"""Native runtime components, C++ through ctypes (PyTorch port of
`wam_tpu.native`; the sources are this package's own copies).

`read_wav(path)` decodes a WAV file to float32 through the compiled shared
library when it is available (built at first use with g++ from `wavio.cpp`
and `prefetch.cpp` into ``build/wam_tpu_torch/native/``), falling back to
scipy.io.wavfile otherwise. Both return (sample_rate, samples), samples
(frames,) mono or (frames, channels).

`WavPrefetcher(paths, workers, capacity)` streams decoded waveforms in
submission order from a C++ thread pool that decodes ahead of the consumer
(`prefetch.cpp`; the data loader's worker role for the ESC-50 pipeline); a
Python thread pool covers machines without the toolchain.

The build takes the kernels' file lock (`wam_tpu_torch.kernels.build_lock`)
and publishes the library by an atomic rename, so processes starting
together (pod workers, test workers) never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import weakref
from pathlib import Path

import numpy as np

__all__ = ["read_wav", "native_available", "WavPrefetcher"]

_HERE = Path(__file__).resolve().parent
_SOURCES = (_HERE / "wavio.cpp", _HERE / "prefetch.cpp")
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib = None
_build_failed = False


def library_path() -> Path:
    """Where the library of the present sources is built: the name carries
    a hash of the sources and flags, so an edited source builds anew."""
    from wam_tpu_torch.kernels import BUILD_DIR

    h = hashlib.sha256()
    for src in _SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(_CXX_FLAGS).encode())
    return BUILD_DIR / "native" / f"libwamnative-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    from wam_tpu_torch.kernels import build_lock

    path.parent.mkdir(parents=True, exist_ok=True)
    with build_lock():
        if path.exists():  # another process built it while this one waited
            return
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        subprocess.run(["g++", *_CXX_FLAGS, "-o", str(tmp), *map(str, _SOURCES)],
                       check=True, capture_output=True)
        os.replace(tmp, path)


def _load() -> ctypes.CDLL | None:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.wav_info.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_long),
            ]
            lib.wav_info.restype = ctypes.c_int
            lib.wav_read_f32.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_long,
            ]
            lib.wav_read_f32.restype = ctypes.c_long
            lib.pf_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_long,
                ctypes.c_int, ctypes.c_long, ctypes.c_long,
            ]
            lib.pf_create.restype = ctypes.c_void_p
            lib.pf_next.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_long, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.pf_next.restype = ctypes.c_long
            lib.pf_next_size.argtypes = [ctypes.c_void_p]
            lib.pf_next_size.restype = ctypes.c_long
            lib.pf_destroy.argtypes = [ctypes.c_void_p]
            lib.pf_destroy.restype = None
            _lib = lib
        except Exception:
            _build_failed = True
        return _lib


def native_available() -> bool:
    return _load() is not None


def read_wav(path: str) -> tuple[int, np.ndarray]:
    lib = _load()
    if lib is None:
        from scipy.io import wavfile

        sr, data = wavfile.read(path)
        if data.dtype == np.int16:
            data = data.astype(np.float32) / 32768.0
        elif data.dtype == np.int32:
            data = (data.astype(np.float64) / 2147483648.0).astype(np.float32)
        else:
            data = data.astype(np.float32)
        return int(sr), data

    path = str(path)
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    frames = ctypes.c_long()
    rc = lib.wav_info(path.encode(), ctypes.byref(sr), ctypes.byref(ch), ctypes.byref(frames))
    if rc != 0:
        raise IOError(f"wav_info failed ({rc}) for {path}")
    out = np.empty(frames.value * ch.value, dtype=np.float32)
    got = lib.wav_read_f32(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           frames.value)
    if got < 0:
        raise IOError(f"wav_read_f32 failed ({got}) for {path}")
    samples = out[: got * ch.value]
    if ch.value > 1:
        samples = samples.reshape(-1, ch.value)
    return sr.value, samples


class WavPrefetcher:
    """Ordered, bounded, threaded WAV prefetch (`prefetch.cpp`).

    Iterate to receive (sample_rate, samples) for each path in order;
    decoding runs up to ``capacity`` items ahead on ``workers`` C++ threads.
    Use it as a context manager (or exhaust the iterator) so the threads are
    joined. Without the native library a Python thread pool keeps the same
    contract.

    One iterator at a time: a second ``iter()`` raises at once. ``close()``
    may be called from another thread while the iterator runs; it waits out
    the item in flight and the iterator then stops cleanly. The C API's -8
    code also covers direct C callers that race pf_destroy against a
    blocked pf_next (`prefetch.cpp`).
    """

    def __init__(self, paths: list[str], workers: int = 4, capacity: int = 8,
                 max_frames: int = 16_000_000):
        self.paths = [str(p) for p in paths]
        self.workers = max(1, int(workers))
        self.capacity = max(1, int(capacity))
        self.max_frames = int(max_frames)
        self._handle = None
        self._fallback = None
        self._closed = False
        self._iterating = False
        # orders native calls against close() from another thread: a call
        # started after pf_destroy returned would use a dangling handle
        self._native_lock = threading.Lock()
        lib = _load()
        if lib is not None and self.paths:
            arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
            self._paths_arr = arr  # alive as long as the worker threads
            self._handle = lib.pf_create(arr, len(self.paths), self.workers, self.capacity,
                                         self.max_frames)
        if self._handle is None and self.paths:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=self.workers)
            self._fallback = True  # futures are submitted as the consumer goes (bounded)
        # a prefetcher built and abandoned must not leak its native threads
        self._finalizer = weakref.finalize(self, WavPrefetcher._finalize, lib, self._handle)

    @staticmethod
    def _finalize(lib, handle):
        if lib is not None and handle is not None:
            lib.pf_destroy(handle)

    def __iter__(self):
        # not a generator, so a second iter() raises here instead of handing
        # out a generator that would share the native ordinal stream; the
        # check and the set happen under the lock
        with self._native_lock:
            if self._closed or self._iterating:
                raise RuntimeError(
                    "WavPrefetcher is single-use: it is already being iterated or was closed; "
                    "construct a new one for another pass")
            self._iterating = True
        if self._handle is not None:
            return self._iter_native()
        if self._fallback:
            return self._iter_fallback()
        return iter(())

    def _iter_native(self):
        lib = _load()
        try:
            # the buffer grows to each item's size (pf_next_size): no
            # worst-case allocation up front
            buf = np.empty(1 << 18, dtype=np.float32)  # 1 MB to start
            sr = ctypes.c_int()
            ch = ctypes.c_int()
            for path in self.paths:
                with self._native_lock:
                    if self._handle is None:  # closed from another thread
                        return
                    need = lib.pf_next_size(self._handle)
                    if need > buf.size:
                        buf = np.empty(need, dtype=np.float32)
                    elif buf.size > (1 << 18) and 0 < need < buf.size // 4:
                        # shrink after an outlier, so one long file does not
                        # keep its buffer for the rest of the pass
                        buf = np.empty(max(need, 1 << 18), dtype=np.float32)
                    got = lib.pf_next(self._handle,
                                      buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                      buf.size, ctypes.byref(sr), ctypes.byref(ch))
                if got == -1:  # exhausted (an item's errors are < -1)
                    return
                if got < 0:
                    raise IOError(
                        f"prefetch decode failed (code {got}) for {path}"
                        + (" — file exceeds max_frames" if got == -5 else "")
                        + (" — prefetcher was destroyed concurrently" if got == -8 else ""))
                samples = buf[: got * ch.value].copy()
                if ch.value > 1:
                    samples = samples.reshape(-1, ch.value)
                yield sr.value, samples
        finally:
            # exhaustion, a break or an error: the C++ workers are joined
            self.close()

    def _iter_fallback(self):
        from collections import deque
        from concurrent.futures import CancelledError

        pending: deque = deque()
        try:
            it = iter(self.paths)
            # bounded work-ahead, ``capacity`` items as on the native path
            for p in it:
                pending.append(self._pool.submit(read_wav, p))
                if len(pending) >= self.capacity:
                    break
            for p in it:
                yield pending.popleft().result()
                pending.append(self._pool.submit(read_wav, p))
            while pending:
                yield pending.popleft().result()
        except (CancelledError, RuntimeError):
            # a close() from another thread cancels the futures and shuts the
            # pool down: stop cleanly, as the native path does
            if not self._closed:
                raise
        finally:
            for fut in pending:
                fut.cancel()
            self.close()

    def close(self):
        self._closed = True
        lib = _load()
        with self._native_lock:
            if self._handle is not None and lib is not None:
                self._finalizer.detach()  # destroyed here, not again by the finalizer
                lib.pf_destroy(self._handle)
                self._handle = None
        if self._fallback:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._fallback = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
