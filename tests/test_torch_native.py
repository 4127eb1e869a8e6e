"""The port's native WAV reader and prefetcher (`wam_tpu_torch.native`)
against the reference's (`wam_tpu.native`) on WAV files the tests write:
16-bit PCM, 32-bit PCM and float32, mono and stereo. `read_wav` is equal bit
for bit; the prefetcher keeps the reference's contract (order, decode, one
worker, an empty list, a missing file, an early break, single use, a second
``iter()``, a start buffer smaller than the item, a close from another
thread, an abandoned handle) and so does its Python fallback. The library is
built under ``build/wam_tpu_torch/native/`` under the kernels' file lock."""

import gc
import threading

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import wam_tpu.native as jnative
import wam_tpu_torch.native as tnative

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

FORMATS = ("int16-mono", "int16-stereo", "int32-mono", "float32-mono", "float32-stereo")


def _wave(fmt: str, frames: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    kind, layout = fmt.split("-")
    shape = (frames, 2) if layout == "stereo" else (frames,)
    x = rng.standard_normal(shape)
    if kind == "int16":
        return (x * 8000).astype(np.int16)
    if kind == "int32":
        return (x * 2e8).astype(np.int32)
    return (0.3 * x).astype(np.float32)


def _write_wavs(tmp_path, n, sr=8000, seconds=0.05, fmt="int16-mono"):
    paths = []
    for i in range(n):
        p = tmp_path / f"clip{i}.wav"
        wavfile.write(p, sr, _wave(fmt, int(sr * seconds), 17 + i))
        paths.append(str(p))
    return paths


def test_the_library_builds_under_the_build_directory():
    assert tnative.native_available()
    path = tnative.library_path()
    assert path.exists() and path.parent.name == "native"
    assert path.parent.parent.name == "wam_tpu_torch" and path.parent.parent.parent.name == "build"
    assert not list(path.parent.glob("*.tmp.so"))  # published by an atomic rename


@pytest.mark.parametrize("fmt", FORMATS)
def test_read_wav_equals_the_reference_bit_for_bit(tmp_path, fmt):
    p = tmp_path / "a.wav"
    data = _wave(fmt, 4097, 3)
    wavfile.write(p, 22050, data)
    sr, got = tnative.read_wav(str(p))
    sr_ref, want = jnative.read_wav(str(p))
    assert sr == sr_ref == 22050
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == data.shape
    np.testing.assert_array_equal(got, want)
    if fmt.startswith("int16"):
        np.testing.assert_array_equal(got, data.astype(np.float32) / 32768.0)


def test_read_wav_raises_on_a_missing_or_malformed_file(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunk")
    for path in (tmp_path / "missing.wav", bad):
        with pytest.raises(IOError) as terr:
            tnative.read_wav(str(path))
        with pytest.raises(IOError) as jerr:
            jnative.read_wav(str(path))
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("fmt", ("int16-mono", "float32-stereo"))
def test_prefetcher_is_ordered_and_equals_read_wav(tmp_path, fmt):
    paths = _write_wavs(tmp_path, 12, fmt=fmt)
    want = [jnative.read_wav(p) for p in paths]
    with tnative.WavPrefetcher(paths, workers=4, capacity=3) as pf:
        got = list(pf)
    assert len(got) == len(paths)
    for (sr_a, a), (sr_b, b) in zip(got, want):
        assert sr_a == sr_b and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_prefetcher_single_worker_and_empty(tmp_path):
    paths = _write_wavs(tmp_path, 3)
    with tnative.WavPrefetcher(paths, workers=1, capacity=1) as pf:
        got = list(pf)
    assert len(got) == 3
    np.testing.assert_array_equal(got[2][1], jnative.read_wav(paths[2])[1])
    with tnative.WavPrefetcher([], workers=2) as pf:
        assert list(pf) == []


def test_prefetcher_missing_file_raises_mid_stream(tmp_path):
    """A missing file raises IOError where it comes (its code is never the
    exhaustion sentinel), after the files before it."""
    paths = _write_wavs(tmp_path, 3)
    paths.insert(1, str(tmp_path / "missing.wav"))
    with tnative.WavPrefetcher(paths, workers=2, capacity=2) as pf:
        it = iter(pf)
        next(it)
        with pytest.raises(IOError, match=r"prefetch decode failed \(code -11\)"):
            next(it)


def test_prefetcher_early_break_closes(tmp_path):
    paths = _write_wavs(tmp_path, 8)
    pf = tnative.WavPrefetcher(paths, workers=3, capacity=2)
    for k, _ in enumerate(pf):
        if k == 2:
            break
    assert pf._handle is None and not pf._fallback


def test_prefetcher_is_single_use(tmp_path):
    paths = _write_wavs(tmp_path, 2)
    pf = tnative.WavPrefetcher(paths, workers=1)
    assert len(list(pf)) == 2
    with pytest.raises(RuntimeError, match="single-use"):
        list(pf)


def test_prefetcher_second_iter_raises_at_once(tmp_path):
    paths = _write_wavs(tmp_path, 4)
    pf = tnative.WavPrefetcher(paths, workers=2, capacity=2)
    it1 = iter(pf)
    with pytest.raises(RuntimeError):
        iter(pf)
    assert len(list(it1)) == 4


def test_prefetcher_grows_past_its_start_buffer(tmp_path):
    """A stereo item of 600k samples (past the 2^18-sample start buffer),
    then small ones (the buffer shrinks back): all equal to read_wav."""
    rng = np.random.default_rng(7)
    big = tmp_path / "big.wav"
    wavfile.write(big, 16_000, (rng.standard_normal((300_000, 2)) * 8000).astype(np.int16))
    paths = [str(big)] + _write_wavs(tmp_path, 2)
    want = [jnative.read_wav(q) for q in paths]
    with tnative.WavPrefetcher(paths, workers=2, capacity=2) as pf:
        got = list(pf)
    assert len(got) == len(want)
    for (sr_a, a), (sr_b, b) in zip(got, want):
        assert sr_a == sr_b and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_prefetcher_max_frames_is_an_error_not_a_clamp(tmp_path):
    paths = _write_wavs(tmp_path, 2)
    with tnative.WavPrefetcher(paths, workers=1, max_frames=100) as pf:
        with pytest.raises(IOError, match="exceeds max_frames"):
            list(pf)


def test_prefetcher_close_from_another_thread_is_safe(tmp_path):
    for _ in range(5):  # a few rounds to vary the interleaving
        paths = _write_wavs(tmp_path, 32)
        pf = tnative.WavPrefetcher(paths, workers=2, capacity=2)
        got, err = [], []

        def consume():
            try:
                for item in iter(pf):
                    got.append(item)
            except (IOError, RuntimeError) as e:
                err.append(e)

        t = threading.Thread(target=consume)
        t.start()
        pf.close()
        t.join(timeout=30)
        assert not t.is_alive(), "the consumer deadlocked against pf_destroy"


def test_abandoned_prefetcher_is_finalized(tmp_path):
    paths = _write_wavs(tmp_path, 4)
    pf = tnative.WavPrefetcher(paths, workers=2, capacity=2)
    assert pf._handle is not None
    fin = pf._finalizer
    del pf
    gc.collect()
    assert not fin.alive


def test_python_fallback_keeps_the_contract(tmp_path, monkeypatch):
    """Without the library: read_wav through scipy (equal to the
    reference's fallback), the prefetcher on a thread pool, ordered, with
    the same samples, single-use."""
    monkeypatch.setattr(tnative, "_load", lambda: None)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    paths = _write_wavs(tmp_path, 10)
    stereo = tmp_path / "stereo.wav"
    wavfile.write(stereo, 8000, _wave("int32-stereo", 500, 5))
    for p in (paths[0], str(stereo)):
        sr, got = tnative.read_wav(p)
        sr_ref, want = jnative.read_wav(p)
        assert sr == sr_ref
        np.testing.assert_array_equal(got, want)
    with tnative.WavPrefetcher(paths, workers=3, capacity=2) as pf:
        assert pf._handle is None and pf._fallback
        got = list(pf)
    assert len(got) == 10
    for (sr, a), p in zip(got, paths):
        sr_ref, b = wavfile.read(p)
        assert sr == sr_ref
        np.testing.assert_array_equal(a, b.astype(np.float32) / 32768.0)
    with pytest.raises(RuntimeError):
        list(pf)
