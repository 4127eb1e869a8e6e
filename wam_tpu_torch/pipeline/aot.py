"""Compiled-step cache — compile skipping across processes (PyTorch port of
`wam_tpu.pipeline.aot`).

The schedule cache (`tune/cache.py`) remembers *what* to run (chunk sizes,
stream mode, transform impls); this layer keeps the compiled program. The
reference exports a jitted function with `jax.export` and a later process
deserializes and calls it. Here a function is compiled with
`torch.compile(..., dynamic=False, fullgraph=True)` (Dynamo under
``trace_autograd_ops``, so a step that takes `torch.autograd.grad` is one
graph), run once, and the cache artifacts of that compile —
AOTAutograd's and Inductor's cache entries, the Triton kernels among them,
as `torch.compiler.save_cache_artifacts` gives them — are written under a
key. A later process loads them (`torch.compiler.load_cache_artifacts`)
before it compiles: Dynamo still traces the Python, but AOTAutograd and
Inductor hit their caches, so nothing is compiled. "Traced" in the
reference's sense is therefore "compiled" here: ``on_trace`` and the
sentinel's `record_trace` fire when AOTAutograd or Inductor missed its
cache (`torch._dynamo.utils.counters`), never on a hit. The hand-written
kernels stay what they are inside a compiled graph: custom operators
(`wavelets.matmul`, `tune.fused_relu`) that Inductor calls as they are.

Keying is **opt-in and caller-owned**, as in the reference: the artifacts
hold a graph whose parameters are its inputs, but the key must still name
the model + config, since the graph's structure and its constants follow
them. No ``aot_key`` -> no compile: the entries run eager.

File format: a JSON header line (``version``, ``key``, ``origin``,
``torch``, ``platform``: the device name, compute capability, CUDA and
Triton versions), then the payload. Files are written atomically (tmp +
rename); a stale version, a corrupt payload, another key under the same
digest or another platform reads as a miss, never as an error.
`WAM_TPU_NO_AOT_CACHE=1` is the kill switch (compile, persist nothing);
``$WAM_TPU_AOT_CACHE`` overrides the directory (~/.cache/wam_tpu/aot by
default). A compile that fails warns once and runs ``fn`` eager (the
reference falls back to plain jit): the status is then "fallback".
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.metadata
import json
import os
import tempfile
import threading
import types
import warnings
from typing import Callable, Sequence

import numpy as np
import torch

from wam_tpu_torch.obs import sentinel
from wam_tpu_torch.pipeline.donation import release

__all__ = [
    "AOT_CACHE_VERSION",
    "default_aot_dir",
    "aot_entry_path",
    "save_aot",
    "load_aot",
    "load_aot_meta",
    "list_aot_entries",
    "read_aot_payload",
    "seed_aot_payload",
    "aval_signature",
    "cached_jit",
    "cached_entry",
]

AOT_CACHE_VERSION = 1

_warned_keys: set[str] = set()
# one compile at a time in a process: the miss counters and the artifact
# recorder are process-wide
_compile_lock = threading.RLock()


def _disabled() -> bool:
    return os.environ.get("WAM_TPU_NO_AOT_CACHE", "") not in ("", "0")


def default_aot_dir() -> str:
    return os.environ.get(
        "WAM_TPU_AOT_CACHE", os.path.expanduser("~/.cache/wam_tpu/aot")
    )


def aot_entry_path(key: str, cache_dir: str | None = None) -> str:
    digest = hashlib.sha1(key.encode()).hexdigest()[:20]
    return os.path.join(cache_dir or default_aot_dir(), f"{digest}.aot")


def _triton_version() -> str | None:
    try:
        return importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        return None


def platform(backend: str | None = None) -> dict:
    """What compiled artifacts for ``backend`` ("cuda" or "cpu"; None: the
    card when there is one) depend on: the device's name and compute
    capability, CUDA's and Triton's versions."""
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    out = {"backend": backend, "device": "cpu", "capability": None,
           "cuda": torch.version.cuda, "triton": _triton_version()}
    if backend == "cuda" and torch.cuda.is_available():
        out["device"] = torch.cuda.get_device_name()
        out["capability"] = "{}.{}".format(*torch.cuda.get_device_capability())
    return out


def _key_backend(key: str) -> str | None:
    """The backend a `cached_entry` key ends with, else None (the card
    when there is one)."""
    tail = key.rsplit("|", 1)[-1]
    return tail if tail in ("cuda", "cpu") else None


def _write_entry(key: str, payload: bytes, cache_dir: str | None, origin: str,
                 torch_version: str | None = None,
                 platform_: dict | None = None) -> str | None:
    """Atomic header+payload write shared by `save_aot` (origin
    "exported") and `seed_aot_payload` (origin "registry")."""
    header = json.dumps({
        "version": AOT_CACHE_VERSION, "key": key, "origin": origin,
        "torch": torch_version or torch.__version__,
        "platform": platform_ or platform(_key_backend(key)),
    }).encode()
    path = aot_entry_path(key, cache_dir)
    tmp = None
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            f.write(header + b"\n" + payload)
        os.replace(tmp, path)
    except OSError:
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return None
    return path


def save_aot(key: str, exported, cache_dir: str | None = None) -> str | None:
    """Write the artifacts of one compile (the bytes of
    `torch.compiler.save_cache_artifacts`, or its ``(bytes, info)`` pair)
    under ``key``. Atomic; returns the path, or None when there is nothing
    to write or the write fails."""
    payload = exported[0] if isinstance(exported, tuple) else exported
    if not payload:
        _warn_once(key, "the compile left no cache artifacts to save")
        return None
    return _write_entry(key, bytes(payload), cache_dir, origin="exported")


def seed_aot_payload(key: str, payload: bytes, cache_dir: str | None = None,
                     *, origin: str = "registry", torch_version: str | None = None,
                     platform_: dict | None = None) -> str | None:
    """Install already-serialized artifacts under ``key`` without loading
    them (the registry's hydration: the payload is the publisher's,
    digest-verified by the caller). ``origin`` marks where the entry came
    from, so a later consult attributes its hit to the registry;
    ``torch_version`` / ``platform_`` record the publisher's (the bundle's
    platform gate has already matched them to this host)."""
    return _write_entry(key, bytes(payload), cache_dir, origin=origin,
                        torch_version=torch_version, platform_=platform_)


def _read_entry(path: str, key: str | None = None):
    """(header, payload) for one cache file, or (None, None) on any
    corruption / version / key mismatch."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
        header_line, _, payload = raw.partition(b"\n")
        header = json.loads(header_line)
    except (OSError, ValueError):
        return None, None
    if not isinstance(header, dict) or header.get("version") != AOT_CACHE_VERSION:
        return None, None
    if key is not None and header.get("key") != key:
        return None, None
    return header, payload


def read_aot_payload(key: str, cache_dir: str | None = None):
    """(payload bytes, header dict) for ``key`` without loading it (the
    registry's publish reads entries this way: a bundle stores the bare
    artifacts, the local header is the cache's own). (None, None) on a
    miss / stale / corrupt file."""
    header, payload = _read_entry(aot_entry_path(key, cache_dir), key)
    if header is None:
        return None, None
    return payload, header


def list_aot_entries(cache_dir: str | None = None) -> list[dict]:
    """Every valid current-version entry of the directory as ``{"key",
    "path", "origin", "torch"}`` rows (headers only). Stale, corrupt and
    torn files are skipped; a missing directory is an empty cache."""
    root = cache_dir or default_aot_dir()
    rows: list[dict] = []
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return rows
    for name in names:
        if not name.endswith(".aot"):
            continue
        path = os.path.join(root, name)
        header, _ = _read_entry(path)
        if header is None or not isinstance(header.get("key"), str):
            continue
        rows.append({
            "key": header["key"],
            "path": path,
            "origin": header.get("origin", "exported"),
            "torch": header.get("torch"),
        })
    return rows


def _parses(payload: bytes) -> bool:
    """Whether ``payload`` deserializes as cache artifacts (nothing is
    installed)."""
    from torch.compiler._cache import CacheArtifactManager

    if not hasattr(CacheArtifactManager, "deserialize"):
        return bool(payload)  # a torch that cannot parse without loading
    try:
        return CacheArtifactManager.deserialize(payload) is not None
    except Exception:
        return False


def load_aot_meta(key: str, cache_dir: str | None = None):
    """(payload, header) for ``key``, or (None, None) on a miss: a version
    mismatch, a key (digest) collision, another platform or torch, and a
    payload that does not deserialize are all misses, never errors. The
    header's ``origin`` is "exported" for an entry this host wrote and
    "registry" for one hydrated from a bundle."""
    header, payload = _read_entry(aot_entry_path(key, cache_dir), key)
    if header is None:
        return None, None
    if header.get("platform") != platform(_key_backend(key)):
        return None, None
    if header.get("torch") != torch.__version__ or not _parses(payload):
        return None, None
    return payload, header


def load_aot(key: str, cache_dir: str | None = None):
    """The payload for ``key``, or None on a miss (`load_aot_meta`)."""
    payload, _ = load_aot_meta(key, cache_dir)
    return payload


def _flat_leaves(tree) -> list:
    """Leaves in the reference's pytree order: tuples and lists in order,
    dicts by sorted key, None a leaf of its own."""
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _flat_leaves(item)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flat_leaves(tree[k])]
    return [tree]


def _dtype_name(leaf) -> str:
    dtype = getattr(leaf, "dtype", None)
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.asarray(leaf).dtype.name if dtype is None else np.dtype(dtype).name


def aval_signature(tree) -> str:
    """Stable shape/dtype signature of an argument tree, e.g.
    ``float32[8,3,224,224];int64[8]`` (None leaves print as ``-``), the
    reference's format."""

    def one(leaf):
        if leaf is None:
            return "-"
        shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
        return f"{_dtype_name(leaf)}[{','.join(str(int(d)) for d in shape)}]"

    return ";".join(one(leaf) for leaf in _flat_leaves(tree))


def _warn_once(key: str, msg: str) -> None:
    if key in _warned_keys:
        return
    _warned_keys.add(key)
    warnings.warn(f"wam_tpu_torch AOT cache [{key}]: {msg}; running eager")


def _misses() -> int:
    """AOTAutograd's and Inductor's cache misses so far in this process."""
    from torch._dynamo.utils import counters

    return (counters["aot_autograd"]["autograd_cache_miss"]
            + counters["inductor"]["fxgraph_cache_miss"])


def graph_breaks() -> int:
    """Dynamo's graph breaks so far in this process (0 for a fullgraph
    compile that succeeded)."""
    from torch._dynamo.utils import counters

    return sum(counters["graph_break"].values())


def _load_artifacts(payload: bytes) -> None:
    torch.compiler.load_cache_artifacts(payload)


def _dynamo_settings() -> dict:
    """Dynamo's settings for a compiled step: ``torch.autograd.grad`` traced
    into the graph (a step takes the gradient of the coefficient leaves),
    and room for one program per signature of a step function."""
    import torch._dynamo

    want = {"trace_autograd_ops": True, "recompile_limit": 64}
    return {k: v for k, v in want.items() if hasattr(torch._dynamo.config, k)}


def _explicit_precision() -> None:
    """Assign the float32 precision flags their own values. The compile
    caches key a program on whether the flags were ever assigned (torch
    2.11: ``cuda_matmul_settings`` reads 'none' until a first assignment of
    ``allow_tf32``, 'ieee' after one), which is no difference in what runs;
    made explicit, a process that set them (as the 3D synthesis does)
    finds the programs a fresh process stored."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cudnn.allow_tf32


def _fresh_artifacts():
    """A context that records only this compile's cache artifacts."""
    from torch.compiler._cache import CacheArtifactManager

    fresh = getattr(CacheArtifactManager, "with_fresh_cache", None)
    if fresh is not None:
        return fresh()
    CacheArtifactManager.clear()
    return contextlib.nullcontext()


def _own_frame(fn, key: str):
    """``fn`` behind a frame of its own: Dynamo keeps its programs per code
    object, so two keys over one function (or one step function of two
    explainers) would otherwise share a program, and the second key's first
    call would compile nothing and leave no artifacts to write."""

    def frame(*args):
        return fn(*args)

    name = "aot_" + hashlib.sha1(key.encode()).hexdigest()[:12]
    code = frame.__code__.replace(co_name=name, co_qualname=name)
    return types.FunctionType(code, frame.__globals__, name, None, frame.__closure__)


class _Compiled:
    """The callable `cached_jit` returns: ``fn`` compiled at its first call
    (see `cached_jit`). ``aot_status`` is "hit", "registry_hit", "miss"
    (before the first call), "exported", "disabled" or "fallback" (with the
    failure in ``error``); ``compiles`` counts the calls that compiled
    (AOTAutograd or Inductor missed its cache)."""

    def __init__(self, fn, key, donate_argnums, on_trace, obs_kind, cache_dir):
        self.fn = fn
        self.key = key
        self.donate_argnums = tuple(donate_argnums)
        self.on_trace = on_trace
        self.obs_kind = obs_kind
        self.cache_dir = cache_dir
        self.compiles = 0
        self.error = None  # why the compile failed ("fallback")
        self.payload = None
        self.aot_status = "disabled"
        if not _disabled():
            self.payload, header = load_aot_meta(key, cache_dir)
            if self.payload is None:
                sentinel.record_aot("miss", key)
                self.aot_status = "miss"
            elif header.get("origin") == "registry":
                # seeded from a bundle, not written by an earlier local
                # process: attribute the skipped compile to the registry
                sentinel.record_aot("registry_hit", key)
                self.aot_status = "registry_hit"
            else:
                sentinel.record_aot("hit", key)
                self.aot_status = "hit"
        self._compiled = torch.compile(_own_frame(fn, key), dynamic=False, fullgraph=True)
        self._first = True

    def _run(self, args):
        # outputs carry no autograd history: a step that needs a gradient
        # takes it inside (`torch.autograd.grad` under enable_grad)
        _explicit_precision()
        with torch._dynamo.config.patch(**_dynamo_settings()), torch.no_grad():
            return self._compiled(*args)

    def _first_call(self, args):
        with _compile_lock:
            if not self._first:
                return self._call(args)
            misses = _misses()
            try:
                if self.payload is not None:
                    _load_artifacts(self.payload)
                    self.payload = None  # installed: the caches hold it now
                with _fresh_artifacts():
                    out = self._run(args)
                    saved = (torch.compiler.save_cache_artifacts()
                             if self.aot_status == "miss" else None)
            except Exception as e:
                self.error = f"{type(e).__name__}: {e}"
                _warn_once(self.key, f"compile failed: {self.error}")
                self.aot_status = "fallback"
                self._first = False
                return self.fn(*args)
            self._note_compiles(misses)
            if saved is not None and save_aot(self.key, saved, self.cache_dir):
                sentinel.record_aot("export", self.key)
                self.aot_status = "exported"
            self._first = False
            return out

    def _note_compiles(self, misses_before: int) -> None:
        if _misses() > misses_before:
            self.compiles += 1
            sentinel.record_trace(self.obs_kind, detail=self.key)
            if self.on_trace is not None:
                self.on_trace()

    def _call(self, args):
        if self.aot_status == "fallback":
            return self.fn(*args)
        misses = _misses()
        out = self._run(args)
        self._note_compiles(misses)  # a guard that failed compiles again
        return out

    def __call__(self, *args):
        out = self._first_call(args) if self._first else self._call(args)
        for i in self.donate_argnums:
            if i < len(args):
                release(args[i])
        return out


def cached_jit(
    fn: Callable,
    example_args: tuple,
    key: str,
    *,
    donate_argnums: Sequence[int] = (),
    on_trace: Callable[[], None] | None = None,
    cache_dir: str | None = None,
    obs_kind: str = "aot",
):
    """One compiled program for ``fn`` at ``example_args``' shapes/dtypes.

    Hit: the stored artifacts are loaded before the compile, AOTAutograd and
    Inductor hit their caches and ``on_trace`` never fires. Miss: ``fn`` is
    compiled at the first call (``on_trace`` fires once), run, and the
    compile's artifacts are written under ``key``. A disabled cache
    compiles and writes nothing; a failed compile runs ``fn`` eager. Returns
    a callable with ``fn``'s signature (`_Compiled`: ``aot_status``,
    ``compiles``), run under ``torch.no_grad()`` (its outputs carry no
    autograd history; ``fn`` enables grad where it takes a gradient). Each
    compile is reported to the sentinel (under
    ``obs_kind``), and the hit/miss/export outcomes land on its AOT
    counters. The CUDA tensors at ``donate_argnums`` are released after the
    call (`pipeline.donation.release`). ``example_args`` only name the
    shapes: the program is specialized to the first call's."""
    del example_args  # the first call's arguments are the example
    return _Compiled(fn, key, donate_argnums, on_trace, obs_kind, cache_dir)


def _backend_of(args) -> str:
    for leaf in _flat_leaves(args):
        if isinstance(leaf, torch.Tensor):
            return leaf.device.type
    return "cuda" if torch.cuda.is_available() else "cpu"


def cached_entry(
    impl: Callable,
    base_key: str,
    *,
    donate_argnums: Sequence[int] = (),
    on_trace: Callable[[], None] | None = None,
    cache_dir: str | None = None,
    obs_kind: str = "aot",
):
    """Shape-dispatching callable over the cache.

    ``entry(*args)`` resolves one `cached_jit` per argument signature,
    keyed ``{base_key}|{aval_signature}|{backend}`` with the backend
    ``cuda`` or ``cpu`` of the arguments. ``base_key`` must identify the
    model + params (module docstring). ``entry.fns`` maps each signature to
    its `cached_jit` callable (their ``aot_status`` and keys)."""
    donate_argnums = tuple(donate_argnums)
    fns: dict[str, _Compiled] = {}
    lock = threading.Lock()

    def entry(*args):
        sig = aval_signature(args)
        with lock:
            fn = fns.get(sig)
            if fn is None:
                fn = cached_jit(impl, args, f"{base_key}|{sig}|{_backend_of(args)}",
                                donate_argnums=donate_argnums, on_trace=on_trace,
                                cache_dir=cache_dir, obs_kind=obs_kind)
                fns[sig] = fn
        return fn(*args)

    entry.fns = fns
    return entry
