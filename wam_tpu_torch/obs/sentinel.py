"""Compile/retrace sentinel — the third pillar of `wam_tpu_torch.obs`
(PyTorch port of `wam_tpu.obs.sentinel`, standard library only).

The reference counts jit traces. Eager PyTorch has no trace; its
counterpart is the FIRST call of an entry at a new input signature
(shape, dtype, device of every tensor argument): that call is where cuDNN
picks its algorithms, the port's kernels are built and their band plans
made, and the caching allocator grows to the bucket's working set.
`wam_tpu_torch.serve.entry.jit_entry` and
`wam_tpu_torch.anytime.entry.make_anytime_entry` call `record_trace` on
that first call. Each event is attributed to a ``(entry_kind, bucket,
replica, phase, origin)`` tuple: bucket/replica/phase come from the
ambient `label(...)` context the serve warmup and worker threads
establish, and ``origin`` is the innermost wam_tpu_torch frames of the
recording stack (the obs frames themselves excluded) — enough to answer
"WHICH call path met a new signature", not just "something did".

`assert_no_retrace()` is the enforcement surface: as a context manager it
snapshots the event count on entry and raises `RetraceError` listing the
new events on exit — the one-first-call-per-bucket invariant the serve
warm path pins. The reference's AOT-cache events (`record_aot`,
`aot_events`, `aot_event_count`) wait for the port's ``pipeline/aot.py``
(ROADMAP.md slice E) and are absent here.

The sentinel stays live even when observability is disabled: first calls
are rare, and a sentinel that silently stops counting when tracing is off
would make the invariant unenforceable exactly when overhead-sensitive
benchmarks run.
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import deque

from wam_tpu_torch.obs.registry import registry

__all__ = ["RetraceError", "label", "record_trace", "trace_count", "compile_events",
           "assert_no_retrace", "clear_events"]

_lock = threading.Lock()
_events: deque = deque(maxlen=1024)
_trace_count = 0
_tls = threading.local()

_jit_traces = registry.counter(
    "wam_tpu_compile_jit_traces_total",
    "jit traces observed by the compile sentinel", labels=("entry_kind",))


class RetraceError(AssertionError):
    """Raised by `assert_no_retrace` when compile events occur inside the
    guarded region; carries the offending event dicts as ``.events``."""

    def __init__(self, events):
        self.events = list(events)
        lines = [
            f"  {e['entry_kind']} bucket={e['bucket']} replica={e['replica']}"
            f" phase={e['phase']} origin={e['origin']}"
            for e in self.events]
        super().__init__(
            f"{len(self.events)} unexpected compile event(s):\n"
            + "\n".join(lines))


class label:
    """Attach attribution labels to compile events recorded on this thread:

        with sentinel.label(replica=rid, bucket=bucket, phase="warmup"):
            entry(x, y)   # any trace inside is tagged

    Nests; inner values shadow outer ones. The serve warmup and worker
    loops establish these so retraces self-identify."""

    def __init__(self, **labels):
        self._labels = labels
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_tls, "labels", None)
        merged = dict(self._prev) if self._prev else {}
        merged.update(self._labels)
        _tls.labels = merged
        return self

    def __exit__(self, *exc):
        _tls.labels = self._prev
        return False


def _current_labels() -> dict:
    return getattr(_tls, "labels", None) or {}


def _origin(skip_obs: bool = True) -> str:
    """Innermost wam_tpu_torch frames of the current stack (obs frames excluded),
    newest last, as ``file.py:lineno:func`` joined by ``<-``."""
    frames = []
    for fr in traceback.extract_stack():
        fn = fr.filename.replace("\\", "/")
        if "wam_tpu" not in fn:
            continue
        if skip_obs and "/obs/" in fn:
            continue
        frames.append(f"{fn.rsplit('/', 1)[-1]}:{fr.lineno}:{fr.name}")
    return "<-".join(frames[-3:]) if frames else "?"


def record_trace(entry_kind: str, detail: str = "", **labels) -> dict:
    """Record one first call at a new signature (the reference's jit
    trace). ``entry_kind`` names the entry family
    ("serve", "aot", "fan", ...); explicit ``labels`` override the ambient
    `label(...)` context. Returns the structured event row."""
    global _trace_count
    merged = dict(_current_labels())
    merged.update({k: v for k, v in labels.items() if v is not None})
    event = {
        "event": "compile_event",
        "entry_kind": entry_kind,
        "detail": detail,
        "bucket": merged.get("bucket"),
        "replica": merged.get("replica"),
        "phase": merged.get("phase", "serve"),
        "origin": _origin(),
        "t": time.time(),
    }
    with _lock:
        _trace_count += 1
        event["seq"] = _trace_count
        _events.append(event)
    _jit_traces.inc(entry_kind=entry_kind)
    return event


def trace_count() -> int:
    with _lock:
        return _trace_count


def compile_events(since_seq: int = 0) -> list[dict]:
    """Structured compile_event rows with ``seq > since_seq`` (bounded by
    the event ring — 1024 events dwarfs any real compile volume)."""
    with _lock:
        return [dict(e) for e in _events if e["seq"] > since_seq]


class assert_no_retrace:
    """``with obs.assert_no_retrace():`` — raises `RetraceError` if any
    first call at a new signature is recorded inside the block. The
    warm-path invariant: after warmup, steady-state serving meets no new
    signature."""

    def __init__(self):
        self._seq0 = 0

    def __enter__(self):
        self._seq0 = trace_count()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False  # don't mask the real failure
        fresh = compile_events(since_seq=self._seq0)
        if fresh:
            raise RetraceError(fresh)
        return False


def clear_events() -> None:
    """Forget all events and zero the count (the registry counters are
    reset separately via `registry.reset()`)."""
    global _trace_count
    with _lock:
        _events.clear()
        _trace_count = 0
