"""Request-scoped tracing — the first pillar of `wam_tpu_torch.obs`
(PyTorch port of `wam_tpu.obs.tracing`; standard library only, and
`torch.profiler` for the named scopes).

A span is one named host-side interval with a trace identity: ``trace_id``
(shared by every span of one request), ``span_id``, and ``parent_id``.
Spans are recorded into a process-level thread-safe ring buffer as plain
dicts and exported as Chrome trace-event JSON (Perfetto-loadable) via
`export_chrome_trace`. Clocks are ``time.perf_counter()`` — monotonic, so
span timestamps order correctly across the serve worker / client / warmup
threads of one process.

Three span shapes cover every call site in the request path:

- ``with span("dispatch", bucket=...):`` — a live span on the current
  thread. It nests: the thread-local context stack parents it to the
  enclosing span, and the new context is visible to everything called
  under it (`AttributionServer.submit` captures it into the request). Live
  spans also enter a `torch.profiler.record_function` named scope, so host
  spans line up with the card's kernels in a `torch.profiler` capture.
- ``start_span("request")`` — a DETACHED span: it does not touch the
  thread-local stack, and it ends on whatever thread resolves it
  (`Span.end`, usually a future callback). This is the per-request root.
- ``record_span("queue_wait", t0, t1, parent=ctx)`` — retroactive: the
  worker loop knows a request's queue wait only once the batch pops, so it
  records the interval after the fact from timestamps it already holds.

Cross-thread propagation is explicit: `current_context()` reads the
calling thread's innermost span, `use_context(ctx)` re-establishes a
context on another thread (the fleet router wraps re-routes in the
original request's context so a re-dispatched request keeps its trace id).

When tracing is disabled (`ObsConfig.enabled=False` via
`wam_tpu_torch.obs.configure`), `span()` returns a shared no-op context manager
singleton and `start_span`/`record_span` return/do nothing — one branch
per call, no allocation, nothing recorded (the near-zero-overhead
contract; the reference measures it with ``scripts/bench_serve.py
--obs-bench``, which the port has no counterpart of yet).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque

__all__ = [
    "Span",
    "span",
    "start_span",
    "record_span",
    "current_context",
    "use_context",
    "spans",
    "clear_spans",
    "export_chrome_trace",
    "set_enabled",
    "enabled",
    "set_ring_size",
    "namespace_ids",
    "spans_to_events",
]


class _State:
    """Shared mutable observability state (also consulted by the metrics
    registry): one enabled flag, one span ring."""

    def __init__(self, ring_size: int = 4096):
        self.enabled = True
        self.ring: deque = deque(maxlen=ring_size)


_STATE = _State()
_ids = itertools.count(1)  # itertools.count.__next__ is atomic under the GIL
_tls = threading.local()


def enabled() -> bool:
    return _STATE.enabled


def set_enabled(flag: bool) -> None:
    _STATE.enabled = bool(flag)


def set_ring_size(n: int) -> None:
    """Resize the span ring, keeping the newest recorded spans."""
    if n < 1:
        raise ValueError("ring_size must be >= 1")
    _STATE.ring = deque(_STATE.ring, maxlen=int(n))


def _next_id() -> str:
    return f"{next(_ids):x}"


def namespace_ids(pid: int) -> None:
    """Partition the span-id space by process: restart this process's id
    counter at ``pid << 40``. Pod workers call it once at startup so ids
    minted in N processes never collide when the router merges their span
    rings into one trace (2^40 ids per process before overlap — the ring
    holds 4096). Idempotent in effect; call before any spans record."""
    global _ids
    _ids = itertools.count((int(pid) << 40) + 1)


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_context():
    """(trace_id, span_id) of the innermost live span on this thread, or
    None — what a child span (or a request capturing its trace identity)
    parents to."""
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


class use_context:
    """Re-establish a span context on the current thread (no-op on None):
    spans opened under it — and `current_context()` reads — see ``ctx`` as
    the parent. The cross-thread half of request-scoped tracing."""

    __slots__ = ("_ctx", "_pushed")

    def __init__(self, ctx):
        self._ctx = ctx
        self._pushed = False

    def __enter__(self):
        if self._ctx is not None:
            _stack().append(self._ctx)
            self._pushed = True
        return self._ctx

    def __exit__(self, *exc):
        if self._pushed:
            _stack().pop()
        return False


class Span:
    """A started-but-unfinished span handle. `end()` stamps ``t1`` and
    records it; safe to call from a different thread than the starter."""

    __slots__ = ("name", "cat", "trace_id", "span_id", "parent_id", "t0",
                 "attrs", "_done")

    def __init__(self, name, cat, trace_id, span_id, parent_id, attrs):
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.t0 = time.perf_counter()
        self._done = False

    @property
    def context(self):
        return (self.trace_id, self.span_id)

    def end(self, t1: float | None = None, **attrs) -> None:
        if self._done:  # idempotent: racing future callbacks end once
            return
        self._done = True
        if attrs:
            self.attrs = {**self.attrs, **attrs}
        _record(self.name, self.cat, self.trace_id, self.span_id,
                self.parent_id, self.t0,
                time.perf_counter() if t1 is None else t1, self.attrs)


class _NullSpan:
    """The disabled-path span: every operation is a no-op, every id None."""

    __slots__ = ()
    name = cat = trace_id = span_id = parent_id = None
    attrs: dict = {}
    t0 = 0.0
    context = None

    def end(self, t1=None, **attrs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _SpanCM:
    """Live span context manager (enabled path): parents to the thread's
    current context, pushes its own, and mirrors the interval into a
    `torch.profiler.record_function` named scope."""

    __slots__ = ("_name", "_cat", "_attrs", "_span", "_annot")

    def __init__(self, name, cat, attrs):
        self._name = name
        self._cat = cat
        self._attrs = attrs
        self._span = None
        self._annot = None

    def __enter__(self) -> Span:
        parent = current_context()
        sp = Span(
            self._name,
            self._cat,
            parent[0] if parent else _next_id(),
            _next_id(),
            parent[1] if parent else None,
            self._attrs,
        )
        _stack().append(sp.context)
        try:
            import torch

            self._annot = torch.profiler.record_function(self._name)
            self._annot.__enter__()
        except Exception:  # profiler unavailable: spans still record
            self._annot = None
        self._span = sp
        return sp

    def __exit__(self, exc_type, exc, tb):
        if self._annot is not None:
            self._annot.__exit__(exc_type, exc, tb)
        _stack().pop()
        if exc_type is not None:
            self._span.attrs = {**self._span.attrs, "error": exc_type.__name__}
        self._span.end()
        return False


def span(name: str, *, cat: str = "obs", **attrs):
    """``with span("dispatch", bucket="3x224x224") as sp:`` — a live span on
    the current thread (module docstring). Disabled: a shared no-op."""
    if not _STATE.enabled:
        return NULL_SPAN
    return _SpanCM(name, cat, attrs)


def start_span(name: str, *, cat: str = "obs", parent=None, **attrs):
    """Start a DETACHED span (not on the thread-local stack): the caller
    owns ending it, possibly from another thread. ``parent=None`` starts a
    fresh trace unless the current thread has a live context."""
    if not _STATE.enabled:
        return NULL_SPAN
    if parent is None:
        parent = current_context()
    return Span(
        name,
        cat,
        parent[0] if parent else _next_id(),
        _next_id(),
        parent[1] if parent else None,
        attrs,
    )


def record_span(name: str, t0: float, t1: float, *, parent=None,
                cat: str = "obs", **attrs) -> None:
    """Record a span retroactively from perf_counter timestamps the caller
    already holds (queue waits, batch service intervals)."""
    if not _STATE.enabled:
        return
    _record(name, cat,
            parent[0] if parent else _next_id(), _next_id(),
            parent[1] if parent else None, t0, t1, attrs)


def _record(name, cat, trace_id, span_id, parent_id, t0, t1, attrs) -> None:
    _STATE.ring.append({
        "name": name,
        "cat": cat,
        "trace_id": trace_id,
        "span_id": span_id,
        "parent_id": parent_id,
        "t0": t0,
        "t1": t1,
        "thread": threading.current_thread().name,
        "attrs": attrs,
    })


def spans() -> list[dict]:
    """Snapshot of the recorded span ring (oldest first)."""
    return list(_STATE.ring)


def clear_spans() -> None:
    _STATE.ring.clear()


def spans_to_events(rows, *, pid: int, clock_offset_s: float = 0.0,
                    process_name: str | None = None) -> list[dict]:
    """Span-ring dicts → Chrome trace events, attributable to ``pid``.

    The cross-process half of trace export: a pod router calls this on
    the span ring each worker ships at shutdown, with ``clock_offset_s``
    the worker→router perf_counter offset estimated from heartbeat RTTs
    — so spans minted on N different monotonic clocks land on ONE shared
    timeline (`ts`/`dur` in µs, offset applied). ``process_name`` adds
    the Perfetto process-label metadata row. Thread-name metadata is
    emitted per distinct thread seen in ``rows``."""
    tids: dict[str, int] = {}
    events: list[dict] = []
    for r in rows:
        tid = tids.setdefault(r["thread"], len(tids) + 1)
        events.append({
            "name": r["name"],
            "cat": r["cat"],
            "ph": "X",
            "ts": (r["t0"] + clock_offset_s) * 1e6,
            "dur": max(0.0, (r["t1"] - r["t0"]) * 1e6),
            "pid": pid,
            "tid": tid,
            "args": {
                "trace_id": r["trace_id"],
                "span_id": r["span_id"],
                "parent_id": r["parent_id"],
                **r["attrs"],
            },
        })
    events.extend(
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
         "args": {"name": thread}}
        for thread, tid in tids.items()
    )
    if process_name is not None:
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": process_name}})
    return events


def export_chrome_trace(path: str, extra_events: list[dict] | None = None) -> str:
    """Write the span ring as Chrome trace-event JSON (Perfetto-loadable).

    Every span becomes one complete (``"ph": "X"``) event: ``ts``/``dur``
    in microseconds on the perf_counter timebase, ``pid`` = this process,
    ``tid`` = a stable per-thread-name integer, and the trace identity
    (``trace_id``/``span_id``/``parent_id``) plus user attrs under
    ``args``. `scripts/trace_report.py` consumes this file; so does
    ``chrome://tracing`` / https://ui.perfetto.dev. Returns ``path``."""
    events = spans_to_events(spans(), pid=os.getpid())
    if extra_events:
        events.extend(extra_events)
    payload = {"traceEvents": events, "displayTimeUnit": "ms"}
    dirname = os.path.dirname(os.path.abspath(path))
    os.makedirs(dirname, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f)
    return path
