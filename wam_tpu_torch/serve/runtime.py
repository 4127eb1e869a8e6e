"""Batched attribution serving runtime (PyTorch port of
`wam_tpu.serve.runtime`).

Turns a stream of independent single-item attribution requests into
padded device batches. One `AttributionServer` owns one device: client
threads `submit()` items and block on futures; a single worker thread
coalesces same-bucket requests into fixed-shape batches (always the
bucket's full ``max_batch`` rows — one input signature per bucket, ever),
dispatches them through a serving entry (`serve.entry.jit_entry`, usually
an engine's ``serve_entry()``), and fans results back out per request.

Operational semantics (DESIGN.md "Serving runtime"):
- **Backpressure**: the queue is bounded by ``queue_depth`` items across
  all buckets; `submit` on a full queue raises `QueueFullError` carrying a
  ``retry_after_s`` estimate — the projected drain time summed PER BUCKET
  ((queued + in-flight batches) × that bucket's EMA service time, from
  `ServeMetrics.ema_service_s`), so a backed-up 224² bucket does not
  inflate the retry estimate of a cheap waveform bucket. The same
  projection (`projected_drain_s`) is the fleet's load-aware routing
  signal (`serve.fleet`) — reject-with-retry-after, never unbounded
  buffering.
- **Coalescing** (DESIGN.md "Admission & coalescing"): the worker serves
  the bucket whose head request is oldest, holding its dispatch inside an
  admission window — ``coalesce_ms`` when set, else ``max_wait_ms`` —
  until the bucket is FULL, the window expires, or the oldest queued
  deadline cannot survive sitting out the rest of the window plus one
  EMA batch service (early release). ``coalesce_ms=0`` (the default for
  direct constructions) is exactly the historical max_wait behavior;
  ``ServeConfig.coalesce_ms`` defaults it on for config-built servers.
  Independent single-item ``submit()``s from many clients pack into one
  full bucket dispatch instead of N replicate-padded ones.
- **QoS lanes**: ``submit(..., qos="interactive"|"batch")`` places the
  request in one of two FIFO lanes per bucket. The pop drains the
  interactive lane first and BACKFILLS a partially-full interactive
  dispatch from the batch lane (padding rows that would be replicated
  anyway carry real batch work instead); bucket selection prefers buckets
  with interactive work. The admission window is still anchored at the
  oldest head across both lanes, so batch work cannot starve.
- **Deadlines**: a request whose deadline lapses while queued (including
  while held in the admission window) is completed with
  `DeadlineExceededError` at pop time, BEFORE slot accounting — expired
  requests leave the lanes without displacing live ones from the take.
- **Result cache** (``result_cache=``, `serve.result_cache.ResultCache`):
  `submit` consults a content-addressed cache before admission; hits
  resolve the future immediately — no queue, no memory admission, no
  batch slot. Worker harvest populates it per real row. Off by default
  for direct constructions (``ServeConfig.result_cache_mb`` turns it on
  in config-built servers); ``WAM_TPU_NO_RESULT_CACHE=1`` kills it live.
- **Degradation** (opt-in, never silent): with a ``fallback_factory``,
  if the entry raises mid-run and `config.probe_accelerator` (a fresh
  probe, in a subprocess) says the card is gone, the server swaps in the
  factory's entry (a CPU rebuild) once, warns (`RuntimeWarning`), replays
  the failed batch on it, and keeps serving with ``degraded`` true in the
  ledger. Without a factory an entry failure fails the batch's requests
  with the entry's error. Nothing here falls back from a kernel to its
  plain version.
- **Shutdown**: `close()` stops intake immediately, drains queued work
  (including any in-flight batch), then joins the worker.
- **Pipelining** (``pipelined=True``, the default): the worker keeps one
  batch in flight — it assembles batch *k+1* into pinned host memory,
  stages it (`pipeline.put_committed`: an asynchronous copy on a side
  stream) and dispatches it (the entry enqueues its kernels) *before*
  harvesting batch *k*, so host assembly, the copy and the host's enqueue
  overlap the card's compute instead of serializing with it. Each batch's
  result crosses to the host once, through `evalsuite.fan.device_fetch`,
  on a fetch stream that waits for an event recorded behind that batch's
  own work: a copy on the compute stream would queue behind batch *k+1*,
  which is already enqueued there, and hold batch *k*'s results (and the
  next dispatch) back a whole batch.
  Entry exceptions that surface at the deferred fetch go through the same
  degradation path as dispatch-time failures (the host batch is kept for
  replay).
- **Device pinning** (``device=``): every staged batch (and the warmup
  zeros) goes to this server's device, and the worker thread makes it the
  current CUDA device. ``device=None`` is the current card
  (`device.resolve_device`); ``"cpu"`` runs the entries on the CPU, as the
  tests do. The worker runs with grad mode on (never `torch.inference_mode`:
  the entries differentiate).
- **Multi-model residency** (``models=``, `serve.models`): the server
  multiplexes extra models behind the same admission plane — queues,
  in-flight accounting, EMA service times, result-cache keys, and memory
  watermarks all key on ``(model, bucket)``; ``submit(model=...)`` pages
  a cold model in synchronously (build + warmup under a ``model_switch``
  span) and the pager evicts idle models under the memory budget. The
  default entry is model ``None``: pinned, never paged, byte-identical
  behavior to a single-model server.
- **Tenant fairness** (``submit(tenant=)``): within each QoS lane the pop
  round-robins across tenants (single-tenant traffic keeps exact FIFO),
  ``tenant_quota`` caps one tenant's share of the bounded queue, and the
  SLO ladder extends to ``bucket@class@tenant`` windows — one flooding
  tenant cannot monopolize admission, dispatch order, or the error
  budget accounting of the others.

Buckets warm one after another at `start()` (the reference warms them
concurrently because XLA compiles in parallel; on one card the warmups
share one stream, and two buckets' working sets at once would double the
peak), on the worker thread: cuDNN keeps state per host thread (its
execution plans), so a warmup on the caller's thread would leave the
worker's first batch of each bucket to build it again.

Cold start: ``registry=`` hydrates a bundle of `wam_tpu_torch.registry`
before any warmup, and ``compilation_cache=True`` points the compile caches
at their persistent directory (`config.enable_compilation_cache`), so an
entry built with an AOT key (`serve.entry.jit_entry`) warms from cached
artifacts at ``compile_count == 0``.
"""

from __future__ import annotations

import contextlib
import threading
import time
import warnings
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from wam_tpu_torch.device import resolve_device
from wam_tpu_torch.evalsuite.fan import device_fetch
from wam_tpu_torch.obs import health as obs_health
from wam_tpu_torch.obs import memory as obs_memory
from wam_tpu_torch.obs import sentinel as obs_sentinel
from wam_tpu_torch.obs import slo as obs_slo
from wam_tpu_torch.obs import tracing as obs_tracing
from wam_tpu_torch.pipeline.stager import put_committed
from wam_tpu_torch.profiling import device_sync
from wam_tpu_torch.serve.buckets import Bucket, BucketTable, bucket_key
from wam_tpu_torch.serve.metrics import ServeMetrics
from wam_tpu_torch.serve.models import ModelPager, ModelSpec
from wam_tpu_torch.serve.result_cache import ResultCache

__all__ = [
    "AttributionServer",
    "ServeError",
    "QueueFullError",
    "MemoryAdmissionError",
    "DeadlineExceededError",
    "InvalidDeadlineError",
    "ServerClosedError",
    "WorkerCrashedError",
    "QOS_CLASSES",
]

# admission lanes, in drain order (interactive first, batch backfills)
QOS_CLASSES = ("interactive", "batch")


class ServeError(RuntimeError):
    """Base class for serving-runtime request failures."""


class QueueFullError(ServeError):
    """Backpressure: the bounded queue is full. ``retry_after_s`` is the
    server's estimate of when capacity frees up — clients should back off
    at least that long before resubmitting."""

    def __init__(self, retry_after_s: float):
        super().__init__(f"queue full; retry after {retry_after_s:.3f}s")
        self.retry_after_s = retry_after_s


class MemoryAdmissionError(QueueFullError):
    """Cold-bucket admission rejected: warming this bucket's projected
    memory watermark would exceed the configured device budget
    (`wam_tpu_torch.obs.memory.MemoryBudget`). A `QueueFullError` subclass so
    clients and the fleet treat it as ordinary backpressure — retry after
    ``retry_after_s`` (by then warm buckets may have drained, or an
    operator raised the budget)."""

    def __init__(self, retry_after_s: float, bucket: str = ""):
        ServeError.__init__(
            self,
            f"cold bucket {bucket or '?'} over memory budget; "
            f"retry after {retry_after_s:.3f}s")
        self.retry_after_s = retry_after_s
        self.bucket = bucket


class DeadlineExceededError(ServeError):
    """The request's deadline lapsed while it was still queued."""


class InvalidDeadlineError(ServeError, ValueError):
    """``submit(deadline_ms=)`` with a zero or negative window: rejected at
    admission, carrying the offending value. (Before this check, a
    non-positive window silently computed an already-past absolute
    deadline, queued the request, and expired it at pop time — a client
    bug surfaced as a confusing `DeadlineExceededError` after a full queue
    round-trip.) Also a `ValueError`, since the deadline is a bad
    *argument*, not a runtime condition."""

    def __init__(self, deadline_ms):
        super().__init__(
            f"deadline_ms must be > 0 (or None for no deadline), "
            f"got {deadline_ms!r}")
        self.deadline_ms = deadline_ms


class ServerClosedError(ServeError):
    """`submit` after `close()` (or during drain)."""


class WorkerCrashedError(ServerClosedError):
    """The device-owner worker thread itself died (an exception OUTSIDE
    the per-batch entry/recover path). Queued futures are failed with this
    instead of hanging forever; a `ServerClosedError` subclass."""


@dataclass
class _Request:
    x: np.ndarray
    y: int | None
    bucket: Bucket
    t_submit: float
    deadline: float | None  # perf_counter timestamp, None = no deadline
    future: Future = field(default_factory=Future)
    # obs trace identity: (trace_id, span_id) this request's spans parent
    # to — captured at submit (the fleet router's context, or a fresh root
    # this server starts for direct submits)
    ctx: tuple | None = None
    qos: str = "interactive"  # admission lane (QOS_CLASSES)
    ckey: str | None = None  # result-cache key (None = cache off)
    # anytime serving: per-request confidence floor for the convergence
    # early exit (0.0 = any converged delivery clears it)
    min_confidence: float = 0.0
    model: str | None = None  # paged model id (None = the default entry)
    tenant: str | None = None  # fair-share identity (None = untracked)


class _Lanes:
    """One bucket's queue as two FIFO lanes (module docstring "QoS
    lanes"), tenant-fair within each lane: `pop` round-robins across the
    tenants present (FIFO within a tenant, rotating start so no tenant
    owns slot 0), which degenerates to exact FIFO when every request
    carries the same (or no) tenant. Only ever touched under the
    server's ``_cond``."""

    __slots__ = ("interactive", "batch", "_rr")

    def __init__(self):
        self.interactive: list[_Request] = []
        self.batch: list[_Request] = []
        self._rr = 0  # rotating round-robin start across tenants

    def __len__(self) -> int:
        return len(self.interactive) + len(self.batch)

    def append(self, r: _Request) -> None:
        (self.interactive if r.qos == "interactive" else self.batch).append(r)

    def head(self) -> _Request:
        """Oldest request across both lanes — the admission window (and
        the served-oldest-bucket choice) anchor here so the batch lane
        cannot starve behind a steady interactive trickle."""
        if self.interactive and self.batch:
            a, b = self.interactive[0], self.batch[0]
            return a if a.t_submit <= b.t_submit else b
        return (self.interactive or self.batch)[0]

    def min_deadline(self) -> float | None:
        """Tightest queued deadline (the early-release trigger)."""
        ds = [r.deadline for r in self.interactive if r.deadline is not None]
        ds += [r.deadline for r in self.batch if r.deadline is not None]
        return min(ds) if ds else None

    def drop_expired(self, now: float) -> list[_Request]:
        """Remove (and return) every request whose deadline lapsed — runs
        at pop time, before slot accounting, so an expired request never
        displaces a live one from the take (deadline hygiene)."""
        expired = [r for r in self.interactive
                   if r.deadline is not None and now > r.deadline]
        expired += [r for r in self.batch
                    if r.deadline is not None and now > r.deadline]
        if expired:
            gone = set(map(id, expired))
            self.interactive = [r for r in self.interactive
                                if id(r) not in gone]
            self.batch = [r for r in self.batch if id(r) not in gone]
        return expired

    def _fair_take(self, lane: str, k: int) -> list[_Request]:
        """Up to ``k`` requests from one lane, round-robin across the
        tenants present (FIFO within each tenant). One tenant in the lane
        is EXACTLY the historical FIFO slice — the fair path only engages
        on genuinely multi-tenant traffic."""
        reqs = getattr(self, lane)
        if k <= 0 or not reqs:
            return []
        order: list = []
        by_tenant: dict = {}
        for r in reqs:
            if r.tenant not in by_tenant:
                by_tenant[r.tenant] = []
                order.append(r.tenant)
            by_tenant[r.tenant].append(r)
        if len(order) <= 1:
            take = reqs[:k]
            del reqs[:k]
            return take
        start = self._rr % len(order)
        self._rr += 1
        order = order[start:] + order[:start]
        take: list[_Request] = []
        idx = dict.fromkeys(order, 0)
        while len(take) < k:
            progressed = False
            for t in order:
                if len(take) >= k:
                    break
                queued = by_tenant[t]
                if idx[t] < len(queued):
                    take.append(queued[idx[t]])
                    idx[t] += 1
                    progressed = True
            if not progressed:
                break
        gone = set(map(id, take))
        setattr(self, lane, [r for r in reqs if id(r) not in gone])
        return take

    def pop(self, k: int) -> list[_Request]:
        """Up to ``k`` requests: the interactive lane drains first, the
        batch lane backfills the remaining rows; each lane drains
        tenant-fair (`_fair_take`)."""
        take = self._fair_take("interactive", k)
        fill = k - len(take)
        if fill > 0 and self.batch:
            take += self._fair_take("batch", fill)
        return take

    def clear(self) -> list[_Request]:
        reqs = self.interactive + self.batch
        self.interactive = []
        self.batch = []
        return reqs


@dataclass
class _Inflight:
    """A dispatched-but-unharvested batch: ``out`` is the entry's (possibly
    still computing) result; the host-side ``xs``/``ys`` are kept so a
    failure surfacing at harvest can replay on the fallback entry."""

    bucket: Bucket
    live: list
    depth: int
    xs: np.ndarray
    ys: np.ndarray | None
    t0: float
    out: object
    # numeric-health vector (on the device) riding the same harvest as
    # ``out`` — None when the health plane is off
    hvec: object = None
    # anytime serving: the (B, ANYTIME_VEC_SIZE) confidence vector (device)
    # riding the same harvest, and the driver's stride-loop info dict
    # (n_used / n_total / complete / converged / strides / deadline_hit) —
    # both None on a plain full-n batch
    cvec: object = None
    anytime: dict | None = None
    model: str | None = None  # paged model id (None = the default entry)
    # on a card: an event recorded on the compute stream behind the batch's
    # work; the harvest copies the result on the fetch stream behind this
    # event only, not behind the next batch already enqueued
    done: object = None


_NOT_READY = object()  # non-blocking _take_batch: nothing poppable yet

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
                 np.dtype(np.float16): torch.float16}


@contextlib.contextmanager
def _grad_on(device: torch.device):
    """Grad mode on, inference mode off, and ``device`` current on a card:
    what the serving entries need on the thread that runs them, whatever
    mode that thread is in."""
    with torch.inference_mode(False), torch.enable_grad():
        if device.type == "cuda":
            with torch.cuda.device(device):
                yield
        else:
            yield


def _host(t):
    """A staged batch leaf back as the host array the replay path takes."""
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def _row(out, i: int):
    """Row ``i`` of every leaf of a fetched (host) result tree."""
    if isinstance(out, dict):
        return {k: _row(v, i) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_row(v, i) for v in out)
    return np.asarray(out)[i]


class AttributionServer:
    """See module docstring.

    Parameters
    ----------
    entry : ``(x, y) -> attribution tree`` with leading batch axis on
        every leaf (an engine's ``serve_entry()`` or any callable taking the
        staged tensors).
    buckets : `BucketTable` or iterable of admitted item shapes.
    max_batch : rows per dispatched batch (every batch is padded to exactly
        this, so each bucket has one input signature).
    max_wait_ms : max time a head-of-bucket request waits for batch fill.
    coalesce_ms : cross-request admission window (module docstring
        "Coalescing"). 0 (default) = historical max_wait behavior; > 0
        holds a bucket's dispatch up to this long for batch fill, with
        deadline-pressure early release. Config-built servers default it
        on via ``ServeConfig.coalesce_ms``.
    queue_depth : bound on queued items across all buckets (backpressure).
    deadline_ms : default per-request deadline (0 = none; per-`submit`
        override).
    labeled : whether requests carry a class label. ``labeled=False``
        servers dispatch ``entry(x, None)`` (representation mode); mixing
        labeled and unlabeled requests in one server would need two graphs
        per bucket, so it is rejected at `submit`.
    warmup : run every bucket's first call at `start()`, so no request
        ever pays it on the hot path.
    compilation_cache : call `config.enable_compilation_cache()` at
        `start()`, after any registry hydration and before warmup.
    metrics : a shared `ServeMetrics`; constructed fresh when None. Pass
        the same object given to ``serve_entry(on_trace=...)`` so first-call
        counts land in the same ledger.
    metrics_path : when set, `close()` emits the batch rows + summary to
        this JSONL ledger (`results.JsonlWriter`).
    fallback_factory : zero-arg callable building an entry for degraded
        serving, e.g. a CPU rebuild (module docstring); None (default):
        no degradation.
    dtype : host dtype items are staged as (one contiguous transfer per
        batch).
    pipelined : keep one batch in flight — stage + dispatch batch *k+1*
        before harvesting batch *k* (module docstring "Pipelining").
        ``False`` restores the synchronous dispatch-then-distribute loop.
    device : the device every staged batch (and warmup) goes to; None is
        the current card or RuntimeError (`device.resolve_device`), "cpu"
        runs on the CPU (module docstring "Device pinning").
    replica_id : this worker's identity in a ledger (None = a lone
        server); forwarded to a freshly constructed `ServeMetrics`.
    health : numeric-health monitoring (`wam_tpu_torch.obs.health`): True
        or a `HealthConfig` builds a per-server `HealthMonitor`; an existing
        monitor is used as-is; None/False (default) disables. Health-fused
        entries (``serve_entry(with_health=True)``) compute the stats in
        their own call; other entries get a post-hoc on-device reduction —
        either way the vector is harvested in the worker's ONE existing
        `device_fetch`, zero extra fetches.
    slo : SLO objectives (`wam_tpu_torch.obs.slo`): a policy string / map /
        `SLObjectives` builds a per-server `SLOTracker`; an existing
        tracker is used as-is; None/"" disables. The tracker is attached
        to ``metrics.slo`` so `close()` writes the ``slo_status`` ledger
        row.
    memory : device memory accounting (`wam_tpu_torch.obs.memory`): a byte
        budget (int)
        builds a per-server `MemoryBudget` on this server's device; an
        existing budget is used as-is; None/0 disables the admission check
        (watermarks are still captured when a budget object is given).
    registry : compile-artifact bundle to hydrate from BEFORE any warmup
        compile (`wam_tpu_torch.registry`): a bundle path or
        `RegistryClient`; None/"" (default) skips. The `HydrationReport`
        is kept as ``registry_report`` and, when ``metrics_path`` is set,
        written as a ``registry_hydration`` ledger row.
    result_cache : content-addressed result cache
        (`serve.result_cache.ResultCache`): an int byte budget builds a
        per-server cache; an existing instance is SHARED as-is;
        None/0 (default) disables — direct constructions keep exact
        pre-cache accounting (``completed == submitted`` stays pinned by
        tests), ``ServeConfig.result_cache_mb`` turns it on for
        config-built servers.
    cache_id : entry/model identity baked into cache keys; defaults to the
        entry's ``__name__`` (or type name). Pass an explicit id when one
        `ResultCache` instance must distinguish entries.
    models : extra paged models this server multiplexes
        (`serve.models.ModelSpec` iterable or ``{model_id: spec}`` map;
        None = single-model server, byte-identical historical behavior).
        Each spec's entry pages in on the first ``submit(model=...)`` —
        build + warmup under a ``model_switch`` span — and pages out under
        the memory budget's byte bound when idle
        (module docstring "Multi-model residency"). Paged models get no
        degradation fallback and no anytime semantics; those stay
        properties of the pinned default entry.
    tenant_quota : one tenant's maximum share of ``queue_depth`` as a
        fraction (0 = off). With it, a ``submit(tenant=...)`` whose
        tenant already holds ``ceil(queue_depth × quota)`` queued items
        is rejected with `QueueFullError` while other tenants (and
        tenant-less submits) still admit — per-tenant admission
        isolation in front of the fair lanes.
    """

    # checked by the lock-discipline lint rule: these attributes may only
    # be mutated inside `with self._cond:` outside __init__
    _GUARDED_BY = {
        "_queues": "_cond",
        "_popped": "_cond",
        "_active": "_cond",
        "_pending": "_cond",
        "_tenant_pending": "_cond",
        "_closed": "_cond",
        "_started": "_cond",
    }

    def __init__(
        self,
        entry,
        buckets,
        *,
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
        coalesce_ms: float = 0.0,
        queue_depth: int = 64,
        deadline_ms: float = 0.0,
        labeled: bool = True,
        warmup: bool = True,
        compilation_cache: bool = False,
        metrics: ServeMetrics | None = None,
        metrics_path: str | None = None,
        fallback_factory=None,
        dtype=np.float32,
        pipelined: bool = True,
        device=None,
        replica_id=None,
        auto_start: bool = True,
        health=None,
        slo=None,
        memory=None,
        registry=None,
        result_cache=None,
        cache_id: str | None = None,
        models=None,
        tenant_quota: float = 0.0,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        if coalesce_ms < 0:
            raise ValueError("coalesce_ms must be >= 0")
        self._entry = entry
        self._registry = registry
        # the hydration's HydrationReport (None when no bundle was given,
        # or not started yet)
        self.registry_report = None
        # anytime serving (wam_tpu_torch.anytime): an entry built by
        # make_anytime_entry flips the server into progressive-refinement
        # mode — deadlines deliver best-so-far AnytimeResults instead of
        # raising, converged batches exit early. WAM_TPU_NO_ANYTIME=1 is
        # the kill switch: the entry's full-n __call__ serves as a plain
        # entry and every anytime semantic (including min_confidence)
        # is disabled.
        import os

        self._anytime = (bool(getattr(entry, "wam_anytime", False))
                         and os.environ.get("WAM_TPU_NO_ANYTIME") != "1")
        self.table = buckets if isinstance(buckets, BucketTable) else BucketTable(buckets)
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.coalesce_s = coalesce_ms / 1e3
        self.queue_depth = queue_depth
        self.default_deadline_s = deadline_ms / 1e3 if deadline_ms else None
        self.labeled = labeled
        self.warmup = warmup
        self.compilation_cache = compilation_cache
        self.replica_id = replica_id
        self.metrics = metrics if metrics is not None else ServeMetrics(replica_id=replica_id)
        self.metrics_path = metrics_path
        self._fallback_factory = fallback_factory
        self.dtype = dtype
        self.pipelined = pipelined
        self._device = resolve_device(device)
        if self._device.type == "cuda" and self._device.index is None:
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._fetch_stream = (torch.cuda.Stream(self._device)
                              if self._device.type == "cuda" else None)
        self.degraded = False

        # health plane (DESIGN.md "Health plane"): all three default off so
        # direct constructions keep their exact pre-health behavior
        if isinstance(health, obs_health.HealthMonitor):
            self._health = health
        elif health:
            cfg = health if isinstance(health, obs_health.HealthConfig) else None
            self._health = obs_health.HealthMonitor(cfg, replica_id=replica_id)
        else:
            self._health = None
        if isinstance(slo, obs_slo.SLOTracker):
            self._slo = slo
        elif slo:
            self._slo = obs_slo.SLOTracker(slo, replica_id=replica_id)
        else:
            self._slo = None
        if self._slo is not None:
            # the ledger hook: ServeMetrics.emit writes the slo_status row
            self.metrics.slo = self._slo
        if isinstance(memory, obs_memory.MemoryBudget):
            self._memory = memory
        elif memory:
            self._memory = obs_memory.MemoryBudget(
                int(memory), device=self._device, replica_id=replica_id)
        else:
            self._memory = None
        # result cache (module docstring): off by default so direct
        # constructions keep exact pre-cache request accounting
        if isinstance(result_cache, ResultCache):
            self._cache = result_cache
        elif result_cache:
            self._cache = ResultCache(
                int(result_cache),
                cache_id=cache_id if cache_id is not None else getattr(
                    entry, "__name__", type(entry).__name__))
        else:
            self._cache = None
        if self._cache is not None:
            # the ledger hook: ServeMetrics.emit writes the result_cache row
            self.metrics.result_cache = self._cache

        # multi-model residency (serve.models): the pager owns page-in /
        # eviction; queues and in-flight accounting key on (model, bucket)
        # with model None = the pinned default entry
        if models:
            self._pager = ModelPager(
                models,
                budget_bytes=(self._memory.budget_bytes
                              if self._memory is not None else None),
                replica_id=replica_id,
                ema_fn=self._model_ema_s,
                busy_fn=self._model_busy,
                retry_after_s=(self._memory.retry_after_s
                               if self._memory is not None else 1.0))
        else:
            self._pager = None
        self.tenant_quota = float(tenant_quota)
        if not 0.0 <= self.tenant_quota <= 1.0:
            raise ValueError(
                f"tenant_quota must be in [0, 1], got {tenant_quota}")

        self._cond = threading.Condition()
        # queue/in-flight keys: (model_id | None, Bucket) — one lane pair
        # per model × admitted bucket, precreated so the locked paths never
        # mutate the dict structure
        self._queues: dict[tuple, _Lanes] = {
            (None, b): _Lanes() for b in self.table}
        if self._pager is not None:
            for mid, spec in self._pager.specs.items():
                for b in self._model_buckets(spec):
                    self._queues[(mid, b)] = _Lanes()
        # popped-but-unresolved requests: the crash guard's reach into
        # batches already taken off the queues (see _fail_pending)
        self._popped: list[_Request] = []
        # popped-but-unfinished batches per (model, bucket): the in-flight
        # half of the projected drain time (queued items alone would read
        # an actively serving replica as idle)
        self._active: dict[tuple, int] = dict.fromkeys(self._queues, 0)
        self._pending = 0
        # queued items per tenant (admission quota accounting; tenant-less
        # submits are not tracked)
        self._tenant_pending: dict[str, int] = {}
        self._closed = False
        self._started = False
        self._worker: threading.Thread | None = None
        self._degrade_lock = threading.Lock()
        if auto_start:
            self.start()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "AttributionServer":
        """Launch the worker, which warms every bucket (its first call — the
        only first calls this server will ever make) before it serves, and
        wait for that warmup; a warmup error is raised here. Idempotent.

        Buckets warm one after another, on the worker thread (module
        docstring). Per-bucket warmup seconds land in the ledger
        (`ServeMetrics.note_warmup` → ``warmup_s``)."""
        if self._started:
            return self
        if self._registry is not None and self._registry != "":
            # hydrate FIRST: seeded compiled steps make the bucket warmups
            # below compile-free, the bundle's compile-cache files must be
            # in place before the compile cache is pointed at them, and the
            # schedule snapshot must land before the entries read the table
            from wam_tpu_torch.registry.client import resolve_client

            client = resolve_client(self._registry)
            if client is not None:
                self.registry_report = client.hydrate()
        if self.compilation_cache:
            from wam_tpu_torch.config import enable_compilation_cache

            enable_compilation_cache()
        warmed, failed = threading.Event(), []
        self._worker = threading.Thread(
            target=self._worker_loop, args=(warmed, failed), name="wam-serve-worker",
            daemon=True
        )
        with self._cond:
            self._started = True
        self._worker.start()
        warmed.wait()
        if failed:  # not started: the server is as it was before the call
            self._worker.join()
            self._worker = None
            with self._cond:
                self._started = False
            raise failed[0]
        return self

    def _warm(self) -> None:
        """Every bucket's first call, on the calling (worker) thread."""
        for bucket in self.table:
            t0 = time.perf_counter()
            # sentinel attribution: first calls here are the expected
            # warmup ones, not steady-state new signatures
            with obs_sentinel.label(
                replica=self.replica_id,
                bucket=bucket_key(bucket.shape),
                phase="warmup",
            ):
                self._sync_dispatch(*self._stage_zeros(bucket))
            self.metrics.note_warmup(bucket.shape, time.perf_counter() - t0)
            if self._memory is not None:
                # per-bucket watermark right after the warmup dispatch:
                # the allocator's peak where the device reports it, the
                # shape-derived estimate otherwise
                self._memory.capture_watermark(
                    bucket_key(bucket.shape), self._estimate_bytes(bucket))

    def close(self, emit_metrics: bool = True) -> None:
        """Stop intake, drain queued requests, join the worker, and (when
        ``metrics_path`` is set) flush the ledger."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join()
        if emit_metrics and self.metrics_path:
            from wam_tpu_torch.results import JsonlWriter

            writer = JsonlWriter(self.metrics_path)
            if self.registry_report is not None:
                writer.write(self.registry_report.row())
            if self._pager is not None:
                self.metrics.models_resident = self.models_resident()
            self.metrics.emit(writer, config=self.describe())
        with self._cond:
            self._started = False

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    def describe(self) -> dict:
        return {
            "buckets": [list(b.shape) for b in self.table],
            "max_batch": self.max_batch,
            "max_wait_ms": self.max_wait_s * 1e3,
            "coalesce_ms": self.coalesce_s * 1e3,
            "result_cache": (self._cache.stats()
                             if self._cache is not None else None),
            "queue_depth": self.queue_depth,
            "labeled": self.labeled,
            "pipelined": self.pipelined,
            "degraded": self.degraded,
            "replica_id": self.replica_id,
            "device": str(self._device),
            "health": self._health.describe() if self._health is not None else None,
            "slo": (
                {k: vars(v) for k, v in self._slo.policy.items()}
                if self._slo is not None
                else None
            ),
            "memory": self._memory.describe() if self._memory is not None else None,
            "registry": (getattr(self._registry, "bundle", None)
                         or (str(self._registry) if self._registry else None)),
            "models": (self._pager.describe()
                       if self._pager is not None else None),
            "tenant_quota": self.tenant_quota,
        }

    # -- client side --------------------------------------------------------

    def submit(self, x, y=None, deadline_ms: float | None = None,
               qos: str = "interactive",
               min_confidence: float = 0.0,
               model: str | None = None,
               tenant: str | None = None) -> Future:
        """Enqueue one item (NO leading batch axis — a client batch is a
        sequence of submits, coalesced back together by the worker).
        ``qos`` picks the admission lane (module docstring "QoS lanes").
        ``model`` routes to a configured paged model (None = the default
        entry), paying the synchronous page-in when it is cold. ``tenant``
        is the request's fair-share identity: it keys the per-tenant lane
        round-robin, the admission quota, the result-cache partition, and
        the ``bucket@class@tenant`` SLO window. Returns a
        `concurrent.futures.Future` resolving to the item's attribution
        (leading axis stripped), or raising `ServeError`.

        On an ANYTIME server (entry built by
        `wam_tpu_torch.anytime.make_anytime_entry`) the future resolves to an
        `AnytimeResult`: a closing ``deadline_ms`` window delivers the
        best-so-far map + confidence instead of raising
        `DeadlineExceededError`, and ``min_confidence`` is the floor every
        batch row must clear for the convergence early exit. A zero or
        negative ``deadline_ms`` is a client bug and fails at admission
        with `InvalidDeadlineError` (any server kind)."""
        if self.labeled and y is None:
            raise ValueError("labeled server: submit(x, y) needs a class label")
        if not self.labeled and y is not None:
            raise ValueError("unlabeled server: submit() must not carry a label")
        if qos not in QOS_CLASSES:
            raise ValueError(f"qos must be one of {QOS_CLASSES}, got {qos!r}")
        if deadline_ms is not None and deadline_ms <= 0:
            raise InvalidDeadlineError(deadline_ms)
        if min_confidence:
            if not self._anytime:
                raise ValueError(
                    "min_confidence needs an anytime server (an entry built "
                    "by wam_tpu_torch.anytime.make_anytime_entry)")
            if not 0.0 <= min_confidence <= 1.0:
                raise ValueError(
                    f"min_confidence must be in [0, 1], got {min_confidence}")
        if model is not None:
            if self._pager is None or model not in self._pager.specs:
                known = (sorted(self._pager.specs)
                         if self._pager is not None else [])
                raise ValueError(
                    f"unknown model {model!r}; configured paged models: "
                    f"{known}")
            if min_confidence:
                raise ValueError(
                    "min_confidence is an anytime semantic of the default "
                    "entry; paged models serve plain full-n results")
        x = np.asarray(x, self.dtype)
        bucket = self.table.select(x.shape)  # NoBucketError before any queueing
        if model is not None and (model, bucket) not in self._queues:
            raise ValueError(
                f"model {model!r} does not serve bucket "
                f"{bucket_key(bucket.shape)}")
        self.metrics.note_submit()
        ckey = None
        if self._cache is not None and self._anytime and model is None:
            # anytime results are NOT cached: what a request gets back
            # depends on the batch's deadline/convergence trajectory, so a
            # cached partial would violate the bit-identical-hit contract
            pass
        elif self._cache is not None:
            # consult BEFORE admission: a hit resolves immediately and
            # never touches the queue, memory admission, a batch slot —
            # or, for a cold paged model, the page-in itself
            ckey = self._cache.key(x, y, model=model)
            hit = self._cache.get(ckey, tenant=tenant)
            if hit is not None:
                self.metrics.note_cache_hit()
                fut: Future = Future()
                fut.set_result(hit)
                return fut
        if model is not None:
            # synchronous page-in on the submitting thread: the first
            # request for a cold model pays (and measures) the switch;
            # `MemoryAdmissionError` here is ordinary backpressure
            self._ensure_model(model)
        if self._memory is not None:
            retry_after = self._memory.admit(
                self._lkey(model, bucket), self._estimate_bytes(bucket))
            if retry_after is not None:
                self.metrics.note_reject()
                raise MemoryAdmissionError(
                    retry_after, bucket=self._lkey(model, bucket))
        now = time.perf_counter()
        if deadline_ms is None:
            deadline = (now + self.default_deadline_s) if self.default_deadline_s else None
        else:
            deadline = now + deadline_ms / 1e3
        req = _Request(x, y, bucket, now, deadline, qos=qos, ckey=ckey,
                       min_confidence=float(min_confidence),
                       model=model, tenant=tenant)
        if obs_tracing._STATE.enabled:
            ctx = obs_tracing.current_context()
            if ctx is None:
                # direct (fleet-less) submit: this server owns the request
                # root span, ended when the future resolves either way
                root = obs_tracing.start_span(
                    "request", cat="serve",
                    bucket="x".join(str(d) for d in bucket.shape),
                    replica=self.replica_id)
                ctx = root.context
                req.future.add_done_callback(
                    lambda f: root.end(
                        error=type(f.exception()).__name__
                        if f.exception() else None))
            req.ctx = ctx
        with self._cond:
            if self._closed or not self._started:
                raise ServerClosedError("server is not accepting requests")
            if self._worker is not None and not self._worker.is_alive():
                raise WorkerCrashedError(
                    "serve worker is not running; the server cannot serve")
            if self._pending >= self.queue_depth:
                self.metrics.note_reject()
                # the TARGET bucket's own drain: an idle bucket's clients
                # retry immediately instead of backing off behind an
                # unrelated hot bucket (the all-bucket sum stays the
                # fleet routing signal, projected_drain_s)
                raise QueueFullError(retry_after_s=self._drain_locked(bucket))
            if tenant is not None and self.tenant_quota > 0.0:
                # per-tenant admission quota: one tenant's queued share is
                # capped, so a flooding tenant hits backpressure while the
                # others keep admitting into the same bounded queue
                cap = max(1, int(self.queue_depth * self.tenant_quota))
                if self._tenant_pending.get(tenant, 0) >= cap:
                    self.metrics.note_reject()
                    raise QueueFullError(
                        retry_after_s=self._drain_locked(bucket))
            self._queues[(model, bucket)].append(req)
            self._pending += 1
            if tenant is not None:
                self._tenant_pending[tenant] = (
                    self._tenant_pending.get(tenant, 0) + 1)
            self._cond.notify_all()
        return req.future

    def attribute(self, x, y=None, deadline_ms: float | None = None,
                  qos: str = "interactive", min_confidence: float = 0.0,
                  model: str | None = None, tenant: str | None = None):
        """Blocking convenience wrapper: submit + wait."""
        return self.submit(x, y, deadline_ms=deadline_ms, qos=qos,
                           min_confidence=min_confidence,
                           model=model, tenant=tenant).result()

    # -- load signal --------------------------------------------------------

    def _drain_locked(self, bucket: Bucket | None = None) -> float:
        """Projected seconds to drain everything queued + in flight:
        (queued batches + active batches) × that bucket's EMA service time
        (`ServeMetrics.ema_service_s`, seeded until the first batch
        lands). With a ``bucket``: that bucket's own drain — the
        `QueueFullError.retry_after_s` estimate, so a rejection against an
        idle bucket does not inherit an unrelated hot bucket's backlog.
        Without: the all-bucket sum — the fleet's routing score. Caller
        holds ``_cond``."""
        total = 0.0
        for (mid, b), q in self._queues.items():
            if bucket is not None and b is not bucket:
                continue
            n_batches = -(-len(q) // self.max_batch) + self._active[(mid, b)]
            if n_batches:
                total += n_batches * self.metrics.ema_service_s(
                    b.shape, model=mid)
        return total

    def projected_drain_s(self) -> float:
        """Thread-safe all-bucket `_drain_locked` — the load-aware dispatch
        signal the fleet router reads per submit (`serve.fleet.FleetServer`)."""
        with self._cond:
            return self._drain_locked()

    def qos_depths(self) -> dict[str, int]:
        """Queued items per QoS lane across all buckets — the fleet's
        interactive-pressure routing term (`FleetServer._score`) and the
        pod heartbeat's ``qos_depth`` signal (`FleetServer.pod_signals`)."""
        with self._cond:
            return {
                "interactive": sum(len(q.interactive)
                                   for q in self._queues.values()),
                "batch": sum(len(q.batch) for q in self._queues.values()),
            }

    def admission_free(self) -> int:
        """Free admission slots right now (``queue_depth - pending``,
        floored at 0) — the pod heartbeat's ``queue_free`` signal: 0
        means a submit would bounce `QueueFullError`, and the pod router
        deprioritizes the hop (a reject costs a cross-host round-trip
        on the tcp transport)."""
        with self._cond:
            return max(0, self.queue_depth - self._pending)

    def health_ok(self) -> bool:
        """Quarantine predicate for the fleet router: True when no health
        monitor is attached, the replica is healthy, or its quarantine has
        aged into probation (`obs.health.HealthMonitor.ok`)."""
        return self._health is None or self._health.ok()

    def slo_penalty_s(self, bucket_shape) -> float:
        """Burn-rate routing penalty for one bucket (0 without a tracker
        or at/below burn 1.0) — added to the fleet's load score so a
        replica burning its error budget sheds load before it dies."""
        if self._slo is None:
            return 0.0
        return self._slo.penalty_s(bucket_key(bucket_shape))

    # -- multi-model residency (serve.models) --------------------------------

    @staticmethod
    def _lkey(model: str | None, bucket: Bucket) -> str:
        """Ledger/EMA/watermark key for one (model, bucket) lane: the
        plain bucket key for the default model (every historical key is
        preserved verbatim), ``model|bucket`` for paged models."""
        bkey = bucket_key(bucket.shape)
        return bkey if model is None else f"{model}|{bkey}"

    def _model_buckets(self, spec: ModelSpec) -> list[Bucket]:
        """The server buckets a spec serves: its declared subset (each
        shape must be an admitted bucket) or every bucket."""
        if spec.buckets is None:
            return list(self.table)
        out = []
        for shape in spec.buckets:
            shape = tuple(shape)
            match = next((b for b in self.table if b.shape == shape), None)
            if match is None:
                raise ValueError(
                    f"model {spec.model_id!r} declares bucket {shape}, "
                    "which is not in the server's bucket table")
            out.append(match)
        return out

    def _model_ema_s(self, model_id: str) -> float:
        """Mean EMA batch service time across one model's buckets — the
        pager's eviction weight (0.0 until the model served a batch)."""
        prefix = f"{model_id}|"
        emas = [v for k, v in self.metrics.ema_service_s().items()
                if k.startswith(prefix)]
        return sum(emas) / len(emas) if emas else 0.0

    def _model_busy(self, model_id: str) -> bool:
        """Does this model have queued or in-flight work? Evictions of
        busy models are refused (`ModelPager._make_room`)."""
        with self._cond:
            for key, q in self._queues.items():
                if key[0] == model_id and (len(q) or self._active[key]):
                    return True
        return False

    def models_resident(self) -> dict[str, int]:
        """``{model_id: footprint_bytes}`` of resident paged models — the
        fleet heartbeat signal and the pod router's model affinity."""
        return self._pager.resident() if self._pager is not None else {}

    def _ensure_model(self, model: str) -> None:
        """Make ``model`` resident, paying the page-in synchronously on
        this (submit) thread — the measured model-switch latency."""
        self._pager.ensure(model, self._page_in)

    def _page_in(self, spec: ModelSpec):
        """One model's page-in, under its build lock (`ModelPager.ensure`):
        hydrate its registry bundle (seeded compiled steps make the warmups
        below loads, not compiles), build the entry, and warm every bucket
        the model serves — all inside one ``model_switch`` span so traces
        show the switch cost end-to-end. Returns ``(entry,
        footprint_bytes)``."""
        buckets = self._model_buckets(spec)
        est = int(spec.est_bytes) or sum(
            self._estimate_bytes(b) for b in buckets)
        with obs_tracing.span(
            "model_switch", cat="serve", model=spec.model_id,
            replica=self.replica_id,
        ):
            if spec.registry is not None and spec.registry != "":
                from wam_tpu_torch.registry.client import resolve_client

                client = resolve_client(spec.registry)
                if client is not None:
                    client.hydrate()
            entry = spec.factory()
            for bucket in buckets:
                with obs_sentinel.label(
                    replica=self.replica_id,
                    bucket=self._lkey(spec.model_id, bucket),
                    phase="pagein",
                ), _grad_on(self._device):
                    device_sync(entry(*self._stage_zeros(bucket)))
                if self._memory is not None:
                    self._memory.capture_watermark(
                        self._lkey(spec.model_id, bucket),
                        self._estimate_bytes(bucket))
        return entry, est

    # -- worker side --------------------------------------------------------

    def _zeros_batch(self, bucket: Bucket):
        x = np.zeros((self.max_batch,) + bucket.shape, self.dtype)
        y = np.zeros((self.max_batch,), np.int32) if self.labeled else None
        return x, y

    def _estimate_bytes(self, bucket: Bucket) -> int:
        """Shape-derived device-footprint estimate for one bucket — the
        memory-admission projection and the watermark fallback."""
        return obs_memory.estimate_entry_bytes(
            bucket.shape, self.max_batch, np.dtype(self.dtype).itemsize)

    def _stage_zeros(self, bucket: Bucket):
        """Warmup batch, staged to this server's device."""
        return put_committed(self._zeros_batch(bucket), self._device)

    def _call_entry(self, xs, ys):
        if self.degraded:
            self.metrics.note_fallback()
        return self._entry(xs, ys)

    def _recover(self, xs, ys):
        """Called from an ``except`` block after the entry failed (at
        dispatch or at the deferred harvest): with a ``fallback_factory``,
        degrade to its entry when the card has actually gone away (a forced
        re-probe in a subprocess tells a device loss from a plain bug — an
        in-process exception with a healthy card re-raises), warn, and
        replay the failed batch on it. Without a factory the failure is
        re-raised: nothing degrades unless the caller asked for it.
        ``xs``/``ys`` are the kept host buffers. The degrade transition is
        serialized so it cannot build the fallback entry twice."""
        if self._fallback_factory is None:
            raise
        with self._degrade_lock:
            if self.degraded:
                raise  # already on the fallback: this failure is its own
            from wam_tpu_torch import config

            if config.probe_accelerator():
                raise  # card healthy: the failure is not the device
            self._entry = self._fallback_factory()
            self.degraded = True
            warnings.warn(
                "serve: the card is gone; serving degraded on the fallback_factory "
                "entry from now on", RuntimeWarning, stacklevel=2)
        self.metrics.note_fallback()
        out = device_fetch(self._entry(xs, ys))
        # a health-fused fallback returns (out, hvec); replay consumers
        # only want the result tree (the batch already failed health-wise)
        if getattr(self._entry, "wam_health", False):
            out = out[0]
        return out

    def _behind(self, done):
        """The stream a harvest fetches on (module docstring
        "Pipelining"): on a card, the fetch stream made to wait for the
        batch's own ``done`` event, so the copy does not queue behind the
        next batch that pipelining has already put on the compute stream;
        elsewhere, the current stream."""
        if done is None:
            return contextlib.nullcontext()
        self._fetch_stream.wait_event(done)
        return torch.cuda.stream(self._fetch_stream)

    def _sync_dispatch(self, xs, ys):
        """Dispatch + harvest in one step (warmup and the non-pipelined
        loop)."""
        try:
            return device_fetch(self._call_entry(xs, ys))
        except Exception:
            return self._recover(_host(xs), _host(ys))

    def _tenants_left_locked(self, reqs: list[_Request]) -> None:
        """Release the per-tenant admission slots for requests leaving the
        lanes (popped into a batch or expired at pop). Callers already
        hold ``_cond``; the re-entrant acquire (Condition wraps an RLock)
        keeps the guarded mutation lexically inside the lock."""
        with self._cond:
            for r in reqs:
                if r.tenant is not None and r.tenant in self._tenant_pending:
                    n = self._tenant_pending[r.tenant] - 1
                    if n > 0:
                        self._tenant_pending[r.tenant] = n
                    else:
                        del self._tenant_pending[r.tenant]

    def _take_batch(self, block: bool = True):
        """Pop a ready batch (bucket full, admission window expired,
        deadline pressure, or draining at close). Returns ``((model,
        bucket), requests, queue_depth_at_pop, expired)``, None when closed and
        drained, or — with ``block=False`` — the `_NOT_READY` sentinel as
        soon as nothing is poppable *right now* (the pipelined worker uses
        this to go harvest the in-flight batch instead of sleeping on the
        queue). ``expired`` requests left the lanes at pop time without
        consuming a take slot; a pop may return ONLY expiries (empty
        ``requests`` — no ``_active`` increment, the worker just fails
        them and comes back)."""
        with self._cond:
            while True:
                if self._pending == 0:
                    if self._closed:
                        return None
                    if not block:
                        return _NOT_READY
                    self._cond.wait(0.05)
                    continue
                # serve the oldest head, preferring lanes with
                # interactive work (lanes drain interactive-first)
                key = min(
                    (k for k, q in self._queues.items() if len(q)),
                    key=lambda k: (0 if self._queues[k].interactive else 1,
                                   self._queues[k].head().t_submit),
                )
                bucket = key[1]
                q = self._queues[key]
                now = time.perf_counter()
                # deadline hygiene: expiries leave the lanes BEFORE slot
                # accounting, so they cannot displace live requests from
                # the take. Returned immediately (no pop) so their futures
                # fail outside the lock with no added hold time. An ANYTIME
                # server never drops: a lapsed deadline still gets
                # dispatched and delivers its best-so-far map (the driver
                # guarantees at least one stride).
                expired = [] if self._anytime else q.drop_expired(now)
                if expired:
                    self._pending -= len(expired)
                    self._tenants_left_locked(expired)
                    # crash-guard reach: until the worker fails them they
                    # live nowhere else (_fail_pending scans _popped)
                    self._popped = [r for r in self._popped
                                    if not r.future.done()]
                    self._popped.extend(expired)
                    return key, [], self._pending, expired
                head_wait = now - q.head().t_submit
                # the admission window: coalesce_ms when set, else the
                # historical max_wait bound (coalesce_ms=0 == old behavior)
                window_s = self.coalesce_s if self.coalesce_s > 0 else self.max_wait_s
                pressed = False
                dmin = q.min_deadline() if self.coalesce_s > 0 else None
                if dmin is not None:
                    # early release: the tightest queued deadline cannot
                    # survive sitting out the rest of the window plus one
                    # EMA batch service — go now, don't hold it to death
                    ema = self.metrics.ema_service_s(
                        bucket.shape, model=key[0])
                    pressed = dmin - now <= (window_s - head_wait) + ema
                if (
                    len(q) >= self.max_batch
                    or head_wait >= window_s
                    or pressed
                    or self._closed  # draining: don't sit out the window
                ):
                    take = q.pop(self.max_batch)
                    self._pending -= len(take)
                    self._tenants_left_locked(take)
                    self._active[key] += 1  # in flight until _finish_active
                    # only the worker thread mutates _popped; resolved
                    # entries age out here (at most ~2 batches stay live)
                    self._popped = [r for r in self._popped
                                    if not r.future.done()]
                    self._popped.extend(take)
                    return key, take, self._pending + len(take), []
                if not block:
                    return _NOT_READY
                wait_s = window_s - head_wait
                if dmin is not None:
                    # wake in time for the deadline-pressure release
                    wait_s = min(wait_s, max(dmin - now - ema, 0.0))
                self._cond.wait(max(wait_s, 1e-4))

    def _worker_loop(self, warmed: threading.Event, failed: list):
        try:
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)
            with _grad_on(self._device):
                try:
                    if self.warmup:
                        self._warm()
                except BaseException as e:  # noqa: BLE001 - raised by start()
                    failed.append(e)
                    return
                finally:
                    warmed.set()
                self._worker_loop_inner()
        except BaseException as e:  # noqa: BLE001 - crash guard (see below)
            # The loop body only reaches here through a bug outside the
            # guarded entry/recover paths (or an injected stager fault) —
            # without this guard every queued future would hang forever.
            self._fail_pending(WorkerCrashedError(
                f"serve worker crashed: {e!r}"))
            raise

    def _fail_pending(self, exc: Exception) -> None:
        """Stop intake and fail every unresolved request with ``exc`` —
        both the queued ones (the crashed worker can never pop them) and
        the popped-but-unresolved ones the crash stranded mid-batch."""
        with self._cond:
            self._closed = True
            reqs = [r for q in self._queues.values() for r in q.clear()]
            self._pending = 0
            self._tenant_pending = {}
            reqs += [r for r in self._popped if not r.future.done()]
            self._popped = []
            self._cond.notify_all()
        for r in reqs:
            r.future.set_exception(exc)
        if reqs:
            self.metrics.note_failed(len(reqs))

    def _worker_loop_inner(self):
        inflight: _Inflight | None = None
        while True:
            # Only block on the queue when nothing is in flight; otherwise
            # peek — either launch the next batch behind the in-flight one
            # or, with nothing poppable, harvest and come back.
            got = self._take_batch(block=inflight is None)
            if got is None:  # closed and drained
                if inflight is not None:
                    self._complete(inflight)
                return
            if got is _NOT_READY:
                self._complete(inflight)
                inflight = None
                continue
            key, reqs, depth, expired_at_pop = got
            # pop-time expiries never held a take slot (_take_batch drops
            # them before slot accounting); fail them outside the lock
            self._fail_expired(key[1], expired_at_pop)
            if not reqs:
                continue  # expiry-only wake: nothing was popped
            now = time.perf_counter()
            live, expired = [], []
            for r in reqs:
                # race-window recheck (pop -> here); _take_batch already
                # filtered, so this only catches deadlines that lapsed in
                # the microseconds since. Anytime servers serve lapsed
                # deadlines too (best-so-far delivery, never a drop).
                (expired if not self._anytime and r.deadline is not None
                 and now > r.deadline else live).append(r)
            self._fail_expired(key[1], expired)
            if not live:
                self._finish_active(key)
                continue
            batch = self._launch_batch(key, live, depth)
            if batch is None:  # failed at dispatch; futures already failed
                self._finish_active(key)
                continue
            if not self.pipelined:
                self._complete(batch)
                continue
            if inflight is not None:
                # batch k+1 is now queued on the device; harvesting k here
                # is exactly the overlap window
                self._complete(inflight)
            inflight = batch

    def _fail_expired(self, bucket: Bucket, expired: list[_Request]) -> None:
        """Fail expired requests with `DeadlineExceededError` and account
        them (per-QoS-class SLO errors)."""
        if not expired:
            return
        for r in expired:
            r.future.set_exception(
                DeadlineExceededError("deadline lapsed while queued")
            )
        self.metrics.note_expired(len(expired))
        if self._slo is not None:
            bkey = bucket_key(bucket.shape)
            groups: dict[tuple, int] = {}
            for r in expired:
                groups[(r.qos, r.tenant)] = groups.get((r.qos, r.tenant), 0) + 1
            for (qos, tenant), n in groups.items():
                self._slo.note_error(bkey, n, qos=qos, tenant=tenant)

    def _finish_active(self, key: tuple) -> None:
        with self._cond:
            self._active[key] -= 1

    def _launch_batch(self, key: tuple, live: list[_Request], depth: int):
        """Assemble the padded host batch, stage it to the device (async
        upload, committed to this server's device when pinned), and
        dispatch the entry WITHOUT harvesting the result."""
        mid, bucket = key
        n_real = len(live)
        with self.metrics.stages.stage("assemble"):
            # written straight into pinned host memory on a card, so the
            # upload is one asynchronous copy (pipeline.stager)
            xs_t = torch.empty((self.max_batch,) + bucket.shape,
                               dtype=_TORCH_DTYPES[np.dtype(self.dtype)],
                               pin_memory=self._device.type == "cuda")
            xs = xs_t.numpy()
            for i, r in enumerate(live):
                if r.x.shape == bucket.shape:
                    xs[i] = r.x
                else:  # right/bottom zero pad (serve.buckets.pad_item)
                    xs[i] = 0
                    xs[i][tuple(slice(0, d) for d in r.x.shape)] = r.x
            # pad rows REPLICATE the first real item: duplicates cannot
            # move the engines' per-block max-normalizer, so real rows
            # come back identical to a full batch (serve.buckets)
            xs[n_real:] = xs[0]
            if self.labeled:
                ys = np.asarray([r.y for r in live], np.int32)
                if n_real < self.max_batch:
                    ys = np.concatenate(
                        [ys, np.repeat(ys[:1], self.max_batch - n_real)]
                    )
            else:
                ys = None
            staged = put_committed((xs_t, ys), self._device)
        t0 = time.perf_counter()
        hvec = None
        cvec = None
        anytime_info = None
        entry = self._entry if mid is None else self._pager.entry(mid)
        try:
            with obs_sentinel.label(
                replica=self.replica_id,
                bucket=self._lkey(mid, bucket),
                phase="serve",
            ), self.metrics.stages.stage("dispatch"):
                if self._anytime and mid is None:
                    # progressive refinement: drive the begin/step/finalize
                    # stride loop (`anytime.driver` — the shared policy).
                    # Batch policy over the LIVE rows only (pad rows
                    # replicate row 0 and must not hold the batch open):
                    # tightest deadline, highest confidence floor.
                    from wam_tpu_torch.anytime.driver import drive_anytime

                    deadlines = [r.deadline for r in live
                                 if r.deadline is not None]
                    out, cvec, anytime_info = drive_anytime(
                        self._entry, *staged,
                        deadline=min(deadlines) if deadlines else None,
                        min_confidence=max(
                            (r.min_confidence for r in live), default=0.0),
                        n_rows=n_real)
                elif mid is None:
                    out = self._call_entry(*staged)
                else:
                    # paged-model dispatch: the model's own compiled entry,
                    # no fallback/degradation ladder (those are properties
                    # of the default entry)
                    out = entry(*staged)
                if self._health is not None:
                    if getattr(entry, "wam_health", False):
                        # fused entry: the vector is computed by the same
                        # call
                        out, hvec = out
                    else:
                        # post-hoc on-device reduction (fake/plain entries):
                        # a few small kernels behind the result, still
                        # harvested in the worker's single device_fetch
                        hvec = obs_health.batch_stats(out)
        except Exception:
            try:
                if mid is not None:
                    raise  # no fallback entry for paged models
                out = self._recover(xs.copy(), ys)  # already host-side on success
                hvec = None
            except Exception as e:
                for r in live:
                    r.future.set_exception(e)
                self.metrics.note_failed(n_real)
                if self._slo is not None:
                    bkey = bucket_key(bucket.shape)
                    for qos in QOS_CLASSES:
                        k = sum(1 for r in live if r.qos == qos)
                        if k:
                            self._slo.note_error(bkey, k, qos=qos)
                return None
        done = None
        if self._fetch_stream is not None:
            done = torch.cuda.Event()
            done.record()
        return _Inflight(bucket, live, depth, xs, ys, t0, out, hvec,
                         cvec=cvec, anytime=anytime_info, model=mid, done=done)

    def _complete(self, batch: _Inflight):
        """Harvest an in-flight batch (block on the device result — where
        async entry failures surface) and distribute rows to futures. The
        per-bucket service-time EMA feeding retry-after / routing updates
        inside `ServeMetrics.note_batch`."""
        live, n_real = batch.live, len(batch.live)
        bkey = bucket_key(batch.bucket.shape)
        healthy = True
        conf_host = None
        try:
            try:
                with self.metrics.stages.stage("harvest"), self._behind(batch.done):
                    if batch.anytime is not None:
                        # anytime batch: the confidence vector (and health
                        # vector, when on) rides the batch's ONE counted
                        # result fetch — `evalsuite.fan.device_fetch`, so
                        # fetch-accounting probes see exactly one fetch per
                        # served batch with checkpointing on
                        if batch.hvec is not None:
                            out, conf_host, hvec_host = device_fetch(
                                (batch.out, batch.cvec, batch.hvec))
                        else:
                            out, conf_host = device_fetch(
                                (batch.out, batch.cvec))
                            hvec_host = None
                    elif batch.hvec is not None:
                        # the health vector rides the batch's one fetch
                        out, hvec_host = device_fetch((batch.out, batch.hvec))
                    else:
                        out = device_fetch(batch.out)
                        hvec_host = None
            except Exception:
                try:
                    if batch.model is not None:
                        raise  # no fallback entry for paged models
                    out = self._recover(batch.xs, batch.ys)
                    hvec_host = None
                    # the fallback entry is a plain full-n one: replayed
                    # rows distribute as ordinary attributions
                    batch.anytime = None
                    conf_host = None
                except Exception as e:
                    for r in live:
                        r.future.set_exception(e)
                    self.metrics.note_failed(n_real)
                    if self._slo is not None:
                        for qos in QOS_CLASSES:
                            k = sum(1 for r in live if r.qos == qos)
                            if k:
                                self._slo.note_error(bkey, k, qos=qos)
                    return
            if self._health is not None and hvec_host is not None:
                # recorded BEFORE rows distribute so a sequential client's
                # next submit observes the updated health_ok() verdict
                healthy = self._health.note(hvec_host, bucket=bkey)
            service_s = time.perf_counter() - batch.t0
            confidences: list[float] = []
            with self.metrics.stages.stage("distribute"):
                done = time.perf_counter()
                for i, r in enumerate(live):
                    row = _row(out, i)
                    if batch.anytime is not None:
                        # anytime delivery: the row plus its certainty —
                        # never cached (submit kept ckey None)
                        from wam_tpu_torch.anytime.result import AnytimeResult
                        from wam_tpu_torch.anytime.state import (
                            SLOT_CONFIDENCE, SLOT_DELTA, SLOT_REL_SEM)

                        conf = float(conf_host[i, SLOT_CONFIDENCE])
                        confidences.append(conf)
                        r.future.set_result(AnytimeResult(
                            attribution=row,
                            confidence=conf,
                            n_used=batch.anytime["n_used"],
                            n_total=batch.anytime["n_total"],
                            complete=batch.anytime["complete"],
                            converged=batch.anytime["converged"],
                            rel_sem=float(conf_host[i, SLOT_REL_SEM]),
                            delta=float(conf_host[i, SLOT_DELTA])))
                        continue
                    if (self._cache is not None and r.ckey is not None
                            and not self.degraded):
                        # populate at harvest (host-side rows). Degraded
                        # batches are not cached: the CPU-rebuilt entry's
                        # float rounding differs from the card's,
                        # and mixing provenances would break the
                        # bit-identical-hit contract
                        self._cache.put(r.ckey, row, tenant=r.tenant)
                    r.future.set_result(row)
            if obs_tracing._STATE.enabled:
                # retroactive per-request phases: the worker only knows a
                # request's queue wait once its batch pops, so the spans are
                # recorded from timestamps already in hand — together they
                # tile submit->done, the trace_report coverage contract
                for r in live:
                    obs_tracing.record_span(
                        "queue_wait", r.t_submit, batch.t0, parent=r.ctx,
                        cat="serve", bucket=bkey, replica=self.replica_id)
                    obs_tracing.record_span(
                        "service", batch.t0, done, parent=r.ctx,
                        cat="serve", bucket=bkey, replica=self.replica_id,
                        n_real=n_real)
            latencies_s = [done - r.t_submit for r in live]
            self.metrics.note_batch(
                bucket_shape=batch.bucket.shape,
                n_real=n_real,
                max_batch=self.max_batch,
                pad_waste=float(np.mean([batch.bucket.pad_waste(r.x.shape) for r in live])),
                queue_depth=batch.depth,
                service_s=service_s,
                queue_waits_s=[batch.t0 - r.t_submit for r in live],
                latencies_s=latencies_s,
                qos=[r.qos for r in live],
                model_id=batch.model,
                tenants=[r.tenant for r in live],
            )
            if batch.anytime is not None:
                self.metrics.note_anytime(
                    bucket_shape=batch.bucket.shape,
                    n_used=batch.anytime["n_used"],
                    n_total=batch.anytime["n_total"],
                    strides=batch.anytime["strides"],
                    converged=batch.anytime["converged"],
                    deadline_hit=batch.anytime["deadline_hit"],
                    confidences=confidences)
            if self._slo is not None:
                for i, (r, lat) in enumerate(zip(live, latencies_s)):
                    self._slo.note(
                        bkey, latency_s=lat, ok=True, healthy=healthy,
                        qos=r.qos, tenant=r.tenant,
                        confidence=confidences[i] if confidences else 1.0)
        finally:
            self._finish_active((batch.model, batch.bucket))
