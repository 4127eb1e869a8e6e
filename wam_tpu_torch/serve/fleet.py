"""Multi-device attribution fleet (PyTorch port of `wam_tpu.serve.fleet`).

`AttributionServer` owns exactly one device: one worker thread, one
device, one bounded queue. `FleetServer` goes wider without touching that
invariant — it starts one `AttributionServer` REPLICA per device (each
pinned to its device by the runtime's ``device=`` and carrying its own
`ServeMetrics` ledger), and puts a shared admission + routing layer in
front:

- **Load-aware routing**: every admitted item is routed to the live
  replica with the lowest projected drain time —
  ``server.projected_drain_s()`` (per-bucket (queued + in-flight batches) ×
  per-bucket EMA service time) plus the item's own bucket EMA on that
  replica, so a replica that is merely *bad at this bucket* loses to an
  idle one even when both have empty queues. Ties resolve to the lowest
  replica id (deterministic for tests).
- **Shared admission**: the fleet rejects (`QueueFullError`) only when
  EVERY live replica's bounded queue rejected, carrying the smallest
  ``retry_after_s`` any replica offered.
- **Oversize dispatch**: `attribute_batch` on a batch larger than one
  replica's bucket cap (``max_batch``) runs it data-parallel over the fleet
  mesh (`parallel.replica_mesh`) with ``oversize="pjit"``: rows are
  bucket-padded and replicate-padded up to the fleet-wide batch
  (``n_replicas × max_batch`` rows, one input signature per bucket), each
  replica's ``max_batch`` rows are staged on its device and run there by
  the replica's own oversize entry (built by ``entry_factory`` with id
  ``OVERSIZE_ENTRY_ID`` and the replica's device) on the replica's own
  oversize thread, concurrently, and the rows are gathered on the host.
  The result is the entry's on the whole padded batch, as the reference's
  one pjit program gives it, so the entry must say how its rows split
  (`serve.entry`): a ``wam_row_wise`` entry computes each row
  alone, and one block a replica is the whole story; an entry with a
  batch-global reduction (the normalized mosaic's max, SmoothGrad's noise
  drawn at the batch's shape) carries ``wam_blocks`` (`serve.entry.RowBlocks`):
  each replica runs its block's share, the fleet takes the elementwise max
  of the blocks' maxima on the host (the one exchange between replicas),
  and each replica finishes its rows with it. Every explainer's
  ``serve_entry`` carries them (1D, 2D, 3D, video, `BaseWAM2D`, with or
  without health; a health entry's per-block vectors are merged into the
  batch's by `obs.health.merge_stats` and published under source
  ``fleet_oversize``). An entry that declares neither is refused at
  construction with ``oversize="pjit"``;
  ``oversize="fanout"`` splits oversize batches into routed per-item
  submits instead.
- **Replica death**: a request whose entry raised (anything that is not a
  per-request `ServeError`) marks its replica dead fleet-wide and is
  re-routed to the survivors; items queued behind the failure drain with
  the same per-request re-route as their batches fail. A request that
  fails on every live replica propagates the last error
  (`NoLiveReplicaError` when none is left). A deterministic per-request
  bug (poison pill) is indistinguishable from a device loss at this layer
  and can take one replica down per retry. While any replica is dead,
  oversize batches fall back to routed per-item submits (the fleet mesh
  spans every device, dead or not).

``entry_factory(replica_id, metrics, device) -> entry`` builds one serving
entry per replica (0..N-1) plus one oversize entry a replica (id
``OVERSIZE_ENTRY_ID``), each computing on ``device``: a PyTorch model lives
on one device, so the factory builds (or looks up) the explainer of that
device. Each replica needs its OWN entry object so its ``on_trace`` hook
counts that replica's first calls — the ledger invariant is
``compile_count == n_buckets`` per replica, and one set a replica on the
oversize ledger when the oversize route is used. A typical factory::

    wams = {}

    def entry_factory(rid, m, device):
        if device not in wams:
            wams[device] = WaveletAttribution2D(bind_inference(model, device=device),
                                                device=device, ...)
        return wams[device].serve_entry(on_trace=m.note_compile)

Replicas start concurrently (each warms its buckets on its own worker
thread). A device list may name one device several times: each entry is
one replica, so two replicas share one card (their batches interleave on
it; no speed-up).

With a ``seq_factory``, a batch whose ITEM shape exceeds every bucket
takes the sequence-sharded route instead of raising `NoBucketError`:
``seq_factory(mesh)`` builds the entry once, on first use, over the fleet
mesh (`parallel.replica_mesh` of the replicas' devices), typically an
explainer with ``mesh=`` (`parallel.SeqShardedWam` underneath), and the
whole batch runs through it in one call, serialized with the oversize
path, under the ``seq_sharded_batch`` span and the sentinel label
``phase="seq_sharded"``, with one oversize ledger row (fill 1.0, the item
shape as its bucket).

``registry=`` (a bundle of `wam_tpu_torch.registry`) is hydrated once
fleet-wide before the replicas warm and again before each supervisor
rebuild.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from wam_tpu_torch.evalsuite.fan import device_fetch
from wam_tpu_torch.obs.health import publish_stats
from wam_tpu_torch.obs import sentinel as obs_sentinel
from wam_tpu_torch.obs import tracing as obs_tracing
from wam_tpu_torch.parallel.mesh import P, replica_mesh, visible_devices
from wam_tpu_torch.pipeline.stager import put_committed
from wam_tpu_torch.serve.buckets import Bucket, BucketTable, NoBucketError, bucket_key, pad_item
from wam_tpu_torch.serve.entry import join_blocks
from wam_tpu_torch.serve.metrics import EMA_SEED_S, FleetMetrics, ServeMetrics
from wam_tpu_torch.serve.models import ModelSpec
from wam_tpu_torch.serve.result_cache import ResultCache
from wam_tpu_torch.serve.runtime import (
    QOS_CLASSES,
    AttributionServer,
    DeadlineExceededError,
    InvalidDeadlineError,
    QueueFullError,
    ServeError,
    ServerClosedError,
    _grad_on,
)

__all__ = ["FleetServer", "NoLiveReplicaError", "OVERSIZE_ENTRY_ID",
           "INTERACTIVE_DEPTH_WEIGHT", "MODEL_PAGEIN_PENALTY_S"]

# entry_factory's replica_id for the fleet-wide oversize entry
OVERSIZE_ENTRY_ID = "fleet"

# routing penalty (seconds) for sending a paged model's request to a
# replica where that model is NOT resident: a page-in (build + first
# dispatch) is far dearer than a warm dispatch, so the router prefers
# replicas already holding the model — but a loaded resident replica can
# still lose to an idle cold one once its drain exceeds this
MODEL_PAGEIN_PENALTY_S = 0.25

# routing weight on a replica's queued-interactive depth (`_score`): each
# max_batch worth of queued interactive work on a replica makes it look
# this many bucket-EMAs busier, so latency-sensitive traffic spreads away
# from interactive-loaded replicas harder than raw drain alone implies
INTERACTIVE_DEPTH_WEIGHT = 0.5


class NoLiveReplicaError(ServeError):
    """Every replica is dead (or rejected this request after deaths) — the
    fleet cannot serve it RIGHT NOW. ``retry_after_s`` estimates when a
    supervised restart will have a replica back (None when the fleet is
    unsupervised or every dead replica escalated to permanent): with it,
    `serve.retry.RetryPolicy` floors its backoff at the restart window
    and treats fleet-wide death as backpressure."""

    def __init__(self, msg: str, retry_after_s: float | None = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


@dataclass
class _Replica:
    rid: int
    device: object
    server: AttributionServer
    metrics: ServeMetrics
    alive: bool = True


@dataclass
class _FleetRequest:
    """One admitted item's routing state: the grown ``tried`` set is what
    makes re-dispatch after a replica death converge."""

    x: np.ndarray
    y: int | None
    bucket: Bucket
    deadline_at: float | None  # perf_counter timestamp, None = no deadline
    future: Future
    qos: str = "interactive"
    # anytime serving: the per-request confidence floor, threaded to
    # whichever replica wins the route (wam_tpu_torch.anytime)
    min_confidence: float = 0.0
    # multi-model routing: which paged model serves this request (None =
    # the default entry); survives re-routes like the rest of the state
    model: str | None = None
    # fair-share identity: lanes/quota/cache-partition/SLO-window key
    tenant: str | None = None
    # fleet-tier result-cache key (None = cache off): computed once at
    # submit, survives re-routes, populated from whichever replica wins
    ckey: str | None = None
    tried: set = field(default_factory=set)
    # obs trace identity: every admission/queue/service span of this
    # request (including re-routes after a death) parents here
    ctx: tuple | None = None


def _stack(rows):
    """Per-row host results (arrays, or tuples / lists / dicts of them)
    stacked along a new leading axis."""
    first = rows[0]
    if isinstance(first, dict):
        return {k: _stack([r[k] for r in rows]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([r[i] for r in rows]) for i in range(len(first)))
    return np.stack([np.asarray(r) for r in rows])


def _head(tree, k: int):
    """The first ``k`` rows of every leaf of a host result tree."""
    if isinstance(tree, dict):
        return {key: _head(v, k) for key, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_head(v, k) for v in tree)
    return np.asarray(tree)[:k]


class FleetServer:
    """One serve worker per device behind shared admission + load-aware
    routing (module docstring). The client surface mirrors
    `AttributionServer` (`submit`/`attribute`/`close`/context manager) plus
    `attribute_batch` for whole batches incl. the oversize path.

    Parameters mirror `AttributionServer` where shared; fleet-specific:

    replicas : worker count (one per device entry). None = every entry of
        ``devices``.
    devices : device list; None is every visible CUDA device
        (RuntimeError when there is none); a list may repeat a device or
        name ``"cpu"`` (the tests). The first ``replicas`` entries become
        the fleet.
    oversize : "pjit" runs oversize batches data-parallel over the fleet
        mesh (one block of rows a replica, the result the entry's on the
        whole batch; the entry must be ``wam_row_wise`` or carry
        ``wam_blocks``, else ValueError); "fanout" always splits them into
        routed per-item submits (no oversize entry).
    seq_factory : optional ``seq_factory(mesh) -> entry`` building the
        sequence-sharded entry ``(xs, ys) -> result`` for items above every
        bucket (module docstring); built lazily, under the oversize lock.
    queue_depth : per-replica bound — total fleet admission capacity is
        ``replicas × queue_depth``.
    metrics : a shared `FleetMetrics` (fresh when None); per-replica
        `ServeMetrics` are created through it so the fleet summary sees
        every ledger.
    prom_port : when not None, serve the obs registry in Prometheus text
        format at ``GET http://127.0.0.1:{prom_port}/metrics`` for this
        fleet's lifetime (`wam_tpu_torch.obs.start_metrics_server`; 0 binds
        an ephemeral port — read ``fleet.prom_server.server_port``).
    health : numeric-health monitoring per replica — ``True`` or a
        `wam_tpu_torch.obs.HealthConfig` (each replica gets its OWN
        monitor). A replica whose batches go non-finite ``quarantine_after``
        times in a row is routed around like a death, but recovers after
        ``recovery_s``; quarantined replicas remain LAST-RESORT candidates.
    slo : per-bucket service objectives, tracked per replica; a replica's
        burn-rate adds a routing penalty (`AttributionServer.slo_penalty_s`).
    memory_budget : per-replica device memory budget in BYTES (cold-bucket
        admission control, `wam_tpu_torch.obs.MemoryBudget`).
    supervise : replica supervision (`serve.supervisor.ReplicaSupervisor`):
        ``True`` or a `SupervisorConfig` restarts dead replicas with
        backoff + jitter and escalates crash loops to permanent-dead;
        None/False (default) keeps permanent-on-first-death. In-flight and
        queued work re-routes to survivors either way.
    registry : compile-artifact bundle (`wam_tpu_torch.registry`): a bundle
        path or `RegistryClient`, hydrated ONCE fleet-wide before the
        replicas warm (the caches are process-wide, so one hydration serves
        every replica) and AGAIN before each supervisor rebuild
        (idempotent: present artifacts are skipped, but a cache wiped under
        a running fleet re-seeds instead of recompiling). Can also be passed
        to `start(registry=...)`. Same silent-miss fallback as
        `AttributionServer`.
    coalesce_ms : per-replica cross-request admission window, forwarded to
        every replica.
    result_cache : ONE shared content-addressed result cache at the fleet
        admission tier (int byte budget or a `ResultCache`): `submit`
        consults it before routing, `_harvest` populates it from whichever
        replica computed the row. Replicas carry no cache.
    cache_id : entry identity baked into fleet cache keys (defaults to
        the entry factory's ``__name__``).
    models : additional paged model families served by every replica
        (`serve.models.ModelSpec` list/dict). Fleet-level spec factories
        take ``(replica_id, metrics, device)`` like ``entry_factory``; route with
        ``submit(model=...)`` (the router prefers replicas where the model
        is resident, `MODEL_PAGEIN_PENALTY_S`).
    tenant_quota : per-tenant admission-queue share in (0, 1], forwarded
        to every replica; 0 disables quotas.
    """

    # checked by the lock-discipline lint rule: mutations outside __init__
    # must hold the mapped lock
    _GUARDED_BY = {
        "_closed": "_lock",
        "_started": "_lock",
        "_canary": "_lock",
        "_canary_fp": "_lock",
        "_canary_t0": "_lock",
        "_os_pools": "_os_lock",
        "_seq_entry": "_os_lock",
    }

    def __init__(
        self,
        entry_factory,
        buckets,
        *,
        replicas: int | None = None,
        devices=None,
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
        coalesce_ms: float = 0.0,
        queue_depth: int = 64,
        deadline_ms: float = 0.0,
        labeled: bool = True,
        warmup: bool = True,
        compilation_cache: bool = False,
        metrics: FleetMetrics | None = None,
        metrics_path: str | None = None,
        oversize: str = "pjit",
        seq_factory=None,
        dtype=np.float32,
        pipelined: bool = True,
        auto_start: bool = True,
        prom_port: int | None = None,
        health=None,
        slo=None,
        memory_budget=None,
        supervise=None,
        registry=None,
        result_cache=None,
        cache_id: str | None = None,
        models=None,
        tenant_quota: float = 0.0,
    ):
        if not callable(entry_factory):
            raise TypeError("entry_factory must be callable(replica_id, metrics, device)")
        if oversize not in ("pjit", "fanout"):
            raise ValueError(f"oversize must be 'pjit' or 'fanout', got {oversize!r}")
        self._registry = registry
        self.registry_report = None  # latest fleet-wide HydrationReport
        devices = visible_devices(devices)
        n = len(devices) if replicas is None else int(replicas)
        if not 1 <= n <= len(devices):
            raise ValueError(f"replicas={n} with {len(devices)} visible devices")
        self.devices = devices[:n]
        self.n_replicas = n
        self.table = buckets if isinstance(buckets, BucketTable) else BucketTable(buckets)
        self.max_batch = max_batch
        self.default_deadline_s = deadline_ms / 1e3 if deadline_ms else None
        self.labeled = labeled
        self.metrics = metrics if metrics is not None else FleetMetrics()
        self.metrics_path = metrics_path
        self.oversize = oversize
        self.dtype = dtype
        self._lock = threading.Lock()
        self._closed = False
        self._started = False
        # online-tuner canary (pin_canary): rid of the replica serving the
        # CHALLENGER schedule, None = no A/B in progress
        self._canary = None
        self._canary_fp = None
        self._canary_t0 = 0.0
        self._canary_overrides = False

        # everything _make_server needs to (re)build one replica server —
        # the restart path constructs from the same recipe as first start
        self._entry_factory = entry_factory
        self._server_kw = dict(
            max_batch=max_batch,
            max_wait_ms=max_wait_ms,
            coalesce_ms=coalesce_ms,
            queue_depth=queue_depth,
            deadline_ms=0.0,  # the fleet applies its default at admission
            labeled=labeled,
            warmup=warmup,
            compilation_cache=compilation_cache,
            metrics_path=None,  # the fleet emits one merged ledger
            dtype=dtype,
            pipelined=pipelined,
            auto_start=False,
            health=health,
            slo=slo,
            memory=memory_budget,
            # replicas carry NO result cache: the fleet keeps ONE shared
            # cache at its admission tier (consulted in submit, populated
            # in _harvest)
            result_cache=None,
            tenant_quota=tenant_quota,
        )
        self.tenant_quota = float(tenant_quota)

        # paged model families (serve.models): normalized to a spec map;
        # factories stay fleet-level 3-arg here, wrapped per replica in
        # _server_models so each replica owns its entries
        specs = []
        if models:
            for spec in (models.values() if isinstance(models, dict) else models):
                if isinstance(spec, dict):
                    spec = ModelSpec(**spec)
                specs.append(spec)
        self._models = {s.model_id: s for s in specs}

        # fleet-tier content-addressed result cache (serve.result_cache):
        # an int byte budget builds one; an instance is shared as-is
        if isinstance(result_cache, ResultCache):
            self._cache = result_cache
        elif result_cache:
            self._cache = ResultCache(
                int(result_cache),
                cache_id=cache_id if cache_id is not None else getattr(
                    entry_factory, "__name__", type(entry_factory).__name__))
        else:
            self._cache = None
        if self._cache is not None:
            self.metrics.result_cache = self._cache

        self._seq_factory = seq_factory
        self._seq_entry = None  # built lazily on the first oversize-item batch
        self._os_entries = None  # one oversize entry a replica, on its device
        self._mesh = None
        self._os_lock = threading.Lock()
        self._os_pools = None  # one oversize thread a replica, made at first use
        if oversize == "pjit" and n > 1:
            self._mesh = replica_mesh(n, self.devices)
            self._os_entries = [entry_factory(OVERSIZE_ENTRY_ID, self.metrics.oversize, dev)
                                for dev in self.devices]
            if not all(getattr(e, "wam_row_wise", False) or getattr(e, "wam_blocks", None)
                       for e in self._os_entries):
                raise ValueError(
                    "oversize='pjit' needs an entry whose rows split over the replicas: "
                    "row-wise (entry.wam_row_wise = True) or carrying RowBlocks "
                    "(jit_entry(blocks=...)); this entry is neither, so its rows would "
                    "depend on the replica count. Use oversize='fanout'")

        self._replicas: list[_Replica] = []
        for rid, dev in enumerate(self.devices):
            m = self.metrics.replica(rid)
            self._replicas.append(_Replica(rid, dev, self._make_server(rid, m), m))

        # replica supervision (serve.supervisor): None/False = permanent-
        # on-first-death; True or a SupervisorConfig opts in
        self._supervisor = None
        if supervise:
            from wam_tpu_torch.serve.supervisor import ReplicaSupervisor, SupervisorConfig

            cfg = supervise if isinstance(supervise, SupervisorConfig) else None
            self._supervisor = ReplicaSupervisor(self, cfg)

        self.prom_server = None
        if prom_port is not None:
            from wam_tpu_torch.obs import start_metrics_server

            self.prom_server = start_metrics_server(prom_port)
        if auto_start:
            self.start()

    @classmethod
    def from_config(cls, cfg, entry_factory, *, devices=None, seed: int | None = None,
                    **overrides) -> "FleetServer":
        """A fleet with the knobs of a `config.ServeConfig`, as the
        reference's serving benchmark builds one: ``cfg.fleet`` replicas,
        ``cfg.oversize``, ``cfg.supervise`` with ``restart_max`` /
        ``restart_window_s`` / ``restart_backoff_ms`` as the
        `SupervisorConfig` (its jitter seeded with ``seed``), ``max_batch``
        ("auto": `tune.resolve_bucket_cap` at the fleet's width), the health,
        memory, SLO, quota and cache knobs, and ``cfg.bucket_shapes()``.
        ``devices`` None takes ``cfg.device``: "auto" or "cuda" is every
        visible card, any other device is named ``cfg.fleet`` times.
        ``overrides`` are `FleetServer` arguments that win over the
        config's."""
        from wam_tpu_torch.obs.health import HealthConfig
        from wam_tpu_torch.serve.supervisor import SupervisorConfig
        from wam_tpu_torch.tune.cache import resolve_bucket_cap

        if devices is None and cfg.device not in ("auto", "cuda"):
            devices = [cfg.device] * cfg.fleet
        kw = dict(
            replicas=cfg.fleet,
            devices=devices,
            max_batch=resolve_bucket_cap(
                cfg.max_batch, replicas=cfg.fleet,
                backend=None if cfg.device == "auto" else torch.device(cfg.device).type),
            max_wait_ms=cfg.max_wait_ms,
            coalesce_ms=cfg.coalesce_ms,
            result_cache=int(cfg.result_cache_mb * 2**20) or None,
            queue_depth=cfg.queue_depth,
            deadline_ms=cfg.deadline_ms,
            warmup=cfg.warmup,
            compilation_cache=cfg.compilation_cache,
            registry=cfg.registry or None,
            metrics_path=cfg.metrics_path or None,
            oversize=cfg.oversize,
            pipelined=cfg.pipelined,
            health=(HealthConfig(quarantine_after=cfg.health_quarantine_n,
                                 recovery_s=cfg.health_recovery_s) if cfg.health else None),
            slo=cfg.slo or None,
            memory_budget=int(cfg.hbm_budget_mb * 2**20) or None,
            tenant_quota=cfg.tenant_quota,
            supervise=(SupervisorConfig(max_restarts=cfg.restart_max,
                                        window_s=cfg.restart_window_s,
                                        backoff_base_s=cfg.restart_backoff_ms / 1e3,
                                        seed=seed) if cfg.supervise else None),
        )
        kw.update(overrides)
        buckets = kw.pop("buckets", None) or cfg.bucket_shapes()
        if not buckets:
            raise ValueError("ServeConfig.buckets is empty: name the buckets there or pass "
                             "buckets=")
        return cls(entry_factory, buckets, **kw)

    # -- lifecycle ----------------------------------------------------------

    def _server_models(self, rid, metrics):
        """Per-replica `ModelSpec` list: the fleet-level 3-arg factories
        become this replica's zero-arg closures, so a paged model's first
        calls count into ITS replica's ledger and its entry computes on the
        replica's device."""
        if not self._models:
            return None
        return [
            ModelSpec(
                s.model_id,
                (lambda f=s.factory, r=rid, m=metrics, d=self.devices[rid]: f(r, m, d)),
                registry=s.registry,
                buckets=s.buckets,
                est_bytes=s.est_bytes,
                cache_id=s.cache_id,
            )
            for s in self._models.values()
        ]

    def _make_server(self, rid, metrics, **overrides) -> AttributionServer:
        """Build one replica's `AttributionServer` from the fleet recipe —
        first construction, supervisor restarts and the canary share this,
        so a restarted replica is configured identically (same entry
        factory, same accumulating `ServeMetrics`, same device)."""
        return AttributionServer(
            self._entry_factory(rid, metrics, self.devices[rid]),
            self.table,
            metrics=metrics,
            device=self.devices[rid],
            replica_id=rid,
            models=self._server_models(rid, metrics),
            **{**self._server_kw, **overrides},
        )

    def _hydrate(self):
        """Hydrate the configured registry bundle into the process-wide
        caches (no-op without one). Idempotent, so the supervisor calls it
        before every rebuild."""
        if self._registry is None or self._registry == "":
            return None
        from wam_tpu_torch.registry.client import resolve_client

        client = resolve_client(self._registry)
        if client is None:
            return None
        self.registry_report = client.hydrate()
        return self.registry_report

    def _rebuild_replica(self, rid) -> None:
        """Supervisor restart procedure: close the dead server (drains any
        request that raced in — each fails with `ServerClosedError` and
        re-routes), re-hydrate the registry bundle (when configured), build
        + warm a fresh one (`start()` warms every bucket on the new worker
        thread), then swap it live under the fleet lock."""
        replica = self._replicas[rid]
        try:
            replica.server.close(emit_metrics=False)
        except Exception:  # noqa: BLE001 - the old server may be arbitrarily broken
            pass  # the fresh one replaces it regardless
        self._hydrate()
        server = self._make_server(rid, replica.metrics)
        server.start()
        with self._lock:
            if self._closed:
                closing = True
            else:
                closing = False
                replica.server = server
                replica.alive = True
        if closing:
            server.close(emit_metrics=False)
            raise ServerClosedError("fleet closed during replica rebuild")

    def start(self, registry=None) -> "FleetServer":
        """Start (and warm) every replica concurrently. Idempotent.
        ``registry`` overrides the constructor's bundle for this start;
        hydration runs ONCE here, before any replica's warmup."""
        if self._started:
            return self
        if registry is not None:
            self._registry = registry
        self._hydrate()
        live = [r for r in self._replicas if r.alive]
        if len(live) == 1:
            live[0].server.start()
        else:
            with ThreadPoolExecutor(
                max_workers=len(live), thread_name_prefix="wam-fleet-start"
            ) as pool:
                list(pool.map(lambda r: r.server.start(), live))
        with self._lock:
            self._started = True
        return self

    def close(self, emit_metrics: bool = True) -> None:
        """Stop intake, drain every replica, and (when ``metrics_path`` is
        set) flush the merged fleet ledger."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self._supervisor is not None:
            self._supervisor.close()
        for r in self._replicas:
            r.server.close(emit_metrics=False)
        with self._os_lock:
            pools, self._os_pools = self._os_pools, None
        for pool in pools or ():
            pool.shutdown(wait=True)
        if emit_metrics and self.metrics_path:
            from wam_tpu_torch.results import JsonlWriter

            writer = JsonlWriter(self.metrics_path)
            if self.registry_report is not None:
                writer.write(self.registry_report.row())
            self.metrics.emit(
                writer,
                config=self.describe(),
                replica_configs={r.rid: r.server.describe() for r in self._replicas},
            )
        if self.prom_server is not None:
            from wam_tpu_torch.obs import stop_metrics_server

            stop_metrics_server(self.prom_server)
            self.prom_server = None
        with self._lock:
            self._started = False

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    def describe(self) -> dict:
        return {
            "replicas": self.n_replicas,
            "coalesce_ms": self._server_kw["coalesce_ms"],
            "result_cache": (self._cache.stats()
                             if self._cache is not None else None),
            "devices": [str(d) for d in self.devices],
            "dead": [r.rid for r in self._replicas if not r.alive],
            "quarantined": [
                r.rid for r in self._replicas if r.alive and not r.server.health_ok()
            ],
            "buckets": [list(b.shape) for b in self.table],
            "max_batch": self.max_batch,
            "labeled": self.labeled,
            "oversize": self.oversize,
            "seq_route": self._seq_factory is not None,
            "canary": self._canary,
            "supervised": self._supervisor is not None,
            "supervision": (
                self._supervisor.describe() if self._supervisor is not None
                else None
            ),
            "registry": (getattr(self._registry, "bundle", None)
                         or (str(self._registry) if self._registry else None)),
            "models": sorted(self._models) if self._models else None,
            "tenant_quota": self.tenant_quota,
        }

    def _restart_hint_s(self) -> float | None:
        """How long a client should wait for a supervised restart to put a
        replica back: the supervisor's worst-case backoff. None when nobody
        is coming back — unsupervised fleet, or every dead replica escalated
        permanent."""
        if self._supervisor is None:
            return None
        with self._lock:
            dead = [r.rid for r in self._replicas if not r.alive]
        if dead and all(self._supervisor.permanently_dead(rid) for rid in dead):
            return None
        cfg = self._supervisor.config
        return cfg.backoff_cap_s * (1.0 + cfg.jitter_frac)

    def pod_signals(self) -> dict:
        """The health-plane aggregate of the whole fleet — the quantities
        `_score` routes on, rolled up for a tier above (the reference's pod
        router, ROADMAP.md slice F). Drain is the best live replica's; EMAs
        are per-bucket means over live replicas; the SLO penalty is the
        worst bucket's mean; ``quarantined`` only when EVERY live replica
        is."""
        with self._lock:
            replicas = list(self._replicas)
        live = [r for r in replicas if r.alive]
        ema: dict[str, float] = {}
        penalties: list[float] = []
        for b in self.table:
            vals = [r.metrics.ema_service_s(b.shape) for r in live]
            ema[b.key] = sum(vals) / len(vals) if vals else EMA_SEED_S
            pen = [r.server.slo_penalty_s(b.shape) for r in live]
            if pen:
                penalties.append(sum(pen) / len(pen))
        # paged-model lanes ride along under their model|bucket keys
        model_ema: dict[str, list[float]] = {}
        for r in live:
            for k, v in r.metrics.ema_service_s().items():
                if "|" in k:
                    model_ema.setdefault(k, []).append(v)
        for k, vals in model_ema.items():
            ema[k] = sum(vals) / len(vals)
        models_resident: dict[str, int] = {}
        for r in live:
            for mid, nbytes in r.server.models_resident().items():
                models_resident[mid] = max(models_resident.get(mid, 0), int(nbytes))
        snaps = [r.metrics.snapshot() for r in replicas]
        os_snap = self.metrics.oversize.snapshot()
        qos_depth = dict.fromkeys(QOS_CLASSES, 0)
        for r in live:
            for cls, depth in r.server.qos_depths().items():
                qos_depth[cls] = qos_depth.get(cls, 0) + depth
        submitted = sum(s["submitted"] for s in snaps) + os_snap["submitted"]
        # fleet-tier cache hits resolve BEFORE routing, so they never enter
        # ``submitted``
        cache_hits = self.metrics.cache_hits
        return {
            "projected_drain_s": min(
                (r.server.projected_drain_s() for r in live), default=0.0),
            "qos_depth": qos_depth,
            "queue_free": sum(r.server.admission_free() for r in live),
            "ema_service_s": ema,
            "slo_penalty_s": max(penalties, default=0.0),
            "quarantined": bool(live) and not any(r.server.health_ok() for r in live),
            "live_replicas": len(live),
            "dead_replicas": len(replicas) - len(live),
            "submitted": submitted,
            "completed": sum(s["completed"] for s in snaps) + os_snap["completed"],
            "compile_count": sum(s["compile_count"] for s in snaps)
            + os_snap["compile_count"],
            "cache_hits": cache_hits,
            "cache_hit_rate": cache_hits / max(1, cache_hits + submitted),
            "models_resident": models_resident,
        }

    # -- online-tuner canary --------------------------------------------------

    def pin_canary(self, fingerprint: str, *, replica_id: int | None = None,
                   overrides: dict | None = None) -> int:
        """Pin one replica as the CHALLENGER arm of a schedule A/B: its
        ``serve_batch`` rows are stamped with ``fingerprint`` and the
        batch-QoS lane prefers it at routing time, so the canary slice is
        the throughput lane — interactive traffic only lands there as a
        last resort. ``overrides`` merges challenger serving knobs into the
        replica recipe (e.g. ``{"max_batch": 16}``) and rebuilds the
        replica with them — in-flight work re-routes to the champions as
        in a supervisor restart. Defaults to the highest live rid. Returns
        the pinned rid."""
        with self._lock:
            if self._canary is not None:
                raise ValueError(
                    f"replica {self._canary} is already the canary; "
                    "clear_canary() first")
            live = [r for r in self._replicas if r.alive]
            if len(live) < 2:
                raise ValueError(
                    "canary A/B needs >= 2 live replicas (one per arm), "
                    f"have {len(live)}")
            if replica_id is None:
                replica_id = max(r.rid for r in live)
            replica = self._replicas[replica_id]
            if not replica.alive:
                raise ValueError(f"replica {replica_id} is dead")
        if overrides:
            replica.server.close(emit_metrics=False)
            server = self._make_server(replica_id, replica.metrics, **overrides)
            server.start()
            with self._lock:
                replica.server = server
        replica.metrics.schedule_fingerprint = fingerprint
        with self._lock:
            self._canary = replica_id
            self._canary_fp = fingerprint
            self._canary_t0 = time.time()
            self._canary_overrides = bool(overrides)
        return replica_id

    def clear_canary(self) -> None:
        """End the A/B: the replica's rows stamp the champion fingerprint
        again, and a replica rebuilt with challenger overrides goes back to
        the fleet recipe (same path as a supervisor restart)."""
        with self._lock:
            rid = self._canary
            had_overrides = self._canary_overrides
            self._canary = None
            self._canary_fp = None
            self._canary_t0 = 0.0
            self._canary_overrides = False
        if rid is None:
            return
        self._replicas[rid].metrics.schedule_fingerprint = None
        if had_overrides:
            self._rebuild_replica(rid)

    def canary_report(self, *, min_batches: int = 8, margin: float = 0.05) -> dict:
        """Champion-vs-challenger comparison from the replicas' OWN batch
        ledgers (`ServeMetrics.batch_sample`): the challenger wins when both
        arms hold ≥ ``min_batches`` batches, its mean per-item service beats
        the champion mean by ≥ ``margin``, and it burns no more SLO. Only
        rows from the open canary window count."""
        with self._lock:
            rid = self._canary
            fp = self._canary_fp
            t0 = self._canary_t0
            replicas = list(self._replicas)
        if rid is None:
            return {"canary": None, "verdict": "none", "win": False}

        def _per_item(rows, want_fp=None):
            return [float(r.get("service_s", 0.0)) / max(1, int(r["n_real"]))
                    for r in rows
                    if r.get("n_real")
                    and float(r.get("timestamp", 0.0)) >= t0
                    and (want_fp is None or r.get("schedule_fingerprint") == want_fp)]

        def _penalty(r):
            return max((r.server.slo_penalty_s(b.shape) for b in self.table), default=0.0)

        chall = _per_item(replicas[rid].metrics.batch_sample(), want_fp=fp)
        champ: list[float] = []
        champ_pen: list[float] = []
        for r in replicas:
            if r.rid != rid and r.alive:
                champ.extend(_per_item(r.metrics.batch_sample()))
                champ_pen.append(_penalty(r))
        out = {
            "canary": rid,
            "challenger_batches": len(chall),
            "champion_batches": len(champ),
            "margin": margin,
            "challenger_slo_penalty_s": _penalty(replicas[rid]),
            "champion_slo_penalty_s": max(champ_pen, default=0.0),
        }
        if len(chall) < min_batches or len(champ) < min_batches:
            out.update(verdict="insufficient", win=False)
            return out
        champ_s = sum(champ) / len(champ)
        chall_s = sum(chall) / len(chall)
        win = (chall_s <= champ_s * (1.0 - margin)
               and out["challenger_slo_penalty_s"] <= out["champion_slo_penalty_s"])
        out.update(
            champion_per_item_s=champ_s,
            challenger_per_item_s=chall_s,
            improvement=(champ_s - chall_s) / champ_s if champ_s > 0 else 0.0,
            verdict="challenger" if win else "champion",
            win=win,
        )
        return out

    # -- client side --------------------------------------------------------

    def submit(self, x, y=None, deadline_ms: float | None = None,
               qos: str = "interactive",
               min_confidence: float = 0.0,
               model: str | None = None,
               tenant: str | None = None) -> Future:
        """Admit one item and route it to the least-loaded live replica.
        Returns a fleet-level future — it survives a replica death by
        re-routing to survivors. ``qos``, ``min_confidence``, ``model`` and
        ``tenant`` as for `AttributionServer.submit` (the router prefers
        replicas where ``model`` is resident). Raises `QueueFullError` only
        when every live replica rejected; a zero/negative ``deadline_ms``
        fails at admission with `InvalidDeadlineError` before any
        routing."""
        if self.labeled and y is None:
            raise ValueError("labeled fleet: submit(x, y) needs a class label")
        if not self.labeled and y is not None:
            raise ValueError("unlabeled fleet: submit() must not carry a label")
        if qos not in QOS_CLASSES:
            raise ValueError(f"qos must be one of {QOS_CLASSES}, got {qos!r}")
        if deadline_ms is not None and deadline_ms <= 0:
            raise InvalidDeadlineError(deadline_ms)
        if model is not None and model not in self._models:
            raise ValueError(
                f"unknown model {model!r}; configured fleet models: {sorted(self._models)}")
        x = np.asarray(x, self.dtype)
        bucket = self.table.select(x.shape)  # NoBucketError before any queueing
        ckey = None
        if self._cache is not None:
            # fleet-tier consult BEFORE routing: a hit never costs a
            # replica queue slot or a scoring pass
            ckey = self._cache.key(x, y, model=model)
            hit = self._cache.get(ckey, tenant=tenant)
            if hit is not None:
                self.metrics.note_cache_hit()
                fut: Future = Future()
                fut.set_result(hit)
                return fut
        now = time.perf_counter()
        if deadline_ms is None:
            deadline_at = (now + self.default_deadline_s) if self.default_deadline_s else None
        else:
            deadline_at = now + deadline_ms / 1e3
        req = _FleetRequest(x, y, bucket, deadline_at, Future(), qos=qos,
                            min_confidence=float(min_confidence), model=model,
                            tenant=tenant, ckey=ckey)
        if obs_tracing._STATE.enabled:
            # detached per-request root: ends on whichever thread resolves
            # the fleet future (worker callback), closing the trace
            root = obs_tracing.start_span("request", cat="fleet",
                                          bucket=bucket_key(bucket.shape))
            req.ctx = root.context
            req.future.add_done_callback(
                lambda f: root.end(
                    error=type(f.exception()).__name__ if f.exception() else None))
            try:
                self._route(req, raise_errors=True)
            except Exception as e:
                root.end(error=type(e).__name__)  # rejected before queueing
                raise
        else:
            self._route(req, raise_errors=True)
        return req.future

    def attribute(self, x, y=None, deadline_ms: float | None = None,
                  qos: str = "interactive", min_confidence: float = 0.0,
                  model: str | None = None, tenant: str | None = None):
        """Blocking convenience wrapper: submit + wait."""
        return self.submit(x, y, deadline_ms=deadline_ms, qos=qos,
                           min_confidence=min_confidence, model=model,
                           tenant=tenant).result()

    def submit_with_retry(self, x, y=None, *, policy=None, stats=None,
                          rng=None, deadline_ms: float | None = None) -> Future:
        """`submit` driven by a `serve.retry.RetryPolicy`: backpressure
        rejections back off (honoring ``retry_after_s``, capped + jittered)
        and resubmit within the policy's attempt/budget limits; optional
        hedging races a second submit against a slow first one. Returns a
        future resolving to the result or a typed `ServeError`
        (`RetryBudgetExceededError` once the policy gives up) — one daemon
        thread per call runs the policy."""
        from wam_tpu_torch.serve.retry import RetryPolicy

        policy = policy if policy is not None else RetryPolicy()
        outer: Future = Future()

        def _submit(remaining_s):
            per_attempt = deadline_ms
            if remaining_s is not None:
                rem_ms = remaining_s * 1e3
                per_attempt = rem_ms if per_attempt is None else min(per_attempt, rem_ms)
            return self.submit(x, y, deadline_ms=per_attempt)

        def _drive():
            try:
                outer.set_result(policy.run(_submit, rng=rng, stats=stats))
            except BaseException as e:  # noqa: BLE001 - the future carries it
                outer.set_exception(e)

        threading.Thread(target=_drive, daemon=True, name="wam-retry").start()
        return outer

    def attribute_batch(self, xs, ys=None, deadline_ms: float | None = None,
                        qos: str = "batch"):
        """Attribute a whole batch. ``len(xs) <= max_batch`` fans out as
        routed per-item submits (the workers coalesce them back into full
        device batches); anything larger takes the oversize data-parallel
        path over the fleet mesh (module docstring). Blocking; returns the
        stacked host result. Fanned-out items default to the ``batch`` QoS
        lane. An item shape no bucket admits takes the sequence-sharded
        route with a ``seq_factory`` and raises `NoBucketError` without one."""
        xs = np.asarray(xs, self.dtype)
        if xs.ndim < 2:
            raise ValueError("attribute_batch needs a leading batch axis")
        if self.labeled:
            ys = np.asarray(ys, np.int32).reshape(-1)
            if len(ys) != len(xs):
                raise ValueError(f"{len(xs)} items but {len(ys)} labels")
        elif ys is not None:
            raise ValueError("unlabeled fleet: attribute_batch() must not carry labels")
        try:
            bucket = self.table.select(xs.shape[1:])
        except NoBucketError:
            if self._seq_factory is None:
                raise
            return self._dispatch_seq_sharded(xs, ys)
        with self._lock:
            fleet_whole = self._os_entries is not None and all(r.alive for r in self._replicas)
        if len(xs) <= self.max_batch or not fleet_whole:
            futs = [self.submit(x, int(ys[i]) if self.labeled else None, deadline_ms, qos=qos)
                    for i, x in enumerate(xs)]
            return _stack([f.result() for f in futs])
        return self._dispatch_oversize(xs, ys, bucket)

    # -- routing ------------------------------------------------------------

    def _score(self, replica: _Replica, bucket: Bucket, model: str | None = None) -> float:
        """Projected completion estimate for a new item on this replica:
        its whole-queue drain plus one batch of the item's own bucket at
        the replica's OWN per-bucket EMA, plus the replica's SLO burn-rate
        penalty, plus the interactive-depth weight
        (`INTERACTIVE_DEPTH_WEIGHT`). A paged-model request reads the
        model's own lane EMA and pays `MODEL_PAGEIN_PENALTY_S` on replicas
        where the model is not resident."""
        ema = replica.metrics.ema_service_s(bucket.shape, model=model)
        interactive_depth = replica.server.qos_depths()["interactive"]
        score = (
            replica.server.projected_drain_s()
            + ema
            + replica.server.slo_penalty_s(bucket.shape)
            + INTERACTIVE_DEPTH_WEIGHT * (interactive_depth / replica.server.max_batch) * ema
        )
        if model is not None and model not in replica.server.models_resident():
            score += MODEL_PAGEIN_PENALTY_S
        return score

    def _route(self, req: _FleetRequest, raise_errors: bool) -> None:
        """Submit ``req`` to the best untried live replica; on total
        rejection raise/fail with the backpressure (or liveness) error.
        ``raise_errors`` distinguishes the synchronous admission path
        (client expects `QueueFullError` from `submit`) from async
        re-dispatch inside a future callback (errors land on the fleet
        future)."""

        def _fail(exc: Exception) -> None:
            if raise_errors:
                raise exc
            req.future.set_exception(exc)

        # admission span under the request's trace: re-routes after a death
        # show up as a second admission span on the same trace id
        with obs_tracing.use_context(req.ctx), obs_tracing.span(
            "admission", cat="fleet", rerouted=bool(req.tried)
        ):
            return self._route_inner(req, _fail)

    def _route_inner(self, req: _FleetRequest, _fail) -> None:
        with self._lock:
            if self._closed or not self._started:
                return _fail(ServerClosedError("fleet is not accepting requests"))
            cands = [r for r in self._replicas if r.alive and r.rid not in req.tried]
        if not cands:
            return _fail(NoLiveReplicaError(
                "no live replica left for this request",
                retry_after_s=self._restart_hint_s()))
        if req.deadline_at is not None:
            remaining_ms = (req.deadline_at - time.perf_counter()) * 1e3
            if remaining_ms <= 0.0:
                return _fail(DeadlineExceededError("deadline lapsed during re-route"))
        else:
            remaining_ms = None
        cands.sort(key=lambda r: self._score(r, req.bucket, req.model))  # stable: rid ties
        with self._lock:
            canary = self._canary
        if canary is not None:
            # schedule-A/B traffic split (pin_canary): the batch lane IS
            # the canary slice; the interactive lane avoids it except as a
            # last resort. Stable sorts keep the score order in each arm.
            cands.sort(key=lambda r: (r.rid != canary) if req.qos == "batch"
                       else (r.rid == canary))
        ok = {r.rid: r.server.health_ok() for r in cands}
        if not all(ok.values()):
            # numeric-health partition: quarantined replicas are routed
            # around like deaths but stay LAST-RESORT candidates
            cands = [r for r in cands if ok[r.rid]] + [r for r in cands if not ok[r.rid]]
        retry_after = None
        for r in cands:
            try:
                inner = r.server.submit(req.x, req.y, deadline_ms=remaining_ms, qos=req.qos,
                                        min_confidence=req.min_confidence, model=req.model,
                                        tenant=req.tenant)
            except QueueFullError as e:
                retry_after = (e.retry_after_s if retry_after is None
                               else min(retry_after, e.retry_after_s))
                continue
            except ServerClosedError:
                continue
            inner.add_done_callback(lambda f, r=r: self._harvest(f, r, req))
            return
        if retry_after is not None:
            return _fail(QueueFullError(retry_after))
        return _fail(NoLiveReplicaError(
            "every live replica refused this request",
            retry_after_s=self._restart_hint_s()))

    def _harvest(self, inner: Future, replica: _Replica, req: _FleetRequest) -> None:
        """Future callback (runs on the replica's worker thread): forward
        success and per-request errors; treat anything else as a device
        loss — mark the replica dead, notify the supervisor (when
        supervised), and re-route to survivors."""
        exc = inner.exception()
        if exc is None:
            result = inner.result()
            if (self._cache is not None and req.ckey is not None
                    and not replica.server.degraded
                    and not getattr(replica.server, "_anytime", False)):
                # populate at the fleet tier (replicas carry no cache);
                # degraded rebuilds and anytime results are skipped (their
                # rows depend on the fallback or the batch's deadline)
                self._cache.put(req.ckey, result, tenant=req.tenant)
            req.future.set_result(result)
            return
        if isinstance(exc, ServerClosedError):
            # the REPLICA closed under this request (supervisor restart in
            # progress, or its worker crashed mid-queue): a liveness event,
            # not a client semantic — re-route instead of forwarding
            with self._lock:
                fleet_closed = self._closed
            if not fleet_closed:
                req.tried.add(replica.rid)
                try:
                    self._route(req, raise_errors=False)
                except Exception as e:  # noqa: BLE001 - a callback must never raise
                    req.future.set_exception(e)
                return
            req.future.set_exception(exc)
            return
        if isinstance(exc, ServeError):
            # deadline / backpressure: per-request semantics, not a device
            # loss — the client decides what to do
            req.future.set_exception(exc)
            return
        with self._lock:
            was_alive = replica.alive
            replica.alive = False
        if was_alive:
            self.metrics.note_replica_death(replica.rid, repr(exc))
            if self._supervisor is not None:
                self._supervisor.notify_death(replica.rid, repr(exc))
        req.tried.add(replica.rid)
        try:
            self._route(req, raise_errors=False)
        except Exception as e:  # noqa: BLE001 - a callback must never raise
            req.future.set_exception(e)

    # -- oversize data-parallel path ----------------------------------------

    def _stage_block(self, rid: int, xs: torch.Tensor, ys):
        """Replica ``rid``'s block of a fleet-wide chunk, staged on its
        device (`pipeline.put_committed`)."""
        block = self._mesh.block(xs, P("data"), data=rid)
        yb = None if ys is None else self._mesh.block(ys, P("data"), data=rid)
        return put_committed((block, yb), self.devices[rid])

    def _replica_rows(self, rid: int, xs: torch.Tensor, ys):
        """A row-wise entry's block: the replica's rows run by its oversize
        entry on its device, fetched to the host. Runs on the replica's
        oversize thread."""
        with _grad_on(self.devices[rid]):
            return device_fetch(self._os_entries[rid](*self._stage_block(rid, xs, ys)))

    def _replica_partial(self, rid: int, xs: torch.Tensor, ys):
        """`RowBlocks.partial` of replica ``rid``'s rows (at row
        ``rid * max_batch`` of the chunk): the state stays on its device,
        the maxima come to the host."""
        with _grad_on(self.devices[rid]):
            sx, sy = self._stage_block(rid, xs, ys)
            state, maxima = self._os_entries[rid].wam_blocks.partial(
                sx, sy, rid * self.max_batch, xs.shape[0])
            return state, device_fetch(maxima)

    def _replica_finish(self, rid: int, state, maxima):
        with _grad_on(self.devices[rid]):
            return device_fetch(self._os_entries[rid].wam_blocks.finish(state, maxima))

    def _dispatch_seq_sharded(self, xs: np.ndarray, ys):
        """A batch whose item shape no bucket admits, through the
        sequence-sharded entry over the fleet mesh (module docstring), whole
        and synchronous: deadlines do not preempt it. Serialized on the
        oversize lock (the dispatch owns every device); its ledger row lands
        on the oversize `ServeMetrics` keyed by the item shape."""
        metrics = self.metrics.oversize
        metrics.note_submit(len(xs))
        item_shape = tuple(xs.shape[1:])
        skey = bucket_key(item_shape)
        with self._os_lock:
            entry = self._seq_entry
            if entry is None:
                mesh = self._mesh
                if mesh is None:  # fanout / one-replica fleets build no mesh up front
                    mesh = replica_mesh(self.n_replicas, self.devices)
                entry = self._seq_entry = self._seq_factory(mesh)
            t0 = time.perf_counter()
            with obs_tracing.span("seq_sharded_batch", cat="fleet", bucket=skey,
                                  n_real=len(xs)), obs_sentinel.label(
                    replica=OVERSIZE_ENTRY_ID, bucket=skey, phase="seq_sharded"):
                with metrics.stages.stage("dispatch"), _grad_on(self.devices[0]):
                    xt = torch.from_numpy(np.ascontiguousarray(xs))
                    yt = (torch.from_numpy(np.ascontiguousarray(ys)) if self.labeled
                          else None)
                    out = entry(xt, yt)
                with metrics.stages.stage("harvest"):
                    out = device_fetch(out)
            service_s = time.perf_counter() - t0
            metrics.note_batch(
                bucket_shape=item_shape,
                n_real=len(xs),
                max_batch=len(xs),  # the whole batch in one call: fill 1.0
                pad_waste=0.0,  # no bucket pad: the entry takes the exact shape
                queue_depth=0,
                service_s=service_s,
                queue_waits_s=[0.0] * len(xs),
                latencies_s=[service_s] * len(xs),
            )
        return out

    def _dispatch_oversize(self, xs: np.ndarray, ys, bucket: Bucket):
        """Data-parallel dispatch over the fleet mesh: chunk to the fleet-
        wide batch (``n_replicas × max_batch`` rows — one oversize input
        signature per bucket), one ``max_batch``-row block a replica, run
        concurrently on the replicas' oversize threads and gathered on the
        host; with `RowBlocks`, the blocks' maxima are reduced on the host
        between their partial and their finish. Serialized (`_os_lock`):
        each dispatch owns every device."""
        rows_per = self.n_replicas * self.max_batch
        metrics = self.metrics.oversize
        metrics.note_submit(len(xs))
        blocked = getattr(self._os_entries[0], "wam_blocks", None) is not None
        health = getattr(self._os_entries[0], "wam_health", False)
        outs = []
        with self._os_lock:
            if self._os_pools is None:
                self._os_pools = [ThreadPoolExecutor(max_workers=1,
                                                     thread_name_prefix=f"wam-fleet-os-{rid}")
                                  for rid in range(self.n_replicas)]
            bkey = bucket_key(bucket.shape)
            for lo in range(0, len(xs), rows_per):
                chunk = xs[lo:lo + rows_per]
                k = len(chunk)
                t0 = time.perf_counter()
                # one span per fleet-wide chunk; sentinel labels so the
                # oversize entries' first calls self-identify
                with obs_tracing.span("oversize_chunk", cat="fleet", bucket=bkey, n_real=k):
                    with metrics.stages.stage("assemble"):
                        padded = np.stack([pad_item(r, bucket) for r in chunk])
                        if k < rows_per:
                            # replicate-pad rows, same exactness argument as
                            # the single-replica batch pad (serve.buckets)
                            reps = np.repeat(padded[:1], rows_per - k, axis=0)
                            padded = np.concatenate([padded, reps])
                        yc = None
                        if self.labeled:
                            yc = ys[lo:lo + rows_per]
                            if k < rows_per:
                                yc = np.concatenate([yc, np.repeat(yc[:1], rows_per - k)])
                            yc = torch.from_numpy(np.ascontiguousarray(yc))
                        xt = torch.from_numpy(padded)
                    with metrics.stages.stage("dispatch"):
                        labels = {**obs_sentinel._current_labels(), "replica": OVERSIZE_ENTRY_ID,
                                  "bucket": bkey, "phase": "oversize"}

                        def each(fn, *per_rid):
                            def run(rid):
                                with obs_sentinel.label(**labels):
                                    return fn(rid, *(a[rid] for a in per_rid))

                            futs = [pool.submit(run, rid)
                                    for rid, pool in enumerate(self._os_pools)]
                            return [f.result() for f in futs]

                        if blocked:
                            parts = each(lambda rid: self._replica_partial(rid, xt, yc))
                            maxima = _tree_max([m for _, m in parts])
                            parts = each(lambda rid, state: self._replica_finish(
                                rid, state, maxima), [st for st, _ in parts])
                        else:
                            parts = each(lambda rid: self._replica_rows(rid, xt, yc))
                    with metrics.stages.stage("harvest"):
                        out = join_blocks(parts, health=health)
                        if health:
                            publish_stats(out[1], source="fleet_oversize", bucket=bkey)
                            out = out[0]
                        out = _head(out, k)
                service_s = time.perf_counter() - t0
                metrics.note_batch(
                    bucket_shape=bucket.shape,
                    n_real=k,
                    max_batch=rows_per,
                    pad_waste=float(np.mean([bucket.pad_waste(r.shape) for r in chunk])),
                    queue_depth=0,
                    service_s=service_s,
                    queue_waits_s=[0.0] * k,
                    latencies_s=[service_s] * k,
                )
                outs.append(out)
        return join_blocks(outs)


def _tree_max(trees: list):
    """Elementwise max of host arrays, or of tuples of them, across blocks."""
    if isinstance(trees[0], (tuple, list)):
        return type(trees[0])(_tree_max(list(t)) for t in zip(*trees))
    return np.maximum.reduce([np.asarray(t) for t in trees])
