"""Per-request serving metrics (PyTorch port of `wam_tpu.serve.metrics`).

The serving runtime's observable state, accumulated thread-safely and
emitted as `results.JsonlWriter` ledger rows: one ``serve_batch`` row per
dispatched batch (queue depth, fill ratio, pad waste, service time) plus a
``serve_summary`` row per drain window (p50/p99 latency, attributions/sec,
reject/expiry counts, first-call count). Stage wall-clock inside the worker
loop reuses `profiling.StageTimer` (assemble / dispatch / harvest /
distribute).

The ledger schema is the reference's v2 (`SCHEMA_VERSION = 2`): every
summary row carries ``schema_version``, ``replica_id`` (None on a
single-card server), ``ema_service_s`` (the per-BUCKET EMA service-time map
that feeds `QueueFullError.retry_after_s`), ``warmup_s`` (per-bucket warmup
seconds), ``busy_s`` and ``utilization`` (dispatch-to-harvest busy time
over the window; pipelined overlap can push utilization above the card's
true duty cycle — it is a routing/idleness signal, not a device
measurement). ``compile_count`` counts first calls at a new signature (the
reference counts jit traces). ``serve_batch`` rows carry the schedule
fingerprint (`tune.cache.schedule_fingerprint`, the digest of the loaded
schedule table). `FleetMetrics` aggregates a
fleet's replica ledgers (`serve.fleet`) into one ``fleet_summary`` row
(aggregate attributions/s, pooled latency percentiles, per-replica
utilization, replica deaths and restarts, oversize counters), with one
``replica_restart`` row per supervisor transition.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from wam_tpu_torch.obs.registry import registry as _obs_registry
from wam_tpu_torch.profiling import StageTimer
from wam_tpu_torch.results import JsonlWriter
from wam_tpu_torch.serve.buckets import bucket_key

__all__ = ["ServeMetrics", "FleetMetrics", "percentile_ms", "SCHEMA_VERSION",
           "write_obs_snapshot", "write_slo_status", "write_result_cache"]

SCHEMA_VERSION = 2

# -- obs registry instruments (second sink; JSONL schema untouched) ---------
# Counters mirror the ServeMetrics counters 1:1 so `obs.render_prom()` and
# the JSONL summary can be cross-checked exactly (bench_serve --emit test).
# Label cardinality: replica id ("-" when unset) and bucket key only.

def _rlabel(replica_id) -> str:
    return "-" if replica_id is None else str(replica_id)


_c_submitted = _obs_registry.counter(
    "wam_tpu_serve_submitted_total", "requests accepted by submit()",
    labels=("replica",))
_c_completed = _obs_registry.counter(
    "wam_tpu_serve_completed_total", "requests resolved with a result",
    labels=("replica",))
_c_rejected = _obs_registry.counter(
    "wam_tpu_serve_rejected_total", "requests rejected by backpressure",
    labels=("replica",))
_c_expired = _obs_registry.counter(
    "wam_tpu_serve_expired_total", "requests whose deadline passed queued",
    labels=("replica",))
_c_failed = _obs_registry.counter(
    "wam_tpu_serve_failed_total", "requests failed with no fallback",
    labels=("replica",))
_c_fallbacks = _obs_registry.counter(
    "wam_tpu_serve_fallback_batches_total",
    "batches served by the degraded CPU entry", labels=("replica",))
_c_compiles = _obs_registry.counter(
    "wam_tpu_serve_compile_total", "serve-entry jit cache misses",
    labels=("replica",))
_c_batches = _obs_registry.counter(
    "wam_tpu_serve_batches_total", "dispatched batches",
    labels=("replica", "bucket"))
_g_queue_depth = _obs_registry.gauge(
    "wam_tpu_serve_queue_depth",
    "queue depth observed at batch assembly", labels=("replica", "bucket"))
_g_ema_service = _obs_registry.gauge(
    "wam_tpu_serve_ema_service_seconds",
    "per-bucket EMA batch service time (routing signal)",
    labels=("replica", "bucket"))
_h_latency = _obs_registry.histogram(
    "wam_tpu_serve_latency_seconds", "submit->result request latency",
    labels=("replica",))
_h_occupancy = _obs_registry.histogram(
    "wam_tpu_serve_batch_occupancy",
    "per-dispatch real-row occupancy (n_real / max_batch) — the coalescing "
    "acceptance gate reads this", labels=("replica",),
    buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
_h_service = _obs_registry.histogram(
    "wam_tpu_serve_service_seconds", "dispatch->harvest batch service time",
    labels=("replica",))
_g_warmup = _obs_registry.gauge(
    "wam_tpu_fleet_warmup_seconds", "per-bucket warmup wall time",
    labels=("replica", "bucket"))
_c_deaths = _obs_registry.counter(
    "wam_tpu_fleet_replica_deaths_total", "replicas marked dead fleet-wide")
_c_restarts = _obs_registry.counter(
    "wam_tpu_serve_restarts_total",
    "completed replica restarts (supervisor 'alive' transitions)",
    labels=("replica",))
_g_fleet_compiles = _obs_registry.gauge(
    "wam_tpu_fleet_compile_count",
    "compile_count per replica as of the last fleet_summary()",
    labels=("replica",))
_c_any_batches = _obs_registry.counter(
    "wam_tpu_anytime_batches_total",
    "batches driven through the anytime stride loop",
    labels=("replica", "bucket"))
_c_any_early = _obs_registry.counter(
    "wam_tpu_anytime_early_exit_total",
    "anytime batches that exited on convergence before n_total",
    labels=("replica",))
_c_any_partial = _obs_registry.counter(
    "wam_tpu_anytime_deadline_partial_total",
    "anytime batches delivered best-so-far at a closing deadline",
    labels=("replica",))
_c_any_strides = _obs_registry.counter(
    "wam_tpu_anytime_strides_total",
    "stride dispatches executed by the anytime driver",
    labels=("replica",))
_h_any_fraction = _obs_registry.histogram(
    "wam_tpu_anytime_samples_fraction",
    "n_used / n_total at delivery (1.0 = ran to completion)",
    labels=("replica",),
    buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
_h_any_conf = _obs_registry.histogram(
    "wam_tpu_anytime_confidence",
    "per-request confidence scalar at delivery",
    labels=("replica",),
    buckets=(0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 0.99, 1.0))

# Per-bucket EMA service-time seed until the first batch of that bucket
# lands: the retry-after / routing estimate for a never-served bucket.
EMA_SEED_S = 0.05


def _live_schedule_fingerprint():
    """The active tuned-schedule fingerprint stamped onto every
    ``serve_batch`` row (`result_cache.schedule_fingerprint`)."""
    from wam_tpu_torch.serve.result_cache import schedule_fingerprint

    return schedule_fingerprint()


def percentile_ms(latencies_s, q: float) -> float:
    """Linear-interpolated percentile of a latency sample, in ms (NaN when
    empty — a summary of zero requests has no latency)."""
    if not latencies_s:
        return float("nan")
    return float(np.quantile(np.asarray(latencies_s, np.float64), q / 100.0) * 1e3)


class ServeMetrics:
    """Accumulator shared by the dispatcher (submit side) and the worker
    loop (drain side); every mutator takes the lock, so client threads and
    the device-owner thread can hit it concurrently. ``replica_id``
    identifies this accumulator's worker in a fleet (None = single-chip)."""

    def __init__(self, replica_id=None):
        self._lock = threading.Lock()
        self.replica_id = replica_id
        self._rl = _rlabel(replica_id)  # obs registry replica label
        # span_prefix threads batch-stage intervals into request traces
        self.stages = StageTimer(span_prefix="serve.")
        self.compile_count = 0  # first calls at a new signature (on_trace hook)
        self.submitted = 0
        self.completed = 0
        self.rejected = 0  # backpressure (queue full)
        self.expired = 0  # deadline passed while queued
        self.failed = 0  # engine raised; no fallback could serve it
        self.fallbacks = 0  # batches served by the degraded fallback entry
        self.busy_s = 0.0  # summed dispatch->harvest service time
        self.cache_hits = 0  # result-cache hits (resolved without admission)
        self.latencies_s: list[float] = []  # submit -> result, per request
        self.queue_waits_s: list[float] = []  # submit -> batch assembly
        self.batch_rows: list[dict] = []  # one dict per dispatched batch
        self._latency_by_qos: dict[str, list[float]] = {}  # class -> sample
        # runtime attaches its ResultCache so emit() can flush a
        # result_cache row next to this replica's summary (None = no cache)
        self.result_cache = None
        # per-row schedule attribution: None = stamp the process-global
        # tuned-table fingerprint; the fleet's canary hook overrides this
        # so the challenger replica's rows carry the CHALLENGER fingerprint
        self.schedule_fingerprint = None
        self.warmup_s: dict[str, float] = {}  # bucket key -> warmup seconds
        self._ema_service_s: dict[str, float] = {}  # bucket key -> EMA
        # runtime attaches its SLOTracker so emit() can flush a slo_status
        # row next to this replica's summary (None = no SLO policy)
        self.slo = None
        # multi-model residency: the runtime stamps {model_id: bytes} here
        # at close so the obs_snapshot row records what was resident
        self.models_resident = None
        # anytime serving (wam_tpu.anytime): stride-loop counters + samples
        self.anytime_batches = 0
        self.anytime_strides = 0
        self.anytime_early_exits = 0
        self.anytime_deadline_partials = 0
        self._anytime_fractions: list[float] = []  # n_used/n_total per batch
        self._anytime_confidences: list[float] = []  # per delivered request
        self._partial_rows: list[dict] = []  # partial_result ledger rows
        self._t0 = time.perf_counter()

    # -- mutators (called from dispatcher / worker threads) -----------------

    def note_compile(self) -> None:
        """Hook for `serve_entry(on_trace=...)`: runs once per first call at
        a new input signature, i.e. once per bucket."""
        with self._lock:
            self.compile_count += 1
        _c_compiles.inc(replica=self._rl)

    def note_submit(self, n: int = 1) -> None:
        with self._lock:
            self.submitted += n
        _c_submitted.inc(n, replica=self._rl)

    def note_cache_hit(self, n: int = 1) -> None:
        """A submit answered from the result cache (never admitted — the
        hit does NOT count into ``completed``/``latencies_s``, which remain
        the computed-request ledger; the cache's own hit/miss counters live
        on the `ResultCache` and its registry instruments)."""
        with self._lock:
            self.cache_hits += n

    def note_reject(self) -> None:
        with self._lock:
            self.rejected += 1
        _c_rejected.inc(replica=self._rl)

    def note_expired(self, n: int = 1) -> None:
        with self._lock:
            self.expired += n
        _c_expired.inc(n, replica=self._rl)

    def note_failed(self, n: int = 1) -> None:
        with self._lock:
            self.failed += n
        _c_failed.inc(n, replica=self._rl)

    def note_fallback(self) -> None:
        with self._lock:
            self.fallbacks += 1
        _c_fallbacks.inc(replica=self._rl)

    def note_warmup(self, bucket_shape: tuple[int, ...], seconds: float) -> None:
        """One bucket's `start()` warmup (trace + compile + first dispatch),
        recorded per bucket so the ledger shows cold-start cost bucket by
        bucket (ROADMAP item 2's first measurement)."""
        key = bucket_key(bucket_shape)
        with self._lock:
            self.warmup_s[key] = float(seconds)
        _g_warmup.set(float(seconds), replica=self._rl, bucket=key)

    def ema_service_s(self, bucket_shape=None, model=None):
        """Per-bucket EMA batch service time — the retry-after and fleet
        routing signal. With a shape: that bucket's EMA (``EMA_SEED_S``
        until its first batch lands). Without: a copy of the whole map.
        ``model`` scopes the lookup to a paged model's own lane
        (``model|bucket`` keys) so service stats cannot pollute across
        models sharing a fleet; None reads the default entry's keys."""
        with self._lock:
            if bucket_shape is None:
                return dict(self._ema_service_s)
            key = bucket_key(bucket_shape)
            if model is not None:
                key = f"{model}|{key}"
            return self._ema_service_s.get(key, EMA_SEED_S)

    def note_batch(
        self,
        *,
        bucket_shape: tuple[int, ...],
        n_real: int,
        max_batch: int,
        pad_waste: float,
        queue_depth: int,
        service_s: float,
        queue_waits_s: list[float],
        latencies_s: list[float],
        qos: list[str] | None = None,
        model_id: str | None = None,
        tenants: list | None = None,
    ) -> None:
        """One dispatched batch: aggregate row + per-request samples, and
        the per-bucket service-time EMA update (first observation seeds the
        EMA directly; later ones blend 0.8/0.2). ``qos`` is the per-request
        class list parallel to ``latencies_s`` — it splits the latency
        sample into per-class percentiles (`snapshot` ``latency_by_qos``)
        and stamps per-class counts onto the batch row (the workload-mix
        miner's bucket × qos histogram, `tune.mix`). ``model_id`` scopes
        the EMA update to the model's own ``model|bucket`` key and stamps
        the batch row; ``tenants`` (per-request, parallel to
        ``latencies_s``) stamps per-tenant counts onto the row."""
        occupancy = n_real / max_batch
        # resolved OUTSIDE the accumulator lock: the first call may load
        # the schedule-cache files (tune.cache takes its own lock)
        fp = self.schedule_fingerprint
        if fp is None:
            fp = _live_schedule_fingerprint()
        with self._lock:
            self.completed += len(latencies_s)
            self.latencies_s.extend(latencies_s)
            self.queue_waits_s.extend(queue_waits_s)
            if qos is not None:
                for cls, lat in zip(qos, latencies_s):
                    self._latency_by_qos.setdefault(cls, []).append(lat)
            self.busy_s += service_s
            key = bucket_key(bucket_shape)
            if model_id is not None:
                key = f"{model_id}|{key}"
            prev = self._ema_service_s.get(key)
            self._ema_service_s[key] = (
                service_s if prev is None else 0.8 * prev + 0.2 * service_s
            )
            row = {
                "metric": "serve_batch",
                "bucket": list(bucket_shape),
                "n_real": n_real,
                "fill_ratio": occupancy,
                "occupancy": occupancy,
                "pad_waste": pad_waste,
                "queue_depth": queue_depth,
                "service_s": service_s,
                "timestamp": time.time(),
            }
            if fp is not None:
                row["schedule_fingerprint"] = fp
            if qos is not None:
                counts: dict[str, int] = {}
                for cls in qos:
                    counts[cls] = counts.get(cls, 0) + 1
                row["qos"] = counts
            if model_id is not None:
                row["model_id"] = model_id
            if tenants is not None:
                tcounts: dict[str, int] = {}
                for t in tenants:
                    if t is not None:
                        tcounts[t] = tcounts.get(t, 0) + 1
                if tcounts:
                    row["tenants"] = tcounts
            if self.replica_id is not None:
                row["replica_id"] = self.replica_id
            self.batch_rows.append(row)
        # registry publication (second sink, outside the accumulator lock)
        _c_completed.inc(len(latencies_s), replica=self._rl)
        _c_batches.inc(replica=self._rl, bucket=key)
        _g_queue_depth.set(queue_depth, replica=self._rl, bucket=key)
        _g_ema_service.set(self._ema_service_s[key], replica=self._rl,
                           bucket=key)
        _h_service.observe(service_s, replica=self._rl)
        _h_occupancy.observe(occupancy, replica=self._rl)
        for lat in latencies_s:
            _h_latency.observe(lat, replica=self._rl)

    def note_anytime(
        self,
        *,
        bucket_shape: tuple[int, ...],
        n_used: int,
        n_total: int,
        strides: int,
        converged: bool,
        deadline_hit: bool,
        confidences: list[float],
    ) -> None:
        """One batch through the anytime stride loop (`anytime.driver`):
        counters, the samples-fraction / confidence histograms, and — when
        the batch was delivered SHORT of ``n_total`` — one ``partial_result``
        v2 ledger row recording what was served instead of a full map
        (an early convergence exit or a deadline best-so-far delivery)."""
        key = bucket_key(bucket_shape)
        fraction = n_used / n_total if n_total > 0 else 1.0
        with self._lock:
            self.anytime_batches += 1
            self.anytime_strides += strides
            self.anytime_early_exits += bool(converged)
            self.anytime_deadline_partials += bool(deadline_hit)
            self._anytime_fractions.append(fraction)
            self._anytime_confidences.extend(confidences)
            if n_used < n_total:
                row = {
                    "metric": "partial_result",
                    "schema_version": SCHEMA_VERSION,
                    "bucket": list(bucket_shape),
                    "n_requests": len(confidences),
                    "n_used": int(n_used),
                    "n_total": int(n_total),
                    "samples_fraction": fraction,
                    "converged": bool(converged),
                    "deadline_hit": bool(deadline_hit),
                    "confidence_min": float(min(confidences)) if confidences
                    else float("nan"),
                    "confidence_mean": float(np.mean(confidences))
                    if confidences else float("nan"),
                    "timestamp": time.time(),
                }
                if self.replica_id is not None:
                    row["replica_id"] = self.replica_id
                self._partial_rows.append(row)
        _c_any_batches.inc(replica=self._rl, bucket=key)
        _c_any_strides.inc(strides, replica=self._rl)
        if converged:
            _c_any_early.inc(replica=self._rl)
        if deadline_hit:
            _c_any_partial.inc(replica=self._rl)
        _h_any_fraction.observe(fraction, replica=self._rl)
        for c in confidences:
            _h_any_conf.observe(float(c), replica=self._rl)

    # -- reporting ----------------------------------------------------------

    def latency_sample(self) -> list[float]:
        """Copy of the per-request latency sample (fleet pooling)."""
        with self._lock:
            return list(self.latencies_s)

    def batch_sample(self) -> list[dict]:
        """Copy of the dispatched-batch rows (the canary comparison and
        the workload-mix miner read per-batch service times from these)."""
        with self._lock:
            return list(self.batch_rows)

    def snapshot(self) -> dict:
        """Aggregate window stats; keys are the schema-v2 ledger row
        documented in the module docstring (every v1 key preserved)."""
        with self._lock:
            window_s = time.perf_counter() - self._t0
            fills = [r["fill_ratio"] for r in self.batch_rows]
            wastes = [r["pad_waste"] for r in self.batch_rows]
            depths = [r["queue_depth"] for r in self.batch_rows]
            return {
                "metric": "serve_summary",
                "schema_version": SCHEMA_VERSION,
                "replica_id": self.replica_id,
                "window_s": window_s,
                "submitted": self.submitted,
                "completed": self.completed,
                "rejected": self.rejected,
                "expired": self.expired,
                "failed": self.failed,
                "fallback_batches": self.fallbacks,
                "batches": len(self.batch_rows),
                "compile_count": self.compile_count,
                "fill_ratio_mean": float(np.mean(fills)) if fills else float("nan"),
                # occupancy is fill_ratio under its coalescing-gate name;
                # the open-loop bench and BASELINE round 13 read this key
                "occupancy_mean": float(np.mean(fills)) if fills else float("nan"),
                "cache_hits": self.cache_hits,
                "latency_by_qos": {
                    cls: {
                        "n": len(sample),
                        "p50_ms": percentile_ms(sample, 50),
                        "p99_ms": percentile_ms(sample, 99),
                    }
                    for cls, sample in sorted(self._latency_by_qos.items())
                },
                "pad_waste_mean": float(np.mean(wastes)) if wastes else float("nan"),
                "queue_depth_mean": float(np.mean(depths)) if depths else float("nan"),
                "queue_depth_max": int(max(depths)) if depths else 0,
                "latency_p50_ms": percentile_ms(self.latencies_s, 50),
                "latency_p99_ms": percentile_ms(self.latencies_s, 99),
                "queue_wait_p50_ms": percentile_ms(self.queue_waits_s, 50),
                "attributions_per_s": self.completed / window_s if window_s > 0 else 0.0,
                "ema_service_s": dict(self._ema_service_s),
                "warmup_s": dict(self.warmup_s),
                "busy_s": self.busy_s,
                "utilization": self.busy_s / window_s if window_s > 0 else 0.0,
                "stages": self.stages.summary(),
                "anytime": {
                    "batches": self.anytime_batches,
                    "strides": self.anytime_strides,
                    "early_exits": self.anytime_early_exits,
                    "deadline_partials": self.anytime_deadline_partials,
                    "samples_fraction_mean": float(
                        np.mean(self._anytime_fractions))
                    if self._anytime_fractions else float("nan"),
                    "confidence_mean": float(
                        np.mean(self._anytime_confidences))
                    if self._anytime_confidences else float("nan"),
                },
            }

    def summary(self) -> dict:
        """Back-compat alias for `snapshot()` (the v1 name)."""
        return self.snapshot()

    def emit(self, writer: JsonlWriter, config: dict | None = None,
             obs_snapshot: bool = True) -> dict:
        """Flush batch rows + the summary row to a JSONL ledger; returns the
        summary. ``config`` is attached to the summary row the way
        `results.MetricRecord` carries its config. Unless suppressed
        (``obs_snapshot=False`` — `FleetMetrics.emit` writes ONE fleet-wide
        snapshot instead of N per-replica copies), an ``obs_snapshot`` row
        with the registry's flattened values follows the summary — the
        periodic registry-in-the-ledger record."""
        with self._lock:
            rows = list(self.batch_rows) + list(self._partial_rows)
        for row in rows:
            writer.write(row)
        summary = self.snapshot()
        if config is not None:
            summary["config"] = config
        writer.write(summary)
        if self.slo is not None:
            write_slo_status(writer, self.slo)
        if self.result_cache is not None:
            write_result_cache(writer, self.result_cache)
        if obs_snapshot:
            write_obs_snapshot(writer, models=self.models_resident)
        return summary


def write_slo_status(writer: JsonlWriter, tracker) -> dict:
    """One ``slo_status`` ledger row from a `wam_tpu_torch.obs.SLOTracker`: the
    per-bucket burn-rate / error-rate / health-rate / p99 snapshot, stamped
    with the ledger schema version here (the obs package stays stdlib-only
    and does not know the serve schema). Publishing the row also refreshes
    the ``wam_tpu_slo_*`` gauges from the SAME floats, so a ledger row and
    a registry scrape taken together agree exactly."""
    row = tracker.snapshot_row(publish=True)
    row["schema_version"] = SCHEMA_VERSION
    writer.write(row)
    return row


def write_result_cache(writer: JsonlWriter, cache) -> dict:
    """One ``result_cache`` ledger row from a `serve.result_cache
    .ResultCache`: hit/miss/eviction counters + resident bytes, stamped
    with the ledger schema version here (the cache row body comes from
    `ResultCache.row`, the envelope is the ledger's concern)."""
    row = cache.row()
    row["schema_version"] = SCHEMA_VERSION
    writer.write(row)
    return row


def write_obs_snapshot(writer: JsonlWriter, models=None) -> dict:
    """One ``obs_snapshot`` ledger row: the registry's flattened values at
    this instant (a NEW row kind — existing v2 rows are untouched).
    ``models`` is the resident-model map (``{model_id: bytes}``) stamped
    as ``models_resident`` when the emitting server pages models."""
    row = {
        "metric": "obs_snapshot",
        "schema_version": SCHEMA_VERSION,
        "registry": _obs_registry.collect(),
        "timestamp": time.time(),
    }
    if models is not None:
        row["models_resident"] = models
    writer.write(row)
    return row


class FleetMetrics:
    """Fleet-wide aggregator (`serve.fleet.FleetServer`): one `ServeMetrics`
    per replica worker, one for the fleet-wide oversize entry, and the
    ``fleet_summary`` ledger row — aggregate attributions/sec across the
    whole fleet, pooled latency percentiles, per-replica utilization, and
    the replica-death trail."""

    def __init__(self):
        self._lock = threading.Lock()
        self._replicas: dict = {}  # replica_id -> ServeMetrics
        self.deaths: list[dict] = []
        self.restarts: list[dict] = []  # replica_restart transition rows
        self.oversize = ServeMetrics(replica_id="fleet")
        # the fleet attaches its SHARED admission-tier ResultCache here
        # (replica servers carry none — fleet.py owns consult/populate)
        self.result_cache = None
        self.cache_hits = 0  # fleet-tier submits answered from the cache
        self._t0 = time.perf_counter()

    def replica(self, replica_id) -> ServeMetrics:
        """Get-or-create the per-replica accumulator."""
        with self._lock:
            if replica_id not in self._replicas:
                self._replicas[replica_id] = ServeMetrics(replica_id=replica_id)
            return self._replicas[replica_id]

    def note_cache_hit(self, n: int = 1) -> None:
        """A fleet-tier submit answered from the shared result cache
        (never routed to a replica)."""
        with self._lock:
            self.cache_hits += n

    def note_replica_death(self, replica_id, reason: str = "") -> None:
        with self._lock:
            self.deaths.append(
                {"replica_id": replica_id, "reason": reason, "timestamp": time.time()}
            )
        _c_deaths.inc()

    def note_restart(self, replica_id, transition: str, *, attempt: int = 0,
                     backoff_s: float = 0.0, reason: str = "") -> dict:
        """One supervisor lifecycle transition (``restarting`` → ``alive`` /
        ``restart_failed`` / ``permanent_dead``) as a v2 ``replica_restart``
        ledger row. Completed restarts (``alive``) also count into
        ``wam_tpu_serve_restarts_total`` so ledger and registry round-trip."""
        row = {
            "metric": "replica_restart",
            "schema_version": SCHEMA_VERSION,
            "replica_id": replica_id,
            "transition": transition,
            "attempt": attempt,
            "backoff_s": backoff_s,
            "reason": reason,
            "timestamp": time.time(),
        }
        with self._lock:
            self.restarts.append(row)
        if transition == "alive":
            _c_restarts.inc(replica=_rlabel(replica_id))
        return row

    @staticmethod
    def load_ledger(path: str) -> list[dict]:
        """Tolerant ledger merge-read: every parseable row, corrupt lines
        skipped with a counted warning (`results.read_jsonl`)."""
        from wam_tpu_torch.results import read_jsonl

        return read_jsonl(path)

    def fleet_summary(self) -> dict:
        """The aggregate row: fleet throughput is completed requests (replica
        + oversize) over the fleet's window; latencies pool every replica's
        sample so p99 reflects the slowest routing decisions, not the best
        replica."""
        with self._lock:
            replicas = dict(self._replicas)
            deaths = list(self.deaths)
            restarts = list(self.restarts)
            t0 = self._t0
        window_s = time.perf_counter() - t0
        per_replica = []
        latencies: list[float] = []
        completed = submitted = rejected = expired = failed = compile_count = 0
        for rid in sorted(replicas, key=str):
            m = replicas[rid]
            s = m.snapshot()
            completed += s["completed"]
            submitted += s["submitted"]
            rejected += s["rejected"]
            expired += s["expired"]
            failed += s["failed"]
            compile_count += s["compile_count"]
            latencies.extend(m.latency_sample())
            # registry publication: first-call/warmup state as of this
            # summary (idempotent gauge sets)
            _g_fleet_compiles.set(s["compile_count"], replica=_rlabel(rid))
            for bucket, secs in s["warmup_s"].items():
                _g_warmup.set(secs, replica=_rlabel(rid), bucket=bucket)
            per_replica.append(
                {
                    "replica_id": rid,
                    "completed": s["completed"],
                    "batches": s["batches"],
                    "compile_count": s["compile_count"],
                    "attributions_per_s": s["completed"] / window_s if window_s > 0 else 0.0,
                    "utilization": s["busy_s"] / window_s if window_s > 0 else 0.0,
                    "ema_service_s": s["ema_service_s"],
                }
            )
        os_snap = self.oversize.snapshot()
        completed += os_snap["completed"]
        submitted += os_snap["submitted"]
        latencies.extend(self.oversize.latency_sample())
        with self._lock:
            cache_hits = self.cache_hits
            cache_stats = (self.result_cache.stats()
                           if self.result_cache is not None else None)
        return {
            "metric": "fleet_summary",
            "schema_version": SCHEMA_VERSION,
            "replicas": len(per_replica),
            "deaths": deaths,
            "restarts": sum(1 for r in restarts if r["transition"] == "alive"),
            "permanent_dead": sorted(
                {str(r["replica_id"]) for r in restarts
                 if r["transition"] == "permanent_dead"}),
            "window_s": window_s,
            "submitted": submitted,
            "completed": completed,
            "rejected": rejected,
            "expired": expired,
            "failed": failed,
            "compile_count": compile_count,
            "attributions_per_s": completed / window_s if window_s > 0 else 0.0,
            "latency_p50_ms": percentile_ms(latencies, 50),
            "latency_p99_ms": percentile_ms(latencies, 99),
            "oversize_batches": os_snap["batches"],
            "oversize_completed": os_snap["completed"],
            "cache_hits": cache_hits,
            "result_cache": cache_stats,
            "per_replica": per_replica,
        }

    def emit(
        self,
        writer: JsonlWriter,
        config: dict | None = None,
        replica_configs: dict | None = None,
    ) -> dict:
        """Flush every replica ledger (batch rows + per-replica summary),
        the oversize ledger when it dispatched anything, the restart rows,
        then the ``fleet_summary`` row; returns the fleet summary."""
        with self._lock:
            replicas = dict(self._replicas)
        for rid in sorted(replicas, key=str):
            cfg = (replica_configs or {}).get(rid)
            replicas[rid].emit(writer, config=cfg, obs_snapshot=False)
        if self.oversize.batch_rows:
            self.oversize.emit(writer, config={"oversize": True},
                               obs_snapshot=False)
        with self._lock:
            restart_rows = list(self.restarts)
        for row in restart_rows:
            writer.write(row)
        summary = self.fleet_summary()
        if config is not None:
            summary["config"] = config
        writer.write(summary)
        if self.result_cache is not None:
            write_result_cache(writer, self.result_cache)
        write_obs_snapshot(writer)
        return summary
