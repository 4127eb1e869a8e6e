"""Pod-level metrics: the v2 ledger rows and obs gauges for the process
tier.

`serve.metrics.ServeMetrics` counts one server, `FleetMetrics` pools a
fleet of replicas; `PodMetrics` pools a pod of worker PROCESSES. It does
not duplicate the workers' own accounting — each worker's fleet writes
its own ledger (``--metrics-path`` with a ``{wid}`` template) — it
records what only the router can see: router-side end-to-end request
latency (admission to result, across the process boundary), worker
lifecycle (ready / death / restart transitions), autoscale decisions,
and the per-worker final snapshots whose ``compile_count`` /
``post_warm_compiles`` the zero-compile-respawn acceptance reads.

Ledger rows (all ``schema_version`` 2, same `results.JsonlWriter`
pipeline as serve):

- ``pod_worker`` — one per worker incarnation at ready and again at
  final (bye/death), carrying the wire `WorkerSnapshot`;
- ``worker_restart`` — the `PodSupervisor` transition trail
  (``restarting`` / ``alive`` / ``respawn_failed`` / ``permanent_dead``),
  mirroring the serve tier's ``replica_restart`` grammar;
- ``pod_autoscale`` — every grow/shrink with the drain signal that
  triggered it;
- ``pod_summary`` — the aggregate: pooled router-side latency
  percentiles, attributions/sec over the pod window, deaths/restarts,
  and per-worker rows.

Prometheus-side, the ``wam_tpu_pod_*`` instruments extend the existing
``wam_tpu_serve_*`` / ``wam_tpu_fleet_*`` families one tier up.
"""

from __future__ import annotations

import threading
import time
from dataclasses import asdict

from wam_tpu_torch.obs.registry import registry as _obs_registry
from wam_tpu_torch.serve.metrics import SCHEMA_VERSION, percentile_ms

__all__ = ["PodMetrics"]

_g_workers_alive = _obs_registry.gauge(
    "wam_tpu_pod_workers_alive", "live worker processes in the pod")
_g_worker_drain = _obs_registry.gauge(
    "wam_tpu_pod_worker_drain_seconds",
    "per-worker projected_drain_s from the last heartbeat",
    labels=("worker",))
_c_deaths = _obs_registry.counter(
    "wam_tpu_pod_worker_deaths_total", "worker processes declared dead",
    labels=("worker",))
_c_restarts = _obs_registry.counter(
    "wam_tpu_pod_worker_restarts_total",
    "pod supervisor restart transitions", labels=("worker", "transition"))
_c_autoscale = _obs_registry.counter(
    "wam_tpu_pod_autoscale_total", "autoscaler actions applied",
    labels=("direction",))
_c_completed = _obs_registry.counter(
    "wam_tpu_pod_requests_completed_total",
    "requests resolved OK through the pod router")
_c_coalesced = _obs_registry.counter(
    "wam_tpu_pod_net_heartbeats_coalesced_total",
    "health probes skipped because one was already outstanding")
_c_registry_stream = _obs_registry.counter(
    "wam_tpu_pod_net_registry_stream_bytes_total",
    "registry bundle bytes streamed to probing workers")
_g_host_rtt = _obs_registry.gauge(
    "wam_tpu_pod_net_host_rtt_seconds",
    "per-host control-channel RTT EMA (heartbeat round-trips)",
    labels=("host",))

_LATENCY_SAMPLE_MAX = 200_000  # bounded like ServeMetrics' sample


class PodMetrics:
    """Thread-safe pod accounting (see module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.latencies_s: list[float] = []
        self.completed = 0
        self.worker_rows: list[dict] = []  # pod_worker rows (ready + final)
        self.restarts: list[dict] = []  # worker_restart rows
        self.autoscale_rows: list[dict] = []  # pod_autoscale rows
        self.deaths: list[dict] = []

    # -- router-side request accounting -------------------------------------

    def note_request(self, latency_s: float) -> None:
        _c_completed.inc()
        with self._lock:
            self.completed += 1
            if len(self.latencies_s) < _LATENCY_SAMPLE_MAX:
                self.latencies_s.append(latency_s)

    # -- wire transport -------------------------------------------------------

    def note_heartbeat_coalesced(self) -> None:
        _c_coalesced.inc()

    def note_registry_stream(self, nbytes: int) -> None:
        if nbytes:
            _c_registry_stream.inc(nbytes)

    def note_host_rtt(self, host: str, ema_s: float) -> None:
        _g_host_rtt.set(ema_s, host=host)

    # -- worker lifecycle ----------------------------------------------------

    def _worker_row(self, wid: int, incarnation: int, snapshot,
                    phase: str, **extra) -> dict:
        row = {
            "metric": "pod_worker",
            "schema_version": SCHEMA_VERSION,
            "worker_id": wid,
            "incarnation": incarnation,
            "phase": phase,  # "ready" | "final"
            **extra,
        }
        if snapshot is not None:
            row.update(asdict(snapshot))
        return row

    def note_worker_ready(self, wid: int, incarnation: int, snapshot,
                          spawn_s: float = 0.0, **extra) -> dict:
        """``extra``: keys a worker on a card adds (``startup_s``,
        ``peak_memory_bytes``, ``kernel_launches``)."""
        row = self._worker_row(wid, incarnation, snapshot, "ready",
                               spawn_s=spawn_s, **extra)
        with self._lock:
            self.worker_rows.append(row)
        return row

    def note_worker_final(self, wid: int, incarnation: int, snapshot) -> dict:
        row = self._worker_row(wid, incarnation, snapshot, "final")
        with self._lock:
            self.worker_rows.append(row)
        return row

    def note_worker_death(self, wid: int, reason: str, snapshot=None) -> None:
        _c_deaths.inc(worker=str(wid))
        row = {"worker_id": wid, "reason": reason,
               "t_s": time.perf_counter() - self._t0}
        if snapshot is not None:
            row["completed_at_death"] = snapshot.completed
        with self._lock:
            self.deaths.append(row)

    def note_worker_restart(self, wid: int, transition: str, *,
                            attempt: int, backoff_s: float = 0.0,
                            reason: str = "") -> dict:
        """Supervisor transition row — the process tier's
        ``replica_restart`` (`FleetMetrics.note_restart` grammar)."""
        _c_restarts.inc(worker=str(wid), transition=transition)
        row = {
            "metric": "worker_restart",
            "schema_version": SCHEMA_VERSION,
            "worker_id": wid,
            "transition": transition,
            "attempt": attempt,
            "backoff_s": backoff_s,
            "reason": reason,
            "t_s": time.perf_counter() - self._t0,
        }
        with self._lock:
            self.restarts.append(row)
        return row

    def note_autoscale(self, decision: int, n_live: int, drain_mean_s: float,
                       worker: int | None = None, error: str = "") -> dict:
        _c_autoscale.inc(direction="grow" if decision > 0 else "shrink")
        row = {
            "metric": "pod_autoscale",
            "schema_version": SCHEMA_VERSION,
            "decision": decision,
            "n_live": n_live,
            "drain_mean_s": drain_mean_s,
            "worker_id": worker,
            "error": error,
            "t_s": time.perf_counter() - self._t0,
        }
        with self._lock:
            self.autoscale_rows.append(row)
        return row

    def publish_gauges(self, snapshots) -> None:
        """Refresh the pod gauges from the latest heartbeat snapshots
        (called from the router's heartbeat loop)."""
        _g_workers_alive.set(len(snapshots))
        for s in snapshots:
            _g_worker_drain.set(s.projected_drain_s, worker=str(s.worker_id))

    # -- aggregate ----------------------------------------------------------

    def pod_summary(self, workers) -> dict:
        """The aggregate row. ``workers`` is the router's `_Worker` list;
        per-worker detail prefers the final (bye) snapshot, falling back
        to the last heartbeat for workers that died mid-flight."""
        with self._lock:
            latencies = list(self.latencies_s)
            completed = self.completed
            deaths = list(self.deaths)
            restarts = list(self.restarts)
            t0 = self._t0
        window_s = time.perf_counter() - t0
        per_worker = []
        for w in sorted(workers, key=lambda w: (w.wid, w.incarnation)):
            s = w.final_snapshot if w.final_snapshot is not None else w.snapshot
            row = {
                "worker_id": w.wid,
                "incarnation": w.incarnation,
                "alive": w.alive,
            }
            if s is not None:
                row.update({
                    "pid": s.pid,
                    "completed": s.completed,
                    "compile_count": s.compile_count,
                    "post_warm_compiles": s.post_warm_compiles,
                    "warm_s": s.warm_s,
                })
            device = getattr(w, "device_stats", None)
            if device is not None:
                row["device"] = {k: device[k] for k in
                                 ("peak_memory_bytes", "kernel_launches")}
            per_worker.append(row)
        return {
            "metric": "pod_summary",
            "schema_version": SCHEMA_VERSION,
            "workers": len([w for w in workers if w.alive]),
            "workers_total": len(workers),
            "window_s": window_s,
            "completed": completed,
            "deaths": deaths,
            "restarts": sum(1 for r in restarts
                            if r["transition"] == "alive"),
            "permanent_dead": sorted(
                {r["worker_id"] for r in restarts
                 if r["transition"] == "permanent_dead"}),
            "autoscale_actions": len(self.autoscale_rows),
            "attributions_per_s": completed / window_s if window_s > 0 else 0.0,
            "latency_p50_ms": percentile_ms(latencies, 50),
            "latency_p99_ms": percentile_ms(latencies, 99),
            "per_worker": per_worker,
        }

    def emit(self, writer, config: dict | None = None, workers=(),
             hosts=()) -> dict:
        """Write the pod's ledger: worker lifecycle rows, restart trail,
        autoscale trail, one ``pod_host`` row per host group (the
        router's `host_summary`), then the ``pod_summary`` (config
        attached). Returns the summary row."""
        with self._lock:
            worker_rows = list(self.worker_rows)
            restarts = list(self.restarts)
            autoscale_rows = list(self.autoscale_rows)
        for row in worker_rows:
            writer.write(row)
        for row in restarts:
            writer.write(row)
        for row in autoscale_rows:
            writer.write(row)
        for host_row in hosts:
            writer.write({"metric": "pod_host",
                          "schema_version": SCHEMA_VERSION, **host_row})
        summary = self.pod_summary(list(workers))
        if config:
            summary["config"] = config
        writer.write(summary)
        return summary
