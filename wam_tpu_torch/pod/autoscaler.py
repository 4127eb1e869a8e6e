"""Pod autoscaler: grow/shrink the worker set from aggregate health
signals.

The policy is a pure function — ``decide(cfg, snapshots, n_live)`` maps
the last heartbeat's `WorkerSnapshot`s to -1/0/+1 — so tests drive every
branch with synthetic drain/burn signals and zero processes. The loop
(`AutoscalerLoop`) is the only part that touches the router: it samples
live snapshots each interval, applies the decision through
`PodRouter.grow` / `PodRouter.shrink`, and sits out a cooldown after
every action so one burst cannot thrash the worker set (a grow takes a
worker bring-up — seconds — to change the signals it acted on).

Grow triggers on EITHER pressure signal:

- mean ``projected_drain_s`` above ``grow_drain_s`` — the pod's queues
  are deeper than the drain target, more hands needed. The grow-side
  drain is discounted by each worker's reported result-cache hit rate:
  a hot cache serves that slice for free, so its queue
  depth is phantom load a new worker would not absorb;
- any worker with ``slo_penalty_s > 0`` — its burn rate crossed 1.0
  (the SLO error budget is being spent faster than earned; see
  `obs.slo.SLOTracker`), and the cheapest way to buy burn headroom is
  another failure domain.

Shrink only when BOTH are calm (mean drain under ``shrink_drain_s``,
zero burn penalty) and only down to ``min_workers``; the router retires
the least-loaded worker gracefully (drain, not kill), so a shrink never
loses requests either.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

__all__ = ["AutoscaleConfig", "AutoscalerLoop", "decide"]


@dataclass(frozen=True)
class AutoscaleConfig:
    """Elasticity policy (the `serve.supervisor.SupervisorConfig` idiom:
    a small frozen dataclass the operator tunes, defaults that behave)."""

    min_workers: int = 1
    max_workers: int = 4
    interval_s: float = 1.0
    grow_drain_s: float = 0.5  # mean projected_drain_s that adds a worker
    shrink_drain_s: float = 0.05  # mean drain calm enough to retire one
    cooldown_s: float = 5.0  # sit-out after any action


def _grow_drain(s) -> float:
    """One worker's drain as the GROW trigger sees it: discounted by the
    result-cache hit rate when the heartbeat reports one. A hot cache
    answers that fraction of admitted traffic without compute, so its
    projected drain (EMA × queued items, cache hits included) overstates
    the work a new worker would actually absorb — growing on it buys
    warm-up cost for phantom load. Workers that do not report one send -1
    (unknown) and keep their raw drain."""
    hit = getattr(s, "cache_hit_rate", -1.0)
    if hit < 0.0:
        return s.projected_drain_s
    return s.projected_drain_s * (1.0 - min(1.0, hit))


def decide(cfg: AutoscaleConfig, snapshots, n_live: int) -> int:
    """-1 (shrink), 0 (hold), or +1 (grow) from the live workers' last
    snapshots. Pure: no clocks, no side effects."""
    if n_live < cfg.min_workers:
        return 1
    if not snapshots:
        return 0
    # grow reads the hit-rate-discounted drain; shrink keeps the RAW
    # drain, so a hot-cache fleet neither grows on phantom queue depth
    # nor shrinks away capacity that real (uncached) traffic still needs
    grow_drain = sum(_grow_drain(s) for s in snapshots) / len(snapshots)
    drain = sum(s.projected_drain_s for s in snapshots) / len(snapshots)
    burning = any(s.slo_penalty_s > 0.0 for s in snapshots)
    if (grow_drain > cfg.grow_drain_s or burning) and n_live < cfg.max_workers:
        return 1
    if (drain < cfg.shrink_drain_s and not burning
            and n_live > cfg.min_workers):
        return -1
    return 0


class AutoscalerLoop:
    """Daemon thread applying `decide` to a `PodRouter` every interval."""

    def __init__(self, router, config: AutoscaleConfig):
        self._router = router
        self.config = config
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="wam-pod-autoscaler")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            snapshots = self._router._live_snapshots()
            n_live = len(self._router.live_worker_ids())
            d = decide(self.config, snapshots, n_live)
            if d == 0:
                continue
            drain = (sum(s.projected_drain_s for s in snapshots)
                     / len(snapshots) if snapshots else 0.0)
            try:
                wid = self._router.grow() if d > 0 else self._router.shrink()
            except Exception as e:  # noqa: BLE001 - loop must survive a failed grow
                self._router.metrics.note_autoscale(
                    d, n_live, drain, error=repr(e))
                continue
            if wid is not None:
                self._router.metrics.note_autoscale(d, n_live, drain,
                                                    worker=wid)
            # cooldown: let the action move the signals before re-deciding
            if self._stop.wait(self.config.cooldown_s):
                return

    def close(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout_s)
            self._thread = None
