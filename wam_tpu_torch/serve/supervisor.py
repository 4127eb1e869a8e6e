"""Replica supervision: restart-on-death with backoff, crash-loop
escalation, and the ``replica_restart`` ledger trail (PyTorch port of
`wam_tpu.serve.supervisor`).

Without a supervisor a replica that threw a non-`ServeError` is dead
fleet-wide for good: right for draining its in-flight work (the re-route
path), wrong for a fleet where most deaths are transient (a device
error that passes, an injected fault). `ReplicaSupervisor` owns the
lifecycle past the death notification:

1. `serve.fleet.FleetServer._harvest` marks the replica dead and notifies
   the supervisor (the drain/re-route semantics are untouched: in-flight
   and queued requests fail over to survivors at once, they never wait on
   a restart).
2. A restart thread backs off (exponential in the replica's recent restart
   count, jittered from the supervisor's seeded RNG, capped), closes the
   dead server (draining anything that raced in), rebuilds it through the
   fleet's own recipe (`FleetServer._rebuild_replica`): the SAME
   entry_factory and per-replica `ServeMetrics`, so first-call counts
   accumulate across incarnations. The factory builds a NEW entry, so the
   rebuilt replica makes its first calls again (the port's stand-in for
   the reference's traces: cuDNN plans, band plans) — during its warmup,
   on its own worker thread, and none in the served window.
3. Every transition lands as a ``replica_restart`` v2 ledger row
   (`FleetMetrics.note_restart`): ``restarting`` → ``alive`` on success,
   ``restart_failed`` when the rebuild itself raised, and
   ``permanent_dead`` when the replica crash-loops — more than
   ``max_restarts`` completed restarts inside ``window_s`` — at which
   point the supervisor stops trying and the fleet serves on the
   survivors.

Supervision is opt-in at the `FleetServer` surface (``supervise=``);
`ServeConfig.supervise` defaults it on for fleets built by
`FleetServer.from_config`, with ``restart_max``, ``restart_window_s`` and
``restart_backoff_ms`` as its `SupervisorConfig`.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass

from wam_tpu_torch.obs import tracing as obs_tracing

__all__ = ["ReplicaSupervisor", "SupervisorConfig"]


@dataclass(frozen=True)
class SupervisorConfig:
    """Restart policy. ``max_restarts`` completed restarts within
    ``window_s`` escalate the NEXT death to permanent-dead (crash-loop
    detection); backoff before restart ``k`` (k = recent restarts) is
    ``min(cap, base·2^k)`` times a jitter in [1, 1+jitter_frac] from a
    seeded RNG (deterministic schedules in tests)."""

    max_restarts: int = 3
    window_s: float = 60.0
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    jitter_frac: float = 0.2
    seed: int | None = None


class ReplicaSupervisor:
    """One per supervised `FleetServer`. Thread-safe; every death spawns
    one daemon restart thread (deaths are rare — thread-per-event keeps
    the fleet's hot path free of supervisor machinery)."""

    # checked by the lock-discipline lint rule
    _GUARDED_BY = {
        "_history": "_lock",
        "_permanent": "_lock",
        "_threads": "_lock",
    }

    def __init__(self, fleet, config: SupervisorConfig | None = None):
        self._fleet = fleet
        self.config = config if config is not None else SupervisorConfig()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._rng = random.Random(self.config.seed)
        # per-replica completed-restart timestamps (monotonic) — the
        # crash-loop window — and permanent-dead flags
        self._history: dict = {}
        self._permanent: set = set()
        self._threads: list[threading.Thread] = []

    # -- death notification (called from _harvest, post mark-dead) ----------

    def notify_death(self, rid, reason: str = "") -> None:
        """Schedule a restart for a replica just marked dead. No-op once
        the replica is permanently dead or the supervisor is closing."""
        if self._stop.is_set():
            return
        with self._lock:
            if rid in self._permanent:
                return
            now = time.monotonic()
            recent = [t for t in self._history.get(rid, [])
                      if now - t <= self.config.window_s]
            self._history[rid] = recent
            if len(recent) >= self.config.max_restarts:
                self._permanent.add(rid)
                escalate = True
            else:
                escalate = False
                attempt = len(recent) + 1
            t = None
            if not escalate:
                t = threading.Thread(
                    target=self._restart, args=(rid, attempt, reason),
                    name=f"wam-supervisor-{rid}", daemon=True)
                self._threads.append(t)
        if escalate:
            self._fleet.metrics.note_restart(
                rid, "permanent_dead",
                attempt=self.config.max_restarts, reason=reason
                or f"crash loop: {self.config.max_restarts} restarts "
                   f"in {self.config.window_s:g}s")
            return
        t.start()

    def _restart(self, rid, attempt: int, reason: str) -> None:
        backoff = min(self.config.backoff_cap_s,
                      self.config.backoff_base_s * 2 ** (attempt - 1))
        with self._lock:
            backoff *= 1.0 + self.config.jitter_frac * self._rng.random()
        self._fleet.metrics.note_restart(
            rid, "restarting", attempt=attempt, backoff_s=backoff,
            reason=reason)
        if self._stop.wait(backoff):
            return  # fleet closing: leave the replica down
        with obs_tracing.span("replica_restart", cat="fleet", replica=rid,
                              attempt=attempt):
            try:
                self._fleet._rebuild_replica(rid)
            except Exception as e:  # noqa: BLE001 - a supervisor thread must not die
                self._fleet.metrics.note_restart(
                    rid, "restart_failed", attempt=attempt,
                    backoff_s=backoff, reason=repr(e))
                # a failed rebuild is itself a death: escalate through the
                # same crash-loop accounting (counts as a completed try)
                with self._lock:
                    self._history.setdefault(rid, []).append(time.monotonic())
                if not self._stop.is_set():
                    self.notify_death(rid, reason=f"rebuild failed: {e!r}")
                return
        with self._lock:
            self._history.setdefault(rid, []).append(time.monotonic())
        self._fleet.metrics.note_restart(
            rid, "alive", attempt=attempt, backoff_s=backoff, reason=reason)

    # -- introspection / lifecycle ------------------------------------------

    def permanently_dead(self, rid=None):
        with self._lock:
            if rid is None:
                return sorted(self._permanent, key=str)
            return rid in self._permanent

    def describe(self) -> dict:
        with self._lock:
            return {
                "max_restarts": self.config.max_restarts,
                "window_s": self.config.window_s,
                "restarts": {str(r): len(ts) for r, ts in self._history.items()
                             if ts},
                "permanent_dead": sorted(self._permanent, key=str),
            }

    def close(self, timeout_s: float = 10.0) -> None:
        """Stop scheduling restarts and join any in-flight restart thread
        (each bounded by backoff_cap + one warmup)."""
        self._stop.set()
        with self._lock:
            threads = list(self._threads)
        deadline = time.monotonic() + timeout_s
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
