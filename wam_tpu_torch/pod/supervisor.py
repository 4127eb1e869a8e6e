"""Pod supervision: respawn dead WORKER PROCESSES with jittered backoff
and crash-loop escalation — `serve.supervisor.ReplicaSupervisor` one
failure domain up.

The policy object is the serve layer's `SupervisorConfig`, reused
verbatim: the operator tunes ONE restart grammar (max_restarts within
window_s, exponential-jittered backoff) whether the thing dying is a
replica thread or a whole process. What differs is the restart
procedure, which the router injects as a callable (``respawn(wid)`` →
spawn the worker argv, wait for its post-warm hello): the supervisor
owns WHEN to restart, the router owns HOW — and tests swap the callable
for a stub to drive crash loops without real subprocesses.

Restart transitions land as ``worker_restart`` v2 ledger rows
(`pod.metrics.PodMetrics.note_worker_restart`): ``restarting`` →
``alive``, ``respawn_failed`` when the spawn itself died or never said
hello, ``permanent_dead`` on crash-loop escalation. A respawn failure
counts as a completed try in the crash-loop window, so a worker whose
process exits during warmup every time still escalates instead of
respawning forever.

`pending_eta_s()` exposes how far away the nearest in-flight respawn is
— `PodRouter` folds it (plus its spawn-time EMA) into
`NoLiveWorkerError.retry_after_s`, which is what lets `RetryPolicy`
ride out a total-outage window as backpressure.
"""

from __future__ import annotations

import random
import threading
import time

from wam_tpu_torch.obs import tracing as obs_tracing
from wam_tpu_torch.serve.supervisor import SupervisorConfig

__all__ = ["PodSupervisor"]


class PodSupervisor:
    """One per `PodRouter`. Thread-safe; every worker death spawns one
    daemon respawn thread (deaths are rare — thread-per-event keeps the
    router's routing path free of supervision machinery)."""

    # checked by the lock-discipline lint rule
    _GUARDED_BY = {
        "_history": "_lock",
        "_permanent": "_lock",
        "_pending_eta": "_lock",
        "_threads": "_lock",
    }

    def __init__(self, respawn, metrics, config: SupervisorConfig | None = None):
        self._respawn = respawn  # callable wid -> None, blocks until warm
        self._metrics = metrics
        self.config = config if config is not None else SupervisorConfig()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._rng = random.Random(self.config.seed)
        # per-worker completed-respawn timestamps (monotonic) inside the
        # crash-loop window, permanent-dead wids, and the monotonic ETA of
        # every respawn currently sleeping out its backoff or warming
        self._history: dict[int, list[float]] = {}
        self._permanent: set[int] = set()
        self._pending_eta: dict[int, float] = {}
        self._threads: list[threading.Thread] = []

    # -- death notification (router._mark_dead, post re-route) --------------

    def notify_death(self, wid: int, reason: str = "") -> None:
        """Schedule a respawn for a worker just marked dead. No-op once
        the worker is permanently dead or the supervisor is closing."""
        if self._stop.is_set():
            return
        with self._lock:
            if wid in self._permanent:
                return
            now = time.monotonic()
            recent = [t for t in self._history.get(wid, [])
                      if now - t <= self.config.window_s]
            self._history[wid] = recent
            if len(recent) >= self.config.max_restarts:
                self._permanent.add(wid)
                escalate = True
            else:
                escalate = False
                attempt = len(recent) + 1
            t = None
            if not escalate:
                t = threading.Thread(
                    target=self._run_respawn, args=(wid, attempt, reason),
                    name=f"wam-pod-supervisor-{wid}", daemon=True)
                self._threads.append(t)
        if escalate:
            self._metrics.note_worker_restart(
                wid, "permanent_dead",
                attempt=self.config.max_restarts, reason=reason
                or f"crash loop: {self.config.max_restarts} respawns "
                   f"in {self.config.window_s:g}s")
            return
        t.start()

    def _run_respawn(self, wid: int, attempt: int, reason: str) -> None:
        backoff = min(self.config.backoff_cap_s,
                      self.config.backoff_base_s * 2 ** (attempt - 1))
        with self._lock:
            backoff *= 1.0 + self.config.jitter_frac * self._rng.random()
            self._pending_eta[wid] = time.monotonic() + backoff
        self._metrics.note_worker_restart(
            wid, "restarting", attempt=attempt, backoff_s=backoff,
            reason=reason)
        try:
            if self._stop.wait(backoff):
                return  # pod closing: leave the worker down
            with obs_tracing.span("worker_respawn", cat="pod", worker=wid,
                                  attempt=attempt):
                try:
                    self._respawn(wid)
                except Exception as e:  # noqa: BLE001 - supervisor thread must not die
                    self._metrics.note_worker_restart(
                        wid, "respawn_failed", attempt=attempt,
                        backoff_s=backoff, reason=repr(e))
                    # a failed respawn is itself a death: escalate through
                    # the same crash-loop accounting (a completed try)
                    with self._lock:
                        self._history.setdefault(wid, []).append(
                            time.monotonic())
                    if not self._stop.is_set():
                        self.notify_death(wid, reason=f"respawn failed: {e!r}")
                    return
        finally:
            with self._lock:
                self._pending_eta.pop(wid, None)
        with self._lock:
            self._history.setdefault(wid, []).append(time.monotonic())
        self._metrics.note_worker_restart(
            wid, "alive", attempt=attempt, backoff_s=backoff, reason=reason)

    # -- retry-hint surface (NoLiveWorkerError.retry_after_s) ---------------

    def pending_eta_s(self, wids=None) -> float | None:
        """Seconds until the NEAREST in-flight respawn finishes its
        backoff (0.0 when one is already warming), or None when nothing
        is respawning right now. ``wids`` restricts to a subset of
        workers — the router computes PER-HOST respawn ETAs with it and
        min-reduces across hosts for the retry hints."""
        with self._lock:
            etas = (self._pending_eta.values() if wids is None
                    else [eta for wid, eta in self._pending_eta.items()
                          if wid in set(wids)])
            if not etas:
                return None
            now = time.monotonic()
            return max(0.0, min(eta - now for eta in etas))

    def any_restartable(self) -> bool:
        """Whether at least one known worker could still come back (i.e.
        not every worker that ever died has escalated to permanent)."""
        with self._lock:
            if self._pending_eta:
                return True
            known = set(self._history)
            return not known or bool(known - self._permanent)

    # -- introspection / lifecycle ------------------------------------------

    def permanently_dead(self, wid: int | None = None):
        with self._lock:
            if wid is None:
                return sorted(self._permanent)
            return wid in self._permanent

    def describe(self) -> dict:
        with self._lock:
            return {
                "max_restarts": self.config.max_restarts,
                "window_s": self.config.window_s,
                "respawns": {str(w): len(ts)
                             for w, ts in self._history.items() if ts},
                "pending": sorted(self._pending_eta),
                "permanent_dead": sorted(self._permanent),
            }

    def close(self, timeout_s: float = 15.0) -> None:
        """Stop scheduling respawns and join in-flight respawn threads
        (each bounded by backoff_cap + one worker bring-up)."""
        self._stop.set()
        with self._lock:
            threads = list(self._threads)
        deadline = time.monotonic() + timeout_s
        for t in threads:
            if t.ident is None:
                # registered by notify_death but not started yet: it starts
                # into the stop flag and returns
                continue
            t.join(max(0.0, deadline - time.monotonic()))
