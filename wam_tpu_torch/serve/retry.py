"""Client-side retry and hedging discipline (PyTorch port of
`wam_tpu.serve.retry`; pure Python). `FleetServer.submit_with_retry`
exposes the policy on the fleet surface.

The serve runtime's backpressure contract is reject-with-retry-after —
`QueueFullError.retry_after_s` is the server's own projected-drain
estimate. `RetryPolicy` is the client side of it:

- **deadline-budgeted retries**: a total ``budget_s`` per logical request;
  each attempt's backoff is clamped to what remains, and a request whose
  budget lapses resolves as a typed `RetryBudgetExceededError` (carrying
  the last server error) — never a hang.
- **retry_after honored, capped backoff + jitter**: the wait before
  attempt *k+1* is ``max(server retry_after, base·2^(k-1) capped)`` times
  a seeded jitter factor, so a thundering herd of rejected clients
  decorrelates instead of re-colliding.
- **tail-latency hedging** (``hedge_after_s``): when the first submit's
  future is still pending after the hedge delay, a second submit races it
  and the FIRST result wins; the loser's future resolves into a swallowed
  callback. Hedges trade duplicate work for p99; keep ``hedge_after_s``
  well above the p50 service time.

Drive it with ``policy.run(lambda rem: server.submit(x, y, deadline_ms=...))``.
"""

from __future__ import annotations

import random
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from concurrent.futures import wait as futures_wait
from dataclasses import dataclass

from wam_tpu_torch.obs.registry import registry as _registry
from wam_tpu_torch.serve.runtime import QueueFullError, ServeError

__all__ = ["RetryPolicy", "RetryStats", "RetryBudgetExceededError"]

_c_attempts = _registry.counter(
    "wam_tpu_retry_attempts_total", "submit attempts made under a RetryPolicy")
_c_retries = _registry.counter(
    "wam_tpu_retry_retries_total", "re-submits after a retryable error")
_c_hedges = _registry.counter(
    "wam_tpu_retry_hedges_total", "hedged second submits fired")
_c_hedge_wins = _registry.counter(
    "wam_tpu_retry_hedge_wins_total", "requests whose hedge resolved first")
_c_exhausted = _registry.counter(
    "wam_tpu_retry_exhausted_total",
    "requests that ran out of attempts or budget")


class RetryBudgetExceededError(ServeError):
    """The retry policy ran out of attempts or deadline budget. ``last``
    is the final server error (None when the budget lapsed with a submit
    still pending — ``pending=True``, the load generator's "lost unless
    typed" distinction: a pending future at budget expiry means the work
    never resolved, which the zero-loss chaos gate treats as a loss)."""

    def __init__(self, msg: str, last: Exception | None = None,
                 pending: bool = False):
        super().__init__(msg)
        self.last = last
        self.pending = pending


class RetryStats:
    """Thread-safe counters shared across a load generator's clients (one
    per bench point); mirrors the ``wam_tpu_retry_*`` registry series."""

    def __init__(self):
        self._lock = threading.Lock()
        self.attempts = 0
        self.retries = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.exhausted = 0
        self.backoff_s_total = 0.0

    def _note(self, field: str, n: float = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def as_dict(self) -> dict:
        with self._lock:
            return {
                "attempts": self.attempts,
                "retries": self.retries,
                "hedges": self.hedges,
                "hedge_wins": self.hedge_wins,
                "exhausted": self.exhausted,
                "backoff_s_total": self.backoff_s_total,
            }


@dataclass(frozen=True)
class RetryPolicy:
    """See module docstring. ``retry_on`` is the retryable error tuple —
    `QueueFullError` (and its `MemoryAdmissionError` subclass) by default;
    chaos benches add `NoLiveReplicaError` so requests rejected during a
    total-outage window retry into the supervisor's restart instead of
    failing. Every other `ServeError` propagates (typed, the client's
    decision), and non-ServeError exceptions propagate immediately."""

    max_attempts: int = 4
    budget_s: float | None = None
    backoff_base_s: float = 0.01
    backoff_cap_s: float = 1.0
    jitter_frac: float = 0.5
    hedge_after_s: float | None = None
    retry_on: tuple = (QueueFullError,)

    def backoff_s(self, attempt: int, rng: random.Random,
                  retry_after_s: float | None = None) -> float:
        """Wait before attempt ``attempt + 1``: exponential-capped, floored
        at the server's own estimate, jittered UP (never below the server's
        retry_after — resubmitting early just re-collides)."""
        b = min(self.backoff_cap_s, self.backoff_base_s * 2 ** max(0, attempt - 1))
        if retry_after_s is not None:
            b = max(b, retry_after_s)
        return b * (1.0 + self.jitter_frac * rng.random())

    def run(self, submit, *, rng: random.Random | None = None,
            stats: RetryStats | None = None):
        """Drive ``submit(remaining_s | None) -> Future`` to a result.
        Blocking; returns the winning future's result or raises a typed
        error. ``remaining_s`` is the unspent budget (None without one) so
        the callee can derive a per-attempt deadline."""
        rng = rng if rng is not None else random.Random()
        t_end = (time.monotonic() + self.budget_s
                 if self.budget_s is not None else None)

        def remaining() -> float | None:
            return None if t_end is None else t_end - time.monotonic()

        def _back_off(attempt: int, e: Exception) -> bool:
            """Sleep before the next attempt; False when out of attempts
            or budget (caller breaks)."""
            if attempt >= self.max_attempts:
                return False
            wait_s = self.backoff_s(
                attempt, rng, getattr(e, "retry_after_s", None))
            rem = remaining()
            if rem is not None:
                if rem <= 0.0:
                    return False
                wait_s = min(wait_s, rem)
            _c_retries.inc()
            if stats is not None:
                stats._note("retries")
                stats._note("backoff_s_total", wait_s)
            time.sleep(wait_s)
            return True

        last: Exception | None = None
        for attempt in range(1, self.max_attempts + 1):
            rem = remaining()
            if rem is not None and rem <= 0.0:
                break
            _c_attempts.inc()
            if stats is not None:
                stats._note("attempts")
            try:
                fut = submit(rem)
            except self.retry_on as e:
                last = e
                if not _back_off(attempt, e):
                    break
                continue
            try:
                return self._await(fut, submit, rem, stats)
            except FutureTimeoutError as e:
                last = e
                break  # budget lapsed with the future still pending
            except self.retry_on as e:
                # the future itself resolved to a retryable error (e.g. a
                # fleet re-route ending in QueueFullError): same loop
                last = e
                if not _back_off(attempt, e):
                    break
        _c_exhausted.inc()
        if stats is not None:
            stats._note("exhausted")
        pending = isinstance(last, FutureTimeoutError)
        raise RetryBudgetExceededError(
            f"retry policy exhausted after {self.max_attempts} attempt(s)"
            + (f"; last error: {last!r}" if last is not None else ""),
            last=None if pending else last, pending=pending)

    def _await(self, fut: Future, submit, rem: float | None,
               stats: RetryStats | None):
        """Wait out one attempt, optionally racing a hedge. Raises
        `concurrent.futures.TimeoutError` (caught by `run` as budget
        exhaustion with ``pending=True``) when the budget lapses with no
        future resolved."""
        if self.hedge_after_s is None:
            if rem is None:
                return fut.result()
            out = futures_wait([fut], timeout=rem)
            if not out.done:
                raise FutureTimeoutError()
            return fut.result()
        first_wait = (self.hedge_after_s if rem is None
                      else min(self.hedge_after_s, rem))
        done, _ = futures_wait([fut], timeout=first_wait)
        if done:
            return fut.result()
        if rem is not None:
            rem = rem - first_wait
            if rem <= 0.0:
                raise FutureTimeoutError()
        _c_hedges.inc()
        if stats is not None:
            stats._note("hedges")
        try:
            hedge = submit(rem)
        except ServeError:
            hedge = None  # hedge rejected: keep waiting on the original
        racers = [fut] if hedge is None else [fut, hedge]
        done, pending = futures_wait(
            racers, timeout=rem, return_when=FIRST_COMPLETED)
        if not done:
            raise FutureTimeoutError()
        # prefer a successful racer; otherwise surface the first error
        winner = next((f for f in done if f.exception() is None),
                      next(iter(done)))
        if hedge is not None and winner is hedge:
            _c_hedge_wins.inc()
            if stats is not None:
                stats._note("hedge_wins")
        for f in pending:
            # first-wins: nothing consumes the loser — swallow its eventual
            # exception so a late failure doesn't warn on GC
            f.add_done_callback(lambda f: f.exception())
        return winner.result()
