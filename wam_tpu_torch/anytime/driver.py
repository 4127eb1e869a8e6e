"""The stride loop: run an `AnytimeEntry` until it is complete, converged
or out of time (PyTorch port of `wam_tpu.anytime.driver`).

- at least one stride always runs, so a request pressed by its deadline
  still gets a real best-so-far map;
- stop when every sample is in (``complete``);
- stop early when the batch has converged: every row's checkpoint delta
  under the entry's ``plateau_tol`` and every row's confidence at or above
  ``min_confidence``;
- stop when the next stride cannot land before the deadline, projected
  from an average of the strides seen so far.

Each stride's progress is read by copying the small confidence vector to
the host: a control-plane wait, which is also the stride's completion
barrier. The result crosses to the host once, through
`evalsuite.fan.device_fetch` (`run_anytime`), so `fetch_scope` counts one
fetch a call.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

from wam_tpu_torch.anytime.state import SLOT_CONFIDENCE, SLOT_COUNT, SLOT_DELTA

__all__ = ["drive_anytime", "run_anytime", "AnytimeOutcome"]


@dataclass
class AnytimeOutcome:
    """`run_anytime`'s host-side result of one batch. ``stride_s`` and
    ``sync_s`` are each stride's host seconds and, of them, the seconds the
    host waited for the confidence vector (the device finishing the
    stride)."""

    out: Any  # finalized attribution (numpy)
    conf: Any  # (B, ANYTIME_VEC_SIZE) confidence vector (numpy)
    n_used: int
    n_total: int
    complete: bool
    converged: bool
    strides: int
    deadline_hit: bool
    stride_s: list = field(default_factory=list)
    sync_s: list = field(default_factory=list)


def drive_anytime(entry, xs, ys, *, deadline: float | None = None,
                  min_confidence: float = 0.0, n_rows: int | None = None):
    """Run the stride loop (module docstring); returns ``(out, conf, info)``,
    the finalized attribution and confidence vector still on the device
    (the caller owns the one result fetch) and ``info`` a dict of
    ``n_used / n_total / complete / converged / strides / deadline_hit /
    stride_s / sync_s``.

    ``deadline`` is an absolute `time.perf_counter` time (None: run to
    convergence or completion); ``min_confidence`` the floor every row must
    clear for the early exit; ``n_rows`` limits the policy to the first rows
    (a batch padded with copies of row 0)."""
    state = entry.begin(xs, ys)
    n_total, tol = entry.n_total, entry.plateau_tol
    strides, count = 0, 0
    ema: float | None = None
    converged = deadline_hit = False
    stride_s, sync_s = [], []
    while True:
        t0 = time.perf_counter()
        state = entry.step(state, xs, ys)
        t1 = time.perf_counter()
        cv = entry.confidence(state).cpu().numpy()  # waits for the stride to land
        t2 = time.perf_counter()
        stride_s.append(t2 - t0)
        sync_s.append(t2 - t1)
        ema = stride_s[-1] if ema is None else 0.5 * (ema + stride_s[-1])
        strides += 1
        rows = cv[:n_rows] if n_rows else cv
        count = int(rows[0, SLOT_COUNT])
        if count >= n_total:
            break
        converged = (tol > 0.0 and float(rows[:, SLOT_DELTA].max()) <= tol
                     and float(rows[:, SLOT_CONFIDENCE].min()) >= min_confidence)
        if converged:
            break
        if deadline is not None and time.perf_counter() + ema > deadline:
            deadline_hit = True
            break
    out, conf = entry.finalize(state)
    info = {"n_used": count, "n_total": n_total, "complete": count >= n_total,
            "converged": converged, "strides": strides, "deadline_hit": deadline_hit,
            "stride_s": stride_s, "sync_s": sync_s}
    return out, conf, info


def run_anytime(entry, xs, ys, *, deadline_ms: float | None = None,
                min_confidence: float = 0.0, n_rows: int | None = None) -> AnytimeOutcome:
    """`drive_anytime` plus THE one result fetch (`evalsuite.fan.device_fetch`,
    counted by `fetch_scope`); ``deadline_ms`` is relative to now."""
    from wam_tpu_torch.evalsuite.fan import device_fetch

    deadline = time.perf_counter() + deadline_ms / 1e3 if deadline_ms is not None else None
    out, conf, info = drive_anytime(entry, xs, ys, deadline=deadline,
                                    min_confidence=min_confidence, n_rows=n_rows)
    out, conf = device_fetch((out, conf))
    return AnytimeOutcome(out=out, conf=conf, **info)
