"""Anytime attribution (PyTorch port of `wam_tpu.anytime`): SmoothGrad as a
running mean with a checkpoint every ``stride`` samples and a confidence
vector beside it, so a caller can stop at a deadline or on convergence and
still get a best-so-far map.

- `anytime.state`: the Welford M2 from consecutive sum accumulators and the
  per-row confidence vector;
- `anytime.entry.make_anytime_entry`: begin / step / finalize entries;
- `anytime.driver`: the stride loop (complete, converged, deadline) and
  `run_anytime`, one result fetch a call;
- `anytime.result.AnytimeResult`: a best-so-far map and its confidence.

`WaveletAttribution2D.anytime_serve_entry` builds the single-device entry.
The anytime server, its kill switch and its SLO objectives wait for
ROADMAP.md slice F; the tuned stride for slice E.
"""

from wam_tpu_torch.anytime.driver import AnytimeOutcome, drive_anytime, run_anytime
from wam_tpu_torch.anytime.entry import DEFAULT_PLATEAU_TOL, AnytimeEntry, make_anytime_entry
from wam_tpu_torch.anytime.result import AnytimeResult
from wam_tpu_torch.anytime.state import (
    ANYTIME_VEC_SIZE,
    SLOT_CONFIDENCE,
    SLOT_COUNT,
    SLOT_DELTA,
    SLOT_REL_SEM,
    conf_stats,
    m2_update,
)

__all__ = [
    "ANYTIME_VEC_SIZE",
    "SLOT_COUNT",
    "SLOT_REL_SEM",
    "SLOT_DELTA",
    "SLOT_CONFIDENCE",
    "DEFAULT_PLATEAU_TOL",
    "AnytimeEntry",
    "AnytimeOutcome",
    "AnytimeResult",
    "conf_stats",
    "drive_anytime",
    "m2_update",
    "make_anytime_entry",
    "run_anytime",
]
