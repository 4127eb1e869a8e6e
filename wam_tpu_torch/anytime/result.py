"""Result type of anytime attribution (PyTorch port of
`wam_tpu.anytime.result`)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

__all__ = ["AnytimeResult"]


@dataclass(frozen=True)
class AnytimeResult:
    """One request's best-so-far attribution and its certainty: a deadline
    delivers the running mean at whatever count it reached (``complete``
    false) instead of an error, and a converged input stops early
    (``converged``) with fewer than ``n_total`` samples. ``confidence`` is
    the `anytime.state` scalar in (0, 1]; ``rel_sem`` and ``delta`` are the
    two signals it folds. The server that returns it is ROADMAP.md slice F's."""

    attribution: Any
    confidence: float
    n_used: int
    n_total: int
    complete: bool
    converged: bool
    rel_sem: float = 0.0
    delta: float = 0.0

    def meets(self, min_confidence: float) -> bool:
        """Whether the result clears a confidence floor."""
        return self.confidence >= float(min_confidence)
