"""Anytime-attribution checkpoint math (PyTorch port of
`wam_tpu.anytime.state`): a variance-derived confidence from a running SUM
accumulator, without touching the accumulator itself.

- **M2 from consecutive sums** (`m2_update`): a Welford second moment per
  batch row, reconstructed from ``(acc_prev, acc_new)``; the sample is
  recovered as g = acc_new - acc_prev (exact up to one rounding, which a
  variance estimate does not feel), so the sum chain stays the plain
  ``acc + g`` of the estimator.
- **Confidence vector** (`conf_stats`): per batch row one (B,
  ANYTIME_VEC_SIZE) float32 array:

  ===== ============ ==================================================
  slot  name         meaning
  ===== ============ ==================================================
  0     count        samples accumulated so far
  1     rel_sem      RMS standard error of the mean / RMS of the mean
  2     delta        relative L2 change since the previous checkpoint
                     (1.0 before a previous checkpoint exists)
  3     confidence   1 / (1 + rel_sem + delta), in (0, 1]
  ===== ============ ==================================================

A gradient tree is a tensor or a list, tuple (`Detail2D` included) or dict
of them, nested, every leaf with a leading batch axis; dict values are
taken in sorted key order, as JAX flattens them. Counts are Python numbers
or tensors.
"""

from __future__ import annotations

import torch

__all__ = [
    "ANYTIME_VEC_SIZE",
    "SLOT_COUNT",
    "SLOT_REL_SEM",
    "SLOT_DELTA",
    "SLOT_CONFIDENCE",
    "m2_update",
    "conf_stats",
]

ANYTIME_VEC_SIZE = 4
SLOT_COUNT, SLOT_REL_SEM, SLOT_DELTA, SLOT_CONFIDENCE = range(ANYTIME_VEC_SIZE)

_EPS = 1e-12


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a gradient tree, depth first."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    return [t for part in tree for t in tree_leaves(part)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of ``rest``),
    keeping the structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    parts = [tree_map(fn, *group) for group in zip(tree, *rest)]
    return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(parts)


def _row_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over every non-leading axis -> (B,) float32."""
    return a.float().reshape(a.shape[0], -1).sum(dim=1)


def _tree_row_sum(fn, *trees) -> torch.Tensor:
    """Sum over the leaves of the per-row reductions ``fn(*leaves) -> (B,)``."""
    total = None
    for group in zip(*(tree_leaves(t) for t in trees)):
        part = fn(*group)
        total = part if total is None else total + part
    return total


def tree_row_elems(tree) -> int:
    """Elements per batch row over the whole tree."""
    n = 0
    for leaf in tree_leaves(tree):
        size = 1
        for d in leaf.shape[1:]:
            size *= int(d)
        n += size
    return n


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def m2_update(m2: torch.Tensor, acc_prev, acc_new, count_prev) -> torch.Tensor:
    """One Welford M2 step per batch row from consecutive sum accumulators:
    with g = acc_new - acc_prev, mean_prev = acc_prev / count_prev and
    mean_new = acc_new / (count_prev + 1), the increment is the sum over
    elements of (g - mean_prev)(g - mean_new). The first sample
    (``count_prev == 0``) adds exactly 0; ``m2`` is (B,) float32."""
    count_prev = _f32(count_prev, m2)
    safe_prev = torch.clamp(count_prev, min=1.0)

    def inc(p, n):
        p32, n32 = p.float(), n.float()
        g = n32 - p32
        return _row_sum((g - p32 / safe_prev) * (g - n32 / (count_prev + 1.0)))

    delta = _tree_row_sum(inc, acc_prev, acc_new)
    return m2 + torch.where(count_prev >= 1.0, delta, torch.zeros_like(delta))


def conf_stats(acc, m2: torch.Tensor, count, prev_acc, prev_count) -> torch.Tensor:
    """The (B, ANYTIME_VEC_SIZE) confidence vector of the running state (the
    slot table above). ``acc`` / ``prev_acc`` are the current and the
    previous checkpoint's SUM trees; ``prev_count == 0`` means no previous
    checkpoint (delta pinned at 1.0, never converged)."""
    count = _f32(count, m2)
    prev_count = _f32(prev_count, m2)
    n_elems = float(max(tree_row_elems(acc), 1))
    safe_n = torch.clamp(count, min=1.0)
    safe_pn = torch.clamp(prev_count, min=1.0)
    one = torch.ones((), dtype=torch.float32, device=m2.device)

    # RMS of the running mean, per row: the normalizer of both signals
    rms = torch.sqrt(_tree_row_sum(lambda a: _row_sum((a.float() / safe_n) ** 2), acc) / n_elems)

    # RMS standard error of the mean: sqrt(mean elementwise variance / n)
    var = m2 / torch.clamp(count - 1.0, min=1.0) / n_elems
    sem = torch.sqrt(torch.clamp(var, min=0.0) / safe_n)
    rel_sem = torch.where(count >= 2.0, sem / (rms + _EPS), one)

    # relative L2 motion since the previous checkpoint
    sq_move = _tree_row_sum(
        lambda a, p: _row_sum((a.float() / safe_n - p.float() / safe_pn) ** 2), acc, prev_acc)
    delta = torch.where(prev_count >= 1.0, torch.sqrt(sq_move / n_elems) / (rms + _EPS), one)

    confidence = 1.0 / (1.0 + rel_sem + delta)
    b = m2.shape[0]
    return torch.stack([count.expand(b) if count.ndim == 0 else count, rel_sem.expand(b),
                        delta.expand(b), confidence.expand(b)], dim=1)
