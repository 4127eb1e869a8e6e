"""The numbers a check compares, shared by the drivers. Each is the worst
over the leading (image) axis, and inf where the two sides differ in
shape, hold a NaN or an infinity, or where a side's image is constant
(a map that is all zeros has no ranks and no scale to compare)."""

from __future__ import annotations

import math


def _avg_ranks(v):
    """0-based ranks of a 1-D tensor, ties given their mean rank."""
    import torch

    s, idx = v.sort()
    _, inv, cnt = torch.unique_consecutive(s, return_inverse=True, return_counts=True)
    ends = cnt.cumsum(0)
    r_sorted = ((ends - cnt + ends - 1).double() / 2)[inv]
    r = torch.empty_like(r_sorted)
    r[idx] = r_sorted
    return r


def _rows(got, want):
    """The two sides as (images, values) float64 rows, or None where they
    cannot be compared image by image."""
    if tuple(got.shape) != tuple(want.shape) or got.shape[0] == 0:
        return None
    g = got.double().reshape(got.shape[0], -1)
    w = want.double().reshape(want.shape[0], -1)
    if not (g.isfinite().all() and w.isfinite().all()):
        return None
    return g, w


def rank_err(got, want) -> float:
    """1 - Spearman's rank correlation of two maps, the worst over the
    images. The ranks, which insertion and deletion read, move with the
    precision about linearly; an L2 distance of ResNet-50's input gradients
    grows about as its square root (ReLU gates that flip), which leaves it
    about 3.5x between TF32 and bfloat16 against the ranks' 10x. Blind to
    scale: see `rel_err`."""
    rows = _rows(got, want)
    if rows is None:
        return math.inf
    worst = 0.0
    for g, w in zip(*rows):
        a, b = _avg_ranks(g), _avg_ranks(w)
        a, b = a - a.mean(), b - b.mean()
        na, nb = float(a.norm()), float(b.norm())
        if na == 0.0 or nb == 0.0:
            return math.inf
        worst = max(worst, 1.0 - float((a * b).sum()) / (na * nb))
    return worst


def rel_err(got, want) -> float:
    """||got - want|| / ||want||, the worst over the images: with the ranks,
    it reads the scale that they cannot see (a mean taken over the wrong
    count, an image scaled or left at zero)."""
    rows = _rows(got, want)
    if rows is None:
        return math.inf
    g, w = rows
    nw = w.norm(dim=1)
    if bool((nw == 0).any()):
        return math.inf
    return float(((g - w).norm(dim=1) / nw).max())


def batch_rel_err(got, want) -> float:
    """||got - want|| / ||want|| over the whole batch: the scale as
    `rel_err` reads it, with the images' rounding pooled, so that it stays
    apart from a lower precision where the worst image does not."""
    rows = _rows(got, want)
    if rows is None:
        return math.inf
    g, w = rows
    nw = float(w.norm())
    return math.inf if nw == 0.0 else float((g - w).norm()) / nw
