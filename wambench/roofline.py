"""The chip's peaks and the least time the 2D transforms' kernels could
take, from the shapes alone.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the full 700 W limit.
A kernel's bound is the larger of the bytes its function must move (each
input read once, each output written once, float32) at the HBM rate and
the float32 work it needs at the rate outside the tensor cores, the
arithmetic of `chip_smoke._bound_ms`. The work is that of the separable
filter bank, counted from the transform's shapes whatever implements it:
each output sample of a one-axis analysis band costs L multiply-adds, each
output sample of a one-axis synthesis L (L / 2 from each of two bands).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12  # dense, the tensor cores' rate for both configurations
F32 = 4


def analysis_len(n: int, L: int) -> int:
    return (n + L - 1) // 2


def synthesis_len(m: int, L: int) -> int:
    return 2 * m - L + 2


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def analysis_levels(planes: int, H: int, W: int, L: int, levels: int) -> list[tuple[int, int]]:
    """(bytes, flops) of each analysis level of ``planes`` images of H x W:
    the approximation read, four bands written."""
    out = []
    for _ in range(levels):
        h, w = analysis_len(H, L), analysis_len(W, L)
        nbytes = planes * (H * W + 4 * h * w) * F32
        macs = planes * (H * 2 * w * L + 4 * h * w * L)  # columns, then rows
        out.append((nbytes, 2 * macs))
        H, W = h, w
    return out


def detail_sides(H: int, W: int, L: int, levels: int) -> list[tuple[int, int]]:
    """The detail bands' sides, coarsest level first."""
    sides = []
    for _ in range(levels):
        H, W = analysis_len(H, L), analysis_len(W, L)
        sides.append((H, W))
    return sides[::-1]


def collapsed(planes: int, H: int, W: int, L: int, levels: int,
              collapse_below: int) -> tuple[int, int, int]:
    """(levels collapsed, bytes, flops) of the collapsed synthesis (K3) of
    the coarsest run of levels whose detail sides all fall below
    ``collapse_below``: the leaves read and the output written. Its adjoint
    reads the output's gradient and writes the leaves' (the same bytes and
    work)."""
    sides = detail_sides(H, W, L, levels)
    k = 0
    for h, w in sides:
        if max(h, w) >= collapse_below:
            break
        k += 1
    if k < 2:
        return 0, 0, 0
    leaves = sides[0][0] * sides[0][1] + sum(3 * h * w for h, w in sides[:k])
    macs = 0
    for h, w in sides[:k]:  # one level: rows of the two column pairs, then columns
        oh, ow = synthesis_len(h, L), synthesis_len(w, L)
        macs += 2 * oh * w * L + oh * ow * L
    oh, ow = synthesis_len(sides[k - 1][0], L), synthesis_len(sides[k - 1][1], L)
    return k, planes * (leaves + oh * ow) * F32, 2 * planes * macs


def k1_bound_s(planes: int, H: int, W: int, L: int, levels: int) -> float:
    """Least time of the K1 launches of one decomposition (every level)."""
    return sum(bound_s(b, f) for b, f in analysis_levels(planes, H, W, L, levels))


def k3_bound_s(planes: int, H: int, W: int, L: int, levels: int, collapse_below: int,
               with_backward: bool) -> float:
    """Least time of the K3 launches of one synthesis (forward, and its
    adjoint when the gradient is taken)."""
    k, nbytes, flops = collapsed(planes, H, W, L, levels, collapse_below)
    if k == 0:
        return 0.0
    return bound_s(nbytes, flops) * (2 if with_backward else 1)
