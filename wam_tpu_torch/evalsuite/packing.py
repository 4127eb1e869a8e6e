"""Invertible coefficient <-> array packing (PyTorch port of
`wam_tpu.evalsuite.packing`): index arithmetic on static shapes, so an
evaluation mask applies to every coefficient in one multiply.

The 2D layout is the attribution mosaic's: approximation top-left, H
top-right, V bottom-left, D bottom-right, level by level; where a level's
detail is larger than the packed block above it (long filters), both are
zero-padded to the larger size, as pywt's ``coeffs_to_array`` pads.
`array_to_coeffs2d` returns views of the packed array, so a synthesis that
reads its leaves in place (K3) reads the masked array itself.

The 1D layout is the concatenation [cA_J | cD_J | ... | cD_1].
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from wam_tpu_torch.wavelets.transform import Detail2D

__all__ = ["coeffs_to_array1d", "array_to_coeffs1d", "coeffs_to_array2d",
           "array_to_coeffs2d", "packed2d_shape", "coeff_shapes2d"]


# -- 1D -------------------------------------------------------------------------


def coeffs_to_array1d(coeffs: Sequence[torch.Tensor]) -> torch.Tensor:
    """[cA_J, cD_J, ..., cD_1] (each (..., n_i)) -> (..., sum n_i)."""
    return torch.cat(list(coeffs), dim=-1)


def array_to_coeffs1d(arr: torch.Tensor, lengths: Sequence[int]) -> list[torch.Tensor]:
    out, off = [], 0
    for n in lengths:
        out.append(arr[..., off:off + n])
        off += n
    return out


# -- 2D -------------------------------------------------------------------------


def _level_layout(shapes: Sequence[tuple[int, int]]):
    """Per-level block sizes: t_j = elementwise max(packed so far, detail);
    the packed array after level j is 2 t_j."""
    p = tuple(shapes[0])
    layout = []
    for d in shapes[1:]:
        t = (max(p[0], d[0]), max(p[1], d[1]))
        layout.append((t, tuple(d)))
        p = (2 * t[0], 2 * t[1])
    return layout, p


def coeff_shapes2d(coeffs) -> list[tuple[int, int]]:
    """[(hA, wA), (h_J, w_J), ..., (h_1, w_1)]: the approximation's shape,
    then each level's detail shape, coarsest first."""
    return [tuple(coeffs[0].shape[-2:])] + [tuple(d.diagonal.shape[-2:]) for d in coeffs[1:]]


def packed2d_shape(coeffs) -> tuple[int, int]:
    return _level_layout(coeff_shapes2d(coeffs))[1]


def _pad_to(a: torch.Tensor, h: int, w: int) -> torch.Tensor:
    ph, pw = h - a.shape[-2], w - a.shape[-1]
    return a if ph == 0 and pw == 0 else F.pad(a, (0, pw, 0, ph))


def coeffs_to_array2d(coeffs) -> torch.Tensor:
    """[cA, Detail2D_J, ..., Detail2D_1] -> one packed array, block by block:
    arr_j = [[arr_{j+1}, H], [V, D]], each zero-padded to the level's block
    size. Leading batch and channel axes pass through."""
    arr = coeffs[0]
    for det in coeffs[1:]:
        dh, dw = det.diagonal.shape[-2:]
        th, tw = max(arr.shape[-2], dh), max(arr.shape[-1], dw)
        top = torch.cat([_pad_to(arr, th, tw), _pad_to(det.horizontal, th, tw)], dim=-1)
        bottom = torch.cat([_pad_to(det.vertical, th, tw), _pad_to(det.diagonal, th, tw)], dim=-1)
        arr = torch.cat([top, bottom], dim=-2)
    return arr


def array_to_coeffs2d(arr: torch.Tensor, shapes: Sequence[tuple[int, int]]) -> list:
    """Inverse of `coeffs_to_array2d`, as views of ``arr``. ``shapes`` is
    `coeff_shapes2d` of a decomposition of the same size."""
    layout, _ = _level_layout(shapes)
    details = []
    for (th, tw), (dh, dw) in reversed(layout):
        details.append(Detail2D(horizontal=arr[..., :dh, tw:tw + dw],
                                vertical=arr[..., th:th + dh, :dw],
                                diagonal=arr[..., th:th + dh, tw:tw + dw]))
        arr = arr[..., :th, :tw]
    hA, wA = shapes[0]
    return [arr[..., :hA, :wA]] + details[::-1]
