"""3D dyadic-cube packing and per-level visualization maps (PyTorch).

Counterpart of `wam_tpu.ops.packing3d`. Slab layout per level with span
[s, e) (s = S/2^{j+1}): ddd in the main diagonal block [s:e]^3 and the six
mixed orientations in the face-adjacent slabs, keys ordered by axes
(-3, -2, -1):

    aad -> [:s, :s, s:e]   ada -> [:s, s:e, :s]   add -> [:s, s:e, s:e]
    daa -> [s:e, :s, :s]   dad -> [s:e, :s, s:e]  dda -> [s:e, s:e, :s]

approximation |cA| in the corner [:sJ]^3. Values are absolute and
unnormalized, so a stack of samples folded into the batch packs row by row.

`visualize_cube` reprojects each level to full resolution (trilinear, half
voxel centers: ``jax.image.resize(method="trilinear")``'s values when
upsampling, borders included) and sums all seven orientations.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from wam_tpu_torch.wavelets.transform import DETAIL3D_KEYS

__all__ = ["cube3d", "cube_size", "visualize_cube"]

_SLABS = {
    "ddd": lambda s, e: (slice(s, e), slice(s, e), slice(s, e)),
    "aad": lambda s, e: (slice(0, s), slice(0, s), slice(s, e)),
    "ada": lambda s, e: (slice(0, s), slice(s, e), slice(0, s)),
    "add": lambda s, e: (slice(0, s), slice(s, e), slice(s, e)),
    "daa": lambda s, e: (slice(s, e), slice(0, s), slice(0, s)),
    "dad": lambda s, e: (slice(s, e), slice(0, s), slice(s, e)),
    "dda": lambda s, e: (slice(s, e), slice(s, e), slice(0, s)),
}


def cube_size(coeffs) -> int:
    return int(2 * coeffs[-1]["ddd"].shape[-1])


def _crop(a: torch.Tensor, sl: tuple[slice, slice, slice]) -> torch.Tensor:
    """The leading corner of ``a`` the size of slab ``sl``: longer filters
    give coefficients wider than their slab (db4 on 32^3: a finest side of
    17 in a cube of 34, a second level of 12 in a slab of 9)."""
    return a[..., : sl[0].stop - sl[0].start, : sl[1].stop - sl[1].start,
             : sl[2].stop - sl[2].start]


def cube3d(coeffs, size: int | None = None) -> torch.Tensor:
    """Pack [cA_J, {aad..ddd}_J, ..., {aad..ddd}_1] (leaves (B, d, h, w))
    into the dyadic cube (B, S, S, S) of absolute values."""
    size = cube_size(coeffs) if size is None else size
    out = coeffs[0].new_zeros((coeffs[0].shape[0], size, size, size))
    approx = coeffs[0].abs()
    ea = min(approx.shape[-1], size // (2 ** (len(coeffs) - 1)))
    out[:, :ea, :ea, :ea] = approx[:, :ea, :ea, :ea]
    # coeffs[1:] is coarsest -> finest; enumerate finest-first
    for i, det in enumerate(coeffs[1:][::-1]):
        e = size // (2**i)
        s = size // (2 ** (i + 1))
        for key in DETAIL3D_KEYS:
            sl = _SLABS[key](s, e)
            out[(slice(None),) + sl] = _crop(det[key].abs(), sl)
    return out


def _norm(a: torch.Tensor) -> torch.Tensor:
    m = a.max()
    return a / torch.where(m == 0, torch.ones_like(m), m)


def _resize(a: torch.Tensor, size: int) -> torch.Tensor:
    """Trilinear resize of (B, d, h, w) to (B, size, size, size)."""
    out = F.interpolate(a[:, None], size=(size, size, size), mode="trilinear",
                        align_corners=False)
    return out[:, 0]


def visualize_cube(cube: torch.Tensor, levels: int) -> torch.Tensor:
    """Per-level full-resolution maps (B, J+2, S, S, S): channel 0 the
    approximation, 1..J the detail levels coarsest first, the last the
    normalized sum of all. Each map is normalized by its max over the whole
    batch, as the reference does."""
    size = cube.shape[-1]
    sa = size // (2**levels)
    maps = [_norm(_resize(cube[:, :sa, :sa, :sa], size))]
    for j in range(levels, 0, -1):  # coarsest first, like the reference
        e = size // (2 ** (j - 1))
        s = size // (2**j)
        total = sum(_resize(cube[(slice(None),) + _SLABS[key](s, e)], size)
                    for key in DETAIL3D_KEYS)
        maps.append(_norm(total))
    stacked = torch.stack(maps, dim=1)
    return torch.cat([stacked, _norm(stacked.sum(dim=1))[:, None]], dim=1)
