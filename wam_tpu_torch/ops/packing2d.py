"""2D dyadic-mosaic packing and per-scale reprojection (PyTorch).

Counterpart of `wam_tpu.ops.packing2d` for NCHW coefficient leaves
(..., B, C, h, w), or NHWC leaves (..., B, h, w, C) with ``channel_axis=-1``
(the channel-last engine, `wavelets.nhwc`). Any leading axes before the
batch axis are stacked samples: each one is normalized on its own, exactly
as the JAX package normalizes the one sample its mapped step sees.

Mosaic layout: approximation in the top-left corner; for each level with
block span [s, e) (s = S/2^{i+1}, e = S/2^i, i = 0 for the finest level):
diagonal at [s:e, s:e], vertical at [s:e, :s], horizontal at [:s, s:e].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["mosaic2d", "reproject_mosaic", "disentangle_scales", "mosaic_size",
           "mosaic_regions", "leaf_maxima", "normalize_mosaic"]


def _norm(a: torch.Tensor, enabled: bool) -> torch.Tensor:
    """Divide by the max over the last three axes (one sample's B, h, w)."""
    if not enabled:
        return a
    m = a.amax(dim=(-3, -2, -1), keepdim=True)
    return a / torch.where(m == 0, torch.ones_like(m), m)


def _channel_dim(channel_axis: int) -> int:
    """The reference's ``channel_axis`` (1: NCHW, -1: NHWC) as a dim
    counted from the end, so leading sample axes pass through."""
    if channel_axis not in (1, -1):
        raise ValueError(f"channel_axis must be 1 (NCHW) or -1 (NHWC), got {channel_axis}")
    return -3 if channel_axis == 1 else -1


def _prep(block: torch.Tensor, normalize: bool, channel_axis: int = 1) -> torch.Tensor:
    """channel-mean -> abs -> optional max normalization (the reference
    order; abs of the mean is not the mean of abs)."""
    return _norm(block.mean(dim=_channel_dim(channel_axis)).abs(), normalize)


def mosaic_size(coeffs, channel_axis: int = 1) -> int:
    """Mosaic side = 2 x finest-level detail size."""
    axis = -1 if _channel_dim(channel_axis) == -3 else -2
    return int(2 * coeffs[-1].horizontal.shape[axis])


def mosaic_regions(coeffs, channel_axis: int = 1) -> list[tuple[int, int, int, int]]:
    """Where each leaf lands in the mosaic, in `mosaic2d`'s write order
    (approximation, then each level's diagonal, vertical and horizontal,
    finest level first): ``(row0, col0, rows, cols)``, the leaf's top-left
    ``rows x cols`` corner written at ``[row0:row0+rows, col0:col0+cols]``.
    A later region overwrites an earlier one where they overlap (long
    filters)."""
    size = mosaic_size(coeffs, channel_axis)
    hdim = -2 if _channel_dim(channel_axis) == -3 else -3
    approx = coeffs[0]
    regions = [(0, 0, min(approx.shape[hdim], size), min(approx.shape[hdim + 1], size))]
    for i in range(len(coeffs) - 1):
        end = size // (2**i)
        start = size // (2 ** (i + 1))
        b = end - start
        # off-diagonal blocks are (b, start)/(start, b): for non-dyadic
        # mosaic sizes (long filters) start != b
        regions += [(start, start, b, b), (start, 0, b, start), (0, start, start, b)]
    return regions


def _region_leaves(coeffs) -> list:
    """The leaves in `mosaic_regions` order."""
    leaves = [coeffs[0]]
    for det in coeffs[1:][::-1]:  # coeffs[1:] is coarsest -> finest
        leaves += [det.diagonal, det.vertical, det.horizontal]
    return leaves


def mosaic2d(coeffs, normalize: bool = True, channel_axis: int = 1) -> torch.Tensor:
    """Pack per-coefficient values [cA, Detail2D_J..Detail2D_1] (each
    (..., B, C, h, w), or (..., B, h, w, C) with ``channel_axis=-1``) into
    the dyadic mosaic (..., B, S, S)."""
    size = mosaic_size(coeffs, channel_axis)
    out = coeffs[0].new_zeros(coeffs[0].shape[:-3] + (size, size))
    for leaf, (r0, c0, nr, nc) in zip(_region_leaves(coeffs), mosaic_regions(coeffs, channel_axis)):
        out[..., r0:r0 + nr, c0:c0 + nc] = _prep(leaf, normalize, channel_axis)[..., :nr, :nc]
    return out


def leaf_maxima(coeffs, channel_axis: int = 1) -> torch.Tensor:
    """The divisors `mosaic2d(normalize=True)` takes, one a leaf in
    `mosaic_regions` order: the max of each leaf's |channel mean| over the
    last three axes (one sample's B, h, w), stacked on a last axis
    (..., n_regions)."""
    return torch.stack([_prep(leaf, False, channel_axis).amax(dim=(-3, -2, -1))
                        for leaf in _region_leaves(coeffs)], dim=-1)


def normalize_mosaic(mosaic: torch.Tensor, maxima: torch.Tensor, regions) -> torch.Tensor:
    """An unnormalized mosaic (..., B, S, S) (`mosaic2d(normalize=False)`)
    divided region by region by ``maxima`` (..., n_regions), as
    `mosaic2d(normalize=True)` divides each leaf by its max (a zero max by
    1): the two agree wherever the maxima do. Taking the maxima over more
    rows than one call saw (`leaf_maxima` of each block of a batch, reduced
    by max) normalizes the blocks as one batch."""
    div = torch.ones_like(mosaic[..., :1, :, :])
    m = torch.where(maxima == 0, torch.ones_like(maxima), maxima).to(mosaic.dtype)
    for k, (r0, c0, nr, nc) in enumerate(regions):
        div[..., r0:r0 + nr, c0:c0 + nc] = m[..., k, None, None, None]
    return mosaic / div


def _resize_bilinear(a: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear resize of the last two axes to (size, size), half-pixel
    centers; the same values as ``jax.image.resize(method="bilinear")`` when
    upsampling, borders included."""
    lead = a.shape[:-2]
    flat = a.reshape((-1, 1) + tuple(a.shape[-2:]))
    out = F.interpolate(flat, size=(size, size), mode="bilinear", align_corners=False,
                        antialias=False)
    return out.reshape(lead + (size, size))


def reproject_mosaic(avg: torch.Tensor, levels: int, approx_coeffs: bool = False) -> torch.Tensor:
    """Unpack an averaged mosaic (B, S, S) into per-level pixel-domain maps
    (B, levels(+1), S, S): each level's H+V+D blocks upsampled and summed."""
    size = avg.shape[-1]
    maps = []
    for j in range(levels):
        end = size // (2**j)
        start = size // (2 ** (j + 1))
        maps.append(_resize_bilinear(avg[:, :start, start:end], size)
                    + _resize_bilinear(avg[:, start:end, :start], size)
                    + _resize_bilinear(avg[:, start:end, start:end], size))
    if approx_coeffs:
        end = size // (2**levels)
        maps.append(_resize_bilinear(avg[:, :end, :end], size))
    return torch.stack(maps, dim=1)


def disentangle_scales(coeffs, approx_coeffs: bool = False, size: int | None = None,
                       channel_axis: int = 1) -> torch.Tensor:
    """Per-level pixel-domain importance maps straight from coefficient
    grads: (B, J(+1), S, S), finest level first. ``channel_axis=-1`` for
    NHWC coefficient leaves."""
    if size is None:
        size = mosaic_size(coeffs, channel_axis)
    maps = []
    for det in coeffs[1:][::-1]:
        maps.append(_resize_bilinear(_prep(det.horizontal, True, channel_axis), size)
                    + _resize_bilinear(_prep(det.vertical, True, channel_axis), size)
                    + _resize_bilinear(_prep(det.diagonal, True, channel_axis), size))
    if approx_coeffs:
        maps.append(_resize_bilinear(_prep(coeffs[0], True, channel_axis), size))
    return torch.stack(maps, dim=1)
