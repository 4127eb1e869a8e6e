"""2D dyadic-mosaic packing and per-scale reprojection (PyTorch).

Counterpart of `wam_tpu.ops.packing2d` for NCHW coefficient leaves
(..., B, C, h, w). Any leading axes before the batch axis are stacked
samples: each one is normalized on its own, exactly as the JAX package
normalizes the one sample its mapped step sees.

Mosaic layout: approximation in the top-left corner; for each level with
block span [s, e) (s = S/2^{i+1}, e = S/2^i, i = 0 for the finest level):
diagonal at [s:e, s:e], vertical at [s:e, :s], horizontal at [:s, s:e].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["mosaic2d", "reproject_mosaic", "disentangle_scales", "mosaic_size"]


def _norm(a: torch.Tensor, enabled: bool) -> torch.Tensor:
    """Divide by the max over the last three axes (one sample's B, h, w)."""
    if not enabled:
        return a
    m = a.amax(dim=(-3, -2, -1), keepdim=True)
    return a / torch.where(m == 0, torch.ones_like(m), m)


def _prep(block: torch.Tensor, normalize: bool) -> torch.Tensor:
    """channel-mean -> abs -> optional max normalization (the reference
    order; abs of the mean is not the mean of abs)."""
    return _norm(block.mean(dim=-3).abs(), normalize)


def mosaic_size(coeffs) -> int:
    """Mosaic side = 2 x finest-level detail size."""
    return int(2 * coeffs[-1].horizontal.shape[-1])


def mosaic2d(coeffs, normalize: bool = True) -> torch.Tensor:
    """Pack per-coefficient values [cA, Detail2D_J..Detail2D_1] (each
    (..., B, C, h, w)) into the dyadic mosaic (..., B, S, S)."""
    size = mosaic_size(coeffs)
    out = coeffs[0].new_zeros(coeffs[0].shape[:-3] + (size, size))

    approx = _prep(coeffs[0], normalize)
    ha = min(approx.shape[-2], size)
    wa = min(approx.shape[-1], size)
    out[..., :ha, :wa] = approx[..., :ha, :wa]

    # coeffs[1:] is coarsest -> finest; enumerate finest-first
    for i, det in enumerate(coeffs[1:][::-1]):
        end = size // (2**i)
        start = size // (2 ** (i + 1))
        b = end - start
        # off-diagonal blocks are (b, start)/(start, b): for non-dyadic
        # mosaic sizes (long filters) start != b
        out[..., start:end, start:end] = _prep(det.diagonal, normalize)[..., :b, :b]
        out[..., start:end, :start] = _prep(det.vertical, normalize)[..., :b, :start]
        out[..., :start, start:end] = _prep(det.horizontal, normalize)[..., :start, :b]
    return out


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


def disentangle_scales(coeffs, approx_coeffs: bool = False, size: int | None = None) -> torch.Tensor:
    """Per-level pixel-domain importance maps straight from coefficient
    grads: (B, J(+1), S, S), finest level first."""
    if size is None:
        size = mosaic_size(coeffs)
    maps = []
    for det in coeffs[1:][::-1]:
        maps.append(_resize_bilinear(_prep(det.horizontal, True), size)
                    + _resize_bilinear(_prep(det.vertical, True), size)
                    + _resize_bilinear(_prep(det.diagonal, True), size))
    if approx_coeffs:
        maps.append(_resize_bilinear(_prep(coeffs[0], True), size))
    return torch.stack(maps, dim=1)
