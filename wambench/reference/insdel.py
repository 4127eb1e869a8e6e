"""Plain insertion and deletion (Petsiuk et al. 2018, "RISE"), in the
wavelet domain as WAM evaluates an explanation.

For one image x (3, H, W) (ImageNet-standardized) with label y and an
explanation mosaic m (S, S) that equals the packed coefficient array's
shape: the image is mapped back to [0, 1] (x * std + mean, clipped) and
decomposed; the packed array holds cA top-left, then per level H
top-right, V bottom-left, D bottom-right. With the cells of m ranked by
value, largest first (ties in row-major order), insertion mask k (k = 0..n)
keeps the k * floor(S^2 / n) best cells, mask 0 none and mask n all;
deletion is the complement, mask 0 all and mask n none. Each masked array is
unpacked, reconstructed, min-max rescaled to [0, 1] over (C, H, W),
standardized again and scored; the curve is the softmax probability of y
along the n + 1 masks and the AUC is sum(curve) / (max(curve) * (n + 1)).
"""

from __future__ import annotations

import torch

from wambench.reference import wavelets as rw

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _stats(x: torch.Tensor):
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device).reshape(3, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device).reshape(3, 1, 1)
    return mean, std


def masks(m: torch.Tensor, n: int):
    """(insertion, deletion) families (n + 1, S, S) of the mosaic ``m``."""
    flat = m.reshape(-1)
    size = flat.numel()
    order = torch.argsort(-flat, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(size, device=m.device)
    ins = torch.zeros((n + 1, size), dtype=torch.bool, device=m.device)
    for k in range(1, n + 1):
        ins[k] = rank < k * (size // n)
    ins[n] = True
    dele = ~ins
    dele[0], dele[n] = True, False
    return ins.reshape((n + 1,) + m.shape), dele.reshape((n + 1,) + m.shape)


def _pack(coeffs) -> torch.Tensor:
    """Packed array (C, S, S) of one image's coefficients (dyadic sizes)."""
    arr = coeffs[0]
    for H, V, D in coeffs[1:]:
        arr = torch.cat([torch.cat([arr, H], -1), torch.cat([V, D], -1)], -2)
    return arr


def _unpack(arr: torch.Tensor, levels: int) -> list:
    details = []
    for _ in range(levels):
        h = arr.shape[-2] // 2
        w = arr.shape[-1] // 2
        details.append((arr[..., :h, w:], arr[..., h:, :w], arr[..., h:, w:]))
        arr = arr[..., :h, :w]
    return [arr] + details[::-1]


def curve(model, x: torch.Tensor, y: int, fam: torch.Tensor, *, name: str, levels: int,
          dtype=torch.float32) -> torch.Tensor:
    """Probabilities of class y along the mask family ``fam`` (M, S, S)."""
    mean, std = _stats(x)
    image01 = torch.clamp(x * std + mean, 0.0, 1.0).to(dtype)
    coeffs = rw.wavedec2(image01, name, levels)
    masked = _pack(coeffs)[None] * fam[:, None].to(dtype)  # (M, C, S, S)
    rec = rw.waverec2(_unpack(masked, levels), name)[..., : x.shape[-2], : x.shape[-1]].float()
    lo = rec.amin(dim=(1, 2, 3), keepdim=True)
    hi = rec.amax(dim=(1, 2, 3), keepdim=True)
    rec = (rec - lo) / torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    logits = model(((rec - mean) / std).to(dtype)).float()
    return torch.softmax(logits, dim=-1)[:, y]


def auc(c: torch.Tensor) -> torch.Tensor:
    d = c.amax(-1) * c.shape[-1]
    return c.sum(-1) / torch.where(d == 0, torch.ones_like(d), d)
