"""Tiny conv classifier for tests and demos: one SAME conv + tanh + global
mean over the spatial axes, (B, spatial...) -> (B, classes). Counterpart of
`wam_tpu.models.toy`; the kernel is passed in (tests hand the JAX package's
kernel across) or drawn from a seeded generator."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from wam_tpu_torch.device import resolve_device

__all__ = ["toy_conv_model"]

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def toy_conv_model(kernel=None, *, seed: int = 3, ndim: int = 2, classes: int = 4,
                   taps: int = 5, device=None):
    """(B, S1..Sn) -> (B, classes); ``kernel`` is (classes, 1, taps, ...) or
    None for N(0, 0.3^2) draws from ``seed``."""
    device = resolve_device(device)
    if kernel is None:
        g = torch.Generator().manual_seed(seed)
        kernel = torch.randn((classes, 1) + (taps,) * ndim, generator=g) * 0.3
    kern = torch.tensor(np.asarray(kernel), dtype=torch.float32, device=device)
    taps = kern.shape[-1]
    conv = _CONV[ndim]

    def model_fn(x: torch.Tensor) -> torch.Tensor:
        out = conv(x[:, None], kern, padding=taps // 2)
        return torch.tanh(out).mean(dim=tuple(range(2, 2 + ndim)))

    return model_fn
