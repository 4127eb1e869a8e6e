"""What the ViT, the ConvNeXt and `PatchConv` share: flax's LayerNorm eps,
the reference's initialisers (`lecun_normal_`, `dense`), and the message
of the taps that are not ported yet."""

from __future__ import annotations

import math

import torch
import torch.nn as nn

__all__ = ["LN_EPS", "TAPS_SLICE", "lecun_normal_", "dense"]

LN_EPS = 1e-6  # flax's LayerNorm default (torch's is 1e-5)
TAPS_SLICE = ("the sow/perturb taps are not ported yet (ROADMAP.md, slice C: the evaluation "
              "baselines read them)")


def lecun_normal_(weight: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's ``lecun_normal``, in place: a normal of variance 1 / fan_in
    truncated at two standard deviations (the scale corrected for the
    truncation, as flax's ``variance_scaling`` does), from torch's global
    generator."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std)


def dense(d_in: int, d_out: int) -> nn.Linear:
    """A dense layer drawn as flax's ``Dense``: lecun_normal kernel, zero bias."""
    layer = nn.Linear(d_in, d_out)
    lecun_normal_(layer.weight, d_in)
    nn.init.zeros_(layer.bias)
    return layer
