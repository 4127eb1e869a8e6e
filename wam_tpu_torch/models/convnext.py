"""ConvNeXt (Tiny by default) as a PyTorch module.

Counterpart of `wam_tpu.models.convnext`: a patchify stem (4x4/4
`PatchConv` and LayerNorm), stages of blocks (7x7 depthwise conv, LayerNorm,
4x pointwise MLP with exact GELU, layer scale, residual), LayerNorm and a
2x2/2 `PatchConv` between stages, and a head of global mean, LayerNorm and
a dense layer. Every LayerNorm has eps 1e-6, as flax's.

The module takes (B, 3, H, W) and carries torchvision's parameter names
(``features.0`` stem, ``features.{2s}`` downsamplers,
``features.{2s+1}.{i}.block.{0,2,3,5}`` and ``layer_scale`` of each block,
``classifier.{0,2}``), so a torchvision-style state dict loads with
``strict=True`` and `ingest.flax_convnext_to_torch` carries the JAX
package's variables across. Fresh weights are drawn as the reference's
initialisers draw them (``lecun_normal`` kernels, zero biases, LayerNorm
ones and zeros, layer scales 1e-6).

Memory format: activations are channels-last, (B, H, W, C) contiguous,
between the stem and the head, as the reference keeps them. LayerNorm and
the pointwise MLP then work on the last axis with no copy, and each
depthwise convolution runs on the channels-last view of the block's input
(``permute(0, 3, 1, 2)``, no copy), which cuDNN takes as NHWC.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn as nn

from wam_tpu_torch.models.layers import LN_EPS, dense, lecun_normal_, tap
from wam_tpu_torch.models.patchconv import PatchConv

__all__ = ["ConvNeXtBlock", "ConvNeXt", "convnext_tiny", "convnext_test"]


def _norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


class ConvNeXtBlock(nn.Module):
    """(B, H, W, dim) -> the same; ``block`` holds torchvision's layers at
    its indices (0 depthwise conv, 2 LayerNorm, 3 and 5 the MLP; 1 stands
    where torchvision permutes to channels-last, which the activations
    already are)."""

    def __init__(self, dim: int):
        super().__init__()
        dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        lecun_normal_(dwconv.weight, 49)
        nn.init.zeros_(dwconv.bias)
        self.block = nn.Sequential(dwconv, nn.Identity(), _norm(dim), dense(dim, 4 * dim),
                                   nn.GELU(), dense(4 * dim, dim))
        self.layer_scale = nn.Parameter(torch.full((dim, 1, 1), 1e-6))

    def forward(self, x):
        y = self.block[0](x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        y = self.block[5](self.block[4](self.block[3](self.block[2](y))))
        return x + self.layer_scale.reshape(-1) * y


class ConvNeXt(nn.Module):
    """x: (B, 3, H, W) -> logits (B, num_classes). Each stage's output, (B,
    H, W, C) channels-last, passes through the tap ``stage{s}``
    (`layers.tap`)."""

    TAPS = ("stage1", "stage2", "stage3", "stage4")

    def __init__(self, num_classes: int = 1000, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768)):
        super().__init__()
        feats = [nn.Sequential(PatchConv(3, dims[0], 4), _norm(dims[0]))]
        for stage, (depth, dim) in enumerate(zip(depths, dims)):
            if stage > 0:
                feats.append(nn.Sequential(_norm(dims[stage - 1]),
                                           PatchConv(dims[stage - 1], dim, 2)))
            feats.append(nn.Sequential(*(ConvNeXtBlock(dim) for _ in range(depth))))
        self.features = nn.Sequential(*feats)
        self.classifier = nn.Sequential(_norm(dims[-1]), nn.Flatten(1),
                                        dense(dims[-1], num_classes))

    def forward(self, x):
        x = x.permute(0, 2, 3, 1)
        stage = 0
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i % 2 == 1:  # the stem and the downsamplers sit at even indices
                stage += 1
                x = tap(f"stage{stage}", x, channels_last=True)
        return self.classifier(x.mean(dim=(1, 2)))


convnext_tiny = partial(ConvNeXt, depths=(3, 3, 9, 3), dims=(96, 192, 384, 768))
convnext_test = partial(ConvNeXt, depths=(1, 1), dims=(16, 32))
