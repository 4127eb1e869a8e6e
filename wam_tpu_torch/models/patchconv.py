"""Non-overlapping (stride == kernel) convolution, channels last.

Counterpart of `wam_tpu.models.patchconv`: the ViT patch embedding and the
ConvNeXt stem and downsamplers. ``PatchConv`` maps (B, H, W, C) to
(B, H // p, W // p, features) with VALID cropping (the H, W remainders are
dropped), its parameters held as timm's ``patch_embed.proj`` holds them:
``weight`` (features, C, p, p) and ``bias`` (features,), so checkpoints and
`ingest.flax_vit_to_torch` map across by name.

It runs as the reference does: a block reshape to (B, H/p, W/p, C·p·p) and
one matmul. On an H100 the other exact form, ``F.conv2d(stride=p)``, was no
faster in the ViT's attribution call and slower in the ConvNeXt's (PERF.md,
`scripts/torch_vit_forms.py`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from wam_tpu_torch.models.layers import lecun_normal_

__all__ = ["PatchConv"]


class PatchConv(nn.Module):
    """(B, H, W, C) -> (B, H // p, W // p, features); weights drawn as the
    reference's (``lecun_normal`` over fan-in C·p·p, zero bias)."""

    def __init__(self, in_ch: int, features: int, patch: int):
        super().__init__()
        self.patch = patch
        self.weight = nn.Parameter(torch.empty(features, in_ch, patch, patch))
        self.bias = nn.Parameter(torch.zeros(features))
        lecun_normal_(self.weight, in_ch * patch * patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        p, h, w = self.patch, H // self.patch, W // self.patch
        cols = (x[:, : h * p, : w * p].reshape(B, h, p, w, p, C).permute(0, 1, 3, 5, 2, 4)
                .reshape(B, h, w, C * p * p))
        return F.linear(cols, self.weight.reshape(self.weight.shape[0], -1), self.bias)
