"""The reference's 3D voxel CNN (`VoxelModel`) as a PyTorch module.

Counterpart of `wam_tpu.models.voxel`: two (Conv3d 3x3x3 VALID, biased ->
ReLU -> 2x2x2 max-pool) stages to 32 and 128 channels, then a 256-unit ReLU
layer and the class head, for 16^3 voxel grids (3D-MNIST; ``size`` sets
another side, as the reference's init shape does). The input
(B, 1, D, H, W) is consumed as it comes and the features are flattened in
PyTorch's NCDHW order, the layout of the reference's own (PyTorch) model;
`ingest.flax_voxel_to_torch` permutes the JAX model's ``fc1`` rows, which it
flattens in NDHWC order. ``act`` is an attribute, as in the reference, so a
modified-backward ReLU can be swapped in. The pooled features pass through
``tap("features", x)`` where the reference sows them (channels first here,
NDHWC there). Fresh weights are drawn as flax's
initialisers draw them (lecun_normal kernels, zero biases).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from wam_tpu_torch.models.layers import dense, lecun_normal_, tap

__all__ = ["VoxelModel"]


def _conv(in_ch: int, out_ch: int) -> nn.Conv3d:
    conv = nn.Conv3d(in_ch, out_ch, 3)
    lecun_normal_(conv.weight, in_ch * 27)
    nn.init.zeros_(conv.bias)
    return conv


class VoxelModel(nn.Module):
    """(B, 1, size, size, size) -> logits (B, num_classes)."""

    TAPS = ("features",)

    def __init__(self, num_classes: int = 10, size: int = 16):
        super().__init__()
        self.act = torch.relu
        self.conv1 = _conv(1, 32)
        self.conv2 = _conv(32, 128)
        side = ((size - 2) // 2 - 2) // 2  # two VALID 3^3 convs, each pooled by 2
        self.fc1 = dense(128 * side**3, 256)  # 128 channels of 2^3 at 16^3
        self.fc2 = dense(256, num_classes)

    def forward(self, x):
        x = F.max_pool3d(self.act(self.conv1(x)), 2)
        x = tap("features", F.max_pool3d(self.act(self.conv2(x)), 2))
        x = self.act(self.fc1(x.flatten(1)))
        return self.fc2(x)
