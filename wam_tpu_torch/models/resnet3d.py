"""The 3D ResNet (`BASELINE.json`'s "wam_3D" config) as a PyTorch module.

Counterpart of `wam_tpu.models.resnet3d`: a 3x3x3 stem conv (padding 1, no
bias) -> BatchNorm (eps 1e-5) -> ReLU, four stages of `BasicBlock3D` at
widths ``width * 2**stage`` (stride 2 on the first block of stages 2-4, a
1x1x1 projection shortcut where the shape changes, which flax's ``SAME``
pads by 0), a spatial mean and a dense head. The input (B, 1, D, H, W) is
consumed as it comes (NCDHW, cuDNN's layout); bind it with
`resnet.bind_inference` and its default ``nchw=True``.

BatchNorms are named after their convs (``bnN`` <-> ``convN``,
``downsample_bn`` <-> ``downsample_conv``), so `ingest.flax_resnet3d_to_torch`
carries the JAX variables across by name and ``bind_inference(fold_bn=True)``
pairs them. ``act`` is an attribute of every block and of the network, so
``fused_relu_vjp=True`` can swap in the fused ReLU VJP. Fresh weights are
drawn as flax's initialisers draw them (lecun_normal kernels, zero biases,
BatchNorm scale 1, bias 0, mean 0, var 1) from torch's generator.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn as nn

from wam_tpu_torch.models.layers import lecun_normal_, tap

__all__ = ["BasicBlock3D", "ResNet3D", "resnet3d_10", "resnet3d_18"]


def _conv(in_ch: int, out_ch: int, k: int, stride: int = 1, padding: int = 0) -> nn.Conv3d:
    conv = nn.Conv3d(in_ch, out_ch, k, stride, padding, bias=False)
    lecun_normal_(conv.weight, in_ch * k**3)
    return conv


def _bn(ch: int) -> nn.BatchNorm3d:
    return nn.BatchNorm3d(ch, eps=1e-5)


class BasicBlock3D(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.act = torch.relu
        self.conv1 = _conv(in_ch, features, 3, stride, 1)
        self.bn1 = _bn(features)
        self.conv2 = _conv(features, features, 3, 1, 1)
        self.bn2 = _bn(features)
        self.downsample_conv = self.downsample_bn = None
        if stride != 1 or in_ch != features:
            self.downsample_conv = _conv(in_ch, features, 1, stride)
            self.downsample_bn = _bn(features)

    def forward(self, x):
        y = self.act(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample_conv is None else self.downsample_bn(self.downsample_conv(x))
        return self.act(y + residual)


class ResNet3D(nn.Module):
    """x: (B, 1, D, H, W) -> logits (B, num_classes). Each stage's output
    passes through the tap ``stage{s}`` (`layers.tap`)."""

    TAPS = ("stage1", "stage2", "stage3", "stage4")

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 10, width: int = 16):
        super().__init__()
        self.act = torch.relu
        self.conv1 = _conv(1, width, 3, 1, 1)
        self.bn1 = _bn(width)
        in_ch = width
        for stage, n_blocks in enumerate(stage_sizes):
            blocks = []
            for i in range(n_blocks):
                stride = 2 if stage > 0 and i == 0 else 1
                blocks.append(BasicBlock3D(in_ch, width * 2**stage, stride))
                in_ch = width * 2**stage
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)
        self.fc = nn.Linear(in_ch, num_classes)
        lecun_normal_(self.fc.weight, in_ch)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x):
        x = self.act(self.bn1(self.conv1(x)))
        for stage in range(self.n_stages):
            x = tap(f"stage{stage + 1}", getattr(self, f"layer{stage + 1}")(x))
        return self.fc(x.mean(dim=(2, 3, 4)))


resnet3d_10 = partial(ResNet3D, (1, 1, 1, 1))
resnet3d_18 = partial(ResNet3D, (2, 2, 2, 2))
