"""Plain ResNet (He et al. 2016, "Deep Residual Learning"), torchvision's
layout: a 7x7/2 stem convolution, BatchNorm, ReLU, 3x3/2 max-pool (pad 1),
four stages of bottleneck blocks (1x1, 3x3 with the stage's stride, 1x1 x4;
a 1x1 projection with BatchNorm where the shape changes), global average
pool and a dense head. BatchNorm in inference form with eps 1e-5. The
weights are a dict keyed by torchvision's state-dict names.

Departures from the paper: the stride sits on the 3x3 convolution of a
bottleneck (torchvision's "ResNet v1.5"), as in the measured package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _bn(w: dict, p: str, x: torch.Tensor) -> torch.Tensor:
    return F.batch_norm(x, w[p + ".running_mean"], w[p + ".running_var"], w[p + ".weight"],
                        w[p + ".bias"], training=False, eps=1e-5)


def _block(w: dict, p: str, x: torch.Tensor, stride: int) -> torch.Tensor:
    y = F.relu(_bn(w, p + ".bn1", F.conv2d(x, w[p + ".conv1.weight"])))
    y = F.relu(_bn(w, p + ".bn2", F.conv2d(y, w[p + ".conv2.weight"], stride=stride, padding=1)))
    y = _bn(w, p + ".bn3", F.conv2d(y, w[p + ".conv3.weight"]))
    if p + ".downsample.0.weight" in w:
        x = _bn(w, p + ".downsample.1", F.conv2d(x, w[p + ".downsample.0.weight"], stride=stride))
    return F.relu(y + x)


def forward(w: dict, x: torch.Tensor, stages=(3, 4, 6, 3)) -> torch.Tensor:
    """x (B, 3, H, W) -> logits (B, classes)."""
    x = F.relu(_bn(w, "bn1", F.conv2d(x, w["conv1.weight"], stride=2, padding=3)))
    x = F.max_pool2d(x, 3, 2, 1)
    for s, n in enumerate(stages):
        for i in range(n):
            x = _block(w, f"layer{s + 1}.{i}", x, 2 if s > 0 and i == 0 else 1)
    return F.linear(x.mean(dim=(2, 3)), w["fc.weight"], w["fc.bias"])
