"""ResNet-18 and ResNet-50 as PyTorch modules, NCHW.

Counterpart of `wam_tpu.models.resnet`: the same architecture (stride on the
3x3 conv of a bottleneck, 1x1 projection shortcut where the shape changes,
BatchNorm eps 1e-5, max-pool 3/2 pad 1, global mean, dense head) with
torchvision's state-dict names, so `wam_tpu_torch.models.ingest` carries the
JAX package's weights across mechanically. Convolutions are cuDNN's, as the
JAX package leaves them to XLA. The activation is the ``act`` attribute of
every block and of the network (``torch.relu`` by default), as the
reference's ``act`` field is, so `bind_inference` can swap in the fused
ReLU VJP and guided backprop its guided ReLU. ``post_linear`` (identity by
default) is read where the reference applies its hook: after every
BatchNorm output and after ``fc``; the ε-rule LRP sets it. The stage
outputs pass through the taps ``stage1`` .. ``stage4`` (`layers.tap`), as
the reference sows them and routes them through its perturbation.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Sequence

import torch
import torch.nn as nn

import torch.nn.functional as F

from wam_tpu_torch.device import resolve_device
from wam_tpu_torch.models.layers import tap
from wam_tpu_torch.tune.fused_relu import fused_relu

__all__ = ["BasicBlock", "Bottleneck", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "bind_inference"]


def _identity(z):
    return z


def _bn(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=1e-5)


def _shortcut(in_ch: int, out_ch: int, stride: int) -> nn.Module | None:
    if stride == 1 and in_ch == out_ch:
        return None
    return nn.Sequential(nn.Conv2d(in_ch, out_ch, 1, stride, bias=False), _bn(out_ch))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.act = torch.relu
        self.post_linear = _identity
        self.conv1 = nn.Conv2d(in_ch, features, 3, stride, 1, bias=False)
        self.bn1 = _bn(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = _bn(features)
        self.downsample = _shortcut(in_ch, features, stride)

    def forward(self, x):
        pl = self.post_linear
        y = self.act(pl(self.bn1(self.conv1(x))))
        y = pl(self.bn2(self.conv2(y)))
        residual = x if self.downsample is None else pl(self.downsample(x))
        return self.act(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.act = torch.relu
        self.post_linear = _identity
        out_ch = features * self.expansion
        self.conv1 = nn.Conv2d(in_ch, features, 1, bias=False)
        self.bn1 = _bn(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride, 1, bias=False)
        self.bn2 = _bn(features)
        self.conv3 = nn.Conv2d(features, out_ch, 1, bias=False)
        self.bn3 = _bn(out_ch)
        self.downsample = _shortcut(in_ch, out_ch, stride)

    def forward(self, x):
        pl = self.post_linear
        y = self.act(pl(self.bn1(self.conv1(x))))
        y = self.act(pl(self.bn2(self.conv2(y))))
        y = pl(self.bn3(self.conv3(y)))
        residual = x if self.downsample is None else pl(self.downsample(x))
        return self.act(y + residual)


def _s2d_stem(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 7x7/2 pad-3 stem conv in space-to-depth form (the reference's
    `_StemConv` with ``s2d=True``): the input rearranged to (B, 4C, H/2,
    W/2), channels ordered (row parity, column parity, channel), convolved
    at stride 1 with the (64, 4C, 4, 4) kernel built from the 7x7 weight
    ``w``: out[o] = sum_k w[k] x[2o + k - 3]; with the input index 2u + a
    the tap is k = 2j + a - 1 for j = u - o + 2 in [0, 4), and k = -1 (j =
    0, a = 0) is the zero row the pad adds. Same function, for even H and W."""
    B, C, H, W = x.shape
    xs = x.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 3, 5, 1, 2, 4)
    xs = xs.reshape(B, 4 * C, H // 2, W // 2)
    wp = F.pad(w, (1, 0, 1, 0))  # (O, C, 8, 8)
    k2 = wp.reshape(w.shape[0], C, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    k2 = k2.reshape(w.shape[0], 4 * C, 4, 4)
    return F.conv2d(F.pad(xs, (2, 1, 2, 1)), k2)


class ResNet(nn.Module):
    """x: (B, 3, H, W) -> logits (B, num_classes). ``stem_s2d=True`` runs
    the stem conv in its space-to-depth form (same weight, same function;
    the reference's TPU-shaped rewrite, here for API parity: chip_smoke.py
    times both forms)."""

    TAPS = ("stage1", "stage2", "stage3", "stage4")

    def __init__(self, stage_sizes: Sequence[int], block_cls, num_classes: int = 1000,
                 stem_s2d: bool = False):
        super().__init__()
        self.act = torch.relu
        self.post_linear = _identity
        self.stem_s2d = stem_s2d
        self.stage_sizes = tuple(stage_sizes)
        self.block_cls = block_cls
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        in_ch = 64
        for stage, n_blocks in enumerate(stage_sizes):
            blocks = []
            for i in range(n_blocks):
                stride = 2 if stage > 0 and i == 0 else 1
                blocks.append(block_cls(in_ch, 64 * 2**stage, stride))
                in_ch = 64 * 2**stage * block_cls.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)
        self.fc = nn.Linear(in_ch, num_classes)

    def stem(self, x):
        """The stem conv, in the form ``stem_s2d`` asks for."""
        if self.stem_s2d and x.shape[-2] % 2 == 0 and x.shape[-1] % 2 == 0:
            return _s2d_stem(x, self.conv1.weight)
        return self.conv1(x)

    def forward(self, x):
        pl = self.post_linear
        x = self.maxpool(self.act(pl(self.bn1(self.stem(x)))))
        for stage in range(self.n_stages):
            x = tap(f"stage{stage + 1}", getattr(self, f"layer{stage + 1}")(x))
        return pl(self.fc(x.mean(dim=(2, 3))))


resnet18 = partial(ResNet, (2, 2, 2, 2), BasicBlock)
resnet34 = partial(ResNet, (3, 4, 6, 3), BasicBlock)
resnet50 = partial(ResNet, (3, 4, 6, 3), Bottleneck)
resnet101 = partial(ResNet, (3, 4, 23, 3), Bottleneck)


def _conv_of(bn_name: str) -> str | None:
    """The conv a BatchNorm follows, by this package's naming: bnN <-> convN,
    downsample.1 <-> downsample.0, and the AudioCNN's bN_bn <-> bN_conv."""
    parent, _, leaf = bn_name.rpartition(".")
    if leaf.startswith("bn"):
        conv = "conv" + leaf[2:]
    elif leaf.endswith("_bn"):
        conv = leaf[:-3] + "_conv"
    elif leaf == "1" and parent.endswith("downsample"):
        conv = "0"
    else:
        return None
    return f"{parent}.{conv}" if parent else conv


@torch.no_grad()
def _fold_bn(model: nn.Module, eps: float = 1e-5) -> None:
    """Fold inference-mode BatchNorm affines into the preceding conv weights,
    in place, for convolutions of any rank (1D, 2D, 3D): BN with running
    stats is y = x*a + b with a = gamma/sqrt(var+eps), b = beta - mean*a; the
    conv's output channels are scaled by a and the BN becomes the pure shift
    (weight 1, bias b, mean 0, var 1-eps, the float32 value of 1 - eps as
    the reference writes it, whatever the tensor's dtype)."""
    modules = dict(model.named_modules())
    for name, bn in modules.items():
        if not isinstance(bn, nn.modules.batchnorm._BatchNorm):
            continue
        conv = modules.get(_conv_of(name) or "")
        if not isinstance(conv, nn.modules.conv._ConvNd) or conv.transposed:
            continue
        a = bn.weight / torch.sqrt(bn.running_var + eps)
        conv.weight.mul_(a.reshape((-1,) + (1,) * (conv.weight.ndim - 1)))
        if conv.bias is not None:
            conv.bias.mul_(a)
        bn.bias.copy_(bn.bias - bn.running_mean * a)
        bn.weight.fill_(1.0)
        bn.running_mean.zero_()
        bn.running_var.fill_(torch.tensor(1.0 - eps, dtype=torch.float32).item())


def bind_inference(
    model: nn.Module,
    variables=None,
    *,
    nchw: bool = True,
    compute_dtype: torch.dtype | None = None,
    fold_bn: bool = False,
    fused_relu_vjp: bool = False,
    device=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Bind a model for attribution: a pure ``x -> logits`` function.

    The module is prepared IN PLACE: ``variables`` (a state dict, e.g. from
    `ingest.flax_resnet_to_torch`) is loaded when given, the module is put in
    eval mode on ``device`` (CUDA unless the caller asks otherwise), and every
    parameter gets ``requires_grad=False`` — attribution differentiates only
    with respect to the input, so no weight gradient is ever computed.

    ``nchw=False`` accepts (B, H, W, C) input and permutes it to NCHW; it
    is for 4-D image input only. A model that takes its input as it comes,
    such as `resnet3d.ResNet3D` on (B, 1, D, H, W) volumes, is bound with
    the default ``nchw=True``: on a 5-D input ``nchw=False`` would permute
    the wrong axes. ``compute_dtype`` (e.g.
    ``torch.bfloat16``) casts parameters and buffers once and the input at
    the boundary; logits come back float32. ``fold_bn`` folds BatchNorm
    multiplies into the conv weights (same function, cheaper backward; a
    biased conv's bias takes the same per-channel scale).
    ``fused_relu_vjp`` sets ``act = fused_relu`` on every module that has an
    ``act`` (`wam_tpu_torch.tune.fused_relu`: the backward keeps a bit-packed
    sign mask instead of the activation, kernels K4/K5 on CUDA); same values
    and gradients, parameters untouched, so it composes with ``fold_bn`` and
    ``compute_dtype``. A model without ``act`` raises ValueError."""
    if fused_relu_vjp and not hasattr(model, "act"):
        raise ValueError("fused_relu_vjp=True requires a model with an `act` attribute "
                         f"(got {type(model).__name__})")
    device = resolve_device(device)
    if variables is not None:
        model.load_state_dict(variables)
    model.eval().to(device)
    model.requires_grad_(False)
    if fold_bn:
        _fold_bn(model)
    if compute_dtype is not None:
        model.to(compute_dtype)
    if fused_relu_vjp:
        for module in model.modules():
            if hasattr(module, "act"):
                module.act = fused_relu

    def fn(x: torch.Tensor) -> torch.Tensor:
        if not nchw:
            x = x.permute(0, 3, 1, 2)
        if compute_dtype is not None:
            return model(x.to(compute_dtype)).float()
        return model(x)

    return fn
