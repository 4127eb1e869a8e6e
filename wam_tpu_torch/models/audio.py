"""The audio CNN as a PyTorch module, and its binding for attribution.

Counterpart of `wam_tpu.models.audio`: VGG-style 3x3 conv (padding 1,
biased) -> BatchNorm (eps 1e-5) -> ReLU blocks with 2x2 max-pools, a 2x2
VALID conv to 1024 channels, a 1x1 sigmoid head and a global max (or mean)
over (T, n_mels). The input is the mel front end's (B, 1, T, n_mels), which
is already NCHW. Submodules carry the reference's names (``b1_conv``,
``b1_bn``, ..., ``head``), so `ingest.flax_audio_to_torch` maps the JAX
variables across by name and `bind_audio_inference(fold_bn=True)` pairs each
``bN_bn`` with its ``bN_conv``. The outputs of blocks 8, 10 and 11 (before
their pools) and of block 12 pass through the taps ``out0`` .. ``out3``
(`layers.tap`), the reference's sow/perturb points.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from wam_tpu_torch.models.layers import tap
from wam_tpu_torch.models.resnet import bind_inference
from wam_tpu_torch.models.toy import toy_conv_model

__all__ = ["AudioCNN", "bind_audio_inference", "toy_wave_model"]

# (block, output channels); a 2x2 max-pool follows the blocks marked True
_BLOCKS = ((1, 16, False), (2, 16, True), (3, 32, False), (4, 32, True), (5, 64, False),
           (6, 64, True), (7, 128, False), (8, 128, True), (9, 256, False), (10, 256, True),
           (11, 512, True))
_TAPPED = {8: "out0", 10: "out1", 11: "out2"}  # block -> tap on its output, before its pool


class AudioCNN(nn.Module):
    """(B, 1, T, n_mels) -> (B, num_classes) class scores in (0, 1)."""

    TAPS = ("out0", "out1", "out2", "out3")

    def __init__(self, num_classes: int = 50, pool: str = "max"):
        super().__init__()
        if pool not in ("max", "mean"):
            raise ValueError(f"pool must be 'max' or 'mean', got {pool!r}")
        self.pool = pool
        in_ch = 1
        for n, ch, _ in _BLOCKS:
            setattr(self, f"b{n}_conv", nn.Conv2d(in_ch, ch, 3, padding=1))
            setattr(self, f"b{n}_bn", nn.BatchNorm2d(ch, eps=1e-5))
            in_ch = ch
        self.b12_conv = nn.Conv2d(in_ch, 1024, 2)
        self.b12_bn = nn.BatchNorm2d(1024, eps=1e-5)
        self.head = nn.Conv2d(1024, num_classes, 1)

    def forward(self, x):
        for n, _, pool in _BLOCKS:
            x = torch.relu(getattr(self, f"b{n}_bn")(getattr(self, f"b{n}_conv")(x)))
            if n in _TAPPED:
                x = tap(_TAPPED[n], x)
            if pool:
                x = F.max_pool2d(x, 2)
        x = tap("out3", torch.relu(self.b12_bn(self.b12_conv(x))))
        x = torch.sigmoid(self.head(x))
        # amax splits the gradient evenly between tied maxima, as JAX's max does
        return x.amax(dim=(2, 3)) if self.pool == "max" else x.mean(dim=(2, 3))


def bind_audio_inference(model: nn.Module, variables=None, *,
                         compute_dtype: torch.dtype | None = None, fold_bn: bool = False,
                         device=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """A pure ``(B, 1, T, n_mels) -> (B, K)`` function, the module prepared in
    place as `resnet.bind_inference` prepares one: ``variables`` (e.g. from
    `ingest.flax_audio_to_torch`) loaded, eval mode on ``device`` (CUDA
    unless the caller asks otherwise), weights frozen. ``fold_bn`` folds
    each BatchNorm's multiply into its biased conv (weight and bias scaled
    per channel); ``compute_dtype`` casts the weights once and the input at
    the boundary, scores come back float32."""
    return bind_inference(model, variables, compute_dtype=compute_dtype, fold_bn=fold_bn,
                          device=device)


def toy_wave_model(kernel=None, *, seed: int = 3, classes: int = 4, taps: int = 9, device=None):
    """Tiny waveform classifier (B, N) -> (B, classes): the 1D instance of
    `toy.toy_conv_model`."""
    return toy_conv_model(kernel, seed=seed, ndim=1, classes=classes, taps=taps, device=device)
