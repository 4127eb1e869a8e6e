"""Vision Transformer (the ViT-B/16 family) as a PyTorch module.

Counterpart of `wam_tpu.models.vit`, the model of `BASELINE.json`'s ViT
Integrated-Gradients workload: pre-norm encoder blocks (LayerNorm eps 1e-6,
multi-head self-attention with queries scaled by 1/sqrt(head_dim), an MLP
with exact erf GELU), a class token first in the sequence, learned position
embeddings, a final LayerNorm and a dense head on the class token.

The module takes (B, 3, H, W), as timm's does, and carries timm's parameter
names (``cls_token``, ``pos_embed``, ``patch_embed.proj``,
``blocks.{i}.{norm1, attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2}``,
``norm``, ``head``), so a timm-style state dict loads with ``strict=True``
and `ingest.flax_vit_to_torch` carries the JAX package's variables across.
Fresh weights are drawn as the reference's initialisers draw them:
``lecun_normal`` kernels, zero biases, ``normal(0.02)`` position
embeddings, a zero class token, LayerNorm ones and zeros.

Attention is no TPU kernel in the reference (flax's einsum and softmax);
the port calls ``F.scaled_dot_product_attention``. On an H100 the whole
attribution call, bound by the host, was 6-9 ms faster with it in event
time, while the explicit product, softmax and product needed 1.6 ms less
device time; PERF.md §6 has both (`scripts/torch_vit_forms.py`), and §7
asks for the choice to be measured again once the host no longer binds
the call.

``capture_attn=True`` (the transformer baselines, `xattr.attention`) runs
the same parameters through the explicit form, q / sqrt(head_dim) · kᵀ →
softmax → · v, so each block's softmax weights A (B, heads, N, N) exist as
a tensor, and passes them through the tap ``block{i}/attn/attention_weights``
(`layers.tap`; the names are ``attention_taps``): a `tap_scope` reads them
back after a forward (the reference's ``sow``) and gives ∂logit/∂A (the
gradient at the reference's zero ``perturb``). With ``capture_attn=False``
the forward is the SDPA path alone, no added operation.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn as nn
import torch.nn.functional as F

from wam_tpu_torch.models.layers import LN_EPS, dense, tap
from wam_tpu_torch.models.patchconv import PatchConv
from wam_tpu_torch.models.resnet import bind_inference

__all__ = ["MlpBlock", "Attention", "EncoderBlock", "ViT", "vit_b16", "vit_tiny_test",
           "bind_vit_inference"]



class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = dense(dim, hidden)
        self.fc2 = dense(hidden, dim)

    def forward(self, x):
        # exact (erf) GELU, as timm's and torchvision's ViTs
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    """Multi-head self-attention with a fused qkv projection (timm's
    layout: rows of ``qkv.weight`` are q, k, v, each heads x head_dim);
    queries scaled by 1/sqrt(head_dim) inside SDPA, or, with a
    ``capture`` tap name, divided by sqrt(head_dim) before the explicit
    q kᵀ, softmax and product with v, the softmax weights passing through
    that tap."""

    def __init__(self, dim: int, heads: int, capture: str | None = None):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not a multiple of heads {heads}")
        self.heads = heads
        self.capture = capture
        self.qkv = dense(dim, 3 * dim)
        self.proj = dense(dim, dim)

    def forward(self, x):
        B, N, D = x.shape
        q, k, v = self.qkv(x).reshape(B, N, 3, self.heads, D // self.heads).permute(2, 0, 3, 1, 4)
        if self.capture is None:
            y = F.scaled_dot_product_attention(q, k, v)  # (B, heads, N, head_dim)
        else:
            scores = (q / math.sqrt(q.shape[-1])) @ k.transpose(-2, -1)
            y = tap(self.capture, torch.softmax(scores, dim=-1)) @ v
        return self.proj(y.transpose(1, 2).reshape(B, N, D))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_hidden: int, capture: str | None = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads, capture)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MlpBlock(dim, mlp_hidden)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """x: (B, 3, image_size, image_size) -> logits (B, num_classes).
    ``image_size`` sets the length of ``pos_embed`` (the reference reads it
    from the input at init). ``capture_attn=True`` exposes every block's
    softmax weights through the taps named in ``attention_taps`` (module
    docstring); it changes no parameter. The token sequence (B, 1 + N, D)
    after the last block passes through the tap ``tokens`` (`layers.tap`)."""

    TAPS = ("tokens",)

    def __init__(self, num_classes: int = 1000, patch: int = 16, dim: int = 768,
                 depth: int = 12, heads: int = 12, mlp_hidden: int = 3072,
                 image_size: int = 224, capture_attn: bool = False):
        super().__init__()
        self.capture_attn = bool(capture_attn)
        captures = [f"block{i}/attn/attention_weights" if capture_attn else None
                    for i in range(depth)]
        self.attention_taps = tuple(c for c in captures if c)
        n_tokens = (image_size // patch) ** 2 + 1
        self.dim = dim
        self.patch_embed = nn.ModuleDict({"proj": PatchConv(3, dim, patch)})
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.empty(1, n_tokens, dim))
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02)
        self.blocks = nn.ModuleList(EncoderBlock(dim, heads, mlp_hidden, c) for c in captures)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.head = dense(dim, num_classes)

    def forward(self, x):
        B = x.shape[0]
        x = self.patch_embed["proj"](x.permute(0, 2, 3, 1)).reshape(B, -1, self.dim)
        x = torch.cat([self.cls_token.expand(B, -1, -1), x], dim=1) + self.pos_embed
        for block in self.blocks:
            x = block(x)
        # the token tap, after the last block and before the final LayerNorm
        return self.head(self.norm(tap("tokens", x))[:, 0])


vit_b16 = partial(ViT, patch=16, dim=768, depth=12, heads=12, mlp_hidden=3072)
vit_tiny_test = partial(ViT, patch=8, dim=64, depth=2, heads=4, mlp_hidden=128)


# The reference's name for `resnet.bind_inference` with its ViT default:
# (B, H, W, C) input unless ``nchw=True``.
bind_vit_inference = partial(bind_inference, nchw=False)
