"""Plain Vision Transformer (Dosovitskiy et al. 2021, "An Image is Worth
16x16 Words"), timm's layout: a 16x16/16 patch convolution, a class token
first, learned position embeddings, pre-norm encoder blocks (LayerNorm,
multi-head self-attention with a fused qkv projection and queries scaled
by 1/sqrt(head_dim), LayerNorm, an MLP with exact erf GELU), a final
LayerNorm and a dense head on the class token. The weights are a dict keyed
by timm's state-dict names.

Departure from the paper: LayerNorm eps is 1e-6 (the JAX reference
implementation's and timm's), not torch's default.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LN_EPS = 1e-6


def _ln(w: dict, p: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], w[p + ".weight"], w[p + ".bias"], eps=LN_EPS)


def _lin(w: dict, p: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, w[p + ".weight"], w[p + ".bias"])


def forward(w: dict, x: torch.Tensor, heads: int = 12, depth: int = 12) -> torch.Tensor:
    """x (B, 3, H, W) -> logits (B, classes)."""
    proj = w["patch_embed.proj.weight"]
    p = proj.shape[-1]
    t = F.conv2d(x, proj, w["patch_embed.proj.bias"], stride=p)  # (B, D, h, w)
    B, D = t.shape[:2]
    t = t.flatten(2).transpose(1, 2)
    t = torch.cat([w["cls_token"].expand(B, -1, -1), t], dim=1) + w["pos_embed"]
    hd = D // heads
    for i in range(depth):
        b = f"blocks.{i}"
        q, k, v = _lin(w, b + ".attn.qkv", _ln(w, b + ".norm1", t)).reshape(
            B, -1, 3, heads, hd).permute(2, 0, 3, 1, 4)
        a = torch.softmax((q / hd**0.5) @ k.transpose(-2, -1), dim=-1) @ v
        t = t + _lin(w, b + ".attn.proj", a.transpose(1, 2).reshape(B, -1, D))
        h = F.gelu(_lin(w, b + ".mlp.fc1", _ln(w, b + ".norm2", t)))
        t = t + _lin(w, b + ".mlp.fc2", h)
    return _lin(w, "head", _ln(w, "norm", t)[:, 0])
