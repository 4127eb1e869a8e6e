"""Transformer-native attribution baselines: attention rollout and
grad x attention relevance (PyTorch port of `wam_tpu.xattr.attention`).

Both read the per-block softmax weights that `models.vit.ViT` exposes when
built with ``capture_attn=True``: each block passes its weights A (B, heads,
N, N) through the tap ``block{i}/attn/attention_weights``, so a `tap_scope`
records them after a forward (`capture_attention_weights`, the reference's
sown intermediates) and `torch.autograd.grad` at the recorded tensors gives
∂logit/∂A (`attention_weight_grads`, the reference's zero perturb tap).

Methods, both (x, y) -> a (B, H, W) map (the `evalsuite.baselines`
contract); like the port's other baselines they take the `nn.Module`,
which carries its weights, run it at its own dtype and return float32:

- `attention_rollout` (Abnar & Zuidema 2020): per block the head mean of
  the weights, mixed with the residual identity (0.5 A + 0.5 I),
  row-normalized, composed input to output; the class-token row of the
  composite is the relevance of each patch token;
- `attention_gradient` (Chefer et al. 2021): per block Ā = ReLU(mean_h
  (∂logit/∂A ⊙ A)), accumulated through the residual stream as
  R <- R + Ā R from the first block up; class-token row again.

The token-grid maps are resized bilinearly to the input's (H, W)
(`evalsuite.baselines.resize_bilinear`, the values of ``jax.image.resize``
when upsampling), so the fan evaluators perturb pixels as they do for the
CNN baselines.
"""

from __future__ import annotations

import torch

from wam_tpu_torch.evalsuite.baselines import module_forward, resize_bilinear, widen
from wam_tpu_torch.models.layers import tap_scope

__all__ = [
    "capture_attention_weights",
    "attention_weight_grads",
    "rollout_from_weights",
    "relevance_from_grads",
    "attention_rollout",
    "attention_gradient",
]


def _require_capture(model) -> tuple[str, ...]:
    if not getattr(model, "capture_attn", False):
        raise ValueError(
            "attention baselines need the ViT built with capture_attn=True "
            "(models/vit.py) — the stock attention body never materializes "
            "its softmax weights"
        )
    return tuple(model.attention_taps)


def _picked(out: torch.Tensor, y) -> torch.Tensor:
    """The sum of the picked logits (of the whole output when ``y`` is
    None): per-sample gradients then do not depend on the batch size."""
    if y is None:
        return out.sum()
    return out.gather(1, torch.as_tensor(y, device=out.device).long()[:, None]).sum()


def capture_attention_weights(model, x: torch.Tensor, nchw: bool = True) -> torch.Tensor:
    """One forward; the softmax weights (L, B, heads, N, N), class token
    included (N = 1 + tokens), float32 (float64 for a float64 model)."""
    names = _require_capture(model)
    with tap_scope(names) as taps, torch.no_grad():
        module_forward(model, x, nchw)
    return torch.stack([widen(taps[n].detach()) for n in names])


def attention_weight_grads(model, x: torch.Tensor, y, nchw: bool = True):
    """(weights, grads), each (L, B, heads, N, N): ∂(picked-logit sum)/∂A
    at every block's tap, from one forward and one backward."""
    names = _require_capture(model)
    with tap_scope(names) as taps, torch.enable_grad():
        out = module_forward(model, x.detach(), nchw)
        weights = [taps[n] for n in names]
        grads = torch.autograd.grad(_picked(out, y), weights)
    return (torch.stack([widen(w.detach()) for w in weights]),
            torch.stack([widen(g) for g in grads]))


def _cls_row_to_grid(rel_row: torch.Tensor) -> torch.Tensor:
    """(B, N) class-token relevance row -> (B, side, side) patch grid."""
    n = rel_row.shape[-1] - 1
    side = int(n**0.5)
    if side * side != n:
        raise ValueError(f"{n} patch tokens is not a square grid")
    return rel_row[:, 1:].reshape(rel_row.shape[0], side, side)


def rollout_from_weights(weights: torch.Tensor, residual: float = 0.5) -> torch.Tensor:
    """Attention rollout over a (L, B, heads, N, N) stack -> (B, s, s)."""
    a = weights.mean(dim=2)  # (L, B, N, N)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    a = (1.0 - residual) * a + residual * eye
    a = a / a.sum(dim=-1, keepdim=True)
    rollout = eye.expand(a.shape[1:])
    for layer in a:
        rollout = layer @ rollout
    return _cls_row_to_grid(rollout[:, 0, :])


def relevance_from_grads(weights: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """grad x attention relevance over (L, B, heads, N, N) stacks -> (B, s, s)."""
    abar = torch.relu((grads * weights).mean(dim=2))  # (L, B, N, N)
    rel = torch.eye(abar.shape[-1], dtype=abar.dtype, device=abar.device).expand(abar.shape[1:])
    for layer in abar:
        rel = rel + layer @ rel
    return _cls_row_to_grid(rel[:, 0, :])


def _spatial_size(x: torch.Tensor, nchw: bool):
    return x.shape[-2:] if nchw else x.shape[1:3]


def attention_rollout(model, x: torch.Tensor, y=None, nchw: bool = True) -> torch.Tensor:
    """Rollout -> (B, H, W). ``y`` is accepted and ignored (rollout does not
    depend on the class), so the evaluators call every method alike."""
    del y
    grid = rollout_from_weights(capture_attention_weights(model, x, nchw))
    return resize_bilinear(grid, _spatial_size(x, nchw))


def attention_gradient(model, x: torch.Tensor, y, nchw: bool = True) -> torch.Tensor:
    """grad x attention relevance -> (B, H, W)."""
    weights, grads = attention_weight_grads(model, x, y, nchw)
    return resize_bilinear(relevance_from_grads(weights, grads), _spatial_size(x, nchw))
