"""Baseline attribution methods (PyTorch port of `wam_tpu.evalsuite.baselines`).

Every method maps (x, y) to a (B, H, W) map in the input's own domain:

- `saliency`: |d logit_y / d x|, channel-averaged;
- `integrated_gradients`: x times the mean gradient along the path from
  zero to x (Riemann, ``linspace(0, 1, n_steps)``), channel-averaged;
- `smoothgrad_pixel`: |mean gradient| over noisy copies, per-image sigma;
- `gradcam`, `gradcam_pp`, `layercam`: activation-tap methods on the
  models' taps (`models.layers.tap`), bilinearly resized to the input;
- `guided_backprop` (`guided_relu` in place of every ``act``),
  `gradient_x_input`;
- `lrp_eps` (the ε-rule through ``post_linear``, `make_eps_tap`) and `lrp`
  (the EpsilonPlusFlat walker of `evalsuite.lrp` on ResNets);
- `attention_rollout`, `attention_gradient` on a ViT built with
  ``capture_attn=True`` (`xattr.attention`).

Gradients are of `core.engine.target_loss` (the batch mean of the picked
logits), as the reference's are. The functions on a model function take
any ``x -> logits`` callable; those that need the module (taps, ``act``,
``post_linear``) take the `nn.Module`, which carries its weights (the
reference passes flax variables beside it), run it at its own dtype with
the input cast at its boundary and return float32 maps. A module's
attribute swap (``act``, ``post_linear``) lasts the call only and is undone
when it raises. Path points and noisy copies run in groups of
``sample_batch_size`` (None: all at once) in one model call each, where the
reference maps them one at a time; the sum order changes, within rounding.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.nn.functional as F

from wam_tpu_torch.core.engine import target_loss
from wam_tpu_torch.core.estimators import noise_sigma
from wam_tpu_torch.models.layers import tap_scope

__all__ = [
    "saliency",
    "integrated_gradients",
    "smoothgrad_pixel",
    "gradcam",
    "gradcam_pp",
    "layercam",
    "guided_relu",
    "guided_backprop",
    "gradient_x_input",
    "make_eps_tap",
    "lrp_eps",
    "lrp",
    "attention_rollout",
    "attention_gradient",
    "module_forward",
    "swapped",
    "resize_bilinear",
]

# -- forwards and gradients ---------------------------------------------------------


def _param_dtype(model: torch.nn.Module) -> torch.dtype:
    for p in model.parameters():
        if p.is_floating_point():
            return p.dtype
    return torch.float32


def widen(t: torch.Tensor) -> torch.Tensor:
    """A low-precision tensor as float32; float32 and float64 as they are."""
    return t if t.dtype in (torch.float32, torch.float64) else t.float()


def module_forward(model: torch.nn.Module, x: torch.Tensor, nchw: bool = True) -> torch.Tensor:
    """``model`` on ``x`` at the module's own dtype: a channels-last image
    batch (``nchw=False``) permuted to channels-first, the input cast to the
    module's parameter dtype, the first output of a tuple, logits widened
    to float32 (a float64 module's stay float64)."""
    if not nchw:
        x = x.permute(0, 3, 1, 2)
    out = model(x.to(_param_dtype(model)))
    return widen(out[0] if isinstance(out, tuple) else out)


def _input_grads(model_fn: Callable, x: torch.Tensor, y) -> torch.Tensor:
    """d target_loss(model_fn(x), y) / dx."""
    leaf = x.detach().requires_grad_()
    with torch.enable_grad():
        loss = target_loss(model_fn(leaf), y)
        return torch.autograd.grad(loss, leaf)[0]


def _grouped_input_grads(model_fn: Callable, xs: torch.Tensor, y,
                         sample_batch_size: int | None) -> torch.Tensor:
    """Each group's input gradient, ``xs`` (n, B, ...): groups of
    ``sample_batch_size`` run as one model call of k * B rows, their
    gradients those of the per-group `target_loss` (summed over the
    groups, each group's gradient is its own)."""
    n, B = xs.shape[:2]
    k = n if sample_batch_size is None else max(1, min(int(sample_batch_size), n))
    grads = []
    for start in range(0, n, k):
        chunk = xs[start:start + k]
        m = chunk.shape[0]
        leaf = chunk.detach().reshape((m * B,) + tuple(xs.shape[2:])).requires_grad_()
        with torch.enable_grad():
            out = model_fn(leaf).reshape(m, B, -1)
            if y is None:
                loss = out.mean(dim=(1, 2)).sum()
            else:
                idx = y.reshape(1, B, 1).long().expand(m, B, 1)
                loss = out.gather(2, idx)[..., 0].mean(dim=1).sum()
            grads.append(torch.autograd.grad(loss, leaf)[0].reshape(chunk.shape))
    return grads[0] if len(grads) == 1 else torch.cat(grads)


def saliency(model_fn: Callable, x: torch.Tensor, y) -> torch.Tensor:
    """|grad| averaged over channels -> (B, H, W)."""
    return _input_grads(model_fn, x, y).abs().mean(dim=1)


def integrated_gradients(model_fn: Callable, x: torch.Tensor, y, n_steps: int = 25,
                         sample_batch_size: int | None = None) -> torch.Tensor:
    """x times the mean gradient along the zero-to-x path (Riemann, the
    path points ``linspace(0, 1, n_steps)``), channel-averaged."""
    alphas = torch.linspace(0.0, 1.0, n_steps, dtype=x.dtype, device=x.device)
    path = alphas.reshape((-1,) + (1,) * x.ndim) * x[None]
    grads = _grouped_input_grads(model_fn, path, y, sample_batch_size)
    return (x * grads.mean(dim=0)).mean(dim=1)


def smoothgrad_pixel(model_fn: Callable, x: torch.Tensor, y, generator=None,
                     n_samples: int = 25, stdev_spread: float = 0.25, *,
                     noise: torch.Tensor | None = None,
                     sample_batch_size: int | None = None) -> torch.Tensor:
    """|mean gradient| over ``n_samples`` noisy copies, channel-averaged; the
    noise of image i has sigma_i = stdev_spread * (max x_i - min x_i).
    ``generator``: a `torch.Generator` on x's device, or an int seed for
    one; ``noise`` (n_samples, *x.shape) hands over unit-normal draws
    instead (the tests give the reference's own)."""
    sigma = noise_sigma(x, stdev_spread).reshape((-1,) + (1,) * (x.ndim - 1))
    if noise is None:
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator(device=x.device).manual_seed(int(generator or 0))
        noise = torch.randn((n_samples,) + tuple(x.shape), generator=generator,
                            device=x.device, dtype=x.dtype)
    grads = _grouped_input_grads(model_fn, x[None] + noise.to(x) * sigma, y, sample_batch_size)
    return grads.mean(dim=0).abs().mean(dim=1)


def gradient_x_input(model_fn: Callable, x: torch.Tensor, y) -> torch.Tensor:
    """x times d logit_y / dx, channel-averaged -> (B, H, W)."""
    return (x * _input_grads(model_fn, x, y)).mean(dim=1)


# -- the GradCAM family --------------------------------------------------------------


def _acts_and_grads(model, x: torch.Tensor, y, layer: str, nchw: bool):
    """A forward under a tap scope, then the gradient of the SUM of the
    picked logits (the whole output's sum when ``y`` is None) with respect
    to the tapped activation: per-sample gradients then do not depend on
    the batch. Returns (activations, gradients), widened, (B, C, h, w); a
    token tap (B, 1 + N, D) loses its class token and folds its N patch
    tokens onto their sqrt(N) x sqrt(N) grid."""
    with tap_scope((layer,)) as taps, torch.enable_grad():
        out = module_forward(model, x.detach(), nchw)
        if layer not in taps.records:
            raise ValueError(f"Model has no activation tap {layer!r}; "
                             f"{type(model).__name__} taps {getattr(model, 'TAPS', ())}")
        if y is None:
            loss = out.sum()
        else:
            loss = out.gather(1, torch.as_tensor(y, device=out.device).long()[:, None]).sum()
        rec = taps.records[layer]
        g = torch.autograd.grad(loss, rec.tensor)[0]
    acts, g = widen(rec.tensor.detach()), widen(g)
    if acts.ndim == 3:
        n = acts.shape[1] - 1
        side = int(n**0.5)
        if side * side != n:
            raise ValueError(f"token tap {layer!r} has {n} patch tokens, not a square grid")
        acts = acts[:, 1:].reshape(acts.shape[0], side, side, acts.shape[-1])
        g = g[:, 1:].reshape(g.shape[0], side, side, g.shape[-1])
        return acts.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    if rec.channels_last:
        return acts.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    return acts, g


def resize_bilinear(cam: torch.Tensor, hw) -> torch.Tensor:
    """(B, h, w) -> (B, *hw), bilinear with half-pixel centers and edge
    clamping: the values of ``jax.image.resize(..., "bilinear")`` when
    upsampling."""
    out = F.interpolate(cam[:, None], size=tuple(int(s) for s in hw), mode="bilinear",
                        align_corners=False, antialias=False)
    return out[:, 0]


def _spatial_size(x: torch.Tensor, nchw: bool):
    return x.shape[-2:] if nchw else x.shape[1:3]


def gradcam(model, x: torch.Tensor, y, layer: str = "stage4", nchw: bool = True) -> torch.Tensor:
    """ReLU(sum_c w_c A_c), w the spatial mean of the gradients."""
    acts, grads = _acts_and_grads(model, x, y, layer, nchw)
    w = grads.mean(dim=(2, 3), keepdim=True)
    return resize_bilinear(torch.relu((w * acts).sum(dim=1)), _spatial_size(x, nchw))


def gradcam_pp(model, x: torch.Tensor, y, layer: str = "stage4",
               nchw: bool = True) -> torch.Tensor:
    """GradCAM++: alpha = g^2 / (2 g^2 + sum_hw A g^3), w = sum_hw alpha relu(g)."""
    acts, grads = _acts_and_grads(model, x, y, layer, nchw)
    g2, g3 = grads**2, grads**3
    denom = 2.0 * g2 + (acts * g3).sum(dim=(2, 3), keepdim=True)
    alpha = g2 / torch.where(denom == 0, 1.0, denom)
    w = (alpha * torch.relu(grads)).sum(dim=(2, 3), keepdim=True)
    return resize_bilinear(torch.relu((w * acts).sum(dim=1)), _spatial_size(x, nchw))


def layercam(model, x: torch.Tensor, y, layer: str = "stage3", nchw: bool = True) -> torch.Tensor:
    """LayerCAM: ReLU(sum_c relu(g) A), a positional weighting."""
    acts, grads = _acts_and_grads(model, x, y, layer, nchw)
    cam = torch.relu((torch.relu(grads) * acts).sum(dim=1))
    return resize_bilinear(cam, _spatial_size(x, nchw))


# -- modified backward rules -----------------------------------------------------------


@contextlib.contextmanager
def swapped(model: torch.nn.Module, attr: str, value):
    """Set ``attr`` to ``value`` on every submodule that has it, for the
    ``with`` block only; the old values come back even when it raises."""
    saved = [(m, getattr(m, attr)) for m in model.modules() if hasattr(m, attr)]
    try:
        for m, _ in saved:
            setattr(m, attr, value)
        yield model
    finally:
        for m, old in saved:
            setattr(m, attr, old)


class _GuidedReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where((x > 0) & (g > 0), g, torch.zeros_like(g))


def guided_relu(x: torch.Tensor) -> torch.Tensor:
    """ReLU whose backward passes only positive gradients at positive inputs
    (Springenberg et al. 2014)."""
    return _GuidedReLU.apply(x)


def guided_backprop(model, x: torch.Tensor, y, nchw: bool = True) -> torch.Tensor:
    """Input gradients with `guided_relu` as every ``act`` of ``model`` for
    this call (parameters untouched), channel-averaged |grad|. Needs a ReLU
    model with an ``act`` attribute (the ResNets; the GELU models and the
    AudioCNN have none)."""
    if not hasattr(model, "act"):
        raise ValueError(
            f"guided_backprop needs a model with a swappable `act` attribute; "
            f"{type(model).__name__} has none (use a ReLU model such as the ResNet zoo, "
            "or add an `act` attribute to the module)")
    with swapped(model, "act", guided_relu):
        return _input_grads(lambda v: module_forward(model, v, nchw), x, y).abs().mean(dim=1)


class _EpsTap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, eps):
        ctx.save_for_backward(z)
        ctx.eps = eps
        return z.view_as(z)

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        denom = z + ctx.eps * torch.sign(z)
        return g * z / torch.where(denom == 0, 1.0, denom), None


def make_eps_tap(eps: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """An identity whose backward applies the LRP ε-rule rescale,
    g -> g z / (z + ε sign z) (a zero denominator counts as 1). Set as
    ``post_linear`` after every linear(+BatchNorm) output, it turns the
    input gradient into ε-LRP for ReLU networks (see the reference)."""

    def eps_tap(z: torch.Tensor) -> torch.Tensor:
        return _EpsTap.apply(z, eps)

    return eps_tap


def lrp_eps(model, x: torch.Tensor, y, eps: float = 1e-6, nchw: bool = True) -> torch.Tensor:
    """Pure ε-rule LRP through ``post_linear`` (`make_eps_tap`), seeded with
    a one-hot at the picked class (each picked logit divided by its
    stabilized, gradient-free self), harvested as x times the gradient,
    summed over channels. The module runs at its own dtype: in bfloat16
    the ε stabilizer vanishes (use `lrp` on a ResNet, which runs float32)."""
    if not hasattr(model, "post_linear"):
        raise ValueError(
            f"lrp_eps needs a model with a `post_linear` hook; {type(model).__name__} has "
            "none (the ResNet zoo provides it)")
    leaf = x.detach().requires_grad_()
    with swapped(model, "post_linear", make_eps_tap(eps)), torch.enable_grad():
        out = module_forward(model, leaf, nchw)
        yy = torch.as_tensor(y, device=out.device).long()
        picked = out.gather(1, yy[:, None])[:, 0]
        denom = (picked + eps * torch.sign(picked)).detach()
        loss = (picked / torch.where(denom == 0, 1.0, denom)).sum()
        grads = torch.autograd.grad(loss, leaf)[0]
    return (x * grads).sum(dim=1 if nchw else -1)


def lrp(model, x: torch.Tensor, y, eps: float = 1e-6, nchw: bool = True) -> torch.Tensor:
    """LRP as the reference's registry runs it: on a ResNet the
    EpsilonPlusFlat walker (`evalsuite.lrp.lrp_resnet`), on another model
    with ``post_linear`` the pure ε-rule (`lrp_eps`), which raises where
    there is none."""
    from wam_tpu_torch.evalsuite.lrp import lrp_resnet
    from wam_tpu_torch.models.resnet import ResNet

    if isinstance(model, ResNet):
        return lrp_resnet(model, x, y, eps=eps, nchw=nchw)
    return lrp_eps(model, x, y, eps=eps, nchw=nchw)


def attention_rollout(model, x: torch.Tensor, y=None, nchw: bool = True) -> torch.Tensor:
    """Attention rollout (Abnar & Zuidema 2020) of a ViT built with
    ``capture_attn=True``: `xattr.attention.attention_rollout`."""
    from wam_tpu_torch.xattr.attention import attention_rollout as impl

    return impl(model, x, y, nchw=nchw)


def attention_gradient(model, x: torch.Tensor, y, nchw: bool = True) -> torch.Tensor:
    """grad x attention relevance (Chefer et al. 2021) of a ViT built with
    ``capture_attn=True``: `xattr.attention.attention_gradient`."""
    from wam_tpu_torch.xattr.attention import attention_gradient as impl

    return impl(model, x, y, nchw=nchw)
