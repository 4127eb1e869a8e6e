"""Core gradient engine: d logit_y / d wavelet-coefficients (PyTorch).

Counterpart of `wam_tpu.core.engine` for 1D signals, 2D inputs (NCHW, or
NHWC with ``channel_last=True``) and 3D volumes: the coefficients of
``wavedec`` / ``wavedec2`` (``wavelets.nhwc.wavedec2_nhwc``) / ``wavedec3``
become detached leaf tensors, the
reconstruction feeds the model (through an optional differentiable
``front_fn``, the 1D mel front end), and `torch.autograd.grad` of the target
loss returns one gradient per coefficient, in the coefficients' own
structure, and with ``front=True`` the gradient at the front end's output
from the same backward pass.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from wam_tpu_torch.wavelets import nhwc
from wam_tpu_torch.wavelets import transform as wt

__all__ = ["WamEngine", "target_loss"]


def target_loss(output: torch.Tensor, y: torch.Tensor | None) -> torch.Tensor:
    """Scalar objective: mean over the batch of logit[i, y[i]], or the mean
    of the whole output when y is None (representation mode)."""
    if y is None:
        return output.mean()
    return output.gather(1, y.reshape(-1, 1).long())[:, 0].mean()


def _flatten(coeffs) -> list[torch.Tensor]:
    out = [coeffs[0]]
    for det in coeffs[1:]:
        if isinstance(det, wt.Detail2D):
            out.extend(det)
        elif isinstance(det, dict):
            out.extend(det[k] for k in wt.DETAIL3D_KEYS)
        else:
            out.append(det)
    return out


def _unflatten(leaves: Sequence[torch.Tensor], like) -> list:
    """``leaves`` in the structure of the coefficients ``like``."""
    it = iter(leaves)
    out = [next(it)]
    for det in like[1:]:
        if isinstance(det, wt.Detail2D):
            out.append(wt.Detail2D(next(it), next(it), next(it)))
        elif isinstance(det, dict):
            out.append({k: next(it) for k in wt.DETAIL3D_KEYS})
        else:
            out.append(next(it))
    return out


def map_coeffs(fn, coeffs) -> list:
    """Apply ``fn`` to every coefficient tensor, keeping the structure."""
    return _unflatten([fn(c) for c in _flatten(coeffs)], coeffs)


class WamEngine:
    """Single-pass wavelet attribution for 1D signals (..., W), 2D inputs
    (..., H, W), or (B, H, W, C) with ``channel_last``, or 3D volumes (...,
    D, H, W).

    Parameters
    ----------
    model_fn : callable mapping the reconstructed batch (or the front end's
        output, when ``front_fn`` is given) to logits (B, K).
    ndim : spatial rank: 1 (audio), 2 (image) or 3 (volume; the model gets
        the reconstruction (B, D, H, W) as it is, and adds its own channel
        axis, as `wam3d` does).
    front_fn : optional differentiable map between the reconstruction and
        the model (the 1D mel front end); ``front=True`` also returns the
        gradient at its output.
    channel_last : 2D only: inputs and reconstructions are NHWC (B, H, W, C)
        and ``model_fn`` takes NHWC (``bind_inference(nchw=False)``); the
        transforms are the contractions of `wavelets.nhwc`, the one
        implementation of that layout, so ``impl`` does not apply.
    impl : the 2D transform implementation, or the 3D synthesis's
        (`wavelets.transform`); ``None`` picks the CUDA kernels for CUDA
        tensors and the conv form for CPU tensors (3D: the conv form on
        every device). The 1D transform has one implementation.
    """

    def __init__(
        self,
        model_fn: Callable[[torch.Tensor], torch.Tensor],
        *,
        ndim: int,
        wavelet: str = "haar",
        level: int = 3,
        mode: str = "reflect",
        front_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
        channel_last: bool = False,
        impl: str | None = None,
    ):
        if ndim not in (1, 2, 3):
            raise ValueError(f"ndim must be 1, 2 or 3, got {ndim}")
        if channel_last and ndim != 2:
            raise ValueError("channel_last is only supported for ndim=2")
        if impl is not None and impl not in wt.IMPLS:
            raise ValueError(f"impl {impl!r} not one of {wt.IMPLS}")
        self.model_fn = model_fn
        self.ndim = ndim
        self.wavelet = wavelet
        self.level = level
        self.mode = mode
        self.front_fn = front_fn
        self.channel_last = channel_last
        self.impl = impl

    def decompose(self, x: torch.Tensor):
        if self.channel_last:
            return nhwc.wavedec2_nhwc(x, self.wavelet, self.level, self.mode)
        if self.ndim == 1:
            return wt.wavedec(x, self.wavelet, self.level, self.mode)
        if self.ndim == 3:
            return wt.wavedec3(x, self.wavelet, self.level, self.mode)
        return wt.wavedec2(x, self.wavelet, self.level, self.mode, impl=self.impl)

    def reconstruct(self, coeffs, spatial_shape: Sequence[int],
                    synth_impl: str | None = None) -> torch.Tensor:
        """The inverse transform cropped to ``spatial_shape``; ``synth_impl``
        (2D and 3D) is this call's synthesis impl in place of ``impl``."""
        # the reconstruction is >= the original for non-haar filters / odd
        # sizes; crop to the model's spatial shape
        synth = self.impl if synth_impl is None else synth_impl
        if self.channel_last:
            rec = nhwc.waverec2_nhwc(coeffs, self.wavelet)
            return rec[..., : spatial_shape[0], : spatial_shape[1], :]
        if self.ndim == 1:
            return wt.waverec(coeffs, self.wavelet)[..., : spatial_shape[0]]
        if self.ndim == 3:
            rec = wt.waverec3(coeffs, self.wavelet, impl=synth)
            return rec[..., : spatial_shape[0], : spatial_shape[1], : spatial_shape[2]]
        rec = wt.waverec2(coeffs, self.wavelet, impl=synth)
        return rec[..., : spatial_shape[0], : spatial_shape[1]]

    def grads_from_coeffs(self, coeffs, y, spatial_shape, samples: int = 1,
                          front: bool = False, synth_impl: str | None = None, anchor=None):
        """Gradient of the target loss w.r.t. every coefficient, in the
        coefficients' structure; with ``front=True`` the pair (those
        gradients, the gradient at the front end's output), both from one
        backward pass.

        ``samples`` > 1 means the rows hold that many stacked copies of one
        batch (sample-major, ``y`` repeated to match): the loss is then the
        SUM over copies of each copy's batch mean, so every coefficient gets
        exactly its own copy's gradient. ``synth_impl``: `reconstruct`'s.

        ``anchor`` (a 0-d zero tensor that requires grad) makes the leaves
        ``coefficient + anchor`` in place of detached copies made to require
        grad: the form a compiled graph (`pipeline.aot`) takes, since Dynamo
        does not trace ``requires_grad_``; the gradients are the same."""
        if front and self.front_fn is None:
            raise ValueError("front=True requires front_fn")
        with torch.enable_grad():
            if anchor is None:
                leaves = [c.detach().requires_grad_(True) for c in _flatten(coeffs)]
            else:
                leaves = [c.detach() + anchor for c in _flatten(coeffs)]
            feats = self.reconstruct(_unflatten(leaves, coeffs), spatial_shape, synth_impl)
            if self.front_fn is not None:
                feats = self.front_fn(feats)
            loss = target_loss(self.model_fn(feats), y) * samples
            grads = torch.autograd.grad(loss, leaves + [feats] if front else leaves)
        if front:
            return _unflatten(grads[:-1], coeffs), grads[-1]
        return _unflatten(grads, coeffs)

    def spatial_shape(self, x_shape) -> tuple:
        """The transform's spatial dims of an input shape (layout-aware)."""
        if self.channel_last:
            return tuple(x_shape[-3:-1])
        return tuple(x_shape[-self.ndim:])

    def attribute(self, x: torch.Tensor, y: torch.Tensor | None, samples: int = 1,
                  anchor=None):
        """Full single pass: decompose -> grads. Returns (coeffs, grads).
        ``anchor``: `grads_from_coeffs`'."""
        with torch.no_grad():
            coeffs = self.decompose(x)
        grads = self.grads_from_coeffs(coeffs, y, self.spatial_shape(x.shape), samples,
                                       anchor=anchor)
        return coeffs, grads

    def attribute_with_health(self, x: torch.Tensor, y: torch.Tensor | None,
                              samples: int = 1, anchor=None):
        """`attribute` plus the gradient tree's numeric-health vector
        (`wam_tpu_torch.obs.health.health_stats` over the coefficient
        gradients: the per-call grad-norm / NaN-Inf summary), computed on
        the device behind the gradients so health-fused serving entries
        carry it in the result fetch they already make. Returns
        ``(coeffs, grads, health_vec)``."""
        from wam_tpu_torch.obs.health import health_stats

        coeffs, grads = self.attribute(x, y, samples, anchor)
        return coeffs, grads, health_stats(grads)

    def attribute_with_front_grads(self, x: torch.Tensor, y: torch.Tensor | None,
                                   samples: int = 1):
        """Like `attribute`, also returning the gradient at the front end's
        output (the reference's mel tap): one backward pass gives both, with
        the front end's output as one more input of `torch.autograd.grad`.
        Returns (coeffs, coefficient grads, front grads)."""
        with torch.no_grad():
            coeffs = self.decompose(x)
        grads, g_front = self.grads_from_coeffs(coeffs, y, self.spatial_shape(x.shape),
                                                samples, front=True)
        return coeffs, grads, g_front
