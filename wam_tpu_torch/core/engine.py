"""Core gradient engine: d logit_y / d wavelet-coefficients (PyTorch).

Counterpart of `wam_tpu.core.engine` for 2D NCHW inputs: the coefficients
of ``wavedec2`` become detached leaf tensors, the reconstruction feeds the
model, and `torch.autograd.grad` of the target loss returns one gradient per
coefficient, in the coefficients' own structure.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

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
        out.extend(det)
    return out


def _unflatten(leaves: Sequence[torch.Tensor]) -> list:
    it = iter(leaves)
    out = [next(it)]
    for h in it:
        out.append(wt.Detail2D(h, next(it), next(it)))
    return out


def map_coeffs(fn, coeffs) -> list:
    """Apply ``fn`` to every coefficient tensor, keeping the structure."""
    return _unflatten([fn(c) for c in _flatten(coeffs)])


class WamEngine:
    """Single-pass wavelet attribution for 2D NCHW inputs.

    Parameters
    ----------
    model_fn : callable mapping the reconstructed (B, C, H, W) batch to
        logits (B, K).
    ndim : spatial rank; only 2 is ported.
    impl : the transform implementation (`wavelets.transform`); ``None``
        picks the CUDA kernels for CUDA tensors and the conv form for CPU
        tensors.
    """

    def __init__(
        self,
        model_fn: Callable[[torch.Tensor], torch.Tensor],
        *,
        ndim: int,
        wavelet: str = "haar",
        level: int = 3,
        mode: str = "reflect",
        channel_last: bool = False,
        impl: str | None = None,
    ):
        if ndim != 2:
            raise NotImplementedError(f"ndim={ndim}: only the 2D engine is ported")
        if channel_last:
            raise NotImplementedError("channel_last: only the NCHW engine is ported")
        if impl is not None and impl not in wt.IMPLS:
            raise ValueError(f"impl {impl!r} not one of {wt.IMPLS}")
        self.model_fn = model_fn
        self.ndim = ndim
        self.wavelet = wavelet
        self.level = level
        self.mode = mode
        self.impl = impl

    def decompose(self, x: torch.Tensor):
        return wt.wavedec2(x, self.wavelet, self.level, self.mode, impl=self.impl)

    def reconstruct(self, coeffs, spatial_shape: Sequence[int]) -> torch.Tensor:
        rec = wt.waverec2(coeffs, self.wavelet, impl=self.impl)
        # the reconstruction is >= the original for non-haar filters / odd
        # sizes; crop to the model's spatial shape
        return rec[..., : spatial_shape[0], : spatial_shape[1]]

    def grads_from_coeffs(self, coeffs, y, spatial_shape, samples: int = 1) -> list:
        """Gradient of the target loss w.r.t. every coefficient, in the
        coefficients' structure.

        ``samples`` > 1 means the rows hold that many stacked copies of one
        batch (sample-major, ``y`` repeated to match): the loss is then the
        SUM over copies of each copy's batch mean, so every coefficient gets
        exactly its own copy's gradient."""
        leaves = [c.detach().requires_grad_(True) for c in _flatten(coeffs)]
        with torch.enable_grad():
            out = self.model_fn(self.reconstruct(_unflatten(leaves), spatial_shape))
            loss = target_loss(out, y) * samples
            grads = torch.autograd.grad(loss, leaves)
        return _unflatten(grads)

    def spatial_shape(self, x_shape) -> tuple:
        return tuple(x_shape[-2:])

    def attribute(self, x: torch.Tensor, y: torch.Tensor | None, samples: int = 1):
        """Full single pass: decompose -> grads. Returns (coeffs, grads)."""
        with torch.no_grad():
            coeffs = self.decompose(x)
        grads = self.grads_from_coeffs(coeffs, y, self.spatial_shape(x.shape), samples)
        return coeffs, grads
