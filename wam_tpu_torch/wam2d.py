"""WAM-2D: image attribution in the wavelet domain (PyTorch port).

Counterpart of `wam_tpu.wam2d`: single-pass coefficient gradients, SmoothGrad
and Integrated Gradients, the dyadic mosaic output and per-scale
reprojection. The model is a function ``x (B, C, H, W) -> logits (B, K)``
already bound to its device (e.g. `models.resnet.bind_inference`).

On CUDA tensors the transforms run through the port's CUDA kernels (K1 for
every analysis level, K3 for the collapsed synthesis and its adjoint); see
`wam_tpu_torch.wavelets.transform` for the ``impl`` switch.

``model_layout="nhwc"``: the model takes (B, H, W, C)
(``bind_inference(nchw=False)``) and the engine runs channel-last through
the contractions of `wavelets.nhwc` (no port kernel; the reference runs
them as XLA einsums too). The input is transposed once, outside the sample
loop; ``__call__`` takes (B, C, H, W) either way, and so does ``noise=``.
"""

from __future__ import annotations

from typing import Callable

import torch

from wam_tpu_torch.core.engine import WamEngine, map_coeffs
from wam_tpu_torch.core.estimators import (
    integrated_path,
    resolve_sample_chunk,
    smoothgrad,
    validate_sample_batch_size,
)
from wam_tpu_torch.device import resolve_device
from wam_tpu_torch.ops.packing2d import disentangle_scales, mosaic2d, reproject_mosaic

__all__ = ["BaseWAM2D", "WaveletAttribution2D"]


class BaseWAM2D:
    """Single-pass WAM-2D.

    ``__call__(x, y)`` computes the wavelet transform of the batch, the
    gradient of the target logits w.r.t. every coefficient, and returns the
    dyadic gradient mosaic (B, S, S). Also populates ``wavelet_coeffs``,
    ``gradient_coeffs`` and ``scales`` (per-level maps (B, J(+1), S, S)).

    ``device``: where the computation runs; CUDA unless the caller asks
    otherwise (``"cpu"`` runs the plain PyTorch versions). ``impl``: the
    transform implementation (``None`` = kernels on CUDA, conv on CPU;
    ``model_layout="nhwc"`` has one implementation and ignores it).
    """

    def __init__(
        self,
        model_fn: Callable[[torch.Tensor], torch.Tensor],
        wavelet: str = "haar",
        J: int = 3,
        mode: str = "reflect",
        approx_coeffs: bool = False,
        normalize_coeffs: bool = True,
        model_layout: str = "nchw",
        device=None,
        impl: str | None = None,
    ):
        if model_layout not in ("nchw", "nhwc"):
            raise ValueError(f"model_layout must be 'nchw' or 'nhwc', got {model_layout!r}")
        self.device = resolve_device(device)
        self.wavelet = wavelet
        self.J = J
        self.mode = mode
        self.approx_coeffs = approx_coeffs
        self.normalize_coeffs = normalize_coeffs
        self.model_layout = model_layout
        self._caxis = -1 if model_layout == "nhwc" else 1
        self.engine = WamEngine(model_fn, ndim=2, wavelet=wavelet, level=J, mode=mode,
                                channel_last=model_layout == "nhwc", impl=impl)

    def _inputs(self, x, y):
        x = torch.as_tensor(x, device=self.device)
        if y is not None:
            y = torch.as_tensor(y, device=self.device)
        return x, y

    def _to_internal(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW caller layout -> the engine's layout (one contiguous copy for
        NHWC)."""
        return x.permute(0, 2, 3, 1).contiguous() if self.model_layout == "nhwc" else x

    def __call__(self, x, y=None) -> torch.Tensor:
        x, y = self._inputs(x, y)
        coeffs, grads = self.engine.attribute(self._to_internal(x), y)
        self.wavelet_coeffs = coeffs
        self.gradient_coeffs = grads
        self.scales = disentangle_scales(grads, approx_coeffs=self.approx_coeffs,
                                         channel_axis=self._caxis)
        return mosaic2d(grads, self.normalize_coeffs, self._caxis)

    def serve_entry(self, *args, **kwargs):
        raise NotImplementedError("serve_entry is not ported yet (ROADMAP.md, slice F)")

    def disentangle_scales(self, grads, approx_coeffs: bool = False):
        return disentangle_scales(grads, approx_coeffs=approx_coeffs, channel_axis=self._caxis)

    def visualize_grad_wam(self, grads):
        return mosaic2d(grads, self.normalize_coeffs, self._caxis)


class WaveletAttribution2D(BaseWAM2D):
    """SmoothGrad / Integrated-Gradients WAM-2D.

    method="smooth": mean over ``n_samples`` noisy passes with per-image
    sigma = stdev_spread * (max - min). method="integratedgrad": trapezoidal
    path integral over alpha * coeffs, scaled by the normalized
    input-coefficient mosaic.

    ``sample_batch_size`` samples (or IG path points) run as one batch of
    sample_batch_size * B model rows; "auto" and None run them all at once.
    Each sample keeps its own loss scale and mosaic normalization, so the
    result does not depend on the chunk.

    ``dwt_bf16=True`` casts each noisy input to bfloat16 at the transform
    (after the float32 noise is added); the coefficients stay float32.

    SmoothGrad noise: standard-normal draws from a ``torch.Generator`` on
    the device seeded with ``random_seed`` (one stream per call, drawn in
    the engine's layout), or the explicit ``noise`` tensor (n_samples,
    *x.shape), in the caller's NCHW layout, given to ``__call__``.
    ``stream_noise=True`` draws each chunk's noise inside the chunk loop,
    sample i's from (random_seed, i) (`core.estimators.sample_noise`), so
    the (n_samples, *x.shape) buffer is never allocated and the result does
    not depend on the chunk (the draws differ from the materialized ones).
    ``"auto"`` materializes: the reference streams above ~128 MB of noise on
    the TPU only, and no rule for the card has been measured yet.
    """

    def __init__(
        self,
        model_fn: Callable[[torch.Tensor], torch.Tensor],
        wavelet: str = "haar",
        method: str = "smooth",
        J: int = 3,
        mode: str = "reflect",
        approx_coeffs: bool = False,
        normalize_coeffs: bool = True,
        n_samples: int = 25,
        stdev_spread: float = 0.25,
        random_seed: int = 42,
        sample_batch_size: int | None | str = "auto",
        dwt_bf16: bool = False,
        stream_noise: bool | str = False,
        model_layout: str = "nchw",
        mesh=None,
        device=None,
        impl: str | None = None,
    ):
        if mesh is not None:
            raise NotImplementedError("mesh= is not ported yet (ROADMAP.md, slice E)")
        super().__init__(model_fn, wavelet=wavelet, J=J, mode=mode,
                         approx_coeffs=approx_coeffs, normalize_coeffs=normalize_coeffs,
                         model_layout=model_layout, device=device, impl=impl)
        if method not in ("smooth", "integratedgrad"):
            raise ValueError(f"Unknown method {method!r}")
        validate_sample_batch_size(sample_batch_size)
        if stream_noise not in (True, False, "auto"):
            raise ValueError(f"stream_noise must be a bool or 'auto', got {stream_noise!r}")
        self.method = method
        self.dwt_bf16 = dwt_bf16
        self.n_samples = n_samples
        self.stdev_spread = stdev_spread
        self.random_seed = random_seed
        self.sample_batch_size = sample_batch_size
        self.stream_noise = stream_noise is True

    def _chunk(self) -> int | None:
        return resolve_sample_chunk(self.sample_batch_size, self.n_samples)

    def _mosaic_of_grads(self, coeffs, y, spatial, s: int) -> torch.Tensor:
        """Gradient mosaics of ``s`` stacked copies: coefficient leaves are
        (s*B, C, h, w), sample-major; returns (s, B, S, S)."""
        grads = self.engine.grads_from_coeffs(coeffs, y.repeat(s) if y is not None else None,
                                              spatial, samples=s)
        grads = map_coeffs(lambda g: g.reshape((s, -1) + tuple(g.shape[1:])), grads)
        return mosaic2d(grads, self.normalize_coeffs, self._caxis)

    # -- SmoothGrad --------------------------------------------------------

    def smooth_wam(self, x, y, noise=None) -> torch.Tensor:
        x, y = self._inputs(x, y)
        x = self._to_internal(x)  # once, outside the sample loop
        if noise is not None and self.model_layout == "nhwc":
            noise = torch.as_tensor(noise).permute(0, 1, 3, 4, 2)
        spatial = self.engine.spatial_shape(x.shape)

        def step(noisy: torch.Tensor) -> torch.Tensor:  # (s, B, C, H, W)
            s = noisy.shape[0]
            flat = noisy.reshape((-1,) + tuple(noisy.shape[2:]))
            if self.dwt_bf16:
                flat = flat.to(torch.bfloat16)
            with torch.no_grad():
                coeffs = self.engine.decompose(flat)
            return self._mosaic_of_grads(coeffs, y, spatial, s)

        generator = None
        if noise is None and not self.stream_noise:
            generator = torch.Generator(device=self.device).manual_seed(self.random_seed)
        avg = smoothgrad(step, x, n_samples=self.n_samples, stdev_spread=self.stdev_spread,
                         batch_size=self._chunk(), generator=generator, noise=noise,
                         materialize_noise=not self.stream_noise, seed=self.random_seed)
        self.scales = reproject_mosaic(avg, self.J, self.approx_coeffs)
        return avg

    # -- Integrated gradients ---------------------------------------------

    def integrated_wam(self, x, y) -> torch.Tensor:
        x, y = self._inputs(x, y)
        x = self._to_internal(x)
        if self.dwt_bf16:
            x = x.to(torch.bfloat16)
        with torch.no_grad():
            coeffs = self.engine.decompose(x)
        baseline = mosaic2d(coeffs, normalize=True, channel_axis=self._caxis)
        spatial = self.engine.spatial_shape(x.shape)

        def grad_fn(alphas: torch.Tensor) -> torch.Tensor:  # (s,)
            s = alphas.shape[0]
            scaled = map_coeffs(
                lambda c: (c[None] * alphas.to(c.dtype).reshape(-1, 1, 1, 1, 1))
                .reshape((-1,) + tuple(c.shape[1:])), coeffs)
            return self._mosaic_of_grads(scaled, y, spatial, s)

        integral = integrated_path(grad_fn, n_steps=self.n_samples,
                                   batch_size=self._chunk(), device=self.device)
        attr = baseline * integral
        self.scales = reproject_mosaic(attr, self.J, self.approx_coeffs)
        return attr

    def __call__(self, x, y, noise=None) -> torch.Tensor:
        if self.method == "smooth":
            return self.smooth_wam(x, y, noise)
        if noise is not None:
            raise ValueError("noise= applies to method='smooth' only")
        return self.integrated_wam(x, y)

    def anytime_serve_entry(self, *args, **kwargs):
        raise NotImplementedError("anytime_serve_entry is not ported yet (ROADMAP.md, slice D)")
