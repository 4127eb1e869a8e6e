"""WAM-2D: image attribution in the wavelet domain (PyTorch port).

Counterpart of `wam_tpu.wam2d`: single-pass coefficient gradients, SmoothGrad
and Integrated Gradients, the dyadic mosaic output and per-scale
reprojection. The model is a function ``x (B, C, H, W) -> logits (B, K)``
already bound to its device (e.g. `models.resnet.bind_inference`).

On CUDA tensors the transforms run through the port's CUDA kernels (K1 for
every analysis level, K3 for the collapsed synthesis and its adjoint); see
`wam_tpu_torch.wavelets.transform` for the ``impl`` switch.

``level_plan="patch"`` (with ``patch=`` and ``image_size=``) takes J from the
ViT patch grid (`xattr.planner.plan_patch_levels`: 224 px, patch 16 -> J=4,
the level-4 cells one token each) instead of ``J``, and keeps the plan as
``patch_plan`` for `analyzers.WAMAnalyzerViT`.

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
    noise_sigma,
    resolve_checkpoint_stride,
    resolve_sample_chunk,
    sample_noise,
    smoothgrad,
    trapezoid,
    validate_sample_batch_size,
)
from wam_tpu_torch.device import resolve_device
from wam_tpu_torch.ops.packing2d import (
    disentangle_scales,
    leaf_maxima,
    mosaic2d,
    mosaic_regions,
    normalize_mosaic,
    reproject_mosaic,
)

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
    ``level_plan``: ``"explicit"`` (J as given) or ``"patch"`` (J planned
    from ``patch`` and ``image_size``, validated here, before any call).
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
        level_plan: str = "explicit",
        patch: int = 16,
        image_size: int | None = None,
    ):
        if model_layout not in ("nchw", "nhwc"):
            raise ValueError(f"model_layout must be 'nchw' or 'nhwc', got {model_layout!r}")
        if level_plan not in ("explicit", "patch"):
            raise ValueError(f"level_plan must be 'explicit' or 'patch', got {level_plan!r}")
        self.level_plan = level_plan
        self.patch_plan = None
        if level_plan == "patch":
            from wam_tpu_torch.xattr.planner import plan_patch_levels

            if image_size is None:
                raise ValueError("level_plan='patch' requires image_size=")
            self.patch_plan = plan_patch_levels(image_size, patch, wavelet)
            J = self.patch_plan.J
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

    def serve_entry(self, donate: bool | None = None, on_trace=None,
                    aot_key: str | None = None, with_health: bool = False):
        """Batched serving entry ``(x, y) -> mosaic (B, S, S)`` for the
        `wam_tpu_torch.serve` worker: no instance-attribute stashing (unlike
        ``__call__``), so it is safe to call from the worker thread.
        ``donate`` / ``on_trace`` / ``aot_key`` go to `serve.entry.jit_entry`
        (the staged batch released on the card, first-call counting; an AOT
        key raises until slice E). ``with_health=True`` computes the
        numeric-health vector in the same call — mosaic saturation/max plus
        the coefficient-gradient norm and pooled NaN/Inf counts
        (`WamEngine.attribute_with_health`), zero extra fetches."""
        from wam_tpu_torch.serve.entry import jit_entry

        if with_health:
            from wam_tpu_torch.obs.health import combine_output_grads, health_stats

            def impl(x, y):
                x, y = self._inputs(x, y)
                _, grads, gvec = self.engine.attribute_with_health(self._to_internal(x), y)
                m = mosaic2d(grads, self.normalize_coeffs, self._caxis)
                return m, combine_output_grads(health_stats(m), gvec)

            return jit_entry(impl, donate=donate, on_trace=on_trace, aot_key=aot_key,
                             with_health="fused")

        def impl(x, y):
            x, y = self._inputs(x, y)
            _, grads = self.engine.attribute(self._to_internal(x), y)
            return mosaic2d(grads, self.normalize_coeffs, self._caxis)

        return jit_entry(impl, donate=donate, on_trace=on_trace, aot_key=aot_key)

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

    ``mesh=`` shards the image ROW axis over the mesh's ``seq_axis``
    (`parallel.SeqShardedWam`; ``batch_axis`` splits the batch too,
    ``seq_fused`` is its ``fused``): the transforms, the coefficient blocks
    and their gradients stay in blocks, the model runs on the gathered
    reconstruction, and each sample's mosaic is packed from the gathered
    gradients. SmoothGrad noise there is sample i's ``sample_noise(
    random_seed, i)`` (the ``stream_noise=True`` stream) or the handed
    ``noise``.
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
        seq_axis: str = "data",
        batch_axis: str | None = None,
        seq_fused: bool | str = "auto",
        device=None,
        impl: str | None = None,
        level_plan: str = "explicit",
        patch: int = 16,
        image_size: int | None = None,
    ):
        super().__init__(model_fn, wavelet=wavelet, J=J, mode=mode,
                         approx_coeffs=approx_coeffs, normalize_coeffs=normalize_coeffs,
                         model_layout=model_layout, device=device, impl=impl,
                         level_plan=level_plan, patch=patch, image_size=image_size)
        if mesh is not None:
            from wam_tpu_torch.parallel.seq_estimators import SeqShardedWam

            # the sharded pipeline is NCHW (the rows are the sharded axis); an
            # NHWC model gets the transpose in front of it
            seq_model = model_fn
            if model_layout == "nhwc":
                seq_model = lambda sig: model_fn(sig.permute(0, 2, 3, 1))  # noqa: E731
            self._seq = SeqShardedWam(
                mesh, seq_model, ndim=2, wavelet=wavelet, level=self.J, mode=mode,
                seq_axis=seq_axis, post_fn=lambda g: mosaic2d(g, normalize_coeffs, 1),
                batch_axis=batch_axis, fused=seq_fused, dwt_bf16=dwt_bf16)
        if mesh is None and batch_axis is not None:
            raise ValueError("batch_axis= requires mesh=")
        self.mesh = mesh
        self.seq_axis = seq_axis
        self.batch_axis = batch_axis
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
        avg = self._smooth(x, y, noise)
        self.scales = reproject_mosaic(avg, self.J, self.approx_coeffs)
        return avg

    def _smooth(self, x, y, noise=None) -> torch.Tensor:
        """The SmoothGrad mosaic, with no instance attribute set."""
        x, y = self._inputs(x, y)
        if self.mesh is not None:
            return self._seq.smoothgrad(
                x, y, self.random_seed, n_samples=self.n_samples,
                stdev_spread=self.stdev_spread, sample_chunk=self._chunk(),
                noise=None if noise is None else torch.as_tensor(noise, device=x.device))
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
        return smoothgrad(step, x, n_samples=self.n_samples, stdev_spread=self.stdev_spread,
                          batch_size=self._chunk(), generator=generator, noise=noise,
                          materialize_noise=not self.stream_noise, seed=self.random_seed)

    # -- Integrated gradients ---------------------------------------------

    def integrated_wam(self, x, y) -> torch.Tensor:
        attr = self._integrated(x, y)
        self.scales = reproject_mosaic(attr, self.J, self.approx_coeffs)
        return attr

    def _integrated(self, x, y) -> torch.Tensor:
        """The Integrated-Gradients attribution, with no instance attribute
        set."""
        x, y = self._inputs(x, y)
        if self.mesh is not None:
            coeffs, integral = self._seq.integrated(x, y, n_steps=self.n_samples,
                                                    sample_chunk=self._chunk())
            return mosaic2d(coeffs, normalize=True, channel_axis=1) * integral
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
        return baseline * integral

    # -- Blocks of a batch's rows (the fleet's oversize route) -------------

    def _block_grads(self, coeffs, y, spatial, s: int, scale: float):
        """`_mosaic_of_grads` of a block of rows of a larger batch, before
        its normalization: the unnormalized mosaics (s, b, S, S), their
        `leaf_maxima` (s, n_regions) over the block's rows and the mosaic's
        regions. The gradients are multiplied by ``scale`` (block rows /
        batch rows), so a row's gradient is the one the batch-mean loss of
        the whole batch gives it."""
        grads = self.engine.grads_from_coeffs(coeffs, y.repeat(s) if y is not None else None,
                                              spatial, samples=s)
        grads = map_coeffs(lambda g: (g * scale).reshape((s, -1) + tuple(g.shape[1:])), grads)
        return (mosaic2d(grads, False, self._caxis), leaf_maxima(grads, self._caxis),
                mosaic_regions(grads, self._caxis))

    def _normalized(self, mosaics, maxima, regions):
        if not self.normalize_coeffs:
            return mosaics
        return normalize_mosaic(mosaics, torch.as_tensor(maxima, device=mosaics.device), regions)

    def _smooth_partial(self, x, y, lo: int, total: int):
        """`RowBlocks.partial` of the SmoothGrad mosaic: this block's rows
        of the noise the entry draws for the whole ``total``-row batch, and
        its per-sample mosaics kept unnormalized until `_smooth_finish`."""
        x, y = self._inputs(x, y)
        x = self._to_internal(x)
        b = x.shape[0]
        full = (total,) + tuple(x.shape[1:])
        spatial = self.engine.spatial_shape(x.shape)
        sigma = noise_sigma(x, self.stdev_spread).reshape((-1,) + (1,) * (x.ndim - 1))
        if self.stream_noise:
            def draw(i0, i1):
                return torch.stack([sample_noise(self.random_seed, i, full, x.device,
                                                 x.dtype)[lo:lo + b] for i in range(i0, i1)])
        else:
            g = torch.Generator(device=self.device).manual_seed(self.random_seed)
            z = torch.randn((self.n_samples,) + full, generator=g, device=x.device,
                            dtype=x.dtype)[:, lo:lo + b]

            def draw(i0, i1):
                return z[i0:i1]

        step = self._chunk() or self.n_samples
        parts = []
        for i in range(0, self.n_samples, step):
            noisy = x + draw(i, min(i + step, self.n_samples)) * sigma
            flat = noisy.reshape((-1,) + tuple(noisy.shape[2:]))
            if self.dwt_bf16:
                flat = flat.to(torch.bfloat16)
            with torch.no_grad():
                coeffs = self.engine.decompose(flat)
            parts.append(self._block_grads(coeffs, y, spatial, noisy.shape[0], b / total))
        mosaics = torch.cat([p[0] for p in parts])
        return (mosaics, parts[0][2]), torch.cat([p[1] for p in parts])

    def _smooth_finish(self, state, maxima):
        mosaics, regions = state
        return self._normalized(mosaics, maxima, regions).mean(dim=0)

    def _integrated_partial(self, x, y, lo: int, total: int):
        """`RowBlocks.partial` of the IG attribution: the baseline mosaic and
        the path's per-step mosaics of this block's rows, unnormalized until
        `_integrated_finish`."""
        del lo  # IG draws nothing: a row's path depends on the row alone
        x, y = self._inputs(x, y)
        x = self._to_internal(x)
        if self.dwt_bf16:
            x = x.to(torch.bfloat16)
        with torch.no_grad():
            coeffs = self.engine.decompose(x)
        spatial = self.engine.spatial_shape(x.shape)
        alphas = torch.linspace(0.0, 1.0, self.n_samples, dtype=torch.float32, device=self.device)
        step = self._chunk() or self.n_samples
        parts = []
        for i in range(0, self.n_samples, step):
            a = alphas[i:i + step]
            scaled = map_coeffs(
                lambda c: (c[None] * a.to(c.dtype).reshape(-1, 1, 1, 1, 1))
                .reshape((-1,) + tuple(c.shape[1:])), coeffs)
            parts.append(self._block_grads(scaled, y, spatial, a.shape[0], x.shape[0] / total))
        base = (mosaic2d(coeffs, False, self._caxis), leaf_maxima(coeffs, self._caxis),
                mosaic_regions(coeffs, self._caxis))
        state = (torch.cat([p[0] for p in parts]), parts[0][2], base[0], base[2])
        return state, (torch.cat([p[1] for p in parts]), base[1])

    def _integrated_finish(self, state, maxima):
        path, regions, base, base_regions = state
        path_max, base_max = maxima
        integral = trapezoid(self._normalized(path, path_max, regions))
        # the baseline is normalized whatever normalize_coeffs says, as in _integrated
        return normalize_mosaic(base, torch.as_tensor(base_max, device=base.device),
                                base_regions) * integral

    def __call__(self, x, y, noise=None) -> torch.Tensor:
        if self.method == "smooth":
            return self.smooth_wam(x, y, noise)
        if noise is not None:
            raise ValueError("noise= applies to method='smooth' only")
        return self.integrated_wam(x, y)

    def serve_entry(self, donate: bool | None = None, on_trace=None,
                    aot_key: str | None = None, with_health: bool = False):
        """Batched serving entry ``(x, y) -> mosaic (B, S, S)`` for the
        `wam_tpu_torch.serve` worker: the estimator body without the
        instance-attribute stashing (``self.scales``) that makes ``__call__``
        thread-unsafe. SmoothGrad seeds its generator with the instance seed
        on every call, so every batch reuses one noise stream — what repeat
        ``__call__`` invocations do (the reference folds the seed in at
        build time). ``mesh=`` is rejected: the serving worker owns one
        device. ``with_health=True`` computes the numeric-health vector over
        the mosaic in the same call (`serve.entry.jit_entry`).

        The mosaic is normalized over the batch and SmoothGrad's noise drawn
        at its shape, so a row depends on the rows beside it. Without
        health, the entry carries the `serve.entry.RowBlocks` that compute a
        batch on blocks of its rows, on several devices, with the result of
        the entry on the whole batch: a block draws its rows of the
        whole batch's noise, scales its loss to the whole batch, and keeps
        its per-sample mosaics unnormalized until every block's maxima are
        known (the fleet's "pjit" oversize route)."""
        if self.mesh is not None:
            raise ValueError(
                "serve_entry() does not support mesh=; the serve worker owns "
                "a single device — drive the sharded estimator directly")
        from wam_tpu_torch.serve.entry import jit_entry

        from wam_tpu_torch.serve.entry import RowBlocks

        if self.method == "smooth":
            impl, blocks = self._smooth, RowBlocks(self._smooth_partial, self._smooth_finish)
        else:
            impl = self._integrated
            blocks = RowBlocks(self._integrated_partial, self._integrated_finish)
        return jit_entry(lambda x, y: impl(x, y), donate=donate, on_trace=on_trace,
                         aot_key=aot_key, with_health=with_health,
                         blocks=None if with_health else blocks)

    def anytime_serve_entry(self, stride: int | str = "auto", on_trace=None,
                            plateau_tol: float | None = None, noise=None):
        """The SmoothGrad mosaic as an anytime entry (`anytime.make_anytime_entry`):
        sample i's mosaic, one sample of the whole batch a step, its noise
        `core.estimators.sample_noise(random_seed, i)` (the streamed path's
        draws) or ``noise[i]`` from a handed-over (n_samples, *x.shape)
        tensor. At full n it equals `smooth_wam` with ``stream_noise=True``
        (or with the same ``noise``) up to the order of the sample sum.
        ``stride`` is the checkpoint cadence ("auto": 5, clamped;
        `core.estimators.resolve_checkpoint_stride`). SmoothGrad only;
        `serve.AttributionServer` serves it with deadlines. ``on_trace``
        fires at each of the entry's first calls at a new input signature
        (`anytime.entry.make_anytime_entry`)."""
        if self.mesh is not None:
            raise ValueError(
                "anytime_serve_entry() does not support mesh=; the serve "
                "worker owns a single device — drive "
                "SeqShardedWam.smoothgrad_checkpointed directly")
        if self.method != "smooth":
            raise ValueError(
                "anytime_serve_entry() needs method='smooth': IG's trapezoid "
                "path weights are not an exchangeable sample mean")
        from wam_tpu_torch.anytime.entry import DEFAULT_PLATEAU_TOL, make_anytime_entry

        def sample_fn(x, y, i: int) -> torch.Tensor:
            x, y = self._inputs(x, y)
            xi = self._to_internal(x)
            if noise is None:
                z = sample_noise(self.random_seed, i, xi.shape, xi.device, xi.dtype)
            else:
                z = self._to_internal(torch.as_tensor(noise[i], device=self.device)).to(xi.dtype)
            sigma = noise_sigma(xi, self.stdev_spread).reshape((-1,) + (1,) * (xi.ndim - 1))
            noisy = xi + sigma * z
            if self.dwt_bf16:
                noisy = noisy.to(torch.bfloat16)
            _, grads = self.engine.attribute(noisy, y)
            return mosaic2d(grads, self.normalize_coeffs, self._caxis)

        return make_anytime_entry(
            sample_fn, n_total=self.n_samples,
            stride=resolve_checkpoint_stride(stride, self.n_samples, workload="wam2d",
                                             dtype="bf16" if self.dwt_bf16 else "f32"),
            plateau_tol=DEFAULT_PLATEAU_TOL if plateau_tol is None else plateau_tol,
            on_trace=on_trace, name="wam2d_anytime")
