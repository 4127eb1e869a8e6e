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

import copy
from typing import Callable

import torch

from wam_tpu_torch.core.engine import WamEngine, map_coeffs
from wam_tpu_torch.core.estimators import (
    block_draws,
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
from wam_tpu_torch.wavelets.transform import IMPLS

__all__ = ["BaseWAM2D", "WaveletAttribution2D"]


def _anchor(device) -> torch.Tensor:
    """A compiled step's anchor (`core.engine.WamEngine.grads_from_coeffs`):
    a 0-d zero that requires grad, made outside the compiled graph."""
    return torch.zeros((), device=device, requires_grad=True)


def _aot_entry(unit: Callable, key: str, record=None, **kw):
    """``unit`` through the compiled-step cache (`pipeline.aot.cached_entry`);
    ``record`` (`serve.entry.jit_entry`'s) is handed the dispatcher."""
    from wam_tpu_torch.pipeline.aot import cached_entry

    fn = cached_entry(unit, key, **kw)
    return fn if record is None else record(fn)


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

    def _compile_twin(self):
        """A shallow copy of this explainer for compiled graphs
        (`pipeline.aot`): its engine holds the Wavelet object, not its name,
        and takes the kernel route of the 2D transforms whatever ``impl``
        says (the custom operators of `wavelets.matmul`: the kernels on the
        card, their plain versions on the CPU), because the conv and matmul
        forms build their filters with numpy, which a graph must not trace.
        The channel-last transforms (`wavelets.nhwc`) have no operator form;
        their compile falls back to eager."""
        from wam_tpu_torch.wavelets.matmul import remember_wavelet

        twin = copy.copy(self)
        twin.engine = copy.copy(self.engine)
        twin.engine.wavelet = remember_wavelet(self.engine.wavelet)
        if not self.engine.channel_last:
            twin.engine.impl = "kernel"
        return twin

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
        (the staged batch released on the card, first-call counting; with an
        AOT key the whole pass is one compiled program of the compiled-step
        cache, `pipeline.aot`). ``with_health=True`` computes the
        numeric-health vector in the same call — mosaic saturation/max plus
        the coefficient-gradient norm and pooled NaN/Inf counts
        (`WamEngine.attribute_with_health`), zero extra fetches.

        The mosaic is normalized over the batch, so a row depends on the
        rows beside it: the entry carries the `serve.entry.RowBlocks` that
        compute a batch on blocks of its rows with the entry's result on
        the whole batch (each block's gradients scaled to the whole batch's
        loss, its mosaic normalized by the max over every block; with
        health, each block's vector merged by `obs.health.merge_stats`)."""
        from wam_tpu_torch.serve.entry import RowBlocks, jit_entry

        blocks = RowBlocks(lambda x, y, lo, total: self._pass_partial(x, y, lo, total, with_health),
                           self._pass_finish)
        def make(wam):
            if with_health:
                from wam_tpu_torch.obs.health import combine_output_grads, health_stats

                def impl(x, y, anchor=None):
                    x, y = wam._inputs(x, y)
                    _, grads, gvec = wam.engine.attribute_with_health(wam._to_internal(x), y,
                                                                      anchor=anchor)
                    m = mosaic2d(grads, wam.normalize_coeffs, wam._caxis)
                    return m, combine_output_grads(health_stats(m), gvec)
            else:
                def impl(x, y, anchor=None):
                    x, y = wam._inputs(x, y)
                    _, grads = wam.engine.attribute(wam._to_internal(x), y, anchor=anchor)
                    return mosaic2d(grads, wam.normalize_coeffs, wam._caxis)
            return impl

        def wam_aot(key, **kw):
            entry = _aot_entry(make(self._compile_twin()), key, **kw)
            return lambda x, y: entry(*self._inputs(x, y), _anchor(self.device))

        impl = make(self)
        impl.wam_aot = wam_aot
        return jit_entry(impl, donate=donate, on_trace=on_trace, aot_key=aot_key,
                         with_health="fused" if with_health else False, blocks=blocks)

    # -- Blocks of a batch's rows (the fleet's oversize route) -------------

    def _block_grads(self, coeffs, y, spatial, s: int, scale: float,
                     synth: str | None = None):
        """`_mosaic_of_grads` of a block of rows of a larger batch, before
        its normalization: the unnormalized mosaics (s, b, S, S), their
        `leaf_maxima` (s, n_regions) over the block's rows and the mosaic's
        regions. The gradients are multiplied by ``scale`` (block rows /
        batch rows), so a row's gradient is the one the batch-mean loss of
        the whole batch gives it. ``synth``: the synthesis impl
        (`WaveletAttribution2D._synth`)."""
        grads = self.engine.grads_from_coeffs(coeffs, y.repeat(s) if y is not None else None,
                                              spatial, samples=s, synth_impl=synth)
        grads = map_coeffs(lambda g: (g * scale).reshape((s, -1) + tuple(g.shape[1:])), grads)
        return (mosaic2d(grads, False, self._caxis), leaf_maxima(grads, self._caxis),
                mosaic_regions(grads, self._caxis))

    def _normalized(self, mosaics, maxima, regions):
        if not self.normalize_coeffs:
            return mosaics
        return normalize_mosaic(mosaics, torch.as_tensor(maxima, device=mosaics.device), regions)

    def _pass_partial(self, x, y, lo: int, total: int, health: bool = False):
        """`RowBlocks.partial` of one pass: this block's unnormalized mosaic
        (its gradients scaled to the whole batch's loss), its maxima, and
        with ``health`` the gradients' health vector."""
        del lo  # one pass draws nothing
        x, y = self._inputs(x, y)
        xi = self._to_internal(x)
        with torch.no_grad():
            coeffs = self.engine.decompose(xi)
        spatial = self.engine.spatial_shape(xi.shape)
        grads = self.engine.grads_from_coeffs(coeffs, y, spatial)
        grads = map_coeffs(lambda g: g * (x.shape[0] / total), grads)
        state = (mosaic2d(grads, False, self._caxis), mosaic_regions(grads, self._caxis))
        if health:
            from wam_tpu_torch.obs.health import health_stats

            state = state + (health_stats(grads),)
        return state, leaf_maxima(grads, self._caxis)

    def _pass_finish(self, state, maxima):
        m = self._normalized(state[0], maxima, state[1])
        if len(state) == 2:
            return m
        from wam_tpu_torch.obs.health import combine_output_grads, health_stats

        return m, combine_output_grads(health_stats(m), state[2])

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

    ``synth_impl`` is the synthesis impl of this explainer's calls (``"conv"``,
    ``"matmul"`` or ``"kernel"``). None takes ``impl`` when given, else the
    tuned ``synth_impl`` of the call's schedule key, else the process knob
    (`wavelets.transform.set_synth2_impl`). A tuned entry applies to the
    call it matches and to no other: the knob is never written.

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
        synth_impl: str | None = None,
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
        self._stream_auto = stream_noise == "auto"
        if synth_impl is not None and synth_impl not in IMPLS:
            raise ValueError(f"synth_impl {synth_impl!r} not one of {IMPLS}")
        self.synth_impl = synth_impl

    def _schedule_key(self, x, batch: int | None = None) -> dict:
        """The call's identity in the schedule cache (`wam_tpu_torch.tune`):
        workload "wam2d", the caller-layout item shape, the batch (``x``'s,
        or the whole batch a block of rows belongs to), the transform dtype,
        the engine's impl and the input's backend."""
        batch = int(x.shape[0]) if batch is None else int(batch)
        return {"workload": "wam2d", "shape": tuple(x.shape[1:]), "batch": batch,
                "dtype": "bf16" if self.dwt_bf16 else "f32", "dwt_impl": self.engine.impl,
                "backend": x.device.type}

    def _chunk(self, x, batch: int | None = None) -> int | None:
        """sample_batch_size resolved for ``x`` (the caller's NCHW batch): an
        explicit value, or for "auto" the tuned chunk of this call's
        schedule key, else every sample at once."""
        return resolve_sample_chunk(self.sample_batch_size, self.n_samples,
                                    **self._schedule_key(x, batch))

    def _synth(self, x, batch: int | None = None) -> str | None:
        """The synthesis impl of a call on ``x`` (the caller's NCHW batch):
        ``synth_impl``, else ``impl``, else the tuned ``synth_impl`` of the
        call's schedule key (`tune.cache.tuned_synth_impl`), else None (the
        process knob)."""
        if self.synth_impl is not None or self.engine.impl is not None:
            return self.synth_impl or self.engine.impl
        from wam_tpu_torch.tune.cache import tuned_synth_impl

        key = self._schedule_key(x, batch)
        return tuned_synth_impl(key["workload"], key["shape"], key["batch"], key["dtype"],
                                backend=key["backend"])

    def _stream(self, x, batch: int | None = None) -> bool:
        """stream_noise for ``x``: True / False as given; "auto" reads the
        tuned ``stream_noise`` of the call's schedule key, else
        materializes."""
        if self._stream_auto:
            from wam_tpu_torch.tune.cache import lookup_schedule

            ent = lookup_schedule(**self._schedule_key(x, batch))
            if ent is not None and ent.get("stream_noise") is not None:
                return bool(ent["stream_noise"])
        return self.stream_noise

    def _mosaic_of_grads(self, coeffs, y, spatial, s: int,
                         synth: str | None = None, anchor=None) -> torch.Tensor:
        """Gradient mosaics of ``s`` stacked copies: coefficient leaves are
        (s*B, C, h, w), sample-major; returns (s, B, S, S). ``synth``: the
        synthesis impl (`_synth`); ``anchor``: the engine's, in a compiled
        step (`core.engine.WamEngine.grads_from_coeffs`)."""
        grads = self.engine.grads_from_coeffs(coeffs, y.repeat(s) if y is not None else None,
                                              spatial, samples=s, synth_impl=synth,
                                              anchor=anchor)
        grads = map_coeffs(lambda g: g.reshape((s, -1) + tuple(g.shape[1:])), grads)
        return mosaic2d(grads, self.normalize_coeffs, self._caxis)

    # -- SmoothGrad --------------------------------------------------------

    def smooth_wam(self, x, y, noise=None) -> torch.Tensor:
        avg = self._smooth(x, y, noise)
        self.scales = reproject_mosaic(avg, self.J, self.approx_coeffs)
        return avg

    def _smooth_step(self, synth: str | None):
        """One chunk of SmoothGrad, the compiled unit of `pipeline.aot`:
        ``step(noisy, y)`` maps a stack of noisy batches (s, B, C, H, W), in
        the engine's layout, to their gradient mosaics (s, B, S, S). The
        noise is drawn outside it (a generator inside a compiled region
        breaks the graph)."""

        def step(noisy: torch.Tensor, y, anchor=None) -> torch.Tensor:
            s = noisy.shape[0]
            flat = noisy.reshape((-1,) + tuple(noisy.shape[2:]))
            if self.dwt_bf16:
                flat = flat.to(torch.bfloat16)
            with torch.no_grad():
                coeffs = self.engine.decompose(flat)
            return self._mosaic_of_grads(coeffs, y, self.engine.spatial_shape(flat.shape), s,
                                         synth, anchor)

        return step

    def _ig_step(self, synth: str | None, spatial, like):
        """One chunk of Integrated Gradients, the compiled unit of
        `pipeline.aot`: ``step(alphas, y, anchor, *leaves)`` maps a chunk of
        path points (s,) and the input's coefficient leaves (in the structure
        of ``like``) to the path's gradient mosaics (s, B, S, S)."""
        from wam_tpu_torch.core.engine import _unflatten

        def step(alphas: torch.Tensor, y, anchor, *leaves) -> torch.Tensor:
            s = alphas.shape[0]
            scaled = map_coeffs(
                lambda c: (c[None] * alphas.to(c.dtype).reshape(-1, 1, 1, 1, 1))
                .reshape((-1,) + tuple(c.shape[1:])), _unflatten(leaves, like))
            return self._mosaic_of_grads(scaled, y, spatial, s, synth, anchor)

        return step

    def _aot_steps(self, aot_key: str, **kw):
        """``steps(kind, *step_args)`` -> the chunk step
        ("smooth" or "ig") compiled through the compiled-step cache, one
        program per (kind, argument signature), keyed
        ``{aot_key}|{kind}|synth-kernel|...`` (`pipeline.aot.cached_entry`):
        a compiled step synthesizes on the kernel route (`_compile_twin`)
        whatever the eager call's ``synth`` is."""
        twin = self._compile_twin()
        synth = twin.engine.impl
        made: dict = {}

        def steps(kind: str, *extra):
            tag = (kind,) + extra[:1]
            if tag not in made:
                unit = (twin._smooth_step(synth) if kind == "smooth"
                        else twin._ig_step(synth, *extra))
                entry = _aot_entry(unit, f"{aot_key}|{kind}|synth-{synth}", **kw)

                def call(a, y, *rest, entry=entry):
                    # int64 labels, as every caller's labels are read, so
                    # a server's int32 batch hits a prewarmed program
                    return entry(a, None if y is None else y.long(), _anchor(a.device), *rest)

                made[tag] = call
            return made[tag]

        return steps

    def _smooth(self, x, y, noise=None, steps=None) -> torch.Tensor:
        """The SmoothGrad mosaic, with no instance attribute set; ``steps``
        (`_aot_steps`) runs each chunk compiled."""
        x, y = self._inputs(x, y)
        chunk = self._chunk(x)
        if self.mesh is not None:
            return self._seq.smoothgrad(
                x, y, self.random_seed, n_samples=self.n_samples,
                stdev_spread=self.stdev_spread, sample_chunk=chunk,
                noise=None if noise is None else torch.as_tensor(noise, device=x.device))
        stream = self._stream(x)
        synth = self._synth(x)
        x = self._to_internal(x)  # once, outside the sample loop
        if noise is not None and self.model_layout == "nhwc":
            noise = torch.as_tensor(noise).permute(0, 1, 3, 4, 2)
        run = (self._smooth_step(synth) if steps is None
               else steps("smooth"))

        def step(noisy: torch.Tensor) -> torch.Tensor:  # (s, B, C, H, W)
            return run(noisy, y)

        generator = None
        if noise is None and not stream:
            generator = torch.Generator(device=self.device).manual_seed(self.random_seed)
        return smoothgrad(step, x, n_samples=self.n_samples, stdev_spread=self.stdev_spread,
                          batch_size=chunk, generator=generator, noise=noise,
                          materialize_noise=not stream, seed=self.random_seed)

    # -- Integrated gradients ---------------------------------------------

    def integrated_wam(self, x, y) -> torch.Tensor:
        attr = self._integrated(x, y)
        self.scales = reproject_mosaic(attr, self.J, self.approx_coeffs)
        return attr

    def _integrated(self, x, y, steps=None) -> torch.Tensor:
        """The Integrated-Gradients attribution, with no instance attribute
        set; ``steps`` (`_aot_steps`) runs each chunk compiled."""
        x, y = self._inputs(x, y)
        chunk = self._chunk(x)
        if self.mesh is not None:
            coeffs, integral = self._seq.integrated(x, y, n_steps=self.n_samples,
                                                    sample_chunk=chunk)
            return mosaic2d(coeffs, normalize=True, channel_axis=1) * integral
        synth = self._synth(x)
        x = self._to_internal(x)
        if self.dwt_bf16:
            x = x.to(torch.bfloat16)
        with torch.no_grad():
            coeffs = self.engine.decompose(x)
        baseline = mosaic2d(coeffs, normalize=True, channel_axis=self._caxis)
        spatial = self.engine.spatial_shape(x.shape)
        from wam_tpu_torch.core.engine import _flatten, _unflatten

        leaves = _flatten(coeffs)
        like = _unflatten([None] * len(leaves), coeffs)  # the structure alone
        if steps is None:
            run = self._ig_step(synth, spatial, like)
            extra = (None,)  # no anchor: the leaves are made to require grad
        else:
            run, extra = steps("ig", spatial, like), ()

        def grad_fn(alphas: torch.Tensor) -> torch.Tensor:  # (s,)
            return run(alphas, y, *extra, *leaves)

        integral = integrated_path(grad_fn, n_steps=self.n_samples,
                                   batch_size=chunk, device=self.device)
        return baseline * integral

    # -- Blocks of a batch's rows (the fleet's oversize route) -------------

    def _smooth_partial(self, x, y, lo: int, total: int):
        """`RowBlocks.partial` of the SmoothGrad mosaic: this block's rows
        of the noise the entry draws for the whole ``total``-row batch, and
        its per-sample mosaics kept unnormalized until `_smooth_finish`."""
        x, y = self._inputs(x, y)
        step = self._chunk(x, total) or self.n_samples
        stream = self._stream(x, total)  # the whole batch's, as the entry resolves it
        synth = self._synth(x, total)
        x = self._to_internal(x)
        b = x.shape[0]
        spatial = self.engine.spatial_shape(x.shape)
        sigma = noise_sigma(x, self.stdev_spread).reshape((-1,) + (1,) * (x.ndim - 1))
        draw = block_draws(self.random_seed, self.n_samples, (total,) + tuple(x.shape[1:]), lo, b,
                           x.device, x.dtype, stream)
        parts = []
        for i in range(0, self.n_samples, step):
            noisy = x + draw(i, min(i + step, self.n_samples)) * sigma
            flat = noisy.reshape((-1,) + tuple(noisy.shape[2:]))
            if self.dwt_bf16:
                flat = flat.to(torch.bfloat16)
            with torch.no_grad():
                coeffs = self.engine.decompose(flat)
            parts.append(self._block_grads(coeffs, y, spatial, noisy.shape[0], b / total, synth))
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
        step = self._chunk(x, total) or self.n_samples
        synth = self._synth(x, total)
        x = self._to_internal(x)
        if self.dwt_bf16:
            x = x.to(torch.bfloat16)
        with torch.no_grad():
            coeffs = self.engine.decompose(x)
        spatial = self.engine.spatial_shape(x.shape)
        alphas = torch.linspace(0.0, 1.0, self.n_samples, dtype=torch.float32, device=self.device)
        parts = []
        for i in range(0, self.n_samples, step):
            a = alphas[i:i + step]
            scaled = map_coeffs(
                lambda c: (c[None] * a.to(c.dtype).reshape(-1, 1, 1, 1, 1))
                .reshape((-1,) + tuple(c.shape[1:])), coeffs)
            parts.append(self._block_grads(scaled, y, spatial, a.shape[0], x.shape[0] / total,
                                           synth))
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
        at its shape, so a row depends on the rows beside it. The entry
        (with or without health) carries the `serve.entry.RowBlocks` that compute a
        batch on blocks of its rows, on several devices, with the result of
        the entry on the whole batch: a block draws its rows of the
        whole batch's noise, scales its loss to the whole batch, and keeps
        its per-sample mosaics unnormalized until every block's maxima are
        known (the fleet's "pjit" oversize route).

        With ``aot_key`` each chunk step (`_smooth_step`, `_ig_step`) is a
        program of the compiled-step cache (`pipeline.aot`), keyed by the
        key, the step's kind and synthesis impl and its arguments'
        signature; the noise draws and the loop over chunks stay eager, so
        the kernels launch as often as in the eager entry."""
        if self.mesh is not None:
            raise ValueError(
                "serve_entry() does not support mesh=; the serve worker owns "
                "a single device — drive the sharded estimator directly")
        from wam_tpu_torch.serve.entry import RowBlocks, jit_entry

        if self.method == "smooth":
            impl, blocks = self._smooth, RowBlocks(self._smooth_partial, self._smooth_finish)
        else:
            impl = self._integrated
            blocks = RowBlocks(self._integrated_partial, self._integrated_finish)

        def entry_impl(x, y):
            return impl(x, y)

        def wam_aot(key, **kw):
            steps = self._aot_steps(key, **kw)
            return lambda x, y: impl(x, y, steps=steps)

        entry_impl.wam_aot = wam_aot
        return jit_entry(entry_impl, donate=donate, on_trace=on_trace,
                         aot_key=aot_key, with_health=with_health, blocks=blocks)

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
