"""WAM-3D: volume (voxel) and point-cloud attribution in the wavelet domain
(PyTorch port).

Counterpart of `wam_tpu.wam3d`: a batched 3D DWT -> coefficient gradients ->
dyadic cube (`ops.packing3d.cube3d`), with the ``y=None`` representation
mode (the gradient of the mean of the model's output), voxel filtering,
SmoothGrad (divided by n_samples once, after the loop) and Integrated
Gradients, per-level visualization, and the point-cloud path (per-axis 1D
DWT attribution with threshold filtering).

The model is a function ``x (B, 1, D, H, W) -> logits (B, K)`` already bound
to its device (e.g. `models.resnet.bind_inference` of a
`models.resnet3d.ResNet3D` or a `models.voxel.VoxelModel`), or, with
``instance="point_clouds"``, ``(B, 3, N) -> logits`` or a tuple whose first
element is the logits (`models.pointnet`). The engine reconstructs
(B, D, H, W) volumes and the model gets ``rec[:, None]``.

No TPU kernel lies on this path: the analysis is a ``conv3d``, the synthesis
a ``conv_transpose3d`` (the default) or three banded products
(`matmul.synthesis3_mm`, ``impl="matmul"`` or ``"kernel"``), the models
cuDNN's. A model bound with
``fused_relu_vjp=True`` runs its ReLUs through K4/K5.

``serve_entry(aot_key=)`` compiles each chunk step through the
compiled-step cache (`pipeline.aot`): inside the graph the 3D levels are
the operators of `wavelets.transform`.
"""

from __future__ import annotations

import copy
from typing import Callable

import numpy as np
import torch

from wam_tpu_torch.core.engine import WamEngine, _flatten, _unflatten, map_coeffs, target_loss
from wam_tpu_torch.core.estimators import (
    block_draws,
    integrated_path,
    resolve_sample_chunk,
    smoothgrad,
    validate_sample_batch_size,
)
from wam_tpu_torch.device import resolve_device
from wam_tpu_torch.ops.packing3d import cube3d, visualize_cube
from wam_tpu_torch.wavelets.transform import wavedec, waverec, waverec3

__all__ = ["filter_coeffs", "BaseWAM3D", "WaveletAttribution3D"]


def filter_coeffs(coeffs, EPS: float, normalized: bool = False) -> torch.Tensor:
    """Binary mask (int32) of the (min-max-normalized) coefficients above EPS."""
    c = torch.as_tensor(coeffs)
    if not normalized:
        lo, hi = c.min(), c.max()
        c = (c - lo) / torch.where(hi > lo, hi - lo, torch.ones_like(hi))
        return (c > EPS).to(torch.int32)
    return (c >= EPS).to(torch.int32)


class BaseWAM3D:
    """Single-pass WAM-3D.

    ``__call__(x, y)`` on volumes (B, 1, D, H, W) (``instance="voxels"``)
    returns the gradient cube (B, S, S, S) and keeps the coefficients and
    their gradients for `filter_voxels`; on point clouds (B, 3, N)
    (``instance="point_clouds"``) it returns the coefficient gradients of
    each coordinate axis (`evaluate_point_clouds`). ``y=None`` takes the
    gradient of the mean of the model's output.

    ``device``: where the computation runs; CUDA unless the caller asks
    otherwise (``"cpu"`` runs the same PyTorch forms there). ``impl``: the
    3D synthesis (`wavelets.transform.idwt3`; ``None`` = the conv form).
    """

    def __init__(
        self,
        model_fn: Callable[[torch.Tensor], torch.Tensor],
        wavelet: str = "haar",
        J: int = 1,
        approx_coeffs: bool = False,
        mode: str = "symmetric",
        instance: str = "voxels",
        normalize: bool = True,
        EPS: float = 0.451,
        device=None,
        impl: str | None = None,
    ):
        if instance not in ("voxels", "point_clouds"):
            raise ValueError(f"Unknown instance {instance!r}")
        self.device = resolve_device(device)
        self.model_fn = model_fn
        self.wavelet = wavelet
        self.J = J
        self.approx_coeffs = approx_coeffs
        self.mode = mode
        self.instance = instance
        self.normalize = normalize
        self.EPS = EPS
        self.input_size = None
        self.engine = WamEngine(lambda rec: model_fn(rec[:, None]), ndim=3, wavelet=wavelet,
                                level=J, mode=mode, impl=impl)

    def _inputs(self, x, y):
        x = torch.as_tensor(x, device=self.device)
        if y is not None:
            y = torch.as_tensor(y, device=self.device)
        return x, y

    # -- voxels ------------------------------------------------------------

    def evaluate_voxels(self, x, y=None) -> torch.Tensor:
        """x: (B, 1, D, H, W). Returns the gradient cube (B, S, S, S); keeps
        the coefficients and their gradients (``coeffs``, ``grads_pytree``)."""
        x, y = self._inputs(x, y)
        self.input_size = x.shape[-1]
        self.coeffs, self.grads_pytree = self.engine.attribute(x[:, 0], y)
        self.grads = cube3d(self.grads_pytree)
        return self.grads

    def filter_voxels(self, EPS: float | None = None) -> torch.Tensor:
        """Reconstruct filtered shapes (B, 1, D, H, W) from the last
        `evaluate_voxels`: the approximation modulated by its min-max-
        normalized gradient, the details hard-thresholded at EPS on their
        max-normalized |gradient|."""
        EPS = self.EPS if EPS is None else EPS
        dims = (-3, -2, -1)
        ga = self.grads_pytree[0]
        lo, hi = ga.amin(dim=dims, keepdim=True), ga.amax(dim=dims, keepdim=True)
        filtered = [self.coeffs[0] * (ga - lo) / torch.where(hi > lo, hi - lo, torch.ones_like(hi))]
        for det_c, det_g in zip(self.coeffs[1:], self.grads_pytree[1:]):
            level = {}
            for key, g in det_g.items():
                gn = g.abs() / g.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12)
                level[key] = det_c[key] * (gn >= EPS)
            filtered.append(level)
        with torch.no_grad():
            rec = waverec3(filtered, self.wavelet, impl=self.engine.impl)
        s = self.input_size
        return rec[..., :s, :s, :s][:, None]

    # -- point clouds ------------------------------------------------------

    def evaluate_point_clouds(self, x, y=None) -> list[list[torch.Tensor]]:
        """x: (B, 3, N) point clouds. Each coordinate sequence is
        decomposed with the 1D DWT, the model reads the reconstruction, and
        one backward gives the gradient of every (axis, level) coefficient.
        Returns a list over x, y, z of coefficient-gradient lists
        [cA_J, cD_J, ..., cD_1]."""
        x, y = self._inputs(x, y)
        self.input = x
        self.batch_size, _, self.shape_size = x.shape
        with torch.no_grad():
            coeffs = [wavedec(x[:, d], self.wavelet, self.J, self.mode) for d in range(3)]
        leaves = [[c.detach().requires_grad_(True) for c in cs] for cs in coeffs]
        with torch.enable_grad():
            rec = torch.stack([self.engine_1d_reconstruct(cs, x.shape[-1]) for cs in leaves], dim=1)
            out = self.model_fn(rec)
            out = out[0] if isinstance(out, tuple) else out
            grads = iter(torch.autograd.grad(target_loss(out, y), [c for cs in leaves for c in cs]))
        self.pc_coeffs = coeffs
        self.pc_grads = [[next(grads) for _ in cs] for cs in leaves]
        return self.pc_grads

    def engine_1d_reconstruct(self, coeffs, length: int) -> torch.Tensor:
        return waverec(coeffs, self.wavelet)[..., :length]

    def filter_point_clouds(self, EPS: float | None = None):
        """Keep the points whose summed (axis, level) gradient importance,
        each level linearly interpolated to the N points, exceeds EPS after
        min-max normalization over the batch. Host-side numpy. Returns (a list
        of (n_kept_i, 3) arrays, the per-point importance (B, N))."""
        EPS = self.EPS if EPS is None else EPS
        n = self.shape_size
        total = np.zeros((self.batch_size, n))
        xq = np.linspace(0.0, 1.0, n)
        for dim_grads in self.pc_grads:
            for level in dim_grads:
                g = level.detach().cpu().numpy()
                xp = np.linspace(0.0, 1.0, g.shape[-1])
                for b in range(self.batch_size):
                    total[b] += np.interp(xq, xp, g[b])
        lo, hi = total.min(), total.max()
        norm = (total - lo) / (hi - lo if hi > lo else 1.0)
        points = self.input.detach().cpu().numpy()
        kept = [points[b, :, np.where(np.abs(norm[b]) > EPS)[0]] for b in range(self.batch_size)]
        return kept, norm

    def __call__(self, x, y=None):
        if self.instance == "voxels":
            return self.evaluate_voxels(x, y)
        return self.evaluate_point_clouds(x, y)


class WaveletAttribution3D(BaseWAM3D):
    """SmoothGrad / Integrated-Gradients WAM-3D on volumes (B, 1, D, H, W).

    method="smooth": the mean gradient cube over ``n_samples`` noisy copies,
    per-volume sigma = stdev_spread * (max - min). method="integratedgrad":
    the cube of the input coefficients times the trapezoid (dx = 1) over
    alpha in linspace(0, 1, n_samples) of the gradient cubes at alpha *
    coefficients.

    ``sample_batch_size`` samples (or path points) run as one batch of
    sample_batch_size * B model rows; "auto" and None run them all at once.
    Each sample keeps its own loss scale, so the result does not depend on
    the chunk.

    SmoothGrad noise: standard-normal draws from a ``torch.Generator`` on
    the device seeded with ``random_seed``, or the explicit ``noise``
    (n_samples, *x.shape) given to ``__call__``; ``stream_noise=True`` draws
    each chunk's noise inside the chunk loop, sample i's from (random_seed,
    i) (`core.estimators.sample_noise`).

    ``mesh=`` shards the volume DEPTH axis over the mesh's ``seq_axis``
    (`parallel.SeqShardedWam`, voxels only; ``batch_axis`` splits the batch
    too, ``seq_fused`` is its ``fused``): transforms and coefficient blocks
    stay in blocks, the model runs on the gathered reconstruction, each
    sample's cube is packed from the gathered gradients. SmoothGrad noise
    there is sample i's ``sample_noise(random_seed, i)`` or the handed
    ``noise``.
    """

    def __init__(
        self,
        model_fn: Callable[[torch.Tensor], torch.Tensor],
        wavelet: str = "haar",
        J: int = 3,
        method: str = "smooth",
        approx_coeffs: bool = False,
        mode: str = "symmetric",
        instance: str = "voxels",
        normalize: bool = True,
        EPS: float = 0.451,
        n_samples: int = 25,
        stdev_spread: float = 1e-4,
        random_seed: int = 42,
        sample_batch_size: int | None | str = "auto",
        stream_noise: bool = False,
        mesh=None,
        seq_axis: str = "data",
        batch_axis: str | None = None,
        seq_fused: bool | str = "auto",
        device=None,
        impl: str | None = None,
    ):
        super().__init__(model_fn, wavelet=wavelet, J=J, approx_coeffs=approx_coeffs,
                         mode=mode, instance=instance, normalize=normalize, EPS=EPS,
                         device=device, impl=impl)
        if mesh is not None and instance != "voxels":
            raise ValueError("mesh= supports instance='voxels' only")
        if mesh is not None:
            from wam_tpu_torch.parallel.seq_estimators import SeqShardedWam

            self._seq = SeqShardedWam(
                mesh, lambda rec: model_fn(rec[:, None]), ndim=3, wavelet=wavelet, level=J,
                mode=mode, seq_axis=seq_axis, post_fn=cube3d, batch_axis=batch_axis,
                fused=seq_fused)
        if mesh is None and batch_axis is not None:
            raise ValueError("batch_axis= requires mesh=")
        self.mesh = mesh
        self.seq_axis = seq_axis
        self.batch_axis = batch_axis
        if method not in ("smooth", "integratedgrad"):
            raise ValueError(f"Unknown method {method!r}")
        validate_sample_batch_size(sample_batch_size)
        self.method = method
        self.n_samples = n_samples
        self.stdev_spread = stdev_spread
        self.random_seed = random_seed
        self.sample_batch_size = sample_batch_size
        self.stream_noise = bool(stream_noise)

    def _chunk(self, x) -> int | None:
        """sample_batch_size resolved for the volumes ``x`` (B, 1, D, H, W):
        explicit, or for "auto" the tuned chunk of the schedule key
        ("wam3d", the item shape, batch, backend), else every sample at
        once."""
        return resolve_sample_chunk(self.sample_batch_size, self.n_samples, workload="wam3d",
                                    shape=tuple(x.shape[1:]), batch=int(x.shape[0]),
                                    backend=x.device.type)

    def _synth(self, x) -> str | None:
        """The 3D synthesis impl of a call on ``x``: ``impl`` when given,
        else the tuned ``synth_impl`` of the call's schedule key ("wam3d"),
        else None (the conv form). It applies to this call only."""
        if self.engine.impl is not None:
            return self.engine.impl
        from wam_tpu_torch.tune.cache import tuned_synth_impl

        return tuned_synth_impl("wam3d", tuple(x.shape[1:]), int(x.shape[0]),
                                backend=x.device.type)

    def _cubes(self, coeffs, y, spatial, s: int, scale: float = 1.0,
               synth: str | None = None, anchor=None) -> torch.Tensor:
        """Gradient cubes of ``s`` stacked copies: coefficient leaves are
        (s*B, d, h, w), sample-major; returns (s, B, S, S, S). The gradients
        are scaled by ``scale`` (`_rows`); ``synth`` is `_synth`'s;
        ``anchor`` the engine's, in a compiled step
        (`core.engine.WamEngine.grads_from_coeffs`)."""
        grads = self.engine.grads_from_coeffs(coeffs, None if y is None else y.repeat(s),
                                              spatial, samples=s, synth_impl=synth,
                                              anchor=anchor)
        if scale != 1.0:
            grads = map_coeffs(lambda g: g * scale, grads)
        cube = cube3d(grads)
        return cube.reshape((s, -1) + tuple(cube.shape[1:]))

    def _smooth_step(self, synth: str | None, scale: float = 1.0):
        """One chunk of SmoothGrad, the compiled unit of `pipeline.aot`:
        ``step(noisy, y)`` maps a stack of noisy volume batches (s, B, D, H,
        W) to their gradient cubes (s, B, S, S, S). The noise is drawn
        outside it."""

        def step(noisy: torch.Tensor, y, anchor=None) -> torch.Tensor:
            spatial = tuple(noisy.shape[-3:])
            with torch.no_grad():
                coeffs = self.engine.decompose(noisy.reshape((-1,) + spatial))
            return self._cubes(coeffs, y, spatial, noisy.shape[0], scale, synth, anchor)

        return step

    def _ig_step(self, synth: str | None, spatial, like, scale: float = 1.0):
        """One chunk of Integrated Gradients, the compiled unit of
        `pipeline.aot`: ``step(alphas, y, anchor, *leaves)`` maps path points
        (s,) and the input's coefficient leaves (in the structure of
        ``like``) to the path's gradient cubes (s, B, S, S, S)."""

        def step(alphas: torch.Tensor, y, anchor, *leaves) -> torch.Tensor:
            scaled = map_coeffs(
                lambda c: (c[None] * alphas.to(c.dtype).reshape(-1, 1, 1, 1, 1))
                .reshape((-1,) + tuple(c.shape[1:])), _unflatten(leaves, like))
            return self._cubes(scaled, y, spatial, alphas.shape[0], scale, synth, anchor)

        return step

    def _compile_twin(self):
        """A shallow copy of this explainer for compiled graphs
        (`pipeline.aot`): its engine holds the Wavelet object, registered by
        name for the graph's level operators (`matmul.remember_wavelet`)."""
        from wam_tpu_torch.wavelets.matmul import remember_wavelet

        twin = copy.copy(self)
        twin.engine = copy.copy(self.engine)
        twin.engine.wavelet = remember_wavelet(self.engine.wavelet)
        return twin

    def _aot_steps(self, aot_key: str, **kw):
        """``steps(kind, synth, *step_args)`` -> the chunk step ("smooth" or
        "ig") compiled through the compiled-step cache, one program per
        (kind, synthesis, argument signature), keyed
        ``{aot_key}|{kind}|synth-{synth}|...`` (`pipeline.aot.cached_entry`;
        the reference tags its key with the synthesis impl the same way,
        ``wam2d._synth_tagged``), ``synth`` the 3D synthesis the step runs
        ("conv" for None)."""
        from wam_tpu_torch.wam2d import _anchor, _aot_entry

        twin = self._compile_twin()
        made: dict = {}

        def steps(kind: str, synth: str | None, *extra):
            tag = (kind, synth) + extra[:1]
            if tag not in made:
                unit = (twin._smooth_step(synth) if kind == "smooth"
                        else twin._ig_step(synth, *extra))
                entry = _aot_entry(unit, f"{aot_key}|{kind}|synth-{synth or 'conv'}", **kw)

                def call(a, y, *rest, entry=entry):
                    # int64 labels, as every caller's labels are read
                    return entry(a, None if y is None else y.long(), _anchor(a.device), *rest)

                made[tag] = call
            return made[tag]

        return steps

    def smooth(self, x, y=None, noise=None) -> torch.Tensor:
        """The mean gradient cube over the noisy samples (B, S, S, S)."""
        self.input_size = x.shape[-1]
        self.grads = self._smooth(x, y, noise)
        return self.grads

    def _smooth(self, x, y=None, noise=None, scale: float = 1.0,
                stream: bool | None = None, steps=None) -> torch.Tensor:
        """`smooth`'s cube, with no instance attribute set. ``scale`` and
        ``stream`` are `_rows`' (a block of a batch); ``steps``
        (`_aot_steps`) runs each chunk compiled."""
        x, y = self._inputs(x, y)
        chunk = self._chunk(x)
        synth = self._synth(x)
        stream = self.stream_noise if stream is None else stream
        vol = x[:, 0]
        spatial = tuple(vol.shape[-3:])
        if self.mesh is not None:
            if noise is not None:
                noise = torch.as_tensor(noise, device=self.device)
                noise = noise.reshape((noise.shape[0],) + tuple(vol.shape))
            return self._seq.smoothgrad(vol, y, self.random_seed, n_samples=self.n_samples,
                                        stdev_spread=self.stdev_spread,
                                        sample_chunk=chunk, noise=noise)

        run = self._smooth_step(synth, scale) if steps is None else steps("smooth", synth)

        def step(noisy: torch.Tensor) -> torch.Tensor:  # (s, B, D, H, W)
            return run(noisy, y)

        generator = None
        if noise is not None:
            noise = torch.as_tensor(noise, device=self.device)
            noise = noise.reshape((noise.shape[0],) + tuple(vol.shape))
        elif not stream:
            generator = torch.Generator(device=self.device).manual_seed(self.random_seed)
        return smoothgrad(step, vol, n_samples=self.n_samples, stdev_spread=self.stdev_spread,
                          batch_size=chunk, generator=generator, noise=noise,
                          materialize_noise=not stream, seed=self.random_seed)

    def integrated_wam(self, x, y=None) -> torch.Tensor:
        """The input coefficients' cube times the trapezoidal path integral
        of the gradient cubes (B, S, S, S)."""
        self.input_size = x.shape[-1]
        self.grads = self._integrated(x, y)
        return self.grads

    def _integrated(self, x, y=None, scale: float = 1.0, steps=None) -> torch.Tensor:
        """`integrated_wam`'s cube, with no instance attribute set;
        ``scale`` is `_rows`'; ``steps`` (`_aot_steps`) runs each chunk
        compiled."""
        x, y = self._inputs(x, y)
        chunk = self._chunk(x)
        synth = self._synth(x)
        vol = x[:, 0]
        spatial = tuple(vol.shape[-3:])
        if self.mesh is not None:
            coeffs, integral = self._seq.integrated(vol, y, n_steps=self.n_samples,
                                                    sample_chunk=chunk)
            return cube3d(coeffs) * integral
        with torch.no_grad():
            coeffs = self.engine.decompose(vol)
        baseline = cube3d(coeffs)
        leaves = _flatten(coeffs)
        like = _unflatten([None] * len(leaves), coeffs)  # the structure alone
        if steps is None:
            run, extra = self._ig_step(synth, spatial, like, scale), (None,)
        else:
            run, extra = steps("ig", synth, spatial, like), ()

        def grad_fn(alphas: torch.Tensor) -> torch.Tensor:  # (s,)
            return run(alphas, y, *extra, *leaves)

        return baseline * integrated_path(grad_fn, n_steps=self.n_samples,
                                          batch_size=chunk, device=self.device)

    intergrated_wam = integrated_wam  # the reference's spelling

    def __call__(self, x, y=None, noise=None) -> torch.Tensor:
        if self.method == "smooth":
            return self.smooth(x, y, noise)
        if noise is not None:
            raise ValueError("noise= applies to method='smooth' only")
        return self.integrated_wam(x, y)

    def serve_entry(self, donate: bool | None = None, on_trace=None,
                    aot_key: str | None = None, with_health: bool = False):
        """Batched serving entry ``(x, y) -> cube (B, S, S, S)`` for the
        `wam_tpu_torch.serve` worker: x is (B, 1, D, H, W) volumes as fed to
        ``__call__``, y is (B,) int labels (the serve path is labeled-only).
        The estimator body without the ``self.grads`` / ``self.input_size``
        stashing that makes ``__call__`` thread-unsafe. SmoothGrad seeds its
        generator with the instance seed on every call. ``mesh=`` is
        rejected: the serving worker owns one device. ``with_health=True``
        computes the numeric-health vector over the cube in the same call
        (`serve.entry.jit_entry`). The entry carries the
        `serve.entry.RowBlocks` of `_rows` (the fleet's "pjit" oversize
        route). With ``aot_key`` each chunk step (`_smooth_step`, `_ig_step`)
        is a program of the compiled-step cache (`pipeline.aot`,
        `_aot_steps`); the noise draws and the loop over chunks stay
        eager."""
        if self.mesh is not None:
            raise ValueError(
                "serve_entry() does not support mesh=; the serve worker owns "
                "a single device — drive the sharded estimator directly")
        from wam_tpu_torch.serve.entry import RowBlocks, jit_entry

        impl = self._smooth if self.method == "smooth" else self._integrated

        def entry_impl(x, y):
            return impl(x, y)

        def wam_aot(key, **kw):
            steps = self._aot_steps(key, **kw)
            return lambda x, y: impl(x, y, steps=steps)

        entry_impl.wam_aot = wam_aot
        return jit_entry(entry_impl, donate=donate, on_trace=on_trace, aot_key=aot_key,
                         with_health=with_health, blocks=RowBlocks.local(self._rows))

    def _rows(self, x, y, lo: int, total: int) -> torch.Tensor:
        """Rows [lo, lo + len(x)) of the entry's cube on a ``total``-row
        batch: SmoothGrad's draws are the whole batch's cut to these rows,
        and the gradients are scaled to the whole batch's loss
        (`RowBlocks.local`)."""
        scale = x.shape[0] / total
        if self.method != "smooth":
            return self._integrated(x, y, scale)
        vol = torch.as_tensor(x, device=self.device)[:, 0]
        draw = block_draws(self.random_seed, self.n_samples, (total,) + tuple(vol.shape[1:]), lo,
                           vol.shape[0], vol.device, vol.dtype, self.stream_noise)
        return self._smooth(x, y, draw(0, self.n_samples), scale, stream=False)

    def visualize(self) -> torch.Tensor:
        """(B, J+2, S, S, S) per-level upsampled maps of the last cube."""
        return visualize_cube(self.grads, self.J)
