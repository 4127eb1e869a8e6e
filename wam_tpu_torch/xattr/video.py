"""Video WAM: wavelet attribution over 2D space and time (PyTorch port of
`wam_tpu.xattr.video`).

Clips are (B, C, T, H, W). Video is anisotropic (far more structure in
space than from frame to frame), so `VideoLevels(spatial=J_s,
temporal=J_t)` decomposes the finest ``J_t`` levels with the separable 3D
DWT (space and time, `transform.dwt3`) and the remaining ``J_s - J_t`` with
the 2D DWT alone, the decimated time riding as a batch axis
(`transform.dwt2` / `idwt2`). ``VideoLevels(J, J)`` is the uniform
`wavedec3` cube; ``VideoLevels(J, 0)`` is per-frame 2D WAM.

The spatial-only levels go through the 2D transform's ``impl`` (None: the
CUDA kernels on CUDA tensors, K1 for analysis and K2 for each synthesis
level, whose backward is K1 again; the conv form on CPU tensors); the 3D
levels through ``conv3d`` / ``conv_transpose3d``, as `wam3d`.

Attribution follows `WaveletAttribution3D`: decompose, take the gradient of
the target logit with respect to every coefficient through the
reconstruction, aggregate. The aggregate is `spacetime_map`: each level's
|gradient| nearest-resized to the clip's (T, H, W) box (the reference's
float32 index arithmetic, `ops.filters.upsample_nearest`) and summed.
`frame_importance` reduces a box to (B, T) per-frame scores, which the
temporal insertion/deletion fan ranks (`xattr.video_eval`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from wam_tpu_torch.core.engine import _flatten, _unflatten, map_coeffs, target_loss
from wam_tpu_torch.core.estimators import (
    block_draws,
    integrated_path,
    resolve_sample_chunk,
    smoothgrad,
    validate_sample_batch_size,
)
from wam_tpu_torch.device import resolve_device
from wam_tpu_torch.ops.filters import upsample_nearest
from wam_tpu_torch.wavelets.filters import build_wavelet
from wam_tpu_torch.wavelets.transform import DETAIL3D_KEYS, dwt2, dwt3, idwt2, idwt3

__all__ = [
    "VideoLevels",
    "wavedec_video",
    "waverec_video",
    "spacetime_map",
    "frame_importance",
    "WaveletAttributionVideo",
]


@dataclasses.dataclass(frozen=True)
class VideoLevels:
    """Anisotropic depth: ``spatial`` levels in all, of which the finest
    ``temporal`` also decimate time."""

    spatial: int
    temporal: int

    def __post_init__(self):
        if self.spatial < 1:
            raise ValueError(f"spatial={self.spatial} must be >= 1")
        if not 0 <= self.temporal <= self.spatial:
            raise ValueError(f"temporal={self.temporal} must satisfy "
                             f"0 <= temporal <= spatial (={self.spatial})")

    @property
    def uniform(self) -> bool:
        return self.temporal == self.spatial


def _as_levels(levels) -> VideoLevels:
    if isinstance(levels, VideoLevels):
        return levels
    s, t = levels
    return VideoLevels(spatial=int(s), temporal=int(t))


def wavedec_video(x: torch.Tensor, wavelet, levels, mode: str = "symmetric",
                  impl: str | None = None):
    """Anisotropic multi-level DWT over the last three axes (T, H, W):
    ``[cA, det_J, ..., det_1]``, coarsest first like `wavedec3`; a 3D
    level's detail is a dict of `DETAIL3D_KEYS`, a spatial-only level's a
    `Detail2D` (``impl``: the 2D transform's, `transform.dwt2`)."""
    lv = _as_levels(levels)
    coeffs = []
    a = x
    for j in range(lv.spatial):
        if j < lv.temporal:
            a, det = dwt3(a, wavelet, mode)
        else:
            a, det = dwt2(a, wavelet, mode, impl)
        coeffs.append(det)
    coeffs.append(a)
    return coeffs[::-1]


def waverec_video(coeffs, wavelet, impl: str | None = None) -> torch.Tensor:
    """Inverse of `wavedec_video`, each level's approximation trimmed to
    its details' shape as `waverec3` / `waverec2` do. The result may exceed
    the original (T, H, W) by the boundary pads; callers crop."""
    L = build_wavelet(wavelet).filt_len if isinstance(wavelet, str) else wavelet.filt_len
    a = coeffs[0]
    for det in coeffs[1:]:
        if isinstance(det, dict):
            tgt = det["ddd"].shape[-3:]
            a = a[..., : tgt[0], : tgt[1], : tgt[2]]
            a = idwt3(a, det, wavelet, out_shape=tuple(2 * s - L + 2 for s in tgt))
        else:
            tgt = det.horizontal.shape[-2:]
            a = a[..., : tgt[0], : tgt[1]]
            a = idwt2(a, det, wavelet, out_shape=(2 * tgt[0] - L + 2, 2 * tgt[1] - L + 2),
                      impl=impl)
    return a


def coeff_leaves(coeffs, include_approx: bool = True):
    """Every (..., t, h, w) leaf of a video coefficient list: the
    approximation (when ``include_approx``), then each level's Detail2D
    fields or 3D values."""
    if include_approx:
        yield coeffs[0]
    for det in coeffs[1:]:
        if isinstance(det, dict):
            yield from (det[k] for k in DETAIL3D_KEYS)
        else:
            yield from det


def spacetime_map(grads, shape, approx_coeffs: bool = False) -> torch.Tensor:
    """A `wavedec_video` gradient list collapsed to one (..., T, H, W) box:
    each leaf's |gradient| nearest-resized to ``shape`` and summed (the
    approximation joins only with ``approx_coeffs``, as in the 2D and 3D
    engines)."""
    shape = tuple(int(s) for s in shape)
    total = None
    for g in coeff_leaves(grads, approx_coeffs):
        up = upsample_nearest(g.abs(), shape)
        total = up if total is None else total + up
    return total


def frame_importance(box: torch.Tensor) -> torch.Tensor:
    """(..., T, H, W) box -> (..., T) per-frame scores (the spatial mean)."""
    return box.mean(dim=(-2, -1))


class WaveletAttributionVideo:
    """SmoothGrad / IG WAM over clips (B, C, T, H, W).

    ``__call__(x, y=None, noise=None)`` returns the (B, T, H, W) spacetime
    box, averaged over channels; `frame_scores` its (B, T) frame scores.
    ``model_fn`` maps clips (B, C, T, H, W) to logits (B, K) (the 3D ResNet
    takes (B, 1, T, H, W) as it is). SmoothGrad averages the boxes of
    ``n_samples`` noisy clips, per-clip sigma = stdev_spread * (max - min);
    IG is in the coefficient domain as in `WaveletAttribution3D`: the
    coefficients times the trapezoid of their gradients along alpha *
    coefficients, then aggregated.

    ``sample_batch_size`` samples (path points) run as one batch of
    sample_batch_size * B model rows ("auto" and None: all at once), each
    keeping its own loss scale. SmoothGrad noise: standard-normal draws from
    a ``torch.Generator`` on the device seeded with ``random_seed``, the
    explicit ``noise`` (n_samples, *x.shape) given to ``__call__``, or with
    ``stream_noise=True`` sample i's from (random_seed, i)
    (`core.estimators.sample_noise`).

    ``device``: CUDA unless the caller asks otherwise; ``impl``: the
    spatial-only levels' 2D transform (None: the kernels on CUDA).
    ``synth_impl``: those levels' synthesis; None takes ``impl`` when
    given, else the tuned ``synth_impl`` of the call's schedule key
    ("wamvid3d"), else the process knob. A tuned entry applies to the call
    it matches only.
    ``mesh=`` shards the TIME axis over the mesh's ``seq_axis`` like the 3D
    depth (`parallel.SeqShardedWam`, one built lazily per (T, H, W) since
    the box's geometry is its ``post_fn``; ``batch_axis`` splits the batch,
    ``seq_fused`` is its ``fused``): uniform levels, single-channel clips
    and SmoothGrad only, with the reference's ValueErrors. Its noise is
    sample i's ``sample_noise(random_seed, i)`` on the (B, T, H, W) clip or
    the handed ``noise``.
    """

    def __init__(
        self,
        model_fn: Callable[[torch.Tensor], torch.Tensor],
        wavelet: str = "haar",
        levels=(3, 1),
        method: str = "smooth",
        mode: str = "symmetric",
        approx_coeffs: bool = False,
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
        synth_impl: str | None = None,
    ):
        if method not in ("smooth", "integratedgrad"):
            raise ValueError(f"Unknown method {method!r}")
        validate_sample_batch_size(sample_batch_size)
        self.levels = _as_levels(levels)
        if mesh is not None and not self.levels.uniform:
            raise ValueError(
                "mesh= (long-clip time sharding) requires uniform levels "
                f"(spatial == temporal); got {self.levels} — the halo layer "
                "shards the axis every level decimates")
        if mesh is None and batch_axis is not None:
            raise ValueError("batch_axis= requires mesh=")
        self.mesh = mesh
        self.seq_axis = seq_axis
        self.batch_axis = batch_axis
        self.seq_fused = seq_fused
        self._seq_cache: dict = {}
        self.device = resolve_device(device)
        self.model_fn = model_fn
        self.wavelet = wavelet
        self.method = method
        self.mode = mode
        self.approx_coeffs = approx_coeffs
        self.n_samples = n_samples
        self.stdev_spread = stdev_spread
        self.random_seed = random_seed
        self.sample_batch_size = sample_batch_size
        self.stream_noise = bool(stream_noise)
        self.impl = impl
        self.synth_impl = synth_impl
        self.grads = None

    def _inputs(self, x, y):
        x = torch.as_tensor(x, device=self.device)
        if y is not None:
            y = torch.as_tensor(y, device=self.device)
        return x, y

    def _chunk(self, clip) -> int | None:
        """sample_batch_size resolved for the clips (B, C, T, H, W): explicit,
        or for "auto" the tuned chunk of the schedule key ("wamvid3d", the
        item shape, batch, backend), else every sample at once."""
        return resolve_sample_chunk(self.sample_batch_size, self.n_samples, workload="wamvid3d",
                                    shape=tuple(clip.shape[1:]), batch=int(clip.shape[0]),
                                    backend=clip.device.type)

    def _synth(self, clip) -> str | None:
        """The spatial-only levels' synthesis impl of a call on ``clip``
        (`synth_impl` in the class docstring)."""
        if self.synth_impl is not None or self.impl is not None:
            return self.synth_impl or self.impl
        from wam_tpu_torch.tune.cache import tuned_synth_impl

        return tuned_synth_impl("wamvid3d", tuple(clip.shape[1:]), int(clip.shape[0]),
                                backend=clip.device.type)

    def _decompose(self, clip: torch.Tensor):
        with torch.no_grad():
            return wavedec_video(clip, self.wavelet, self.levels, self.mode, self.impl)

    def _coeff_grads(self, coeffs, y, shape, s: int, scale: float = 1.0,
                     synth: str | None = None):
        """Gradient of the target loss w.r.t. every coefficient of ``s``
        stacked copies of the batch (rows sample-major): the loss is the sum
        over copies of each copy's batch mean, times ``scale`` (`_rows`).
        ``synth``: `_synth`'s."""
        leaves = [c.detach().requires_grad_(True) for c in _flatten(coeffs)]
        t, h, w = shape
        with torch.enable_grad():
            rec = waverec_video(_unflatten(leaves, coeffs), self.wavelet, synth)
            out = self.model_fn(rec[..., :t, :h, :w])
            loss = target_loss(out, None if y is None else y.repeat(s)) * s
            grads = torch.autograd.grad(loss, leaves)
        if scale != 1.0:
            grads = [g * scale for g in grads]
        return _unflatten(grads, coeffs)

    def _boxes(self, grads, shape, s: int) -> torch.Tensor:
        """(s*B, C, ...) gradient list -> (s, B, T, H, W) channel-mean boxes."""
        box = spacetime_map(grads, shape, self.approx_coeffs).mean(dim=1)
        return box.reshape((s, -1) + tuple(box.shape[1:]))

    # -- SmoothGrad --------------------------------------------------------

    def smooth(self, x, y=None, noise=None) -> torch.Tensor:
        self.grads = self._smooth(x, y, noise)
        return self.grads

    def _get_seq(self, clip_shape):
        """The lazy per-(T, H, W) `SeqShardedWam`: its post_fn bakes in the
        clip geometry, which the constructor does not know."""
        key = tuple(int(s) for s in clip_shape[-3:])
        if key not in self._seq_cache:
            from wam_tpu_torch.parallel.seq_estimators import SeqShardedWam

            self._seq_cache[key] = SeqShardedWam(
                self.mesh, lambda rec: self.model_fn(rec[:, None]), ndim=3,
                wavelet=self.wavelet, level=self.levels.spatial, mode=self.mode,
                seq_axis=self.seq_axis,
                post_fn=lambda g: spacetime_map(g, key, self.approx_coeffs),
                batch_axis=self.batch_axis, fused=self.seq_fused)
        return self._seq_cache[key]

    def _smooth(self, x, y=None, noise=None, scale: float = 1.0,
                stream: bool | None = None) -> torch.Tensor:
        """`smooth`'s box, with no instance attribute set. ``scale`` and
        ``stream`` are `_rows`' (a block of a batch)."""
        clip, y = self._inputs(x, y)
        chunk = self._chunk(clip)
        synth = self._synth(clip)
        stream = self.stream_noise if stream is None else stream
        shape = tuple(clip.shape[-3:])
        if self.mesh is not None:
            if clip.shape[1] != 1:
                raise ValueError(
                    "mesh= long-clip dispatch supports single-channel clips "
                    f"(C=1); got C={clip.shape[1]}")
            if noise is not None:
                noise = torch.as_tensor(noise, device=self.device)[:, :, 0]
            return self._get_seq(clip.shape).smoothgrad(
                clip[:, 0], y, self.random_seed, n_samples=self.n_samples,
                stdev_spread=self.stdev_spread, sample_chunk=chunk, noise=noise)

        def step(noisy: torch.Tensor) -> torch.Tensor:  # (s, B, C, T, H, W)
            s = noisy.shape[0]
            coeffs = self._decompose(noisy.reshape((-1,) + tuple(noisy.shape[2:])))
            return self._boxes(self._coeff_grads(coeffs, y, shape, s, scale, synth), shape, s)

        generator = None
        if noise is not None:
            noise = torch.as_tensor(noise, device=self.device)
        elif not stream:
            generator = torch.Generator(device=self.device).manual_seed(self.random_seed)
        return smoothgrad(step, clip, n_samples=self.n_samples, stdev_spread=self.stdev_spread,
                          batch_size=chunk, generator=generator, noise=noise,
                          materialize_noise=not stream, seed=self.random_seed)

    # -- Integrated Gradients ----------------------------------------------

    def integrated_wam(self, x, y=None) -> torch.Tensor:
        self.grads = self._integrated(x, y)
        return self.grads

    def _integrated(self, x, y=None, scale: float = 1.0) -> torch.Tensor:
        """`integrated_wam`'s box, with no instance attribute set; ``scale``
        is `_rows`'."""
        if self.mesh is not None:
            raise ValueError(
                "mesh= supports method='smooth' only for video — the IG "
                "path's coefficient-domain multiply needs the gathered "
                "pytree; run IG unsharded or via chunked batches")
        clip, y = self._inputs(x, y)
        chunk = self._chunk(clip)
        synth = self._synth(clip)
        shape = tuple(clip.shape[-3:])
        coeffs = self._decompose(clip)

        def grad_fn(alphas: torch.Tensor) -> list:  # (s,) -> per leaf (s, B, ...)
            s = alphas.shape[0]

            def along(c):
                a = alphas.to(c.dtype).reshape((-1,) + (1,) * c.ndim)
                return (c[None] * a).reshape((-1,) + tuple(c.shape[1:]))

            grads = self._coeff_grads(map_coeffs(along, coeffs), y, shape, s, scale, synth)
            return [g.reshape((s, -1) + tuple(g.shape[1:])) for g in _flatten(grads)]

        integral = integrated_path(grad_fn, n_steps=self.n_samples, batch_size=chunk,
                                   device=self.device)
        attr = _unflatten([c * g for c, g in zip(_flatten(coeffs), integral)], coeffs)
        return spacetime_map(attr, shape, self.approx_coeffs).mean(dim=1)

    def __call__(self, x, y=None, noise=None) -> torch.Tensor:
        if self.method == "smooth":
            return self.smooth(x, y, noise)
        if noise is not None:
            raise ValueError("noise= applies to method='smooth' only")
        return self.integrated_wam(x, y)

    def frame_scores(self, x, y=None, noise=None) -> torch.Tensor:
        """(B, T) per-frame importance: `frame_importance` of the box."""
        return frame_importance(self(x, y, noise))

    def serve_entry(self, donate: bool | None = None, on_trace=None,
                    aot_key: str | None = None, with_health: bool = False):
        """Batched serving entry ``(x, y) → (B, T, H, W)`` for the serve
        worker (labeled-only, one device — the contract of
        `WaveletAttribution3D.serve_entry`), with the
        `serve.entry.RowBlocks` of `_rows`."""
        if self.mesh is not None:
            raise ValueError(
                "serve_entry() does not support mesh=; the serve worker owns "
                "a single device — drive the sharded estimator directly")
        from wam_tpu_torch.serve.entry import RowBlocks, jit_entry

        impl = self._smooth if self.method == "smooth" else self._integrated
        return jit_entry(lambda x, y: impl(x, y), donate=donate, on_trace=on_trace,
                         aot_key=aot_key, with_health=with_health,
                         blocks=RowBlocks.local(self._rows))

    def _rows(self, x, y, lo: int, total: int) -> torch.Tensor:
        """Rows [lo, lo + len(x)) of the entry's box on a ``total``-row
        batch: SmoothGrad's draws are the whole batch's cut to these rows,
        and the gradients are scaled to the whole batch's loss
        (`RowBlocks.local`)."""
        scale = x.shape[0] / total
        if self.method != "smooth":
            return self._integrated(x, y, scale)
        clip = torch.as_tensor(x, device=self.device)
        draw = block_draws(self.random_seed, self.n_samples, (total,) + tuple(clip.shape[1:]), lo,
                           clip.shape[0], clip.device, clip.dtype, self.stream_noise)
        return self._smooth(x, y, draw(0, self.n_samples), scale, stream=False)
