"""Sequence-sharded SmoothGrad / Integrated-Gradients estimators (PyTorch
port of `wam_tpu.parallel.seq_estimators`).

The SmoothGrad sample loop and the IG alpha-path over the sequence-sharded
decompose -> reconstruct -> model -> gradients core of `halo` (periodized)
and `halo_modes` (the engines' expansive modes): the transforms, the
coefficient leaves and the accumulators stay in blocks over the mesh's
``seq_axis``, one ring exchange a level.

Design, where the port departs from the reference:

- **Noise.** JAX's threefry and torch's Philox never agree, and Philox
  draws are not sharding-invariant when sliced. Sample i is therefore drawn
  at the WHOLE input's shape by `core.estimators.sample_noise(seed, i, ...)`
  on the input's device and then split over the blocks (or taken from a
  handed ``noise`` (n_samples, *x.shape)). Its noisy input and gradient
  are then the port's single-device ``smoothgrad(materialize_noise=False,
  seed=...)`` sample's, as the reference's equal its own single-device
  stream; the mean differs only by summation order. The cost is one
  sample's x-sized noise buffer on the input's device.
- **The model is not partitioned over the sequence axis.** The reference
  lets GSPMD partition the model; PyTorch has nothing that partitions an
  arbitrary ``nn.Module`` spatially. The blocks' reconstruction is
  concatenated on the model's device (block 0's), the model and its
  backward run there, the input gradient is split back onto the blocks,
  and the synthesis adjoint runs on each block. Across processes every
  rank gathers the whole reconstruction (each block broadcast by its owner)
  and runs the model on it.
- **Steps.** Each sample / chunk / alpha-step is one call of a step
  (``fused=True``: draw, decompose, gradients and accumulation in one
  call) or of the split loop's pieces (``fused=False``: draw, decompose,
  gradients, accumulation), the same operations in the same order, so the
  two are bit-equal; ``dispatch_count`` counts step calls and advances by
  the reference's counts on the same calls. ``"auto"`` reads the schedule
  cache's ``wamseq{n}d`` entry (`wam_tpu_torch.tune`: ``seq_fused``,
  ``sample_chunk``) and without one resolves to ``fused=True`` and
  ``sample_chunk=1``, the reference's no-entry fallbacks.
- **First calls.** A step's first call at a new input signature reports
  to `obs.sentinel` under kind ``"seq"`` (the reference reports its jits'
  traces there).

Inputs are BATCHED (x.ndim > ndim); an unbatched signal is refused, as in
the reference.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from wam_tpu_torch.core.engine import target_loss
from wam_tpu_torch.core.estimators import noise_sigma, sample_noise
from wam_tpu_torch.obs import sentinel as obs_sentinel
from wam_tpu_torch.parallel import halo, halo_modes
from wam_tpu_torch.parallel.halo import Sharded, _gmap
from wam_tpu_torch.parallel.halo_modes import TailedLeaf
from wam_tpu_torch.parallel.mesh import Mesh
from wam_tpu_torch.parallel.tree import tree_leaves, tree_map, tree_zip_map
from wam_tpu_torch.wavelets.transform import Detail2D

__all__ = ["seq_sharded_wam", "SeqShardedWam"]

_DEC_PER = {1: halo.sharded_wavedec_per, 2: halo.sharded_wavedec2_per,
            3: halo.sharded_wavedec3_per}
_REC_PER = {1: halo.sharded_waverec_per, 2: halo.sharded_waverec2_per,
            3: halo.sharded_waverec3_per}
_DEC_MODE = {1: halo_modes.sharded_wavedec_mode, 2: halo_modes.sharded_wavedec2_mode,
             3: halo_modes.sharded_wavedec3_mode}
_REC_MODE = {1: halo_modes.sharded_waverec_mode, 2: halo_modes.sharded_waverec2_mode,
             3: halo_modes.sharded_waverec3_mode}


def _map_coeffs(tree, block_fn, tail_fn):
    """``block_fn`` over every block, ``tail_fn`` over every tail of a
    coefficient tree (Sharded / TailedLeaf leaves, Detail2D / dict levels)."""
    if isinstance(tree, Sharded):
        return tree.map_blocks(block_fn)
    if isinstance(tree, TailedLeaf):
        return TailedLeaf(tree.core.map_blocks(block_fn),
                          None if tree.tail is None else tail_fn(tree.tail))
    if isinstance(tree, dict):
        return {k: _map_coeffs(v, block_fn, tail_fn) for k, v in tree.items()}
    if isinstance(tree, Detail2D):
        return Detail2D(*(_map_coeffs(f, block_fn, tail_fn) for f in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_coeffs(c, block_fn, tail_fn) for c in tree)
    return tree


def _by_groups(fn, groups: int):
    """``fn`` on (groups, rows...) views of a tail whose rows are group-major."""
    def run(t):
        return fn(t.reshape((groups, -1) + tuple(t.shape[1:]))).flatten(0, 1)

    return run


def _signature(args) -> tuple:
    return tuple((tuple(t.shape), str(t.dtype), str(t.device)) for t in tree_leaves(args))


class SeqShardedWam:
    """Sequence-sharded WAM gradient core and estimators for one modality.

    Parameters mirror `core.engine.WamEngine` plus the mesh geometry:
    ``seq_axis`` names the mesh axis the sequence dimension (last for
    ndim=1, rows for ndim=2, depth for ndim=3) is split over, ``batch_axis``
    a second axis the leading axis is split over. ``front_fn`` is the
    optional differentiable front end between the reconstruction and the
    model (the 1D mel); with ``front_grads`` its output's gradient is
    returned beside the coefficient gradients. ``post_fn`` maps the
    GATHERED per-sample coefficient-gradient tree to the per-sample output
    (the 2D mosaic, the 3D cube); identity when None.

    ``model_fn`` takes the whole reconstruction on the mesh's model device
    (block 0's; module docstring). ``fused``: True, False or "auto" (the
    tuned ``seq_fused``, else True).
    ``dwt_bf16`` casts the signal to bfloat16 at the decompose boundary; the
    transforms read it as float32. ``dispatch_count`` counts step calls.
    """

    def __init__(
        self,
        mesh: Mesh,
        model_fn: Callable[[torch.Tensor], torch.Tensor],
        *,
        ndim: int,
        wavelet: str = "haar",
        level: int = 3,
        mode: str = "symmetric",
        seq_axis: str = "data",
        front_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
        front_grads: bool = False,
        post_fn: Callable[[Any], Any] | None = None,
        batch_axis: str | None = None,
        fused: bool | str = True,
        dwt_bf16: bool = False,
    ):
        if ndim not in (1, 2, 3):
            raise ValueError(f"ndim must be 1, 2 or 3, got {ndim}")
        if front_grads and front_fn is None:
            raise ValueError("front_grads=True requires front_fn")
        if front_grads and post_fn is not None:
            raise ValueError("front_grads and post_fn are mutually exclusive")
        if fused not in (True, False, "auto"):
            raise ValueError(f"fused must be True, False or 'auto'; "
                             f"got {fused!r}")
        if batch_axis is not None:
            if batch_axis not in mesh.axis_names:
                raise ValueError(
                    f"batch_axis {batch_axis!r} is not a mesh axis "
                    f"{tuple(mesh.axis_names)}"
                )
            if batch_axis == seq_axis:
                raise ValueError("batch_axis must differ from seq_axis")
        self.mesh = mesh
        self.ndim = ndim
        self.seq_axis = seq_axis
        self.batch_axis = batch_axis
        self.front_fn = front_fn
        self.front_grads = front_grads
        self.post_fn = post_fn
        self.model_fn = model_fn
        self.fused = fused
        self.dwt_bf16 = dwt_bf16
        self.dispatch_count = 0  # step calls launched by the entry points
        self.periodized = mode == "periodization"
        if self.periodized:
            self.dec = _DEC_PER[ndim](mesh, wavelet, level, seq_axis, batch_axis)
            self._rec = _REC_PER[ndim](mesh, wavelet, seq_axis, batch_axis)
        else:
            self.dec = _DEC_MODE[ndim](mesh, wavelet, level, mode, seq_axis, batch_axis)
            self._rec = _REC_MODE[ndim](mesh, wavelet, seq_axis, batch_axis)
        self.ring = self.dec.ring
        self._seen: set = set()

    # -- plumbing ----------------------------------------------------------

    def _call(self, name: str, fn, *args):
        """One step call, counted; its first call at a new signature (the
        shape, dtype and device of every tensor argument) reports to the
        compile sentinel."""
        self.dispatch_count += 1
        sig = (name, _signature(args))
        if sig not in self._seen:
            self._seen.add(sig)
            obs_sentinel.record_trace("seq", detail=name)
        return fn(*args)

    def _check_batched(self, x):
        if x.ndim <= self.ndim:
            raise ValueError(
                f"SeqShardedWam(ndim={self.ndim}) takes BATCHED inputs "
                f"(rank > {self.ndim}); got rank {x.ndim} {tuple(x.shape)} — add a "
                f"leading batch axis (x[None]) for a single signal")

    def _dec_input(self, sig: torch.Tensor) -> torch.Tensor:
        return sig.to(torch.bfloat16) if self.dwt_bf16 else sig

    def _gather(self, tree, samples: int = 1, x_lead: tuple = ()):
        """A coefficient(-gradient) tree gathered to plain tensors on the
        model device, the reference's single-device structure. ``samples``
        > 1: leaves (samples, *x_lead, ...) from a chunk's sample-major
        rows."""
        g = self.ring.g

        def leaf(c):
            if isinstance(c, Sharded):
                t = c.gather(samples=samples)
            else:
                t = c.core.gather(samples=samples)
                tail = c.tail
                if tail is not None and tail.shape[-self.ndim] > 0:
                    if c.core.ring.distributed:
                        ring = c.core.ring
                        tail = halo.broadcast_from(ring, tail, (0, ring.k - 1), tail)
                    if samples > 1:  # group-major (G, s, r) rows -> sample-major
                        tail = tail.reshape((g, samples, -1) + tuple(tail.shape[1:]))
                        tail = tail.transpose(0, 1).flatten(0, 2)
                    t = torch.cat([t, tail.to(t.device)], dim=-self.ndim)
            if samples > 1:
                t = t.reshape((samples,) + tuple(x_lead) + tuple(t.shape[1:]))
            return t

        out = []
        for c in tree:
            if isinstance(c, Detail2D):
                out.append(Detail2D(*(leaf(f) for f in c)))
            elif isinstance(c, dict):
                out.append({k: leaf(v) for k, v in c.items()})
            else:
                out.append(leaf(c))
        return out

    def _rec_signal(self, cs, samples: int, x_shape) -> torch.Tensor:
        """The whole reconstruction on the model device, (samples * B, ...)
        sample-major, cropped to the input's sequence extent."""
        rec = self._rec._apply(cs)
        if not self.periodized:  # a TailedLeaf: its tail is None for even filters
            rec = rec.core if rec.tail is None else self._gather([rec], samples)[0]
        sig = rec.gather(samples=samples) if isinstance(rec, Sharded) else rec
        sig = sig.reshape((-1,) + tuple(x_shape[1:]))
        return sig[(Ellipsis,) + tuple(slice(0, s) for s in x_shape[-self.ndim:])]

    def _split(self, sigs: list[torch.Tensor]) -> Sharded:
        """Whole signals (one per sample) split over the blocks, each block's
        rows sample-major."""
        ring, ndim = self.ring, self.ndim
        x = sigs[0]
        parts = [Sharded.split(s, ring, -ndim, lead_dims=x.ndim - ndim) for s in sigs]
        if len(parts) == 1:
            return parts[0]
        blocks = _gmap(lambda *b: torch.cat(b, dim=0), *[p.blocks for p in parts])
        rows = len(sigs) * parts[0].shape[0]
        return Sharded(blocks, -ndim, ring, (rows,))

    # -- the gradient step -------------------------------------------------

    def _grads_impl(self, cs, y, x_shape, samples: int = 1):
        """Gradient of the engines' loss (mean of the picked logits; with
        ``samples`` stacked copies the sum of each copy's mean) with respect
        to every coefficient block and tail, in the coefficients' structure;
        with ``front_grads`` also the front end output's gradient. With
        ``post_fn`` (one sample) the gathered gradients go through it."""
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(cs)]
        it = iter(leaves)
        cl = tree_map(lambda _: next(it), cs)
        yy = None if y is None else torch.as_tensor(y, device=self.ring.model_device)
        if yy is not None and samples > 1:
            yy = yy.repeat(samples)
        with torch.enable_grad():
            sig = self._rec_signal(cl, samples, x_shape)
            h = self.front_fn(sig) if self.front_fn is not None else sig
            loss = target_loss(self.model_fn(h), yy) * samples
            inputs = leaves + ([h] if self.front_grads else [])
            grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        filled = [torch.zeros_like(t) if gr is None else gr for t, gr in zip(leaves, grads)]
        it = iter(filled)
        g_cs = tree_map(lambda _: next(it), cs)
        if self.front_grads:
            return (g_cs, grads[-1])
        if self.post_fn is not None and samples == 1:
            return self.post_fn(self._gather(g_cs))
        return g_cs

    def _chunk_core(self, cs, y, x_shape, w, g: int, nan: bool):
        """A chunk of ``g`` samples (rows sample-major in every block): the
        ``w``-weighted sum over the samples of their gradients (or of their
        ``post_fn`` outputs), back to the batch's rows."""
        groups = self.ring.g
        out = self._grads_impl(cs, y, x_shape, samples=g)

        def wsum(a):  # (g, ...) -> (...)
            if nan:
                a = torch.nan_to_num(a)
            return (a * w.to(a.device, a.dtype).reshape((g,) + (1,) * (a.ndim - 1))).sum(dim=0)

        block = lambda a: wsum(a.reshape((g, -1) + tuple(a.shape[1:])))  # noqa: E731
        tail = _by_groups(lambda a: torch.stack(
            [block(a[i]) for i in range(a.shape[0])]), groups)
        x_lead = tuple(x_shape[:-self.ndim])
        if self.front_grads:
            g_cs, g_front = out
            return (self._relead(_map_coeffs(g_cs, block, tail), x_lead), block(g_front))
        if self.post_fn is not None:
            per = self._gather(out, g, x_lead)
            pieces = [self.post_fn(tree_map(lambda t, i=i: t[i], per)) for i in range(g)]
            return tree_zip_map(lambda *p: wsum(torch.stack(p)), pieces)
        return self._relead(_map_coeffs(out, block, tail), x_lead)

    # -- the steps (one call each) ------------------------------------------

    def _noisy_impl(self, x, key, i, spread, noise):
        z = (noise[i].to(x.device, x.dtype) if noise is not None
             else sample_noise(key, i, x.shape, x.device, x.dtype))
        sigma = noise_sigma(x, spread).reshape((-1,) + (1,) * (x.ndim - 1))
        return x + z * sigma

    def _noisy_chunk_impl(self, x, key, i0, spread, noise, g, n_samples):
        """``g`` consecutive draws (sample-major blocks); slots past
        ``n_samples`` (a remainder chunk's weight-0 pads) take x itself."""
        sigs = [self._noisy_impl(x, key, i, spread, noise) if i < n_samples else x
                for i in range(i0, i0 + g)]
        return self._split([self._dec_input(s) for s in sigs])

    def _accum_impl(self, acc, g, w):
        return tree_zip_map(lambda a, b: a + w * b, [acc, g])

    def _accum_nan_impl(self, acc, g, w):
        return tree_zip_map(lambda a, b: a + w * torch.nan_to_num(b), [acc, g])

    def _first_nan_impl(self, g, w):
        return tree_map(lambda b: w * torch.nan_to_num(b), g)

    def _scale_impl(self, tree, s):
        return tree_map(lambda a: s * a, tree)

    def _decompose(self, sig):
        with torch.no_grad():
            return self.dec._apply(sig)

    def _fused_attr(self, x, y):
        cs = self._decompose(self._dec_input(x))
        return cs, self._grads_impl(cs, y, tuple(x.shape))

    def _fused_step(self, x, key, i, spread, noise, y):
        cs = self._decompose(self._dec_input(self._noisy_impl(x, key, i, spread, noise)))
        return self._grads_impl(cs, y, tuple(x.shape))

    def _fused_step_acc(self, acc, x, key, i, spread, noise, y):
        return self._accum_impl(acc, self._fused_step(x, key, i, spread, noise, y), 1.0)

    def _fused_chunk(self, x, key, i0, spread, noise, y, w, g, n_samples):
        cs = self._decompose(self._noisy_chunk_impl(x, key, i0, spread, noise, g, n_samples))
        return self._chunk_core(cs, y, tuple(x.shape), w, g, nan=False)

    def _fused_chunk_acc(self, acc, x, key, i0, spread, noise, y, w, g, n_samples):
        part = self._fused_chunk(x, key, i0, spread, noise, y, w, g, n_samples)
        return self._accum_impl(acc, part, 1.0)

    def _grads_ig(self, cs, alpha, y, x_shape):
        return self._grads_impl(_map_coeffs(cs, lambda c: c * alpha, lambda c: c * alpha),
                                y, x_shape)

    def _fused_ig_first(self, cs, alpha, w, y, x_shape):
        return self._first_nan_impl(self._grads_ig(cs, alpha, y, x_shape), w)

    def _fused_ig_step(self, acc, cs, alpha, w, y, x_shape):
        return self._accum_nan_impl(acc, self._grads_ig(cs, alpha, y, x_shape), w)

    def _grads_ig_chunk(self, cs, alphas, y, w, x_shape):
        """IG chunk: the coefficients repeated once a path point (sample-
        major rows in every block, group-major in the tails), each copy
        scaled by its alpha; trapezoid weights ``w`` (0 for pads) with
        nan_to_num."""
        g = alphas.shape[0]

        def rep(c):
            a = alphas.to(c.device, c.dtype).reshape((g,) + (1,) * c.ndim)
            return (c[None] * a).reshape((g * c.shape[0],) + tuple(c.shape[1:]))

        tail = _by_groups(lambda t: torch.stack([rep(t[i]) for i in range(t.shape[0])]),
                          self.ring.g)
        rows = g * math.prod(x_shape[:-self.ndim])
        scaled = self._relead(_map_coeffs(cs, rep, tail), (rows,))
        return self._chunk_core(scaled, y, x_shape, w, g, nan=True)

    def _relead(self, tree, lead: tuple):
        """A coefficient tree with its leading dims read as ``lead``: every
        `Sharded` leaf's, every tail reshaped to it."""
        def walk(c):
            if isinstance(c, Sharded):
                return Sharded(c.blocks, c.axis, c.ring, lead)
            if isinstance(c, TailedLeaf):
                t = c.tail
                return TailedLeaf(walk(c.core), None if t is None else
                                  t.reshape(lead + tuple(t.shape[t.ndim - self.ndim:])))
            if isinstance(c, Detail2D):
                return Detail2D(*(walk(f) for f in c))
            if isinstance(c, dict):
                return {k: walk(v) for k, v in c.items()}
            return c

        return [walk(c) for c in tree]

    def _fused_ig_chunk_acc(self, acc, cs, alphas, y, w, x_shape):
        return self._accum_impl(acc, self._grads_ig_chunk(cs, alphas, y, w, x_shape), 1.0)

    def _finalize(self, tree):
        """The accumulated tree in the reference's single-device structure
        (gathered; identity for ``post_fn`` outputs)."""
        if self.post_fn is not None:
            return tree
        if self.front_grads:
            return (self._gather(tree[0]), tree[1])
        return self._gather(tree)

    # -- the schedule knobs ("auto": the schedule cache, wam_tpu_torch.tune) --

    def _lookup(self, x):
        from wam_tpu_torch.tune.cache import lookup_schedule

        return lookup_schedule(f"wamseq{self.ndim}d", tuple(x.shape[1:]), int(x.shape[0]),
                               backend=x.device.type)

    def _resolve_fused(self, x) -> bool:
        """``fused="auto"``: the tuned ``seq_fused`` of the ``wamseq{n}d`` key,
        else True (one step a sample)."""
        if self.fused != "auto":
            return bool(self.fused)
        ent = self._lookup(x)
        if ent is not None and "seq_fused" in ent:
            return bool(ent["seq_fused"])
        return True

    def _resolve_seq_chunk(self, sample_chunk, x, n: int) -> int:
        """``sample_chunk``: None is all ``n``; "auto" the tuned chunk of the
        ``wamseq{n}d`` key (None in the entry: all), else 1 (one sample a
        step, never every sequence-sized sample at once)."""
        if sample_chunk == "auto":
            ent = self._lookup(x)
            sample_chunk = 1
            if ent is not None and "sample_chunk" in ent:
                chunk = ent["sample_chunk"]
                sample_chunk = None if chunk is None else max(1, int(chunk))
        return n if sample_chunk is None else sample_chunk

    # -- entry points --------------------------------------------------------

    def attribute(self, x, y=None):
        """One pass without noise: (coeffs, grads) as `WamEngine.attribute`
        gives them, gathered. Fused: one step."""
        self._check_batched(x)
        shape = tuple(x.shape)
        if self._resolve_fused(x):
            self.dec._check(x)
            coeffs, grads = self._call("_fused_attr", self._fused_attr, x, y)
        else:
            coeffs = self._call("dec", self._decompose_checked, self._dec_input(x))
            grads = self._call("_grads", self._grads_impl, coeffs, y, shape)
        return self._gather(coeffs), self._finalize(grads)

    def _decompose_checked(self, sig):
        with torch.no_grad():
            return self.dec(sig)

    def smoothgrad(self, x, y, key: int = 0, *, n_samples: int, stdev_spread: float,
                   sample_chunk: int | None | str = 1, noise: torch.Tensor | None = None):
        """Mean over ``n_samples`` noisy passes. ``key``: the integer seed of
        `core.estimators.sample_noise` (sample i's standard-normal draw at
        x's shape, on x's device), or ``noise`` (n_samples, *x.shape). The
        noisy inputs and per-sample gradients are the single-device
        streamed estimator's; the mean differs by summation order.
        ``sample_chunk`` > 1 stacks that many samples into each step's
        model rows (None: all; "auto": 1); a remainder chunk is padded with
        weight-0 slots so every chunk has one shape."""
        self._check_batched(x)
        fused = self._resolve_fused(x)
        sample_chunk = self._resolve_seq_chunk(sample_chunk, x, n_samples)
        shape = tuple(x.shape)
        if noise is not None and tuple(noise.shape) != (n_samples,) + shape:
            raise ValueError(f"noise must have shape {(n_samples,) + shape}, "
                             f"got {tuple(noise.shape)}")
        if fused:
            self.dec._check(x)
        acc = None
        if sample_chunk <= 1:
            for i in range(n_samples):
                if fused:
                    acc = (self._call("_fused_step", self._fused_step, x, key, i, stdev_spread,
                                      noise, y)
                           if acc is None else
                           self._call("_fused_step_acc", self._fused_step_acc, acc, x, key, i,
                                      stdev_spread, noise, y))
                else:
                    acc = self._split_sample(acc, x, key, i, stdev_spread, noise, y)
        else:
            n_chunks = -(-n_samples // min(sample_chunk, n_samples))
            g = -(-n_samples // n_chunks)
            i = 0
            while i < n_samples:
                n_real = min(g, n_samples - i)
                w = self._weights(g, n_real, x.dtype)
                if fused:
                    acc = (self._call("_fused_chunk", self._fused_chunk, x, key, i, stdev_spread,
                                      noise, y, w, g, n_samples)
                           if acc is None else
                           self._call("_fused_chunk_acc", self._fused_chunk_acc, acc, x, key, i,
                                      stdev_spread, noise, y, w, g, n_samples))
                else:
                    chunk = self._call("_noisy_chunk", self._noisy_chunk_impl, x, key, i,
                                       stdev_spread, noise, g, n_samples)
                    cs = self._call("dec", self._decompose_checked, chunk)
                    part = self._call("_grads_chunk", self._chunk_core, cs, y, shape, w, g,
                                      False)
                    acc = (part if acc is None
                           else self._call("_accum", self._accum_impl, acc, part, 1.0))
                i += n_real
        return self._finalize(self._call("_scale", self._scale_impl, acc, 1.0 / n_samples))

    def _weights(self, g: int, n_real: int, dtype) -> torch.Tensor:
        """A chunk's sample weights on the model device, 1 for its ``n_real``
        samples and 0 for its pad slots, made there (a copy from host memory
        would wait for the queue)."""
        slots = torch.arange(g, device=self.ring.model_device)
        return (slots < n_real).to(dtype)

    def _split_sample(self, acc, x, key, i, spread, noise, y):
        """One sample of the split loop: draw, decompose, gradients, then
        the accumulation from the second sample on."""
        noisy = self._call("_noisy", self._noisy_impl, x, key, i, spread, noise)
        cs = self._call("dec", self._decompose_checked, self._dec_input(noisy))
        g = self._call("_grads", self._grads_impl, cs, y, tuple(x.shape))
        return g if acc is None else self._call("_accum", self._accum_impl, acc, g, 1.0)

    # -- anytime checkpointed estimators --------------------------------------

    def smoothgrad_checkpointed(self, x, y, key: int = 0, *, n_samples: int,
                                stdev_spread: float, stride: int | str = "auto",
                                min_confidence: float = 0.0, plateau_tol: float = 0.0,
                                on_checkpoint=None, noise: torch.Tensor | None = None):
        """`smoothgrad` (one sample a step) with a confidence checkpoint
        every ``stride`` samples and at the end (`anytime.state`): the
        accumulator chain is the plain loop's, so the checkpoint at n is
        bit-equal to `smoothgrad`. ``plateau_tol > 0`` exits once every
        row's delta is under it and its confidence at least
        ``min_confidence``. Returns ``(map, info)`` with ``n_used``,
        ``n_total``, ``complete``, ``converged`` and ``conf`` (the last host
        conf vector, (B, 4))."""
        from wam_tpu_torch.core.estimators import resolve_checkpoint_stride

        self._check_batched(x)
        fused = self._resolve_fused(x)
        stride = resolve_checkpoint_stride(stride, n_samples, workload=f"wamseq{self.ndim}d",
                                           shape=tuple(x.shape[1:]), batch=x.shape[0],
                                           backend=x.device.type)
        if fused:
            self.dec._check(x)
        state = self._anytime_state(x)
        for i in range(n_samples):
            acc = state["acc"]
            if fused:
                acc_new = (self._call("_fused_step", self._fused_step, x, key, i, stdev_spread,
                                      noise, y)
                           if acc is None else
                           self._call("_fused_step_acc", self._fused_step_acc, acc, x, key, i,
                                      stdev_spread, noise, y))
            else:
                acc_new = self._split_sample(acc, x, key, i, stdev_spread, noise, y)
            if self._advance(state, acc_new, i, n_samples, stride, min_confidence, plateau_tol,
                             on_checkpoint):
                break
        count = state["count"]
        attr = self._finalize(self._call("_scale", self._scale_impl, state["acc"], 1.0 / count))
        return attr, self._info(state, n_samples)

    def integrated_checkpointed(self, x, y, *, n_steps: int, dx: float = 1.0,
                                stride: int | str = "auto", min_confidence: float = 0.0,
                                plateau_tol: float = 0.0, on_checkpoint=None):
        """`integrated` (one path point a step) with checkpoints every
        ``stride`` points (see `smoothgrad_checkpointed`); an early exit
        truncates the path. Returns ``(coeffs, integral, info)``."""
        from wam_tpu_torch.core.estimators import resolve_checkpoint_stride

        self._check_batched(x)
        fused = self._resolve_fused(x)
        stride = resolve_checkpoint_stride(stride, n_steps, workload=f"wamseq{self.ndim}d",
                                           shape=tuple(x.shape[1:]), batch=x.shape[0],
                                           backend=x.device.type)
        shape = tuple(x.shape)
        coeffs = self._call("dec", self._decompose_checked, self._dec_input(x))
        alphas = torch.linspace(0.0, 1.0, n_steps, dtype=torch.float32).tolist()
        state = self._anytime_state(x)
        for i in range(n_steps):
            w = self._trap_w(i, n_steps) * dx
            acc_new = self._ig_point(state["acc"], coeffs, alphas[i], w, y, shape, fused)
            if self._advance(state, acc_new, i, n_steps, stride, min_confidence, plateau_tol,
                             on_checkpoint):
                break
        return self._gather(coeffs), self._finalize(state["acc"]), self._info(state, n_steps)

    def _anytime_state(self, x) -> dict:
        return {"m2": torch.zeros((x.shape[0],), dtype=torch.float32,
                                  device=self.ring.model_device),
                "acc": None, "prev_acc": None, "prev_count": 0, "conf": None,
                "converged": False, "count": 0}

    @staticmethod
    def _info(state: dict, n_total: int) -> dict:
        return {"n_used": state["count"], "n_total": n_total,
                "complete": state["count"] >= n_total, "converged": state["converged"],
                "conf": state["conf"]}

    def _plain(self, acc):
        """The accumulator as whole per-row tensors for the confidence side
        computations (the gathered form; a `post_fn` output as it is)."""
        return acc if self.post_fn is not None else self._finalize(acc)

    def _advance(self, state, acc_new, i, n_total, stride, min_confidence, plateau_tol,
                 on_checkpoint) -> bool:
        """Fold one sample into the anytime state: the M2 step (from the
        second sample on), then at a stride boundary (and at the end) the
        confidence vector read back, the snapshot for the next delta and
        the early-exit decision. Side computations only: the accumulator
        chain is untouched."""
        from wam_tpu_torch.anytime.state import SLOT_CONFIDENCE, SLOT_DELTA, conf_stats, m2_update

        if state["acc"] is not None:
            state["m2"] = self._call("_anytime_m2", m2_update, state["m2"],
                                     self._plain(state["acc"]), self._plain(acc_new), float(i))
        state["acc"], state["count"] = acc_new, i + 1
        count = state["count"]
        if count % stride and count < n_total:
            return False
        ref = state["prev_acc"] if state["prev_acc"] is not None else acc_new
        conf = self._call("_anytime_conf", conf_stats, self._plain(acc_new), state["m2"],
                          float(count), self._plain(ref), float(state["prev_count"]))
        conf_host = conf.cpu().numpy()
        state.update(conf=conf_host, prev_acc=acc_new, prev_count=count)
        if on_checkpoint is not None:
            on_checkpoint(count, conf_host)
        if (count < n_total and plateau_tol > 0.0
                and float(conf_host[:, SLOT_DELTA].max()) <= plateau_tol
                and float(conf_host[:, SLOT_CONFIDENCE].min()) >= min_confidence):
            state["converged"] = True
        return state["converged"]

    @staticmethod
    def _trap_w(i: int, n_steps: int) -> float:
        # a length-1 path is its own both endpoints -> weight 1.0
        if n_steps == 1:
            return 1.0
        return 0.5 if i in (0, n_steps - 1) else 1.0

    def _ig_point(self, acc, coeffs, alpha, w, y, shape, fused: bool):
        """One path point's step(s): the fused one, or gradients then the
        NaN-safe weighted accumulation."""
        if fused:
            return (self._call("_fused_ig_first", self._fused_ig_first, coeffs, alpha, w, y,
                               shape)
                    if acc is None else
                    self._call("_fused_ig_step", self._fused_ig_step, acc, coeffs, alpha, w, y,
                               shape))
        g = self._call("_grads_ig", self._grads_ig, coeffs, alpha, y, shape)
        return (self._call("_first_nan", self._first_nan_impl, g, w) if acc is None
                else self._call("_accum_nan", self._accum_nan_impl, acc, g, w))

    def integrated(self, x, y, *, n_steps: int, dx: float = 1.0,
                   sample_chunk: int | None | str = 1):
        """Trapezoidal path integral of the gradient over alpha * coeffs,
        alpha in linspace(0, 1, n_steps) (float32), NaN-safe
        (`core.estimators.trapezoid` up to summation order). Returns
        (gathered coeffs, integral tree); the caller multiplies by its
        baseline. ``sample_chunk`` batches that many path points a step
        (None: all, "auto": 1). Decompose once, then one step a point (or a
        chunk)."""
        self._check_batched(x)
        fused = self._resolve_fused(x)
        sample_chunk = self._resolve_seq_chunk(sample_chunk, x, n_steps)
        shape = tuple(x.shape)
        coeffs = self._call("dec", self._decompose_checked, self._dec_input(x))
        alphas = torch.linspace(0.0, 1.0, n_steps, dtype=torch.float32).tolist()
        dev = self.ring.model_device
        acc = None
        if sample_chunk <= 1:
            for i in range(n_steps):
                acc = self._ig_point(acc, coeffs, alphas[i], self._trap_w(i, n_steps) * dx, y,
                                     shape, fused)
        else:
            n_chunks = -(-n_steps // min(sample_chunk, n_steps))
            g = -(-n_steps // n_chunks)
            i = 0
            while i < n_steps:
                n_real = min(g, n_steps - i)
                # built on the device: a copy from host memory waits for the queue
                a_chunk = torch.linspace(0.0, 1.0, n_steps, dtype=torch.float32,
                                         device=dev)[i:i + g]
                a_chunk = torch.cat([a_chunk, a_chunk.new_zeros(g - a_chunk.shape[0])])
                w = self._weights(g, n_real, torch.float32) * dx
                for k in (0, n_steps - 1):  # the trapezoid's halved endpoints
                    if n_steps > 1 and i <= k < i + n_real:
                        w[k - i] = 0.5 * dx
                if fused and acc is not None:
                    acc = self._call("_fused_ig_chunk_acc", self._fused_ig_chunk_acc, acc,
                                     coeffs, a_chunk, y, w, shape)
                else:
                    part = self._call("_grads_ig_chunk", self._grads_ig_chunk, coeffs, a_chunk,
                                      y, w, shape)
                    acc = (part if acc is None
                           else self._call("_accum", self._accum_impl, acc, part, 1.0))
                i += n_real
        return self._gather(coeffs), self._finalize(acc)


def seq_sharded_wam(mesh: Mesh, model_fn, **kwargs) -> SeqShardedWam:
    """Convenience constructor (see `SeqShardedWam`)."""
    return SeqShardedWam(mesh, model_fn, **kwargs)
