"""Sharded attribution estimators: SmoothGrad and IG over a (data, sample)
mesh (PyTorch port of `wam_tpu.parallel.sharded`).

The reference builds one jitted graph whose noisy inputs are sharded
P('sample', 'data') and whose sample mean is a psum over the mesh. Here a
runner walks the mesh's blocks (`parallel.mesh.Mesh`): each block runs on
its device, with its (n_samples / sample_shards) x (B / data_shards) rows
stacked into one step call, and returns the sum over its samples. The
partial sums are moved to the output device (the device of this process's
first block) and added there in sample-index order, then divided by
n_samples: the reference's ``psum(...) / n_samples``. A block's tensors
live until its partial sum is taken, so a mesh of ten blocks on one card
peaks at one block's memory. Blocks on several cards run concurrently (the
host enqueues them in turn); blocks that share a card run one after
another, with no speed-up.

On a mesh that spans processes (`multihost.hybrid_mesh` under a process
group) each process runs only its own blocks; the rows of the blocks it
does not own are zeros in its output, and one ``all_reduce`` (sum) over the
group both adds the sample partials and gathers the data rows, so every
process returns the whole result.

The step runs on the block's tensors, on the block's device: on a mesh over
several cards the step must accept every mesh device's tensors.

Noise follows the port's rule (`core.estimators.smoothgrad`): the runner
takes the standard-normal draws as ``noise`` (n_samples, *x.shape), or
draws them once from ``generator`` on x's device; the same draws give the
single-device `smoothgrad`'s noisy inputs, element for element.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from wam_tpu_torch.core.estimators import noise_sigma
from wam_tpu_torch.parallel.mesh import Mesh, P
from wam_tpu_torch.parallel.tree import cyclic_pad_index, tree_leaves, tree_map, tree_zip_map

__all__ = ["sharded_smoothgrad", "sharded_smoothgrad_spmd", "sharded_integrated_path"]


def _check_sample_split(n: int, shards: int, sample_axis: str) -> None:
    if n % shards:
        raise ValueError(f"n_samples={n} not divisible by {sample_axis}={shards}")


def _run_blocks(mesh: Mesh, groups: list[list[dict]], block_fn: Callable):
    """Run ``block_fn(coords, device) -> partial`` for every block of
    ``groups`` this process owns; each group's partials are added on the
    output device in the group's order, and the groups' sums concatenated
    along axis 0 (module docstring; across processes, one all_reduce)."""
    local = mesh.local_devices()
    if not local:
        raise ValueError(f"this process owns no block of {mesh}")
    out_dev = local[0]
    sums = []
    for group in groups:
        acc = None
        for coords in group:
            if not mesh.owns(**coords):
                continue
            part = tree_map(lambda t: t.to(out_dev), block_fn(coords, mesh.device(**coords)))
            acc = part if acc is None else tree_zip_map(torch.add, [acc, part])
        sums.append(acc)
    if mesh.process_ids is not None:
        import torch.distributed as dist

        template = next(s for s in sums if s is not None)
        sums = [s if s is not None else tree_map(torch.zeros_like, template) for s in sums]
        full = tree_zip_map(lambda *p: torch.cat(p), sums)
        for leaf in tree_leaves(full):
            dist.all_reduce(leaf)
        return full
    return tree_zip_map(lambda *p: torch.cat(p), sums)


def _noise(x: torch.Tensor, n_samples: int, noise, generator) -> torch.Tensor:
    if noise is None:
        return torch.randn((n_samples,) + tuple(x.shape), generator=generator, device=x.device,
                           dtype=x.dtype)
    if tuple(noise.shape) != (n_samples,) + tuple(x.shape):
        raise ValueError(f"noise must have shape {(n_samples,) + tuple(x.shape)}, "
                         f"got {tuple(noise.shape)}")
    return noise


def sharded_smoothgrad(
    step_fn: Callable[[torch.Tensor], Any],
    mesh: Mesh,
    *,
    n_samples: int,
    stdev_spread: float,
    data_axis: str = "data",
    sample_axis: str = "sample",
) -> Callable[..., Any]:
    """Build a ``run(x, *, noise=None, generator=None) -> mean tree``
    SmoothGrad runner with the single-device semantics.

    ``step_fn`` maps a stack of noisy batches (s, B, ...) to a stacked
    result (s, B, ...) or a list of them (the port's step contract), the
    labels closed over: it sees the whole batch, so batch-global reductions
    (the mosaic's normalize-by-max) are as on one device. The samples split
    over ``sample_axis``; the data axis does not split the step (the
    reference replicates the model over it), so each sample shard runs
    once, on the block at data index 0. Requires n_samples %
    sample_shards == 0.
    """
    n_sample_shards = mesh.shape[sample_axis]
    _check_sample_split(n_samples, n_sample_shards, sample_axis)
    ns = n_samples // n_sample_shards

    def run(x, *, noise=None, generator=None):
        z = _noise(x, n_samples, noise, generator)
        sigma = noise_sigma(x, stdev_spread).reshape((-1,) + (1,) * (x.ndim - 1))

        def block(coords, dev):
            s = coords[sample_axis]
            noisy = x.to(dev) + z[s * ns:(s + 1) * ns].to(dev, x.dtype) * sigma.to(dev)
            return tree_map(lambda t: t.sum(dim=0), step_fn(noisy))

        group = [{data_axis: 0, sample_axis: s} for s in range(n_sample_shards)]
        return tree_map(lambda t: t / n_samples, _run_blocks(mesh, [group], block))

    return run


def sharded_smoothgrad_spmd(
    step_fn: Callable[[torch.Tensor, Any, float], Any],
    mesh: Mesh,
    *,
    n_samples: int,
    stdev_spread: float,
    data_axis: str = "data",
    sample_axis: str = "sample",
) -> Callable[..., Any]:
    """`sharded_smoothgrad` with the data axis split too: each block
    computes ONLY its (n_samples / sample_shards, B / data_shards) rows.

    Contract (the reference's):
    - ``step_fn(noisy_local, y_local, grad_scale)`` receives the block's
      stacked noisy rows (s, b, ...), their labels (passed to the runner,
      not closed over; None stays None) and the loss-mean rescale factor
      below, and returns (s, b, ...) or a list of them;
    - the runner signature is ``run(x, y, *, noise=None, generator=None)``;
    - any batch-global reduction inside ``step_fn`` (the mosaic's
      normalize-by-max) is computed PER DATA SHARD. With
      ``mosaic2d(..., normalize=False)`` (or any shard-local step) the
      result is the single-device `smoothgrad`'s up to the order of the
      sample sum.

    Loss-mean rescale: the engine's loss takes the MEAN over the rows it
    sees, so a block of b rows gives gradients B/b times the full batch's.
    The runner passes ``grad_scale = b / B``; the step multiplies its
    coefficient gradients by it before any (scale-invariant) normalization::

        def step(noisy, y_local, grad_scale):
            s = noisy.shape[0]
            flat = noisy.reshape((-1,) + tuple(noisy.shape[2:]))
            with torch.no_grad():
                coeffs = engine.decompose(flat)
            grads = engine.grads_from_coeffs(coeffs, y_local.repeat(s), spatial, samples=s)
            grads = map_coeffs(lambda g: (g * grad_scale).reshape((s, -1) + g.shape[1:]), grads)
            return mosaic2d(grads, normalize=False)

    Batch divisibility: B need NOT divide the data axis. A batch that does
    not is padded to the next multiple with cyclic copies of the noised
    rows, run sharded, and the pad rows sliced off the result: the model is
    batch-diagonal (inference-mode BN), so the real rows are untouched. With
    normalize=True a padding shard's normalizer sees the copies.

    Requires n_samples % sample_shards == 0.
    """
    n_sample_shards = mesh.shape[sample_axis]
    _check_sample_split(n_samples, n_sample_shards, sample_axis)

    def run(x, y, *, noise=None, generator=None):
        n_data_shards = mesh.shape[data_axis]
        batch = x.shape[0]
        z = _noise(x, n_samples, noise, generator)
        sigma = noise_sigma(x, stdev_spread).reshape((-1,) + (1,) * (x.ndim - 1))
        y = None if y is None else torch.as_tensor(y)
        idx, rows = cyclic_pad_index(batch, n_data_shards)
        if idx is not None:
            # cyclic copies of the real rows: every shard sees genuine
            # inputs (finite normalizers); the copies are sliced off below
            x, sigma = x[idx.to(x.device)], sigma[idx.to(sigma.device)]
            z = z[:, idx.to(z.device)]
            y = None if y is None else y[idx.to(y.device)]
        grad_scale = (rows // n_data_shards) / batch

        def block(coords, dev):
            xb = mesh.block(x, P(data_axis), **coords).to(dev)
            zb = mesh.block(z, P(sample_axis, data_axis), **coords).to(dev, x.dtype)
            noisy = xb + zb * mesh.block(sigma, P(data_axis), **coords).to(dev)
            yb = None if y is None else mesh.block(y, P(data_axis), **coords).to(dev)
            return tree_map(lambda t: t.sum(dim=0), step_fn(noisy, yb, grad_scale))

        groups = [[{data_axis: d, sample_axis: s} for s in range(n_sample_shards)]
                  for d in range(n_data_shards)]
        out = _run_blocks(mesh, groups, block)
        return tree_map(lambda t: (t / n_samples)[:batch], out)

    return run


def sharded_integrated_path(
    grad_fn: Callable[..., Any],
    decompose_fn: Callable[[torch.Tensor], Any],
    mesh: Mesh,
    *,
    n_steps: int,
    data_axis: str = "data",
    sample_axis: str = "sample",
    dx: float = 1.0,
) -> Callable[..., Any]:
    """Build a ``run(x, y=None) -> integral tree`` IG runner: the α-path
    split over ``sample_axis`` (contiguous runs of path points, as equal as
    ``n_steps`` allows) and the batch over ``data_axis``.

    Each data shard's rows are decomposed once (``decompose_fn``, on the
    device of its first block); a block calls ``grad_fn(coeffs_local,
    y_local, alphas_local, grad_scale)`` with its rows' coefficients, their
    labels, its path points (s,) and the loss-mean rescale factor of
    `sharded_smoothgrad_spmd`, and gets the stacked gradients (s, b, ...) of
    the scaled coefficients (or a list of them) back; the block's share of
    the trapezoid rule (NaN-safe, `core.estimators.trapezoid`) is summed
    there. Batch-global reductions inside ``grad_fn`` are per data shard,
    and a batch that does not divide the data axis is padded cyclically, as
    in `sharded_smoothgrad_spmd`."""

    def run(x, y=None):
        n_data_shards = mesh.shape[data_axis]
        n_sample_shards = mesh.shape[sample_axis]
        batch = x.shape[0]
        y = None if y is None else torch.as_tensor(y)
        idx, rows = cyclic_pad_index(batch, n_data_shards)
        if idx is not None:
            x = x[idx.to(x.device)]
            y = None if y is None else y[idx.to(y.device)]
        grad_scale = (rows // n_data_shards) / batch
        dtype = x.dtype if x.is_floating_point() else torch.float32
        alphas = torch.linspace(0.0, 1.0, n_steps, dtype=dtype)  # the reference's x.dtype
        weights = torch.ones(n_steps, dtype=dtype)
        weights[0] = weights[-1] = 0.5
        parts = np.array_split(np.arange(n_steps), n_sample_shards)
        coeffs: dict[int, Any] = {}
        groups = [[{data_axis: d, sample_axis: s} for s in range(n_sample_shards)
                   if len(parts[s])] for d in range(n_data_shards)]
        last = {g[-1][data_axis]: g[-1][sample_axis] for g in groups if g}

        def block(coords, dev):
            d, s = coords[data_axis], coords[sample_axis]
            if d not in coeffs:
                with torch.no_grad():
                    coeffs[d] = decompose_fn(mesh.block(x, P(data_axis), **coords).to(dev))
            # a data shard's coefficients live until its last sample block
            c = tree_map(lambda t: t.to(dev),
                         coeffs.pop(d) if s == last[d] else coeffs[d])
            yb = None if y is None else mesh.block(y, P(data_axis), **coords).to(dev)
            lo, hi = int(parts[s][0]), int(parts[s][-1]) + 1
            w = weights[lo:hi].to(dev)
            out = grad_fn(c, yb, alphas[lo:hi].to(dev), grad_scale)
            return tree_map(lambda t: (torch.nan_to_num(t) * w.to(t.dtype).reshape(
                (-1,) + (1,) * (t.ndim - 1))).sum(dim=0), out)

        out = _run_blocks(mesh, groups, block)
        return tree_map(lambda t: (t * dx)[:batch], out)

    return run
