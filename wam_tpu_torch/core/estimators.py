"""Attribution smoothing estimators: SmoothGrad and Integrated Gradients.

Counterpart of `wam_tpu.core.estimators`. Where the JAX package maps a step
over samples with ``lax.map(batch_size=)``, the port folds a chunk of ``s``
samples into the batch dimension and calls the step once per chunk: a step
takes a stacked (s, ...) input and returns a stacked (s, ...) result, or a
list of them (one per output, e.g. WAM-1D's mel tap and coefficient levels).
``batch_size=None`` runs all samples in one chunk.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["noise_sigma", "smoothgrad", "integrated_path", "trapezoid", "sample_noise",
           "resolve_sample_chunk", "resolve_checkpoint_stride", "validate_sample_batch_size"]


def validate_sample_batch_size(value) -> None:
    """Reject any string other than exactly "auto"."""
    if isinstance(value, str) and value != "auto":
        raise ValueError(
            f"sample_batch_size must be an int, None or 'auto', got {value!r}"
        )


def resolve_sample_chunk(sample_batch_size, n_samples: int) -> int | None:
    """Explicit ints pass through (clamped to n_samples; >= n means one
    chunk). "auto" is all samples at once, as the JAX package does off the
    TPU; a default chunk for the card is for a sweep to set."""
    validate_sample_batch_size(sample_batch_size)
    if sample_batch_size == "auto" or sample_batch_size is None:
        return None
    chunk = int(sample_batch_size)
    if chunk < 1:
        raise ValueError(f"sample_batch_size must be >= 1, got {chunk}")
    return None if chunk >= n_samples else chunk


def resolve_checkpoint_stride(stride, n_samples: int, *, workload: str | None = None,
                              shape=None, batch: int | None = None, dtype: str = "f32",
                              default: int = 5) -> int:
    """The anytime checkpoint stride k (`wam_tpu_torch.anytime`): an explicit
    int (or numeric string) is clamped to [1, n_samples], below 1 raises;
    ``"auto"`` is ``default``, clamped the same way. ``workload``, ``shape``,
    ``batch`` and ``dtype`` identify the call as the reference's tuned
    ``anytime_stride`` lookup keys it; the port has no schedule cache yet
    (ROADMAP.md slice E, ``tune``), so they are accepted and do not change
    the result."""
    del workload, shape, batch, dtype
    n = max(1, int(n_samples))
    if stride != "auto":
        stride = int(stride)
        if stride < 1:
            raise ValueError(f"checkpoint stride must be >= 1, got {stride}")
        return min(stride, n)
    return min(int(default), n)


def _chunked_map(fn: Callable, xs: torch.Tensor, batch_size: int | None):
    """``fn`` over leading-axis chunks of ``xs``, results concatenated (per
    position when ``fn`` returns a list of tensors)."""
    step = xs.shape[0] if batch_size is None else batch_size
    outs = [fn(xs[i:i + step]) for i in range(0, xs.shape[0], step)]
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs)
    return [torch.cat(parts) for parts in zip(*outs)]


def _tree_map(fn: Callable, out):
    return fn(out) if isinstance(out, torch.Tensor) else [fn(t) for t in out]


def noise_sigma(x: torch.Tensor, stdev_spread: float) -> torch.Tensor:
    """Per-image noise scale sigma_i = spread * (max(x_i) - min(x_i)),
    reduced over all non-batch axes."""
    flat = x.reshape(x.shape[0], -1)
    return stdev_spread * (flat.amax(dim=1) - flat.amin(dim=1))


def sample_noise(seed: int, index: int, shape, device, dtype=torch.float32) -> torch.Tensor:
    """Sample ``index``'s standard-normal draw of ``shape``, a function of
    (seed, index) only: a generator seeded from both (numpy's SeedSequence
    mixes them), the counterpart of the reference's ``fold_in(key, i)``.
    One shared generator drawn chunk by chunk would make the draws depend
    on the chunk size."""
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint64)[0]
    g = torch.Generator(device=device).manual_seed(int(state) & (2**63 - 1))
    return torch.randn(tuple(shape), generator=g, device=device, dtype=dtype)


def smoothgrad(
    step_fn: Callable,
    x: torch.Tensor,
    *,
    n_samples: int,
    stdev_spread: float,
    batch_size: int | None = None,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
    materialize_noise: bool = True,
    seed: int = 0,
):
    """Mean of ``step_fn`` over ``n_samples`` noisy copies x + sigma * z_i.

    ``step_fn`` maps a stack of noisy batches (s, *x.shape) to a stacked
    result (s, ...) or a list of them. The standard-normal draws z come from
    ``noise`` (n_samples, *x.shape) when given, else from ``generator``; they
    are drawn once for all samples, so the result does not depend on
    ``batch_size``.

    ``materialize_noise=False`` never allocates the (n_samples, *x.shape)
    buffer: each chunk draws its own samples' noise, sample i's from
    `sample_noise(seed, i)`, so the result does not depend on ``batch_size``
    either. Those draws differ from the materialized path's (the reference's
    streamed draws differ from its materialized ones too)."""
    sigma = noise_sigma(x, stdev_spread).reshape((-1,) + (1,) * (x.ndim - 1))
    if not materialize_noise:
        if noise is not None:
            raise ValueError("noise= is a materialized buffer; it needs materialize_noise=True")

        def streamed(idx: torch.Tensor):
            z = torch.stack([sample_noise(seed, int(i), x.shape, x.device, x.dtype) for i in idx])
            return step_fn(x + z * sigma)

        outs = _chunked_map(streamed, torch.arange(n_samples), batch_size)
        return _tree_map(lambda t: t.mean(dim=0), outs)
    if noise is None:
        noise = torch.randn((n_samples,) + tuple(x.shape), generator=generator,
                            device=x.device, dtype=x.dtype)
    elif tuple(noise.shape) != (n_samples,) + tuple(x.shape):
        raise ValueError(f"noise must have shape {(n_samples,) + tuple(x.shape)}, "
                         f"got {tuple(noise.shape)}")
    outs = _chunked_map(lambda z: step_fn(x + z * sigma), noise.to(x.device, x.dtype),
                        batch_size)
    return _tree_map(lambda t: t.mean(dim=0), outs)


def trapezoid(path: torch.Tensor, dx: float = 1.0) -> torch.Tensor:
    """Trapezoidal rule along axis 0, NaN-safe (NaN -> 0)."""
    path = torch.nan_to_num(path)
    return (path[0] / 2 + path[1:-1].sum(dim=0) + path[-1] / 2) * dx


def integrated_path(
    grad_fn: Callable[[torch.Tensor], torch.Tensor],
    *,
    n_steps: int,
    batch_size: int | None = None,
    dx: float = 1.0,
    device=None,
) -> torch.Tensor:
    """Integrated gradients along the straight path alpha * coeffs,
    alpha in linspace(0, 1, n_steps) (float32): ``grad_fn`` maps a chunk of
    alphas (s,) to a stacked result (s, ...) or a list of them; returns the
    trapezoid integral of each over the path."""
    alphas = torch.linspace(0.0, 1.0, n_steps, dtype=torch.float32, device=device)
    return _tree_map(lambda t: trapezoid(t, dx=dx), _chunked_map(grad_fn, alphas, batch_size))
