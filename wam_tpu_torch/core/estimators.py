"""Attribution smoothing estimators: SmoothGrad and Integrated Gradients.

Counterpart of `wam_tpu.core.estimators`. Where the JAX package maps a step
over samples with ``lax.map(batch_size=)``, the port folds a chunk of ``s``
samples into the batch dimension and calls the step once per chunk: a step
takes a stacked (s, ...) input and returns a stacked (s, ...) result.
``batch_size=None`` runs all samples in one chunk.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["noise_sigma", "smoothgrad", "integrated_path", "trapezoid",
           "resolve_sample_chunk", "validate_sample_batch_size"]


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


def _chunked_map(fn: Callable[[torch.Tensor], torch.Tensor], xs: torch.Tensor,
                 batch_size: int | None) -> torch.Tensor:
    """``fn`` over leading-axis chunks of ``xs``, results concatenated."""
    step = xs.shape[0] if batch_size is None else batch_size
    return torch.cat([fn(xs[i:i + step]) for i in range(0, xs.shape[0], step)])


def noise_sigma(x: torch.Tensor, stdev_spread: float) -> torch.Tensor:
    """Per-image noise scale sigma_i = spread * (max(x_i) - min(x_i)),
    reduced over all non-batch axes."""
    flat = x.reshape(x.shape[0], -1)
    return stdev_spread * (flat.amax(dim=1) - flat.amin(dim=1))


def smoothgrad(
    step_fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    *,
    n_samples: int,
    stdev_spread: float,
    batch_size: int | None = None,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mean of ``step_fn`` over ``n_samples`` noisy copies x + sigma * z_i.

    ``step_fn`` maps a stack of noisy batches (s, *x.shape) to a stacked
    result (s, ...). The standard-normal draws z come from ``noise``
    (n_samples, *x.shape) when given, else from ``generator``; they are
    drawn once for all samples, so the result does not depend on
    ``batch_size``."""
    sigma = noise_sigma(x, stdev_spread).reshape((-1,) + (1,) * (x.ndim - 1))
    if noise is None:
        noise = torch.randn((n_samples,) + tuple(x.shape), generator=generator,
                            device=x.device, dtype=x.dtype)
    elif tuple(noise.shape) != (n_samples,) + tuple(x.shape):
        raise ValueError(f"noise must have shape {(n_samples,) + tuple(x.shape)}, "
                         f"got {tuple(noise.shape)}")
    outs = _chunked_map(lambda z: step_fn(x + z * sigma), noise.to(x.device, x.dtype),
                        batch_size)
    return outs.mean(dim=0)


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
    alphas (s,) to a stacked result (s, ...); returns the trapezoid integral
    of the result over the path."""
    alphas = torch.linspace(0.0, 1.0, n_steps, dtype=torch.float32, device=device)
    return trapezoid(_chunked_map(grad_fn, alphas, batch_size), dx=dx)
