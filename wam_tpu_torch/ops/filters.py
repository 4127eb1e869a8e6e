"""Small image ops of the evaluation suite (PyTorch port of
`wam_tpu.ops.filters`): a separable Gaussian blur, superpixel sums and the
nearest-neighbour resize (over two axes, or three for video).

The nearest resize follows ``jax.image.resize(..., "nearest")``: output
pixel i reads source pixel floor((i + 1/2) * n_in / n_out), the half-pixel
rule of ``F.interpolate(mode="nearest-exact")``, computed in float32 as the
reference computes it, (i + 1/2) * (n_in * (1 / n_out)). Where the exact
quotient is an integer the two roundings can differ by one pixel (28 -> 237
at pixel 118: nearest-exact reads 14, the reference 13), so the index map
is built here and applied as a gather. `superpixel_sum` assigns every pixel
to the cell that map sends it to, so attribution mass per cell lines up
with the μ-fidelity masks that `upsample_nearest` builds.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


__all__ = ["gaussian_filter2d", "superpixel_sum", "upsample_nearest"]


@functools.lru_cache(maxsize=None)
def _gauss_kernel_np(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _gauss_kernel(sigma: float, radius: int, dtype, device) -> torch.Tensor:
    # built once per device: a copy from host memory waits for the queue
    return torch.as_tensor(_gauss_kernel_np(sigma, radius), dtype=dtype,
                           device=device).reshape(1, 1, -1)


def gaussian_filter2d(img: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur over the last two axes, edge-padded by
    radius = int(4 sigma + 1/2), normalized kernel, in float32.

    Each output is its own input plus the kernel-weighted sum of its
    window's differences from it, x_i + sum_k w_k (x_(i+k) - x_i): equal to
    the plain weighted sum wherever the weights sum to 1, and a constant map
    comes back bit for bit (every difference is exactly 0), where a
    convolution of a constant rounds its weights' sum in float32 (16² of
    ones read 16.000002 a cell, which breaks μ-fidelity's rank ties)."""
    radius = max(1, int(4.0 * sigma + 0.5))
    k = _gauss_kernel(float(sigma), radius, img.dtype, img.device)[0, 0]

    def blur_last(a: torch.Tensor) -> torch.Tensor:
        flat = a.reshape(-1, a.shape[-1])
        win = F.pad(flat[:, None], (radius, radius), mode="replicate")[:, 0]
        win = win.unfold(-1, 2 * radius + 1, 1)  # (rows, n, 2r + 1)
        out = flat + ((win - flat[..., None]) * k).sum(dim=-1)
        return out.reshape(a.shape)

    return blur_last(blur_last(img).transpose(-1, -2)).transpose(-1, -2)


@functools.lru_cache(maxsize=256)
def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """Source index of every output position of a nearest resize from n_in
    to n_out: floor((i + 1/2) * (n_in * (1 / n_out))) in float32, the
    reference's arithmetic (XLA folds its ``* n_in / n_out`` into one
    constant multiply)."""
    f32 = np.float32
    pos = (np.arange(n_out, dtype=f32) + f32(0.5)) * (f32(n_in) * (f32(1) / f32(n_out)))
    idx = np.minimum(np.floor(pos).astype(np.int64), n_in - 1)
    return torch.as_tensor(idx, device=device)


def superpixel_sum(img: torch.Tensor, grid: int) -> torch.Tensor:
    """Sums over grid x grid superpixels: (..., H, W) -> (..., grid, grid).
    Where the sides do not divide, every pixel lands in the cell that the
    nearest resize from grid to (H, W) maps it to."""
    h, w = img.shape[-2:]
    if h % grid == 0 and w % grid == 0:
        r = img.reshape(img.shape[:-2] + (grid, h // grid, grid, w // grid))
        return r.sum(dim=(-3, -1))
    rows = img.new_zeros(img.shape[:-2] + (grid, w))
    rows.index_add_(img.ndim - 2, _nearest_index(grid, h, img.device), img)
    out = img.new_zeros(img.shape[:-2] + (grid, grid))
    return out.index_add_(img.ndim - 1, _nearest_index(grid, w, img.device), rows)


def upsample_nearest(a: torch.Tensor, shape) -> torch.Tensor:
    """Nearest-neighbour resize of the last ``len(shape)`` axes to ``shape``
    (up or down; (H, W) for images, (T, H, W) for clips), the half-pixel
    rule of ``jax.image.resize(..., "nearest")`` on each axis."""
    for k, n_out in enumerate(shape):
        axis = a.ndim - len(shape) + k
        a = a.index_select(axis, _nearest_index(a.shape[axis], int(n_out), a.device))
    return a
