"""2D mosaic viewers (PyTorch port of `wam_tpu.viz.viewers`): one mosaic
with its dyadic level separators (optionally smoothed by the port's
`ops.filters.gaussian_filter2d`, on ``device``: None is the card, or
RuntimeError), diagonal panels, explanations beside their images, and
grouped level-share bars. Matplotlib, on the host, imported inside the
functions that draw."""

from __future__ import annotations

import numpy as np
import torch

from wam_tpu_torch.device import resolve_device
from wam_tpu_torch.ops.filters import gaussian_filter2d
from wam_tpu_torch.optional import require

__all__ = [
    "plot_wam",
    "wavelet_region_lines",
    "plot_wavelet_regions",
    "add_lines",
    "plot_diagonal",
    "visualize_explanations_basic",
    "visualize_gradients_at_levels",
]


def wavelet_region_lines(size: int, levels: int):
    """Endpoints of the separator lines between dyadic blocks: at each level
    l a horizontal and a vertical line at size/2^(l+1), spanning size/2^l."""
    lines = []
    for lev in range(levels):
        span = size // (2**lev)
        mid = size // (2 ** (lev + 1))
        lines.append((((0, mid), (span, mid)), ((mid, span), (mid, 0))))
    return lines


def plot_wavelet_regions(size: int, levels: int):
    """`wavelet_region_lines` in the reference viewer's shape: dicts ``h[k]``,
    ``v[k]`` of (2, 2) endpoint arrays per level."""
    lines = wavelet_region_lines(size, levels)
    h = {i: np.array(hline) for i, (hline, _) in enumerate(lines)}
    v = {i: np.array(vline) for i, (_, vline) in enumerate(lines)}
    return h, v


def add_lines(size: int, levels: int, ax) -> None:
    """White dyadic separators on an imshow'd mosaic."""
    ax.set_xlim(0, size)
    ax.set_ylim(size, 0)
    for (h0, h1), (v0, v1) in wavelet_region_lines(size, levels):
        ax.plot([h0[0], h1[0]], [h0[1], h1[1]], c="w")
        ax.plot([v0[0], v1[0]], [v0[1], v1[1]], c="w")


def plot_wam(ax, wam, levels: int, smooth: bool = False, sigma: float = 1.0,
             cmap: str = "viridis", normalize_approx: bool = False, device=None):
    """Render one attribution mosaic with its level separators."""
    wam = wam.detach().cpu().numpy() if isinstance(wam, torch.Tensor) else np.asarray(wam)
    size = wam.shape[0]
    display = wam
    if normalize_approx:
        b = size // (2**levels)
        display = wam / (wam.max() if wam.max() else 1.0)
        display = display.copy()
        display[:b, :b] = 0.0
    if smooth:
        t = torch.as_tensor(np.asarray(display, dtype=np.float32), device=resolve_device(device))
        display = gaussian_filter2d(t, sigma=sigma).cpu().numpy()
    ax.imshow(display, cmap=cmap)
    add_lines(size, levels, ax)


def plot_diagonal(diagonals: dict, cmap: str = "viridis", figsize=(14, 4)):
    """Panel of the diagonal blocks and the approximation."""
    plt = require("matplotlib.pyplot", "plot_diagonal")
    keys = list(diagonals)
    fig, axes = plt.subplots(1, len(keys), figsize=figsize)
    if len(keys) == 1:
        axes = [axes]
    for ax, key in zip(axes, keys):
        im = ax.imshow(diagonals[key], cmap=cmap)
        ax.set_title(str(key))
        ax.axis("off")
        fig.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
    fig.tight_layout()
    return fig


def visualize_explanations_basic(explanations, images, levels: int, cmap="viridis",
                                 smooth: bool = True, which=0, device=None):
    """Original image and WAM side by side, one figure per image."""
    plt = require("matplotlib.pyplot", "visualize_explanations_basic")
    indices = range(len(explanations)) if which == "all" else [which]
    figs = []
    for i in indices:
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
        ax1.imshow(np.asarray(images[i]))
        ax1.set_title("Original Image")
        ax1.axis("off")
        plot_wam(ax2, explanations[i], levels=levels, cmap=cmap, smooth=smooth, device=device)
        ax2.set_title("WAM")
        ax2.axis("off")
        fig.tight_layout()
        figs.append(fig)
    return figs


def visualize_gradients_at_levels(gradients_at_levels, title: str, names=None):
    """Grouped bar plot of per-level attribution shares."""
    plt = require("matplotlib.pyplot", "visualize_gradients_at_levels")
    arr = np.asarray(gradients_at_levels)
    n_samples, n_levels = arr.shape
    names = names or [f"Sample {i + 1}" for i in range(n_samples)]
    levels = np.arange(n_levels)
    width = 0.8 / n_samples
    fig = plt.figure(figsize=(10, 6))
    for i in range(n_samples):
        plt.bar(levels + i * width, arr[i], width=width, label=names[i])
    plt.xlabel("Scale level")
    plt.ylabel("Attribution")
    plt.title(title)
    plt.xticks(levels + 0.4, levels + 1)
    plt.legend()
    plt.tight_layout()
    return fig
