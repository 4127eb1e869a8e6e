"""Visualization (PyTorch port of `wam_tpu.viz`): the 2D mosaic viewers.
matplotlib is imported by the functions that draw, never on import."""

from wam_tpu_torch.viz.viewers import (
    add_lines,
    plot_diagonal,
    plot_wam,
    plot_wavelet_regions,
    visualize_explanations_basic,
    visualize_gradients_at_levels,
    wavelet_region_lines,
)

__all__ = [
    "plot_wam",
    "add_lines",
    "wavelet_region_lines",
    "plot_wavelet_regions",
    "plot_diagonal",
    "visualize_explanations_basic",
    "visualize_gradients_at_levels",
]
