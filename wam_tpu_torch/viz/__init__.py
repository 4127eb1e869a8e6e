"""Visualization (PyTorch port of `wam_tpu.viz`): the 2D mosaic viewers and
the 3D point-cloud and voxel renders. matplotlib (and plotly, where it is
installed) is imported by the functions that draw, never on import."""

from wam_tpu_torch.viz.viewers import (
    add_lines,
    plot_diagonal,
    plot_wam,
    plot_wavelet_regions,
    visualize_explanations_basic,
    visualize_gradients_at_levels,
    wavelet_region_lines,
)
from wam_tpu_torch.viz.viz3d import (
    HAS_PLOTLY,
    scatter3d,
    scatter3d_batch,
    scatter3d_colors,
    scatter3d_explanation_batch,
    scatter3d_plotly,
    scatter3d_superpose,
    voxel_figure,
    voxel_superpose,
    voxel_superpose_plotly,
    voxel_surface_mesh,
    voxels_plotly,
)

__all__ = [
    "plot_wam",
    "add_lines",
    "wavelet_region_lines",
    "plot_wavelet_regions",
    "plot_diagonal",
    "visualize_explanations_basic",
    "visualize_gradients_at_levels",
    "scatter3d",
    "scatter3d_batch",
    "scatter3d_superpose",
    "scatter3d_colors",
    "scatter3d_explanation_batch",
    "voxel_figure",
    "voxel_superpose",
    "voxel_surface_mesh",
    "scatter3d_plotly",
    "voxels_plotly",
    "voxel_superpose_plotly",
    "HAS_PLOTLY",
]
