"""3D visualization (PyTorch port of `wam_tpu.viz.viz3d`): point-cloud
scatters and voxel renders with heatmap superposition, in matplotlib 3D,
and the same data as plotly figures when plotly is installed.

Every function takes tensors (any device) or arrays. `voxel_surface_mesh`
extracts the exposed faces of an occupancy grid with one shifted mask a
direction (6 numpy passes whatever the voxel count). matplotlib is imported
by the functions that draw; plotly is never imported on import: `HAS_PLOTLY`
says whether it can be, and the plotly functions raise ImportError without
it.
"""

from __future__ import annotations

import importlib.util

import numpy as np
import torch

from wam_tpu_torch.optional import require

__all__ = [
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


def _plotly_importable() -> bool:
    try:
        return importlib.util.find_spec("plotly") is not None
    except (ImportError, ValueError):
        return False


HAS_PLOTLY = _plotly_importable()


def _require_plotly():
    if not HAS_PLOTLY:
        raise ImportError(
            "plotly is not installed; use the matplotlib functions "
            "(scatter3d/voxel_figure/voxel_superpose) or install plotly"
        )
    import plotly.graph_objects as go

    return go


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _as_points(cloud) -> np.ndarray:
    """(3, N) or (N, 3) -> (N, 3)."""
    a = _np(cloud)
    if a.ndim != 2:
        raise ValueError(f"Expected 2D point array, got {a.shape}")
    return a.T if a.shape[0] == 3 and a.shape[1] != 3 else a


def _plt(what: str):
    return require("matplotlib.pyplot", what)


def scatter3d(cloud, ax=None, color=None, size: float = 4.0, title: str | None = None):
    """One point cloud; returns (axes, the scatter's collection)."""
    pts = _as_points(cloud)
    if ax is None:
        fig = _plt("scatter3d").figure()
        ax = fig.add_subplot(projection="3d")
    sc = ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=color, s=size)
    if title:
        ax.set_title(title)
    return ax, sc


def scatter3d_batch(clouds, titles=None, ncols: int = 4, size: float = 4.0):
    """A grid of point clouds."""
    plt = _plt("scatter3d_batch")
    n = len(clouds)
    ncols = min(ncols, n)
    nrows = (n + ncols - 1) // ncols
    fig = plt.figure(figsize=(4 * ncols, 4 * nrows))
    for i, cloud in enumerate(clouds):
        ax = fig.add_subplot(nrows, ncols, i + 1, projection="3d")
        scatter3d(cloud, ax=ax, size=size, title=titles[i] if titles else None)
    fig.tight_layout()
    return fig


def scatter3d_superpose(cloud_a, cloud_b, labels=("source", "filtered"), size: float = 4.0):
    """Two clouds overlaid (blue, red)."""
    fig = _plt("scatter3d_superpose").figure()
    ax = fig.add_subplot(projection="3d")
    for cloud, lbl, c in zip((cloud_a, cloud_b), labels, ("tab:blue", "tab:red")):
        pts = _as_points(cloud)
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=size, label=lbl, color=c, alpha=0.6)
    ax.legend()
    return fig


def scatter3d_colors(cloud, values, cmap: str = "viridis", size: float = 6.0):
    """A cloud coloured by a scalar a point, with its colour bar."""
    fig = _plt("scatter3d_colors").figure()
    ax = fig.add_subplot(projection="3d")
    pts = _as_points(cloud)
    sc = ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=_np(values), cmap=cmap, s=size)
    fig.colorbar(sc, ax=ax, fraction=0.03)
    return fig


def scatter3d_explanation_batch(clouds, importances, ncols: int = 4, cmap: str = "viridis"):
    """A batch of clouds coloured by their importances."""
    plt = _plt("scatter3d_explanation_batch")
    n = len(clouds)
    ncols = min(ncols, n)
    nrows = (n + ncols - 1) // ncols
    fig = plt.figure(figsize=(4 * ncols, 4 * nrows))
    for i, (cloud, imp) in enumerate(zip(clouds, importances)):
        ax = fig.add_subplot(nrows, ncols, i + 1, projection="3d")
        pts = _as_points(cloud)
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=_np(imp), cmap=cmap, s=6)
    fig.tight_layout()
    return fig


def voxel_figure(volume, threshold: float = 0.5, facecolor: str = "#7aa6c2"):
    """Solid voxels of a (D, H, W) grid above ``threshold``."""
    filled = _np(volume) > threshold
    fig = _plt("voxel_figure").figure()
    ax = fig.add_subplot(projection="3d")
    ax.voxels(filled, facecolors=facecolor, edgecolor="k", linewidth=0.2)
    return fig


# Per direction: the offset to the neighbour and the face's 4 unit-cube
# corners, counter-clockwise seen from outside (outward normals).
_FACES = [
    ((1, 0, 0), np.array([(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)])),
    ((-1, 0, 0), np.array([(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)])),
    ((0, 1, 0), np.array([(0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0)])),
    ((0, -1, 0), np.array([(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)])),
    ((0, 0, 1), np.array([(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)])),
    ((0, 0, -1), np.array([(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0)])),
]


def voxel_surface_mesh(volume, threshold: float = 0.0):
    """Surface mesh of the occupied region (> ``threshold``) of a (D, H, W)
    grid: ``(vertices (N, 3) float64, triangles (M, 3) int64 with outward
    winding, intensity (N,) float64)``, the intensity a vertex being its
    voxel's value. Only exposed faces are emitted (a face between two
    occupied voxels is interior), so N grows with the surface, not the
    volume."""
    vol = _np(volume)
    if vol.ndim != 3:
        raise ValueError(f"Expected (D, H, W) volume, got {vol.shape}")
    occ = vol > threshold
    padded = np.pad(occ, 1, constant_values=False)
    verts, tris, inten = [], [], []
    base = 0
    for (ox, oy, oz), corners in _FACES:
        nb = padded[1 + ox: 1 + ox + occ.shape[0],
                    1 + oy: 1 + oy + occ.shape[1],
                    1 + oz: 1 + oz + occ.shape[2]]
        exposed = occ & ~nb
        coords = np.argwhere(exposed)  # (F, 3)
        if coords.size == 0:
            continue
        f = len(coords)
        verts.append((coords[:, None, :] + corners[None, :, :]).reshape(-1, 3))
        first = base + 4 * np.arange(f)[:, None]
        tris.append(np.concatenate([first + np.array([[0, 1, 2]]),
                                    first + np.array([[0, 2, 3]])], axis=0))
        inten.append(np.repeat(vol[exposed], 4))
        base += 4 * f
    if not verts:
        return (np.zeros((0, 3), np.float64), np.zeros((0, 3), np.int64),
                np.zeros((0,), np.float64))
    return (np.concatenate(verts).astype(np.float64), np.concatenate(tris).astype(np.int64),
            np.concatenate(inten).astype(np.float64))


_HIDDEN_AXES = dict(xaxis=dict(visible=False), yaxis=dict(visible=False),
                    zaxis=dict(visible=False))


def scatter3d_plotly(cloud, values=None, size: float = 4.0, cmap: str = "Viridis",
                     title: str | None = None):
    """A point cloud as a plotly Scatter3d figure, coloured by ``values``
    when given. Needs plotly."""
    go = _require_plotly()
    pts = _as_points(cloud)
    marker = dict(size=size)
    if values is not None:
        marker.update(color=_np(values), colorscale=cmap, showscale=True)
    fig = go.Figure(data=go.Scatter3d(x=pts[:, 0], y=pts[:, 1], z=pts[:, 2], mode="markers",
                                      marker=marker))
    fig.update_layout(title=title, showlegend=False,
                      margin=dict(l=30.0, r=30.0, b=80.0, t=50.0), scene=_HIDDEN_AXES)
    return fig


def _mesh3d_trace(go, volume, threshold, colorscale, opacity):
    v, t, inten = voxel_surface_mesh(volume, threshold)
    return go.Mesh3d(x=v[:, 0], y=v[:, 1], z=v[:, 2], i=t[:, 0], j=t[:, 1], k=t[:, 2],
                     intensity=inten, colorscale=colorscale, showscale=False,
                     opacity=opacity)


def voxels_plotly(volume, threshold: float = 0.0, cmap: str = "Viridis", opacity: float = 0.5):
    """A voxel grid as a plotly Mesh3d figure (`voxel_surface_mesh`). Needs
    plotly."""
    go = _require_plotly()
    fig = go.Figure(data=_mesh3d_trace(go, volume, threshold, cmap, opacity),
                    layout=go.Layout(height=500, width=600))
    fig.update_layout(scene=_HIDDEN_AXES)
    return fig


def _normalized(heatmap) -> np.ndarray:
    heat = _np(heatmap).astype(np.float64)
    hmin, hmax = heat.min(), heat.max()
    return (heat - hmin) / (hmax - hmin if hmax > hmin else 1.0)


def voxel_superpose_plotly(volume, heatmap, vox_threshold: float = 0.5,
                           heat_threshold: float = 0.3, cmap_shape: str = "Blues",
                           cmap_heat: str = "Viridis"):
    """The shape's mesh and the thresholded attribution heatmap's mesh
    overlaid. Needs plotly."""
    go = _require_plotly()
    heat_n = _normalized(heatmap)
    fig = go.Figure(
        data=[_mesh3d_trace(go, _np(volume), vox_threshold, cmap_shape, 0.25),
              _mesh3d_trace(go, np.where(heat_n > heat_threshold, heat_n, 0.0),
                            heat_threshold, cmap_heat, 0.9)],
        layout=go.Layout(height=500, width=600))
    fig.update_layout(scene=_HIDDEN_AXES)
    return fig


def voxel_superpose(volume, heatmap, vox_threshold: float = 0.5, heat_threshold: float = 0.5,
                    cmap: str = "inferno"):
    """Voxel shape (grey, translucent) with the thresholded attribution
    heatmap's voxels coloured over it."""
    matplotlib = require("matplotlib", "voxel_superpose")
    plt = _plt("voxel_superpose")
    vol = _np(volume)
    heat = _np(heatmap)
    hmin, hmax = heat.min(), heat.max()
    heat_n = (heat - hmin) / (hmax - hmin if hmax > hmin else 1.0)

    shape_mask = vol > vox_threshold
    heat_mask = heat_n > heat_threshold

    colors = np.zeros(shape_mask.shape + (4,))
    colors[shape_mask] = (0.6, 0.6, 0.6, 0.25)
    mapped = matplotlib.colormaps[cmap](heat_n)
    mapped[..., 3] = 0.9
    colors[heat_mask] = mapped[heat_mask]

    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    ax.voxels(shape_mask | heat_mask, facecolors=colors)
    return fig
