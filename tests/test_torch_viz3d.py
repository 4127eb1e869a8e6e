"""The port's 3D renders (`wam_tpu_torch.viz.viz3d`) against the reference's
(`wam_tpu.viz.viz3d`) under matplotlib's Agg backend: the figures hold the
same data (scatter offsets and colours, axes and titles, voxel faces and
their colours), `voxel_surface_mesh` gives the same vertices, triangles and
intensities bit for bit, tensors (also float64, also (3, N) clouds) are
taken as arrays, and without plotly the plotly functions raise the
reference's ImportError."""

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from wam_tpu.viz import viz3d as jv  # noqa: E402
from wam_tpu_torch.viz import viz3d as tv  # noqa: E402

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def close_figures():
    yield
    plt.close("all")


def _cloud(seed, n=50, transpose=False):
    pts = np.random.default_rng(seed).standard_normal((n, 3))
    return pts.T.copy() if transpose else pts


def _scatter_data(ax):
    """Every scatter of a 3D axes: (x, y, z offsets, face colours)."""
    out = []
    for coll in ax.collections:
        xs, ys, zs = coll._offsets3d
        out.append((np.asarray(xs), np.asarray(ys), np.asarray(zs),
                    np.asarray(coll.get_facecolors())))
    return out


def _figure_data(fig):
    data = []
    for ax in fig.axes:
        data.append((ax.get_title(), ax.get_legend_handles_labels()[1]))
        if hasattr(ax, "get_zlim"):
            data.append(_scatter_data(ax))
    return data


def _assert_same(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _assert_same(u, v)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _draw(fig):
    fig.canvas.draw()  # colours are resolved at draw
    return fig


@pytest.mark.parametrize("transpose", [False, True])
def test_scatter3d(transpose):
    cloud = _cloud(0, transpose=transpose)
    colors = np.linspace(0, 1, 50)
    jax_ax, _ = jv.scatter3d(cloud, color=colors, title="t")
    port_ax, sc = tv.scatter3d(torch.from_numpy(cloud), color=colors, title="t")
    _draw(jax_ax.figure), _draw(port_ax.figure)
    assert port_ax.get_title() == jax_ax.get_title() == "t"
    _assert_same(_scatter_data(port_ax), _scatter_data(jax_ax))
    assert sc is port_ax.collections[0]
    with pytest.raises(ValueError, match="Expected 2D point array"):
        tv.scatter3d(np.zeros(3))


def test_scatter3d_batch_superpose_colors_and_explanations():
    clouds = [_cloud(i, n=20 + i) for i in range(5)]
    imps = [np.random.default_rng(10 + i).random(20 + i) for i in range(5)]
    pairs = [
        (lambda m, c: m.scatter3d_batch(c, titles=list("abcde"), ncols=3), clouds),
        (lambda m, c: m.scatter3d_superpose(c[0], c[1]), clouds),
        (lambda m, c: m.scatter3d_colors(c[2], imps[2]), clouds),
        (lambda m, c: m.scatter3d_explanation_batch(c, imps, ncols=2), clouds),
    ]
    for call, data in pairs:
        want = _figure_data(_draw(call(jv, data)))
        got = _figure_data(_draw(call(tv, [torch.from_numpy(c) for c in data])))
        _assert_same(got, want)


def test_voxel_figure_and_superpose_faces():
    rng = np.random.default_rng(5)
    vol = rng.random((6, 5, 4))
    heat = rng.standard_normal((6, 5, 4))
    for call in (lambda m, v, h: m.voxel_figure(v, threshold=0.6),
                 lambda m, v, h: m.voxel_superpose(v, h, vox_threshold=0.7, heat_threshold=0.4)):
        figs = [_draw(call(jv, vol, heat)),
                _draw(call(tv, torch.from_numpy(vol), torch.from_numpy(heat)))]
        faces = []
        for fig in figs:
            ax = fig.axes[0]
            faces.append([(np.asarray(c.get_facecolor()), [np.asarray(p) for p in c._vec.T])
                          for c in ax.collections])
        _assert_same(faces[1], faces[0])
        assert len(faces[0]) > 0


@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_voxel_surface_mesh_bit_for_bit(threshold):
    rng = np.random.default_rng(1)
    vol = rng.random((7, 6, 5)) * (rng.random((7, 6, 5)) > 0.3)
    want = jv.voxel_surface_mesh(vol, threshold)
    for arg in (vol, torch.from_numpy(vol)):
        got = tv.voxel_surface_mesh(arg, threshold)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    empty = tv.voxel_surface_mesh(np.zeros((3, 3, 3)))
    _assert_same([e.shape for e in empty], [(0, 3), (0, 3), (0,)])
    with pytest.raises(ValueError, match="Expected \\(D, H, W\\) volume"):
        tv.voxel_surface_mesh(np.zeros((3, 3)))


def test_the_plotly_half_raises_without_plotly(monkeypatch):
    assert tv.HAS_PLOTLY == jv.HAS_PLOTLY
    for mod in (tv, jv):  # where plotly is installed, its absence is what is held
        monkeypatch.setattr(mod, "HAS_PLOTLY", False)
    vol = np.ones((2, 2, 2))
    for name, args in (("scatter3d_plotly", (_cloud(0),)), ("voxels_plotly", (vol,)),
                       ("voxel_superpose_plotly", (vol, vol))):
        with pytest.raises(ImportError) as terr:
            getattr(tv, name)(*args)
        with pytest.raises(ImportError) as jerr:
            getattr(jv, name)(*args)
        assert str(terr.value) == str(jerr.value)
