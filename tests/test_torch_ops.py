"""Parity of the PyTorch port's mosaic packing, estimators and gradient
engine with the JAX package (the slice end to end is test_torch_wam2d.py).

Inputs are made with numpy from a seed and go through both packages.
Tolerance: the pure packing and estimator functions are held to 1e-6 (a few
float32 ulps of values of O(1)); engine gradients through the toy model to
1e-6 absolute plus 1e-4 relative (float32 convolutions in another order).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wam_tpu.core import engine as jengine
from wam_tpu.core import estimators as jest
from wam_tpu.models.toy import toy_conv_model as jtoy
from wam_tpu.ops import packing2d as jpack
from wam_tpu.wavelets import transform as jt
from wam_tpu_torch.core import engine as tengine
from wam_tpu_torch.core import estimators as test_
from wam_tpu_torch.models.toy import toy_conv_model as ttoy
from wam_tpu_torch.ops import packing2d as tpack
from wam_tpu_torch.wavelets import transform as tt

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

PURE_TOL = 1e-6


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _np(t):
    return t.detach().numpy()


def _coeff_pair(shape, wavelet, level, seed):
    """The same random coefficient tree (shapes of a real decomposition) in
    both packages."""
    rng = _rng("coeffs", shape, wavelet, level, seed)
    ref = jt.wavedec2(jnp.zeros(shape), wavelet, level)
    leaves = [rng.standard_normal(np.shape(c)).astype(np.float32)
              for c in jax.tree_util.tree_leaves(ref)]
    j = [jnp.asarray(leaves[0])] + [jt.Detail2D(*map(jnp.asarray, leaves[1 + 3 * i: 4 + 3 * i]))
                                    for i in range(level)]
    t = [torch.from_numpy(leaves[0])] + [tt.Detail2D(*map(torch.from_numpy, leaves[1 + 3 * i: 4 + 3 * i]))
                                         for i in range(level)]
    return j, t


# -- packing -------------------------------------------------------------------


@pytest.mark.parametrize("wavelet,side,normalize",
                         [("haar", 64, True), ("db4", 64, False), ("db4", 45, True)])
def test_mosaic_and_scales_match_jax(wavelet, side, normalize):
    j, t = _coeff_pair((2, 3, side, side), wavelet, 3, 0)
    want = np.asarray(jpack.mosaic2d(j, normalize))
    got = _np(tpack.mosaic2d(t, normalize))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=PURE_TOL, rtol=0)
    # per-level maps sum three resized blocks (values up to 3), and the two
    # resizers weight neighbours in another order: a few float32 ulps
    for approx in (False, True):
        np.testing.assert_allclose(
            _np(tpack.reproject_mosaic(torch.from_numpy(want.copy()), 3, approx)),
            np.asarray(jpack.reproject_mosaic(jnp.asarray(want), 3, approx)),
            atol=PURE_TOL, rtol=4e-6)
        np.testing.assert_allclose(
            _np(tpack.disentangle_scales(t, approx)),
            np.asarray(jpack.disentangle_scales(j, approx)), atol=PURE_TOL, rtol=4e-6)


def test_mosaic_normalizes_each_stacked_sample_alone():
    """Leading sample axes: each sample's blocks are normalized by that
    sample's own max over (B, h, w), as the JAX step sees one sample."""
    _, t = _coeff_pair((2, 3, 40, 40), "db4", 2, 1)
    stacked = [torch.stack([c, 5 * c]) for c in [t[0]]] + [
        tt.Detail2D(*(torch.stack([c, 5 * c]) for c in d)) for d in t[1:]]
    out = tpack.mosaic2d(stacked)
    torch.testing.assert_close(out[0], tpack.mosaic2d(t))
    torch.testing.assert_close(out[1], out[0])


@pytest.mark.parametrize("wavelet,side", [("haar", 64), ("db4", 45), ("db4", 224)])
def test_deferred_normalization_equals_the_mosaic_over_the_whole_batch(wavelet, side):
    """`normalize_mosaic` of blocks of rows, with `leaf_maxima` reduced by
    max over the blocks, gives `mosaic2d(normalize=True)` of the whole
    batch, overlapping regions (long filters) included: equal."""
    _, t = _coeff_pair((4, 3, side, side), wavelet, 3, 2)
    want = tpack.mosaic2d(t, True)
    halves = [[c[lo:lo + 2] for c in t[:1]] + [tt.Detail2D(*(c[lo:lo + 2] for c in d))
                                                for d in t[1:]] for lo in (0, 2)]
    maxima = torch.maximum(*(tpack.leaf_maxima(h) for h in halves))
    assert maxima.shape == (1 + 3 * 3,)
    got = torch.cat([tpack.normalize_mosaic(tpack.mosaic2d(h, False), maxima,
                                            tpack.mosaic_regions(h)) for h in halves])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("src,size", [((3, 3), 10), ((5, 7), 230), ((17, 34), 64), ((1, 4), 8)])
def test_resize_bilinear_matches_jax_at_borders(src, size):
    a = _rng("resize", src, size).standard_normal((2,) + src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(a), (2, size, size), method="bilinear"))
    got = _np(tpack._resize_bilinear(torch.from_numpy(a), size))
    np.testing.assert_allclose(got, want, atol=PURE_TOL, rtol=0)
    # the borders specifically: first/last rows and columns
    for sl in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_allclose(got[sl], want[sl], atol=PURE_TOL, rtol=0)


# -- estimators ----------------------------------------------------------------


def test_noise_sigma_trapezoid_and_loss_match_jax():
    rng = _rng("est")
    x = rng.standard_normal((3, 2, 8, 9)).astype(np.float32)
    np.testing.assert_allclose(_np(test_.noise_sigma(torch.from_numpy(x), 0.25)),
                               np.asarray(jest.noise_sigma(jnp.asarray(x), 0.25)),
                               atol=PURE_TOL, rtol=0)
    path = rng.standard_normal((5, 4, 6)).astype(np.float32)
    path[1, 2, 3] = np.nan
    np.testing.assert_allclose(_np(test_.trapezoid(torch.from_numpy(path))),
                               np.asarray(jest.trapezoid(jnp.asarray(path))),
                               atol=PURE_TOL, rtol=0)
    logits = rng.standard_normal((4, 7)).astype(np.float32)
    y = np.array([0, 6, 3, 3])
    for yy in (y, None):
        np.testing.assert_allclose(
            float(tengine.target_loss(torch.from_numpy(logits),
                                      None if yy is None else torch.from_numpy(yy))),
            float(jengine.target_loss(jnp.asarray(logits), yy)), atol=PURE_TOL)


def test_smoothgrad_estimator_matches_jax_with_handed_noise():
    """A nonlinear step through both estimators on the same draws."""
    rng = _rng("sg")
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    z = rng.standard_normal((5, 2, 3, 4)).astype(np.float32)
    # JAX draws its own normals; hand them over by averaging the step
    sigma = jest.noise_sigma(jnp.asarray(x), 0.3).reshape(2, 1, 1)
    want = np.mean([np.asarray(jnp.tanh(jnp.asarray(x) + jnp.asarray(zi) * sigma) ** 2)
                    for zi in z], axis=0)
    for bs in (None, 2):
        got = test_.smoothgrad(lambda v: torch.tanh(v) ** 2, torch.from_numpy(x), n_samples=5,
                               stdev_spread=0.3, batch_size=bs, noise=torch.from_numpy(z))
        np.testing.assert_allclose(_np(got), want, atol=PURE_TOL, rtol=0)


def test_sample_batch_size_validation():
    with pytest.raises(ValueError):
        test_.validate_sample_batch_size("false")
    assert test_.resolve_sample_chunk("auto", 25) is None
    assert test_.resolve_sample_chunk(None, 25) is None
    assert test_.resolve_sample_chunk(4, 25) == 4
    assert test_.resolve_sample_chunk(30, 25) is None
    with pytest.raises(ValueError):
        test_.resolve_sample_chunk(0, 25)


# -- engine ----------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["conv", "matmul", "kernel"])
def test_engine_grads_match_jax_on_toy_model(impl):
    key = jax.random.PRNGKey(3)
    kern = np.asarray(jax.random.normal(key, (4, 1, 5, 5), jnp.float32) * 0.3)
    x = _rng("toy").standard_normal((3, 36, 40)).astype(np.float32)
    y = np.array([0, 3, 1])
    je = jengine.WamEngine(jtoy(key), ndim=2, wavelet="db4", level=3)
    _, want = je.attribute(jnp.asarray(x), jnp.asarray(y))
    te = tengine.WamEngine(ttoy(kern, device="cpu"), ndim=2, wavelet="db4", level=3, impl=impl)
    _, got = te.attribute(torch.from_numpy(x), torch.from_numpy(y))
    flat_w = [np.asarray(a) for a in jax.tree_util.tree_leaves(want)]
    flat_g = [_np(got[0])] + [_np(t) for d in got[1:] for t in d]
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-4)


def test_engine_rejects_unported_modes():
    # channel_last is ported for ndim=2 (tests/test_torch_nhwc.py) and
    # raises the reference's ValueError for any other rank
    assert tengine.WamEngine(lambda v: v, ndim=2, channel_last=True).channel_last
    with pytest.raises(ValueError, match="channel_last"):
        tengine.WamEngine(lambda v: v, ndim=1, channel_last=True)
    with pytest.raises(ValueError, match="ndim"):
        tengine.WamEngine(lambda v: v, ndim=4)
    # ported with the audio slice (1D) and the 3D slice
    assert [tengine.WamEngine(lambda v: v, ndim=n).ndim for n in (1, 3)] == [1, 3]


