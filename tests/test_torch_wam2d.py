"""Parity of the PyTorch port's WAM-2D slice with the JAX package: packing,
estimators, the engine and `WaveletAttribution2D` end to end.

Weights are a JAX ResNet-18 init carried across by `flax_resnet_to_torch`;
SmoothGrad noise is drawn once with numpy and handed to both packages (the
JAX side averages `BaseWAM2D` passes on x + sigma * z_i, the port takes the
draws through ``noise=``). The port runs on its "kernel" impl (the path the
card runs, through the kernels' plain versions on CPU tensors) and on its
"conv" impl.

Tolerance: mosaics are normalized to [0, 1] per block and come out of
float32 gradients through ResNet-18 computed with different summation orders
on the two sides; they agree to ~1e-6 and the bound is 1e-4.
"""

import importlib
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wam_tpu import wam2d as jwam
from wam_tpu.core import engine as jengine
from wam_tpu.core import estimators as jest
from wam_tpu.models import bind_inference as jbind
from wam_tpu.models import resnet18 as jresnet18
from wam_tpu.ops import packing2d as jpack
from wam_tpu.wavelets import transform as jt
from wam_tpu_torch import wam2d as twam
from wam_tpu_torch.models import resnet as tres
from wam_tpu_torch.models.ingest import flax_resnet_to_torch
from wam_tpu_torch.wavelets import transform as tt

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

SLICE_TOL = 1e-4
# `wam_tpu.tune` re-exports the function `fused_relu` under the module's name
jfr = importlib.import_module("wam_tpu.tune.fused_relu")


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _np(t):
    return t.detach().numpy()


# -- the slice: WaveletAttribution2D on ResNet-18 ----------------------------------


@pytest.fixture(scope="module", autouse=True)
def jax_default_route():
    """The JAX side on its default route (conv analysis and synthesis, XLA's
    ReLU on the CPU) for the whole module, its module fixtures included, and
    the knobs put back after. They are module globals that other test files
    of the same process may leave changed (tests/test_tune.py leaves the
    synthesis on "matmul"); a ResNet-18 mosaic moves by ~3e-3 when the
    synthesis changes its summation order, as ReLU gates near zero flip."""
    saved = jt.get_dwt2_impl(), jt.get_synth2_impl(), jfr.get_fused_relu_impl()
    jt.set_dwt2_impl("auto")
    jt.set_synth2_impl("auto")
    jfr.set_fused_relu_impl("auto")
    yield
    jt.set_dwt2_impl(saved[0])
    jt.set_synth2_impl(saved[1])
    jfr.set_fused_relu_impl(saved[2])


@pytest.fixture(scope="module")
def r18():
    model = jresnet18(num_classes=10)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    jfn = jbind(model, variables, nchw=True)
    tfn = tres.bind_inference(tres.resnet18(num_classes=10), flax_resnet_to_torch(variables),
                              device="cpu")
    rng = _rng("slice")
    x = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
    y = np.array([1, 7])
    return jfn, tfn, x, y, model, variables


def test_base_wam2d_matches_jax(r18):
    jfn, tfn, x, y, *_ = r18
    jm = jwam.BaseWAM2D(jfn, wavelet="db4", J=3)
    want = np.asarray(jm(jnp.asarray(x), jnp.asarray(y)))
    tm = twam.BaseWAM2D(tfn, wavelet="db4", J=3, device="cpu", impl="kernel")
    got = _np(tm(torch.from_numpy(x), torch.from_numpy(y)))
    assert got.shape == want.shape == (2, 70, 70)
    np.testing.assert_allclose(got, want, atol=SLICE_TOL, rtol=0)
    np.testing.assert_allclose(_np(tm.scales), np.asarray(jm.scales), atol=SLICE_TOL, rtol=0)


@pytest.fixture(scope="module")
def jax_smooth(r18):
    """JAX SmoothGrad on handed-over draws: the mean of `BaseWAM2D` passes
    on x + sigma * z_i."""
    jfn, _, x, y, *_ = r18
    z = _rng("noise").standard_normal((3,) + x.shape).astype(np.float32)
    sigma = np.asarray(jest.noise_sigma(jnp.asarray(x), 0.25)).reshape(-1, 1, 1, 1)
    jm = jwam.BaseWAM2D(jfn, wavelet="db4", J=3)
    want = np.mean([np.asarray(jm(jnp.asarray(x + zi * sigma), jnp.asarray(y))) for zi in z],
                   axis=0)
    return z, want


@pytest.mark.parametrize("impl", ["kernel", "conv"])
def test_smooth_wam_matches_jax_with_handed_noise(r18, jax_smooth, impl):
    _, tfn, x, y, *_ = r18
    z, want = jax_smooth
    tm = twam.WaveletAttribution2D(tfn, wavelet="db4", J=3, method="smooth", n_samples=3,
                                   stdev_spread=0.25, device="cpu", impl=impl)
    got = _np(tm(torch.from_numpy(x), torch.from_numpy(y), noise=torch.from_numpy(z)))
    np.testing.assert_allclose(got, want, atol=SLICE_TOL, rtol=0)
    want_scales = np.asarray(jpack.reproject_mosaic(jnp.asarray(want), 3))
    np.testing.assert_allclose(_np(tm.scales), want_scales, atol=SLICE_TOL * 3, rtol=0)


@pytest.fixture(scope="module")
def jax_ig(r18):
    """JAX IG two ways: the package's own pieces evaluated op by op
    (baseline mosaic of the input coefficients times the trapezoid over
    alpha in {0, .5, 1}, dx=1, of the gradient mosaics), and the class."""
    jfn, _, x, y, *_ = r18
    je = jengine.WamEngine(jfn, ndim=2, wavelet="db4", level=3)
    coeffs = je.decompose(jnp.asarray(x))
    path = [jpack.mosaic2d(je.grads_from_coeffs(
        jax.tree_util.tree_map(lambda c, a=a: c * a, coeffs), jnp.asarray(y), (64, 64)))
        for a in (0.0, 0.5, 1.0)]
    eager = np.asarray(jpack.mosaic2d(coeffs) * (path[0] / 2 + path[1] + path[2] / 2))
    jm = jwam.WaveletAttribution2D(jfn, wavelet="db4", J=3, method="integratedgrad",
                                   n_samples=3, sample_batch_size=None)
    return eager, np.asarray(jm(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("impl", ["kernel", "conv"])
def test_integrated_wam_matches_jax(r18, jax_ig, impl):
    _, tfn, x, y, *_ = r18
    eager, cls = jax_ig
    tm = twam.WaveletAttribution2D(tfn, wavelet="db4", J=3, method="integratedgrad",
                                   n_samples=3, device="cpu", impl=impl)
    got = _np(tm(torch.from_numpy(x), torch.from_numpy(y)))
    # the integral sums 3 normalized mosaics: 3x the slice tolerance
    np.testing.assert_allclose(got, eager, atol=3 * SLICE_TOL, rtol=0)
    # The JAX class jit-compiles the same math into one scan; at this input
    # its result differs from its op-by-op evaluation by 2.3e-3 (a few ReLU
    # gates near zero flip under XLA's reordered sums), so against the class
    # the bound is 3e-3.
    np.testing.assert_allclose(got, cls, atol=3e-3, rtol=0)


@pytest.mark.parametrize("method", ["smooth", "integratedgrad"])
@pytest.mark.parametrize("normalize", [False, True])
def test_chunked_run_equals_unchunked(r18, method, normalize):
    """sample_batch_size=2 folds two samples into one model call of 2B rows:
    the loss must be the sum of per-sample batch means (else every gradient
    is 1/2 of the right one, visible with normalize_coeffs=False) and the
    mosaic max must be per sample (visible with normalization on)."""
    _, tfn, x, y, *_ = r18
    z = torch.from_numpy(_rng("chunk").standard_normal((3,) + x.shape).astype(np.float32))
    kw = dict(wavelet="db4", J=3, method=method, n_samples=3, normalize_coeffs=normalize,
              device="cpu", impl="kernel")
    extra = {"noise": z} if method == "smooth" else {}
    one = twam.WaveletAttribution2D(tfn, sample_batch_size=None, **kw)(x, y, **extra)
    two = twam.WaveletAttribution2D(tfn, sample_batch_size=2, **kw)(x, y, **extra)
    scale = float(one.abs().max())
    assert scale > 0
    torch.testing.assert_close(two, one, atol=1e-5 * scale, rtol=1e-5)


def test_dwt_bf16_cast_after_noise(r18):
    """dwt_bf16 rounds the NOISY input to bf16 inside the step: the result
    equals the f32 run on bf16-rounded noisy inputs, and stays close to the
    f32 run."""
    _, tfn, x, y, *_ = r18
    z = torch.from_numpy(_rng("bf16").standard_normal((2,) + x.shape).astype(np.float32))
    kw = dict(wavelet="db4", J=3, n_samples=2, device="cpu", impl="kernel")
    bf = twam.WaveletAttribution2D(tfn, dwt_bf16=True, **kw)(x, y, noise=z)
    f32 = twam.WaveletAttribution2D(tfn, **kw)(x, y, noise=z)
    assert bf.dtype == torch.float32
    assert not torch.equal(bf, f32)
    cos = torch.nn.functional.cosine_similarity(bf.flatten(), f32.flatten(), dim=0)
    assert float(cos) > 0.99


@pytest.fixture
def k2_route(monkeypatch):
    """Both packages with the synthesis crossover lowered to 32, so at 64²
    (db4 J=3, detail sides 35/21/14) the two coarsest levels collapse (K3)
    and the finest runs per level (K2); the JAX side on its Pallas
    synthesis and its Pallas fused ReLU (interpret mode). The JAX knobs are
    module globals and are put back after the test."""
    monkeypatch.setattr(jt, "_SYNTH_COLLAPSE", 32)
    monkeypatch.setattr(tt, "SYNTH_COLLAPSE", 32)
    synth, relu = jt.get_synth2_impl(), jfr.get_fused_relu_impl()
    jt.set_synth2_impl("pallas")
    jfr.set_fused_relu_impl("pallas_interpret")
    yield
    jt.set_synth2_impl(synth)
    jfr.set_fused_relu_impl(relu)


def test_smooth_wam_with_k2_and_fused_relu_matches_jax(r18, k2_route):
    """The second slice's path at a small size: SmoothGrad through a K2
    synthesis level, on a model bound with fused_relu_vjp=True, against the
    JAX package on the same route, noise handed over."""
    _, _, x, y, model, variables = r18
    jfn = jbind(model, variables, nchw=True, fused_relu_vjp=True)
    tfn = tres.bind_inference(tres.resnet18(num_classes=10), flax_resnet_to_torch(variables),
                              fused_relu_vjp=True, device="cpu")
    assert tt._collapse_count(tt.wavedec2(torch.from_numpy(x), "db4", 3)[1:]) == 2
    z = _rng("noise-k2").standard_normal((2,) + x.shape).astype(np.float32)
    sigma = np.asarray(jest.noise_sigma(jnp.asarray(x), 0.25)).reshape(-1, 1, 1, 1)
    jm = jwam.BaseWAM2D(jfn, wavelet="db4", J=3)
    want = np.mean([np.asarray(jm(jnp.asarray(x + zi * sigma), jnp.asarray(y))) for zi in z],
                   axis=0)
    tm = twam.WaveletAttribution2D(tfn, wavelet="db4", J=3, method="smooth", n_samples=2,
                                   stdev_spread=0.25, sample_batch_size=2, device="cpu",
                                   impl="kernel")
    got = _np(tm(torch.from_numpy(x), torch.from_numpy(y), noise=torch.from_numpy(z)))
    assert got.shape == (2, 70, 70) and np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, atol=SLICE_TOL, rtol=0)


def test_wam2d_rejects_unported_options(r18):
    _, tfn, *_ = r18
    # mesh= is ported (tests/test_torch_seq_estimators.py): a meshed explainer
    # refuses both serving entries, batch_axis needs a mesh
    from wam_tpu_torch.parallel import make_mesh

    meshed = twam.WaveletAttribution2D(tfn, mesh=make_mesh({"data": 2}, ["cpu"] * 2),
                                       device="cpu")
    with pytest.raises(ValueError, match="serve_entry"):
        meshed.serve_entry()
    with pytest.raises(ValueError, match="anytime_serve_entry"):
        meshed.anytime_serve_entry()
    with pytest.raises(ValueError, match="batch_axis= requires mesh="):
        twam.WaveletAttribution2D(tfn, batch_axis="data", device="cpu")
    # model_layout="nhwc" is ported (tests/test_torch_nhwc.py); an unknown
    # layout raises the reference's ValueError
    with pytest.raises(ValueError, match="model_layout"):
        twam.BaseWAM2D(tfn, model_layout="hwcn", device="cpu")
    m = twam.WaveletAttribution2D(tfn, device="cpu")
    assert callable(m.serve_entry())  # ported (tests/test_torch_serve.py), and the AOT key
    assert m.serve_entry(aot_key="k").wam_aot_fns == []  # steps made at the first call
    # anytime_serve_entry is ported (tests/test_torch_anytime.py): SmoothGrad only
    with pytest.raises(ValueError, match="smooth"):
        twam.WaveletAttribution2D(tfn, method="integratedgrad", device="cpu").anytime_serve_entry()
    with pytest.raises(ValueError):
        twam.WaveletAttribution2D(tfn, method="gradcam", device="cpu")
