"""Parity of the port's scale analyzers (`wam_tpu_torch.analyzers`) and the
fork's analytics (`wam_tpu_torch.analysis`) with the JAX package.

Inputs are made with numpy from a seed and handed to both packages: images,
mosaics (the explainers return the same arrays on both sides), and the
weights of a small 3-channel conv classifier written in both (SAME 3x3 conv,
tanh, global mean, and a bias that keeps class 3 from ever being predicted,
so the "no correct reconstruction" branch runs). `cross_wavelet_iou` runs
WAM-IG on `convnext_test`, its weights drawn with numpy into the JAX tree
and carried across by `flax_convnext_to_torch`.

Tolerances: quantile thresholds, masks and the recorded quantiles are held
equal (the port copies ``jnp.quantile``'s float32 arithmetic);
reconstructions and reprojection maps to 1e-5 of their largest value; the
IoUs equal. The CUDA route is followed on CPU tensors that say they are on
CUDA, with stand-ins of the K1 / K3 launchers that count the launches.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from wam_tpu import analysis as ja
from wam_tpu import analyzers as jan
from wam_tpu import wam2d as jwam
from wam_tpu.models import convnext as jconvnext
from wam_tpu.models import bind_inference as jbind
from wam_tpu.wavelets import transform as jt
from wam_tpu_torch import analysis as ta
from wam_tpu_torch import analyzers as tan
from wam_tpu_torch import kernels
from wam_tpu_torch import wam2d as twam
from wam_tpu_torch.models import convnext as tconvnext
from wam_tpu_torch.models import resnet as tres
from wam_tpu_torch.models.ingest import flax_convnext_to_torch
from wam_tpu_torch.wavelets import filters as tfilters
from wam_tpu_torch.wavelets import matmul as tmm

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

TOL = 1e-5
QS = list(np.linspace(0.95, 0.0, 20))  # the flagship analyzer's insertion sweep


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, what: str):
    got, want = np.asarray(_np(got), np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=TOL * max(np.abs(want).max(), 1e-30), rtol=0,
                               err_msg=what)


@pytest.fixture(scope="module", autouse=True)
def jax_default_route():
    """The JAX transforms on their default CPU route for the module, the
    knobs put back after (other files of the process may leave them
    changed)."""
    saved = jt.get_dwt2_impl(), jt.get_synth2_impl()
    jt.set_dwt2_impl("auto")
    jt.set_synth2_impl("auto")
    yield
    jt.set_dwt2_impl(saved[0])
    jt.set_synth2_impl(saved[1])


@pytest.fixture(scope="module")
def toy():
    """The classifier in both packages (NCHW in), 3 images of 32^2, their
    labels (the third one 3, never predicted), and seeded mosaics for haar
    (32^2) and db4 (38^2)."""
    rng = _rng("toy")
    kern = (rng.standard_normal((4, 3, 3, 3)) * 0.5).astype(np.float32)  # OIHW
    bias = np.array([0.0, 0.0, 0.0, -10.0], np.float32)
    jk = jnp.asarray(kern.transpose(2, 3, 1, 0))  # HWIO

    def jfn(x):
        out = lax.conv_general_dilated(x.transpose(0, 2, 3, 1), jk, (1, 1), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return jnp.tanh(out).mean(axis=(1, 2)) + bias

    tk, tb = torch.from_numpy(kern), torch.from_numpy(bias)

    def tfn(x):
        return torch.tanh(F.conv2d(x, tk, padding=1)).mean(dim=(2, 3)) + tb

    x = rng.standard_normal((3, 3, 32, 32)).astype(np.float32)
    y = np.asarray(jfn(jnp.asarray(x))).argmax(axis=1)
    y[2] = 3
    wams = {"haar": rng.random((3, 32, 32)).astype(np.float32),
            "db4": rng.random((3, 38, 38)).astype(np.float32)}
    return jfn, tfn, x, y, wams


# -- the functions ----------------------------------------------------------------


def test_quantile_equals_jnp_quantile():
    """Bit for bit, on random values and on values with many ties, at qs
    where q (n - 1) is and is not an integer."""
    rng = _rng("q")
    qs = QS + [0.0, 0.25, 0.5, 1.0, 1 / 3]
    for a in (rng.random((32, 32)).astype(np.float32),
              rng.integers(0, 7, (31, 33)).astype(np.float32)):
        want = np.asarray(jnp.quantile(jnp.asarray(a), jnp.asarray(qs)))
        np.testing.assert_array_equal(_np(tan.quantile(torch.from_numpy(a), qs)), want)


def test_levelized_masks_partial_and_disentangled_images(toy):
    *_, x, _, wams = toy
    image, wam = x[0], wams["haar"][0]
    np.testing.assert_array_equal(
        _np(tan.compute_levelized_masks(torch.from_numpy(wam), 3)),
        np.asarray(jan.compute_levelized_masks(jnp.asarray(wam), 3)))
    for q in (0.75,):
        # jitted: one compile of the reference function, not one an op
        jrec, jfilt = jax.jit(jan.generate_partial_image, static_argnums=(2, 3))(
            jnp.asarray(image), jnp.asarray(wam), q, 3)
        trec, tfilt = tan.generate_partial_image(torch.from_numpy(image), torch.from_numpy(wam),
                                                 q, 3)
        np.testing.assert_array_equal(_np(tfilt), np.asarray(jfilt))
        _close(trec, jrec, f"partial image q={q}")
    jp, jm = jax.jit(jan.generate_disentangled_images, static_argnums=(2, 3))(
        jnp.asarray(wam), jnp.asarray(image), 3, 0.2)
    tp, tm = tan.generate_disentangled_images(torch.from_numpy(wam), torch.from_numpy(image), 3,
                                              EPS=0.2)
    np.testing.assert_array_equal(_np(tm), np.asarray(jm))
    _close(tp, jp, "disentangled images")


def _analyzers(toy, wavelet, impl):
    jfn, tfn, x, y, wams = toy
    jm = jan.WAMAnalyzer2D(jfn, lambda *_: wams[wavelet], wavelet=wavelet, J=3)
    tm = tan.WAMAnalyzer2D(tfn, lambda *_: torch.from_numpy(wams[wavelet]), wavelet=wavelet,
                           J=3, device="cpu", impl=impl)
    return jm, tm, x, y


@pytest.mark.parametrize("wavelet,impl", [("haar", "kernel"), ("haar", None)])
def test_isolate_scales_matches_jax(toy, wavelet, impl):
    jm, tm, x, y = _analyzers(toy, wavelet, impl)
    want = jm.isolate_scales(jnp.asarray(x), y, EPS=0.1)
    got = tm.isolate_scales(x, y, EPS=0.1)
    for (tp, tmask), (jp, jmask) in zip(got, want):
        np.testing.assert_array_equal(_np(tmask), np.asarray(jmask))
        _close(tp, jp, "partial images")


@pytest.mark.parametrize("mode", ["insertion", "deletion"])
@pytest.mark.parametrize("wavelet,impl", [("haar", "kernel"), ("db4", None)])
def test_isolate_necessary_components_matches_jax(toy, wavelet, impl, mode):
    """Kept masks and recorded quantiles equal, reconstructions and class
    probabilities to 1e-5 of the largest, and image 2 (label 3) takes the
    no-correct-reconstruction branch on both sides."""
    jm, tm, x, y = _analyzers(toy, wavelet, impl)
    qs = QS if mode == "insertion" else QS[::-1]
    want = jm.isolate_necessary_components(jnp.asarray(x), y, qs, mode)
    got = tm.isolate_necessary_components(x, y, qs, mode)
    recorded = "insertion_quantile" if mode == "insertion" else "deletion_quantile"
    assert getattr(tm, recorded) == getattr(jm, recorded) and len(getattr(jm, recorded)) >= 1
    for (trecs, tkept, twam, (tprobs, tidx)), (jrecs, jkept, jwam_, (jprobs, jidx)) in zip(got, want):
        np.testing.assert_array_equal(_np(twam), np.asarray(jwam_))
        if jkept is None:
            assert tkept is None and tprobs is None and trecs == (None, None, None)
            assert np.isnan(tidx) and np.isnan(jidx)
            continue
        assert tidx == jidx
        np.testing.assert_array_equal(_np(tkept), jkept)
        for a, b in zip(trecs, jrecs):
            _close(a, b, "reconstruction")
        _close(tprobs, jprobs, "class probabilities")
    assert got[2][1] is None
    with pytest.raises(AssertionError):
        tm.isolate_necessary_components(x, y, qs[::-1], mode)
    with pytest.raises(ValueError, match="mode"):
        tm.isolate_necessary_components(x, y, qs, "both")


def test_vit_analyzer_needs_a_patch_plan(toy):
    _, tfn, *_ = toy
    explainer = twam.WaveletAttribution2D(tfn, device="cpu")
    with pytest.raises(ValueError, match="level_plan='patch'"):
        tan.WAMAnalyzerViT(explainer)
    with pytest.raises(ValueError, match="level_plan='patch'"):
        jan.WAMAnalyzerViT(explainer)


# -- analysis.py --------------------------------------------------------------------


def test_analysis_statistics_match_jax(toy):
    jfn, tfn, x, y, wams = toy
    expl = list(wams["haar"])
    for key, value in ja.get_diagonal(expl[0], 3).items():
        np.testing.assert_array_equal(ta.get_diagonal(torch.from_numpy(expl[0]), 3)[key], value)
    for size in ("maximal", "minimal"):
        jmean, jvar = ja.get_mean_pixelwise_variance(expl[1], 3, size)
        tmean, tvar = ta.get_mean_pixelwise_variance(expl[1], 3, size)
        assert tmean == jmean
        np.testing.assert_array_equal(tvar, jvar)
        assert ta.rank_images(expl, 3, size) == ja.rank_images(expl, 3, size)
    with pytest.raises(ValueError, match="size"):
        ta.get_mean_pixelwise_variance(expl[0], 3, "median")
    shares = ta.get_gradients_attribution_on_levels(expl, 3)
    np.testing.assert_array_equal(shares, ja.get_gradients_attribution_on_levels(expl, 3))
    multi = ta.get_multiple_grad_attr([expl, expl[:2]], 3)
    jmulti = ja.get_multiple_grad_attr([expl, expl[:2]], 3)
    for a, b in zip(ta.get_mean_across_images(multi), ja.get_mean_across_images(jmulti)):
        np.testing.assert_array_equal(a, b)
    for p in (0.05, 0.3):
        np.testing.assert_array_equal(ta.top_percentage_mask(expl[0], p),
                                      ja.top_percentage_mask(expl[0], p))
    masks = [ta.top_percentage_mask(e, 0.2) for e in expl]
    assert ta.iou(masks[0], masks[1]) == ja.iou(masks[0], masks[1])
    assert ta.iou(masks[0] & False, masks[1] & False) == 0.0
    assert ta.mean_pairwise_iou(masks) == ja.mean_pairwise_iou(masks)
    assert ta.mean_pairwise_iou(masks[:1]) == 0.0
    _close(ta.reprojection_map(expl[2], 3, device="cpu"), ja.reprojection_map(expl[2], 3),
           "reprojection map")
    wam = twam.WaveletAttribution2D(tfn, method="integratedgrad", n_samples=2, device="cpu")
    jwam_ = jwam.WaveletAttribution2D(jfn, method="integratedgrad", n_samples=2)
    _close(ta.get_explanation_for_image(x[0], tfn, wam, lambda im: torch.from_numpy(im)[None]),
           ja.get_explanation_for_image(x[0], jfn, jwam_, lambda im: jnp.asarray(im)[None]),
           "explanation")


def _draw_convnext():
    """convnext_test (10 classes) weights drawn with numpy into the JAX
    tree's shapes (no init compile): kernels N(0, 1/fan_in), biases and the
    LayerNorm shifts N(0, 0.05^2), scales 1 + N(0, 0.1^2), layer scales
    U(0.5, 1.5)."""
    model = jconvnext.convnext_test(num_classes=10)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))

    def draw(path, s):
        name = path[-1].key
        rng = _rng("cnx", jax.tree_util.keystr(path))
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "gamma":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    variables = {"params": jax.tree_util.tree_map_with_path(draw, shapes["params"])}
    tmodel = tconvnext.convnext_test(num_classes=10)
    tmodel.load_state_dict(flax_convnext_to_torch(variables), strict=True)
    # jitted: op-by-op dispatch compiles every op of the forward
    return jax.jit(jbind(model, variables, nchw=True)), tres.bind_inference(tmodel, device="cpu")


def test_cross_wavelet_iou_on_convnext_matches_jax():
    """The IoU experiment at test size: WAM-IG (J=2, 2 path points) under
    haar and db4 on convnext_test, one 32^2 image; the crop before the
    reprojection (db4's mosaic is 38^2); maps to 1e-5, IoUs equal."""
    jfn, tfn = _draw_convnext()
    image = _rng("iou-img").standard_normal((3, 32, 32)).astype(np.float32)
    wavelets = ("haar", "db4")

    def jmake(w):
        return jwam.WaveletAttribution2D(jfn, wavelet=w, J=2, method="integratedgrad",
                                         n_samples=2)

    def tmake(w):
        return twam.WaveletAttribution2D(tfn, wavelet=w, J=2, method="integratedgrad",
                                         n_samples=2, device="cpu")

    want = ja.cross_wavelet_reprojection_maps(image, jmake, wavelets, jfn,
                                              lambda im: jnp.asarray(im)[None], 2)
    got = ta.cross_wavelet_reprojection_maps(image, tmake, wavelets, tfn,
                                             lambda im: torch.from_numpy(im)[None], 2,
                                             device="cpu")
    for g, w in zip(got, want):
        assert g.shape == (32, 32)
        _close(g, w, "reprojection map")
    for p in (0.05, 0.25, 0.5):
        assert ta.iou_from_reprojection_maps(got, p) == ja.iou_from_reprojection_maps(want, p)
    cached = {w: tmake(w) for w in wavelets}
    assert ta.cross_wavelet_iou(image, cached.get, wavelets, 0.25, tfn,
                                lambda im: torch.from_numpy(im)[None], 2,
                                device="cpu") == ja.iou_from_reprojection_maps(want, 0.25)


# -- the CUDA route -----------------------------------------------------------------


class FakeCuda(torch.Tensor):
    """A CPU tensor that says it lives on CUDA, to follow the CUDA route."""

    @property
    def is_cuda(self):
        return True


def test_analyzers_on_cuda_launch_k1_three_and_k3_one_an_image(monkeypatch):
    """At 224^2, haar, J=3 (detail sides 112 / 56 / 28, all collapsed):
    each image of a call decomposes once through K1 (3 levels) and
    reconstructs its whole mask family in one K3 forward over masks x 3
    rows; never K3's backward, K2, K4 or K5. Values equal the plain route."""
    w = tfilters.build_wavelet("haar")
    dec, rec = (tuple(w.dec_lo), tuple(w.dec_hi)), (tuple(w.rec_lo), tuple(w.rec_hi))
    cpu = torch.device("cpu")
    calls = []

    def dwt2(x3, plan):
        calls.append(("dwt2", x3.shape[0]))
        _, At = tmm._kernel_analysis(plan.q, *dec, "reflect", cpu)
        _, Bt = tmm._kernel_analysis(plan.s, *dec, "reflect", cpu)
        return tmm.dwt2_plain(x3, At, Bt)

    def pair(leaves, plan):
        calls.append(("pair", leaves[0].shape[0]))
        out = 0
        for i, (R, C) in enumerate(zip(tmm._level_blocks(plan.rows, *rec),
                                       tmm._level_blocks(plan.cols, *rec))):
            h, v, d = leaves[1 + 3 * i:4 + 3 * i]
            aa = leaves[0] if i == 0 else torch.zeros_like(h)
            y = torch.cat([torch.cat([aa, v], -1), torch.cat([h, d], -1)], -2)
            out = out + torch.from_numpy(R).float() @ y @ torch.from_numpy(C).float().T
        return out

    monkeypatch.setattr(kernels, "dwt2", dwt2)
    monkeypatch.setattr(kernels, "pair", pair)
    for name in ("pair_bwd", "synth2", "relu_fwd", "relu_bwd", "build_all"):
        monkeypatch.setattr(kernels, name, lambda *a: pytest.fail("not on the analyzers path"))
    rng = _rng("cuda-route")
    weights = torch.from_numpy(rng.standard_normal((4, 3 * 224 * 224)).astype(np.float32) / 400)

    def model_fn(v):
        return torch.tanh(v.reshape(v.shape[0], -1) @ weights.T)

    x = torch.from_numpy(rng.standard_normal((2, 3, 224, 224)).astype(np.float32))
    wams = torch.from_numpy(rng.random((2, 224, 224)).astype(np.float32))
    out = {}
    for tag, xin in (("cuda", x.as_subclass(FakeCuda)), ("plain", x)):
        an = tan.WAMAnalyzer2D(model_fn, lambda *_: wams, device="cpu")
        calls.clear()
        scales = an.isolate_scales(xin, [0, 1])
        assert calls == ([("dwt2", 3)] * 3 + [("pair", 12)]) * 2 if tag == "cuda" else not calls
        calls.clear()
        comps = an.isolate_necessary_components(xin, [0, 1], QS, "insertion")
        assert calls == ([("dwt2", 3)] * 3 + [("pair", 60)]) * 2 if tag == "cuda" else not calls
        out[tag] = scales, comps
    for (a, _), (b, _) in zip(out["cuda"][0], out["plain"][0]):
        torch.testing.assert_close(a.as_subclass(torch.Tensor), b, atol=1e-5, rtol=0)
    for a, b in zip(out["cuda"][1], out["plain"][1]):
        assert a[3][1] == b[3][1] or (np.isnan(a[3][1]) and np.isnan(b[3][1]))
        if b[3][0] is not None:
            np.testing.assert_allclose(a[3][0], b[3][0], atol=1e-6, rtol=0)


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no device given and no card, the analyzer and the reprojection
    raise rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tan.WAMAnalyzer2D(lambda v: v, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        ta.reprojection_map(np.zeros((8, 8), np.float32), 2)
    assert tan.WAMAnalyzer2D(lambda v: v, None, device="cpu").device == torch.device("cpu")
