"""Parity of the PyTorch port's ViT and ConvNeXt slice with the JAX package:
`PatchConv`, the two models, their checkpoint maps, and WAM-2D Integrated
Gradients and SmoothGrad on both (haar, J=3), as `BASELINE.json`'s ViT
workload runs them.

Weights are a JAX init with every LayerNorm, bias and layer scale redrawn
with numpy (so each map is exercised), carried to the port by
`flax_vit_to_torch` / `flax_convnext_to_torch`; inputs and SmoothGrad noise
are numpy draws handed to both packages. The port runs on its "kernel" impl
(the card's route, through K1's and K3's plain versions on CPU tensors) and
on its "conv" impl.

Tolerances: logits 1e-4 (float32 products in other summation orders over a
few layers); attribution mosaics 1e-4 of their largest value. Neither model
has a ReLU gate to flip, so the JAX class's jitted scan and its op-by-op
evaluation agree as closely as the port does with either.
"""

import importlib
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.torch_ref_models import TorchTinyConvNeXt, TorchTinyViT
from wam_tpu import wam2d as jwam
from wam_tpu.core import engine as jengine
from wam_tpu.core import estimators as jest
from wam_tpu.models import bind_inference as jbind
from wam_tpu.models import convnext as jconvnext
from wam_tpu.models import ingest as jingest
from wam_tpu.models import vit as jvit
from wam_tpu.models.patchconv import PatchConv as JPatchConv
from wam_tpu.ops import packing2d as jpack
from wam_tpu.wavelets import transform as jt
from wam_tpu_torch import kernels
from wam_tpu_torch import wam2d as twam
from wam_tpu_torch.models import convnext as tconvnext
from wam_tpu_torch.models import patchconv as tpc
from wam_tpu_torch.models import resnet as tres
from wam_tpu_torch.models import vit as tvit
from wam_tpu_torch.models.ingest import flax_convnext_to_torch, flax_vit_to_torch
from wam_tpu_torch.wavelets import filters as tfilters
from wam_tpu_torch.wavelets import matmul as tmm
from wam_tpu_torch.wavelets import transform as tt

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

TOL = 1e-4
SIDE = 32  # both tiny models at 32^2: haar J=3 detail sides 16 / 8 / 4
# `wam_tpu.tune` re-exports the function `fused_relu` under the module's name
jfr = importlib.import_module("wam_tpu.tune.fused_relu")


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _np(t):
    return t.detach().numpy()


@pytest.fixture(scope="module", autouse=True)
def jax_default_route():
    """The JAX side on its default route (conv analysis and synthesis on the
    CPU) for the whole module, the knobs put back after: they are module
    globals that other test files of the same process may leave changed."""
    saved = jt.get_dwt2_impl(), jt.get_synth2_impl(), jfr.get_fused_relu_impl()
    jt.set_dwt2_impl("auto")
    jt.set_synth2_impl("auto")
    jfr.set_fused_relu_impl("auto")
    yield
    jt.set_dwt2_impl(saved[0])
    jt.set_synth2_impl(saved[1])
    jfr.set_fused_relu_impl(saved[2])


def _redrawn(variables, seed):
    """The init's params with LayerNorm scales 1 + N(0, 0.1^2), biases (and
    the class token) N(0, 0.05^2) and layer scales U(0.5, 1.5), drawn with
    numpy; kernels and position embeddings as the init drew them."""
    def redraw(path, a):
        name = path[-1].key
        rng = np.random.default_rng(zlib.crc32(f"{seed}{path}".encode()))
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name in ("bias", "cls_token"):
            return (0.05 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "gamma":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return np.asarray(a)

    return {"params": jax.tree_util.tree_map_with_path(redraw, variables["params"])}


def _jax_pair(name):
    """(JAX model, redrawn variables, port model with them loaded)."""
    if name == "vit":
        model = jvit.vit_tiny_test(num_classes=10)
        tmodel = tvit.vit_tiny_test(num_classes=10, image_size=SIDE)
        to_torch = flax_vit_to_torch
    else:
        model = jconvnext.convnext_test(num_classes=10)
        tmodel = tconvnext.convnext_test(num_classes=10)
        to_torch = flax_convnext_to_torch
    variables = _redrawn(model.init(jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3))), name)
    tmodel.load_state_dict(to_torch(variables), strict=True)
    return model, variables, tmodel.eval()


@pytest.fixture(scope="module")
def vit():
    return _jax_pair("vit")


@pytest.fixture(scope="module")
def convnext():
    return _jax_pair("convnext")


def _x(shape, *key):
    return _rng(*key).standard_normal(shape).astype(np.float32)


# -- PatchConv ---------------------------------------------------------------------


@pytest.mark.parametrize("shape,patch", [((2, 32, 32, 3), 8), ((2, 35, 29, 3), 8),
                                          ((1, 19, 22, 16), 4), ((3, 9, 10, 5), 2)],
                         ids=["even", "ragged8", "ragged4", "ragged2"])
def test_patchconv_matches_strided_conv(shape, patch):
    """The block reshape and matmul equal ``F.conv2d(stride=p)`` on the NCHW
    input, remainders cropped (VALID), values and input gradients."""
    torch.manual_seed(0)
    layer = tpc.PatchConv(shape[-1], 12, patch)
    with torch.no_grad():
        layer.bias.normal_()
    x = torch.from_numpy(_x(shape, "patch", shape)).requires_grad_(True)
    got = layer(x)
    want = F.conv2d(x.permute(0, 3, 1, 2), layer.weight, layer.bias,
                    stride=patch).permute(0, 2, 3, 1)
    assert got.shape == (shape[0], shape[1] // patch, shape[2] // patch, 12)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    g = torch.from_numpy(_x(tuple(got.shape), "patch-g", shape))
    (dx,) = torch.autograd.grad(got, x, g)
    (dw,) = torch.autograd.grad(want, x, g)
    torch.testing.assert_close(dx, dw, atol=1e-5, rtol=1e-5)


def test_patchconv_matches_jax():
    """The reference's PatchConv on the same weights ((p, p, C, F) kernel
    as the port's (F, C, p, p)), ragged input."""
    jlayer = JPatchConv(features=12, patch=4)
    x = _x((2, 19, 22, 5), "jpatch")
    variables = jlayer.init(jax.random.PRNGKey(1), jnp.asarray(x))
    bias = _x((12,), "jpatch-bias")
    variables = {"params": {"kernel": variables["params"]["kernel"], "bias": jnp.asarray(bias)}}
    want = np.asarray(jlayer.apply(variables, jnp.asarray(x)))
    tlayer = tpc.PatchConv(5, 12, 4)
    tlayer.load_state_dict({
        "weight": torch.from_numpy(np.asarray(variables["params"]["kernel"]).transpose(3, 2, 0, 1)
                                   .copy()),
        "bias": torch.from_numpy(bias)})
    np.testing.assert_allclose(_np(tlayer(torch.from_numpy(x))), want, atol=1e-5, rtol=1e-5)


# -- models --------------------------------------------------------------------------


def test_vit_tiny_logits_match_jax(vit):
    """The form the card runs (SDPA attention, matmul patch embedding)
    against the reference's explicit softmax and matmul."""
    model, variables, tmodel = vit
    x = _x((2, 3, SIDE, SIDE), "vit-x")
    want = np.asarray(jbind(model, variables, nchw=True)(jnp.asarray(x)))
    with torch.no_grad():
        got = _np(tmodel(torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_convnext_test_logits_match_jax(convnext):
    model, variables, tmodel = convnext
    x = _x((2, 3, SIDE, SIDE), "convnext-x")
    want = np.asarray(jbind(model, variables, nchw=True)(jnp.asarray(x)))
    with torch.no_grad():
        got = _np(tmodel(torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_torch_reference_models_load_strict():
    """timm's and torchvision's names: the reference state dicts load into
    the port with strict=True and give the same logits."""
    torch.manual_seed(0)
    x = torch.from_numpy(_x((2, 3, SIDE, SIDE), "ref-x"))
    ref = TorchTinyViT(num_classes=7).eval()
    port = tvit.vit_tiny_test(num_classes=7, image_size=SIDE).eval()
    port.load_state_dict(ref.state_dict(), strict=True)
    with torch.no_grad():
        torch.testing.assert_close(port(x), ref(x), atol=TOL, rtol=TOL)
    ref = TorchTinyConvNeXt(num_classes=5).eval()
    with torch.no_grad():
        for m in ref.modules():
            if hasattr(m, "layer_scale"):
                m.layer_scale.uniform_(0.5, 1.5)
    port = tconvnext.convnext_test(num_classes=5).eval()
    port.load_state_dict(ref.state_dict(), strict=True)
    with torch.no_grad():
        torch.testing.assert_close(port(x), ref(x), atol=TOL, rtol=TOL)


def _assert_trees_equal(got, want, path=()):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_trees_equal(got[k], want[k], path + (k,))
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=str(path))


@pytest.mark.parametrize("name", ["vit", "convnext"])
def test_ingest_round_trip(vit, convnext, name):
    """The reference's torch -> flax map undoes the port's flax -> torch map
    exactly (the qkv split included), and the port's state dict has every
    key of the module."""
    model, variables, tmodel = vit if name == "vit" else convnext
    if name == "vit":
        state = flax_vit_to_torch(variables)
        back = jingest.torch_vit_to_flax(state, num_heads=4)
    else:
        state = flax_convnext_to_torch(variables)
        back = jingest.torch_convnext_to_flax(state)
    assert set(state) == set(tmodel.state_dict())
    _assert_trees_equal(back, variables)


def test_ingest_ignores_the_perturbation_taps():
    model = jvit.vit_tiny_test(num_classes=3)
    variables = model.init(jax.random.PRNGKey(2), jnp.zeros((1, SIDE, SIDE, 3)))
    assert "perturbations" in variables
    state = flax_vit_to_torch(variables)
    tvit.vit_tiny_test(num_classes=3, image_size=SIDE).load_state_dict(state, strict=True)


def test_bind_vit_inference_bf16_returns_f32(vit):
    _, _, tmodel = vit
    model = tvit.vit_tiny_test(num_classes=10, image_size=SIDE)
    model.load_state_dict(tmodel.state_dict())
    x = torch.from_numpy(_x((2, SIDE, SIDE, 3), "bf16-x"))
    f32 = tvit.bind_vit_inference(tvit.vit_tiny_test(num_classes=10, image_size=SIDE),
                                  tmodel.state_dict(), device="cpu")(x)
    fn = tvit.bind_vit_inference(model, compute_dtype=torch.bfloat16, device="cpu")
    out = fn(x)
    assert out.dtype == torch.float32 and out.shape == (2, 10)
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad for p in model.parameters())
    cos = F.cosine_similarity(out.flatten(), f32.flatten(), dim=0)
    assert float(cos) > 0.99


def test_generic_bind_inference_binds_a_vit(vit):
    """The workload binds the ViT with the generic `bind_inference`
    (NCHW), as `bench_workloads.vit_workload` does."""
    _, _, tmodel = vit
    x = torch.from_numpy(_x((2, 3, SIDE, SIDE), "bind-x"))
    with torch.no_grad():
        want = tmodel(x)
    fn = tres.bind_inference(tmodel, nchw=True, device="cpu")
    torch.testing.assert_close(fn(x), want)
    nhwc = tvit.bind_vit_inference(tmodel, device="cpu")
    torch.testing.assert_close(nhwc(x.permute(0, 2, 3, 1)), want)


def test_unported_taps_raise():
    """``capture_attn`` adds the attention taps and no CAM tap
    (tests/test_torch_xattr.py holds what they capture); the token and stage
    taps are ported (`models.layers.tap`), and a tap a model does not have
    raises where a CAM asks for it."""
    from wam_tpu_torch.evalsuite.baselines import gradcam

    capture = tvit.vit_tiny_test(capture_attn=True)
    assert capture.TAPS == ("tokens",) and capture.attention_taps == (
        "block0/attn/attention_weights", "block1/attn/attention_weights")
    assert tvit.vit_tiny_test().attention_taps == ()
    for model in (tvit.vit_tiny_test(image_size=SIDE), tconvnext.convnext_test()):
        assert set(model.TAPS) <= {"tokens", "stage1", "stage2", "stage3", "stage4"}
        with pytest.raises(ValueError, match="no activation tap 'stage9'"):
            gradcam(model.eval(), torch.zeros(1, 3, SIDE, SIDE), [0], layer="stage9")


def test_fresh_weights_follow_the_reference_initialisers():
    """lecun_normal kernels (std 1/sqrt(fan_in), truncated at 2 std), zero
    biases and class token, normal(0.02) position embeddings, LayerNorm ones
    and zeros, layer scales 1e-6."""
    torch.manual_seed(0)
    vit_ = tvit.ViT(num_classes=10, patch=8, dim=256, depth=1, heads=4, mlp_hidden=512,
                    image_size=64)
    fc1 = vit_.blocks[0].mlp.fc1.weight
    assert abs(float(fc1.detach().std()) * 16 - 1) < 0.03
    assert float(fc1.detach().abs().max()) <= 2 / 0.87962566103423978 / 16 + 1e-6
    patch_std = float(vit_.patch_embed["proj"].weight.detach().std()) * np.sqrt(3 * 64)
    assert abs(patch_std - 1) < 0.05
    assert abs(float(vit_.pos_embed.detach().std()) - 0.02) < 0.002
    assert not vit_.cls_token.any() and not vit_.blocks[0].attn.qkv.bias.any()
    assert bool((vit_.norm.weight == 1).all()) and not vit_.norm.bias.any()
    assert vit_.norm.eps == 1e-6
    cnx = tconvnext.convnext_test()
    assert bool((cnx.features[1][0].layer_scale == 1e-6).all())


# -- WAM-2D on the two models ----------------------------------------------------------


@pytest.fixture(scope="module", params=["vit", "convnext"])
def model_pair(request, vit, convnext):
    model, variables, tmodel = vit if request.param == "vit" else convnext
    jfn = jbind(model, variables, nchw=True)
    tfn = tres.bind_inference(tmodel, device="cpu")
    x = _x((1, 3, SIDE, SIDE), "wam-x", request.param)
    y = np.array([3])
    return request.param, jfn, tfn, x, y


@pytest.fixture(scope="module")
def jax_ig(model_pair):
    """JAX IG (haar, J=3, 4 path points) two ways: its pieces evaluated op by
    op (baseline mosaic of the input coefficients times the trapezoid over
    alpha of the gradient mosaics, dx=1), and the class's jitted scan."""
    _, jfn, _, x, y = model_pair
    je = jengine.WamEngine(jfn, ndim=2, wavelet="haar", level=3)
    coeffs = je.decompose(jnp.asarray(x))
    alphas = np.linspace(0.0, 1.0, 4, dtype=np.float32)
    path = [jpack.mosaic2d(je.grads_from_coeffs(
        jax.tree_util.tree_map(lambda c, a=a: c * a, coeffs), jnp.asarray(y), (SIDE, SIDE)))
        for a in alphas]
    trap = path[0] / 2 + sum(path[1:-1]) + path[-1] / 2
    eager = np.asarray(jpack.mosaic2d(coeffs) * trap)
    jm = jwam.WaveletAttribution2D(jfn, wavelet="haar", J=3, method="integratedgrad",
                                   n_samples=4, sample_batch_size=None)
    return eager, np.asarray(jm(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("impl", ["kernel", "conv"])
def test_integrated_wam_matches_jax(model_pair, jax_ig, impl):
    """The workload's call at a small size (4 path points in chunks of 2)
    against both JAX forms at 1e-4 of the largest value."""
    name, _, tfn, x, y = model_pair
    eager, cls = jax_ig
    tm = twam.WaveletAttribution2D(tfn, wavelet="haar", J=3, mode="reflect",
                                   method="integratedgrad", n_samples=4, sample_batch_size=2,
                                   device="cpu", impl=impl)
    got = _np(tm(torch.from_numpy(x), torch.from_numpy(y)))
    assert got.shape == (1, SIDE, SIDE) and np.abs(got).max() > 0
    scale = np.abs(eager).max()
    np.testing.assert_allclose(got, eager, atol=TOL * scale, rtol=0)
    np.testing.assert_allclose(got, cls, atol=TOL * scale, rtol=0)
    np.testing.assert_allclose(cls, eager, atol=TOL * scale, rtol=0)
    want_scales = np.asarray(jpack.reproject_mosaic(jnp.asarray(eager), 3))
    np.testing.assert_allclose(_np(tm.scales), want_scales, atol=3 * TOL * scale, rtol=0)


@pytest.mark.parametrize("impl", ["kernel", "conv"])
def test_smooth_wam_matches_jax_with_handed_noise(model_pair, impl):
    _, jfn, tfn, x, y = model_pair
    z = _rng("noise", model_pair[0]).standard_normal((3,) + x.shape).astype(np.float32)
    sigma = np.asarray(jest.noise_sigma(jnp.asarray(x), 0.25)).reshape(-1, 1, 1, 1)
    jm = jwam.BaseWAM2D(jfn, wavelet="haar", J=3)
    want = np.mean([np.asarray(jm(jnp.asarray(x + zi * sigma), jnp.asarray(y))) for zi in z],
                   axis=0)
    tm = twam.WaveletAttribution2D(tfn, wavelet="haar", J=3, method="smooth", n_samples=3,
                                   stdev_spread=0.25, sample_batch_size=2, device="cpu",
                                   impl=impl)
    got = _np(tm(torch.from_numpy(x), torch.from_numpy(y), noise=torch.from_numpy(z)))
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(), rtol=0)


# -- what the card will be given at 224^2 ----------------------------------------------


def _haar():
    w = tfilters.build_wavelet("haar")
    return tuple(w.dec_lo), tuple(w.dec_hi), tuple(w.rec_lo), tuple(w.rec_hi)


def test_haar_224_k1_band_plans_fit_the_card():
    """K1's plans at the workload's three analysis levels (224 -> 112 ->
    56 -> 28): two taps a row pair held in registers, two stages, the
    column taps in shared memory, inside the band target (two blocks an
    SM)."""
    dec_lo, dec_hi, _, _ = _haar()
    cpu = torch.device("cpu")
    for side, tiles in ((224, 7), (112, 4), (56, 2)):
        plan = tmm.dwt2_band(side, side, dec_lo, dec_hi, "reflect", cpu)
        assert (plan.q, plan.s, plan.p, plan.t) == (side,) * 4
        assert (plan.kc, plan.k, plan.rt, plan.stages, plan.cols_shared) == (2, 2, 16, 2, 1)
        assert plan.ntiles == tiles and plan.tp == side // 2
        assert plan.smem_bytes() <= tmm.SMEM_TARGET <= kernels.MAX_SMEM
        assert plan.blob.dtype == torch.int32 and plan.blob.ndim == 1
    assert tmm.dwt2_band(224, 224, dec_lo, dec_hi, "reflect", cpu).smem_bytes() == 90624


def test_haar_224_k3_plans_fit_the_card():
    """K3 collapses all three levels (detail sides 28 / 56 / 112, all under
    the crossover) into one forward and one backward plan of 256 threads a
    block, each inside a block's shared memory."""
    _, _, rec_lo, rec_hi = _haar()
    x = torch.zeros(1, 3, 224, 224)
    coeffs = tt.wavedec2(x, "haar", 3, "reflect", impl="kernel")
    sides = tuple(int(d.horizontal.shape[-1]) for d in coeffs[1:])
    assert sides == (28, 56, 112) and tt._collapse_count(coeffs[1:]) == 3
    fwd, bwd = tmm.pair_band(sides, sides, rec_lo, rec_hi, torch.device("cpu"))
    for plan in (fwd, bwd):
        assert (plan.p, plan.t, len(plan.levels), plan.threads) == (224, 224, 3, 256)
        assert plan.rows == plan.cols == sides
        assert plan.smem_bytes() <= tmm.SMEM_TARGET
    assert [lv.rt for lv in fwd.levels] == [16, 16, 16]
    assert [lv.k for lv in bwd.levels] == [8, 4, 2]
    assert [lv.fold_log2 for lv in bwd.levels] == [3, 2, 1]


def test_ig_path_launches_k1_three_times_and_k3_eight(monkeypatch):
    """On CUDA tensors the workload's call (one 224^2 image, haar J=3, 64
    path points in chunks of 16) decomposes once through K1 (3 levels) and
    runs K3 forward and backward once a chunk (8), nothing else; followed
    here with stand-ins of the launchers that run the plain versions."""
    dec_lo, dec_hi, rec_lo, rec_hi = _haar()
    cpu = torch.device("cpu")
    calls = []

    def dwt2(x3, plan):
        calls.append("dwt2")
        _, At = tmm._kernel_analysis(plan.q, dec_lo, dec_hi, "reflect", cpu)
        _, Bt = tmm._kernel_analysis(plan.s, dec_lo, dec_hi, "reflect", cpu)
        return tmm.dwt2_plain(x3, At, Bt)

    def blocks(plan):
        return (tmm._level_blocks(plan.rows, rec_lo, rec_hi),
                tmm._level_blocks(plan.cols, rec_lo, rec_hi))

    def pair(leaves, plan):
        calls.append("pair")
        out = 0
        for i, (R, C) in enumerate(zip(*blocks(plan))):
            h, v, d = leaves[1 + 3 * i:4 + 3 * i]
            aa = leaves[0] if i == 0 else torch.zeros_like(h)
            y = torch.cat([torch.cat([aa, v], -1), torch.cat([h, d], -1)], -2)
            out = out + torch.from_numpy(R).float() @ y @ torch.from_numpy(C).float().T
        return out

    def pair_bwd(g, plan):
        calls.append("pair_bwd")
        grads = []
        for i, (R, C, r, c) in enumerate(zip(*blocks(plan), plan.rows, plan.cols)):
            dy = torch.from_numpy(R).float().T @ g @ torch.from_numpy(C).float()
            grads += ([dy[:, :r, :c]] if i == 0 else []) + [
                dy[:, r:, :c], dy[:, :r, c:], dy[:, r:, c:]]
        return [t.contiguous() for t in grads]

    for name, fn in (("dwt2", dwt2), ("pair", pair), ("pair_bwd", pair_bwd)):
        monkeypatch.setattr(kernels, name, fn)
    for name in ("synth2", "relu_fwd", "relu_bwd", "build_all"):
        monkeypatch.setattr(kernels, name, lambda *a: pytest.fail("not on the IG path"))
    monkeypatch.setattr(tmm, "on_cpu", lambda t: False)
    weights = torch.from_numpy(_x((4, 3 * 224 * 224), "toy-w") / 400)

    def model_fn(v):  # a cheap classifier of (B, 3, 224, 224), every pixel weighed
        return torch.tanh(v.reshape(v.shape[0], -1) @ weights.T)

    x = torch.from_numpy(_x((1, 3, 224, 224), "toy-x"))
    tm = twam.WaveletAttribution2D(model_fn, wavelet="haar", J=3, mode="reflect",
                                   method="integratedgrad", n_samples=64, sample_batch_size=16,
                                   device="cpu", impl="kernel")
    out = tm(x, torch.tensor([2]))
    assert out.shape == (1, 224, 224) and bool(torch.isfinite(out).all())
    assert calls.count("dwt2") == 3 and calls.count("pair") == calls.count("pair_bwd") == 4
    assert calls[:3] == ["dwt2"] * 3 and len(calls) == 11
    monkeypatch.undo()
    plain = twam.WaveletAttribution2D(model_fn, wavelet="haar", J=3, mode="reflect",
                                      method="integratedgrad", n_samples=64,
                                      sample_batch_size=16, device="cpu", impl="matmul")
    want = plain(x, torch.tensor([2]))
    torch.testing.assert_close(out, want, atol=1e-5 * float(want.abs().max()), rtol=0)
