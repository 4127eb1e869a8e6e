"""Parity of the PyTorch port's baseline methods (`evalsuite.baselines`,
`evalsuite.lrp`) and the models' taps, ``post_linear`` and ``stem_s2d``
with the JAX package.

Weights are drawn with numpy into `jax.eval_shape(model.init)`'s tree
(kernels N(0, 1/fan_in), every BatchNorm non-identity) and carried to the
port by `models.ingest`; inputs come from numpy seeds. The ResNets run at
32 x 48, so every stage's grid is non-square (a transposed CAM grid fails).

Tolerances, over the largest value of the reference's map: 1e-4 in float32
for the gradient maps, the CAMs and the EpsilonPlusFlat walker (measured
1e-7 to 2e-5). Two rules are ill-conditioned where a denominator nearly
cancels, and are held in float32 at a measured bound and in float64 (the
same float32-drawn values widened on both sides) at 1e-9: GradCAM++
(2 g^2 + sum A g^3; measured up to 3.0e-3 in float32, 2e-12 in float64)
and the all-ε walker (z + 1e-6 sign z on near-zero sums; measured up to
2.5e-4 in float32, 2e-13 in float64). AudioCNN maps where a ReLU gate
lies within rounding of zero (IG's midpoint, SmoothGrad's noisy copies) are
held the same way: float32 at 2e-2 (measured up to 5.7e-3), float64 at
1e-9. Taps to 1e-6 of their largest
value in float64 (1e-9) and at 1e-5 in float32 (measured up to 1.04e-6),
the bilinear resize to 1e-6, the stem forms to 1e-5.
"""

import contextlib
import importlib
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wam_tpu.evalsuite import baselines as JB
from wam_tpu.evalsuite.lrp import lrp_resnet as jlrp_resnet
from wam_tpu.models import bind_inference as jbind
from wam_tpu.models import convnext as jconvnext
from wam_tpu.models import resnet as jres
from wam_tpu.models import vit as jvit
from wam_tpu.models.audio import AudioCNN as JAudioCNN
from wam_tpu.models.audio import bind_audio_inference as jbind_audio
from wam_tpu.models.resnet3d import resnet3d_10 as jresnet3d_10
from wam_tpu_torch.evalsuite import baselines as TB
from wam_tpu_torch.evalsuite.lrp import lrp_resnet as tlrp_resnet
from wam_tpu_torch.models import audio as taudio
from wam_tpu_torch.models import convnext as tconvnext
from wam_tpu_torch.models import resnet as tres
from wam_tpu_torch.models import resnet3d as tr3
from wam_tpu_torch.models import vit as tvit
from wam_tpu_torch.models.ingest import (
    flax_audio_to_torch,
    flax_convnext_to_torch,
    flax_resnet3d_to_torch,
    flax_resnet_to_torch,
    flax_vit_to_torch,
)
from wam_tpu_torch.models.layers import tap, tap_scope

TOL = 1e-4
TAP_TOL = 1e-6
TAP_F32 = 1e-5
F64_TOL = 1e-9
# measured float32 bounds of the ill-conditioned rules (module docstring)
GRADCAMPP_F32 = 1e-2
LRP_EPS_F32 = 1e-3
AUDIO_GATE_F32 = 2e-2
H, W = 32, 48
AUDIO_IN = (2, 1, 257, 128)  # out3 is a 3 x 1 grid
jfr = importlib.import_module("wam_tpu.tune.fused_relu")


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _np(t):
    return t.detach().numpy()


@pytest.fixture(scope="module", autouse=True)
def jax_knobs():
    """XLA's ReLU on the JAX side (its fused-ReLU route is a process global
    that other files may leave changed), put back after."""
    saved = jfr.get_fused_relu_impl()
    jfr.set_fused_relu_impl("auto")
    yield
    jfr.set_fused_relu_impl(saved)


@contextlib.contextmanager
def _x64():
    saved = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", saved)


def _variables(model, shape, seed):
    """float32 variables drawn with numpy in ``model.init``'s tree, the
    perturbation taps zero."""
    rng = _rng("vars", type(model).__name__, seed)
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros(shape))

    def draw(path, leaf):
        name, n = path[-1].key, leaf.shape
        if path[0].key == "perturbations":
            return np.zeros(n, np.float32)
        if name == "kernel":
            v = rng.standard_normal(n) / np.sqrt(np.prod(n[:-1]))
        elif name in ("bias", "mean", "cls_token", "pos_embed"):
            v = 0.05 * rng.standard_normal(n)
        elif name == "scale":
            v = rng.uniform(0.8, 1.2, n)
        elif name == "gamma":
            v = rng.uniform(0.5, 1.5, n)
        else:  # var
            v = rng.uniform(0.5, 1.5, n)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _port(tmodel, state):
    tmodel.load_state_dict(state)
    return tmodel.eval().requires_grad_(False)


def _resnet(jctor, tctor, classes=10):
    model = jctor(num_classes=classes)
    variables = _variables(model, (1, H, W, 3), jctor.keywords["stage_sizes"])
    return model, variables, _port(tctor(num_classes=classes), flax_resnet_to_torch(variables))


@pytest.fixture(scope="module")
def r18():
    return _resnet(jres.resnet18, tres.resnet18)


@pytest.fixture(scope="module")
def r50():
    return _resnet(jres.resnet50, tres.resnet50)


@pytest.fixture(scope="module")
def nets(r18, r50):
    return {"r18": r18, "r50": r50}


@pytest.fixture(scope="module")
def audio():
    model = JAudioCNN(num_classes=10)
    variables = _variables(model, (1,) + AUDIO_IN[1:], "audio")
    tmodel = _port(taudio.AudioCNN(num_classes=10), flax_audio_to_torch(variables))
    x = (_rng("audio-x").standard_normal(AUDIO_IN) * 10.0).astype(np.float32)
    return model, variables, tmodel, x


def _vit_or_convnext(name):
    if name == "vit":
        model, tmodel, to_torch = (jvit.vit_tiny_test(num_classes=10),
                                   tvit.vit_tiny_test(num_classes=10, image_size=32),
                                   flax_vit_to_torch)
    else:
        model, tmodel, to_torch = (jconvnext.convnext_test(num_classes=10),
                                   tconvnext.convnext_test(num_classes=10), flax_convnext_to_torch)
    variables = _variables(model, (1, 32, 32, 3), name)
    return model, variables, _port(tmodel, to_torch(variables))


@pytest.fixture(scope="module")
def transformers():
    return {name: _vit_or_convnext(name) for name in ("vit", "convnext")}


def _x(shape, *key):
    return _rng("x", *key).standard_normal(shape).astype(np.float32)


def _close(got, want, tol, tag=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    assert np.isfinite(got).all(), tag
    peak = np.abs(want).max()
    if peak == 0:  # an all-zero reference map: the port's must be all zero too
        np.testing.assert_array_equal(got, want, err_msg=tag)
        return
    err = np.abs(got - want).max() / peak
    assert err <= tol, f"{tag}: {err:.3e} of the max > {tol:.1e}"


def _ref(fn, *args):
    """The JAX reference ``fn(*args)`` jitted over its arguments (variables
    and arrays; modules are closed over): one compile costs far less on the
    CPU than op-by-op dispatch."""
    return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*args))


def _inputs(shape, key, y):
    x = _x(shape, key)
    return x, torch.from_numpy(x), jnp.asarray(x), torch.tensor(y), jnp.asarray(y)


# -- the taps ------------------------------------------------------------------------------


def _jax_sown(model, variables, inp):
    base = {k: v for k, v in variables.items() if k != "perturbations"}
    state = _ref(lambda b, i: model.apply(b, i, mutable=["intermediates"])[1], base, inp)
    return {k: np.asarray(v[0]) for k, v in state["intermediates"].items()}


def _tap_case(name):
    if name == "resnet18":
        model = jres.resnet18(num_classes=10)
        v = _variables(model, (1, H, W, 3), "taps")
        x = _x((2, 3, H, W), "taps")
        return (model, v, jnp.asarray(x.transpose(0, 2, 3, 1)),
                _port(tres.resnet18(num_classes=10), flax_resnet_to_torch(v)), x, "nchw")
    if name == "audio":
        model = JAudioCNN(num_classes=10)
        v = _variables(model, (1,) + AUDIO_IN[1:], "taps")
        x = _x(AUDIO_IN, "taps") * 10
        return (model, v, jnp.asarray(x), _port(taudio.AudioCNN(num_classes=10),
                                                flax_audio_to_torch(v)), x, "nchw")
    if name == "resnet3d":
        model = jresnet3d_10(num_classes=10, width=4)
        v = _variables(model, (1, 1, 8, 8, 8), "taps")
        x = _x((2, 1, 8, 8, 8), "taps")
        return (model, v, jnp.asarray(x),
                _port(tr3.resnet3d_10(num_classes=10, width=4), flax_resnet3d_to_torch(v)), x,
                "ncdhw")
    model, v, tmodel = _vit_or_convnext(name)
    x = _x((2, 3, 32, 32), "taps")
    return model, v, jnp.asarray(x.transpose(0, 2, 3, 1)), tmodel, x, "nhwc"


@pytest.mark.parametrize("name", ["resnet18", "audio", "vit", "convnext", "resnet3d"])
def test_taps_match_the_sown_intermediates(name):
    """Every tap of every model: the reference's names, letter for letter,
    and its sown values (NHWC / NDHWC there; ConvNeXt's channels-last here
    too, recorded as such), in float64 within 1e-9 and in float32 within
    TAP_F32 (measured up to 1.04e-6, the AudioCNN's out0 after 8 convs)."""
    jmodel, v, jinp, tmodel, x, layout = _tap_case(name)
    for dtype, tol in (("float32", TAP_F32), ("float64", F64_TOL)):
        if dtype == "float64":
            with _x64():
                want = _jax_sown(jmodel, _f64(v), jnp.asarray(jinp, jnp.float64))
            tmodel.double()
        else:
            want = _jax_sown(jmodel, v, jinp)
        assert tuple(sorted(want)) == tuple(sorted(type(tmodel).TAPS[:len(want)]))
        with tap_scope(want) as taps:
            tmodel(torch.from_numpy(x).to(getattr(torch, dtype)))
        tmodel.float()
        assert sorted(taps.records) == sorted(want)
        for tap_name, ref in want.items():
            rec = taps.records[tap_name]
            got = _np(rec.tensor)
            if layout == "nchw" and got.ndim == 4:
                got = got.transpose(0, 2, 3, 1)
            elif layout == "ncdhw":
                got = got.transpose(0, 2, 3, 4, 1)
            assert rec.channels_last == (name == "convnext")
            _close(got, ref, tol, f"{name} {tap_name} {dtype}")


def test_tap_outside_a_scope_is_the_identity():
    """No scope: ``tap`` returns its argument itself, and a forward makes no
    tensor that requires grad."""
    t = torch.randn(2, 3)
    assert tap("stage1", t) is t
    model = tres.resnet18(num_classes=3).eval().requires_grad_(False)
    with tap_scope(["stage2"]) as taps:
        with tap_scope(["out0"]):
            model(torch.randn(1, 3, 32, 32))
    assert list(taps.records) == ["stage2"] and taps["stage2"].requires_grad
    assert not model(torch.randn(1, 3, 32, 32)).requires_grad


# -- the bilinear resize -----------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [((7, 7), (224, 224)), ((14, 14), (224, 224)),
                                     ((4, 4), (32, 32)), ((4, 6), (32, 48)),
                                     ((3, 1), (257, 128)), ((5, 1), (431, 128))])
def test_cam_resize_matches_jax(src, dst):
    """The CAMs' resize at the slice's sizes: ResNet-50's stage4 and stage3
    at 224², the tests' grids, the AudioCNN's out3 at 257 and 431 frames."""
    a = np.abs(_x((2,) + src, "resize", src))
    want = np.asarray(jax.image.resize(jnp.asarray(a), (2,) + dst, method="bilinear"))
    _close(_np(TB.resize_bilinear(torch.from_numpy(a), dst)), want, TAP_TOL, f"{src}->{dst}")


# -- the modified backward rules ---------------------------------------------------------


def test_guided_relu_backward_is_the_reference_rule():
    x = np.array([-2.0, -0.5, 0.0, 0.0, 0.5, 1.5, 3.0, -1.0], np.float32)
    g = np.array([1.0, -1.0, 2.0, -2.0, -0.5, 0.25, 0.0, 4.0], np.float32)
    out, vjp = jax.vjp(JB.guided_relu, jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    got = TB.guided_relu(t)
    (gt,) = torch.autograd.grad(got, t, torch.from_numpy(g))
    np.testing.assert_array_equal(_np(got), np.asarray(out))
    np.testing.assert_array_equal(_np(gt), np.asarray(vjp(jnp.asarray(g))[0]))


@pytest.mark.parametrize("eps", [1e-6, 0.25])
def test_eps_tap_backward_is_the_reference_rule(eps):
    """Identity forward; g z / (z + eps sign z), a zero denominator (z = 0)
    counting as 1."""
    z = np.array([-2.0, -eps, 0.0, 1e-7, 0.5, 3.0], np.float32)
    g = np.array([1.0, 2.0, 3.0, -1.0, 0.5, -4.0], np.float32)
    out, vjp = jax.vjp(JB.make_eps_tap(eps), jnp.asarray(z))
    t = torch.from_numpy(z).requires_grad_()
    got = TB.make_eps_tap(eps)(t)
    (gt,) = torch.autograd.grad(got, t, torch.from_numpy(g))
    np.testing.assert_array_equal(_np(got), z)
    np.testing.assert_allclose(_np(gt), np.asarray(vjp(jnp.asarray(g))[0]), rtol=1e-6)


# -- ResNet's stem_s2d, post_linear, resnet34 / resnet101 ----------------------------------


@pytest.mark.parametrize("shape", [(2, 3, 32, 32), (1, 3, 32, 48), (2, 3, 30, 26)])
def test_stem_s2d_matches_the_plain_stem(shape):
    """The space-to-depth stem is the 7x7/2 conv, same weight (1e-5), and
    the reference's s2d stem on the same kernel agrees; an odd side falls
    back to the plain form."""
    torch.manual_seed(0)
    plain = tres.resnet18(num_classes=4).eval().requires_grad_(False)
    s2d = tres.resnet18(num_classes=4, stem_s2d=True).eval().requires_grad_(False)
    s2d.load_state_dict(plain.state_dict())
    x = torch.from_numpy(_x(shape, "stem", shape))
    _close(_np(s2d.stem(x)), _np(plain.conv1(x)), 1e-5, "stem")
    _close(_np(s2d(x)), _np(plain(x)), 1e-5, "logits")
    kernel = jnp.asarray(_np(plain.conv1.weight).transpose(2, 3, 1, 0))
    want = jres._StemConv(s2d=True).apply({"params": {"kernel": kernel}},
                                          jnp.asarray(_np(x).transpose(0, 2, 3, 1)))
    _close(_np(s2d.stem(x)).transpose(0, 2, 3, 1), want, 1e-5, "reference s2d")
    odd = torch.from_numpy(_x((1, 3, 31, 32), "stem-odd"))
    torch.testing.assert_close(s2d.stem(odd), plain.conv1(odd))


def test_stem_s2d_input_gradient_matches():
    torch.manual_seed(1)
    plain = tres.resnet18(num_classes=4).eval().requires_grad_(False)
    s2d = tres.resnet18(num_classes=4, stem_s2d=True).eval().requires_grad_(False)
    s2d.load_state_dict(plain.state_dict())
    x = torch.from_numpy(_x((2, 3, 32, 32), "stem-grad"))
    y = torch.tensor([1, 3])
    _close(_np(TB.saliency(s2d, x, y)), _np(TB.saliency(plain, x, y)), 1e-5, "saliency")


def test_post_linear_sits_where_the_reference_applies_it(r18):
    """A counting ``post_linear`` sees every BatchNorm output and fc (2 a
    block, 3 for the projected ones, the stem's and fc's); doubling it
    matches the reference clone with the same hook."""
    jmodel, v, tmodel = r18
    seen = []
    with TB.swapped(tmodel, "post_linear", lambda z: seen.append(tuple(z.shape)) or z):
        tmodel(torch.zeros(1, 3, H, W))
    assert len(seen) == 1 + 8 * 2 + 3 + 1 and seen[-1] == (1, 10)
    x = _x((2, 3, H, W), "post-linear")
    with TB.swapped(tmodel, "post_linear", lambda z: 2 * z):
        got = tmodel(torch.from_numpy(x))
    want = jmodel.clone(post_linear=lambda z: 2 * z).apply(
        {k: v[k] for k in ("params", "batch_stats")}, jnp.asarray(x.transpose(0, 2, 3, 1)))
    _close(_np(got), want, TOL, "post_linear")
    assert tmodel.post_linear is tres._identity


@pytest.mark.parametrize("arch", ["resnet34", "resnet101"])
def test_resnet34_resnet101_scores_match_jax(arch):
    model = getattr(jres, arch)(num_classes=10)
    v = _variables(model, (1, 32, 32, 3), arch)
    tmodel = _port(getattr(tres, arch)(num_classes=10), flax_resnet_to_torch(v))
    x = _x((2, 3, 32, 32), arch)
    want = _ref(lambda vv, xx: jbind(model, vv, nchw=True)(xx), v, jnp.asarray(x))
    _close(_np(tmodel(torch.from_numpy(x))), want, TOL, arch)


# -- the methods on ResNets ----------------------------------------------------------------

GRAD_METHODS = ("saliency", "integrated_gradients", "gradient_x_input", "smoothgrad_pixel")


@pytest.mark.parametrize("method", GRAD_METHODS)
def test_gradient_methods_match_jax(r18, method):
    """On the handed-over unit draws of JAX's own key for SmoothGrad; IG's
    5 path points in groups of 2 (the reference maps them one at a time)."""
    net = "r18"
    jmodel, v, tmodel = r18
    x, xt, xj, yt, yj = _inputs((2, 3, H, W), (net, method), [3, 7])

    def tfn(a):
        return TB.module_forward(tmodel, a)

    if method == "smoothgrad_pixel":
        key = jax.random.PRNGKey(4)
        noise = np.asarray(jax.random.normal(key, (3,) + x.shape, jnp.float32))
        want = _ref(lambda vv, xx, yy: JB.smoothgrad_pixel(jbind(jmodel, vv), xx, yy, key,
                                                           n_samples=3), v, xj, yj)
        got = TB.smoothgrad_pixel(tfn, xt, yt, n_samples=3, noise=torch.from_numpy(noise),
                                  sample_batch_size=2)
    elif method == "integrated_gradients":
        want = _ref(lambda vv, xx, yy: JB.integrated_gradients(jbind(jmodel, vv), xx, yy,
                                                               n_steps=5), v, xj, yj)
        got = TB.integrated_gradients(tfn, xt, yt, n_steps=5, sample_batch_size=2)
    else:
        want = _ref(lambda vv, xx, yy: getattr(JB, method)(jbind(jmodel, vv), xx, yy), v, xj, yj)
        got = getattr(TB, method)(tfn, xt, yt)
    _close(_np(got), want, TOL, method)


def test_smoothgrad_draws_come_from_the_generator(r18):
    """Without handed noise the draws are the seeded generator's: the same
    seed gives the same map, its handed-over draws too."""
    _, _, tmodel = r18
    x, xt, _, yt, _ = _inputs((2, 3, H, W), "sg-gen", [1, 2])

    def tfn(a):
        return TB.module_forward(tmodel, a)

    a = TB.smoothgrad_pixel(tfn, xt, yt, 5, n_samples=2)
    b = TB.smoothgrad_pixel(tfn, xt, yt, torch.Generator().manual_seed(5), n_samples=2)
    z = torch.randn((2,) + x.shape, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, b)
    torch.testing.assert_close(a, TB.smoothgrad_pixel(tfn, xt, yt, n_samples=2, noise=z))


@pytest.mark.parametrize("net,method,layer", [
    ("r18", "gradcam", "stage2"), ("r18", "gradcam", "stage3"), ("r18", "gradcam", "stage4"),
    ("r18", "layercam", "stage2"), ("r18", "layercam", "stage3"), ("r50", "gradcam", "stage3"),
    ("r50", "layercam", "stage4")])
def test_cams_match_jax_on_resnets(nets, net, method, layer):
    jmodel, v, tmodel = nets[net]
    _, xt, xj, yt, yj = _inputs((2, 3, H, W), (net, method, layer), [3, 7])
    want = _ref(lambda vv, xx, yy: getattr(JB, method)(jmodel, vv, xx, yy, layer=layer), v, xj,
                yj)
    _close(_np(getattr(TB, method)(tmodel, xt, yt, layer=layer)), want, TOL, method)


@pytest.mark.parametrize("net,layer", [("r18", "stage2"), ("r18", "stage3")])
def test_gradcam_pp_matches_jax_f32_and_f64(nets, net, layer):
    jmodel, v, tmodel = nets[net]
    x, xt, xj, yt, yj = _inputs((2, 3, H, W), (net, "gcpp", layer), [3, 7])
    want = _ref(lambda vv, xx, yy: JB.gradcam_pp(jmodel, vv, xx, yy, layer=layer), v, xj, yj)
    _close(_np(TB.gradcam_pp(tmodel, xt, yt, layer=layer)), want, GRADCAMPP_F32, "float32")
    with _x64():
        want = _ref(lambda vv, xx, yy: JB.gradcam_pp(jmodel, vv, xx, yy, layer=layer), _f64(v),
                    jnp.asarray(x, jnp.float64), yj)
    got = TB.gradcam_pp(tmodel.double(), xt.double(), yt, layer=layer)
    tmodel.float()
    _close(_np(got), want, F64_TOL, "float64")


@pytest.mark.parametrize("net", ["r18"])
def test_guided_backprop_matches_jax_and_restores_act(nets, net):
    jmodel, v, tmodel = nets[net]
    _, xt, xj, yt, yj = _inputs((2, 3, H, W), (net, "gbp"), [0, 9])
    want = _ref(lambda vv, xx, yy: JB.guided_backprop(jmodel, vv, xx, yy), v, xj, yj)
    _close(_np(TB.guided_backprop(tmodel, xt, yt)), want, TOL, "guided_backprop")
    assert all(m.act is torch.relu for m in tmodel.modules() if hasattr(m, "act"))


def test_guided_backprop_restores_act_when_it_raises(r18):
    _, _, tmodel = r18
    with pytest.raises(RuntimeError):
        TB.guided_backprop(tmodel, torch.zeros(1, 5, H, W), torch.tensor([0]))
    assert all(m.act is torch.relu for m in tmodel.modules() if hasattr(m, "act"))


@pytest.mark.parametrize("net,eps", [("r18", 1e-6), ("r18", 1e-2), ("r50", 1e-2)])
def test_lrp_eps_matches_jax(nets, net, eps):
    """The ε rule through ``post_linear`` (every BatchNorm output of both
    block kinds, and fc): at ε = 1e-2 within 1e-4 in float32; at ε = 1e-6
    (the stabilizer on near-zero sums, as the all-ε walker) at its measured
    float32 bound and in float64 within 1e-9."""
    jmodel, v, tmodel = nets[net]
    x, xt, xj, yt, yj = _inputs((2, 3, H, W), (net, "lrp_eps", eps), [2, 5])
    want = _ref(lambda vv, xx, yy: JB.lrp_eps(jmodel, vv, xx, yy, eps=eps), v, xj, yj)
    tol = TOL if eps > 1e-3 else LRP_EPS_F32
    _close(_np(TB.lrp_eps(tmodel, xt, yt, eps=eps)), want, tol, "float32")
    assert tmodel.post_linear is tres._identity
    if eps > 1e-3:
        return
    with _x64():
        want = _ref(lambda vv, xx, yy: JB.lrp_eps(jmodel, vv, xx, yy, eps=eps), _f64(v),
                    jnp.asarray(x, jnp.float64), yj)
    got = TB.lrp_eps(tmodel.double(), xt.double(), yt, eps=eps)
    tmodel.float()
    _close(_np(got), want, F64_TOL, "float64")


@pytest.mark.parametrize("net", ["r18", "r50"])
@pytest.mark.parametrize("composite", ["epsilon_plus_flat", "epsilon"])
def test_lrp_resnet_matches_jax(nets, net, composite):
    """The walker on BasicBlock (ResNet-18) and Bottleneck (ResNet-50)
    blocks: float32 within 1e-4 (EpsilonPlusFlat) or the measured ε bound,
    and the all-ε walker in float64 within 1e-9; the caller's module is not
    folded."""
    jmodel, v, tmodel = nets[net]
    x, xt, xj, yt, yj = _inputs((2, 3, H, W), (net, "lrp", composite), [3, 8])
    before = {k: t.clone() for k, t in tmodel.state_dict().items()}
    want = jlrp_resnet(jmodel, v, xj, yj, composite=composite)
    tol = TOL if composite == "epsilon_plus_flat" else LRP_EPS_F32
    _close(_np(tlrp_resnet(tmodel, xt, yt, composite=composite)), want, tol, "float32")
    for k, t in tmodel.state_dict().items():
        torch.testing.assert_close(t, before[k], rtol=0, atol=0)
    if composite == "epsilon_plus_flat":
        return
    with _x64():
        want = jlrp_resnet(jmodel, _f64(v), jnp.asarray(x, jnp.float64), yj, composite=composite)
    got = tlrp_resnet(tmodel.double(), xt.double(), yt, composite=composite)
    tmodel.float()
    _close(_np(got), want, F64_TOL, "float64")


def test_lrp_dispatches_on_the_model(r18, audio):
    jmodel, v, tmodel = r18
    _, xt, xj, yt, yj = _inputs((2, 3, H, W), "lrp-dispatch", [1, 4])
    _close(_np(TB.lrp(tmodel, xt, yt)), jlrp_resnet(jmodel, v, xj, yj), TOL, "lrp")
    with pytest.raises(ValueError, match="post_linear"):
        TB.lrp(audio[2], torch.from_numpy(audio[3]), torch.tensor([0, 1]))
    with pytest.raises(ValueError, match="ResNet structure"):
        tlrp_resnet(audio[2], torch.from_numpy(audio[3]), torch.tensor([0, 1]))


# -- CAMs on the token, channels-last and audio taps -----------------------------------------


@pytest.mark.parametrize("name,layer", [("vit", "tokens"), ("convnext", "stage1"),
                                        ("convnext", "stage2")])
@pytest.mark.parametrize("method", ["gradcam", "gradcam_pp", "layercam"])
def test_cams_on_vit_tokens_and_convnext(transformers, name, layer, method):
    """ConvNeXt's channels-last stages, and the ViT's token tap: it sits
    after the last block, where only the class token reaches the head, so
    the patch tokens' gradients and every token CAM are exactly zero, in
    the reference as here (`test_token_cam_folds_the_grid` checks the fold
    on a tap whose patch tokens do reach the output)."""
    jmodel, v, tmodel = transformers[name]
    _, xt, xj, yt, yj = _inputs((2, 3, 32, 32), (name, layer, method), [4, 6])
    want = _ref(lambda vv, xx, yy: getattr(JB, method)(jmodel, vv, xx, yy, layer=layer), v, xj,
                yj)
    tol = GRADCAMPP_F32 if method == "gradcam_pp" else TOL
    _close(_np(getattr(TB, method)(tmodel, xt, yt, layer=layer)), want, tol, method)


@pytest.mark.parametrize("layer", ["out3", "out2"])
@pytest.mark.parametrize("method", ["gradcam", "gradcam_pp", "layercam"])
def test_cams_on_the_audio_cnn(audio, layer, method):
    """The AudioCNN takes (B, 1, T, M) as it comes (the reference's
    ``nchw=False``); out3 is a 3 x 1 grid resized to 257 x 128."""
    jmodel, v, tmodel, x = audio
    y = [2, 8]
    want = _ref(lambda vv, xx, yy: getattr(JB, method)(jmodel, vv, xx, yy, layer=layer,
                                                       nchw=False),
                v, jnp.asarray(x), jnp.asarray(y))
    got = getattr(TB, method)(tmodel, torch.from_numpy(x), torch.tensor(y), layer=layer)
    tol = GRADCAMPP_F32 if method == "gradcam_pp" else TOL
    _close(_np(got), want, tol, method)


def test_audio_gradient_methods_match_jax(audio):
    jmodel, v, tmodel, x = audio
    y = [2, 8]
    for method in ("saliency", "gradient_x_input"):
        want = _ref(lambda vv, xx, yy: getattr(JB, method)(jbind_audio(jmodel, vv), xx, yy), v,
                    jnp.asarray(x), jnp.asarray(y))
        got = getattr(TB, method)(lambda a: TB.module_forward(tmodel, a),
                                  torch.from_numpy(x), torch.tensor(y))
        _close(_np(got), want, TOL, method)


@pytest.mark.parametrize("method", ["integrated_gradients", "smoothgrad_pixel"])
def test_audio_gate_flips_vanish_in_float64(audio, method):
    """IG's midpoint and SmoothGrad's noisy copies put AudioCNN ReLU gates
    within rounding of zero, and a gate flips between the two float32
    computations (measured 2.4e-3 and 5.7e-3 of the max): float32 is held
    at AUDIO_GATE_F32, float64 (the same values widened) within 1e-9."""
    jmodel, v, tmodel, x = audio
    y = [2, 7]
    key = jax.random.PRNGKey(42)

    def ref(vv, xx, yy):
        fn = jbind_audio(jmodel, vv)
        if method == "integrated_gradients":
            return JB.integrated_gradients(fn, xx, yy, n_steps=3)
        return JB.smoothgrad_pixel(fn, xx, yy, key, n_samples=3, stdev_spread=0.001)

    def port(xx):
        def fn(a):
            return TB.module_forward(tmodel, a)

        if method == "integrated_gradients":
            return TB.integrated_gradients(fn, xx, torch.tensor(y), n_steps=3)
        # JAX's own draws at the input's dtype (x64 draws differ from float32's)
        noise = np.asarray(jax.random.normal(key, (3,) + x.shape, jnp.asarray(xx.numpy()).dtype))
        return TB.smoothgrad_pixel(fn, xx, torch.tensor(y), n_samples=3, stdev_spread=0.001,
                                   noise=torch.from_numpy(noise.copy()))

    _close(_np(port(torch.from_numpy(x))), _ref(ref, v, jnp.asarray(x), jnp.asarray(y)),
           AUDIO_GATE_F32, "float32")
    with _x64():
        want = _ref(ref, _f64(v), jnp.asarray(x, jnp.float64), jnp.asarray(y))
        tmodel.double()
        got = port(torch.from_numpy(x).double())
    tmodel.float()
    _close(_np(got), want, F64_TOL, "float64")


class _Tokens(torch.nn.Module):
    TAPS = ("tokens",)

    def forward(self, x):
        t = tap("tokens", x.reshape(x.shape[0], 7, -1))  # 1 + 6 tokens: not square
        return t.sum(dim=1)


class _SquareTokens(torch.nn.Module):
    """(B, 1 + 6, D) tokens whose patch tokens reach the output."""

    TAPS = ("tokens",)

    def __init__(self, weights):
        super().__init__()
        self.weights = weights  # (1 + 6, D, K)

    def forward(self, x):
        t = tap("tokens", x)
        return torch.einsum("bnd,ndk->bk", t, self.weights)


def test_token_cam_folds_the_grid():
    """A (B, 1 + N, D) token tap: the class token dropped, token k at row k
    // sqrt(N), column k % sqrt(N) (the reference's row-major reshape);
    GradCAM then by hand."""
    rng = _rng("tokens")
    x = torch.from_numpy(rng.standard_normal((2, 1 + 9, 5)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((1 + 9, 5, 3)).astype(np.float32))
    y = torch.tensor([0, 2])
    acts, grads = TB._acts_and_grads(_SquareTokens(w), x, y, "tokens", True)
    g = w[1:, :, y].permute(2, 0, 1)  # d logit_y / d token, (B, 9, D)
    torch.testing.assert_close(acts, x[:, 1:].reshape(2, 3, 3, 5).permute(0, 3, 1, 2))
    torch.testing.assert_close(grads, g.reshape(2, 3, 3, 5).permute(0, 3, 1, 2))
    cam = torch.relu((grads.mean(dim=(2, 3), keepdim=True) * acts).sum(dim=1))
    torch.testing.assert_close(TB.gradcam(_SquareTokens(w), x, y, layer="tokens"),
                               TB.resize_bilinear(cam, x.shape[-2:]))


def test_cam_errors():
    x, y = torch.randn(2, 3, 7, 4), torch.tensor([0, 1])
    with pytest.raises(ValueError, match="not a square grid"):
        TB.gradcam(_Tokens(), x, y, layer="tokens")
    with pytest.raises(ValueError, match="no activation tap 'stage9'"):
        TB.gradcam(tres.resnet18(num_classes=2).eval(), torch.randn(1, 3, 32, 32), y[:1],
                   layer="stage9")
    model = tconvnext.convnext_test(num_classes=2).eval()
    with pytest.raises(ValueError, match="no activation tap 'stage3'"):
        TB.gradcam(model, torch.randn(1, 3, 32, 32), y[:1], layer="stage3")
    with pytest.raises(ValueError, match="swappable `act`"):
        TB.guided_backprop(model, torch.randn(1, 3, 32, 32), y[:1])
    with pytest.raises(ValueError, match="post_linear"):
        TB.lrp_eps(model, torch.randn(1, 3, 32, 32), y[:1])
    for fn in (TB.attention_rollout, TB.attention_gradient):  # no captured attention
        with pytest.raises(ValueError, match="capture_attn=True"):
            fn(model, torch.randn(1, 3, 32, 32), y[:1])
