"""Parity of the PyTorch port's models with the JAX package.

Weights come from a JAX init, with every BatchNorm given non-identity
scale/bias/mean/var drawn with numpy, and are carried to the port by
`flax_resnet_to_torch`. Logits are compared at 1e-4 (absolute and
relative): both sides compute float32 convolutions with different
summation orders across up to 50 layers.
"""

import importlib
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wam_tpu.models.audio import AudioCNN as JAudioCNN
from wam_tpu.models.audio import bind_audio_inference as jbind_audio
from wam_tpu.models.audio import toy_wave_model as jtoy_wave
from wam_tpu.models import bind_inference as jbind
from wam_tpu.models import resnet18 as jresnet18
from wam_tpu.models import resnet50 as jresnet50
from wam_tpu.models.toy import toy_conv_model as jtoy
from wam_tpu_torch.models import audio as taudio
from wam_tpu_torch.models import resnet as tres
from wam_tpu_torch.models.ingest import flax_audio_to_torch, flax_resnet_to_torch
from wam_tpu_torch.models.toy import toy_conv_model as ttoy
from wam_tpu_torch.tune.fused_relu import fused_relu

TOL = 1e-4
# `wam_tpu.tune` re-exports the function `fused_relu` under the module's name
jfr = importlib.import_module("wam_tpu.tune.fused_relu")


def _perturbed(variables, seed=3):
    """Non-identity BatchNorm affines and running stats, so the weight map
    and the fold are exercised; the scales stay near 1 so ReLUs stay alive."""
    def perturb(path, a):
        name = path[-1].key
        rng = np.random.default_rng(zlib.crc32(f"{seed}{path}".encode()))
        if name == "mean":
            return rng.standard_normal(a.shape).astype(np.float32) * 0.05
        if name in ("var", "scale"):
            return (rng.uniform(size=a.shape) * 0.8 + 0.6).astype(np.float32)
        if name == "bias":
            return rng.standard_normal(a.shape).astype(np.float32) * 0.05
        return np.asarray(a)

    params = jax.tree_util.tree_map_with_path(perturb, variables["params"])
    stats = jax.tree_util.tree_map_with_path(perturb, variables["batch_stats"])
    return {"params": params, "batch_stats": stats}


def _pair(jctor, tctor, side, num_classes):
    model = jctor(num_classes=num_classes)
    variables = _perturbed(model.init(jax.random.PRNGKey(0), jnp.zeros((1, side, side, 3))))
    tmodel = tctor(num_classes=num_classes)
    return model, variables, tmodel, flax_resnet_to_torch(variables)


@pytest.fixture(scope="module")
def r18():
    return _pair(jresnet18, tres.resnet18, 64, 10)


@pytest.fixture(scope="module")
def r50():
    return _pair(jresnet50, tres.resnet50, 64, 1000)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("fold_bn", [False, True])
def test_resnet18_logits_match_jax(r18, fold_bn):
    model, variables, tmodel, state = r18
    x = _x((2, 3, 64, 64))
    want = np.asarray(jbind(model, variables, nchw=True, fold_bn=fold_bn)(jnp.asarray(x)))
    fn = tres.bind_inference(tres.resnet18(num_classes=10), state, fold_bn=fold_bn,
                             device="cpu")
    with torch.no_grad():
        got = fn(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_resnet50_logits_match_jax(r50):
    model, variables, tmodel, state = r50
    x = _x((1, 3, 64, 64), seed=2)
    want = np.asarray(jbind(model, variables, nchw=True)(jnp.asarray(x)))
    fn = tres.bind_inference(tmodel, state, device="cpu")
    with torch.no_grad():
        got = fn(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 1000)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_ingest_covers_every_state_key(r50):
    *_, tmodel, state = r50
    assert set(state) == set(tmodel.state_dict())
    for k, v in tmodel.state_dict().items():
        assert tuple(state[k].shape) == tuple(v.shape), k


def test_fold_bn_is_a_reparameterization(r18):
    """Folded and unfolded bindings give the same logits and input
    gradients, and the fold really rewrote the BatchNorms."""
    *_, state = r18
    x = torch.from_numpy(_x((2, 3, 64, 64), seed=4)).requires_grad_(True)
    m0, m1 = tres.resnet18(num_classes=10), tres.resnet18(num_classes=10)
    f0 = tres.bind_inference(m0, state, device="cpu")
    f1 = tres.bind_inference(m1, state, fold_bn=True, device="cpu")
    assert torch.equal(m1.bn1.weight, torch.ones_like(m1.bn1.weight))
    assert torch.equal(m1.layer2[0].downsample[1].running_mean,
                       torch.zeros_like(m1.layer2[0].downsample[1].running_mean))
    assert not torch.equal(m0.conv1.weight, m1.conv1.weight)
    l0, l1 = f0(x), f1(x)
    torch.testing.assert_close(l1, l0, atol=2e-5, rtol=2e-5)
    g0, = torch.autograd.grad(l0.sum(), x)
    g1, = torch.autograd.grad(l1.sum(), x)
    torch.testing.assert_close(g1, g0, atol=2e-5, rtol=2e-5)


def test_bind_inference_freezes_weights_and_takes_nhwc(r18):
    *_, state = r18
    model = tres.resnet18(num_classes=10)
    fn = tres.bind_inference(model, state, device="cpu")
    assert not model.training
    assert not any(p.requires_grad for p in model.parameters())
    x = torch.from_numpy(_x((2, 3, 32, 32), seed=5))
    nhwc = tres.bind_inference(model, nchw=False, device="cpu")
    with torch.no_grad():
        torch.testing.assert_close(nhwc(x.permute(0, 2, 3, 1)), fn(x))


def test_bind_inference_bf16_close_to_f32(r18):
    """bf16 compute keeps ~3 significant digits per layer; the gate is the
    cosine of the logits against the port's own f32 path (>= 0.99)."""
    *_, state = r18
    x = torch.from_numpy(_x((2, 3, 64, 64), seed=6))
    f32 = tres.bind_inference(tres.resnet18(num_classes=10), state, device="cpu")
    bf16 = tres.bind_inference(tres.resnet18(num_classes=10), state,
                               compute_dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        a, b = f32(x), bf16(x)
    assert b.dtype == torch.float32
    cos = torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(), dim=0)
    assert float(cos) >= 0.99


def test_fused_relu_vjp_binds_and_runs_on_cpu():
    """fused_relu_vjp=True swaps every ``act`` (the stem's and each block's)
    for `fused_relu` without touching a parameter, and the bound model runs
    forward and backward on CPU tensors (the kernels' plain versions)."""
    model = tres.resnet18(num_classes=2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    fn = tres.bind_inference(model, fused_relu_vjp=True, fold_bn=True,
                             compute_dtype=torch.bfloat16, device="cpu")
    acts = [m.act for m in model.modules() if hasattr(m, "act")]
    assert len(acts) == 1 + 8 and all(a is fused_relu for a in acts)
    assert set(model.state_dict()) == set(before)
    x = torch.from_numpy(_x((1, 3, 32, 32), seed=8)).requires_grad_(True)
    out = fn(x)
    (g,) = torch.autograd.grad(out[:, 1].sum(), x)
    assert out.dtype == torch.float32 and out.shape == (1, 2)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0


def test_fused_relu_vjp_needs_an_act():
    with pytest.raises(ValueError, match="act"):
        tres.bind_inference(torch.nn.Linear(3, 2), fused_relu_vjp=True, device="cpu")


@pytest.fixture
def jax_fused_relu_interpret():
    """The JAX impl knob is a module global: set it per test, put it back."""
    before = jfr.get_fused_relu_impl()
    jfr.set_fused_relu_impl("pallas_interpret")
    yield
    jfr.set_fused_relu_impl(before)


def test_resnet18_fused_relu_matches_jax(r18, jax_fused_relu_interpret):
    """bind_inference(fused_relu_vjp=True) on both sides: logits and input
    gradients agree at the model tolerance; the port's fused binding equals
    its own unfused binding exactly (same gate, same values)."""
    model, variables, _, state = r18
    x = _x((2, 3, 64, 64), seed=9)
    y = np.array([3, 8])
    jfn = jbind(model, variables, nchw=True, fused_relu_vjp=True)

    def jloss(a):
        return jnp.take_along_axis(jfn(a), jnp.asarray(y)[:, None], axis=1).sum()

    want = np.asarray(jfn(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(jloss)(jnp.asarray(x)))

    def port(fused):
        fn = tres.bind_inference(tres.resnet18(num_classes=10), state, fused_relu_vjp=fused,
                                 device="cpu")
        tx = torch.from_numpy(x).requires_grad_(True)
        out = fn(tx)
        (g,) = torch.autograd.grad(out.gather(1, torch.from_numpy(y)[:, None]).sum(), tx)
        return out.detach(), g

    (got, got_g), (plain, plain_g) = port(True), port(False)
    assert np.abs(want_g).max() > 0
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_g.numpy(), want_g, atol=TOL * np.abs(want_g).max(), rtol=TOL)
    assert torch.equal(got, plain) and torch.equal(got_g, plain_g)


def test_toy_model_matches_jax():
    key = jax.random.PRNGKey(3)
    kern = np.asarray(jax.random.normal(key, (4, 1, 5, 5), jnp.float32) * 0.3)
    x = _x((3, 20, 24), seed=7)
    want = np.asarray(jtoy(key, ndim=2)(jnp.asarray(x)))
    got = ttoy(kern, ndim=2, device="cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


# -- the audio CNN ---------------------------------------------------------------

AUDIO_IN = (2, 1, 129, 128)  # the shortest mel input that survives the six pools


@pytest.fixture(scope="module")
def audio():
    model = JAudioCNN(num_classes=50)
    init = jax.jit(model.init)  # one compile, not one per op
    variables = _perturbed(init(jax.random.PRNGKey(0), jnp.zeros((1,) + AUDIO_IN[1:])))
    x = _x(AUDIO_IN, seed=5) * 10.0  # dB-scale inputs
    return model, variables, flax_audio_to_torch(variables), x


@pytest.mark.parametrize("fold_bn", [False, True])
def test_audiocnn_scores_match_jax(audio, fold_bn):
    """Scores of the JAX AudioCNN and the port's on the same weights, with
    and without the BatchNorm fold (biased convs)."""
    model, variables, state, x = audio
    want = np.asarray(jax.jit(jbind_audio(model, variables, fold_bn=fold_bn))(jnp.asarray(x)))
    fn = taudio.bind_audio_inference(taudio.AudioCNN(num_classes=50), state, fold_bn=fold_bn,
                                     device="cpu")
    got = fn(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 50)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_audiocnn_mean_pool_and_input_gradient_match_jax(audio):
    model, variables, state, x = audio
    jm = JAudioCNN(num_classes=50, pool="mean")
    out, vjp = jax.vjp(jax.jit(lambda v: jm.apply(variables, v)), jnp.asarray(x))
    want = np.asarray(out)
    (want_g,) = vjp(jnp.zeros_like(out).at[:, 3].set(1.0))
    want_g = np.asarray(want_g)
    tm = taudio.AudioCNN(num_classes=50, pool="mean")
    fn = taudio.bind_audio_inference(tm, state, device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    out = fn(xt)
    out[:, 3].sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, atol=TOL, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, atol=TOL * np.abs(want_g).max(), rtol=0)
    with pytest.raises(ValueError, match="pool"):
        taudio.AudioCNN(pool="sum")


def test_audio_ingest_covers_every_state_key(audio):
    _, _, state, _ = audio
    assert set(state) == set(taudio.AudioCNN(num_classes=50).state_dict())
    with pytest.raises(KeyError, match="unexpected"):
        flax_audio_to_torch({"params": {"dense": {}}, "batch_stats": {}})


def test_audio_fold_bn_scales_the_conv_bias(audio):
    """The fold pairs every bN_bn with its biased bN_conv: each BatchNorm
    becomes a pure shift and each conv bias takes the per-channel scale."""
    _, _, state, x = audio
    plain = taudio.AudioCNN(num_classes=50)
    folded = taudio.AudioCNN(num_classes=50)
    f_plain = taudio.bind_audio_inference(plain, state, device="cpu")
    f_fold = taudio.bind_audio_inference(folded, state, fold_bn=True, device="cpu")
    for n in range(1, 13):
        bn, conv = getattr(folded, f"b{n}_bn"), getattr(folded, f"b{n}_conv")
        assert torch.equal(bn.weight, torch.ones_like(bn.weight))
        a = state[f"b{n}_bn.weight"] / torch.sqrt(state[f"b{n}_bn.running_var"] + 1e-5)
        torch.testing.assert_close(conv.bias, state[f"b{n}_conv.bias"] * a)
    torch.testing.assert_close(f_fold(torch.from_numpy(x)), f_plain(torch.from_numpy(x)),
                               atol=TOL, rtol=0)


def test_bind_audio_inference_freezes_weights(audio):
    _, _, state, _ = audio
    model = taudio.AudioCNN(num_classes=50)
    taudio.bind_audio_inference(model, state, device="cpu")
    assert not model.training
    assert not any(p.requires_grad for p in model.parameters())


def test_audio_bf16_close_to_f32(audio):
    """compute_dtype=bfloat16: float32 scores, cosine >= 0.99 to float32."""
    _, _, state, x = audio
    f32 = taudio.bind_audio_inference(taudio.AudioCNN(num_classes=50), state, device="cpu")
    bf = taudio.bind_audio_inference(taudio.AudioCNN(num_classes=50), state,
                                     compute_dtype=torch.bfloat16, device="cpu")
    a, b = f32(torch.from_numpy(x)), bf(torch.from_numpy(x))
    assert b.dtype == torch.float32
    cos = torch.nn.functional.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0)
    assert float(cos) >= 0.99


def test_toy_wave_model_matches_jax():
    key = jax.random.PRNGKey(4)
    kern = np.asarray(jax.random.normal(key, (4, 1, 9), jnp.float32) * 0.3)
    x = _x((3, 200), seed=8)
    want = np.asarray(jtoy_wave(key)(jnp.asarray(x)))
    got = taudio.toy_wave_model(kern, device="cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
