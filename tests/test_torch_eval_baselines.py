"""Parity of the PyTorch port's baseline evaluators (`EvalImageBaselines`,
`EvalAudioBaselines`) with the JAX package, and their contracts: one
counted result fetch a metric call, the evaluator's own copy of the model
at its compute dtype, LRP in float32 under a bfloat16 evaluator, and the
options that raise.

Both sides get the same numpy-seeded inputs and weights (drawn into the
JAX init's tree, carried across by `models.ingest`). Every method's
explanation is computed by both sides (held as in
tests/test_torch_baselines.py), then scored twice: each side on its own
explanation, and the port on the reference's, handed over. AUCs, curves
and μ values agree within 1e-5, predicted classes exactly. One JAX
evaluator scores every method's maps (its fan is compiled once); the
methods' JAX explanations each compile once.
"""

import importlib
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wam_tpu.config import PrecisionPolicy as JPolicy
from wam_tpu.evalsuite.eval_baselines import EvalAudioBaselines as JEvalAudio
from wam_tpu.evalsuite.eval_baselines import EvalImageBaselines as JEvalImage
from wam_tpu.models import resnet18 as jresnet18
from wam_tpu.models.audio import AudioCNN as JAudioCNN
from wam_tpu_torch.config import FP8, PrecisionPolicy
from wam_tpu_torch.evalsuite import fan as tfan
from wam_tpu_torch.evalsuite.eval_baselines import (
    AUDIO_METHODS,
    IMAGE_METHODS,
    EvalAudioBaselines,
    EvalImageBaselines,
)
from wam_tpu_torch.models import audio as taudio
from wam_tpu_torch.models import resnet as tres
from wam_tpu_torch.models.ingest import flax_audio_to_torch, flax_resnet_to_torch

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

TOL = 1e-5
MAP_TOL = {"gradcampp": 1e-2}  # GradCAM++'s measured float32 bound (test_torch_baselines.py)
# the CAMs' bilinear upsampling makes positions that tie in exact arithmetic
# (mirror images within a coarse cell); the reference's resize breaks those
# ties by rounding, position by position, so each side's own map ranks them
# in another order and its AUCs differ by up to ~3e-2: these are scored on
# the handed-over map only
TIED = ("gradcam", "gradcampp", "layercam")
# AudioCNN ReLU gates flip between the two float32 computations on these
# inputs (IG's midpoint, SmoothGrad's noisy copies), moving the map by up
# to 6.3e-3 of its max; in float64 the two agree within 2e-15
# (test_torch_baselines.py::test_audio_gate_flips_vanish_in_float64): those
# maps are held at 2e-2 and scored on the handed-over map only
AUDIO_MAP_TOL = {"integratedgrad": 2e-2, "smoothgrad": 2e-2}
SIDE = 32
# at 32² stage4 is a 1 x 1 grid: its CAM resizes to a constant map, whose
# ties float rounding breaks differently on each side; stage3 is 2 x 2
CAM_LAYER = "stage3"
AUDIO_IN = (2, 1, 257, 128)
N_ITER = 8
MU = dict(grid_size=8, sample_size=6, subset_size=12)
jfr = importlib.import_module("wam_tpu.tune.fused_relu")


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


@pytest.fixture(scope="module", autouse=True)
def jax_knobs():
    """XLA's ReLU on the JAX side and no precision knob in the environment,
    all put back after: process globals other files may leave changed."""
    saved = jfr.get_fused_relu_impl()
    env = {k: os.environ.pop(k) for k in ("WAM_TPU_FAN_DTYPE", "WAM_TPU_MEL_BF16")
           if k in os.environ}
    jfr.set_fused_relu_impl("auto")
    yield
    jfr.set_fused_relu_impl(saved)
    os.environ.update(env)


def _variables(model, shape, seed):
    """float32 variables drawn with numpy in ``model.init``'s tree (every
    BatchNorm non-identity), the perturbation taps zero."""
    rng = _rng("vars", seed)
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros(shape))

    def draw(path, leaf):
        name, n = path[-1].key, leaf.shape
        if path[0].key == "perturbations":
            return np.zeros(n, np.float32)
        if name == "kernel":
            v = rng.standard_normal(n) / np.sqrt(np.prod(n[:-1]))
        elif name in ("bias", "mean"):
            v = 0.05 * rng.standard_normal(n)
        elif name == "scale":
            v = rng.uniform(0.8, 1.2, n)
        else:  # var
            v = rng.uniform(0.5, 1.5, n)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _close(got, want, tol=TOL, tag=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=tol, err_msg=tag)


def _map_close(got, want, tol, tag):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), tag
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * peak, (tag, np.abs(got - want).max() / peak)


@pytest.fixture(scope="module")
def image():
    """ResNet-18 (10 classes) at 32², two images, labels, and one scoring
    evaluator a side."""
    model = jresnet18(num_classes=10)
    v = _variables(model, (1, SIDE, SIDE, 3), "r18")
    state = flax_resnet_to_torch(v)
    x = _rng("img").standard_normal((2, 3, SIDE, SIDE)).astype(np.float32)
    y = [3, 8]
    jev = JEvalImage(model, v, method="saliency", batch_size=9, n_samples=3)
    tev = EvalImageBaselines(tres.resnet18(num_classes=10), state, method="saliency",
                             batch_size=9, n_samples=3, device="cpu")
    return model, v, state, x, y, jev, tev


def _scores(ev, x, y, expl):
    """Insertion and deletion (scores, curves) and μ of ``expl`` handed to ``ev``."""
    ev.explanations, ev._expl_key = expl, None
    out = {}
    for mode in ("insertion", "deletion"):
        out[mode] = getattr(ev, mode)(x, y, n_iter=N_ITER)
        out[f"{mode}_curves"] = np.stack(getattr(ev, f"{mode}_curves"))
    out["mu"] = ev.mu_fidelity(x, y, **MU)
    return out


def _same_scores(got, want, tag):
    for key in want:
        _close(got[key], want[key], tag=f"{tag} {key}")


@pytest.mark.parametrize("method", [m for m in IMAGE_METHODS if m not in ("rollout", "attngrad")])
def test_image_methods_and_their_scores_match_jax(image, method):
    """Each of the nine methods: the map, then its insertion, deletion and
    μ-fidelity, each side on its own map and the port on the reference's."""
    model, v, state, x, y, jev, tev = image
    jm = JEvalImage(model, v, method=method, batch_size=9, n_samples=3, cam_layer=CAM_LAYER)
    tm = EvalImageBaselines(tres.resnet18(num_classes=10), state, method=method, batch_size=9,
                            n_samples=3, cam_layer=CAM_LAYER, device="cpu")
    want_map = np.asarray(jm.precompute(jnp.asarray(x), jnp.asarray(y)))
    if method == "smoothgrad":  # the port's draws are torch's: hand over JAX's
        from wam_tpu_torch.evalsuite import baselines as TB

        key = jax.random.PRNGKey(jm.random_seed)
        noise = torch.from_numpy(np.asarray(jax.random.normal(key, (3,) + x.shape)))
        got_map = TB.smoothgrad_pixel(tm.model_fn, torch.from_numpy(x), torch.tensor(y),
                                      n_samples=3, stdev_spread=0.25, noise=noise)
    else:
        got_map = tm.precompute(torch.from_numpy(x), y)
        assert got_map.dtype == torch.float32 and got_map.shape == (2, SIDE, SIDE)
    _map_close(got_map.numpy(), want_map, MAP_TOL.get(method, 1e-4), method)
    want = _scores(jev, jnp.asarray(x), y, jnp.asarray(want_map))
    _same_scores(_scores(tev, torch.from_numpy(x), y, torch.from_numpy(want_map)), want,
                 f"{method} handed over")
    if method not in TIED:
        _same_scores(_scores(tev, torch.from_numpy(x), y, got_map), want, f"{method} own map")


@pytest.fixture(scope="module")
def audio():
    """The AudioCNN (10 classes) on two mel inputs of 257 frames (its out3
    a 3 x 1 grid), and one scoring evaluator a side."""
    model = JAudioCNN(num_classes=10)
    v = _variables(model, (1,) + AUDIO_IN[1:], "audio")
    state = flax_audio_to_torch(v)
    x = (10.0 * _rng("mel").standard_normal(AUDIO_IN)).astype(np.float32)
    y = [2, 7]
    jev = JEvalAudio(model, v, method="saliency", batch_size=9, n_samples=3)
    tev = EvalAudioBaselines(taudio.AudioCNN(num_classes=10), state, method="saliency",
                             batch_size=9, n_samples=3, device="cpu")
    return model, v, state, x, y, jev, tev


def _audio_scores(ev, x, y, expl):
    ev.explanations, ev._expl_key = expl, None
    out = {"insertion": ev.insertion(x, y, n_iter=N_ITER)}
    out["insertion_curves"] = np.stack(ev.insertion_curves)
    out["deletion"] = ev.deletion(x, y, n_iter=N_ITER)
    out["deletion_curves"] = np.stack(ev.deletion_curves)
    out["spectra"] = ev.faithfulness_of_spectra(x, y)
    out["fidelity"] = ev.input_fidelity(x, y)
    return out


@pytest.mark.parametrize("method", AUDIO_METHODS)
def test_audio_methods_and_their_scores_match_jax(audio, method):
    """Each of the four methods on the mel input: the map, then insertion,
    deletion, faithfulness of spectra and input fidelity (classes equal),
    each side on its own map and the port on the reference's."""
    model, v, state, x, y, jev, tev = audio
    jm = JEvalAudio(model, v, method=method, batch_size=9, n_samples=3)
    tm = EvalAudioBaselines(taudio.AudioCNN(num_classes=10), state, method=method,
                            batch_size=9, n_samples=3, device="cpu")
    want_map = np.asarray(jm.precompute(jnp.asarray(x), jnp.asarray(y)))
    if method == "smoothgrad":
        from wam_tpu_torch.evalsuite import baselines as TB

        key = jax.random.PRNGKey(jm.random_seed)
        noise = torch.from_numpy(np.asarray(jax.random.normal(key, (3,) + x.shape)))
        got_map = TB.smoothgrad_pixel(tm.model_fn, torch.from_numpy(x), torch.tensor(y),
                                      n_samples=3, stdev_spread=0.001, noise=noise)
    else:
        got_map = tm.precompute(torch.from_numpy(x), y)
    _map_close(got_map.numpy(), want_map, AUDIO_MAP_TOL.get(method, 1e-4), method)
    want = _audio_scores(jev, jnp.asarray(x), y, jnp.asarray(want_map))
    cases = [(torch.from_numpy(want_map), "handed over")]
    if method not in AUDIO_MAP_TOL:
        cases.append((got_map, "own map"))
    for expl, tag in cases:
        got = _audio_scores(tev, torch.from_numpy(x), y, expl)
        assert got.pop("fidelity") == want["fidelity"], (method, tag)
        _same_scores(got, {k: w for k, w in want.items() if k != "fidelity"}, f"{method} {tag}")


def test_smoothgrad_is_seeded_by_random_seed(image):
    """The evaluator's SmoothGrad draws come from a generator seeded with
    ``random_seed``: two evaluators agree, another seed differs."""
    _, _, state, x, y, _, _ = image

    def maps(seed):
        return EvalImageBaselines(tres.resnet18(num_classes=10), state, method="smoothgrad",
                                  n_samples=2, random_seed=seed,
                                  device="cpu").precompute(torch.from_numpy(x), y)

    torch.testing.assert_close(maps(7), maps(7))
    assert not torch.equal(maps(7), maps(8))


# -- the one-fetch contract --------------------------------------------------------------


@pytest.fixture
def host_reads(monkeypatch):
    """Counts every tensor-to-host read while a metric runs."""
    calls = []
    for name in ("cpu", "numpy", "item", "tolist", "__array__"):
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    return calls


def test_one_fetch_per_metric_call(image, audio, host_reads):
    _, _, _, x, y, _, tev = image
    _, _, _, xa, ya, _, tea = audio
    x, xa = torch.from_numpy(x), torch.from_numpy(xa)
    tev.reset()
    tea.reset()
    tev.precompute(x, y)
    tea.precompute(xa, ya)
    for call in (lambda: tev.insertion(x, y, n_iter=N_ITER),
                 lambda: tev.deletion(x, y, n_iter=N_ITER),
                 lambda: tev.mu_fidelity(x, y, **MU),
                 lambda: tea.insertion(xa, ya, n_iter=N_ITER),
                 lambda: tea.faithfulness_of_spectra(xa, ya),
                 lambda: tea.input_fidelity(xa, ya)):
        host_reads.clear()
        with tfan.fetch_scope() as fs:
            call()
        assert fs.count == 1
        assert host_reads == ["cpu", "numpy"]  # the fetch's one copy, nothing else


def test_precompute_fingerprints_the_batch(image):
    """Another batch recomputes; the same batch reuses; assigned
    explanations adopt the first batch they are used with."""
    _, _, state, x, y, _, _ = image
    ev = EvalImageBaselines(tres.resnet18(num_classes=10), state, device="cpu")
    x = torch.from_numpy(x)
    first = ev.precompute(x, y)
    assert ev.precompute(x, y) is first
    assert ev.precompute(x[:1], y[:1]) is not first
    ev.reset()
    assert ev.explanations is None
    ev.explanations = torch.ones(2, SIDE, SIDE)
    assert torch.equal(ev.precompute(x, y), torch.ones(2, SIDE, SIDE))
    assert ev.precompute(x[:1], y[:1]).shape == (1, SIDE, SIDE)


# -- precision ---------------------------------------------------------------------------------


def test_lrp_under_a_bf16_evaluator_runs_float32(image):
    """``method="lrp"`` under ``compute_dtype=torch.bfloat16``: the walker
    widens the evaluator's bf16-rounded weights and runs float32, as the
    reference's does (its map within 1e-4 of the reference's bf16
    evaluator's); the logits come back float32 and the caller's module is
    untouched."""
    model, v, state, x, y, _, _ = image
    caller = tres.resnet18(num_classes=10)
    caller.load_state_dict(state)
    before = {k: t.clone() for k, t in caller.state_dict().items()}
    ev = EvalImageBaselines(caller, None, method="lrp", compute_dtype=torch.bfloat16,
                            device="cpu")
    assert next(ev.model.parameters()).dtype == torch.bfloat16
    assert ev.model_fn(torch.from_numpy(x)).dtype == torch.float32
    got = ev.precompute(torch.from_numpy(x), y)
    want = JEvalImage(model, v, method="lrp", compute_dtype=jnp.bfloat16).precompute(
        jnp.asarray(x), jnp.asarray(y))
    assert got.dtype == torch.float32
    _map_close(got.numpy(), np.asarray(want), 1e-4, "bf16 lrp")
    for k, t in caller.state_dict().items():
        assert t.dtype == before[k].dtype and torch.equal(t, before[k]), k
    assert caller.training and all(p.requires_grad for p in caller.parameters())


def test_guided_backprop_leaves_the_callers_model_alone(image):
    _, _, state, x, y, _, _ = image
    caller = tres.resnet18(num_classes=10)
    caller.load_state_dict(state)
    ev = EvalImageBaselines(caller, None, method="guided_backprop", device="cpu")
    ev.precompute(torch.from_numpy(x), y)
    assert ev.model is not caller
    for m in (caller, ev.model):
        assert all(mod.act is torch.relu for mod in m.modules() if hasattr(mod, "act"))


@pytest.mark.parametrize("compute_dtype,precision", [
    (None, None), ("f32", None), ("bf16", None), ("fp8", None), ("bfloat16", None),
    (None, "bf16"), (None, "fp8"), ("bf16", "fp8"), (None, "policy-fp8")])
def test_compute_dtype_resolves_as_jax_does(image, compute_dtype, precision):
    """The policy strings, dtypes and precision policies resolve to the
    reference's compute dtype and fan tag (on this CPU both sides find fp8
    supported)."""
    model, v, state, *_ = image
    jcd = jnp.bfloat16 if compute_dtype == "bfloat16" else compute_dtype
    tcd = torch.bfloat16 if compute_dtype == "bfloat16" else compute_dtype
    jprec = JPolicy(fan_dtype="fp8") if precision == "policy-fp8" else precision
    tprec = PrecisionPolicy(fan_dtype="fp8") if precision == "policy-fp8" else precision
    jev = JEvalImage(model, v, compute_dtype=jcd, precision=jprec)
    tev = EvalImageBaselines(tres.resnet18(num_classes=10), state, compute_dtype=tcd,
                             precision=tprec, device="cpu")
    assert tev._fan_dtype == jev._fan_dtype
    want = None if jev.compute_dtype is None else jnp.dtype(jev.compute_dtype).name
    got = None if tev.compute_dtype is None else str(tev.compute_dtype).removeprefix("torch.")
    assert got == want
    assert tev._fan_plan(9).fan_dtype == (jev._fan_dtype or "f32")


def test_fp8_rounds_through_e4m3_and_computes_in_bf16(image):
    """"fp8" where `fp8_supported` (this CPU, as the reference's): the
    evaluator's weights are e4m3 values held in bfloat16 (cuDNN has no fp8
    convolution), never float32; inputs are rounded through e4m3; logits
    come back float32 and the metrics run."""
    _, _, state, x, y, _, _ = image
    ev = EvalImageBaselines(tres.resnet18(num_classes=10), state, compute_dtype="fp8",
                            batch_size=9, device="cpu")
    assert ev.compute_dtype == FP8 and ev._fan_dtype == "fp8"
    w = ev.model.conv1.weight
    assert w.dtype == torch.bfloat16
    torch.testing.assert_close(w, w.to(FP8).to(torch.bfloat16), rtol=0, atol=0)
    assert not torch.equal(w.float(), state["conv1.weight"])
    xt = torch.from_numpy(x)
    logits = ev.model_fn(xt)
    assert logits.dtype == torch.float32
    rounded = xt.to(FP8).float()
    torch.testing.assert_close(logits, ev.model(rounded.to(torch.bfloat16)).float())
    scores = ev.insertion(xt, y, n_iter=N_ITER)
    assert np.isfinite(scores).all() and min(scores) >= 0 and max(scores) <= 1


# -- what raises ----------------------------------------------------------------------------------


def test_evaluators_refuse_what_is_not_there(image, monkeypatch):
    _, _, state, *_ = image
    net = tres.resnet18(num_classes=10)
    with pytest.raises(NotImplementedError, match="srd"):
        EvalImageBaselines(net, state, method="srd", device="cpu")
    with pytest.raises(ValueError, match="Unknown method"):
        EvalImageBaselines(net, state, method="occlusion", device="cpu")
    with pytest.raises(ValueError, match="Unknown method"):
        EvalAudioBaselines(taudio.AudioCNN(), None, method="lrp", device="cpu")
    for method in ("rollout", "attngrad"):  # a model without captured attention
        with pytest.raises(ValueError, match="capture_attn=True"):
            EvalImageBaselines(net, state, method=method, device="cpu")
    # aot_key= and donate_inputs= are ported (tests/test_torch_aot.py): kept as given
    for kw in ({"aot_key": "k"}, {"donate_inputs": True}):
        for cls in (EvalImageBaselines, EvalAudioBaselines):
            ev = cls(net, None, device="cpu", **kw)
            assert (ev.aot_key, ev.donate_inputs) == (kw.get("aot_key"),
                                                      kw.get("donate_inputs"))
    mesh = object()  # mesh= is ported (tests/test_torch_parallel.py): kept as given
    assert EvalImageBaselines(net, None, device="cpu", mesh=mesh).mesh is mesh
    with pytest.raises(ValueError, match="swappable `act`"):  # the AudioCNN has no `act`
        EvalImageBaselines(taudio.AudioCNN(), None, method="guided_backprop", nchw=True,
                           device="cpu").precompute(torch.zeros(1, 1, 257, 128), [0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (EvalImageBaselines, EvalAudioBaselines):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(net, None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(net, None, device="cuda")
