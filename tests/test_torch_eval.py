"""Parity of the PyTorch port's evaluators with the JAX package:
`Eval2DWAM` (insertion, deletion, μ-fidelity) and `Eval1DWAM` (insertion and
deletion on both targets, faithfulness of spectra, input fidelity), and the
one-fetch contract of every metric call.

Both sides get the same numpy-seeded inputs, the same weights (a JAX init
carried across) and the same explanations, assigned to ``grad_wams`` (the
reference's hand-over, `wam_tpu/evalsuite/eval2d.py:151-167`), or computed
by both explainers on the same handed-over SmoothGrad draws. The port runs
its "kernel" impl (on CPU tensors, the kernels' plain versions: the path
the card runs) and its "conv" impl.

Tolerances: class probabilities come out of float32 models through
transforms summed in another order and agree to ~1e-7; AUCs and curves are
held to 1e-5, μ-fidelity's Spearman values (ranks of those probabilities)
to 1e-5, predicted classes exactly.
"""

import importlib
import os
import zlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wam_tpu.core import estimators as jest
from wam_tpu.evalsuite import fan as jfan
from wam_tpu.evalsuite.eval1d import Eval1DWAM as JEval1D
from wam_tpu.evalsuite.eval2d import Eval2DWAM as JEval2D
from wam_tpu.models import bind_inference as jbind
from wam_tpu.models import resnet18 as jresnet18
from wam_tpu.models.audio import AudioCNN as JAudioCNN
from wam_tpu.models.audio import bind_audio_inference as jbind_audio
from wam_tpu.ops import melspec as jmel
from wam_tpu import wam2d as jwam
from wam_tpu.wavelets import transform as jt
from wam_tpu_torch.evalsuite import fan as tfan
from wam_tpu_torch.evalsuite.eval1d import Eval1DWAM
from wam_tpu_torch.evalsuite.eval2d import Eval2DWAM
from wam_tpu_torch.models import audio as taudio
from wam_tpu_torch.models import resnet as tres
from wam_tpu_torch.models.ingest import flax_audio_to_torch, flax_resnet_to_torch
from wam_tpu_torch.wam2d import WaveletAttribution2D

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

TOL = 1e-5
# `wam_tpu.tune` re-exports the function `fused_relu` under the module's name
jfr = importlib.import_module("wam_tpu.tune.fused_relu")


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


@pytest.fixture(scope="module", autouse=True)
def jax_knobs():
    """The JAX side on its default CPU routes for the whole module (conv 2D
    analysis and synthesis, XLA's ReLU, the conv 1D transform, the fft STFT,
    float32 mel matmuls) and no precision knob in the environment; all put
    back after. They are process globals that other test files may leave
    changed."""
    saved = (jt.get_dwt2_impl(), jt.get_synth2_impl(), jfr.get_fused_relu_impl(),
             jt._dwt1_impl, jmel.get_stft_impl(), jmel.get_mel_bf16())
    env = {k: os.environ.pop(k) for k in ("WAM_TPU_FAN_DTYPE", "WAM_TPU_MEL_BF16")
           if k in os.environ}
    jt.set_dwt2_impl("auto")
    jt.set_synth2_impl("auto")
    jfr.set_fused_relu_impl("auto")
    jt.set_dwt1_impl("conv")
    jmel.set_stft_impl("fft")
    jmel.set_mel_bf16(False)
    yield
    jt.set_dwt2_impl(saved[0])
    jt.set_synth2_impl(saved[1])
    jfr.set_fused_relu_impl(saved[2])
    jt.set_dwt1_impl(saved[3])
    jmel.set_stft_impl(saved[4])
    jmel.set_mel_bf16(saved[5])
    os.environ.update(env)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=tol)


# -- a tiny image classifier on both sides ------------------------------------------


class TinyImgModel(nn.Module):
    """The reference tests' tiny classifier (tests/test_fan.py)."""

    classes: int = 5

    @nn.compact
    def __call__(self, x):
        x = jnp.transpose(x, (0, 2, 3, 1))
        x = nn.Conv(8, (3, 3), strides=(2, 2))(x)
        x = nn.relu(x).mean(axis=(1, 2))
        return nn.Dense(self.classes)(x)


@pytest.fixture(scope="module")
def tiny():
    model = TinyImgModel()
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)))["params"]
    w = torch.from_numpy(np.array(params["Conv_0"]["kernel"]).transpose(3, 2, 0, 1).copy())
    b = torch.from_numpy(np.array(params["Conv_0"]["bias"]))
    dw = torch.from_numpy(np.array(params["Dense_0"]["kernel"]))
    db = torch.from_numpy(np.array(params["Dense_0"]["bias"]))

    def tfn(x):  # flax SAME at stride 2 on an even side pads one row and column after
        h = F.conv2d(F.pad(x, (0, 1, 0, 1)), w.to(x.dtype), b.to(x.dtype), stride=2)
        return torch.relu(h).mean(dim=(2, 3)) @ dw.to(x.dtype) + db.to(x.dtype)

    return (lambda x: model.apply({"params": params}, x)), tfn


def _images(key, n=2, side=32):
    return _rng("img", key).standard_normal((n, 3, side, side)).astype(np.float32)


def _mosaics(key, n=2, side=32):
    """Attribution mosaics in [0, 1] with many ties (a few levels)."""
    return np.round(_rng("wam", key).random((n, side, side)) * 8).astype(np.float32) / 8


def _pair(jfn, tfn, wams, impl, **kw):
    """JAX and port evaluators on the same explanations."""
    jev = JEval2D(jfn, None, **kw)
    tev = Eval2DWAM(tfn, None, device="cpu", impl=impl, **kw)
    jev.grad_wams = jnp.asarray(wams)
    tev.grad_wams = torch.from_numpy(wams)
    return jev, tev


@pytest.mark.parametrize("impl", ["kernel", "conv"])
@pytest.mark.parametrize("batch_size", [4, 16, 64])
def test_eval2d_insertion_deletion_match_jax(tiny, impl, batch_size):
    """Scores and curves of both modes at three chunk geometries (fan 9: 4
    rows a model call, one image a call, seven images a call)."""
    jfn, tfn = tiny
    x, y = _images("auc"), [1, 3]
    jev, tev = _pair(jfn, tfn, _mosaics("auc"), impl, wavelet="haar", J=2,
                     batch_size=batch_size)
    for mode in ("insertion", "deletion"):
        want = getattr(jev, mode)(jnp.asarray(x), y, n_iter=8)
        got = getattr(tev, mode)(torch.from_numpy(x), y, n_iter=8)
        _close(got, want)
        _close(getattr(tev, f"{mode}_curves"), getattr(jev, f"{mode}_curves"))
        assert len(getattr(tev, f"{mode}_curves")[0]) == 9


@pytest.mark.parametrize("impl", ["kernel", "conv"])
def test_eval2d_mu_fidelity_matches_jax(tiny, impl):
    jfn, tfn = tiny
    x, y = _images("mu", n=3), [0, 2, 4]
    jev, tev = _pair(jfn, tfn, _rng("wam", "mu").random((3, 32, 32)).astype(np.float32),
                     impl, wavelet="haar", J=2, batch_size=16)
    kw = dict(grid_size=8, sample_size=6, subset_size=12)
    want = jev.mu_fidelity(jnp.asarray(x), y, **kw)
    got = tev.mu_fidelity(torch.from_numpy(x), y, **kw)
    _close(got, want)
    assert all(-1.0 <= v <= 1.0 for v in got)


@pytest.mark.parametrize("side,grid,sample,subset", [(16, 8, 32, 12), (224, 28, 32, 157)])
def test_constant_map_mu_fidelity_reads_zero_in_both_packages(tiny, side, grid, sample, subset):
    """A constant explanation gives every superpixel the same mass, so the
    Spearman correlation has no ranks to order and reads 0.0, in the port
    as in the reference: the port's blur returns a constant map bit for bit
    (a float32 convolution of ones read 1.0000001 a pixel, 4.0000005 a
    2 x 2 cell, and the subsets' sums broke the ties: ±0.09–0.14 here)."""
    jfn, tfn = tiny
    x, y = _images("const", n=2, side=side), [1, 3]
    jev, tev = _pair(jfn, tfn, np.ones((2, side, side), np.float32), "kernel",
                     wavelet="haar", J=2, batch_size=64)
    kw = dict(grid_size=grid, sample_size=sample, subset_size=subset)
    want = jev.mu_fidelity(jnp.asarray(x), y, **kw)
    got = tev.mu_fidelity(torch.from_numpy(x), y, **kw)
    np.testing.assert_array_equal(np.asarray(want, np.float64), 0.0)
    np.testing.assert_array_equal(np.asarray(got, np.float64), 0.0)


def test_eval2d_resized_mosaic_matches_jax(tiny):
    """A db2 decomposition packs to a larger array than the image: the mosaic
    is resized to it by the nearest rule before the masks."""
    jfn, tfn = tiny
    x, y = _images("resize"), [2, 0]
    jev, tev = _pair(jfn, tfn, _mosaics("resize"), "kernel", wavelet="db2", J=2,
                     batch_size=32)
    _close(tev.insertion(torch.from_numpy(x), y, n_iter=8),
           jev.insertion(jnp.asarray(x), y, n_iter=8))
    _close(tev.insertion_curves, jev.insertion_curves)


def test_eval2d_through_the_explainer_with_handed_noise(tiny):
    """Insertion with explanations each side computes itself: the port's
    `WaveletAttribution2D` on handed-over draws, the JAX side the mean of
    `BaseWAM2D` passes on the same noisy inputs."""
    jfn, tfn = tiny
    x, y = _images("expl"), [4, 1]
    z = _rng("expl-noise").standard_normal((3,) + x.shape).astype(np.float32)
    sigma = np.asarray(jest.noise_sigma(jnp.asarray(x), 0.25)).reshape(-1, 1, 1, 1)
    jbase = jwam.BaseWAM2D(jfn, wavelet="haar", J=2)

    def jexplainer(xx, yy):
        return jnp.mean(jnp.stack([jbase(xx + zi * sigma, jnp.asarray(yy)) for zi in z]), 0)

    texpl = WaveletAttribution2D(tfn, wavelet="haar", J=2, n_samples=3, device="cpu",
                                 impl="kernel")
    jev = JEval2D(jfn, jexplainer, wavelet="haar", J=2, batch_size=16)
    tev = Eval2DWAM(tfn, lambda xx, yy: texpl(xx, yy, noise=torch.from_numpy(z)),
                    wavelet="haar", J=2, batch_size=16, device="cpu", impl="kernel")
    want = jev.insertion(jnp.asarray(x), y, n_iter=8)
    got = tev.insertion(torch.from_numpy(x), y, n_iter=8)
    _close(tev.grad_wams.numpy(), np.asarray(jev.grad_wams), tol=1e-5)
    _close(got, want)
    _close(tev.insertion_curves, jev.insertion_curves)


@pytest.fixture(scope="module")
def r18():
    model = jresnet18(num_classes=10)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    jfn = jbind(model, variables, nchw=True)
    tfn = tres.bind_inference(tres.resnet18(num_classes=10), flax_resnet_to_torch(variables),
                              device="cpu")
    return jfn, tfn


def test_eval2d_resnet18_matches_jax(r18):
    """ResNet-18 at 64², haar J=3: insertion, deletion (one image a model
    call) and μ-fidelity, on the kernel impl."""
    jfn, tfn = r18
    x, y = _images("r18", side=64), [3, 8]
    jev, tev = _pair(jfn, tfn, _rng("wam", "r18").random((2, 64, 64)).astype(np.float32),
                     "kernel", wavelet="haar", J=3, batch_size=9)
    for mode in ("insertion", "deletion"):
        _close(getattr(tev, mode)(torch.from_numpy(x), y, n_iter=8),
               getattr(jev, mode)(jnp.asarray(x), y, n_iter=8))
        _close(getattr(tev, f"{mode}_curves"), getattr(jev, f"{mode}_curves"))
    kw = dict(grid_size=8, sample_size=6, subset_size=12)
    _close(tev.mu_fidelity(torch.from_numpy(x), y, **kw), jev.mu_fidelity(jnp.asarray(x), y, **kw))


def test_eval2d_precompute_fingerprints_the_batch(tiny):
    """A second batch recomputes its explanations; the same batch reuses them."""
    _, tfn = tiny
    calls = []

    def explainer(x, y):
        calls.append(tuple(x.shape))
        return torch.ones(x.shape[:1] + x.shape[-2:])

    ev = Eval2DWAM(tfn, explainer, wavelet="haar", J=2, batch_size=16, device="cpu")
    x = torch.from_numpy(_images("fp"))
    ev.insertion(x, [0, 1], n_iter=4)
    ev.deletion(x, [0, 1], n_iter=4)
    ev.insertion(x[:1], [0], n_iter=4)
    assert calls == [(2, 3, 32, 32), (1, 3, 32, 32)]
    ev.reset()
    assert ev.grad_wams is None


# -- the one-fetch contract -----------------------------------------------------------


@pytest.fixture
def host_reads(monkeypatch):
    """Counts every tensor-to-host read (``cpu``, ``numpy``, ``item``,
    ``tolist``, ``__array__``) while a metric runs."""
    calls = []
    for name in ("cpu", "numpy", "item", "tolist", "__array__"):
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    return calls


def test_one_fetch_per_metric_call_eval2d(tiny, host_reads):
    _, tfn = tiny
    ev = Eval2DWAM(tfn, lambda x, y: torch.ones(x.shape[:1] + x.shape[-2:]), wavelet="haar",
                   J=2, batch_size=16, device="cpu", impl="kernel")
    x, y = torch.from_numpy(_images("fetch")), [1, 3]
    ev.precompute(x, y)
    for call in (lambda: ev.insertion(x, y, n_iter=8), lambda: ev.deletion(x, y, n_iter=8),
                 lambda: ev.mu_fidelity(x, y, grid_size=8, sample_size=6, subset_size=12)):
        host_reads.clear()
        with tfan.fetch_scope() as fs:
            call()
        assert fs.count == 1
        assert host_reads == ["cpu", "numpy"]  # the fetch's one copy, nothing else


def test_one_fetch_per_metric_call_bf16_fan(tiny):
    """The bf16 fan keeps the contract (the cast lives inside the step)."""
    _, tfn = tiny
    ev = Eval2DWAM(tfn, lambda x, y: torch.ones(x.shape[:1] + x.shape[-2:]), wavelet="haar",
                   J=2, batch_size=16, precision="bf16", device="cpu")
    assert ev._fan_plan(9).fan_dtype == "bf16"
    x, y = torch.from_numpy(_images("fetch16")), [1, 3]
    for call in (lambda: ev.insertion(x, y, n_iter=8),
                 lambda: ev.mu_fidelity(x, y, grid_size=8, sample_size=6, subset_size=12)):
        with tfan.fetch_scope() as fs:
            out = call()
        assert fs.count == 1 and np.all(np.isfinite(out))


# -- Eval1DWAM on the AudioCNN ------------------------------------------------------

SLICE_KW = dict(wavelet="db6", J=5, mode="reflect", n_mels=128, n_fft=1024, sample_rate=44100)


@pytest.fixture(scope="module")
def audio():
    """`scripts/bench_eval.py --toy`'s audio geometry: the 50-class AudioCNN
    on JAX weights, 2 waveforms of 65,536 samples (129 frames), db6 J=5,
    and seeded explanations of the explainer's shapes (mel gradients (2,
    129, 128), six coefficient levels) with ties, handed to both sides."""
    model = JAudioCNN(num_classes=50)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 1, 129, 128)))
    jfn = jbind_audio(model, variables)
    tfn = taudio.bind_audio_inference(taudio.AudioCNN(num_classes=50),
                                      flax_audio_to_torch(variables), device="cpu")
    rng = _rng("audio")
    x = (0.1 * rng.standard_normal((2, 65536))).astype(np.float32)
    mel = np.round(rng.standard_normal((2, 129, 128)), 1).astype(np.float32)
    coeffs = [np.round(rng.standard_normal((2, n)), 2).astype(np.float32)
              for n in (2058, 2058, 4106, 8201, 16392, 32773)]
    jev = JEval1D(jfn, None, batch_size=32, **SLICE_KW)
    tev = Eval1DWAM(tfn, None, batch_size=32, device="cpu", **SLICE_KW)
    jev.grad_wams = (jnp.asarray(mel), [jnp.asarray(c) for c in coeffs])
    tev.grad_wams = (torch.from_numpy(mel), [torch.from_numpy(c) for c in coeffs])
    return jev, tev, x, [7, 31]


@pytest.mark.parametrize("target", ["wavelet", "melspec"])
def test_eval1d_auc_matches_jax(audio, target):
    """Insertion (n_iter 8, 9 rows: one model call) and deletion (n_iter 40,
    41 rows: 32-row slices) on both targets."""
    jev, tev, x, y = audio
    for mode, n_iter in (("insertion", 8), ("deletion", 40)):
        want = getattr(jev, mode)(jnp.asarray(x), y, target=target, n_iter=n_iter)
        got = getattr(tev, mode)(torch.from_numpy(x), y, target=target, n_iter=n_iter)
        _close(got, want)
        _close(getattr(tev, f"{mode}_curves"), getattr(jev, f"{mode}_curves"))


@pytest.mark.parametrize("target", ["wavelet", "melspec"])
def test_eval1d_spectra_and_input_fidelity_match_jax(audio, target):
    jev, tev, x, y = audio
    _close(tev.faithfulness_of_spectra(torch.from_numpy(x), y, target=target),
           jev.faithfulness_of_spectra(jnp.asarray(x), y, target=target))
    want = jev.input_fidelity(jnp.asarray(x), y, target=target)
    with tfan.fetch_scope() as fs:
        got = tev.input_fidelity(torch.from_numpy(x), y, target=target)
    assert got == want and fs.count == 1
    assert [len(p) for p in got] == [2, 2]


def test_one_fetch_per_metric_call_eval1d(audio, host_reads):
    _, tev, x, y = audio
    x = torch.from_numpy(x)
    for call in (lambda: tev.insertion(x, y, n_iter=4),
                 lambda: tev.faithfulness_of_spectra(x, y, target="melspec"),
                 lambda: tev.input_fidelity(x, y)):
        host_reads.clear()
        with tfan.fetch_scope() as fs:
            call()
        assert fs.count == 1 and host_reads == ["cpu", "numpy"]


def test_evaluators_refuse_unported_options(tiny):
    _, tfn = tiny
    # aot_key= and donate_inputs= are ported (tests/test_torch_aot.py): kept as given
    for kw in ({"aot_key": "k"}, {"donate_inputs": True}):
        for cls in (Eval2DWAM, Eval1DWAM):
            ev = cls(tfn, None, device="cpu", **kw)
            assert (ev.aot_key, ev.donate_inputs) == (kw.get("aot_key"),
                                                      kw.get("donate_inputs"))
    mesh = object()  # mesh= is ported (tests/test_torch_parallel.py): kept as given
    for cls in (Eval2DWAM, Eval1DWAM):
        assert cls(tfn, None, device="cpu", mesh=mesh).mesh is mesh
    with pytest.raises(ValueError, match="Unknown target"):
        Eval1DWAM(tfn, lambda x, y: (torch.zeros(1, 1, 1), []), device="cpu").insertion(
            np.zeros((1, 4096), np.float32), [0], target="stft")
