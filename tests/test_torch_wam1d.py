"""Parity of the PyTorch port's WAM-1D slice with the JAX package: the
engine's mel tap, `BaseWAM1D`, `WaveletAttribution1D` (SmoothGrad and IG),
streamed noise, the scaleogram, the filters and `VisualizerWAM1D`, and the
slice on the AudioCNN.

Inputs and SmoothGrad draws come from numpy seeds and go to both packages
(the JAX side averages `BaseWAM1D` passes on x + sigma * z_i; the port takes
the draws through ``noise=``). Models: a tiny conv classifier on the mel
spectrogram (as in tests/test_wam1d.py, with explicit symmetric padding so
both frameworks pad alike), its weights handed across; and the AudioCNN
through `flax_audio_to_torch`. Tolerance: every tap within 1e-4 of its
largest value (float32 gradients in different summation orders agree to
~1e-6 of it).
"""

import zlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wam_tpu import wam1d as jw
from wam_tpu.core import engine as jengine
from wam_tpu.core import estimators as jest
from wam_tpu.models.audio import AudioCNN as JAudioCNN
from wam_tpu.models.audio import bind_audio_inference as jbind_audio
from wam_tpu.ops import melspec as jmel
from wam_tpu.wavelets import transform as jt
from wam_tpu_torch import wam1d as tw
from wam_tpu_torch import wam2d as twam2d
from wam_tpu_torch.core import engine as tengine
from wam_tpu_torch.core import estimators as test_
from wam_tpu_torch.models import audio as taudio
from wam_tpu_torch.models.ingest import flax_audio_to_torch
from wam_tpu_torch.models.toy import toy_conv_model
from wam_tpu_torch.ops import melspec as tmel

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

SR, NFFT, NMELS, WLEN = 8000, 256, 32, 4096
KW = dict(n_mels=NMELS, n_fft=NFFT, sample_rate=SR)
TOL = 1e-4


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _np(t):
    return t.detach().numpy()


def _close(got, want, tol=TOL):
    """Within ``tol`` of the largest reference value."""
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), want, atol=tol * np.abs(want).max(), rtol=0)


@pytest.fixture(scope="module", autouse=True)
def jax_switches():
    """The JAX package's transform and mel switches are module globals that
    other test files of the same process may leave changed: for this module,
    its module fixtures included, the JAX side runs on its conv 1D transform,
    the fft STFT and float32 mel matmuls; the switches are put back after."""
    saved = jt._dwt1_impl, jmel.get_stft_impl(), jmel.get_mel_bf16()
    jt.set_dwt1_impl("conv")
    jmel.set_stft_impl("fft")
    jmel.set_mel_bf16(False)
    yield
    jt.set_dwt1_impl(saved[0])
    jmel.set_stft_impl(saved[1])
    jmel.set_mel_bf16(saved[2])


class Tiny(nn.Module):
    @nn.compact
    def __call__(self, x):  # (B, 1, T, M)
        x = jnp.transpose(x, (0, 2, 3, 1))
        x = nn.relu(nn.Conv(8, (3, 3), strides=(2, 2), padding=1)(x)).mean(axis=(1, 2))
        return nn.Dense(6)(x)


@pytest.fixture(scope="module")
def tiny():
    """The JAX model function and the port's, on the same weights."""
    model = Tiny()
    T = 1 + WLEN // (NFFT // 2)
    p = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, T, NMELS)))["params"]
    conv = torch.nn.Conv2d(1, 8, 3, stride=2, padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.array(p["Conv_0"]["kernel"]).transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.from_numpy(np.array(p["Conv_0"]["bias"])))
    conv.requires_grad_(False)
    dense_w = torch.from_numpy(np.array(p["Dense_0"]["kernel"]))
    dense_b = torch.from_numpy(np.array(p["Dense_0"]["bias"]))

    def tfn(mel):
        return torch.relu(conv(mel)).mean(dim=(2, 3)) @ dense_w + dense_b

    return (lambda mel: model.apply({"params": p}, mel)), tfn


def _waves(*key, n=2):
    return _rng(*key).standard_normal((n, WLEN)).astype(np.float32)


# -- helpers -------------------------------------------------------------------------


def test_normalize_waveforms_list():
    wfs = [np.array([1, 2, 4], dtype=np.int16), np.array([2, 8, 4], dtype=np.int16)]
    out = tw.normalize_waveforms(wfs, device="cpu")
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), np.asarray(jw.normalize_waveforms(wfs)))


def test_scaleogram_matches_jax():
    rng = _rng("scaleo")
    coeffs = [rng.standard_normal((2, n)).astype(np.float32) for n in (5, 5, 9, 17)]
    coeffs[1][1] = 0.0  # an all-zero level keeps its zeros
    want = jw.scaleogram(coeffs, J=3)
    got = tw.scaleogram([torch.from_numpy(c) for c in coeffs], J=3)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# -- the engine's mel tap --------------------------------------------------------------


def test_engine_front_grads_match_jax(tiny):
    """`attribute_with_front_grads`: one backward gives the coefficient and
    the front-output gradients; the reference gets them through a zero tap."""
    jfn, tfn = tiny
    x, y = _waves("engine"), np.array([2, 5])
    jfront = lambda w: jmel.melspectrogram(w, **KW)[:, None]  # noqa: E731
    tfront = lambda w: tmel.melspectrogram(w, **KW)[:, None]  # noqa: E731
    je = jengine.WamEngine(jfn, ndim=1, wavelet="db6", level=3, mode="reflect", front_fn=jfront)
    _, jg, jf = je.attribute_with_front_grads(jnp.asarray(x), jnp.asarray(y))
    te = tengine.WamEngine(tfn, ndim=1, wavelet="db6", level=3, mode="reflect", front_fn=tfront)
    _, tg, tf = te.attribute_with_front_grads(torch.from_numpy(x), torch.from_numpy(y))
    _close(tf, jf)
    assert len(tg) == len(jg) == 4
    for g, w in zip(tg, jg):
        _close(g, w)
    _, plain = te.attribute(torch.from_numpy(x), torch.from_numpy(y))
    for a, b in zip(plain, tg):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="front_fn"):
        tengine.WamEngine(tfn, ndim=1).attribute_with_front_grads(torch.from_numpy(x), None)


# -- BaseWAM1D ---------------------------------------------------------------------------


@pytest.mark.parametrize("wavelet,J,mode", [("db2", 3, "symmetric"), ("db6", 4, "reflect"),
                                            ("haar", 2, "periodic")])
def test_base_wam1d_taps_match_jax(tiny, wavelet, J, mode):
    jfn, tfn = tiny
    x, y = _waves("base", wavelet), np.array([1, 3])
    jm = jw.BaseWAM1D(jfn, wavelet=wavelet, J=J, mode=mode, **KW)
    jmel_g, jcoef = jm(jnp.asarray(x), jnp.asarray(y))
    tm = tw.BaseWAM1D(tfn, wavelet=wavelet, J=J, mode=mode, device="cpu", **KW)
    mel_g, coef = tm(x, y)
    assert tuple(mel_g.shape) == (2, 1 + WLEN // (NFFT // 2), NMELS)
    _close(mel_g, jmel_g)
    for g, w in zip(coef, jcoef):
        _close(g, w)
    # the coefficient entry point (waveform=False) and the filter
    mel_c, coef_c = tm(tm.wavelet_coeffs, y, waveform=False)
    jmel_c, jcoef_c = jm(jm.wavelet_coeffs, jnp.asarray(y), waveform=False)
    _close(mel_c, jmel_c)
    for g, w in zip(coef_c, jcoef_c):
        _close(g, w)
    for eps in (0.3, -1.0):
        _close(tm.filter(eps), jm.filter(eps), tol=1e-5)
    np.testing.assert_allclose(tm.visualize_grad_wam(coef), jm.visualize_grad_wam(jcoef),
                               atol=1e-4)


# -- WaveletAttribution1D ----------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_smooth(tiny):
    """JAX SmoothGrad on handed-over draws: the mean of `BaseWAM1D` passes
    on x + sigma * z_i."""
    jfn, _ = tiny
    x, y = _waves("smooth"), np.array([0, 4])
    z = _rng("smooth-noise").standard_normal((3,) + x.shape).astype(np.float32)
    sigma = np.asarray(jest.noise_sigma(jnp.asarray(x), 0.01)).reshape(-1, 1)
    jm = jw.BaseWAM1D(jfn, wavelet="db6", J=3, mode="reflect", **KW)
    outs = [jm(jnp.asarray(x + zi * sigma), jnp.asarray(y)) for zi in z]
    mel = np.mean([np.asarray(o[0]) for o in outs], axis=0)
    coeffs = [np.mean([np.asarray(o[1][lv]) for o in outs], axis=0) for lv in range(4)]
    return x, y, z, mel, coeffs


@pytest.mark.parametrize("chunk", [None, 2])
def test_smooth_wam1d_matches_jax_with_handed_noise(tiny, jax_smooth, chunk):
    _, tfn = tiny
    x, y, z, want_mel, want_coeffs = jax_smooth
    tm = tw.WaveletAttribution1D(tfn, wavelet="db6", J=3, method="smooth", n_samples=3,
                                 stdev_spread=0.01, sample_batch_size=chunk, device="cpu", **KW)
    mel, coeffs = tm(x, y, noise=torch.from_numpy(z))
    _close(mel, want_mel)
    for g, w in zip(coeffs, want_coeffs):
        _close(g, w)
    assert tm.melspecs is mel and tm.grad_coeffs is coeffs


@pytest.mark.parametrize("chunk", [None, 3])
def test_integrated_wam1d_matches_jax(tiny, chunk):
    """IG against the JAX class (one jitted scan over the path) and against
    the JAX pieces evaluated op by op: the trapezoid (dx=1) over alpha in
    linspace(0, 1, 4) of both taps' gradients, times the input's mel
    spectrogram and coefficients."""
    jfn, tfn = tiny
    x, y = _waves("ig"), np.array([3, 1])
    kw = dict(wavelet="db6", J=3, mode="reflect", method="integratedgrad", n_samples=4, **KW)
    jmel_a, jcoef_a = jw.WaveletAttribution1D(jfn, sample_batch_size=None, **kw)(
        jnp.asarray(x), jnp.asarray(y))
    jm = jw.BaseWAM1D(jfn, wavelet="db6", J=3, mode="reflect", **KW)
    coeffs = jm.engine.decompose(jnp.asarray(x))
    path = [jm([c * a for c in coeffs], jnp.asarray(y), waveform=False)
            for a in np.linspace(0, 1, 4, dtype=np.float32)]
    trap = lambda vs: vs[0] / 2 + vs[1] + vs[2] + vs[3] / 2  # noqa: E731
    eager_mel = np.asarray(jm.compute_melspec(jnp.asarray(x))[:, 0]) * trap([p[0] for p in path])
    eager_coef = [np.asarray(c) * trap([p[1][lv] for p in path]) for lv, c in enumerate(coeffs)]
    tm = tw.WaveletAttribution1D(tfn, sample_batch_size=chunk, device="cpu", **kw)
    mel, coef = tm(x, y)
    for want_mel, want_coef in ((jmel_a, jcoef_a), (eager_mel, eager_coef)):
        _close(mel, want_mel)
        for g, w in zip(coef, want_coef):
            _close(g, w)


# -- streamed noise ------------------------------------------------------------------------


def test_smoothgrad_streams_noise_per_sample():
    """materialize_noise=False: sample i's draw is `sample_noise(seed, i)`
    whatever the chunk, and no (n_samples, *x.shape) buffer is handed in."""
    x = torch.from_numpy(_rng("sg-stream").standard_normal((2, 3, 4)).astype(np.float32))
    sigma = test_.noise_sigma(x, 0.3).reshape(2, 1, 1)
    z = torch.stack([test_.sample_noise(7, i, x.shape, "cpu") for i in range(5)])
    want = torch.tanh(x + z * sigma).pow(2).mean(dim=0)
    for bs in (None, 1, 2, 5):
        got = test_.smoothgrad(lambda v: torch.tanh(v) ** 2, x, n_samples=5, stdev_spread=0.3,
                               batch_size=bs, materialize_noise=False, seed=7)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert torch.equal(test_.sample_noise(7, 3, (4,), "cpu"), test_.sample_noise(7, 3, (4,), "cpu"))
    assert not torch.equal(test_.sample_noise(7, 3, (4,), "cpu"),
                           test_.sample_noise(8, 3, (4,), "cpu"))
    with pytest.raises(ValueError, match="materialize_noise"):
        test_.smoothgrad(lambda v: v, x, n_samples=5, stdev_spread=0.3, noise=z,
                         materialize_noise=False)


def test_stream_noise_1d_does_not_depend_on_the_chunk(tiny):
    _, tfn = tiny
    x, y = _waves("stream1d"), np.array([0, 1])
    kw = dict(wavelet="db6", J=3, n_samples=5, stdev_spread=0.01, device="cpu", **KW)
    runs = [tw.WaveletAttribution1D(tfn, stream_noise=True, sample_batch_size=bs, **kw)(x, y)
            for bs in (None, 1, 2, "auto")]
    for mel, coeffs in runs[1:]:
        _close(mel, _np(runs[0][0]), tol=1e-6)
        for g, w in zip(coeffs, runs[0][1]):
            _close(g, _np(w), tol=1e-6)
    materialized = tw.WaveletAttribution1D(tfn, **kw)(x, y)
    assert not torch.allclose(materialized[0], runs[0][0])
    with pytest.raises(ValueError, match="materialize_noise"):
        tw.WaveletAttribution1D(tfn, stream_noise=True, **kw)(
            x, y, noise=torch.zeros((5,) + x.shape))


def test_stream_noise_2d_does_not_depend_on_the_chunk():
    toy = toy_conv_model(device="cpu")
    x = torch.from_numpy(_rng("stream2d").standard_normal((2, 1, 24, 24)).astype(np.float32))
    y = torch.tensor([0, 3])
    kw = dict(wavelet="db4", J=2, n_samples=5, device="cpu")
    fn = lambda v: toy(v[:, 0])  # noqa: E731
    runs = [twam2d.WaveletAttribution2D(fn, stream_noise=True, sample_batch_size=bs, **kw)(x, y)
            for bs in (None, 2, 3)]
    for r in runs[1:]:
        torch.testing.assert_close(r, runs[0], atol=1e-6, rtol=0)
    materialized = twam2d.WaveletAttribution2D(fn, **kw)(x, y)
    assert not torch.allclose(materialized, runs[0])
    # "auto" materializes until a measured rule for the card exists
    assert torch.equal(twam2d.WaveletAttribution2D(fn, stream_noise="auto", **kw)(x, y),
                       materialized)
    with pytest.raises(ValueError, match="stream_noise"):
        twam2d.WaveletAttribution2D(fn, stream_noise="yes", **kw)


# -- the visualizer --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def visualizers(tiny):
    jfn, tfn = tiny
    x, y = _waves("viz"), np.array([0, 1])
    z = _rng("viz-noise").standard_normal((2,) + x.shape).astype(np.float32)
    kw = dict(wavelet="haar", J=2, method="smooth", n_samples=2, **KW)
    jv = jw.VisualizerWAM1D(jfn, x, **kw)
    tv = tw.VisualizerWAM1D(tfn, x, device="cpu", **kw)
    mel, coeffs = tv(x, y, noise=torch.from_numpy(z))
    return jv, tv, x, _np(mel), [_np(c) for c in coeffs]


@pytest.mark.parametrize("method", ["ht", "st", "modulation"])
def test_visualizer_wavelet_filters_match_jax(visualizers, method):
    jv, tv, _, _, coeffs = visualizers
    src, filt = tv.filtered_spectrogram_from_wavelet_coefficients(coeffs, method, EPS=0.3)
    jsrc, jfilt = jv.filtered_spectrogram_from_wavelet_coefficients(coeffs, method, EPS=0.3)
    np.testing.assert_allclose(src, jsrc, atol=1e-4 * np.abs(jsrc).max(), rtol=0)
    np.testing.assert_allclose(filt, jfilt, atol=1e-4 * np.abs(jfilt).max(), rtol=0)


@pytest.mark.parametrize("method", ["ht", "modulation"])
def test_visualizer_mel_filters_match_jax(visualizers, method):
    jv, tv, x, mel, _ = visualizers
    power, jpower = tv.compute_melspec_power(x), jv.compute_melspec_power(x)
    assert power.shape == (2, NMELS, 1 + WLEN // (NFFT // 2))
    np.testing.assert_allclose(power, jpower, atol=1e-5 * np.abs(jpower).max(), rtol=0)
    filt = tv.filter_melspec(jpower, mel, method, EPS=0.2)
    np.testing.assert_allclose(filt, jv.filter_melspec(jpower, mel, method, EPS=0.2), rtol=1e-6)
    src, out = tv.filtered_spectrogram_from_melspec(mel, method, EPS=0.2)
    jsrc, jout = jv.filtered_spectrogram_from_melspec(mel, method, EPS=0.2)
    np.testing.assert_allclose(src, jsrc, atol=1e-4 * np.abs(jsrc).max(), rtol=0)
    np.testing.assert_allclose(out, jout, atol=1e-4 * np.abs(jout).max(), rtol=0)
    with pytest.raises(ValueError, match="filtering"):
        tv.filter_melspec(jpower, mel, "st")


def test_wam1d_rejects_unported_options(tiny):
    _, tfn = tiny
    # mesh= is ported (tests/test_torch_seq_estimators.py): a meshed explainer
    # refuses serve_entry, batch_axis needs a mesh
    from wam_tpu_torch.parallel import make_mesh

    meshed = tw.WaveletAttribution1D(tfn, mesh=make_mesh({"data": 2}, ["cpu"] * 2), device="cpu")
    with pytest.raises(ValueError, match="serve_entry"):
        meshed.serve_entry()
    with pytest.raises(ValueError, match="batch_axis= requires mesh="):
        tw.WaveletAttribution1D(tfn, batch_axis="data", device="cpu")
    m = tw.WaveletAttribution1D(tfn, device="cpu", **KW)
    assert callable(m.serve_entry())  # ported (tests/test_torch_serve.py), and the AOT key
    with pytest.warns(UserWarning, match="no compiled step"):  # eager, no programs
        assert m.serve_entry(aot_key="k").wam_aot_fns == []
    with pytest.raises(ValueError):
        tw.WaveletAttribution1D(tfn, method="gradcam", device="cpu")
    with pytest.raises(ValueError):
        tw.WaveletAttribution1D(tfn, sample_batch_size="false", device="cpu")
    ig = tw.WaveletAttribution1D(tfn, method="integratedgrad", device="cpu", **KW)
    with pytest.raises(ValueError, match="smooth"):
        ig(_waves("rej"), [0, 1], noise=torch.zeros(25, 2, WLEN))


# -- the slice: the AudioCNN at the shortest length it takes --------------------------------

SLICE_KW = dict(wavelet="db6", J=5, mode="reflect", n_mels=128, n_fft=1024, sample_rate=44100)


@pytest.fixture(scope="module")
def audio_slice():
    """The audio path at a small size: db6, J=5, reflect, the mel front end
    at n_fft 1024, hop 512, 128 mels, 44.1 kHz, the 50-class AudioCNN on JAX
    weights, 2 waveforms of 65,536 samples (129 frames, the fewest that
    survive the six pools), 2 handed-over SmoothGrad draws."""
    model = JAudioCNN(num_classes=50)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 1, 129, 128)))
    rng = _rng("audio-slice")
    x = (0.1 * rng.standard_normal((2, 65536))).astype(np.float32)
    z = rng.standard_normal((2, 2, 65536)).astype(np.float32)
    sigma = np.asarray(jest.noise_sigma(jnp.asarray(x), 0.001)).reshape(-1, 1)
    return model, variables, x, z, sigma, np.array([7, 31])


def test_audio_slice_taps_match_jax_in_float64(audio_slice):
    """Both packages' per-sample taps (the JAX `_tap_grads`; the port's,
    two samples stacked in one model call) in float64, where no ReLU gate
    or max-pool lies within rounding of flipping: every tap within 1e-9 of
    its largest value."""
    model, variables, x, z, sigma, y = audio_slice
    noisy = (x[None] + z * sigma[None]).astype(np.float64)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        jm = jw.WaveletAttribution1D(lambda mel: model.apply(v64, mel), **SLICE_KW)
        taps = jax.jit(jm._tap_grads)
        want = [taps(jnp.asarray(n), jnp.asarray(y)) for n in noisy]
        want = [[np.asarray(w[0]) for w in want]] + [
            [np.asarray(w[1][lv]) for w in want] for lv in range(6)]
    fn = taudio.bind_audio_inference(taudio.AudioCNN(num_classes=50).double(),
                                     flax_audio_to_torch(variables), device="cpu")
    tm = tw.WaveletAttribution1D(fn, device="cpu", **SLICE_KW)
    flat = torch.from_numpy(noisy).reshape(-1, 65536)
    with torch.no_grad():
        coeffs = tm.engine.decompose(flat)
    got = tm._tap_grads(coeffs, torch.from_numpy(y), 65536, 2)
    assert got[0].dtype == torch.float64
    for g, w in zip(got, want):
        _close(g, np.stack(w), tol=1e-9)


def test_audio_slice_matches_jax_in_float32(audio_slice):
    """`WaveletAttribution1D` SmoothGrad end to end in float32 against the
    mean of the JAX taps on the same draws. In float32 the two packages'
    summation orders flip a ReLU gate of the AudioCNN for one of the two
    draws (measured when this test was written: the other draw's taps agree
    to 2e-5 of the max, the flipped draw's mel tap moves by 10% of its max
    at 193 of 33,024 entries, cosine 0.99997, cD3's cosine 0.99986), so the
    bound here is cosine >= 0.999 and max abs <= 0.2 x the largest value;
    the float64 test above holds the same chain to 1e-9."""
    model, variables, x, z, sigma, y = audio_slice
    jm = jw.WaveletAttribution1D(jbind_audio(model, variables), **SLICE_KW)
    taps = jax.jit(jm._tap_grads)
    outs = [taps(jnp.asarray(x + zi * sigma), jnp.asarray(y)) for zi in z]
    want = [np.mean([np.asarray(o[0]) for o in outs], axis=0)] + [
        np.mean([np.asarray(o[1][lv]) for o in outs], axis=0) for lv in range(6)]
    fn = taudio.bind_audio_inference(taudio.AudioCNN(num_classes=50),
                                     flax_audio_to_torch(variables), device="cpu")
    tm = tw.WaveletAttribution1D(fn, method="smooth", n_samples=2, stdev_spread=0.001,
                                 sample_batch_size=2, device="cpu", **SLICE_KW)
    mel, coeffs = tm(x, y, noise=torch.from_numpy(z))
    assert tuple(mel.shape) == (2, 129, 128)
    assert [c.shape[-1] for c in coeffs] == [2058, 2058, 4106, 8201, 16392, 32773]
    for g, w in zip([mel, *coeffs], want):
        _close(g, w, tol=0.2)
        a, b = _np(g).ravel().astype(np.float64), w.ravel().astype(np.float64)
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.999


# -- ROADMAP queue 3 entry B: the bf16 arms against their own float32 ------------------------


def _mel_cosine(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("arm, stft", [("model", "fft"), ("mel", "fft"), ("mel", "matmul")])
def test_bf16_arms_move_both_packages_alike(audio_slice, arm, stft):
    """Queue 3 entry B: on the card the bf16 AudioCNN's mel attribution reads
    cosine 0.93 to float32. Each package's bf16 arm against its OWN float32
    on the same AudioCNN, weights, waveforms and handed-over draws:

    - ``model`` (``compute_dtype=bfloat16``, entry B's arm): cosine 0.94505
      (JAX) and 0.94496 (port) when this test was written, and 0.9949 from
      one package's bf16 map to the other's: the packages move alike, so
      the drop is a property of running the AudioCNN in bf16, not a port
      fault;
    - ``mel`` (`resolve_precision(mel_bf16=True)`): with the fft STFT only
      the filterbank matmul takes bf16: 0.99269 (JAX) against 0.98878
      (port) before the port's bf16 matmuls kept a float32 output as the
      reference's do (one rounding to bf16 more), 0.99296 after and 0.9998
      between the packages; with the matmul STFT the DFT takes bf16 too:
      0.98141 (JAX), 0.98218 (port), 0.9993 between them (float32 on that
      form: 0.99969 between the packages, a gate flip).
    """
    model, variables, x, z, sigma, y = audio_slice
    cdt = arm == "model"
    maps = {}
    saved = jmel.get_stft_impl(), tmel.get_stft_impl()
    jmel.set_stft_impl(stft)
    tmel.set_stft_impl(stft)
    try:
        for bf in (False, True):
            mel_bf16 = bf and arm == "mel"
            jmel.set_mel_bf16(mel_bf16)
            tmel.set_mel_bf16(mel_bf16)
            jfn = jbind_audio(model, variables, compute_dtype=jnp.bfloat16 if bf and cdt else None)
            taps = jax.jit(jw.WaveletAttribution1D(jfn, **SLICE_KW)._tap_grads)
            jmap = np.mean([np.asarray(taps(jnp.asarray(x + zi * sigma), jnp.asarray(y))[0])
                            for zi in z], axis=0)
            tfn = taudio.bind_audio_inference(
                taudio.AudioCNN(num_classes=50), flax_audio_to_torch(variables),
                compute_dtype=torch.bfloat16 if bf and cdt else None, device="cpu")
            tm = tw.WaveletAttribution1D(tfn, method="smooth", n_samples=2, stdev_spread=0.001,
                                         sample_batch_size=2, device="cpu", **SLICE_KW)
            maps[bf] = jmap, _np(tm(x, y, noise=torch.from_numpy(z))[0].float())
    finally:
        jmel.set_mel_bf16(False)
        tmel.set_mel_bf16(False)
        jmel.set_stft_impl(saved[0])
        tmel.set_stft_impl(saved[1])
    cos_jax = _mel_cosine(maps[True][0], maps[False][0])
    cos_port = _mel_cosine(maps[True][1], maps[False][1])
    cross = _mel_cosine(maps[True][0], maps[True][1])
    assert _mel_cosine(maps[False][0], maps[False][1]) >= 0.999
    assert abs(cos_port - cos_jax) <= 2e-3  # the two packages move alike
    if arm == "model":
        assert cos_jax < 0.97 and cos_port < 0.97 and cross >= 0.99
    else:
        assert cross >= 0.999
        if stft == "fft":  # the filterbank alone: inside the reference's 0.99 gate
            assert cos_jax >= 0.99 and cos_port >= 0.99
