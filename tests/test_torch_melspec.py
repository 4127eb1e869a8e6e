"""Parity of the PyTorch port's mel front end (`wam_tpu_torch.ops.melspec`)
with the JAX package's: the filterbank, the power spectrogram in both STFT
forms, the dB mel spectrogram, its gradient with respect to the waveform,
the bf16 chain, the global switches and the host-side mel inversion.

Inputs are made with numpy from a seed. Tolerances: the filterbank is the
same numpy code (equal); the power spectra agree to <= 1e-5 of each frame's
largest value and the dB spectrogram to <= 1e-3 dB (float32 FFTs and DFT
matmuls in different summation orders); gradients to <= 1e-4 of the largest.
The bf16 chain is held to the reference's own gate: WAM-1D attribution
cosine >= 0.99 to float32 through a nonlinear head.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wam_tpu.ops import melspec as jm
from wam_tpu.wam1d import BaseWAM1D as JBaseWAM1D
from wam_tpu_torch.ops import melspec as tm
from wam_tpu_torch.wam1d import BaseWAM1D

IMPLS = ["fft", "matmul"]


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(autouse=True)
def mel_switches():
    """Both packages' STFT and bf16 switches are module globals: each test
    starts from the defaults ("auto", float32 matmuls), whatever another
    test file of the process left, and they are put back after it."""
    saved = jm.get_stft_impl(), jm.get_mel_bf16(), tm.get_stft_impl(), tm.get_mel_bf16()
    for mod in (jm, tm):
        mod.set_stft_impl("auto")
        mod.set_mel_bf16(False)
    yield
    jm.set_stft_impl(saved[0])
    jm.set_mel_bf16(saved[1])
    tm.set_stft_impl(saved[2])
    tm.set_mel_bf16(saved[3])


@pytest.mark.parametrize("args", [(513, 128, 44100), (129, 32, 8000), (257, 64, 16000, 50.0, 7000.0)])
def test_mel_filterbank_equal(args):
    np.testing.assert_array_equal(tm.mel_filterbank(*args), jm.mel_filterbank(*args))


@pytest.mark.parametrize("n_fft,hop,center", [(256, None, True), (256, 64, True), (256, 100, True),
                                              (512, None, False)])
@pytest.mark.parametrize("impl", IMPLS)
def test_stft_power_matches_jax(impl, n_fft, hop, center):
    """Both STFT forms, hops that divide n_fft (the reference's block
    framing) and one that does not (its gather), centred or not."""
    x = _rng("stft", n_fft, hop).standard_normal((2, 3000)).astype(np.float32)
    want = np.asarray(jm.stft_power(jnp.asarray(x), n_fft=n_fft, hop=hop, center=center,
                                    impl=impl))
    got = _np(tm.stft_power(torch.from_numpy(x), n_fft=n_fft, hop=hop, center=center, impl=impl))
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= 1e-5 * want.max(axis=-1, keepdims=True))


@pytest.mark.parametrize("impl", IMPLS)
def test_melspectrogram_db_matches_jax(impl):
    x = _rng("mel").standard_normal((2, 16384)).astype(np.float32)
    kw = dict(sample_rate=44100, n_fft=1024, n_mels=128, impl=impl)
    want = np.asarray(jm.melspectrogram(jnp.asarray(x), **kw))
    got = _np(tm.melspectrogram(torch.from_numpy(x), **kw))
    assert got.shape == want.shape == (2, 33, 128)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    want = np.asarray(jm.melspectrogram(jnp.asarray(x), to_db=False, **kw))
    got = _np(tm.melspectrogram(torch.from_numpy(x), to_db=False, **kw))
    assert np.all(np.abs(got - want) <= 1e-5 * want.max(axis=-1, keepdims=True))


@pytest.mark.parametrize("impl", IMPLS)
def test_melspectrogram_gradient_matches_jax(impl):
    """The gradient of a nonlinear scalar of the dB mel spectrogram with
    respect to the waveform: the power as re^2 + im^2 and the framing view
    carry the same VJP as the reference's |rfft|^2 and block framing."""
    import jax

    rng = _rng("melgrad", impl)
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    w = rng.standard_normal((2, 33, 32)).astype(np.float32)
    kw = dict(sample_rate=8000, n_fft=256, n_mels=32, impl=impl)
    want = np.asarray(jax.grad(
        lambda v: (jnp.tanh(jm.melspectrogram(v, **kw) / 30.0) * w).sum())(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (torch.tanh(tm.melspectrogram(xt, **kw) / 30.0) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(xt.grad), want, atol=1e-4 * np.abs(want).max(), rtol=0)


def test_power_gradient_is_finite_at_silence():
    """re^2 + im^2 differentiates at a zero spectrum, where |.|^2 through
    abs() would give NaN."""
    x = torch.zeros(1, 1024, requires_grad=True)
    tm.stft_power(x, n_fft=256, impl="fft").sum().backward()
    assert bool(torch.isfinite(x.grad).all())


def test_auto_is_fft_and_switches_validate():
    x = torch.from_numpy(_rng("auto").standard_normal((1, 2048)).astype(np.float32))
    tm.set_stft_impl("auto")
    assert tm.get_stft_impl() == "auto"
    assert torch.equal(tm.stft_power(x, n_fft=256), tm.stft_power(x, n_fft=256, impl="fft"))
    tm.set_stft_impl("matmul")
    assert torch.equal(tm.stft_power(x, n_fft=256), tm.stft_power(x, n_fft=256, impl="matmul"))
    with pytest.raises(ValueError, match="impl"):
        tm.set_stft_impl("dft")
    with pytest.raises(ValueError, match="impl"):
        tm.stft_power(x, impl="dft")


def test_bf16_flag_per_call_beats_global():
    x = torch.from_numpy(_rng("bf16flag").standard_normal((1, 2048)).astype(np.float32))
    kw = dict(n_fft=256, n_mels=16, impl="matmul")
    base = tm.melspectrogram(x, **kw)
    tm.set_mel_bf16(True)
    assert tm.get_mel_bf16() is True
    bf = tm.melspectrogram(x, **kw)
    assert bf.dtype == torch.float32 and not torch.equal(bf, base)
    assert torch.equal(tm.melspectrogram(x, bf16=False, **kw), base)
    tm.set_mel_bf16(False)
    assert torch.equal(tm.melspectrogram(x, bf16=True, **kw), bf)


@pytest.mark.parametrize("impl", IMPLS)
def test_bf16_mel_chain_attribution_cosine(impl):
    """The reference's gate for the bf16 mel chain (tests/test_precision.py):
    WAM-1D mel attribution through a NONLINEAR head, bf16 against float32,
    cosine >= 0.99, here against the port's float32 and the JAX package's.
    The port's bf16 matmuls round their outputs to bf16 (the reference's
    accumulate to float32 out), one rounding more, inside the same gate."""
    rng = _rng("bf16gate")
    wave = rng.standard_normal((2, 4096)).astype(np.float32)
    head = rng.standard_normal((16, 4)).astype(np.float32)
    y = np.array([0, 1])
    kw = dict(wavelet="haar", J=2, n_mels=16, n_fft=256)
    jattr, _ = JBaseWAM1D(lambda mel: jnp.tanh(mel / 30.0).mean(axis=2)[:, 0, :] @ head, **kw)(
        jnp.asarray(wave), jnp.asarray(y))
    wam = BaseWAM1D(lambda mel: torch.tanh(mel / 30.0).mean(dim=2)[:, 0, :] @ torch.from_numpy(head),
                    device="cpu", **kw)
    tm.set_stft_impl(impl)
    attr = {}
    for bf in (False, True):
        tm.set_mel_bf16(bf)
        attr[bf] = _np(wam(wave, y)[0]).ravel().astype(np.float64)
    ref = np.asarray(jattr, np.float64).ravel()
    for other in (attr[False], ref):
        cos = attr[True] @ other / (np.linalg.norm(attr[True]) * np.linalg.norm(other))
        assert cos >= 0.99
    assert np.any(attr[True] != attr[False])
    np.testing.assert_allclose(attr[False], ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


def test_mel_to_stft_magnitude_matches_jax():
    mel = np.abs(_rng("nnls").standard_normal((3, 20, 32))).astype(np.float32)
    want = jm.mel_to_stft_magnitude(mel, 8000, 256, 32)
    got = tm.mel_to_stft_magnitude(mel, 8000, 256, 32)
    assert got.shape == want.shape == (3, 20, 129)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
