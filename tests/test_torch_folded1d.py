"""The port's polyphase-folded 1D transform (`wam_tpu_torch.wavelets.folded1d`)
against the reference's (`wam_tpu.wavelets.folded1d`), and the 1D impl knob
(`set_dwt1_impl`: "auto", "conv", "folded", "folded_nhc").

- `fold_analysis1d` / `fold_synthesis1d` against the JAX ones over the
  reference tests' wavelets, modes and lengths, float32 within 1e-5 of the
  largest value. In float64 the port's fold is held to the JAX conv form
  within 1e-9 of the max: the reference stores its fold matrices in float32
  and casts them, so its own float64 fold differs from its conv form by the
  taps' float32 rounding (~1e-7 of the max), and the port's float64 fold is
  held to it at 1e-6.
- the "nch" and "nhc" layouts against each other, and the fold's gradients
  (the adjoint maps in the autograd Functions) against the conv form's and
  against JAX's VJP of its fold.
- the 1D transform, its multi-level forms and a small WAM-1D SmoothGrad under
  every knob value, against the reference under the same value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wam_tpu import wam1d as jw
from wam_tpu.core import estimators as jest
from wam_tpu.ops import melspec as jmel
from wam_tpu.wavelets import folded1d as jf
from wam_tpu.wavelets import transform as jt
from wam_tpu.wavelets.filters import build_wavelet as jbuild
from wam_tpu_torch import wam1d as tw
from wam_tpu_torch.wavelets import folded1d as tf
from wam_tpu_torch.wavelets import transform as tt
from wam_tpu_torch.wavelets.filters import build_wavelet as tbuild

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

IMPLS = ("auto", "conv", "folded", "folded_nhc")
TOL = 1e-5


@pytest.fixture(autouse=True)
def knobs():
    """Both packages' 1D knobs (and the JAX mel switches the WAM-1D case
    reads) are module globals: each test starts from "auto" / "conv" and
    puts them back."""
    saved = jt._dwt1_impl, tt._dwt1_impl, jmel.get_stft_impl(), jmel.get_mel_bf16()
    jmel.set_stft_impl("fft")
    jmel.set_mel_bf16(False)
    yield
    jt.set_dwt1_impl(saved[0])
    tt.set_dwt1_impl(saved[1])
    jmel.set_stft_impl(saved[2])
    jmel.set_mel_bf16(saved[3])


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0)


def _padded(x: np.ndarray, L: int, mode: str) -> np.ndarray:
    """The analysis input `fold_analysis1d` takes: pad(x, L - 1)[..., 1:]."""
    np_mode = {"symmetric": "symmetric", "reflect": "reflect", "zero": "constant"}[mode]
    return np.pad(x, ((0, 0), (L - 1, L - 1)), mode=np_mode)[..., 1:]


@pytest.mark.parametrize("layout", ["nch", "nhc"])
@pytest.mark.parametrize("wavelet", ["haar", "db2", "db6", "sym3"])
@pytest.mark.parametrize("mode", ["symmetric", "reflect", "zero"])
@pytest.mark.parametrize("n", [4096, 5003, 8192])
def test_fold_analysis_matches_jax(layout, wavelet, mode, n):
    L = tbuild(wavelet).filt_len
    x = np.random.default_rng(n + L).standard_normal((2, n)).astype(np.float32)
    xp = _padded(x, L, mode)
    n_out = (n + L - 1) // 2
    want = jf.fold_analysis1d(jnp.asarray(xp), jbuild(wavelet), n_out, layout=layout)
    got = tf.fold_analysis1d(torch.from_numpy(xp), tbuild(wavelet), n_out, layout=layout)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 2, n_out)
    _close(got, want)


@pytest.mark.parametrize("layout", ["nch", "nhc"])
@pytest.mark.parametrize("wavelet", ["haar", "db2", "db6", "sym3"])
@pytest.mark.parametrize("n", [2048, 2502, 4096])
def test_fold_synthesis_matches_jax(layout, wavelet, n):
    sub = np.random.default_rng(n).standard_normal((3, 2, n)).astype(np.float32)
    want = jf.fold_synthesis1d(jnp.asarray(sub), jbuild(wavelet), layout=layout)
    got = tf.fold_synthesis1d(torch.from_numpy(sub), tbuild(wavelet), layout=layout)
    assert tuple(got.shape) == (3, 2 * n - tbuild(wavelet).filt_len + 2)
    _close(got, want)


@pytest.mark.parametrize("wavelet", ["db2", "db6"])
def test_float64_fold_is_the_conv_map(wavelet):
    """Float64: the port's fold equals the JAX conv form within 1e-9 of the
    max in both directions; the reference's own fold rounds its taps to
    float32, so the port is held to it at 1e-6."""
    wav = tbuild(wavelet)
    L, n = wav.filt_len, 5003
    x = np.random.default_rng(1).standard_normal((2, n))
    with jax.enable_x64(True):
        jt.set_dwt1_impl("conv")
        ja, jd = jt.dwt(jnp.asarray(x), wavelet, "symmetric")
        want_a = np.stack([np.asarray(ja), np.asarray(jd)], axis=-2)
        want_s = np.asarray(jt.idwt(ja, jd, wavelet))
        jfold = np.asarray(jf.fold_analysis1d(jnp.asarray(_padded(x, L, "symmetric")),
                                              jbuild(wavelet), (n + L - 1) // 2))
    for layout in ("nch", "nhc"):
        got = tf.fold_analysis1d(torch.from_numpy(_padded(x, L, "symmetric")), wav,
                                 (n + L - 1) // 2, layout=layout)
        assert got.dtype == torch.float64
        _close(got, want_a, 1e-9)
        _close(got, jfold, 1e-6)
        rec = tf.fold_synthesis1d(torch.from_numpy(want_a), wav, layout=layout)
        _close(rec, want_s, 1e-9)
    assert np.abs(jfold - want_a).max() > 1e-9 * np.abs(want_a).max()  # the reference's rounding


@pytest.mark.parametrize("wavelet", ["haar", "db6"])
@pytest.mark.parametrize("n", [4096, 5003])
def test_nch_and_nhc_layouts_agree(wavelet, n):
    tt.set_dwt1_impl("folded")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, n)).astype(np.float32))
    a_ref, d_ref = tt.dwt(x, wavelet, "symmetric")
    rec_ref = tt.idwt(a_ref, d_ref, wavelet, out_len=n)
    tt.set_dwt1_impl("folded_nhc")
    a, d = tt.dwt(x, wavelet, "symmetric")
    rec = tt.idwt(a, d, wavelet, out_len=n)
    rt = tt.waverec(tt.wavedec(x, wavelet, 3, "symmetric"), wavelet)[..., :n]
    for got, want in ((a, a_ref), (d, d_ref), (rec, rec_ref)):
        _close(got, want.numpy(), 1e-6)
    _close(rt, x.numpy(), 2e-4)


@pytest.mark.parametrize("layout", ["nch", "nhc"])
@pytest.mark.parametrize("wavelet", ["db2", "db6"])
def test_fold_gradients_match_the_conv_form_and_jax(layout, wavelet):
    """The VJP of dwt -> idwt through the fold equals the conv form's (the
    port's autograd Functions) and JAX's VJP of its own fold; gradcheck on
    a short float64 signal checks each adjoint exactly."""
    n = 4096
    x = np.random.default_rng(2).standard_normal((1, n)).astype(np.float32)
    weights = np.cos(np.arange(n)).astype(np.float32)
    impl = {"nch": "folded", "nhc": "folded_nhc"}[layout]

    def tloss(v):
        cA, cD = tt.dwt(v, wavelet, "symmetric")
        return (tt.idwt(cA, cD, wavelet, out_len=n) * torch.from_numpy(weights)).sum()

    def jloss(v):
        cA, cD = jt.dwt(v, wavelet, "symmetric")
        return (jt.idwt(cA, cD, wavelet, out_len=n) * jnp.asarray(weights)).sum()

    grads = {}
    for name in ("conv", impl):
        tt.set_dwt1_impl(name)
        v = torch.from_numpy(x).requires_grad_(True)
        tloss(v).backward()
        grads[name] = v.grad
    jt.set_dwt1_impl(impl)
    want = jax.grad(jloss)(jnp.asarray(x))
    _close(grads[impl], grads["conv"].numpy())
    _close(grads[impl], want)

    wav = tbuild(wavelet)
    xp = torch.randn(2, 300, dtype=torch.float64, requires_grad=True)
    sub = torch.randn(2, 2, 150, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda t: tf.fold_analysis1d(t, wav, 151, P=8, layout=layout),
                                    (xp,))
    assert torch.autograd.gradcheck(lambda t: tf.fold_synthesis1d(t, wav, P=8, layout=layout),
                                    (sub,))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("wavelet,mode", [("haar", "symmetric"), ("db6", "reflect"),
                                          ("sym3", "zero")])
def test_the_1d_transform_under_each_knob_value_matches_the_reference(impl, wavelet, mode):
    n = 5003
    x = np.random.default_rng(4).standard_normal((2, n)).astype(np.float32)
    jt.set_dwt1_impl(impl)
    tt.set_dwt1_impl(impl)
    assert tt._dwt1_impl == jt._dwt1_impl == impl
    ja, jd = jt.dwt(jnp.asarray(x), wavelet, mode)
    ta, td = tt.dwt(torch.from_numpy(x), wavelet, mode)
    _close(ta, ja)
    _close(td, jd)
    _close(tt.idwt(ta, td, wavelet, out_len=n), jt.idwt(ja, jd, wavelet, out_len=n))
    jc = jt.wavedec(jnp.asarray(x), wavelet, 3, mode)
    tc = tt.wavedec(torch.from_numpy(x), wavelet, 3, mode)
    for got, want in zip(tc, jc):
        _close(got, want)
    _close(tt.waverec(tc, wavelet), jt.waverec(jc, wavelet))


def test_the_knob_takes_the_reference_names_and_reads_its_env(monkeypatch):
    import importlib

    for name in IMPLS:
        tt.set_dwt1_impl(name)
        assert tt._dwt1_impl == name
    with pytest.raises(ValueError) as terr:
        tt.set_dwt1_impl("bogus")
    with pytest.raises(ValueError) as jerr:
        jt.set_dwt1_impl("bogus")
    assert str(terr.value) == str(jerr.value)
    tt.set_dwt1_impl("auto")
    assert tt._fold1d_layout() is None  # "auto" is the conv form on every device
    monkeypatch.setenv("WAM_TORCH_DWT1_IMPL", "folded_nhc")
    fresh = importlib.util.module_from_spec(importlib.util.find_spec(tt.__name__))
    fresh.__spec__.loader.exec_module(fresh)
    assert fresh._dwt1_impl == "folded_nhc" and fresh._fold1d_layout() == "nhc"


SR, NFFT, NMELS, WLEN = 8000, 256, 32, 4096
KW = dict(n_mels=NMELS, n_fft=NFFT, sample_rate=SR)


@pytest.fixture(scope="module")
def tiny():
    """A conv classifier on the mel spectrogram in both packages, the same
    weights (the JAX side a closure over numpy arrays)."""
    rng = np.random.default_rng(9)
    w = (0.3 * rng.standard_normal((8, 1, 3, 3))).astype(np.float32)
    b = (0.1 * rng.standard_normal(8)).astype(np.float32)
    dense = (0.3 * rng.standard_normal((8, 6))).astype(np.float32)

    def jfn(mel):  # (B, 1, T, M)
        out = jax.lax.conv_general_dilated(mel, jnp.asarray(w), (2, 2), ((1, 1), (1, 1)),
                                           precision=jax.lax.Precision.HIGHEST)
        return jnp.maximum(out + jnp.asarray(b)[None, :, None, None], 0).mean(axis=(2, 3)) \
            @ jnp.asarray(dense)

    def tfn(mel):
        out = torch.nn.functional.conv2d(mel, torch.from_numpy(w), torch.from_numpy(b), stride=2,
                                         padding=1)
        return torch.relu(out).mean(dim=(2, 3)) @ torch.from_numpy(dense)

    return jfn, tfn


@pytest.mark.parametrize("impl", IMPLS)
def test_wam1d_smoothgrad_under_each_knob_value_matches_the_reference(tiny, impl):
    """WAM-1D SmoothGrad (db6, J=3, 3 samples) with the draws handed to both
    sides: the mel tap and every coefficient level within 1e-4 of the max."""
    jfn, tfn = tiny
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, WLEN)).astype(np.float32)
    y = np.array([0, 4])
    z = rng.standard_normal((3,) + x.shape).astype(np.float32)
    jt.set_dwt1_impl(impl)
    tt.set_dwt1_impl(impl)
    sigma = np.asarray(jest.noise_sigma(jnp.asarray(x), 0.01)).reshape(-1, 1)
    jm = jw.BaseWAM1D(jfn, wavelet="db6", J=3, mode="reflect", **KW)
    outs = [jm(jnp.asarray(x + zi * sigma), jnp.asarray(y)) for zi in z]
    want_mel = np.mean([np.asarray(o[0]) for o in outs], axis=0)
    want = [np.mean([np.asarray(o[1][lv]) for o in outs], axis=0) for lv in range(4)]
    tm = tw.WaveletAttribution1D(tfn, wavelet="db6", J=3, method="smooth", n_samples=3,
                                 stdev_spread=0.01, device="cpu", **KW)
    mel, coeffs = tm(x, y, noise=torch.from_numpy(z))
    _close(mel, want_mel, 1e-4)
    for g, w in zip(coeffs, want):
        _close(g, w, 1e-4)
