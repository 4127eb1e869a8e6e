"""Parity of the port's channel-last path with the JAX package: the NHWC
transforms (`wavelets.nhwc`), `WamEngine(channel_last=True)`, the packing
with ``channel_axis=-1``, and `WaveletAttribution2D(model_layout="nhwc")`
SmoothGrad and IG; and the NHWC path against the port's own NCHW path.

Inputs are made with numpy from a seed. The model is a small 3-channel
conv classifier written in both packages (one SAME 3x3 conv, tanh, global
mean): smooth, so the mosaics agree to float32 summation order. Tolerances:
transforms and leaves 1e-5 of the larger of 1 and the largest value,
mosaics 1e-5 of their largest value; NHWC against NCHW in the port, on
ResNet-18 with the same weights, 1e-5 of the largest value as well.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from wam_tpu import wam2d as jwam
from wam_tpu.core import engine as jengine
from wam_tpu.core import estimators as jest
from wam_tpu.ops import packing2d as jpack
from wam_tpu.wavelets import nhwc as jn
from wam_tpu.wavelets import transform as jt
from wam_tpu_torch import wam2d as twam
from wam_tpu_torch.core import engine as tengine
from wam_tpu_torch.models import resnet as tres
from wam_tpu_torch.ops import packing2d as tpack
from wam_tpu_torch.wavelets import nhwc as tn
from wam_tpu_torch.wavelets import transform as tt

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

TOL = 1e-5
MODES = ["reflect", "symmetric", "zero", "constant", "periodic"]


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _close(got, want, what: str, scale: float | None = None):
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = TOL * (max(1.0, np.abs(want).max()) if scale is None else scale)
    np.testing.assert_allclose(got, want, atol=bound, rtol=0, err_msg=what)


def _leaves(coeffs) -> list:
    out = [coeffs[0]]
    for det in coeffs[1:]:
        out.extend(det)
    return out


# -- transforms --------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("wavelet", ["haar", "db4"])
def test_nhwc_transforms_match_jax(wavelet, mode):
    """`dwt2_nhwc`, `wavedec2_nhwc`, `idwt2_nhwc` (random leaves) and
    `waverec2_nhwc` against JAX leaf by leaf, at odd and even sides; the
    NHWC leaves equal the port's NCHW transform's, transposed."""
    rng = _rng("nhwc", wavelet, mode)
    x = rng.standard_normal((2, 21, 18, 3)).astype(np.float32)
    xt = torch.from_numpy(x)
    ja, jd = jn.dwt2_nhwc(jnp.asarray(x), wavelet, mode)
    ta, td = tn.dwt2_nhwc(xt, wavelet, mode)
    for g, w in zip([ta, *td], [ja, *jd]):
        _close(g, w, "dwt2_nhwc")
    want = jn.wavedec2_nhwc(jnp.asarray(x), wavelet, 2, mode)
    got = tn.wavedec2_nhwc(xt, wavelet, 2, mode)
    nchw = tt.wavedec2(xt.permute(0, 3, 1, 2), wavelet, 2, mode, impl="matmul")
    for g, w, c in zip(_leaves(got), _leaves(want), _leaves(nchw)):
        _close(g, w, "wavedec2_nhwc")
        _close(g, c.permute(0, 2, 3, 1).numpy(), "NHWC against NCHW")
    _close(tn.waverec2_nhwc(got, wavelet)[:, :21, :18], x, "round trip")
    rand = [rng.standard_normal(np.shape(c)).astype(np.float32) for c in _leaves(want)]
    jr = [jnp.asarray(rand[0])] + [jt.Detail2D(*map(jnp.asarray, rand[1 + 3 * i:4 + 3 * i]))
                                   for i in range(2)]
    tr = [torch.from_numpy(rand[0])] + [tt.Detail2D(*map(torch.from_numpy, rand[1 + 3 * i:4 + 3 * i]))
                                        for i in range(2)]
    _close(tn.waverec2_nhwc(tr, wavelet), jn.waverec2_nhwc(jr, wavelet), "waverec2_nhwc")
    cA = rng.standard_normal(np.shape(want[-1].horizontal)).astype(np.float32)
    _close(tn.idwt2_nhwc(torch.from_numpy(cA), tr[2], wavelet),
           jn.idwt2_nhwc(jnp.asarray(cA), jr[2], wavelet), "idwt2_nhwc")


@pytest.mark.parametrize("wavelet", ["haar", "db4"])
def test_nhwc_vjps_match_jax(wavelet):
    """The gradients of `wavedec2_nhwc` and `waverec2_nhwc` (the transposed
    contractions, in full float32) against ``jax.vjp``."""
    rng = _rng("nhwc-vjp", wavelet)
    x = rng.standard_normal((2, 20, 22, 3)).astype(np.float32)
    fwd = jax.jit(lambda v: jn.wavedec2_nhwc(v, wavelet, 2))
    shapes = jax.eval_shape(fwd, jnp.asarray(x))
    cot = jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape).astype(np.float32)), shapes)
    (want,) = jax.jit(lambda v, c: jax.vjp(fwd, v)[1](c))(jnp.asarray(x), cot)
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(_leaves(tn.wavedec2_nhwc(xt, wavelet, 2)), xt,
                                 [torch.tensor(np.asarray(c)) for c in _leaves(cot)])
    _close(got, want, "vjp of wavedec2_nhwc")

    rec = jax.jit(lambda c: jn.waverec2_nhwc(c, wavelet))
    g = rng.standard_normal(jax.eval_shape(rec, cot).shape).astype(np.float32)
    (want,) = jax.jit(lambda c, gg: jax.vjp(rec, c)[1](gg))(cot, jnp.asarray(g))
    leaves = [torch.tensor(np.asarray(c)).requires_grad_(True) for c in _leaves(cot)]
    tc = [leaves[0]] + [tt.Detail2D(*leaves[1 + 3 * i:4 + 3 * i]) for i in range(2)]
    got = torch.autograd.grad(tn.waverec2_nhwc(tc, wavelet), leaves, torch.from_numpy(g))
    for a, b in zip(got, _leaves(want)):
        _close(a, b, "vjp of waverec2_nhwc")


def test_nhwc_dtypes():
    """bf16 in, float32 out; float64 stays float64."""
    x = torch.from_numpy(_rng("dt").standard_normal((1, 8, 8, 3)))
    assert tn.dwt2_nhwc(x, "db4")[0].dtype == torch.float64
    cA, det = tn.dwt2_nhwc(x.to(torch.bfloat16), "db4")
    assert cA.dtype == det.diagonal.dtype == torch.float32


# -- packing -------------------------------------------------------------------------


@pytest.mark.parametrize("wavelet,side", [("haar", 32), ("db4", 30)])
def test_nhwc_packing_matches_jax(wavelet, side):
    """`mosaic_size`, `mosaic2d` (both normalizations) and
    `disentangle_scales` on NHWC leaves, against JAX's ``channel_axis=-1``."""
    rng = _rng("pack", wavelet, side)
    ref = jax.eval_shape(lambda v: jn.wavedec2_nhwc(v, wavelet, 3), jnp.zeros((2, side, side, 3)))
    rand = [rng.standard_normal(np.shape(c)).astype(np.float32) for c in _leaves(ref)]
    j = [jnp.asarray(rand[0])] + [jt.Detail2D(*map(jnp.asarray, rand[1 + 3 * i:4 + 3 * i]))
                                  for i in range(3)]
    t = [torch.from_numpy(rand[0])] + [tt.Detail2D(*map(torch.from_numpy, rand[1 + 3 * i:4 + 3 * i]))
                                       for i in range(3)]
    assert tpack.mosaic_size(t, channel_axis=-1) == jpack.mosaic_size(j, channel_axis=-1)
    for normalize in (True, False):
        want = jax.jit(lambda c, n=normalize: jpack.mosaic2d(c, n, channel_axis=-1))(j)
        _close(tpack.mosaic2d(t, normalize, channel_axis=-1), want, "mosaic2d")
    want = jax.jit(lambda c: jpack.disentangle_scales(c, approx_coeffs=True, channel_axis=-1))(j)
    _close(tpack.disentangle_scales(t, approx_coeffs=True, channel_axis=-1), want, "disentangle")
    with pytest.raises(ValueError, match="channel_axis"):
        tpack.mosaic2d(t, channel_axis=2)


# -- engine and WaveletAttribution2D ---------------------------------------------------


@pytest.fixture(scope="module")
def conv3():
    """The same 3-channel conv classifier (4 classes) in both packages, each
    taking NHWC, and its NCHW form in the port."""
    kern = (_rng("kern").standard_normal((3, 3, 3, 4)) * 0.3).astype(np.float32)  # HWIO
    jk = jnp.asarray(kern)

    def jfn(x):
        out = lax.conv_general_dilated(x, jk, (1, 1), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return jnp.tanh(out).mean(axis=(1, 2))

    tk = torch.from_numpy(kern.transpose(3, 2, 0, 1).copy())  # OIHW

    def tfn_nchw(x):
        return torch.tanh(F.conv2d(x, tk, padding=1)).mean(dim=(2, 3))

    def tfn(x):
        return tfn_nchw(x.permute(0, 3, 1, 2))

    rng = _rng("conv3-x")
    x = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    return jfn, tfn, tfn_nchw, x, np.array([1, 3])


def test_engine_channel_last_leaves_match_jax(conv3):
    jfn, tfn, _, x, y = conv3
    xh = x.transpose(0, 2, 3, 1).copy()
    je = jengine.WamEngine(jfn, ndim=2, wavelet="db4", level=2, channel_last=True)
    jc, jg = jax.jit(je.attribute)(jnp.asarray(xh), jnp.asarray(y))
    te = tengine.WamEngine(tfn, ndim=2, wavelet="db4", level=2, channel_last=True)
    assert te.spatial_shape(xh.shape) == (32, 32)
    tc, tg = te.attribute(torch.from_numpy(xh), torch.from_numpy(y))
    for g, w in zip(_leaves(tc), _leaves(jc)):
        _close(g, w, "coefficients")
    for g, w in zip(_leaves(tg), _leaves(jg)):
        _close(g, w, "coefficient gradients", scale=float(np.abs(np.asarray(w)).max()))
    with pytest.raises(ValueError, match="channel_last"):
        tengine.WamEngine(tfn, ndim=3, channel_last=True)


@pytest.mark.parametrize("method", ["smooth", "integratedgrad"])
def test_wam2d_nhwc_matches_jax_and_nchw(conv3, method):
    """SmoothGrad (2 samples, noise drawn with numpy and handed to both: the
    JAX side averages `BaseWAM2D(model_layout="nhwc")` passes on x + sigma
    z_i) and IG (3 path points, the jitted class) against JAX; then the
    port's NHWC against its NCHW path on the same noise."""
    jfn, tfn, tfn_nchw, x, y = conv3
    kw = dict(wavelet="db4", J=2, method=method, n_samples=2 if method == "smooth" else 3)
    z = _rng("noise").standard_normal((2,) + x.shape).astype(np.float32)
    if method == "smooth":
        sigma = np.asarray(jest.noise_sigma(jnp.asarray(x), 0.25)).reshape(-1, 1, 1, 1)
        jm = jwam.BaseWAM2D(jfn, wavelet="db4", J=2, model_layout="nhwc")
        want = np.mean([np.asarray(jm(jnp.asarray(x + zi * sigma), jnp.asarray(y)))
                        for zi in z], axis=0)
        extra = {"noise": torch.from_numpy(z)}
    else:
        jm = jwam.WaveletAttribution2D(jfn, model_layout="nhwc", sample_batch_size=None, **kw)
        want = np.asarray(jm(jnp.asarray(x), jnp.asarray(y)))
        extra = {}
    tm = twam.WaveletAttribution2D(tfn, model_layout="nhwc", device="cpu", **kw)
    got = tm(torch.from_numpy(x), torch.from_numpy(y), **extra)
    scale = float(np.abs(want).max())
    assert got.shape == want.shape and scale > 0
    _close(got, want, f"{method} mosaic", scale=scale)
    _close(tm.scales, np.asarray(jpack.reproject_mosaic(jnp.asarray(want), 2)),
           f"{method} scales", scale=3 * scale)
    nchw = twam.WaveletAttribution2D(tfn_nchw, device="cpu", impl="matmul", **kw)
    _close(got, nchw(torch.from_numpy(x), torch.from_numpy(y), **extra).numpy(),
           f"{method} NHWC against NCHW", scale=scale)


def test_base_wam2d_nhwc_matches_jax(conv3):
    jfn, tfn, _, x, y = conv3
    jm = jwam.BaseWAM2D(jfn, wavelet="haar", J=2, model_layout="nhwc", approx_coeffs=True)
    want = np.asarray(jm(jnp.asarray(x), jnp.asarray(y)))
    tm = twam.BaseWAM2D(tfn, wavelet="haar", J=2, model_layout="nhwc", approx_coeffs=True,
                        device="cpu")
    got = tm(torch.from_numpy(x), torch.from_numpy(y))
    _close(got, want, "mosaic", scale=float(np.abs(want).max()))
    _close(tm.scales, np.asarray(jm.scales), "scales", scale=float(np.abs(want).max()))
    assert tm.gradient_coeffs[0].shape == (2, 8, 8, 3)


@pytest.mark.parametrize("method", ["smooth", "integratedgrad"])
def test_resnet18_nhwc_equals_nchw(method):
    """ResNet-18 (10 classes, seeded) bound NCHW and NHWC with the same
    weights: the two layouts' mosaics agree (the same operators, another
    contraction order)."""
    torch.manual_seed(0)
    model = tres.resnet18(num_classes=10)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    fn = tres.bind_inference(model, device="cpu")
    fn_nhwc = tres.bind_inference(tres.resnet18(num_classes=10), state, nchw=False,
                                  device="cpu")
    x = torch.from_numpy(_rng("r18").standard_normal((2, 3, 32, 32)).astype(np.float32))
    z = torch.from_numpy(_rng("r18-z").standard_normal((2, 2, 3, 32, 32)).astype(np.float32))
    y = torch.tensor([1, 7])
    kw = dict(wavelet="db4", J=2, method=method, n_samples=2, device="cpu")
    extra = {"noise": z} if method == "smooth" else {}
    want = twam.WaveletAttribution2D(fn, impl="matmul", **kw)(x, y, **extra)
    got = twam.WaveletAttribution2D(fn_nhwc, model_layout="nhwc", **kw)(x, y, **extra)
    _close(got, want.numpy(), "NHWC against NCHW", scale=float(want.abs().max()))


def test_model_layout_is_checked(conv3):
    _, tfn, *_ = conv3
    with pytest.raises(ValueError, match="model_layout"):
        twam.BaseWAM2D(tfn, model_layout="nwhc", device="cpu")
