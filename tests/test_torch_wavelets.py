"""Parity of the PyTorch port's wavelet layer with the JAX package.

Inputs are made with numpy from a seed and go through both packages. The
JAX side of K1 is `dwt2_pallas` itself, and of K2 `idwt2_pallas`: both run
their Pallas kernels in interpret mode off the TPU. The JAX side of K3 is
`waverec2_collapsed`, whose `_pair_forward` runs its plain matmul pair off
the TPU. The port side of each is the plain PyTorch version that CPU
tensors take.

Tolerances: both packages compute in float32 with different summation
orders, so values of O(1) agree to ~1e-6; 1e-5 is the stated bound.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wam_tpu.wavelets import filters as jfilters
from wam_tpu.wavelets import matmul as jmm
from wam_tpu.wavelets import transform as jt
from wam_tpu_torch.wavelets import filters as tfilters
from wam_tpu_torch.wavelets import matmul as tmm
from wam_tpu_torch.wavelets import transform as tt

MODES = ["reflect", "symmetric", "zero", "constant", "periodic"]
TOL = 1e-5


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _np(a):
    return np.asarray(a.detach().float().numpy() if isinstance(a, torch.Tensor) else a,
                      dtype=np.float32)


def _coeffs_np(coeffs):
    out = [_np(coeffs[0])]
    for det in coeffs[1:]:
        out.extend(_np(t) for t in det)
    return out


# -- filters and operators ----------------------------------------------------


@pytest.mark.parametrize("name", ["haar"] + [f"db{n}" for n in range(2, 9)]
                         + [f"sym{n}" for n in range(2, 9)])
def test_filter_taps_bit_equal(name):
    a, b = jfilters.build_wavelet(name), tfilters.build_wavelet(name)
    for field in ("dec_lo", "dec_hi", "rec_lo", "rec_hi"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


@pytest.mark.parametrize("wavelet", ["haar", "db4", "sym3"])
@pytest.mark.parametrize("mode", MODES)
def test_operator_matrices_equal(wavelet, mode):
    w = tfilters.build_wavelet(wavelet)
    for n in (5, 17, 64):
        np.testing.assert_array_equal(
            tmm._analysis_np(n, tuple(w.dec_lo), tuple(w.dec_hi), mode),
            jmm._analysis_np(n, tuple(w.dec_lo), tuple(w.dec_hi), mode))
        np.testing.assert_array_equal(
            tmm._synthesis_np(n, tuple(w.rec_lo), tuple(w.rec_hi)),
            jmm._synthesis_np(n, tuple(w.rec_lo), tuple(w.rec_hi)))
    sizes = [(40 + w.filt_len - 1) // 2]  # per-level lengths of a 40-long axis
    for _ in range(2):
        sizes.append((sizes[-1] + w.filt_len - 1) // 2)
    sizes = tuple(sizes[::-1])
    np.testing.assert_array_equal(
        tmm._collapsed_axis_np(sizes, tuple(w.rec_lo), tuple(w.rec_hi)),
        jmm._collapsed_axis_np(sizes, tuple(w.rec_lo), tuple(w.rec_hi)))


def test_analysis_band_width_at_most_filter_length():
    """K1's operators are banded: at most L nonzeros per row (the lever a
    band-aware kernel would use), at the flagship's 224/115/61 sides."""
    w = tfilters.build_wavelet("db4")
    for n in (224, 115, 61):
        A = tmm._analysis_np(n, tuple(w.dec_lo), tuple(w.dec_hi), "reflect")
        assert A.shape == (2 * ((n + 7) // 2), n)
        assert (np.count_nonzero(A, axis=1) <= 8).all()


# -- K1: the plain version against dwt2_pallas (interpret mode) ---------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 33, 40), (1, 64, 17)], ids=["odd-even", "even-odd"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("wavelet", ["haar", "db4"])
def test_k1_plain_matches_dwt2_pallas(wavelet, mode, shape, dtype):
    rng = _rng("k1", wavelet, mode, shape, dtype)
    x = rng.standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    want, vjp = jax.vjp(lambda v: jmm.dwt2_pallas(v, wavelet, mode), jx)
    g = rng.standard_normal(want.shape).astype(np.float32)
    (want_dx,) = vjp(jnp.asarray(g))

    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    tx.requires_grad_(True)
    got = tmm.dwt2_kernel(tx, wavelet, mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=0)
    (got_dx,) = torch.autograd.grad(got, tx, torch.from_numpy(g))
    assert got_dx.dtype == tx.dtype
    if dtype == "f32":
        np.testing.assert_allclose(_np(got_dx), np.asarray(want_dx), atol=TOL, rtol=0)
    else:
        # Both packages round the same float32 adjoint to bfloat16; a 1e-7
        # difference before rounding can move a value by one bf16 ulp
        # (relative 2^-8 to 2^-7; it happens for db4-constant-even-odd), so
        # the bound is one ulp plus the f32 tolerance.
        np.testing.assert_allclose(_np(got_dx), np.asarray(want_dx, np.float32),
                                   atol=TOL, rtol=2.0**-7)


# -- K3: the plain version against waverec2_collapsed -------------------------


@pytest.mark.parametrize("wavelet,shape,level", [
    ("db4", (2, 3, 64, 64), 3),
    ("db4", (1, 2, 45, 50), 3),
    ("haar", (1, 3, 40, 36), 3),
    ("sym3", (2, 1, 33, 33), 2),
])
def test_k3_plain_matches_waverec2_collapsed(wavelet, shape, level):
    rng = _rng("k3", wavelet, shape, level)
    x = rng.standard_normal(shape).astype(np.float32)
    coeffs = jt.wavedec2(jnp.asarray(x), wavelet, level, "reflect")
    leaves = [np.array(c) for c in jax.tree_util.tree_leaves(coeffs)]

    def jfn(*ls):
        it = iter(ls)
        cA = next(it)
        dets = [jt.Detail2D(*(next(it) for _ in range(3))) for _ in range(level)]
        return jmm.waverec2_collapsed(cA, dets, wavelet)

    want, vjp = jax.vjp(jfn, *(jnp.asarray(v) for v in leaves))
    g = rng.standard_normal(want.shape).astype(np.float32)
    want_grads = vjp(jnp.asarray(g))

    tleaves = [torch.from_numpy(v).requires_grad_(True) for v in leaves]
    tdets = [tt.Detail2D(*tleaves[1 + 3 * i: 4 + 3 * i]) for i in range(level)]
    got = tmm.waverec2_collapsed(tleaves[0], tdets, wavelet)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=0)
    got_grads = torch.autograd.grad(got, tleaves, torch.from_numpy(g))
    for gg, wg in zip(got_grads, want_grads):
        np.testing.assert_allclose(_np(gg), np.asarray(wg), atol=TOL, rtol=0)


def test_k3_bf16_leaves_upcast_at_assembly():
    rng = _rng("k3bf16")
    x = torch.from_numpy(rng.standard_normal((1, 2, 40, 40)).astype(np.float32))
    coeffs = tt.wavedec2(x, "db4", 3)
    bf = [coeffs[0].bfloat16()] + [tt.Detail2D(*(t.bfloat16() for t in d)) for d in coeffs[1:]]
    got = tmm.waverec2_collapsed(bf[0], bf[1:], "db4")
    want = tmm.waverec2_collapsed(bf[0].float(), [tt.Detail2D(*(t.float() for t in d))
                                                  for d in bf[1:]], "db4")
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# -- K2: the plain version against idwt2_pallas (interpret mode) -------------


@pytest.fixture
def jax_synth_knobs():
    """The JAX synthesis knob is a module global: set it per test and put it
    back after."""
    before = jt.get_synth2_impl()
    yield
    jt.set_synth2_impl(before)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("trim", [False, True], ids=["full", "trimmed"])
@pytest.mark.parametrize("shape", [(2, 4, 9, 13), (1, 3, 4, 17, 6)], ids=["h<w", "h>w"])
@pytest.mark.parametrize("wavelet", ["haar", "db4"])
def test_k2_plain_matches_idwt2_pallas(wavelet, shape, trim, dtype):
    """Values and VJP of `idwt2_kernel` on CPU tensors (K2's plain version,
    backward K1's plain version) against `idwt2_pallas`, with h != w so a
    swapped row/column operator shows, an ``out_shape`` trim, and bf16
    subbands read as they are."""
    rng = _rng("k2", wavelet, shape, trim, dtype)
    sub = rng.standard_normal(shape).astype(np.float32)
    L = tfilters.build_wavelet(wavelet).filt_len
    full = (2 * shape[-2] - L + 2, 2 * shape[-1] - L + 2)
    out_shape = (full[0] - 1, full[1] - 2) if trim else None
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    want, vjp = jax.vjp(lambda v: jmm.idwt2_pallas(v, wavelet, out_shape),
                        jnp.asarray(sub, dtype=jdt))
    g = rng.standard_normal(want.shape).astype(np.float32)
    (want_dsub,) = vjp(jnp.asarray(g))

    tsub = torch.from_numpy(sub).to(tdt).requires_grad_(True)
    got = tmm.idwt2_kernel(tsub, wavelet, out_shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert tuple(got.shape[-2:]) == (out_shape or full)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=0)
    (got_dsub,) = torch.autograd.grad(got, tsub, torch.from_numpy(g))
    assert got_dsub.dtype == tdt
    if dtype == "f32":
        np.testing.assert_allclose(_np(got_dsub), np.asarray(want_dsub), atol=TOL, rtol=0)
    else:
        # both round the same float32 adjoint to bfloat16 (see the K1 test)
        np.testing.assert_allclose(_np(got_dsub), np.asarray(want_dsub, np.float32),
                                   atol=TOL, rtol=2.0**-7)


def test_k2_plain_is_the_merged_matmul_pair():
    """`idwt2_plain` (what chip_smoke.py holds K2 against) is the quadrant
    merge followed by Sr @ Y @ Sc^T, and equals `synthesis2_mm`."""
    sub = torch.from_numpy(_rng("k2pair").standard_normal((3, 4, 10, 7)).astype(np.float32))
    w = tfilters.build_wavelet("db4")
    Sr, _ = tmm._kernel_synthesis(10, tuple(w.rec_lo), tuple(w.rec_hi), sub.device)
    _, Sct = tmm._kernel_synthesis(7, tuple(w.rec_lo), tuple(w.rec_hi), sub.device)
    got = tmm.idwt2_plain(sub, Sr, Sct)
    assert got.shape == (3, 14, 8)
    torch.testing.assert_close(got, tmm.synthesis2_mm(sub, "db4", (14, 8)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("crossover", [32, 14], ids=["collapsed+K2", "K2-only"])
def test_waverec2_kernel_with_k2_levels_matches_jax(monkeypatch, jax_synth_knobs, crossover):
    """waverec2(impl="kernel") with the crossover lowered below the finest
    detail side, so the collapsed pair (K3) is followed by per-level K2
    synthesis, against the JAX waverec2 on its pallas synthesis (db4 J=3 at
    64²: sides 35/21/14, so crossover 32 collapses 2 levels and leaves one K2
    level; 14 collapses none and runs all three through K2). Values and the
    gradient of every leaf."""
    monkeypatch.setattr(jt, "_SYNTH_COLLAPSE", crossover)
    monkeypatch.setattr(tt, "SYNTH_COLLAPSE", crossover)
    jt.set_synth2_impl("pallas")
    rng = _rng("rec-k2", crossover)
    x = rng.standard_normal((1, 2, 64, 64)).astype(np.float32)
    coeffs = tt.wavedec2(torch.from_numpy(x), "db4", 3)
    assert tt._collapse_count(coeffs[1:]) == {32: 2, 14: 0}[crossover]
    leaves = [_np(coeffs[0])] + [_np(t) for d in coeffs[1:] for t in d]

    def jfn(*ls):
        return jt.waverec2([ls[0]] + [jt.Detail2D(*ls[1 + 3 * i: 4 + 3 * i]) for i in range(3)],
                           "db4")

    want, vjp = jax.vjp(jfn, *(jnp.asarray(v) for v in leaves))
    g = rng.standard_normal(want.shape).astype(np.float32)
    want_grads = vjp(jnp.asarray(g))

    tleaves = [torch.from_numpy(v).requires_grad_(True) for v in leaves]
    tcoeffs = [tleaves[0]] + [tt.Detail2D(*tleaves[1 + 3 * i: 4 + 3 * i]) for i in range(3)]
    got = tt.waverec2(tcoeffs, "db4", impl="kernel")
    assert tuple(got.shape) == want.shape == (1, 2, 64, 64)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=0)
    np.testing.assert_allclose(_np(got), x, atol=1e-4, rtol=0)  # the round trip
    for gg, wg in zip(torch.autograd.grad(got, tleaves, torch.from_numpy(g)), want_grads):
        np.testing.assert_allclose(_np(gg), np.asarray(wg), atol=TOL, rtol=0)


def test_path2_shapes_take_k2():
    """At 288² (db4, J=3) the detail sides are 147/77/42: the two coarsest
    levels collapse (R is 148 x 238) and the finest runs through K2 with
    subbands (4, 147, 147), Sr (288, 294) and a 288² output."""
    coeffs = tt.wavedec2(torch.zeros(1, 1, 288, 288), "db4", 3)
    assert [d.horizontal.shape[-1] for d in coeffs[1:]] == [42, 77, 147]
    assert tt._collapse_count(coeffs[1:]) == 2
    w = tfilters.build_wavelet("db4")
    R = tmm._collapsed_axis_np((42, 77), tuple(w.rec_lo), tuple(w.rec_hi))
    assert R.shape == (148, 238)
    assert tmm._synthesis_np(147, tuple(w.rec_lo), tuple(w.rec_hi)).shape == (288, 294)


# -- transforms -----------------------------------------------------------------


@pytest.mark.parametrize("impl", ["conv", "matmul", "kernel"])
@pytest.mark.parametrize("shape", [(2, 3, 32, 37), (1, 2, 5, 6)], ids=["odd", "tiny"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("wavelet", ["haar", "db4", "sym3"])
def test_wavedec2_matches_jax(wavelet, mode, shape, impl):
    """Coefficients of every port impl against the JAX conv form, J=1 on the
    tiny shape (pads wider than the signal) and J=3 otherwise."""
    level = 1 if shape[-1] < 8 else 3
    x = _rng("dec", wavelet, mode, shape).standard_normal(shape).astype(np.float32)
    want = jt.wavedec2(jnp.asarray(x), wavelet, level, mode)
    got = tt.wavedec2(torch.from_numpy(x), wavelet, level, mode, impl=impl)
    for g, w in zip(_coeffs_np(got), [np.asarray(t) for t in jax.tree_util.tree_leaves(want)]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)


@pytest.mark.parametrize("impl", ["conv", "matmul", "kernel"])
@pytest.mark.parametrize("wavelet,shape,level", [
    ("db4", (2, 3, 64, 64), 3),
    ("db4", (1, 2, 45, 50), 1),
    ("haar", (1, 3, 40, 36), 3),
    ("sym3", (2, 1, 33, 31), 2),
])
def test_waverec2_matches_jax_and_round_trips(wavelet, shape, level, impl):
    """Synthesis of arbitrary coefficients against the JAX conv synthesis
    (collapsed on impl="kernel" wherever >= 2 levels fall under the
    crossover), and the decompose/reconstruct round trip."""
    rng = _rng("rec", wavelet, shape, level)
    x = rng.standard_normal(shape).astype(np.float32)
    shapes = [np.asarray(t).shape for t in
              jax.tree_util.tree_leaves(jt.wavedec2(jnp.asarray(x), wavelet, level, "reflect"))]
    leaves = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jcoeffs = [jnp.asarray(leaves[0])] + [
        jt.Detail2D(*(jnp.asarray(v) for v in leaves[1 + 3 * i: 4 + 3 * i]))
        for i in range(level)]
    tcoeffs = [torch.from_numpy(leaves[0])] + [
        tt.Detail2D(*(torch.from_numpy(v) for v in leaves[1 + 3 * i: 4 + 3 * i]))
        for i in range(level)]
    want = np.asarray(jt.waverec2(jcoeffs, wavelet))
    got = _np(tt.waverec2(tcoeffs, wavelet, impl=impl))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)

    rec = tt.waverec2(tt.wavedec2(torch.from_numpy(x), wavelet, level, impl=impl), wavelet,
                      impl=impl)
    np.testing.assert_allclose(_np(rec)[..., : shape[-2], : shape[-1]], x, atol=1e-4, rtol=0)


@pytest.mark.parametrize("impl", ["conv", "matmul", "kernel"])
def test_bf16_in_f32_coefficients_out(impl):
    """bf16 input: float32 coefficients on every impl, equal to the f32
    transform of the bf16-rounded input (only the input rounding differs)."""
    x = torch.from_numpy(_rng("bf16").standard_normal((2, 3, 40, 40)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    got = tt.wavedec2(xb, "db4", 3, impl=impl)
    want = tt.wavedec2(xb.float(), "db4", 3, impl=impl)
    for g, w in zip(_coeffs_np(got), _coeffs_np(want)):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)
    assert all(t.dtype == torch.float32 for t in [got[0], *got[1]])


def test_collapse_count_and_flagship_shapes():
    """At the flagship (224^2, db4, J=3) every detail side (115/61/34) is
    below the crossover, so the whole synthesis is one collapsed pair, with
    R of shape (224, 420)."""
    coeffs = tt.wavedec2(torch.zeros(1, 1, 224, 224), "db4", 3)
    assert [d.horizontal.shape[-1] for d in coeffs[1:]] == [34, 61, 115]
    assert tt._collapse_count(coeffs[1:]) == 3
    w = tfilters.build_wavelet("db4")
    R = tmm._collapsed_axis_np((34, 61, 115), tuple(w.rec_lo), tuple(w.rec_hi))
    assert R.shape == (224, 420)
    assert tt.dwt_max_level(224, 8) == jt.dwt_max_level(224, 8)


def test_bad_impl_and_mode_rejected():
    x = torch.zeros(1, 1, 8, 8)
    with pytest.raises(ValueError, match="impl"):
        tt.dwt2(x, "haar", impl="pallas")
    with pytest.raises(ValueError, match="mode"):
        tt.dwt2(x, "haar", mode="wrap", impl="conv")
