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
from wam_tpu_torch import kernels
from wam_tpu_torch.wavelets import filters as tfilters
from wam_tpu_torch.wavelets import matmul as tmm
from wam_tpu_torch.wavelets import transform as tt

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

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


# -- band form: what K1 and K2 read in place of the dense operators ------------

BAND_WAVELETS = ["haar", "db4", "sym3", "db8"]
BAND_SIDES = [5, 17, 64, 115, 147]


def _other_side(side):
    """A second side for h != w: the next of BAND_SIDES, cyclically."""
    return BAND_SIDES[(BAND_SIDES.index(side) + 1) % len(BAND_SIDES)]


def _scatter(idx, w, shape):
    dense = np.zeros(shape)
    np.add.at(dense, (np.arange(shape[0])[:, None], idx), w)
    return dense


def _band_operators(wavelet, mode, side):
    """A (h rows of input), B^T (w columns), and the synthesis operators of
    the levels they produce: Sr (h'), Sc^T (w'), Sr^T; with h != w."""
    wv = tfilters.build_wavelet(wavelet)
    dec, rec = (tuple(wv.dec_lo), tuple(wv.dec_hi)), (tuple(wv.rec_lo), tuple(wv.rec_hi))
    h, w = side, _other_side(side)
    A, B = tmm._analysis_np(h, *dec, mode), tmm._analysis_np(w, *dec, mode)
    Sr = tmm._synthesis_np(A.shape[0] // 2, *rec)
    Sc = tmm._synthesis_np(B.shape[0] // 2, *rec)
    return wv, {"A": (A, "rows"), "B^T": (B.T, "cols"), "Sr": (Sr, "rows"),
                "Sc^T": (Sc.T, "cols"), "Sr^T": (Sr.T, "rows")}


@pytest.mark.parametrize("side", BAND_SIDES)
@pytest.mark.parametrize("wavelet", BAND_WAVELETS)
@pytest.mark.parametrize("mode", MODES)
def test_band_form_scatters_back_bit_for_bit(mode, wavelet, side):
    """The ELL pair of every operator K1 and K2 take (rows of M1, columns of
    M2) scatters back to the float64 operator bit for bit, with at most L
    taps per row or column (periodic rows wrap, folded taps are summed)."""
    wv, ops = _band_operators(wavelet, mode, side)
    for name, (M, along) in ops.items():
        idx, w = tmm.band_form(M, along)
        rows = M if along == "rows" else M.T
        assert idx.dtype == np.int32 and idx.shape == w.shape, name
        assert idx.shape[1] <= wv.filt_len, (name, idx.shape)
        np.testing.assert_array_equal(_scatter(idx, w, rows.shape), rows, err_msg=name)


def _strip_perm(plan):
    """Where the strip keeps each column: K1's odd columns from odd_off on,
    or K3's groups of c mod 2^fold_log2, fstride apart."""
    c = np.arange(plan["s"])
    if "fold_log2" in plan:
        f = 1 << plan["fold_log2"]
        return (c % f) * plan["fstride"] + c // f
    return np.where(c % 2, plan["odd_off"] + c // 2, c // 2) if plan["odd_off"] else c


def _emulate_band(plan, stage_row, n):
    """The data flow of csrc/band2.cuh (and of one level of
    csrc/collapsed.cuh) over a plan, in numpy float64: per row tile, stage
    the named source rows (``stage_row(q)`` -> (n, s)), form the row pairs'
    strip (columns permuted as `_strip_perm` says), then the column pairs
    against it. Checks that taps name staged slots only and that every
    output element is written exactly once."""
    rt, s = plan["rt"], plan["s"]
    perm = _strip_perm(plan)
    out = np.zeros((n, plan["p"], plan["t"]))
    hits = np.zeros((plan["p"], plan["t"]), int)
    for j in range(plan["ntiles"]):
        slots = plan["tsrc"][j]
        stage = np.stack([stage_row(q) if q >= 0 else np.full((n, s), np.nan) for q in slots], 1)
        live = plan["trow"][j, :, 0] >= 0
        assert (slots[plan["tidx"][j][live]] >= 0).all()
        strip = np.full((n, 2 * rt, plan["ts_stride"]), np.nan)
        # (n, rt, 2, s): both rows of every pair from the pair's shared taps
        pairs = np.einsum("rhk,nrks->nrhs", plan["tw"][j].astype(np.float64),
                          stage[:, plan["tidx"][j]])
        strip[:, :, perm] = pairs.reshape(n, 2 * rt, s)
        rows = plan["trow"][j].ravel()
        vals = strip[:, :, plan["cidx"]]  # (n, 2rt, tp, k)
        for half in range(2):
            cols = plan["ccol"][:, half]
            res = np.einsum("nrpk,pk->nrp", vals, plan["cw"][:, half].astype(np.float64))
            keep_r, keep_c = rows >= 0, cols >= 0
            out[:, rows[keep_r][:, None], cols[keep_c][None, :]] = res[:, keep_r][:, :, keep_c]
            np.add.at(hits, (rows[keep_r][:, None], cols[keep_c][None, :]), 1)
    assert (hits == 1).all()
    return out


def _quadrants(y):
    h, w = y.shape[-2] // 2, y.shape[-1] // 2
    return np.stack([y[..., :h, :w], y[..., :h, w:], y[..., h:, :w], y[..., h:, w:]], -3)


@pytest.mark.parametrize("side", BAND_SIDES)
@pytest.mark.parametrize("wavelet", BAND_WAVELETS)
@pytest.mark.parametrize("mode", MODES)
def test_band_plan_gather_sum_matches_k1_plain(mode, wavelet, side):
    """K1's plan (band forms of A and B^T, row pairs (i, h' + i), the strip
    deinterleaved), gathered and summed in numpy with K1's quadrant split,
    equals `dwt2_plain` within 1e-5, h != w, periodic wrap included."""
    wv = tfilters.build_wavelet(wavelet)
    taps = (tuple(wv.dec_lo), tuple(wv.dec_hi), mode)
    h, w = side, _other_side(side)
    x = _rng("band-k1", wavelet, mode, side).standard_normal((2, h, w)).astype(np.float32)
    plan = tmm._dwt2_plan_np(h, w, *taps)
    assert plan["k"] == max(plan["kc"], min(wv.filt_len, max(h, w)))
    got = _quadrants(_emulate_band(plan, lambda q: x[:, q].astype(np.float64), 2))
    cpu = torch.device("cpu")
    _, At = tmm._kernel_analysis(h, *taps, cpu)
    _, Bt = tmm._kernel_analysis(w, *taps, cpu)
    np.testing.assert_allclose(got, _np(tmm.dwt2_plain(torch.from_numpy(x), At, Bt)),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("trim", [False, True], ids=["full", "trimmed"])
@pytest.mark.parametrize("side", BAND_SIDES)
@pytest.mark.parametrize("wavelet", BAND_WAVELETS)
def test_band_plan_gather_sum_matches_k2_plain(wavelet, side, trim):
    """K2's plan (Sr, Sc^T; row and column pairs (2m, 2m + 1)), gathered in
    numpy with the subband row split (merged row q from subbands 0 | 1 or
    2 | 3), equals `idwt2_plain`; its backward's plan (Sr^T, Sc, on K1)
    equals `dwt2_plain(g, Sr, Sc)`, with g zero-padded from the trimmed
    output as autograd hands it over. h != w; within 1e-5."""
    wv = tfilters.build_wavelet(wavelet)
    rec = (tuple(wv.rec_lo), tuple(wv.rec_hi))
    h, w = (max(n, wv.filt_len) for n in (side, _other_side(side)))  # 2n - L + 2 > 0
    rng = _rng("band-k2", wavelet, side, trim)
    sub = rng.standard_normal((2, 4, h, w)).astype(np.float32)
    cpu = torch.device("cpu")
    Sr, _ = tmm._kernel_synthesis(h, *rec, cpu)
    Sc, Sct = tmm._kernel_synthesis(w, *rec, cpu)
    full = (Sr.shape[0], Sc.shape[0])
    out_shape = (full[0] - 1, full[1] - 2) if trim else full

    def subband_row(q):
        top = q < h
        return np.concatenate([sub[:, 0 if top else 2, q % h], sub[:, 1 if top else 3, q % h]],
                              -1).astype(np.float64)

    fwd = tmm._idwt2_plan_np(h, w, *rec, False)
    got = _emulate_band(fwd, subband_row, 2)[:, :out_shape[0], :out_shape[1]]
    want = _np(tmm.idwt2_plain(torch.from_numpy(sub), Sr, Sct))[:, :out_shape[0], :out_shape[1]]
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)

    g = np.zeros((2,) + full, np.float32)
    g[:, :out_shape[0], :out_shape[1]] = rng.standard_normal((2,) + out_shape)
    bwd = tmm._idwt2_plan_np(h, w, *rec, True)
    got = _quadrants(_emulate_band(bwd, lambda q: g[:, q].astype(np.float64), 2))
    np.testing.assert_allclose(got, _np(tmm.dwt2_plain(torch.from_numpy(g), Sr, Sc)),
                               atol=TOL, rtol=0)


def _dense_from_blob(plan):
    """Decode a `kernels.BandPlan` blob (the layout csrc/band2.cuh reads:
    tsrc | per tile trow, tidx, tw | ccol, cidx, cw pair-minor) back to the
    dense M1 (p x q) and M2 (s x t) it stands for."""
    fields = plan._asdict()
    return _decode_band(plan.blob.cpu().numpy(), 0, fields, _strip_perm(fields), plan.p,
                        plan.q, plan.t)


def _decode_band(blob, at, plan, perm, p, q, t):
    """The dense M1 (p x q) and M2 (s x t) of the band plan whose arrays
    start at word ``at`` of ``blob``; ``plan`` gives its shape."""
    def take(count, shape):
        nonlocal at
        at += count
        return blob[at - count:at].reshape(shape)

    nt, rt, k, tp = plan["ntiles"], plan["rt"], plan["k"], plan["tp"]
    tsrc = take(nt * plan["sm"], (nt, plan["sm"]))
    tdat = take(nt * (2 * rt + 3 * rt * k), (nt, -1))
    trow = tdat[:, :2 * rt].reshape(nt, rt, 2)
    tidx = tdat[:, 2 * rt:2 * rt + rt * k].reshape(nt, rt, k)
    tw = np.ascontiguousarray(tdat[:, 2 * rt + rt * k:]).view(np.float32).reshape(nt, rt, 2, k)
    ccol, cidx = take(tp * 2, (2, tp)).T, take(tp * k, (k, tp)).T
    cw = np.moveaxis(take(tp * 2 * k, (2, k, tp)).view(np.float32), -1, 0)
    c = np.arange(plan["s"])
    unperm = np.zeros(plan["ts_stride"], int)
    unperm[perm] = c
    m1, m2 = np.zeros((p, q)), np.zeros((plan["s"], t))
    for j in range(nt):
        for r in range(rt):
            for half in range(2):
                if trow[j, r, half] >= 0:
                    np.add.at(m1[trow[j, r, half]], tsrc[j][tidx[j, r]], tw[j, r, half])
    for u in range(tp):
        for half in range(2):
            if ccol[u, half] >= 0:
                np.add.at(m2[:, ccol[u, half]], unperm[cidx[u]], cw[u, half])
    return m1, m2


@pytest.mark.parametrize("wavelet,mode,h,w", [
    ("db4", "reflect", 224, 115), ("db4", "periodic", 61, 34), ("haar", "zero", 17, 5),
    ("sym3", "constant", 64, 147), ("db8", "symmetric", 115, 17)])
def test_band_plan_blob_decodes_to_the_operators(wavelet, mode, h, w):
    """The device plans of K1 (A, B^T), K2 (Sr, Sc^T) and K2's backward
    (Sr^T, Sc), read back from the int32 blob the kernel reads, are the
    float32 operators."""
    wv = tfilters.build_wavelet(wavelet)
    dec, rec = (tuple(wv.dec_lo), tuple(wv.dec_hi)), (tuple(wv.rec_lo), tuple(wv.rec_hi))
    cpu = torch.device("cpu")
    A, B = tmm._analysis_np(h, *dec, mode), tmm._analysis_np(w, *dec, mode)
    hs, ws = A.shape[0] // 2, B.shape[0] // 2
    Sr, Sc = tmm._synthesis_np(hs, *rec), tmm._synthesis_np(ws, *rec)
    fwd, bwd = tmm.idwt2_band(hs, ws, *rec, cpu)
    for plan, (m1, m2) in ((tmm.dwt2_band(h, w, *dec, mode, cpu), (A, B.T)),
                           (fwd, (Sr, Sc.T)), (bwd, (Sr.T, Sc))):
        assert plan.blob.dtype == torch.int32
        got1, got2 = _dense_from_blob(plan)
        np.testing.assert_array_equal(got1, m1.astype(np.float32))
        np.testing.assert_array_equal(got2, m2.astype(np.float32))


def test_band_plans_at_the_paths_shapes():
    """db4 at the paths' sides: 8 taps in registers, two stages, the column
    pairs' taps in shared memory, and blocks within the shared-memory
    target; the strip's odd columns start at 16 mod 32 for K1, unpermuted
    for K2's forward."""
    w = tfilters.build_wavelet("db4")
    dec, rec = (tuple(w.dec_lo), tuple(w.dec_hi)), (tuple(w.rec_lo), tuple(w.rec_hi))
    plans = [tmm._dwt2_plan_np(n, n, *dec, "reflect") for n in (224, 115, 61, 288, 147, 77)]
    plans += [tmm._idwt2_plan_np(147, 147, *rec, bwd) for bwd in (False, True)]
    for plan in plans:
        assert (plan["k"], plan["kc"], plan["stages"], plan["cols_shared"]) == (8, 8, 2, 1)
        smem = kernels.band_smem_bytes(plan["s"], plan["sm"], plan["rt"], plan["k"],
                                       plan["tp"], plan["ts_stride"], 2, 1)
        assert smem <= tmm.SMEM_TARGET
        assert plan["odd_off"] % 32 == 16 or (plan is plans[-2] and plan["odd_off"] == 0)
    # a tile of rt row pairs stages the 2 rt + L - 2 source rows they read
    assert (plans[0]["rt"], plans[0]["sm"], plans[0]["ntiles"]) == (16, 38, 8)
    assert (plans[3]["rt"], plans[3]["sm"], plans[3]["ntiles"]) == (8, 22, 19)


def test_band_plan_long_filters_and_wide_sides():
    """db20 (40 taps) keeps 16 in registers and the rest in a loop; a side
    too wide for two stages and for the column pairs' taps in shared memory
    falls back to one stage and taps read from device memory; one wider
    still is refused."""
    wv = tfilters.build_wavelet("db20")
    dec = (tuple(wv.dec_lo), tuple(wv.dec_hi))
    plan = tmm._dwt2_plan_np(64, 50, *dec, "symmetric")
    assert (plan["kc"], plan["k"]) == (16, 40)
    x = _rng("db20").standard_normal((1, 64, 50))
    got = _quadrants(_emulate_band(plan, lambda q: x[:, q], 1))
    A, B = tmm._analysis_np(64, *dec, "symmetric"), tmm._analysis_np(50, *dec, "symmetric")
    np.testing.assert_allclose(got, _quadrants(A @ x @ B.T), atol=TOL, rtol=0)  # f32 taps
    d4 = tfilters.build_wavelet("db4")
    dec4 = (tuple(d4.dec_lo), tuple(d4.dec_hi))
    wide = tmm._dwt2_plan_np(16, 4000, *dec4, "zero")
    assert (wide["stages"], wide["cols_shared"]) == (1, 0)
    x = _rng("wide").standard_normal((1, 16, 4000))
    got = _quadrants(_emulate_band(wide, lambda q: x[:, q], 1))
    A, B = tmm._analysis_np(16, *dec4, "zero"), tmm._analysis_np(4000, *dec4, "zero")
    np.testing.assert_allclose(got, _quadrants(A @ x @ B.T), atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="shared memory"):
        tmm._dwt2_plan_np(16, 9000, *dec4, "zero")


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


def _k3_against_jax(wavelet, shape, level, views):
    """waverec2_collapsed of the port (CPU: the plain version) against the
    JAX one, values and the gradient of every leaf. With ``views`` the
    port's leaves are made as the engine makes them: detached views of one
    (..., 4, h, w) tensor per level, in K1's subband order."""
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

    tleaves = [torch.from_numpy(v) for v in leaves]
    if views:
        subs = []
        for i in range(level):
            h, v, d = tleaves[1 + 3 * i:4 + 3 * i]
            aa = tleaves[0] if i == 0 else torch.zeros_like(h)
            subs.append(torch.stack([aa, v, h, d], -3))  # (aa, ad, da, dd)
        tleaves = [subs[0][..., 0, :, :]] + [
            sub[..., k, :, :] for sub in subs for k in (2, 1, 3)]
        assert not any(t.is_contiguous() for t in tleaves)
    tleaves = [t.detach().requires_grad_(True) for t in tleaves]
    tdets = [tt.Detail2D(*tleaves[1 + 3 * i: 4 + 3 * i]) for i in range(level)]
    got = tmm.waverec2_collapsed(tleaves[0], tdets, wavelet)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=0)
    got_grads = torch.autograd.grad(got, tleaves, torch.from_numpy(g))
    for gg, wg in zip(got_grads, want_grads):
        np.testing.assert_allclose(_np(gg), np.asarray(wg), atol=TOL, rtol=0)


@pytest.mark.parametrize("wavelet,shape,level", [
    ("db4", (2, 3, 64, 64), 3),
    ("db4", (1, 2, 45, 50), 3),
    ("haar", (1, 3, 40, 36), 3),
    ("sym3", (2, 1, 33, 33), 2),
])
def test_k3_plain_matches_waverec2_collapsed(wavelet, shape, level):
    _k3_against_jax(wavelet, shape, level, views=False)


@pytest.mark.parametrize("wavelet,shape,level", [
    ("db4", (2, 3, 64, 64), 3),
    ("sym3", (1, 2, 45, 50), 2),
])
def test_k3_plain_matches_waverec2_collapsed_on_leaf_views(wavelet, shape, level):
    """The same on non-contiguous leaves: views of K1-shaped outputs, as the
    engine hands them over."""
    _k3_against_jax(wavelet, shape, level, views=True)


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


# -- K3's plans: one band product per collapsed level and direction ----------

# (wavelet, image side(s), levels, collapsed levels): the flagship (224^2,
# sides 34/61/115), path 2 (288^2, its two coarsest levels 42/77), h != w,
# J = 2..4
K3_PLAN_CASES = [("db4", (224, 224), 3, 3), ("db4", (288, 288), 3, 2), ("haar", (40, 36), 3, 3),
                 ("sym3", (64, 50), 4, 4), ("db8", (90, 70), 2, 2), ("db4", (45, 50), 2, 2)]


def _k3_setup(wavelet, hw, level, keep):
    """Leaves of a real decomposition (2 images), the collapsed levels'
    sides and K3's (forward, backward) plans."""
    x = _rng("k3plan", wavelet, hw).standard_normal((2,) + hw).astype(np.float32)
    coeffs = jt.wavedec2(jnp.asarray(x), wavelet, level, "reflect")
    leaves = [np.asarray(coeffs[0], np.float64)] + [
        np.asarray(t, np.float64) for d in coeffs[1:1 + keep] for t in d]
    rs = tuple(leaves[1 + 3 * i].shape[-2] for i in range(keep))
    cs = tuple(leaves[1 + 3 * i].shape[-1] for i in range(keep))
    wv = tfilters.build_wavelet(wavelet)
    rec = (tuple(wv.rec_lo), tuple(wv.rec_hi))
    return leaves, rs, cs, rec, tmm._pair_plans_np(rs, cs, *rec)


@pytest.mark.parametrize("wavelet,hw,level,keep", K3_PLAN_CASES)
def test_k3_plans_emulated_match_dense_and_jax(wavelet, hw, level, keep):
    """csrc/collapsed.cuh's data flow over K3's plans, in numpy: the forward
    sums each level's band product on rows of Y_l staged from the leaves
    ([aa or 0 | V] above, [H | D] below), with every level on the same row
    tiles and column pairs (a thread's sums stay in registers); the backward
    runs each level's product on g and splits it into aa (coarsest only),
    V, H, D. Held against the dense R Y C^T and against the JAX
    waverec2_collapsed forward and per-leaf VJP, within 1e-5."""
    leaves, rs, cs, rec, (fwd, bwd) = _k3_setup(wavelet, hw, level, keep)
    n = leaves[0].shape[0]
    first = fwd["levels"][0]
    for lv in fwd["levels"]:
        assert np.array_equal(lv["trow"], first["trow"]) and np.array_equal(lv["ccol"], first["ccol"])
        assert 2 * lv["rt"] <= kernels.PAIR_ROWS_PER_THREAD * (fwd["threads"] // lv["tp"])

    def y_rows(i):
        r, c = rs[i], cs[i]
        h, v, d = leaves[1 + 3 * i:4 + 3 * i]
        aa = leaves[0] if i == 0 else np.zeros_like(h)
        return lambda q: (np.concatenate([aa[:, q], v[:, q]], -1) if q < r
                          else np.concatenate([h[:, q - r], d[:, q - r]], -1))

    got = sum(_emulate_band(lv, y_rows(i), n) for i, lv in enumerate(fwd["levels"]))
    R, C = tmm._collapsed_axis_np(rs, *rec), tmm._collapsed_axis_np(cs, *rec)
    Y = np.zeros((n, R.shape[1], C.shape[1]))
    at_r = at_c = 0
    for i, (r, c) in enumerate(zip(rs, cs)):
        h, v, d = leaves[1 + 3 * i:4 + 3 * i]
        if i == 0:
            Y[:, :r, :c] = leaves[0]
        Y[:, at_r:at_r + r, at_c + c:at_c + 2 * c] = v
        Y[:, at_r + r:at_r + 2 * r, at_c:at_c + c] = h
        Y[:, at_r + r:at_r + 2 * r, at_c + c:at_c + 2 * c] = d
        at_r, at_c = at_r + 2 * r, at_c + 2 * c
    np.testing.assert_allclose(got, R @ Y @ C.T, atol=TOL, rtol=0)

    def jfn(*ls):
        return jmm.waverec2_collapsed(ls[0], [jt.Detail2D(*ls[1 + 3 * i:4 + 3 * i])
                                              for i in range(keep)], wavelet)

    want, vjp = jax.vjp(jfn, *(jnp.asarray(v, jnp.float32) for v in leaves))
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)
    g = _rng("k3plan-g", wavelet, hw).standard_normal(want.shape).astype(np.float32)
    grads = []
    for i, lv in enumerate(bwd["levels"]):
        q = _quadrants(_emulate_band(lv, lambda row: g[:, row].astype(np.float64), n))
        grads += ([q[:, 0]] if i == 0 else []) + [q[:, 2], q[:, 1], q[:, 3]]  # H, V, D
    for got_g, want_g in zip(grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got_g, np.asarray(want_g), atol=TOL, rtol=0)


@pytest.mark.parametrize("wavelet,hw,level,keep", K3_PLAN_CASES)
def test_k3_plan_blob_decodes_to_the_level_operators(wavelet, hw, level, keep):
    """Each level of K3's device plans, read back from the int32 blob the
    kernel reads at its PairLevel offsets, is R_l and C_l^T (forward) or
    R_l^T and C_l (backward) in float32, bit for bit."""
    _, rs, cs, rec, _ = _k3_setup(wavelet, hw, level, keep)
    plans = tmm.pair_band(rs, cs, *rec, torch.device("cpu"))
    Rb, Cb = tmm._level_blocks(rs, *rec), tmm._level_blocks(cs, *rec)
    for plan, backward in zip(plans, (False, True)):
        assert (plan.rows, plan.cols) == (rs, cs) and len(plan.levels) == keep
        blob = plan.blob.numpy()
        for lv, R, C in zip(plan.levels, Rb, Cb):
            fields = lv._asdict()
            m1, m2 = (R.T, C) if backward else (R, C.T)
            got1, got2 = _decode_band(blob, lv.tsrc, fields, _strip_perm(fields), m1.shape[0],
                                      m1.shape[1], m2.shape[1])
            np.testing.assert_array_equal(got1, m1.astype(np.float32))
            np.testing.assert_array_equal(got2, m2.astype(np.float32))
        assert plan.smem_bytes() <= kernels.MAX_SMEM


def test_k3_plans_at_the_paths_shapes():
    """db4 at the paths' collapsed levels: the forward tiles 16 row pairs
    (taps 16 at the coarse levels, 8 at the finest), the backward folds its
    strip by the taps' step (8, 4, 2 columns coarsest first) and takes up
    to 50 taps (16 in registers); the flagship's backward takes one stage
    (two would stage twice the rows of g), path 2's two; all within the
    shared-memory target (two blocks an SM)."""
    wv = tfilters.build_wavelet("db4")
    rec = (tuple(wv.rec_lo), tuple(wv.rec_hi))
    flag = tmm._pair_plans_np((34, 61, 115), (34, 61, 115), *rec)
    p2 = tmm._pair_plans_np((42, 77), (42, 77), *rec)
    assert [lv["rt"] for lv in flag[0]["levels"]] == [16] * 3
    assert [lv["k"] for lv in flag[0]["levels"]] == [16, 16, 8]
    assert [lv["fold_log2"] for lv in flag[1]["levels"]] == [3, 2, 1]
    assert [(lv["k"], lv["kc"]) for lv in flag[1]["levels"]] == [(50, 16), (22, 16), (8, 8)]
    assert [lv["fold_log2"] for lv in p2[1]["levels"]] == [2, 1]
    assert [p["stages"] for p in (*flag, *p2)] == [2, 1, 2, 2]
    for fwd, bwd in (flag, p2):
        for plan in (fwd, bwd):
            assert kernels.pair_smem_bytes(plan["stages"], plan["stage_words"],
                                           plan["strip_words"]) <= tmm.SMEM_TARGET
    assert (flag[0]["threads"], p2[0]["threads"]) == (256, 256)


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


# -- the 1D transform -------------------------------------------------------------


@pytest.mark.parametrize("n,level", [(7, 1), (37, 2), (101, 3)], ids=["pad-past-signal", "37", "101"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("wavelet", ["haar", "db2", "db6"])
def test_wavedec_waverec_1d_match_jax(wavelet, mode, n, level):
    """1D coefficients, the reconstruction of arbitrary coefficients, and
    both VJPs (analysis: the gradient w.r.t. the signal of a weighted sum of
    the coefficients; synthesis: the gradient w.r.t. every coefficient of a
    weighted sum of the reconstruction) against the JAX conv form, odd
    lengths, every mode; length 7 pads db6 past the signal."""
    rng = _rng("dec1", wavelet, mode, n)
    x = rng.standard_normal((2, 3, n)).astype(np.float32)
    # jitted: one compile a case instead of one per eager op and shape
    jc, jvjp = jax.vjp(jax.jit(lambda v: jt.wavedec(v, wavelet, level, mode)), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tc = tt.wavedec(xt, wavelet, level, mode)
    assert [tuple(t.shape) for t in tc] == [np.asarray(t).shape for t in jc]
    for g, w in zip(tc, jc):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=TOL, rtol=0)
    cot = [rng.standard_normal(np.asarray(t).shape).astype(np.float32) for t in jc]
    (want_dx,) = jvjp([jnp.asarray(c) for c in cot])
    (got_dx,) = torch.autograd.grad(tc, xt, [torch.from_numpy(c) for c in cot])
    np.testing.assert_allclose(_np(got_dx), np.asarray(want_dx), atol=TOL, rtol=0)

    leaves = [rng.standard_normal(c.shape).astype(np.float32) for c in cot]
    jr, rvjp = jax.vjp(jax.jit(lambda cs: jt.waverec(cs, wavelet)), [jnp.asarray(v) for v in leaves])
    lt = [torch.from_numpy(v).requires_grad_(True) for v in leaves]
    tr = tt.waverec(lt, wavelet)
    assert tuple(tr.shape) == np.asarray(jr).shape
    np.testing.assert_allclose(_np(tr), np.asarray(jr), atol=TOL, rtol=0)
    r = rng.standard_normal(np.asarray(jr).shape).astype(np.float32)
    (want_dc,) = rvjp(jnp.asarray(r))
    got_dc = torch.autograd.grad(tr, lt, torch.from_numpy(r))
    for g, w in zip(got_dc, want_dc):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=TOL, rtol=0)


@pytest.mark.parametrize("wavelet", ["haar", "db6"])
def test_waverec_1d_round_trip_and_idwt_lengths(wavelet):
    x = torch.from_numpy(_rng("rt1", wavelet).standard_normal((2, 1001)).astype(np.float32))
    rec = tt.waverec(tt.wavedec(x, wavelet, 4, "reflect"), wavelet)
    torch.testing.assert_close(rec[..., :1001], x, atol=1e-5, rtol=0)
    cA, cD = tt.dwt(x, wavelet, "symmetric")
    L = tfilters.build_wavelet(wavelet).filt_len
    assert cA.shape[-1] == (1001 + L - 1) // 2
    assert tt.idwt(cA, cD, wavelet).shape[-1] == 2 * cA.shape[-1] - L + 2
    assert tt.idwt(cA, cD, wavelet, out_len=1001).shape[-1] == 1001


def test_1d_bf16_in_f32_coefficients_out():
    x = torch.from_numpy(_rng("bf16-1d").standard_normal((2, 300)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    got, want = tt.wavedec(xb, "db6", 3), tt.wavedec(xb.float(), "db6", 3)
    assert all(t.dtype == torch.float32 for t in got)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    rec = tt.waverec([c.to(torch.bfloat16) for c in got], "db6")
    assert rec.dtype == torch.float32


def test_1d_transform_turns_tf32_off_and_restores_it():
    """The transform's convolutions run with cuDNN's TF32 off (the
    reference's Precision.HIGHEST), and the caller's setting comes back,
    also after an error."""
    prev = torch.backends.cudnn.allow_tf32
    seen = []
    try:
        torch.backends.cudnn.allow_tf32 = True
        with tt._f32_convs():
            seen.append(torch.backends.cudnn.allow_tf32)
        assert torch.backends.cudnn.allow_tf32 is True
        with pytest.raises(RuntimeError), tt._f32_convs():
            raise RuntimeError
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert seen == [False]


# -- boundary padding: the cached index map ----------------------------------------


@pytest.mark.parametrize("mode", ["reflect", "symmetric", "constant", "periodic"])
@pytest.mark.parametrize("n,pad", [(1, 3), (2, 7), (5, 11), (224, 7), (1000, 11)])
def test_pad_index_is_the_source_index_map(mode, n, pad):
    """The vectorized map equals `matmul._source_index` at every padded
    position, and is built once per (length, pad, mode, device)."""
    cpu = torch.device("cpu")
    got = tt._pad_index(n, pad, mode, cpu)
    want = [tmm._source_index(p, n, mode) for p in range(-pad, n + pad)]
    assert got.tolist() == want
    assert tt._pad_index(n, pad, mode, cpu) is got


@pytest.mark.parametrize("mode", MODES)
def test_pad_axes_2d_values_unchanged(mode):
    """The 2D padding through the cached map is bit for bit the per-call
    loop it replaced."""
    x = torch.from_numpy(_rng("pad2", mode).standard_normal((2, 3, 9, 6)).astype(np.float32))
    pad = 7
    if mode == "zero":
        want = torch.nn.functional.pad(x, (pad,) * 4)
    else:
        want = x
        for axis in (-2, -1):
            n = want.shape[axis]
            idx = torch.tensor([tmm._source_index(p, n, mode) for p in range(-pad, n + pad)])
            want = want.index_select(axis % want.ndim, idx)
    assert torch.equal(tt._pad_axes(x, pad, mode), want)
