"""Parity of the port's periodized transforms (`wam_tpu_torch.wavelets.
periodized`) with the JAX package: all twelve ``*_per`` functions in every
rank, every leaf held by name, and their VJPs against ``jax.vjp`` (the
reference's inverses are ``jax.linear_transpose`` of its forwards, the
port's the explicit adjoint).

Inputs are made with numpy from a seed. Both sides compute in float32 in
another summation order; values of O(1) agree to ~1e-6 and the bound is
1e-5 of the larger of 1 and the reference's largest value.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wam_tpu.wavelets import periodized as jp
from wam_tpu_torch.wavelets import filters as tfilters
from wam_tpu_torch.wavelets import periodized as tp
from wam_tpu_torch.wavelets.transform import Detail2D

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

TOL = 1e-5
WAVELETS = ["haar", "db4", "sym8"]
# the shapes of each rank: a batch axis and sides of 32 (two levels of sym8
# need 32 -> 16 >= L - 2 = 14)
SHAPES = {1: (3, 32), 2: (2, 32, 32), 3: (2, 32, 32, 32)}
FNS = {1: ("dwt_per", "idwt_per", "wavedec_per", "waverec_per"),
       2: ("dwt2_per", "idwt2_per", "wavedec2_per", "waverec2_per"),
       3: ("dwt3_per", "idwt3_per", "wavedec3_per", "waverec3_per")}


def _j(name: str, wavelet: str, *static):
    """The reference function ``name`` jitted for one wavelet (one compile
    per call signature; op-by-op dispatch compiles every op)."""
    fn = getattr(jp, name)
    return jax.jit(lambda *a: fn(*a, wavelet, *static))


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _named(level) -> dict:
    """One level's leaves by name: a 1D detail, a Detail2D, or a 3D dict."""
    if isinstance(level, dict):
        return dict(level)
    if hasattr(level, "_fields"):
        return dict(zip(level._fields, level))
    return {"d": level}


def _flat(out) -> dict:
    """Every leaf of a single level (cA, detail) or of a coefficient list,
    keyed by level and name."""
    if isinstance(out, tuple) and not hasattr(out, "_fields"):
        cA, det = out
        return {"cA": cA, **{f"1/{k}": v for k, v in _named(det).items()}}
    flat = {"cA": out[0]}
    for i, det in enumerate(out[1:]):
        flat.update({f"{i}/{k}": v for k, v in _named(det).items()})
    return flat


def _close(got, want, what: str):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=TOL * max(1.0, np.abs(want).max()), rtol=0,
                               err_msg=what)


def _hold(got: dict, want: dict, what: str):
    assert sorted(got) == sorted(want), what
    for k in want:
        _close(got[k].detach().numpy(), want[k], f"{what} {k}")


def _like(rng, coeffs_j, tdetail):
    """Random numpy leaves shaped like a JAX single level (cA, detail), and
    the same leaves as (jax, torch) structures."""
    cA, det = coeffs_j
    a = rng.standard_normal(cA.shape).astype(np.float32)
    named = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in _named(det).items()}
    if isinstance(det, dict):
        jdet, tdet = ({k: jnp.asarray(v) for k, v in named.items()},
                      {k: torch.from_numpy(v) for k, v in named.items()})
    elif hasattr(det, "_fields"):
        jdet = type(det)(**{k: jnp.asarray(v) for k, v in named.items()})
        tdet = tdetail(**{k: torch.from_numpy(v) for k, v in named.items()})
    else:
        jdet, tdet = jnp.asarray(named["d"]), torch.from_numpy(named["d"])
    return (jnp.asarray(a), jdet), (torch.from_numpy(a), tdet)


def _like_list(rng, coeffs):
    """Random leaves shaped like a JAX coefficient list, as (jax, torch)."""
    jl, tl = [], []
    a = rng.standard_normal(coeffs[0].shape).astype(np.float32)
    jl.append(jnp.asarray(a))
    tl.append(torch.from_numpy(a))
    for det in coeffs[1:]:
        (_, jd), (_, td) = _like(rng, (coeffs[0], det), Detail2D)
        jl.append(jd)
        tl.append(td)
    return jl, tl


@pytest.mark.parametrize("wavelet", WAVELETS)
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_periodized_transforms_match_jax(rank, wavelet):
    """Single level and two levels, forward and inverse, each leaf by name;
    the round trip of the port is exact to float32."""
    rng = _rng("per", rank, wavelet)
    dwt, idwt, dec, rec = FNS[rank]
    x = rng.standard_normal(SHAPES[rank]).astype(np.float32)
    xt = torch.from_numpy(x)

    want = _j(dwt, wavelet)(jnp.asarray(x))
    got = getattr(tp, dwt)(xt, wavelet)
    _hold(_flat(got), _flat(want), dwt)

    (ja, jd), (ta, td) = _like(rng, want, Detail2D)
    inv = _j(idwt, wavelet)(ja, jd)
    _close(getattr(tp, idwt)(ta, td, wavelet).numpy(), inv, idwt)

    want_l = _j(dec, wavelet, 2)(jnp.asarray(x))
    got_l = getattr(tp, dec)(xt, wavelet, 2)
    _hold(_flat(got_l), _flat(want_l), dec)
    _close(getattr(tp, rec)(got_l, wavelet).numpy(), x, f"{rec} round trip")
    jl, tl = _like_list(rng, want_l)
    _close(getattr(tp, rec)(tl, wavelet).numpy(), _j(rec, wavelet)(jl), rec)


@pytest.mark.parametrize("wavelet", WAVELETS)
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_periodized_vjps_match_jax(rank, wavelet):
    """The gradients of each forward and each inverse, single level and two
    levels, against ``jax.vjp`` on the same cotangents."""
    rng = _rng("vjp", rank, wavelet)
    dwt, idwt, dec, rec = FNS[rank]
    x = rng.standard_normal(SHAPES[rank]).astype(np.float32)

    for fwd, levels in ((dwt, None), (dec, 2)):
        args = () if levels is None else (levels,)
        fn = _j(fwd, wavelet, *args)
        out = jax.eval_shape(fn, jnp.asarray(x))
        cot = jax.tree_util.tree_map(
            lambda leaf: jnp.asarray(rng.standard_normal(leaf.shape).astype(np.float32)), out)
        (want,) = jax.jit(lambda v, c: jax.vjp(fn, v)[1](c))(jnp.asarray(x), cot)
        xt = torch.from_numpy(x).requires_grad_(True)
        leaves = _flat(getattr(tp, fwd)(xt, wavelet, *args))
        cots = _flat(cot)
        (got,) = torch.autograd.grad([leaves[k] for k in cots],
                                     xt, [torch.tensor(np.asarray(v)) for v in cots.values()])
        _close(got.numpy(), want, f"vjp of {fwd}")

    (ja, jd), (ta, td) = _like(rng, jax.eval_shape(_j(dwt, wavelet), jnp.asarray(x)), Detail2D)
    fn = _j(idwt, wavelet)
    g = rng.standard_normal(jax.eval_shape(fn, ja, jd).shape).astype(np.float32)
    want = jax.jit(lambda a, d, c: jax.vjp(fn, a, d)[1](c))(ja, jd, jnp.asarray(g))
    ins = [ta.requires_grad_(True)] + [t.requires_grad_(True) for t in _named(td).values()]
    got = torch.autograd.grad(getattr(tp, idwt)(ta, td, wavelet), ins, torch.from_numpy(g))
    _hold(dict(zip(["cA"] + [f"1/{k}" for k in _named(td)], got)),
          _flat((want[0], want[1])), f"vjp of {idwt}")

    jl, tl = _like_list(rng, jax.eval_shape(_j(dec, wavelet, 2), jnp.asarray(x)))
    fn = _j(rec, wavelet)
    g = rng.standard_normal(jax.eval_shape(fn, jl).shape).astype(np.float32)
    (want,) = jax.jit(lambda c, gg: jax.vjp(fn, c)[1](gg))(jl, jnp.asarray(g))
    ins = [t.requires_grad_(True) for t in _flat(tl).values()]
    got = torch.autograd.grad(getattr(tp, rec)(tl, wavelet), ins, torch.from_numpy(g))
    _hold(dict(zip(_flat(tl), got)), _flat(want), f"vjp of {rec}")


@pytest.mark.parametrize("wavelet", WAVELETS)
def test_smallest_legal_length_and_the_errors(wavelet):
    """N = L - 2 (haar: 2) is the reference's shortest axis: its one-time
    wrap then copies the whole signal. A shorter even axis, and an odd one,
    raise in both packages."""
    L = tfilters.build_wavelet(wavelet).filt_len
    n = max(L - 2, 2)
    x = _rng("small", wavelet).standard_normal((2, n)).astype(np.float32)
    want = jp.dwt_per(jnp.asarray(x), wavelet)
    got = tp.dwt_per(torch.from_numpy(x), wavelet)
    for g, w in zip(got, want):
        _close(g.numpy(), w, "dwt_per at N = L - 2")
    _close(tp.idwt_per(*got, wavelet).numpy(), jp.idwt_per(*want, wavelet), "idwt_per")
    _close(tp.idwt_per(*got, wavelet).numpy(), x, "round trip at N = L - 2")
    bad = [n + 1] + ([n - 2] if L > 4 else [])
    for m in bad:
        xm = np.zeros((2, m), np.float32)
        with pytest.raises((ValueError, TypeError)):
            jp.dwt_per(jnp.asarray(xm), wavelet)
        with pytest.raises(ValueError):
            tp.dwt_per(torch.from_numpy(xm), wavelet)


def test_periodized_float64_and_bf16():
    """float64 stays float64 (an orthogonal round trip to 1e-12); bf16 input
    gives float32 coefficients."""
    x = torch.from_numpy(_rng("f64").standard_normal((2, 3, 16, 16)))
    coeffs = tp.wavedec2_per(x, "db4", 2)
    assert coeffs[0].dtype == torch.float64
    assert float((tp.waverec2_per(coeffs, "db4") - x).abs().max()) < 1e-12
    bf = tp.dwt2_per(x.to(torch.bfloat16), "db4")
    assert bf[0].dtype == torch.float32 and bf[1].diagonal.dtype == torch.float32
