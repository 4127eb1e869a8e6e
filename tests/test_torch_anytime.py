"""Parity of the port's anytime attribution (`wam_tpu_torch.anytime`,
`core.estimators.resolve_checkpoint_stride`,
`WaveletAttribution2D.anytime_serve_entry`) with the JAX package's, and the
port's own contracts: the finalized map bit-equal for every stride, one
result fetch a call, a zero deadline stops after one stride.

Per-sample contributions are input gradients of the reference's toy conv
models (their kernels handed across) at numpy or ``jax.random.fold_in``
noise handed to both packages.

Tolerances: M2 and the confidence vector 1e-6 of their scale (float32 sums
in another order); an entry's finalized map 1e-5 of its largest value;
WAM-2D's anytime mosaic 1e-4 of its largest value against the reference,
1e-6 against the port's own streamed SmoothGrad (the order of the sample
sum); counts, flags and strides exact.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wam_tpu import anytime as ja
from wam_tpu import wam2d as jwam
from wam_tpu.core import estimators as jest
from wam_tpu.models.toy import toy_conv_model as jtoy
from wam_tpu.wavelets import transform as jt
from wam_tpu_torch import anytime as ta
from wam_tpu_torch import wam2d as twam
from wam_tpu_torch.anytime import state as tstate
from wam_tpu_torch.core import estimators as test
from wam_tpu_torch.evalsuite import fan as tfan
from wam_tpu_torch.models.toy import toy_conv_model as ttoy
from wam_tpu_torch.wavelets.transform import Detail2D


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel_close(got, want, tol, tag=""):
    got, want = np.asarray(_np(got), np.float64), np.asarray(_np(want), np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), (tag, got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30), (
        tag, np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", autouse=True)
def jax_default_route():
    """The JAX transforms on their default route, the knobs put back after."""
    saved = jt.get_dwt2_impl(), jt.get_synth2_impl()
    jt.set_dwt2_impl("auto")
    jt.set_synth2_impl("auto")
    yield
    jt.set_dwt2_impl(saved[0])
    jt.set_synth2_impl(saved[1])


# -- the checkpoint math ---------------------------------------------------------------------


def _stream(n, shapes, seed):
    rng = _rng("stream", seed)
    return [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(n)]


def test_resolve_checkpoint_stride_matches_jax():
    for stride, n in ((3, 25), (100, 25), ("7", 25), ("auto", 25), ("auto", 3), (1, 1),
                      (5, 0), ("auto", 0)):
        assert test.resolve_checkpoint_stride(stride, n) == jest.resolve_checkpoint_stride(
            stride, n), (stride, n)
    assert test.resolve_checkpoint_stride("auto", 25, default=7) == 7
    # the workload keys are accepted; the tuned lookup waits for slice E
    assert test.resolve_checkpoint_stride("auto", 25, workload="wam2d", shape=(3, 32, 32),
                                          batch=4, dtype="bf16") == 5
    for bad in (0, -2, "0"):
        with pytest.raises(ValueError) as want:
            jest.resolve_checkpoint_stride(bad, 25)
        with pytest.raises(ValueError) as got:
            test.resolve_checkpoint_stride(bad, 25)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("tree", ["tensor", "detail2d", "dict"])
def test_m2_update_and_conf_stats_match_jax(tree):
    """Welford M2 over consecutive sum accumulators and the confidence vector
    at every checkpoint of a 7-sample stream (stride 3), on a tensor, a
    Detail2D-shaped list and a dict tree."""
    shapes = {"tensor": [(3, 10)], "detail2d": [(3, 4, 4)] * 4,
              "dict": [(3, 2, 5), (3, 7)]}[tree]
    stream = _stream(7, shapes, tree)

    def pack(leaves, lib):
        if tree == "tensor":
            return leaves[0]
        if tree == "detail2d":
            return [leaves[0], Detail2D(*leaves[1:])] if lib is torch else [
                leaves[0], tuple(leaves[1:])]
        return {"b": leaves[0], "a": leaves[1]}

    conv_j = lambda ls: pack([jnp.asarray(v) for v in ls], jnp)  # noqa: E731
    conv_t = lambda ls: pack([torch.tensor(v) for v in ls], torch)  # noqa: E731
    acc_j, acc_t = conv_j([np.zeros(s, np.float32) for s in shapes]), conv_t(
        [np.zeros(s, np.float32) for s in shapes])
    m2_j, m2_t = jnp.zeros((3,), jnp.float32), torch.zeros(3)
    prev_j, prev_t, prev_n = acc_j, acc_t, 0
    for i, g in enumerate(stream):
        new_j = jax.tree_util.tree_map(lambda a, b: a + b, acc_j, conv_j(g))
        new_t = tstate.tree_map(lambda a, b: a + b, acc_t, conv_t(g))
        m2_j = ja.m2_update(m2_j, acc_j, new_j, jnp.asarray(i, jnp.float32))
        m2_t = ta.m2_update(m2_t, acc_t, new_t, i)
        _rel_close(m2_t, m2_j, 1e-6, f"m2 {i}")
        acc_j, acc_t = new_j, new_t
        if (i + 1) % 3 == 0 or i == len(stream) - 1:
            want = ja.conf_stats(acc_j, m2_j, float(i + 1), prev_j, float(prev_n))
            got = ta.conf_stats(acc_t, m2_t, i + 1, prev_t, prev_n)
            assert got.shape == (3, ta.ANYTIME_VEC_SIZE)
            _rel_close(got, want, 1e-6, f"conf {i}")
            prev_j, prev_t, prev_n = acc_j, acc_t, i + 1
    assert tstate.tree_row_elems(acc_t) == sum(int(np.prod(s[1:])) for s in shapes)


def test_first_sample_and_no_checkpoint_edges():
    z = torch.zeros(3, 10)
    torch.testing.assert_close(ta.m2_update(torch.zeros(3), z, z + 1.0, 0), torch.zeros(3))
    cv = ta.conf_stats(z + 1.0, torch.ones(3), 6, z, 0)
    torch.testing.assert_close(cv[:, ta.SLOT_DELTA], torch.ones(3))
    assert bool((cv[:, ta.SLOT_CONFIDENCE] <= 0.5).all())
    cv1 = ta.conf_stats(z + 1.0, torch.ones(3), 1, z, 0)  # one sample: rel_sem pinned at 1
    torch.testing.assert_close(cv1[:, ta.SLOT_REL_SEM], torch.ones(3))


# -- entries and the stride loop ----------------------------------------------------------


@pytest.fixture(scope="module")
def wave():
    """The reference's toy waveform model and the port's with its kernel,
    2 waveforms of 256 samples, labels, and 40 samples of numpy noise."""
    key = jax.random.PRNGKey(0)
    kern = np.asarray(jax.random.normal(key, (4, 1, 9), jnp.float32) * 0.3)
    x = _rng("wave").standard_normal((2, 256)).astype(np.float32)
    noise = _rng("wnoise").standard_normal((40, 2, 256)).astype(np.float32)
    return jtoy(key, ndim=1, taps=9), ttoy(kern, ndim=1, taps=9, device="cpu"), x, \
        np.array([0, 1]), noise


def _jax_sample_fn(model, noise, sigma=0.05):
    def sample_fn(x, y, i):
        noisy = x + sigma * jnp.asarray(noise)[jnp.minimum(i, noise.shape[0] - 1)]
        return jax.grad(lambda v: model(v)[jnp.arange(v.shape[0]), y].sum())(noisy)

    return sample_fn


def _torch_sample_fn(model, noise, sigma=0.05, calls=None):
    def sample_fn(x, y, i):
        if calls is not None:
            calls.append(i)
        leaf = (x + sigma * torch.from_numpy(noise[i])).requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad(model(leaf).gather(1, y[:, None]).sum(), leaf)[0]

    return sample_fn


@pytest.mark.parametrize("n_total,stride", [(11, 4), (12, 4), (5, 5)])
def test_anytime_entry_and_run_match_jax(wave, n_total, stride):
    """`make_anytime_entry` + `run_anytime` against the reference's: the
    map, the confidence vector, ``n_used``, the flags and the strides; a
    non-dividing tail stride stops at ``n_total`` (no sample past it is
    drawn); one result fetch; ``entry(x, y)`` is the full-n map."""
    jm, tm, x, y, noise = wave
    jent = ja.make_anytime_entry(_jax_sample_fn(jm, noise), n_total=n_total, stride=stride)
    calls = []
    tent = ta.make_anytime_entry(_torch_sample_fn(tm, noise, calls=calls), n_total=n_total,
                                 stride=stride)
    assert tent.wam_anytime and tent.n_strides() == jent.n_strides()
    want = ja.run_anytime(jent, jnp.asarray(x), jnp.asarray(y))
    with tfan.fetch_scope() as fs:
        got = ta.run_anytime(tent, torch.from_numpy(x), torch.from_numpy(y))
    assert fs.count == 1 and calls == list(range(n_total))
    for key in ("n_used", "n_total", "complete", "converged", "strides", "deadline_hit"):
        assert getattr(got, key) == getattr(want, key), key
    _rel_close(got.out, want.out, 1e-5, "map")
    _rel_close(got.conf, want.conf, 1e-5, "conf")
    assert len(got.stride_s) == len(got.sync_s) == got.strides
    assert torch.equal(tent(torch.from_numpy(x), torch.from_numpy(y)), torch.from_numpy(got.out))


def test_convergence_early_exit_matches_jax(wave):
    jm, tm, x, y, noise = wave
    kw = dict(n_total=40, stride=4, plateau_tol=10.0)
    want = ja.run_anytime(ja.make_anytime_entry(_jax_sample_fn(jm, noise), **kw),
                          jnp.asarray(x), jnp.asarray(y))
    got = ta.run_anytime(ta.make_anytime_entry(_torch_sample_fn(tm, noise), **kw),
                         torch.from_numpy(x), torch.from_numpy(y))
    assert got.converged and want.converged and got.n_used == want.n_used < 40
    _rel_close(got.conf, want.conf, 1e-5, "conf")
    # a confidence floor no row clears keeps it running to the end
    full = ta.run_anytime(ta.make_anytime_entry(_torch_sample_fn(tm, noise), **kw),
                          torch.from_numpy(x), torch.from_numpy(y), min_confidence=1.1)
    assert full.complete and not full.converged and full.n_used == 40


def test_entry_errors_match_jax():
    for kw in ({"n_total": 4, "stride": 5}, {"n_total": 0}, {"n_total": 4, "stride": 0}):
        with pytest.raises(ValueError) as want:
            ja.make_anytime_entry(lambda x, y, i: x, **kw)
        with pytest.raises(ValueError) as got:
            ta.make_anytime_entry(lambda x, y, i: x, **kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n_total", [10, 7])
def test_finalized_map_is_bit_equal_for_every_stride(wave, n_total):
    """Strides 1, 5 and n add the same samples in the same order: the
    finalized maps are equal bit for bit, and so is a tree's."""
    _, tm, x, y, noise = wave
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    outs = []
    for stride in (1, min(5, n_total), n_total):
        fn = _torch_sample_fn(tm, noise)
        ent = ta.make_anytime_entry(lambda a, b, i: [fn(a, b, i), {"sq": fn(a, b, i) ** 2}],
                                    n_total=n_total, stride=stride)
        outs.append(ta.run_anytime(ent, xt, yt).out)
    for out in outs[1:]:
        for a, b in zip((outs[0][0], outs[0][1]["sq"]), (out[0], out[1]["sq"])):
            assert np.array_equal(a, b)


def test_zero_deadline_stops_after_one_stride(wave):
    _, tm, x, y, noise = wave
    ent = ta.make_anytime_entry(_torch_sample_fn(tm, noise), n_total=20, stride=5)
    res = ta.run_anytime(ent, torch.from_numpy(x), torch.from_numpy(y), deadline_ms=0)
    assert res.strides == 1 and res.deadline_hit and res.n_used == 5 and not res.complete
    assert res.conf.shape == (2, ta.ANYTIME_VEC_SIZE) and (res.conf[:, ta.SLOT_COUNT] == 5).all()
    r = ta.AnytimeResult(res.out, float(res.conf[0, ta.SLOT_CONFIDENCE]), res.n_used, 20, False,
                         False)
    assert r.meets(0.0) and not r.meets(1.01)


# -- WaveletAttribution2D.anytime_serve_entry ---------------------------------------------


@pytest.fixture(scope="module")
def wam2d():
    key = jax.random.PRNGKey(0)
    kern = np.asarray(jax.random.normal(key, (4, 1, 5, 5), jnp.float32) * 0.3)
    jm, tm = jtoy(key, ndim=2), ttoy(kern, ndim=2, device="cpu")
    x = _rng("x2").standard_normal((2, 1, 16, 16)).astype(np.float32)
    return (lambda v: jm(v.mean(axis=1))), (lambda v: tm(v.mean(dim=1))), x, np.array([1, 2])


def test_wam2d_anytime_serve_entry_matches_jax(wam2d):
    """The reference's entry (its ``fold_in`` draws) against the port's with
    those draws handed over, through the kernels' plain versions; and the
    port's full-n map against its own SmoothGrad on the same noise (handed
    over, and streamed from `sample_noise`)."""
    jfn, tfn, x, y = wam2d
    jw = jwam.WaveletAttribution2D(jfn, J=2, n_samples=6, random_seed=3)
    tw = twam.WaveletAttribution2D(tfn, J=2, n_samples=6, random_seed=3, device="cpu",
                                   impl="kernel")
    jent = jw.anytime_serve_entry(stride=3)
    key = jax.random.PRNGKey(3)
    z = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i), x.shape))
                  for i in range(6)])
    tent = tw.anytime_serve_entry(stride=3, noise=torch.from_numpy(z))
    assert (tent.n_total, tent.stride) == (jent.n_total, jent.stride) == (6, 3)
    want = ja.run_anytime(jent, jnp.asarray(x), jnp.asarray(y))
    got = ta.run_anytime(tent, torch.from_numpy(x), torch.from_numpy(y))
    assert got.complete and got.n_used == want.n_used == 6 and got.out.shape == (2, 16, 16)
    _rel_close(got.out, want.out, 1e-4, "anytime mosaic")
    own = tw.smooth_wam(torch.from_numpy(x), torch.from_numpy(y), noise=torch.from_numpy(z))
    _rel_close(got.out, own, 1e-6, "against smooth_wam, same noise")
    streamed = twam.WaveletAttribution2D(tfn, J=2, n_samples=6, random_seed=3, device="cpu",
                                         stream_noise=True, sample_batch_size=4)
    default = ta.run_anytime(tw.anytime_serve_entry(), torch.from_numpy(x), torch.from_numpy(y))
    assert default.strides == 2  # "auto": 5, clamped to n = 6 -> 2 strides
    _rel_close(default.out, streamed(torch.from_numpy(x), torch.from_numpy(y)), 1e-6,
               "against streamed smooth_wam")


def test_wam2d_anytime_serve_entry_rejects_as_jax(wam2d):
    jfn, tfn, *_ = wam2d
    with pytest.raises(ValueError) as want:
        jwam.WaveletAttribution2D(jfn, method="integratedgrad").anytime_serve_entry()
    with pytest.raises(ValueError) as got:
        twam.WaveletAttribution2D(tfn, method="integratedgrad", device="cpu").anytime_serve_entry()
    assert str(got.value) == str(want.value)
    jw, tw = jwam.WaveletAttribution2D(jfn), twam.WaveletAttribution2D(tfn, device="cpu")
    jw.mesh = tw.mesh = object()
    with pytest.raises(ValueError) as want:
        jw.anytime_serve_entry()
    with pytest.raises(ValueError) as got:
        tw.anytime_serve_entry()
    assert str(got.value) == str(want.value)
