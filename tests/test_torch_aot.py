"""The compiled-step cache (`wam_tpu_torch.pipeline.aot`) against the
reference's `wam_tpu.pipeline.aot` (`tests/test_pipeline.py`'s AOT half):
the key formats (signatures, entry-path digests) equal the reference's,
the sentinel's miss -> export -> hit -> registry_hit sequence equals the
reference's for the same scenario, a miss compiles once and a fresh
consumer (`torch._dynamo.reset()` and an empty Inductor directory) compiles
nothing (AOTAutograd's and Inductor's miss counters), stale / corrupt /
foreign entries read as misses, the kill switch, the per-signature
dispatch; `torch.library.opcheck` on every kernel operator; a toy WAM-2D
pass through `cached_jit` against the reference's in float32 and float64;
and the consumers: a server warming from a warm cache at zero compiles and
a cached AUC runner.

Every test points the caches at its own directories. The first Inductor
compile of a process pays the C++ toolchain's warm-up (~20 s on a CPU)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch._inductor.config
import torch.nn.functional as F
from jax import lax
from torch._dynamo.utils import counters

from wam_tpu.obs import sentinel as jsentinel
from wam_tpu.pipeline import aot as jaot
from wam_tpu_torch.obs import sentinel
from wam_tpu_torch.ops import graph_const
from wam_tpu_torch.pipeline import aot
from wam_tpu_torch.tune import fused_relu as tfr
from wam_tpu_torch.wavelets import matmul as tmm
from wam_tpu_torch.wavelets import transform as tt

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

T = 120  # seconds a served future is waited on


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Cache directories of the test's own; ``fresh()`` makes this process a
    fresh consumer: Dynamo reset, an empty Inductor directory."""
    n = [0]

    def fresh():
        n[0] += 1
        d = tmp_path / f"inductor{n[0]}"
        monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", str(d))
        monkeypatch.setenv("TRITON_CACHE_DIR", str(d / "triton"))
        torch._dynamo.reset()
        return d

    monkeypatch.setenv("WAM_TPU_AOT_CACHE", str(tmp_path / "aot"))
    monkeypatch.setenv("WAM_TPU_CACHE_DIR", str(tmp_path / "compile"))
    monkeypatch.delenv("WAM_TPU_NO_AOT_CACHE", raising=False)
    # one compile process: the suite's workers share the machine
    monkeypatch.setattr(torch._inductor.config, "compile_threads", 1)
    fresh()
    yield type("Caches", (), {"root": tmp_path, "aot": str(tmp_path / "aot"),
                              "fresh": staticmethod(fresh)})
    torch._dynamo.reset()


def _mul_add(a, b):
    return a * 2.0 + b


def _args():
    return torch.arange(8.0), torch.ones(8)


def _misses() -> int:
    return (counters["aot_autograd"]["autograd_cache_miss"]
            + counters["inductor"]["fxgraph_cache_miss"])


# -- formats ---------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    (np.arange(8, dtype=np.float32), np.ones((8,), np.float32)),
    (np.zeros((2, 3), np.int32), None),
    (np.zeros((8, 3, 224, 224), np.float32), None, np.zeros((8,), np.int32)),
])
def test_signature_and_entry_path_match_the_reference(case):
    want = jaot.aval_signature(case)
    assert aot.aval_signature(case) == want
    as_torch = tuple(None if a is None else torch.from_numpy(a) for a in case)
    assert aot.aval_signature(as_torch) == want
    for key in ("k1", f"prewarm|{want}|cuda", "x" * 300):
        assert aot.aot_entry_path(key, "/d") == jaot.aot_entry_path(key, "/d")
    assert aot.AOT_CACHE_VERSION == jaot.AOT_CACHE_VERSION


def test_the_event_sequence_matches_the_reference(caches):
    """miss -> export, a fresh consumer's hit, and an entry seeded as a
    registry hydration would seed it: registry_hit, on both sides."""
    events = {}
    jdir, jdir2 = str(caches.root / "jaot"), str(caches.root / "jaot2")
    jargs = (jnp.arange(8.0), jnp.ones((8,)))
    jsentinel.clear_events()
    jaot.cached_jit(_mul_add, jargs, "k", cache_dir=jdir)(*jargs)
    jaot.cached_jit(_mul_add, jargs, "k", cache_dir=jdir)(*jargs)
    payload, header = jaot.read_aot_payload("k", jdir)
    jaot.seed_aot_payload("k", payload, jdir2)
    jaot.cached_jit(_mul_add, jargs, "k", cache_dir=jdir2)(*jargs)
    events["ref"] = [r["aot_event"] for r in jsentinel.aot_events()]

    sentinel.clear_events()
    aot.cached_jit(_mul_add, _args(), "k")(*_args())
    caches.fresh()
    aot.cached_jit(_mul_add, _args(), "k")(*_args())
    payload, header = aot.read_aot_payload("k")
    aot.seed_aot_payload("k", payload, str(caches.root / "aot2"))
    caches.fresh()
    fn = aot.cached_jit(_mul_add, _args(), "k", cache_dir=str(caches.root / "aot2"))
    fn(*_args())
    events["port"] = [r["aot_event"] for r in sentinel.aot_events()]
    assert events["port"] == events["ref"] == ["miss", "export", "hit", "registry_hit"]
    assert fn.aot_status == "registry_hit" and fn.compiles == 0
    assert sentinel.trace_count() == 1  # the one compile, the miss's


def test_a_miss_compiles_once_and_a_fresh_consumer_compiles_nothing(caches):
    traces = []
    fn1 = aot.cached_jit(_mul_add, _args(), "k1", on_trace=lambda: traces.append("a"))
    out1 = fn1(*_args())
    assert traces == ["a"] and fn1.compiles == 1 and fn1.aot_status == "exported"
    assert aot.load_aot("k1") is not None
    caches.fresh()
    misses, hits = _misses(), counters["inductor"]["fxgraph_cache_hit"]
    fn2 = aot.cached_jit(_mul_add, _args(), "k1", on_trace=lambda: traces.append("b"))
    out2 = fn2(*_args())
    assert traces == ["a"] and fn2.compiles == 0 and fn2.aot_status == "hit"
    assert _misses() == misses and counters["inductor"]["fxgraph_cache_hit"] > hits
    torch.testing.assert_close(out1, out2)
    torch.testing.assert_close(out2, torch.arange(8.0) * 2 + 1)
    assert aot.graph_breaks() == 0


def test_a_process_that_assigned_the_precision_flags_still_hits(caches):
    """The compile caches key a program on whether ``allow_tf32`` was ever
    assigned ('none' until then, 'ieee' after, for the same float32
    matmuls): a consumer that assigned it (the 3D synthesis does) must hit
    what a process that never did exported."""
    saved = torch.backends.cuda.matmul.fp32_precision
    try:
        torch.backends.cuda.matmul.fp32_precision = "none"  # never assigned
        aot.cached_jit(_mul_add, _args(), "k5")(*_args())
        torch.backends.cuda.matmul.allow_tf32 = False  # now 'ieee', the same matmuls
        caches.fresh()
        fn = aot.cached_jit(_mul_add, _args(), "k5")
        fn(*_args())
        assert fn.aot_status == "hit" and fn.compiles == 0
    finally:
        torch.backends.cuda.matmul.fp32_precision = saved


def _stale(path):
    raw = open(path, "rb").read()
    header_line, _, payload = raw.partition(b"\n")
    header = json.loads(header_line)
    header["version"] += 1
    open(path, "wb").write(json.dumps(header).encode() + b"\n" + payload)


def _corrupt(path):
    header_line, _, payload = open(path, "rb").read().partition(b"\n")
    open(path, "wb").write(header_line + b"\n" + payload[: len(payload) // 2] + b"\x00" * 9)


def _foreign(path):
    header_line, _, payload = open(path, "rb").read().partition(b"\n")
    header = json.loads(header_line)
    header["platform"] = {**header["platform"], "device": "another card"}
    open(path, "wb").write(json.dumps(header).encode() + b"\n" + payload)


def _garbage(path):
    open(path, "wb").write(b"not a cache entry")


@pytest.mark.parametrize("spoil", [_stale, _corrupt, _foreign, _garbage],
                         ids=["stale", "corrupt", "platform", "garbage"])
def test_spoiled_entries_read_as_a_miss(caches, spoil):
    aot.cached_jit(_mul_add, _args(), "k2")(*_args())
    spoil(aot.aot_entry_path("k2"))
    assert aot.load_aot("k2") is None and aot.load_aot_meta("k2") == (None, None)
    caches.fresh()
    traces = []
    fn = aot.cached_jit(_mul_add, _args(), "k2", on_trace=lambda: traces.append(1))
    torch.testing.assert_close(fn(*_args()), torch.arange(8.0) * 2 + 1)
    assert traces == [1] and fn.aot_status == "exported"  # re-exported, not errored


def test_the_kill_switch(caches, monkeypatch):
    monkeypatch.setenv("WAM_TPU_NO_AOT_CACHE", "1")
    traces = []
    fn = aot.cached_jit(_mul_add, _args(), "k4", on_trace=lambda: traces.append(1))
    torch.testing.assert_close(fn(*_args()), torch.arange(8.0) * 2 + 1)
    assert traces == [1] and fn.aot_status == "disabled"  # compiled, nothing written
    assert aot.list_aot_entries() == []


def test_cached_entry_dispatches_per_signature(caches):
    traces = []
    entry = aot.cached_entry(lambda x: x * 3.0, "base", on_trace=lambda: traces.append(1))
    entry(torch.ones(4))
    entry(torch.ones(8))
    entry(torch.ones(4))  # the same signature: no new program
    assert len(traces) == 2 and len(aot.list_aot_entries()) == 2
    assert sorted(e["key"] for e in aot.list_aot_entries()) == [
        "base|float32[4]|cpu", "base|float32[8]|cpu"]
    caches.fresh()
    fresh = aot.cached_entry(lambda x: x * 3.0, "base", on_trace=lambda: traces.append(1))
    torch.testing.assert_close(fresh(torch.ones(4)), torch.full((4,), 3.0))
    torch.testing.assert_close(fresh(torch.ones(8)), torch.full((8,), 3.0))
    assert len(traces) == 2  # both signatures hit


# -- the kernels as operators -------------------------------------------------------


def _op_cases():
    lo, hi, rlo, rhi = tmm._taps("db2")
    g = torch.Generator().manual_seed(0)

    def r(*shape, grad=True):
        return torch.randn(shape, generator=g).requires_grad_(grad)

    sizes = [5, 8]
    leaves = [r(2, 5, 5)] + [r(2, s, s) for s in sizes for _ in range(3)]
    return {
        "dwt2": (tmm.dwt2_op, (r(3, 12, 10), lo, hi, "reflect")),
        "dwt2_adjoint": (tmm.dwt2_adjoint_op, (r(3, 4, 7, 6, grad=False), 12, 10, lo, hi,
                                               "reflect")),
        "synth2": (tmm.synth2_op, (r(3, 4, 6, 5), rlo, rhi)),
        "synth2_bwd": (tmm.synth2_bwd_op, (r(3, 10, 8, grad=False), 6, 5, rlo, rhi)),
        "pair": (tmm.pair_op, (leaves, sizes, sizes, rlo, rhi)),
        "pair_bwd": (tmm.pair_bwd_op, (r(2, 14, 14, grad=False), sizes, sizes, rlo, rhi)),
        "relu_fwd": (tfr.relu_fwd_op, (r(5, 300),)),
        "relu_bwd": (tfr.relu_bwd_op, (tfr.relu_fwd_plain(torch.randn(5, 300))[1],
                                      r(5, 300, grad=False))),
        # the 1D / 3D levels (wavelets/transform.py) and the host-built constants
        "dwt1": (tt._level_op, (r(3, 37), "dwt1", "db2", "reflect", "conv", [])),
        "dwt1_folded": (tt._level_op, (r(3, 37), "dwt1", "db2", "reflect", "folded_nhc", [])),
        "idwt1": (tt._level_op, (r(3, 2, 20), "idwt1", "db2", "", "folded", [])),
        "dwt3": (tt._level_op, (r(2, 6, 7, 5), "dwt3", "db2", "symmetric", "", [])),
        "idwt3": (tt._level_op, (r(2, 8, 4, 4, 4), "idwt3", "db2", "", "conv", [6, 5, 6])),
        "idwt3_matmul": (tt._level_op, (r(2, 8, 4, 4, 4), "idwt3", "db2", "", "matmul",
                                        [6, 5, 6])),
        "wave_level_vjp": (tt._level_vjp_op, (r(3, 2, 20, grad=False), [3, 37], "dwt1", "db2",
                                              "reflect", "conv", [])),
        "graph_const": (graph_const._const_op, (torch.zeros(2), "mel_filterbank",
                                                [33, 8, 8000])),
    }


@pytest.mark.parametrize("name", ["dwt2", "dwt2_adjoint", "synth2", "synth2_bwd", "pair",
                                  "pair_bwd", "relu_fwd", "relu_bwd", "dwt1", "dwt1_folded",
                                  "idwt1", "dwt3", "idwt3", "idwt3_matmul", "wave_level_vjp",
                                  "graph_const"])
def test_opcheck_every_kernel_operator(name):
    op, args = _op_cases()[name]
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("name", ["dwt1", "dwt1_folded", "idwt1", "dwt3", "idwt3",
                                  "idwt3_matmul"])
def test_the_level_operators_are_the_eager_levels_and_their_adjoints(name):
    """Each 1D / 3D level operator computes its eager level (`_level_rows`)
    and its registered backward is that level's adjoint (float64
    gradcheck)."""
    op, (t, *rest) = _op_cases()[name]
    torch.testing.assert_close(op(t, *rest), tt._level_rows(t, *rest), rtol=0, atol=0)
    x = t.detach().double().requires_grad_(True)
    assert torch.autograd.gradcheck(lambda a: op(a, *rest), (x,))


def test_the_operators_are_the_plain_versions_and_their_adjoints():
    """Each operator's CPU implementation is its kernel's plain version, and
    each registered backward is the adjoint of its forward (float64)."""
    cases = _op_cases()
    x3, lo, hi, mode = cases["dwt2"][1]
    A, At = tmm._kernel_analysis(12, tuple(lo), tuple(hi), mode, torch.device("cpu"))
    _, Bt = tmm._kernel_analysis(10, tuple(lo), tuple(hi), mode, torch.device("cpu"))
    torch.testing.assert_close(tmm.dwt2_op(x3, lo, hi, mode), tmm.dwt2_plain(x3, At, Bt))
    sub3, rlo, rhi = cases["synth2"][1]
    x = sub3.detach().double().requires_grad_(True)
    assert torch.autograd.gradcheck(lambda t: tmm.synth2_op(t, rlo, rhi), (x,))
    leaves = [t.detach().double().requires_grad_(True) for t in cases["pair"][1][0]]
    sizes = cases["pair"][1][1]
    assert torch.autograd.gradcheck(lambda *ls: tmm.pair_op(list(ls), sizes, sizes, rlo, rhi),
                                    tuple(leaves))
    x = x3.detach().double().requires_grad_(True)
    assert torch.autograd.gradcheck(lambda t: tmm.dwt2_op(t, lo, hi, mode), (x,))


# -- a toy WAM-2D pass against the reference's cached_jit ----------------------------


def _jax_model(kern):
    def model(x):  # (B, C, H, W) -> (B, 4)
        out = lax.conv_general_dilated(x.mean(axis=1)[:, None], kern, (1, 1),
                                       [(2, 2), (2, 2)],
                                       dimension_numbers=("NCHW", "OIHW", "NCHW"))
        return jnp.tanh(out).mean(axis=(2, 3))

    return model


def _torch_model(kern):
    return lambda x: torch.tanh(F.conv2d(x.mean(dim=1)[:, None], kern, padding=2)).mean(
        dim=(2, 3))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-9)])
def test_a_toy_wam2d_pass_matches_the_reference_cached_jit(caches, dtype, tol):
    """The single-pass WAM-2D entry (db2, J=2, 16^2, a toy conv) through
    each package's cached_jit (`serve_entry(aot_key=)`), the same numpy
    inputs and the JAX init carried over: the port's compiled program (the
    kernel operators' plain versions) against the reference's exported one,
    within ``tol`` of the max."""
    from wam_tpu.wam2d import BaseWAM2D as JWam
    from wam_tpu_torch.wam2d import BaseWAM2D as TWam

    kern = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 1, 5, 5)) * 0.3, dtype)
    x = np.random.default_rng(3).standard_normal((3, 2, 16, 16)).astype(dtype)
    y = np.array([0, 2, 3], np.int32)
    with jax.enable_x64(dtype == "float64"):
        jentry = JWam(_jax_model(jnp.asarray(kern)), wavelet="db2", J=2).serve_entry(
            aot_key=f"toy-{dtype}")
        want = np.asarray(jentry(jnp.asarray(x), jnp.asarray(y)))
    twam = TWam(_torch_model(torch.from_numpy(kern)), wavelet="db2", J=2, device="cpu")
    tentry = twam.serve_entry(aot_key=f"toy-{dtype}")
    got = tentry(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    (prog,) = [f for d in tentry.wam_aot_fns for f in d.fns.values()]
    assert prog.aot_status == "exported" and prog.compiles == 1 and aot.graph_breaks() == 0
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


# -- the consumers ---------------------------------------------------------------------


def test_server_warmup_from_a_warm_cache_compiles_nothing(caches):
    """The reference's `test_serve_warmup_hits_aot_cache`: a second server
    with the same key in a fresh consumer warms with ZERO compiles, and its
    rows equal the eager entry's."""
    from wam_tpu_torch.serve import AttributionServer
    from wam_tpu_torch.wam2d import BaseWAM2D

    kern = torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                                         (4, 1, 5, 5)) * 0.3))
    wam = BaseWAM2D(_torch_model(kern), wavelet="db2", J=2, device="cpu")
    x = np.random.default_rng(1).standard_normal((2, 16, 16)).astype(np.float32)
    eager = wam.serve_entry()

    cold = []
    server = AttributionServer(wam.serve_entry(on_trace=lambda: cold.append(1),
                                               aot_key="toy-serve"),
                               [(2, 16, 16)], max_batch=2, device="cpu")
    server.close()
    assert cold == [1]  # warmup compiled and exported the bucket's program

    caches.fresh()
    warm = []
    entry = wam.serve_entry(on_trace=lambda: warm.append(1), aot_key="toy-serve")
    server = AttributionServer(entry, [(2, 16, 16)], max_batch=2, device="cpu")
    try:
        got = server.submit(x, 2).result(timeout=T)
    finally:
        server.close()
    assert warm == [] and server.metrics.compile_count == 0
    want = eager(torch.from_numpy(np.stack([x, x])), torch.tensor([2, 2])).numpy()[0]
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())


def test_a_cached_auc_runner_compiles_once_and_equals_the_eager_one(caches):
    """The reference's `test_run_cached_auc_aot_skips_model_retrace`: a fresh
    runner cache with the same key compiles nothing more (sentinel), and the
    scores and curves equal the eager runner's."""
    from wam_tpu_torch.evalsuite.metrics import run_cached_auc

    def model_fn(batch):
        return batch.reshape(batch.shape[0], -1)[:, :4]

    def inputs_fn(x_s, expl_s):
        masks = torch.linspace(0.0, 1.0, 4)[:, None, None, None]  # n_iter + 1
        return x_s[None] * masks + expl_s[None]

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 1, 4, 4)).astype(
        np.float32))
    expl = torch.ones(2, 4, 4) * 0.1
    y = np.array([1, 3])

    def run(key):
        scores, curves = run_cached_auc({}, ("insertion",), inputs_fn, model_fn, 16, 3, x,
                                        expl, y, aot_key=key)
        return np.asarray(scores), np.asarray(curves)

    n0 = sentinel.trace_count()
    s1, c1 = run("toy-auc")
    n_cold = sentinel.trace_count() - n0
    s2, c2 = run("toy-auc")  # a fresh runner cache: only the compiled program is shared
    assert n_cold == 1 and sentinel.trace_count() - n0 == n_cold
    s0, c0 = run(None)
    np.testing.assert_allclose(s1, s0, atol=1e-6)
    np.testing.assert_allclose(c2, c0, atol=1e-6)
    np.testing.assert_allclose(s2, s0, atol=1e-6)
