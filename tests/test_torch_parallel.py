"""The port's data-parallel half of `parallel/*` and the evaluators' ``mesh=``
(`wam_tpu_torch.parallel`, `wam_tpu_torch.evalsuite.fan`) held to
`wam_tpu.parallel`, case for case with `tests/test_parallel.py`.

The JAX side runs on the virtual 8-device CPU mesh `tests/conftest.py`
forces; the port's side on meshes over ``["cpu"] * k`` (one block an entry,
run one after another). Inputs and the toy classifier's kernel are drawn
with numpy or by the reference's own ``jax.random`` calls and handed to
both; the SmoothGrad noise is the reference's own draw
(``jax.random.normal(key, (n,) + x.shape)``), handed to the port. Bounds:
the sharded estimators against JAX within 1e-4 of the max (float32; the
toy's tanh keeps gates out of it), 1e-9 in float64; against the port's own
single-device `smoothgrad` / `integrated_path` within 1e-6 of the max (only
the order of the sample sum differs). One test starts two gloo processes
(`init_distributed` + `hybrid_mesh`), each with a 120 s limit."""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wam_tpu.core.engine import WamEngine as JEngine
from wam_tpu.core.estimators import smoothgrad as jsmoothgrad
from wam_tpu.models.toy import toy_conv_model as jtoy
from wam_tpu.ops.packing2d import mosaic2d as jmosaic
from wam_tpu.parallel import make_mesh as jmake_mesh
from wam_tpu.parallel import sharded_integrated_path as jsharded_ig
from wam_tpu.parallel import sharded_smoothgrad as jsharded_sg
from wam_tpu.parallel import sharded_smoothgrad_spmd as jsharded_spmd
from wam_tpu_torch import parallel as tpar
from wam_tpu_torch.core.engine import WamEngine, map_coeffs
from wam_tpu_torch.core.estimators import integrated_path, smoothgrad
from wam_tpu_torch.evalsuite import fan as tfan
from wam_tpu_torch.models.toy import toy_conv_model
from wam_tpu_torch.ops.packing2d import mosaic2d
from wam_tpu_torch.parallel.multihost import CoordinatorConnectError

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SIDE, N = 16, 4
SPREAD = 0.15


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def toy():
    """The toy conv classifier in both packages (the reference's kernel
    handed over), each behind a WAM engine (haar, J=2) on (B, 1, 16, 16)."""
    key = jax.random.PRNGKey(5)
    kernel = np.asarray(jax.random.normal(key, (4, 1, 5, 5)) * 0.3)
    jfn = jtoy(key)
    tfn = toy_conv_model(kernel, device="cpu")
    jeng = JEngine(lambda x: jfn(x[:, 0]), ndim=2, wavelet="haar", level=2, mode="reflect")
    teng = WamEngine(lambda x: tfn(x[:, 0]), ndim=2, wavelet="haar", level=2, mode="reflect")
    return jeng, teng


def _inputs(batch: int, seed: int, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, 1, SIDE, SIDE)).astype(dtype), np.arange(batch) % 4


def _port_step(teng, normalize: bool = False):
    """The spmd step contract on the port: (s, b, 1, H, W) noisy rows, the
    block's labels, the loss-mean rescale -> (s, b, S, S) mosaics."""

    def step(noisy, y_l, grad_scale):
        s = noisy.shape[0]
        flat = noisy.reshape((-1,) + tuple(noisy.shape[2:]))
        with torch.no_grad():
            coeffs = teng.decompose(flat)
        grads = teng.grads_from_coeffs(coeffs, y_l.repeat(s), (SIDE, SIDE), samples=s)
        grads = map_coeffs(lambda g: (g * grad_scale).reshape((s, -1) + tuple(g.shape[1:])),
                           grads)
        return mosaic2d(grads, normalize)

    return step


def _jax_step(jeng, normalize: bool = False):
    def step(noisy, y_l, grad_scale):
        _, grads = jeng.attribute(noisy, y_l)
        grads = jax.tree_util.tree_map(lambda g: g * grad_scale, grads)
        return jmosaic(grads, normalize)

    return step


def _cpu_mesh(sizes: dict):
    return tpar.make_mesh(sizes, ["cpu"] * int(np.prod(list(sizes.values()))))


def _jax_mesh(sizes: dict):
    return jmake_mesh(sizes, jax.devices()[:int(np.prod(list(sizes.values())))])


# -- mesh helpers ---------------------------------------------------------------------


@pytest.mark.parametrize("sizes", [{"data": 4, "sample": 2}, {"data": -1, "sample": 4},
                                   {"data": 2, "sample": -1}, {"sample": 8}])
def test_make_mesh_shapes_match_jax(sizes):
    got = tpar.make_mesh(sizes, ["cpu"] * 8)
    want = jmake_mesh(sizes)
    assert got.shape == dict(want.shape) and got.axis_names == want.axis_names
    assert got.size == 8 and all(d == torch.device("cpu") for d in got.devices.flat)


@pytest.mark.parametrize("sizes", [{"data": 3}, {"data": -1, "sample": -1},
                                   {"data": -1, "sample": 3}, {"data": 2, "sample": 2}])
def test_make_mesh_errors_match_jax(sizes):
    with pytest.raises(ValueError) as want:
        jmake_mesh(sizes)
    with pytest.raises(ValueError) as got:
        tpar.make_mesh(sizes, ["cpu"] * 8)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_data_sample_and_replica_meshes_match_jax(n):
    from wam_tpu.parallel import data_sample_mesh as jds
    from wam_tpu.parallel import replica_mesh as jrep

    assert tpar.data_sample_mesh(n, ["cpu"] * 8).shape == dict(jds(n).shape)
    assert tpar.replica_mesh(n, ["cpu"] * 8).shape == dict(jrep(n).shape)
    for bad in (0, 9):
        with pytest.raises(ValueError) as want:
            jrep(bad)
        with pytest.raises(ValueError) as got:
            tpar.replica_mesh(bad, ["cpu"] * 8)
        assert str(got.value) == str(want.value)


def test_mesh_blocks_and_the_card_default(monkeypatch):
    mesh = tpar.make_mesh({"data": 2, "sample": 3}, ["cpu"] * 6)
    t = torch.arange(3 * 4 * 5).reshape(3, 4, 5)
    blk = mesh.block(t, tpar.P("sample", "data"), data=1, sample=2)
    assert torch.equal(blk, t[2:3, 2:4])
    assert mesh.block(t, tpar.P(None, "data"), data=0).shape == (3, 2, 5)
    with pytest.raises(ValueError, match="does not split"):
        mesh.block(t, tpar.P("data"), data=0)
    with pytest.raises(ValueError, match="unknown mesh axes"):
        mesh.device(model=0)
    assert mesh.owns(data=1, sample=2) and mesh.local_devices() == [torch.device("cpu")] * 6
    assert repr(tpar.P("data", None)) == "P('data', None)"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: tpar.make_mesh({"data": 1}), lambda: tpar.replica_mesh(1),
                  lambda: tpar.data_sample_mesh(), lambda: tpar.hybrid_mesh({"data": 1})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_mesh({"data": 1}, ["cuda:0"])


def test_single_process_multihost_helpers():
    info = tpar.init_distributed()
    assert info["process_count"] == 1 and info["process_index"] == 0
    assert info["global_devices"] == info["local_devices"]
    assert tpar.process_local_batch(32) == 32
    mesh = tpar.hybrid_mesh({"data": 4, "sample": 2}, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 4, "sample": 2} and mesh.process_ids is None
    assert tpar.hybrid_mesh({"data": -1, "sample": 2}, devices=["cpu"] * 8).shape == {
        "data": 4, "sample": 2}


# -- the sharded estimators against JAX ----------------------------------------------


MESHES = [{"data": 2, "sample": 2}, {"data": 4, "sample": 2}]


@pytest.mark.parametrize("batch", [4, 3])
@pytest.mark.parametrize("sizes", MESHES, ids=["d2s2", "d4s2"])
def test_spmd_smoothgrad_matches_jax_and_the_port_smoothgrad(toy, sizes, batch):
    """The reference's spmd runner and the port's on the same mesh shape,
    the same noise, normalize=False; B=3 pads the data axis cyclically."""
    jeng, teng = toy
    x, y = _inputs(batch, seed=batch)
    key = jax.random.PRNGKey(11)
    z = np.asarray(jax.random.normal(key, (N,) + x.shape, jnp.float32))
    want = jsharded_spmd(_jax_step(jeng), _jax_mesh(sizes), n_samples=N,
                         stdev_spread=SPREAD)(jnp.asarray(x), jnp.asarray(y), key)
    step = _port_step(teng)
    got = tpar.sharded_smoothgrad_spmd(step, _cpu_mesh(sizes), n_samples=N,
                                       stdev_spread=SPREAD)(
        torch.from_numpy(x), torch.from_numpy(y), noise=torch.from_numpy(z))
    assert got.shape == (batch, SIDE, SIDE)
    assert _rel(got, want) <= 1e-4
    own = smoothgrad(lambda noisy: step(noisy, torch.from_numpy(y), 1.0), torch.from_numpy(x),
                     n_samples=N, stdev_spread=SPREAD, noise=torch.from_numpy(z))
    assert _rel(got, own) <= 1e-6


@pytest.mark.parametrize("sizes", MESHES, ids=["d2s2", "d4s2"])
def test_sharded_smoothgrad_keeps_batch_global_normalization(toy, sizes):
    """The propagation runner: the step sees the whole batch (normalize=True
    normalizes over it), against the reference's runner and the port's
    single-device smoothgrad."""
    jeng, teng = toy
    x, y = _inputs(4, seed=7)
    key = jax.random.PRNGKey(3)
    z = np.asarray(jax.random.normal(key, (N,) + x.shape, jnp.float32))

    def jstep(noisy):
        _, grads = jeng.attribute(noisy, jnp.asarray(y))
        return jmosaic(grads, True)

    want = jsharded_sg(jstep, _jax_mesh(sizes), n_samples=N, stdev_spread=SPREAD)(
        jnp.asarray(x), key)
    step = _port_step(teng, normalize=True)
    tstep = lambda noisy: step(noisy, torch.from_numpy(y), 1.0)  # noqa: E731
    got = tpar.sharded_smoothgrad(tstep, _cpu_mesh(sizes), n_samples=N, stdev_spread=SPREAD)(
        torch.from_numpy(x), noise=torch.from_numpy(z))
    assert _rel(got, want) <= 1e-4
    own = smoothgrad(tstep, torch.from_numpy(x), n_samples=N, stdev_spread=SPREAD,
                     noise=torch.from_numpy(z))
    assert _rel(got, own) <= 1e-6
    # the reference's own single-device estimator agrees too
    assert _rel(got, jsmoothgrad(jstep, jnp.asarray(x), key, n_samples=N,
                                 stdev_spread=SPREAD)) <= 1e-4


def test_sample_split_must_divide():
    for runner in (tpar.sharded_smoothgrad, tpar.sharded_smoothgrad_spmd):
        with pytest.raises(ValueError, match="n_samples=5 not divisible by sample=4"):
            runner(lambda *a: a[0], _cpu_mesh({"data": 2, "sample": 4}), n_samples=5,
                   stdev_spread=0.1)
    with pytest.raises(ValueError, match="noise must have shape"):
        tpar.sharded_smoothgrad(lambda n: n, _cpu_mesh({"data": 1, "sample": 2}), n_samples=2,
                                stdev_spread=0.1)(torch.zeros(2, 3), noise=torch.zeros(3, 2, 3))


def _port_grad_fn(teng):
    def grad_fn(coeffs, y_l, alphas, grad_scale):
        s = alphas.shape[0]
        scaled = map_coeffs(lambda c: (c[None] * alphas.to(c.dtype).reshape(-1, 1, 1, 1, 1))
                            .reshape((-1,) + tuple(c.shape[1:])), coeffs)
        grads = teng.grads_from_coeffs(scaled, y_l.repeat(s), (SIDE, SIDE), samples=s)
        grads = map_coeffs(lambda g: (g * grad_scale).reshape((s, -1) + tuple(g.shape[1:])),
                           grads)
        return mosaic2d(grads, False)

    return grad_fn


@pytest.mark.parametrize("batch", [4, 3])
@pytest.mark.parametrize("sizes", MESHES, ids=["d2s2", "d4s2"])
def test_sharded_integrated_path_matches_jax_and_the_port(toy, sizes, batch):
    """IG with the α-path over the sample axis and the batch over the data
    axis (8 path points, a B=3 batch padded): against the reference's
    runner (its step sees the whole batch) and the port's single-device
    `integrated_path`."""
    jeng, teng = toy
    x, y = _inputs(batch, seed=10 + batch)

    def jgrad(coeffs):
        return jmosaic(jeng.grads_from_coeffs(coeffs, jnp.asarray(y), (SIDE, SIDE)), False)

    want = jsharded_ig(jgrad, jeng.decompose, _jax_mesh(sizes), n_steps=8)(jnp.asarray(x))
    grad_fn = _port_grad_fn(teng)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got = tpar.sharded_integrated_path(grad_fn, teng.decompose, _cpu_mesh(sizes), n_steps=8)(
        tx, ty)
    assert _rel(got, want) <= 1e-4
    coeffs = teng.decompose(tx)
    own = integrated_path(lambda a: grad_fn(coeffs, ty, a, 1.0), n_steps=8)
    assert _rel(got, own) <= 1e-6


def test_sharded_integrated_path_frees_a_data_shard_after_its_last_block():
    """A data shard's coefficients live until its last sample block: when
    the blocks of data index 1 run, data index 0's are gone."""
    import weakref

    mesh = tpar.make_mesh({"data": 2, "sample": 2}, ["cpu"] * 4)
    refs, alive_at = {}, []

    def decompose(x):
        c = [x * 1.0]
        refs[len(refs)] = weakref.ref(c[0])
        return c

    def grad_fn(c, y, alphas, scale):
        alive_at.append([r() is not None for r in refs.values()])
        return c[0][None] * alphas.reshape(-1, 1, 1)

    run = tpar.sharded_integrated_path(grad_fn, decompose, mesh, n_steps=4)
    x = torch.arange(8.0).reshape(4, 2)
    out = run(x)
    # data 0: both blocks see its leaf; data 1: only its own is alive
    assert alive_at == [[True], [True], [False, True], [False, True]]
    torch.testing.assert_close(out, x * 0.5 * 3, rtol=0, atol=1e-6)  # trapezoid of alpha*x


def test_sharded_estimators_in_float64(toy):
    """float64 end to end, spmd SmoothGrad and IG on {data 2, sample 2},
    against the reference in x64 mode: within 1e-9 of the max."""
    jeng, teng = toy
    x, y = _inputs(4, seed=21, dtype=np.float64)
    key = jax.random.PRNGKey(2)
    sizes = {"data": 2, "sample": 2}
    kern = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (4, 1, 5, 5)) * 0.3,
                      np.float64)
    with jax.enable_x64(True):
        jk = jnp.asarray(kern)

        def jfn64(v):  # the toy classifier, its kernel in float64
            out = jax.lax.conv_general_dilated(v[:, None], jk, (1, 1), [(2, 2), (2, 2)],
                                               dimension_numbers=("NCHW", "OIHW", "NCHW"))
            return jnp.tanh(out).mean(axis=(2, 3))

        jeng64 = JEngine(lambda v: jfn64(v[:, 0]), ndim=2, wavelet="haar", level=2,
                         mode="reflect")
        z = np.asarray(jax.random.normal(key, (N,) + x.shape, jnp.float64))
        want_sg = np.asarray(jsharded_spmd(_jax_step(jeng64), _jax_mesh(sizes), n_samples=N,
                                           stdev_spread=SPREAD)(jnp.asarray(x), jnp.asarray(y),
                                                                key))

        def jgrad(coeffs):
            return jmosaic(jeng64.grads_from_coeffs(coeffs, jnp.asarray(y), (SIDE, SIDE)), False)

        want_ig = np.asarray(jsharded_ig(jgrad, jeng64.decompose, _jax_mesh(sizes), n_steps=6)(
            jnp.asarray(x)))
    assert want_sg.dtype == np.float64
    kt = torch.from_numpy(kern)

    def tfn64(v):
        out = torch.nn.functional.conv2d(v[:, 0][:, None], kt, padding=2)
        return torch.tanh(out).mean(dim=(2, 3))

    teng64 = WamEngine(tfn64, ndim=2, wavelet="haar", level=2, mode="reflect")
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got_sg = tpar.sharded_smoothgrad_spmd(_port_step(teng64), _cpu_mesh(sizes), n_samples=N,
                                          stdev_spread=SPREAD)(tx, ty, noise=torch.from_numpy(z))
    got_ig = tpar.sharded_integrated_path(_port_grad_fn(teng64), teng64.decompose,
                                          _cpu_mesh(sizes), n_steps=6)(tx, ty)
    assert got_sg.dtype == torch.float64 and _rel(got_sg, want_sg) <= 1e-9
    assert _rel(got_ig, want_ig) <= 1e-9


# -- the evaluators on a mesh --------------------------------------------------------


def test_fan_runner_on_a_mesh_pads_splits_and_slices_back():
    mesh = _cpu_mesh({"data": 4})
    calls = []

    def body(a, b):
        calls.append(a.shape[0])
        return a * 2 + b[:, None], (a.sum(dim=1),)

    a, b = torch.arange(15.0).reshape(5, 3), torch.arange(5.0)
    out, (tail,) = tfan.fan_runner(body, mesh=mesh)(a, b)
    assert calls == [2, 2, 2, 2]  # 5 rows padded to 8, one block a data index
    assert torch.equal(out, a * 2 + b[:, None]) and torch.equal(tail, a.sum(dim=1))
    assert not out.requires_grad


def test_eval2d_sharded_insertion_matches_jax_and_the_unsharded_port():
    """The reference's case: a linear model and a constant explainer, the
    image batch over {data: 8} (2 images padded), against the reference's
    sharded run and the port's mesh-less one; one fetch a metric call."""
    from wam_tpu.evalsuite import Eval2DWAM as JEval2D
    from wam_tpu_torch.evalsuite import Eval2DWAM

    rng = np.random.default_rng(4)
    W = (rng.standard_normal((3 * 16 * 16, 5)) * 0.05).astype(np.float32)
    x = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    y = np.array([1, 3])
    jW, tW = jnp.asarray(W), torch.from_numpy(W)
    jev = JEval2D(lambda v: v.reshape(v.shape[0], -1) @ jW, lambda v, _: jnp.ones((2, 16, 16)),
                  wavelet="haar", J=2, mesh=jmake_mesh({"data": 8}))
    want = jev.insertion(jnp.asarray(x), y, n_iter=16)
    mesh = _cpu_mesh({"data": 8})
    kw = dict(wavelet="haar", J=2, device="cpu")
    tfn = lambda v: v.reshape(v.shape[0], -1) @ tW  # noqa: E731
    expl = lambda v, _: torch.ones((2, 16, 16))  # noqa: E731
    tev = Eval2DWAM(tfn, expl, mesh=mesh, **kw)
    with tfan.fetch_scope() as fs:
        got = tev.insertion(torch.from_numpy(x), y, n_iter=16)
    assert fs.count == 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    single = Eval2DWAM(tfn, expl, **kw).insertion(torch.from_numpy(x), y, n_iter=16)
    np.testing.assert_allclose(got, single, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.stack(tev.insertion_curves), np.stack(jev.insertion_curves),
                               rtol=0, atol=1e-5)
    # μ-fidelity on a non-constant map (a constant one leaves the Spearman
    # correlation undefined)
    wams = rng.random((2, 16, 16)).astype(np.float32)
    jev.grad_wams, jev._expl_key = jnp.asarray(wams), None
    tev.grad_wams, tev._expl_key = torch.from_numpy(wams), None
    kw_mu = dict(grid_size=4, sample_size=6, subset_size=5)
    with tfan.fetch_scope() as fs:
        mu = tev.mu_fidelity(torch.from_numpy(x), y, **kw_mu)
    assert fs.count == 1
    np.testing.assert_allclose(mu, jev.mu_fidelity(jnp.asarray(x), y, **kw_mu), rtol=0,
                               atol=1e-4)


def _resnet_variables(model, shape):
    """float32 variables drawn with numpy into ``model.init``'s tree
    (`jax.eval_shape`: a real init compiles an initialiser per shape), every
    BatchNorm non-identity, the perturbation taps zero."""
    rng = np.random.default_rng(6)
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros(shape))

    def draw(path, leaf):
        name, n = path[-1].key, leaf.shape
        if path[0].key == "perturbations":
            return np.zeros(n, np.float32)
        if name == "kernel":
            v = rng.standard_normal(n) / np.sqrt(np.prod(n[:-1]))
        elif name in ("bias", "mean"):
            v = 0.05 * rng.standard_normal(n)
        else:  # scale, var
            v = rng.uniform(0.8, 1.2, n)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def test_eval_baselines_sharded_insertion_matches_jax():
    """The reference's case (there on {data: 8} with 16 steps): saliency on
    ResNet-18 (JAX init carried over by `flax_resnet_to_torch`) at 16², three
    images over {data: 2} (one padded), 8 steps."""
    from wam_tpu.evalsuite import EvalImageBaselines as JEvalImage
    from wam_tpu.models import resnet18 as jresnet18
    from wam_tpu_torch.evalsuite import EvalImageBaselines
    from wam_tpu_torch.models import resnet as tres
    from wam_tpu_torch.models.ingest import flax_resnet_to_torch

    model = jresnet18(num_classes=5)
    variables = _resnet_variables(model, (1, 16, 16, 3))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (3, 3, 16, 16)) * 0.3)
    y = np.array([1, 2, 4])
    jev = JEvalImage(model, variables, method="saliency", mesh=_jax_mesh({"data": 2}))
    want = jev.insertion(jnp.asarray(x), y, n_iter=8)
    state = flax_resnet_to_torch(variables)
    tev = EvalImageBaselines(tres.resnet18(num_classes=5), state, method="saliency",
                             mesh=_cpu_mesh({"data": 2}), device="cpu")
    with tfan.fetch_scope() as fs:
        got = tev.insertion(torch.from_numpy(x), y, n_iter=8)
    assert fs.count == 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    single = EvalImageBaselines(tres.resnet18(num_classes=5), state, method="saliency",
                                device="cpu").insertion(torch.from_numpy(x), y, n_iter=8)
    np.testing.assert_allclose(got, single, rtol=0, atol=1e-6)


# -- multiple processes ----------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    sys.path.insert(0, {root!r})
    from wam_tpu_torch import parallel as tpar
    from wam_tpu_torch.core.engine import WamEngine, map_coeffs
    from wam_tpu_torch.models.toy import toy_conv_model
    from wam_tpu_torch.ops.packing2d import mosaic2d

    pid = int(sys.argv[1])
    info = tpar.init_distributed({coord!r}, 2, pid, initialization_timeout=60, device="cpu")
    assert info["process_count"] == 2 and info["process_index"] == pid, info
    case = np.load({case!r})
    fn = toy_conv_model(case["kernel"], device="cpu")
    eng = WamEngine(lambda v: fn(v[:, 0]), ndim=2, wavelet="haar", level=2, mode="reflect")

    def step(noisy, y_l, scale):
        s = noisy.shape[0]
        flat = noisy.reshape((-1,) + tuple(noisy.shape[2:]))
        with torch.no_grad():
            coeffs = eng.decompose(flat)
        grads = eng.grads_from_coeffs(coeffs, y_l.repeat(s), (16, 16), samples=s)
        grads = map_coeffs(lambda g: (g * scale).reshape((s, -1) + tuple(g.shape[1:])), grads)
        return mosaic2d(grads, False)

    mesh = tpar.hybrid_mesh({{"sample": 2, "data": 2}}, dcn_axis="sample", devices=["cpu"] * 2)
    assert mesh.shape == {{"sample": 2, "data": 2}} and mesh.process_ids is not None
    out = tpar.sharded_smoothgrad_spmd(step, mesh, n_samples=4, stdev_spread=0.15)(
        torch.from_numpy(case["x"]), torch.from_numpy(case["y"]),
        noise=torch.from_numpy(case["z"]))
    np.save({out!r} + f".{{pid}}.npy", out.numpy())
    print(f"WORKER{{pid}}_OK", flush=True)
""")


def test_two_gloo_processes_reproduce_the_one_process_mesh(toy, tmp_path):
    """init_distributed(coordinator, 2, pid) then the spmd runner on a
    hybrid mesh whose sample axis spans the two processes: each process runs
    its own blocks and one all_reduce sums them; both results equal the
    one-process [cpu] * 4 mesh's."""
    _, teng = toy
    x, y = _inputs(3, seed=31)
    z = np.random.default_rng(32).standard_normal((N,) + x.shape).astype(np.float32)
    kernel = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (4, 1, 5, 5)) * 0.3)
    case = tmp_path / "case.npz"
    np.savez(case, x=x, y=y, z=z, kernel=kernel)
    want = tpar.sharded_smoothgrad_spmd(_port_step(teng), _cpu_mesh({"sample": 2, "data": 2}),
                                        n_samples=N, stdev_spread=SPREAD)(
        torch.from_numpy(x), torch.from_numpy(y), noise=torch.from_numpy(z)).numpy()
    out = str(tmp_path / "out")
    code = WORKER.format(root=str(ROOT), coord=f"127.0.0.1:{_free_port()}", case=str(case),
                         out=out)
    env = {**{k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")},
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}  # as this process
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # both ranks on this host's loopback
    procs = [subprocess.Popen([sys.executable, "-c", code, str(pid)], cwd=str(ROOT), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for pid, (p, log) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER{pid}_OK" in log, log[-3000:]
        np.testing.assert_array_equal(np.load(f"{out}.{pid}.npy"), want)


def test_init_distributed_raises_on_an_unreachable_coordinator():
    """A rank that cannot reach its coordinator raises CoordinatorConnectError
    naming the address after its bounded attempts, never returning as if
    single-process."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        from wam_tpu_torch.parallel import init_distributed
        from wam_tpu_torch.parallel.multihost import CoordinatorConnectError
        try:
            init_distributed("127.0.0.1:{_free_port()}", 2, 1, initialization_timeout=1,
                             connect_attempts=2, connect_backoff_s=0.1, device="cpu")
        except CoordinatorConnectError as e:
            print("RAISED", "127.0.0.1" in str(e), "2 attempt(s)" in str(e), flush=True)
        else:
            print("SWALLOWED", flush=True)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), capture_output=True,
                          text=True, timeout=120)
    assert "RAISED True True" in proc.stdout, (proc.stdout + proc.stderr)[-3000:]
    assert issubclass(CoordinatorConnectError, RuntimeError)


def test_init_distributed_takes_a_file_rendezvous_and_destroys_the_group_at_exit(tmp_path):
    """A ``file://`` coordinator starts the group with no port to choose, and
    the group is destroyed at interpreter exit: the handler registered by
    `init_distributed` leaves no group alive, and the process exits 0 (a
    gloo rank that exited with its group alive could abort in teardown)."""
    code = textwrap.dedent(f"""
        import atexit, sys
        sys.path.insert(0, {str(ROOT)!r})
        import torch.distributed as dist
        from wam_tpu_torch.parallel import init_distributed
        from wam_tpu_torch.parallel import multihost
        info = init_distributed("file://{tmp_path / 'rendezvous'}", 1, 0,
                                initialization_timeout=30, device="cpu")
        assert info["process_count"] == 1 and dist.is_initialized()
        assert multihost._shutdown_registered
        multihost._shutdown()
        print("DESTROYED", not dist.is_initialized(), flush=True)
        init_distributed("file://{tmp_path / 'rendezvous2'}", 1, 0, device="cpu")
        print("LIVE AT EXIT", dist.is_initialized(), flush=True)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    assert "DESTROYED True" in proc.stdout and "LIVE AT EXIT True" in proc.stdout
