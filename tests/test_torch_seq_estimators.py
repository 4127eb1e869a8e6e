"""The port's sequence-sharded estimators (`wam_tpu_torch.parallel.
seq_estimators.SeqShardedWam`) and the explainers' and fleet's ``mesh=`` /
``seq_factory=`` routes, held to the reference's on the virtual 8-device
CPU mesh:

- `SeqShardedWam` attribute / smoothgrad (one sample a step and chunked) /
  integrated and the checkpointed pair against `wam_tpu.parallel.
  SeqShardedWam` on the same model, the reference's own draws
  ``jax.random.normal(jax.random.fold_in(key, i), x.shape)`` handed to the
  port; ``dispatch_count`` advancing by the reference's counts on the same
  calls, fused and split;
- fused against split, bit-equal, on five (ndim, wavelet, mode) cases,
  ``[3-db2-symmetric]`` among them;
- the port's sequence-sharded SmoothGrad against its single-device streamed
  estimator (float64, 1e-9 of the max);
- `WaveletAttribution1D/2D/3D(mesh=)` and `WaveletAttributionVideo(mesh=)`
  against the reference's with the reference's draws handed over (float32:
  1e-5 of the max for the mosaic/cube/box, 1e-4 for the 1D mel tap, whose
  dB front end the two packages compute in another order);
- the entry points' errors, type and message;
- first calls reported to the compile sentinel under kind "seq";
- `FleetServer(seq_factory=)` serving a batch above every bucket through
  the route, equal to the entry called directly.

The reference's graphs compile once each, in module-scoped fixtures."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wam_tpu as jw
import wam_tpu.parallel as jpar
import wam_tpu_torch as tw
import wam_tpu_torch.parallel as tpar
from wam_tpu_torch.obs import sentinel as tsentinel
from wam_tpu_torch.obs import tracing as ttracing
from wam_tpu_torch.parallel.tree import tree_leaves

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

SEED = 42  # the explainers' default random_seed
N = 3


def _need8():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh (tests/conftest.py)")


def _jmesh(k=4):
    return jpar.make_mesh({"data": k}, jax.devices()[:k])


def _tmesh(k=4):
    return tpar.make_mesh({"data": k}, ["cpu"] * k)


def _draws(seed, n, shape):
    key = jax.random.PRNGKey(seed)
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i), shape))
                     for i in range(n)])


def _close(got, want, tol, what):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs {err:.3e} > {tol} x {scale:.3e}"


# -- models written in both packages -----------------------------------------------


def _wave_models(n=1024, k=5):
    w = (np.random.default_rng(1).standard_normal((n, k)) / np.sqrt(n)).astype(np.float32)
    return (lambda x: jnp.tanh(x @ jnp.asarray(w)),
            lambda x: torch.tanh(x @ torch.as_tensor(w, dtype=x.dtype)))


def _image_models(c=3, h=64, w=32, k=5):
    t = np.random.default_rng(2).standard_normal((k, c, h, w)).astype(np.float32)
    s = float(np.sqrt(c * h * w))
    return (lambda x: jnp.tanh(jnp.einsum("bchw,kchw->bk", x, jnp.asarray(t)) / s),
            lambda x: torch.tanh(torch.einsum("bchw,kchw->bk", x, torch.as_tensor(
                t, dtype=x.dtype)) / s))


def _volume_models(k=4):
    w = np.random.default_rng(3).standard_normal((8, k)).astype(np.float32)

    def jm(x):  # (B, 1, D, H, W)
        pooled = x[:, 0].mean(axis=(2, 3))
        return jnp.tanh(pooled.reshape(pooled.shape[0], 8, -1).mean(axis=-1) @ jnp.asarray(w))

    def tm(x):
        pooled = x[:, 0].mean(dim=(2, 3))
        return torch.tanh(pooled.reshape(pooled.shape[0], 8, -1).mean(dim=-1)
                          @ torch.as_tensor(w, dtype=x.dtype))

    return jm, tm


def _mel_models(n_mels=32, k=4):
    w = np.random.default_rng(4).standard_normal((n_mels, k)).astype(np.float32) / 100.0
    return (lambda mel: mel[:, 0].mean(axis=1) @ jnp.asarray(w),
            lambda mel: mel[:, 0].mean(dim=1) @ torch.as_tensor(w, dtype=mel.dtype))


# -- SeqShardedWam against the reference ---------------------------------------------

X1 = np.random.default_rng(5).standard_normal((2, 1024)).astype(np.float32)
Y1 = np.array([1, 3], np.int32)
KW1 = dict(ndim=1, wavelet="db2", level=2, mode="symmetric")


def _run_seq(pkg, sw, x, y, key, z):
    """The same calls on either package's SeqShardedWam; each result with the
    dispatches it took."""
    out = {}

    def rec(name, fn):
        sw.dispatch_count = 0
        out[name] = (fn(), sw.dispatch_count)

    noise = {} if pkg is jpar else {"noise": z}
    rec("attribute", lambda: sw.attribute(x, y))
    rec("smooth1", lambda: sw.smoothgrad(x, y, key, n_samples=N, stdev_spread=0.1,
                                         sample_chunk=1, **noise))
    rec("smooth2", lambda: sw.smoothgrad(x, y, key, n_samples=N, stdev_spread=0.1,
                                         sample_chunk=2, **noise))
    rec("ig1", lambda: sw.integrated(x, y, n_steps=N, sample_chunk=1))
    rec("ig2", lambda: sw.integrated(x, y, n_steps=N, sample_chunk=2))
    rec("smooth_ckpt", lambda: sw.smoothgrad_checkpointed(x, y, key, n_samples=N,
                                                          stdev_spread=0.1, stride=2,
                                                          **noise))
    rec("ig_ckpt", lambda: sw.integrated_checkpointed(x, y, n_steps=N, stride=2))
    return out


@pytest.fixture(scope="module")
def seq_ref():
    _need8()
    jm, _ = _wave_models()
    key = jax.random.PRNGKey(7)
    fused = jpar.SeqShardedWam(_jmesh(), jm, **KW1)
    split = jpar.SeqShardedWam(_jmesh(), jm, fused=False, **KW1)
    return {"fused": _run_seq(jpar, fused, jnp.asarray(X1), jnp.asarray(Y1), key, None),
            "split": _run_seq(jpar, split, jnp.asarray(X1), jnp.asarray(Y1), key, None)}


def _tensors(tree):
    if isinstance(tree, dict):  # an anytime info dict: its conf vector
        return [tree["conf"]]
    if isinstance(tree, (jnp.ndarray, np.ndarray, torch.Tensor)):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for part in tree for t in _tensors(part)]
    return []


@pytest.mark.parametrize("fused", ["fused", "split"])
def test_seq_sharded_wam_matches_the_reference(seq_ref, fused):
    """Every entry point's result within 1e-5 of the max of the reference's
    (the anytime confidence vectors within 1e-4) and the same dispatch count
    on the same call, fused and split."""
    _, tm = _wave_models()
    sw = tpar.SeqShardedWam(_tmesh(), tm, fused=fused == "fused", **KW1)
    z = torch.from_numpy(_draws(7, N, X1.shape))
    got = _run_seq(tpar, sw, torch.from_numpy(X1), torch.from_numpy(Y1).long(), 7, z)
    for name, (res, count) in seq_ref[fused].items():
        g_res, g_count = got[name]
        assert g_count == count, (name, g_count, count)
        a, b = _tensors(g_res), _tensors(res)
        assert len(a) == len(b), name
        for i, (p, q) in enumerate(zip(a, b)):
            _close(p, q, 1e-4 if name.endswith("ckpt") and p is a[-1] else 1e-5,
                   f"{name} {fused} leaf {i}")
        if name.endswith("ckpt"):
            info, want = g_res[-1], res[-1]
            assert {k: info[k] for k in ("n_used", "n_total", "complete", "converged")} == \
                {k: want[k] for k in ("n_used", "n_total", "complete", "converged")}


def _torch_case(ndim, wavelet, mode):
    """A small model and input for the fused/split cases (the reference's
    shapes: 1D (2, 2048), 2D (2, 3, 64, 32), 3D (2, 1, 32, 8, 8))."""
    g = torch.Generator().manual_seed(ndim)
    if ndim == 1:
        x, w = torch.randn(2, 2048, generator=g), torch.randn(2048, 5, generator=g) / 45.0
        return lambda s: torch.tanh(s @ w), x, 2
    if ndim == 2:
        x, t = torch.randn(2, 3, 64, 32, generator=g), torch.randn(5, 3, 64, 32, generator=g)
        return lambda s: torch.tanh(torch.einsum("bchw,kchw->bk", s, t) / 78.0), x, 2
    _, tm = _volume_models()
    return tm, torch.randn(2, 1, 32, 8, 8, generator=g)[:, 0], 1


@pytest.mark.parametrize("ndim,wavelet,mode", [
    (1, "db3", "symmetric"),
    (1, "db2", "periodization"),
    (2, "db2", "reflect"),
    (2, "haar", "periodization"),
    (3, "db2", "symmetric"),
])
def test_seq_fused_vs_split_bitexact(ndim, wavelet, mode):
    """The fused step is bit-equal to the split loop (the same operations
    in the same order): SmoothGrad one sample a step and chunked (n=3,
    chunk 2: one weight-0 pad slot), IG chunked, attribute."""
    model, x, level = _torch_case(ndim, wavelet, mode)
    if ndim == 3:
        model3 = model
        model = lambda s: model3(s[:, None])  # noqa: E731
    y = torch.tensor([1, 3])
    kw = dict(ndim=ndim, wavelet=wavelet, level=level, mode=mode)
    mesh = tpar.make_mesh({"data": 8}, ["cpu"] * 8)
    sw_f = tpar.SeqShardedWam(mesh, model, fused=True, **kw)
    sw_s = tpar.SeqShardedWam(mesh, model, fused=False, **kw)
    pairs = []
    for chunk in (1, 2):
        pairs.append((sw_f.smoothgrad(x, y, 7, n_samples=3, stdev_spread=0.1,
                                      sample_chunk=chunk),
                      sw_s.smoothgrad(x, y, 7, n_samples=3, stdev_spread=0.1,
                                      sample_chunk=chunk)))
    pairs.append((sw_f.integrated(x, y, n_steps=3, sample_chunk=2),
                  sw_s.integrated(x, y, n_steps=3, sample_chunk=2)))
    pairs.append((sw_f.attribute(x, y), sw_s.attribute(x, y)))
    for got, want in pairs:
        a, b = tree_leaves(got), tree_leaves(want)
        assert len(a) == len(b) > 0
        for p, q in zip(a, b):
            assert torch.equal(p, q)


def test_seq_smoothgrad_equals_the_single_device_streamed_estimator():
    """Float64: WaveletAttribution2D(mesh=) against the same explainer on
    one device with ``stream_noise=True`` (the same draws, one sample a
    model call on both): SmoothGrad and IG within 1e-9 of the max."""
    _, tm = _image_models()
    x = torch.randn(2, 3, 64, 32, dtype=torch.float64, generator=torch.Generator().manual_seed(9))
    y = torch.tensor([0, 4])
    for method in ("smooth", "integratedgrad"):
        kw = dict(wavelet="db2", J=2, method=method, n_samples=N, sample_batch_size=1,
                  device="cpu")
        single = tw.WaveletAttribution2D(tm, stream_noise=True, **kw)(x, y)
        seq = tw.WaveletAttribution2D(tm, mesh=_tmesh(), **kw)(x, y)
        _close(seq, single.numpy(), 1e-9, method)


# -- the explainers' mesh= against the reference's ------------------------------------


def _explainer_cases():
    """(name, reference explainer, port explainer, input, labels, noise
    shape or None)."""
    jm2, tm2 = _image_models()
    jm3, tm3 = _volume_models()
    jmel, tmel = _mel_models()
    x2 = np.random.default_rng(6).standard_normal((2, 3, 64, 32)).astype(np.float32)
    x3 = np.random.default_rng(7).standard_normal((2, 1, 32, 8, 8)).astype(np.float32)
    xv = np.random.default_rng(8).standard_normal((2, 1, 16, 8, 8)).astype(np.float32)
    x1 = np.random.default_rng(9).standard_normal((2, 4096)).astype(np.float32)
    mel = dict(n_mels=32, n_fft=256, sample_rate=8000)
    cases = []
    for method in ("smooth", "integratedgrad"):
        kw2 = dict(wavelet="db2", J=2, method=method, n_samples=N)
        cases.append((f"2d-{method}", lambda kw2=kw2: jw.WaveletAttribution2D(
            jm2, mesh=_jmesh(), **kw2), lambda kw2=kw2: tw.WaveletAttribution2D(
            tm2, mesh=_tmesh(), device="cpu", **kw2), x2, np.array([1, 4]), x2.shape))
        kw1 = dict(wavelet="db2", J=2, method=method, n_samples=N, **mel)
        cases.append((f"1d-{method}", lambda kw1=kw1: jw.WaveletAttribution1D(
            jmel, mesh=_jmesh(), **kw1), lambda kw1=kw1: tw.WaveletAttribution1D(
            tmel, mesh=_tmesh(), device="cpu", **kw1), x1, np.array([0, 3]), x1.shape))
    kw3 = dict(wavelet="db2", J=2, n_samples=N)
    cases.append(("3d-smooth", lambda: jw.WaveletAttribution3D(jm3, mesh=_jmesh(2), **kw3),
                  lambda: tw.WaveletAttribution3D(tm3, mesh=_tmesh(2), device="cpu", **kw3),
                  x3, np.array([1, 2]), (2, 32, 8, 8)))
    kwv = dict(wavelet="haar", levels=(2, 2), n_samples=N)
    cases.append(("video-smooth", lambda: jw.WaveletAttributionVideo(jm3, mesh=_jmesh(2), **kwv),
                  lambda: tw.WaveletAttributionVideo(tm3, mesh=_tmesh(2), device="cpu", **kwv),
                  xv, np.array([0, 3]), (2, 16, 8, 8)))
    return cases


CASES = _explainer_cases()


@pytest.fixture(scope="module")
def explainer_ref():
    _need8()
    out = {}
    for name, jmake, _, x, y, _ in CASES:
        res = jmake()(jnp.asarray(x), jnp.asarray(y))
        out[name] = [np.asarray(t) for t in jax.tree_util.tree_leaves(res)]
    return out


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_explainers_mesh_match_the_reference(explainer_ref, case):
    """Each explainer with ``mesh=`` (rows, the waveform, depth or time over
    the mesh) against the reference's with ``mesh=``, the reference's draws
    handed to the port."""
    name, _, tmake, x, y, noise_shape = case
    wam = tmake()
    noise = None
    if name.endswith("smooth"):
        z = _draws(SEED, N, noise_shape)
        if name.startswith("video"):
            z = z[:, :, None]
        noise = torch.from_numpy(z)
    xt = torch.from_numpy(x)
    res = wam(xt, torch.from_numpy(y).long(), noise=noise) if noise is not None \
        else wam(xt, torch.from_numpy(y).long())
    got, want = tree_leaves(res), explainer_ref[name]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        tol = 1e-4 if name.startswith("1d") else 1e-5
        _close(g, w, tol, f"{name} leaf {i}")


def _error(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value).replace("wam_tpu_torch", "wam_tpu")


def test_entry_point_errors_match_the_reference():
    """SeqShardedWam's and the explainers' refusals: type and message."""
    _need8()
    jm2, tm2 = _image_models()
    jm3, tm3 = _volume_models()
    jmel, tmel = _mel_models()
    jmesh, tmesh = _jmesh(), _tmesh()
    cases = [
        (lambda p, m, f: p.SeqShardedWam(m, f, ndim=4)),
        (lambda p, m, f: p.SeqShardedWam(m, f, ndim=1, front_grads=True)),
        (lambda p, m, f: p.SeqShardedWam(m, f, ndim=1, front_fn=f, front_grads=True,
                                         post_fn=f)),
        (lambda p, m, f: p.SeqShardedWam(m, f, ndim=1, fused="yes")),
        (lambda p, m, f: p.SeqShardedWam(m, f, ndim=1, batch_axis="rows")),
        (lambda p, m, f: p.SeqShardedWam(m, f, ndim=1, batch_axis="data")),
    ]
    for i, make in enumerate(cases):
        assert _error(lambda: make(tpar, tmesh, tm2)) == _error(lambda: make(jpar, jmesh, jm2)), i
    unbatched = np.zeros((1024,), np.float32)
    assert (_error(lambda: tpar.SeqShardedWam(tmesh, tm2, ndim=1).attribute(
        torch.from_numpy(unbatched)))
        == _error(lambda: jpar.SeqShardedWam(jmesh, jm2, ndim=1).attribute(
            jnp.asarray(unbatched))))
    explainers = [
        (lambda pkg, m, f: pkg.WaveletAttribution2D(f, batch_axis="data"), "2d"),
        (lambda pkg, m, f: pkg.WaveletAttribution1D(f, batch_axis="data"), "1d"),
        (lambda pkg, m, f: pkg.WaveletAttribution3D(f, batch_axis="data"), "3d"),
        (lambda pkg, m, f: pkg.WaveletAttribution3D(f, instance="point_clouds", mesh=m), "3d"),
        (lambda pkg, m, f: pkg.WaveletAttributionVideo(f, levels=(2, 1), mesh=m), "3d"),
        (lambda pkg, m, f: pkg.WaveletAttributionVideo(f, batch_axis="data"), "3d"),
        (lambda pkg, m, f: pkg.WaveletAttributionVideo(f, levels=(2, 2), mesh=m,
                                                       method="integratedgrad")(
            np.zeros((2, 1, 16, 8, 8), np.float32)), "3d"),
        (lambda pkg, m, f: pkg.WaveletAttributionVideo(f, levels=(2, 2), mesh=m)(
            np.zeros((2, 2, 16, 8, 8), np.float32)), "3d"),
        (lambda pkg, m, f: pkg.WaveletAttribution2D(f, mesh=m).serve_entry(), "2d"),
        (lambda pkg, m, f: pkg.WaveletAttribution1D(f, mesh=m).serve_entry(), "1d"),
        (lambda pkg, m, f: pkg.WaveletAttribution3D(f, mesh=m).serve_entry(), "3d"),
        (lambda pkg, m, f: pkg.WaveletAttributionVideo(f, levels=(2, 2), mesh=m).serve_entry(),
         "3d"),
    ]
    models = {"2d": (jm2, tm2), "1d": (jmel, tmel), "3d": (jm3, tm3)}
    for i, (make, kind) in enumerate(explainers):
        jf, tf = models[kind]
        want = _error(lambda: make(jw, jmesh, jf))
        got = _error(lambda: make(_CpuPkg, tmesh, tf))
        assert got == want, (i, got, want)


class _CpuPkg:
    """The port's explainers with ``device="cpu"`` (the tests' rule)."""

    @staticmethod
    def WaveletAttribution1D(*a, **k):
        return tw.WaveletAttribution1D(*a, device="cpu", **k)

    @staticmethod
    def WaveletAttribution2D(*a, **k):
        return tw.WaveletAttribution2D(*a, device="cpu", **k)

    @staticmethod
    def WaveletAttribution3D(*a, **k):
        return tw.WaveletAttribution3D(*a, device="cpu", **k)

    @staticmethod
    def WaveletAttributionVideo(*a, **k):
        return tw.WaveletAttributionVideo(*a, device="cpu", **k)


def test_first_calls_report_to_the_sentinel_under_kind_seq():
    """A step's first call at a new signature is one ``seq`` compile event;
    the same call again adds none; a new batch size adds one per step."""
    _, tm = _wave_models()
    sw = tpar.SeqShardedWam(_tmesh(), tm, **KW1)
    x, y = torch.from_numpy(X1), torch.tensor([1, 3])
    since = tsentinel.trace_count()
    sw.attribute(x, y)
    first = [e for e in tsentinel.compile_events() if e["seq"] > since]
    assert [e["entry_kind"] for e in first] == ["seq"] and "_fused_attr" in first[0]["detail"]
    mark = tsentinel.trace_count()
    sw.attribute(x, y)
    assert tsentinel.trace_count() == mark
    sw.attribute(torch.cat([x, x]), torch.tensor([1, 3, 0, 2]))
    assert tsentinel.trace_count() == mark + 1


def test_fleet_seq_route_serves_items_above_every_bucket():
    """A two-replica fleet with ``seq_factory``: a batch whose item shape is
    above every bucket runs through the sequence-sharded entry the factory
    builds on the fleet mesh (once), equal to that entry called directly;
    its first calls carry phase="seq_sharded", its call the span
    ``seq_sharded_batch``; one oversize ledger row a batch, fill 1.0."""
    from wam_tpu_torch.serve import FleetServer, NoBucketError

    _, tm = _image_models()
    built = []

    def seq_factory(mesh):
        wam = tw.WaveletAttribution2D(tm, wavelet="db2", J=2, n_samples=2, mesh=mesh,
                                      device="cpu")
        built.append(mesh)
        return lambda xs, ys: wam(xs, ys)

    small = tw.WaveletAttribution2D(tm, wavelet="db2", J=2, n_samples=2, device="cpu")
    fleet = FleetServer(lambda rid, m, dev: small.serve_entry(), [(3, 32, 32)],
                        devices=["cpu"] * 2, warmup=False, oversize="fanout", max_batch=2)
    fleet_seq = FleetServer(lambda rid, m, dev: small.serve_entry(), [(3, 32, 32)],
                            devices=["cpu"] * 2, warmup=False, oversize="fanout", max_batch=2,
                            seq_factory=seq_factory)
    xs = np.random.default_rng(10).standard_normal((2, 3, 64, 32)).astype(np.float32)
    ys = np.array([1, 3], np.int32)
    was_tracing = ttracing.enabled()
    ttracing.set_enabled(True)
    try:
        with pytest.raises(NoBucketError):
            fleet.attribute_batch(xs, ys)
        since = tsentinel.trace_count()
        n_spans = len(ttracing.spans())
        got = fleet_seq.attribute_batch(xs, ys)
        spans = [sp for sp in ttracing.spans()[n_spans:] if sp["name"] == "seq_sharded_batch"]
        assert len(spans) == 1 and spans[0]["attrs"]["n_real"] == 2
        events = [e for e in tsentinel.compile_events() if e["seq"] > since]
        assert events and all(e["entry_kind"] == "seq" and e["phase"] == "seq_sharded"
                              for e in events)
        fleet_seq.attribute_batch(xs, ys)
        assert len(built) == 1 and built[0].shape == {"data": 2}
        rows = fleet_seq.metrics.oversize.batch_rows
        assert len(rows) == 2 and all(r["fill_ratio"] == 1.0 for r in rows)
        direct = tw.WaveletAttribution2D(tm, wavelet="db2", J=2, n_samples=2, mesh=built[0],
                                         device="cpu")
        want = direct(torch.from_numpy(xs), torch.from_numpy(ys).long())
        np.testing.assert_array_equal(got, want.numpy())
    finally:
        ttracing.set_enabled(was_tracing)
        fleet.close()
        fleet_seq.close()


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_batch_axis_matches_the_seq_only_mesh(ndim):
    """``batch_axis`` splits the rows over a second mesh axis (the cores
    only; the tails stay whole): SmoothGrad one sample a step and chunked,
    and IG, equal to the seq-only mesh's (the rows are independent, so the
    split changes no value), as the reference holds its batch-axis arm to
    its seq-only ``want`` arm."""
    model, x, level = _torch_case(ndim, "db2", "symmetric")
    if ndim == 3:
        model3 = model
        model = lambda s: model3(s[:, None])  # noqa: E731
    x, y = torch.cat([x, x.flip(0)]), torch.tensor([1, 3, 0, 2])
    kw = dict(ndim=ndim, wavelet="db2", level=level, mode="reflect" if ndim == 2 else "symmetric")
    seq_only = tpar.SeqShardedWam(tpar.make_mesh({"data": 4}, ["cpu"] * 4), model, **kw)
    batched = tpar.SeqShardedWam(tpar.make_mesh({"data": 4, "batch": 2}, ["cpu"] * 8), model,
                                 batch_axis="batch", **kw)
    for chunk in (1, 2):
        a = batched.smoothgrad(x, y, 3, n_samples=3, stdev_spread=0.1, sample_chunk=chunk)
        b = seq_only.smoothgrad(x, y, 3, n_samples=3, stdev_spread=0.1, sample_chunk=chunk)
        for p, q in zip(tree_leaves(a), tree_leaves(b)):
            _close(p, q.numpy(), 1e-6, f"smoothgrad chunk {chunk}")
    a, b = batched.integrated(x, y, n_steps=3), seq_only.integrated(x, y, n_steps=3)
    for p, q in zip(tree_leaves(a), tree_leaves(b)):
        _close(p, q.numpy(), 1e-6, "integrated")


def test_2d_mesh_nhwc_and_dwt_bf16_pass_through():
    """``model_layout="nhwc"`` under ``mesh=`` wraps the model with the
    transpose: equal to the NCHW explainer on the same mesh; ``dwt_bf16``
    rounds each noisy input to bfloat16 at the transform, as the
    single-device explainer does: within 1e-5 of its max (one sample a
    model call on both, the same draws)."""
    _, tm = _image_models()
    x = torch.randn(2, 3, 64, 32, generator=torch.Generator().manual_seed(12))
    y = torch.tensor([2, 0])
    kw = dict(wavelet="db2", J=2, n_samples=2, sample_batch_size=1, device="cpu")
    nchw = tw.WaveletAttribution2D(tm, mesh=_tmesh(), **kw)(x, y)
    nhwc = tw.WaveletAttribution2D(lambda v: tm(v.permute(0, 3, 1, 2)), model_layout="nhwc",
                                   mesh=_tmesh(), **kw)(x, y)
    assert torch.equal(nchw, nhwc)
    seq = tw.WaveletAttribution2D(tm, mesh=_tmesh(), dwt_bf16=True, **kw)(x, y)
    single = tw.WaveletAttribution2D(tm, dwt_bf16=True, stream_noise=True, **kw)(x, y)
    _close(seq, single.numpy(), 1e-5, "dwt_bf16")
    assert not torch.equal(seq, nchw)  # the rounding is applied
