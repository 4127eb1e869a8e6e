"""The port's fleet (`wam_tpu_torch.serve.fleet`, `serve.supervisor`,
`wam_tpu_torch.testing`) held to the reference's: the cases of
`tests/test_fleet.py` and `tests/test_resilience.py` on replicas over
``["cpu"] * n`` (one worker thread a replica), and cross-package cases:

- the same oversize batch through both fleets' "pjit" route, equal;
- the chaos layer's grammar and fault streams: the same seed gives the same
  fault sequence as `wam_tpu.testing.faults.FaultInjector`;
- a real two-replica fleet over a small ResNet-18 WAM-2D (the reference's
  weights carried over): served rows equal to the entry on the same batch,
  each replica's half of an oversize batch equal to the entry on that
  half, one first call a bucket per replica at warmup and none after.

Operational tests drive worker loops with GATED fake entries
(threading.Event handshakes, no sleeps) so the queue and routing states
they assert are deterministic; the one probabilistic test (chaos zero-loss)
runs a seeded fault schedule. Every wait takes a timeout."""

import random
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wam_tpu.serve as jserve
import wam_tpu.testing as jtesting
from wam_tpu_torch import obs
from wam_tpu_torch import testing as ttesting
from wam_tpu_torch.serve import (
    OVERSIZE_ENTRY_ID,
    FleetMetrics,
    FleetServer,
    NoBucketError,
    NoLiveReplicaError,
    QueueFullError,
    RetryPolicy,
    RetryStats,
    SupervisorConfig,
    jit_entry,
)
from wam_tpu_torch.serve.entry import RowBlocks

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

T = 10  # seconds: every future / join waits at most this long


def _fleet(factory, n=2, shapes=((4,),), **kw):
    kw.setdefault("max_batch", 1)
    kw.setdefault("max_wait_ms", 0.0)
    kw.setdefault("warmup", False)
    kw.setdefault("oversize", "fanout")
    return FleetServer(factory, list(shapes), devices=["cpu"] * n, **kw)


def _double(xs, ys):
    return xs * 2.0


def _row_wise(fn):
    """A plain entry declared row-wise (``entry.wam_row_wise``), so the
    "pjit" oversize route may split its rows over the replicas."""
    fn.wam_row_wise = True
    return fn


def _registry_total(prefix: str) -> float:
    return sum(v for k, v in obs.registry.collect().items() if k.startswith(prefix))


class _GateEntry:
    """Fake entry that parks its replica's worker inside the dispatch until
    released — deterministic in-flight state without sleeps."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()
        self.calls = 0

    def __call__(self, xs, ys):
        self.calls += 1
        self.entered.set()
        assert self.release.wait(timeout=T), "test gate never released"
        return xs * 2.0


def _gated(n=2, **kw):
    gates = {rid: _GateEntry() for rid in range(n)}
    return _fleet(lambda rid, m, dev: gates.get(rid, _double), n, **kw), gates


def _release(gates):
    for g in gates.values():
        g.release.set()


# -- routing and admission ------------------------------------------------------------


def test_routing_picks_idle_replica():
    """With replica 0 parked mid-dispatch (one batch in flight), the next
    submit routes to idle replica 1: 0's projected drain includes its
    in-flight batch."""
    fleet, gates = _gated(2)
    x = np.zeros((4,), np.float32)
    try:
        f0 = fleet.submit(x, 0)  # both idle -> tie-break to replica 0
        assert gates[0].entered.wait(timeout=T)
        f1 = fleet.submit(x, 0)  # 0 busy -> must land on 1
        assert gates[1].entered.wait(timeout=T)
        assert gates[0].calls == 1 and gates[1].calls == 1
        _release(gates)
        np.testing.assert_array_equal(f0.result(timeout=T), x * 2.0)
        np.testing.assert_array_equal(f1.result(timeout=T), x * 2.0)
    finally:
        _release(gates)
        fleet.close()


def test_shared_admission_rejects_only_when_all_full():
    fleet, gates = _gated(2, queue_depth=1)
    x = np.zeros((4,), np.float32)
    futs = []
    try:
        futs.append(fleet.submit(x, 0))  # in flight on 0
        assert gates[0].entered.wait(timeout=T)
        futs.append(fleet.submit(x, 0))  # in flight on 1
        assert gates[1].entered.wait(timeout=T)
        futs.append(fleet.submit(x, 0))  # queued (depth 1) on one replica
        futs.append(fleet.submit(x, 0))  # queued on the other
        with pytest.raises(QueueFullError) as ei:
            fleet.submit(x, 0)  # every queue full -> fleet-level reject
        assert ei.value.retry_after_s > 0
        _release(gates)
        for f in futs:
            np.testing.assert_array_equal(f.result(timeout=T), x * 2.0)
    finally:
        _release(gates)
        fleet.close()


def test_fleet_submit_validation_and_unported_options(monkeypatch):
    fleet, gates = _gated(2)
    try:
        with pytest.raises(ValueError, match="label"):
            fleet.submit(np.zeros((4,), np.float32))
        with pytest.raises(NoBucketError):
            fleet.submit(np.zeros((5,), np.float32), 0)  # before any queueing
        with pytest.raises(NoBucketError):  # no sequence-sharded route
            fleet.attribute_batch(np.zeros((2, 4096), np.float32), np.zeros((2,), np.int32))
        assert fleet.describe()["seq_route"] is False
        # registry= is ported (tests/test_torch_registry.py): start() on a
        # started fleet returns it and hydrates nothing
        assert fleet.start(registry="bundle.tar") is fleet and fleet.registry_report is None
    finally:
        _release(gates)
        fleet.close()
    # seq_factory= is the sequence-sharded route: an item above every bucket
    # runs through the entry it builds on the fleet mesh, once, lazily
    meshes = []
    seq = _fleet(lambda rid, m, dev: _double,
                 seq_factory=lambda mesh: meshes.append(mesh) or _double)
    try:
        assert seq.describe()["seq_route"] is True and not meshes
        xs = np.arange(2 * 4096, dtype=np.float32).reshape(2, 4096)
        for _ in range(2):
            np.testing.assert_array_equal(seq.attribute_batch(xs, np.zeros((2,), np.int32)),
                                          xs * 2.0)
        assert len(meshes) == 1 and meshes[0].shape == {"data": 2}
    finally:
        seq.close()
    # a bundle that is not there is a silent miss: the fleet compiles as without one
    missing = _fleet(lambda rid, m, dev: _double, registry="no-such-bundle")
    try:
        assert missing.registry_report.status == "no_manifest"
        assert missing.describe()["registry"] == "no-such-bundle"
    finally:
        missing.close()
    with pytest.raises(ValueError, match="oversize"):
        _fleet(_double, oversize="spread")
    with pytest.raises(ValueError, match="replicas=3 with 2"):
        _fleet(_double, replicas=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetServer(lambda rid, m, dev: _double, [(4,)], warmup=False)


# -- the oversize data-parallel path -------------------------------------------------


def _rows_entry(xs, ys):
    return xs * 2.0 + ys[:, None].to(xs.dtype)


def test_oversize_pjit_matches_the_entry_and_the_reference():
    """A 16-row batch on a 4-replica fleet (bucket cap 2) runs one block of
    rows a replica and equals the entry on the same rows — and the
    reference's fleet on the same batch."""
    calls = []

    def factory(rid, m, dev):
        def entry(xs, ys):
            if rid == OVERSIZE_ENTRY_ID:
                calls.append((threading.current_thread().name, xs.shape[0]))
            return _rows_entry(xs, ys)

        return _row_wise(entry)

    fleet = _fleet(factory, 4, max_batch=2, oversize="pjit")
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((16, 4)).astype(np.float32)
    ys = np.arange(16, dtype=np.int32)
    try:
        got = fleet.attribute_batch(xs, ys)
    finally:
        fleet.close()
    np.testing.assert_array_equal(got, _rows_entry(torch.from_numpy(xs), torch.from_numpy(ys)))
    # two fleet-wide chunks of 8 rows, 2 rows on each replica's own thread
    assert sorted(n for _, n in calls) == [2] * 8
    assert {name.rsplit("_", 1)[0] for name, _ in calls} == {
        f"wam-fleet-os-{rid}" for rid in range(4)}
    assert fleet.metrics.oversize.completed == 16 and fleet.metrics.oversize.batch_rows
    jfleet = jserve.FleetServer(lambda rid, m: jax.jit(lambda a, b: a * 2.0 + b[:, None]),
                                [(4,)], replicas=4, max_batch=2, warmup=False,
                                oversize="pjit")
    try:
        np.testing.assert_array_equal(got, jfleet.attribute_batch(xs, ys))
    finally:
        jfleet.close()


def test_oversize_partial_chunk_and_fanout_small_batch():
    """Oversize rows that don't fill the fleet-wide batch are replicate-
    padded (and sliced off); a batch within one replica's cap takes the
    routed per-item path."""
    fleet = _fleet(lambda rid, m, dev: _row_wise(lambda xs, ys: xs * 3.0), 2, max_batch=2,
                   oversize="pjit")
    rng = np.random.default_rng(1)
    try:
        xs = rng.standard_normal((7, 4)).astype(np.float32)
        np.testing.assert_array_equal(fleet.attribute_batch(xs, np.zeros((7,), np.int32)),
                                      xs * 3.0)
        assert fleet.metrics.oversize.completed == 7
        small = rng.standard_normal((2, 4)).astype(np.float32)
        np.testing.assert_array_equal(
            fleet.attribute_batch(small, np.zeros((2,), np.int32)), small * 3.0)
        assert fleet.metrics.oversize.completed == 7
    finally:
        fleet.close()


def test_pjit_refuses_an_entry_that_does_not_say_how_its_rows_split():
    """An entry that is neither row-wise nor carries RowBlocks would give
    rows that depend on the replica count: "pjit" refuses it at
    construction; "fanout" and a one-replica fleet take it."""
    with pytest.raises(ValueError, match="fanout"):
        _fleet(lambda rid, m, dev: _double, 2, oversize="pjit")
    with pytest.raises(ValueError, match="fanout"):
        _fleet(lambda rid, m, dev: jit_entry(_double), 2, oversize="pjit")
    for fleet in (_fleet(lambda rid, m, dev: jit_entry(_double), 2, oversize="fanout"),
                  _fleet(lambda rid, m, dev: _double, 1, oversize="pjit"),
                  _fleet(lambda rid, m, dev: _row_wise(jit_entry(_double)), 2,
                         oversize="pjit")):
        fleet.close()


def test_each_replica_computes_on_its_own_device():
    """The factory is told each replica's device: replica r's entry and its
    oversize entry are built for devices[r] (here "cpu:0" and "cpu:1", two
    names of the CPU), the served rows are staged there, and each oversize
    entry sees its own block of every fleet-wide chunk."""
    built, seen = [], []

    def factory(rid, m, dev):
        built.append((rid, dev))

        def entry(xs, ys):
            seen.append((rid, dev, xs.device, threading.current_thread().name,
                         xs[:, 0].tolist()))
            return xs * 2.0

        return _row_wise(entry)

    fleet = FleetServer(factory, [(4,)], devices=["cpu:0", "cpu:1"], max_batch=2,
                        max_wait_ms=0.0, warmup=False, oversize="pjit")
    xs = np.arange(28, dtype=np.float32).reshape(7, 4)
    try:
        got = fleet.attribute_batch(xs, np.zeros((7,), np.int32))
        fleet.attribute(xs[0], 0)
    finally:
        fleet.close()
    np.testing.assert_array_equal(got, xs * 2.0)
    devs = [torch.device("cpu:0"), torch.device("cpu:1")]
    assert fleet.devices == devs
    assert sorted(built, key=str) == sorted(
        [(0, devs[0]), (1, devs[1]), (OVERSIZE_ENTRY_ID, devs[0]),
         (OVERSIZE_ENTRY_ID, devs[1])], key=str)
    blocks = [(dev, name, rows) for rid, dev, _, name, rows in seen if rid == OVERSIZE_ENTRY_ID]
    # two chunks of 4 rows (the second replicate-padded): 2 rows a replica
    want = {(devs[0], 0.0), (devs[1], 8.0), (devs[0], 16.0), (devs[1], 24.0)}
    assert {(dev, rows[0]) for dev, _, rows in blocks} == want
    for dev, name, rows in blocks:
        assert name.startswith(f"wam-fleet-os-{devs.index(dev)}")
    served = [(rid, dev, xdev) for rid, dev, xdev, _, _ in seen if rid != OVERSIZE_ENTRY_ID]
    assert served and all(dev == devs[rid] for rid, dev, _ in served)


def _conv_wam2d(method: str, **kw):
    from wam_tpu_torch import WaveletAttribution2D

    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.ReLU(),
                              torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(),
                              torch.nn.Linear(4, 5))
    return WaveletAttribution2D(net, wavelet="db4", J=2, method=method, n_samples=4,
                                sample_batch_size=3, device="cpu", **kw)


@pytest.mark.parametrize("method,stream", [("smooth", False), ("smooth", True),
                                           ("integratedgrad", False)])
def test_oversize_blocks_equal_the_entry_on_the_whole_batch(method, stream):
    """A WAM-2D entry normalizes its mosaic over the batch and draws its
    noise at the batch's shape. On three replicas (two rows each), the
    "pjit" route's RowBlocks give the entry's result on the whole padded
    fleet-wide chunk: each block draws its rows of that chunk's noise,
    scales its loss by 2/6, and its mosaics are normalized by the max over
    all three blocks."""
    kw = {"stream_noise": True} if stream else {}
    wam = _conv_wam2d(method, **kw)
    fleet = FleetServer(lambda rid, m, dev: wam.serve_entry(), [(3, 24, 24)],
                        devices=["cpu"] * 3, max_batch=2, warmup=False, oversize="pjit")
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((5, 3, 24, 24)).astype(np.float32)
    ys = np.array([0, 1, 2, 3, 4], np.int32)
    try:
        got = fleet.attribute_batch(xs, ys)
    finally:
        fleet.close()
    pad = np.concatenate([xs, xs[:1]])  # the replicate pad to 3 x 2 rows
    want = wam.serve_entry()(torch.from_numpy(pad),
                             torch.from_numpy(np.append(ys, ys[0]))).detach().numpy()[:5]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # on one block alone, the rows differ: the route really reduces over blocks
    alone = wam.serve_entry()(torch.from_numpy(xs[:2]), torch.from_numpy(ys[:2])).detach()
    assert np.abs(got[:2] - alone.numpy()).max() > 1e-3 * np.abs(want).max()


def test_fleet_from_config_reads_the_fleet_knobs():
    """`FleetServer.from_config` reads ServeConfig's fleet, oversize,
    supervise and restart_* (and the knobs it shares with the server)."""
    from wam_tpu_torch.config import ServeConfig

    cfg = ServeConfig(device="cpu", fleet=3, oversize="fanout", supervise=True, restart_max=5,
                      restart_window_s=7.0, restart_backoff_ms=20.0, buckets="4,8",
                      warmup=False, max_batch=2, queue_depth=5, coalesce_ms=0.0,
                      result_cache_mb=0.0, health=False)
    fleet = FleetServer.from_config(cfg, lambda rid, m, dev: _double, seed=4)
    try:
        d = fleet.describe()
        assert (fleet.n_replicas, d["oversize"], d["buckets"], d["max_batch"]) == (
            3, "fanout", [[4], [8]], 2)
        assert fleet._os_entries is None and d["supervised"]
        sup = fleet._supervisor.config
        assert (sup.max_restarts, sup.window_s, sup.backoff_base_s, sup.seed) == (
            5, 7.0, 0.02, 4)
        np.testing.assert_array_equal(fleet.attribute(np.ones((4,), np.float32), 0),
                                      np.full((4,), 2.0, np.float32))
    finally:
        fleet.close()
    cfg = ServeConfig(device="cpu", fleet=2, oversize="pjit", supervise=False, buckets="4",
                      warmup=False)
    fleet = FleetServer.from_config(cfg, lambda rid, m, dev: _row_wise(_double))
    try:
        assert fleet._supervisor is None and len(fleet._os_entries) == 2
        assert fleet.describe()["max_batch"] == 8  # "auto"-free default
    finally:
        fleet.close()
    with pytest.raises(ValueError, match="buckets"):
        FleetServer.from_config(ServeConfig(device="cpu", fleet=2), lambda rid, m, dev: _double)


# -- replica death ---------------------------------------------------------------------


def test_replica_death_routes_to_survivors():
    def make_entry(rid, m, dev):
        if rid == 0:
            def dying(xs, ys):
                raise RuntimeError("replica 0 gone")

            return dying
        return _double

    fleet = _fleet(make_entry, 2)
    x = np.ones((4,), np.float32)
    try:
        futs = [fleet.submit(x, 0) for _ in range(4)]
        for f in futs:
            np.testing.assert_array_equal(f.result(timeout=T), x * 2.0)
        assert [r.rid for r in fleet._replicas if not r.alive] == [0]
        assert [d["replica_id"] for d in fleet.metrics.fleet_summary()["deaths"]] == [0]
        np.testing.assert_array_equal(fleet.attribute(x, 1), x * 2.0)
        xs = np.stack([x] * 3)  # oversize degrades to routed fan-out, still correct
        np.testing.assert_array_equal(fleet.attribute_batch(xs, np.zeros((3,), np.int32)),
                                      xs * 2.0)
    finally:
        fleet.close()


def test_no_live_replica_when_every_replica_dies_unsupervised():
    def dying(rid, m, dev):
        def entry(xs, ys):
            raise RuntimeError(f"replica {rid} gone")

        return entry

    fleet = _fleet(dying, 2)
    try:
        with pytest.raises(NoLiveReplicaError) as ei:
            fleet.submit(np.ones((4,), np.float32), 0).result(timeout=T)
        assert ei.value.retry_after_s is None  # nobody is coming back
        assert fleet.describe()["dead"] == [0, 1]
        with pytest.raises(NoLiveReplicaError):
            fleet.submit(np.ones((4,), np.float32), 0)
    finally:
        fleet.close()


# -- first calls, ledgers ------------------------------------------------------------


def _toy_wam2d():
    from wam_tpu_torch.models.toy import toy_conv_model
    from wam_tpu_torch.wam2d import BaseWAM2D

    kernel = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 1, 5, 5)) * 0.3)
    toy = toy_conv_model(kernel, device="cpu")
    return BaseWAM2D(lambda x: toy(x.mean(dim=1)), J=2, device="cpu")


def test_fleet_first_calls_once_per_bucket_per_replica():
    """Each replica owns its own entry: warmup makes every bucket's first
    call on every replica once, and the mixed-shape stream adds none."""
    wam = _toy_wam2d()
    shapes = [(1, 8, 8), (1, 16, 16)]
    fleet = _fleet(lambda rid, m, dev: wam.serve_entry(on_trace=m.note_compile), 2, shapes,
                   max_batch=2, warmup=True)
    try:
        for rep in fleet._replicas:
            assert rep.metrics.compile_count == len(shapes)
            assert set(rep.metrics.warmup_s) == {"1x8x8", "1x16x16"}
        stream = [(1, 8, 8), (1, 16, 16), (1, 6, 6), (1, 12, 12), (1, 8, 8)]
        rng = np.random.default_rng(2)
        with obs.assert_no_retrace():
            for i, shape in enumerate(stream):
                out = fleet.attribute(rng.standard_normal(shape).astype(np.float32), i % 4)
                assert out.shape[-1] == out.shape[-2]
        summary = fleet.metrics.fleet_summary()
        assert summary["compile_count"] == len(shapes) * 2
        assert summary["completed"] == len(stream)
    finally:
        fleet.close()


def test_fleet_ledger_schema(tmp_path):
    path = str(tmp_path / "fleet.jsonl")
    fleet = _fleet(lambda rid, m, dev: _row_wise(lambda xs, ys: xs * 1.0), 2, max_batch=2,
                   warmup=True, metrics_path=path, oversize="pjit")
    for i in range(6):
        fleet.attribute(np.zeros((4,), np.float32), i % 4)
    fleet.attribute_batch(np.zeros((8, 4), np.float32), np.zeros((8,), np.int32))
    fleet.close()
    rows = FleetMetrics.load_ledger(path)
    batches = [r for r in rows if r["metric"] == "serve_batch"]
    summaries = [r for r in rows if r["metric"] == "serve_summary"]
    fleet_rows = [r for r in rows if r["metric"] == "fleet_summary"]
    assert len(fleet_rows) == 1
    assert all("replica_id" in r for r in batches)
    assert {r["replica_id"] for r in summaries} >= {0, 1, "fleet"}
    for s in summaries:
        assert s["schema_version"] == 2 and isinstance(s["ema_service_s"], dict)
        for key in ("completed", "batches", "latency_p50_ms", "attributions_per_s"):
            assert key in s
    assert {str(r["replica_id"]) for r in fleet_rows[0]["per_replica"]} == {"0", "1"}
    assert fleet_rows[0]["oversize_completed"] == 8
    assert fleet_rows[0]["completed"] == 6 + 8
    assert all("utilization" in r for r in fleet_rows[0]["per_replica"])
    want = set(jserve.FleetMetrics().fleet_summary())
    assert set(fleet_rows[0]) - {"config"} == want  # the reference's keys
    warm = [s for s in summaries if s["replica_id"] in (0, 1)]
    assert all(s["warmup_s"].get("4", 0.0) > 0.0 for s in warm)


def test_fleet_metrics_get_or_create_and_restart_rows():
    obs.configure(enabled=True)
    obs.reset()
    fm = FleetMetrics()
    a = fm.replica(0)
    assert fm.replica(0) is a and a.replica_id == 0
    fm.note_replica_death(0, "test")
    s = fm.fleet_summary()
    assert s["replicas"] == 1 and len(s["deaths"]) == 1
    fm.note_restart(1, "restarting", attempt=1, backoff_s=0.05, reason="boom")
    row = fm.note_restart(1, "alive", attempt=1)
    assert row["metric"] == "replica_restart" and row["schema_version"] == 2
    jrow = jserve.FleetMetrics().note_restart(1, "alive", attempt=1)
    assert set(row) == set(jrow)
    fm.note_restart(2, "permanent_dead", attempt=3, reason="crash loop")
    s = fm.fleet_summary()
    assert s["restarts"] == 1 and s["permanent_dead"] == ["2"]
    assert _registry_total("wam_tpu_serve_restarts_total") == 1.0


def test_fleet_result_cache_canary_and_signals():
    """The shared admission-tier cache answers a repeat with no routing;
    a canary pins the highest replica and reports; the health-plane
    aggregate counts every replica."""
    fleet = _fleet(lambda rid, m, dev: _double, 2, result_cache=1 << 20, cache_id="toy")
    x = np.ones((4,), np.float32)
    try:
        first = fleet.attribute(x, 1)
        again = fleet.attribute(x, 1)
        np.testing.assert_array_equal(first, again)
        assert fleet.metrics.cache_hits == 1
        assert fleet.pin_canary("challenger") == 1
        with pytest.raises(ValueError, match="already the canary"):
            fleet.pin_canary("again")
        for i in range(4):
            fleet.attribute(np.full((4,), float(i), np.float32), 0, qos="batch")
        report = fleet.canary_report(min_batches=1)
        assert report["canary"] == 1 and report["verdict"] in ("champion", "challenger",
                                                               "insufficient")
        fleet.clear_canary()
        assert fleet.canary_report()["verdict"] == "none"
        sig = fleet.pod_signals()
        assert sig["live_replicas"] == 2 and sig["cache_hits"] == 1
        assert fleet.describe()["devices"] == ["cpu", "cpu"]
    finally:
        fleet.close()


# -- supervision -------------------------------------------------------------------------


def test_restart_rejoins_warm_with_ledger_roundtrip(tmp_path):
    """Kill each replica of a 3-replica fleet in turn under load: every
    request resolves, every replica is rebuilt by the supervisor (a NEW
    entry from the factory, warmed on the new worker: its first call is at
    warmup), no first call lands in the served window, and the
    ``replica_restart`` rows round-trip against the registry counter."""
    obs.configure(enabled=True)
    obs.reset()
    kills = {rid: threading.Event() for rid in range(3)}
    builds = {rid: 0 for rid in range(3)}

    class _Killable:
        def __init__(self, inner, rid):
            self._inner, self._rid = inner, rid

        def __call__(self, xs, ys):
            if kills[self._rid].is_set():
                kills[self._rid].clear()  # one death per arm
                raise RuntimeError(f"injected device loss on {self._rid}")
            return self._inner(xs, ys)

    def factory(rid, m, dev):
        builds[rid] += 1
        return _Killable(jit_entry(lambda xs, ys: xs * 2.0, on_trace=m.note_compile), rid)

    path = str(tmp_path / "fleet.jsonl")
    fleet = _fleet(factory, 3, warmup=True, metrics_path=path,
                   supervise=SupervisorConfig(max_restarts=8, window_s=60.0,
                                              backoff_base_s=0.001, jitter_frac=0.0, seed=0))
    x = np.ones((4,), np.float32)
    try:
        assert fleet.describe()["supervised"] is True
        served = obs.sentinel.trace_count()
        for rid in range(3):
            kills[rid].set()
            deadline = time.monotonic() + 30
            # rounds grow until the load spills onto every replica: the
            # router scores by each replica's own EMA, so a replica whose
            # one slow batch left it a high EMA takes no item while the
            # others have room (up to 150 items: under the fleet's 3 x 64
            # queue slots)
            n = 6
            while kills[rid].is_set():
                futs = [fleet.submit(x, i % 4) for i in range(n)]
                for f in futs:
                    np.testing.assert_array_equal(f.result(timeout=T), x * 2.0)
                assert time.monotonic() < deadline, f"replica {rid} never took its kill"
                n = min(2 * n, 150)
            while not fleet._replicas[rid].alive:
                assert time.monotonic() < deadline, f"replica {rid} never restarted"
                time.sleep(0.005)
        for i in range(6):
            np.testing.assert_array_equal(fleet.attribute(x, i % 4), x * 2.0)
        events = obs.sentinel.compile_events(since_seq=served)
        assert events and all(e["phase"] == "warmup" for e in events)
    finally:
        for e in kills.values():
            e.clear()
        fleet.close()
    assert builds == {0: 2, 1: 2, 2: 2}
    rows = FleetMetrics.load_ledger(path)
    restarts = [r for r in rows if r.get("metric") == "replica_restart"]
    alive = [r for r in restarts if r["transition"] == "alive"]
    assert {r["replica_id"] for r in alive} == {0, 1, 2}
    for rid in range(3):
        assert [r["transition"] for r in restarts if r["replica_id"] == rid] == [
            "restarting", "alive"]
    assert _registry_total("wam_tpu_serve_restarts_total") == len(alive) == 3
    fleet_rows = [r for r in rows if r.get("metric") == "fleet_summary"]
    assert fleet_rows[0]["restarts"] == 3 and fleet_rows[0]["permanent_dead"] == []
    per = {r["replica_id"]: r["compile_count"] for r in fleet_rows[0]["per_replica"]}
    assert per == {0: 2, 1: 2, 2: 2}  # one first call an incarnation, both at warmup


def test_crash_loop_escalates_to_permanent_dead():
    def factory(rid, m, dev):
        if rid == 0:
            def dying(xs, ys):
                raise RuntimeError("replica 0 is cursed")

            return dying

        def survivor(xs, ys):
            time.sleep(0.02)  # a drain under a burst above the dead one's EMA seed
            return xs * 2.0

        return survivor

    fleet = _fleet(factory, 2, supervise=SupervisorConfig(
        max_restarts=1, window_s=60.0, backoff_base_s=0.001, jitter_frac=0.0, seed=1))
    x = np.ones((4,), np.float32)
    try:
        deadline = time.monotonic() + 20
        while not fleet._supervisor.permanently_dead(0):
            futs = [fleet.submit(x, 0) for _ in range(6)]
            for f in futs:
                np.testing.assert_array_equal(f.result(timeout=T), x * 2.0)
            assert time.monotonic() < deadline, "never escalated"
            time.sleep(0.002)
        while True:
            transitions = [r["transition"] for r in fleet.metrics.restarts
                           if r["replica_id"] == 0]
            if "permanent_dead" in transitions:
                break
            assert time.monotonic() < deadline
            time.sleep(0.002)
        assert "restarting" in transitions and "alive" in transitions
        assert transitions[-1] == "permanent_dead"
        assert fleet.describe()["supervision"]["permanent_dead"] == [0]
        np.testing.assert_array_equal(fleet.attribute(x, 1), x * 2.0)
    finally:
        fleet.close()


def test_chaos_fleet_zero_loss_with_supervision():
    """A supervised 4-replica fleet under a seeded chaos schedule (injected
    deaths + latency) with retrying clients loses no request."""
    obs.configure(enabled=True)
    obs.reset()
    sched = ttesting.ChaosSchedule("exc=0.15,latency=0.1:2", seed=11)
    fleet = _fleet(sched.wrap_factory(lambda rid, m, dev: _double), 4, queue_depth=2,
                   supervise=SupervisorConfig(max_restarts=50, window_s=60.0,
                                              backoff_base_s=0.001, jitter_frac=0.0, seed=11))
    policy = RetryPolicy(max_attempts=8, budget_s=20.0, backoff_base_s=0.002,
                         backoff_cap_s=0.05, retry_on=(QueueFullError, NoLiveReplicaError))
    stats = RetryStats()
    x = np.ones((4,), np.float32)
    ok, errs = {"n": 0}, []
    lock = threading.Lock()

    def client(cid):
        rng = random.Random(cid)
        for i in range(12):
            try:
                out = fleet.submit_with_retry(x, i % 4, policy=policy, stats=stats,
                                              rng=rng).result(timeout=30)
                np.testing.assert_array_equal(out, x * 2.0)
                with lock:
                    ok["n"] += 1
            except Exception as e:  # noqa: BLE001 - tallied, asserted below
                with lock:
                    errs.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        fleet.close()
    assert not any(t.is_alive() for t in threads)
    assert not errs, f"lost/failed requests under chaos: {errs[:3]}"
    assert ok["n"] == 48 and sched.injected_total() > 0
    summary = fleet.metrics.fleet_summary()
    assert summary["restarts"] > 0 and summary["permanent_dead"] == []


# -- the chaos layer against the reference -------------------------------------------


@pytest.mark.parametrize("spec", ["default", "off", "nan=0.05,exc=0.02,latency=0.1:20",
                                  "0:exc=0.5;*:nan=0.1", "oom=0.3"])
def test_parse_chaos_matches_the_reference(spec):
    got, want = ttesting.parse_chaos(spec), jtesting.parse_chaos(spec)
    assert {k: vars(v) for k, v in got.items()} == {k: vars(v) for k, v in want.items()}


def test_chaos_errors_match_the_reference():
    for call in (lambda m: m.parse_chaos("bogus=1"), lambda m: m.FaultSpec(nan_p=0.9, exc_p=0.9)):
        with pytest.raises(ValueError) as want:
            call(jtesting)
        with pytest.raises(ValueError) as got:
            call(ttesting)
        assert str(got.value) == str(want.value)
    sched = ttesting.ChaosSchedule("0:exc=0.5;*:nan=0.1", seed=3)
    assert sched.spec_for(0).exc_p == 0.5 and sched.spec_for(2).nan_p == 0.1
    assert sched.injector(0) is sched.injector(0)  # a restart keeps the stream


@pytest.mark.parametrize("seed, replica", [(7, 0), (7, 1), (11, 3), (0, None)])
def test_fault_streams_match_the_reference(seed, replica):
    """The same (seed, replica) gives the same fault sequence in both
    packages, and another replica another one."""
    spec = dict(nan_p=0.3, exc_p=0.2, oom_p=0.05, latency_p=0.2)
    t = ttesting.FaultInjector(ttesting.FaultSpec(**spec), seed=seed, replica=replica)
    j = jtesting.FaultInjector(jtesting.FaultSpec(**spec), seed=seed, replica=replica)
    seq = [t.draw() for _ in range(64)]
    assert seq == [j.draw() for _ in range(64)] and any(k is not None for k in seq)
    other = ttesting.FaultInjector(ttesting.FaultSpec(**spec), seed=seed, replica="x")
    assert seq != [other.draw() for _ in range(64)]


def test_chaos_entry_faults_and_warmup_exemption():
    from wam_tpu_torch.testing.faults import ChaosEntry

    calls = []

    def inner(xs, ys):
        calls.append(1)
        return xs * 1.0

    inj = ttesting.FaultInjector(ttesting.FaultSpec(exc_p=1.0), seed=0, replica=0)
    entry = ChaosEntry(inner, inj)
    with obs.sentinel.label(phase="warmup"):  # warmup passes clean, no draw
        entry(torch.ones(2), None)
    assert len(calls) == 1 and inj.total() == 0
    with pytest.raises(ttesting.ChaosFault):
        entry(torch.ones(2), None)
    assert inj.counts == {"exc": 1}
    inj2 = ttesting.FaultInjector(ttesting.FaultSpec(nan_p=1.0), seed=0, replica=0)
    out = ChaosEntry(inner, inj2)(torch.ones(4), None)
    assert not torch.isfinite(out).all() and inj2.counts == {"nan": 1}
    health = ChaosEntry(jit_entry(lambda xs, ys: xs * 1.0, with_health=True), inj2)
    res, hvec = health(torch.ones(4), None)
    assert not torch.isfinite(res).all() and float(hvec[0]) > 0  # the vector sees the NaN


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_stager_chaos_fails_the_request_as_the_reference_does():
    """A staging fault (`stager_chaos`) lands outside the entry's guarded
    path in both packages: the worker's crash guard fails the request with
    `WorkerCrashedError` (typed, never a hang) and closes the server."""
    from wam_tpu_torch.serve import AttributionServer, ServerClosedError, WorkerCrashedError

    kinds = {}
    for name, mod, serve_mod, entry, kw in (
            ("port", ttesting, AttributionServer, _double, {"device": "cpu"}),
            ("reference", jtesting, jserve.AttributionServer, lambda xs, ys: xs * 2.0, {})):
        inj = mod.FaultInjector(mod.FaultSpec(exc_p=1.0), seed=0, replica=0)
        server = serve_mod(entry, [(4,)], max_batch=1, max_wait_ms=0.0, warmup=False, **kw)
        try:
            with mod.stager_chaos(inj):
                with pytest.raises(Exception) as ei:
                    server.submit(np.ones((4,), np.float32), 0).result(timeout=T)
            kinds[name] = type(ei.value).__name__
            assert inj.counts == {"exc": 1}
            if name == "port":
                assert isinstance(ei.value, WorkerCrashedError)
                with pytest.raises(ServerClosedError):
                    server.submit(np.ones((4,), np.float32), 0)
            server._worker.join(timeout=T)
        finally:
            server.close()
    assert kinds["port"] == kinds["reference"] == "WorkerCrashedError"


# -- a real fleet ---------------------------------------------------------------------


def test_two_replica_resnet_fleet_serves_the_entry():
    """Two replicas over a ResNet-18 WAM-2D (haar, J=2, IG with 2 path
    points, the reference's init carried over) on 32² and 40² buckets: each
    served row equals the entry on the batch it was served in, both
    replicas serve, one first call a bucket per replica at warmup and none
    after, and an oversize batch equals the entry on each fleet-wide
    chunk (the rows of both replicas), as the reference's pjit program."""
    from wam_tpu.models import resnet18 as jresnet18
    from wam_tpu_torch import WaveletAttribution2D
    from wam_tpu_torch.models import resnet as tres
    from wam_tpu_torch.models.ingest import flax_resnet_to_torch

    model = jresnet18(num_classes=10)
    rng = np.random.default_rng(9)
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    variables = jax.tree_util.tree_map_with_path(
        lambda p, leaf: (np.zeros(leaf.shape, np.float32) if p[0].key == "perturbations" else
                         (rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
                          if p[-1].key == "kernel" else rng.uniform(0.8, 1.2, leaf.shape))
                         .astype(np.float32)), tree)
    fn = tres.bind_inference(tres.resnet18(num_classes=10), flax_resnet_to_torch(variables),
                             device="cpu")
    wam = WaveletAttribution2D(fn, wavelet="haar", J=2, method="integratedgrad", n_samples=2,
                               device="cpu")
    batches = []

    class _Recorder:
        def __init__(self, inner, rid):
            self.inner, self.rid = inner, rid

            # the oversize route runs the entry's RowBlocks: record its blocks
            self.wam_blocks = RowBlocks(self._partial, inner.wam_blocks.finish)

        def _partial(self, xs, ys, lo, total):
            batches.append((self.rid, xs.clone(), ys.clone(), (lo, total)))
            return self.inner.wam_blocks.partial(xs, ys, lo, total)

        def __call__(self, xs, ys):
            out = self.inner(xs, ys)
            batches.append((self.rid, xs.clone(), ys.clone(), out.detach().clone()))
            return out

    obs.reset()
    fleet = FleetServer(lambda rid, m, dev: _Recorder(wam.serve_entry(on_trace=m.note_compile), rid),
                        [(3, 32, 32), (3, 40, 40)], devices=["cpu", "cpu"], max_batch=2,
                        max_wait_ms=50.0, oversize="pjit")
    xs = [rng.standard_normal((3, s, s)).astype(np.float32) for s in (32, 40, 32, 40) * 2]
    try:
        warm = obs.sentinel.trace_count()
        batches.clear()
        with obs.assert_no_retrace():
            futs = [fleet.submit(x, i % 10) for i, x in enumerate(xs)]
            outs = [f.result(timeout=60) for f in futs]
        assert warm == 4  # two buckets x two replicas, at warmup
        big = np.stack([x for x in xs if x.shape[-1] == 32] * 2)  # 8 rows, cap 2
        over = fleet.attribute_batch(big, np.arange(8) % 10)
    finally:
        fleet.close()
    ref = wam.serve_entry()
    served_by = {rid for rid, *_ in batches}
    assert served_by == {0, 1, OVERSIZE_ENTRY_ID}, served_by  # both replicas served
    assert sorted(b[3] for b in batches if b[0] == OVERSIZE_ENTRY_ID) == [
        (0, 4), (0, 4), (2, 4), (2, 4)]  # two chunks: rows 0-1 and 2-3 of each
    for i, (x, out) in enumerate(zip(xs, outs)):
        hit = [b for b in batches if b[0] != OVERSIZE_ENTRY_ID and b[1].shape[-1] == x.shape[-1]
               and any(torch.equal(b[1][r, :, :x.shape[1], :x.shape[2]], torch.from_numpy(x))
                       and int(b[2][r]) == i % 10 for r in range(b[1].shape[0]))]
        assert hit, i
        _, bx, by, bout = hit[0]
        r = next(r for r in range(bx.shape[0])
                 if torch.equal(bx[r, :, :x.shape[1], :x.shape[2]], torch.from_numpy(x)))
        np.testing.assert_array_equal(out, bout[r].numpy())
        want = ref(bx, by)[r].detach().numpy()
        assert np.abs(out - want).max() <= 1e-5 * np.abs(want).max()
    ys = torch.from_numpy(np.arange(8) % 10)
    for lo in (0, 4):  # a fleet-wide chunk is 4 rows: 2 a replica
        want = ref(torch.from_numpy(big[lo:lo + 4]), ys[lo:lo + 4]).detach().numpy()
        assert np.abs(over[lo:lo + 4] - want).max() <= 1e-5 * np.abs(want).max()


def _blocks_entry(kind: str, method: str = "smooth"):
    """(serve entry, item shape) of each explainer whose rows the "pjit"
    route splits, on a tiny seeded model."""
    import wam_tpu_torch as wtt

    torch.manual_seed(1)
    nn = torch.nn
    kw = dict(method=method, n_samples=3, sample_batch_size=2, device="cpu")
    if kind == "1d":
        net = nn.Sequential(nn.Conv2d(1, 2, 3), nn.ReLU(), nn.AdaptiveAvgPool2d(1), nn.Flatten(),
                            nn.Linear(2, 5))
        wam = wtt.WaveletAttribution1D(net, wavelet="db2", J=2, n_fft=128, n_mels=8,
                                       sample_rate=8000, stdev_spread=0.1, **kw)
        return wam.serve_entry(), (512,)
    if kind == "3d":
        net = nn.Sequential(nn.Conv3d(1, 2, 3), nn.ReLU(), nn.AdaptiveAvgPool3d(1), nn.Flatten(),
                            nn.Linear(2, 5))
        wam = wtt.WaveletAttribution3D(net, wavelet="haar", J=2, stdev_spread=0.1, **kw)
        return wam.serve_entry(), (1, 8, 8, 8)
    if kind == "video":
        net = nn.Sequential(nn.Conv3d(1, 2, 3), nn.ReLU(), nn.AdaptiveAvgPool3d(1), nn.Flatten(),
                            nn.Linear(2, 5))
        wam = wtt.WaveletAttributionVideo(net, wavelet="haar", levels=(2, 1), stdev_spread=0.1,
                                          **kw)
        return wam.serve_entry(), (1, 4, 8, 8)
    net = nn.Sequential(nn.Conv2d(3, 4, 3), nn.ReLU(), nn.AdaptiveAvgPool2d(1), nn.Flatten(),
                        nn.Linear(4, 5))
    if kind.startswith("base2d"):
        wam = wtt.BaseWAM2D(net, wavelet="db2", J=2, device="cpu")
    else:
        wam = wtt.WaveletAttribution2D(net, wavelet="db2", J=2, **kw)
    return wam.serve_entry(with_health=kind.endswith("+health")), (3, 16, 16)


def _np_leaves(t):
    if isinstance(t, (tuple, list)):
        return [leaf for v in t for leaf in _np_leaves(v)]
    return [np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor) else t)]


def _rel_close(got, want, tol=1e-5):
    got, want = _np_leaves(got), _np_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol * np.abs(w).max(), np.abs(g - w).max()


@pytest.mark.parametrize("kind,method", [("1d", "smooth"), ("1d", "integratedgrad"),
                                         ("3d", "smooth"), ("video", "integratedgrad"),
                                         ("video", "smooth"), ("base2d", None),
                                         ("base2d+health", None), ("wam2d+health", "smooth")])
def test_every_entry_carries_blocks_equal_to_the_whole_batch(kind, method):
    """The 1D, 3D, video, `BaseWAM2D` and health entries carry RowBlocks:
    through the fleet's "pjit" route on three replicas (two rows each, the
    chunk replicate-padded), and block by block, they give the entry's
    result on the whole padded batch within 1e-5 of its max; a health
    entry's merged vector equals the whole batch's at the same bound."""
    from wam_tpu_torch.serve.entry import join_blocks

    entry, shape = _blocks_entry(kind, method or "smooth")
    assert entry.wam_blocks is not None
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((5,) + shape).astype(np.float32)
    ys = np.array([0, 1, 2, 3, 4], np.int64)
    pad_x, pad_y = np.concatenate([xs, xs[:1]]), np.append(ys, ys[0])
    whole = entry(torch.from_numpy(pad_x), torch.from_numpy(pad_y))
    parts = []
    states = []
    for rid in range(3):
        sl = slice(2 * rid, 2 * rid + 2)
        states.append(entry.wam_blocks.partial(torch.from_numpy(pad_x[sl]),
                                               torch.from_numpy(pad_y[sl]), 2 * rid, 6))
    from wam_tpu_torch.evalsuite.fan import device_fetch
    from wam_tpu_torch.serve.fleet import _tree_max

    maxima = _tree_max([device_fetch(m) for _, m in states])
    parts = [device_fetch(entry.wam_blocks.finish(st, maxima)) for st, _ in states]
    health = getattr(entry, "wam_health", False)
    _rel_close(join_blocks(parts, health=health), whole)
    fleet = FleetServer(lambda rid, m, dev: _blocks_entry(kind, method or "smooth")[0], [shape],
                        devices=["cpu"] * 3, max_batch=2, warmup=False, oversize="pjit")
    try:
        got = fleet.attribute_batch(xs, ys)
    finally:
        fleet.close()
    _rel_close(got, [w[:5] for w in _np_leaves(whole[0] if health else whole)])
