"""The port's serving runtime (`wam_tpu_torch.serve`) held to the
reference's (`wam_tpu.serve`): case for case with `tests/test_serve.py`
(bucket routing, padding correctness through a real engine, one first call
per bucket, backpressure, deadlines, opt-in degradation, per-bucket drain,
the ledger), the admission semantics of `tests/test_coalesce.py` and the
anytime server of `tests/test_anytime.py` that the flagship path uses, and
cross-package cases:

- one scripted request stream through both servers, with the same
  deterministic fake entry: the first request parks the worker inside the
  entry and every other request is submitted before it resumes (the
  reference's ``submit`` refuses requests before ``start()``, so the gate
  is what makes batch composition deterministic); the batches (bucket, real
  rows, padding), their dispatch order, every request's result or typed
  error and the ledger rows less their time fields must be equal;
- ``serve_entry`` of both packages on ResNet-18 at 32², J=2: IG equal
  within 1e-4 of the max; SmoothGrad (the JAX entry draws its own noise)
  bit-equal to the port's own ``smooth_wam`` on the same seed, through the
  server too.

Every wait takes a timeout."""

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wam_tpu.serve as jserve
import wam_tpu_torch.serve as tserve
import wam_tpu_torch.tune as ttune
from wam_tpu_torch import obs
from wam_tpu_torch.serve import (
    AttributionServer,
    Bucket,
    BucketTable,
    DeadlineExceededError,
    InvalidDeadlineError,
    NoBucketError,
    QueueFullError,
    ServeError,
    ServeMetrics,
    ServerClosedError,
    pad_item,
)

T = 10  # seconds: every future / join waits at most this long


def _server(entry, shapes=((4,),), **kw):
    kw.setdefault("warmup", False)
    return AttributionServer(entry, list(shapes), device="cpu", **kw)


# -- shape bucketing ----------------------------------------------------------


def test_bucket_table_selects_smallest_fit():
    table = BucketTable([(1, 64, 64), (1, 32, 32), (1, 48, 48)])
    assert table.select((1, 32, 32)).shape == (1, 32, 32)
    assert table.select((1, 20, 20)).shape == (1, 32, 32)
    assert table.select((1, 33, 32)).shape == (1, 48, 48)
    assert table.select((1, 64, 64)).shape == (1, 64, 64)
    with pytest.raises(NoBucketError):
        table.select((1, 65, 64))
    with pytest.raises(NoBucketError):
        table.select((32, 32))
    with pytest.raises(ValueError):
        BucketTable([(1, 32, 32), (1, 32, 32)])
    with pytest.raises(ValueError):
        BucketTable([])


def test_pad_item_and_waste():
    b = Bucket.of((1, 8, 8))
    x = np.arange(2 * 3, dtype=np.float32).reshape(1, 2, 3)
    padded = pad_item(x, b)
    assert padded.shape == (1, 8, 8)
    np.testing.assert_array_equal(padded[:, :2, :3], x)
    assert padded.sum() == x.sum()
    assert b.pad_waste(x.shape) == pytest.approx(1.0 - 6 / 64)
    assert b.pad_waste((1, 8, 8)) == 0.0
    assert pad_item(padded, b) is padded
    np.testing.assert_array_equal(padded, jserve.pad_item(x, jserve.Bucket.of((1, 8, 8))))


def test_serve_config_bucket_parsing():
    from wam_tpu_torch.config import ServeConfig

    cfg = ServeConfig(buckets="3x224x224, 3x256x256,32768")
    assert cfg.bucket_shapes() == [(3, 224, 224), (3, 256, 256), (32768,)]
    assert ServeConfig().bucket_shapes() == []


# -- padding correctness through a real engine --------------------------------


def _toy_wam2d():
    from wam_tpu_torch.models.toy import toy_conv_model
    from wam_tpu_torch.wam2d import BaseWAM2D

    kernel = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 1, 5, 5)) * 0.3)
    toy = toy_conv_model(kernel, device="cpu")
    return BaseWAM2D(lambda x: toy(x.mean(dim=1)), J=2, device="cpu")


def test_batch_pad_matches_unbatched_reference():
    """A lone request in a replicate-padded max_batch=4 batch comes back
    identical to the unbatched engine call."""
    wam = _toy_wam2d()
    x = np.random.default_rng(1).standard_normal((1, 16, 16)).astype(np.float32)
    ref = wam(torch.from_numpy(x[None]), torch.tensor([2])).numpy()[0]
    server = _server(wam.serve_entry(), [(1, 16, 16)], max_batch=4)
    try:
        got = server.submit(x, 2).result(timeout=T)
    finally:
        server.close()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_spatial_pad_matches_padded_reference():
    wam = _toy_wam2d()
    bucket = Bucket.of((1, 16, 16))
    x_small = np.random.default_rng(2).standard_normal((1, 12, 12)).astype(np.float32)
    ref = wam(torch.from_numpy(pad_item(x_small, bucket)[None]), torch.tensor([1])).numpy()[0]
    server = _server(wam.serve_entry(), [bucket.shape], max_batch=4)
    try:
        got = server.submit(x_small, 1).result(timeout=T)
    finally:
        server.close()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_mixed_stream_compiles_once_per_bucket():
    """A >= 3-shape stream (exact and undersized fits) meets each bucket's
    first call exactly once — at warmup — counted through
    serve_entry(on_trace=...)."""
    wam = _toy_wam2d()
    metrics = ServeMetrics()
    shapes = [(1, 8, 8), (1, 16, 16), (1, 24, 24)]
    server = _server(wam.serve_entry(on_trace=metrics.note_compile), shapes, max_batch=2,
                     metrics=metrics, warmup=True)
    assert metrics.compile_count == len(shapes)
    stream = [(1, 8, 8), (1, 16, 16), (1, 24, 24), (1, 6, 6), (1, 12, 12),
              (1, 20, 20), (1, 8, 8), (1, 24, 24)]
    rng = np.random.default_rng(0)
    try:
        for i, shape in enumerate(stream):
            out = server.submit(rng.standard_normal(shape).astype(np.float32),
                                i % 4).result(timeout=T)
            assert out.shape[-1] == out.shape[-2]
    finally:
        server.close()
    assert metrics.compile_count == len(shapes)
    assert metrics.completed == len(stream)


# -- operational semantics (gated fake entries) -------------------------------


class _GateEntry:
    """Fake entry that parks the worker thread inside the dispatch until
    released — deterministic queue buildup without sleeps."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()
        self.calls = 0

    def __call__(self, xs, ys):
        self.calls += 1
        self.entered.set()
        assert self.release.wait(timeout=T), "test gate never released"
        return np.asarray(xs) * 2.0


def test_backpressure_rejects_with_retry_after():
    entry = _GateEntry()
    server = _server(entry, max_batch=1, max_wait_ms=0.0, queue_depth=2)
    x = np.zeros((4,), np.float32)
    try:
        first = server.submit(x, 0)
        assert entry.entered.wait(timeout=T)
        server.submit(x, 0)
        server.submit(x, 0)
        with pytest.raises(QueueFullError) as ei:
            server.submit(x, 0)
        assert ei.value.retry_after_s > 0
        assert server.metrics.rejected == 1
        entry.release.set()
        np.testing.assert_array_equal(first.result(timeout=T), x * 2.0)
    finally:
        entry.release.set()
        server.close()
    assert server.metrics.completed == 3


def test_deadline_lapses_while_queued():
    entry = _GateEntry()
    server = _server(entry, max_batch=1, max_wait_ms=0.0, queue_depth=8)
    x = np.zeros((4,), np.float32)
    try:
        first = server.submit(x, 0)
        assert entry.entered.wait(timeout=T)
        doomed = server.submit(x, 0, deadline_ms=30.0)
        threading.Event().wait(0.1)
        entry.release.set()
        first.result(timeout=T)
        with pytest.raises(DeadlineExceededError):
            doomed.result(timeout=T)
    finally:
        entry.release.set()
        server.close()
    assert server.metrics.expired == 1


def test_submit_validation_and_close():
    server = _server(lambda xs, ys: np.asarray(xs), max_batch=1)
    x = np.zeros((4,), np.float32)
    with pytest.raises(ValueError, match="label"):
        server.submit(x)
    with pytest.raises(NoBucketError):
        server.submit(np.zeros((5,), np.float32), 0)
    for bad in (0, -5.0):
        with pytest.raises(InvalidDeadlineError) as ei:
            server.submit(x, 1, deadline_ms=bad)
        assert ei.value.deadline_ms == bad
        assert isinstance(ei.value, ValueError) and isinstance(ei.value, ServeError)
    with pytest.raises(ValueError, match="anytime"):
        server.submit(x, 1, min_confidence=0.5)
    with pytest.raises(ValueError, match="qos"):
        server.submit(x, 1, qos="bulk")
    server.close()
    with pytest.raises(ServerClosedError):
        server.submit(x, 0)


def test_unlabeled_server():
    server = _server(lambda xs, ys: np.asarray(xs) + (0.0 if ys is None else 1.0),
                     max_batch=2, labeled=False)
    x = np.arange(4, dtype=np.float32)
    try:
        with pytest.raises(ValueError, match="unlabeled"):
            server.submit(x, 3)
        np.testing.assert_array_equal(server.submit(x).result(timeout=T), x)
    finally:
        server.close()


def test_cpu_fallback_on_device_loss(monkeypatch):
    """Opt-in degradation: the entry raises, the forced re-probe says the
    card is gone -> the server swaps in the fallback entry once, warns,
    replays the batch on it, and keeps serving with ``degraded`` true in
    its description."""
    from wam_tpu_torch import config as tconfig

    calls = {"probe": 0}

    def fake_probe(timeout_s: float = 180.0):
        calls["probe"] += 1
        return False

    monkeypatch.setattr(tconfig, "probe_accelerator", fake_probe)

    def dying_entry(xs, ys):
        raise RuntimeError("device lost")

    server = _server(dying_entry, max_batch=1,
                     fallback_factory=lambda: (lambda xs, ys: np.asarray(xs) * 3.0))
    x = np.ones((4,), np.float32)
    try:
        with pytest.warns(RuntimeWarning, match="degraded"):
            out = server.submit(x, 0).result(timeout=T)
        np.testing.assert_array_equal(out, x * 3.0)
        assert server.degraded and server.describe()["degraded"]
        assert calls["probe"] == 1 and server.metrics.fallbacks >= 1
        np.testing.assert_array_equal(server.submit(x, 1).result(timeout=T), x * 3.0)
        assert calls["probe"] == 1
    finally:
        server.close()


def test_healthy_accelerator_reraises(monkeypatch):
    from wam_tpu_torch import config as tconfig

    monkeypatch.setattr(tconfig, "probe_accelerator", lambda timeout_s=180.0: True)

    def buggy_entry(xs, ys):
        raise RuntimeError("actual bug")

    server = _server(buggy_entry, max_batch=1,
                     fallback_factory=lambda: (lambda xs, ys: np.asarray(xs)))
    try:
        with pytest.raises(RuntimeError, match="actual bug"):
            server.submit(np.ones((4,), np.float32), 0).result(timeout=T)
        assert not server.degraded and server.metrics.failed == 1
    finally:
        server.close()


def test_no_fallback_factory_fails_the_batch_typed(monkeypatch):
    """Degradation is opt-in: without a factory the batch's requests fail
    with the entry's own error and the card is never probed."""
    from wam_tpu_torch import config as tconfig

    monkeypatch.setattr(tconfig, "probe_accelerator",
                        lambda *a, **k: pytest.fail("probed without a fallback_factory"))

    def dying_entry(xs, ys):
        raise RuntimeError("kernel launch failed")

    server = _server(dying_entry, max_batch=2, max_wait_ms=0.0)
    try:
        futs = [server.submit(np.ones((4,), np.float32), i) for i in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="kernel launch failed"):
                f.result(timeout=T)
        assert not server.degraded and server.metrics.failed == 3
    finally:
        server.close()


def test_projected_drain_is_per_bucket():
    from wam_tpu_torch.serve.metrics import EMA_SEED_S

    entry = _GateEntry()
    server = _server(entry, [(4,), (8,)], max_batch=1, max_wait_ms=0.0, queue_depth=8)
    x4 = np.zeros((4,), np.float32)
    try:
        assert server.projected_drain_s() == 0.0
        first = server.submit(x4, 0)
        assert entry.entered.wait(timeout=T)
        assert server.projected_drain_s() == pytest.approx(EMA_SEED_S)
        server.submit(x4, 0)
        assert server.projected_drain_s() == pytest.approx(2 * EMA_SEED_S)
        entry.release.set()
        first.result(timeout=T)
    finally:
        entry.release.set()
        server.close()


def test_warmup_ledger_and_per_bucket_ema():
    metrics = ServeMetrics()
    server = _server(lambda xs, ys: np.asarray(xs), [(4,), (8,)], max_batch=2, warmup=True,
                     metrics=metrics)
    try:
        server.submit(np.zeros((4,), np.float32), 0).result(timeout=T)
    finally:
        server.close()
    snap = metrics.snapshot()
    assert set(snap["warmup_s"]) == {"4", "8"}
    assert all(v > 0.0 for v in snap["warmup_s"].values())
    assert set(snap["ema_service_s"]) == {"4"}
    assert snap["schema_version"] == 2 and snap["replica_id"] is None


def test_warmup_runs_on_the_worker_thread_and_its_error_raises_from_start():
    """The warmup calls run on the thread that serves the requests later
    (per-thread library state is warm when the first request lands); a
    warmup error is raised by `start()` and leaves the server unstarted, so
    `start()` can be called again."""
    threads, fail = [], [True]

    def entry(xs, ys):
        threads.append(threading.get_ident())
        if fail[0]:
            raise RuntimeError("warmup failed")
        return np.asarray(xs)

    server = _server(entry, [(4,), (8,)], max_batch=1, warmup=True, auto_start=False)
    try:
        with pytest.raises(RuntimeError, match="warmup failed"):
            server.start()
        assert len(threads) == 1 and threads[0] != threading.get_ident()
        fail[0] = False
        threads.clear()
        server.start()
        server.submit(np.zeros((4,), np.float32), 0).result(timeout=T)
        assert len(threads) == 3 and len(set(threads)) == 1
        assert threads[0] != threading.get_ident()
    finally:
        server.close()


def test_metrics_ledger_schema(tmp_path):
    path = str(tmp_path / "serve.jsonl")
    server = _server(lambda xs, ys: np.asarray(xs), [(4,), (8,)], max_batch=2,
                     metrics_path=path)
    for i in range(5):
        server.submit(np.zeros((4 if i % 2 else 8,), np.float32), 0).result(timeout=T)
    server.close()
    rows = [json.loads(line) for line in open(path)]
    batches = [r for r in rows if r["metric"] == "serve_batch"]
    summaries = [r for r in rows if r["metric"] == "serve_summary"]
    assert batches and len(summaries) == 1
    for r in batches:
        assert 0.0 < r["fill_ratio"] <= 1.0 and 0.0 <= r["pad_waste"] < 1.0
        assert r["service_s"] >= 0.0 and r["queue_depth"] >= 0
        assert r["schedule_fingerprint"] == ttune.schedule_fingerprint()
    s = summaries[0]
    assert s["completed"] == 5 and s["submitted"] == 5
    assert s["latency_p50_ms"] > 0.0 and s["latency_p99_ms"] >= s["latency_p50_ms"]
    assert s["attributions_per_s"] > 0.0
    assert s["compile_count"] == 0
    assert {"assemble", "dispatch", "harvest", "distribute"} <= set(s["stages"])
    assert s["config"]["max_batch"] == 2 and s["config"]["device"] == "cpu"


def test_percentile_ms_empty_is_nan():
    assert np.isnan(tserve.percentile_ms([], 50))
    assert tserve.percentile_ms([0.1], 50) == pytest.approx(100.0)
    lat = list(np.random.default_rng(4).uniform(0, 1, 37))
    assert tserve.percentile_ms(lat, 99) == jserve.percentile_ms(lat, 99)


def test_unported_options_raise_naming_their_slice(tmp_path, monkeypatch):
    # every option of the reference's is ported now (tests/test_torch_aot.py,
    # tests/test_torch_registry.py): none raises
    monkeypatch.setenv("WAM_TPU_CACHE_DIR", str(tmp_path / "compile"))
    monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", str(tmp_path / "before"))
    monkeypatch.setenv("TRITON_CACHE_DIR", str(tmp_path / "before"))
    srv = _server(lambda xs, ys: xs, compilation_cache=True)
    srv.close()
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == str(tmp_path / "compile")
    srv = _server(lambda xs, ys: xs, registry="no-such-bundle")
    srv.close()
    assert srv.registry_report.status == "no_manifest"
    assert tserve.ModelSpec("m", lambda: None, registry="bundle.tar").registry == "bundle.tar"
    assert tserve.jit_entry(lambda x, y: x, aot_key="k").wam_aot_fns[0].fns == {}
    assert tserve.fleet_aot_key("k", 4, "bf16") == jserve.fleet_aot_key("k", 4, "bf16")
    assert tserve.fleet_aot_key(None, 4) is None and tserve.fleet_aot_key("k", 1) == "k"


def test_entry_points_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AttributionServer(lambda xs, ys: xs, [(4,)], warmup=False)


# -- admission: coalescing, QoS, cache, tenants ---------------------------------


class _RecordingEntry:
    """Instant entry that records each dispatched batch's labels."""

    def __init__(self):
        self.batches = []

    def __call__(self, xs, ys):
        self.batches.append(None if ys is None else [int(y) for y in ys])
        return np.asarray(xs) * 2.0


def test_coalescing_window_holds_then_releases():
    entry = _RecordingEntry()
    server = _server(entry, max_batch=4, coalesce_ms=300.0)
    try:
        t0 = time.perf_counter()
        futs = [server.submit(np.zeros((4,), np.float32), i) for i in range(4)]
        for f in futs:
            f.result(timeout=T)
        assert time.perf_counter() - t0 < 0.25  # a full bucket leaves at once
        t0 = time.perf_counter()
        server.submit(np.zeros((4,), np.float32), 9).result(timeout=T)
        assert time.perf_counter() - t0 >= 0.25  # a lone request waits out the window
    finally:
        server.close()
    assert entry.batches[0] == [0, 1, 2, 3] and entry.batches[1] == [9] * 4


def test_interactive_lane_drains_first_batch_backfills():
    entry = _GateEntry()
    entry.batches = []
    inner = entry.__call__

    def rec(xs, ys):
        entry.batches.append([int(y) for y in ys])
        return inner(xs, ys)

    server = _server(rec, max_batch=4, max_wait_ms=0.0)
    try:
        first = server.submit(np.zeros((4,), np.float32), 9, qos="batch")
        assert entry.entered.wait(timeout=T)
        lag = server.submit(np.zeros((4,), np.float32), 1, qos="batch")
        pri = server.submit(np.zeros((4,), np.float32), 2, qos="interactive")
        assert server.qos_depths() == {"interactive": 1, "batch": 1}
        entry.release.set()
        for f in (first, lag, pri):
            f.result(timeout=T)
        assert entry.batches[0][0] == 9 and entry.batches[1][:2] == [2, 1]
    finally:
        entry.release.set()
        server.close()


def test_repeat_submit_hits_cache_bit_identically():
    entry = _RecordingEntry()
    metrics = ServeMetrics()
    server = _server(entry, max_batch=2, metrics=metrics, result_cache=1 << 20, cache_id="toy")
    try:
        x = np.full((4,), 3.0, np.float32)
        r1 = server.submit(x, 1).result(timeout=T)
        r2 = server.submit(x, 1).result(timeout=T)
        np.testing.assert_array_equal(r1, r2)
        assert len(entry.batches) == 1 and metrics.cache_hits == 1
        server.submit(x, 2).result(timeout=T)
        assert len(entry.batches) == 2
    finally:
        server.close()
    assert metrics.snapshot()["completed"] == 2


def test_result_cache_key_tracks_precision_and_the_schedule_slot(monkeypatch):
    x = np.ones((4,), np.float32)
    k = tserve.result_cache_key(x, 1, "id")
    assert k.split("|")[3] == ttune.schedule_fingerprint() and k.endswith("|f32")
    assert k != tserve.result_cache_key(x.astype(np.float64), 1, "id")
    assert k != tserve.result_cache_key(x, 2, "id") != tserve.result_cache_key(x, 1, "other")
    monkeypatch.setenv("WAM_TPU_FAN_DTYPE", "bf16")
    assert tserve.result_cache_key(x, 1, "id") != k
    monkeypatch.setenv("WAM_TPU_NO_RESULT_CACHE", "1")
    cache = tserve.ResultCache(1 << 10)
    assert not cache.put("a", x) and cache.get("a") is None


def test_tenant_quota_and_fair_lanes():
    entry = _GateEntry()
    entry.batches = []
    inner = entry.__call__

    def rec(xs, ys):
        entry.batches.append([int(y) for y in ys])
        return inner(xs, ys)

    server = _server(rec, max_batch=4, max_wait_ms=0.0, queue_depth=8, tenant_quota=0.5)
    x = np.zeros((4,), np.float32)
    try:
        first = server.submit(x, 99)
        assert entry.entered.wait(timeout=T)
        futs = [server.submit(x, i, tenant="flood") for i in range(4)]
        with pytest.raises(QueueFullError):
            server.submit(x, 5, tenant="flood")  # 4 = 8 * 0.5 queued already
        futs += [server.submit(x, 10 + i, tenant="quiet") for i in range(2)]
        entry.release.set()
        for f in [first] + futs:
            f.result(timeout=T)
    finally:
        entry.release.set()
        server.close()
    # the next batch interleaves the tenants instead of FIFO-draining "flood"
    assert sorted(entry.batches[1]) == [0, 1, 10, 11]


def test_paged_model_serves_beside_the_default_entry():
    spec = tserve.ModelSpec("triple", lambda: (lambda xs, ys: np.asarray(xs) * 3.0))
    server = _server(lambda xs, ys: np.asarray(xs) * 2.0, max_batch=2, models=[spec])
    x = np.ones((4,), np.float32)
    try:
        np.testing.assert_array_equal(server.submit(x, 0).result(timeout=T), x * 2.0)
        np.testing.assert_array_equal(server.submit(x, 0, model="triple").result(timeout=T),
                                      x * 3.0)
        assert set(server.models_resident()) == {"triple"}
        with pytest.raises(ValueError, match="unknown model"):
            server.submit(x, 0, model="nope")
    finally:
        server.close()


def test_retry_policy_honors_retry_after_and_gives_up_typed():
    import random

    policy = tserve.RetryPolicy(max_attempts=3, backoff_base_s=0.001, jitter_frac=0.0)
    attempts = []

    def always_full(rem):
        attempts.append(rem)
        raise QueueFullError(retry_after_s=0.002)

    stats = tserve.RetryStats()
    with pytest.raises(tserve.RetryBudgetExceededError) as ei:
        policy.run(always_full, rng=random.Random(0), stats=stats)
    assert len(attempts) == 3 and isinstance(ei.value.last, QueueFullError)
    assert stats.as_dict()["retries"] == 2 and stats.as_dict()["exhausted"] == 1
    server = _server(lambda xs, ys: np.asarray(xs) * 2.0, max_batch=1)
    try:
        out = policy.run(lambda rem: server.submit(np.ones((4,), np.float32), 0))
    finally:
        server.close()
    np.testing.assert_array_equal(out, np.full((4,), 2.0))


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_worker_crash_fails_queued_requests(monkeypatch):
    server = _server(lambda xs, ys: np.asarray(xs), max_batch=1)

    def boom(*a, **k):
        raise RuntimeError("stager fault")

    monkeypatch.setattr(tserve.runtime, "put_committed", boom)
    try:
        with pytest.raises(tserve.WorkerCrashedError):
            server.submit(np.ones((4,), np.float32), 0).result(timeout=T)
        server._worker.join(timeout=T)
        with pytest.raises(ServerClosedError):
            server.submit(np.ones((4,), np.float32), 0)
    finally:
        server.close()


# -- the anytime server -------------------------------------------------------------


def _linear_anytime_entry(n_total=20, stride=5):
    from wam_tpu_torch.anytime import make_anytime_entry

    w = torch.linspace(0.5, 1.5, 16)

    def sample_fn(x, y, i):
        return x * w  # the same draw every sample: converges at the 2nd checkpoint

    return make_anytime_entry(sample_fn, n_total=n_total, stride=stride)


def test_serve_anytime_results_partials_and_ledger(tmp_path):
    from wam_tpu_torch.anytime import AnytimeResult
    from wam_tpu_torch.evalsuite.fan import fetch_count

    ledger = tmp_path / "anytime.jsonl"
    srv = _server(_linear_anytime_entry(), [(16,)], max_batch=2, max_wait_ms=1.0, warmup=True,
                  metrics_path=str(ledger))
    try:
        f0 = fetch_count()
        res = srv.submit(np.ones(16, np.float32), 1).result(timeout=T)
        assert isinstance(res, AnytimeResult)
        assert res.converged and res.n_used == 10 and res.n_total == 20
        assert res.meets(0.9) and not res.complete
        assert fetch_count() - f0 == 1
        res2 = srv.submit(np.ones(16, np.float32) * 2.0, 1, deadline_ms=0.001).result(timeout=T)
        assert isinstance(res2, AnytimeResult) and 0 < res2.n_used < res2.n_total
    finally:
        srv.close()
    snap = srv.metrics.snapshot()["anytime"]
    assert snap["batches"] == 2 and snap["early_exits"] >= 1 and snap["deadline_partials"] >= 1
    rows = [json.loads(line) for line in open(ledger)]
    partial = [r for r in rows if r.get("metric") == "partial_result"]
    assert partial
    for r in partial:
        assert r["schema_version"] == 2 and r["n_used"] < r["n_total"]
        assert 0.0 < r["confidence_mean"] <= 1.0


def test_anytime_kill_switch_and_first_calls(monkeypatch):
    from wam_tpu_torch.anytime import AnytimeResult

    fired = []
    from wam_tpu_torch.anytime import make_anytime_entry

    ent = make_anytime_entry(lambda x, y, i: x * 1.0, n_total=8, stride=4,
                             on_trace=lambda: fired.append(1))
    srv = _server(ent, [(8,)], max_batch=1, max_wait_ms=0.0, warmup=True)
    try:
        assert len(fired) == 3  # begin, step, finalize: the reference's 3 traces
        assert isinstance(srv.submit(np.ones(8, np.float32), 1).result(timeout=T),
                          AnytimeResult)
        assert len(fired) == 3
    finally:
        srv.close()
    monkeypatch.setenv("WAM_TPU_NO_ANYTIME", "1")
    srv = _server(ent, [(8,)], max_batch=1, max_wait_ms=0.0)
    try:
        res = srv.submit(np.ones(8, np.float32), 1).result(timeout=T)
        assert not isinstance(res, AnytimeResult) and res.shape == (8,)
    finally:
        srv.close()


# -- the same scripted stream through both servers ---------------------------------------


class _ScriptEntry:
    """Deterministic fake entry, the same in both packages: each row's
    result is 2x + its label; every dispatched batch is logged (shape,
    labels of every row), and the first call parks until released."""

    def __init__(self):
        self.log = []
        self.entered = threading.Event()
        self.release = threading.Event()

    def __call__(self, xs, ys):
        xs, ys = np.asarray(xs), np.asarray(ys)
        self.log.append((xs.shape, ys.tolist(), xs.tolist()))
        self.entered.set()
        assert self.release.wait(timeout=T), "test gate never released"
        return xs * 2.0 + ys.reshape((-1,) + (1,) * (xs.ndim - 1)).astype(np.float32)


# (shape, label, qos, tenant, deadline_ms)
_SCRIPT = [((4,), 0, "interactive", None, None)] + [
    ((4,), 1, "batch", "a", None), ((3,), 2, "interactive", "b", None),
    ((8,), 3, "batch", None, None), ((4,), 4, "interactive", "a", 30.0),
    ((6,), 5, "interactive", None, None), ((2,), 6, "batch", "b", None),
    ((8,), 7, "interactive", "a", None), ((4,), 8, "batch", None, 30.0),
    ((5,), 9, "interactive", "b", None), ((1,), 10, "batch", None, None),
    ((4,), 11, "interactive", None, None), ((9,), 12, "interactive", None, None),
    ((4,), 13, "batch", "a", 0.0), ((7,), 14, "batch", "b", None),
    ((4,), 15, "interactive", None, None), ((8,), 16, "batch", None, None),
]


def _run_script(pkg, tmp_path, device_kw):
    entry = _ScriptEntry()
    path = str(tmp_path / f"{pkg.__name__}.jsonl")
    server = pkg.AttributionServer(entry, [(4,), (8,)], max_batch=3, max_wait_ms=0.0,
                                   queue_depth=13, warmup=False, metrics_path=path,
                                   **device_kw)
    outcomes = []
    futs = []
    try:
        for i, (shape, y, qos, tenant, deadline) in enumerate(_SCRIPT):
            x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape) + 100 * y
            try:
                futs.append(server.submit(x, y, deadline_ms=deadline, qos=qos,
                                          tenant=tenant))
            except Exception as e:  # noqa: BLE001 - typed admission errors are the data
                futs.append(None)
                outcomes.append((i, type(e).__name__))
            if i == 0:
                assert entry.entered.wait(timeout=T)
        time.sleep(0.1)  # let the 30 ms deadlines lapse while queued
        entry.release.set()
        for i, f in enumerate(futs):
            if f is None:
                continue
            try:
                outcomes.append((i, np.asarray(f.result(timeout=T)).tolist()))
            except Exception as e:  # noqa: BLE001
                outcomes.append((i, type(e).__name__))
    finally:
        entry.release.set()
        server.close()
    rows = [json.loads(line) for line in open(path)]
    batches = [{k: v for k, v in r.items()
                if k not in ("service_s", "timestamp", "schedule_fingerprint")}
               for r in rows if r["metric"] == "serve_batch"]
    summary = next(r for r in rows if r["metric"] == "serve_summary")
    counts = {k: summary[k] for k in ("submitted", "completed", "rejected", "expired",
                                      "failed", "batches", "compile_count")}
    return entry.log, sorted(outcomes), batches, counts


def test_scripted_stream_equals_the_reference(tmp_path):
    got = _run_script(tserve, tmp_path, {"device": "cpu"})
    want = _run_script(jserve, tmp_path, {})
    names = ("batches dispatched (shape, labels, rows)", "outcomes", "serve_batch rows",
             "summary counts")
    for name, g, w in zip(names, got, want):
        assert g == w, name
    outcomes = dict(got[1])
    assert outcomes[12] == "NoBucketError" and outcomes[13] == "InvalidDeadlineError"
    assert "QueueFullError" in outcomes.values()
    assert "DeadlineExceededError" in outcomes.values()


def test_registry_counts_of_the_scripted_stream_equal_the_reference(tmp_path):
    """render_prom of the serve families that count (not time) after the
    same stream: the same lines in both registries."""
    jobs = pytest.importorskip("wam_tpu.obs")
    jobs.reset()
    obs.reset()
    _run_script(tserve, tmp_path, {"device": "cpu"})
    _run_script(jserve, tmp_path, {})
    fams = ("wam_tpu_serve_submitted_total", "wam_tpu_serve_completed_total",
            "wam_tpu_serve_rejected_total", "wam_tpu_serve_expired_total",
            "wam_tpu_serve_batches_total", "wam_tpu_serve_queue_depth",
            "wam_tpu_serve_batch_occupancy")

    def lines(text):
        return [ln for ln in text.splitlines() if ln.split("{")[0].split(" ")[0] in fams
                or any(ln.startswith(f"# {k} {f}") for f in fams for k in ("HELP", "TYPE"))
                or any(ln.startswith(f + "_") for f in fams)]

    assert lines(obs.render_prom()) == lines(jobs.render_prom())
    jobs.reset()
    obs.reset()


# -- serve_entry on ResNet-18 against the reference -------------------------------------------


@pytest.fixture(scope="module")
def r18():
    from wam_tpu.models import bind_inference as jbind
    from wam_tpu.models import resnet18 as jresnet18
    from wam_tpu.wavelets import transform as jt
    from wam_tpu_torch.models import resnet as tres
    from wam_tpu_torch.models.ingest import flax_resnet_to_torch

    saved = jt.get_dwt2_impl(), jt.get_synth2_impl()
    jt.set_dwt2_impl("auto")
    jt.set_synth2_impl("auto")
    model = jresnet18(num_classes=10)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    jfn = jbind(model, variables, nchw=True)
    tfn = tres.bind_inference(tres.resnet18(num_classes=10), flax_resnet_to_torch(variables),
                              device="cpu")
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 3, 32, 32)).astype(np.float32)
    y = np.array([1, 7, 4])
    yield jfn, tfn, x, y
    jt.set_dwt2_impl(saved[0])
    jt.set_synth2_impl(saved[1])


def test_serve_entry_ig_equals_the_reference(r18):
    from wam_tpu import wam2d as jwam
    from wam_tpu_torch import wam2d as twam

    jfn, tfn, x, y = r18
    kw = dict(wavelet="db4", J=2, method="integratedgrad", n_samples=4)
    want = np.asarray(jwam.WaveletAttribution2D(jfn, **kw).serve_entry()(
        jnp.asarray(x), jnp.asarray(y)))
    tw = twam.WaveletAttribution2D(tfn, device="cpu", **kw)
    got = tw.serve_entry()(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)
    # BaseWAM2D's entry, plain and health-fused, against the reference's
    jb, tb = jwam.BaseWAM2D(jfn, wavelet="db4", J=2), twam.BaseWAM2D(tfn, wavelet="db4", J=2,
                                                                     device="cpu")
    want_m, want_h = jb.serve_entry(with_health=True)(jnp.asarray(x), jnp.asarray(y))
    got_m, got_h = tb.serve_entry(with_health=True)(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_h.numpy()[:5], np.asarray(want_h)[:5], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got_h.numpy()[5], np.asarray(want_h)[5], rtol=1e-3)


def test_serve_entry_smoothgrad_is_the_ports_smooth_wam(r18):
    """The JAX entry draws its own noise (threefry); the port's entry is
    bit-equal to its own smooth_wam on the same seed, called directly and
    through the server (row for row, the batch padded by replication)."""
    from wam_tpu_torch import wam2d as twam

    _, tfn, x, y = r18
    tw = twam.WaveletAttribution2D(tfn, wavelet="db4", J=2, n_samples=3, random_seed=5,
                                   device="cpu")
    want = tw.smooth_wam(x, y).numpy()
    ent = tw.serve_entry()
    np.testing.assert_array_equal(ent(torch.from_numpy(x), torch.from_numpy(y)).numpy(), want)
    np.testing.assert_array_equal(ent(torch.from_numpy(x), torch.from_numpy(y)).numpy(), want)
    server = _server(ent, [(3, 32, 32)], max_batch=3, coalesce_ms=200.0)
    try:
        futs = [server.submit(x[i], int(y[i])) for i in range(3)]
        got = np.stack([f.result(timeout=60) for f in futs])
    finally:
        server.close()
    np.testing.assert_array_equal(got, want)
    assert server.metrics.snapshot()["batches"] == 1


def test_serve_entries_of_the_other_classes(r18):
    """serve_entry no longer raises on WaveletAttribution1D, 3D or video:
    each equals its class's own call on the same seed, without setting the
    attributes ``__call__`` sets."""
    from wam_tpu_torch import wam1d as tw1
    from wam_tpu_torch import wam3d as tw3
    from wam_tpu_torch.models.toy import toy_conv_model
    from wam_tpu_torch.xattr import video as tvid

    rng = np.random.default_rng(9)
    f1 = toy_conv_model(ndim=1, device="cpu")
    w1 = tw1.WaveletAttribution1D(lambda m: f1(m.reshape(m.shape[0], -1)), J=2, n_samples=2,
                                  n_mels=8, n_fft=64, device="cpu")
    wave = rng.standard_normal((2, 512)).astype(np.float32)
    mel, coeffs = w1.serve_entry()(torch.from_numpy(wave), torch.tensor([0, 1]))
    want_mel, want_coeffs = w1(wave, np.array([0, 1]))
    np.testing.assert_array_equal(mel.numpy(), want_mel.numpy())
    for a, b in zip(coeffs, want_coeffs):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    f3 = toy_conv_model(ndim=3, device="cpu", taps=3)
    w3 = tw3.WaveletAttribution3D(lambda v: f3(v[:, 0]), J=2, n_samples=2, device="cpu")
    vol = rng.standard_normal((2, 1, 8, 8, 8)).astype(np.float32)
    ent3 = w3.serve_entry()
    assert not hasattr(w3, "grads")
    np.testing.assert_array_equal(ent3(torch.from_numpy(vol), torch.tensor([0, 2])).numpy(),
                                  w3(vol, np.array([0, 2])).numpy())
    vw = tvid.WaveletAttributionVideo(lambda c: f3(c[:, 0]), levels=(1, 1), n_samples=2,
                                      device="cpu")
    clip = rng.standard_normal((2, 1, 4, 8, 8)).astype(np.float32)
    entv = vw.serve_entry(with_health=True)
    box, hvec = entv(torch.from_numpy(clip), torch.tensor([1, 3]))
    np.testing.assert_array_equal(box.numpy(), vw(clip, np.array([1, 3])).numpy())
    assert entv.wam_health and obs.health.summarize(hvec)["finite"]
