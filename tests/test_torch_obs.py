"""The port's observability and health plane (`wam_tpu_torch.obs`) held to
the reference's (`wam_tpu.obs`): case for case with `tests/test_obs.py` and
`tests/test_health.py` (the fleet cases on one server; the fan piggyback
and the AOT events, which the port does not have yet, as what raises or is
absent), plus cross-package cases: `render_prom` of both registries after
the same operations, the SLO tracker states after the same notes, and
`health_stats` on the same arrays with NaN and Inf.

Every wait takes a timeout."""

import json
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from wam_tpu import obs as jobs
from wam_tpu.obs import health as jhealth
from wam_tpu.obs import slo as jslo
from wam_tpu_torch import obs
from wam_tpu_torch.obs import health as obs_health
from wam_tpu_torch.obs import sentinel, tracing
from wam_tpu_torch.obs import slo as obs_slo
from wam_tpu_torch.obs.health import HealthConfig, HealthMonitor
from wam_tpu_torch.obs.memory import MemoryBudget, estimate_entry_bytes
from wam_tpu_torch.obs.registry import Registry, registry

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def obs_clean():
    """Every test starts from zero obs state and leaves tracing enabled."""
    obs.configure(enabled=True, ring_size=4096)
    obs.reset()
    yield
    obs.configure(enabled=True, ring_size=4096)
    obs.reset()


def _server(entry=None, **kw):
    from wam_tpu_torch.serve import AttributionServer

    kw.setdefault("max_wait_ms", 0.0)
    kw.setdefault("warmup", False)
    return AttributionServer(entry or (lambda xs, ys: np.asarray(xs) * 2.0), [(4,)],
                             device="cpu", **kw)


# -- tracing ------------------------------------------------------------------


def test_span_nesting_shares_trace_and_parents():
    with obs.span("outer", cat="t") as parent:
        with obs.span("inner", cat="t", k=1):
            pass
    rows = {r["name"]: r for r in obs.spans()}
    assert rows["inner"]["trace_id"] == rows["outer"]["trace_id"]
    assert rows["inner"]["parent_id"] == rows["outer"]["span_id"]
    assert rows["outer"]["parent_id"] is None
    assert rows["inner"]["attrs"] == {"k": 1}
    assert rows["inner"]["t1"] >= rows["inner"]["t0"]
    assert parent.name == "outer"


def test_live_spans_are_torch_profiler_scopes():
    """The reference's jax.profiler.TraceAnnotation becomes
    torch.profiler.record_function: a live span shows in a profile."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("wam_span_probe"):
            torch.ones(4).sum()
    assert any(e.name == "wam_span_probe" for e in prof.events())


def test_detached_root_and_retroactive_spans():
    root = obs.start_span("request", cat="t")
    t0 = time.perf_counter()
    t1 = t0 + 0.25
    obs.record_span("queue_wait", t0, t1, parent=(root.trace_id, root.span_id), cat="t")
    root.end()
    rows = {r["name"]: r for r in obs.spans()}
    assert rows["queue_wait"]["trace_id"] == rows["request"]["trace_id"]
    assert rows["queue_wait"]["parent_id"] == rows["request"]["span_id"]
    assert rows["queue_wait"]["t1"] - rows["queue_wait"]["t0"] == pytest.approx(0.25)


def test_use_context_propagates_across_threads():
    root = obs.start_span("request", cat="t")
    ctx = (root.trace_id, root.span_id)

    def worker():
        with obs.use_context(ctx):
            with obs.span("service", cat="t"):
                pass

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=10)
    root.end()
    rows = {r["name"]: r for r in obs.spans()}
    assert rows["service"]["trace_id"] == root.trace_id
    assert rows["service"]["parent_id"] == root.span_id


def test_disabled_mode_records_nothing_and_is_a_shared_noop():
    obs.configure(enabled=False)
    s1 = obs.span("a")
    s2 = obs.span("b")
    assert s1 is s2 is obs.NULL_SPAN
    with s1:
        pass
    obs.record_span("c", 0.0, 1.0)
    assert obs.spans() == []
    c = registry.counter("wam_tpu_test_disabled_total")
    c.inc()
    assert c.value() == 0.0


def test_ring_size_bounds_and_keeps_newest():
    obs.configure(ring_size=4)
    for i in range(10):
        with obs.span(f"s{i}"):
            pass
    assert [r["name"] for r in obs.spans()] == ["s6", "s7", "s8", "s9"]


# -- registry -----------------------------------------------------------------


def test_counter_gauge_histogram_basics():
    c = registry.counter("wam_tpu_test_ops_total", "ops", labels=("kind",))
    c.inc(kind="a")
    c.inc(2, kind="a")
    assert c.value(kind="a") == 3.0
    with pytest.raises(ValueError):
        c.inc(-1, kind="a")
    with pytest.raises(ValueError):
        c.inc(kind="a", extra="nope")
    g = registry.gauge("wam_tpu_test_depth")
    g.set(5)
    g.dec(2)
    assert g.value() == 3.0
    h = registry.histogram("wam_tpu_test_lat_seconds", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(50.0)
    assert h.count() == 3
    assert h.sum() == pytest.approx(50.55)


def test_registry_get_or_create_and_type_mismatch():
    a = registry.counter("wam_tpu_test_same_total")
    assert registry.counter("wam_tpu_test_same_total") is a
    with pytest.raises(ValueError):
        registry.gauge("wam_tpu_test_same_total")


def test_render_prom_exposition_format():
    c = registry.counter("wam_tpu_test_fmt_total", "help text", labels=("r",))
    c.inc(r='q"x"')
    h = registry.histogram("wam_tpu_test_fmt_seconds", buckets=(0.1, 1.0))
    h.observe(0.5)
    text = obs.render_prom()
    assert "# HELP wam_tpu_test_fmt_total help text" in text
    assert "# TYPE wam_tpu_test_fmt_total counter" in text
    assert 'wam_tpu_test_fmt_total{r="q\\"x\\""} 1' in text
    assert 'wam_tpu_test_fmt_seconds_bucket{le="0.1"} 0' in text
    assert 'wam_tpu_test_fmt_seconds_bucket{le="1"} 1' in text
    assert 'wam_tpu_test_fmt_seconds_bucket{le="+Inf"} 1' in text
    assert "wam_tpu_test_fmt_seconds_sum 0.5" in text
    assert "wam_tpu_test_fmt_seconds_count 1" in text


def _drive_registry(reg):
    c = reg.counter("wam_tpu_x_ops_total", "ops", labels=("kind", "r"))
    c.inc(kind="a", r='q"x"\n')
    c.inc(2.5, kind="b", r="1")
    g = reg.gauge("wam_tpu_x_depth", "depth", labels=("bucket",))
    g.set(7, bucket="3x224x224")
    g.dec(0.25, bucket="3x224x224")
    h = reg.histogram("wam_tpu_x_lat_seconds", "lat", labels=("r",), buckets=(0.001, 0.1, 1.0))
    for v in (0.0005, 0.05, 0.5, 5.0, 0.1):
        h.observe(v, r="-")
    reg.histogram("wam_tpu_x_empty_seconds", "never observed")
    return reg


def test_render_prom_and_collect_equal_the_reference():
    from wam_tpu.obs.registry import Registry as JRegistry

    port, ref = _drive_registry(Registry()), _drive_registry(JRegistry())
    assert port.render_prom() == ref.render_prom()
    assert port.collect() == ref.collect()


def test_registry_reset_zeroes_but_keeps_instruments():
    c = registry.counter("wam_tpu_test_reset_total")
    c.inc(7)
    registry.reset()
    assert c.value() == 0.0
    assert registry.counter("wam_tpu_test_reset_total") is c


# -- first-call sentinel ---------------------------------------------------------


def test_sentinel_attribution_and_ambient_labels():
    with sentinel.label(replica=3, bucket="1x16x16", phase="warmup"):
        ev = sentinel.record_trace("serve", detail="entry")
    assert (ev["replica"], ev["bucket"], ev["phase"]) == (3, "1x16x16", "warmup")
    with sentinel.label(replica=1, bucket="b"):
        ev2 = sentinel.record_trace("serve", replica=2, bucket=None)
    assert (ev2["replica"], ev2["bucket"]) == (2, "b")
    assert sentinel.trace_count() == 2
    assert registry.counter(
        "wam_tpu_compile_jit_traces_total").value(entry_kind="serve") == 2.0
    assert ev["origin"]


def test_assert_no_retrace_raises_with_events():
    with obs.assert_no_retrace():
        pass
    with pytest.raises(obs.RetraceError) as ei:
        with obs.assert_no_retrace():
            sentinel.record_trace("serve", bucket="1x8x8")
    assert len(ei.value.events) == 1 and "1x8x8" in str(ei.value)
    with pytest.raises(RuntimeError):
        with obs.assert_no_retrace():
            sentinel.record_trace("serve")
            raise RuntimeError("real failure")


def test_sentinel_aot_events_wait_for_the_aot_cache():
    """The AOT cache (pipeline/aot.py) has landed: the reference's
    `test_sentinel_counts_aot_events` on the port, and the same scenario's
    event rows (less their times) equal to the reference's."""
    rows = {}
    for mod in (jobs.sentinel, sentinel):
        mod.clear_events()
        with mod.label(bucket="3x8x8", phase="warmup"):
            for event in ("miss", "export", "hit", "hit", "registry_hit"):
                mod.record_aot(event, "k1")
        rows[mod] = [{k: v for k, v in r.items() if k != "t"} for r in mod.aot_events()]
        assert mod.aot_event_count("hit") == 2 and mod.aot_event_count() == 5
        assert mod.trace_count() == 0  # AOT events never count as traces
        mod.clear_events()
    assert rows[sentinel] == rows[jobs.sentinel]
    assert registry.counter("wam_tpu_compile_aot_events_total").value(event="hit") == 2.0
    assert "record_aot" in obs.__all__


def test_sentinel_stays_live_when_obs_disabled():
    obs.configure(enabled=False)
    with pytest.raises(obs.RetraceError):
        with obs.assert_no_retrace():
            sentinel.record_trace("serve")
    assert sentinel.trace_count() == 1
    assert registry.counter(
        "wam_tpu_compile_jit_traces_total").value(entry_kind="serve") == 0.0


def test_jit_entry_reports_each_new_signature_once():
    """The port's counterpart of a jit trace: the first call at each (shape,
    dtype, device) signature, reported with the ambient labels."""
    from wam_tpu_torch.serve.entry import jit_entry

    fired = []
    ent = jit_entry(lambda x, y: x * 2, on_trace=lambda: fired.append(1), donate=False)
    y = torch.zeros(2, dtype=torch.int32)
    with sentinel.label(bucket="2x4", phase="warmup"):
        ent(torch.zeros(2, 4), y)
    ent(torch.ones(2, 4), y)  # same signature: not reported
    ent(torch.zeros(2, 4, dtype=torch.float64), y)
    ent(torch.zeros(3, 4), y)
    ent(torch.zeros(3, 4), None)  # an unlabeled call is its own signature
    events = sentinel.compile_events()
    assert len(fired) == 4 == len(events) == sentinel.trace_count()
    assert events[0]["phase"] == "warmup" and events[0]["bucket"] == "2x4"
    assert [e["bucket"] for e in events[1:]] == ["2x4", "3x4", "3x4"]


# -- chrome export / HTTP -----------------------------------------------------


def test_export_chrome_trace_format(tmp_path):
    with obs.span("outer", cat="t", bucket="1x16x16"):
        with obs.span("inner", cat="t"):
            pass
    path = obs.export_chrome_trace(str(tmp_path / "trace.json"))
    payload = json.loads((tmp_path / "trace.json").read_text())
    assert path == str(tmp_path / "trace.json")
    xs = [e for e in payload["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"outer", "inner"}
    for e in xs:
        assert e["dur"] >= 0 and e["ts"] > 0
        assert e["args"]["trace_id"] and e["args"]["span_id"]
    assert next(e for e in xs if e["name"] == "outer")["args"]["bucket"] == "1x16x16"
    assert any(m["name"] == "thread_name" for m in payload["traceEvents"] if m["ph"] == "M")


def test_metrics_http_endpoint():
    registry.counter("wam_tpu_test_http_total").inc(5)
    server = obs.start_metrics_server(0)
    try:
        port = server.server_port
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                      timeout=5).read().decode()
        assert "wam_tpu_test_http_total 5" in body
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=5)
    finally:
        obs.stop_metrics_server(server)


# -- serve integration --------------------------------------------------------


def test_serve_registry_matches_ledger_roundtrip(tmp_path):
    """The prom registry and the JSONL ledger are two views of the SAME
    counts — the serve_summary row, the obs_snapshot row and collect()
    agree exactly."""
    from wam_tpu_torch.serve import ServeMetrics

    path = str(tmp_path / "ledger.jsonl")
    server = _server(max_batch=4, metrics=ServeMetrics(), metrics_path=path)
    x = np.zeros((4,), np.float32)
    try:
        for _ in range(6):
            np.testing.assert_array_equal(server.attribute(x, 0), x * 2.0)
    finally:
        server.close()
    rows = [json.loads(line) for line in open(path) if line.strip()]
    summary = next(r for r in rows if r["metric"] == "serve_summary")
    snap = next(r for r in rows if r["metric"] == "obs_snapshot")
    live = registry.collect()
    assert summary["submitted"] == summary["completed"] == 6
    for field in ("submitted", "completed", "rejected", "expired"):
        key = f'wam_tpu_serve_{field}_total{{replica="-"}}'
        assert snap["registry"].get(key, 0.0) == live.get(key, 0.0) == float(summary[field])
    assert snap["registry"]['wam_tpu_serve_latency_seconds_count{replica="-"}'] == 6.0
    batch_rows = [r for r in rows if r["metric"] == "serve_batch"]
    assert sum(v for k, v in live.items()
               if k.startswith("wam_tpu_serve_batches_total")) == len(batch_rows)


def test_server_trace_export_is_valid_and_covers_requests(tmp_path):
    """The reference's fleet trace case on one server: every request's
    trace carries its root and the retroactive queue_wait/service spans,
    and the reference's trace_report.py finds >= 95% span coverage."""
    n_req = 8
    server = _server(max_batch=2)
    x = np.zeros((4,), np.float32)
    try:
        futs = [server.submit(x, 0) for _ in range(n_req)]
        for f in futs:
            f.result(timeout=10)
    finally:
        server.close()
    path = str(tmp_path / "trace.json")
    obs.export_chrome_trace(path)
    events = [e for e in json.loads(open(path).read())["traceEvents"] if e.get("ph") == "X"]
    roots = [e for e in events if e["name"] == "request"]
    assert len(roots) == n_req
    by_trace = {}
    for e in events:
        by_trace.setdefault(e["args"]["trace_id"], set()).add(e["name"])
    for r in roots:
        assert {"queue_wait", "service"} <= by_trace[r["args"]["trace_id"]]
    assert all(e["dur"] >= 0 for e in events)
    report = subprocess.run([sys.executable, "scripts/trace_report.py", path,
                             "--min-coverage", "0.95"], cwd=ROOT, capture_output=True,
                            text=True, timeout=60)
    assert report.returncode == 0, report.stdout + report.stderr
    assert "span coverage" in report.stdout


def test_no_retrace_across_warm_server_loop():
    """A WARM server with `jit_entry` entries serves a mixed exact/padded
    stream without a single new signature (the reference's two-replica case
    on one server)."""
    from wam_tpu_torch.serve import AttributionServer, ServeMetrics
    from wam_tpu_torch.serve.entry import jit_entry

    m = ServeMetrics()
    server = AttributionServer(jit_entry(lambda xs, ys: xs * 2.0, on_trace=m.note_compile),
                               [(4,), (8,)], max_batch=2, max_wait_ms=0.0, warmup=True,
                               metrics=m, device="cpu")
    try:
        warm = sentinel.trace_count()
        assert warm == 2 == m.compile_count
        assert all(e["phase"] == "warmup" for e in sentinel.compile_events())
        with obs.assert_no_retrace():
            futs = [server.submit(np.zeros((n,), np.float32), 0) for n in (4, 8, 3, 4, 7, 8)]
            for f in futs:
                f.result(timeout=30)
    finally:
        server.close()
    assert sentinel.trace_count() == warm


def test_obs_config_dataclass_configures_layer():
    from wam_tpu_torch.config import ObsConfig

    obs.configure(ObsConfig(enabled=False, ring_size=8))
    assert not tracing._STATE.enabled and tracing._STATE.ring.maxlen == 8
    obs.configure(ObsConfig())
    assert tracing._STATE.enabled


def test_stager_publishes_to_registry():
    """The stager half of `test_stager_and_fan_publish_to_registry` (the
    port's fan keeps its one-copy fetch: no spans or health piggyback yet)."""
    from wam_tpu_torch.pipeline.stager import put_committed

    x = np.zeros((2, 8), np.float32)
    put_committed(x, "cpu")
    assert registry.counter("wam_tpu_stager_h2d_bytes_total").value() == float(x.nbytes)


# -- numeric health -------------------------------------------------------------


def test_health_stats_vector_layout():
    vec = obs_health.health_stats(
        {"m": torch.tensor([0.5, -1.0, float("nan"), float("inf")])}).numpy()
    assert vec.shape == (obs_health.HEALTH_VEC_SIZE,)
    s = obs_health.summarize(vec)
    assert s["nonfinite"] == 2 and s["total"] == 4
    assert not s["finite"]
    # NaN does not leak into the saturation count; |-1.0| and |inf| count
    assert vec[2] == 2.0


def test_health_stats_clean_batch_and_grad_pooling():
    out = torch.tensor([0.25, 0.5])
    grads = {"w": torch.tensor([3.0, 4.0])}
    s = obs_health.summarize(obs_health.health_stats(out, grads))
    assert s["finite"] and s["total"] == 4
    assert s["grad_norm"] == pytest.approx(5.0)
    combined = obs_health.combine_output_grads(
        obs_health.health_stats(out), obs_health.health_stats(grads))
    s2 = obs_health.summarize(combined)
    assert s2["total"] == 4 and s2["grad_norm"] == pytest.approx(5.0)


@pytest.mark.parametrize("case", ["clean", "nan", "inf", "saturated", "tree"])
def test_health_stats_equal_the_reference(case):
    rng = np.random.default_rng(3)
    a = rng.random((3, 17, 5)).astype(np.float32)
    b = rng.standard_normal((3, 9)).astype(np.float32)
    if case == "nan":
        a[0, 3, 1] = np.nan
        b[2, 4] = np.nan
    elif case == "inf":
        a[1, 0, 0] = np.inf
        b[0, 0] = -np.inf
    elif case == "saturated":
        a[:, :4] = 1.0
    grads = [b, (a * 3.0, b * 0.5)] if case == "tree" else None
    want = np.asarray(jhealth.health_stats((a, {"k": b}), grads))
    got = obs_health.health_stats(
        (torch.from_numpy(a), {"k": torch.from_numpy(b)}),
        None if grads is None else [torch.from_numpy(grads[0]),
                                    tuple(torch.from_numpy(g) for g in grads[1])]).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[:5], want[:5], rtol=0, atol=0, equal_nan=True)
    np.testing.assert_allclose(got[5], want[5], rtol=1e-6, equal_nan=True)  # sum order
    sj, sp = jhealth.summarize(want), obs_health.summarize(got)
    assert {k: sj[k] for k in ("nonfinite", "total", "finite")} == \
        {k: sp[k] for k in ("nonfinite", "total", "finite")}


def test_health_monitor_quarantine_and_probation():
    mon = HealthMonitor(HealthConfig(quarantine_after=2, recovery_s=10.0))
    good = obs_health.health_stats(torch.ones(4) * 0.5)
    bad = obs_health.health_stats(torch.tensor([float("nan"), 0.0]))
    assert mon.note(good, now=0.0) and mon.ok(now=0.0)
    mon.note(bad, now=1.0)
    assert mon.ok(now=1.0)  # one bad batch: not yet
    mon.note(bad, now=2.0)
    assert mon.quarantined and not mon.ok(now=3.0)
    assert mon.ok(now=12.0)  # probation
    mon.note(bad, now=12.5)  # a bad probe re-arms
    assert not mon.ok(now=14.0)
    mon.note(good, now=15.0)
    assert not mon.quarantined and mon.ok(now=15.0)


def test_health_monitor_states_equal_the_reference():
    cfg = dict(quarantine_after=2, recovery_s=1.0, backoff_factor=3.0, max_recovery_s=5.0)
    tmon, jmon = HealthMonitor(HealthConfig(**cfg)), jhealth.HealthMonitor(
        jhealth.HealthConfig(**cfg))
    good, bad = np.array([0, 4, 0, 4, 0.5, 1.0], np.float32), \
        np.array([2, 4, 0, 4, 0.5, np.nan], np.float32)
    for i, v in enumerate([good, bad, bad, bad, good, bad, bad, good, bad, bad]):
        now = float(i)
        assert tmon.note(v, now=now) == jmon.note(v, now=now)
        assert tmon.ok(now=now + 0.5) == jmon.ok(now=now + 0.5)
        assert tmon.describe() == jmon.describe()


def test_fan_health_piggyback_waits_and_the_fan_fetches_once():
    """The reference piggybacks health on the fan's fetch
    (`test_fan_single_fetch_with_health_on`, `test_fan_health_gates_off_with_obs`);
    the port's fan keeps its one-copy fetch, and the piggyback's switch is
    absent until it lands (ROADMAP.md slice F)."""
    from wam_tpu_torch.evalsuite.fan import fetch_scope, run_fan

    for name in ("fan_health_enabled", "set_fan_health"):
        assert hasattr(jhealth, name) and not hasattr(obs_health, name)
    with fetch_scope() as fs:
        out = run_fan(lambda x: x * 2.0, (torch.ones(8),))
    assert fs.count == 1 and np.array_equal(out, np.full((8,), 2.0, np.float32))
    assert registry.counter("wam_tpu_health_checks_total", labels=("source", "replica")).value(
        source="fan", replica="-") == 0.0


class _PoisonEntry:
    """Fake entry whose output turns NaN while ``poisoned`` is set (numpy
    out: the worker's post-hoc `batch_stats` path)."""

    def __init__(self):
        self.poisoned = threading.Event()

    def __call__(self, xs, ys):
        out = np.asarray(xs, np.float32) * 2.0
        if self.poisoned.is_set():
            out = out + np.nan
        return out


def test_single_server_quarantine_and_recovery():
    entry = _PoisonEntry()
    server = _server(entry, max_batch=1,
                     health=HealthConfig(quarantine_after=2, recovery_s=0.05))
    x = np.ones((4,), np.float32)
    try:
        server.attribute(x, 0)
        assert server.health_ok()
        entry.poisoned.set()
        for _ in range(2):
            assert np.isnan(server.submit(x, 0).result(timeout=10)).all()
        assert not server.health_ok()
        entry.poisoned.clear()
        time.sleep(0.06)
        assert server.health_ok()
        np.testing.assert_array_equal(server.submit(x, 0).result(timeout=10), x * 2.0)
        assert server.health_ok() and not server._health.quarantined
        d = server.describe()["health"]
        assert d["nonfinite_batches"] == 2 and not d["quarantined"]
    finally:
        server.close()


def test_no_retrace_across_warm_health_fused_server():
    """The reference's health-fused fleet case on one server: a warm
    `with_health=True` entry serves a mixed stream with no new signature,
    and every batch's vector is noted."""
    from wam_tpu_torch.serve import AttributionServer
    from wam_tpu_torch.serve.entry import jit_entry

    ent = jit_entry(lambda xs, ys: xs * 2.0, with_health=True)
    assert ent.wam_health
    server = AttributionServer(ent, [(4,), (8,)], max_batch=2, max_wait_ms=0.0, warmup=True,
                               health=True, device="cpu")
    try:
        with obs.assert_no_retrace():
            futs = [server.submit(np.ones((n,), np.float32), 0) for n in (4, 8, 3, 7)]
            outs = [f.result(timeout=30) for f in futs]
    finally:
        server.close()
    assert all(o.shape in ((4,), (8,)) for o in outs)
    assert server.describe()["health"]["checks"] >= 2


# -- SLO ----------------------------------------------------------------------------


def test_slo_burn_rate_components():
    tr = obs_slo.SLOTracker("p99_ms=100,error_rate=0.1,health_rate=0.9")
    for i in range(98):
        tr.note("4", latency_s=0.01, now=100.0 + i * 1e-3)
    tr.note("4", latency_s=0.5, now=100.2)
    tr.note_error("4", 1, now=100.3)
    st = tr.bucket_stats("4", now=100.4)
    assert st["n"] == 100
    assert st["error_rate"] == pytest.approx(0.01)
    assert st["health_rate"] == pytest.approx(0.99)
    assert st["burn_rate"] == pytest.approx((1 / 99) / 0.01)
    assert tr.penalty_s("4", now=100.4) == pytest.approx(
        ((1 / 99) / 0.01 - 1.0) * obs_slo.PENALTY_SCALE_S)
    assert tr.bucket_stats("4", now=1000.0)["n"] == 0


def test_slo_tracker_states_equal_the_reference():
    policy = ("*:p99_ms=40,error_rate=0.05;*@interactive:p99_ms=20,min_confidence=0.8;"
              "3x32x32@batch@acme:health_rate=0.99")
    assert obs_slo.parse_slo(policy).keys() == jslo.parse_slo(policy).keys()
    trackers = (obs_slo.SLOTracker(policy, replica_id=1), jslo.SLOTracker(policy, replica_id=1))
    rng = np.random.default_rng(5)
    for i in range(60):
        kw = dict(latency_s=float(rng.uniform(0.001, 0.06)), healthy=bool(i % 7),
                  confidence=float(rng.uniform(0.5, 1.0)), now=10.0 + i * 1e-3,
                  qos=("interactive", "batch", None)[i % 3],
                  tenant="acme" if i % 2 else None)
        for tr in trackers:
            tr.note("3x32x32", **kw)
        if i % 11 == 0:
            for tr in trackers:
                tr.note_error("3x32x32", 2, now=10.0 + i * 1e-3, qos="batch", tenant="acme")
    got, want = (tr.snapshot_row(publish=False, now=10.5) for tr in trackers)
    for row in (got, want):
        row.pop("timestamp")
    assert got == want
    for key in want["buckets"]:
        assert trackers[0].penalty_s(key, now=10.5) == trackers[1].penalty_s(key, now=10.5)


def test_slo_status_row_roundtrips_registry_exactly(tmp_path):
    from wam_tpu_torch.results import JsonlWriter
    from wam_tpu_torch.serve.metrics import SCHEMA_VERSION, write_slo_status

    tr = obs_slo.SLOTracker("p99_ms=25,error_rate=0.05", replica_id=0)
    rng = np.random.default_rng(7)
    base = time.perf_counter()
    for i in range(37):
        tr.note("1x16x16", latency_s=float(rng.uniform(0.001, 0.06)), ok=True,
                healthy=bool(i % 5), now=base + i * 1e-3)
    tr.note_error("1x16x16", 3, now=base + 0.1)
    path = str(tmp_path / "ledger.jsonl")
    row = write_slo_status(JsonlWriter(path), tr)
    assert row["schema_version"] == SCHEMA_VERSION
    back = json.loads(open(path).read().strip())
    assert back["metric"] == "slo_status"
    stats = back["buckets"]["1x16x16"]
    assert stats["n"] == 40
    for field, gname in {"burn_rate": "wam_tpu_slo_burn_rate",
                         "error_rate": "wam_tpu_slo_error_rate",
                         "health_rate": "wam_tpu_slo_health_rate",
                         "p99_s": "wam_tpu_slo_p99_seconds",
                         "n": "wam_tpu_slo_window_requests"}.items():
        assert stats[field] == registry.gauge(gname).value(replica="0", bucket="1x16x16")


def test_server_emits_slo_status_ledger_row(tmp_path):
    path = str(tmp_path / "serve.jsonl")
    server = _server(max_batch=2, metrics_path=path, slo="p99_ms=1000,error_rate=0.5")
    x = np.zeros((4,), np.float32)
    try:
        for _ in range(5):
            server.attribute(x, 0)
    finally:
        server.close()
    rows = [json.loads(line) for line in open(path) if line.strip()]
    slo_rows = [r for r in rows if r["metric"] == "slo_status"]
    assert len(slo_rows) == 1
    st = slo_rows[0]["buckets"]["4@interactive"]
    assert st["n"] == 5 and st["error_rate"] == 0.0 and st["burn_rate"] == 0.0
    assert slo_rows[0]["objectives"]["*"]["p99_ms"] == 1000.0


# -- memory accounting / admission -------------------------------------------


def test_memory_cold_bucket_admission_with_simulated_memory():
    from wam_tpu_torch.serve import MemoryAdmissionError, QueueFullError

    budget = MemoryBudget(budget_bytes=1024, in_use_fn=lambda: 900, retry_after_s=2.5)
    server = _server(max_batch=4, memory=budget)
    x = np.ones((4,), np.float32)
    try:
        with pytest.raises(MemoryAdmissionError) as ei:
            server.submit(x, 0)
        assert isinstance(ei.value, QueueFullError)
        assert ei.value.retry_after_s == 2.5 and ei.value.bucket == "4"
        assert budget.rejects == 1
        assert registry.counter(
            "wam_tpu_memory_admission_rejects_total").value(replica="-") == 1.0
        budget.capture_watermark("4", estimate_entry_bytes((4,), 4))
        np.testing.assert_array_equal(server.attribute(x, 0), x * 2.0)
    finally:
        server.close()


def test_memory_watermark_captured_at_warmup():
    """On the CPU the allocator reports nothing, so the watermark is the
    shape-derived estimate (the card's peak bytes are read by
    `device_memory_stats`, checked on the card by chip_smoke.py)."""
    from wam_tpu_torch.serve import AttributionServer
    from wam_tpu_torch.serve.entry import jit_entry

    server = AttributionServer(jit_entry(lambda xs, ys: xs * 2.0), [(4,)], max_batch=2,
                               max_wait_ms=0.0, warmup=True, memory=1 << 30, device="cpu")
    try:
        assert server._memory.is_warm("4")
        wm = server._memory.describe()["watermarks"]["4"]
        assert wm == estimate_entry_bytes((4,), 2)
        assert registry.gauge("wam_tpu_memory_bucket_watermark_bytes").value(
            replica="-", bucket="4") == float(wm)
        x = np.ones((4,), np.float32)
        np.testing.assert_array_equal(server.attribute(x, 0), x * 2.0)
    finally:
        server.close()


def test_device_memory_stats_reads_the_caching_allocator(monkeypatch):
    from wam_tpu_torch.obs import memory

    assert memory.device_memory_stats("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda dev: {
        "allocated_bytes.all.current": 100, "allocated_bytes.all.peak": 250,
        "reserved_bytes.all.current": 512})
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (1000, 4000))
    assert memory.device_memory_stats() == {
        "bytes_in_use": 100, "peak_bytes_in_use": 250, "bytes_reserved": 512,
        "bytes_free": 1000, "bytes_limit": 4000}
    budget = MemoryBudget(300, device="cuda:0")
    assert budget.capture_watermark("b", 7) == 250 and budget.bytes_in_use() == 100
    assert budget.admit("cold", 150) is None and budget.admit("cold", 250) == 1.0


def test_estimate_entry_bytes_and_staged_feed():
    assert estimate_entry_bytes((3, 32, 32), 8) == 3 * 32 * 32 * 8 * 4 * 4
    assert estimate_entry_bytes((4,), 1, multiplier=1.0, aot_bytes=100) == 116
    from wam_tpu_torch.pipeline.stager import put_committed

    before = registry.gauge("wam_tpu_memory_staged_bytes").value()
    put_committed(np.zeros((8,), np.float32), "cpu")
    assert registry.gauge("wam_tpu_memory_staged_bytes").value() == before + 32


# -- /metrics e2e -------------------------------------------------------------

_PROM_SAMPLE = (
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})? '
    r'(-?\d+(\.\d+)?([eE][+-]?\d+)?|nan|[+-]?inf)$'
)


def test_server_metrics_endpoint_exposes_health_plane():
    server = _server(max_batch=2, health=True, slo="p99_ms=1000", memory=1 << 30)
    prom = obs.start_metrics_server(0)
    x = np.zeros((4,), np.float32)
    try:
        for f in [server.submit(x, 0) for _ in range(8)]:
            f.result(timeout=10)
        server._slo.snapshot_row(publish=True)
        body = urllib.request.urlopen(f"http://127.0.0.1:{prom.server_port}/metrics",
                                      timeout=5).read().decode()
    finally:
        server.close()
        obs.stop_metrics_server(prom)
    for family in ("wam_tpu_health_checks_total", "wam_tpu_slo_burn_rate",
                   "wam_tpu_memory_budget_bytes"):
        assert f"# TYPE {family}" in body, family
        assert any(line.startswith(family) for line in body.splitlines()), family
    sample_re = re.compile(_PROM_SAMPLE)
    for line in body.splitlines():
        if line and not line.startswith("#"):
            assert sample_re.match(line), f"unparseable exposition line: {line!r}"


# -- profiling ------------------------------------------------------------------------


def test_stage_timer_and_median_iqr_match_the_reference():
    from wam_tpu import profiling as jprof
    from wam_tpu_torch import profiling as tprof

    samples = [0.3, 0.1, 0.4, 0.15, 0.9, 0.2]
    assert tprof.median_iqr(samples) == jprof.median_iqr(samples)
    timer = tprof.StageTimer(span_prefix="serve.")
    with timer.stage("assemble"):
        pass
    out = timer.timed("dispatch", lambda: torch.ones(3) * 2)
    tprof.device_sync((out, {"k": [out]}))
    s = timer.summary()
    assert s["assemble"]["calls"] == s["dispatch"]["calls"] == 1
    assert {r["name"] for r in obs.spans()} == {"serve.assemble", "serve.dispatch"}
