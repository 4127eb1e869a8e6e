"""The port's pod tier (`wam_tpu_torch.pod`, `testing.PodChaosKiller`) held
to the reference's (`wam_tpu.pod`):

- in process, against the reference: the frames of one message tree are
  byte-equal and each package decodes the other's; truncation, bad magic
  and an absurd header length raise `FrameError` in both; the HMAC
  handshake accepts the right key and rejects a wrong one across packages;
  the error wire dicts, the autoscaler's decisions, the supervisor's
  transitions (seeded backoff, a fake clock), the `PodMetrics` rows less
  their time fields, the router's scores and route picks on fake channels
  (`tests/test_transport.py`'s set-up) and `PodChaosKiller`'s victims are
  equal;
- the port alone, over real ``wam_tpu_torch.pod.worker`` subprocesses with
  ``--device cpu --fake-entry``: spread, a mid-stream SIGKILL with zero
  lost over pipe and tcp, a shrink that drains, and a crash loop that ends
  permanently dead (a worker killed twice, a respawn whose process exits
  before hello; also with stub respawns, as the reference tests it);
- one toy-entry worker whose answers are bit-equal to the port's
  in-process `serve_entry` on the same seed (the JAX entry draws its own
  noise; the in-process entry is held against JAX in
  `tests/test_torch_serve.py`), and a bfloat16 entry's result framed as
  float32, as the in-process fleet returns it.

The workers run torch on one thread (``OMP_NUM_THREADS=1``), as this
process does while a toy answer is compared."""

import dataclasses
import os
import random
import socket
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import wam_tpu.pod as jpod
import wam_tpu.pod.autoscaler as jautoscaler
import wam_tpu.pod.protocol as jprotocol
import wam_tpu.pod.router as jrouter
import wam_tpu.pod.supervisor as jsupervisor
import wam_tpu.pod.transport as jtransport
import wam_tpu.serve as jserve
import wam_tpu.serve.runtime as jruntime
import wam_tpu.testing as jtesting
from wam_tpu.pod.netchannel import NetListener as JNetListener
from wam_tpu.pod.netchannel import connect_tcp as jconnect_tcp
from wam_tpu_torch import pod as tpod
from wam_tpu_torch import testing as ttesting
from wam_tpu_torch.pod import autoscaler as tautoscaler
from wam_tpu_torch.pod import netchannel as tnet
from wam_tpu_torch.pod import protocol as tprotocol
from wam_tpu_torch.pod import router as trouter
from wam_tpu_torch.pod import supervisor as tsupervisor
from wam_tpu_torch.pod import transport as ttransport
from wam_tpu_torch.pod import worker as tworker
from wam_tpu_torch.serve import (
    FleetServer,
    NoLiveReplicaError,
    QueueFullError,
    RetryPolicy,
    RetryStats,
    SupervisorConfig,
)
from wam_tpu_torch.serve.runtime import MemoryAdmissionError

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
WORKER_ARGV = [sys.executable, "-m", "wam_tpu_torch.pod.worker", "--device", "cpu",
               "--fake-entry", "5", "--buckets", "1x16x16"]


def _poll(pred, timeout_s=30.0, dt=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(dt)
    return pred()


def _x():
    return np.zeros((1, 16, 16), np.float32)


def _pod(n=2, **kw):
    kw.setdefault("heartbeat_s", 0.1)
    kw.setdefault("env", ONE_THREAD)
    return tpod.PodRouter(WORKER_ARGV, "1x16x16", workers=n, **kw)


# -- frames: byte-equal and cross-decoded ------------------------------------------


def _snapshot(pkg, wid=3):
    return pkg.WorkerSnapshot(worker_id=wid, pid=1234, t_worker=12.5, projected_drain_s=0.25,
                              ema_service_s={"1x16x16": 0.01}, qos_depth={"interactive": 2},
                              queue_free=5, cache_hit_rate=0.5, completed=7,
                              models_resident={"m": 10})


def _messages(pkg):
    rng = np.random.default_rng(0)
    return {
        "submit": {"op": "submit", "req_id": 9, "x": rng.random((3, 16, 16), np.float32),
                   "y": 2, "deadline_ms": None, "ctx": ["t1", "s2"], "qos": "interactive",
                   "model": None, "tenant": "a"},
        "dtypes": {"op": "result", "req_id": 1, "ok": True,
                   "value": {"f16": rng.random(8).astype(np.float16),
                             "i64": np.arange(7, dtype=np.int64),
                             "bool": np.array([True, False]),
                             "empty": np.zeros((0, 4), np.float32),
                             "big": rng.random((2, 64, 64)).astype(np.float32).T}},
        "health": {"op": "health_reply", "t_send": 1.5, "t_worker": 2.5,
                   "snapshot": _snapshot(pkg)},
        "bundle": {"op": "registry_bundle",
                   "files": {"manifest.json": b"{}", "aot/x.aot": b"\x00\xffraw" * 10}},
        "scalars": {"op": "hello", "worker_id": np.int64(3), "ratio": np.float32(0.5),
                    "flag": np.bool_(True), "nested": [1, "two", None, {"k": 1.25}]},
    }


def _wire(pkg, msg) -> bytes:
    bufs, total = pkg.encode_message(msg)
    data = b"".join(bytes(b) for b in bufs)
    assert len(data) == total
    return data


def _decode(pkg, data: bytes):
    a, b = socket.socketpair()
    try:
        sender = threading.Thread(target=a.sendall, args=(data,))
        sender.start()
        out, n = pkg.read_message(b)
        sender.join(timeout=30)
        assert n == len(data)
        return out
    finally:
        a.close()
        b.close()


def _same_tree(a, b):
    if dataclasses.is_dataclass(a):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same_tree(u, v)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


@pytest.mark.parametrize("name", ["submit", "dtypes", "health", "bundle", "scalars"])
def test_frames_are_byte_equal_and_cross_decode(name):
    jmsg = _messages(jpod)[name]
    tmsg = _messages(tpod)[name]
    jdata, tdata = _wire(jtransport, jmsg), _wire(ttransport, tmsg)
    assert tdata == jdata
    # each package decodes the other's frame into its own types
    _same_tree(_decode(ttransport, jdata), _decode(ttransport, tdata))
    _same_tree(_decode(jtransport, tdata), _decode(jtransport, jdata))
    got = _decode(ttransport, jdata)
    if name == "health":
        assert isinstance(got["snapshot"], tprotocol.WorkerSnapshot)
    assert dataclasses.asdict(tprotocol.WorkerSnapshot(1, 2, 3.0)) == dataclasses.asdict(
        jprotocol.WorkerSnapshot(1, 2, 3.0))


def test_arrays_ride_raw_and_tensors_as_their_numpy_view():
    """The array payload is a view of the array's own memory (no pickle); a
    CPU tensor is framed as the same bytes as its numpy array, a bfloat16
    or device tensor is refused before anything is sent."""
    arr = np.arange(64, dtype=np.float32).reshape(8, 8)
    bufs, _ = ttransport.encode_message({"op": "submit", "x": arr})
    assert any(isinstance(b, memoryview) and np.shares_memory(np.frombuffer(b, np.uint8), arr)
               for b in bufs)
    t = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    assert _wire(ttransport, {"op": "result", "value": t}) == _wire(
        jtransport, {"op": "result", "value": arr})
    with pytest.raises(TypeError, match="bfloat16"):
        ttransport.encode_message({"op": "result", "value": t.bfloat16()})
    with pytest.raises(TypeError, match="meta"):
        ttransport.encode_message({"op": "result", "value": t.to("meta")})


def _frame_error(pkg, data: bytes):
    a, b = socket.socketpair()
    try:
        a.sendall(data)
        a.close()
        with pytest.raises(pkg.FrameError) as e:
            pkg.read_message(b)
        return str(e.value)
    finally:
        b.close()


@pytest.mark.parametrize("case", ["truncated", "bad_magic", "absurd_header", "lying_array"])
def test_frame_errors_are_alike(case):
    good = _wire(jtransport, {"op": "hello", "x": np.ones(4, np.float32)})
    if case == "truncated":
        data = good[:-3]
    elif case == "bad_magic":
        data = b"NOPE" + good[4:]
    elif case == "absurd_header":
        data = jtransport._PRELUDE.pack(jtransport.MAGIC, jtransport.MAX_HEADER_BYTES + 1)
    else:
        data = good.replace(b'"n":16', b'"n":12')
    assert issubclass(ttransport.FrameError, OSError)
    assert _frame_error(ttransport, data) == _frame_error(jtransport, data)


def _accepting(listener):
    accepted = []

    def loop():
        while True:
            try:
                accepted.append(listener.accept())
            except OSError:
                return

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    return accepted, t


@pytest.mark.parametrize("server,client", [(tnet.NetListener, jconnect_tcp),
                                           (JNetListener, tnet.connect_tcp)],
                         ids=["port-listens", "reference-listens"])
def test_hmac_handshake_across_packages(server, client):
    listener = server(authkey=b"right-key")
    addr = f"tcp://{listener.address[0]}:{listener.address[1]}"
    accepted, t = _accepting(listener)
    try:
        with pytest.raises((jtransport.PodAuthError, ttransport.PodAuthError, OSError)):
            client(addr, b"wrong-key")
        raw = socket.create_connection(tnet.parse_address(addr))
        raw.sendall(b"garbage-not-a-handshake-frame" + bytes(32))
        raw.close()
        chan = client(addr, b"right-key")
        assert chan.handshake_rtt_s is not None and chan.handshake_rtt_s >= 0.0
        chan.send({"op": "ping", "x": np.ones((2, 2), np.float32)})
        assert _poll(lambda: accepted, timeout_s=10.0)
        echoed = accepted[0].recv()
        assert echoed["op"] == "ping"
        np.testing.assert_array_equal(echoed["x"], np.ones((2, 2), np.float32))
        chan.close()
        assert _poll(lambda: listener.bad_handshakes >= 2, timeout_s=10.0)
    finally:
        listener.close()
        # the port's listener wakes its accept loop; the reference's stays
        # blocked in accept() (a daemon thread) after close
        t.join(timeout=10.0 if server is tnet.NetListener else 0.5)
    if server is tnet.NetListener:
        assert not t.is_alive()


# -- typed errors ------------------------------------------------------------------


def _errors(serve, runtime, pod):
    return [serve.QueueFullError(0.25), runtime.MemoryAdmissionError(0.5, bucket="1x16x16"),
            serve.NoLiveReplicaError("all dead", retry_after_s=1.5),
            runtime.ServerClosedError("closing"), runtime.DeadlineExceededError("late"),
            serve.NoBucketError("no bucket"), pod.NoLiveWorkerError("pod down", 0.02),
            ValueError("foreign")]


def test_error_wire_dicts_equal_the_reference_and_round_trip():
    import wam_tpu_torch.serve as tserve
    import wam_tpu_torch.serve.runtime as truntime

    jerrs = _errors(jserve, jruntime, jpod)
    terrs = _errors(tserve, truntime, tpod)
    for je, te in zip(jerrs, terrs):
        row = tprotocol.encode_error(te)
        assert row == jprotocol.encode_error(je)
        back = tprotocol.decode_error(row)
        jback = jprotocol.decode_error(row)
        assert type(back).__name__ == type(jback).__name__
        assert str(back) == str(jback)
        assert getattr(back, "retry_after_s", None) == getattr(jback, "retry_after_s", None)
    assert isinstance(tprotocol.decode_error(tprotocol.encode_error(QueueFullError(0.25))),
                      QueueFullError)
    assert isinstance(tprotocol.decode_error({"type": "MemoryAdmissionError",
                                              "retry_after_s": 0.5}), MemoryAdmissionError)
    assert isinstance(tprotocol.decode_error(tprotocol.encode_error(NoLiveReplicaError("x"))),
                      NoLiveReplicaError)
    u = tprotocol.decode_error({"type": "SomethingForeign", "message": "boom",
                                "retry_after_s": 2.0})
    assert isinstance(u, tpod.PodWorkerError) and u.retry_after_s == 2.0


def test_the_authkey_travels_in_the_environment(monkeypatch):
    monkeypatch.delenv(tprotocol.AUTHKEY_ENV, raising=False)
    assert tprotocol.AUTHKEY_ENV == jprotocol.AUTHKEY_ENV
    with pytest.raises(RuntimeError, match=tprotocol.AUTHKEY_ENV):
        tprotocol.connect_to_router("tcp://127.0.0.1:1")


# -- policies: autoscaler, supervisor, metrics ------------------------------------


def test_autoscaler_decisions_equal_the_reference():
    rng = random.Random(0)
    cfgs = [dict(), dict(min_workers=2, max_workers=3, grow_drain_s=0.2, shrink_drain_s=0.1)]
    n = 0
    for kw in cfgs:
        tcfg, jcfg = tautoscaler.AutoscaleConfig(**kw), jautoscaler.AutoscaleConfig(**kw)
        for _ in range(300):
            k = rng.randrange(0, 5)
            rows = [dict(worker_id=i, pid=0, t_worker=0.0,
                         projected_drain_s=rng.choice([0.0, 0.01, 0.07, 0.3, 0.6, 2.0]),
                         slo_penalty_s=rng.choice([0.0, 0.0, 0.0, 0.1]),
                         cache_hit_rate=rng.choice([-1.0, 0.0, 0.5, 0.95]))
                    for i in range(k)]
            n_live = rng.randrange(0, 6)
            got = tautoscaler.decide(tcfg, [tpod.WorkerSnapshot(**r) for r in rows], n_live)
            want = jautoscaler.decide(jcfg, [jpod.WorkerSnapshot(**r) for r in rows], n_live)
            assert got == want
            n += got != 0
    assert n > 100  # the sequence reaches both branches, not only "hold"


class _FakeClock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


def _supervise(pkg_sup, pkg_metrics, monkeypatch, script, fail_on=()):
    """Drive one package's `PodSupervisor` through ``script`` (death wids, or
    ("advance", s) to move the fake clock) with a stub respawn; returns the
    transition rows less their time field."""
    clock = _FakeClock()
    monkeypatch.setattr(pkg_sup, "time", clock)
    calls = []

    def respawn(wid):
        calls.append(wid)
        if len(calls) in fail_on:
            raise RuntimeError("spawn exploded")

    metrics = pkg_metrics.PodMetrics()
    sup = pkg_sup.PodSupervisor(respawn, metrics, jserve.SupervisorConfig(
        max_restarts=2, window_s=60.0, backoff_base_s=0.001, backoff_cap_s=0.002, seed=7))
    try:
        for step in script:
            if isinstance(step, tuple):
                clock.t += step[1]
                continue
            before = len(metrics.restarts)
            sup.notify_death(step, reason="test kill")

            def settled(wid=step, before=before):
                # alive again or escalated (a failed respawn is re-queued);
                # a death of a permanently dead worker writes no row
                rows = [r for r in metrics.restarts[before:] if r["worker_id"] == wid]
                return (not sup.describe()["pending"]
                        and (rows[-1]["transition"] in ("alive", "permanent_dead")
                             if rows else sup.permanently_dead(wid)))

            assert _poll(settled, timeout_s=10.0)
        time.sleep(0.02)
        perm = sup.permanently_dead()
    finally:
        sup.close()
    return ([{k: v for k, v in r.items() if k != "t_s"} for r in metrics.restarts],
            perm, calls)


@pytest.mark.parametrize("script,fail_on", [
    ([7, 7, 7, 7], ()),
    ([7, 7, ("advance", 61.0), 7, 7, 7], ()),
    ([3, 4, 3, 4, 3], ()),
    ([5], (1,)),
], ids=["crash-loop", "window-expires", "two-workers", "failed-respawn"])
def test_supervisor_transitions_equal_the_reference(monkeypatch, script, fail_on):
    import wam_tpu.pod.metrics as jmetrics

    import wam_tpu_torch.pod.metrics as tmetrics

    got = _supervise(tsupervisor, tmetrics, monkeypatch, script, fail_on)
    want = _supervise(jsupervisor, jmetrics, monkeypatch, script, fail_on)
    assert got == want
    rows = got[0]
    assert rows and {r["transition"] for r in rows} <= {
        "restarting", "alive", "respawn_failed", "permanent_dead"}


def test_crash_loop_escalates_to_permanent_dead():
    metrics = tpod.PodMetrics()
    respawns = []
    sup = tpod.PodSupervisor(respawns.append, metrics, SupervisorConfig(
        max_restarts=2, window_s=60.0, backoff_base_s=0.001, seed=0))

    def alive_rows():
        return [r for r in metrics.restarts if r["transition"] == "alive"]

    try:
        for expected in (1, 2):
            sup.notify_death(7, reason="test kill")
            assert _poll(lambda: len(alive_rows()) == expected, timeout_s=10.0)
        assert len(respawns) == 2
        sup.notify_death(7, reason="test kill")
        assert sup.permanently_dead(7) and sup.permanently_dead() == [7]
        sup.notify_death(7, reason="ignored")
        time.sleep(0.05)
        assert len(respawns) == 2
    finally:
        sup.close()
    transitions = [r["transition"] for r in metrics.restarts if r["worker_id"] == 7]
    assert transitions.count("alive") == 2 and transitions[-1] == "permanent_dead"


def test_failed_respawn_counts_toward_the_crash_loop():
    metrics = tpod.PodMetrics()

    def bad_respawn(wid):
        raise RuntimeError("spawn exploded")

    sup = tpod.PodSupervisor(bad_respawn, metrics, SupervisorConfig(
        max_restarts=1, window_s=60.0, backoff_base_s=0.001, seed=0))
    try:
        sup.notify_death(3, reason="test kill")
        assert _poll(lambda: sup.permanently_dead(3), timeout_s=10.0)
    finally:
        sup.close()
    transitions = [r["transition"] for r in metrics.restarts if r["worker_id"] == 3]
    assert "respawn_failed" in transitions and transitions[-1] == "permanent_dead"
    assert "alive" not in transitions


class _W:
    """A router-side worker record as `PodMetrics.pod_summary` reads it."""

    def __init__(self, wid, inc, alive, snap, final=None):
        self.wid, self.incarnation, self.alive = wid, inc, alive
        self.snapshot, self.final_snapshot = snap, final


class _Writer:
    def __init__(self):
        self.rows = []

    def write(self, row):
        self.rows.append(row)


TIME_FIELDS = {"t_s", "window_s", "attributions_per_s"}


def _strip(row):
    if isinstance(row, dict):
        return {k: _strip(v) for k, v in row.items() if k not in TIME_FIELDS}
    if isinstance(row, list):
        return [_strip(v) for v in row]
    return row


def test_pod_metrics_rows_equal_the_reference():
    import wam_tpu.pod.metrics as jmetrics

    import wam_tpu_torch.pod.metrics as tmetrics

    def drive(pkg, mod):
        m = mod.PodMetrics()
        s0, s1 = _snapshot(pkg, 0), _snapshot(pkg, 1)
        m.note_worker_ready(0, 0, s0, spawn_s=1.5)
        m.note_worker_ready(1, 0, s1, spawn_s=2.5)
        for lat in (0.01, 0.02, 0.05, 0.2):
            m.note_request(lat)
        m.note_worker_death(1, "exit code -9", snapshot=s1)
        m.note_worker_restart(1, "restarting", attempt=1, backoff_s=0.1, reason="kill")
        m.note_worker_restart(1, "alive", attempt=1, backoff_s=0.1, reason="kill")
        m.note_autoscale(1, 2, 0.7, worker=2)
        m.note_autoscale(-1, 3, 0.0, worker=2, error="")
        m.note_worker_final(0, 0, s0)
        w = [_W(0, 0, True, s0, s0), _W(1, 1, True, s1)]
        out = _Writer()
        summary = m.emit(out, config={"transport": "tcp"}, workers=w,
                         hosts=[{"host": "h0", "alive": 2}])
        return out.rows, summary

    trows, tsum = drive(tpod, tmetrics)
    jrows, jsum = drive(jpod, jmetrics)
    assert _strip(trows) == _strip(jrows)
    assert _strip(tsum) == _strip(jsum)
    assert [r["metric"] for r in trows] == ["pod_worker"] * 3 + ["worker_restart"] * 2 + [
        "pod_autoscale"] * 2 + ["pod_host", "pod_summary"]


# -- routing on fake channels (tests/test_transport.py's set-up) --------------------


class _FakeChan:
    def __init__(self):
        self.sent = []

    def send(self, msg):
        self.sent.append(msg)

    def close(self):
        pass


def _fake_router(rmod, pkg):
    return pkg.PodRouter([sys.executable, "-c", "pass"], "1x16x16", workers=0,
                         hosts=["host0", "host1"], host_label="host0", auto_start=False,
                         supervise=False)


def _fake_worker(rmod, pkg, router, wid, host, drain_s=0.0, rtt_s=None, free=8, **snap):
    w = rmod._Worker(wid, 0, expected_host=host)
    w.alive, w.host, w.chan = True, host, _FakeChan()
    w.snapshot = pkg.WorkerSnapshot(worker_id=wid, pid=1000 + wid, t_worker=0.0,
                                    projected_drain_s=drain_s,
                                    ema_service_s={"1x16x16": 0.01}, queue_free=free, **snap)
    w.snapshot_t = rmod.time.monotonic()
    w.ready.set()
    with router._lock:
        router._workers[wid] = w
    if rtt_s is not None:
        router._note_rtt(w, rtt_s)
    return w


def _route_trace(rmod, pkg, monkeypatch):
    """Scores and picks of one router over a fixed sequence of fake workers,
    loads and submits; the router's monotonic clock is frozen, so the
    time-decayed drain is the reported one in both packages."""
    monkeypatch.setattr(rmod, "time", types.SimpleNamespace(
        monotonic=lambda: 100.0, perf_counter=time.perf_counter, sleep=time.sleep))
    router = _fake_router(rmod, pkg)
    ws = [_fake_worker(rmod, pkg, router, 0, "host0"),
          _fake_worker(rmod, pkg, router, 1, "host1", rtt_s=0.002),
          _fake_worker(rmod, pkg, router, 2, "host0", drain_s=0.03,
                       qos_depth={"interactive": 2}),
          _fake_worker(rmod, pkg, router, 3, "host1", free=0, slo_penalty_s=0.1)]
    x = np.zeros((1, 16, 16), np.float32)
    trace = []
    loads = [(0.0, 0.0), (0.5, 0.0), (0.5, 0.5), (0.0, 0.2), (0.01, 0.0)]
    for i, (d0, d1) in enumerate(loads * 2):
        ws[0].snapshot.projected_drain_s, ws[1].snapshot.projected_drain_s = d0, d1
        trace.append([router._score(w, "1x16x16") for w in ws])
        router.submit(x, i % 3)
        trace.append([len(w.chan.sent) for w in ws])
    router.close()
    return trace


def test_router_scores_and_picks_equal_the_reference(monkeypatch):
    got = _route_trace(trouter, tpod, monkeypatch)
    assert got == _route_trace(jrouter, jpod, monkeypatch)
    # the local worker wins the first tie; the full queue is never first
    assert got[1] == [1, 0, 0, 0] and got[-1][3] == 0


def test_retry_after_min_reduces_across_hosts():
    router = _fake_router(trouter, tpod)
    _fake_worker(trouter, tpod, router, 0, "host0")
    _fake_worker(trouter, tpod, router, 1, "host1")
    fut = router.submit(_x(), 0)
    with router._lock:
        workers = dict(router._workers)
    for wid, ra in ((0, 0.8), (1, 0.3)):
        router._on_result(workers[wid], {"req_id": next(iter(workers[wid].inflight)),
                                         "ok": False,
                                         "error": {"type": "QueueFullError",
                                                   "retry_after_s": ra}})
    try:
        with pytest.raises(QueueFullError) as e:
            fut.result(timeout=5)
        assert abs(e.value.retry_after_s - 0.3) < 1e-9
    finally:
        router.close()


class _ChaosRouter:
    def __init__(self, n):
        self.live = list(range(n))
        self.killed = []

    def live_worker_ids(self):
        return list(self.live)

    def kill_worker(self, wid):
        self.killed.append(wid)
        self.live.remove(wid)
        return True


@pytest.mark.parametrize("seed", [0, 3])
def test_pod_chaos_killer_replays_the_reference_victims(seed):
    runs = []
    for cls in (ttesting.PodChaosKiller, jtesting.PodChaosKiller, ttesting.PodChaosKiller):
        r = _ChaosRouter(5)
        killer = cls(r, 40, fractions=(0.25, 0.6, 0.9), seed=seed)
        for done in range(41):
            killer.on_progress(done)
        runs.append((r.killed, killer.kills))
    assert runs[0] == runs[1] == runs[2]
    assert [k["threshold"] for k in runs[0][1]] == [10, 24, 36]
    with pytest.raises(ValueError):
        ttesting.PodChaosKiller(_ChaosRouter(1), 10, fractions=(1.0,))


# -- the worker's entry point -------------------------------------------------------


def test_worker_cli_runs_with_jax_blocked_and_takes_the_card_by_default():
    block = "".join(f"sys.modules[{m!r}] = None\n" for m in ("jax", "jaxlib", "flax", "wam_tpu"))
    code = ("import sys, runpy\n" + block
            + "sys.argv = ['worker'] + sys.argv[1:]\n"
              "runpy.run_module('wam_tpu_torch.pod.worker', run_name='__main__')\n")
    env = {**os.environ, **ONE_THREAD, "CUDA_VISIBLE_DEVICES": ""}
    help_ = subprocess.run([sys.executable, "-c", code, "--help"], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=120)
    assert help_.returncode == 0 and "--fake-entry" in help_.stdout, help_.stderr
    run = subprocess.run([sys.executable, "-c", code, "--connect", "tcp://127.0.0.1:1",
                          "--worker-id", "0"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode != 0 and "no CUDA device is available" in run.stderr


def test_a_bfloat16_result_is_framed_as_the_in_process_float32():
    """A bfloat16 entry's rows reach the client as float32, the dtype the
    in-process fleet returns them in (the worker's fleet fetches them so),
    through a frame; a bfloat16 tensor itself is refused by the encoder."""
    def factory(rid, metrics, dev):
        return lambda xs, ys: (xs * 1.5).to(torch.bfloat16)

    fleet = FleetServer(factory, [(1, 16, 16)], devices=["cpu"], max_batch=2)
    try:
        x = np.linspace(-2, 2, 256, dtype=np.float32).reshape(1, 16, 16)
        want = fleet.submit(x, 0).result(timeout=30)
    finally:
        fleet.close()
    assert want.dtype == np.float32
    np.testing.assert_array_equal(want, torch.from_numpy(x * 1.5).bfloat16().float().numpy())
    got = _decode(ttransport, _wire(ttransport, {"op": "result", "value": want}))["value"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# -- real worker processes (fake entries) --------------------------------------------


def test_router_spreads_load_across_workers():
    router = _pod(2)
    try:
        futs = [router.submit(_x(), 0) for _ in range(60)]
        assert all(f.result(timeout=60).shape == (1, 16, 16) for f in futs)
    finally:
        router.close()
    summary = router.pod_summary()
    assert summary["completed"] == 60
    per_worker = {w["worker_id"]: w for w in summary["per_worker"]}
    assert set(per_worker) == {0, 1}
    assert all(w["completed"] > 0 for w in per_worker.values())
    assert sum(w["completed"] for w in per_worker.values()) == 60
    assert all("device" not in w for w in per_worker.values())  # no card


@pytest.mark.parametrize("transport", ["pipe", "tcp"])
def test_kill_worker_midstream_zero_lost(transport):
    router = _pod(2, transport=transport,
                  supervise=SupervisorConfig(seed=0, backoff_base_s=0.01))
    policy = RetryPolicy(max_attempts=8, budget_s=60.0,
                         retry_on=(QueueFullError, tpod.NoLiveWorkerError))
    stats = RetryStats()
    try:
        futs = [router.submit_with_retry(_x(), 0, policy=policy, stats=stats)
                for _ in range(40)]
        victim = router.live_worker_ids()[0]
        assert router.kill_worker(victim)
        futs += [router.submit_with_retry(_x(), 0, policy=policy, stats=stats)
                 for _ in range(40)]
        assert all(f.result(timeout=60) is not None for f in futs)
        assert router.pod_summary()["completed"] == 80
        # the death is seen asynchronously (the channel's EOF or the exit
        # code): every request may resolve on the survivor first
        assert _poll(lambda: [d["worker_id"] for d in router.pod_summary()["deaths"]]
                     == [victim], timeout_s=30.0)
        assert _poll(lambda: sorted(router.live_worker_ids()) == [0, 1], timeout_s=60.0)
    finally:
        router.close()
    assert router.describe()["transport"] == transport
    assert stats.as_dict()["exhausted"] == 0
    rows = [r for r in router.metrics.restarts if r["transition"] == "alive"]
    assert len(rows) == 1 and rows[0]["worker_id"] == victim


def test_shrink_drains_gracefully():
    router = _pod(2)
    try:
        futs = [router.submit(_x(), 0) for _ in range(20)]
        wid = router.shrink()
        assert wid is not None
        assert all(f.result(timeout=60) is not None for f in futs)
        assert router.pod_summary()["deaths"] == []
        assert _poll(lambda: router.live_worker_ids() == [1 - wid], timeout_s=30.0)
        assert router.attribute(_x(), 0) is not None
    finally:
        router.close()


def test_a_worker_in_a_long_batch_still_answers_its_heartbeats():
    """Health probes are answered on the worker's channel thread, not its
    serving thread: a batch that holds the serving thread for 2.5 s (the
    fake entry's GIL-releasing sleep, as a wait on the card is) does not
    silence a worker whose heartbeat timeout is 1 s."""
    argv = [a if a != "5" else "2500" for a in WORKER_ARGV]
    router = tpod.PodRouter(argv, "1x16x16", workers=1, heartbeat_s=0.1,
                            heartbeat_timeout_s=1.0, env=ONE_THREAD)
    try:
        replies = router._workers[0].last_reply
        assert router.attribute(_x(), 0).shape == (1, 16, 16)
        assert router._workers[0].last_reply > replies + 2.0  # answered during the batch
        assert router.pod_summary()["deaths"] == []
    finally:
        router.close()


def test_chaos_kills_close_together_take_two_workers():
    """Two kill thresholds one request apart: a SIGKILLed worker leaves the
    live set at once (its death is detected later), so the second kill
    takes the other worker, and both deaths are seen and re-routed."""
    router = _pod(2, supervise=SupervisorConfig(seed=0, backoff_base_s=0.01))
    killer = ttesting.PodChaosKiller(router, 100, fractions=(0.01, 0.02), seed=1)
    try:
        killer.on_progress(1)
        killer.on_progress(2)
        assert [k["killed"] for k in killer.kills] == [True, True]
        assert sorted(k["worker_id"] for k in killer.kills) == [0, 1]
        assert not router.kill_worker(killer.kills[0]["worker_id"])  # no second SIGKILL
        assert _poll(lambda: len(router.pod_summary()["deaths"]) == 2, timeout_s=30.0)
        policy = RetryPolicy(max_attempts=8, budget_s=60.0,
                             retry_on=(QueueFullError, tpod.NoLiveWorkerError))
        assert router.submit_with_retry(_x(), 0, policy=policy).result(timeout=60) is not None
    finally:
        router.close()


@pytest.mark.parametrize("case", ["killed-twice", "respawn-fails"])
def test_a_real_crash_loop_ends_permanently_dead(case):
    """One fake worker under `SupervisorConfig(max_restarts=1)`: killed
    twice inside the window it is respawned once, then escalated; when its
    respawn's process exits before hello, the failed spawn counts toward
    the loop at once (no wait for the ready timeout) and escalates."""
    router = _pod(1, supervise=SupervisorConfig(max_restarts=1, window_s=60.0,
                                                backoff_base_s=0.01, seed=0),
                  ready_timeout_s=120.0)
    try:
        assert router.kill_worker(0)
        if case == "killed-twice":
            assert _poll(lambda: [r["transition"] for r in router.metrics.restarts]
                         == ["restarting", "alive"], timeout_s=60.0)
            assert router.attribute(_x(), 0) is not None
            assert router.kill_worker(0)
        else:
            router._worker_argv = [sys.executable, "-c", "import sys; sys.exit(3)"]
        assert _poll(lambda: router._supervisor.permanently_dead(0), timeout_s=60.0)
        with pytest.raises(tpod.NoLiveWorkerError) as e:
            router.submit(_x(), 0).result(timeout=30)
        assert e.value.retry_after_s is None  # nobody is coming back
    finally:
        router.close()
    transitions = [r["transition"] for r in router.metrics.restarts]
    assert transitions == (["restarting", "alive", "permanent_dead"] if case == "killed-twice"
                           else ["restarting", "respawn_failed", "permanent_dead"])
    if case == "respawn-fails":
        assert "exited with code 3" in router.metrics.restarts[1]["reason"]


# -- the toy entry: a worker's answers against the in-process entry -----------------


def test_toy_worker_answers_equal_the_in_process_entry():
    """Each request is sent alone, so the worker's batch is the item padded
    by replication to --max-batch rows; the in-process `serve_entry` of the
    same recipe on that batch gives the same bits."""
    argv = [sys.executable, "-m", "wam_tpu_torch.pod.worker", "--device", "cpu",
            "--buckets", "3x16x16", "--n-samples", "3", "--max-batch", "4"]
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((3, 3, 16, 16)).astype(np.float32)
    ys = [0, 3, 1]
    router = tpod.PodRouter(argv, "3x16x16", workers=1, heartbeat_s=0.1, env=ONE_THREAD,
                            transport="tcp")
    try:
        got = [router.attribute(x, y) for x, y in zip(xs, ys)]
        rows = [r for r in router.metrics.worker_rows if r["phase"] == "ready"]
        assert rows and rows[0]["compile_count"] == 1  # the one warmup shape
    finally:
        router.close()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        entry = tworker.toy_wam(3, "cpu").serve_entry()
        for x, y, g in zip(xs, ys, got):
            batch = torch.from_numpy(np.repeat(x[None], 4, axis=0))
            want = entry(batch, torch.full((4,), y, dtype=torch.int32))[0].numpy()
            assert g.dtype == np.float32 and g.shape == want.shape
            np.testing.assert_array_equal(g, want)
    finally:
        torch.set_num_threads(threads)
    assert np.abs(got[0]).max() > 0 and not np.array_equal(got[0], got[1])
