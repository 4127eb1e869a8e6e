"""Front-door pod router: health-aware routing over N worker processes.

`PodRouter` is the process-level analog of `serve.fleet.FleetServer`: the
fleet routes items across replica threads inside one process; the router
routes them across INDEPENDENT worker processes (`wam_tpu_torch.pod.worker`),
each a full fleet of its own. The routing discipline is deliberately the
same shape as `FleetServer._route_inner` so operators reason about one
model at both scales:

- **healthy-first, load-aware**: candidates are scored by the worker's
  last-heartbeat ``projected_drain_s`` plus the router-side in-flight
  count times the worker's per-bucket EMA service time (the heartbeat is
  stale by up to one interval; in-flight accounting covers the gap) plus
  the worker's SLO burn penalty. Workers whose every replica is
  quarantined are last-resort candidates, never dropped.
- **host-aware**: every worker belongs to a host group
  (``--host-label``, self-reported at hello). Cross-host candidates
  carry their host's congestion-free MIN RTT (lowest heartbeat
  round-trip seen, seeded by the transport handshake; the EMA is kept
  alongside for observability) added to the drain+SLO score — a remote
  worker wins exactly when it is cheaper by more than the wire, so an
  idle remote host absorbs load a busy local one would queue (locality
  is a penalty, not a tier: a hard local-first tier would starve
  remote hosts whenever local queues merely had room; penalizing with
  the loaded EMA would double-count queueing the drain term already
  scores). Workers
  whose heartbeat said ``queue_free == 0`` sort after workers with
  room on ANY host: a rejected submit now costs a network round-trip,
  not a pipe hop, so the router avoids hops it already knows will
  bounce.
- **typed backpressure, aggregated fleet-style**: a worker's
  `QueueFullError` re-routes the request to the next candidate; when
  every live worker rejected, the request fails with a `QueueFullError`
  carrying the smallest ``retry_after_s`` per HOST, min-reduced across
  hosts — folding in any host's supervised-respawn ETA when a dead
  host would be back sooner than the live ones drain.
- **zero lost requests across worker death**: the router keeps the host
  copy of every in-flight request until its result arrives; a worker
  death (channel EOF, heartbeat timeout, or exit code — whichever signal
  lands first) re-routes everything that worker held to the survivors,
  exactly like the fleet's `_harvest` re-route, while the
  `PodSupervisor` respawns the process with jittered backoff (hydrating
  the registry bundle so rejoin is seconds). With ZERO live workers the
  submit fails `NoLiveWorkerError` whose ``retry_after_s`` estimates the
  respawn ETA — `RetryPolicy` treats a total-outage window as
  backpressure, not a terminal failure.

Trace identity crosses the process boundary: the router opens the
per-request root span, ships ``(trace_id, span_id)`` with the submit, and
workers re-establish it (`obs.tracing.use_context`) so their spans join
the request's timeline. At close each worker ships its span ring back;
`trace_events()` re-bases them onto the router's clock (offset estimated
from heartbeat RTTs) for one merged Chrome trace.
"""

from __future__ import annotations

import itertools
import os
import secrets
import socket as _socket
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from multiprocessing.connection import Listener

import numpy as np

from wam_tpu_torch.obs import tracing as obs_tracing
from wam_tpu_torch.pod.metrics import PodMetrics
from wam_tpu_torch.pod.protocol import AUTHKEY_ENV, Channel, decode_error
from wam_tpu_torch.pod.supervisor import PodSupervisor
from wam_tpu_torch.serve.buckets import BucketTable, bucket_key
from wam_tpu_torch.serve.metrics import EMA_SEED_S
from wam_tpu_torch.serve.fleet import INTERACTIVE_DEPTH_WEIGHT, MODEL_PAGEIN_PENALTY_S
from wam_tpu_torch.serve.runtime import (
    DeadlineExceededError,
    QueueFullError,
    ServeError,
    ServerClosedError,
)
from wam_tpu_torch.serve.supervisor import SupervisorConfig

__all__ = ["NoLiveWorkerError", "PodRouter"]

# seed for the spawn-time EMA before the first worker came up (the
# respawn-ETA half of NoLiveWorkerError.retry_after_s)
_SPAWN_EMA_SEED_S = 5.0

# control-channel transport: "tcp" (framed zero-copy, pod.netchannel)
# or "pipe" (legacy multiprocessing pickle pipe)
TRANSPORT_ENV = "WAM_TPU_POD_TRANSPORT"
_DEFAULT_TRANSPORT = "tcp"

# health-poll period override (seconds); constructor args still win
HEARTBEAT_ENV = "WAM_TPU_POD_HEARTBEAT_S"
_DEFAULT_HEARTBEAT_S = 0.25

# per-host RTT EMA smoothing (heartbeat round-trips; handshake-seeded)
_RTT_EMA_ALPHA = 0.2

# at most this many pre-hello exchanges (registry probes) before a
# connection must say hello or be dropped
_MAX_PREFACE_MSGS = 4


def _resolve_transport(transport: str | None) -> str:
    t = transport or os.environ.get(TRANSPORT_ENV, "") or _DEFAULT_TRANSPORT
    if t not in ("tcp", "pipe"):
        raise ValueError(f"unknown pod transport {t!r} (tcp|pipe)")
    return t


class NoLiveWorkerError(ServeError):
    """Every pod worker is dead (or refused this request after deaths).
    ``retry_after_s`` estimates when a supervised respawn will be serving
    again (pending-restart ETA + spawn-time EMA; None when the pod is
    unsupervised and nobody is coming back) — `RetryPolicy` floors its
    backoff at it, turning a total-outage window into survivable
    backpressure."""

    def __init__(self, msg: str, retry_after_s: float | None = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


@dataclass
class _PodRequest:
    """One admitted item's routing state (the process-level twin of
    `serve.fleet._FleetRequest`): the router holds ``x`` until a result
    lands, so a worker death re-dispatches from the host copy."""

    req_id: int
    x: np.ndarray
    y: int | None
    bkey: str
    deadline_at: float | None
    future: Future
    t_submit: float
    qos: str = "interactive"
    model: str | None = None
    tenant: str | None = None
    tried: set = field(default_factory=set)
    # tightest QueueFullError retry_after per HOST that rejected; the
    # terminal error min-reduces ACROSS hosts (satellite: a pod is now
    # multiple failure domains, the estimate must span all of them)
    retry_after_by_host: dict = field(default_factory=dict)
    ctx: tuple | None = None


class _Worker:
    """Router-side state for one worker process incarnation."""

    def __init__(self, wid: int, incarnation: int, expected_host: str = ""):
        self.wid = wid
        self.incarnation = incarnation
        self.proc: subprocess.Popen | None = None
        self.chan: Channel | None = None
        self.snapshot = None  # latest protocol.WorkerSnapshot
        self.snapshot_t = time.monotonic()  # when `snapshot` landed
        self.last_reply = time.monotonic()
        self.alive = False
        self.host = ""  # self-reported at hello
        self.expected_host = expected_host  # spawn-time assignment
        # monotonic time of the unanswered health probe, or None —
        # the heartbeat loop coalesces instead of stacking probes
        # (heartbeat thread sets, receiver thread clears; benign race)
        self.health_pending_t: float | None = None
        self.draining = False  # autoscale shrink: no new routes
        # SIGKILLed by this router (kill_worker / kill_host): not live for
        # the chaos and autoscale surface from the kill on, though its death
        # is detected, re-routed and respawned by the usual paths
        self.killed = False
        self.closing = False  # router-initiated close: EOF is not a death
        self.ready = threading.Event()
        self.inflight: dict[int, _PodRequest] = {}
        self.inflight_lock = threading.Lock()
        # perf_counter offset: t_router ~= t_worker + clock_offset_s,
        # estimated from the lowest-RTT heartbeat (midpoint method)
        self.clock_offset_s = 0.0
        self.best_rtt_s = float("inf")
        self.spans: list[dict] = []  # shipped at bye
        self.final_snapshot = None
        # what a worker on a card reports beside its snapshot ("device":
        # allocator peak bytes, the kernels' launch counts since its start,
        # at hello its start-up stamps): the latest and the one at hello
        self.device_stats: dict | None = None
        self.device_ready: dict | None = None


class PodRouter:
    """See module docstring.

    Parameters
    ----------
    worker_argv : base command for one worker process, e.g.
        ``[sys.executable, "-m", "wam_tpu_torch.pod.worker", "--device", "cpu",
        "--fake-entry", "25", "--buckets", "1x16x16"]``. The router
        appends ``--connect``/``--worker-id``; the literal ``{wid}`` in
        any element is substituted with the worker id (per-worker ledger
        paths and the like; ``--device cuda:{wid}`` spreads workers over
        the cards of a machine, while on one card every worker takes
        ``cuda:0``). Respawns and autoscale grows reuse it, so a
        ``--registry`` in here is what makes every rejoin hydrate.
    workers : initial worker count.
    buckets : the workers' admitted item shapes (`ServeConfig` grammar or
        a shape list) — the router needs them for bucket-keyed scoring
        and fail-fast `NoBucketError` before anything queues.
    labeled : whether submits carry a class label (must match the
        workers' entries).
    supervise : `serve.supervisor.SupervisorConfig` / True for supervised
        respawn with crash-loop escalation; None/False = a dead worker
        stays dead (in-flight work still re-routes either way).
    autoscale : a `pod.autoscaler.AutoscaleConfig` to grow/shrink the
        worker set from aggregate drain + SLO burn; None = fixed set.
    heartbeat_s / heartbeat_timeout_s : health-poll period and the
        silence threshold that declares a worker dead. ``heartbeat_s``
        defaults from ``WAM_TPU_POD_HEARTBEAT_S`` (else 0.25); at most
        ONE probe per worker is outstanding — while a worker is busy,
        further ticks coalesce instead of stacking stale probes.
    ready_timeout_s : max wall time for a spawned worker to warm and
        say hello (covers the torch import, the CUDA context, the kernels'
        libraries, registry hydration and warmup).
    transport : "tcp" (framed zero-copy transport, `pod.netchannel`) or
        "pipe" (legacy multiprocessing pickle pipe); None defaults from
        ``WAM_TPU_POD_TRANSPORT`` (else tcp). The scheme rides the
        ``--connect`` address, so workers need no extra flag.
    hosts : host-group labels to spread spawned workers over
        (round-robin by wid; the literal ``{host}`` in the argv is
        substituted, so benches pass ``--host-label {host}``). None =
        every worker expected on this router's own host.
    host_label : this router's own host identity for host-local-first
        routing (default: the real hostname).
    registry : a compile-artifact bundle DIRECTORY to stream over the
        wire to workers spawned with ``--registry wire`` — a freshly
        connected host probes, receives the bundle as raw byte frames,
        and hydrates to ``compile_count == 0`` before taking traffic.
        Workers with a shared filesystem keep using ``--registry
        PATH`` directly; this parameter is for hosts that do not.
    env : extra environment for worker processes.
    metrics_path : pod JSONL ledger (pod_worker / worker_restart /
        pod_autoscale / pod_host / pod_summary rows) written at close.
    """

    # checked by the lock-discipline lint rule: mutations outside __init__
    # must hold self._lock (heartbeat, acceptor, supervisor, and client
    # threads all touch these)
    _GUARDED_BY = {
        "_closed": "_lock",
        "_started": "_lock",
        "_workers": "_lock",
        "_threads": "_lock",
        "_spawn_ema_s": "_lock",
        "_host_rtt": "_lock",
        "_host_rtt_min": "_lock",
        "_wire_files": "_lock",
    }

    def __init__(
        self,
        worker_argv,
        buckets,
        *,
        workers: int = 2,
        labeled: bool = True,
        supervise=True,
        autoscale=None,
        heartbeat_s: float | None = None,
        heartbeat_timeout_s: float = 5.0,
        ready_timeout_s: float = 180.0,
        transport: str | None = None,
        hosts: list | None = None,
        host_label: str | None = None,
        registry: str | None = None,
        env: dict | None = None,
        metrics: PodMetrics | None = None,
        metrics_path: str | None = None,
        seed: int = 0,
        auto_start: bool = True,
    ):
        if isinstance(buckets, str):
            from wam_tpu_torch.config import ServeConfig

            buckets = ServeConfig(buckets=buckets).bucket_shapes()
        self.table = (buckets if isinstance(buckets, BucketTable)
                      else BucketTable(buckets))
        self._worker_argv = [str(a) for a in worker_argv]
        self.n_initial = int(workers)
        self.labeled = labeled
        if heartbeat_s is None:
            try:
                heartbeat_s = float(
                    os.environ.get(HEARTBEAT_ENV, "") or _DEFAULT_HEARTBEAT_S)
            except ValueError:
                heartbeat_s = _DEFAULT_HEARTBEAT_S
        self.heartbeat_s = heartbeat_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.ready_timeout_s = ready_timeout_s
        self.transport = _resolve_transport(transport)
        self.hosts = [str(h) for h in hosts] if hosts else None
        self.host_label = host_label or _socket.gethostname()
        self.registry = registry
        self._env = dict(env or {})
        self.metrics = metrics if metrics is not None else PodMetrics()
        self.metrics_path = metrics_path
        self.seed = seed

        self._lock = threading.Lock()
        # serializes score->choose->inflight-insert in _route_inner:
        # two client threads scoring concurrently both see the same
        # inflight counts and pick the same worker, so a 16-submit
        # burst lands 5/3 instead of 4/4 and the straggler waits out a
        # full extra batch cycle behind the overfull worker's queue
        self._route_lock = threading.Lock()
        self._workers: dict[int, _Worker] = {}
        self._wid_counter = itertools.count(0)
        self._req_ids = itertools.count(1)
        self._closed = False
        self._started = False
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._spawn_ema_s = _SPAWN_EMA_SEED_S
        self._host_rtt: dict[str, float] = {}  # host label -> RTT EMA (s)
        # host label -> lowest RTT seen (s): the congestion-free wire
        # cost. The EMA above is observability (how the path is doing);
        # ROUTING penalizes with the min — a loaded worker's heartbeat
        # RTT measures queueing, which the drain score already counts,
        # and double-counting it would starve busy-but-cheap hosts.
        self._host_rtt_min: dict[str, float] = {}
        self._wire_files: dict[str, bytes] | None = None  # lazy bundle
        self._authkey = secrets.token_bytes(16)
        self._listener = None  # Listener (pipe) or NetListener (tcp)
        self.address: str | None = None

        self._supervisor = None
        if supervise:
            cfg = supervise if isinstance(supervise, SupervisorConfig) else None
            self._supervisor = PodSupervisor(self._respawn_worker,
                                             self.metrics, cfg)
        self._autoscaler = None
        if autoscale is not None:
            from wam_tpu_torch.pod.autoscaler import AutoscalerLoop

            self._autoscaler = AutoscalerLoop(self, autoscale)
        if auto_start:
            self.start()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "PodRouter":
        if self._started:
            return self
        if self.transport == "tcp":
            from wam_tpu_torch.pod.netchannel import NetListener, format_address

            self._listener = NetListener(authkey=self._authkey)
            self.address = format_address(*self._listener.address)
        else:
            self._listener = Listener(("127.0.0.1", 0),
                                      authkey=self._authkey)
            host, port = self._listener.address
            self.address = f"{host}:{port}"
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="wam-pod-accept")
        t.start()
        with self._lock:
            self._threads.append(t)
        # first bring-up: spawn everything, then wait — warmups overlap
        pending = [self._spawn_worker(next(self._wid_counter))
                   for _ in range(self.n_initial)]
        for w in pending:
            self._await_ready(w)
        t = threading.Thread(target=self._heartbeat_loop, daemon=True,
                             name="wam-pod-heartbeat")
        t.start()
        with self._lock:
            self._threads.append(t)
        if self._autoscaler is not None:
            self._autoscaler.start()
        with self._lock:
            self._started = True
        return self

    def _worker_env(self) -> dict:
        env = {**os.environ, **self._env}
        env[AUTHKEY_ENV] = self._authkey.hex()
        return env

    def _host_for_wid(self, wid: int) -> str:
        """Spawn-time host assignment: round-robin over the configured
        host groups (stable per wid, so a respawn stays on its host)."""
        if self.hosts:
            return self.hosts[wid % len(self.hosts)]
        return self.host_label

    def _spawn_worker(self, wid: int, incarnation: int = 0) -> _Worker:
        """Launch one worker process and register its pending slot; the
        acceptor thread completes the handshake when its hello arrives."""
        host = self._host_for_wid(wid)
        w = _Worker(wid, incarnation, expected_host=host)
        with self._lock:
            self._workers[wid] = w
        argv = [a.replace("{wid}", str(wid)).replace("{host}", host)
                for a in self._worker_argv]
        argv += ["--connect", self.address, "--worker-id", str(wid)]
        w.t_spawn = time.perf_counter()
        # a fresh interpreter by exec, never a fork: this process may hold a
        # CUDA context, which a forked child cannot use
        w.proc = subprocess.Popen(argv, env=self._worker_env(),
                                  stdout=subprocess.DEVNULL)
        return w

    def _await_ready(self, w: _Worker) -> None:
        deadline = time.monotonic() + self.ready_timeout_s
        while not w.ready.wait(0.05):
            rc = w.proc.poll()
            if rc is not None:
                # a worker that exits during its start-up is a failed spawn
                # now, not a wait until the timeout
                raise RuntimeError(
                    f"pod worker {w.wid} (pid {w.proc.pid}) exited with code "
                    f"{rc} before it was ready")
            if time.monotonic() > deadline:
                try:
                    w.proc.kill()
                except OSError:
                    pass
                raise RuntimeError(
                    f"pod worker {w.wid} (pid {w.proc.pid}) did not become "
                    f"ready within {self.ready_timeout_s:g}s")
        spawn_s = time.perf_counter() - w.t_spawn
        with self._lock:
            self._spawn_ema_s = 0.7 * self._spawn_ema_s + 0.3 * spawn_s
        extra = {}
        d = w.device_ready or {}
        if "t_kernels" in d:
            # a worker on a card: where its start-up went, from its stamps
            # (one host's monotonic clock, so comparable with t_spawn)
            extra["startup_s"] = {
                "interpreter_and_imports": d["t_main"] - w.t_spawn,
                "cuda_context": d["t_cuda"] - d["t_main"],
                "kernel_libraries": d["t_kernels"] - d["t_cuda"],
                "fleet_warmup": d["t_ready"] - d["t_kernels"],
            }
            extra["peak_memory_bytes"] = d["peak_memory_bytes"]
            extra["kernel_launches"] = d["kernel_launches"]
        self.metrics.note_worker_ready(w.wid, w.incarnation, w.snapshot,
                                       spawn_s=spawn_s, **extra)

    def _respawn_worker(self, wid: int) -> None:
        """Supervisor restart procedure: spawn a fresh incarnation (same
        argv — including any ``--registry`` bundle, so the rejoin
        hydrates instead of recompiling) and block until it is warm."""
        with self._lock:
            if self._closed:
                raise ServerClosedError("pod closed during worker respawn")
            prev = self._workers.get(wid)
            incarnation = (prev.incarnation + 1) if prev is not None else 0
        if prev is not None and prev.proc is not None:
            # the dead incarnation's device memory comes back only when its
            # process is gone: admit the new one after that (and reap it)
            try:
                prev.proc.wait(self.ready_timeout_s)
            except subprocess.TimeoutExpired:
                prev.proc.kill()
                prev.proc.wait()
        w = self._spawn_worker(wid, incarnation)
        self._await_ready(w)

    def _accept_loop(self) -> None:
        """Accept connections and hand each to its own preface thread —
        a worker that streams the registry bundle and warms for seconds
        before saying hello must not serialize every OTHER worker's
        bring-up behind it."""
        while not self._stop.is_set():
            try:
                conn = self._listener.accept()
            except (OSError, EOFError):
                return  # listener closed
            chan = conn if self.transport == "tcp" else Channel(conn)
            t = threading.Thread(target=self._preface_loop, args=(chan,),
                                 daemon=True, name="wam-pod-preface")
            t.start()
            with self._lock:
                self._threads.append(t)

    def _preface_loop(self, chan) -> None:
        """One fresh connection: serve pre-hello registry probes, then
        register the worker when its hello arrives."""
        msg = None
        try:
            for _ in range(_MAX_PREFACE_MSGS):
                msg = chan.recv()
                if msg.get("op") != "registry_probe":
                    break
                files = self._load_wire_files()
                with obs_tracing.span(
                        "registry_stream", cat="pod",
                        files=len(files),
                        bytes=sum(len(v) for v in files.values())):
                    chan.send({"op": "registry_bundle", "files": files})
                self.metrics.note_registry_stream(
                    sum(len(v) for v in files.values()))
        except (OSError, EOFError):
            chan.close()
            return
        if not isinstance(msg, dict) or msg.get("op") != "hello":
            chan.close()
            return
        wid = msg.get("worker_id")
        with self._lock:
            w = self._workers.get(wid)
        if w is None or w.ready.is_set():
            chan.close()
            return
        w.chan = chan
        w.snapshot = msg.get("snapshot")
        w.device_stats = w.device_ready = msg.get("device")
        w.snapshot_t = time.monotonic()
        w.host = msg.get("host") or w.expected_host
        hs_rtt = getattr(chan, "handshake_rtt_s", None)
        if hs_rtt is not None:
            # the HMAC proof round-trip is a free RTT sample: seed the
            # host EMA and the clock offset so host-aware routing and
            # the trace merge have signal before the first heartbeat
            self._note_rtt(w, hs_rtt)
            if w.snapshot is not None:
                w.clock_offset_s = (time.perf_counter() - hs_rtt / 2.0
                                    - w.snapshot.t_worker)
        w.last_reply = time.monotonic()
        w.alive = True
        t = threading.Thread(target=self._receive_loop, args=(w,),
                             daemon=True,
                             name=f"wam-pod-recv-{wid}")
        t.start()
        with self._lock:
            self._threads.append(t)
        w.ready.set()

    def _load_wire_files(self) -> dict:
        """The registry bundle as {relpath: bytes}, read once and cached
        — what ``registry_probe`` streams (raw byte frames on the tcp
        transport; nothing re-reads the directory per worker)."""
        with self._lock:
            if self._wire_files is not None:
                return self._wire_files
        files: dict[str, bytes] = {}
        if self.registry:
            base = os.path.abspath(self.registry)
            for dirpath, _, names in os.walk(base):
                for name in sorted(names):
                    path = os.path.join(dirpath, name)
                    rel = os.path.relpath(path, base).replace(os.sep, "/")
                    try:
                        with open(path, "rb") as fh:
                            files[rel] = fh.read()
                    except OSError:
                        continue  # torn/vanished file: per-artifact miss
        with self._lock:
            if self._wire_files is None:
                self._wire_files = files
            return self._wire_files

    def _note_rtt(self, w: _Worker, rtt_s: float) -> None:
        host = w.host or w.expected_host
        with self._lock:
            prev = self._host_rtt.get(host)
            ema = (rtt_s if prev is None
                   else (1.0 - _RTT_EMA_ALPHA) * prev + _RTT_EMA_ALPHA * rtt_s)
            self._host_rtt[host] = ema
            prev_min = self._host_rtt_min.get(host)
            self._host_rtt_min[host] = (rtt_s if prev_min is None
                                        else min(prev_min, rtt_s))
        self.metrics.note_host_rtt(host, ema)

    def close(self, emit_metrics: bool = True) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        if self._autoscaler is not None:
            self._autoscaler.close()
        if self._supervisor is not None:
            self._supervisor.close()
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            w.closing = True
            if w.alive and w.chan is not None:
                try:
                    w.chan.send({"op": "close"})
                except OSError:
                    pass
        deadline = time.monotonic() + 30.0
        for w in workers:
            if w.proc is not None:
                try:
                    w.proc.wait(max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    w.proc.kill()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        if emit_metrics and self.metrics_path:
            from wam_tpu_torch.results import JsonlWriter

            self.metrics.emit(JsonlWriter(self.metrics_path),
                              config=self.describe(), workers=workers,
                              hosts=self.host_summary())
        with self._lock:
            self._started = False

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    def describe(self) -> dict:
        with self._lock:
            workers = list(self._workers.values())
        return {
            "pod_workers": len([w for w in workers if w.alive]),
            "workers_total": len(workers),
            "buckets": [list(b.shape) for b in self.table],
            "labeled": self.labeled,
            "supervised": self._supervisor is not None,
            "autoscaled": self._autoscaler is not None,
            "heartbeat_s": self.heartbeat_s,
            "transport": self.transport,
            "host_label": self.host_label,
            "hosts": self.hosts,
            "wire_registry": bool(self.registry),
            "worker_argv": self._worker_argv,
        }

    # -- health plane -------------------------------------------------------

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            now = time.monotonic()
            with self._lock:
                # closing workers are retiring on purpose: their exit is
                # the receive loop's EOF to handle, not a death to flag
                workers = [w for w in self._workers.values()
                           if w.alive and not w.closing]
            for w in workers:
                rc = w.proc.poll() if w.proc is not None else None
                if rc is not None:
                    self._mark_dead(w, f"exit code {rc}")
                    continue
                if now - w.last_reply > self.heartbeat_timeout_s:
                    self._mark_dead(
                        w, f"heartbeat silence > {self.heartbeat_timeout_s:g}s")
                    try:
                        w.proc.kill()  # unresponsive but running: fence it
                    except OSError:
                        pass
                    continue
                if (w.health_pending_t is not None
                        and now - w.health_pending_t
                        < self.heartbeat_timeout_s):
                    # probe still unanswered: coalesce — a worker busy
                    # with a batch answers ONE probe when it surfaces,
                    # not a backlog of stale ones (death detection rides
                    # last_reply silence either way)
                    self.metrics.note_heartbeat_coalesced()
                    continue
                w.health_pending_t = now
                try:
                    w.chan.send({"op": "health", "t_send": time.perf_counter()})
                except OSError:
                    self._mark_dead(w, "control channel write failed")
            self.metrics.publish_gauges(self._live_snapshots())

    def _live_snapshots(self):
        with self._lock:
            return [w.snapshot for w in self._workers.values()
                    if w.alive and w.snapshot is not None]

    def _receive_loop(self, w: _Worker) -> None:
        while True:
            try:
                msg = w.chan.recv()
            except (EOFError, OSError):
                break
            op = msg.get("op")
            if op == "result":
                self._on_result(w, msg)
            elif op == "health_reply":
                now = time.perf_counter()
                rtt = now - msg["t_send"]
                if rtt < w.best_rtt_s:
                    # midpoint estimate from the tightest round-trip seen
                    w.best_rtt_s = rtt
                    w.clock_offset_s = (msg["t_send"] + rtt / 2.0
                                        - msg["t_worker"])
                self._note_rtt(w, rtt)
                w.snapshot = msg["snapshot"]
                w.snapshot_t = time.monotonic()
                w.last_reply = time.monotonic()
                w.health_pending_t = None
                if msg.get("device") is not None:
                    w.device_stats = msg["device"]
            elif op == "bye":
                w.final_snapshot = msg.get("snapshot")
                w.spans = msg.get("spans") or []
                if msg.get("device") is not None:
                    w.device_stats = msg["device"]
                if w.final_snapshot is not None:
                    self.metrics.note_worker_final(
                        w.wid, w.incarnation, w.final_snapshot)
        if not w.closing:
            self._mark_dead(w, "control channel EOF")
            return
        # router-initiated retirement (shrink drain or pod close): not a
        # death — but anything the worker still held must not strand
        with self._lock:
            w.alive = False
        with w.inflight_lock:
            orphans = list(w.inflight.values())
            w.inflight.clear()
        for req in orphans:
            req.tried.add(w.wid)
            self._route(req, raise_errors=False)

    def _mark_dead(self, w: _Worker, reason: str) -> None:
        """Worker death: re-route everything it held, tell the
        supervisor. Idempotent per incarnation (EOF, heartbeat timeout,
        and exit-code detection race — first signal wins)."""
        with self._lock:
            if not w.alive:
                return
            w.alive = False
        self.metrics.note_worker_death(w.wid, reason,
                                       snapshot=w.snapshot)
        with w.inflight_lock:
            orphans = list(w.inflight.values())
            w.inflight.clear()
        for req in orphans:
            req.tried.add(w.wid)
            self._route(req, raise_errors=False)
        if (self._supervisor is not None and not self._closed
                and not w.draining):
            self._supervisor.notify_death(w.wid, reason)

    def kill_worker(self, wid: int) -> bool:
        """SIGKILL one worker process (the pod-chaos hook —
        `testing.faults.PodChaosKiller` drives it). Returns whether a
        live worker was killed. Death detection, re-route, and respawn
        all go through the normal paths: a chaos kill is
        indistinguishable from a real one by design."""
        with self._lock:
            w = self._workers.get(wid)
        if w is None or not w.alive or w.killed or w.proc is None:
            return False
        try:
            w.proc.kill()
        except OSError:
            return False
        # a process takes a while to die after SIGKILL (a CUDA context's
        # teardown): until its death is seen, it must not be picked again
        w.killed = True
        return True

    def kill_host(self, host: str) -> list[int]:
        """SIGKILL every live worker on one host label — the host-level
        chaos fault (rack loss, host OOM, a pulled network cable as far
        as this router can tell). Detection, in-flight re-route, and
        supervised respawn all run the per-worker death paths; returns
        the wids killed."""
        with self._lock:
            victims = [w for w in self._workers.values()
                       if w.alive and not w.killed and self._worker_host(w) == host]
        killed = []
        for w in victims:
            if w.proc is None:
                continue
            try:
                w.proc.kill()
            except OSError:
                continue
            w.killed = True
            killed.append(w.wid)
        return killed

    def live_worker_ids(self) -> list[int]:
        with self._lock:
            return sorted(w.wid for w in self._workers.values()
                          if w.alive and not w.draining and not w.killed)

    def live_hosts(self) -> list[str]:
        with self._lock:
            return sorted({self._worker_host(w)
                           for w in self._workers.values()
                           if w.alive and not w.draining and not w.killed})

    # -- autoscaler surface -------------------------------------------------

    def grow(self) -> int:
        """Add one worker (autoscaler grow). Returns its wid."""
        wid = next(self._wid_counter)
        w = self._spawn_worker(wid)
        self._await_ready(w)
        return wid

    def shrink(self) -> int | None:
        """Gracefully retire the least-loaded live worker (autoscaler
        shrink): stop routing to it, let it drain, and do NOT treat its
        exit as a death. Returns the wid, or None when nothing shrinks."""
        with self._lock:
            cands = [w for w in self._workers.values()
                     if w.alive and not w.draining]
            if len(cands) <= 1:
                return None
            w = min(cands, key=lambda w: (len(w.inflight), w.wid))
            w.draining = True
            w.closing = True
        try:
            w.chan.send({"op": "close"})
        except OSError:
            pass
        return w.wid

    # -- canary plane -------------------------------------------------------

    def pin_canary(self, fingerprint: str, *, overrides=None) -> list[int]:
        """Broadcast an online-tuner challenger pin to every live worker:
        each worker pins ONE of its fleet replicas to the challenger
        schedule (`FleetServer.pin_canary`), so the canary slice spans the
        whole pod at the same per-worker blast radius. Best-effort —
        single-replica workers skip the pin on their side. Returns the
        wids the pin reached."""
        return self._broadcast_canary(fingerprint, overrides)

    def clear_canary(self) -> list[int]:
        """End the schedule A/B on every live worker (champion-only
        routing resumes; override-built canary replicas rebuild)."""
        return self._broadcast_canary(None, None)

    def _broadcast_canary(self, fingerprint, overrides) -> list[int]:
        with self._lock:
            workers = [w for w in self._workers.values()
                       if w.alive and not w.draining and w.chan is not None]
        reached = []
        for w in workers:
            try:
                w.chan.send({"op": "canary", "fingerprint": fingerprint,
                             "overrides": overrides})
            except OSError:
                continue  # death paths will handle it
            reached.append(w.wid)
        return reached

    # -- client side --------------------------------------------------------

    def submit(self, x, y=None, deadline_ms: float | None = None,
               qos: str = "interactive", model: str | None = None,
               tenant: str | None = None) -> Future:
        """Admit one item and route it to the best live worker. ``qos``
        rides the wire to the worker fleet's admission lanes (and weighs
        into routing via each worker's heartbeat ``qos_depth``); so do
        ``model`` (a paged-model id, validated worker-side, weighed into
        routing via heartbeat ``models_resident``) and ``tenant`` (the
        fair-share lane / cache-partition key). The
        returned future survives worker death by re-routing; it fails
        typed (`QueueFullError` / `NoLiveWorkerError` / deadline) when
        the pod genuinely cannot take the work."""
        if self.labeled and y is None:
            raise ValueError("labeled pod: submit(x, y) needs a class label")
        if not self.labeled and y is not None:
            raise ValueError("unlabeled pod: submit() must not carry a label")
        x = np.asarray(x, np.float32)
        bucket = self.table.select(x.shape)  # NoBucketError pre-queue
        now = time.perf_counter()
        deadline_at = now + deadline_ms / 1e3 if deadline_ms else None
        req = _PodRequest(next(self._req_ids), x, y, bucket_key(bucket.shape),
                          deadline_at, Future(), now, qos=qos, model=model,
                          tenant=tenant)
        if obs_tracing._STATE.enabled:
            root = obs_tracing.start_span("request", cat="pod",
                                          bucket=req.bkey)
            req.ctx = root.context
            req.future.add_done_callback(
                lambda f: root.end(
                    error=type(f.exception()).__name__ if f.exception()
                    else None))
            try:
                self._route(req, raise_errors=True)
            except Exception as e:
                root.end(error=type(e).__name__)
                raise
        else:
            self._route(req, raise_errors=True)
        return req.future

    def attribute(self, x, y=None, deadline_ms: float | None = None,
                  qos: str = "interactive", model: str | None = None,
                  tenant: str | None = None):
        return self.submit(x, y, deadline_ms=deadline_ms, qos=qos,
                           model=model, tenant=tenant).result()

    def submit_with_retry(self, x, y=None, *, policy=None, stats=None,
                          rng=None, deadline_ms: float | None = None) -> Future:
        """`submit` driven by a `serve.retry.RetryPolicy` (the
        `FleetServer.submit_with_retry` discipline one level up). Pass a
        policy whose ``retry_on`` includes `NoLiveWorkerError` to ride
        out total-outage windows during supervised respawns."""
        from wam_tpu_torch.serve.retry import RetryPolicy

        policy = policy if policy is not None else RetryPolicy()
        outer: Future = Future()

        def _submit(remaining_s):
            per_attempt = deadline_ms
            if remaining_s is not None:
                rem_ms = remaining_s * 1e3
                per_attempt = (rem_ms if per_attempt is None
                               else min(per_attempt, rem_ms))
            return self.submit(x, y, deadline_ms=per_attempt)

        def _drive():
            try:
                outer.set_result(policy.run(_submit, rng=rng, stats=stats))
            except BaseException as e:  # noqa: BLE001 - future carries it
                outer.set_exception(e)

        threading.Thread(target=_drive, daemon=True,
                         name="wam-pod-retry").start()
        return outer

    # -- routing ------------------------------------------------------------

    def _worker_host(self, w: _Worker) -> str:
        return w.host or w.expected_host

    def _respawn_hints_by_host(self) -> dict:
        """host label -> seconds until that host plausibly serves again
        (its soonest pending respawn's backoff ETA + the spawn-time
        EMA). Only hosts with an in-flight respawn appear."""
        if self._supervisor is None:
            return {}
        with self._lock:
            by_host: dict[str, list[int]] = {}
            for w in self._workers.values():
                by_host.setdefault(self._worker_host(w), []).append(w.wid)
            spawn_ema = self._spawn_ema_s
        hints = {}
        for host, wids in by_host.items():
            eta = self._supervisor.pending_eta_s(wids=wids)
            if eta is not None:
                hints[host] = max(0.0, eta) + spawn_ema
        return hints

    def _respawn_hint_s(self) -> float | None:
        """How long until SOME host is plausibly serving again: the
        per-host respawn ETAs min-reduced across hosts. None when
        unsupervised (nobody is coming back)."""
        if self._supervisor is None:
            return None
        hints = self._respawn_hints_by_host()
        if hints:
            return min(hints.values())
        if not self._supervisor.any_restartable():
            return None
        with self._lock:
            return self._spawn_ema_s

    def _score(self, w: _Worker, bkey: str,
               model: str | None = None) -> float:
        s = w.snapshot
        if s is None:
            return float("inf")
        ema = s.ema_service_s.get(f"{model}|{bkey}" if model else bkey,
                                  s.ema_service_s.get(bkey))
        if ema is None:
            ema = (sum(s.ema_service_s.values()) / len(s.ema_service_s)
                   if s.ema_service_s else EMA_SEED_S)
        with w.inflight_lock:
            inflight = len(w.inflight)
        # heartbeat-reported queued-interactive depth weighs extra, the
        # same discipline the in-process fleet applies per replica
        # (serve.fleet.INTERACTIVE_DEPTH_WEIGHT) lifted one tier up
        interactive_depth = (s.qos_depth or {}).get("interactive", 0)
        # age the drain estimate: a worker that reported 80ms of queue
        # 80ms ago has worked it off by now.  Without the decay a
        # just-freed worker keeps its stale mid-batch drain and loses
        # routes to a mid-batch peer whose heartbeat predates its batch
        # (drain 0), parking requests behind a live batch for a full
        # extra service cycle.  Work routed since the snapshot is the
        # inflight term's job, so decaying only the reported drain
        # cannot under-count.
        drain = max(0.0, s.projected_drain_s
                    - (time.monotonic() - w.snapshot_t))
        score = (drain + inflight * ema + s.slo_penalty_s
                 + INTERACTIVE_DEPTH_WEIGHT * interactive_depth * ema)
        # paged-model affinity: a worker whose fleet already holds the
        # model resident skips the page-in stall, same discipline the
        # in-process fleet applies per replica (serve.fleet)
        if model is not None and model not in (s.models_resident or {}):
            score += MODEL_PAGEIN_PENALTY_S
        return score

    def _route(self, req: _PodRequest, raise_errors: bool) -> None:
        def _fail(exc: Exception) -> None:
            if raise_errors:
                raise exc
            req.future.set_exception(exc)

        with obs_tracing.use_context(req.ctx), obs_tracing.span(
            "pod_admission", cat="pod", rerouted=bool(req.tried)
        ):
            return self._route_inner(req, _fail)

    def _route_inner(self, req: _PodRequest, _fail) -> None:
        with self._lock:
            if self._closed:
                return _fail(ServerClosedError("pod is not accepting requests"))
            cands = [w for w in self._workers.values()
                     if w.alive and not w.draining and w.ready.is_set()
                     and w.wid not in req.tried]
        if not cands:
            if req.retry_after_by_host:
                # every live worker rejected: per-host tightest
                # estimates, min-reduced ACROSS hosts — and a dead
                # host's respawn ETA competes too, in case the pod is
                # back before any live host drains
                ra = min(req.retry_after_by_host.values())
                hints = self._respawn_hints_by_host()
                if hints:
                    ra = min(ra, min(hints.values()))
                return _fail(QueueFullError(ra))
            return _fail(NoLiveWorkerError(
                "no live pod worker left for this request",
                retry_after_s=self._respawn_hint_s()))
        if req.deadline_at is not None:
            remaining_ms = (req.deadline_at - time.perf_counter()) * 1e3
            if remaining_ms <= 0.0:
                return _fail(
                    DeadlineExceededError("deadline lapsed during re-route"))
        else:
            remaining_ms = None
        with self._lock:
            host_rtt = dict(self._host_rtt_min)

        def _key(w: _Worker):
            host = self._worker_host(w)
            local = host == self.host_label
            s = w.snapshot
            # a heartbeat-reported full queue means this hop will bounce
            # with QueueFullError — now a network round-trip, so workers
            # with room (on any host) come first
            full = s is not None and s.queue_free == 0
            # locality is a SCORE penalty, not a hard tier: a remote
            # worker wins exactly when it is cheaper by more than the
            # wire (that host's congestion-free MIN RTT — queueing is
            # the drain term's job). A hard tier would starve remote
            # hosts whenever local workers merely have queue room.
            penalty = 0.0 if local else host_rtt.get(host, 0.0)
            return (full, self._score(w, req.bkey, req.model) + penalty,
                    w.wid)

        while cands:
            # score->choose->inflight-insert is atomic under _route_lock
            # so concurrent submits see each other's inflight and a
            # burst spreads evenly; the send itself happens outside so
            # payload writes to different workers still overlap
            with self._route_lock:
                cands.sort(key=_key)
                quarantined = {
                    w.wid: (w.snapshot.quarantined if w.snapshot else False)
                    for w in cands}
                if any(quarantined.values()):
                    cands = ([w for w in cands if not quarantined[w.wid]]
                             + [w for w in cands if quarantined[w.wid]])
                chosen = None
                for w in cands:
                    with w.inflight_lock:
                        if not w.alive:
                            continue
                        w.inflight[req.req_id] = req
                    chosen = w
                    break
            if chosen is None:
                break
            try:
                chosen.chan.send({
                    "op": "submit", "req_id": req.req_id, "x": req.x,
                    "y": req.y, "deadline_ms": remaining_ms, "ctx": req.ctx,
                    "qos": req.qos, "model": req.model, "tenant": req.tenant,
                })
            except (OSError, AttributeError):
                # died between the candidate snapshot and the send: undo
                # and fall through to the next candidate (its death path
                # runs via the receiver/heartbeat threads)
                with chosen.inflight_lock:
                    chosen.inflight.pop(req.req_id, None)
                cands.remove(chosen)
                continue
            return
        return _fail(NoLiveWorkerError(
            "every live pod worker refused this request",
            retry_after_s=self._respawn_hint_s()))

    def _on_result(self, w: _Worker, msg: dict) -> None:
        with w.inflight_lock:
            req = w.inflight.pop(msg["req_id"], None)
        if req is None:
            return  # already re-routed by a racing death path
        if msg.get("ok"):
            self.metrics.note_request(time.perf_counter() - req.t_submit)
            req.future.set_result(msg.get("value"))
            return
        exc = decode_error(msg.get("error") or {})
        if isinstance(exc, QueueFullError):
            # worker-level backpressure: try the rest of the pod, keeping
            # the smallest retry_after PER HOST (the terminal error
            # min-reduces across hosts — fleet aggregation one tier up)
            req.tried.add(w.wid)
            ra = getattr(exc, "retry_after_s", None) or 0.0
            host = self._worker_host(w)
            cur = req.retry_after_by_host.get(host)
            req.retry_after_by_host[host] = (ra if cur is None
                                             else min(cur, ra))
            self._route(req, raise_errors=False)
            return
        if isinstance(exc, ServerClosedError):
            # the WORKER's fleet closed under the request (its own
            # supervisor restarting a replica, or shutdown racing in):
            # liveness, not semantics — re-route
            req.tried.add(w.wid)
            self._route(req, raise_errors=False)
            return
        req.future.set_exception(exc)

    # -- reporting ----------------------------------------------------------

    def pod_summary(self) -> dict:
        with self._lock:
            workers = list(self._workers.values())
        return self.metrics.pod_summary(workers)

    def host_summary(self) -> list[dict]:
        """One row per host group: worker counts, completed work, the
        RTT estimates (EMA for path health, min for the routing
        penalty), and any pending respawn ETA — the ``pod_host``
        ledger rows."""
        with self._lock:
            workers = list(self._workers.values())
            host_rtt = dict(self._host_rtt)
            host_rtt_min = dict(self._host_rtt_min)
        hints = self._respawn_hints_by_host()
        rows: dict[str, dict] = {}
        for w in sorted(workers, key=lambda w: w.wid):
            host = self._worker_host(w)
            row = rows.setdefault(host, {
                "host": host,
                "local": host == self.host_label,
                "workers": 0,
                "alive": 0,
                "completed": 0,
                "rtt_ema_s": host_rtt.get(host),
                "rtt_min_s": host_rtt_min.get(host),
                "respawn_eta_s": hints.get(host),
            })
            row["workers"] += 1
            row["alive"] += int(w.alive)
            s = w.final_snapshot if w.final_snapshot is not None else w.snapshot
            if s is not None:
                row["completed"] += s.completed
        return list(rows.values())

    def trace_events(self) -> list[dict]:
        """Worker spans shipped at close, re-based onto the router's
        perf_counter via each worker's heartbeat clock offset — ready for
        `obs.export_chrome_trace(path, extra_events=...)`."""
        events: list[dict] = []
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            if not w.spans:
                continue
            pid = (w.final_snapshot.pid if w.final_snapshot is not None
                   else (w.proc.pid if w.proc is not None else -w.wid))
            host = self._worker_host(w)
            name = f"pod-worker-{w.wid}"
            if host != self.host_label:
                # cross-host worker: carry the host in the Perfetto
                # process label so one merged trace reads as a pod map
                name += f"@{host}"
            events.extend(obs_tracing.spans_to_events(
                w.spans, pid=pid, clock_offset_s=w.clock_offset_s,
                process_name=name))
        return events
