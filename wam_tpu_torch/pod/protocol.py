"""Router <-> worker control channel (pod tentpole, transport layer).

One pod = one front-door router process + N independent fleet worker
processes. The message grammar here is TRANSPORT-INDEPENDENT — plain
dicts keyed by ``op`` — and two wire encodings speak it:

- ``tcp://host:port``: the framed-TCP
  transport (`pod.transport` + `pod.netchannel`) — length-prefixed
  binary frames where ndarray payloads ride as raw zero-copy buffer
  frames (header carries shape/dtype; NO pickle on the array path),
  mutually HMAC-authenticated via the same `AUTHKEY_ENV` secret.
- bare ``host:port``: the legacy `multiprocessing.connection` pipe
  (length-prefixed pickle frames over loopback TCP), kept behind
  ``WAM_TPU_POD_TRANSPORT=pipe`` as the fallback.

Either way the authkey reaches workers through the environment — never
argv, which is world-readable in /proc — and each side serializes
sends through a lock while one dedicated receiver thread per
connection drains the other direction.

Message grammar::

    worker -> router   {"op": "registry_probe", worker_id}
    router -> worker   {"op": "registry_bundle", files}
    worker -> router   {"op": "hello", worker_id, pid, host, snapshot,
                        buckets}
    router -> worker   {"op": "submit", req_id, x, y, deadline_ms, qos,
                        model, tenant, ctx}
    worker -> router   {"op": "result", req_id, ok, value | error}
    router -> worker   {"op": "health", t_send}
    worker -> router   {"op": "health_reply", t_send, t_worker, snapshot}
    router -> worker   {"op": "canary", fingerprint | None, overrides}
    router -> worker   {"op": "close"}
    worker -> router   {"op": "bye", snapshot, spans}

``registry_probe`` is the one PRE-hello exchange: a freshly connected
worker (spawned with ``--registry wire``) asks for the pod's
compile-artifact bundle and hydrates from the streamed ``files``
(relpath -> raw bytes frames) BEFORE warmup, so a cold host joins at
``compile_count == 0`` without sharing a filesystem with the router.
``hello`` is sent AFTER the worker's fleet warmed — readiness and
liveness are the same signal. ``canary`` pins (fingerprint + optional
server-kw overrides) or clears (fingerprint None) a schedule-A/B canary
replica inside the worker's fleet (`FleetServer.pin_canary`) — how the
online tuner's challenger reaches every worker in a pod. ``health_reply`` echoes the router's
``t_send`` so the router can estimate the worker's perf_counter clock
offset from the round-trip (spans shipped at ``bye`` are re-based onto
the router's timebase with it; `wam_tpu_torch.obs.tracing.spans_to_events`).

Errors cross the boundary as plain dicts (``encode_error`` /
``decode_error``), NOT pickled exception objects: the serve taxonomy's
constructors take positional estimates (`QueueFullError(retry_after_s)`)
that default pickling mangles, and an unknown class must degrade to a
typed `PodWorkerError` instead of an unpickling crash. ``retry_after_s``
survives the round-trip — the router aggregates worker backpressure
fleet-style, so the estimate is load-bearing.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from multiprocessing.connection import Client, Connection

__all__ = [
    "AUTHKEY_ENV",
    "Channel",
    "PodWorkerError",
    "WorkerSnapshot",
    "connect_to_router",
    "decode_error",
    "encode_error",
]

# worker-side: hex authkey for the router's Listener (set by the router
# in the spawned worker's environment)
AUTHKEY_ENV = "WAM_TPU_POD_AUTHKEY"


class PodWorkerError(RuntimeError):
    """A worker-side failure whose concrete class could not be
    reconstructed on the router side (unknown/foreign exception type)."""


@dataclass
class WorkerSnapshot:
    """One worker's health-plane signals as shipped over the channel —
    the same quantities the in-process fleet routes on
    (`FleetServer.pod_signals`), plus process identity and the compile
    sentinels the zero-compile-respawn acceptance reads."""

    worker_id: int
    pid: int
    t_worker: float  # worker perf_counter at snapshot time
    projected_drain_s: float = 0.0
    ema_service_s: dict = field(default_factory=dict)  # bucket key -> s
    qos_depth: dict = field(default_factory=dict)  # QoS class -> queued items
    # free admission slots across live replicas; 0 = a submit would
    # bounce QueueFull, and the router deprioritizes the hop (a reject
    # costs a cross-host round-trip on the tcp transport). -1 = unknown
    # (a worker that does not report it).
    queue_free: int = -1
    # result-cache hit fraction of admitted traffic; a hot cache absorbs
    # load without queueing, so the autoscaler discounts drain by it
    # before growing. -1 = unknown (a worker that does not report it).
    cache_hit_rate: float = -1.0
    slo_penalty_s: float = 0.0
    quarantined: bool = False  # EVERY live replica quarantined
    live_replicas: int = 1
    dead_replicas: int = 0
    submitted: int = 0
    completed: int = 0
    compile_count: int = 0
    post_warm_compiles: int = 0
    warm_s: float = 0.0  # wall time from process start to ready
    # paged models resident on this worker's fleet (model_id -> bytes);
    # empty = none resident OR a worker that does not report it
    models_resident: dict = field(default_factory=dict)


def encode_error(exc: Exception) -> dict:
    """Exception -> wire dict. Carries the class name, message, and the
    backpressure estimate when the error has one."""
    row = {"type": type(exc).__name__, "message": str(exc)}
    retry_after = getattr(exc, "retry_after_s", None)
    if retry_after is not None:
        row["retry_after_s"] = float(retry_after)
    return row


def decode_error(row: dict) -> Exception:
    """Wire dict -> the matching serve-taxonomy exception (retry_after_s
    re-attached), or `PodWorkerError` for types this side does not know."""
    from wam_tpu_torch.serve.fleet import NoLiveReplicaError
    from wam_tpu_torch.serve.runtime import (
        DeadlineExceededError,
        MemoryAdmissionError,
        QueueFullError,
        ServerClosedError,
        ServeError,
        WorkerCrashedError,
    )

    name = row.get("type", "")
    msg = row.get("message", "")
    retry_after = row.get("retry_after_s")
    if name == "QueueFullError":
        return QueueFullError(retry_after if retry_after is not None else 0.0)
    if name == "MemoryAdmissionError":
        return MemoryAdmissionError(
            retry_after if retry_after is not None else 0.0)
    if name == "NoLiveReplicaError":
        return NoLiveReplicaError(msg, retry_after_s=retry_after)
    simple = {
        "DeadlineExceededError": DeadlineExceededError,
        "ServerClosedError": ServerClosedError,
        "WorkerCrashedError": WorkerCrashedError,
        "ServeError": ServeError,
        "NoBucketError": None,  # resolved below (buckets import)
    }
    if name == "NoBucketError":
        from wam_tpu_torch.serve.buckets import NoBucketError

        return NoBucketError(msg)
    cls = simple.get(name)
    if cls is not None:
        return cls(msg)
    err = PodWorkerError(f"{name}: {msg}")
    if retry_after is not None:
        err.retry_after_s = retry_after
    return err


class Channel:
    """One authenticated connection with a send lock. ``send`` may be
    called from any thread; ``recv`` belongs to exactly one receiver
    thread (the multiprocessing.Connection contract)."""

    def __init__(self, conn: Connection):
        self._conn = conn
        self._send_lock = threading.Lock()
        self._closed = False

    def send(self, msg: dict) -> None:
        with self._send_lock:
            self._conn.send(msg)

    def recv(self) -> dict:
        return self._conn.recv()

    def close(self) -> None:
        self._closed = True
        try:
            self._conn.close()
        except OSError:
            pass

    @property
    def closed(self) -> bool:
        return self._closed


def connect_to_router(address: str):
    """Worker-side dial. The address carries its transport:
    ``tcp://host:port`` speaks the framed zero-copy transport
    (`pod.netchannel`), a bare ``host:port`` the legacy
    multiprocessing pipe. The authkey comes from the environment
    either way (`AUTHKEY_ENV`, hex)."""
    key_hex = os.environ.get(AUTHKEY_ENV, "")
    if not key_hex:
        raise RuntimeError(
            f"worker has no {AUTHKEY_ENV} in its environment — pod workers "
            "must be spawned by a PodRouter (or a test setting the key)")
    if address.startswith("tcp://"):
        from wam_tpu_torch.pod.netchannel import connect_tcp

        return connect_tcp(address, bytes.fromhex(key_hex))
    host, _, port = address.rpartition(":")
    conn = Client((host or "127.0.0.1", int(port)),
                  authkey=bytes.fromhex(key_hex))
    return Channel(conn)
