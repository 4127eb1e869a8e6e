"""Pod worker process: one `FleetServer` behind a control channel.

``python -m wam_tpu_torch.pod.worker --connect HOST:PORT --worker-id K ...``
is what `wam_tpu_torch.pod.router.PodRouter` spawns N times. Each worker is
a full, independent failure domain: its own Python process, its own CUDA
context and caching allocator, its own `FleetServer` (replica supervision,
health plane, SLO tracking, registry hydration all included) — a SIGKILL
here costs the pod one worker, not the service.

Lifecycle:

1. Device select. ``--device`` defaults to ``auto``: the current CUDA
   device, or an error when there is none (`device.resolve_device`); the
   CPU runs only on ``--device cpu``. On a card the kernels' libraries are
   built (under the build directory's lock, `kernels.build_all`) and
   loaded here, before warmup: nothing is built on the serving path, and
   two workers starting together on a fresh checkout build once.
2. Optional multi-host bring-up: ``--coordinator`` routes through
   `parallel.multihost.init_distributed` (bounded connect retries,
   coordinator named in the timeout error).
3. Build + warm the fleet. ``--registry BUNDLE`` hydrates compiled
   artifacts before warmup — this is what makes a supervisor respawn
   rejoin at zero compiles instead of compiling everything again.
4. Dial the router, send ``hello`` (readiness == liveness), then serve
   the channel: ``submit`` ops run under the router's trace context so
   worker-side spans join the request's cross-process timeline,
   ``health`` ops answer with a `WorkerSnapshot` on this (the channel's)
   thread, never the serving thread, so a worker busy in a batch still
   answers, and ``close`` drains and ships the span ring back for the
   merged trace export.

Results cross the wire as the numpy rows the serve runtime fetched
(`evalsuite.fan.device_fetch`: a bfloat16 result arrives as float32, which
numpy has a dtype for), so a frame never carries a tensor.

The span-id counter is namespaced by pid (`obs.tracing.namespace_ids`)
so ids minted here never collide with the router's when the traces merge.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from wam_tpu_torch.pod.protocol import (
    WorkerSnapshot,
    connect_to_router,
    encode_error,
)

__all__ = ["main", "build_worker_server", "toy_wam"]


def _parse(argv):
    p = argparse.ArgumentParser(
        prog="wam_tpu_torch.pod.worker", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--connect", required=True, metavar="HOST:PORT",
                   help="router control-channel address")
    p.add_argument("--worker-id", type=int, required=True)
    p.add_argument("--device", default="auto",
                   help="auto (the current CUDA device, or an error without "
                        "one), cuda, cuda:N or cpu")
    p.add_argument("--fleet", type=int, default=1,
                   help="replica servers inside this worker")
    p.add_argument("--buckets", default="1x16x16",
                   help="admitted item shapes, ServeConfig grammar")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--coalesce-ms", type=float, default=0.0,
                   help="cross-request admission window (0 = max-wait only)")
    p.add_argument("--result-cache-mb", type=float, default=0.0,
                   help="fleet-tier result cache budget in MB (0 = off)")
    p.add_argument("--queue-depth", type=int, default=64)
    p.add_argument("--fake-entry", type=float, default=None, metavar="MS",
                   help="fixed-cost fake entry instead of the toy model")
    p.add_argument("--n-samples", type=int, default=2,
                   help="SmoothGrad samples for the toy entry")
    p.add_argument("--aot-key-base", default="",
                   help="compiled-step cache key of the toy entry "
                        "(pipeline.aot; hydrated by --registry)")
    p.add_argument("--registry", default="",
                   help="compile-artifact bundle to hydrate before warmup; "
                        "the literal 'wire' streams it from the router "
                        "over the control channel instead (tcp transport)")
    p.add_argument("--host-label", default="",
                   help="host-group identity self-reported at hello "
                        "(routers spawn with --host-label {host})")
    p.add_argument("--chaos", default="",
                   help="in-process fault spec (wam_tpu_torch.testing.faults)")
    p.add_argument("--slo", default="")
    p.add_argument("--metrics-path", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--coordinator", default="",
                   help="multi-host coordinator address (init_distributed)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p.parse_args(argv)


class _FakeEntry:
    """Fixed-service-time entry: one 'compile' per new input shape, one
    GIL-releasing sleep per batch — pod scaling curves measure routing,
    not model contention."""

    def __init__(self, metrics, ms: float):
        import threading

        self._metrics = metrics
        self._seen = set()
        self._lock = threading.Lock()
        self._s = ms / 1e3

    def __call__(self, xs, ys):
        import numpy as np

        shape = tuple(int(d) for d in xs.shape)
        with self._lock:
            if shape not in self._seen:
                self._seen.add(shape)
                self._metrics.note_compile()
        time.sleep(self._s)
        return np.zeros(shape, np.float32)


def toy_wam(n_samples: int, device):
    """The toy entry's explainer: `WaveletAttribution2D` (haar, J=2, every
    sample in one chunk) over the channel mean of the port's seeded
    `models.toy.toy_conv_model` on ``device`` — the recipe a test or a
    smoke run rebuilds in process to hold a worker's answers against."""
    from wam_tpu_torch.models.toy import toy_conv_model
    from wam_tpu_torch.wam2d import WaveletAttribution2D

    toy = toy_conv_model(seed=0, ndim=2, device=device)
    return WaveletAttribution2D(lambda x: toy(x.mean(dim=1)), J=2,
                                n_samples=n_samples, sample_batch_size=None,
                                device=device)


def build_worker_server(args, fleet_metrics, registry=None, device=None):
    """Construct (not yet started) the worker's `FleetServer` from parsed
    args — the same recipe for first spawn and supervisor respawns.
    ``registry`` overrides ``args.registry`` with an already-built
    `RegistryClient` (the wire-streamed bundle path); ``device`` is the
    resolved device of every replica (None resolves ``args.device``)."""
    import torch

    from wam_tpu_torch.config import ServeConfig
    from wam_tpu_torch.device import resolve_device
    from wam_tpu_torch.serve import FleetServer, SupervisorConfig

    if device is None:
        device = resolve_device(None if args.device == "auto" else args.device)
    device = torch.device(device)
    buckets = ServeConfig(buckets=args.buckets).bucket_shapes()
    if args.fake_entry is not None:
        entry_factory = lambda rid, m, dev: _FakeEntry(m, args.fake_entry)
    elif args.aot_key_base or args.registry:
        from wam_tpu_torch.config import precision_tag
        from wam_tpu_torch.serve import fleet_aot_key

        # precision-tag the base so a bf16-policy worker never reuses
        # the f32 export bundle ("f32" tag → suffix-free, warm caches)
        base = fleet_aot_key(
            args.aot_key_base
            or f"pod_worker|toy2d|J2|n{args.n_samples}|mb{args.max_batch}",
            None, precision_tag())

        def entry_factory(rid, m, dev, _base=base):
            from wam_tpu_torch.serve import OVERSIZE_ENTRY_ID, fleet_aot_key

            key = (fleet_aot_key(_base, args.fleet)
                   if rid == OVERSIZE_ENTRY_ID else _base)
            return toy_wam(args.n_samples, dev).serve_entry(
                on_trace=m.note_compile, aot_key=key)
    else:
        entry_factory = lambda rid, m, dev: toy_wam(
            args.n_samples, dev).serve_entry(on_trace=m.note_compile)
    if args.chaos and args.chaos not in ("off", "none"):
        from wam_tpu_torch.testing import ChaosSchedule

        entry_factory = ChaosSchedule(
            args.chaos, seed=args.seed).wrap_factory(entry_factory)
    return FleetServer(
        entry_factory,
        buckets,
        replicas=max(1, args.fleet),
        devices=[device] * max(1, args.fleet),
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        coalesce_ms=getattr(args, "coalesce_ms", 0.0),
        result_cache=int(getattr(args, "result_cache_mb", 0.0) * 2**20) or None,
        queue_depth=args.queue_depth,
        metrics=fleet_metrics,
        metrics_path=args.metrics_path or None,
        slo=args.slo or None,
        supervise=SupervisorConfig(seed=args.seed),
        registry=registry if registry is not None
        else (args.registry or None),
        auto_start=False,
    )


def _load_kernels() -> None:
    """Build the kernels' libraries that are missing (one build at a time
    across processes) and load them all, so the serving path opens no
    library and runs no compiler."""
    from wam_tpu_torch import kernels

    kernels.build_all()
    for k in kernels.KERNELS.values():
        k.fn(k.symbols[0])


def main(argv=None) -> int:
    t_start = time.perf_counter()
    args = _parse(argv if argv is not None else sys.argv[1:])

    import torch

    from wam_tpu_torch.device import resolve_device

    device = resolve_device(None if args.device == "auto" else args.device)
    # start-up stamps on the host's monotonic clock (perf_counter), which the
    # router shares on one host: its spawn stamp to t_main is the interpreter
    # and the imports
    stamps = {"t_main": t_start}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.empty(0, device=device)  # the CUDA context
        stamps["t_cuda"] = time.perf_counter()
        _load_kernels()
        stamps["t_kernels"] = time.perf_counter()
    if args.coordinator:
        from wam_tpu_torch.parallel.multihost import init_distributed

        init_distributed(coordinator_address=args.coordinator,
                         num_processes=args.num_processes,
                         process_id=args.process_id, device=device)

    from wam_tpu_torch.obs import sentinel as obs_sentinel
    from wam_tpu_torch.obs import tracing as obs_tracing
    from wam_tpu_torch.serve import FleetMetrics

    # cross-process span ids: offset this process's counter by pid so the
    # merged pod trace never sees two spans with one id
    obs_tracing.namespace_ids(os.getpid())

    # wire registry: dial the router BEFORE building the fleet, probe for
    # the compile-artifact bundle, and hydrate from the streamed bytes —
    # a cold host joins at compile_count == 0 without a shared filesystem.
    # The same channel carries hello afterwards (one connection per worker).
    chan = None
    wire_registry = None
    if args.registry == "wire":
        from wam_tpu_torch.registry.client import RegistryClient

        chan = connect_to_router(args.connect)
        chan.send({"op": "registry_probe", "worker_id": args.worker_id})
        reply = chan.recv()
        files = dict(reply.get("files") or {})
        # dict lookup as the fetcher: a miss raises KeyError, which the
        # client's silent-miss ladder treats as artifact-not-in-bundle
        wire_registry = RegistryClient("wire://pod-router",
                                       fetcher=files.__getitem__)

    fleet_metrics = FleetMetrics()
    server = build_worker_server(args, fleet_metrics, registry=wire_registry,
                                 device=device)
    server.start()
    stamps["t_ready"] = time.perf_counter()
    warm_s = stamps["t_ready"] - t_start
    warm_traces = obs_sentinel.trace_count()

    def snapshot() -> WorkerSnapshot:
        sig = server.pod_signals()
        return WorkerSnapshot(
            worker_id=args.worker_id,
            pid=os.getpid(),
            t_worker=time.perf_counter(),
            projected_drain_s=sig["projected_drain_s"],
            ema_service_s=sig["ema_service_s"],
            qos_depth=sig.get("qos_depth", {}),
            queue_free=sig.get("queue_free", -1),
            cache_hit_rate=sig.get("cache_hit_rate", -1.0),
            slo_penalty_s=sig["slo_penalty_s"],
            quarantined=sig["quarantined"],
            live_replicas=sig["live_replicas"],
            dead_replicas=sig["dead_replicas"],
            submitted=sig["submitted"],
            completed=sig["completed"],
            compile_count=sig["compile_count"],
            post_warm_compiles=obs_sentinel.trace_count() - warm_traces,
            warm_s=warm_s,
            models_resident=sig.get("models_resident", {}),
        )

    def _with_device(msg: dict, startup: bool = False) -> dict:
        # on a card, the allocator's peak and the kernels' launch counts
        # (since the process started) ride beside the snapshot under
        # "device", a key the router reads when present; the snapshot
        # keeps the reference's fields
        if device.type == "cuda":
            from wam_tpu_torch import kernels

            msg["device"] = {
                "peak_memory_bytes": int(torch.cuda.max_memory_allocated(device)),
                "kernel_launches": kernels.launch_counts(),
                **(stamps if startup else {}),
            }
        return msg

    if chan is None:
        chan = connect_to_router(args.connect)
    chan.send(_with_device({
        "op": "hello",
        "worker_id": args.worker_id,
        "pid": os.getpid(),
        "host": args.host_label,
        "snapshot": snapshot(),
        "buckets": args.buckets,
    }, startup=True))

    def _send_result(req_id, fut) -> None:
        try:
            exc = fut.exception()
            if exc is None:
                chan.send({"op": "result", "req_id": req_id, "ok": True,
                           "value": fut.result()})
            else:
                chan.send({"op": "result", "req_id": req_id, "ok": False,
                           "error": encode_error(exc)})
        except OSError:
            pass  # router vanished mid-reply; the pod supervisor owns us

    graceful = False
    while True:
        try:
            msg = chan.recv()
        except (EOFError, OSError):
            break  # router gone: drain and exit (supervised by the pod)
        op = msg.get("op")
        if op == "submit":
            req_id = msg["req_id"]
            ctx = tuple(msg["ctx"]) if msg.get("ctx") else None
            try:
                # the router's trace context re-established on this side of
                # the process boundary: every span the serve runtime opens
                # for this request joins the router's timeline
                with obs_tracing.use_context(ctx):
                    fut = server.submit(msg["x"], msg.get("y"),
                                        deadline_ms=msg.get("deadline_ms"),
                                        qos=msg.get("qos", "interactive"),
                                        model=msg.get("model"),
                                        tenant=msg.get("tenant"))
            except Exception as e:  # noqa: BLE001 - typed over the wire
                _send_result(req_id, _failed_future(e))
                continue
            fut.add_done_callback(
                lambda f, rid=req_id: _send_result(rid, f))
        elif op == "health":
            try:
                chan.send(_with_device({"op": "health_reply", "t_send": msg["t_send"],
                                        "t_worker": time.perf_counter(),
                                        "snapshot": snapshot()}))
            except OSError:
                break
        elif op == "canary":
            # online-tuner challenger pin: fingerprint present = pin one
            # replica to the challenger schedule (optional server-kw
            # overrides), fingerprint None = clear the A/B. Best-effort —
            # a one-replica worker cannot A/B and just skips the pin.
            try:
                fp = msg.get("fingerprint")
                if fp is None:
                    server.clear_canary()
                else:
                    server.pin_canary(fp, overrides=msg.get("overrides"))
            except (ValueError, RuntimeError):
                pass
        elif op == "close":
            graceful = True
            break
    server.close(emit_metrics=bool(args.metrics_path))
    if graceful:
        try:
            chan.send(_with_device({"op": "bye", "snapshot": snapshot(),
                                    "spans": obs_tracing.spans()}))
        except OSError:
            pass
    chan.close()
    return 0


def _failed_future(exc):
    from concurrent.futures import Future

    f = Future()
    f.set_exception(exc)
    return f


if __name__ == "__main__":
    sys.exit(main())
