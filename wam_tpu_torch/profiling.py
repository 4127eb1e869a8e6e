"""Timing and profiling utilities (PyTorch port of `wam_tpu.profiling`).

- Timers: `bench_time` / `bench_samples` (host clock, each region closed by
  `device_sync`), `device_time_samples` (CUDA events around each region of
  warm calls: the card's own clock; ``[]`` where no CUDA tensor is
  involved, as the reference returns ``[]`` off the TPU) and
  `metric_fetch_split` (the two side by side). `median_iqr` summarizes.
- Traces: `trace` (a named range, ``torch.profiler.record_function``),
  `profile_to` (a ``torch.profiler`` capture written as a Chrome trace
  under a directory) and the readers of such a capture: `named_op_split`
  (device time by name token or by a caller's partition),
  `synth_device_split` (the 2D transforms' analysis / synthesis spans) and
  `h2d_stats` (host-to-device copies and their overlap with kernels). Where
  the reference reads xplane op names, these read kernel names and the
  names of the host ops and spans that launched each kernel.
- `StageTimer`, the accumulating wall-clock timer the serve ledger
  decomposes by. `start_server` has no torch counterpart and raises.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from collections import defaultdict, namedtuple

__all__ = ["trace", "StageTimer", "start_server", "profile_to", "device_sync",
           "bench_time", "bench_samples", "median_iqr", "device_time_samples",
           "h2d_stats", "named_op_split", "synth_device_split", "metric_fetch_split",
           "kernel_events"]


def _tensors(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def device_sync(out) -> None:
    """Wait until every tensor of ``out`` (a tensor or a tuple, list or dict
    of them) is computed: a `torch.cuda.synchronize` of each CUDA device
    the tree touches; CPU tensors are ready when the call returns. Use it
    to close a timed region."""
    import torch

    devices = {t.device for t in _tensors(out) if t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


def median_iqr(samples: list[float]) -> tuple[float, float, float, float]:
    """(median, q1, q3, iqr) of a sample list (linear-interpolated quartiles)."""
    import numpy as np

    a = np.asarray(sorted(samples), dtype=np.float64)
    q1, med, q3 = np.quantile(a, [0.25, 0.5, 0.75])
    return float(med), float(q1), float(q3), float(q3 - q1)


class StageTimer:
    """Accumulating wall-clock timer: ``with timer.stage("dwt"): ...``;
    `timed` also waits for the device result (`device_sync`).

    With ``span_prefix`` set (e.g. ``"serve."``), every stage interval is
    also recorded as an obs span named ``{span_prefix}{name}`` — it parents
    to the calling thread's current span context, so stages that run inside
    a request's context join that request's trace. Thread-safe for one
    writer per stage name (the serve worker); the totals are plain dicts."""

    def __init__(self, span_prefix: str | None = None):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.span_prefix = span_prefix

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.totals[name] += t1 - t0
            self.counts[name] += 1
            if self.span_prefix is not None:
                from wam_tpu_torch.obs import tracing as _obs_tracing

                _obs_tracing.record_span(
                    f"{self.span_prefix}{name}", t0, t1,
                    parent=_obs_tracing.current_context(), cat="stage")

    def timed(self, name: str, fn, *args, **kwargs):
        with self.stage(name):
            out = fn(*args, **kwargs)
            device_sync(out)
        return out

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "calls": self.counts[k],
                "mean_s": self.totals[k] / max(self.counts[k], 1)}
            for k in self.totals
        }


def _cuda_device(tree):
    """The device of the first CUDA tensor of a tree, or None."""
    for t in _tensors(tree):
        if t.is_cuda:
            return t.device
    return None


def bench_time(fn, *args, repeats: int = 3, laps: int = 1) -> float:
    """Min host-clock seconds a call of ``fn(*args)`` over ``repeats``
    regions of ``laps`` calls, after one untimed warm call; each region is
    closed by `device_sync`."""
    return min(bench_samples(fn, *args, k=repeats, laps=laps, warmup=1))


def bench_samples(fn, *args, k: int = 7, laps: int = 1, warmup: int = 1) -> list[float]:
    """``k`` host-clock samples (seconds a call): each a region of ``laps``
    calls closed by `device_sync` of the last output, after ``warmup``
    untimed calls."""
    for _ in range(max(1, warmup)):
        device_sync(fn(*args))
    times = []
    for _ in range(k):
        t0 = time.perf_counter()
        out = None
        for _ in range(laps):
            out = fn(*args)
        device_sync(out)
        times.append((time.perf_counter() - t0) / laps)
    return times


def device_time_samples(fn, *args, k: int = 3, laps: int = 1, warmup: int = 1,
                        device=None) -> list[float]:
    """``k`` device-time samples (seconds a call): each the CUDA-event time
    of one region of ``laps`` warm calls divided by ``laps``, the events
    recorded on the current stream of ``device`` after a synchronize.
    ``device`` None takes the first CUDA tensor's among ``args`` and the
    warm-up output; with none, ``[]``: there is no device clock to read
    (the reference's answer off the TPU)."""
    import torch

    out = None
    for _ in range(max(1, warmup)):
        out = fn(*args)
        device_sync(out)
    if device is None:
        device = _cuda_device(args) or _cuda_device(out)
    if device is None or torch.device(device).type != "cuda":
        return []
    samples = []
    with torch.cuda.device(device):
        for _ in range(k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(laps):
                fn(*args)
            end.record()
            torch.cuda.synchronize()
            samples.append(start.elapsed_time(end) / 1e3 / laps)
    return samples


def metric_fetch_split(fn, *args, k: int = 3, laps: int = 1, warmup: int = 1) -> dict:
    """Host-clock against device time of one metric call (python in,
    python out): ``{"wall_s", "wall_q1_s", "wall_q3_s", "device_s",
    "residue_s", "plane"}``, the residue being what the host adds around
    the device work (the fetch, the glue). Without a CUDA device
    ``device_s`` / ``residue_s`` are None and ``plane`` is "wall"."""
    wall = bench_samples(fn, *args, k=k, laps=laps, warmup=warmup)
    med, q1, q3, _ = median_iqr(wall)
    res = {"wall_s": med, "wall_q1_s": q1, "wall_q3_s": q3,
           "device_s": None, "residue_s": None, "plane": "wall"}
    dev = device_time_samples(fn, *args, k=k, laps=laps, warmup=0)
    if dev:
        dmed = median_iqr(dev)[0]
        res.update(device_s=dmed, residue_s=max(0.0, med - dmed), plane="device")
    return res


@contextlib.contextmanager
def trace(name: str):
    """A named range in ``torch.profiler`` captures (host timeline, and the
    kernels it launches carry it in their op chain, `kernel_events`)."""
    import torch

    with torch.profiler.record_function(name):
        yield


def start_server(port: int = 9999):
    """The reference exposes a live JAX profiler server for TensorBoard to
    capture from; torch.profiler has no such server (a capture is taken in
    process, `profile_to`), so this raises."""
    raise NotImplementedError(
        f"start_server(port={port}): torch.profiler has no live profiler server to attach "
        "to; capture a region in process with profiling.profile_to(logdir)")


@contextlib.contextmanager
def profile_to(logdir: str):
    """Capture one region with ``torch.profiler`` (CPU, and CUDA when a card
    is visible) and write it as a Chrome trace under ``logdir``
    (``wam_trace_<pid>_<ns>.json``, the file the readers take). Yields the
    profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"wam_trace_{os.getpid()}_{time.time_ns()}.json"))


# -- reading a capture ------------------------------------------------------------------

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver", "runtime", "driver")
_HOST_CATS = ("cpu_op", "user_annotation", "operator")


# one device event of a capture: its name, start and duration (us), category
# and args, and ``ops``: the host ops and spans around its launch, innermost first
KernelEvent = namedtuple("KernelEvent", "name start dur cat args ops")


def _trace_events(trace) -> list | None:
    """The event list of a capture: a `profile_to` directory (its newest
    trace), a Chrome-trace file, or a ``torch.profiler`` profile."""
    if hasattr(trace, "export_chrome_trace"):
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            trace.export_chrome_trace(path)
            return _trace_events(path)
    path = str(trace)
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.json")), key=os.path.getmtime)
        if not files:
            return None
        path = files[-1]
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    events = data.get("traceEvents", data) if isinstance(data, dict) else data
    return [e for e in events if isinstance(e, dict) and e.get("ph") == "X"]


def kernel_events(trace) -> list[KernelEvent] | None:
    """Every device event (kernels, copies, memsets) of a capture
    (`_trace_events`), each with the names of the host ops and
    ``record_function`` spans enclosing the runtime call that launched it
    on its thread, innermost first (matched by the events' correlation
    ids). None when the capture cannot be read."""
    events = _trace_events(trace)
    if events is None:
        return None

    def cat(e):
        return str(e.get("cat", "")).lower()

    device = [e for e in events if cat(e) in _DEVICE_CATS]
    launch_at = {}
    for e in events:
        if cat(e) in _LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_at[corr] = (e.get("pid"), e.get("tid"), float(e["ts"]))
    hosts = defaultdict(list)
    for e in events:
        if cat(e) in _HOST_CATS:
            hosts[(e.get("pid"), e.get("tid"))].append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"]))
    for v in hosts.values():
        v.sort(key=lambda h: (h[0], -h[1]))
    # the enclosing host ranges of each launch: one sweep per thread
    queries = defaultdict(list)
    for corr, (pid, tid, ts) in launch_at.items():
        queries[(pid, tid)].append((ts, corr))
    chains = {}
    for thread, qs in queries.items():
        ranges, i, stack = hosts.get(thread, []), 0, []
        for ts, corr in sorted(qs):
            while i < len(ranges) and ranges[i][0] <= ts:
                stack.append(ranges[i])
                i += 1
            stack = [r for r in stack if r[1] >= ts]
            chains[corr] = tuple(r[2] for r in reversed(stack))
    out = []
    for e in device:
        args = e.get("args") or {}
        out.append(KernelEvent(e["name"], float(e["ts"]), float(e.get("dur", 0.0)), cat(e), args,
                               chains.get(args.get("correlation"), ())))
    return out


def _union_seconds(intervals) -> float:
    total, cur = 0.0, None
    for s, e in sorted(intervals):
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        total += cur[1] - cur[0]
    return total / 1e6


def _token_matches(ev: KernelEvent, token: str) -> bool:
    t = token.lower()
    return t in ev.name.lower() or any(t in op.lower() for op in ev.ops)


def named_op_split(trace, tokens=("wam_synth", "wam_analysis"), *, classify=None,
                   launches: bool = False):
    """Device seconds of a capture (`profile_to` directory, trace file or
    profile) by name, or None when it holds no device event (a CPU
    capture).

    With ``tokens`` (the reference's default: the 2D transforms' span
    names), a device event counts under every token that occurs in its
    kernel name or in the name of a host op or span around its launch
    (`kernel_events`); ``classify(event) -> label or None`` instead puts
    each event under one label (a partition; None leaves it out). Each
    label's seconds are the union of its events' intervals, ``"total"`` the
    union of every event's. With ``launches`` also returns the event count
    of each label."""
    evs = kernel_events(trace)
    if not evs:
        return None
    groups: dict[str, list] = {} if classify else {t: [] for t in tokens}
    for ev in evs:
        if classify is not None:
            label = classify(ev)
            if label is not None:
                groups.setdefault(label, []).append(ev)
        else:
            for t in tokens:
                if _token_matches(ev, t):
                    groups[t].append(ev)
    out = {k: _union_seconds((e.start, e.start + e.dur) for e in v) for k, v in groups.items()}
    out["total"] = _union_seconds((e.start, e.start + e.dur) for e in evs)
    if launches:
        return out, {k: len(v) for k, v in groups.items()}
    return out


def synth_device_split(fn, *args, laps: int = 1, warmup: int = 1) -> dict | None:
    """Analysis against synthesis device time of one runner: one captured
    region of ``laps`` calls, its device time bucketed by the 2D
    transforms' spans (``wam_analysis`` / ``wam_synth``, around their
    forward launches) per call, with fractions of the total. None without
    a CUDA device."""
    import shutil
    import tempfile

    out = None
    for _ in range(max(1, warmup)):
        out = fn(*args)
        device_sync(out)
    if (_cuda_device(args) or _cuda_device(out)) is None:
        return None
    d = tempfile.mkdtemp(prefix="wam_synth_split_")
    try:
        with profile_to(d):
            out = None
            for _ in range(laps):
                out = fn(*args)
            device_sync(out)
        split = named_op_split(d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if split is None:
        return None
    total = split.pop("total")
    res = {f"{k}_s": v / laps for k, v in split.items()}
    res["op_total_s"] = total / laps
    if total > 0:
        for k, v in split.items():
            res[f"{k}_frac"] = v / total
    return res


def h2d_stats(trace) -> dict | None:
    """Host-to-device copies of a capture: ``{"h2d_bytes", "h2d_seconds",
    "overlap_frac"}``, the seconds the union of the copies' intervals and
    ``overlap_frac`` the share of it that ran while a kernel ran (None when
    the capture holds no kernel). None when it holds no such copy."""
    evs = kernel_events(trace)
    if not evs:
        return None
    copies = [e for e in evs if "memcpy" in e.cat and "htod" in e.name.lower().replace(" ", "")]
    if not copies:
        return None
    kernels = [(e.start, e.start + e.dur) for e in evs if e.cat == "kernel"]
    iv = [(e.start, e.start + e.dur) for e in copies]
    h2d_s = _union_seconds(iv)
    overlap = None
    if kernels and h2d_s > 0:
        both = _union_seconds(iv) + _union_seconds(kernels) - _union_seconds(iv + kernels)
        overlap = both / h2d_s
    nbytes = sum(int(e.args.get("bytes", 0) or 0) for e in copies)
    return {"h2d_bytes": nbytes, "h2d_seconds": h2d_s, "overlap_frac": overlap}
