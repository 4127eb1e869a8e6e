"""Reading a ``torch.profiler`` capture of a stretch of the window.

The arithmetic is the measured package's `profiling.kernel_events` and
`profiling._union_seconds`, copied so that the yardstick stays fixed when
the package changes: each device event (kernel, copy, memset) with the
names of the host ops and ``record_function`` ranges around the runtime
call that launched it, matched by correlation id; busy time as the union
of the device intervals. The stretch is the host range ``WINDOW`` that the
harness opens around the profiled calls or, in a capture of the card's
activity alone, the span between the first ``MARK`` kernel's end and the
last one's start; device time is clipped to it.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict, namedtuple

WINDOW = "wambench.window"
MARK = "spin_kernel"  # torch.cuda._sleep's kernel, which marks a device-only stretch
MARK_CYCLES = 1000

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver", "runtime", "driver")
_HOST_CATS = ("cpu_op", "user_annotation", "operator")

KernelEvent = namedtuple("KernelEvent", "name start dur cat args ops")
HostOp = namedtuple("HostOp", "name start end tid")


class Capture:
    """Device events, host ops and the window of one exported trace."""

    def __init__(self, path: str):
        with open(path) as f:
            data = json.load(f)
        events = data.get("traceEvents", data) if isinstance(data, dict) else data
        events = [e for e in events if isinstance(e, dict) and e.get("ph") == "X"]

        def cat(e):
            return str(e.get("cat", "")).lower()

        windows = [e for e in events if e.get("name") == WINDOW and cat(e) in _HOST_CATS]
        marks = sorted((e for e in events if cat(e) == "kernel" and MARK in e.get("name", "")),
                       key=lambda e: float(e["ts"]))
        self.marked = not windows
        if windows:
            w = max(windows, key=lambda e: float(e.get("dur", 0.0)))
            self.t0 = float(w["ts"])
            self.t1 = self.t0 + float(w.get("dur", 0.0))
        elif len(marks) >= 2:
            self.t0 = float(marks[0]["ts"]) + float(marks[0].get("dur", 0.0))
            self.t1 = float(marks[-1]["ts"])
        else:
            raise ValueError("the capture holds no window range and no marks")
        self.window_s = (self.t1 - self.t0) / 1e6
        launch_at = {}
        for e in events:
            if cat(e) in _LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch_at[corr] = (e.get("pid"), e.get("tid"), float(e["ts"]))
        hosts = defaultdict(list)
        self.host_ops = []
        host_cats = _LAUNCH_CATS if self.marked else _HOST_CATS  # marked: runtime calls alone
        for e in events:
            if cat(e) in host_cats:
                s = float(e["ts"])
                end = s + float(e.get("dur", 0.0))
                hosts[(e.get("pid"), e.get("tid"))].append((s, end, e["name"]))
                self.host_ops.append(HostOp(e["name"], s, end, (e.get("pid"), e.get("tid"))))
        for v in hosts.values():
            v.sort(key=lambda h: (h[0], -h[1]))
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
        self.device = []
        for e in events:
            if cat(e) not in _DEVICE_CATS:
                continue
            s, d = float(e["ts"]), float(e.get("dur", 0.0))
            if s + d <= self.t0 or s >= self.t1 or (self.marked and MARK in e["name"]):
                continue
            args = e.get("args") or {}
            self.device.append(KernelEvent(e["name"], s, d, cat(e), args,
                                           chains.get(args.get("correlation"), ())))
        self.kernels = [e for e in self.device if e.cat == "kernel"]

    def clipped(self, evs) -> list[tuple[float, float]]:
        return [(max(e.start, self.t0), min(e.start + e.dur, self.t1)) for e in evs]

    def busy_s(self, evs=None) -> float:
        return union_seconds(self.clipped(self.device if evs is None else evs))

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took most time: [name, seconds]."""
        tot = defaultdict(float)
        for e, (s, t) in zip(self.device, self.clipped(self.device)):
            tot[e.name] += (t - s) / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """The device's idle time inside the window by what the host was
        doing then: each gap between busy intervals charged to the
        innermost host op (in a marked capture: runtime call) running at
        its middle (on any thread), summed by name; [name, seconds], the
        largest first."""
        busy = merged(self.clipped(self.device))
        gaps, cur = [], self.t0
        for s, t in busy:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, t)
        if cur < self.t1:
            gaps.append((cur, self.t1))
        ops = sorted((h for h in self.host_ops if h.name != WINDOW), key=lambda h: h.start)
        tot = defaultdict(float)
        active, i = [], 0
        for a, b in gaps:  # in time order: one sweep over the host ops
            mid = (a + b) / 2
            while i < len(ops) and ops[i].start <= mid:
                active.append(ops[i])
                i += 1
            active = [h for h in active if h.end >= mid]
            name = min(active, key=lambda h: h.end - h.start).name if active else "host: no op"
            tot[name] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def merged(intervals) -> list[tuple[float, float]]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def union_seconds(intervals) -> float:
    return sum(e - s for s, e in merged(intervals)) / 1e6


def under(ev: KernelEvent, token: str) -> bool:
    """Whether a device event's name, or a host op or range around its
    launch, holds ``token``."""
    t = token.lower()
    return t in ev.name.lower() or any(t in op.lower() for op in ev.ops)


def export(prof, directory: str) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"wambench_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path
