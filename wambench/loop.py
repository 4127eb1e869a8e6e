"""The closed loop: one caller, calls back to back, each call's result
on the host before the next call starts. In a traced run a stretch of
calls inside the window runs under ``torch.profiler``, inside the host
range `trace.WINDOW`."""

from __future__ import annotations

import time

from wambench.trace import MARK_CYCLES, WINDOW


class Window:
    """What one window did: calls made, items completed, seconds, and the
    traced stretch's calls, items and host-clock seconds."""

    def __init__(self):
        self.calls = 0
        self.items = 0
        self.failed = 0  # requests refused or never answered (an open loop's)
        self.seconds = 0.0
        self.outputs = []
        self.traced_calls = 0
        self.traced_items = 0
        self.traced_host_s = 0.0
        self.profile = None
        self.traced_spans = []
        self.traced_launches = {}
        self.ends = []  # each call's end, seconds from the window's start

    def quarter_call_s(self) -> list[float]:
        """The mean seconds a call in each quarter of the window (a call
        counted in the quarter it ends in): a rate that drifts through the
        window shows here."""
        if not self.ends or self.seconds <= 0:
            return []
        q = self.seconds / 4
        sums, counts = [0.0] * 4, [0] * 4
        prev = 0.0
        for e in self.ends:
            k = min(int(e / q), 3)
            sums[k] += e - prev
            counts[k] += 1
            prev = e
        return [s / c if c else float("nan") for s, c in zip(sums, counts)]


class Stretch:
    """A profiled stretch of the window: the profiler started ahead of it
    (its start costs the host up to a second, and the card's events come
    in some time after), the stretch marked, then the profiler stopped.

    By default the profiler records the host's operators as well as the
    card's, and the host range `trace.WINDOW` marks the stretch. With
    ``device_only`` (and a card) it records the card's activity and the
    runtime calls alone, which costs the host far less a launch, and the
    stretch is marked on the card: a short spin kernel (`trace.MARK`) on a
    stream of its own at each end, which runs as it is launched."""

    def __init__(self, device_only: bool = False):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.marked = device_only and torch.cuda.is_available()
        acts = [] if self.marked else [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            if self.marked:
                self._stream = torch.cuda.Stream()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.host_s = 0.0
        self._range = None

    def _mark(self):
        import torch

        with torch.cuda.stream(self._stream):
            torch.cuda._sleep(MARK_CYCLES)

    def open(self):
        import torch

        if self.marked:
            self._mark()
        else:
            self._range = torch.profiler.record_function(WINDOW)
            self._range.__enter__()
        self.t0 = time.perf_counter()

    def close(self, stop: bool = True):
        """End the stretch; ``stop`` False leaves the profiler running (a
        marked stretch) until `stop`, so that its cost falls after the
        window's work."""
        self.t1 = time.perf_counter()
        self.host_s = self.t1 - self.t0
        if self.marked:
            self._mark()
        else:
            self._range.__exit__(None, None, None)
        if stop:
            self.stop()

    def stop(self):
        if self.marked:
            self._stream.synchronize()
        self.prof.__exit__(None, None, None)


def closed_loop(call, n_items: int, seconds: float, trace: bool, trace_calls: int,
                spans=None, launches=None, device_only: bool = False) -> Window:
    """Run ``call(i)`` (which returns the call's host result) for ``i`` =
    0, 1, ... until ``seconds`` have passed since the window opened; the
    rate is every item over all the window's time. With ``trace``, calls
    1 .. trace_calls are profiled, the profiler started before call 0
    (the window runs on past them until its time is up, and at least
    through them); ``spans`` (the package's
    `obs` tracing: ``clear_spans`` / ``spans``) and ``launches()`` (its
    launch counters) are read around that stretch; ``device_only`` as in
    `Stretch`."""
    w = Window()
    stretch = Stretch(device_only) if trace else None  # started with the window's first call
    t0 = time.perf_counter()
    while True:
        if trace and w.calls == 1:
            if spans:
                spans.clear_spans()
            l0 = launches() if launches else {}
            stretch.open()
            for _ in range(trace_calls):
                w.outputs.append(call(w.calls))
                w.calls += 1
                w.items += n_items
            stretch.close()
            w.profile = stretch.prof
            w.traced_host_s = stretch.host_s
            w.traced_calls = trace_calls
            w.traced_items = trace_calls * n_items
            w.traced_spans = spans.spans() if spans else []
            if launches:
                l1 = launches()
                w.traced_launches = {k: l1[k] - l0.get(k, 0) for k in l1}
        else:
            w.outputs.append(call(w.calls))
            w.calls += 1
            w.items += n_items
        w.ends.append(time.perf_counter() - t0)
        if time.perf_counter() - t0 >= seconds and (w.traced_calls or not trace):
            break
    w.seconds = time.perf_counter() - t0
    return w
