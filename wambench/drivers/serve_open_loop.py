"""Serving explanations to callers who wait: an open loop of requests with
Poisson arrivals at a fixed rate into `wam_tpu_torch.serve.AttributionServer`
over a `WaveletAttribution2D` SmoothGrad entry (``serve_entry``).

Inputs, from the seed: one distinct labelled image a request (a pool as
large as the window's requests), and the arrival times. Every seed gets
the same set of inter-arrival gaps (drawn once from the traffic file's
``arrival_seed``) in its own order, so runs differ in order and not in
load. A request is timed from when it was due to when its mosaic was on
the host (the future's completion); one refused or failed counts in
``failed`` and, in the percentile, as having waited the whole window.

The check follows the server's batching: the batches' real-row counts, in
dispatch order, from the server's metrics (the package's own record; a
single submitter and one lane keep the queue first in, first out), cut the
window's requests into batches; the reference recomputes each sampled
request's batch as the server assembles it (padding rows repeat the first
real row and its label) with the entry's noise (one draw of the batch's
shape from a generator seeded with the explainer's seed, every batch) and
compares the request's row.

A traced run profiles a stretch near the window's end (``trace_seconds``,
ending ``trace_before_end_s`` before it), the card's activity alone, marked
on the card (`loop.Stretch` with ``device_only``). The profiler is primed
before the window, started a second ahead of the stretch and stopped once
the last request is submitted: stopping it holds the host for about a
second, and inside the window that stall would come out as a burst of
late submissions past the queue's depth, so the stretch would show
another load than the cell's.
"""

from __future__ import annotations

import math
import sys
import threading
import time

import numpy as np

from wambench import common, compare
from wambench.drivers import base
from wambench.loop import Stretch, Window
from wambench.reference import wam as ref_wam

PROFILER_LEAD_S = 1.0  # the profiler starts this long ahead of the stretch it reads

class Driver(base.Driver):
    E2E = "latency_p95_ms"

    def __init__(self, cell):
        super().__init__(cell)
        self.B = self.t["max_batch"]

    # -- inputs ---------------------------------------------------------------------

    def arrivals(self) -> np.ndarray:
        """Due times (s from the window's start) of the window's requests."""
        rate = self.t["rate_per_s"]
        n = int(math.ceil(rate * self.cell.seconds))
        if n == 0:
            return np.zeros(0)
        gaps = np.random.default_rng(self.t["arrival_seed"]).exponential(1.0 / rate, n)
        gaps *= self.cell.seconds / gaps.sum()  # the same total for every seed
        order = np.random.default_rng(common.sub_seed(self.cell.seed, 5)).permutation(n)
        return np.cumsum(gaps[order]) - gaps[order][0]

    def setup_inputs(self):
        self.due = self.arrivals()
        # the window's requests (or the control's full batches), then the warm-up's
        self.n_window = max(len(self.due), self.t["check_calls"] * self.B)
        n = self.n_window + self.t["warmup_requests"]
        x, y = common.image_pool(self.cell.seed, 1, n, self.cfg["in_channels"], self.side,
                                 self.cfg["num_classes"], self.device)
        self.x_dev, self.y_dev = x[0], y[0]
        self.x_host = x[0].cpu().numpy()
        self.y_host = y[0].cpu().numpy().astype(np.int64)
        self.noise_seed = common.sub_seed(self.cell.seed, 3) & 0xFFFFFFFF

    def _image(self, j: int):  # request j of the window; the warm-up's after them
        return self.x_host[j], int(self.y_host[j])

    # -- the program ----------------------------------------------------------------

    def setup_program(self):
        import wam_tpu_torch
        from wam_tpu_torch.serve import AttributionServer

        fn = common.port_model(self.cell)
        t = self.t
        wam = wam_tpu_torch.WaveletAttribution2D(
            fn, wavelet=t["wavelet"], J=t["levels"], mode=t["mode"], method="smooth",
            n_samples=t["n_samples"], stdev_spread=t["stdev_spread"],
            sample_batch_size=t["sample_batch_size"], stream_noise=False,
            random_seed=self.noise_seed, device=self.device, impl=t["impl"])
        shape = (self.cfg["in_channels"], self.side, self.side)
        self.server = AttributionServer(wam.serve_entry(), [shape], max_batch=self.B,
                                        max_wait_ms=t["max_wait_ms"],
                                        queue_depth=t["queue_depth"], device=self.device)

    def warmup(self):
        """Requests beyond the window's, submitted together and awaited."""
        n = self.n_window
        futs = [self.server.submit(*self._image(n + k)) for k in range(self.t["warmup_requests"])]
        for f in futs:
            f.result(timeout=120)
        self._settle(len(futs), 0)

    def _settle(self, n: int, rows0: int) -> list[int]:
        """The real-row counts of the batches recorded after ``rows0``, once
        they account for ``n`` answered requests (a future is answered just
        before its batch is recorded)."""
        deadline = time.perf_counter() + 30.0
        while True:
            rows = [r["n_real"] for r in self.server.metrics.batch_sample()[rows0:]]
            if sum(rows) >= n or time.perf_counter() > deadline:
                return rows
            time.sleep(0.01)

    def window(self, seconds: float, trace: bool, obs, launches) -> Window:
        """Submit each request at its due time; wait for every answer (a
        minute past the close at most); in a traced run profile
        ``trace_seconds`` from the first request due ``trace_before_end_s``
        before the window's end."""
        w = Window()
        n = len(self.due)
        done = [math.nan] * n
        lock = threading.Lock()
        futs = [None] * n
        self.rows0 = len(self.server.metrics.batch_sample())
        span = self.t["trace_seconds"]
        lo = max(0.0, seconds - self.t["trace_before_end_s"])
        if trace:  # the profiler's first start in a process sets it up: before the window
            Stretch(device_only=True).stop()
        stretch = None
        state = "before" if trace else "none"
        t0 = time.perf_counter()

        def finished(j):
            def cb(_):
                with lock:
                    done[j] = time.perf_counter()
            return cb

        for j in range(n):
            due = t0 + self.due[j]
            if stretch is None and state == "before" and self.due[j] >= lo - PROFILER_LEAD_S:
                stretch = Stretch(device_only=True)
            if state == "before" and self.due[j] >= lo:
                obs.clear_spans()
                stretch.open()
                first, state = j, "open"
            if state == "open" and time.perf_counter() - stretch.t0 >= span:
                stretch.close(stop=False)
                last, state = j, "closed"
            now = time.perf_counter()
            if due > now:
                time.sleep(due - now)
            try:
                futs[j] = self.server.submit(*self._image(j))
                futs[j].add_done_callback(finished(j))
            except Exception:  # refused (queue full, closed): a failed request
                futs[j] = None
        if state == "open":
            stretch.close(stop=False)
            last = n
        if stretch is not None:
            stretch.stop()
        deadline = time.perf_counter() + 60.0
        outputs, failed = [], 0
        for j, f in enumerate(futs):
            try:
                outputs.append(None if f is None else
                               f.result(timeout=max(0.0, deadline - time.perf_counter())))
            except Exception:
                outputs.append(None)
            if outputs[-1] is None:
                failed += 1
        w.seconds = time.perf_counter() - t0
        lat = [(d - (t0 + self.due[j])) if not math.isnan(d) else seconds
               for j, d in enumerate(done)]
        lat = [lat[j] if outputs[j] is not None else seconds for j in range(n)]
        w.latencies = lat
        w.failed = failed
        w.calls = n
        w.items = n
        w.outputs = outputs
        self.answered = n - failed
        if trace:
            w.profile = stretch.prof
            w.traced_host_s = stretch.host_s
            w.traced_calls = w.traced_items = last - first
            w.traced_spans = [sp for sp in obs.spans() if stretch.t0 <= sp["t1"] <= stretch.t1]
        return w

    def free_program(self):
        self.batches = self._settle(self.answered, self.rows0)
        self.server.close(emit_metrics=False)
        del self.server

    def e2e(self, window) -> dict:
        return {self.E2E: 1e3 * float(np.percentile(window.latencies, 95))}

    def samples(self, window) -> list[int]:
        """Requests to check, drawn from the seed among the answered ones."""
        ok = [j for j, o in enumerate(window.outputs) if o is not None]
        rng = np.random.default_rng(common.sub_seed(self.cell.seed, 4))
        k = min(self.t["check_calls"], len(ok))
        return sorted(int(j) for j in rng.choice(ok, size=k, replace=False))

    # -- the reference and the control ----------------------------------------------

    def setup_reference(self, dtype):
        self.ref_model = common.reference_model(self.cell, dtype)
        self.ref_dtype = dtype
        self._ref_cache = {}

    def batch_of(self, j: int, outputs) -> list[int]:
        """The window's requests served in request j's batch, in row order:
        the answered requests in submission order cut by the batches' real
        rows. Raises when the counts do not tile the answered requests."""
        if self.batches is None:  # the control: full batches of consecutive requests
            return list(range(j - j % self.B, j - j % self.B + self.B))
        answered = [i for i, o in enumerate(outputs) if o is not None]
        if sum(self.batches) != len(answered):
            raise ValueError(f"{sum(self.batches)} batched rows for {len(answered)} answers")
        start = 0
        for n in self.batches:
            rows = answered[start:start + n]
            if j in rows:
                return rows
            start += n
        raise ValueError(f"request {j} in no batch")

    def reference_batch(self, rows: list[int]):
        """The reference's mosaics (B, S, S) of one served batch."""
        import torch

        key = (tuple(rows), self.ref_dtype)
        if key in self._ref_cache:
            return self._ref_cache[key]

        t = self.t
        idx = rows + [rows[0]] * (self.B - len(rows))
        x = self.x_dev[idx]
        y = self.y_dev[idx]
        g = torch.Generator(device=self.device).manual_seed(self.noise_seed)
        noise = torch.randn((t["n_samples"],) + tuple(x.shape), generator=g, device=self.device)
        out = ref_wam.smoothgrad(self.ref_model, x, y, noise, name=t["wavelet"],
                                 levels=t["levels"], spread=t["stdev_spread"],
                                 chunk=t["sample_batch_size"] or t["n_samples"],
                                 dtype=self.ref_dtype).cpu()
        self._ref_cache[key] = out
        return out

    def reference(self, j: int, outputs):
        """Request j's row of the reference's batch; NaN (never correct)
        when the recorded batches do not tile the answered requests."""
        import torch

        try:
            rows = self.batch_of(j, outputs)
        except ValueError as e:
            print(f"serve check: {e}", file=sys.stderr)
            return torch.full(tuple(outputs[j].shape), float("nan"))
        return torch.as_tensor(self.reference_batch(rows)[rows.index(j)])

    def control_indices(self, k: int) -> list[int]:
        """The control's requests: one a batch, each in another row."""
        return [i * self.B + i % self.B for i in range(k)]

    def control(self):
        """The reference in the control's precision in the server's place,
        on full batches of consecutive requests."""
        self.batches = None

        def call(j):
            return self.reference_batch(self.batch_of(j, None))[j % self.B]

        return call

    @staticmethod
    def compare(got, want) -> dict:
        """The served row against the reference's row of its batch: relative
        L2 distance and 1 - Spearman."""
        import torch

        got, want = torch.as_tensor(got)[None], torch.as_tensor(want)[None]
        return {"mosaic_rel_err": compare.rel_err(got, want),
                "mosaic_rank_err": compare.rank_err(got, want)}

    def facts(self) -> dict:
        return {"model_flops_per_item": self.t["n_samples"] * self.row_flops()[1],
                "items_per_call": 1}
