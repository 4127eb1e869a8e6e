"""Timing utilities (PyTorch port of the part of `wam_tpu.profiling` the
serving runtime stands on): `StageTimer`, the accumulating wall-clock
timer whose stages the serve ledger decomposes by, `device_sync`, which
closes a timed region, and `median_iqr`.

The reference's profiler readers (``trace``, ``start_server``,
``profile_to``, ``bench_time``, ``bench_samples``, ``device_time_samples``,
``h2d_stats``, ``named_op_split``, ``synth_device_split``,
``metric_fetch_split``) read XLA's xplane traces; their `torch.profiler`
counterparts wait for ROADMAP.md slice E.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

__all__ = ["StageTimer", "device_sync", "median_iqr"]


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
