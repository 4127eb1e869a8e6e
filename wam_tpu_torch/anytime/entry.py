"""Checkpointed attribution entries (PyTorch port of `wam_tpu.anytime.entry`).

An anytime entry splits a sample-mean estimator into three calls that a
caller runs stride by stride:

- ``begin(x, y) -> state``         the zero state: sum accumulator, Welford
                                   M2, sample count, checkpoint snapshot and
                                   its count, confidence vector
- ``step(state, x, y) -> state``   ``stride`` samples added one at a time,
                                   then the confidence vector
- ``finalize(state) -> (attr, conf)``  the running mean through the
                                   caller's finalize, and the (B,
                                   ANYTIME_VEC_SIZE) confidence vector

``confidence(state)`` reads the state's confidence vector (no computation):
the stride loop's progress check copies that small tensor to the host,
a control-plane wait, not a result fetch.

The state tuple is the reference's ``(acc, m2, count, prev_acc, prev_count,
conf)``. The counts are Python ints: eager PyTorch knows them on the host,
and the confidence vector carries the count on the device (slot 0). The
samples are added one by one in index order, ``acc <- acc + g_i``, so the
finalized map at count n is bit-equal for every stride. Past ``n_total`` a
sample has weight 0, as in the reference's masked stride; eager code skips
it instead of computing it and multiplying by 0. The zero accumulator trees
are made by the first sample (the reference sizes them with ``eval_shape``,
which costs a trace; here it would cost a sample).

``on_trace`` and ``obs_kind``: each of begin / step / finalize reports its
first call at a new input signature (`serve.entry.signature` of ``(x, y)``;
finalize: of the confidence vector) to the first-call sentinel
(`wam_tpu_torch.obs.sentinel`) under ``obs_kind`` and fires ``on_trace`` —
the port's counterpart of the reference's three jit traces, so an anytime
bucket warms at 3 first calls, not 1.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from wam_tpu_torch.anytime.state import ANYTIME_VEC_SIZE, conf_stats, m2_update, tree_map
from wam_tpu_torch.obs import sentinel as obs_sentinel

__all__ = ["AnytimeEntry", "make_anytime_entry", "DEFAULT_PLATEAU_TOL"]

# relative motion per checkpoint under which an input counts as converged
# (the early-exit trigger): about half a percent of the map's RMS a stride
DEFAULT_PLATEAU_TOL = 5e-3


class AnytimeEntry:
    """The begin / step / confidence / finalize bundle (module docstring),
    built by `make_anytime_entry`; `anytime.driver.drive_anytime` runs it,
    and ``entry(x, y)`` is the full-n path (every stride, the finalized
    attribution alone)."""

    wam_anytime = True

    def __init__(self, begin, step, finalize, *, n_total: int, stride: int,
                 plateau_tol: float, name: str):
        self.begin = begin
        self.step = step
        self.finalize = finalize
        self.n_total = int(n_total)
        self.stride = int(stride)
        self.plateau_tol = float(plateau_tol)
        self.__name__ = name

    def confidence(self, state) -> torch.Tensor:
        """The state's confidence vector, on the device."""
        return state[-1]

    def n_strides(self) -> int:
        return -(-self.n_total // self.stride)

    def __call__(self, x, y):
        state = self.begin(x, y)
        for _ in range(self.n_strides()):
            state = self.step(state, x, y)
        out, _conf = self.finalize(state)
        return out


def make_anytime_entry(
    sample_fn: Callable,
    finalize_fn: Callable | None = None,
    *,
    n_total: int,
    stride: int = 5,
    plateau_tol: float = DEFAULT_PLATEAU_TOL,
    on_trace: Callable[[], None] | None = None,
    obs_kind: str = "serve",
    name: str = "anytime_entry",
) -> AnytimeEntry:
    """An `AnytimeEntry` from a per-sample step.

    ``sample_fn(x, y, i) -> g`` is sample ``i``'s contribution (a tensor or
    a tree of them, each with a leading batch axis), whose mean over
    ``n_total`` samples is the attribution; ``finalize_fn(mean) -> attr``
    post-processes the mean (identity when None). ``stride`` is the
    checkpoint cadence k, samples a `step`."""
    if n_total < 1:
        raise ValueError(f"n_total must be >= 1, got {n_total}")
    if not 1 <= stride <= n_total:
        raise ValueError(f"stride must be in [1, n_total={n_total}], got {stride}")
    if finalize_fn is None:
        finalize_fn = lambda mean: mean  # noqa: E731
    from wam_tpu_torch.serve.entry import signature

    seen: set = set()

    def _first_call(detail: str, *args) -> None:
        key = (detail, signature(*args))
        if key in seen:
            return
        seen.add(key)
        obs_sentinel.record_trace(obs_kind, detail=f"{name}:{detail}")
        if on_trace is not None:
            on_trace()

    def begin(x, y):
        _first_call("begin", x, y)
        b, dev = x.shape[0], torch.as_tensor(x).device
        return (None, torch.zeros((b,), dtype=torch.float32, device=dev), 0, None, 0,
                torch.zeros((b, ANYTIME_VEC_SIZE), dtype=torch.float32, device=dev))

    def step(state, x, y):
        _first_call("step", x, y)
        acc, m2, count, prev_acc, prev_count, _ = state
        for _ in range(stride):
            if count >= n_total:  # weight 0 past n_total: inert
                break
            g = sample_fn(x, y, count)
            if acc is None:
                acc = prev_acc = tree_map(torch.zeros_like, g)
            acc_new = tree_map(lambda a, b: a + b.to(a.dtype), acc, g)
            m2 = m2_update(m2, acc, acc_new, count)
            acc, count = acc_new, count + 1
        conf = conf_stats(acc, m2, count, prev_acc, prev_count)
        # the snapshot the NEXT stride's delta is measured against
        return (acc, m2, count, acc, count, conf)

    def finalize(state):
        acc, _m2, count, _pa, _pc, conf = state
        _first_call("finalize", conf)
        # the reference's float32 reciprocal, exact as a Python float
        scale = float(np.float32(1.0) / np.float32(max(count, 1)))
        mean = tree_map(lambda a: (a.float() * scale).to(a.dtype), acc)
        return finalize_fn(mean), conf

    return AnytimeEntry(begin, step, finalize, n_total=n_total, stride=stride,
                        plateau_tol=plateau_tol, name=name)
