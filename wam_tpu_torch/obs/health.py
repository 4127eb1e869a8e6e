"""Numeric-health monitoring (health-plane pillar 1; PyTorch port of
`wam_tpu.obs.health`).

WAM's output quality rests on a numerically delicate chain — differentiable
IDWT reconstruction, bf16 analysis with f32 accumulation, gradient
estimators that need explicit ``nan_to_num`` hygiene — and this module is
what watches it in production. The design constraint is the one the eval
fan engine lives by: **zero extra result fetches**. `health_stats` is a
torch reduction producing one tiny fixed-size vector on the result's
device that rides *inside* the result tree already being fetched:

- computed inside the serving entry when it was built with
  ``serve_entry(with_health=True)`` (`serve.entry.jit_entry`) — the stats
  are one more output of the same call;
- computed post-hoc by the serve worker (`batch_stats`) for entries that
  are not health-fused (fake entries, user callables) — a few more
  reductions enqueued behind the result, still harvested in the worker's
  single `evalsuite.fan.device_fetch`;
- computed by the eval fan (`evalsuite.fan.run_fan`) over each metric's
  result and fetched with it in the metric's single `device_fetch`
  (switch: `set_fan_health`, on by default, and the obs enabled flag).

The host side (`summarize`, `publish_stats`, `HealthMonitor`) turns the
vector into ``wam_tpu_health_*`` registry series and the quarantine
decision: N consecutive non-finite batches mark a server degraded, and
after ``recovery_s`` it accepts probe traffic again and one healthy batch
clears the quarantine.

This module imports only the standard library at import time; torch and
numpy are imported inside the helpers that need them.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass

from wam_tpu_torch.obs.registry import registry as _registry

__all__ = [
    "HEALTH_VEC_SIZE",
    "SAT_THRESHOLD",
    "health_stats",
    "combine_output_grads",
    "merge_stats",
    "batch_stats",
    "summarize",
    "publish_stats",
    "HealthConfig",
    "HealthMonitor",
    "fan_health_enabled",
    "set_fan_health",
]

# The on-device vector layout (f32, fixed size so every health-fused graph
# has the same extra output shape):
#   [0] non-finite element count (output tree + gradient tree when given)
#   [1] total inexact elements behind [0]
#   [2] saturation count over the OUTPUT: |v| >= SAT_THRESHOLD
#   [3] output element count (denominator of the saturation fraction)
#   [4] max |v| over the output
#   [5] sum of squares over the GRADIENTS (output when no gradient tree) —
#       grad_norm = sqrt of this, the per-call grad-norm summary
HEALTH_VEC_SIZE = 6

# Engines max-normalize attribution mosaics into [0, 1]; a value this close
# to the top of the range counts as saturated (a clipped/flat attribution).
SAT_THRESHOLD = 0.995

# -- device side (torch reductions, no host sync) ----------------------------


# Eval-fan health piggyback switch (module-level: the fan has no server
# object to carry per-instance config). Gated on the obs enabled flag too.
_FAN_HEALTH = True


def set_fan_health(enabled: bool) -> None:
    global _FAN_HEALTH
    _FAN_HEALTH = bool(enabled)


def fan_health_enabled() -> bool:
    """Whether `evalsuite.fan.run_fan` should piggyback health stats onto
    its single fetch: the module switch AND the obs enabled flag."""
    from wam_tpu_torch.obs import tracing as _tracing

    return _FAN_HEALTH and _tracing._STATE.enabled


def _leaves(tree) -> list:
    """Tensor and array leaves of a tensor / array / tuple / list / dict
    tree, as tensors (numpy arrays are wrapped without a copy)."""
    import numpy as np
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, np.ndarray):
        return [torch.from_numpy(np.ascontiguousarray(tree))]
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return []


def _inexact_leaves(tree) -> list:
    return [leaf for leaf in _leaves(tree)
            if leaf.is_floating_point() or leaf.is_complex()]


def health_stats(out, grads=None, *, sat_threshold: float = SAT_THRESHOLD):
    """The on-device health reduction: one ``(HEALTH_VEC_SIZE,)`` float32
    vector over an attribution output tree (and optionally the coefficient
    gradients behind it), on the first leaf's device. Reductions only, so
    calling it inside a serving entry enqueues a few small kernels behind
    the result and never waits on the device. Counts are float32 sums
    (exact to 2**24 elements — far above any serve batch), as in the
    reference."""
    import torch

    leaves = _inexact_leaves(out)
    if not leaves:
        return torch.zeros((HEALTH_VEC_SIZE,), dtype=torch.float32)
    gleaves = _inexact_leaves(grads) if grads is not None else []
    if not gleaves:
        grads = None  # no gradient tree (or nothing inexact in it)
        gleaves = leaves
    dev = leaves[0].device

    def _nonfinite(t):
        return (~torch.isfinite(t)).sum(dtype=torch.float32).to(dev)

    f32 = torch.float32
    nonfinite = sum(_nonfinite(t) for t in leaves)
    total = float(sum(t.numel() for t in leaves))
    if grads is not None:
        nonfinite = nonfinite + sum(_nonfinite(t) for t in gleaves)
        total += float(sum(t.numel() for t in gleaves))
    # NaN compares False under >=, so a poisoned batch shows up in the
    # non-finite count, not a phantom saturation count
    sat = sum((t.abs() >= sat_threshold).sum(dtype=f32).to(dev) for t in leaves)
    out_count = float(sum(t.numel() for t in leaves))
    max_abs = torch.stack([t.to(f32).abs().amax().to(dev) for t in leaves]).amax()
    sumsq = sum(t.to(f32).square().sum().to(dev) for t in gleaves)
    # the counts are filled on the device (torch.full), not copied from the
    # host: a host-to-device copy of a scalar would wait on the device
    return torch.stack([
        nonfinite, torch.full((), total, dtype=f32, device=dev), sat,
        torch.full((), out_count, dtype=f32, device=dev), max_abs, sumsq,
    ])


def combine_output_grads(out_vec, grad_vec):
    """Merge an output-tree vector with a gradient-tree vector into one:
    non-finite/total pool both trees, saturation/max stay output-only, the
    grad-norm sum-of-squares comes from the gradients. Used by health-fused
    engine entries (`core.engine.WamEngine.attribute_with_health`)."""
    import torch

    return torch.stack([
        out_vec[0] + grad_vec[0],
        out_vec[1] + grad_vec[1],
        out_vec[2], out_vec[3], out_vec[4],
        grad_vec[5],
    ])


def merge_stats(vecs):
    """One vector for a batch computed in blocks of its rows (the fleet's
    oversize route, `serve.entry.RowBlocks`): the counts and the sum of
    squares add up, the max |v| is the max over the blocks. Host arrays or
    tensors in; a float32 numpy vector out."""
    import numpy as np

    a = np.stack([np.asarray(v, dtype=np.float32) for v in vecs])
    out = a.sum(axis=0, dtype=np.float32)
    out[4] = a[:, 4].max()
    return out


def batch_stats(out):
    """The health reduction for a result tree that is NOT health-fused
    (fake entries, arbitrary callables): the same `health_stats`, enqueued
    behind the result. The caller harvests it together with the result in
    its one existing fetch (`serve.runtime._complete`)."""
    return health_stats(out)


# -- host side --------------------------------------------------------------


def summarize(vec) -> dict:
    """Host-side view of a fetched health vector."""
    import numpy as np

    if hasattr(vec, "detach"):  # a tensor: copied to the host here
        vec = vec.detach().cpu().numpy()
    v = [float(x) for x in np.asarray(vec).reshape(-1)]
    nonfinite, total, sat, out_n, max_abs, sumsq = v[:HEALTH_VEC_SIZE]
    return {
        "nonfinite": int(nonfinite),
        "total": int(total),
        "finite": nonfinite == 0.0,
        "sat_frac": sat / out_n if out_n else 0.0,
        "max_abs": max_abs,
        # sqrt(NaN) is NaN, which is the honest grad norm of a poisoned batch
        "grad_norm": math.sqrt(sumsq) if sumsq == sumsq and sumsq >= 0.0
        else float("nan"),
    }


def _label(value) -> str:
    return "-" if value is None else str(value)


_c_checks = _registry.counter(
    "wam_tpu_health_checks_total", "health vectors evaluated",
    labels=("source", "replica"))
_c_bad_batches = _registry.counter(
    "wam_tpu_health_nonfinite_batches_total",
    "batches whose output carried any NaN/Inf", labels=("source", "replica"))
_c_bad_values = _registry.counter(
    "wam_tpu_health_nonfinite_values_total",
    "individual non-finite elements observed", labels=("source", "replica"))
_g_sat = _registry.gauge(
    "wam_tpu_health_saturation_fraction",
    "fraction of output elements at/above the saturation threshold",
    labels=("source", "replica", "bucket"))
_g_maxabs = _registry.gauge(
    "wam_tpu_health_max_abs", "max |output| of the last checked batch",
    labels=("source", "replica", "bucket"))
_g_gnorm = _registry.gauge(
    "wam_tpu_health_grad_norm", "grad-norm summary of the last checked batch",
    labels=("source", "replica", "bucket"))
_g_quarantined = _registry.gauge(
    "wam_tpu_health_quarantined",
    "1 while the replica is quarantined by the health monitor",
    labels=("replica",))
_g_consecutive = _registry.gauge(
    "wam_tpu_health_consecutive_nonfinite",
    "current run of consecutive non-finite batches", labels=("replica",))


def publish_stats(vec, *, source: str, replica=None, bucket=None) -> bool:
    """Publish one fetched health vector to the ``wam_tpu_health_*`` series.
    Returns whether the batch was finite (the quarantine input)."""
    s = summarize(vec)
    src, rl, bk = _label(source), _label(replica), _label(bucket)
    _c_checks.inc(source=src, replica=rl)
    if not s["finite"]:
        _c_bad_batches.inc(source=src, replica=rl)
        _c_bad_values.inc(s["nonfinite"], source=src, replica=rl)
    _g_sat.set(s["sat_frac"], source=src, replica=rl, bucket=bk)
    _g_maxabs.set(s["max_abs"], source=src, replica=rl, bucket=bk)
    _g_gnorm.set(s["grad_norm"], source=src, replica=rl, bucket=bk)
    return s["finite"]


@dataclass(frozen=True)
class HealthConfig:
    """Quarantine policy knobs (`ServeConfig.health_*` surfaces them on the
    CLI). ``quarantine_after`` consecutive non-finite batches mark the
    replica degraded; after the recovery window it accepts probe traffic
    again and ``clear_after`` consecutive healthy batches clear the state
    (a bad probe re-arms it). The recovery window ESCALATES on every
    re-quarantine — ``recovery_s × backoff_factor^(arms-1)``, capped at
    ``max_recovery_s`` — and the escalation survives clears: a replica
    flapping between poisoned and healthy bursts would otherwise oscillate
    quarantine↔probation at a constant period forever, while escalating
    windows bound the transition count logarithmically (the hysteresis the
    chaos tests pin). Operators can forgive a fixed replica with
    `HealthMonitor.reset_escalation`."""

    enabled: bool = True
    quarantine_after: int = 3
    recovery_s: float = 30.0
    sat_threshold: float = SAT_THRESHOLD
    clear_after: int = 1
    backoff_factor: float = 2.0
    max_recovery_s: float = 300.0


class HealthMonitor:
    """Per-server quarantine state machine over the batch health stream.

    ``note(vec)`` is called by the serve worker once per harvested batch
    (before results are distributed, so routing observes the updated state
    no later than the client sees the result); ``ok()`` is read by the
    fleet router. Thread-safe; ``now`` is injectable for deterministic
    tests."""

    def __init__(self, config: HealthConfig | None = None, *, replica_id=None):
        self.config = config if config is not None else HealthConfig()
        self.replica_id = replica_id
        self._rl = _label(replica_id)
        self._lock = threading.Lock()
        self._consecutive = 0
        self._consecutive_ok = 0
        self._quarantined_at: float | None = None
        self._arms = 0  # quarantine entries ever; NOT reset on clear
        self.checks = 0
        self.nonfinite_batches = 0

    def _recovery_window_locked(self) -> float:
        """Current probation delay: the configured window escalated by how
        many times this replica has been quarantined (caller holds lock)."""
        c = self.config
        return min(c.max_recovery_s,
                   c.recovery_s * c.backoff_factor ** max(0, self._arms - 1))

    def note(self, vec, *, bucket=None, now: float | None = None) -> bool:
        """Record one batch's health vector; returns whether it was finite."""
        finite = publish_stats(vec, source="serve", replica=self.replica_id,
                               bucket=bucket)
        now = time.perf_counter() if now is None else now
        with self._lock:
            self.checks += 1
            if finite:
                self._consecutive = 0
                self._consecutive_ok += 1
                if self._consecutive_ok >= self.config.clear_after:
                    self._quarantined_at = None
            else:
                self.nonfinite_batches += 1
                self._consecutive_ok = 0
                self._consecutive += 1
                if self._consecutive >= self.config.quarantine_after:
                    # (re-)arm: a bad probe during probation restarts the
                    # recovery clock; only the None->armed transition
                    # escalates (a long bad burst is one quarantine, not N)
                    if self._quarantined_at is None:
                        self._arms += 1
                    self._quarantined_at = now
            _g_consecutive.set(self._consecutive, replica=self._rl)
            _g_quarantined.set(0.0 if self._quarantined_at is None else 1.0,
                               replica=self._rl)
        return finite

    @property
    def quarantined(self) -> bool:
        with self._lock:
            return self._quarantined_at is not None

    def ok(self, now: float | None = None) -> bool:
        """Routing predicate: healthy, or quarantined-but-probational
        (``recovery_s`` elapsed — let probe traffic through so a recovered
        replica can prove itself)."""
        if not self.config.enabled:
            return True
        with self._lock:
            if self._quarantined_at is None:
                return True
            now = time.perf_counter() if now is None else now
            return (now - self._quarantined_at) >= self._recovery_window_locked()

    def reset_escalation(self) -> None:
        """Operator forgiveness: drop the escalated recovery window back to
        the configured base (e.g. after the poisoning cause was fixed)."""
        with self._lock:
            self._arms = min(self._arms, 1)

    def describe(self) -> dict:
        with self._lock:
            return {
                "checks": self.checks,
                "nonfinite_batches": self.nonfinite_batches,
                "consecutive_nonfinite": self._consecutive,
                "quarantined": self._quarantined_at is not None,
                "quarantine_arms": self._arms,
                "recovery_window_s": self._recovery_window_locked(),
            }
