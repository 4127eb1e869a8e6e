"""Deterministic, schedule-driven fault injection (PyTorch port of
`wam_tpu.testing.faults`).

The fleet's failover machinery — replica death re-route, quarantine
probation, supervised restart and client retry — is only trustworthy if it
is EXERCISED under systematic fault load, not just tested transition by
transition. This module is the chaos engine: a seeded per-replica fault
stream wrapped around the same entry factories production uses, so the
serve stack runs its real code paths while faults arrive at configurable
probabilities.

Fault kinds (drawn once per entry call from one uniform variate, so a
replica's fault sequence is a pure function of ``(seed, replica_id)``):

- ``exc``     — the entry raises `ChaosFault` (a non-`ServeError`): the
                fleet marks the replica dead, the supervisor restarts it.
- ``oom``     — same, with a RESOURCE_EXHAUSTED-shaped message (simulated
                device OOM; the serve layer treats any non-ServeError as a
                chip loss, so this documents the failure mode rather than
                taking a different path).
- ``nan``     — the entry's OUTPUT is poisoned with NaN: the health plane
                sees a non-finite batch (quarantine pressure, not death).
- ``latency`` — the entry sleeps ``latency_ms`` before serving (tail
                inflation; exercises retry/hedging and SLO burn).

Determinism: each replica's `FaultInjector` owns a
``random.Random(f"wam-chaos:{seed}:{rid}")`` — string seeding hashes with
a stable algorithm, so schedules reproduce across processes regardless of
``PYTHONHASHSEED``, and the same seed gives the same fault sequence as
the reference's `FaultInjector`. A replica's serve worker is
single-threaded, so the draw sequence maps 1:1 to its batch sequence.

Spec grammar::

    default                         # DEFAULT_CHAOS on every replica
    off                             # all probabilities zero
    nan=0.05,exc=0.02,latency=0.1:20   # one spec for every replica
    0:exc=0.5;*:nan=0.1             # per-replica overrides ('*' = rest)

``latency=p`` uses the default 5 ms; ``latency=p:ms`` sets both.

``PodChaosKiller`` is the process-kill chaos of the pod tier: it SIGKILLs
a worker process through `wam_tpu_torch.pod.PodRouter.kill_worker` at
seeded progress thresholds.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from dataclasses import dataclass

from wam_tpu_torch.obs import sentinel as _sentinel
from wam_tpu_torch.obs.registry import registry as _registry

__all__ = [
    "ChaosFault",
    "ChaosSchedule",
    "DEFAULT_CHAOS",
    "FaultInjector",
    "FaultSpec",
    "PodChaosKiller",
    "parse_chaos",
    "stager_chaos",
]

_c_injected = _registry.counter(
    "wam_tpu_chaos_injected_total", "faults injected by the chaos layer",
    labels=("kind", "replica"))


class ChaosFault(RuntimeError):
    """An injected entry failure. Deliberately NOT a `ServeError`: the
    fleet's `_harvest` treats it as a chip loss — replica marked dead,
    request re-routed — which is exactly the path chaos must exercise."""


@dataclass(frozen=True)
class FaultSpec:
    """Per-call fault probabilities for one replica. Probabilities are
    mutually exclusive slices of one uniform draw; their sum must be
    <= 1 (the remainder is a clean call)."""

    nan_p: float = 0.0
    exc_p: float = 0.0
    oom_p: float = 0.0
    latency_p: float = 0.0
    latency_ms: float = 5.0

    def __post_init__(self):
        total = self.nan_p + self.exc_p + self.oom_p + self.latency_p
        if not 0.0 <= total <= 1.0:
            raise ValueError(
                f"fault probabilities sum to {total:.3f}; must be in [0, 1]")


# The default chaos schedule (the reference's): per-BATCH probabilities
# under which a 2-replica run sees latency + backpressure-retry pressure and
# a 4-replica run sees several deaths/restarts, while clean batches still
# dominate.
DEFAULT_CHAOS = FaultSpec(nan_p=0.05, exc_p=0.05, oom_p=0.02,
                          latency_p=0.10, latency_ms=5.0)

_ZERO = FaultSpec()


def _parse_one(spec: str) -> FaultSpec:
    spec = spec.strip().lower()
    if spec in ("default", ""):
        return DEFAULT_CHAOS
    if spec in ("off", "none"):
        return _ZERO
    kw: dict = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, _, val = part.partition("=")
        key = key.strip()
        if key == "latency":
            p, _, ms = val.partition(":")
            kw["latency_p"] = float(p)
            if ms:
                kw["latency_ms"] = float(ms)
        elif key in ("nan", "exc", "oom"):
            kw[f"{key}_p"] = float(val)
        else:
            raise ValueError(
                f"unknown chaos fault {key!r} (want nan/exc/oom/latency)")
    return FaultSpec(**kw)


def parse_chaos(spec: str) -> dict[str, FaultSpec]:
    """Parse a chaos spec string into ``{replica_key: FaultSpec}`` —
    ``"*"`` is the every-replica default (grammar in module docstring)."""
    spec = (spec or "").strip()
    if ";" not in spec and ":" not in spec.split(",")[0].partition("=")[0]:
        return {"*": _parse_one(spec)}
    out: dict[str, FaultSpec] = {}
    for seg in spec.split(";"):
        seg = seg.strip()
        if not seg:
            continue
        head, sep, rest = seg.partition(":")
        if sep and "=" not in head:
            out[head.strip()] = _parse_one(rest)
        else:
            out["*"] = _parse_one(seg)
    return out


class FaultInjector:
    """One replica's deterministic fault stream: a private seeded RNG and
    the spec's probability partition. ``draw()`` consumes exactly one
    variate per call, so the Nth call's fault kind is reproducible."""

    def __init__(self, spec: FaultSpec, seed: int, replica=None):
        self.spec = spec
        self.replica = "-" if replica is None else str(replica)
        self._rng = random.Random(f"wam-chaos:{seed}:{self.replica}")
        self._lock = threading.Lock()
        self.counts: dict[str, int] = {}

    def draw(self) -> str | None:
        """The next call's fault kind (None = clean), from one uniform
        draw partitioned [exc | oom | nan | latency | clean]."""
        s = self.spec
        with self._lock:
            u = self._rng.random()
        edges = (("exc", s.exc_p), ("oom", s.oom_p), ("nan", s.nan_p),
                 ("latency", s.latency_p))
        acc = 0.0
        for kind, p in edges:
            acc += p
            if u < acc:
                return kind
        return None

    def fire(self, kind: str) -> None:
        with self._lock:
            self.counts[kind] = self.counts.get(kind, 0) + 1
        _c_injected.inc(kind=kind, replica=self.replica)

    def total(self) -> int:
        with self._lock:
            return sum(self.counts.values())


def _poison_nan(tree):
    """NaN-poison the first element of every floating leaf (tensor or
    array) of a result tree, on a copy."""
    import numpy as np
    import torch

    def leaf(a):
        if isinstance(a, torch.Tensor):
            if not a.is_floating_point():
                return a
            out = a.clone()
            out.view(-1)[0] = float("nan")
            return out
        arr = np.asarray(a)
        if not np.issubdtype(arr.dtype, np.inexact):
            return arr
        out = arr.copy()
        out.reshape(-1)[0] = np.nan
        return out

    if isinstance(tree, dict):
        return {k: _poison_nan(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_poison_nan(v) for v in tree)
    return leaf(tree)


class ChaosEntry:
    """Wraps a serving entry with one injector. Health-fused entries
    (``entry.wam_health``) get their health vector RECOMPUTED over the
    poisoned output — the fused vector described the clean result, and a
    poisoned batch must look poisoned to the quarantine machinery."""

    def __init__(self, inner, injector: FaultInjector):
        self._inner = inner
        self.injector = injector
        self.wam_health = bool(getattr(inner, "wam_health", False))
        # how the fleet's oversize route may split the inner entry's rows;
        # a block's partial takes the faults a call would (no NaN poisoning)
        self.wam_row_wise = bool(getattr(inner, "wam_row_wise", False))
        blocks = getattr(inner, "wam_blocks", None)
        self.wam_blocks = None
        if blocks is not None:
            from wam_tpu_torch.serve.entry import RowBlocks

            def partial(x, y, lo, total):
                self._raise_or_delay(self.injector.draw())
                return blocks.partial(x, y, lo, total)

            self.wam_blocks = RowBlocks(partial, blocks.finish)

    def _raise_or_delay(self, kind) -> None:
        if kind == "exc":
            self.injector.fire(kind)
            raise ChaosFault(
                f"chaos: injected entry failure (replica {self.injector.replica})")
        if kind == "oom":
            self.injector.fire(kind)
            raise ChaosFault(
                "RESOURCE_EXHAUSTED: chaos-simulated device OOM "
                f"(replica {self.injector.replica})")
        if kind == "latency":
            self.injector.fire(kind)
            time.sleep(self.spec_latency_s)

    def __call__(self, xs, ys):
        # warmup dispatches are exempt and consume NO draws: a warmup fault
        # would fail server start (and a restart's re-warm would perturb the
        # replica's deterministic fault stream). The serve warm path labels
        # its dispatches phase="warmup" on the calling thread.
        if _sentinel._current_labels().get("phase") == "warmup":
            return self._inner(xs, ys)
        kind = self.injector.draw()
        self._raise_or_delay(kind)
        out = self._inner(xs, ys)
        if kind == "nan":
            self.injector.fire(kind)
            if self.wam_health:
                from wam_tpu_torch.obs.health import health_stats

                res, _ = out
                res = _poison_nan(res)
                return res, health_stats(res)
            return _poison_nan(out)
        return out

    @property
    def spec_latency_s(self) -> float:
        return self.injector.spec.latency_ms / 1e3


class ChaosSchedule:
    """A parsed chaos spec + seed: builds one deterministic `FaultInjector`
    per replica and wraps entry factories for `FleetServer` /
    `AttributionServer` construction."""

    def __init__(self, specs: dict[str, FaultSpec] | FaultSpec | str = "default",
                 seed: int = 0):
        if isinstance(specs, str):
            specs = parse_chaos(specs)
        elif isinstance(specs, FaultSpec):
            specs = {"*": specs}
        self.specs = dict(specs)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._injectors: dict[str, FaultInjector] = {}

    def spec_for(self, rid) -> FaultSpec:
        key = "-" if rid is None else str(rid)
        return self.specs.get(key, self.specs.get("*", _ZERO))

    def injector(self, rid) -> FaultInjector:
        """Get-or-create the replica's injector — a restarted replica's
        fresh entry keeps the SAME fault stream (the supervisor rebuilt
        the server, not the chaos schedule)."""
        key = "-" if rid is None else str(rid)
        with self._lock:
            if key not in self._injectors:
                self._injectors[key] = FaultInjector(
                    self.spec_for(rid), self.seed, replica=rid)
            return self._injectors[key]

    def wrap_factory(self, entry_factory):
        """``entry_factory(rid, metrics, device) -> entry`` with chaos
        wrapped in. The fleet's oversize entries (one a replica device)
        share the "*" (or their own id's) stream too."""

        def factory(rid, metrics, device):
            return ChaosEntry(entry_factory(rid, metrics, device), self.injector(rid))

        return factory

    def injected_total(self) -> int:
        with self._lock:
            injectors = list(self._injectors.values())
        return sum(i.total() for i in injectors)

    def injected_counts(self) -> dict[str, int]:
        with self._lock:
            injectors = list(self._injectors.values())
        out: dict[str, int] = {}
        for i in injectors:
            for kind, n in i.counts.items():
                out[kind] = out.get(kind, 0) + n
        return out


class PodChaosKiller:
    """Process-kill chaos for the pod tier: SIGKILL a live worker each
    time the driven request count crosses a progress threshold.

    Where `ChaosSchedule` injects faults INSIDE a process (entry raises,
    NaN poison, staging latency), this kills the process itself — the
    failure mode the pod tier exists to survive. Deterministic like the
    rest of the chaos layer: thresholds are fixed fractions of the
    planned request count and the victim at each crossing comes from a
    seeded RNG over the live worker ids, so a failing chaos run replays
    exactly (`random.Random(f"wam-pod-chaos:{seed}")`).

    Drive it from the client loop: ``on_progress(resolved_so_far)`` after
    every resolved request; at most one kill fires per threshold
    crossing, and kills land mid-stream by construction (fractions
    strictly inside (0, 1)). The kill goes through
    `PodRouter.kill_worker`, so detection, in-flight re-route, and
    supervised respawn all exercise the REAL failure paths — nothing is
    mocked."""

    def __init__(self, router, total_requests: int, *,
                 fractions=(0.25, 0.6), seed: int = 0):
        for f in fractions:
            if not 0.0 < f < 1.0:
                raise ValueError(f"kill fraction {f} not inside (0, 1)")
        self._router = router
        self._thresholds = sorted(
            max(1, int(f * total_requests)) for f in fractions)
        self._rng = random.Random(f"wam-pod-chaos:{seed}")
        self._lock = threading.Lock()
        self._fired = 0
        self.kills: list[dict] = []

    def on_progress(self, resolved: int) -> None:
        """Fire every threshold ``resolved`` has crossed (one victim
        each). Thread-safe; a crossing with zero live workers is consumed
        without a kill (the pod is already fully down — nothing to do)."""
        while True:
            with self._lock:
                if (self._fired >= len(self._thresholds)
                        or resolved < self._thresholds[self._fired]):
                    return
                threshold = self._thresholds[self._fired]
                self._fired += 1
                live = self._router.live_worker_ids()
                wid = (live[self._rng.randrange(len(live))] if live else None)
            killed = wid is not None and self._router.kill_worker(wid)
            if killed:
                _c_injected.inc(kind="kill", replica=str(wid))
            with self._lock:
                self.kills.append({"threshold": threshold,
                                   "worker_id": wid, "killed": killed})


@contextlib.contextmanager
def stager_chaos(injector: FaultInjector):
    """Inject faults at the STAGING hook: patches the serve runtime's
    ``put_committed`` so H2D uploads sleep (``latency``) or raise
    (``exc``/``oom`` → dispatch-time failure, the `_launch_batch` recover
    path) per the injector's stream. Explicitly a test-harness context
    manager — the only patched internal in the chaos layer."""
    from wam_tpu_torch.serve import runtime

    orig = runtime.put_committed

    def staged(tree, dev):
        kind = injector.draw()
        if kind in ("exc", "oom"):
            injector.fire(kind)
            raise ChaosFault(f"chaos: injected staging failure ({kind})")
        if kind == "latency":
            injector.fire(kind)
            time.sleep(injector.spec.latency_ms / 1e3)
        return orig(tree, dev)

    runtime.put_committed = staged
    try:
        yield injector
    finally:
        runtime.put_committed = orig
