"""Multi-model residency: memory-aware model paging for the serving plane
(PyTorch port of `wam_tpu.serve.models`).

One `AttributionServer` serves its default entry and, through ``models=``,
more model families behind the same admission plane, treating MODELS the
way the runtime treats buckets: as pageable device residents under a byte
budget.

`ModelSpec` declares one servable model: a zero-arg ``factory`` building
its serving entry, the bucket subset it serves, and a device-footprint
estimate. (The reference's ``registry`` bundle, which makes a page-in a
hydration rather than a compile, waits for the port's ``registry/*``,
ROADMAP.md: a spec that names one raises NotImplementedError.)
`ModelPager` owns the residency state machine:

- **Page-in** (`ensure`): the first `submit(model=...)` for a non-resident
  model pays the switch synchronously — entry build and per-bucket warmup
  dispatches run under the model's own build lock inside a
  ``model_switch`` obs span, so concurrent submits for the same cold model
  block on ONE build instead of racing N.
- **Eviction**: under a byte budget (the server's `MemoryBudget`,
  `ServeConfig.hbm_budget_mb`) the pager evicts the least-valuable
  resident first — LRU weighted by the model's mean EMA service time:
  ``score = idle_s / max(ema_s, EMA_SEED_S)``, so an old AND cheap model
  pages out before a recently-hot or expensive one. A model with queued or
  in-flight work is NEVER evicted (``busy_fn``); when nothing evictable
  frees enough bytes the page-in is refused as ordinary memory
  backpressure (`MemoryAdmissionError`). An evicted entry's tensors go
  back to the caching allocator when its last reference dies.
- **Kill switch**: ``WAM_TPU_NO_MODEL_PAGING=1`` disables the budget and
  the evictor (models still page in, nothing pages out, nothing is
  refused).

The default model (``model=None``) is pinned by the runtime and never
enters the pager. Instrumentation: ``wam_tpu_serve_model_pagein_total`` /
``_pagein_seconds`` / ``_pageout_total`` / ``_resident`` /
``_resident_bytes`` (declared in `obs/schema.py`).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

from wam_tpu_torch.obs.registry import registry as _obs_registry

__all__ = ["ModelSpec", "ModelPager", "model_paging_disabled"]

_c_pagein = _obs_registry.counter(
    "wam_tpu_serve_model_pagein_total",
    "model page-ins (hydration + build + warmup)",
    labels=("replica", "model"))
_h_pagein_s = _obs_registry.histogram(
    "wam_tpu_serve_model_pagein_seconds",
    "model switch latency: submit blocked on page-in",
    labels=("replica", "model"))
_c_pageout = _obs_registry.counter(
    "wam_tpu_serve_model_pageout_total",
    "model evictions under the HBM budget",
    labels=("replica", "model"))
_g_resident = _obs_registry.gauge(
    "wam_tpu_serve_model_resident",
    "resident paged models on this server", labels=("replica",))
_g_resident_bytes = _obs_registry.gauge(
    "wam_tpu_serve_model_resident_bytes",
    "summed device-footprint estimate of resident paged models",
    labels=("replica",))


def model_paging_disabled() -> bool:
    """``WAM_TPU_NO_MODEL_PAGING=1`` kill switch, read per call so flipping
    the env var takes effect without a restart (the serve kill-switch
    convention — `WAM_TPU_NO_RESULT_CACHE` et al.)."""
    return os.environ.get("WAM_TPU_NO_MODEL_PAGING", "") not in ("", "0")


@dataclass
class ModelSpec:
    """One servable model on a multiplexed server.

    ``factory`` is a ZERO-ARG callable building the model's serving entry.
    ``registry`` (the reference's compile-artifact bundle) must stay None
    until the port's ``registry/*`` lands (module docstring). ``buckets``
    restricts the model to a subset of the server's
    bucket shapes (None = every bucket). ``est_bytes`` overrides the
    shape-derived device-footprint estimate (0 = derive). ``cache_id``
    names the model in result-cache keys (defaults to ``model_id``)."""

    model_id: str
    factory: object
    registry: object = None
    buckets: object = None
    est_bytes: int = 0
    cache_id: str | None = None

    def __post_init__(self):
        if not self.model_id:
            raise ValueError("ModelSpec needs a non-empty model_id")
        if "|" in self.model_id or "@" in self.model_id:
            # '|' delimits model-prefixed EMA/watermark keys, '@' the SLO
            # ladder segments — a model id containing either would alias
            raise ValueError(
                f"model_id must not contain '|' or '@': {self.model_id!r}")
        if not callable(self.factory):
            raise TypeError("ModelSpec.factory must be a zero-arg callable")
        if self.registry is not None and self.registry != "":
            raise NotImplementedError(
                "ModelSpec(registry=) needs the compile-artifact registry, registry/*, "
                "which is not ported yet (ROADMAP.md, slice F)")


@dataclass
class _Resident:
    spec: ModelSpec
    entry: object
    nbytes: int
    paged_in_at: float
    last_used: float = field(default=0.0)
    pagein_s: float = 0.0


class ModelPager:
    """Residency state machine for one server's paged models (module
    docstring). Thread-safe: a meta lock guards the resident map, one
    build lock per model serializes its page-in.

    ``budget_bytes`` bounds the summed footprint estimates of resident
    paged models (None = unbounded). ``ema_fn(model_id) -> float`` returns
    the model's mean EMA batch service time (the eviction weight);
    ``busy_fn(model_id) -> bool`` answers whether the model has queued or
    in-flight work (evictions of busy models are refused)."""

    def __init__(self, specs, *, budget_bytes=None, replica_id=None,
                 ema_fn=None, busy_fn=None, retry_after_s: float = 1.0):
        if isinstance(specs, dict):
            specs = list(specs.values())
        self.specs: dict[str, ModelSpec] = {}
        for spec in specs or []:
            if not isinstance(spec, ModelSpec):
                spec = ModelSpec(**spec)
            if spec.model_id in self.specs:
                raise ValueError(f"duplicate model_id {spec.model_id!r}")
            self.specs[spec.model_id] = spec
        self.budget_bytes = int(budget_bytes) if budget_bytes else None
        self.replica_id = replica_id
        self._rl = "-" if replica_id is None else str(replica_id)
        self._ema_fn = ema_fn or (lambda mid: 0.0)
        self._busy_fn = busy_fn or (lambda mid: False)
        self.retry_after_s = retry_after_s
        self._meta = threading.Lock()
        self._resident: dict[str, _Resident] = {}
        self._locks: dict[str, threading.Lock] = {
            mid: threading.Lock() for mid in self.specs}
        self.pageins = 0
        self.pageouts = 0

    # -- queries ------------------------------------------------------------

    def is_resident(self, model_id: str) -> bool:
        with self._meta:
            return model_id in self._resident

    def resident(self) -> dict[str, int]:
        """``{model_id: footprint_bytes}`` of resident paged models."""
        with self._meta:
            return {mid: r.nbytes for mid, r in self._resident.items()}

    def resident_bytes(self) -> int:
        with self._meta:
            return sum(r.nbytes for r in self._resident.values())

    def entry(self, model_id: str):
        """The resident entry, touching its LRU clock. KeyError when the
        model is not resident (callers `ensure` first)."""
        with self._meta:
            r = self._resident[model_id]
            r.last_used = time.perf_counter()
            return r.entry

    def touch(self, model_id: str) -> None:
        with self._meta:
            r = self._resident.get(model_id)
            if r is not None:
                r.last_used = time.perf_counter()

    def describe(self) -> dict:
        with self._meta:
            return {
                "models": sorted(self.specs),
                "resident": {mid: {"bytes": r.nbytes,
                                   "pagein_s": r.pagein_s}
                             for mid, r in self._resident.items()},
                "budget_bytes": self.budget_bytes,
                "pageins": self.pageins,
                "pageouts": self.pageouts,
                "paging_disabled": model_paging_disabled(),
            }

    # -- page-in ------------------------------------------------------------

    def ensure(self, model_id: str, page_in_fn):
        """Resident entry for ``model_id``, paging it in when cold.
        ``page_in_fn(spec) -> (entry, nbytes)`` does the server-side work
        (build, warmup) and runs under the model's build lock —
        concurrent submits for the same cold model serialize here and the
        losers find it resident. Eviction under the byte budget happens
        BEFORE the build so the incoming model's warmup allocates into
        freed headroom."""
        spec = self.specs.get(model_id)
        if spec is None:
            raise KeyError(f"unknown model {model_id!r}; "
                           f"configured: {sorted(self.specs)}")
        with self._locks[model_id]:
            with self._meta:
                r = self._resident.get(model_id)
                if r is not None:
                    r.last_used = time.perf_counter()
                    return r.entry
            est = self._estimate(spec)
            self._make_room(model_id, est)
            t0 = time.perf_counter()
            entry, nbytes = page_in_fn(spec)
            pagein_s = time.perf_counter() - t0
            now = time.perf_counter()
            with self._meta:
                self._resident[model_id] = _Resident(
                    spec, entry, int(nbytes or est), now,
                    last_used=now, pagein_s=pagein_s)
                self.pageins += 1
                n, total = len(self._resident), sum(
                    r.nbytes for r in self._resident.values())
            _c_pagein.inc(replica=self._rl, model=model_id)
            _h_pagein_s.observe(pagein_s, replica=self._rl, model=model_id)
            _g_resident.set(n, replica=self._rl)
            _g_resident_bytes.set(total, replica=self._rl)
            return entry

    def _estimate(self, spec: ModelSpec) -> int:
        return int(spec.est_bytes) if spec.est_bytes else 0

    def set_estimate(self, model_id: str, nbytes: int) -> None:
        """Refine a resident model's footprint after warmup captured a
        real watermark (the `MemoryBudget` device-peak path)."""
        with self._meta:
            r = self._resident.get(model_id)
            if r is not None and nbytes > 0:
                r.nbytes = int(nbytes)

    # -- eviction -----------------------------------------------------------

    def _make_room(self, incoming: str, est_bytes: int) -> None:
        """Evict idle residents (LRU weighted by EMA service time) until
        ``est_bytes`` fits under the budget; refuse with memory
        backpressure when busy models pin the budget. No-op without a
        budget or with paging disabled. Caller holds the incoming model's
        build lock (never the meta lock)."""
        if self.budget_bytes is None or model_paging_disabled():
            return
        while True:
            with self._meta:
                used = sum(r.nbytes for r in self._resident.values())
                if used + est_bytes <= self.budget_bytes:
                    return
                now = time.perf_counter()
                victims = sorted(
                    ((mid, r) for mid, r in self._resident.items()
                     if mid != incoming),
                    key=lambda it: self._evict_score(it[0], it[1], now),
                    reverse=True)
            evicted = False
            for mid, _ in victims:
                if self._busy_fn(mid):
                    continue  # queued/in-flight work: never evicted
                if self._evict(mid):
                    evicted = True
                    break
            if not evicted:
                from wam_tpu_torch.serve.runtime import MemoryAdmissionError

                raise MemoryAdmissionError(
                    self.retry_after_s, bucket=f"model:{incoming}")

    def _evict_score(self, mid: str, r: _Resident, now: float) -> float:
        """Higher = evict first: idle seconds over the model's mean EMA
        batch service time (seeded), so old-and-cheap pages out before
        recently-hot-or-expensive."""
        from wam_tpu_torch.serve.metrics import EMA_SEED_S

        ema = self._ema_fn(mid) or 0.0
        return (now - r.last_used) / max(ema, EMA_SEED_S)

    def _evict(self, model_id: str) -> bool:
        """Drop one resident (its entry object is released; its tensors go
        back to the caching allocator when the last reference dies). Rechecks busy-ness
        under the meta lock against the map it mutates."""
        with self._meta:
            r = self._resident.get(model_id)
            if r is None:
                return False
            del self._resident[model_id]
            self.pageouts += 1
            n, total = len(self._resident), sum(
                x.nbytes for x in self._resident.values())
        _c_pageout.inc(replica=self._rl, model=model_id)
        _g_resident.set(n, replica=self._rl)
        _g_resident_bytes.set(total, replica=self._rl)
        return True
