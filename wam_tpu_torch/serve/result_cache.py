"""Content-addressed attribution result cache (the serve admission tier;
PyTorch port of `wam_tpu.serve.result_cache`).

WAM attribution is DETERMINISTIC per (input, label, entry, schedule): the
engines derive their SmoothGrad noise from a fixed per-entry RNG path, the
serve runtime's replicate-batch padding keeps real rows bit-identical
regardless of batch fill, and tuned schedules are the only knob that moves
the sampling chunking (and with it the noise realization). So a repeated
query — the Zipf head of real traffic, viral inputs, retried clients — can
be answered from a byte-bounded cache with EXACT results, not approximate
ones.

Key = ``sha256(input bytes | shape | dtype) | label | cache_id |
schedule_fingerprint | precision_tag``:

- the input digest covers the raw bytes plus shape/dtype, so a reshaped
  or recast array never collides;
- ``cache_id`` names the entry/model/method this cache serves. A cache is
  only shared between servers running the SAME logical entry (fleet
  replicas built from one factory); callers serving multiple entries from
  one cache must pass distinguishing ids;
- the schedule fingerprint is `schedule_fingerprint()`, the digest of the
  loaded schedule table (`tune.cache.schedule_fingerprint`): it changes
  whenever a tuned schedule lands;
- the precision tag (the port's `config.precision_tag`) covers
  env-routed precision flips (``WAM_TPU_FAN_DTYPE`` /
  ``WAM_TPU_MEL_BF16``) — a bf16 run can never replay a cached f32
  result or vice versa.

Placement: `AttributionServer.submit` / `FleetServer.submit` consult the
cache BEFORE admission — a hit resolves the future immediately and never
touches the bounded queue, memory admission, or a batch slot (DESIGN.md
"Admission & coalescing"). Population happens at harvest: each real row of
a completed batch is stored host-side.

Bounding: a plain LRU over an `OrderedDict` with a BYTE budget (values are
numpy pytrees; their ``nbytes`` sum is the charge). Oversized single
values are refused rather than evicting the whole cache. Eviction, hit,
and miss counts publish to the obs registry
(``wam_tpu_serve_cache_{hits,misses,evictions}_total``) and to a v2
``result_cache`` ledger row (`serve.metrics.write_result_cache`).

Kill switch: ``WAM_TPU_NO_RESULT_CACHE=1`` bypasses get/put per call
(mirrors ``WAM_TPU_NO_SCHEDULE_CACHE`` / the AOT cache convention) — for
bisecting "is the cache wrong" in production without a restart.

Exactness caveat (serve.buckets): deterministic entries (``method=
"gradcam"``/plain gradients) are bit-exact by construction. SmoothGrad
entries are bit-exact PER ROW POSITION — the serve runtime always packs a
request into *some* row of a full ``max_batch`` batch, and the engines'
per-batch RNG gives each row its own noise stream, so two computes of the
same input in different row positions differ by the (unbiased) sampling
noise. The cache returns whichever realization was computed first —
deterministic for a given arrival order, within estimator variance always.
Callers for whom realization identity matters (eval suites) should bypass
the cache (kill switch) rather than depend on arrival order.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import OrderedDict

import numpy as np

from wam_tpu_torch.obs.registry import registry as _obs_registry

__all__ = ["ResultCache", "result_cache_key", "cache_disabled", "schedule_fingerprint"]

_c_hits = _obs_registry.counter(
    "wam_tpu_serve_cache_hits_total",
    "result-cache hits (futures resolved without admission)")
_c_misses = _obs_registry.counter(
    "wam_tpu_serve_cache_misses_total",
    "result-cache misses (requests that went through admission)")
_c_evictions = _obs_registry.counter(
    "wam_tpu_serve_cache_evictions_total",
    "result-cache LRU evictions under the byte budget")
_g_bytes = _obs_registry.gauge(
    "wam_tpu_serve_cache_bytes", "resident result-cache payload bytes")
_g_entries = _obs_registry.gauge(
    "wam_tpu_serve_cache_entries", "resident result-cache entries")


def cache_disabled() -> bool:
    """``WAM_TPU_NO_RESULT_CACHE=1`` kill switch, read per call so flipping
    the env var takes effect without a restart."""
    return os.environ.get("WAM_TPU_NO_RESULT_CACHE", "") not in ("", "0")


def schedule_fingerprint() -> str:
    """The live tuned-schedule fingerprint (`tune.cache.schedule_fingerprint`,
    module docstring)."""
    from wam_tpu_torch.tune.cache import schedule_fingerprint as live

    return live()


def result_cache_key(x: np.ndarray, y, cache_id: str,
                     model: str | None = None) -> str:
    """Content address for one request: input digest + label + entry id +
    the live tuned-schedule fingerprint (module docstring) + the live
    precision tag. Tuned-entry precision flips already move the schedule
    fingerprint; the tag covers the ENV route (``WAM_TPU_FAN_DTYPE`` /
    ``WAM_TPU_MEL_BF16``), read per call like the fingerprint, so flipping
    a precision knob can never replay a result computed under the other
    policy. ``model`` folds a paged model's identity into the key (multi-
    model fleets share one cache), so exact-replay hits can never cross
    models; None keeps the historical single-model key unchanged."""
    from wam_tpu_torch.config import precision_tag

    h = hashlib.sha256()
    h.update(x.tobytes())
    h.update(repr((x.shape, str(x.dtype))).encode())
    key = (f"{h.hexdigest()}|{y}|{cache_id}|{schedule_fingerprint()}"
           f"|{precision_tag()}")
    if model is not None:
        key = f"{key}|{model}"
    return key


def _leaves(value) -> list:
    if isinstance(value, dict):
        return [leaf for k in value for leaf in _leaves(value[k])]
    if isinstance(value, (tuple, list)):
        return [leaf for v in value for leaf in _leaves(v)]
    return [value]


def _tree_bytes(value) -> int:
    return sum(int(np.asarray(leaf).nbytes) for leaf in _leaves(value))


class ResultCache:
    """Thread-safe bounded LRU of attribution result pytrees.

    ``max_bytes`` bounds the summed payload ``nbytes`` (keys and dict
    overhead are not charged — the payloads dominate by orders of
    magnitude). ``cache_id`` is baked into every key (module docstring).
    One instance may be shared by many servers: client threads `get` under
    `submit`, worker threads `put` at harvest; one lock covers both (the
    critical sections are dict moves, not hashing — keys are computed
    outside).

    Tenant partitioning: entries live in per-tenant LRU shards (the
    ``None`` shard is the tenant-less default and recovers the historical
    single-LRU behavior exactly). Each live shard gets an equal slice of
    the byte budget, a hot tenant trims its OWN shard first, and the
    global bound evicts from the LARGEST shard — so one hot tenant can
    never flush everyone else's working set. A tenant's `get` only sees
    its own shard: hit/miss accounting (and the nonzero-hit-rate isolation
    gate) is per tenant.
    """

    def __init__(self, max_bytes: int, *, cache_id: str = ""):
        if max_bytes < 1:
            raise ValueError("max_bytes must be >= 1")
        self.max_bytes = int(max_bytes)
        self.cache_id = str(cache_id)
        self._lock = threading.Lock()
        # tenant (None | str) -> LRU shard of key -> (value, nbytes)
        self._shards: dict = {None: OrderedDict()}
        self._shard_bytes: dict = {None: 0}
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._tstats: dict = {}  # tenant -> {"hits": n, "misses": n}

    def key(self, x: np.ndarray, y, model: str | None = None) -> str:
        return result_cache_key(x, y, self.cache_id, model=model)

    def _evict_one_locked(self, tenant) -> None:
        shard = self._shards[tenant]
        _, (_, sz) = shard.popitem(last=False)
        self._shard_bytes[tenant] -= sz
        self._bytes -= sz
        self.evictions += 1

    def get(self, key: str, tenant: str | None = None):
        """The cached pytree, or None. Counts a hit or a miss — call it
        once per admission decision, not speculatively."""
        if cache_disabled():
            return None
        with self._lock:
            shard = self._shards.get(tenant)
            entry = shard.get(key) if shard is not None else None
            if tenant is not None:
                ts = self._tstats.setdefault(
                    tenant, {"hits": 0, "misses": 0})
            if entry is None:
                self.misses += 1
                if tenant is not None:
                    ts["misses"] += 1
                _c_misses.inc()
                return None
            shard.move_to_end(key)
            self.hits += 1
            if tenant is not None:
                ts["hits"] += 1
        _c_hits.inc()
        return entry[0]

    def put(self, key: str, value, tenant: str | None = None) -> bool:
        """Insert (host-side pytree) into the tenant's shard, evicting LRU
        entries down to the fair-share and global byte budgets. A single
        value over the whole budget is refused (returns False) instead of
        flushing everything for an uncacheable row."""
        if cache_disabled():
            return False
        nbytes = _tree_bytes(value)
        if nbytes > self.max_bytes:
            return False
        evicted0 = self.evictions
        with self._lock:
            shard = self._shards.get(tenant)
            if shard is None:
                shard = self._shards[tenant] = OrderedDict()
                self._shard_bytes[tenant] = 0
            old = shard.pop(key, None)
            if old is not None:
                self._shard_bytes[tenant] -= old[1]
                self._bytes -= old[1]
            # fair share: every LIVE (non-empty, plus the inserting) shard
            # gets an equal budget slice; a hot tenant evicts from its OWN
            # shard before touching others
            live = {t for t, s in self._shards.items() if s} | {tenant}
            cap = self.max_bytes // len(live)
            while self._shard_bytes[tenant] + nbytes > cap and shard:
                self._evict_one_locked(tenant)
            # global bound: trim the LARGEST shard (ties break arbitrarily)
            while self._bytes + nbytes > self.max_bytes:
                victim = max(
                    (t for t, s in self._shards.items() if s),
                    key=lambda t: self._shard_bytes[t], default=None)
                if victim is None:
                    break
                self._evict_one_locked(victim)
            shard[key] = (value, nbytes)
            self._shard_bytes[tenant] += nbytes
            self._bytes += nbytes
            evicted = self.evictions - evicted0
            nbytes_now = self._bytes
            entries_now = sum(len(s) for s in self._shards.values())
        if evicted:
            _c_evictions.inc(evicted)
        _g_bytes.set(nbytes_now)
        _g_entries.set(entries_now)
        return True

    def __len__(self) -> int:
        with self._lock:
            return sum(len(s) for s in self._shards.values())

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def stats(self) -> dict:
        """Counter snapshot (the ``result_cache`` ledger-row body and the
        bench's hit-rate report)."""
        with self._lock:
            hits, misses = self.hits, self.misses
            out = {
                "hits": hits,
                "misses": misses,
                "evictions": self.evictions,
                "entries": sum(len(s) for s in self._shards.values()),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "hit_rate": hits / (hits + misses) if hits + misses else 0.0,
                "cache_id": self.cache_id,
                "disabled": cache_disabled(),
            }
            if self._tstats:
                out["tenants"] = {
                    str(t): {
                        "hits": ts["hits"],
                        "misses": ts["misses"],
                        "hit_rate": (ts["hits"] / (ts["hits"] + ts["misses"])
                                     if ts["hits"] + ts["misses"] else 0.0),
                        "entries": len(self._shards.get(t, ())),
                        "bytes": self._shard_bytes.get(t, 0),
                    }
                    for t, ts in sorted(self._tstats.items())
                }
            return out

    def row(self) -> dict:
        """The v2 ``result_cache`` ledger row (schema stamped by
        `serve.metrics.write_result_cache`, which owns the envelope)."""
        row = {"metric": "result_cache", "timestamp": time.time()}
        row.update(self.stats())
        return row
