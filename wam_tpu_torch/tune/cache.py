"""Versioned schedule cache — where autotuned schedules live (PyTorch port
of `wam_tpu.tune.cache`).

- **Key**: one canonical string per (workload, input shape, batch, dtype,
  2D transform impl, backend), ``workload|shape|batch|dtype|impl|backend``
  as in the reference, with the port's impl names (``"conv"``,
  ``"matmul"``, ``"kernel"``) and ``"cuda"`` / ``"cpu"`` as the backend.
- **Entry**: the winning knobs (``sample_chunk``, ``stream_noise``,
  ``synth_impl``, ``layout``, ``fan_cap``, ...) plus the measurement that
  crowned them (median seconds, items/s, measurement plane).
- **Two layers**: the package's pinned defaults (``default_schedules.json``
  beside this file) overlaid by the user cache
  (``$WAM_TORCH_SCHEDULE_CACHE`` or
  ``~/.cache/wam_tpu_torch/schedules.json``, a file of its own so the two
  packages never overwrite each other's), where `wam_tpu_torch.tune.autotune`
  persists winners. User entries win. The pinned file ships with no
  entries: defaults measured on the card are set by a benchmark.
- **Versioning**: files carry ``version``; a file with another version is
  ignored wholesale and overwritten on the next `ScheduleCache.save`.

Every reader (`core.estimators.resolve_sample_chunk`, `evalsuite.fan.plan_fan`,
`config.resolve_precision`, the serve bucket cap, `SeqShardedWam`'s
``"auto"`` knobs) consults `lookup_schedule` first and falls back to its
untuned rule when no entry matches, so a process with no cache file
computes what it computed before the cache existed.

``WAM_TPU_NO_SCHEDULE_CACHE=1`` disables every lookup (the kill switch of
schedule experiments).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading

__all__ = [
    "SCHEDULE_CACHE_VERSION",
    "schedule_key",
    "default_cache_path",
    "ScheduleCache",
    "load_schedule_cache",
    "lookup_schedule",
    "record_schedule",
    "resolve_fan_cap",
    "resolve_bucket_cap",
    "apply_tuned_synth_impl",
    "tuned_synth_impl",
    "invalidate_process_cache",
    "entries_fingerprint",
    "schedule_fingerprint",
]

SCHEDULE_CACHE_VERSION = 1
CACHE_ENV = "WAM_TORCH_SCHEDULE_CACHE"
DISABLE_ENV = "WAM_TPU_NO_SCHEDULE_CACHE"

_lock = threading.Lock()
_process_cache: "ScheduleCache | None" = None


def default_cache_path() -> str:
    """``$WAM_TORCH_SCHEDULE_CACHE`` or
    ``~/.cache/wam_tpu_torch/schedules.json``."""
    return os.environ.get(CACHE_ENV,
                          os.path.expanduser("~/.cache/wam_tpu_torch/schedules.json"))


def _pinned_path() -> str:
    return os.path.join(os.path.dirname(__file__), "default_schedules.json")


def default_backend() -> str:
    """The backend a call with no device takes: ``"cuda"`` when a card is
    visible, else ``"cpu"`` (the port's entry points run on the card unless
    told otherwise)."""
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def schedule_key(workload: str, shape, batch: int, dtype: str = "f32",
                 dwt_impl: str | None = None, backend: str | None = None) -> str:
    """Canonical cache key. ``shape`` is the per-item shape (no batch axis);
    ``dtype`` the transform-boundary dtype label ("f32" / "bf16");
    ``dwt_impl`` defaults to the 2D analysis impl a call on ``backend``
    takes with no ``impl=`` (`wavelets.transform.resolved_dwt2_impl`), so a
    key built under ``"auto"`` matches the impl that runs; ``backend``
    defaults to `default_backend`."""
    if backend is None:
        backend = default_backend()
    if dwt_impl is None:
        from wam_tpu_torch.wavelets.transform import resolved_dwt2_impl

        dwt_impl = resolved_dwt2_impl(backend)
    shape_s = "x".join(str(int(d)) for d in shape) if shape else "-"
    return f"{workload}|{shape_s}|b{int(batch)}|{dtype}|{dwt_impl}|{backend}"


class ScheduleCache:
    """Pinned-defaults + user-file schedule table (module docstring)."""

    def __init__(self, path: str | None = None, pinned: bool = True):
        self.path = path or default_cache_path()
        self.entries: dict[str, dict] = {}
        self.stale_files: list[str] = []
        self._fingerprint = None
        if pinned:
            self._merge_file(_pinned_path())
        self._merge_file(self.path)

    def _merge_file(self, path: str) -> None:
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return
        if not isinstance(data, dict) or data.get("version") != SCHEDULE_CACHE_VERSION:
            # stale schema: ignore every entry rather than half-apply it
            self.stale_files.append(path)
            return
        schedules = data.get("schedules", {})
        if isinstance(schedules, dict):
            for k, v in schedules.items():
                if isinstance(v, dict):
                    self.entries[k] = v

    def get(self, key: str) -> dict | None:
        return self.entries.get(key)

    def put(self, key: str, entry: dict) -> None:
        self.entries[key] = dict(entry)
        # a new entry changes the table's identity: drop the memoized
        # fingerprint so results cached under the old table stop matching
        self._fingerprint = None

    def save(self, path: str | None = None) -> str:
        """Write the USER layer (every entry that is not a pinned default,
        and tuned overrides of pinned keys) atomically."""
        path = path or self.path
        pinned = ScheduleCache(path=os.devnull, pinned=True).entries
        user = {k: v for k, v in self.entries.items() if pinned.get(k) != v}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {"version": SCHEDULE_CACHE_VERSION, "schedules": user}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path


def load_schedule_cache(refresh: bool = False) -> ScheduleCache:
    """The process-wide cache, loaded once (at the first "auto" resolution)."""
    global _process_cache
    with _lock:
        if _process_cache is None or refresh:
            _process_cache = ScheduleCache()
        return _process_cache


def invalidate_process_cache() -> None:
    """Drop the process-wide cache (after another process wrote the file,
    or the cache path changed)."""
    global _process_cache
    with _lock:
        _process_cache = None


def entries_fingerprint(entries: dict, *, disabled: bool = False) -> str:
    """Digest of a schedule table body, the hash behind
    `schedule_fingerprint`: equal entries give equal digests, so the online
    tuner can fingerprint a challenger table as serving would after a
    promotion."""
    body = json.dumps({"version": SCHEDULE_CACHE_VERSION, "disabled": disabled,
                       "schedules": entries}, sort_keys=True, default=str)
    return hashlib.sha256(body.encode()).hexdigest()[:16]


def _disabled() -> bool:
    return os.environ.get(DISABLE_ENV, "") not in ("", "0")


def schedule_fingerprint() -> str:
    """Digest of the loaded schedule table (entries, schema version and the
    kill switch): the schedule slot of serve result-cache keys and of the
    ``serve_batch`` ledger rows. Memoized on the loaded `ScheduleCache`."""
    cache = load_schedule_cache()
    disabled = _disabled()
    memo = cache._fingerprint
    if memo is not None and memo[0] == disabled:
        return memo[1]
    fp = entries_fingerprint(cache.entries, disabled=disabled)
    cache._fingerprint = (disabled, fp)
    return fp


def lookup_schedule(workload: str, shape, batch: int, dtype: str = "f32",
                    dwt_impl: str | None = None, backend: str | None = None) -> dict | None:
    """The entry for the key, or None (the caller falls back to its untuned
    rule)."""
    if _disabled():
        return None
    key = schedule_key(workload, shape, batch, dtype, dwt_impl, backend)
    return load_schedule_cache().get(key)


def record_schedule(workload: str, shape, batch: int, entry: dict, dtype: str = "f32",
                    dwt_impl: str | None = None, backend: str | None = None,
                    persist: bool = True) -> str:
    """Install (and by default persist) a tuned entry; returns its key."""
    key = schedule_key(workload, shape, batch, dtype, dwt_impl, backend)
    cache = load_schedule_cache()
    cache.put(key, entry)
    if persist:
        cache.save()
    return key


def tuned_synth_impl(workload: str, shape, batch: int, dtype: str = "f32",
                     backend: str | None = None) -> str | None:
    """The tuned ``synth_impl`` of this key, or None with no entry or no
    such field. The explainers pass it to their own call's synthesis, so
    it never touches the process knob other calls read."""
    ent = lookup_schedule(workload, shape, batch, dtype, backend=backend)
    return (ent.get("synth_impl") if ent else None) or None


def apply_tuned_synth_impl(workload: str, shape, batch: int, dtype: str = "f32",
                           backend: str | None = None) -> str | None:
    """The reference's process-wide form: set the tuned ``synth_impl`` of
    this key (if any) with `wavelets.transform.set_synth2_impl` and return
    it; with no entry or no such field, None, and the knob is left as it
    is. The port's explainers read `tuned_synth_impl` per call instead."""
    impl = tuned_synth_impl(workload, shape, batch, dtype, backend=backend)
    if impl:
        from wam_tpu_torch.wavelets.transform import set_synth2_impl

        set_synth2_impl(impl)
        return impl
    return None


def resolve_fan_cap(batch_size, fan: int, *, workload: str = "eval2d", shape=None,
                    default: int = 128, backend: str | None = None) -> int:
    """Evaluation fan cap: an explicit int passes through; "auto" reads the
    tuned ``fan_cap`` for (workload, fan), else ``default``. The entry's
    ``fan_chunk`` is `evalsuite.fan.plan_fan`'s to read."""
    if batch_size != "auto":
        return int(batch_size)
    ent = lookup_schedule(workload, shape or (fan,), fan, backend=backend)
    if ent is not None and ent.get("fan_cap"):
        return int(ent["fan_cap"])
    return default


def resolve_bucket_cap(max_batch, shape=None, *, replicas: int = 1, default: int = 8,
                       backend: str | None = None) -> int:
    """Serving bucket cap (`ServeConfig.max_batch`): an explicit int passes
    through; "auto" reads the tuned ``bucket_cap`` of the "serve" workload
    at this bucket shape, keyed by the replica count, else ``default``."""
    if max_batch != "auto":
        return int(max_batch)
    ent = lookup_schedule("serve", shape or (), int(replicas), backend=backend)
    if ent is not None and ent.get("bucket_cap"):
        return int(ent["bucket_cap"])
    return default
