"""Device memory accounting + cold-bucket admission (health-plane pillar 2;
PyTorch port of `wam_tpu.obs.memory`).

`AttributionServer.submit` rejects on queue depth; a cold bucket's first
request also needs the memory of its working set. `MemoryBudget` closes
that gap with three pieces:

- **Watermark capture at warmup**: right after a bucket's warmup dispatch
  the server records the device's peak bytes (`device_memory_stats`: the
  caching allocator's ``allocated_bytes.all.peak`` from
  `torch.cuda.memory_stats` on a card) with an *estimated-bytes fallback*
  computed from the bucket shape × max_batch × dtype
  (`estimate_entry_bytes`) where the device reports nothing (the CPU). A
  warm bucket is thereafter always admitted — its memory is already paid
  for.
- **Live-bytes gauge**: the stager's per-transfer byte counter feeds
  ``wam_tpu_memory_staged_bytes`` (`note_staged`, called from
  `pipeline.stager.put_committed`) without any device sync.
- **Admission check**: `admit()` — called by `AttributionServer.submit`
  before queueing — projects ``bytes_in_use + estimate`` for a COLD bucket
  and rejects with a ``retry_after_s`` (surfaced as
  `serve.runtime.MemoryAdmissionError`, a `QueueFullError` subclass) when
  the projection exceeds the configured budget.

``in_use_fn`` injects a simulated bytes-in-use reading for deterministic
tests (and for devices with no statistics at all, where the fallback is
the largest recorded watermark).
"""

from __future__ import annotations

import threading

from wam_tpu_torch.obs.registry import registry as _registry

__all__ = [
    "MemoryBudget",
    "device_memory_stats",
    "estimate_entry_bytes",
    "note_staged",
]


def _label(value) -> str:
    return "-" if value is None else str(value)


_g_watermark = _registry.gauge(
    "wam_tpu_memory_bucket_watermark_bytes",
    "device peak-bytes watermark captured at the bucket's warmup "
    "(estimated when the backend exposes no memory_stats)",
    labels=("replica", "bucket"))
_g_in_use = _registry.gauge(
    "wam_tpu_memory_device_bytes_in_use",
    "device bytes in use as of the last admission projection",
    labels=("replica",))
_g_budget = _registry.gauge(
    "wam_tpu_memory_budget_bytes", "configured device memory budget",
    labels=("replica",))
_c_rejects = _registry.counter(
    "wam_tpu_memory_admission_rejects_total",
    "cold-bucket submits rejected because the projected watermark "
    "exceeded the budget", labels=("replica",))
_g_staged = _registry.gauge(
    "wam_tpu_memory_staged_bytes",
    "cumulative host->device bytes staged (live-bytes feed from the "
    "stager's transfer counter)")


def note_staged(nbytes: int) -> None:
    """Live-bytes feed: `pipeline.stager.put_committed` forwards every
    staged transfer's host-side byte count here (a no-op when obs is
    disabled, like the counter beside it)."""
    _g_staged.inc(nbytes)


def device_memory_stats(device=None) -> dict | None:
    """The caching allocator's statistics of a CUDA ``device`` in the
    reference's keys: ``bytes_in_use`` (allocated now), ``peak_bytes_in_use``
    (the peak since the last `torch.cuda.reset_peak_memory_stats`),
    ``bytes_reserved`` and, from `torch.cuda.mem_get_info`, ``bytes_free``
    and ``bytes_limit`` (the card's total). None for the CPU, a missing
    card, or any failure. ``device=None`` asks the current CUDA device."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        dev = torch.device("cuda", torch.cuda.current_device()) if device is None \
            else torch.device(device)
        if dev.type != "cuda":
            return None
        stats = torch.cuda.memory_stats(dev)
        free, total = torch.cuda.mem_get_info(dev)
    except Exception:
        return None
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
        "bytes_free": int(free),
        "bytes_limit": int(total),
    }


def estimate_entry_bytes(bucket_shape, max_batch: int, itemsize: int = 4, *,
                         multiplier: float = 4.0, aot_bytes: int = 0) -> int:
    """Estimated-bytes fallback for a bucket's device footprint: the padded
    input batch (``max_batch × prod(shape) × itemsize``) times a working-set
    multiplier (input + output + ~2x transient coefficient pyramids), plus
    ``aot_bytes`` (kept for the reference's signature: 0 until the port's AOT
    cache lands). Deliberately coarse: it only has to be the right order of
    magnitude for admission, and only until the first real watermark
    replaces it."""
    elems = int(max_batch)
    for d in bucket_shape:
        elems *= int(d)
    return int(elems * int(itemsize) * float(multiplier)) + int(aot_bytes)


class MemoryBudget:
    """Per-device memory accounting + the cold-bucket admission decision.

    One instance per `AttributionServer`. ``budget_bytes`` None/0 disables
    admission but keeps watermark capture. Thread-safe: client threads
    admit while the worker and page-ins capture watermarks."""

    def __init__(self, budget_bytes: int | None = None, *, device=None,
                 replica_id=None, retry_after_s: float = 1.0,
                 in_use_fn=None):
        self.budget_bytes = int(budget_bytes) if budget_bytes else None
        self.retry_after_s = float(retry_after_s)
        self.replica_id = replica_id
        self._rl = _label(replica_id)
        self._device = device
        self._in_use_fn = in_use_fn
        self._lock = threading.Lock()
        self._watermarks: dict[str, int] = {}
        self.rejects = 0
        if self.budget_bytes:
            _g_budget.set(self.budget_bytes, replica=self._rl)

    def capture_watermark(self, bucket_key: str, fallback_bytes: int) -> int:
        """Record a bucket's post-warmup watermark: the device's peak bytes
        when it reports them, else the caller's shape-derived estimate. The
        bucket is 'warm' (always admitted) from here on."""
        stats = device_memory_stats(self._device)
        wm = None
        if stats:
            wm = stats.get("peak_bytes_in_use", stats.get("bytes_in_use"))
        wm = int(fallback_bytes) if wm is None else int(wm)
        with self._lock:
            self._watermarks[bucket_key] = wm
        _g_watermark.set(wm, replica=self._rl, bucket=bucket_key)
        return wm

    def is_warm(self, bucket_key: str) -> bool:
        with self._lock:
            return bucket_key in self._watermarks

    def bytes_in_use(self) -> int:
        """Current device bytes in use: the injected reading, else the
        allocator's live counter, else the largest recorded watermark (the
        most conservative figure a device without statistics can offer)."""
        if self._in_use_fn is not None:
            return int(self._in_use_fn())
        stats = device_memory_stats(self._device)
        if stats and stats.get("bytes_in_use") is not None:
            return int(stats["bytes_in_use"])
        with self._lock:
            return max(self._watermarks.values(), default=0)

    def admit(self, bucket_key: str, estimate_bytes: int) -> float | None:
        """Admission decision for one submit: None admits; a float is the
        ``retry_after_s`` to reject with. Warm buckets and unbudgeted
        servers always admit; a cold bucket is admitted only when its
        projected watermark (bytes in use + estimate) fits the budget."""
        if self.budget_bytes is None or self.is_warm(bucket_key):
            return None
        in_use = self.bytes_in_use()
        _g_in_use.set(in_use, replica=self._rl)
        if in_use + int(estimate_bytes) <= self.budget_bytes:
            return None
        with self._lock:
            self.rejects += 1
        _c_rejects.inc(replica=self._rl)
        return self.retry_after_s

    def describe(self) -> dict:
        with self._lock:
            return {
                "budget_bytes": self.budget_bytes,
                "watermarks": dict(self._watermarks),
                "rejects": self.rejects,
            }
