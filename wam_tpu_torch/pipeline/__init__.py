"""Streaming pipeline (PyTorch port of `wam_tpu.pipeline`): the prefetch /
donate / precompile trio threaded through the hot paths.

- `stager` — asynchronous host→device staging through pinned memory on a
  side stream (`put_committed`, `stage_to_device`, `DeviceStager`).
- `donation` — the shared "on the card only by default" donation policy
  (`resolve_donate`, `donating_jit`), where donating releases the input's
  storage to the caching allocator, and the `donation_safe` guard.
- `aot` — the versioned compiled-step cache over `torch.compile` and its
  portable cache artifacts (`cached_jit`, `cached_entry`): a fresh process
  with a populated cache compiles nothing.
"""

from wam_tpu_torch.pipeline.aot import (
    AOT_CACHE_VERSION,
    aot_entry_path,
    aval_signature,
    cached_entry,
    cached_jit,
    default_aot_dir,
    load_aot,
    save_aot,
)
from wam_tpu_torch.pipeline.donation import donating_jit, donation_safe, resolve_donate
from wam_tpu_torch.pipeline.stager import DeviceStager, put_committed, stage_to_device

__all__ = [
    "AOT_CACHE_VERSION",
    "aot_entry_path",
    "aval_signature",
    "cached_entry",
    "cached_jit",
    "default_aot_dir",
    "load_aot",
    "save_aot",
    "donating_jit",
    "donation_safe",
    "resolve_donate",
    "DeviceStager",
    "put_committed",
    "stage_to_device",
]
