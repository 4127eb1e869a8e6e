"""Streaming pipeline (PyTorch port of `wam_tpu.pipeline`): the prefetch
and donate halves of the reference's prefetch / donate / precompile trio.

- `stager` — asynchronous host→device staging through pinned memory on a
  side stream (`put_committed`, `stage_to_device`, `DeviceStager`).
- `donation` — the shared "on the card only by default" donation policy
  (`resolve_donate`, `donating_jit`), where donating releases the input's
  storage to the caching allocator, and the `donation_safe` guard.

The reference's third module, the AOT executable cache (``aot``:
``AOT_CACHE_VERSION``, ``aot_entry_path``, ``aval_signature``,
``cached_entry``, ``cached_jit``, ``default_aot_dir``, ``load_aot``,
``save_aot``), waits for ROADMAP.md slice E.
"""

from wam_tpu_torch.pipeline.donation import donating_jit, donation_safe, resolve_donate
from wam_tpu_torch.pipeline.stager import DeviceStager, put_committed, stage_to_device

__all__ = [
    "donating_jit",
    "donation_safe",
    "resolve_donate",
    "DeviceStager",
    "put_committed",
    "stage_to_device",
]
