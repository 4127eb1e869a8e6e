"""wam_tpu_torch.tune — the schedule autotuner and the fused ReLU backward
(PyTorch port of `wam_tpu.tune`).

- **Schedule autotuning** (`cache`, `autotuner`, `workloads`, `sweep`): a
  measured, persisted schedule table keyed by (workload, shape, batch,
  dtype, transform impl, backend) that every "auto" knob of the port
  consults (`core.estimators.resolve_sample_chunk`, `evalsuite.fan.plan_fan`,
  `config.resolve_precision`, the serve bucket cap, `SeqShardedWam`) before
  its untuned rule. ``python -m wam_tpu_torch.tune`` sweeps a preset and
  persists the winner to ``~/.cache/wam_tpu_torch/schedules.json``.
- **The fused ReLU VJP** (`fused_relu`): relu with a bit-packed sign mask
  kept for the backward (K4/K5), enabled by
  ``models.bind_inference(..., fused_relu_vjp=True)``. Here ``fused_relu``
  is the module; its wrapper picks the kernel or the plain version by the
  tensor's device, or by ``set_fused_relu_impl`` / ``get_fused_relu_impl``
  (the reference's knob, ``WAM_TPU_FUSED_RELU_IMPL``).
- **Online schedule learning** (`mix`, `online`): a shadow tuner that mines
  the serve ledger into a `WorkloadMix`, re-sweeps against the observed
  distribution (the ``wamlive`` preset) and canary-A/Bs the challenger on
  one fleet replica; ``python -m wam_tpu_torch.tune.online`` (kill switch
  ``WAM_TPU_NO_ONLINE_TUNE``).
"""

from wam_tpu_torch.tune import fused_relu
from wam_tpu_torch.tune.fused_relu import get_fused_relu_impl, set_fused_relu_impl
from wam_tpu_torch.tune.cache import (
    SCHEDULE_CACHE_VERSION,
    ScheduleCache,
    apply_tuned_synth_impl,
    default_cache_path,
    entries_fingerprint,
    invalidate_process_cache,
    load_schedule_cache,
    lookup_schedule,
    record_schedule,
    resolve_bucket_cap,
    resolve_fan_cap,
    schedule_fingerprint,
    schedule_key,
)

# the reference's `wam_tpu.tune.__all__`
__all__ = [
    "SCHEDULE_CACHE_VERSION",
    "ScheduleCache",
    "apply_tuned_synth_impl",
    "default_cache_path",
    "invalidate_process_cache",
    "load_schedule_cache",
    "lookup_schedule",
    "record_schedule",
    "resolve_bucket_cap",
    "resolve_fan_cap",
    "schedule_fingerprint",
    "schedule_key",
    "fused_relu",
    "get_fused_relu_impl",
    "set_fused_relu_impl",
    "autotune",
    "Candidate",
    "chunk_candidates",
    "entries_fingerprint",
    "WorkloadMix",
    "mine_ledger",
    "drift_report",
    "OnlineTuner",
    "OnlineTuneConfig",
]


def __getattr__(name):
    # the autotuner, the presets and the online tuner import models and
    # engines; `import wam_tpu_torch.tune` stays light for the "auto" readers
    if name in ("autotune", "Candidate", "chunk_candidates", "measure_candidate"):
        from wam_tpu_torch.tune import autotuner

        return getattr(autotuner, name)
    if name in ("get_workload", "WORKLOADS"):
        from wam_tpu_torch.tune import workloads

        return getattr(workloads, name)
    if name in ("WorkloadMix", "BucketObservation", "mine_ledger", "mine_rows", "drift_report"):
        from wam_tpu_torch.tune import mix

        return getattr(mix, name)
    if name in ("OnlineTuner", "OnlineTuneConfig", "plan_serve_schedule", "canary_verdict"):
        from wam_tpu_torch.tune import online

        return getattr(online, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
