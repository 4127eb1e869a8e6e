"""`wam_tpu_torch.testing` — deterministic fault injection for resilience
tests (PyTorch port of `wam_tpu.testing`). Production code never imports
this package; the serve stack is exercised through its public factories
(entry_factory wrapping), not patched internals — except the stager
latency hook, which is an explicit context manager.
``PodChaosKiller`` kills pod worker processes (`wam_tpu_torch.pod`).
"""

from wam_tpu_torch.testing.faults import (
    DEFAULT_CHAOS,
    ChaosFault,
    ChaosSchedule,
    FaultInjector,
    FaultSpec,
    PodChaosKiller,
    parse_chaos,
    stager_chaos,
)

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
