"""Pod serving: process-level failure domains over N independent fleets
(PyTorch port of `wam_tpu.pod`; the same wire grammar and frames).

The resilience ladder so far lived inside ONE process: replica threads
with supervised restarts (`serve.supervisor`), client retry/hedging
(`serve.retry`), chaos injection (`testing.faults`), registry-backed
zero-compile rehydration (`registry`). This package adds the tier above
— a front-door `PodRouter` spreading work across worker PROCESSES
(`pod.worker`, each a full `serve.fleet.FleetServer`), a `PodSupervisor`
respawning dead processes with the same crash-loop policy grammar
(`serve.supervisor.SupervisorConfig` reused), and an `AutoscalerLoop`
growing/shrinking the worker set from the pod's aggregate health plane —
so a SIGKILL, host OOM, or hardware loss costs one worker, never the
service, and in-flight requests re-route with zero loss.

Layering (imports point downward only):

    router ──> supervisor ──> metrics ──> protocol
       │            │
       └─> autoscaler (policy pure; loop drives router.grow/shrink)

`pod.worker` is the subprocess entrypoint (``python -m
wam_tpu_torch.pod.worker``) and imports none of the router side at runtime.
"""

from wam_tpu_torch.pod.autoscaler import AutoscaleConfig, AutoscalerLoop
from wam_tpu_torch.pod.metrics import PodMetrics
from wam_tpu_torch.pod.protocol import PodWorkerError, WorkerSnapshot
from wam_tpu_torch.pod.router import NoLiveWorkerError, PodRouter
from wam_tpu_torch.pod.supervisor import PodSupervisor

__all__ = [
    "AutoscaleConfig",
    "AutoscalerLoop",
    "NoLiveWorkerError",
    "PodMetrics",
    "PodRouter",
    "PodSupervisor",
    "PodWorkerError",
    "WorkerSnapshot",
]
