"""`wam_tpu_torch.serve` — the batched attribution serving runtime and its
multi-device fleet (PyTorch port of `wam_tpu.serve`).

A stream of independent attribution requests (mixed shapes, mixed arrival
times) in; a small fixed set of warm bucket shapes and a single
device-owning worker loop out. See `serve.runtime` for the operational
semantics, `serve.buckets` for the shape-admission policy and
`serve.metrics` for the ledger schema (v2).

Engines plug in via their ``serve_entry()`` methods (wam1d / wam2d / wam3d
and the video explainer) — thread-safe batched callables
(`serve.entry.jit_entry`) that count their first call at each input
signature and release their donated input batch on the card.

`serve.fleet.FleetServer` runs one server replica per device behind shared
admission and load-aware routing (oversize batches data-parallel over the
replicas), `serve.supervisor.ReplicaSupervisor` restarts dead replicas.
"""

from wam_tpu_torch.serve.buckets import Bucket, BucketTable, NoBucketError, bucket_key, pad_item
from wam_tpu_torch.serve.entry import fleet_aot_key, jit_entry
from wam_tpu_torch.serve.fleet import OVERSIZE_ENTRY_ID, FleetServer, NoLiveReplicaError
from wam_tpu_torch.serve.metrics import SCHEMA_VERSION, FleetMetrics, ServeMetrics, percentile_ms
from wam_tpu_torch.serve.models import ModelPager, ModelSpec, model_paging_disabled
from wam_tpu_torch.serve.result_cache import ResultCache, result_cache_key
from wam_tpu_torch.serve.retry import RetryBudgetExceededError, RetryPolicy, RetryStats
from wam_tpu_torch.serve.runtime import (
    QOS_CLASSES,
    AttributionServer,
    DeadlineExceededError,
    InvalidDeadlineError,
    MemoryAdmissionError,
    QueueFullError,
    ServeError,
    ServerClosedError,
    WorkerCrashedError,
)
from wam_tpu_torch.serve.supervisor import ReplicaSupervisor, SupervisorConfig

__all__ = [
    "AttributionServer",
    "FleetServer",
    "Bucket",
    "BucketTable",
    "NoBucketError",
    "NoLiveReplicaError",
    "ServeError",
    "QueueFullError",
    "MemoryAdmissionError",
    "DeadlineExceededError",
    "InvalidDeadlineError",
    "ServerClosedError",
    "WorkerCrashedError",
    "RetryBudgetExceededError",
    "RetryPolicy",
    "RetryStats",
    "ReplicaSupervisor",
    "SupervisorConfig",
    "ServeMetrics",
    "FleetMetrics",
    "SCHEMA_VERSION",
    "OVERSIZE_ENTRY_ID",
    "percentile_ms",
    "ResultCache",
    "result_cache_key",
    "ModelSpec",
    "ModelPager",
    "model_paging_disabled",
    "QOS_CLASSES",
    "jit_entry",
    "fleet_aot_key",
    "bucket_key",
    "pad_item",
]
