"""`wam_tpu_torch.parallel` — meshes, multi-process bring-up and the sharded
estimators (PyTorch port of `wam_tpu.parallel`, its data-parallel half).

`mesh` holds the named-axis `Mesh` and the functions that make one,
`multihost` the `torch.distributed` bring-up and meshes that span
processes, `sharded` the SmoothGrad and IG runners over a (data, sample)
mesh. The sequence-sharded
half of the reference (`halo`, `halo_modes`, `seq_estimators`: halo
exchange between shards of one long signal) waits for ROADMAP.md slice E1b.
"""

from wam_tpu_torch.parallel.mesh import P, data_sample_mesh, make_mesh, replica_mesh
from wam_tpu_torch.parallel.multihost import hybrid_mesh, init_distributed, process_local_batch
from wam_tpu_torch.parallel.sharded import (
    sharded_integrated_path,
    sharded_smoothgrad,
    sharded_smoothgrad_spmd,
)

__all__ = [
    "make_mesh",
    "data_sample_mesh",
    "replica_mesh",
    "P",
    "sharded_smoothgrad",
    "sharded_smoothgrad_spmd",
    "sharded_integrated_path",
    "init_distributed",
    "hybrid_mesh",
    "process_local_batch",
]
