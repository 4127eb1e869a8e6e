"""`wam_tpu_torch.parallel` — meshes, multi-process bring-up, the sharded
estimators and the sequence-sharded transforms (PyTorch port of
`wam_tpu.parallel`).

`mesh` holds the named-axis `Mesh` and the functions that make one,
`multihost` the `torch.distributed` bring-up and meshes that span
processes, `sharded` the SmoothGrad and IG runners over a (data, sample)
mesh. The sequence-sharded half splits one long signal over a mesh axis:
`halo` (the ring exchange and the periodized transforms), `halo_modes`
(the expansive modes' core + tail transforms) and `seq_estimators`
(`SeqShardedWam`, the estimators over them).
"""

from wam_tpu_torch.parallel.halo import (
    sharded_coeff_grads_per,
    sharded_dwt_per,
    sharded_wavedec2_per,
    sharded_wavedec3_per,
    sharded_wavedec_per,
    sharded_waverec2_per,
    sharded_waverec3_per,
    sharded_waverec_per,
)
from wam_tpu_torch.parallel.halo_modes import (
    TailedLeaf,
    gather_coeffs,
    gather_leaf,
    sharded_coeff_grads_mode,
    sharded_wavedec2_mode,
    sharded_wavedec3_mode,
    sharded_wavedec_mode,
    sharded_waverec2_mode,
    sharded_waverec3_mode,
    sharded_waverec_mode,
)
from wam_tpu_torch.parallel.mesh import P, data_sample_mesh, make_mesh, replica_mesh
from wam_tpu_torch.parallel.multihost import hybrid_mesh, init_distributed, process_local_batch
from wam_tpu_torch.parallel.seq_estimators import SeqShardedWam, seq_sharded_wam
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
    "sharded_dwt_per",
    "sharded_wavedec_per",
    "sharded_wavedec2_per",
    "sharded_wavedec3_per",
    "sharded_waverec_per",
    "sharded_waverec2_per",
    "sharded_waverec3_per",
    "sharded_coeff_grads_per",
    "TailedLeaf",
    "gather_leaf",
    "gather_coeffs",
    "sharded_wavedec_mode",
    "sharded_wavedec2_mode",
    "sharded_wavedec3_mode",
    "sharded_waverec_mode",
    "sharded_waverec2_mode",
    "sharded_waverec3_mode",
    "sharded_coeff_grads_mode",
    "SeqShardedWam",
    "seq_sharded_wam",
]
