"""wam_tpu_torch: the Wavelet Attribution Method in PyTorch and CUDA.

A port of `wam_tpu` (JAX on the TPU, kept as the reference) to PyTorch on an
NVIDIA H100. Module paths and names mirror `wam_tpu`; the TPU's Pallas
kernels become hand-written CUDA kernels (`wam_tpu_torch.kernels`), each
with its plain PyTorch version beside it for CPU tensors and for tests.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from wam_tpu_torch.core.engine import WamEngine, target_loss
from wam_tpu_torch.core.estimators import (
    integrated_path,
    noise_sigma,
    smoothgrad,
    trapezoid,
    validate_sample_batch_size,
)
from wam_tpu_torch.device import resolve_device
from wam_tpu_torch.models.ingest import flax_resnet_to_torch
from wam_tpu_torch.models.resnet import bind_inference, resnet18, resnet50
from wam_tpu_torch.ops.packing2d import (
    disentangle_scales,
    mosaic2d,
    mosaic_size,
    reproject_mosaic,
)
from wam_tpu_torch.tune.fused_relu import fused_relu
from wam_tpu_torch.wam2d import BaseWAM2D, WaveletAttribution2D
from wam_tpu_torch.wavelets.matmul import idwt2_kernel
from wam_tpu_torch.wavelets.transform import (
    Detail2D,
    dwt2,
    dwt_max_level,
    idwt2,
    wavedec2,
    waverec2,
)

__all__ = [
    "BaseWAM2D",
    "Detail2D",
    "WamEngine",
    "WaveletAttribution2D",
    "bind_inference",
    "disentangle_scales",
    "dwt2",
    "dwt_max_level",
    "flax_resnet_to_torch",
    "fused_relu",
    "idwt2",
    "idwt2_kernel",
    "integrated_path",
    "mosaic2d",
    "mosaic_size",
    "noise_sigma",
    "reproject_mosaic",
    "resnet18",
    "resnet50",
    "resolve_device",
    "smoothgrad",
    "target_loss",
    "trapezoid",
    "validate_sample_batch_size",
    "wavedec2",
    "waverec2",
]
