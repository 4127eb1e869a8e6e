"""wam_tpu_torch: the Wavelet Attribution Method in PyTorch and CUDA.

A port of `wam_tpu` (JAX on the TPU, kept as the reference) to PyTorch on an
NVIDIA H100: WAM-2D on images (`WaveletAttribution2D`, on ResNets, ViTs and
ConvNeXts), WAM-1D on audio (`WaveletAttribution1D`, through the mel front
end), WAM-3D on volumes and point clouds (`WaveletAttribution3D`,
`BaseWAM3D`, on the 3D ResNet, the voxel CNN and PointNet), and the
faithfulness metrics of 2D and 1D attributions (`Eval2DWAM`, `Eval1DWAM`:
insertion and deletion AUC, μ-fidelity, faithfulness of spectra, input
fidelity), and the baseline methods scored by the same metrics
(`EvalImageBaselines`, `EvalAudioBaselines`: saliency, integrated
gradients, SmoothGrad, the GradCAM family, guided backprop, gradient x
input, LRP; `wam_tpu_torch.evalsuite`), the scale analyzers
(`WAMAnalyzer2D`) and the fork's analytics (`wam_tpu_torch.analysis`:
per-level statistics, cross-wavelet IoU), the periodized and channel-last
transforms (`wam_tpu_torch.wavelets`; ``model_layout="nhwc"``), and the
data, checkpoint and viewer helpers (`wam_tpu_torch.data`,
`wam_tpu_torch.viz`), the transformer and temporal attributions
(`wam_tpu_torch.xattr`: attention rollout and grad x attention on a ViT,
patch-aligned level plans, video WAM and its temporal evaluation),
anytime SmoothGrad (`wam_tpu_torch.anytime`), the serving runtime and its
multi-device fleet (`wam_tpu_torch.serve`) and data parallelism over
device meshes (`wam_tpu_torch.parallel`). Module paths and names mirror `wam_tpu`; the TPU's Pallas kernels become hand-written CUDA kernels
(`wam_tpu_torch.kernels`), each with its plain PyTorch version beside it for
CPU tensors and for tests. Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""

from wam_tpu_torch.analyzers import WAMAnalyzer2D, WAMAnalyzerViT
from wam_tpu_torch.config import EvalConfig, PrecisionPolicy, resolve_precision
from wam_tpu_torch.core.engine import WamEngine, target_loss
from wam_tpu_torch.core.estimators import (
    integrated_path,
    noise_sigma,
    sample_noise,
    smoothgrad,
    trapezoid,
    validate_sample_batch_size,
)
from wam_tpu_torch.device import resolve_device
from wam_tpu_torch.evalsuite import (
    AUDIO_METHODS,
    IMAGE_METHODS,
    Eval1DWAM,
    Eval2DWAM,
    EvalAudioBaselines,
    EvalImageBaselines,
)
from wam_tpu_torch.models.audio import AudioCNN, bind_audio_inference, toy_wave_model
from wam_tpu_torch.models.convnext import ConvNeXt, convnext_test, convnext_tiny
from wam_tpu_torch.models.ingest import (
    flax_audio_to_torch,
    flax_convnext_to_torch,
    flax_pointnet_to_torch,
    flax_resnet3d_to_torch,
    flax_resnet_to_torch,
    flax_vit_to_torch,
    flax_voxel_to_torch,
)
from wam_tpu_torch.models.patchconv import PatchConv
from wam_tpu_torch.models.pointnet import (
    PointNetCls,
    PointNetDenseCls,
    PointNetFeat,
    feature_transform_regularizer,
)
from wam_tpu_torch.models.resnet import (
    ResNet,
    bind_inference,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
)
from wam_tpu_torch.models.resnet3d import ResNet3D, resnet3d_10, resnet3d_18
from wam_tpu_torch.models.voxel import VoxelModel
from wam_tpu_torch.models.vit import ViT, bind_vit_inference, vit_b16, vit_tiny_test
from wam_tpu_torch.ops.melspec import (
    amplitude_to_db,
    mel_filterbank,
    melspectrogram,
    stft_power,
)
from wam_tpu_torch.ops.packing2d import (
    disentangle_scales,
    mosaic2d,
    mosaic_size,
    reproject_mosaic,
)
from wam_tpu_torch.ops.packing3d import cube3d, cube_size, visualize_cube
from wam_tpu_torch.tune.fused_relu import fused_relu
from wam_tpu_torch.wam1d import (
    BaseWAM1D,
    VisualizerWAM1D,
    WaveletAttribution1D,
    normalize_waveforms,
    scaleogram,
)
from wam_tpu_torch.wam2d import BaseWAM2D, WaveletAttribution2D
from wam_tpu_torch.wam3d import BaseWAM3D, WaveletAttribution3D, filter_coeffs
from wam_tpu_torch.wavelets.filters import Wavelet, build_wavelet
from wam_tpu_torch.wavelets.matmul import idwt2_kernel
from wam_tpu_torch.wavelets.transform import (
    DETAIL3D_KEYS,
    Detail2D,
    dwt,
    dwt2,
    dwt3,
    dwt_max_level,
    idwt,
    idwt2,
    idwt3,
    wavedec,
    wavedec2,
    wavedec3,
    waverec,
    waverec2,
    waverec3,
)
from wam_tpu_torch.xattr import (
    EvalVideoWAM,
    VideoLevels,
    WaveletAttributionVideo,
    attention_gradient,
    attention_rollout,
    plan_patch_levels,
    token_grid_map,
)

__all__ = [
    "AUDIO_METHODS",
    "AudioCNN",
    "BaseWAM1D",
    "BaseWAM2D",
    "BaseWAM3D",
    "ConvNeXt",
    "DETAIL3D_KEYS",
    "Detail2D",
    "Eval1DWAM",
    "Eval2DWAM",
    "EvalAudioBaselines",
    "EvalConfig",
    "EvalImageBaselines",
    "EvalVideoWAM",
    "IMAGE_METHODS",
    "PatchConv",
    "PointNetCls",
    "PointNetDenseCls",
    "PointNetFeat",
    "PrecisionPolicy",
    "ResNet",
    "ResNet3D",
    "ViT",
    "VideoLevels",
    "VisualizerWAM1D",
    "VoxelModel",
    "WAMAnalyzer2D",
    "WAMAnalyzerViT",
    "WamEngine",
    "Wavelet",
    "WaveletAttribution1D",
    "WaveletAttribution2D",
    "WaveletAttribution3D",
    "WaveletAttributionVideo",
    "amplitude_to_db",
    "attention_gradient",
    "attention_rollout",
    "bind_audio_inference",
    "bind_inference",
    "bind_vit_inference",
    "build_wavelet",
    "convnext_test",
    "convnext_tiny",
    "cube3d",
    "cube_size",
    "disentangle_scales",
    "dwt",
    "dwt2",
    "dwt3",
    "dwt_max_level",
    "feature_transform_regularizer",
    "filter_coeffs",
    "flax_audio_to_torch",
    "flax_convnext_to_torch",
    "flax_pointnet_to_torch",
    "flax_resnet3d_to_torch",
    "flax_resnet_to_torch",
    "flax_vit_to_torch",
    "flax_voxel_to_torch",
    "fused_relu",
    "idwt",
    "idwt2",
    "idwt2_kernel",
    "idwt3",
    "integrated_path",
    "mel_filterbank",
    "melspectrogram",
    "mosaic2d",
    "mosaic_size",
    "noise_sigma",
    "normalize_waveforms",
    "plan_patch_levels",
    "reproject_mosaic",
    "resnet18",
    "resnet34",
    "resnet101",
    "resnet3d_10",
    "resnet3d_18",
    "resnet50",
    "resolve_device",
    "resolve_precision",
    "sample_noise",
    "scaleogram",
    "smoothgrad",
    "stft_power",
    "target_loss",
    "token_grid_map",
    "toy_wave_model",
    "trapezoid",
    "validate_sample_batch_size",
    "visualize_cube",
    "vit_b16",
    "vit_tiny_test",
    "wavedec",
    "wavedec2",
    "wavedec3",
    "waverec",
    "waverec2",
    "waverec3",
]
