"""Models and checkpoint ingestion (PyTorch port of `wam_tpu.models`)."""

from wam_tpu_torch.models.audio import AudioCNN, bind_audio_inference
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
    STN,
    PointNetCls,
    PointNetDenseCls,
    PointNetFeat,
    PointNetfeat,
    STN3d,
    STNkd,
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

__all__ = [
    "AudioCNN",
    "ConvNeXt",
    "PatchConv",
    "PointNetCls",
    "PointNetDenseCls",
    "PointNetFeat",
    "PointNetfeat",
    "ResNet",
    "ResNet3D",
    "STN",
    "STN3d",
    "STNkd",
    "ViT",
    "VoxelModel",
    "bind_audio_inference",
    "bind_inference",
    "bind_vit_inference",
    "convnext_test",
    "convnext_tiny",
    "feature_transform_regularizer",
    "flax_audio_to_torch",
    "flax_convnext_to_torch",
    "flax_pointnet_to_torch",
    "flax_resnet3d_to_torch",
    "flax_resnet_to_torch",
    "flax_vit_to_torch",
    "flax_voxel_to_torch",
    "resnet18",
    "resnet34",
    "resnet101",
    "resnet3d_10",
    "resnet3d_18",
    "resnet50",
    "vit_b16",
    "vit_tiny_test",
]
