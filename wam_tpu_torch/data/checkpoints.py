"""Model registry and checkpoint loading (PyTorch port of
`wam_tpu.data.checkpoints`).

The port's models carry torchvision's and timm's parameter names, so a
PyTorch checkpoint (``.pth`` / ``.pt`` / ``.bin``) loads with
`models.ingest.strip_module_prefix` (DataParallel's ``module.``) and
``load_state_dict(strict=True)``, where the reference converts it to a flax
tree. The native format, in the place of the reference's orbax
checkpoints, is ``torch.save`` of the state dict, read back with
``torch.load(weights_only=True)``. A model without a checkpoint gets the
port's initialisers (the reference's) drawn from torch's CPU generator
seeded 0 (the reference initialises from ``PRNGKey(0)``), inside
`torch.random.fork_rng`, so the caller's generator state is left as it
was.
"""

from __future__ import annotations

import os
from typing import Any

import torch
import torch.nn as nn

from wam_tpu_torch.models.audio import AudioCNN, bind_audio_inference
from wam_tpu_torch.models.convnext import convnext_tiny
from wam_tpu_torch.models.ingest import strip_module_prefix
from wam_tpu_torch.models.pointnet import PointNetCls
from wam_tpu_torch.models.resnet import bind_inference, resnet18, resnet34, resnet50, resnet101
from wam_tpu_torch.models.vit import vit_b16
from wam_tpu_torch.models.voxel import VoxelModel

__all__ = ["build_vision_model", "load_3d_model", "load_3dvoxel_model", "load_audio_model",
           "save_variables", "load_variables"]

VISION_MODELS = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "vit_b16": vit_b16,
    "convnext_tiny": convnext_tiny,
}
TORCH_CHECKPOINT = (".pth", ".pt", ".bin")


def _seeded(ctor, **kwargs) -> nn.Module:
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return ctor(**kwargs)


def _state(model: nn.Module) -> dict:
    """A CPU copy of the model's state dict (what binding may fold or cast
    in place is not the caller's copy)."""
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def build_vision_model(model_key: str = "resnet18", num_classes: int = 1000,
                       checkpoint_path: str | None = None, image_size: int = 224,
                       compute_dtype: torch.dtype | None = None, nchw: bool = True,
                       fold_bn: bool = False, device=None):
    """Build a vision model by key (`VISION_MODELS`), load a PyTorch or native
    checkpoint when given, and bind it for attribution. Returns (model,
    state dict, model_fn); model_fn takes NCHW input (``nchw=False``: NHWC,
    for ``WaveletAttribution2D(model_layout="nhwc")``). ``image_size`` sets
    the ViT's position table. ``compute_dtype`` and ``fold_bn`` are
    `models.resnet.bind_inference`'s; ``device`` is where the model runs
    (CUDA unless the caller asks otherwise)."""
    if model_key not in VISION_MODELS:
        raise ValueError(f"Unknown model key {model_key!r}; options: {sorted(VISION_MODELS)}")
    kwargs = {"num_classes": num_classes}
    if model_key.startswith("vit"):
        kwargs["image_size"] = image_size
    model = _seeded(VISION_MODELS[model_key], **kwargs)
    if checkpoint_path is not None:
        if checkpoint_path.endswith(TORCH_CHECKPOINT):
            state = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
            model.load_state_dict(strip_module_prefix(state), strict=True)
        else:
            load_variables(checkpoint_path, model)
    variables = _state(model)
    return model, variables, bind_inference(model, nchw=nchw, compute_dtype=compute_dtype,
                                            fold_bn=fold_bn, device=device)


def _bound(model: nn.Module, checkpoint_path: str | None, device):
    if checkpoint_path:
        load_variables(checkpoint_path, model)
    variables = _state(model)
    return variables, bind_inference(model, device=device)


def load_3d_model(checkpoint_path: str | None, num_classes: int, feature_transform: bool,
                  num_points: int = 1024, device=None):
    """PointNet classifier: (model, state dict, x (B, 3, N) -> log-probs)."""
    model = _seeded(PointNetCls, k=num_classes, feature_transform=feature_transform)
    variables, fn = _bound(model, checkpoint_path, device)
    return model, variables, lambda x: fn(x)[0]


def load_3dvoxel_model(checkpoint_path: str | None, num_classes: int = 10, size: int = 16,
                       device=None):
    """Voxel CNN on ``size``^3 grids: (model, state dict, model_fn)."""
    model = _seeded(VoxelModel, num_classes=num_classes, size=size)
    variables, fn = _bound(model, checkpoint_path, device)
    return model, variables, fn


def load_audio_model(checkpoint_path: str | None = None, num_classes: int = 50,
                     time_frames: int = 128, n_mels: int = 128, device=None):
    """Audio CNN and its bound inference function: (model, state dict,
    (B, 1, T, n_mels) -> logits). ``time_frames`` and ``n_mels`` are the
    reference's init shapes; the port's layers do not depend on them."""
    model = _seeded(AudioCNN, num_classes=num_classes)
    if checkpoint_path:
        load_variables(checkpoint_path, model)
    return model, _state(model), bind_audio_inference(model, device=device)


# -- native checkpoints ----------------------------------------------------------


def save_variables(path: str, variables: Any) -> None:
    """Write a state dict (or a module's) as a native checkpoint."""
    if isinstance(variables, nn.Module):
        variables = variables.state_dict()
    torch.save({k: v.detach().cpu() for k, v in variables.items()}, os.path.abspath(path))


def load_variables(path: str, like: Any = None) -> dict:
    """Read a native checkpoint. With ``like`` a module, load it into the
    module strictly; with ``like`` a state dict, check the names and shapes
    match. Returns the state dict read."""
    state = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if isinstance(like, nn.Module):
        like.load_state_dict(state, strict=True)
    elif like is not None:
        want = {k: tuple(v.shape) for k, v in like.items()}
        got = {k: tuple(v.shape) for k, v in state.items()}
        bad = sorted(k for k in set(want) | set(got) if want.get(k) != got.get(k))
        if bad:
            raise ValueError(f"checkpoint {path} does not match its model at {bad}")
    return state
