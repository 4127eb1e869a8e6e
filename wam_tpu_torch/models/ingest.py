"""Checkpoint ingestion: the JAX package's model variables -> this port's
state dicts.

`flax_resnet_to_torch` takes the ``{'params', 'batch_stats'}`` tree of a
`wam_tpu.models.resnet` model (as numpy arrays, or anything numpy can read)
and returns the state dict of the matching `wam_tpu_torch.models.resnet`
module; `flax_audio_to_torch` does the same for `wam_tpu.models.audio`'s
AudioCNN and `wam_tpu_torch.models.audio.AudioCNN`, `flax_vit_to_torch` for
`wam_tpu.models.vit` (timm's names) and `flax_convnext_to_torch` for
`wam_tpu.models.convnext` (torchvision's names); the last two are the
inverses of the reference's `torch_vit_to_flax` and `torch_convnext_to_flax`.
`flax_resnet3d_to_torch`, `flax_voxel_to_torch` and `flax_pointnet_to_torch`
carry the 3D models across by name (`resnet3d`, `voxel`, `pointnet`).
So both packages can run the same weights:

- conv kernel (kh, kw, I, O) -> weight (O, I, kh, kw), and (kd, kh, kw, I,
  O) -> (O, I, kd, kh, kw); conv bias as is
- the PointNets' point-shared dense kernels (I, O) -> 1x1 Conv1d weights
  (O, I, 1); the voxel model's ``fc1`` rows, which JAX flattens in NDHWC
  order, permuted to PyTorch's NCDHW order
- dense kernel (in, out) -> weight (out, in); bias as is
- BatchNorm scale/bias + mean/var -> weight/bias + running_mean/running_var
- LayerNorm scale/bias -> weight/bias
- the ViT's per-projection attention kernels (dim, heads, head_dim) -> one
  fused ``qkv`` weight (3 dim, dim), rows q, k, v; the output kernel
  (heads, head_dim, dim) -> ``proj.weight`` (dim, dim)

Collections other than ``params`` and ``batch_stats`` (the ViT's and
ConvNeXt's init-time ``perturbations`` taps) carry no weights and are
ignored.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

__all__ = ["flax_resnet_to_torch", "flax_audio_to_torch", "flax_vit_to_torch",
           "flax_convnext_to_torch", "flax_resnet3d_to_torch", "flax_voxel_to_torch",
           "flax_pointnet_to_torch"]


def _t(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))


def _conv(kernel) -> torch.Tensor:
    """A flax conv kernel (*spatial, I, O) of any rank -> (O, I, *spatial)."""
    k = np.asarray(kernel)
    return _t(k.transpose((k.ndim - 1, k.ndim - 2) + tuple(range(k.ndim - 2))))


def _take_bn(state: dict, node_p, node_s, prefix: str) -> None:
    state[f"{prefix}.weight"] = _t(node_p["scale"])
    state[f"{prefix}.bias"] = _t(node_p["bias"])
    state[f"{prefix}.running_mean"] = _t(node_s["mean"])
    state[f"{prefix}.running_var"] = _t(node_s["var"])
    state[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def flax_resnet_to_torch(variables: Mapping) -> dict[str, torch.Tensor]:
    params, stats = variables["params"], variables["batch_stats"]
    state: dict[str, torch.Tensor] = {}

    def take_bn(node_p, node_s, prefix: str):
        _take_bn(state, node_p, node_s, prefix)

    state["conv1.weight"] = _conv(params["conv1"]["kernel"])
    take_bn(params["bn1"], stats["bn1"], "bn1")
    for block, node in params.items():
        if not block.startswith("layer"):
            continue
        stage, idx = block.split("_")  # "layer{s}_{i}" -> torch "layer{s}.{i}"
        prefix = f"{stage}.{idx}"
        for name, sub in node.items():
            if name.startswith("conv"):
                state[f"{prefix}.{name}.weight"] = _conv(sub["kernel"])
            elif name.startswith("bn"):
                take_bn(sub, stats[block][name], f"{prefix}.{name}")
            elif name == "downsample_conv":
                state[f"{prefix}.downsample.0.weight"] = _conv(sub["kernel"])
            elif name == "downsample_bn":
                take_bn(sub, stats[block][name], f"{prefix}.downsample.1")
            else:
                raise KeyError(f"unexpected ResNet variable {block}/{name}")
    state["fc.weight"] = _t(np.asarray(params["fc"]["kernel"]).T)
    state["fc.bias"] = _t(params["fc"]["bias"])
    return state


def flax_audio_to_torch(variables: Mapping) -> dict[str, torch.Tensor]:
    """AudioCNN variables: every ``bN_conv`` / ``head`` (kernel and bias) and
    ``bN_bn`` (scale, bias and batch stats) under the same name."""
    params, stats = variables["params"], variables["batch_stats"]
    state: dict[str, torch.Tensor] = {}
    for name, node in params.items():
        if name.endswith("_conv") or name == "head":
            state[f"{name}.weight"] = _conv(node["kernel"])
            state[f"{name}.bias"] = _t(node["bias"])
        elif name.endswith("_bn"):
            _take_bn(state, node, stats[name], name)
        else:
            raise KeyError(f"unexpected AudioCNN variable {name}")
    return state


def _dense(state: dict, node, prefix: str) -> None:
    state[f"{prefix}.weight"] = _t(np.asarray(node["kernel"]).T)
    state[f"{prefix}.bias"] = _t(node["bias"])


def _ln(state: dict, node, prefix: str) -> None:
    state[f"{prefix}.weight"] = _t(node["scale"])
    state[f"{prefix}.bias"] = _t(node["bias"])


def _blocks(params: Mapping, stem: str) -> list[str]:
    """The names ``{stem}{i}`` of ``params``, in the order of i."""
    return sorted((k for k in params if k.startswith(stem) and k[len(stem):].isdigit()),
                  key=lambda k: int(k[len(stem):]))


def flax_vit_to_torch(variables: Mapping) -> dict[str, torch.Tensor]:
    """`wam_tpu.models.vit` variables -> the state dict of
    `wam_tpu_torch.models.vit.ViT` (timm's names)."""
    params = variables["params"]
    state: dict[str, torch.Tensor] = {
        "cls_token": _t(params["cls_token"]),
        "pos_embed": _t(params["pos_embed"]),
        "patch_embed.proj.weight": _conv(params["patch_embed"]["kernel"]),
        "patch_embed.proj.bias": _t(params["patch_embed"]["bias"]),
    }
    for i, name in enumerate(_blocks(params, "block")):
        node, p = params[name], f"blocks.{i}"
        _ln(state, node["ln1"], f"{p}.norm1")
        _ln(state, node["ln2"], f"{p}.norm2")
        attn = node["attn"]
        dim = np.asarray(attn["query"]["kernel"]).shape[0]
        # (dim, heads, head_dim) kernels -> (dim_out, dim_in) rows of qkv
        state[f"{p}.attn.qkv.weight"] = _t(np.concatenate(
            [np.asarray(attn[q]["kernel"]).reshape(dim, dim).T for q in ("query", "key", "value")]))
        state[f"{p}.attn.qkv.bias"] = _t(np.concatenate(
            [np.asarray(attn[q]["bias"]).reshape(dim) for q in ("query", "key", "value")]))
        state[f"{p}.attn.proj.weight"] = _t(np.asarray(attn["out"]["kernel"]).reshape(dim, dim).T)
        state[f"{p}.attn.proj.bias"] = _t(attn["out"]["bias"])
        _dense(state, node["mlp"]["fc1"], f"{p}.mlp.fc1")
        _dense(state, node["mlp"]["fc2"], f"{p}.mlp.fc2")
    _ln(state, params["ln"], "norm")
    _dense(state, params["head"], "head")
    return state


def flax_convnext_to_torch(variables: Mapping) -> dict[str, torch.Tensor]:
    """`wam_tpu.models.convnext` variables -> the state dict of
    `wam_tpu_torch.models.convnext.ConvNeXt` (torchvision's names: stem
    ``features.0``, downsampler of stage s ``features.{2s}``, its blocks
    ``features.{2s+1}.{i}``, head ``classifier.{0,2}``)."""
    params = variables["params"]
    state: dict[str, torch.Tensor] = {
        "features.0.0.weight": _conv(params["stem_conv"]["kernel"]),
        "features.0.0.bias": _t(params["stem_conv"]["bias"]),
    }
    _ln(state, params["stem_ln"], "features.0.1")
    stage = 0
    while f"stage{stage}_block0" in params:
        if stage > 0:
            _ln(state, params[f"down{stage}_ln"], f"features.{2 * stage}.0")
            state[f"features.{2 * stage}.1.weight"] = _conv(params[f"down{stage}_conv"]["kernel"])
            state[f"features.{2 * stage}.1.bias"] = _t(params[f"down{stage}_conv"]["bias"])
        for i, name in enumerate(_blocks(params, f"stage{stage}_block")):
            node, p = params[name], f"features.{2 * stage + 1}.{i}"
            # depthwise kernel (kh, kw, 1, dim) -> (dim, 1, kh, kw)
            state[f"{p}.block.0.weight"] = _conv(node["dwconv"]["kernel"])
            state[f"{p}.block.0.bias"] = _t(node["dwconv"]["bias"])
            _ln(state, node["ln"], f"{p}.block.2")
            _dense(state, node["pw1"], f"{p}.block.3")
            _dense(state, node["pw2"], f"{p}.block.5")
            state[f"{p}.layer_scale"] = _t(np.asarray(node["gamma"]).reshape(-1, 1, 1))
        stage += 1
    _ln(state, params["head_ln"], "classifier.0")
    _dense(state, params["head"], "classifier.2")
    return state


def _walk(state: dict, params: Mapping, stats: Mapping, prefix: str = "",
          point_shared: tuple[str, ...] = ()) -> dict[str, torch.Tensor]:
    """Every conv, dense and BatchNorm of a flax variable tree under its own
    name (a block ``layer{s}_{i}`` as torch's ``layer{s}.{i}``); the dense
    layers named in ``point_shared`` become 1x1 Conv1d weights."""
    for name, node in params.items():
        key = prefix + re.sub(r"^(layer\d+)_(\d+)$", r"\1.\2", name)
        if "kernel" in node:
            k = np.asarray(node["kernel"])
            if k.ndim > 2:
                state[f"{key}.weight"] = _conv(k)
            else:
                state[f"{key}.weight"] = _t(k.T[..., None] if name in point_shared else k.T)
            if "bias" in node:
                state[f"{key}.bias"] = _t(node["bias"])
        elif "scale" in node:
            _take_bn(state, node, stats[name], key)
        else:
            _walk(state, node, stats.get(name, {}), key + ".", point_shared)
    return state


def flax_resnet3d_to_torch(variables: Mapping) -> dict[str, torch.Tensor]:
    """`wam_tpu.models.resnet3d` variables -> the state dict of
    `wam_tpu_torch.models.resnet3d.ResNet3D` (the same names; a block
    ``layer{s}_{i}`` is ``layer{s}.{i}``)."""
    return _walk({}, variables["params"], variables["batch_stats"])


def flax_voxel_to_torch(variables: Mapping) -> dict[str, torch.Tensor]:
    """`wam_tpu.models.voxel.VoxelModel` variables -> the state dict of
    `wam_tpu_torch.models.voxel.VoxelModel`. JAX flattens the pooled
    features (B, d, h, w, C) in NDHWC order, the port in NCDHW order:
    ``fc1``'s input columns are permuted to match."""
    state = _walk({}, variables["params"], {})
    ch = state["conv2.weight"].shape[0]
    w = state["fc1.weight"]
    side = round((w.shape[1] // ch) ** (1 / 3))
    state["fc1.weight"] = (w.reshape(w.shape[0], side, side, side, ch)
                           .permute(0, 4, 1, 2, 3).reshape(w.shape[0], -1).contiguous())
    return state


def flax_pointnet_to_torch(variables: Mapping) -> dict[str, torch.Tensor]:
    """`wam_tpu.models.pointnet` variables (`PointNetCls`,
    `PointNetDenseCls`, `PointNetFeat` or `STN`) -> the state dict of the
    same `wam_tpu_torch.models.pointnet` module: the same names, the
    point-shared dense layers (``mlp1``-``mlp3``, ``c1``-``c4``) as 1x1
    Conv1d weights."""
    return _walk({}, variables["params"], variables["batch_stats"],
                 point_shared=("mlp1", "mlp2", "mlp3", "c1", "c2", "c3", "c4"))
