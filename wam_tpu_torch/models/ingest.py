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
So both packages can run the same weights:

- conv kernel (kh, kw, I, O) -> weight (O, I, kh, kw); conv bias as is
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

from typing import Mapping

import numpy as np
import torch

__all__ = ["flax_resnet_to_torch", "flax_audio_to_torch", "flax_vit_to_torch",
           "flax_convnext_to_torch"]


def _t(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))


def _conv(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


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
