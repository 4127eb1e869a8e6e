"""Checkpoint ingestion: the JAX package's model variables -> this port's
state dicts.

`flax_resnet_to_torch` takes the ``{'params', 'batch_stats'}`` tree of a
`wam_tpu.models.resnet` model (as numpy arrays, or anything numpy can read)
and returns the state dict of the matching `wam_tpu_torch.models.resnet`
module; `flax_audio_to_torch` does the same for `wam_tpu.models.audio`'s
AudioCNN and `wam_tpu_torch.models.audio.AudioCNN`. So both packages can run
the same weights:

- conv kernel (kh, kw, I, O) -> weight (O, I, kh, kw); conv bias as is
- dense kernel (in, out) -> weight (out, in); bias as is
- BatchNorm scale/bias + mean/var -> weight/bias + running_mean/running_var
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["flax_resnet_to_torch", "flax_audio_to_torch"]


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
