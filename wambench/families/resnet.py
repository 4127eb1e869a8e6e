"""The ResNet family: parameter layout, seeded weights, the measured
package's model, the plain reference and the model's multiply-adds.

Weights (the benchmark's own rule, stated in the configuration file): every
convolution He-normal over its fan-in, std sqrt(2 / fan_in); the head
normal with std 1 / sqrt(fan_in) and a zero bias; BatchNorm in inference
form with running mean 0, running variance 1, bias 0 and scale 1, except
the last BatchNorm of each bottleneck, whose scale is
``config["residual_bn_scale"]`` so the residual stream stays near unit
size through the depth, as a trained network's does.
"""

from __future__ import annotations

import math

from wambench.reference import resnet as reference

EXPANSION = 4


def _blocks(cfg: dict):
    in_ch = cfg["stem_width"]
    for s, n in enumerate(cfg["stage_blocks"]):
        width = cfg["stem_width"] * 2**s
        for i in range(n):
            stride = 2 if s > 0 and i == 0 else 1
            yield f"layer{s + 1}.{i}", in_ch, width, stride
            in_ch = width * EXPANSION


def param_specs(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, kind, value): kind "normal" (value = std), "fill"
    (float32) or "count" (int64)."""
    specs = []

    def conv(name, o, i, k):
        specs.append((name + ".weight", (o, i, k, k), "normal", math.sqrt(2.0 / (i * k * k))))

    def bn(name, ch, scale=1.0):
        specs.extend([(name + ".weight", (ch,), "fill", scale), (name + ".bias", (ch,), "fill", 0.0),
                      (name + ".running_mean", (ch,), "fill", 0.0),
                      (name + ".running_var", (ch,), "fill", 1.0),
                      (name + ".num_batches_tracked", (), "count", 0)])

    stem = cfg["stem_width"]
    conv("conv1", stem, cfg["in_channels"], 7)
    bn("bn1", stem)
    for p, in_ch, width, stride in _blocks(cfg):
        out = width * EXPANSION
        conv(p + ".conv1", width, in_ch, 1)
        bn(p + ".bn1", width)
        conv(p + ".conv2", width, width, 3)
        bn(p + ".bn2", width)
        conv(p + ".conv3", out, width, 1)
        bn(p + ".bn3", out, cfg["residual_bn_scale"])
        if stride != 1 or in_ch != out:
            conv(p + ".downsample.0", out, in_ch, 1)
            bn(p + ".downsample.1", out)
    feat = stem * 2 ** (len(cfg["stage_blocks"]) - 1) * EXPANSION
    specs.append(("fc.weight", (cfg["num_classes"], feat), "normal", 1.0 / math.sqrt(feat)))
    specs.append(("fc.bias", (cfg["num_classes"],), "fill", 0.0))
    return specs


def build_port(cfg: dict, weights: dict, device):
    """The measured package's ResNet with ``weights``, bound for attribution."""
    import torch

    from wam_tpu_torch.models import resnet

    if cfg["stage_blocks"] != [3, 4, 6, 3] or cfg["stem_width"] != 64:
        raise ValueError("the package builds ResNet-50's stages only")
    with torch.device("meta"):
        model = resnet.resnet50(num_classes=cfg["num_classes"])
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return resnet.bind_inference(model, nchw=True, device=device)


def reference_forward(cfg: dict, weights: dict):
    stages = tuple(cfg["stage_blocks"])
    return lambda x: reference.forward(weights, x, stages)


def _conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def macs(cfg: dict, image_hw) -> dict:
    """Multiply-adds of one image's forward pass by kind, from the shapes:
    every convolution and the head."""
    H, W = image_hw
    stem = cfg["stem_width"]
    h, w = _conv_out(H, 7, 2, 3), _conv_out(W, 7, 2, 3)
    conv = h * w * stem * cfg["in_channels"] * 49
    h, w = _conv_out(h, 3, 2, 1), _conv_out(w, 3, 2, 1)  # max-pool
    for _, in_ch, width, stride in _blocks(cfg):
        out = width * EXPANSION
        conv += h * w * width * in_ch
        h2, w2 = _conv_out(h, 3, stride, 1), _conv_out(w, 3, stride, 1)
        conv += h2 * w2 * width * width * 9 + h2 * w2 * out * width
        if stride != 1 or in_ch != out:
            conv += h2 * w2 * out * in_ch
        h, w = h2, w2
    feat = stem * 2 ** (len(cfg["stage_blocks"]) - 1) * EXPANSION
    return {"conv": conv, "linear": feat * cfg["num_classes"], "attention": 0}
