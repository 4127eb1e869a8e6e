"""The ViT family: parameter layout, seeded weights, the measured package's
model, the plain reference and the model's multiply-adds.

Weights (the benchmark's own rule, stated in the configuration file):
every dense and patch kernel LeCun-normal, std 1 / sqrt(fan_in), as the
JAX reference's initialisers draw them (without their truncation); zero
biases; position embeddings normal with std 0.02; the class token normal
with std 0.02 (the published initialisation leaves it zero until trained);
LayerNorm scale 1, bias 0.
"""

from __future__ import annotations

import math

from wambench.reference import vit as reference


def _tokens(cfg: dict) -> int:
    return (cfg["image_size"] // cfg["patch_size"]) ** 2 + 1


def param_specs(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    D, M, p, C = cfg["hidden_size"], cfg["mlp_size"], cfg["patch_size"], cfg["in_channels"]
    specs = [("cls_token", (1, 1, D), "normal", 0.02),
             ("pos_embed", (1, _tokens(cfg), D), "normal", 0.02),
             ("patch_embed.proj.weight", (D, C, p, p), "normal", 1.0 / math.sqrt(C * p * p)),
             ("patch_embed.proj.bias", (D,), "fill", 0.0)]

    def dense(name, o, i):
        specs.extend([(name + ".weight", (o, i), "normal", 1.0 / math.sqrt(i)),
                      (name + ".bias", (o,), "fill", 0.0)])

    def ln(name):
        specs.extend([(name + ".weight", (D,), "fill", 1.0), (name + ".bias", (D,), "fill", 0.0)])

    for i in range(cfg["num_layers"]):
        b = f"blocks.{i}"
        ln(b + ".norm1")
        dense(b + ".attn.qkv", 3 * D, D)
        dense(b + ".attn.proj", D, D)
        ln(b + ".norm2")
        dense(b + ".mlp.fc1", M, D)
        dense(b + ".mlp.fc2", D, M)
    ln("norm")
    dense("head", cfg["num_classes"], D)
    return specs


def build_port(cfg: dict, weights: dict, device):
    """The measured package's ViT with ``weights``, bound for attribution
    (NCHW input, as its attribution call feeds it)."""
    import torch

    from wam_tpu_torch.models import resnet, vit

    with torch.device("meta"):
        model = vit.ViT(num_classes=cfg["num_classes"], patch=cfg["patch_size"],
                        dim=cfg["hidden_size"], depth=cfg["num_layers"], heads=cfg["num_heads"],
                        mlp_hidden=cfg["mlp_size"], image_size=cfg["image_size"])
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return resnet.bind_inference(model, nchw=True, device=device)


def reference_forward(cfg: dict, weights: dict):
    return lambda x: reference.forward(weights, x, cfg["num_heads"], cfg["num_layers"])


def macs(cfg: dict, image_hw) -> dict:
    """Multiply-adds of one image's forward pass by kind: the patch
    projection and every dense layer ("linear"), and the two attention
    products q k^T and A v ("attention")."""
    D, M, p = cfg["hidden_size"], cfg["mlp_size"], cfg["patch_size"]
    n_patch = (image_hw[0] // p) * (image_hw[1] // p)
    N = n_patch + 1
    linear = n_patch * D * cfg["in_channels"] * p * p
    linear += cfg["num_layers"] * N * (3 * D * D + D * D + 2 * D * M)
    linear += D * cfg["num_classes"]
    attention = cfg["num_layers"] * 2 * N * N * D
    return {"conv": 0, "linear": linear, "attention": attention}
