"""What every cell shares: seeds, seeded weights and images made on the
device, the run's caches inside the checkout, the device's description,
and the check that no JAX module was loaded."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent  # the checkout
BENCH = Path(__file__).resolve().parent
CACHE = ROOT / "build" / "wambench"  # every cache a run writes (git-ignored)

FORBIDDEN = ("jax", "jaxlib", "flax", "wam_tpu")

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def set_environment() -> None:
    """Before torch is imported: the package's knobs cleared (a cell runs as
    its files state), its caches and any compiler's at fixed paths inside
    the checkout, and JAX kept out of libraries that would load it."""
    for key in list(os.environ):
        if key.startswith(("WAM_TORCH_", "WAM_TPU_")):
            del os.environ[key]
    CACHE.mkdir(parents=True, exist_ok=True)
    os.environ["WAM_TORCH_SCHEDULE_CACHE"] = str(CACHE / "schedules.json")
    os.environ["WAM_TPU_AOT_CACHE"] = str(CACHE / "aot")
    os.environ["WAM_TPU_CACHE_DIR"] = str(CACHE / "registry")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed that is a function of (seed, tags) only."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32] + [int(t) for t in tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) & (2**63 - 1)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def make_weights(specs, seed: int, device) -> dict:
    """Weights from the family's specs: every "normal" leaf cut from one
    standard-normal draw of a generator on ``device`` and scaled, the rest
    filled; float32, as served."""
    import torch

    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    total = sum(int(np.prod(shape)) for _, shape, kind, _ in specs if kind == "normal")
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, shape, kind, value in specs:
        if kind == "normal":
            n = int(np.prod(shape))
            out[name] = flat[off:off + n].view(shape).mul_(value)
            off += n
        elif kind == "count":
            out[name] = torch.full(shape, int(value), dtype=torch.int64, device=device)
        else:
            out[name] = torch.full(shape, float(value), dtype=torch.float32, device=device)
    return out


def port_model(cell):
    """The package's model of the cell's configuration, bound for
    attribution, with the seeded weights."""
    weights = make_weights(cell.family.param_specs(cell.config), cell.seed, cell.device)
    return cell.family.build_port(cell.config, weights, cell.device)


def reference_model(cell, dtype):
    """The plain reference's forward with the same seeded weights, made
    again from the seed (nothing of the package's), cast to ``dtype``."""
    weights = make_weights(cell.family.param_specs(cell.config), cell.seed, cell.device)
    weights = {k: v.to(dtype) if v.is_floating_point() else v for k, v in weights.items()}
    return cell.family.reference_forward(cell.config, weights)


def _images(g, n: int, channels: int, side: int, classes: int, device):
    """``n`` ImageNet-standardized images and labels from the generator
    ``g``: smooth random images in [0, 1] (a coarse random field upsampled,
    plus fine noise, clipped), then standardized."""
    import torch
    import torch.nn.functional as F

    coarse = torch.rand((n, channels, max(side // 8, 2), max(side // 8, 2)), generator=g,
                        device=device)
    img = F.interpolate(coarse, size=(side, side), mode="bilinear", align_corners=False)
    img = (img + 0.1 * torch.randn((n, channels, side, side), generator=g, device=device)).clamp(0, 1)
    mean = torch.tensor(IMAGENET_MEAN[:channels], device=device).reshape(1, -1, 1, 1)
    std = torch.tensor(IMAGENET_STD[:channels], device=device).reshape(1, -1, 1, 1)
    y = torch.randint(0, classes, (n,), generator=g, device=device)
    return (img - mean) / std, y


def image_pool(seed: int, pool: int, batch: int, channels: int, side: int, classes: int, device):
    """``pool`` batches of images and their labels, (pool, batch, C, S, S)
    and (pool, batch). Same seed, same images."""
    import torch

    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    x, y = _images(g, pool * batch, channels, side, classes, device)
    return x.reshape(pool, batch, channels, side, side), y.reshape(pool, batch)


def image_batch(seed: int, index: int, batch: int, channels: int, side: int, classes: int,
                device):
    """Call ``index``'s own batch of images and labels, made on the device
    from (seed, index): every call of a window explains images no other
    call has seen."""
    import torch

    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 6, index))
    return _images(g, batch, channels, side, classes, device)


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)
