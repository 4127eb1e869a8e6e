#!/usr/bin/env python3
"""The two exact forms of the ViT's attention and of `PatchConv`, timed on
the card.

    python3 scripts/torch_vit_forms.py

The port keeps one form of each: ``F.scaled_dot_product_attention`` in
`wam_tpu_torch.models.vit.Attention` and the block reshape plus matmul in
`wam_tpu_torch.models.patchconv.PatchConv` (the reference's forms are the
explicit product, softmax and product, and the same matmul). This script
defines the other form of each (`explicit_attention`, `strided_conv`) and
times both in the whole attribution call of chip_smoke.py's ViT and
ConvNeXt phases (`chip_smoke.build_vit` / `vit_wam`: one 224² image, haar,
J=3, IG 64 path points, chunk 16, TF32 on for matmuls and convolutions),
the form set on every module of the model, in turns A B B A. Each turn
gives the median of 3 CUDA-event-timed calls after a warm call and the
device time of one more call under `torch.profiler` (the sum of its
kernels' times): the calls can be bound by the host, and the device time
is what the form itself costs. Each turn's attribution is held against the
first turn's (max abs error, relative to its max). Prints one JSON line
with the times and the card's name and power limit. Needs one CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def explicit_attention(self, x):
    """`Attention.forward` in the reference's form: queries scaled, the
    product with the keys, the softmax, the product with the values."""
    import torch

    B, N, D = x.shape
    q, k, v = self.qkv(x).reshape(B, N, 3, self.heads, D // self.heads).permute(2, 0, 3, 1, 4)
    w = torch.softmax((q * q.shape[-1] ** -0.5) @ k.transpose(-2, -1), dim=-1)
    return self.proj((w @ v).transpose(1, 2).reshape(B, N, D))


def strided_conv(self, x):
    """`PatchConv.forward` as a stride-p convolution of the channels-last
    view (VALID: the remainders are never read)."""
    import torch.nn.functional as F

    return F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                    stride=self.patch).permute(0, 2, 3, 1)


def _set(modules, forward) -> None:
    """Give every module ``forward`` (None: its class's own)."""
    for m in modules:
        if forward is None:
            m.__dict__.pop("forward", None)
        else:
            m.forward = types.MethodType(forward, m)


def _busy_ms(torch, call) -> float:
    """Device time of one ``call``: the sum of its kernels' times."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def _turns(torch, chip_smoke, kernels, wam, x, y, modules, other) -> dict:
    """The call with the kept form (A) and ``other`` (B), A B B A: event
    medians, device times, and each turn's attribution against the first."""
    out = {"kept_ms": [], "other_ms": [], "kept_device_ms": [], "other_device_ms": [],
           "max_rel_err": 0.0}
    first = None
    for name in ("kept", "other", "other", "kept"):
        _set(modules, None if name == "kept" else other)
        run = chip_smoke._time_calls(torch, kernels, wam, x, y, 3, items=1, unit="attributions")
        out[f"{name}_ms"].append(run["median_ms"])
        out[f"{name}_device_ms"].append(_busy_ms(torch, lambda: wam(x, y)))
        first = run["out"] if first is None else first
        err = float((run["out"] - first).abs().max() / first.abs().max())
        out["max_rel_err"] = max(out["max_rel_err"], err)
    _set(modules, None)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_vit_forms: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import wam_tpu_torch as wtt
    from wam_tpu_torch import kernels
    from wam_tpu_torch.models.patchconv import PatchConv
    from wam_tpu_torch.models.vit import Attention

    kernels.build_all()
    dev = torch.device(chip_smoke.DEVICE)
    prec = chip_smoke._precision(torch, True)
    result = {"precision": prec}
    for arch in ("vit", "convnext"):
        model, fn, x, y = chip_smoke.build_vit(torch, wtt, arch)
        wam = chip_smoke.vit_wam(wtt, fn, dev)
        patches = [m for m in model.modules() if isinstance(m, PatchConv)]
        result[arch] = {"patchconv": _turns(torch, chip_smoke, kernels, wam, x, y, patches,
                                            strided_conv)}
        if arch == "vit":
            attn = [m for m in model.modules() if isinstance(m, Attention)]
            result[arch]["attention"] = _turns(torch, chip_smoke, kernels, wam, x, y, attn,
                                               explicit_attention)
        del model, fn, wam
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({**result, "gpu": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
