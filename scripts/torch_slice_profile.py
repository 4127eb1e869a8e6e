#!/usr/bin/env python3
"""Where the time of the port's flagship slice goes on the card.

    python3 scripts/torch_slice_profile.py [--path2]

Runs `wam_tpu_torch.WaveletAttribution2D` SmoothGrad on ResNet-50, set up by
`chip_smoke.build_slice` (the paths of chip_smoke.py, one definition for
both: batch 32, db4, J=3, n_samples=25, sample_batch_size=4, cuDNN TF32 on;
3x224x224 for the flagship, or with ``--path2`` 3x288x288 with
``fused_relu_vjp=True``) once to warm up, then once under `torch.profiler`,
and prints one JSON line: the call's wall time, the summed device time of
its kernels by group (K1-K5, convolutions, matmuls, other), and the
device's idle share (1 - summed kernel time / wall time; one stream, so
kernels do not overlap). Needs one CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

GROUPS = (  # first match wins, on the lower-cased kernel name
    ("K2 idwt2_kernel", ("wam_synth2",)),        # band2_kernel<.., wam_synth2::QuadrantSource<..>, ..>
    ("K1 dwt2_kernel", ("wam_dwt2",)),           # band2_kernel<.., wam_dwt2::QuadrantStore>
    ("K3 waverec2_collapsed", ("collapsed::",)),  # collapsed::forward_kernel, backward_kernel
    ("K4 fused_relu forward", ("relu_fwd_kernel",)),
    ("K5 fused_relu backward", ("relu_bwd_kernel",)),
    ("convolution (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad",
                             "fprop", "winograd", "cutlass")),
    ("matmul (cuBLAS)", ("gemm", "gemv")),
    ("batchnorm", ("batch_norm", "bn_")),
    ("pooling", ("pool",)),
)


def _group(name: str) -> str:
    low = name.lower()
    for label, keys in GROUPS:
        if any(k in low for k in keys):
            return label
    return "other (elementwise, reductions, copies)"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_slice_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import wam_tpu_torch as wtt
    from wam_tpu_torch import kernels

    kernels.build_all()
    path2 = "--path2" in sys.argv[1:]
    side = chip_smoke.SIDE2 if path2 else chip_smoke.SIDE
    _, wam, x, y, _ = chip_smoke.build_slice(torch, wtt, side=side, fused_relu_vjp=path2)
    wam(x, y)
    torch.cuda.synchronize()

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        wam(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    groups: dict[str, float] = {}
    launches: dict[str, int] = {}
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total", 0.0) or 0.0
        if dt <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        label = _group(ev.key)
        groups[label] = groups.get(label, 0.0) + dt / 1e3
        launches[label] = launches.get(label, 0) + ev.count
    busy_ms = sum(groups.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({
        "path": "path2 (288^2, fused_relu_vjp)" if path2 else "flagship (224^2)",
        "gpu": smi, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
        "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "kernel_launches": launches,
    }))
    if busy_ms == 0:
        print("torch_slice_profile: the profiler recorded no device time", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
