#!/usr/bin/env python3
"""Times K1, K2 and K3 of two or more checkouts of the port, in turns.

    python3 scripts/torch_kernel_ab.py DIR [DIR ...]

Each DIR is the root of a checkout (for example the parent commit unpacked
with ``git archive`` into a git-ignored directory). The checkouts run in the
order given, each in its own process that imports ``wam_tpu_torch`` from
that DIR and builds its kernels there, so list them as A B B A to see the
spread. Each process calls the public functions under ``torch.no_grad()``,
so the script is the same for checkouts whose kernel wrappers differ:

- ``matmul.dwt2_kernel`` (K1) at the three analysis levels of the flagship
  (224²) and of path 2 (288²);
- ``matmul.idwt2_kernel`` (K2) forward at path 2's finest synthesis level
  (4 x 147² -> 288²), and forward + backward through autograd (the backward
  is a K1 launch; ``K2_backward`` is the difference);
- ``matmul.waverec2_collapsed`` (K3) on the levels each path collapses
  (flagship 34/61/115, path 2 42/77), its leaves made as the engine makes
  them (views of K1's output): forward, and forward + backward through
  autograd (``K3_<path>_backward`` is the difference). A checkout that
  assembles Y has the assembly timed as part of K3.

Float32, one sample chunk of images per launch, inputs from one seed. Each
case gives the event time per call (CUDA events around many calls, host
launch gaps included) and the device time per call (`torch.profiler`, the
kernels alone). Constants and the event timer come from that DIR's own
``chip_smoke.py``. Prints one JSON line per process and a last line with
the card. Needs one CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ITERS, WARMUP = 50, 5


def _device_ms(torch, fn) -> float:
    """Summed CUDA kernel time per call of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(ev, "self_device_time_total", 0.0) or 0.0 for ev in prof.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA)
    return total / 1e3 / ITERS


def one(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from wam_tpu_torch import kernels
    from wam_tpu_torch.wavelets import matmul as tmm

    for mod in (cs, kernels, tmm):
        assert Path(mod.__file__).resolve().is_relative_to(Path(root).resolve())
    kernels.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(cs.DEVICE)
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    n = cs.SAMPLE_CHUNK * cs.BATCH * cs.CHANNELS
    res = {"tree": root}

    def record(name, fn):
        res[f"{name}_ms"] = cs._time_ms(fn, iters=ITERS, warmup=WARMUP)
        res[f"{name}_device_ms"] = _device_ms(torch, fn)

    with torch.no_grad():
        for tag, side in (("flagship", cs.SIDE), ("path2", cs.SIDE2)):
            x = torch.randn((n, side, side), generator=g, device=dev)
            for level in range(1, cs.LEVELS + 1):
                record(f"K1_{tag}_level{level}",
                       lambda x=x: tmm.dwt2_kernel(x, cs.WAVELET, cs.MODE))
                x = tmm.dwt2_kernel(x, cs.WAVELET, cs.MODE)[:, 0].contiguous()
        h = (cs.SIDE2 + 7) // 2
        sub = torch.randn((n, 4, h, h), generator=g, device=dev)
        record("K2_forward", lambda: tmm.idwt2_kernel(sub, cs.WAVELET))
    sv = sub.clone().requires_grad_(True)
    gout = torch.randn((n, cs.SIDE2, cs.SIDE2), generator=g, device=dev)
    record("K2_forward_backward",
           lambda: torch.autograd.grad(tmm.idwt2_kernel(sv, cs.WAVELET), sv, gout))
    from wam_tpu_torch.wavelets import transform as tt

    for tag, side in (("flagship", cs.SIDE), ("path2", cs.SIDE2)):
        imgs = torch.randn((n // cs.CHANNELS, cs.CHANNELS, side, side), generator=g, device=dev)
        with torch.no_grad():
            coeffs = tt.wavedec2(imgs, cs.WAVELET, cs.LEVELS, cs.MODE, impl="kernel")
        keep = tt._collapse_count(coeffs[1:])
        flat = [coeffs[0]] + [t for d in coeffs[1:1 + keep] for t in d]
        leaves = [t.detach().requires_grad_(True) for t in flat]

        def rec(ls=leaves, keep=keep):
            return tmm.waverec2_collapsed(
                ls[0], [tt.Detail2D(*ls[1 + 3 * i:4 + 3 * i]) for i in range(keep)], cs.WAVELET)

        with torch.no_grad():
            gout = torch.randn(rec().shape, generator=g, device=dev)
            record(f"K3_{tag}_forward", rec)
        record(f"K3_{tag}_forward_backward",
               lambda rec=rec, gout=gout, leaves=leaves: torch.autograd.grad(rec(), leaves, gout))
    for key in ("", "_device"):
        res[f"K2_backward{key}_ms"] = (res[f"K2_forward_backward{key}_ms"]
                                       - res[f"K2_forward{key}_ms"])
        for tag in ("flagship", "path2"):
            res[f"K3_{tag}_backward{key}_ms"] = (res[f"K3_{tag}_forward_backward{key}_ms"]
                                                 - res[f"K3_{tag}_forward{key}_ms"])
    for key in ("", "_device"):
        for tag in ("flagship", "path2"):
            res[f"K1_{tag}_chunk{key}_ms"] = sum(res[f"K1_{tag}_level{lv}{key}_ms"]
                                                 for lv in range(1, cs.LEVELS + 1))
        res[f"K1_path2_chunk{key}_ms"] += res[f"K2_backward{key}_ms"]
    return res


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    for root in sys.argv[1:]:
        proc = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
