"""Autotuner CLI.

    python -m wam_tpu_torch.tune --workload toy --dry-run --device cpu   # the CPU smoke
    python -m wam_tpu_torch.tune --workload flagship                      # tune + persist
    python -m wam_tpu_torch.tune --workload mu2d --k 5

Sweeps the workload's candidate schedules (`wam_tpu_torch.tune.workloads`),
prints one progress line per candidate to stderr and ONE JSON line to
stdout (the winner, every candidate's median / quartiles / items/s /
plane / peak GB / kernel launches a call, whether the winner was
persisted; on the card also ``device_name`` and ``power_limit``), and
persists the winner to the user schedule cache
(``$WAM_TORCH_SCHEDULE_CACHE`` or ``~/.cache/wam_tpu_torch/schedules.json``)
unless ``--dry-run``. The plane is ``"device"`` (CUDA events) on the card
and ``"wall"`` (host clock) on the CPU. ``--device auto`` (the default) is
the card, and an error when none is visible: the sweep runs on the CPU
only on ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def _card_identity() -> dict:
    import torch

    out = {"device_name": torch.cuda.get_device_name(0), "power_limit": None}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        out["power_limit"] = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m wam_tpu_torch.tune",
                                description="Sweep candidate schedules and persist the winner.")
    p.add_argument("--workload", default="toy",
                   help="preset: toy | flagship | mu2d | fan2d | mel1d | wamvit2d | wamvid3d | "
                        "wamseq1d | wamseq2d")
    p.add_argument("--device", default="auto",
                   help="auto (the card; an error without one) | cuda | cpu")
    p.add_argument("--k", type=int, default=3, help="timed regions a candidate")
    p.add_argument("--laps", type=int, default=2, help="calls a timed region")
    p.add_argument("--dry-run", action="store_true",
                   help="sweep and report but do not persist the winner")
    args = p.parse_args(argv)

    from wam_tpu_torch.device import resolve_device
    from wam_tpu_torch.tune.autotuner import autotune
    from wam_tpu_torch.tune.cache import default_cache_path
    from wam_tpu_torch.tune.workloads import get_workload

    device = resolve_device(args.device)
    if device.type == "cuda":
        from wam_tpu_torch import kernels

        kernels.build_all()
    wl = get_workload(args.workload, device=device)
    print(f"# device={device} workload={wl.name} candidates={len(wl.candidates)} k={args.k} "
          f"laps={args.laps}", file=sys.stderr)
    res = autotune(wl, k=args.k, laps=args.laps, persist=not args.dry_run,
                   log=lambda s: print(s, file=sys.stderr))
    out = {
        "workload": wl.name,
        "key": res["key"],
        "winner": res["winner"]["label"],
        "items_per_s": round(res["winner"]["items_per_s"], 3),
        "median_s": round(res["winner"]["median_s"], 6),
        "plane": res["winner"]["plane"],
        "backend": device.type,
        "persisted": res["persisted"],
        "cache": default_cache_path() if res["persisted"] else None,
        "candidates": [
            {"label": r["label"], "items_per_s": round(r["items_per_s"], 3),
             "median_s": round(r["median_s"], 6), "q1_s": round(r["q1_s"], 6),
             "q3_s": round(r["q3_s"], 6), "plane": r["plane"],
             "peak_gb": None if r["peak_gb"] is None else round(r["peak_gb"], 3),
             "launches": r["launches"]}
            for r in res["results"]
        ],
    }
    if device.type == "cuda":
        out.update(_card_identity())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
