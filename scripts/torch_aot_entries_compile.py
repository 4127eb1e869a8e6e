#!/usr/bin/env python3
"""Where the cold compiles of `chip_smoke.py`'s phase aot_entries spend
their time, and how the host's cores share them.

    python3 scripts/torch_aot_entries_compile.py

Runs `chip_smoke.aot_entry_child` (the audio, vol and video paths'
``serve_entry(aot_key=)`` at their full widths, cuDNN deterministic, TF32
off, every chunk step compiled cold) three ways, each in cache directories
of its own: the three children at once with Inductor's default compile
threads, the three at once with two compile threads a child
(``TORCHINDUCTOR_COMPILE_THREADS=2``), and the audio child alone. Prints one
JSON line a way: its wall seconds and, a child, its first call's seconds
and the totals above 2 s of `torch._dynamo.utils.compilation_time_metrics`
(Dynamo's tracing, AOTAutograd, Inductor's lowering, scheduling and
codegen, Triton's compiles), then one summary line a way. Writes the three
to ``chiprun_out/aot_entries_compile.json``. Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CHILD = ("import sys; sys.path.insert(0, {root!r}); import chip_smoke, json; "
         "chip_smoke.aot_entry_child({kind!r}, 'compile|{kind}', 'cuda'); "
         "import torch._dynamo.utils as u; "
         "print(json.dumps({{k: round(sum(v), 2) for k, v in "
         "u.compilation_time_metrics.items() if sum(v) > 2.0}}))")


def run(chip_smoke, kinds, threads, tag: str) -> dict:
    """``kinds``' cold children at once in fresh cache directories."""
    root = tempfile.mkdtemp(prefix=f"aot_entries_compile_{tag}_")
    env = {**os.environ, **chip_smoke._aot_env(root, "")}
    if threads is not None:
        env["TORCHINDUCTOR_COMPILE_THREADS"] = str(threads)
    t0 = time.perf_counter()
    procs = {kind: subprocess.Popen(
        [sys.executable, "-c", CHILD.format(root=str(ROOT), kind=kind)], cwd=str(ROOT),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for kind in kinds}
    kids = {}
    for kind, proc in procs.items():
        out, err = proc.communicate(timeout=1200)
        if proc.returncode != 0:
            raise SystemExit(f"{kind}: the child failed:\n{err[-3000:]}")
        lines = out.strip().splitlines()
        kids[kind] = {"child": json.loads(lines[-2]), "times_s": json.loads(lines[-1]),
                      "done_s": time.perf_counter() - t0}
    res = {"tag": tag, "compile_threads": threads, "wall_s": time.perf_counter() - t0,
           "children": kids}
    print(json.dumps(res), flush=True)
    return res


def main() -> int:
    import torch

    import chip_smoke
    from wam_tpu_torch import kernels

    if not torch.cuda.is_available():
        print("torch_aot_entries_compile: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke._nvidia_smi(), flush=True)
    kernels.build_all()  # the children load the libraries under their hashed names
    ways = [run(chip_smoke, chip_smoke.AOT_ENTRY_KINDS, None, "default"),
            run(chip_smoke, chip_smoke.AOT_ENTRY_KINDS, 2, "threads2"),
            run(chip_smoke, ("audio",), None, "audio_alone")]
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "aot_entries_compile.json", "w") as f:
        json.dump(ways, f, indent=1)
    for way in ways:
        print(way["tag"], f"{way['wall_s']:.1f} s",
              {k: round(v["child"]["first_call_s"], 1) for k, v in way["children"].items()},
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
