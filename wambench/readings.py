"""The lower readings of a cell's correctness check: sound runs of the
package on many seeds, each with a short window, in one process (set-up
builds the kernels once), every number the driver compares printed with
its worst over the run's checked calls, one JSON line a seed. The limits
in ``wambench/limits/`` sit above the largest of these and below the
control's (`wambench/control.py`).

    python3 wambench/readings.py --workload <cell> --seconds <s> --seed <n> [--seed <n> ...]

The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from wambench import run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the lower readings of a cell's check")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seed", type=int, action="append", required=True)
    args = p.parse_args(argv)
    rc = 0
    for seed in args.seed:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = run.run(["--workload", args.workload, "--seed", str(seed), "--seconds",
                            str(args.seconds), "--trace", "0"], every=True)
        lines = buf.getvalue().strip().splitlines()
        if code or not lines:
            print(json.dumps({"workload": args.workload, "seed": seed, "rc": code}), flush=True)
            rc = 1
            continue
        res = json.loads(lines[-1])
        print(json.dumps({"workload": args.workload, "seed": seed, "attempted": res["attempted"],
                          "failed": res["failed"], "checks": res["checks"]}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
