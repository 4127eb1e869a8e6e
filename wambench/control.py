"""The control of a cell's correctness check: the plain reference put in
the package's place and computed in the configuration's ``control_dtype``
(bfloat16: the nearest precision below the float32-with-TF32 the
configurations state), on the cell's inputs for ``check_calls`` calls,
then judged by the same comparison with the float32 reference. Its numbers
are the upper readings the limits in ``wambench/limits/`` sit below; a
control that passes every limit means the check cannot tell the lower
precision, and this exits 1.

    python3 wambench/control.py --workload <cell> --seed <n> [--seed <n> ...]

The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from wambench import common  # noqa: E402


def control_run(workload: str, seed: int, device, overrides=None, every=False) -> dict:
    """One seed's control: the checks of its calls, as `run.check` gives them."""
    import torch

    from wambench import run

    cell = run.load_cell(workload, seed, 0.0, False, torch.device(device), overrides)
    driver = run.make_driver(cell)
    driver.setup_inputs()
    driver.setup_reference(getattr(torch, cell.config["control_dtype"]))
    call = driver.control()
    idx = driver.control_indices(cell.traffic["check_calls"])
    outputs = [None] * (max(idx) + 1)
    for i in idx:
        outputs[i] = call(i)
    return run.check(cell, driver, outputs, idx, every)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the control of a cell's correctness check")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    p.add_argument("--every", action="store_true",
                   help="print every number the driver compares, also those without a limit")
    args = p.parse_args(argv)
    common.set_environment()
    import torch

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    failed_all = True
    for seed in args.seed:
        checks = control_run(args.workload, seed, "cuda", every=args.every)
        from wambench.run import is_correct

        ok = is_correct({k: c for k, c in checks.items() if c["limit"] is not None})
        failed_all &= not ok
        print(json.dumps({"workload": args.workload, "seed": seed, "control_correct": ok,
                          "checks": checks}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
