"""Run one cell of the benchmark once and print its result as the last line.

    python3 wambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in BENCHMARK.json at the checkout's
root; everything else is found by name: the configuration
``wambench/configs/<config>.json`` (its ``family`` names
``wambench/families/<family>.py``), the traffic mix
``wambench/traffic/<traffic>.json`` (its ``kind`` names the driver
``wambench/drivers/<kind>.py``), the limits of the correctness check
``wambench/limits/<cell>.json`` and each per-layer metric's reader
``wambench/metrics/<metric>.py``.

A run: set-up (the package's kernels built on the first run in the
checkout, seeded weights and inputs made on the card, the cell's shapes
warmed), then the window of ``--seconds``, then, with the package's state
freed, the check of sampled calls against the plain reference. With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a ``torch.profiler``
capture of a stretch of the window and from the package's spans and
counters. It exits with 2 and prints no result without enough cards, and
with 3 if a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

if __package__ in (None, ""):  # run as a script: the checkout's root in place of this folder
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from wambench import common  # noqa: E402


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_cell(name: str, seed: int, seconds: float, trace: bool, device, overrides=None):
    """The cell's entry, configuration, traffic, family and limits."""
    bench = common.load_json(common.ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = common.load_json(common.BENCH / "configs" / f"{entry['config']}.json")
    traffic = common.load_json(common.BENCH / "traffic" / f"{entry['traffic']}.json")
    limits_path = common.BENCH / "limits" / f"{name}.json"
    limits = common.load_json(limits_path) if limits_path.exists() else {}
    if overrides:
        cfg.update(overrides.get("config", {}))
        traffic.update(overrides.get("traffic", {}))
    family = importlib.import_module(f"wambench.families.{cfg['family']}")
    return SimpleNamespace(name=name, entry=entry, bench=bench, config=cfg, traffic=traffic,
                           limits=limits, family=family, seed=seed, seconds=seconds,
                           trace=trace, device=device)


def make_driver(cell):
    return importlib.import_module(f"wambench.drivers.{cell.traffic['kind']}").Driver(cell)


def set_precision(cfg: dict) -> None:
    import torch

    torch.backends.cudnn.allow_tf32 = bool(cfg["precision"]["cudnn_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["precision"]["matmul_tf32"])


def reference_precision() -> None:
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _metric_reader(name: str):
    path = common.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"wambench_metric_{len(name)}_{abs(hash(name))}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(cell, kind: str) -> list[dict]:
    """The cell's end-to-end (``kind`` "end_to_end") or per-layer metrics."""
    return [m for m in cell.bench[kind]
            if "workloads" not in m or cell.name in m["workloads"]]


def check(cell, driver, outputs: list, indices: list[int], every: bool = False) -> dict:
    """The sampled calls against the reference (float32, TF32 off): each
    number that the cell's limits file names (with ``every``, each number
    the driver compares), its worst over the calls, beside its limit."""
    import torch

    reference_precision()
    driver.setup_reference(torch.float32)
    worst: dict = {}
    for i in indices:
        want = driver.reference(i, outputs)
        for k, v in driver.compare(outputs[i], want).items():
            if every or k in cell.limits:
                worst[k] = max(worst.get(k, -math.inf), v) if math.isfinite(v) else math.inf
    return {k: {"value": v, "limit": cell.limits.get(k, {}).get("limit")}
            for k, v in worst.items()}


def is_correct(checks: dict) -> bool:
    return bool(checks) and all(c["limit"] is not None and math.isfinite(c["value"])
                                and c["value"] <= c["limit"] for c in checks.values())


def device_info(device, peak: int) -> dict:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}


def per_layer(cell, driver, window, tmpdir: str) -> tuple[dict, dict, dict]:
    """Per-layer metrics, the device's busy and window seconds and the
    breakdown, from the traced stretch."""
    from wambench import roofline, trace

    path = trace.export(window.profile, tmpdir)
    try:
        cap = trace.Capture(path)
    finally:
        os.remove(path)
    ctx = SimpleNamespace(cell=cell, capture=cap, window=window, facts=driver.facts(),
                          roofline=roofline, trace=trace)
    out = {}
    for m in cell_metrics(cell, "per_layer"):
        v = _metric_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"busy_s": cap.busy_s(), "window_s": cap.window_s}
    return out, dev, {"device_ops": cap.device_ops(), "idle_gaps": cap.idle_gaps()}


def run(argv=None, device=None, overrides=None, every=False) -> int:
    """One run; returns the exit code. ``device`` and ``overrides`` are for
    the tests, which drive the same run on the CPU at a tiny size;
    ``every`` checks every number the driver compares, also those without
    a limit (`wambench.readings`)."""
    args = parse(argv)
    common.set_environment()
    import torch

    if device is None:
        chips = None
        bench = common.load_json(common.ROOT / "BENCHMARK.json")
        for w in bench["workloads"]:
            if w["name"] == args.workload:
                chips = w["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < (chips or 1):
            _log(f"needs {chips or 1} CUDA device(s); torch sees "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    torch.set_num_threads(4)
    cell = load_cell(args.workload, args.seed, args.seconds, bool(args.trace), device, overrides)
    driver = make_driver(cell)

    from wam_tpu_torch import kernels, obs

    obs.configure(enabled=bool(args.trace))
    if args.trace:
        obs.set_ring_size(1 << 18)
    set_precision(cell.config)
    if device.type == "cuda":
        kernels.build_all()
    driver.setup_inputs()
    driver.setup_program()
    driver.warmup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - _T_START

    window = driver.window(args.seconds, bool(args.trace), obs, kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    metrics: dict = {}
    dev = device_info(device, peak)
    breakdown = None
    if args.trace:
        with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as d:
            metrics, busy, breakdown = per_layer(cell, driver, window, d)
        dev.update(busy)
        window.profile = None
    else:
        e2e = driver.e2e(window)
        e2e["setup_s"] = setup_s
        for m in cell_metrics(cell, "end_to_end"):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    driver.free_program()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    indices = driver.samples(window)
    t_check = time.perf_counter()
    checks = check(cell, driver, window.outputs, indices, every)
    check_s = time.perf_counter() - t_check
    correct = is_correct(checks)

    bad = common.forbidden_modules()
    if bad:
        _log("modules of JAX or of the JAX package were loaded: " + ", ".join(bad))
        return 3
    result = {"correct": correct, "attempted": window.items,
              "failed": window.failed, "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    _log(f"cell {cell.name} seed {args.seed}: {window.calls} calls, {window.items} items in "
         f"{window.seconds:.3f} s; setup {setup_s:.3f} s; checked calls {indices} in "
         f"{check_s:.3f} s; "
         f"card {common.power_limit() if device.type == 'cuda' else 'cpu'}")
    if window.ends:
        _log("mean seconds a call by quarter of the window: "
             + " ".join(f"{r:.4f}" for r in window.quarter_call_s()))
    for k, c in checks.items():
        _log(f"check {k} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
