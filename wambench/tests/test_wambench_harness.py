"""The benchmark's harness on the CPU at a tiny size: every cell through the
same run, the last line's shape, a cell added only as new files, the
import guard, the FLOP counter and the roofline's bytes.

    python -m pytest wambench/tests -q
"""

from __future__ import annotations

import io
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from wambench import common, roofline, run  # noqa: E402
from wambench.families import resnet as fam_resnet  # noqa: E402
from wambench.families import vit as fam_vit  # noqa: E402

BENCH = common.load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 12345  # more than 32 signed bits, as a run's --seed may be


def tiny(cell: str) -> dict:
    """Overrides that shrink a cell to a CPU test's size (the widths of
    ResNet-50 kept; ViT-B/16 cut to 2 layers)."""
    ov = {"config": {"image_size": 32, "num_classes": 10},
          "traffic": {"batch": 2, "warmup_calls": 1, "trace_calls": 1,
                      "check_calls": 1}}
    kind = common.load_json(ROOT / "wambench" / "traffic" /
                            f"{next(w for w in BENCH['workloads'] if w['name'] == cell)['traffic']}.json")
    if kind["kind"] == "offline_attr":
        ov["traffic"].update(n_samples=3 if kind["method"] == "smooth" else 4, sample_batch_size=2)
    elif kind["kind"] == "serve_open_loop":
        ov["traffic"].update(rate_per_s=40.0, max_batch=2, n_samples=2, warmup_requests=2,
                             trace_before_end_s=0.5, trace_seconds=0.3, check_calls=3)
    else:
        ov["traffic"].update(explain_samples=2, n_iter=4, rows_per_model_call=8)
    if cell.startswith("vit"):
        ov["config"]["num_layers"] = 2
    return ov


def run_line(cell: str, trace: int, seconds: float = 0.6) -> tuple[int, dict]:
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.run(["--workload", cell, "--seed", str(SEED), "--seconds", str(seconds),
                      "--trace", str(trace)], device="cpu", overrides=tiny(cell))
    lines = buf.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else {}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_runs_and_prints_the_contract_line(cell, trace):
    rc, res = run_line(cell, trace)
    assert rc == 0
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]  # the port agrees with the reference
    assert res["attempted"] > 0 and res["failed"] == 0
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    e2e = {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])}
    if trace == 0:
        assert set(res["metrics"]) == e2e
    else:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_the_command_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "wambench/run.py", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


NEW_CELL = """
import json, sys
sys.path.insert(0, {root!r})
from wambench import run
rc = run.run(["--workload", "resnet50t.sg_tiny", "--seed", "7", "--seconds", "0.2", "--trace",
              "1"], device="cpu")
sys.exit(rc)
"""


def test_a_cell_added_only_as_new_files_is_found_and_run(tmp_path):
    """A new configuration, traffic mix, per-layer metric and limits file,
    and entries naming them: the harness runs the cell unchanged."""
    shutil.copytree(ROOT / "wambench", tmp_path / "wambench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(ROOT / "wam_tpu_torch", tmp_path / "wam_tpu_torch")
    b = tmp_path / "wambench"
    cfg = common.load_json(b / "configs" / "resnet50.json")
    cfg.update(name="resnet50t", image_size=32, num_classes=10)
    (b / "configs" / "resnet50t.json").write_text(json.dumps(cfg))
    traffic = common.load_json(b / "traffic" / "sg_b32.json")
    traffic.update(batch=2, n_samples=2, sample_batch_size=1, pool=1, warmup_calls=1,
                   trace_calls=1, check_calls=1)
    (b / "traffic" / "sg_tiny.json").write_text(json.dumps(traffic))
    (b / "limits" / "resnet50t.sg_tiny.json").write_text(
        json.dumps({"mosaic_rel_err": {"limit": 0.05}}))
    (b / "metrics" / "calls_traced.new.py").write_text(
        "def read(ctx):\n    return float(ctx.window.traced_calls)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "resnet50t", "source": "https://arxiv.org/abs/1512.03385",
                             "file": "wambench/configs/resnet50t.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "resnet50t.sg_tiny", "config": "resnet50t",
                               "traffic": "sg_tiny", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "calls_traced.new", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "attributions_per_s",
                               "workloads": ["resnet50t.sg_tiny"]})
    for m in bench["end_to_end"]:
        if m["name"] == "attributions_per_s":
            m["workloads"].append("resnet50t.sg_tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", NEW_CELL.format(root=str(tmp_path))],
                         cwd=tmp_path, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"]["calls_traced.new"] == {"value": 1.0, "unit": "calls"}


GUARD = """
import sys
sys.path.insert(0, {root!r})
from wambench import run
import io, contextlib
with contextlib.redirect_stdout(io.StringIO()):
    rc = run.run(["--workload", {cell!r}, "--seed", "3", "--seconds", "0.1", "--trace", "0"],
                 device="cpu", overrides={ov!r})
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_no_module_of_jax_or_the_jax_package_is_loaded(cell):
    out = subprocess.run([sys.executable, "-c", GUARD.format(root=str(ROOT), cell=cell,
                                                             ov=tiny(cell))],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(eval(out.stdout.strip().splitlines()[-1]))  # noqa: S307 - our own output
    assert not top & set(common.FORBIDDEN)
    assert "wam_tpu_torch" in top


def test_the_reference_imports_nothing_of_the_package():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import wambench.reference.wavelets, wambench.reference.wam, "
            "wambench.reference.resnet, wambench.reference.vit, wambench.reference.insdel\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    top = set(eval(out.stdout.strip().splitlines()[-1]))  # noqa: S307
    assert not top & ({"wam_tpu_torch"} | set(common.FORBIDDEN))


def test_flop_counter_gives_the_published_multiply_adds():
    r = fam_resnet.macs(common.load_json(ROOT / "wambench/configs/resnet50.json"), (224, 224))
    v = fam_vit.macs(common.load_json(ROOT / "wambench/configs/vit_b16.json"), (224, 224))
    assert abs(sum(r.values()) / 4.09e9 - 1) < 0.005  # torchvision: 4.09 GMAC
    assert abs(sum(v.values()) / 17.6e9 - 1) < 0.005  # 17.56 GMAC with the attention products


def test_roofline_bounds_match_chip_smokes_at_the_flagship():
    """chip_smoke.py's K1 and K3 bounds of the flagship's sample chunk
    (4 samples x 32 images x 3 planes, db4, 224^2): 0.0641 ms and 0.0969 ms
    (PERF.md's kernel table). Its K1 count adds the dense operators it reads
    (0.4 MB of 214 MB), which the benchmark leaves to the implementation."""
    planes = 4 * 32 * 3
    k1 = roofline.k1_bound_s(planes, 224, 224, 8, 3) * 1e3
    k3 = roofline.k3_bound_s(planes, 224, 224, 8, 3, 128, True) * 1e3
    assert abs(k1 / 0.0641 - 1) < 0.005
    assert abs(k3 / 0.0969 - 1) < 0.005
    lv = roofline.analysis_levels(planes, 224, 224, 8, 3)
    assert [b for b, _ in lv] == [planes * (224 * 224 + 4 * 115 * 115) * 4,
                                  planes * (115 * 115 + 4 * 61 * 61) * 4,
                                  planes * (61 * 61 + 4 * 34 * 34) * 4]
    k, nbytes, _ = roofline.collapsed(planes, 224, 224, 8, 3, 128)
    leaves = 34 * 34 + 3 * (34 * 34 + 61 * 61 + 115 * 115)
    assert k == 3 and nbytes == planes * (leaves + 224 * 224) * 4


def test_seeded_inputs_and_weights_repeat():
    import torch

    a = common.image_pool(SEED, 2, 2, 3, 32, 10, "cpu")
    b = common.image_pool(SEED, 2, 2, 3, 32, 10, "cpu")
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    specs = fam_resnet.param_specs(common.load_json(ROOT / "wambench/configs/resnet50.json"))
    w1 = common.make_weights(specs, SEED, "cpu")
    w2 = common.make_weights(specs, SEED, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert abs(sum(v.numel() for k, v in w1.items() if "running" not in k
                   and "num_batches" not in k) - 25_557_032) == 0  # torchvision's count
