"""The port's online schedule learning (`wam_tpu_torch.tune.mix`,
`wam_tpu_torch.tune.online`) held to the reference's on the same serve
ledger rows: the mined mix (torn lines included), the drift report, the
serve-plane proposal, the canary verdict and the live preset's
candidates; then the shadow tuner's pass in process and through
``python -m wam_tpu_torch.tune.online --once`` on a ledger the test
writes, its kill switch, and the registry bundle it cannot publish yet."""

import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import wam_tpu.tune.cache as jcache
import wam_tpu.tune.mix as jmix
import wam_tpu.tune.online as jonline
import wam_tpu_torch.tune.cache as tcache
import wam_tpu_torch.tune.mix as tmix
import wam_tpu_torch.tune.online as tonline
from wam_tpu.tune import workloads as jwl
from wam_tpu_torch.tune import workloads as twl

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# the sweeps run many small ops: one intra-op thread keeps them from
# stalling on a machine whose cores other test workers share
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def caches(tmp_path, monkeypatch):
    monkeypatch.setenv("WAM_TORCH_SCHEDULE_CACHE", str(tmp_path / "port.json"))
    monkeypatch.setenv("WAM_TPU_SCHEDULE_CACHE", str(tmp_path / "ref.json"))
    monkeypatch.delenv("WAM_TPU_NO_SCHEDULE_CACHE", raising=False)
    monkeypatch.delenv("WAM_TPU_NO_ONLINE_TUNE", raising=False)
    jcache.invalidate_process_cache()
    tcache.invalidate_process_cache()
    yield tmp_path
    jcache.invalidate_process_cache()
    tcache.invalidate_process_cache()


def _rows(seed: int = 0, n: int = 40, shift: float = 1.0) -> list[dict]:
    """serve_batch rows over three buckets (one a paged model's), the later
    quarter of the 16-wide bucket ``shift`` x slower; a few other rows."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        bucket = [[3, 16, 16], [3, 32, 32], [3, 16, 16]][i % 3]
        n_real = int(rng.integers(1, 9))
        slow = shift if (i > 3 * n // 4 and bucket[1] == 16) else 1.0
        row = {"metric": "serve_batch", "bucket": bucket, "n_real": n_real,
               "service_s": float(0.01 * n_real * slow * (1 + 0.05 * rng.random())),
               "timestamp": 1000.0 + i, "occupancy": n_real / 8,
               "queue_depth": int(rng.integers(0, 4)),
               "qos": {"interactive": n_real // 2, "batch": n_real - n_real // 2},
               "schedule_fingerprint": "fpA" if i % 2 else "fpB",
               "tenants": {"t0": n_real}}
        if i % 3 == 2:
            row["model_id"] = "m1"
        rows.append(row)
    rows.append({"metric": "serve_summary", "completed": 5, "timestamp": 2000.0})
    rows.append({"metric": "serve_batch", "bucket": [4], "n_real": 0, "timestamp": 3000.0})
    return rows


def _write_ledger(path, rows, torn: bool = True):
    with open(path, "w") as f:
        for i, r in enumerate(rows):
            f.write(json.dumps(r) + "\n")
            if torn and i == 5:
                f.write('{"metric": "serve_batch", "bucket": [3, 1\n')
        if torn:
            f.write('{"metric": "serve_ba')


def _both(fn_name, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (getattr(tmix, fn_name)(*args, **kw), getattr(jmix, fn_name)(*args, **kw))


@pytest.mark.parametrize("window", [None, 12.0])
def test_mined_mix_matches_the_reference(caches, window):
    path = caches / "serve.jsonl"
    _write_ledger(path, _rows())
    t, j = _both("mine_ledger", str(path), window_s=window)
    assert t.to_dict() == j.to_dict()
    assert t.corrupt_lines == j.corrupt_lines == 2
    assert [b.key for b in t.dominant(3)] == [b.key for b in j.dominant(3)]
    t, j = _both("mine_rows", _rows(1), source="<rows>")
    assert t.to_dict() == j.to_dict()
    assert _both("mine_rows", [{"metric": "serve_summary"}]) == (None, None)
    assert tmix.mine_ledger(str(caches / "missing.jsonl")) is None


@pytest.mark.parametrize("shift,threshold", [(1.0, 1.5), (3.0, 1.5), (0.2, 1.5), (3.0, 4.0)])
def test_drift_report_matches_the_reference(shift, threshold):
    tm, jm = _both("mine_rows", _rows(2, n=60, shift=shift))
    for predictions in (None, {"3x32x32": 0.005, "3x16x16": 0.02}):
        t = tmix.drift_report(tm, threshold=threshold, predictions=predictions)
        j = jmix.drift_report(jm, threshold=threshold, predictions=predictions)
        assert t == j
    with pytest.raises(ValueError, match="threshold"):
        tmix.drift_report(tm, threshold=1.0)


def test_serve_plan_and_canary_verdict_match_the_reference(caches):
    tm, jm = _both("mine_rows", _rows(3, n=60))
    for kw in (dict(), dict(current_cap=4, max_cap=16), dict(replicas=2, default_cap=4)):
        assert tonline.plan_serve_schedule(tm, **kw) == jonline.plan_serve_schedule(jm, **kw)
    rows = _rows(4, n=80)
    for kw in (dict(), dict(margin=0.2), dict(min_batches=50), dict(since=1030.0)):
        assert (tonline.canary_verdict(rows, "fpA", "fpB", **kw)
                == jonline.canary_verdict(rows, "fpA", "fpB", **kw))


def test_the_live_preset_matches_the_reference(caches):
    tm, jm = _both("mine_rows", _rows(5, n=30))
    t = twl.get_workload("wamlive", mix=tm, device="cpu")
    j = jwl.get_workload("wamlive", mix=jm)
    assert [c.label() for c in t.candidates] == [c.label() for c in j.candidates]
    assert (t.shape, t.batch, t.items) == (tuple(j.shape), j.batch, j.items)
    fn, args = t.build(t.candidates[0])
    assert np.isfinite(float(fn(*args)))


def test_the_shadow_tuner_mines_sweeps_and_promotes(caches):
    """One forced pass: the mix, the drift rows, a challenger table written
    to its own file under the fingerprint serving would give it; a promotion
    installs it and writes its row; a registry bundle raises."""
    ledger = caches / "serve.jsonl"
    _write_ledger(ledger, _rows(6, n=48, shift=3.0), torn=False)
    cfg = tonline.OnlineTuneConfig(ledger=str(ledger), force_sweep=True, n_samples=2,
                                   sweep_k=1, sweep_laps=1, min_batches=4, device="cpu")
    tuner = tonline.OnlineTuner(cfg)
    out = tuner.step()
    assert out["mix"]["rows"] == 48 and out["drift"]["drifted"]
    chall = out["challenger"]
    assert os.path.exists(chall["path"]) and chall["sweep"]["plane"] == "wall"
    merged = {**tcache.ScheduleCache().entries, **chall["entries"]}
    assert chall["fingerprint"] == tcache.entries_fingerprint(merged)
    drift_rows = [json.loads(line) for line in open(ledger) if '"schedule_drift"' in line]
    assert drift_rows and all(r["schema_version"] == 2 for r in drift_rows)
    verdict = {"verdict": "challenger", "champion_fp": "fpA", "improvement": 0.1}
    promoted = tuner.promote(chall, verdict)
    assert promoted["live_fingerprint"] == chall["fingerprint"]
    assert tcache.load_schedule_cache().get(chall["keys"][0]) is not None
    # bundle_dir= publishes the promotion (tests/test_torch_registry.py)
    tuner.config.bundle_dir = str(caches / "bundle")
    tuner.config.bundle_aot_keys = []
    assert tuner.promote(chall, verdict)["bundle"]["dir"] == str(caches / "bundle")


def test_the_kill_switch_freezes_the_tuner(caches, monkeypatch):
    ledger = caches / "serve.jsonl"
    _write_ledger(ledger, _rows(7), torn=False)
    monkeypatch.setenv("WAM_TPU_NO_ONLINE_TUNE", "1")
    assert tonline.online_tune_disabled()
    out = tonline.OnlineTuner(tonline.OnlineTuneConfig(ledger=str(ledger), device="cpu")).step()
    assert out == {"disabled": True}


def test_the_cli_once_on_a_ledger(caches):
    ledger = caches / "serve.jsonl"
    _write_ledger(ledger, _rows(8, n=24))
    env = {**os.environ, **ONE_THREAD, "WAM_TORCH_SCHEDULE_CACHE": str(caches / "s.json")}
    env.pop("WAM_TPU_NO_ONLINE_TUNE", None)
    proc = subprocess.run([sys.executable, "-m", "wam_tpu_torch.tune.online", "--ledger",
                           str(ledger), "--once", "--device", "cpu"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["mix"]["rows"] == 24 and out["mix"]["corrupt_lines"] == 2
    empty = caches / "empty.jsonl"
    empty.write_text("")
    proc = subprocess.run([sys.executable, "-m", "wam_tpu_torch.tune.online", "--ledger",
                           str(empty), "--once", "--device", "cpu"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and json.loads(proc.stdout.strip()) == {"mix": None}


def test_the_config_takes_the_card_by_default(monkeypatch, tmp_path):
    """`OnlineTuneConfig()` with no device takes the card (None, as the
    CLI's ``--device auto``) and raises without one; ``device="cpu"`` is the
    only way onto the CPU, and the CLI's default is "auto"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tonline.OnlineTuneConfig(ledger=str(tmp_path / "serve.jsonl"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tonline.OnlineTuneConfig(ledger=str(tmp_path / "serve.jsonl"), device="cuda")
    assert tonline.OnlineTuneConfig(ledger=str(tmp_path / "serve.jsonl"),
                                    device="cpu").device == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tonline.main(["--ledger", str(tmp_path / "serve.jsonl"), "--once"])
