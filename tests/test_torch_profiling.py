"""The port's profiler (`wam_tpu_torch.profiling`) and environment check
(`wam_tpu_torch.env_check`) on the CPU:

- the host-clock timers and `median_iqr` (equal to the reference's);
  `device_time_samples` returns ``[]`` and `metric_fetch_split` reports the
  wall plane where no CUDA tensor is involved, as the reference does where
  no TPU plane exists;
- `profile_to` writes a Chrome trace that the readers take; a CPU capture
  holds no device event, so `named_op_split` and `synth_device_split` give
  None, as the reference's do off the TPU;
- the readers on a kineto-shaped trace written here: each kernel's launch
  matched to the host ops and spans around it, the token split and a
  caller's partition as interval unions, the launch counts, the
  host-to-device copies and their overlap with kernels;
- `start_server` raises with its reason;
- ``python -m wam_tpu_torch.env_check --device cpu`` passes."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from wam_tpu import profiling as jprof
from wam_tpu_torch import env_check
from wam_tpu_torch import profiling as tprof

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def test_host_timers_and_median_iqr():
    calls = []

    def fn(a):
        calls.append(1)
        return a * 2

    x = torch.ones(4)
    samples = tprof.bench_samples(fn, x, k=5, laps=3, warmup=2)
    assert len(samples) == 5 and all(s > 0 for s in samples) and len(calls) == 2 + 15
    assert tprof.bench_time(fn, x, repeats=2) > 0
    for s in ([0.3, 0.1, 0.2], [1.0], [4.0, 1.0, 3.0, 2.0]):
        assert tprof.median_iqr(s) == jprof.median_iqr(s)


def test_no_device_clock_on_cpu_tensors():
    x = torch.ones(4)
    assert tprof.device_time_samples(lambda a: a + 1, x, k=2) == []
    res = tprof.metric_fetch_split(lambda a: a + 1, x, k=2)
    assert res["plane"] == "wall" and res["device_s"] is None and res["residue_s"] is None
    assert res["wall_q1_s"] <= res["wall_s"] <= res["wall_q3_s"]
    assert tprof.device_time_samples(lambda a: a, x, device="cpu") == []


def test_a_cpu_capture_has_no_device_events(tmp_path):
    with tprof.profile_to(str(tmp_path)):
        with tprof.trace("wam_synth"):
            torch.ones(8).cumsum(0)
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "wam_synth" for e in events)
    assert tprof.kernel_events(str(tmp_path)) == []
    assert tprof.named_op_split(str(tmp_path)) is None
    assert tprof.h2d_stats(str(tmp_path)) is None
    assert tprof.synth_device_split(lambda a: a + 1, torch.ones(3)) is None
    assert tprof.kernel_events(str(tmp_path / "missing")) is None


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _trace(path):
    """Host: a span wam_synth (0-100) around an op (10-60) launching kernel
    A (corr 1) and kernel B (corr 2); an op at 120 launching C (corr 3) and
    a copy (corr 4); the backward thread's op launching D (corr 5). Device
    intervals: A 200-230, B 220-250 (overlapping A), C 300-310, the copy
    305-325 (1 MB, half over C), D 400-440."""
    events = [
        _x("user_annotation", "wam_synth", 0, 100),
        _x("cpu_op", "aten::conv2d", 10, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 2, correlation=1),
        _x("cuda_driver", "cuLaunchKernel", 40, 2, correlation=2),
        _x("cpu_op", "aten::add", 120, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 122, 2, correlation=3),
        _x("cuda_runtime", "cudaMemcpyAsync", 125, 2, correlation=4),
        _x("cpu_op", "autograd::engine::evaluate_function: XBackward", 130, 30, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 140, 2, tid=2, correlation=5),
        _x("kernel", "band2_kernel<wam_dwt2>", 200, 30, tid=9, correlation=1),
        _x("kernel", "collapsed::forward_kernel", 220, 30, tid=9, correlation=2),
        _x("kernel", "vectorized_elementwise_kernel", 300, 10, tid=9, correlation=3),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 305, 20, tid=9, correlation=4,
           bytes=1 << 20),
        _x("kernel", "collapsed::backward_kernel", 400, 40, tid=9, correlation=5),
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "ts": 20},
    ]
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_the_readers_on_a_device_trace(tmp_path):
    trace = _trace(tmp_path / "t.json")
    evs = {e.name: e for e in tprof.kernel_events(trace)}
    assert evs["band2_kernel<wam_dwt2>"].ops == ("aten::conv2d", "wam_synth")
    assert evs["vectorized_elementwise_kernel"].ops == ("aten::add",)
    assert evs["collapsed::backward_kernel"].ops == (
        "autograd::engine::evaluate_function: XBackward",)
    split = tprof.named_op_split(trace, ("wam_synth", "collapsed", "nothing"))
    assert split["wam_synth"] == pytest.approx(50e-6)  # A and B: 200-250
    assert split["collapsed"] == pytest.approx(70e-6)  # B and D
    assert split["nothing"] == 0.0
    assert split["total"] == pytest.approx((50 + 25 + 40) * 1e-6)

    def classify(ev):
        return "K" if "collapsed" in ev.name or "wam_dwt2" in ev.name else "other"

    part, counts = tprof.named_op_split(trace, classify=classify, launches=True)
    assert counts == {"K": 3, "other": 2}
    assert part["K"] == pytest.approx(90e-6) and part["other"] == pytest.approx(25e-6)
    h2d = tprof.h2d_stats(trace)
    assert h2d["h2d_bytes"] == 1 << 20 and h2d["h2d_seconds"] == pytest.approx(20e-6)
    assert h2d["overlap_frac"] == pytest.approx(0.25)
    assert tprof.named_op_split(str(tmp_path)) is not None  # a directory: its newest trace


def test_start_server_says_why_it_cannot():
    with pytest.raises(NotImplementedError, match="no live profiler server"):
        tprof.start_server(9999)


def test_env_check_runs_on_the_cpu(capsys):
    core, optional = env_check.check_imports()
    assert core == [] and env_check.CORE_DEPS == ["torch", "numpy", "scipy", "einops"]
    assert set(optional) <= set(env_check.OPTIONAL_DEPS)
    assert env_check.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "device: cpu" in out and out.strip().splitlines()[-1].startswith("OK:")
    assert env_check.main(["--device", "cuda"]) == 1  # no card here


def test_env_check_module_entry_point():
    proc = subprocess.run([sys.executable, "-m", "wam_tpu_torch.env_check", "--device", "cpu"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "OK:" in proc.stdout, proc.stdout + proc.stderr[-2000:]
    assert "FAIL" not in proc.stdout
