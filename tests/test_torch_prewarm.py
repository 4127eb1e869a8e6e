"""``python -m wam_tpu_torch.prewarm`` (the port of `wam_tpu.prewarm`) in
fresh processes on the CPU: the toy preset's chunk step compiled and
exported, then loaded by a second process ("hit", no compile), then a
bundle published from its manifest (``registry publish --from-prewarm``),
hydrated into empty cache directories and loaded by a third process
("registry_hit", no compile). Three subprocesses, each with the caches of
the test's own."""

import json
import os
import subprocess
import sys
from pathlib import Path

from wam_tpu_torch.registry import __main__ as registry_cli

ROOT = Path(__file__).resolve().parent.parent
# the reference's summary keys (`wam_tpu/prewarm.py`), its xla_cache_dir
# being compile_cache_dir here
REF_KEYS = {"config", "backend", "batch", "sample_chunk", "stream_noise", "synth_impl",
            "schedule_entries", "schedule_stale_files", "compile_cache_dir", "aot",
            "aot_cache_dir", "warm_s", "warmed"}


def _env(root: Path, tag: str) -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT),
            "WAM_TPU_AOT_CACHE": str(root / f"aot{tag}"),
            "WAM_TPU_CACHE_DIR": str(root / f"compile{tag}"),
            "TORCHINDUCTOR_CACHE_DIR": str(root / f"compile{tag}"),
            "TRITON_CACHE_DIR": str(root / f"compile{tag}" / "triton"),
            "WAM_TORCH_SCHEDULE_CACHE": str(root / "schedules.json"),
            "TORCHINDUCTOR_COMPILE_THREADS": "1"}  # the suite's workers share the machine


def _prewarm(root: Path, tag: str, manifest=None) -> dict:
    cmd = [sys.executable, "-m", "wam_tpu_torch.prewarm", "--config", "toy", "--device", "cpu"]
    if manifest is not None:
        cmd += ["--manifest", str(manifest)]
    proc = subprocess.run(cmd, cwd=ROOT, env=_env(root, tag), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout  # ONE JSON line
    return json.loads(lines[0])


def test_prewarm_exports_then_hits_then_hydrates_from_a_bundle(tmp_path, capsys):
    manifest = tmp_path / "warm.json"
    cold = _prewarm(tmp_path, "1", manifest)
    assert REF_KEYS <= set(cold) and "xla_cache_dir" not in cold
    assert cold["aot"] == "exported" and cold["backend"] == "cpu" and cold["compiles"] >= 1
    assert cold["compile_cache_dir"] == str(tmp_path / "compile1")
    warmed = cold["warmed"]
    assert warmed["aot_keys"] == [s["key"] for s in cold["aot_steps"]]
    assert all(k.startswith(cold["aot_key"] + "|smooth|") for k in warmed["aot_keys"])
    assert warmed["platform"]["backend"] == "cpu"
    assert json.loads(manifest.read_text()) == cold

    hit = _prewarm(tmp_path, "1")
    assert hit["aot"] == "hit" and hit["compiles"] == 0
    assert [s["aot"] for s in hit["aot_steps"]] == ["hit"] * len(warmed["aot_keys"])

    bundle = tmp_path / "bundle"
    assert registry_cli.main(["--device", "cpu", "publish", "--out", str(bundle),
                              "--aot-dir", str(tmp_path / "aot1"),
                              "--compile-dir", str(tmp_path / "compile1"),
                              "--library-dir", str(tmp_path / "no-libs"),
                              "--schedule-cache", str(tmp_path / "schedules.json"),
                              "--from-prewarm", str(manifest)]) == 0
    pub = json.loads(capsys.readouterr().out)
    # no kernel library on the CPU and no compile-cache file: the compiled
    # steps' payloads alone make the hydrated prewarm below a registry_hit
    assert pub["aot"] == len(warmed["aot_keys"]) and pub["compile"] == 0
    assert registry_cli.main(["hydrate", str(bundle), "--aot-dir", str(tmp_path / "aot2"),
                              "--compile-dir", str(tmp_path / "compile2"),
                              "--schedule-cache", str(tmp_path / "schedules.json")]) == 0
    row = json.loads(capsys.readouterr().out)
    assert row["status"] == "hydrated" and row["artifacts"]["aot:hydrated"] == pub["aot"]

    hydrated = _prewarm(tmp_path, "2")
    assert hydrated["aot"] == "registry_hit" and hydrated["compiles"] == 0
    assert [s["key"] for s in hydrated["aot_steps"]] == warmed["aot_keys"]
