"""The port's schedule autotuner (`wam_tpu_torch.tune`: cache, autotuner,
workloads, CLI, the "auto" readers) and the 2D transforms' process-wide
knobs, held to the reference (`wam_tpu.tune`, `wam_tpu.wavelets`) on the
CPU:

- the schedule key on the same arguments (the reference's "pallas" impl is
  the port's "kernel", its "tpu" backend the port's "cuda"); versioned cache
  files written by each package read the same by both, a stale version
  ignored wholesale by both; `lookup_schedule` and every ``resolve_*`` on
  the same tables; `entries_fingerprint` equal on equal entries;
- `chunk_candidates`, `Candidate` labels and entries, and every preset's
  candidate labels (the reference's ResNet-50 presets built on a stand-in
  model: no JAX ResNet is initialised);
- with no cache file every "auto" reader resolves as before the cache
  existed (a test per reader), and with an entry each reads it;
- the knobs: names, defaults, precedence of a per-call ``impl=``, error
  messages (the package's impl names aside);
- the toy sweep in process and through ``python -m wam_tpu_torch.tune``.

Each test runs against its own cache files (``WAM_TORCH_SCHEDULE_CACHE``
and ``WAM_TPU_SCHEDULE_CACHE`` under tmp_path); the process caches and the
knobs of both packages are put back after each."""

import json
import os
import subprocess
import sys
from pathlib import Path

import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wam_tpu.tune.cache as jcache
import wam_tpu_torch.tune as ttune
import wam_tpu_torch.tune.cache as tcache
from wam_tpu.core import estimators as jest
from wam_tpu.evalsuite import fan as jfan
from wam_tpu.tune import autotuner as jauto
from wam_tpu.wavelets import transform as jt
from wam_tpu_torch import config as tconfig
from wam_tpu_torch.core import estimators as test_
from wam_tpu_torch.evalsuite import fan as tfan
from wam_tpu_torch.tune import autotuner as tauto
from wam_tpu_torch.tune import workloads as twl
from wam_tpu_torch.wavelets import transform as tt

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TO_PORT = {"pallas": "kernel", "tpu": "cuda"}
# the sweeps run many small ops: one intra-op thread keeps them from
# stalling on a machine whose cores other test workers share
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_name(s: str) -> str:
    for a, b in TO_PORT.items():
        s = s.replace(a, b)
    return s


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Both packages on their own user-cache files under tmp_path, the
    kill switch off, the knobs at "auto"; all put back after."""
    tpath, jpath = tmp_path / "port.json", tmp_path / "ref.json"
    monkeypatch.setenv("WAM_TORCH_SCHEDULE_CACHE", str(tpath))
    monkeypatch.setenv("WAM_TPU_SCHEDULE_CACHE", str(jpath))
    monkeypatch.delenv("WAM_TPU_NO_SCHEDULE_CACHE", raising=False)
    monkeypatch.delenv("WAM_TPU_FAN_DTYPE", raising=False)
    monkeypatch.delenv("WAM_TPU_MEL_BF16", raising=False)
    knobs = (jt.get_dwt2_impl(), jt.get_synth2_impl(), tt.get_dwt2_impl(), tt.get_synth2_impl())
    for mod in (jt, tt):
        mod.set_dwt2_impl("auto")
        mod.set_synth2_impl("auto")
    jcache.invalidate_process_cache()
    tcache.invalidate_process_cache()
    yield tpath, jpath
    jcache.invalidate_process_cache()
    tcache.invalidate_process_cache()
    jt.set_dwt2_impl(knobs[0])
    jt.set_synth2_impl(knobs[1])
    tt.set_dwt2_impl(knobs[2])
    tt.set_synth2_impl(knobs[3])


def _write(path, entries, version=1):
    path.write_text(json.dumps({"version": version, "schedules": entries}))


# -- the key and the files ------------------------------------------------------------


@pytest.mark.parametrize("args", [
    ("wam2d", (3, 224, 224), 32, "bf16", "pallas", "tpu"),
    ("eval2d", (65,), 65, "f32", "conv", "cpu"),
    ("serve", (), 2, "f32", "matmul", "cpu"),
    ("wamseq1d", (2048,), 2, "f32", "pallas", "tpu"),
])
def test_schedule_key_matches_the_reference(caches, args):
    want = jcache.schedule_key(*args)
    port_args = args[:4] + (TO_PORT.get(args[4], args[4]), TO_PORT.get(args[5], args[5]))
    assert tcache.schedule_key(*port_args) == _port_name(want)


def test_schedule_key_defaults_match_the_reference_on_the_cpu(caches):
    """With no impl or backend given, both resolve the impl a call takes
    with the knobs at "auto" on the CPU ("conv") and the CPU backend."""
    assert not torch.cuda.is_available()
    for args in ((("wam2d", (3, 16, 16), 2)), ("wam1d", (512,), 4, "bf16")):
        assert tcache.schedule_key(*args) == jcache.schedule_key(*args)
    tt.set_dwt2_impl("matmul")
    jt.set_dwt2_impl("matmul")
    assert tcache.schedule_key("wam2d", (8,), 1) == jcache.schedule_key("wam2d", (8,), 1)


def test_cache_files_read_the_same_in_both_packages(caches, tmp_path):
    """A user layer saved by either package is read by the other with the
    same entries; a stale version is ignored wholesale by both."""
    tpath, jpath = caches
    entries = {"wam2d|3x16x16|b2|f32|conv|cpu": {"sample_chunk": 2, "stream_noise": True},
               "eval2d|65|b65|f32|conv|cpu": {"sample_chunk": None, "fan_cap": 256}}
    tc = tcache.ScheduleCache(path=str(tpath), pinned=False)
    jc = jcache.ScheduleCache(path=str(jpath), pinned=False)
    for k, v in entries.items():
        tc.put(k, v)
        jc.put(k, v)
    tc.save()
    jc.save()
    assert json.loads(tpath.read_text()) == json.loads(jpath.read_text())
    for reader in (tcache.ScheduleCache, jcache.ScheduleCache):
        for path in (tpath, jpath):
            got = reader(path=str(path), pinned=False)
            assert got.entries == entries and got.stale_files == []
    stale = tmp_path / "stale.json"
    _write(stale, entries, version=0)
    for reader in (tcache.ScheduleCache, jcache.ScheduleCache):
        got = reader(path=str(stale), pinned=False)
        assert got.entries == {} and got.stale_files == [str(stale)]
    broken = tmp_path / "broken.json"
    broken.write_text("{not json")
    assert tcache.ScheduleCache(path=str(broken), pinned=False).entries == {}


def test_the_pinned_table_has_a_version_and_no_entries(caches):
    data = json.loads((ROOT / "wam_tpu_torch" / "tune" / "default_schedules.json").read_text())
    assert data["version"] == tcache.SCHEDULE_CACHE_VERSION == jcache.SCHEDULE_CACHE_VERSION
    assert data["schedules"] == {}
    assert tcache.ScheduleCache(path=os.devnull).entries == {}


def test_the_user_cache_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("WAM_TORCH_SCHEDULE_CACHE", raising=False)
    monkeypatch.delenv("WAM_TPU_SCHEDULE_CACHE", raising=False)
    assert tcache.default_cache_path().endswith(os.path.join(".cache", "wam_tpu_torch",
                                                             "schedules.json"))
    assert tcache.default_cache_path() != jcache.default_cache_path()


def test_entries_fingerprint_matches_the_reference():
    for entries in ({}, {"a|1|b1|f32|conv|cpu": {"sample_chunk": 4}},
                    {"x": {"fan_cap": 256, "fan_chunk": 2}, "y": {"bucket_cap": 16}}):
        for disabled in (False, True):
            assert (tcache.entries_fingerprint(entries, disabled=disabled)
                    == jcache.entries_fingerprint(entries, disabled=disabled))


# -- lookups and resolution on the same tables --------------------------------------

TABLE = {
    "wam2d|3x16x16|b2|f32|conv|cpu": {"sample_chunk": 2, "stream_noise": True,
                                      "synth_impl": "matmul", "anytime_stride": 3},
    "wam2d|3x16x16|b2|bf16|conv|cpu": {"sample_chunk": 8},
    "eval2d|65|b65|f32|conv|cpu": {"sample_chunk": None, "fan_cap": 256, "fan_chunk": 3,
                                   "fan_dtype": "bf16"},
    "eval2d|128|b128|f32|conv|cpu": {"fan_cap": 256, "mel_bf16": True},
    "serve|-|b2|f32|conv|cpu": {"bucket_cap": 16},
    "serve|3x8x8|b1|f32|conv|cpu": {"bucket_cap": 4},
}


def test_lookup_and_resolution_match_the_reference(caches):
    tpath, jpath = caches
    _write(tpath, TABLE)
    _write(jpath, TABLE)
    for key in TABLE:
        wl, shape, batch, dtype = key.split("|")[:4]
        shape = () if shape == "-" else tuple(int(d) for d in shape.split("x"))
        batch = int(batch[1:])
        assert tcache.lookup_schedule(wl, shape, batch, dtype) == jcache.lookup_schedule(
            wl, shape, batch, dtype) == TABLE[key]
    assert tcache.lookup_schedule("wam2d", (3, 16, 16), 4) is None
    for bs, fan in (("auto", 65), ("auto", 128), ("auto", 9), (32, 65)):
        assert tcache.resolve_fan_cap(bs, fan) == jcache.resolve_fan_cap(bs, fan)
        t, j = tfan.plan_fan(bs, fan), jfan.plan_fan(bs, fan)
        assert (t.cap, t.images_per_chunk, t.fan_chunk, t.fan_dtype) == (
            j.cap, j.images_per_chunk, j.fan_chunk, j.fan_dtype)
    for mb, shape, reps in (("auto", None, 2), ("auto", (3, 8, 8), 1), ("auto", None, 3),
                            (5, None, 2)):
        assert (tcache.resolve_bucket_cap(mb, shape, replicas=reps)
                == jcache.resolve_bucket_cap(mb, shape, replicas=reps))
    for wl, shape, batch in (("eval2d", (65,), 65), ("eval2d", (128,), 128), (None, None, None)):
        from wam_tpu.config import resolve_precision as jprec

        t, j = tconfig.resolve_precision(wl, shape, batch), jprec(wl, shape, batch)
        assert (t.fan_dtype, t.mel_bf16) == (j.fan_dtype, j.mel_bf16)
    for sbs, dtype in (("auto", "f32"), ("auto", "bf16"), (3, "f32"), (None, "f32")):
        kw = dict(workload="wam2d", shape=(3, 16, 16), dtype=dtype)
        assert (test_.resolve_sample_chunk(sbs, 25, batch=2, **kw)
                == jest.resolve_sample_chunk(sbs, 2, 25, **kw))
        assert (test_.resolve_sample_chunk(sbs, 4, batch=2, **kw)
                == jest.resolve_sample_chunk(sbs, 2, 4, **kw))
    for stride in ("auto", 2, 9):
        kw = dict(workload="wam2d", shape=(3, 16, 16), batch=2)
        assert (test_.resolve_checkpoint_stride(stride, 8, **kw)
                == jest.resolve_checkpoint_stride(stride, 8, **kw))
    assert tcache.apply_tuned_synth_impl("wam2d", (3, 16, 16), 2) == jcache.apply_tuned_synth_impl(
        "wam2d", (3, 16, 16), 2) == "matmul"
    assert tt.get_synth2_impl() == jt.get_synth2_impl() == "matmul"
    assert tcache.apply_tuned_synth_impl("wam2d", (3, 16, 16), 4) is None


def test_the_kill_switch_disables_every_lookup(caches, monkeypatch):
    tpath, jpath = caches
    _write(tpath, TABLE)
    before = ttune.schedule_fingerprint()
    monkeypatch.setenv("WAM_TPU_NO_SCHEDULE_CACHE", "1")
    assert tcache.lookup_schedule("serve", (), 2) is None
    assert tcache.resolve_bucket_cap("auto", replicas=2) == 8
    assert test_.resolve_sample_chunk("auto", 25, batch=2, workload="wam2d",
                                      shape=(3, 16, 16)) is None
    assert ttune.schedule_fingerprint() != before  # the switch is part of the identity


def test_schedule_fingerprint_follows_the_table(caches):
    """The serve result cache's schedule slot and the ledger rows' stamp are
    the loaded table's digest: a recorded entry moves it."""
    from wam_tpu_torch.serve.result_cache import result_cache_key

    fp = ttune.schedule_fingerprint()
    assert fp == tcache.entries_fingerprint({})
    key = result_cache_key(np.ones(4, np.float32), 1, "id")
    assert key.split("|")[3] == fp
    tcache.record_schedule("wam2d", (3, 16, 16), 2, {"sample_chunk": 2}, persist=False)
    assert ttune.schedule_fingerprint() != fp
    assert result_cache_key(np.ones(4, np.float32), 1, "id") != key


# -- every "auto" reader without a cache file, and with an entry -------------------


def _img_wam(**kw):
    from wam_tpu_torch import WaveletAttribution2D

    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.ReLU(),
                              torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(),
                              torch.nn.Linear(4, 5))
    return WaveletAttribution2D(net, wavelet="db2", J=2, n_samples=4, device="cpu", **kw)


def test_no_cache_file_leaves_every_auto_reader_as_before(caches):
    """With no cache file: the sample chunk is every sample (2D, 1D, 3D,
    video explainers), stream_noise "auto" materializes, the stride is 5,
    the fan cap 128 in float32, the bucket cap 8 (also through
    `FleetServer.from_config`), `SeqShardedWam`'s "auto" is fused with one
    sample a step, and the synthesis knob stays "auto"."""
    import wam_tpu_torch as wtt
    from wam_tpu_torch.config import ServeConfig
    from wam_tpu_torch.parallel import SeqShardedWam, make_mesh
    from wam_tpu_torch.serve import FleetServer

    tpath, _ = caches
    assert not tpath.exists()
    x = torch.zeros((2, 3, 16, 16))
    wam = _img_wam(stream_noise="auto")
    assert wam._chunk(x) is None and wam._stream(x) is False
    assert wam._synth(x) is None and tt.get_synth2_impl() == "auto"
    assert wtt.WaveletAttribution1D(lambda m: m.mean((2, 3)), device="cpu")._chunk(
        torch.zeros((2, 512))) is None
    assert wtt.WaveletAttribution3D(lambda v: v.mean((2, 3, 4)), device="cpu")._chunk(
        torch.zeros((2, 1, 8, 8, 8))) is None
    assert wtt.WaveletAttributionVideo(lambda v: v.mean((2, 3, 4)), device="cpu")._chunk(
        torch.zeros((2, 1, 4, 8, 8))) is None
    assert test_.resolve_checkpoint_stride("auto", 25, workload="wam2d", shape=(3, 16, 16),
                                           batch=2) == 5
    plan = tfan.plan_fan("auto", 65)
    assert (plan.cap, plan.images_per_chunk, plan.fan_chunk, plan.fan_dtype) == (
        128, 1, None, "f32")
    p = tconfig.resolve_precision("eval2d", (65,), 65)
    assert (p.fan_dtype, p.mel_bf16) == ("f32", False)
    assert tcache.resolve_bucket_cap("auto", replicas=2) == 8
    fleet = FleetServer.from_config(ServeConfig(device="cpu", fleet=2, max_batch="auto",
                                                oversize="fanout", buckets="4", warmup=False,
                                                health=False, result_cache_mb=0.0),
                                    lambda rid, m, dev: (lambda xs, ys: xs))
    try:
        assert fleet.max_batch == 8
    finally:
        fleet.close()
    sw = SeqShardedWam(make_mesh({"data": 2}, ["cpu"] * 2), lambda s: s.mean(-1, keepdim=True),
                       ndim=1, wavelet="haar", level=1, fused="auto")
    xs = torch.zeros((2, 64))
    assert sw._resolve_fused(xs) is True and sw._resolve_seq_chunk("auto", xs, 5) == 1


def test_each_auto_reader_reads_its_entry(caches):
    """With entries on the CPU backend: the explainers' chunk and stream,
    the tuned synthesis, the fan plan, the bucket cap (through
    `FleetServer.from_config` too) and the seq knobs."""
    import wam_tpu_torch as wtt
    from wam_tpu_torch.config import ServeConfig
    from wam_tpu_torch.parallel import SeqShardedWam, make_mesh
    from wam_tpu_torch.serve import FleetServer

    tpath, _ = caches
    _write(tpath, {**TABLE,
                   "wam1d|512|b2|f32|conv|cpu": {"sample_chunk": 3},
                   "wam3d|1x8x8x8|b2|f32|conv|cpu": {"sample_chunk": 2},
                   "wamvid3d|1x4x8x8|b2|f32|conv|cpu": {"sample_chunk": 5},
                   "wamseq1d|64|b2|f32|conv|cpu": {"sample_chunk": None, "seq_fused": False}})
    x = torch.zeros((2, 3, 16, 16))
    wam = _img_wam(stream_noise="auto", sample_batch_size="auto")
    assert wam._chunk(x) == 2 and wam._stream(x) is True
    assert wam._synth(x) == "matmul" and tt.get_synth2_impl() == "auto"
    assert wtt.WaveletAttribution1D(lambda m: m.mean((2, 3)), device="cpu")._chunk(
        torch.zeros((2, 512))) == 3
    assert wtt.WaveletAttribution3D(lambda v: v.mean((2, 3, 4)), device="cpu")._chunk(
        torch.zeros((2, 1, 8, 8, 8))) == 2
    assert wtt.WaveletAttributionVideo(lambda v: v.mean((2, 3, 4)), device="cpu")._chunk(
        torch.zeros((2, 1, 4, 8, 8))) == 5
    plan = tfan.plan_fan("auto", 65)
    assert (plan.cap, plan.images_per_chunk, plan.fan_chunk, plan.fan_dtype) == (256, 3, None,
                                                                                  "bf16")
    fleet = FleetServer.from_config(ServeConfig(device="cpu", fleet=2, max_batch="auto",
                                                oversize="fanout", buckets="4", warmup=False,
                                                health=False, result_cache_mb=0.0),
                                    lambda rid, m, dev: (lambda xs, ys: xs))
    try:
        assert fleet.max_batch == 16
    finally:
        fleet.close()
    sw = SeqShardedWam(make_mesh({"data": 2}, ["cpu"] * 2), lambda s: s.mean(-1, keepdim=True),
                       ndim=1, wavelet="haar", level=1, fused="auto")
    xs = torch.zeros((2, 64))
    assert sw._resolve_fused(xs) is False and sw._resolve_seq_chunk("auto", xs, 5) == 5


def test_the_resolved_chunk_gives_the_explicit_chunks_map(caches):
    """An explainer built like a recorded winner, with sample_batch_size
    "auto", resolves to the winner's chunk and computes the explicit-chunk
    call's map bit for bit."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 3, 16, 16))
                         .astype(np.float32))
    y = torch.tensor([1, 4])
    tcache.record_schedule("wam2d", (3, 16, 16), 2, {"sample_chunk": 3, "stream_noise": False},
                           dtype="bf16", persist=False)
    auto = _img_wam(sample_batch_size="auto", dwt_bf16=True)
    explicit = _img_wam(sample_batch_size=3, dwt_bf16=True)
    assert auto._chunk(x) == 3
    assert torch.equal(auto(x, y), explicit(x, y))


def test_a_tuned_synthesis_applies_to_its_own_call_only(caches, monkeypatch):
    """A tuned ``synth_impl`` runs the call whose key it matches (the 2D,
    3D and video explainers) and never writes the process knob: a second
    explainer with no entry keeps the knob's "auto" ("kernel" on the card,
    "conv" here). An explicit ``impl`` or ``synth_impl`` wins over the
    entry."""
    import wam_tpu_torch as wtt
    from wam_tpu_torch.wavelets import matmul as tmm

    tpath, _ = caches
    _write(tpath, {"wam2d|3x16x16|b2|f32|conv|cpu": {"synth_impl": "matmul"},
                   "wam3d|1x8x8x8|b2|f32|conv|cpu": {"synth_impl": "matmul"},
                   "wamvid3d|1x4x8x8|b2|f32|conv|cpu": {"synth_impl": "matmul"}})
    calls = [0]
    banded = tmm.synthesis2_mm

    def counted(*a, **kw):
        calls[0] += 1
        return banded(*a, **kw)

    monkeypatch.setattr(tmm, "synthesis2_mm", counted)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 3, 16, 16))
                         .astype(np.float32))
    y = torch.tensor([1, 4])
    first, second = _img_wam(), _img_wam()
    out = first(x, y)
    assert first._synth(x) == "matmul" and calls[0] > 0
    assert tt.get_synth2_impl() == "auto" and tt.resolved_synth2_impl("cuda") == "kernel"
    calls[0] = 0
    second(x[:1], y[:1])  # batch 1: no entry
    assert second._synth(x[:1]) is None and calls[0] == 0
    assert torch.equal(out, _img_wam(synth_impl="matmul")(x, y))
    assert _img_wam(impl="conv")._synth(x) == "conv"
    assert _img_wam(synth_impl="kernel")._synth(x) == "kernel"
    with pytest.raises(ValueError, match="synth_impl 'pallas' not one of"):
        _img_wam(synth_impl="pallas")
    vol = wtt.WaveletAttribution3D(lambda v: v.mean((2, 3, 4)), device="cpu")
    assert vol._synth(torch.zeros((2, 1, 8, 8, 8))) == "matmul"
    assert vol._synth(torch.zeros((1, 1, 8, 8, 8))) is None
    assert wtt.WaveletAttribution3D(lambda v: v.mean((2, 3, 4)), device="cpu",
                                    impl="conv")._synth(torch.zeros((2, 1, 8, 8, 8))) == "conv"
    clip = torch.zeros((2, 1, 4, 8, 8))
    vid = wtt.WaveletAttributionVideo(lambda v: v.mean((2, 3, 4)), device="cpu")
    assert vid._synth(clip) == "matmul" and vid._synth(clip[:1]) is None
    assert wtt.WaveletAttributionVideo(lambda v: v.mean((2, 3, 4)), device="cpu",
                                       synth_impl="conv")._synth(clip) == "conv"
    assert tt.get_synth2_impl() == "auto"


def test_auto_device_raises_without_a_card(caches, monkeypatch, tmp_path):
    """The tuner's entry points take the card for "auto" (and for no
    device) and raise when none is visible, as every other entry point of
    the port does: no sweep falls back to the CPU, and nothing is
    persisted. ``env_check`` reports FAIL."""
    from wam_tpu_torch import env_check
    from wam_tpu_torch.tune import __main__ as tmain
    from wam_tpu_torch.tune import online as tonline
    from wam_tpu_torch.tune import sweep as tsweep

    tpath, _ = caches
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ledger = tmp_path / "serve.jsonl"
    ledger.write_text("")
    for call in (lambda: tmain.main(["--workload", "toy"]),
                 lambda: tmain.main(["--workload", "toy", "--dry-run", "--device", "auto"]),
                 lambda: twl.get_workload("toy"),
                 lambda: tonline.main(["--ledger", str(ledger), "--once", "--device", "auto"]),
                 lambda: tsweep.main(["audio"])):
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            call()
    assert not tpath.exists()
    assert env_check.main([]) == 1


# -- the knobs ----------------------------------------------------------------------


def test_the_knobs_match_the_reference(caches):
    for mod in (jt, tt):
        assert (mod.get_dwt2_impl(), mod.get_synth2_impl()) == ("auto", "auto")
    assert tt.resolved_synth2_impl() == jt.resolved_synth2_impl() == "conv"
    for name in ("matmul", "conv"):
        tt.set_dwt2_impl(name)
        jt.set_dwt2_impl(name)
        assert tt.resolved_synth2_impl("cpu") == jt.resolved_synth2_impl()
    tt.set_dwt2_impl("kernel")
    jt.set_dwt2_impl("pallas")
    assert tt.resolved_synth2_impl("cpu") == jt.resolved_synth2_impl() == "matmul"
    tt.set_dwt2_impl("auto")
    assert tt.resolved_synth2_impl("cuda") == "kernel" and tt.resolved_dwt2_impl("cuda") == "kernel"
    for setter in ("set_dwt2_impl", "set_synth2_impl"):
        with pytest.raises(ValueError) as terr:
            getattr(tt, setter)("bogus")
        with pytest.raises(ValueError) as jerr:
            getattr(jt, setter)("bogus")
        assert str(terr.value) == _port_name(str(jerr.value)).replace(", 'pallas_interpret'", "")
    saved = jt._dwt1_impl
    for name in ("auto", "conv", "folded", "folded_nhc"):  # the reference's four names
        tt.set_dwt1_impl(name)
        jt.set_dwt1_impl(name)
        assert tt._dwt1_impl == jt._dwt1_impl == name
    jt.set_dwt1_impl(saved)
    with pytest.raises(ValueError) as terr:
        tt.set_dwt1_impl("pallas")
    with pytest.raises(ValueError) as jerr:
        jt.set_dwt1_impl("pallas")
    assert str(terr.value) == str(jerr.value)
    tt.set_dwt1_impl("auto")


def test_the_knobs_route_calls_that_pass_no_impl(caches):
    """A knob set to "matmul" (or "kernel", the plain versions on the CPU)
    is what a call with no ``impl=`` runs, and a per-call ``impl=`` still
    wins; back at "auto" the CPU runs "conv"."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 3, 40, 36))
                         .astype(np.float32))
    ref = {i: tt.wavedec2(x, "db4", 3, impl=i) for i in ("conv", "matmul", "kernel")}
    rec = {i: tt.waverec2(ref["conv"], "db4", impl=i) for i in ("conv", "matmul", "kernel")}

    def same(a, b):
        return all(torch.equal(p, q) for p, q in zip(_leaves(a), _leaves(b)))

    assert same(tt.wavedec2(x, "db4", 3), ref["conv"])
    for name in ("matmul", "kernel"):
        tt.set_dwt2_impl(name)
        assert same(tt.wavedec2(x, "db4", 3), ref[name])
        assert same(tt.wavedec2(x, "db4", 3, impl="conv"), ref["conv"])
        tt.set_synth2_impl(name)
        assert torch.equal(tt.waverec2(ref["conv"], "db4"), rec[name])
        assert torch.equal(tt.waverec2(ref["conv"], "db4", impl="conv"), rec["conv"])
    tt.set_dwt2_impl("matmul")
    tt.set_synth2_impl("auto")  # off the card: the analysis impl's pair
    assert torch.equal(tt.waverec2(ref["conv"], "db4"), rec["matmul"])


def _leaves(coeffs):
    out = []
    for c in coeffs:
        out.extend(c if isinstance(c, tuple) else [c])
    return out


# -- candidates and presets ---------------------------------------------------------


@pytest.mark.parametrize("batch,n,targets", [(32, 25, (128, 256, 512)), (4, 8, (8, 16)),
                                              (2, 8, (4, 8)), (8, 50, (128, 256, 512)),
                                              (1, 3, (128,))])
def test_chunk_candidates_match_the_reference(batch, n, targets):
    assert tauto.chunk_candidates(batch, n, targets) == jauto.chunk_candidates(batch, n, targets)


def test_candidate_labels_and_entries_match_the_reference():
    kws = [dict(), dict(sample_chunk=4, stream_noise=True),
           dict(sample_chunk=4, synth_impl="pallas", layout="nchw"),
           dict(fan_cap=256, fan_chunk=2, fan_dtype="bf16"),
           dict(sample_chunk=1, seq_fused=False, anytime_stride=4),
           dict(mel_bf16=True, dwt_impl="matmul", stream_noise=False)]
    for kw in kws:
        j = jauto.Candidate(**kw)
        t = tauto.Candidate(**{k: TO_PORT.get(v, v) if isinstance(v, str) else v
                               for k, v in kw.items()})
        assert t.label() == _port_name(j.label())
        assert json.dumps(t.entry(), sort_keys=True) == _port_name(
            json.dumps(j.entry(), sort_keys=True))


class _TinyFlax(nn.Module):
    """A stand-in for the reference presets' ResNet-50 (labels only)."""

    num_classes: int = 1000

    @nn.compact
    def __call__(self, x, train: bool = False):
        return nn.Dense(self.num_classes)(jnp.mean(x, axis=(1, 2)))


@pytest.mark.parametrize("name", ["toy", "flagship", "mu2d", "fan2d", "mel1d", "wamvit2d",
                                  "wamvid3d", "wamseq1d", "wamseq2d"])
def test_every_presets_candidates_match_the_reference(monkeypatch, name):
    """Labels, cache-key identity and items of each preset (the port's
    built on the CPU without a model; the reference's ResNet-50 presets on
    a stand-in model)."""
    import wam_tpu.models as jmodels
    from wam_tpu.tune import workloads as jwl

    monkeypatch.setattr(jmodels, "resnet50", lambda num_classes=1000: _TinyFlax(num_classes))
    j = jwl.get_workload(name)
    t = twl.get_workload(name, device="cpu")
    assert [c.label() for c in t.candidates] == [_port_name(c.label()) for c in j.candidates]
    assert (t.name, t.workload, tuple(t.shape), t.batch, t.items, t.dtype) == (
        j.name, j.workload, tuple(j.shape), j.batch, j.items, j.dtype)


def test_the_flagship_preset_is_the_benchmarks_call():
    wl = twl.get_workload("flagship", device="cpu")
    assert (wl.workload, wl.shape, wl.batch, wl.dtype) == ("wam2d", (3, 224, 224), 32, "bf16")
    labels = [c.label() for c in wl.candidates]
    assert labels[:4] == ["chunk=4 stream=on", "chunk=8 stream=on", "chunk=16 stream=on",
                          "chunk=full stream=on"]
    assert "chunk=4 stream=on nchw" in labels and "chunk=4 stream=on synth=kernel" in labels
    with pytest.raises(ValueError, match="unknown workload"):
        twl.get_workload("nope")
    with pytest.raises(ValueError, match="mix="):
        twl.get_workload("wamlive")


# -- the sweep ---------------------------------------------------------------------


def test_autotune_toy_persists_its_winner_and_the_dry_run_does_not(caches):
    tpath, _ = caches
    wl = twl.get_workload("toy", device="cpu")
    dry = tauto.autotune(wl, k=1, laps=1, persist=False)
    assert not tpath.exists() and dry["persisted"] is False
    assert len(dry["results"]) == len(wl.candidates) >= 2
    for r in dry["results"]:
        assert r["plane"] == "wall" and r["peak_gb"] is None and r["median_s"] > 0
        assert r["launches"] == {"dwt2": 0, "synth2": 0, "pair": 0, "relu_fwd": 0,
                                 "relu_bwd": 0}
        assert r["items_per_s"] == pytest.approx(wl.items / r["median_s"])
    assert tt.get_synth2_impl() == "auto"  # the synth probe does not outlive the sweep
    res = tauto.autotune(wl, k=1, laps=1, persist=True)
    assert res["key"] == "wam2d_toy|32x32|b4|f32|conv|cpu"
    saved = json.loads(tpath.read_text())
    assert saved["version"] == 1 and saved["schedules"][res["key"]]["source"] == "autotune:toy"
    assert tcache.lookup_schedule("wam2d_toy", (32, 32), 4) == res["entry"]


def test_the_toy_runners_give_the_same_mosaic_at_every_chunk(caches):
    """A runner bakes its chunk in; the mean does not depend on it (the
    draws are made once), so every materialized candidate agrees."""
    wl = twl.get_workload("toy", device="cpu")
    outs = []
    for cand in wl.candidates:
        if cand.stream_noise or cand.synth_impl:
            continue
        fn, args = wl.build(cand)
        outs.append(fn(*args))
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), rtol=0,
                                   atol=1e-6 * float(outs[0].abs().max()))


def test_the_cli_dry_run_prints_one_json_line(tmp_path):
    env = {**os.environ, **ONE_THREAD, "WAM_TORCH_SCHEDULE_CACHE": str(tmp_path / "s.json")}
    proc = subprocess.run([sys.executable, "-m", "wam_tpu_torch.tune", "--workload", "toy",
                           "--dry-run", "--device", "cpu", "--k", "1", "--laps", "1"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["persisted"] is False and out["winner"] and len(out["candidates"]) >= 2
    assert all(c["plane"] == "wall" for c in out["candidates"])
    assert not (tmp_path / "s.json").exists()


def test_every_preset_runs_at_a_small_geometry(caches):
    """Each preset's runners, built at a small geometry on the CPU, run one
    call for every candidate (ResNet-50 at 32²; the others as they are)."""
    small = {"flagship": dict(image=32, batch=2, n_samples=2),
             "mu2d": dict(image=32, n_images=2, grid_size=4, sample_size=6, subset_size=3),
             "fan2d": dict(image=32, n_images=2, n_iter=4), "mel1d": dict(n=4096, batch=2),
             "wamvit2d": {}, "wamvid3d": {}, "wamseq1d": {}, "wamseq2d": {}}
    for name, kw in small.items():
        wl = twl.get_workload(name, device="cpu", **kw)
        for cand in wl.candidates:
            fn, args = wl.build(cand)
            out = fn(*args)
            leaves = out if isinstance(out, list) else [out]
            assert all(bool(torch.isfinite(t).all()) for t in _leaves(leaves)), (name, cand)
    assert tt.get_synth2_impl() in ("auto", "matmul", "kernel")
