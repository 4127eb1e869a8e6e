"""The compile-artifact registry (`wam_tpu_torch.registry`), the reference's
`tests/test_registry.py` on the port: publish -> hydrate round trips, the
silent-miss ladder (torn manifest, stale schema, foreign platform,
per-artifact digest), the `WAM_TPU_NO_REGISTRY` kill switch, the schedule
snapshot merged under local entries, the CLI's exit codes, the kernel
libraries hydrated only under this checkout's names, and the serve stack's
wiring: a cold-cache server, a supervised fleet restart and a paged
`ModelSpec` warming from a bundle at zero compiles; the manifest's and the
report row's keys against the reference's.

Every test isolates the caches (`WAM_TPU_AOT_CACHE`, `WAM_TPU_CACHE_DIR`,
`WAM_TORCH_SCHEDULE_CACHE`, `TORCHINDUCTOR_CACHE_DIR`) so nothing touches
~/.cache; a "fresh host" is also a Dynamo reset and an empty Inductor
directory."""

import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch
import torch._inductor.config

from wam_tpu.registry import bundle as jbundle
from wam_tpu_torch import kernels, obs
from wam_tpu_torch.obs import sentinel
from wam_tpu_torch.pipeline import aot as aot_cache
from wam_tpu_torch.registry import (
    REGISTRY_SCHEMA_VERSION,
    RegistryClient,
    load_manifest,
    publish_bundle,
    resolve_client,
)
from wam_tpu_torch.registry import __main__ as registry_cli
from wam_tpu_torch.tune.cache import SCHEDULE_CACHE_VERSION, ScheduleCache

T = 60  # seconds a future is waited on


@pytest.fixture
def host(tmp_path, monkeypatch):
    """Isolated caches; ``host.fresh()`` is a new host's empty compile cache."""
    n = [0]

    def fresh():
        n[0] += 1
        d = tmp_path / f"inductor{n[0]}"
        monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", str(d))
        monkeypatch.setenv("TRITON_CACHE_DIR", str(d / "triton"))
        torch._dynamo.reset()

    monkeypatch.setenv("WAM_TPU_AOT_CACHE", str(tmp_path / "aot"))
    monkeypatch.setenv("WAM_TPU_CACHE_DIR", str(tmp_path / "compile"))
    monkeypatch.setenv("WAM_TORCH_SCHEDULE_CACHE", str(tmp_path / "s.json"))
    # one compile process: the suite's workers share the machine
    monkeypatch.setattr(torch._inductor.config, "compile_threads", 1)
    for name in ("WAM_TPU_NO_AOT_CACHE", "WAM_TPU_NO_REGISTRY"):
        monkeypatch.delenv(name, raising=False)
    fresh()
    yield type("Host", (), {"fresh": staticmethod(fresh)})
    torch._dynamo.reset()


def _seed_aot(key, cache_dir):
    """Compile and export one real program under ``key`` (the publisher)."""
    fn = aot_cache.cached_jit(lambda x: x * 2.0 + 1.0, None, key, cache_dir=str(cache_dir))
    fn(torch.arange(4.0))
    payload, header = aot_cache.read_aot_payload(key, str(cache_dir))
    assert payload is not None and header["origin"] == "exported"
    return payload


def _aot_seq0():
    rows = sentinel.aot_events()
    return rows[-1]["seq"] if rows else 0


def _edit_manifest(bundle, mutate):
    path = os.path.join(str(bundle), "manifest.json")
    with open(path) as f:
        doc = json.load(f)
    mutate(doc)
    with open(path, "w") as f:
        json.dump(doc, f)


# -- publish -> hydrate round trip -----------------------------------------------------


def test_publish_hydrate_roundtrip(tmp_path, host):
    """A bundle published from one host's caches seeds another's: the
    compiled step lands byte-identical under origin "registry", a compile
    file copies in by name, and a later consult runs the program with ZERO
    compiles, attributed as a registry_hit. The manifest and the report
    row have the reference's keys."""
    pub, tgt = tmp_path / "pub", tmp_path / "tgt"
    payload = _seed_aot("rt-key", pub)
    comp_pub, comp_tgt = tmp_path / "comp_pub", tmp_path / "comp_tgt"
    os.makedirs(comp_pub / "fxgraph")
    (comp_pub / "fxgraph" / "mod.bin").write_bytes(b"fake-inductor-entry")

    lean = publish_bundle(str(tmp_path / "lean"), aot_dir=str(pub), compile_dir=str(comp_pub),
                          library_dir=str(tmp_path / "no-libs"),
                          schedule_path=str(tmp_path / "none.json"), backend="cpu")
    assert [a["kind"] for a in lean["artifacts"]] == ["aot"]  # the tree only on request
    manifest = publish_bundle(str(tmp_path / "bundle"), aot_dir=str(pub),
                              compile_dir=str(comp_pub), library_dir=str(tmp_path / "no-libs"),
                              include_compile_tree=True,
                              schedule_path=str(tmp_path / "none.json"), backend="cpu")
    assert sorted(a["kind"] for a in manifest["artifacts"]) == ["aot", "compile"]
    assert all(len(a["sha256"]) == 64 for a in manifest["artifacts"])
    ref = jbundle.publish_bundle(str(tmp_path / "jbundle"), aot_dir=str(tmp_path / "none"),
                                 include_xla=False, schedule_path=str(tmp_path / "none.json"))
    assert sorted(manifest) == sorted(ref)

    host.fresh()
    report = RegistryClient(str(tmp_path / "bundle")).hydrate(
        aot_dir=str(tgt), schedule_path=str(tmp_path / "sched.json"),
        compile_dir=str(comp_tgt))
    assert report.status == "hydrated"
    assert report.count("aot", "hydrated") == 1 and report.count("compile", "hydrated") == 1
    assert report.hydrated == 2
    got, header = aot_cache.read_aot_payload("rt-key", str(tgt))
    assert got == payload and header["origin"] == "registry"
    assert (comp_tgt / "fxgraph" / "mod.bin").read_bytes() == b"fake-inductor-entry"

    seq0 = _aot_seq0()
    with sentinel.assert_no_retrace():
        fn = aot_cache.cached_jit(lambda x: x * 2.0 + 1.0, None, "rt-key", cache_dir=str(tgt))
        out = fn(torch.arange(4.0)).numpy()
    np.testing.assert_allclose(out, np.arange(4) * 2.0 + 1.0)
    assert fn.compiles == 0
    events = [(e["aot_event"], e["key"]) for e in sentinel.aot_events(since_seq=seq0)]
    assert ("registry_hit", "rt-key") in events

    row = report.row()  # the serve close path writes exactly this dict
    assert row["metric"] == "registry_hydration" and row["schema_version"] == 2
    assert row["hydrated"] == 2
    assert sorted(row) == ["artifacts", "bundle", "duration_s", "hydrated", "metric",
                           "schedules_added", "schedules_status", "schema_version", "status",
                           "t"]


def test_hydrate_is_idempotent_local_wins(tmp_path, host):
    """Re-hydrating over a warm cache rewrites nothing: valid local entries
    count as "present" (a supervisor rebuild hydrates every time)."""
    pub = tmp_path / "pub"
    _seed_aot("idem-key", pub)
    bundle = str(tmp_path / "bundle")
    publish_bundle(bundle, aot_dir=str(pub), include_compile=False, backend="cpu")
    tgt = tmp_path / "tgt"
    kw = dict(aot_dir=str(tgt), schedule_path=str(tmp_path / "s.json"))
    assert RegistryClient(bundle).hydrate(**kw).count("aot", "hydrated") == 1
    entry_path = aot_cache.aot_entry_path("idem-key", str(tgt))
    mtime = os.path.getmtime(entry_path)
    again = RegistryClient(bundle).hydrate(**kw)
    assert again.count("aot", "present") == 1 and again.count("aot", "hydrated") == 0
    assert os.path.getmtime(entry_path) == mtime


# -- the silent-miss ladder ----------------------------------------------------------


def test_corrupt_artifact_is_per_artifact_miss(tmp_path, host):
    """One flipped payload loses ONE artifact (digest_mismatch and a
    registry_miss event); the rest of the bundle still hydrates."""
    pub = tmp_path / "pub"
    _seed_aot("good-key", pub)
    _seed_aot("bad-key", pub)
    bundle = str(tmp_path / "bundle")
    manifest = publish_bundle(bundle, aot_dir=str(pub), include_compile=False, backend="cpu")
    bad = next(a for a in manifest["artifacts"] if a["key"] == "bad-key")
    with open(os.path.join(bundle, bad["file"]), "wb") as f:
        f.write(b"bitrot")
    seq0 = _aot_seq0()
    report = RegistryClient(bundle).hydrate(aot_dir=str(tmp_path / "tgt"),
                                            schedule_path=str(tmp_path / "s.json"))
    assert report.status == "hydrated"  # a partial hydration is still a win
    assert report.count("aot", "hydrated") == 1 and report.count("aot", "digest_mismatch") == 1
    events = [(e["aot_event"], e["key"]) for e in sentinel.aot_events(since_seq=seq0)]
    assert ("registry_miss", "bad-key") in events
    assert aot_cache.read_aot_payload("bad-key", str(tmp_path / "tgt"))[0] is None


def test_manifest_digest_tamper_rejected(tmp_path, host):
    pub = tmp_path / "pub"
    _seed_aot("tamper-key", pub)
    bundle = str(tmp_path / "bundle")
    publish_bundle(bundle, aot_dir=str(pub), include_compile=False, backend="cpu")
    _edit_manifest(bundle, lambda d: d["artifacts"][0].update(sha256="0" * 64))
    report = RegistryClient(bundle).hydrate(aot_dir=str(tmp_path / "tgt"),
                                            schedule_path=str(tmp_path / "s.json"))
    assert report.count("aot", "digest_mismatch") == 1 and report.hydrated == 0


def test_torn_manifest_is_empty_bundle(tmp_path, host):
    bundle = tmp_path / "bundle"
    os.makedirs(bundle)
    (bundle / "manifest.json").write_text('{"registry_schema_version": 1, "art')
    tgt = tmp_path / "tgt"
    report = RegistryClient(str(bundle)).hydrate(aot_dir=str(tgt),
                                                 schedule_path=str(tmp_path / "s.json"))
    assert report.status == "no_manifest" and report.hydrated == 0
    assert not os.path.exists(tgt)  # zero writes
    gone = RegistryClient(str(tmp_path / "never-published")).hydrate(
        aot_dir=str(tgt), schedule_path=str(tmp_path / "s.json"))
    assert gone.status == "no_manifest"


@pytest.mark.parametrize("status,mutate", [
    ("stale_schema", lambda d: d.update(registry_schema_version=REGISTRY_SCHEMA_VERSION + 1)),
    ("platform_mismatch", lambda d: d["platform"].update(backend="cuda")),
    ("platform_mismatch", lambda d: d["platform"].update(torch="0.0.0")),
    ("platform_mismatch", lambda d: d["platform"].update(device="another card")),
    ("version_mismatch", lambda d: d["platform"].update(aot_cache_version=999)),
], ids=["schema", "backend", "torch", "device", "aot-version"])
def test_stale_schema_and_foreign_platform_skip_wholesale(tmp_path, host, status, mutate):
    """A manifest of another registry schema, another platform (backend,
    torch, CUDA, Triton, device, capability) or another compiled-step
    schema is ignored WHOLESALE, and `probe` stamps the cause on every
    row."""
    pub = tmp_path / "pub"
    _seed_aot("whole-key", pub)
    bundle = str(tmp_path / "bundle")
    publish_bundle(bundle, aot_dir=str(pub), include_compile=False, backend="cpu")
    _edit_manifest(bundle, mutate)
    tgt = tmp_path / "tgt"
    report = RegistryClient(bundle).hydrate(aot_dir=str(tgt),
                                            schedule_path=str(tmp_path / "s.json"))
    assert report.status == status and not os.path.exists(tgt)
    probe = RegistryClient(bundle).probe(aot_dir=str(tgt))
    assert probe["status"] == status and probe["hydratable"] == 0
    assert [r["outcome"] for r in probe["artifacts"]] == [status]


def test_kill_switch_disables_hydrate_not_probe(tmp_path, host, monkeypatch):
    pub = tmp_path / "pub"
    _seed_aot("kill-key", pub)
    bundle = str(tmp_path / "bundle")
    publish_bundle(bundle, aot_dir=str(pub), include_compile=False, backend="cpu")
    monkeypatch.setenv("WAM_TPU_NO_REGISTRY", "1")
    tgt = tmp_path / "tgt"
    report = RegistryClient(bundle).hydrate(aot_dir=str(tgt),
                                            schedule_path=str(tmp_path / "s.json"))
    assert report.status == "disabled" and not os.path.exists(tgt)
    assert RegistryClient(bundle).probe(aot_dir=str(tgt))["hydratable"] == 1
    monkeypatch.setenv("WAM_TPU_NO_REGISTRY", "0")  # "0" means enabled
    assert RegistryClient(bundle).hydrate(
        aot_dir=str(tgt), schedule_path=str(tmp_path / "s.json")).status == "hydrated"


def test_resolve_client_normalizes_the_serve_param(tmp_path):
    assert resolve_client(None) is None and resolve_client("") is None
    client = RegistryClient(str(tmp_path))
    assert resolve_client(client) is client
    made = resolve_client(str(tmp_path / "b"))
    assert isinstance(made, RegistryClient) and made.bundle == str(tmp_path / "b")


def test_kernel_libraries_hydrate_only_under_this_checkouts_names(tmp_path, host):
    """The built kernel libraries travel as compile artifacts; one whose name
    is not what this checkout's sources hash to is never written ("stale"),
    and a present one is left alone."""
    libs = tmp_path / "libs"
    os.makedirs(libs)
    names = sorted({k.library_path().name for k in kernels.KERNELS.values()})
    for name in names:
        (libs / name).write_bytes(b"device code of " + name.encode())
    (libs / "libdwt2-0000000000000000.so").write_bytes(b"another source's")
    bundle = str(tmp_path / "bundle")
    manifest = publish_bundle(bundle, aot_dir=str(tmp_path / "none"),
                              compile_dir=str(tmp_path / "no-compile"), library_dir=str(libs),
                              include_schedules=False, backend="cpu")
    assert sorted(a["key"] for a in manifest["artifacts"]) == sorted(
        [f"kernels/{n}" for n in names] + ["kernels/libdwt2-0000000000000000.so"])
    tgt = tmp_path / "tgt-libs"
    probe = RegistryClient(bundle).probe(library_dir=str(tgt))
    assert {r["key"]: r["outcome"] for r in probe["artifacts"]}[
        "kernels/libdwt2-0000000000000000.so"] == "stale"
    report = RegistryClient(bundle).hydrate(library_dir=str(tgt),
                                            schedule_path=str(tmp_path / "s.json"))
    assert report.count("compile", "hydrated") == len(names)
    assert report.count("compile", "stale") == 1
    assert sorted(os.listdir(tgt)) == names
    again = RegistryClient(bundle).hydrate(library_dir=str(tgt),
                                           schedule_path=str(tmp_path / "s.json"))
    assert again.count("compile", "present") == len(names)


# -- schedule snapshot ------------------------------------------------------------


def test_schedule_snapshot_merges_under_local(tmp_path, host):
    pub_sched = tmp_path / "pub.json"
    cache = ScheduleCache(path=str(pub_sched))
    cache.put("wamtest|published|only", {"sample_chunk": 64})
    cache.put("wamtest|shared|key", {"sample_chunk": 999})
    cache.save()
    bundle = str(tmp_path / "bundle")
    publish_bundle(bundle, aot_dir=str(tmp_path / "no-aot"), schedule_path=str(pub_sched),
                   include_compile=False, backend="cpu")
    local_sched = tmp_path / "local.json"
    local = ScheduleCache(path=str(local_sched))
    local.put("wamtest|shared|key", {"sample_chunk": 8})  # tuned on this host
    local.save()
    report = RegistryClient(bundle).hydrate(aot_dir=str(tmp_path / "tgt"),
                                            schedule_path=str(local_sched))
    assert report.schedules_status == "merged" and report.schedules_added == 1
    merged = ScheduleCache(path=str(local_sched))
    assert merged.get("wamtest|shared|key") == {"sample_chunk": 8}
    assert merged.get("wamtest|published|only") == {"sample_chunk": 64}
    _edit_manifest(bundle, lambda d: d["schedules"].update(version=SCHEDULE_CACHE_VERSION + 1))
    again = RegistryClient(bundle).hydrate(aot_dir=str(tmp_path / "tgt2"),
                                           schedule_path=str(local_sched))
    assert again.schedules_status == "stale" and again.schedules_added == 0


# -- CLI -----------------------------------------------------------------------------


def test_cli_publish_inspect_hydrate_exit_codes(tmp_path, host, capsys):
    pub = tmp_path / "pub"
    _seed_aot("cli-key", pub)
    bundle = str(tmp_path / "bundle")
    assert registry_cli.main(["--device", "cpu", "publish", "--out", bundle, "--aot-dir",
                              str(pub), "--no-compile",
                              "--schedule-cache", str(tmp_path / "s.json")]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["aot"] == 1 and doc["platform"]["backend"] == "cpu"
    assert registry_cli.main(["publish", "--out", str(tmp_path / "empty"), "--aot-dir",
                              str(tmp_path / "no-cache"), "--no-compile",
                              "--no-schedules"]) == 1  # nothing to publish
    capsys.readouterr()
    tgt = tmp_path / "tgt"
    assert registry_cli.main(["inspect", bundle, "--aot-dir", str(tgt)]) == 0
    assert json.loads(capsys.readouterr().out)["hydratable"] == 1
    assert registry_cli.main(["inspect", str(tmp_path / "nowhere"), "--aot-dir",
                              str(tgt)]) == 1
    capsys.readouterr()
    assert registry_cli.main(["hydrate", bundle, "--aot-dir", str(tgt), "--schedule-cache",
                              str(tmp_path / "s2.json"), "--compile-dir",
                              str(tmp_path / "comp")]) == 0
    row = json.loads(capsys.readouterr().out)
    assert row["metric"] == "registry_hydration" and row["hydrated"] == 1
    assert aot_cache.read_aot_payload("cli-key", str(tgt))[0] is not None


def test_cli_from_prewarm_filters_keys(tmp_path, host, capsys):
    pub = tmp_path / "pub"
    _seed_aot("warmed-key", pub)
    _seed_aot("other-key", pub)
    warm = tmp_path / "warm.json"
    warm.write_text(json.dumps({"config": "toy", "warmed": {
        "bucket_keys": ["wam2d|toy"], "aot_keys": ["warmed-key"],
        "schedule_version": SCHEDULE_CACHE_VERSION}}))
    legacy = tmp_path / "legacy.json"
    legacy.write_text(json.dumps({"config": "toy", "aot": "exported"}))
    keys, sources = registry_cli._prewarm_keys([str(warm), str(legacy)])
    assert keys == ["warmed-key"]
    assert len(sources) == 1 and sources[0]["bucket_keys"] == ["wam2d|toy"]
    assert registry_cli._prewarm_keys([str(legacy)]) == (None, [])
    bundle = str(tmp_path / "bundle")
    assert registry_cli.main(["--device", "cpu", "publish", "--out", bundle, "--aot-dir",
                              str(pub), "--no-compile", "--no-schedules", "--from-prewarm",
                              str(warm), str(legacy)]) == 0
    capsys.readouterr()
    manifest = load_manifest(bundle)
    assert [a["key"] for a in manifest["artifacts"]] == ["warmed-key"]
    assert manifest["source"]["prewarm"][0]["prewarm_manifest"] == str(warm)


# -- serve wiring ---------------------------------------------------------------------


def _toy_wam2d():
    from wam_tpu_torch.models.toy import toy_conv_model
    from wam_tpu_torch.wam2d import BaseWAM2D

    toy = toy_conv_model(device="cpu")
    return BaseWAM2D(lambda x: toy(x.mean(dim=1)), wavelet="db2", J=2, device="cpu")


def test_server_cold_cache_warms_from_bundle(tmp_path, host, monkeypatch):
    """A server whose caches are EMPTY but which is handed ``registry=``
    warms and serves with zero compiles, equal to the publisher, and its
    close path writes the ``registry_hydration`` ledger row; a server
    pointed at no bundle compiles as without one. A paged `ModelSpec` with
    the bundle pages in at zero compiles too."""
    from wam_tpu_torch.serve import AttributionServer, ModelSpec

    pub = tmp_path / "pub-aot"
    monkeypatch.setenv("WAM_TPU_AOT_CACHE", str(pub))
    wam = _toy_wam2d()
    x = np.random.default_rng(1).standard_normal((1, 16, 16)).astype(np.float32)
    ref = wam.serve_entry()(torch.from_numpy(np.stack([x, x])), torch.tensor([2, 2])).numpy()[0]

    cold = []
    server = AttributionServer(wam.serve_entry(on_trace=lambda: cold.append(1),
                                               aot_key="reg-serve"),
                               [(1, 16, 16)], max_batch=2, device="cpu")
    server.close()
    assert cold == [1]  # the publisher's warmup compiled and exported
    bundle = str(tmp_path / "bundle")
    publish_bundle(bundle, aot_dir=str(pub), include_compile=False, backend="cpu",
                   schedule_path=str(tmp_path / "s.json"))

    host.fresh()
    monkeypatch.setenv("WAM_TPU_AOT_CACHE", str(tmp_path / "cold-aot"))
    warm = []
    ledger = str(tmp_path / "serve.jsonl")
    server = AttributionServer(wam.serve_entry(on_trace=lambda: warm.append(1),
                                               aot_key="reg-serve"),
                               [(1, 16, 16)], max_batch=2, device="cpu", metrics_path=ledger,
                               registry=bundle)
    try:
        assert server.registry_report.status == "hydrated"
        assert server.registry_report.hydrated >= 1
        assert server.describe()["registry"] == bundle
        got = server.submit(x, 2).result(timeout=T)
    finally:
        server.close()
    assert warm == []  # the bundle, not a compile, paid the warmup
    np.testing.assert_allclose(got, ref, atol=1e-6 * np.abs(ref).max())
    rows = [json.loads(line) for line in open(ledger)]
    hyd = [r for r in rows if r.get("metric") == "registry_hydration"]
    assert len(hyd) == 1 and hyd[0]["status"] == "hydrated" and hyd[0]["schema_version"] == 2

    host.fresh()
    monkeypatch.setenv("WAM_TPU_AOT_CACHE", str(tmp_path / "paged-aot"))
    paged = []
    spec = ModelSpec("toy", lambda: wam.serve_entry(on_trace=lambda: paged.append(1),
                                                    aot_key="reg-serve"),
                     registry=bundle)
    server = AttributionServer(lambda xs, ys: xs[:, 0], [(1, 16, 16)], max_batch=2,
                               device="cpu", models=[spec])
    try:
        got = server.submit(x, 2, model="toy").result(timeout=T)
    finally:
        server.close()
    assert paged == []  # paged in from the bundle at zero compiles
    np.testing.assert_allclose(got, ref, atol=1e-6 * np.abs(ref).max())

    monkeypatch.setenv("WAM_TPU_AOT_CACHE", str(tmp_path / "cold2-aot"))
    host.fresh()
    fb = []
    server = AttributionServer(wam.serve_entry(on_trace=lambda: fb.append(1),
                                               aot_key="reg-serve"),
                               [(1, 16, 16)], max_batch=2, device="cpu",
                               registry=str(tmp_path / "not-a-bundle"))
    server.close()
    assert server.registry_report.status == "no_manifest"
    assert fb == [1]  # compiled, as if no bundle had been offered


def test_fleet_restart_rehydrates_from_bundle(tmp_path, host, monkeypatch):
    """A fleet started with ``registry=`` warms from the bundle at zero
    compiles, and when a replica dies AND the local compiled-step cache has
    been wiped under it, the rebuild's re-hydration re-seeds the cache so
    the restarted replica rejoins at zero compiles (`assert_no_retrace`)."""
    from wam_tpu_torch.serve import FleetServer, SupervisorConfig, jit_entry

    obs.configure(enabled=True)
    obs.reset()
    aot_dir = tmp_path / "aot"
    kills = {rid: threading.Event() for rid in range(2)}

    def factory(rid, m, device):
        # a fresh entry every (re)build: a warm rejoin can only come from the
        # compiled-step cache, which after the rmtree only the bundle refills
        inner = jit_entry(lambda xs, ys: xs * 2.0, on_trace=m.note_compile, aot_key="reg-fleet")

        def entry(xs, ys):
            if kills[rid].is_set():
                kills[rid].clear()  # one death an arm
                raise RuntimeError(f"injected device loss on {rid}")
            return inner(xs, ys)

        return entry

    seed = FleetServer(factory, [(4,)], replicas=2, devices=["cpu"] * 2, max_batch=1,
                       max_wait_ms=0.0, warmup=True, oversize="fanout")
    seed.close()
    bundle = str(tmp_path / "bundle")
    publish_bundle(bundle, aot_dir=str(aot_dir), include_compile=False, backend="cpu",
                   schedule_path=str(tmp_path / "s.json"))
    shutil.rmtree(aot_dir)  # the fresh host: cold local caches
    host.fresh()

    sentinel.clear_events()
    x = np.ones((4,), np.float32)
    with sentinel.assert_no_retrace():
        fleet = FleetServer(factory, [(4,)], replicas=2, devices=["cpu"] * 2, max_batch=1,
                            max_wait_ms=0.0, warmup=True, oversize="fanout", registry=bundle,
                            supervise=SupervisorConfig(max_restarts=8, window_s=60.0,
                                                       backoff_base_s=0.001, jitter_frac=0.0,
                                                       seed=0))
        try:
            first_report = fleet.registry_report
            assert first_report.status == "hydrated"
            assert fleet.describe()["registry"] == bundle
            shutil.rmtree(aot_dir)  # the rebuild must re-hydrate from the bundle
            kills[0].set()
            deadline = time.monotonic() + 30
            while kills[0].is_set():
                for f in [fleet.submit(x, i % 2) for i in range(4)]:
                    np.testing.assert_array_equal(f.result(timeout=T), x * 2.0)
                assert time.monotonic() < deadline, "the kill never reached replica 0"
            while fleet.registry_report is first_report:
                assert time.monotonic() < deadline, "the rebuild never re-hydrated"
                time.sleep(0.01)
            for f in [fleet.submit(x, i % 2) for i in range(4)]:
                np.testing.assert_array_equal(f.result(timeout=T), x * 2.0)
        finally:
            fleet.close()
    assert fleet.registry_report.count("aot", "hydrated") >= 1
    events = [e["aot_event"] for e in sentinel.aot_events()]
    assert "registry_hit" in events and "miss" not in events and "export" not in events
