"""Pod workers warming from a compile-artifact bundle (`wam_tpu_torch.pod`
with `wam_tpu_torch.registry`), the reference's
`tests/test_pod.py::test_registry_hydrated_respawn_zero_compiles` and
`tests/test_transport.py::test_cold_worker_joins_compile_free_from_wire_bundle`
on the port: one seed worker compiles the toy entry's step under throwaway
caches (the file's one compile), its bundle is published once, and

- a worker started with ``--registry BUNDLE`` on empty caches is ready at
  ``compile_count == 0``, and so is the supervisor's respawn after a
  SIGKILL;
- a worker started with ``--registry wire`` over tcp, with no bundle path
  and empty caches, hydrates from the bytes the router streams and is
  ready at ``compile_count == 0``.

Each worker gets caches of its own (`WAM_TPU_AOT_CACHE`,
`WAM_TORCH_SCHEDULE_CACHE`, `WAM_TPU_CACHE_DIR`, `TORCHINDUCTOR_CACHE_DIR`),
so a hit can only come from the bundle. A cold worker's Inductor directory
starts with the seed's built C++ kernels (its ``.cpp``/``.so`` files) and
none of its graph caches (``fxgraph``, ``aotautograd``): on the CPU the
kernels' g++ builds are most of a start, and `compile_count` counts the
graph caches' misses only (`pipeline.aot`), which the bundle alone can
turn into hits."""

import shutil
import sys
import time

import numpy as np
import pytest
import torch

from wam_tpu_torch.pod import PodRouter
from wam_tpu_torch.registry import publish_bundle
from wam_tpu_torch.serve import SupervisorConfig

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

KEY_BASE = "test_torch_pod|toy2d|J2|n2|mb8"
TOY_ARGV = [sys.executable, "-m", "wam_tpu_torch.pod.worker", "--device", "cpu",
            "--buckets", "1x16x16", "--n-samples", "2", "--aot-key-base", KEY_BASE]


def _caches(root, cpp_from=None) -> dict:
    if cpp_from is not None:
        shutil.copytree(cpp_from / "inductor", root / "inductor",
                        ignore=shutil.ignore_patterns("fxgraph", "aotautograd", "locks"))
    return {
        "WAM_TPU_AOT_CACHE": str(root / "aot"),
        "WAM_TORCH_SCHEDULE_CACHE": str(root / "schedules.json"),
        "WAM_TPU_CACHE_DIR": str(root / "compile"),
        "TORCHINDUCTOR_CACHE_DIR": str(root / "inductor"),
        "TRITON_CACHE_DIR": str(root / "inductor" / "triton"),
        "TORCHINDUCTOR_COMPILE_THREADS": "1",  # the suite's workers share the machine
        "OMP_NUM_THREADS": "1",
    }


def _x():
    return np.random.default_rng(3).standard_normal((1, 16, 16)).astype(np.float32)


def _poll(pred, timeout_s):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A seed worker's compiled step, published as a bundle; with the seed's
    answer to `_x()`."""
    root = tmp_path_factory.mktemp("pod-seed")
    # the seed's kernels build in parallel (g++ is most of its start)
    router = PodRouter(TOY_ARGV, "1x16x16", workers=1,
                       env={**_caches(root / "seed"), "TORCHINDUCTOR_COMPILE_THREADS": "4"},
                       ready_timeout_s=300.0)
    try:
        ready = [r for r in router.metrics.worker_rows if r["phase"] == "ready"]
        assert ready[0]["compile_count"] == 1  # the seed compiled its one step
        answer = router.attribute(_x(), 1)
    finally:
        router.close()
    manifest = publish_bundle(str(root / "bundle"), aot_dir=str(root / "seed" / "aot"),
                              schedule_path=str(root / "seed" / "schedules.json"),
                              include_compile=False, backend="cpu",
                              source={"test": "test_torch_pod_registry seed worker"})
    assert sum(1 for a in manifest["artifacts"] if a["kind"] == "aot") >= 1
    return root, str(root / "bundle"), answer


def _ready_rows(router, incarnation):
    return [r for r in router.metrics.worker_rows
            if r["phase"] == "ready" and r["incarnation"] == incarnation]


def test_registry_hydrated_respawn_zero_compiles(bundle):
    root, path, answer = bundle
    router = PodRouter(TOY_ARGV + ["--registry", path], "1x16x16", workers=1,
                       env=_caches(root / "cold", cpp_from=root / "seed"),
                       ready_timeout_s=300.0,
                       supervise=SupervisorConfig(seed=0, backoff_base_s=0.01))
    try:
        first = _ready_rows(router, 0)
        assert first and first[0]["compile_count"] == 0  # even the first spawn hydrates
        np.testing.assert_array_equal(router.attribute(_x(), 1), answer)
        assert router.kill_worker(0)
        assert _poll(lambda: bool(_ready_rows(router, 1)), timeout_s=240.0)
        respawned = _ready_rows(router, 1)[0]
        assert respawned["compile_count"] == 0
        assert respawned["post_warm_compiles"] == 0
        np.testing.assert_array_equal(router.attribute(_x(), 1), answer)
    finally:
        router.close()
    assert [r["transition"] for r in router.metrics.restarts] == ["restarting", "alive"]


def test_cold_worker_joins_compile_free_from_wire_bundle(bundle):
    from wam_tpu_torch.pod.metrics import _c_registry_stream

    root, path, answer = bundle
    streamed_before = _c_registry_stream.value()
    router = PodRouter(TOY_ARGV + ["--registry", "wire"], "1x16x16", workers=1,
                       transport="tcp", registry=path,
                       env=_caches(root / "wire", cpp_from=root / "seed"),
                       ready_timeout_s=300.0)
    try:
        ready = _ready_rows(router, 0)
        assert ready and ready[0]["compile_count"] == 0
        np.testing.assert_array_equal(router.attribute(_x(), 1), answer)
        # the bundle went over the wire, not through a path
        assert _c_registry_stream.value() > streamed_before
        assert router.describe()["wire_registry"]
    finally:
        router.close()
