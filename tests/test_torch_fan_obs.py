"""The eval fan's observability on the port (`wam_tpu_torch.evalsuite.fan`,
`obs.health`, `results`), held to the reference's:

- `run_fan` runs the step in span ``fan.dispatch`` and the fetch in span
  ``fan.fetch`` (category "fan"), as `wam_tpu.evalsuite.fan.run_fan` does;
- every `device_fetch` adds one to ``wam_tpu_fan_result_fetches_total``:
  a metric call of `Eval2DWAM` adds exactly one;
- with the health piggyback on (`obs.health.fan_health_enabled`, the
  default), a metric call publishes one health vector under source "fan"
  while its fetch count stays 1 and its host reads stay one copy (the
  vector rides the result's); off, nothing is published;
- `results.read_jsonl` counts the lines it skips into
  ``wam_tpu_serve_ledger_corrupt_lines_total``, as the reference does.

The metric calls run a one-conv model at 16² on the CPU: the claims are
about the fan's bookkeeping, not the model."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import wam_tpu.obs as jobs
import wam_tpu.results as jresults
from wam_tpu.evalsuite import fan as jfan
from wam_tpu.obs import health as jhealth
from wam_tpu_torch import obs as tobs
from wam_tpu_torch import results as tresults
from wam_tpu_torch.evalsuite import fan as tfan
from wam_tpu_torch.evalsuite.eval2d import Eval2DWAM
from wam_tpu_torch.obs import health as thealth

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture
def observed():
    """Observability on with empty rings, the piggyback switch restored."""
    saved = thealth._FAN_HEALTH, jhealth._FAN_HEALTH
    tobs.configure(enabled=True)
    jobs.configure(enabled=True)
    tobs.reset()
    jobs.reset()
    yield
    thealth.set_fan_health(saved[0])
    jhealth.set_fan_health(saved[1])


def _fan_rows(spans):
    return [(s["name"], s["cat"]) for s in spans if s.get("cat") == "fan"]


@pytest.mark.parametrize("health", [True, False])
def test_run_fan_spans_and_counter_equal_the_reference(observed, health):
    thealth.set_fan_health(health)
    jhealth.set_fan_health(health)
    assert thealth.fan_health_enabled() is health and jhealth.fan_health_enabled() is health
    tcount = tobs.registry.counter("wam_tpu_fan_result_fetches_total")
    jcount = jobs.registry.counter("wam_tpu_fan_result_fetches_total")
    t0, j0 = tcount.value(), jcount.value()
    x = np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)
    got = tfan.run_fan(lambda a: a * 2.0, (torch.from_numpy(x),))
    want = jfan.run_fan(lambda a: a * 2.0, (jnp.asarray(x),))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert tcount.value() - t0 == 1 == jcount.value() - j0
    assert _fan_rows(tobs.tracing.spans()) == _fan_rows(jobs.tracing.spans()) == [
        ("fan.dispatch", "fan"), ("fan.fetch", "fan")]


def _toy_eval():
    g = torch.Generator().manual_seed(0)
    w = torch.randn(4, 3, 3, 3, generator=g) * 0.3

    def fn(x):
        return torch.tanh(F.conv2d(x, w.to(x.dtype), padding=1)).mean(dim=(2, 3))

    ev = Eval2DWAM(fn, None, wavelet="haar", J=2, batch_size=16, device="cpu")
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 3, 16, 16)).astype(np.float32))
    ev.grad_wams = torch.from_numpy(rng.random((2, 16, 16)).astype(np.float32))
    return ev, x, [1, 3]


@pytest.fixture
def host_reads(monkeypatch):
    """Every tensor-to-host read while a metric runs."""
    calls = []
    for name in ("cpu", "numpy", "item", "tolist", "__array__"):
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    return calls


@pytest.mark.parametrize("health", [True, False], ids=["health-on", "health-off"])
def test_a_metric_call_fetches_once_with_the_health_vector(observed, host_reads, health):
    thealth.set_fan_health(health)
    ev, x, y = _toy_eval()
    fetches = tobs.registry.counter("wam_tpu_fan_result_fetches_total")
    checks = tobs.registry.counter("wam_tpu_health_checks_total",
                                   labels=("source", "replica"))
    for call in (lambda: ev.insertion(x, y, n_iter=4), lambda: ev.deletion(x, y, n_iter=4),
                 lambda: ev.mu_fidelity(x, y, grid_size=4, sample_size=4, subset_size=6)):
        f0, c0 = fetches.value(), checks.value(source="fan", replica="-")
        tobs.tracing.clear_spans()
        host_reads.clear()
        with tfan.fetch_scope() as fs:
            out = call()
        assert np.all(np.isfinite(out))
        assert fs.count == 1 and fetches.value() - f0 == 1
        assert host_reads == ["cpu", "numpy"]  # one copy, the vector inside it
        assert checks.value(source="fan", replica="-") - c0 == (1 if health else 0)
        assert _fan_rows(tobs.tracing.spans()) == [("fan.dispatch", "fan"), ("fan.fetch", "fan")]
    if health:
        gauge = tobs.registry.gauge("wam_tpu_health_max_abs",
                                    labels=("source", "replica", "bucket"))
        assert gauge.value(source="fan", replica="-", bucket="-") > 0


def test_the_piggyback_follows_the_obs_switch(observed):
    thealth.set_fan_health(True)
    tobs.configure(enabled=False)
    try:
        assert not thealth.fan_health_enabled()
    finally:
        tobs.configure(enabled=True)
    assert thealth.fan_health_enabled()
    assert {"fan_health_enabled", "set_fan_health"} <= set(thealth.__all__)
    assert set(thealth.__all__) >= set(jhealth.__all__) - {"merge_stats"}


def test_device_fetch_packs_a_tree_into_one_copy(host_reads):
    tree = {"map": torch.randn(2, 5, 3).transpose(1, 2), "vec": torch.arange(6.0),
            "ids": [torch.tensor([3, 1], dtype=torch.int64), torch.tensor(True)],
            "bf16": torch.randn(4).bfloat16(), "none": torch.empty(0, 2)}
    host_reads.clear()
    out = tfan.device_fetch(tree)
    assert host_reads == ["cpu", "numpy"]
    np.testing.assert_array_equal(out["map"], tree["map"].numpy())
    np.testing.assert_array_equal(out["vec"], tree["vec"].numpy())
    np.testing.assert_array_equal(out["ids"][0], tree["ids"][0].numpy())
    assert out["ids"][1].dtype == np.bool_ and out["ids"][1].shape == () and out["ids"][1]
    assert out["bf16"].dtype == np.float32
    np.testing.assert_array_equal(out["bf16"], tree["bf16"].float().numpy())
    assert out["none"].shape == (0, 2)


def _torn_ledger(path):
    path.write_text('{"metric": "a", "v": 1}\n{"metric": "b", "v": 2\n\n'
                    'not json\n{"metric": "c", "v": 3}\n')


def test_read_jsonl_counts_corrupt_lines_as_the_reference(tmp_path, observed):
    path = tmp_path / "ledger.jsonl"
    _torn_ledger(path)
    tc = tobs.registry.counter("wam_tpu_serve_ledger_corrupt_lines_total")
    jc = jobs.registry.counter("wam_tpu_serve_ledger_corrupt_lines_total")
    t0, j0 = tc.value(), jc.value()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rows = tresults.read_jsonl(str(path))
        want = jresults.read_jsonl(str(path))
    assert rows == want and [r["metric"] for r in rows] == ["a", "c"]
    assert tc.value() - t0 == 2 == jc.value() - j0
    with pytest.raises(ValueError):
        tresults.read_jsonl(str(path), strict=True)
    assert tc.value() - t0 == 2  # a strict read raises before counting
