"""Parity of the PyTorch port's evaluation machinery with the JAX package:
the image filters, the coefficient packing, the metrics (AUC, masks,
Spearman, μ-fidelity draws), the fan's plans, forwards and fetch counter,
and the precision policy. Inputs are drawn with numpy from a seed and given
to both packages.

Tolerances: index maps, masks, packing, plans and draws are exact; float32
reductions in another order are held to 1e-6 of their scale.
"""

import threading
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wam_tpu import config as jconfig
from wam_tpu.evalsuite import fan as jfan
from wam_tpu.evalsuite import metrics as jmetrics
from wam_tpu.evalsuite import packing as jpack
from wam_tpu.ops import filters as jfilters
from wam_tpu.wavelets import transform as jt
from wam_tpu_torch import config as tconfig
from wam_tpu_torch.evalsuite import fan as tfan
from wam_tpu_torch.evalsuite import metrics as tmetrics
from wam_tpu_torch.evalsuite import packing as tpack
from wam_tpu_torch.ops import filters as tfilters
from wam_tpu_torch.wavelets import transform as tt

CPU = torch.device("cpu")


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True)
def no_precision_knobs(monkeypatch):
    """Neither package reads a fan-dtype or mel knob from the environment."""
    monkeypatch.delenv("WAM_TPU_FAN_DTYPE", raising=False)
    monkeypatch.delenv("WAM_TPU_MEL_BF16", raising=False)


# -- ops/filters -----------------------------------------------------------------


@pytest.mark.parametrize("n_in,n_out", [(28, 224), (28, 230), (28, 235), (28, 237), (7, 20),
                                        (224, 235), (235, 224), (230, 224), (115, 64), (10, 3)])
def test_upsample_nearest_matches_jax(n_in, n_out):
    """The half-pixel nearest resize, up and down, divisible or not, at the
    reference's float32 rounding (28 -> 237 is where it differs from
    ``F.interpolate(mode="nearest-exact")``): equal."""
    x = _rng("up", n_in, n_out).standard_normal((2, n_in, n_in + 3)).astype(np.float32)
    want = np.asarray(jfilters.upsample_nearest(jnp.asarray(x), (n_out, n_out + 1)))
    got = tfilters.upsample_nearest(_t(x), (n_out, n_out + 1)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("side,grid", [(224, 28), (230, 28), (235, 28), (237, 28), (30, 8)])
def test_superpixel_sum_matches_jax(side, grid):
    """Cell sums at divisible and non-divisible sizes: each pixel in the cell
    JAX's nearest resize maps it to. Ones count each cell's pixels exactly;
    random maps agree to 1e-6 of the total."""
    for x in (np.ones((2, side, side + 1), np.float32),
              _rng("sp", side).standard_normal((2, side, side + 1)).astype(np.float32)):
        want = np.asarray(jfilters.superpixel_sum(jnp.asarray(x), grid))
        got = tfilters.superpixel_sum(_t(x), grid).numpy()
        assert got.shape == want.shape == (2, grid, grid)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(x).sum())
    counts = tfilters.superpixel_sum(torch.ones(side, side), grid)
    assert float(counts.sum()) == side * side


@pytest.mark.parametrize("sigma", [0.5, 1.0, 2.0])
def test_gaussian_filter2d_matches_jax(sigma):
    x = _rng("gauss", sigma).standard_normal((3, 28, 33)).astype(np.float32)
    want = np.asarray(jfilters.gaussian_filter2d(jnp.asarray(x), sigma))
    got = tfilters.gaussian_filter2d(_t(x), sigma).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# -- evalsuite/packing -----------------------------------------------------------


@pytest.mark.parametrize("wavelet,J,side", [("haar", 3, 32), ("db4", 3, 40), ("db2", 2, 27)])
def test_pack2d_matches_jax_and_round_trips(wavelet, J, side):
    x = _rng("pack2d", wavelet).standard_normal((2, 3, side, side + 2)).astype(np.float32)
    jc = jt.wavedec2(jnp.asarray(x), wavelet, J)
    tc = tt.wavedec2(_t(x), wavelet, J, impl="conv")
    want = np.asarray(jpack.coeffs_to_array2d(jc))
    got = tpack.coeffs_to_array2d(tc)
    assert tpack.packed2d_shape(tc) == jpack.packed2d_shape(jc) == tuple(got.shape[-2:])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    back = tpack.array_to_coeffs2d(got, tpack.coeff_shapes2d(tc))
    flat = [back[0]] + [t for d in back[1:] for t in d]
    for a, b in zip(flat, [tc[0]] + [t for d in tc[1:] for t in d]):
        assert torch.equal(a, b)
        assert a.data_ptr() >= got.data_ptr()  # views of the packed array


def test_pack1d_matches_jax_and_round_trips():
    x = _rng("pack1d").standard_normal((2, 1000)).astype(np.float32)
    tc = tt.wavedec(_t(x), "db6", 4, mode="reflect")
    arr = tpack.coeffs_to_array1d(tc)
    want = np.asarray(jpack.coeffs_to_array1d([jnp.asarray(c.numpy()) for c in tc]))
    np.testing.assert_array_equal(arr.numpy(), want)
    back = tpack.array_to_coeffs1d(arr, [c.shape[-1] for c in tc])
    assert all(torch.equal(a, b) for a, b in zip(back, tc))


# -- evalsuite/metrics -----------------------------------------------------------


def _tied(shape, key):
    """Values with many ties: a few levels, and blocks of equal values."""
    a = np.round(_rng("ties", key).standard_normal(shape), 1).astype(np.float32)
    a.reshape(-1)[::7] = 0.5
    return a


@pytest.mark.parametrize("n_iter", [1, 4, 8, 64])
def test_generate_masks_2d_matches_jax_with_ties(n_iter):
    attr = _tied((16, 16), n_iter)
    want = [np.asarray(m) for m in jmetrics.generate_masks(n_iter, jnp.asarray(attr))]
    got = [m.numpy() for m in tmetrics.generate_masks(n_iter, _t(attr))]
    for g, w in zip(got, want):
        assert g.shape == w.shape == (n_iter + 1, 16, 16)
        np.testing.assert_array_equal(g, w)


def test_generate_masks_1d_signed_matches_jax_with_ties():
    attr = _tied((5003,), "1d")
    attr[100:140] = -attr[140:180]  # equal magnitudes of both signs
    want = [np.asarray(m) for m in jmetrics.generate_masks(64, jnp.asarray(attr), signed=True)]
    got = [m.numpy() for m in tmetrics.generate_masks(64, _t(attr), signed=True)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_compute_auc_softmax_minmax_match_jax():
    p = _rng("auc").random((3, 65)).astype(np.float32)
    p[1] = 0.0
    np.testing.assert_allclose(tmetrics.compute_auc(_t(p)).numpy(),
                               np.asarray(jmetrics.compute_auc(jnp.asarray(p))), atol=1e-6)
    logits = _rng("softmax").standard_normal((4, 7)).astype(np.float32)
    np.testing.assert_allclose(tmetrics.softmax_probs(_t(logits)).numpy(),
                               np.asarray(jmetrics.softmax_probs(jnp.asarray(logits))),
                               atol=1e-6)
    np.testing.assert_allclose(tmetrics.minmax_normalize(_t(logits)).numpy(),
                               np.asarray(jmetrics.minmax_normalize(jnp.asarray(logits))),
                               atol=1e-6)


@pytest.mark.parametrize("n", [6, 128, 200])
def test_spearman_matches_jax_and_scipy_with_ties(n):
    """Average ranks for ties: JAX's and scipy.stats.spearmanr's value to 1e-6."""
    from scipy.stats import spearmanr

    rng = _rng("spearman", n)
    a = np.round(rng.standard_normal(n), 1).astype(np.float32)
    b = np.round(rng.standard_normal(n), 1).astype(np.float32)
    b[: n // 4] = 0.0
    a[n // 2: n // 2 + n // 8] = 0.5
    got = float(tmetrics.spearman(_t(a), _t(b)))
    np.testing.assert_allclose(got, float(jmetrics.spearman(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-6)
    np.testing.assert_allclose(got, spearmanr(a, b).statistic, atol=1e-6)
    assert float(tmetrics.spearman(_t(a), _t(a))) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("with_rand_masks", [True, False])
def test_mu_fidelity_draws_bitwise_equal(with_rand_masks):
    """The same numpy stream in the same order: bitwise equal, cached per
    configuration (a second call returns the same tensors)."""
    args = (7, 3, 8, 6, 12, with_rand_masks)
    want = jmetrics.mu_fidelity_draws({}, *args)
    cache = {}
    got = tmetrics.mu_fidelity_draws(cache, *args, device=CPU)
    if with_rand_masks:
        assert got[0].shape == (3, 6, 8, 8) and got[1].shape == (3, 6, 64)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[0].untyped_storage().data_ptr() == got[1].untyped_storage().data_ptr()
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tmetrics.mu_fidelity_draws(cache, *args, device=CPU) is got


def test_batch_fingerprint():
    x = torch.zeros((2, 3, 4, 4))
    assert tmetrics.batch_fingerprint(x, [1, 2]) == ((2, 3, 4, 4), "float32", (1, 2))
    assert tmetrics.batch_fingerprint(x, torch.tensor([1, 2])) == ((2, 3, 4, 4), "float32",
                                                                   (1, 2))
    assert tmetrics.batch_fingerprint(x, None)[2] == ()


# -- evalsuite/fan ---------------------------------------------------------------


@pytest.mark.parametrize("cap", [1, 16, 64, 65, 100, 128, 256, 520])
@pytest.mark.parametrize("fan", [3, 9, 65, 128])
def test_plan_fan_int_caps_match_jax(cap, fan):
    want = jfan.plan_fan(cap, fan)
    got = tfan.plan_fan(cap, fan)
    assert (got.cap, got.images_per_chunk, got.fan_chunk, got.fan_dtype) == (
        want.cap, want.images_per_chunk, want.fan_chunk, want.fan_dtype)


def test_plan_fan_auto_is_the_reference_fallback():
    assert tfan.plan_fan("auto", 65) == tfan.FanPlan(128, 1, None, "f32")
    assert tfan.plan_fan("auto", 129) == tfan.FanPlan(128, 1, 128, "f32")
    assert tfan.plan_fan("auto", 8, fan_dtype="bf16") == tfan.FanPlan(128, 16, None, "bf16")


@pytest.mark.parametrize("fan_chunk", [None, 2, 3, 16])
def test_chunked_forward_slices_rows(fan_chunk):
    calls = []
    w = _t(_rng("fwd").standard_normal((5, 4)).astype(np.float32))

    def model(x):
        calls.append(x.shape[0])
        return x @ w

    x = _t(_rng("fwd-x").standard_normal((7, 5)).astype(np.float32))
    out = tfan.make_chunked_forward(model, fan_chunk)(x)
    torch.testing.assert_close(out, x @ w)
    step = fan_chunk if fan_chunk and fan_chunk < 7 else 7
    assert calls == [min(step, 7 - i) for i in range(0, 7, step)]


def test_device_fetch_counter_and_scopes():
    tfan.reset_fetch_count()
    with tfan.fetch_scope() as outer:
        out = tfan.device_fetch((torch.ones(2), [torch.zeros(1)]))
        with tfan.fetch_scope() as inner:
            tfan.device_fetch(torch.ones(1))
    tfan.device_fetch(torch.ones(1))
    assert isinstance(out[0], np.ndarray) and isinstance(out[1][0], np.ndarray)
    assert (outer.count, inner.count, tfan.fetch_count()) == (2, 1, 3)


def test_fetch_scope_is_thread_isolated():
    counts = []

    def work():
        with tfan.fetch_scope() as fs:
            for _ in range(5):
                tfan.device_fetch(torch.ones(1))
        counts.append(fs.count)

    with tfan.fetch_scope() as main:
        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert counts == [5] * 4 and main.count == 0


def test_fan_runner_builds_no_graph_and_refuses_unported_options():
    w = torch.ones(3, requires_grad=True)
    out = tfan.fan_runner(lambda x: x * w)(torch.ones(3))
    assert not out.requires_grad
    # aot_key= is the compiled-step cache's dispatcher (tests/test_torch_aot.py);
    # donate=True releases CUDA inputs only, so CPU tensors pass through
    assert tfan.fan_runner(lambda x: x, aot_key="k").fns == {}
    x = torch.arange(3.0)
    assert torch.equal(tfan.fan_runner(lambda x: x * 2, donate=True, donate_argnums=(0,))(x),
                       torch.arange(3.0) * 2) and x.numel() == 3
    tfan.fan_runner(lambda x: x, donate=False)
    # mesh= is ported (tests/test_torch_parallel.py): the sharded runner,
    # no graph there either
    from wam_tpu_torch.parallel import make_mesh

    sharded = tfan.fan_runner(lambda x: x * w, mesh=make_mesh({"data": 2}, ["cpu"] * 2))(
        torch.ones(3, 3))
    assert not sharded.requires_grad and torch.equal(sharded, torch.ones(3, 3))


# -- config: the precision policy -------------------------------------------------


@pytest.mark.parametrize("env", ["", "bf16", "fp8", "f32"])
@pytest.mark.parametrize("explicit", [None, "bf16", "f32"])
def test_resolve_precision_matches_jax(monkeypatch, env, explicit):
    """Explicit argument, then WAM_TPU_FAN_DTYPE / WAM_TPU_MEL_BF16, then f32:
    the same policy as the reference's without a tuned entry."""
    if env:
        monkeypatch.setenv("WAM_TPU_FAN_DTYPE", env)
        monkeypatch.setenv("WAM_TPU_MEL_BF16", "1" if env == "bf16" else "0")
    want = jconfig.resolve_precision(fan_dtype=explicit)
    got = tconfig.resolve_precision(fan_dtype=explicit)
    assert (got.fan_dtype, got.mel_bf16, got.tag()) == (want.fan_dtype, want.mel_bf16,
                                                        want.tag())
    assert tfan.plan_fan(16, 9, fan_dtype=explicit).fan_dtype == jfan.plan_fan(
        16, 9, fan_dtype=explicit).fan_dtype


def test_bad_fan_dtype_raises_as_jax_does(monkeypatch):
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError, match="fan_dtype"):
            mod.PrecisionPolicy(fan_dtype="fp16")
    monkeypatch.setenv("WAM_TPU_FAN_DTYPE", "int8")
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError, match="WAM_TPU_FAN_DTYPE"):
            mod.resolve_precision()


@pytest.mark.parametrize("fp8_ok", [True, False])
def test_fp8_policy_degrades_to_bf16_as_jax_does(monkeypatch, fp8_ok):
    """fp8 where the device's probe passes, else bf16; f32 adds no cast."""
    monkeypatch.setattr(jconfig, "_fp8_result", fp8_ok)
    monkeypatch.setattr(tconfig, "_fp8_results", {str(tconfig._current_device()): fp8_ok})
    for fan_dtype in ("f32", "bf16", "fp8"):
        want = jconfig.PrecisionPolicy(fan_dtype=fan_dtype).compute_dtype()
        got = tconfig.PrecisionPolicy(fan_dtype=fan_dtype).compute_dtype()
        assert (None if want is None else jnp.dtype(want).name) == (
            None if got is None else str(got).removeprefix("torch."))


def test_fp8_probe_runs_once_per_device(monkeypatch):
    monkeypatch.setattr(tconfig, "_fp8_results", {})
    first = tconfig.fp8_supported()
    assert tconfig._fp8_results == {str(tconfig._current_device()): first}
    assert tconfig.fp8_supported() is first


@pytest.mark.parametrize("fan_dtype", ["bf16", "fp8"])
def test_cast_model_fn_quantizes_inputs_and_returns_float32(monkeypatch, fan_dtype):
    """The fan forward sees the inputs rounded to the policy dtype (widened
    back) and returns float32 logits; f32 returns the model unchanged."""
    monkeypatch.setattr(tconfig, "_fp8_results", {str(tconfig._current_device()): True})
    seen = []

    def model(x):
        seen.append(x)
        return x.double().sum(dim=1, keepdim=True)

    assert tfan.cast_model_fn(model, "f32") is model
    x = _t(_rng("cast").standard_normal((4, 9)).astype(np.float32))
    out = tfan.cast_model_fn(model, fan_dtype)(x)
    low = torch.bfloat16 if fan_dtype == "bf16" else tconfig.FP8
    assert out.dtype == torch.float32 and seen[0].dtype == torch.float32
    assert torch.equal(seen[0], x.to(low).float())
    jx = np.asarray(jconfig.compute_cast(jnp.asarray(x.numpy()),
                                         jnp.bfloat16 if fan_dtype == "bf16"
                                         else jnp.float8_e4m3fn).astype(jnp.float32))
    np.testing.assert_array_equal(seen[0].numpy(), jx)


# -- results ---------------------------------------------------------------------


def test_jsonl_ledger_round_trips_with_jax_and_skips_a_torn_line(tmp_path):
    """Rows the port writes read back through both packages' readers, and a
    torn last line is skipped with a counted `LedgerCorruptWarning`."""
    from wam_tpu import results as jresults
    from wam_tpu_torch import results as tresults

    path = str(tmp_path / "ledger" / "rows.jsonl")
    w = tresults.JsonlWriter(path)
    w.write(tresults.MetricRecord("insertion", 0.75, "auc", {"n_iter": 64}, timestamp=1.0))
    w.write({"metric": "mu_fidelity", "value": 0.25})
    assert w.done_keys() == {"insertion", "mu_fidelity"}
    with open(path, "a") as f:
        f.write('{"metric": "torn", "val')
    with pytest.warns(tresults.LedgerCorruptWarning, match="1 corrupt"):
        rows, corrupt = tresults.read_jsonl_stats(path)
    with pytest.warns(jresults.LedgerCorruptWarning):
        assert jresults.read_jsonl(path) == rows
    assert corrupt == 1 and rows[0] == {"metric": "insertion", "value": 0.75, "unit": "auc",
                                        "config": {"n_iter": 64}, "timestamp": 1.0}
    with pytest.raises(ValueError):
        tresults.read_jsonl(path, strict=True)


def test_csv_writer_matches_jax(tmp_path):
    from wam_tpu import results as jresults
    from wam_tpu_torch import results as tresults

    for mod, name in ((tresults, "port.csv"), (jresults, "ref.csv")):
        w = mod.CsvWriter(str(tmp_path / name), ["model", "auc"])
        w.write({"model": "resnet50", "auc": 0.5})
        mod.CsvWriter(str(tmp_path / name), ["model", "auc"]).write({"model": "vit", "auc": 1})
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "ref.csv").read_text()
