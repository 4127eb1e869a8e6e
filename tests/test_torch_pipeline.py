"""The port's streaming pipeline (`wam_tpu_torch.pipeline`) held to the
single-device half of `tests/test_pipeline.py`: the double-buffered
stager (order, overlap, error forwarding, shutdown), `put_committed`'s
placement, and the donation policy, where donating releases a card
tensor's storage to the caching allocator (followed here on CPU tensors
that say they live on the card). The AOT cache half waits for
``pipeline/aot.py`` (ROADMAP.md slice E): its names are absent. The
staging path of a card (pinned memory, the side stream, the event and
`record_stream`) runs in chip_smoke.py's serve phase.

Every wait takes a timeout."""

import time
import warnings

import numpy as np
import pytest
import torch

import wam_tpu.pipeline as jpipe
import wam_tpu_torch.pipeline as tpipe
from wam_tpu_torch.pipeline import (
    DeviceStager,
    donating_jit,
    donation_safe,
    put_committed,
    resolve_donate,
    stage_to_device,
)
from wam_tpu_torch.pipeline.donation import release


class FakeCuda(torch.Tensor):
    """A CPU tensor that says it lives on CUDA, to follow the card's route."""

    @property
    def is_cuda(self):
        return True


def _slow_batches(n, delay, fail_at=None):
    for i in range(n):
        if fail_at is not None and i == fail_at:
            raise ValueError(f"host iterator died at {i}")
        time.sleep(delay)
        yield np.full((4,), float(i), dtype=np.float32)


# -- device stager ------------------------------------------------------------


def test_stager_preserves_order_and_values():
    got = [b for b in stage_to_device(_slow_batches(5, 0.0), device="cpu")]
    assert len(got) == 5
    for i, b in enumerate(got):
        assert isinstance(b, torch.Tensor)
        np.testing.assert_array_equal(b.numpy(), np.full((4,), float(i)))


def test_stager_overlaps_host_production_with_consumption():
    """Producer sleeps DELAY per batch, consumer works DELAY per batch:
    serial cost is 2*N*DELAY, the staged loop ~ (N+1)*DELAY."""
    n, delay = 4, 0.06
    t0 = time.perf_counter()
    for _ in stage_to_device(_slow_batches(n, delay), device="cpu"):
        time.sleep(delay)
    elapsed = time.perf_counter() - t0
    assert elapsed < 2 * n * delay * 0.9, f"staged loop took {elapsed:.3f}s: no overlap"


def test_stager_propagates_host_iterator_error():
    stager = DeviceStager(_slow_batches(5, 0.0, fail_at=2), device="cpu")
    assert float(next(stager)[0]) == 0.0
    assert float(next(stager)[0]) == 1.0
    with pytest.raises(ValueError, match="host iterator died"):
        next(stager)
    stager.close()


def test_stager_close_mid_stream_joins_producer():
    stager = DeviceStager(_slow_batches(50, 0.01), depth=2, device="cpu")
    next(stager)
    stager.close()
    assert not stager._thread.is_alive()
    with pytest.raises(ValueError, match="depth"):
        DeviceStager([], depth=0, device="cpu")


def test_put_committed_honors_device(monkeypatch):
    """The reference commits to a sharding; the port stages onto a device:
    a tree keeps its structure, None stays None, a contiguous numpy leaf on
    the CPU is not copied, and no device means the card or RuntimeError."""
    xs, ys = np.arange(16, dtype=np.float32).reshape(4, 4), np.zeros((4,), np.int32)
    out = put_committed((xs, ys, None, {"k": [xs]}), "cpu")
    assert isinstance(out, tuple) and out[2] is None
    assert all(t.device == torch.device("cpu") for t in (out[0], out[1], out[3]["k"][0]))
    assert out[1].dtype == torch.int32
    assert out[0].data_ptr() == xs.__array_interface__["data"][0]
    t = torch.ones(3)
    assert put_committed(t, "cpu") is t
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        put_committed(xs)


# -- donation policy ----------------------------------------------------------


def test_resolve_donate_default_is_the_card_only():
    assert resolve_donate(None) is torch.cuda.is_available()
    assert resolve_donate(True) is True and resolve_donate(False) is False


def test_donating_jit_default_leaves_cpu_buffers_alone():
    fn = donating_jit(lambda x: x * 2.0)
    x = torch.arange(8.0)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn(x)
    assert not rec
    np.testing.assert_allclose(out.numpy(), np.arange(8.0) * 2.0)
    np.testing.assert_allclose(x.numpy(), np.arange(8.0))


def test_donating_jit_explicit_true_consumes_the_buffer():
    """Forced donation really donates: after the call the card
    tensor is emptied (its memory back to the allocator) and indexing the
    caller's handle raises, as a read of a donated jax.Array does. CPU
    tensors are never released."""
    fn = donating_jit(lambda x: x + 1.0, donate=True)
    x = torch.arange(4.0).as_subclass(FakeCuda)
    out = fn(x)
    np.testing.assert_allclose(out.as_subclass(torch.Tensor).numpy(), np.arange(4.0) + 1.0)
    assert x.numel() == 0 and x.untyped_storage().nbytes() == 0
    with pytest.raises(IndexError):
        x.as_subclass(torch.Tensor)[0]
    cpu = torch.arange(4.0)
    release(cpu)
    assert cpu.untyped_storage().nbytes() == 16
    assert donating_jit(lambda x: x, donate=False) is not fn


def test_donation_safe_copies_only_when_donating():
    x = torch.arange(6.0).as_subclass(FakeCuda)
    assert donation_safe(x, False) is x
    guarded = donation_safe(x, True)
    assert guarded is not x
    np.testing.assert_allclose(guarded.as_subclass(torch.Tensor).numpy(), np.arange(6.0))
    tree = donation_safe({"a": np.ones(3), "b": None, "c": (torch.zeros(2),)}, True)
    assert isinstance(tree["a"], torch.Tensor) and tree["b"] is None
    np.testing.assert_allclose(tree["a"].numpy(), np.ones(3))


def test_jit_entry_donates_the_staged_batch():
    """`serve.entry.jit_entry(donate=True)` releases its input once the
    entry has run: the serve worker's staged batch goes back to the
    allocator while the worker still holds the tensor."""
    from wam_tpu_torch.serve.entry import jit_entry

    ent = jit_entry(lambda x, y: x * 2.0, donate=True)
    x = torch.ones(2, 3).as_subclass(FakeCuda)
    out = ent(x, None)
    assert ent.wam_donate and x.numel() == 0
    np.testing.assert_allclose(out.as_subclass(torch.Tensor).numpy(), np.full((2, 3), 2.0))
    keep = jit_entry(lambda x, y: x * 2.0, donate=False)
    x = torch.ones(2, 3).as_subclass(FakeCuda)
    keep(x, None)
    assert not keep.wam_donate and x.untyped_storage().nbytes() == 24


def test_pipeline_exports_the_reference_less_the_aot_cache():
    # the AOT cache has landed (tests/test_torch_aot.py): nothing is less
    assert tpipe.__all__ == jpipe.__all__
    assert all(getattr(tpipe, n) is not None for n in tpipe.__all__)
