"""Parity of the port's fused ReLU VJP (K4/K5) with the JAX package.

The packed mask must be the reference's bit for bit, and the ReLU's values
and gradients must equal the reference's exactly: a compare, a select and a
multiply by 0 or 1 round nothing. The JAX side runs its Pallas kernels in
interpret mode (``set_fused_relu_impl("pallas_interpret")``); the port side
is the plain version that CPU tensors take.
"""

import importlib
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wam_tpu_torch.tune import fused_relu as tfr

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

# `wam_tpu.tune` re-exports the function `fused_relu` under the module's name
jfr = importlib.import_module("wam_tpu.tune.fused_relu")


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


@pytest.fixture
def pallas_interpret():
    """The JAX impl knob is a module global: set it per test, put it back."""
    before = jfr.get_fused_relu_impl()
    jfr.set_fused_relu_impl("pallas_interpret")
    yield
    jfr.set_fused_relu_impl(before)


def _with_zeros(shape, seed):
    x = _rng("x", shape, seed).standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[::7] = 0.0  # exact zeros: the gate is x > 0, so their gradient is 0
    return x


SHAPES = [(16, 128), (2, 3, 17, 19), (1000,), (3, 1024), (1,)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_pack_and_unpack_are_the_reference_bit_for_bit(shape):
    """Through `_to_rows` (which zero-pads a size that is not a multiple of
    1024, as the reference does), the mask bytes and the unpacked gate equal
    `wam_tpu.tune.fused_relu.pack_mask` / `unpack_mask`."""
    x = _with_zeros(shape, 0)
    want_m = np.asarray(jfr.pack_mask(jfr._to_rows(jnp.asarray(x))))
    got_m = tfr.pack_mask(tfr._to_rows(torch.from_numpy(x)))
    assert got_m.dtype == torch.uint8
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    np.testing.assert_array_equal(tfr.unpack_mask(got_m).numpy(),
                                  np.asarray(jfr.unpack_mask(jnp.asarray(want_m))))
    # bit b of m[r, l] is element (8r + b) * 128 + l: the bits stride by 128
    flat = np.zeros(tfr._to_rows(torch.from_numpy(x)).numel(), np.float32)
    flat[: x.size] = x.reshape(-1)
    bits = (flat.reshape(-1, 8, 128) > 0).astype(np.uint8)
    np.testing.assert_array_equal(got_m.numpy(), (bits << np.arange(8)[None, :, None]).sum(1))


def test_to_rows_is_a_view_when_aligned():
    """At ResNet-50's ReLU sites the size is a multiple of 1024: no copy."""
    x = torch.randn(2, 64, 16, 16)
    rows = tfr._to_rows(x)
    assert rows.shape == (x.numel() // 128, 128)
    assert rows.data_ptr() == x.data_ptr()
    ragged = tfr._to_rows(torch.randn(3, 5))
    assert ragged.shape == (8, 128) and float(ragged.reshape(-1)[15:].abs().sum()) == 0.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fused_relu_equals_the_reference(pallas_interpret, shape, dtype):
    """Values and gradients of `fused_relu` equal the JAX `fused_relu` on its
    Pallas kernels, in float32 and bfloat16, with exact zeros and sizes that
    are not a multiple of 1024."""
    rng = _rng("relu", shape, dtype)
    x = _with_zeros(shape, 1)
    g = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    jx, jg = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    want, vjp = jax.vjp(jfr.fused_relu, jx)
    (want_dx,) = vjp(jg)

    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    got = tfr.fused_relu(tx)
    (got_dx,) = torch.autograd.grad(got, tx, torch.from_numpy(g).to(tdt))
    assert got.dtype == got_dx.dtype == tdt
    np.testing.assert_array_equal(got.float().detach().numpy(), np.asarray(want, np.float32))
    np.testing.assert_array_equal(got_dx.float().numpy(), np.asarray(want_dx, np.float32))
    assert float(got_dx.float().reshape(-1)[::7].abs().sum()) == 0.0


def test_fused_relu_saves_only_the_mask():
    """The residual is the (ceil(numel / 1024), 128) uint8 mask, not the
    activation; with no gradient recorded the primal is plain torch.relu."""
    x = torch.randn(4, 8, 32, requires_grad=True)
    y = tfr.fused_relu(x)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0].dtype == torch.uint8 and saved[0].shape == (1, 128)
    with torch.no_grad():
        plain = tfr.fused_relu(x)
    assert plain.grad_fn is None and torch.equal(plain, torch.relu(x))


def test_plain_kernels_round_trip_the_layout():
    """K4's and K5's plain versions compose to torch.relu's backward."""
    x = torch.from_numpy(_with_zeros((5, 300), 2))
    g = torch.from_numpy(_rng("g").standard_normal((5, 300)).astype(np.float32))
    y, m = tfr.relu_fwd_plain(x)
    assert m.shape == (2, 128)
    assert torch.equal(y, torch.relu(x))
    assert torch.equal(tfr.relu_bwd_plain(m, g), torch.where(x > 0, g, torch.zeros_like(g)))


@pytest.fixture
def restore_impl():
    """The port's and the reference's fused-ReLU knobs, restored after."""
    prev, jprev = tfr.get_fused_relu_impl(), jfr.get_fused_relu_impl()
    yield
    tfr.set_fused_relu_impl(prev)
    jfr.set_fused_relu_impl(jprev)


def test_the_impl_knob_takes_the_references_names(restore_impl, monkeypatch):
    """`set_fused_relu_impl`: the reference's four names, its ValueError on
    any other; "auto", "xla" and "pallas_interpret" run the plain version on
    a CPU tensor, "pallas" raises there; on a tensor the wrapper treats as
    on the card, "auto" and "pallas" take K4/K5 (stand-ins here) and "xla" /
    "pallas_interpret" the plain version."""
    for name in ("auto", "xla", "pallas", "pallas_interpret"):
        tfr.set_fused_relu_impl(name)
        jfr.set_fused_relu_impl(name)
        assert tfr.get_fused_relu_impl() == jfr.get_fused_relu_impl() == name
    with pytest.raises(ValueError) as want:
        jfr.set_fused_relu_impl("cuda")
    with pytest.raises(ValueError) as got:
        tfr.set_fused_relu_impl("cuda")
    assert str(got.value) == str(want.value)
    assert tfr.get_fused_relu_impl() == "pallas_interpret"  # unchanged by the refusal

    x = torch.from_numpy(_with_zeros((4, 37), 3)).requires_grad_(True)
    for name in ("auto", "xla", "pallas_interpret"):
        tfr.set_fused_relu_impl(name)
        y = tfr.fused_relu(x)
        (g,) = torch.autograd.grad(y.sum(), x)
        assert torch.equal(y, torch.relu(x)) and torch.equal(g, (x > 0).to(x.dtype))
    tfr.set_fused_relu_impl("pallas")
    with pytest.raises(ValueError, match="pallas"):
        tfr.fused_relu(x)

    calls = []
    monkeypatch.setattr(tfr, "on_cpu", lambda t: False)  # the card's route
    monkeypatch.setattr(tfr.kernels, "relu_fwd",
                        lambda t: calls.append("K4") or tfr.relu_fwd_plain(t))
    monkeypatch.setattr(tfr.kernels, "relu_bwd",
                        lambda m, g: calls.append("K5") or tfr.relu_bwd_plain(m, g))
    for name, want_calls in (("auto", ["K4", "K5"]), ("pallas", ["K4", "K5"]),
                             ("xla", []), ("pallas_interpret", [])):
        calls.clear()
        tfr.set_fused_relu_impl(name)
        torch.autograd.grad(tfr.fused_relu(x).sum(), x)
        assert calls == want_calls, name
