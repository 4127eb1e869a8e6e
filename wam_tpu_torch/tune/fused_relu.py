"""Fused ReLU VJP: packed sign-mask residual, one-multiply backward (K4/K5).

Counterpart of `wam_tpu.tune.fused_relu`. The default ReLU backward keeps
the activation and re-derives the gate from it; `fused_relu` keeps only
the sign mask, bit-packed 8 to a byte (1/32 of a float32 activation), and
its backward is one masked multiply. On CUDA tensors the forward is K4
(``csrc/relu_mask.cu``, y and the mask in one pass) and the backward K5;
CPU tensors run the plain versions below.

`set_fused_relu_impl` takes the reference's four names (the process knob
starts from ``WAM_TPU_FUSED_RELU_IMPL``): ``"auto"`` picks the route by the
tensor's device as above; ``"xla"`` and ``"pallas_interpret"`` run the
plain versions on every device; ``"pallas"`` runs K4/K5 and raises on a
CPU tensor. It is an explicit choice, read at every call (inside a
compiled graph too), never a fallback.

The gradient convention is ``torch.relu``'s and ``jax.nn.relu``'s: the gate
is ``x > 0``, so the gradient at exactly 0 is 0.

Wire-up: ``models.resnet.bind_inference(..., fused_relu_vjp=True)`` sets
``act = fused_relu`` on the model's modules; parameters are untouched.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from wam_tpu_torch import kernels
from wam_tpu_torch.device import on_cpu

__all__ = ["fused_relu", "set_fused_relu_impl", "get_fused_relu_impl",
           "pack_mask", "unpack_mask"]

_LANES = kernels.MASK_LANES
_PACK = kernels.MASK_PACK

_IMPLS = ("auto", "xla", "pallas", "pallas_interpret")
_impl = "auto"


def set_fused_relu_impl(name: str) -> None:
    """Select the fused-ReLU route for the calls that follow (module
    docstring): ``"auto"``, ``"xla"``, ``"pallas"`` or
    ``"pallas_interpret"``."""
    global _impl
    if name not in _IMPLS:
        raise ValueError(f"impl {name!r} not one of {_IMPLS}")
    _impl = name


set_fused_relu_impl(os.environ.get("WAM_TPU_FUSED_RELU_IMPL", "auto"))


def get_fused_relu_impl() -> str:
    return _impl


def _on_kernel(t: torch.Tensor) -> bool:
    """Whether a call on ``t`` runs K4/K5 under the knob (module
    docstring); "pallas" on a CPU tensor raises."""
    if _impl == "auto":
        return not on_cpu(t)
    if _impl == "pallas":
        if on_cpu(t):
            raise ValueError("fused-ReLU impl 'pallas' runs K4/K5, which take CUDA "
                             "tensors; got a CPU tensor (set_fused_relu_impl('auto') "
                             "picks the route by the device)")
        return True
    return False


# -- packed-mask layout ------------------------------------------------------
#
# x is flattened, zero-padded to a multiple of 8·128 and viewed as (R, 128)
# with R a multiple of 8. The mask packs the row axis: 8 consecutive rows
# fold into one uint8 row, m[r, l] = Σ_b (x[8r+b, l] > 0)·2^b. Pad elements
# pack to 0 bits and their cotangents are sliced off. The kernels pad
# nothing: they skip the elements past the end, whose bits are 0 all the same.


def _flat_rows(n: int) -> int:
    return kernels.mask_rows(n) * _PACK


def pack_mask(x2: torch.Tensor) -> torch.Tensor:
    """(R, 128) float -> (R // 8, 128) uint8 of sign bits (x > 0)."""
    bits = (x2 > 0).to(torch.int32).reshape(-1, _PACK, _LANES)
    weights = 2 ** torch.arange(_PACK, dtype=torch.int32, device=x2.device)
    return (bits * weights[None, :, None]).sum(dim=1).to(torch.uint8)


def unpack_mask(m: torch.Tensor) -> torch.Tensor:
    """(R // 8, 128) uint8 -> (R, 128) float32 0/1 gate."""
    shifts = torch.arange(_PACK, dtype=torch.uint8, device=m.device)
    bits = (m[:, None, :] >> shifts[None, :, None]) & 1
    return bits.reshape(-1, _LANES).to(torch.float32)


def _to_rows(a: torch.Tensor) -> torch.Tensor:
    """``a`` flat as (R, 128): a view when ``a`` is contiguous and its size a
    multiple of 1024 (every ReLU site of ResNet-50), else a zero-padded copy."""
    flat = a.reshape(-1)
    pad = _flat_rows(flat.numel()) * _LANES - flat.numel()
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, _LANES)


def _from_rows(a2: torch.Tensor, shape, dtype) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= int(d)
    return a2.reshape(-1)[:n].reshape(shape).to(dtype)


def relu_fwd_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4: (relu(x), packed mask)."""
    return torch.relu(x), pack_mask(_to_rows(x))


def relu_bwd_plain(m: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5: g * unpack(m), in g's dtype."""
    g2 = _to_rows(g)
    return _from_rows(g2 * unpack_mask(m).to(g2.dtype), g.shape, g.dtype)


class _FusedRelu(torch.autograd.Function):
    """Forward K4, saving only the mask; backward K5."""

    @staticmethod
    def forward(ctx, x):
        ctx.kernel = _on_kernel(x)
        if ctx.kernel:
            y, m = kernels.relu_fwd(x.contiguous())
        else:
            y, m = relu_fwd_plain(x)
        ctx.save_for_backward(m)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (m,) = ctx.saved_tensors
        if ctx.kernel:
            return kernels.relu_bwd(m, g.contiguous())
        return relu_bwd_plain(m, g)


# -- the kernels as custom operators, for compiled graphs --------------------
#
# Inside `torch.compile` `fused_relu` calls these (`wavelets.matmul` says
# why): each implementation takes the knob's route where it runs, K4/K5's
# launch wrappers or the plain versions.


@torch.library.custom_op("wam_tpu_torch::relu_fwd", mutates_args=(), device_types="cpu")
def relu_fwd_op(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K4: (relu(x), packed sign mask)."""
    _on_kernel(x)  # "pallas" raises on a CPU tensor
    return relu_fwd_plain(x)


@relu_fwd_op.register_kernel("cuda")
def _(x):
    return kernels.relu_fwd(x) if _on_kernel(x) else relu_fwd_plain(x)


@relu_fwd_op.register_fake
def _(x):
    return (torch.empty_like(x),
            x.new_empty((kernels.mask_rows(x.numel()), _LANES), dtype=torch.uint8))


@torch.library.custom_op("wam_tpu_torch::relu_bwd", mutates_args=(), device_types="cpu")
def relu_bwd_op(m: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K5: g * unpack(m)."""
    return relu_bwd_plain(m, g)


@relu_bwd_op.register_kernel("cuda")
def _(m, g):
    return kernels.relu_bwd(m, g) if _on_kernel(g) else relu_bwd_plain(m, g)


@relu_bwd_op.register_fake
def _(m, g):
    return torch.empty_like(g)


def _relu_op_setup(ctx, inputs, output):
    ctx.save_for_backward(output[1])


def _relu_op_backward(ctx, gy, gm):
    (m,) = ctx.saved_tensors
    return relu_bwd_op(m, gy.contiguous())


relu_fwd_op.register_autograd(_relu_op_backward, setup_context=_relu_op_setup)


def fused_relu(x: torch.Tensor) -> torch.Tensor:
    """ReLU with the packed-mask fused backward (module docstring). As in
    the reference, the primal is a plain ``torch.relu`` when autograd does
    not record (no gradient needed); the kernel pair runs whenever it does."""
    if torch.is_grad_enabled() and x.requires_grad:
        if torch.compiler.is_compiling():
            return relu_fwd_op(x.contiguous())[0]
        return _FusedRelu.apply(x)
    return torch.relu(x)
