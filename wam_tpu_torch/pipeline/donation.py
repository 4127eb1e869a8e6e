"""Buffer-donation policy (PyTorch port of `wam_tpu.pipeline.donation`).

On the TPU, donation aliases an input buffer into a jitted program's
output: XLA reuses its memory, and the donated array is deleted for the
caller. Eager PyTorch has no aliasing program; its counterpart here is
release: after a donating call has enqueued its last use of a donated
CUDA tensor, the tensor is emptied (`Tensor.set_`), so its memory goes
back to the caching allocator (stream-ordered: reused by later work on
the same stream only) even while the caller still holds the tensor
object. The caller's handle then has 0 elements: indexing it raises, as a
read of a donated `jax.Array` does.

``donate=None`` resolves to "donate on the card only" (`resolve_donate`):
on the CPU there is no allocator pool to feed, so donation defaults off.

`donation_safe` guards instance-cached or user-held tensors: when
donation is on it passes a copy of a device tensor (so the caller's handle
survives), and is a plain pass-through otherwise.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import numpy as np
import torch

__all__ = ["resolve_donate", "donating_jit", "donation_safe", "release"]


def resolve_donate(donate: bool | None) -> bool:
    """``None`` → donate iff a CUDA card is present (the reference's "on
    TPU only", shared by the serve entries)."""
    if donate is None:
        return torch.cuda.is_available()
    return bool(donate)


def release(t) -> None:
    """Give a donated CUDA tensor's memory back to the caching allocator
    by emptying the tensor (module docstring); CPU tensors and non-tensors
    are left alone."""
    if isinstance(t, torch.Tensor) and t.is_cuda:
        t.set_()


def donating_jit(
    fn: Callable,
    *,
    donate_argnums: Sequence[int] = (0,),
    donate: bool | None = None,
):
    """``fn`` with the shared donation policy: when `resolve_donate(donate)`
    is true, the CUDA tensors at ``donate_argnums`` are released
    (`release`) once ``fn`` returns, that is once it has enqueued every use
    of them. There is no jit in eager PyTorch; the name is the reference's."""
    argnums = tuple(donate_argnums) if resolve_donate(donate) else ()
    if not argnums:
        return fn

    @functools.wraps(fn)
    def donating(*args, **kwargs):
        out = fn(*args, **kwargs)
        for i in argnums:
            if i < len(args):
                release(args[i])
        return out

    return donating


def donation_safe(tree, donating: bool):
    """Make ``tree`` (a tensor or array, or a tuple, list or dict of them)
    safe to pass as a donated argument: numpy leaves become tensors either
    way; when ``donating``, existing CUDA tensors are copied so the caller's
    handle survives the release; otherwise tensors pass through uncopied."""
    if isinstance(tree, torch.Tensor):
        return tree.clone() if donating and tree.is_cuda else tree
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree)
    if isinstance(tree, dict):
        return {k: donation_safe(v, donating) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(donation_safe(v, donating) for v in tree)
    return tree
