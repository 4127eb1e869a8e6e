"""Host-built constants inside compiled graphs (`pipeline.aot`).

Several eager functions build a constant with numpy and keep it in a
``functools.lru_cache``: the STFT's window and DFT matrices, the mel
filterbank, the nearest-resize index. Dynamo traces neither numpy nor the
cache, so under ``torch.compile`` such a function asks for its constant
through one custom operator, ``wam_tpu_torch::graph_const``, which runs the
same function where the graph runs (its cache included) and hands back a
copy, so the graph may treat the output as its own buffer. Inductor keeps
the call opaque; its fake implementation gives the constant's shape from
the shape rule registered beside it. Eager calls never reach the
operator.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["register_const", "graph_const"]

# name -> (build(like, *args) -> tensor, shape(*args) -> tuple, dtype(like) -> dtype)
_CONSTS: dict[str, tuple[Callable, Callable, Callable]] = {}


def register_const(name: str, build: Callable, shape: Callable,
                   dtype: Callable = lambda like: like.dtype) -> None:
    """Register ``build(like, *args)``, which makes the constant ``name``
    (``like`` gives the device, and the dtype unless ``dtype`` says
    otherwise), with ``shape(*args)``, its shape."""
    _CONSTS[name] = (build, shape, dtype)


@torch.library.custom_op("wam_tpu_torch::graph_const", mutates_args=())
def _const_op(like: torch.Tensor, name: str, args: list[int]) -> torch.Tensor:
    """The constant ``name`` at ``args`` on ``like``'s device (a copy)."""
    return _CONSTS[name][0](like, *args).clone(memory_format=torch.contiguous_format)


@_const_op.register_fake
def _(like, name, args):
    _, shape, dtype = _CONSTS[name]
    return like.new_empty(tuple(shape(*args)), dtype=dtype(like))


def graph_const(name: str, like: torch.Tensor, *args: int) -> torch.Tensor:
    """The constant ``name`` at the integer ``args``: ``build``'s cached
    tensor in eager code, the operator's copy inside a compiled graph."""
    if torch.compiler.is_compiling():
        # detached: the constant has no gradient to give ``like``
        return _const_op(like.detach(), name, [int(a) for a in args])
    return _CONSTS[name][0](like, *args)
