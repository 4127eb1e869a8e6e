"""What the models share: flax's LayerNorm eps, the reference's initialisers
(`lecun_normal_`, `dense`), and the activation taps.

Taps are the counterpart of the reference's ``sow("intermediates", name,
x)`` followed by ``perturb(name, x)``: a model passes an activation through
``tap(name, x)`` where the reference sows it. Outside a `tap_scope` the call
returns ``x`` itself and adds no operation. Inside a scope that asks for
``name``, the activation is recorded and made a leaf that requires grad (a
detached alias, no copy, when nothing upstream carries a graph), so
``torch.autograd.grad(loss, scope[name])`` is the gradient with respect to
it, as the gradient with respect to the reference's zero perturbation is.
A model lists its tap names, the reference's letter for letter, in ``TAPS``.
"""

from __future__ import annotations

import math
import threading
from typing import Iterable, NamedTuple

import torch
import torch.nn as nn

__all__ = ["LN_EPS", "lecun_normal_", "dense", "tap", "tap_scope", "TapRecord"]

LN_EPS = 1e-6  # flax's LayerNorm default (torch's is 1e-5)


def lecun_normal_(weight: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's ``lecun_normal``, in place: a normal of variance 1 / fan_in
    truncated at two standard deviations (the scale corrected for the
    truncation, as flax's ``variance_scaling`` does), from torch's global
    generator."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std)


def dense(d_in: int, d_out: int) -> nn.Linear:
    """A dense layer drawn as flax's ``Dense``: lecun_normal kernel, zero bias."""
    layer = nn.Linear(d_in, d_out)
    lecun_normal_(layer.weight, d_in)
    nn.init.zeros_(layer.bias)
    return layer


# -- activation taps ------------------------------------------------------------------

_tls = threading.local()  # per-thread stack of live tap scopes


class TapRecord(NamedTuple):
    """A tapped activation and its layout: ``channels_last`` for a
    (B, H, W, C) activation (ConvNeXt's), else channels first, or a (B, N,
    D) token sequence."""

    tensor: torch.Tensor
    channels_last: bool


class tap_scope:
    """Record the named taps of the forwards run inside it::

        with tap_scope(["stage4"]) as taps, torch.enable_grad():
            out = model(x)
            g = torch.autograd.grad(out.sum(), taps["stage4"])

    ``taps[name]`` is the activation (the last one recorded under that
    name), ``taps.records[name]`` its `TapRecord`."""

    def __init__(self, names: Iterable[str]):
        self.names = frozenset(names)
        self.records: dict[str, TapRecord] = {}

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.records[name].tensor

    def __enter__(self) -> "tap_scope":
        stack = getattr(_tls, "scopes", None)
        if stack is None:
            stack = _tls.scopes = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _tls.scopes.remove(self)
        return False


def tap(name: str, x: torch.Tensor, channels_last: bool = False) -> torch.Tensor:
    """A model's tap point: ``x`` itself unless a live `tap_scope` asks for
    ``name``; then ``x`` is recorded as a tensor that requires grad."""
    scopes = getattr(_tls, "scopes", None)
    if not scopes:
        return x
    for scope in scopes:
        if name in scope.names:
            if not x.requires_grad:
                x = x.detach().requires_grad_()
            scope.records[name] = TapRecord(x, channels_last)
    return x
