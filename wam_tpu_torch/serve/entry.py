"""Serving entries — the glue between an engine and the runtime (PyTorch
port of `wam_tpu.serve.entry`).

A serving entry is a callable ``entry(x, y) -> attribution tree`` with a
leading batch axis on every input and output leaf and no instance-attribute
stashing (the worker loop is a thread; the engines' ``__call__``
convenience surface sets ``self.scales`` etc. and is NOT thread-safe).
`jit_entry` keeps the reference's name and contract; there is no jit in
eager PyTorch, and what the reference does at trace time happens at the
FIRST call at a new input signature (the shape, dtype and device of every
tensor argument, `signature`) — where cuDNN picks its algorithms, the
port's kernels are built and their band plans made:

- **first-call counting** via ``on_trace``: it runs once per new
  signature, so it counts what the reference's hook counts (the serve
  ledger's ``compile_count`` and the one-per-bucket assertion), and every
  such call is reported to the sentinel (`wam_tpu_torch.obs.sentinel`)
  under ``obs_kind``;
- **donation** (``donate``, `pipeline.donation`): the staged input batch
  is released to the caching allocator once the entry has enqueued its
  work on it;
- **health** (``with_health``): the numeric-health vector computed inside
  the same call;
- **row blocks** (``blocks``): what the fleet's data-parallel oversize
  route (`serve.fleet`) needs to run an entry with a batch-global
  reduction on blocks of a batch's rows, on several devices: `RowBlocks`,
  the block's share of the work and the finish that takes the reduction
  over every block. (An entry whose rows depend on their own input alone
  says so with ``entry.wam_row_wise = True`` instead.)

``aot_key=`` (the reference's AOT executable cache) raises
NotImplementedError until the port's ``pipeline/aot.py`` lands
(ROADMAP.md slice E); `fleet_aot_key` is a string function and is here.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable

from wam_tpu_torch.obs import sentinel
from wam_tpu_torch.pipeline.donation import release, resolve_donate

__all__ = ["jit_entry", "fleet_aot_key", "signature", "RowBlocks", "join_blocks"]


@dataclass(frozen=True)
class RowBlocks:
    """An entry ``(x, y) -> out`` over B rows, computed on blocks of them:

    - ``partial(x_block, y_block, lo, total) -> (state, maxima)`` runs on
      the block's device with the rows ``[lo, lo + len(x_block))`` of a
      ``total``-row batch, and returns what the block keeps (``state``, on
      its device) and a tensor, or tuple of tensors, of the maxima its
      batch-global reduction takes over its own rows;
    - ``finish(state, maxima) -> out`` gives the block's rows of the entry's
      result on the whole batch, once ``maxima`` are the elementwise max of
      every block's (host numpy arrays, the shapes ``partial`` returned).
    """

    partial: Callable
    finish: Callable

    @classmethod
    def local(cls, rows: Callable) -> "RowBlocks":
        """Blocks of an entry whose only batch-wide dependences are its
        noise draws and its loss scale: ``rows(x_block, y_block, lo,
        total)`` gives the block's rows of the result outright (no maxima,
        the finish passes them through)."""
        return cls(lambda x, y, lo, total: (rows(x, y, lo, total), ()),
                   lambda state, maxima: state)


def join_blocks(parts: list, health: bool = False):
    """The whole batch's result from its blocks' finished results (host
    numpy trees, in row order): every leaf concatenated along its rows; a
    health-carrying entry's ``(out, vec)`` pairs give ``(out, merged
    vec)`` (`obs.health.merge_stats`)."""
    import numpy as np

    def cat(trees):
        first = trees[0]
        if isinstance(first, dict):
            return {k: cat([t[k] for t in trees]) for k in first}
        if isinstance(first, (tuple, list)):
            return type(first)(cat([t[i] for t in trees]) for i in range(len(first)))
        return np.concatenate([np.asarray(t) for t in trees])

    if not health:
        return cat(parts)
    from wam_tpu_torch.obs.health import merge_stats

    return cat([p[0] for p in parts]), merge_stats([p[1] for p in parts])


def fleet_aot_key(aot_key: str | None, n_replicas: int | None,
                  precision: str | None = None) -> str | None:
    """Replica-count (and precision) tag for fleet AOT keys, as in the
    reference: an export built for an N-card fleet must be a cache MISS on
    another N, and a non-default ``precision`` tag (`config.precision_tag`,
    e.g. "bf16" or "bf16+mel") is appended so a bf16 export never hits the
    f32 one. Single-card keys (``n_replicas`` in {None, 1}) and the default
    policy ("f32"/None/"") pass through unchanged."""
    if aot_key is None:
        return None
    if n_replicas not in (None, 1):
        aot_key = f"{aot_key}|fleet{int(n_replicas)}"
    if precision not in (None, "", "f32"):
        aot_key = f"{aot_key}|{precision}"
    return aot_key


def signature(*args) -> tuple:
    """The input signature a first call is keyed on: (shape, dtype, device)
    of each tensor or array argument, the value's type otherwise (a None
    label is its own signature)."""
    sig = []
    for a in args:
        shape = getattr(a, "shape", None)
        if shape is None:
            sig.append(type(a).__name__)
        else:
            sig.append((tuple(int(d) for d in shape), str(getattr(a, "dtype", "")),
                        str(getattr(a, "device", "cpu"))))
    return tuple(sig)


def _bucket_of(x):
    """Bucket label for a first-call event: the input's shape."""
    try:
        return "x".join(str(int(d)) for d in x.shape)
    except Exception:
        return None


def jit_entry(
    impl: Callable,
    *,
    donate: bool | None = None,
    on_trace: Callable[[], None] | None = None,
    aot_key: str | None = None,
    obs_kind: str = "serve",
    with_health: bool | str = False,
    blocks: RowBlocks | None = None,
):
    """Wrap ``impl(x, y)`` as a serving entry (see module docstring).

    ``donate=None`` resolves to "donate on the card only"
    (`pipeline.donation.resolve_donate`). Every first call at a new input
    signature fires ``on_trace`` and is reported to the sentinel under
    ``obs_kind``, tagged with whatever bucket/replica/phase labels the
    caller's thread holds.

    ``with_health=True`` computes the numeric-health reduction over the
    output in the SAME call: the entry returns ``(out, health_vec)`` where
    the vector is `wam_tpu_torch.obs.health.health_stats` over the output —
    one more small tensor of the result already being fetched, never a
    second fetch. ``with_health="fused"`` declares that ``impl`` ALREADY
    returns that tuple (`WamEngine.attribute_with_health` folds the
    gradient statistics in). Either way the entry carries
    ``entry.wam_health = True`` so the serve worker knows to unpack.

    ``blocks`` becomes ``entry.wam_blocks`` (module docstring); a block's
    ``partial`` counts its first calls and releases its donated input as
    the entry does. With ``with_health=True`` each block's finish returns
    ``(rows, health vector of its rows)`` (`join_blocks` merges them);
    with ``"fused"`` the given finish already does."""
    if aot_key is not None:
        raise NotImplementedError(
            "aot_key= needs the AOT executable cache, pipeline/aot.py, which is not "
            "ported yet (ROADMAP.md, slice E)")
    fused = with_health == "fused"
    if with_health and not fused:
        from wam_tpu_torch.obs.health import health_stats

        base_impl = impl

        def impl(x, y):  # noqa: F811 - deliberate health-wrapped rebind
            out = base_impl(x, y)
            return out, health_stats(out)

        impl.__name__ = getattr(base_impl, "__name__", "entry") + "+health"

    donating = resolve_donate(donate)
    seen: set = set()
    lock = threading.Lock()
    detail = getattr(impl, "__name__", "")

    def first_call(x, y):
        sig = signature(x, y)
        with lock:
            first = sig not in seen
            seen.add(sig)
        if first:
            sentinel.record_trace(obs_kind, detail=detail, bucket=_bucket_of(x))
            if on_trace is not None:
                on_trace()

    def entry(x, y):
        first_call(x, y)
        out = impl(x, y)
        if donating:
            release(x)
        return out

    entry.__name__ = detail or "entry"
    entry.wam_donate = donating
    entry.wam_blocks = None
    if blocks is not None:
        def partial(x, y, lo, total):
            first_call(x, y)
            out = blocks.partial(x, y, lo, total)
            if donating:
                release(x)
            return out

        finish = blocks.finish
        if with_health and not fused:
            from wam_tpu_torch.obs.health import health_stats

            def finish(state, maxima):  # noqa: F811 - health-wrapped rebind
                out = blocks.finish(state, maxima)
                return out, health_stats(out)

        entry.wam_blocks = RowBlocks(partial, finish)
    if with_health:
        entry.wam_health = True
    return entry
