"""The evaluation fan: chunk planning, dispatch and the single result fetch
of every fan-shaped faithfulness metric (PyTorch port of
`wam_tpu.evalsuite.fan`).

A metric's fan step is one function ``body(*device_args) -> result`` that
runs once per metric call, eagerly, under ``torch.no_grad()`` (no autograd
graph: a chunk's ResNet activations are freed as soon as its logits exist):

- masks, perturbed inputs and label gathers are built on the device inside
  the step; the host uploads the inputs and any cached randomness once;
- the images' fans run in chunks of `FanPlan.images_per_chunk` images a
  model call, or in ``fan_chunk``-row slices when one image's fan alone is
  over the cap on rows per model call (the reference's ``lax.map(...,
  batch_size=)``);
- results stay on the device across chunks and cross to the host in
  EXACTLY ONE counted `device_fetch` per metric call; nothing else in the
  step waits for the device.

``torch.no_grad`` and not ``torch.inference_mode``: operators and band plans
that the transforms cache on first use must stay usable by an autograd
pass later (an explainer's), and an inference-mode tensor cannot be saved
for backward.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from wam_tpu_torch.config import PrecisionPolicy, compute_cast, resolve_precision
from wam_tpu_torch.parallel.mesh import P
from wam_tpu_torch.parallel.tree import cyclic_pad_index, tree_leaves, tree_map, tree_zip_map

__all__ = ["FanPlan", "plan_fan", "fan_chunk_geometry", "cast_model_fn",
           "make_chunked_forward", "make_sharded_runner", "fan_runner",
           "run_fan", "device_fetch",
           "fetch_count", "reset_fetch_count", "fetch_scope", "upload", "AUTO_CAP"]

# rows a model call when batch_size="auto" and no tuned cap matches: the
# reference's own fallback
AUTO_CAP = 128


# -- the single result fetch --------------------------------------------------

_FETCH_COUNT = 0
_fetch_tls = threading.local()  # per-thread stack of live fetch_scopes


def device_fetch(out):
    """THE result fetch: the whole result (a tensor, or a tuple, list or
    dict of them) copied to the host as numpy, in the same structure. Every fan metric's device-to-host
    transfer goes through here, counted by `fetch_scope` and `fetch_count`."""
    global _FETCH_COUNT
    _FETCH_COUNT += 1
    for scope in getattr(_fetch_tls, "scopes", ()):
        scope._count += 1
    return tree_map(lambda t: t.detach().cpu().numpy(), out)


def fetch_count() -> int:
    """`device_fetch` calls since import or the last reset, in every thread."""
    return _FETCH_COUNT


def reset_fetch_count() -> None:
    global _FETCH_COUNT
    _FETCH_COUNT = 0


class fetch_scope:
    """Scoped counter of the `device_fetch` calls made by the current
    thread while it is live::

        with fetch_scope() as fs:
            metric(...)
        assert fs.count == 1

    Scopes nest, each level counting on its own; ``count`` stays readable
    after exit."""

    def __init__(self):
        self._count = 0

    @property
    def count(self) -> int:
        return self._count

    def __enter__(self) -> "fetch_scope":
        scopes = getattr(_fetch_tls, "scopes", None)
        if scopes is None:
            scopes = _fetch_tls.scopes = []
        scopes.append(self)
        return self

    def __exit__(self, *exc):
        _fetch_tls.scopes.remove(self)
        return False


# -- chunk geometry ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FanPlan:
    """Chunk geometry of one metric's fan: ``cap`` model rows a call,
    ``images_per_chunk`` images' fans a model call, ``fan_chunk`` rows a
    model call when one image's fan alone exceeds the cap (else None), and
    the forward's ``fan_dtype`` ("f32" / "bf16" / "fp8")."""

    cap: int
    images_per_chunk: int
    fan_chunk: int | None
    fan_dtype: str = "f32"


def fan_chunk_geometry(batch_size: int, fan: int) -> tuple[int, int | None]:
    """(images_per_chunk, fan_chunk) under a cap of ``batch_size`` rows a
    model call: several images a call when a fan is small, ``batch_size``-
    row slices of one fan when it exceeds the cap."""
    images_per_chunk = max(1, batch_size // fan)
    fan_chunk = batch_size if (images_per_chunk == 1 and fan > batch_size) else None
    return images_per_chunk, fan_chunk


def plan_fan(batch_size, fan: int, *, workload: str = "eval2d", shape=None,
             default: int = AUTO_CAP, fan_dtype: str | None = None,
             backend: str | None = None) -> FanPlan:
    """The fan geometry of one metric call. An int ``batch_size`` is the cap
    (the caller's memory budget, geometry by the cap // fan rule).
    ``"auto"`` reads the schedule cache (`wam_tpu_torch.tune`) for the
    (``workload``, fan) key: its ``fan_cap`` (`tune.resolve_fan_cap`, else
    ``default``) and its ``fan_chunk``, which sets the images a chunk
    directly. ``fan_dtype`` None resolves through `config.resolve_precision`:
    the ``WAM_TPU_FAN_DTYPE`` knob, then (under "auto" only) the tuned
    entry's ``fan_dtype``, then f32."""
    from wam_tpu_torch.tune.cache import lookup_schedule, resolve_fan_cap

    cap = resolve_fan_cap(batch_size, fan, workload=workload, shape=shape, default=default,
                          backend=backend)
    images_per_chunk, fan_chunk = fan_chunk_geometry(cap, fan)
    if batch_size == "auto":
        ent = lookup_schedule(workload, shape or (fan,), fan, backend=backend)
        if ent and ent.get("fan_chunk"):
            images_per_chunk = max(1, int(ent["fan_chunk"]))
            if images_per_chunk > 1:
                fan_chunk = None  # several whole images a chunk: no inner split
    policy = resolve_precision(workload if batch_size == "auto" else None, shape or (fan,), fan,
                               fan_dtype=fan_dtype, backend=backend)
    return FanPlan(cap, images_per_chunk, fan_chunk, policy.fan_dtype)


def cast_model_fn(model_fn, fan_dtype: str):
    """The precision boundary of a fan forward: inputs quantized to the
    policy's compute dtype and widened back to their own dtype, logits
    returned in float32, so every reduction after it runs in float32. The
    model computes at the dtype it is bound at on the quantized values,
    which is what XLA's promotion gives the reference against float32 or
    bf16 parameters. "f32" returns ``model_fn`` unchanged."""
    dtype = PrecisionPolicy(fan_dtype=fan_dtype).compute_dtype()
    if dtype is None:
        return model_fn

    def cast_fn(x):
        return model_fn(compute_cast(x, dtype).to(x.dtype)).float()

    return cast_fn


def make_chunked_forward(model_fn, fan_chunk: int | None):
    """Forward over a fan, in ``fan_chunk``-row model calls when the fan is
    longer than that."""

    def forward(inputs):
        if fan_chunk is not None and fan_chunk < inputs.shape[0]:
            return torch.cat([model_fn(inputs[i:i + fan_chunk])
                              for i in range(0, inputs.shape[0], fan_chunk)])
        return model_fn(inputs)

    return forward


# -- dispatch --------------------------------------------------------------------


def make_sharded_runner(body, mesh, data_axis: str = "data"):
    """The on-mesh fan: axis 0 of every positional argument split over
    ``data_axis`` (cyclically padded to its size), one block a data index
    run on that block's device under ``torch.no_grad()`` (the mesh's other
    axes do not split the fan: their blocks would repeat it), each block's
    outputs moved to the first argument's device, concatenated and sliced
    back to the batch. The blocks are enqueued in turn from this thread and
    nothing waits for the device, so the metric's single `device_fetch`
    stays its only host copy."""

    def run(*args):
        lead = tree_leaves(args)[0].shape[0]
        idx, _ = cyclic_pad_index(lead, mesh.shape[data_axis])
        if idx is not None:
            args = tree_map(lambda a: a[idx.to(a.device)], args)
        out_dev = args[0].device
        outs = []
        with torch.no_grad():
            for d in range(mesh.shape[data_axis]):
                dev = mesh.device(**{data_axis: d})
                block = tree_map(lambda a: mesh.block(a, P(data_axis), **{data_axis: d})
                                 .to(dev), args)
                outs.append(tree_map(lambda t: t.to(out_dev), body(*block)))
        return tree_map(lambda t: t[:lead], tree_zip_map(lambda *p: torch.cat(p), outs))

    return run


def fan_runner(body, *, mesh=None, data_axis: str = "data", donate: bool | None = None,
               donate_argnums: tuple = (), aot_key: str | None = None):
    """The dispatch every fan step goes through.

    One device: ``body`` under ``torch.no_grad()``, its CUDA arguments at
    ``donate_argnums`` released after the call when the shared donation
    policy says so (`pipeline.donation.resolve_donate`: on the card only by
    default; the caller passes copies of what it keeps, `donation_safe`),
    or through the compiled-step cache (`pipeline.aot.cached_entry`) when
    the caller gives an ``aot_key`` (which must identify the model + params).
    With ``mesh``, `make_sharded_runner` splits axis 0 over ``data_axis``;
    donation and the compiled cache are not used there, as in the
    reference."""
    if mesh is not None:
        return make_sharded_runner(body, mesh, data_axis)
    from wam_tpu_torch.pipeline.donation import release, resolve_donate

    argnums = tuple(donate_argnums) if resolve_donate(donate) else ()

    def run(*args):
        with torch.no_grad():
            return body(*args)

    if aot_key is not None:
        from wam_tpu_torch.pipeline.aot import cached_entry

        return cached_entry(run, aot_key, donate_argnums=argnums, obs_kind="fan")
    if not argnums:
        return run

    def donating(*args):
        out = run(*args)
        for i in argnums:
            release(args[i])
        return out

    return donating


def run_fan(runner, args: tuple):
    """Run a fan step and fetch its result ONCE; returns the host (numpy)
    result of the single `device_fetch`."""
    return device_fetch(runner(*args))


def upload(a, device) -> torch.Tensor:
    """Host data (numpy, a list, a CPU tensor) onto ``device`` without
    waiting for the device's queue: through pinned memory, asynchronously,
    on CUDA. A tensor on a device is moved by ``.to`` (a no-op on
    ``device`` itself)."""
    device = torch.device(device)
    if isinstance(a, torch.Tensor) and a.device.type != "cpu":
        return a.to(device)
    t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
