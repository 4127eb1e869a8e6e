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

__all__ = ["FanPlan", "plan_fan", "fan_chunk_geometry", "cast_model_fn",
           "make_chunked_forward", "check_ported", "fan_runner", "run_fan", "device_fetch",
           "fetch_count", "reset_fetch_count", "fetch_scope", "upload", "AUTO_CAP"]

# rows a model call when batch_size="auto": the reference's own fallback
# (the port has no tuned cap yet)
AUTO_CAP = 128


# -- the single result fetch --------------------------------------------------

_FETCH_COUNT = 0
_fetch_tls = threading.local()  # per-thread stack of live fetch_scopes


def _to_host(out):
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    if isinstance(out, (tuple, list)):
        return type(out)(_to_host(o) for o in out)
    return out


def device_fetch(out):
    """THE result fetch: the whole result (a tensor, or a tuple or list of
    them) copied to the host as numpy. Every fan metric's device-to-host
    transfer goes through here, counted by `fetch_scope` and `fetch_count`."""
    global _FETCH_COUNT
    _FETCH_COUNT += 1
    for scope in getattr(_fetch_tls, "scopes", ()):
        scope._count += 1
    return _to_host(out)


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


def plan_fan(batch_size, fan: int, *, fan_dtype: str | None = None) -> FanPlan:
    """The fan geometry of one metric call: an int ``batch_size`` is the cap;
    ``"auto"`` is `AUTO_CAP` (the reference consults its tuned schedule
    cache first; the port has none yet). ``fan_dtype`` None resolves through
    `config.resolve_precision` (the ``WAM_TPU_FAN_DTYPE`` knob, then f32)."""
    cap = AUTO_CAP if batch_size == "auto" else int(batch_size)
    images_per_chunk, fan_chunk = fan_chunk_geometry(cap, fan)
    return FanPlan(cap, images_per_chunk, fan_chunk,
                   resolve_precision(fan_dtype=fan_dtype).fan_dtype)


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


def check_ported(*, mesh=None, donate: bool | None = None, aot_key: str | None = None) -> None:
    """Raise NotImplementedError for the reference's dispatch options that
    are not ported yet: ``mesh=`` (its shard_map path), ``aot_key=`` (its
    executable cache) and ``donate=True`` (it donates on the TPU only, so
    None and False mean the same here)."""
    if mesh is not None:
        raise NotImplementedError("mesh= is not ported yet (ROADMAP.md, slice E)")
    if aot_key is not None:
        raise NotImplementedError("aot_key= is not ported yet (ROADMAP.md, slice E)")
    if donate:
        raise NotImplementedError("donate_inputs=True is not ported yet (ROADMAP.md, slice E)")


def fan_runner(body, *, mesh=None, donate: bool | None = None, aot_key: str | None = None):
    """The dispatch every fan step goes through: ``body`` run under
    ``torch.no_grad()`` (`check_ported` for the options)."""
    check_ported(mesh=mesh, donate=donate, aot_key=aot_key)

    def run(*args):
        with torch.no_grad():
            return body(*args)

    return run


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
