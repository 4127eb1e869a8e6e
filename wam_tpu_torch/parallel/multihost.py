"""Multi-process execution: `torch.distributed` bootstrap and meshes that
span processes (PyTorch port of `wam_tpu.parallel.multihost`).

The reference connects one process per host with `jax.distributed` and
lays a hybrid mesh whose outer axis crosses hosts. Here `init_distributed`
is `torch.distributed.init_process_group` (NCCL for CUDA devices, gloo for
the CPU) with the reference's bounded connect attempts, and `hybrid_mesh`
lays one axis (``dcn_axis``) across the processes, each process's own
devices forming its slice. The sharded runners (`parallel.sharded`) run
only this process's blocks of such a mesh and sum across processes with
one ``all_reduce``.

NCCL takes one card per rank: two ranks on one card are refused
("Duplicate GPU detected"), so a one-card machine runs its multi-process
path under gloo on the CPU, or a group of one rank.

Single-process use is unchanged: with no process group every helper is the
local one (`make_mesh`, one process).
"""

from __future__ import annotations

import atexit
import datetime
import math
import os
import time

import numpy as np
import torch

from wam_tpu_torch.device import resolve_device
from wam_tpu_torch.parallel.mesh import Mesh, make_mesh, visible_devices

__all__ = ["CoordinatorConnectError", "init_distributed", "hybrid_mesh",
           "process_local_batch"]


class CoordinatorConnectError(RuntimeError):
    """Could not reach the process group's coordinator within the retry
    budget. The message names the coordinator address and the attempts
    made: a bring-up that fails here fails diagnosable, not as a hang."""


def _dist():
    import torch.distributed as dist

    return dist


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def _process_count() -> int:
    """Ranks of the process group, 1 without one."""
    return _dist().get_world_size() if _initialized() else 1


def _process_index() -> int:
    """This process's rank, 0 without a process group."""
    return _dist().get_rank() if _initialized() else 0


def _initialize_with_retries(init_method: str, label: str, connect_attempts: int,
                             connect_backoff_s: float, **kwargs) -> None:
    """`init_process_group` with bounded attempts and linear backoff;
    exhaustion raises `CoordinatorConnectError` naming the address. An
    already-initialised group passes as success."""
    dist = _dist()
    last: Exception | None = None
    for attempt in range(1, max(1, connect_attempts) + 1):
        if dist.is_initialized():
            return
        try:
            dist.init_process_group(init_method=init_method, **kwargs)
            return
        except (RuntimeError, TimeoutError, OSError, ValueError) as exc:
            last = exc
            if attempt < connect_attempts:
                time.sleep(connect_backoff_s * attempt)
    raise CoordinatorConnectError(
        f"could not connect to the torch.distributed coordinator at {label} after "
        f"{connect_attempts} attempt(s) (backoff {connect_backoff_s:g}s/attempt): {last!r}"
    ) from last


def _info() -> dict:
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {
        "process_index": _process_index(),
        "process_count": _process_count(),
        "local_devices": local,
        "global_devices": local * _process_count(),
    }


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    initialization_timeout: float | None = None,
    connect_attempts: int = 3,
    connect_backoff_s: float = 2.0,
    device=None,
) -> dict:
    """Connect this process to its process group.

    ``coordinator_address`` ("host:port", rank 0 listens there; or a
    ``file://`` path on a file system every rank shares, a rendezvous no
    other process can take between choosing it and binding it),
    ``num_processes`` and ``process_id`` start a group explicitly; with none
    of them, a launcher's environment (``WORLD_SIZE`` above 1, with
    ``MASTER_ADDR``/``MASTER_PORT``, as torchrun sets) starts one, and a
    single process with no launcher environment is a no-op. ``device``: the
    collectives' device, CUDA (NCCL) unless the caller asks for the CPU
    (gloo). Connecting is bounded: ``connect_attempts`` tries with
    ``connect_backoff_s``-linear backoff, each waiting at most
    ``initialization_timeout`` seconds, then `CoordinatorConnectError`.
    Returns {"process_index", "process_count", "local_devices",
    "global_devices"} (local devices: the visible CUDA devices, 1 without
    any). The group is destroyed when the interpreter exits, as
    ``jax.distributed`` shuts down at exit: a process that ends with its
    group alive can abort in teardown ("terminate called without an active
    exception") while its communication threads still run."""
    env_world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    explicit = coordinator_address is not None or num_processes not in (None, 1)
    if not explicit and env_world <= 1:
        return _info()
    backend = "gloo" if resolve_device(device).type == "cpu" else "nccl"
    kwargs = {"backend": backend}
    if initialization_timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(initialization_timeout))
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("an explicit process group needs coordinator_address, "
                             "num_processes and process_id")
        method = (coordinator_address if coordinator_address.startswith("file://")
                  else f"tcp://{coordinator_address}")
        _initialize_with_retries(method, coordinator_address, connect_attempts,
                                 connect_backoff_s, world_size=int(num_processes),
                                 rank=int(process_id), **kwargs)
    else:
        label = (f"{os.environ.get('MASTER_ADDR', '<unset>')}:"
                 f"{os.environ.get('MASTER_PORT', '<unset>')}")
        _initialize_with_retries("env://", label, connect_attempts, connect_backoff_s, **kwargs)
    global _shutdown_registered
    if not _shutdown_registered:
        atexit.register(_shutdown)
        _shutdown_registered = True
    return _info()


_shutdown_registered = False


def _shutdown() -> None:
    """Destroy the process group if one is alive (at interpreter exit)."""
    if _initialized():
        _dist().destroy_process_group()


def hybrid_mesh(
    axis_sizes: dict[str, int],
    dcn_axis: str | None = None,
    devices=None,
) -> Mesh:
    """Mesh over every process's devices with one axis across processes.

    ``devices`` are this process's (None: every visible CUDA device); every
    process must bring as many. ``dcn_axis`` (default: the first axis) is
    laid across the processes, rank r holding its r-th equal part, so every
    other axis stays within a process. The mesh records each block's rank
    (`Mesh.process_ids`); other ranks' blocks have no device here. Without
    a process group this is exactly ``make_mesh``. Use -1 for one axis size
    to infer it from the global device count.
    """
    devices = visible_devices(devices)
    n_proc = _process_count()
    sizes = dict(axis_sizes)
    unknown = [k for k, v in sizes.items() if v == -1]
    if unknown:
        known = math.prod(v for v in sizes.values() if v != -1)
        total = len(devices) * n_proc
        if len(unknown) > 1 or total % known:
            raise ValueError(f"cannot infer {unknown} from {total} devices")
        sizes[unknown[0]] = total // known
    if not _initialized():
        return make_mesh(sizes, devices)

    dcn_axis = dcn_axis or next(iter(sizes))
    if sizes[dcn_axis] % n_proc:
        raise ValueError(
            f"DCN axis {dcn_axis!r}={sizes[dcn_axis]} not divisible by "
            f"{n_proc} processes"
        )
    names = tuple(sizes)
    k = names.index(dcn_axis)
    local_shape = tuple(sizes[a] // n_proc if a == dcn_axis else sizes[a] for a in names)
    if math.prod(local_shape) != len(devices):
        raise ValueError(f"Mesh {sizes} over {n_proc} processes needs "
                         f"{math.prod(local_shape)} devices a process, got {len(devices)}")
    rank = _process_index()
    local = make_mesh(dict(zip(names, local_shape)), devices).devices
    empty = np.empty(local_shape, dtype=object)  # another rank's slice: no device here
    parts = [local if r == rank else empty for r in range(n_proc)]
    owner = [np.full(local_shape, r) for r in range(n_proc)]
    return Mesh(np.concatenate(parts, axis=k), names,
                process_ids=np.concatenate(owner, axis=k), rank=rank)


def process_local_batch(global_batch: int) -> int:
    """Per-process batch size for a data-parallel input pipeline: each
    process feeds only its share of the global batch."""
    n = _process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n
