"""Device meshes: named axes over an array of devices (PyTorch port of
`wam_tpu.parallel.mesh`).

WAM has two embarrassingly parallel axes, the image batch and the
estimator's noise samples (or path points). The reference lays them over a
`jax.sharding.Mesh` and lets XLA place the work and insert the collectives.
Here a `Mesh` is a small object of the same shape: an array of
`torch.device`s with an axis name per dimension, ``.shape[axis]`` and
``.axis_names`` as in JAX. The runners of `parallel.sharded` and
`evalsuite.fan` walk its blocks and run each on its device; a
`PartitionSpec` (``P``) says which leading axis of a tensor is split over
which mesh axis (`Mesh.block`).

A device list may name one device several times: each entry is one block
of the mesh, so ``make_mesh({"data": 2, "sample": 5}, ["cuda:0"] * 10)``
runs ten blocks on one card, one after another, as the reference's tests
run an 8-device mesh on one CPU. A mesh built by `multihost.hybrid_mesh`
under an initialised process group also records which process owns each
block (``process_ids``); the blocks of other processes have no device here
(None).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from wam_tpu_torch.device import resolve_device

__all__ = ["make_mesh", "data_sample_mesh", "replica_mesh", "P", "PartitionSpec", "Mesh"]


class PartitionSpec(tuple):
    """The mesh axis each leading tensor axis is split over, in order (None:
    that axis is whole on every block), as `jax.sharding.PartitionSpec`."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """Named axes over an array of devices (module docstring).

    ``devices``: an object array of `torch.device`s (None for a block of
    another process), one dimension per name in ``axis_names``.
    ``process_ids``: None for a mesh of this process alone, else an int
    array of the same shape naming the rank that owns each block, and
    ``rank`` this process's."""

    def __init__(self, devices: np.ndarray, axis_names, process_ids=None, rank: int = 0):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"{devices.ndim}-D device array for axes {self.axis_names}")
        self.process_ids = process_ids
        self.rank = int(rank)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"

    def _index(self, coords: dict) -> tuple:
        unknown = set(coords) - set(self.axis_names)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; axes are {self.axis_names}")
        return tuple(int(coords.get(a, 0)) for a in self.axis_names)

    def device(self, **coords) -> torch.device | None:
        """The block's device at ``coords`` (axis name -> index, 0 for an
        axis not named)."""
        return self.devices[self._index(coords)]

    def owns(self, **coords) -> bool:
        """Whether this process runs the block at ``coords``."""
        return self.process_ids is None or int(self.process_ids[self._index(coords)]) == self.rank

    def local_devices(self) -> list[torch.device]:
        """The devices of this process's blocks, in mesh order."""
        return [self.devices[i] for i in np.ndindex(self.devices.shape) if self.owns(
            **dict(zip(self.axis_names, i)))]

    def block(self, t: torch.Tensor, spec: PartitionSpec, **coords) -> torch.Tensor:
        """The view of ``t`` that the block at ``coords`` holds under
        ``spec``: leading axis i split into ``shape[spec[i]]`` equal parts,
        part ``coords[spec[i]]`` taken (its size must divide)."""
        for i, axis in enumerate(spec):
            if axis is None:
                continue
            n = self.shape[axis]
            if t.shape[i] % n:
                raise ValueError(f"axis {i} of length {t.shape[i]} does not split over "
                                 f"{axis}={n}")
            step = t.shape[i] // n
            t = t.narrow(i, int(coords.get(axis, 0)) * step, step)
        return t


def _device(d) -> torch.device:
    """One mesh entry: ``resolve_device`` of it, a CUDA device without an
    index taking the current one."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_devices(devices=None) -> list[torch.device]:
    """``devices`` resolved, or every visible CUDA device when None
    (RuntimeError, `device.resolve_device`'s, when there is none)."""
    if devices is None:
        resolve_device(None)
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [_device(d) for d in devices]


def _device_array(devices, shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return arr.reshape(shape)


def make_mesh(axis_sizes: dict[str, int], devices=None) -> Mesh:
    """Build a Mesh with named axes from an {axis: size} mapping.

    The product of sizes must equal the device count (use -1 for one axis to
    infer it). ``devices`` None is every visible CUDA device; a list may
    repeat a device (one block per entry)."""
    devices = visible_devices(devices)
    sizes = dict(axis_sizes)
    unknown = [k for k, v in sizes.items() if v == -1]
    known = math.prod(v for v in sizes.values() if v != -1)
    if len(unknown) > 1:
        raise ValueError("At most one axis size may be -1")
    if unknown:
        if len(devices) % known:
            raise ValueError(f"{len(devices)} devices not divisible by {known}")
        sizes[unknown[0]] = len(devices) // known
    if math.prod(sizes.values()) != len(devices):
        raise ValueError(f"Mesh {sizes} does not match {len(devices)} devices")
    return Mesh(_device_array(devices, tuple(sizes.values())), tuple(sizes))


def replica_mesh(n_replicas: int, devices=None) -> Mesh:
    """1D ``('data',)`` mesh over the first ``n_replicas`` devices: the serve
    fleet's oversize mesh (`wam_tpu_torch.serve.fleet`), batch rows split
    across replicas, each replica's model whole on its device: data
    parallelism with no collective."""
    devices = visible_devices(devices)
    n = int(n_replicas)
    if not 1 <= n <= len(devices):
        raise ValueError(f"replica_mesh({n}) with {len(devices)} devices")
    return make_mesh({"data": n}, devices[:n])


def data_sample_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """Default 2D mesh for attribution workloads: ('data', 'sample').

    Splits the device count into the most square data×sample factorization,
    favoring the data axis.
    """
    devices = visible_devices(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    best_sample = 1
    for s in range(1, int(math.isqrt(n)) + 1):
        if n % s == 0:
            best_sample = s
    return make_mesh({"data": n // best_sample, "sample": best_sample}, devices)
