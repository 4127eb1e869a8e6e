"""Double-buffered host→device staging (PyTorch port of
`wam_tpu.pipeline.stager`).

A batch loop that interleaves host work (decode, `np.stack`, padding) with
a synchronous upload puts batch *k*'s host time and transfer in front of
batch *k*'s compute. `put_committed` makes the upload asynchronous: each
host leaf is written into pinned (page-locked) host memory and copied to
the card with ``non_blocking=True`` on a side stream of the device, so the
copy overlaps whatever the compute stream is running. The compute stream
(the caller's current stream) waits on an event recorded after the copy —
the GPU orders the two, the host never waits — and `Tensor.record_stream`
tells the caching allocator that the compute stream uses the staged
buffer, so the allocator does not hand its memory to another tensor until
the compute stream's work on it is done. The pinned host buffers come from
PyTorch's caching host allocator, which keeps each until its copy has
finished.

`stage_to_device` / `DeviceStager` move the host side off the consumer's
critical path too: a producer thread pulls from the host iterator and
stages each batch, parking up to ``depth`` staged batches in a bounded
queue (``depth=2`` is double buffering).

Consumers: the serve dispatcher's assemble stage (`serve/runtime.py`
stages each padded batch before dispatch) and any batch loop.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from wam_tpu_torch.obs import tracing as _obs_tracing
from wam_tpu_torch.obs.registry import registry as _registry

__all__ = ["put_committed", "stage_to_device", "DeviceStager"]

_DONE = object()

_h2d_bytes = _registry.counter(
    "wam_tpu_stager_h2d_bytes_total",
    "host->device bytes staged through put_committed")

_side_streams: dict = {}
_side_lock = threading.Lock()


def _side_stream(device: torch.device):
    """The copy stream of a CUDA device (one per device and process)."""
    with _side_lock:
        stream = _side_streams.get(device.index)
        if stream is None:
            stream = _side_streams[device.index] = torch.cuda.Stream(device)
        return stream


def _host_leaves(tree) -> list:
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _host_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _host_leaves(v)]
    return []


def _map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _stage_leaf(leaf, device: torch.device, copy_stream, compute_stream):
    if isinstance(leaf, torch.Tensor) and leaf.device == device:
        return leaf
    if device.type != "cuda":
        return torch.as_tensor(leaf).to(device)
    host = torch.as_tensor(leaf)
    if host.device.type != "cpu":
        return host.to(device)  # another card: a device-to-device copy
    if not host.is_pinned():
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        host = pinned
    with torch.cuda.stream(copy_stream):
        staged = host.to(device, non_blocking=True)
    staged.record_stream(compute_stream)
    return staged


def put_committed(tree, device=None):
    """Stage a batch tree (numpy arrays or tensors, in a tuple, list or dict;
    None leaves stay None) onto ``device``: asynchronously through pinned
    memory on the device's copy stream for a card, with the caller's current
    stream made to wait for the copy (module docstring); a plain
    `torch.as_tensor` for the CPU (no copy of a contiguous numpy array).
    ``device=None`` is `device.resolve_device(None)`: the card, or
    RuntimeError. When observability is on, the staged leaves' host-side
    bytes land on the H2D counter and the memory module's staged-bytes
    gauge (no device sync)."""
    from wam_tpu_torch.device import resolve_device

    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if _obs_tracing._STATE.enabled:
        n = sum(int(getattr(leaf, "nbytes", 0)) if isinstance(leaf, np.ndarray)
                else leaf.numel() * leaf.element_size() for leaf in _host_leaves(tree))
        if n:
            _h2d_bytes.inc(n)
            from wam_tpu_torch.obs import memory as _obs_memory

            _obs_memory.note_staged(n)
    if device.type != "cuda":
        return _map(lambda leaf: _stage_leaf(leaf, device, None, None), tree)
    copy_stream = _side_stream(device)
    compute_stream = torch.cuda.current_stream(device)
    staged = _map(lambda leaf: _stage_leaf(leaf, device, copy_stream, compute_stream), tree)
    done = torch.cuda.Event()
    done.record(copy_stream)
    compute_stream.wait_event(done)
    return staged


class DeviceStager:
    """Iterator over ``batches`` with each item already staged on
    ``device``.

    A daemon producer thread runs the host iterator and stages every batch
    via `put_committed`; the bounded queue (``depth`` slots) is the double
    buffer. Exceptions from the host iterator (and `StopIteration`) are
    forwarded to the consumer in order. `close()` (also wired to context
    exit) stops the producer without draining the host iterator. The
    producer's current stream is the device's default stream, as the
    consumer's is unless it set another: the wait is enqueued there.
    """

    def __init__(self, batches: Iterable[Any], *, depth: int = 2, device=None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        from wam_tpu_torch.device import resolve_device

        device = resolve_device(device)
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._produce,
            args=(iter(batches), device),
            name="wam-device-stager",
            daemon=True,
        )
        self._thread.start()

    def _produce(self, it: Iterator[Any], device) -> None:
        try:
            for item in it:
                staged = put_committed(item, device)
                while not self._stop.is_set():
                    try:
                        self._queue.put(staged, timeout=0.05)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            payload = _DONE
        except BaseException as exc:  # forwarded, not swallowed
            payload = exc
        while not self._stop.is_set():
            try:
                self._queue.put(payload, timeout=0.05)
                return
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._queue.get()
        if item is _DONE:
            self.close()
            raise StopIteration
        if isinstance(item, BaseException):
            self.close()
            raise item
        return item

    def close(self) -> None:
        """Stop the producer; staged-but-unconsumed batches are dropped."""
        self._stop.set()
        # unblock a producer parked on a full queue
        try:
            self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def stage_to_device(batches: Iterable[Any], *, depth: int = 2, device=None):
    """Generator convenience over `DeviceStager` — guarantees the producer
    thread is shut down when the loop ends, breaks, or raises."""
    stager = DeviceStager(batches, depth=depth, device=device)
    try:
        yield from stager
    finally:
        stager.close()
