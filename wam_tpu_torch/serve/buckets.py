"""Shape bucketing for the serving runtime (a copy of
`wam_tpu.serve.buckets`: numpy only).

On the card, the first call of an entry at a new input shape is slow: cuDNN
picks its algorithms, the wavelet kernels' band plans are made, and the
caching allocator grows to the new working set. The dispatcher therefore
admits only a small fixed set of *bucket* shapes, decided at server
construction: every request is routed to the smallest bucket that fits it,
right-padded up to the bucket's spatial dims, and batches are always
dispatched at the bucket's full ``max_batch`` rows — so each bucket meets
its first call exactly once, at warmup.

Padding semantics:
- **Batch rows** are padded by REPLICATING the first real item. With the
  engines' default per-block max-normalization (`ops.packing2d.mosaic2d`),
  duplicate rows cannot move a block's max, so batch padding leaves real
  rows' attributions numerically unchanged for deterministic entries (the
  correctness property tests/test_torch_serve.py asserts). Zero rows would
  perturb the normalizer. Stochastic entries (SmoothGrad) draw noise per
  batch SHAPE, and every dispatch is the same full ``max_batch`` shape —
  so serving is deterministic given a request's row position, but it is a
  different (equally valid) noise realization than an unbatched call.
- **Spatial dims** are right/bottom zero-padded to the bucket. This changes
  the transform's boundary context, so a spatially padded attribution is
  the attribution *of the padded input* at the bucket's resolution — the
  standard serving trade (documented per bucket in the metrics as
  ``pad_waste``). Route exact shapes to exact buckets when parity with an
  unbatched call matters.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Bucket", "BucketTable", "NoBucketError", "bucket_key", "pad_item"]


def bucket_key(shape) -> str:
    """Stable string form of a bucket shape — "1x224x224" — the same
    grammar `config.ServeConfig.buckets` parses. Used as the JSON-safe key
    of the per-bucket ledger maps (`serve.metrics` EMA / warmup seconds)."""
    return "x".join(str(int(s)) for s in shape)


class NoBucketError(ValueError):
    """No configured bucket admits the request's shape — a permanent
    condition for this server (unlike `QueueFullError`, retrying cannot
    help)."""


@dataclass(frozen=True, order=True)
class Bucket:
    """One compiled item shape (no batch dim; e.g. (C, H, W) for images,
    (W,) for waveforms, (1, D, H, W) for volumes). Ordering is by padded
    element count so `BucketTable.select` prefers the least-waste fit."""

    elements: int
    shape: tuple[int, ...]

    @classmethod
    def of(cls, shape) -> "Bucket":
        shape = tuple(int(s) for s in shape)
        return cls(int(np.prod(shape)) if shape else 1, shape)

    @property
    def key(self) -> str:
        return bucket_key(self.shape)

    def fits(self, item_shape: tuple[int, ...]) -> bool:
        return len(item_shape) == len(self.shape) and all(
            s <= b for s, b in zip(item_shape, self.shape)
        )

    def pad_waste(self, item_shape: tuple[int, ...]) -> float:
        """Fraction of this bucket's elements that padding ``item_shape``
        up to it would waste (0.0 for an exact fit)."""
        return 1.0 - float(np.prod(item_shape)) / self.elements


class BucketTable:
    """The fixed admitted-shape set. ``select`` returns the smallest (by
    element count) bucket whose every dim >= the item's — i.e. minimal pad
    waste among fitting buckets — or raises `NoBucketError`."""

    def __init__(self, shapes):
        if not shapes:
            raise ValueError("at least one bucket shape is required")
        self.buckets = sorted(Bucket.of(s) for s in shapes)
        if len({b.shape for b in self.buckets}) != len(self.buckets):
            raise ValueError("duplicate bucket shapes")

    def select(self, item_shape) -> Bucket:
        item_shape = tuple(int(s) for s in item_shape)
        for b in self.buckets:
            if b.fits(item_shape):
                return b
        raise NoBucketError(
            f"no bucket fits item shape {item_shape}; "
            f"buckets: {[b.shape for b in self.buckets]}"
        )

    def __iter__(self):
        return iter(self.buckets)

    def __len__(self):
        return len(self.buckets)


def pad_item(x: np.ndarray, bucket: Bucket) -> np.ndarray:
    """Right/bottom zero-pad one item up to the bucket shape (host-side, so
    the padded batch assembles into one contiguous transfer)."""
    if x.shape == bucket.shape:
        return x
    widths = [(0, b - s) for s, b in zip(x.shape, bucket.shape)]
    return np.pad(x, widths)
