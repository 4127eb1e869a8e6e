"""Mosaic packing (PyTorch port of `wam_tpu.ops`)."""

from wam_tpu_torch.ops.packing2d import (
    disentangle_scales,
    mosaic2d,
    mosaic_size,
    reproject_mosaic,
)

__all__ = ["mosaic2d", "mosaic_size", "reproject_mosaic", "disentangle_scales"]
