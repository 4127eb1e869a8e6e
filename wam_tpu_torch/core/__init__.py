"""Gradient engine and estimators (PyTorch port of `wam_tpu.core`)."""

from wam_tpu_torch.core.engine import WamEngine, target_loss
from wam_tpu_torch.core.estimators import integrated_path, noise_sigma, smoothgrad, trapezoid

__all__ = [
    "WamEngine",
    "target_loss",
    "smoothgrad",
    "integrated_path",
    "noise_sigma",
    "trapezoid",
]
