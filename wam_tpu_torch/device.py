"""Device resolution for the port's entry points: CUDA unless the caller
asks for another device, and never a silent fallback to the CPU."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device, or RuntimeError when there is
    none. An explicit device is returned as given (``"cpu"`` is how tests and
    CPU users ask for the plain versions)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "wam_tpu_torch runs on CUDA by default and no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    return device
