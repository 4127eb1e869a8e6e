"""Device resolution for the port's entry points: CUDA unless the caller
asks for another device, and never a silent fallback to the CPU."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "on_cpu"]


def resolve_device(device=None) -> torch.device:
    """``None`` (or a config's ``"auto"``) -> the current CUDA device, or
    RuntimeError when there is none. An explicit device is returned as given
    (``"cpu"`` is how tests and CPU users ask for the plain versions)."""
    if device is None or device == "auto":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "wam_tpu_torch runs on CUDA by default and no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    return device


def on_cpu(t: torch.Tensor) -> bool:
    """Whether a kernel wrapper serves ``t`` with its plain version: True for
    a CPU tensor, False for a CUDA tensor (which goes to the kernel), and
    ValueError for any other device."""
    if t.is_cuda:
        return False
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}: the port runs on cuda or cpu")
    return True
