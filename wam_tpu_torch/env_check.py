"""Environment verification (PyTorch port of `wam_tpu.env_check`): the
dependency stack, the device, the kernels' build and a tiny end-to-end
attribution.

    python -m wam_tpu_torch.env_check [--device cuda|cpu]

On the card (the default: without one it reports FAIL) it builds every kernel
(`kernels.build_all`) and runs a 32² db2 J=2 SmoothGrad attribution whose
transforms go through K1 and K3 (their launches counted and checked); with
``--device cpu`` the same attribution runs on the kernels' plain versions,
and nothing is built. Exits 0 when every check passes.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

# what the port cannot run without; everything else is optional
# (`wam_tpu_torch.optional`), and absent on a card machine
CORE_DEPS = ["torch", "numpy", "scipy", "einops"]
OPTIONAL_DEPS = ["matplotlib", "PIL", "h5py", "pandas"]


def check_imports() -> tuple[list[str], list[str]]:
    """(missing core packages, missing optional packages)."""
    def missing(mods):
        out = []
        for mod in mods:
            try:
                __import__(mod)
            except Exception:
                out.append(mod)
        return out

    return missing(CORE_DEPS), missing(OPTIONAL_DEPS)


def device_line(device: str) -> str:
    """The device the checks run on: the card's name, the card count and
    its power limit from ``nvidia-smi``, or the CPU."""
    import torch

    if device != "cuda":
        return f"cpu (torch {torch.__version__})"
    limit = "power limit unknown"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        limit = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return (f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)} ({limit}); "
            f"torch {torch.__version__}, CUDA {torch.version.cuda}")


def check_wam(device: str) -> dict:
    """A DWT round trip and a 32² db2 J=2 SmoothGrad attribution on a tiny
    seeded model; on the card the kernels are built first and K1/K3 must
    launch. Returns the kernels' launch counts."""
    import torch

    from wam_tpu_torch import WaveletAttribution2D, kernels, wavedec2, waverec2

    if device == "cuda":
        kernels.build_all()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((1, 3, 32, 32), generator=gen).to(device)
    rec = waverec2(wavedec2(x, "db2", 2), "db2")[..., :32, :32]
    err = float((rec - x).abs().max())
    if err > 1e-3:
        raise AssertionError(f"DWT round trip off by {err:.3e}")
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.ReLU(),
                                torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(),
                                torch.nn.Linear(4, 4)).to(device).eval()
    expl = WaveletAttribution2D(model, wavelet="db2", J=2, n_samples=2, device=device,
                                impl="kernel")
    kernels.reset_launch_counts()
    out = expl(x, torch.tensor([1], device=device))
    counts = kernels.launch_counts()
    if out.shape[0] != 1 or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"attribution of shape {tuple(out.shape)}, finite "
                             f"{bool(torch.isfinite(out).all())}")
    if device == "cuda" and not (counts["dwt2"] > 0 and counts["pair"] > 0):
        raise AssertionError(f"K1/K3 did not launch on the card: {counts}")
    return counts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m wam_tpu_torch.env_check",
                                description="Check the stack, the device and one attribution.")
    p.add_argument("--device", default="auto",
                   help="auto (the card; FAIL without one) | cuda | cpu")
    args = p.parse_args(argv)
    core, optional = check_imports()
    if core:
        print(f"FAIL: missing imports: {core}")
        return 1
    if optional:
        print(f"optional packages not installed (their functions raise ImportError): {optional}")
    from wam_tpu_torch.device import resolve_device

    try:
        device = resolve_device(args.device).type
    except RuntimeError as e:
        print(f"FAIL: {e}")
        return 1
    print(f"device: {device_line(device)}")
    try:
        counts = check_wam(device)
    except Exception as e:  # noqa: BLE001 - report any failure of the drive
        print(f"FAIL: end-to-end attribution: {type(e).__name__}: {e}")
        return 1
    print(f"OK: imports, device, DWT round trip, end-to-end attribution (kernel launches "
          f"{counts})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
