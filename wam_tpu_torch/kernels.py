"""Builds, loads and launches the port's hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` (Hopper) into
its own shared library under ``build/wam_tpu_torch/`` at the repository root,
at first use, and loaded with ``ctypes``. The library name carries a hash of
the sources, so an edited kernel is rebuilt and a stale one is never loaded.

| kernel  | source          | replaces (TPU kernel)                            |
|---------|-----------------|--------------------------------------------------|
| ``dwt2``| ``csrc/dwt2.cu``| ``wam_tpu/wavelets/matmul.py::_fused_kernel`` (K1)|
| ``pair``| ``csrc/pair.cu``| ``wam_tpu/wavelets/matmul.py::_pair_kernel`` (K3) |

The launch wrappers take CUDA tensors only: they check device, dtype, shape
and contiguity, allocate the output with ``torch.empty``, launch on the
current stream and raise when the launch fails. Each counts its launches in
``KERNELS[name].launches`` (one per launch, nowhere else). Nothing here runs
on the CPU: the plain PyTorch versions live beside their callers in
`wam_tpu_torch.wavelets.matmul`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["KERNELS", "build_all", "dwt2", "pair", "launch_counts",
           "reset_launch_counts", "nvcc_command"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "wam_tpu_torch"
_HEADERS = ("mm2.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Largest S (columns of X) whose row strip fits the 227 KB of shared memory a
# block may use: (kChunk + S) * kRows * 4 bytes, kChunk = 64, kRows = 16.
MAX_INNER = 227 * 1024 // (16 * 4) - 64
_MAX_DIM = 2**31 - 1

_P = ctypes.c_void_p
_I = ctypes.c_int
# (x, m1t, m2, out, N, P, Q, S, T, stream) -> cudaError_t, on the current device
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]


class Kernel:
    """One CUDA source, its shared library and its launch count."""

    def __init__(self, name: str, source: str, symbols: tuple[str, ...]):
        self.name = name
        self.source = _CSRC / source
        self.symbols = symbols
        self.launches = 0
        self._lib = None

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for p in (self.source, *(_CSRC / s for s in _HEADERS)):
            h.update(p.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def fn(self, symbol: str):
        if self._lib is None:
            path = self.library_path()
            if not path.exists():
                build_all([self])
            lib = ctypes.CDLL(str(path))
            for s in self.symbols:
                f = getattr(lib, s)
                f.argtypes = _ARGTYPES
                f.restype = ctypes.c_int
            self._lib = lib
        return getattr(self._lib, symbol)


KERNELS = {
    "dwt2": Kernel("dwt2", "dwt2.cu", ("wam_dwt2_f32", "wam_dwt2_bf16")),
    "pair": Kernel("pair", "pair.cu", ("wam_pair_f32",)),
}


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH): "
            "the CUDA kernels of wam_tpu_torch are built from source at first use")
    return found


def nvcc_command(kernel: Kernel, out: Path, nvcc: str = "nvcc") -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(out), str(kernel.source)]


def build_all(kernels=None) -> dict[str, dict]:
    """Compile every kernel whose library is missing, one ``nvcc`` per source,
    all started together. Returns {name: {"seconds", "log"}} for the kernels
    built (``log`` holds ptxas's register and shared-memory report)."""
    kernels = list(KERNELS.values()) if kernels is None else list(kernels)
    todo = [k for k in kernels if not k.library_path().exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    running = []
    for k in todo:
        final = k.library_path()
        tmp = final.with_name(f"{final.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(nvcc_command(k, tmp, nvcc), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((k, proc, tmp, final))
    report, failed = {}, []
    for k, proc, tmp, final in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{k.source.name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, final)  # atomic: a concurrent loader never sees half a file
        report[k.name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def _check(t: torch.Tensor, name: str, dtypes, ndim: int, device) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got device {t.device}); "
                         "the plain PyTorch version serves CPU tensors")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(kernel: Kernel, symbol: str, x, m1t, m2, out_shape) -> torch.Tensor:
    dev = x.device
    _check(x, "x", (torch.float32, torch.bfloat16), 3, dev)
    _check(m1t, "m1t", (torch.float32,), 2, dev)
    _check(m2, "m2", (torch.float32,), 2, dev)
    n, q, s = x.shape
    if m1t.shape[0] != q or m2.shape[0] != s:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, m1t {tuple(m1t.shape)}, "
                         f"m2 {tuple(m2.shape)}")
    p, t = m1t.shape[1], m2.shape[1]
    if s > MAX_INNER:
        raise ValueError(f"{kernel.name}: inner side {s} exceeds the shared-memory "
                         f"strip limit {MAX_INNER}")
    if max(n * q * s, n * p * t, q * p, s * t) > _MAX_DIM:
        raise ValueError(f"{kernel.name}: tensor too large for int32 sides")
    out = torch.empty(out_shape, device=dev, dtype=torch.float32)
    if n == 0:
        return out
    launcher = kernel.fn(symbol)
    with torch.cuda.device(dev):  # the caller's current device is restored on exit
        err = launcher(x.data_ptr(), m1t.data_ptr(), m2.data_ptr(), out.data_ptr(),
                       n, p, q, s, t, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel.name} kernel launch failed: cudaError_t {err}")
    kernel.launches += 1
    return out


def dwt2(x3: torch.Tensor, a_t: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """K1: (N, H, W) f32/bf16 -> (N, 4, h', w') f32 with
    [[aa, ad], [da, dd]] = A . x . B^T; ``a_t`` = A^T (H, 2h'), ``bt`` = B^T
    (W, 2w'), both contiguous float32."""
    n = x3.shape[0]
    h2, w2 = a_t.shape[-1], bt.shape[-1]
    if h2 % 2 or w2 % 2:
        raise ValueError(f"analysis operators must have even output sides, got {h2}, {w2}")
    symbol = "wam_dwt2_bf16" if x3.dtype == torch.bfloat16 else "wam_dwt2_f32"
    return _launch(KERNELS["dwt2"], symbol, x3, a_t, bt, (n, 4, h2 // 2, w2 // 2))


def pair(y3: torch.Tensor, m1t: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """K3: (N, Q, S) f32 -> (N, P, T) f32, out[n] = m1t^T . y3[n] . m2."""
    if y3.dtype != torch.float32:
        raise TypeError(f"pair kernel takes float32, got {y3.dtype}")
    return _launch(KERNELS["pair"], "wam_pair_f32", y3, m1t, m2,
                   (y3.shape[0], m1t.shape[1], m2.shape[1]))
