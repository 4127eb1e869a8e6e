"""Builds, loads and launches the port's hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` (Hopper) into
its own shared library under ``build/wam_tpu_torch/`` at the repository root,
at first use, and loaded with ``ctypes``. The library name carries a hash of
the sources, so an edited kernel is rebuilt and a stale one is never loaded.

| kernel      | source               | replaces (TPU kernel)                                   |
|-------------|----------------------|---------------------------------------------------------|
| ``dwt2``    | ``csrc/dwt2.cu``     | ``wam_tpu/wavelets/matmul.py::_fused_kernel`` (K1)      |
| ``synth2``  | ``csrc/synth2.cu``   | ``wam_tpu/wavelets/matmul.py::_fused_synth_kernel`` (K2)|
| ``pair``    | ``csrc/pair.cu``     | ``wam_tpu/wavelets/matmul.py::_pair_kernel`` (K3)       |
| ``relu_fwd``| ``csrc/relu_mask.cu``| ``wam_tpu/tune/fused_relu.py::_fwd_kernel`` (K4)        |
| ``relu_bwd``| ``csrc/relu_mask.cu``| ``wam_tpu/tune/fused_relu.py::_bwd_kernel`` (K5)        |

K1 and K2 share the banded two-sided product of ``csrc/band2.cuh``, which
takes its operators as a `BandPlan` (built by `wam_tpu_torch.wavelets.matmul`);
K3 runs the per-level banded products of ``csrc/collapsed.cuh`` on a
`PairPlan`, reading the coefficient leaves where they lie; K4 and K5 share one
library. The launch wrappers take CUDA tensors only: they check device, dtype,
shape and layout, allocate the outputs with ``torch.empty``,
launch on the current stream and raise when the launch fails. Each counts
its launches in ``KERNELS[name].launches`` (one per launch, nowhere else;
under a lock, since a fleet's replicas launch from several threads).
Nothing here runs on the CPU: the plain PyTorch versions live beside their
callers in `wam_tpu_torch.wavelets.matmul` and `wam_tpu_torch.tune.fused_relu`.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch

__all__ = ["KERNELS", "BandPlan", "PairLevel", "PairPlan", "pair_plan", "build_all", "dwt2",
           "synth2", "pair", "pair_bwd", "relu_fwd", "relu_bwd", "band_smem_bytes", "launch_counts",
           "reset_launch_counts", "nvcc_command", "build_lock"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "wam_tpu_torch"
_HEADERS = ("band2.cuh", "collapsed.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Shared memory a block may use on an H100 (the opt-in maximum).
MAX_SMEM = 227 * 1024
MAX_THREADS = 512  # threads of a block (band2.cuh's kMaxThreads, collapsed.cuh's)
# K3 (collapsed.cuh): collapsed levels at most, output rows a forward thread
# sums in registers, threads of a backward block.
MAX_LEVELS, PAIR_ROWS_PER_THREAD, PAIR_BWD_THREADS = 8, 16, 256
_MAX_DIM = 2**31 - 1

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# Every entry point returns cudaError_t and launches on the current device.
# collapsed.cuh (K3): (leaves, plans, out, N, P, T, stream) forward,
# (g, grads, plans, N, P, T, stream) backward; leaves and plans by reference
_PAIR_ARGS = (_P, _P, _P, _I, _I, _I, _P)
# band2.cuh kernels: (x, out, plan, kc, N, Q, S, P, T, ntiles, rt, sm, k, tp,
# odd_off, ts_stride, stages, cols_shared, stream)
_BAND_ARGS = (_P, _P, _P) + (_I,) * 15 + (_P,)
# relu_mask.cu: (x, y, m, n, stream) forward, (m, g, dx, n, stream) backward
_RELU_ARGS = (_P, _P, _P, _L, _P)


class Kernel:
    """One kernel: its CUDA source, the entry points it uses in the source's
    shared library (with their ctypes argument types) and its launch count.
    Kernels of one source share one library."""

    def __init__(self, name: str, source: str, symbols: tuple[str, ...], argtypes):
        self.name = name
        self.source = _CSRC / source
        self.symbols = symbols
        self.argtypes = list(argtypes)
        self.launches = 0
        self._lib = None

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for p in (self.source, *(_CSRC / s for s in _HEADERS)):
            h.update(p.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.source.stem}-{h.hexdigest()[:16]}.so"

    def fn(self, symbol: str):
        if self._lib is None:
            path = self.library_path()
            if not path.exists():
                build_all([self])
            lib = ctypes.CDLL(str(path))
            for s in self.symbols:
                f = getattr(lib, s)
                f.argtypes = self.argtypes
                f.restype = ctypes.c_int
            self._lib = lib
        return getattr(self._lib, symbol)


KERNELS = {
    "dwt2": Kernel("dwt2", "dwt2.cu", ("wam_dwt2_f32", "wam_dwt2_bf16"), _BAND_ARGS),
    "synth2": Kernel("synth2", "synth2.cu", ("wam_synth2_f32", "wam_synth2_bf16"), _BAND_ARGS),
    "pair": Kernel("pair", "pair.cu", ("wam_pair_fwd_f32", "wam_pair_bwd_f32"), _PAIR_ARGS),
    "relu_fwd": Kernel("relu_fwd", "relu_mask.cu", ("wam_relu_fwd_f32", "wam_relu_fwd_bf16"),
                       _RELU_ARGS),
    "relu_bwd": Kernel("relu_bwd", "relu_mask.cu", ("wam_relu_bwd_f32", "wam_relu_bwd_bf16"),
                       _RELU_ARGS),
}


_COUNT_LOCK = threading.Lock()


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
    """Compile every library that is missing, one ``nvcc`` per source, all
    started together. Returns {source name: {"seconds", "log"}} for the
    libraries built (``log`` holds ptxas's register and shared-memory
    report)."""
    kernels = list(KERNELS.values()) if kernels is None else list(kernels)
    if all(k.library_path().exists() for k in kernels):
        return {}
    with build_lock():
        return _build_missing(kernels)


@contextlib.contextmanager
def build_lock():
    """One build at a time across processes (pod workers or test workers
    starting together on a fresh checkout): the others wait here and then
    find the libraries. The kernels and `wam_tpu_torch.native` share it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build_missing(kernels) -> dict[str, dict]:
    todo = list({k.library_path(): k for k in kernels
                 if not k.library_path().exists()}.values())
    if not todo:
        return {}
    nvcc = _nvcc()
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
        report[k.source.stem] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def _check(t: torch.Tensor, name: str, dtypes, ndim: int | None, device) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got device {t.device}); "
                         "the plain PyTorch version serves CPU tensors")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _call(kernel: Kernel, symbol: str, dev, *args) -> None:
    """Launch ``symbol`` on ``dev``'s current stream, raise if the launch
    failed, count it."""
    launcher = kernel.fn(symbol)
    with torch.cuda.device(dev):  # the caller's current device is restored on exit
        err = launcher(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel.name} kernel launch failed: cudaError_t {err}")
    with _COUNT_LOCK:
        kernel.launches += 1


def _suffix(t: torch.Tensor) -> str:
    return "bf16" if t.dtype == torch.bfloat16 else "f32"


class BandPlan(NamedTuple):
    """The operators of one banded product out[n] = M1 . X[n] . M2 on one
    device, in the layout ``csrc/band2.cuh`` reads (X[n] is q x s, out[n]
    p x t; built by `wam_tpu_torch.wavelets.matmul`). ``blob`` holds the
    tiles' staged source rows, the row pairs' taps and the column pairs'
    taps (int32, weights as float32 bits)."""

    blob: torch.Tensor  # tsrc | per tile: trow, tidx, tw | ccol, cidx, cw (pair-minor)
    q: int
    s: int
    p: int
    t: int
    kc: int         # taps held in registers: 2, 4, 8 or 16
    k: int          # taps per row pair and per column pair (padded to kc up to 16)
    ntiles: int     # row tiles per image
    rt: int         # row pairs per tile
    sm: int         # staged source rows per tile
    tp: int         # column pairs
    odd_off: int    # where the strip's odd columns start (0: not permuted)
    ts_stride: int  # floats per strip row
    stages: int     # 2: the next tile's rows load while this one computes
    cols_shared: int  # 1: the column pairs' taps are copied into shared memory

    def smem_bytes(self) -> int:
        """Dynamic shared memory of one block launched on this plan."""
        return band_smem_bytes(self.s, self.sm, self.rt, self.k, self.tp, self.ts_stride,
                               self.stages, self.cols_shared)


def band_smem_bytes(s: int, sm: int, rt: int, k: int, tp: int, ts_stride: int,
                    stages: int, cols_shared: int) -> int:
    """Dynamic shared memory of a band2.cuh block (``band::smem_bytes``):
    per stage the staged rows and the tile's row-pair data, then the strip
    and (when ``cols_shared``) the column pairs' data."""
    return (stages * (sm * s + 2 * rt + 3 * rt * k) + 2 * rt * ts_stride
            + cols_shared * tp * (2 + 3 * k)) * 4


def _launch_band(kernel: Kernel, symbol: str, x, plan: BandPlan, out_shape) -> torch.Tensor:
    """Launch a band2.cuh kernel on ``x`` (already checked by the caller)."""
    dev = x.device
    _check(plan.blob, "plan", (torch.int32,), 1, dev)
    smem = plan.smem_bytes()
    if smem > MAX_SMEM:
        raise ValueError(f"{kernel.name}: plan needs {smem} bytes of shared memory, "
                         f"more than {MAX_SMEM}")
    n = x.shape[0]
    if max(n * plan.q * plan.s, n * plan.p * plan.t, n * plan.ntiles) > _MAX_DIM:
        raise ValueError(f"{kernel.name}: tensor too large for int32 sides")
    out = torch.empty(out_shape, device=dev, dtype=torch.float32)
    if n == 0:
        return out
    _call(kernel, symbol, dev, x.data_ptr(), out.data_ptr(), plan.blob.data_ptr(), plan.kc, n,
          plan.q, plan.s, plan.p, plan.t, plan.ntiles, plan.rt, plan.sm, plan.k, plan.tp,
          plan.odd_off, plan.ts_stride, plan.stages, plan.cols_shared)
    return out


def dwt2(x3: torch.Tensor, plan: BandPlan) -> torch.Tensor:
    """K1: (N, H, W) f32/bf16 -> (N, 4, h', w') f32 with
    [[aa, ad], [da, dd]] = M1 . x . M2, M1 = A (2h' x H) and M2 = B^T
    (W x 2w') given as ``plan`` (`matmul.dwt2_band`; K2's backward passes
    the plan of Sr^T and Sc)."""
    _check(x3, "x", (torch.float32, torch.bfloat16), 3, x3.device)
    n, q, s = x3.shape
    if (q, s) != (plan.q, plan.s):
        raise ValueError(f"x of shape {tuple(x3.shape)} does not fit a plan for "
                         f"{plan.q} x {plan.s}")
    if plan.p % 2 or plan.t % 2:
        raise ValueError(f"analysis operators must have even output sides, got {plan.p}, "
                         f"{plan.t}")
    return _launch_band(KERNELS["dwt2"], f"wam_dwt2_{_suffix(x3)}", x3, plan,
                        (n, 4, plan.p // 2, plan.t // 2))


def synth2(sub: torch.Tensor, plan: BandPlan) -> torch.Tensor:
    """K2: (N, 4, h, w) f32/bf16 subbands in (aa, ad, da, dd) order ->
    (N, P, T) f32 = Sr . [[aa, ad], [da, dd]] . Sc^T, M1 = Sr and M2 = Sc^T
    given as ``plan`` (`matmul.idwt2_band`). The merge happens in the
    kernel."""
    _check(sub, "sub", (torch.float32, torch.bfloat16), 4, sub.device)
    n, four, h, w = sub.shape
    if four != 4 or (2 * h, 2 * w) != (plan.q, plan.s):
        raise ValueError(f"sub of shape {tuple(sub.shape)} does not fit a plan for "
                         f"{plan.q} x {plan.s}")
    return _launch_band(KERNELS["synth2"], f"wam_synth2_{_suffix(sub)}", sub, plan,
                        (n, plan.p, plan.t))


class PairLevel(NamedTuple):
    """One collapsed level of a K3 plan: a band product in ``csrc/band2.cuh``'s
    layout, its arrays at word offsets of the plan's blob."""

    tsrc: int       # offsets of the level's tsrc, tile data and column data
    tdat: int
    ccols: int
    ntiles: int     # row tiles per image
    rt: int         # row pairs per tile
    sm: int         # staged source rows per tile
    k: int          # taps per row pair and per column pair
    kc: int         # taps held in registers: 2, 4, 8 or 16
    tp: int         # column pairs
    s: int          # floats per staged source row
    fold_log2: int  # the strip groups its columns by c mod 2^fold_log2
    fstride: int    # floats between those groups
    ts_stride: int  # floats per strip row


class _Leaf(ctypes.Structure):
    """``collapsed::Leaf``: an (N, rows, cols) float32 tensor, columns
    contiguous, by its pointer, image stride and row stride (elements)."""

    _fields_ = [("ptr", _P), ("img", _L), ("row", _L)]


class _Leaves(ctypes.Structure):
    """``collapsed::Leaves``: the approximation, then each level's H, V, D
    (the order of `pair`'s leaves), and the levels' sides."""

    _fields_ = [("leaf", _Leaf * (1 + 3 * MAX_LEVELS)), ("rows", _I * MAX_LEVELS),
                ("cols", _I * MAX_LEVELS), ("levels", _I)]


class _LevelPlan(ctypes.Structure):
    _fields_ = [(f, _I) for f in PairLevel._fields]


class _Plans(ctypes.Structure):
    """``collapsed::Plans``."""

    _fields_ = [("blob", _P), ("levels", _I), ("threads", _I), ("stages", _I),
                ("stage_words", _I), ("strip_words", _I), ("lv", _LevelPlan * MAX_LEVELS)]


class PairPlan(NamedTuple):
    """One direction of K3 on one device (`matmul.pair_band`): the levels'
    band plans end to end in ``blob`` (int32, weights as float32 bits) and
    the block's shape. ``rows`` and ``cols`` are the levels' coefficient
    sides, coarsest first; the product's image is p x t."""

    blob: torch.Tensor
    levels: tuple   # of PairLevel, coarsest first
    threads: int
    stages: int       # 2: the next work item's rows load while one computes
    stage_words: int  # floats of each stage
    strip_words: int  # floats of the strip
    rows: tuple
    cols: tuple
    p: int
    t: int
    args: _Plans    # the launch argument, built once (`pair_plan`)

    def smem_bytes(self) -> int:
        """Dynamic shared memory of one block: the stages and the strip."""
        return pair_smem_bytes(self.stages, self.stage_words, self.strip_words)


def pair_smem_bytes(stages: int, stage_words: int, strip_words: int) -> int:
    """Dynamic shared memory of a collapsed.cuh block (``collapsed::smem_bytes``)."""
    return (stages * stage_words + strip_words) * 4


def pair_plan(blob: torch.Tensor, levels, threads: int, stages: int, stage_words: int,
              strip_words: int, rows: tuple, cols: tuple, p: int, t: int) -> PairPlan:
    """A `PairPlan` with its launch argument (``collapsed::Plans``)."""
    args = _Plans(blob=blob.data_ptr(), levels=len(levels), threads=threads, stages=stages,
                  stage_words=stage_words, strip_words=strip_words)
    for i, lv in enumerate(levels):
        args.lv[i] = tuple(lv)
    return PairPlan(blob, tuple(levels), threads, stages, stage_words, strip_words, rows, cols,
                    p, t, args)


def pair_fwd_threads(tp: int) -> int:
    """Threads of a K3 forward block, a thread per column pair and group of
    strip rows: 256 up to 256 column pairs (eight warps share a tile's 16
    row pairs evenly), else one per pair in whole warps."""
    return 256 if tp <= 256 else min(MAX_THREADS, (tp + 31) // 32 * 32)


def _leaves_struct(leaves, plan: PairPlan) -> _Leaves:
    st = _Leaves(rows=plan.rows, cols=plan.cols, levels=len(plan.levels))
    for i, t in enumerate(leaves):
        st.leaf[i] = (t.data_ptr(), t.stride(0), t.stride(1))
    return st


def _check_pair(plan: PairPlan, dev) -> None:
    _check(plan.blob, "plan", (torch.int32,), 1, dev)
    if not 1 <= len(plan.levels) <= MAX_LEVELS:
        raise ValueError(f"pair: {len(plan.levels)} levels, expected 1 to {MAX_LEVELS}")
    if plan.smem_bytes() > MAX_SMEM:
        raise ValueError(f"pair: plan needs {plan.smem_bytes()} bytes of shared memory, more "
                         f"than {MAX_SMEM}")


def _check_leaves(leaves, plan: PairPlan, dev) -> int:
    """The leaves' shapes against the plan: cA (N, r_J, c_J), then H, V, D
    of each level (N, r_l, c_l), float32 CUDA tensors with contiguous
    columns (any image and row strides: views of K1's output are read in
    place). Returns N."""
    if len(leaves) != 1 + 3 * len(plan.levels):
        raise ValueError(f"pair: {len(leaves)} leaves for {len(plan.levels)} levels")
    n = leaves[0].shape[0] if leaves[0].ndim == 3 else -1
    for i, t in enumerate(leaves):
        lv = max(0, (i - 1) // 3)
        want = (n, plan.rows[lv], plan.cols[lv])
        if t.dtype != torch.float32:
            raise TypeError(f"pair kernel takes float32 leaves, got {t.dtype} for leaf {i}")
        if not t.is_cuda:
            raise ValueError(f"leaf {i} must be a CUDA tensor (got device {t.device}); the "
                             "plain PyTorch version serves CPU tensors")
        if t.device != dev:
            raise ValueError(f"leaf {i} is on {t.device}, expected {dev}")
        if tuple(t.shape) != want:
            raise ValueError(f"leaf {i} has shape {tuple(t.shape)}, expected {want}")
        if t.stride(2) != 1 and t.shape[2] != 1:
            raise ValueError(f"leaf {i} must have contiguous columns, got strides {t.stride()}")
    return n


def pair(leaves, plan: PairPlan) -> torch.Tensor:
    """K3 forward: out[n] = sum_l R_l . Y_l[n] . C_l^T, (N, P, T) float32,
    with Y_l = [[aa or 0, V_l], [H_l, D_l]] read straight from ``leaves``:
    [cA, H_J, V_J, D_J, ..., H_1, V_1, D_1], coarsest first, each an (N,
    r_l, c_l) float32 CUDA tensor with contiguous columns (`_check_leaves`);
    ``plan`` is `matmul.pair_band`'s forward plan."""
    dev = leaves[0].device
    n = _check_leaves(leaves, plan, dev)
    _check_pair(plan, dev)
    out = torch.empty((n, plan.p, plan.t), device=dev, dtype=torch.float32)
    if n:
        _call(KERNELS["pair"], "wam_pair_fwd_f32", dev,
              ctypes.byref(_leaves_struct(leaves, plan)), ctypes.byref(plan.args),
              out.data_ptr(), n, plan.p, plan.t)
    return out


def pair_bwd(g: torch.Tensor, plan: PairPlan) -> list[torch.Tensor]:
    """K3 backward: each leaf's gradient from g (N, P, T) float32, the
    quadrants of R_l^T . g[n] . C_l (aa only at the coarsest level), in the
    leaves' order, each (N, r_l, c_l) float32 and contiguous; ``plan`` is
    `matmul.pair_band`'s backward plan."""
    _check(g, "g", (torch.float32,), 3, g.device)
    dev = g.device
    _check_pair(plan, dev)
    n = g.shape[0]
    if tuple(g.shape[1:]) != (plan.p, plan.t):
        raise ValueError(f"g of shape {tuple(g.shape)} does not fit a plan for "
                         f"{plan.p} x {plan.t}")
    grads = [torch.empty((n, plan.rows[0], plan.cols[0]), device=dev, dtype=torch.float32)]
    for r, c in zip(plan.rows, plan.cols):
        grads += [torch.empty((n, r, c), device=dev, dtype=torch.float32) for _ in range(3)]
    if n:
        _call(KERNELS["pair"], "wam_pair_bwd_f32", dev, g.data_ptr(),
              ctypes.byref(_leaves_struct(grads, plan)), ctypes.byref(plan.args), n, plan.p,
              plan.t)
    return grads


MASK_LANES, MASK_PACK = 128, 8  # the (R/8, 128) uint8 sign-mask layout


def mask_rows(numel: int) -> int:
    """Rows of the packed mask of ``numel`` elements: ceil(numel / 1024)."""
    return -(-numel // (MASK_PACK * MASK_LANES))


def relu_fwd(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K4: contiguous f32/bf16 x of any shape -> (y = relu(x), same shape and
    dtype; m, (ceil(numel / 1024), 128) uint8 sign mask)."""
    _check(x, "x", (torch.float32, torch.bfloat16), None, x.device)
    y = torch.empty_like(x)
    m = torch.empty((mask_rows(x.numel()), MASK_LANES), device=x.device, dtype=torch.uint8)
    if x.numel():
        _call(KERNELS["relu_fwd"], f"wam_relu_fwd_{_suffix(x)}", x.device, x.data_ptr(),
              y.data_ptr(), m.data_ptr(), x.numel())
    return y, m


def relu_bwd(m: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K5: dx = g * unpack(m), g contiguous f32/bf16 of any shape, ``m`` the
    mask K4 gave for an input of g's size."""
    _check(g, "g", (torch.float32, torch.bfloat16), None, g.device)
    _check(m, "m", (torch.uint8,), 2, g.device)
    if tuple(m.shape) != (mask_rows(g.numel()), MASK_LANES):
        raise ValueError(f"mask of shape {tuple(m.shape)} does not fit {g.numel()} elements")
    dx = torch.empty_like(g)
    if g.numel():
        _call(KERNELS["relu_bwd"], f"wam_relu_bwd_{_suffix(g)}", g.device, m.data_ptr(),
              g.data_ptr(), dx.data_ptr(), g.numel())
    return dx
