#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port, `wam_tpu_torch`.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (Hopper,
sm_90a). Phases, each fatal on failure:

1. device: the card's name and power limit (nvidia-smi);
2. build:  every kernel of the main path, compiled from ``wam_tpu_torch/csrc``
   by nvcc (one process per source, all at once);
3. kernels: each kernel against its plain PyTorch version at the shapes the
   main path gives it, TF32 off, and timed with CUDA events;
4. slice:  the main path, `WaveletAttribution2D` SmoothGrad on ResNet-50
   (1000 classes, seeded random weights) at batch 32, 3x224x224, db4, J=3,
   reflect, n_samples=25, stdev_spread=0.25, with launch counts reset just
   before and read just after; then a reduced run (2 images, 2 samples) of
   the kernel path against the same call on the plain versions.

Prints the kernels' JSON line, the nvidia-smi line, and as its last line
``{"ok": true, "device": {...}}``. Exits nonzero, printing no result, when
there is no CUDA device or the port is not beside this script.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

BATCH, CHANNELS, SIDE = 32, 3, 224
WAVELET, LEVELS, MODE = "db4", 3, "reflect"
N_SAMPLES, SPREAD = 25, 0.25
SAMPLE_CHUNK = 4          # samples per model call: 4 x 32 = 128 ResNet-50 rows
SEED = 0
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12    # H100 SXM f32 outside the tensor cores
# kernel vs plain: both accumulate float32 in another order; 1e-5 of the
# largest reference value is ~100 float32 ulps of headroom
KERNEL_RTOL = 1e-5


def _log(*args):
    print(*args, flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _product_macs(left, right) -> int:
    """Multiply-adds of left @ right when both skip their zeros:
    sum over k of nnz(left[:, k]) * nnz(right[k, :]) (boolean masks)."""
    import torch

    return int((left.sum(0, dtype=torch.int64) * right.sum(1, dtype=torch.int64)).sum())


def _needed_flops(x, m1t, m2) -> int:
    """FLOP that out[n] = m1t^T . x[n] . m2 needs when it skips the zeros of
    the operators and of x (the wavelet operators are banded or sparse, the
    collapsed synthesis input is block-diagonal), in the cheaper of the two
    association orders. x's zeros are taken as those every image shares."""
    import torch

    a = (m1t != 0).T.cpu()
    xm = (x != 0).any(0).cpu()
    b = (m2 != 0).cpu()
    f64 = torch.float64

    def mask_mm(u, v):
        return (u.to(f64) @ v.to(f64)) > 0

    left_first = _product_macs(a, xm) + _product_macs(mask_mm(a, xm), b)
    right_first = _product_macs(xm, b) + _product_macs(a, mask_mm(xm, b))
    return 2 * x.shape[0] * min(left_first, right_first)


def _dense_flops(x, m1t, m2) -> int:
    """FLOP of the dense products, as the kernels do them (T = M1 . X first)."""
    n, q, s = x.shape
    return 2 * n * m1t.shape[1] * s * (q + m2.shape[1])


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _check(name: str, got, want) -> tuple[float, float]:
    import torch

    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = KERNEL_RTOL * max(1.0, float(want.abs().max()))
    _log(f"  {name}: max_abs_err={err:.3e} tol={tol:.3e}")
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {err:.3e} > {tol:.3e})")
    return err, tol


def phase_kernels(torch, tmm, kernels) -> list[dict]:
    """K1 at the three analysis levels (f32 and bf16 input) and K3 forward and
    backward, at the main path's launch shapes: N = SAMPLE_CHUNK * BATCH *
    CHANNELS images per launch."""
    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log("phase kernels: torch.backends.cuda.matmul.allow_tf32=False "
         "torch.backends.cudnn.allow_tf32=False")
    g = torch.Generator(device=dev).manual_seed(SEED)
    n = SAMPLE_CHUNK * BATCH * CHANNELS
    from wam_tpu_torch.wavelets.filters import build_wavelet

    w = build_wavelet(WAVELET)
    taps = (tuple(w.dec_lo), tuple(w.dec_hi), MODE)

    # K1: level l reads the previous level's approximation
    k1 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "matmul_pair_ms": 0.0, "err": 0.0,
          "tol": 0.0, "bytes": 0, "flops": 0, "dense_flops": 0, "cases": []}
    x = torch.randn((n, SIDE, SIDE), generator=g, device=dev)
    for level in range(1, LEVELS + 1):
        side = x.shape[-1]
        A, At = tmm._kernel_analysis(side, *taps, dev)
        _, Bt = tmm._kernel_analysis(side, *taps, dev)
        for dtype in (torch.float32, torch.bfloat16):
            xin = x.to(dtype).contiguous()
            want = tmm.dwt2_plain(xin, At, Bt)
            err, tol = _check(f"K1 level {level} {str(dtype)[6:]}", kernels.dwt2(xin, At, Bt), want)
            ms = _time_ms(lambda: kernels.dwt2(xin, At, Bt))
            plain_ms = _time_ms(lambda: tmm.dwt2_plain(xin, At, Bt))
            p, q, s, t = At.shape[1], side, side, Bt.shape[1]
            nbytes = _nbytes(xin, At, Bt) + n * p * t * 4
            flops, dense = _needed_flops(xin, At, Bt), _dense_flops(xin, At, Bt)
            bound, by = _bound_ms(nbytes, flops)
            case = {"level": level, "dtype": str(dtype)[6:], "shape": [n, q, s],
                    "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": by, "flops": flops,
                    "dense_flops": dense, "bytes": nbytes,
                    "dense_bound_ms": _bound_ms(nbytes, dense)[0]}
            if dtype == torch.float32:
                xf = xin
                case["library_ms"] = _time_ms(
                    lambda: torch.einsum("qp,nqs,st->npt", At, xf, Bt))
                case["matmul_pair_ms"] = _time_ms(lambda: tmm.pair_plain(xf, At, Bt))
                # the main path's per-step work: its dtype (f32) at every level
                for key in ("ms", "plain_ms", "library_ms", "matmul_pair_ms"):
                    k1[key] += case[key]
                k1["bytes"] += nbytes
                k1["flops"] += flops
                k1["dense_flops"] += dense
            k1["err"] = max(k1["err"], err)
            k1["tol"] = max(k1["tol"], tol)
            k1["cases"].append(case)
            _log(f"  K1 level {level} {case['dtype']}: {ms:.4f} ms (plain {plain_ms:.4f}, "
                 f"bound {bound:.4f} by {by})")
        x = want[:, 0].contiguous()

    # K3: Y of a real decomposition of the noisy-batch shape
    from wam_tpu_torch.wavelets import transform as tt

    imgs = torch.randn((n // CHANNELS, CHANNELS, SIDE, SIDE), generator=g, device=dev)
    coeffs = tt.wavedec2(imgs, WAVELET, LEVELS, MODE, impl="matmul")
    details = coeffs[1:]
    R, Rt, C, Ct = tmm.collapsed_operators(details, WAVELET, dev)
    y3 = tmm.assemble_collapsed(coeffs[0], details).reshape(n, Rt.shape[0], Ct.shape[0])
    gout = torch.randn((n, R.shape[0], C.shape[0]), generator=g, device=dev)
    k3 = {"cases": []}
    fwd_err, fwd_tol = _check("K3 forward", kernels.pair(y3, Rt, Ct), tmm.pair_plain(y3, Rt, Ct))
    yv = y3.clone().requires_grad_(True)
    out = tmm._PairCore.apply(yv, R, Rt, C, Ct)
    (dy,) = torch.autograd.grad(out, yv, gout)
    bwd_err, bwd_tol = _check("K3 backward (autograd)", dy, tmm.pair_plain(gout, R, C))
    for name, (xin, m1t, m2), err, tol in (
            ("forward", (y3, Rt, Ct), fwd_err, fwd_tol),
            ("backward", (gout, R, C), bwd_err, bwd_tol)):
        ms = _time_ms(lambda: kernels.pair(xin, m1t, m2))
        plain_ms = _time_ms(lambda: tmm.pair_plain(xin, m1t, m2))
        library_ms = _time_ms(lambda: torch.einsum("qp,nqs,st->npt", m1t, xin, m2))
        p, q, s, t = m1t.shape[1], m1t.shape[0], m2.shape[0], m2.shape[1]
        nbytes = _nbytes(xin, m1t, m2) + n * p * t * 4
        flops, dense = _needed_flops(xin, m1t, m2), _dense_flops(xin, m1t, m2)
        bound, by = _bound_ms(nbytes, flops)
        k3["cases"].append({"pass": name, "shape": [n, q, s], "max_abs_err": err, "tol": tol,
                            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                            "bound_ms": bound, "bound_by": by, "flops": flops,
                            "dense_flops": dense, "bytes": nbytes,
                            "dense_bound_ms": _bound_ms(nbytes, dense)[0]})
        _log(f"  K3 {name}: {ms:.4f} ms (plain {plain_ms:.4f}, einsum {library_ms:.4f}, "
             f"bound {bound:.4f} by {by})")
    def total(cases, key):
        return sum(c[key] for c in cases)

    k3_bound, k3_by = _bound_ms(total(k3["cases"], "bytes"), total(k3["cases"], "flops"))
    k1_bound, k1_by = _bound_ms(k1["bytes"], k1["flops"])

    return [
        {"name": "dwt2_kernel (K1)", "route": "cuda", "source": "wam_tpu_torch/csrc/dwt2.cu",
         "replaces": "wam_tpu/wavelets/matmul.py:176", "launches": None,
         "max_abs_err": k1["err"], "tol": k1["tol"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1_bound, "bound_by": k1_by, "flops": k1["flops"], "bytes": k1["bytes"],
         "dense_bound_ms": _bound_ms(k1["bytes"], k1["dense_flops"])[0],
         "library_ms": k1["library_ms"],
         "library": "torch.einsum (the matmul pair, without the quadrant split)",
         "matmul_pair_ms": k1["matmul_pair_ms"],
         "work": "3 analysis levels, f32 input, one sample chunk", "cases": k1["cases"]},
        {"name": "waverec2_collapsed (K3)", "route": "cuda", "source": "wam_tpu_torch/csrc/pair.cu",
         "replaces": "wam_tpu/wavelets/matmul.py:439", "launches": None,
         "max_abs_err": max(fwd_err, bwd_err), "tol": max(fwd_tol, bwd_tol),
         "ms": total(k3["cases"], "ms"), "plain_ms": total(k3["cases"], "plain_ms"),
         "bound_ms": k3_bound, "bound_by": k3_by, "flops": total(k3["cases"], "flops"),
         "bytes": total(k3["cases"], "bytes"),
         "dense_bound_ms": _bound_ms(total(k3["cases"], "bytes"),
                                     total(k3["cases"], "dense_flops"))[0],
         "library_ms": total(k3["cases"], "library_ms"),
         "library": "torch.einsum (the matmul pair)",
         "matmul_pair_ms": total(k3["cases"], "plain_ms"),
         "work": "forward + backward, one sample chunk", "cases": k3["cases"]},
    ]


def build_slice(torch, wtt):
    """The main path's set-up, shared with scripts/torch_slice_profile.py:
    the library's precision defaults, stated (cuDNN convolutions in TF32,
    matmuls in float32), ResNet-50 with 1000 classes and weights from SEED,
    a (BATCH, CHANNELS, SIDE, SIDE) batch and its labels from a generator
    seeded SEED + 1, and the SmoothGrad attribution object on the kernels.
    Returns (model_fn, wam, x, y, generator)."""
    dev = torch.device(DEVICE)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(SEED)
    fn = wtt.bind_inference(wtt.resnet50(num_classes=1000), device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn((BATCH, CHANNELS, SIDE, SIDE), generator=g, device=dev)
    y = torch.randint(0, 1000, (BATCH,), generator=g, device=dev)
    wam = wtt.WaveletAttribution2D(fn, wavelet=WAVELET, J=LEVELS, mode=MODE, method="smooth",
                                   n_samples=N_SAMPLES, stdev_spread=SPREAD,
                                   sample_batch_size=SAMPLE_CHUNK, device=dev, impl="kernel")
    return fn, wam, x, y, g


def phase_slice(torch, wtt, kernels, smi: str) -> dict:
    """The main path at full width, then the reduced kernel-vs-plain check."""
    dev = torch.device(DEVICE)
    fn, wam, x, y, g = build_slice(torch, wtt)
    _log(f"phase slice: ResNet-50 x ({BATCH},{CHANNELS},{SIDE},{SIDE}) {WAVELET} J={LEVELS} "
         f"{MODE} n_samples={N_SAMPLES} sample_batch_size={SAMPLE_CHUNK} "
         "cudnn.allow_tf32=True matmul.allow_tf32=False")
    t0 = time.perf_counter()
    wam(x, y)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = wam(x, y)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    side = 2 * ((SIDE + wtt.wavelets.filters.build_wavelet(WAVELET).filt_len - 1) // 2)
    if tuple(out.shape) != (BATCH, side, side):
        raise AssertionError(f"mosaic shape {tuple(out.shape)} != {(BATCH, side, side)}")
    if not bool(torch.isfinite(out).all()) or float(out.abs().sum()) == 0.0:
        raise AssertionError("mosaic is not finite and nonzero")
    if tuple(wam.scales.shape) != (BATCH, LEVELS, side, side):
        raise AssertionError(f"scales shape {tuple(wam.scales.shape)}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    _log(f"  launches on the main path: {launches}")
    _log(f"  first call {warm_s:.3f} s; timed call {run_s:.3f} s = "
         f"{BATCH / run_s:.2f} attributions/s; peak memory {peak_gb:.2f} GB on {smi}")

    # reduced check: kernel path vs the same call on the plain versions
    torch.backends.cudnn.allow_tf32 = False
    n_img, n_smp = 2, 2
    z = torch.randn((n_smp, n_img, CHANNELS, SIDE, SIDE), generator=g, device=dev)
    res = {}
    for impl in ("kernel", "matmul"):
        small = wtt.WaveletAttribution2D(fn, wavelet=WAVELET, J=LEVELS, mode=MODE,
                                         n_samples=n_smp, stdev_spread=SPREAD,
                                         sample_batch_size=SAMPLE_CHUNK, device=dev, impl=impl)
        res[impl] = small(x[:n_img], y[:n_img], noise=z)
    diff = (res["kernel"] - res["matmul"]).abs()
    err = float(diff.max())
    cos = float(torch.nn.functional.cosine_similarity(
        res["kernel"].flatten(), res["matmul"].flatten(), dim=0))
    # mosaics lie in [0, 1] per block (n_smp-sample mean). The two paths
    # round the coefficients differently (~1e-7 relative); through ResNet-50
    # that can flip a ReLU gate sitting at zero and move a few entries, so
    # the check is on the cosine and a max-abs bound of 1e-2.
    _log(f"  reduced check (TF32 off, {n_img} images x {n_smp} samples): kernel vs plain "
         f"max_abs_err={err:.3e} (tol 1e-2) cosine={cos:.8f} (tol >= 0.9999) "
         f"mean_abs_err={float(diff.mean()):.3e}")
    if not (err <= 1e-2 and cos >= 0.9999):
        raise AssertionError("reduced check: kernel path disagrees with the plain path")
    return {"launches": launches, "seconds": run_s, "first_call_s": warm_s,
            "attributions_per_s": BATCH / run_s, "peak_memory_gb": peak_gb,
            "reduced_max_abs_err": err, "reduced_cosine": cos}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    if not (ROOT / "wam_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: wam_tpu_torch not found beside {Path(__file__).name}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import wam_tpu_torch as wtt
    from wam_tpu_torch import kernels
    from wam_tpu_torch.wavelets import matmul as tmm

    smi = _nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    _log(f"phase device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    t0 = time.perf_counter()
    report = kernels.build_all()
    _log(f"phase build: {time.perf_counter() - t0:.2f} s for {sorted(report)} "
         f"into {kernels.BUILD_DIR}")
    for name, rep in report.items():
        for line in rep["log"].splitlines():
            if "registers" in line or "spill" in line:
                _log(f"  {name}: {line.strip()}")

    rows = phase_kernels(torch, tmm, kernels)
    slice_ = phase_slice(torch, wtt, kernels, smi)
    names = {"dwt2_kernel (K1)": "dwt2", "waverec2_collapsed (K3)": "pair"}
    for row in rows:
        row["launches"] = slice_["launches"][names[row["name"]]]

    print(json.dumps({"slice": {k: v for k, v in slice_.items() if k != "launches"},
                      "gpu": smi}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
