#!/usr/bin/env python3
"""Where the time of one of the port's paths goes on the card.

    python3 scripts/torch_slice_profile.py [--path2 | --nhwc | --audio | --vit | --convnext | --vol] [--bf16]
    python3 scripts/torch_slice_profile.py --eval2d [--mu]
    python3 scripts/torch_slice_profile.py --baselines [--lrp | --insertion]
    python3 scripts/torch_slice_profile.py [--patch | --video | --anytime | --attention [--attngrad]]

Runs a path of chip_smoke.py, set up by its own code (one definition for
both): by default the flagship, `wam_tpu_torch.WaveletAttribution2D`
SmoothGrad on ResNet-50 (`chip_smoke.build_slice`: batch 32, 3x224x224, db4,
J=3, n_samples=25, sample_batch_size=4, cuDNN TF32 on); with ``--path2`` the
same at 3x288x288 with ``fused_relu_vjp=True``; with ``--nhwc`` the
flagship's call with ``model_layout="nhwc"`` on the same ResNet-50 bound
with ``bind_inference(nchw=False)`` (`chip_smoke.build_nhwc`); with ``--audio`` the audio
path, `WaveletAttribution1D` SmoothGrad on the AudioCNN
(`chip_smoke.build_audio`: 8 x 220,500 samples, db6, J=5, n_samples=50,
sample_batch_size=16); with ``--vit`` the ViT path, `WaveletAttribution2D`
Integrated Gradients on ViT-B/16 (`chip_smoke.build_vit`: one 3x224x224
image, haar, J=3, 64 path points, sample_batch_size=16, TF32 on for
matmuls and convolutions, chip_smoke's headline arm); with ``--convnext``
the same call on ConvNeXt-T; ``--bf16`` binds either model in bfloat16
(chip_smoke's bf16 arm); with ``--vol`` the 3D path, `WaveletAttribution3D`
SmoothGrad on the 3D ResNet-18 (`chip_smoke.build_vol`: 8 x 1x32^3, haar,
J=2, n_samples=25, sample_batch_size=16, TF32 on for the model, chip_smoke's
headline); with ``--eval2d`` one `Eval2DWAM` insertion call
(`chip_smoke.build_eval2d`: ResNet-50 in bfloat16 with fold_bn, 8 images of
3x224x224, haar, J=3, n_iter 64, 128 rows a model call, the explainer's
mosaics computed before), or with ``--mu`` its μ-fidelity call (28 x 28
grid, 128 subsets of 157 cells); with ``--baselines`` one saliency
explanation of the baselines phase's image registry
(`chip_smoke.build_baselines`: `EvalImageBaselines` on ResNet-50 in
bfloat16, 4 images of 3x224x224, 64 rows a model call), with ``--lrp`` its
LRP explanation (the float32 walker), with ``--insertion`` one saliency
insertion call (n_iter 32); with ``--patch`` the patch path (`chip_smoke.
patch_wam`: the ViT call with ``level_plan="patch"``, J=4, TF32 on), with
``--video`` the video path (`chip_smoke.build_video`, `video_wam`: 4 clips of
1x16x32^2, levels (2, 1), n=25 in one chunk), with ``--anytime`` one full
`anytime.run_anytime` of the flagship's explainer (stride 5), with
``--attention`` one rollout explanation of the attention phase
(`chip_smoke.build_attention`: ViT-B/16 with ``capture_attn=True``, 4 images,
TF32 on) or with ``--attngrad`` its attngrad explanation. One call to warm up, then one under
`torch.profiler` (`wam_tpu_torch.profiling.profile_to`), read back through
`profiling.named_op_split` with this script's grouping; prints one JSON line: the call's wall time, the summed
device time of its kernels by group (K1-K5, the 1D transform, FFT,
convolutions, matmuls, batchnorm, pooling, other), and the device's idle
share (1 - summed kernel time / wall time; one stream, so kernels do not
overlap). The 1D transform's kernels are those launched inside its
``wam_dwt1`` profiler spans (`wavelets.transform.SPAN_1D`), and the 3D
transform's those inside its ``wam_dwt3`` spans (`SPAN_3D`), taken out of
the group their names fall in. On the ViT, ConvNeXt, patch and attention paths every kernel other
than K1-K5 is grouped by the op that launched it (`OP_GROUPS`: matmul,
attention, LayerNorm, GELU, convolution forward and backward, copies),
since cuBLAS's and cuDNN's kernel names do not tell a matmul from a
convolution. The JSON also lists the kernels that took the most device
time (``top_kernels``). Needs one CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

GROUPS = (  # first match wins, on the lower-cased kernel name
    ("K2 idwt2_kernel", ("wam_synth2",)),        # band2_kernel<.., wam_synth2::QuadrantSource<..>, ..>
    ("K1 dwt2_kernel", ("wam_dwt2",)),           # band2_kernel<.., wam_dwt2::QuadrantStore>
    ("K3 waverec2_collapsed", ("collapsed::",)),  # collapsed::forward_kernel, backward_kernel
    ("K4 fused_relu forward", ("relu_fwd_kernel",)),
    ("K5 fused_relu backward", ("relu_bwd_kernel",)),
    ("FFT (cuFFT)", ("fft", "radix")),
    ("layout conversion (NCHW <-> NHWC)", ("nchwtonhwc", "nhwctonchw")),
    # cuBLAS's full-float32 (FFMA) GEMMs: the NHWC transforms' contractions
    # (TF32 off); cuDNN's convolutions run TF32 on every path profiled here
    ("matmul (cuBLAS, full float32)", ("xmma_gemm_f32f32_f32f32",)),
    ("convolution (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad",
                             "fprop", "winograd", "cutlass")),
    ("matmul (cuBLAS)", ("gemm", "gemv")),
    ("batchnorm", ("batch_norm", "bn_")),
    ("pooling", ("pool",)),
)


# --vit / --convnext: a kernel's group by the op that launched it, the
# innermost op first, then its parents; first match wins
OP_GROUPS = (
    ("attention (SDPA)", ("attention",)),
    ("LayerNorm", ("layer_norm",)),
    ("GELU", ("gelu",)),
    ("convolution backward (cuDNN: input gradient)", ("convolution_backward",)),
    ("convolution forward (cuDNN)", ("convolution", "cudnn")),
    ("matmul (cuBLAS)", ("aten::mm", "aten::addmm", "aten::matmul", "aten::linear")),
    ("copies (copy_, cat, index_select)", ("copy_", "clone", "aten::cat", "index_select")),
)
OP_OTHER = "other (elementwise, reductions)"


def _op_group(ops) -> str:
    """A kernel's group by the ops that launched it, innermost first."""
    for name in ops:
        for label, keys in OP_GROUPS:
            if any(k in name.lower() for k in keys):
                return label
    return OP_OTHER


def _group(name: str) -> str:
    low = name.lower()
    for label, keys in GROUPS:
        if any(k in low for k in keys):
            return label
    return "other (elementwise, reductions, copies)"


DWT1 = "1D DWT (transform spans: convolutions, padding gathers)"
DWT3 = "3D DWT (transform spans: conv3d, synthesis products, padding gathers, stacking)"


def _classifier(by_op: bool, span_1d: str, span_3d: str):
    """A device event's group (`profiling.named_op_split`'s ``classify``):
    inside a 1D or 3D transform span, that transform's group; on the
    ``by_op`` paths every kernel other than K1-K5 by the op that launched
    it; else by its kernel name (`GROUPS`)."""
    def classify(ev) -> str:
        if span_1d in ev.ops:
            return DWT1
        if span_3d in ev.ops:
            return DWT3
        label = _group(ev.name)
        if by_op and not label.startswith("K"):
            return _op_group(ev.ops)
        return label

    return classify


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_slice_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import wam_tpu_torch as wtt
    from wam_tpu_torch import kernels

    from wam_tpu_torch.wavelets.transform import SPAN_1D, SPAN_3D

    kernels.build_all()
    path2, audio, vol, eval2d = ("--path2" in sys.argv[1:], "--audio" in sys.argv[1:],
                                 "--vol" in sys.argv[1:], "--eval2d" in sys.argv[1:])
    arch = next((a for a in ("vit", "convnext") if f"--{a}" in sys.argv[1:]), None)
    baselines = "--baselines" in sys.argv[1:]
    dev = torch.device(chip_smoke.DEVICE)
    custom = next((a for a in ("patch", "video", "anytime", "attention")
                   if f"--{a}" in sys.argv[1:]), None)
    if custom == "patch":
        chip_smoke._precision(torch, True)
        _, fn, x, y = chip_smoke.build_vit(torch, wtt)
        wam = chip_smoke.patch_wam(wtt, fn, dev)
        arch = "patch"
        path = (f"patch (1x3x{chip_smoke.VIT_SIDE}^2, haar, patch {chip_smoke.PATCH}: "
                f"J={chip_smoke.PATCH_LEVELS}, IG {chip_smoke.VIT_STEPS} steps, chunk "
                f"{chip_smoke.VIT_CHUNK}, TF32 on)")
    elif custom == "video":
        chip_smoke._precision(torch, True)
        _, fn, x, y = chip_smoke.build_video(torch, wtt)
        wam = chip_smoke.video_wam(wtt, fn, dev)
        path = (f"video ({chip_smoke.VID_BATCH}x1x{chip_smoke.VID_FRAMES}x{chip_smoke.VID_SIDE}^2, "
                f"3D ResNet-18, haar levels {chip_smoke.VID_LEVELS}, n={chip_smoke.VID_SAMPLES} "
                "in one chunk, TF32 on for the model)")
    elif custom == "anytime":
        from wam_tpu_torch import anytime

        _, flagship, x, y, _ = chip_smoke.build_slice(torch, wtt)
        entry = flagship.anytime_serve_entry(stride=chip_smoke.ANY_STRIDE)

        def run():
            return anytime.run_anytime(entry, x, y)

        path = (f"anytime (the flagship's explainer, {chip_smoke.N_SAMPLES} samples, stride "
                f"{chip_smoke.ANY_STRIDE}, one sample of {chip_smoke.BATCH} images a step)")
    elif custom == "attention":
        chip_smoke._precision(torch, True)
        model, _, x, y = chip_smoke.build_attention(torch, wtt)
        method = "attngrad" if "--attngrad" in sys.argv[1:] else "rollout"
        ev = wtt.EvalImageBaselines(model, None, method=method, batch_size=chip_smoke.ATTN_CAP,
                                    device=dev)

        def run():
            return ev.compute_explanations(x, y)

        arch = "attention"
        path = (f"attention {method} explanation ({chip_smoke.ATTN_BATCH}x3x"
                f"{chip_smoke.VIT_SIDE}^2, ViT-B/16 capture_attn=True, TF32 on)")
    elif baselines:
        chip_smoke._precision(torch, True)
        method = "lrp" if "--lrp" in sys.argv[1:] else "saliency"
        ev, x, y = chip_smoke.build_baselines(torch, wtt, method)
        if "--insertion" in sys.argv[1:]:
            ev.precompute(x, y)

            def run():
                return ev.insertion(x, y, n_iter=chip_smoke.BASE_N_ITER)

            what = f"insertion n_iter {chip_smoke.BASE_N_ITER}"
        else:
            def run():
                return ev.compute_explanations(x, y)

            what = "explanation"
        path = (f"baselines {method} {what} ({chip_smoke.BASE_BATCH}x3x{chip_smoke.EVAL_SIDE}^2, "
                f"ResNet-50 bfloat16, {chip_smoke.BASE_CAP} rows a model call)")
    elif eval2d:
        chip_smoke._precision(torch, True)
        _, ev, x, y = chip_smoke.build_eval2d(torch, wtt)
        ev.precompute(x, y)
        metric = "mu_fidelity" if "--mu" in sys.argv[1:] else "insertion"
        run = chip_smoke.eval2d_calls(ev, x, y)[metric]
        path = (f"eval2d {metric} ({chip_smoke.EVAL_BATCH}x3x{chip_smoke.EVAL_SIDE}^2, ResNet-50 "
                f"bfloat16 fold_bn, {chip_smoke.EVAL_WAVELET} J={chip_smoke.EVAL_LEVELS}, "
                f"{chip_smoke.EVAL_ROWS[metric]} model rows, {chip_smoke.EVAL_CAP} a call)")
    elif arch in ("vit", "convnext"):
        chip_smoke._precision(torch, True)
        bf16 = "--bf16" in sys.argv[1:]
        _, fn, x, y = chip_smoke.build_vit(torch, wtt, arch,
                                           compute_dtype=torch.bfloat16 if bf16 else None)
        wam = chip_smoke.vit_wam(wtt, fn, torch.device(chip_smoke.DEVICE))
        path = (f"{arch} (1x3x{chip_smoke.VIT_SIDE}^2, {chip_smoke.VIT_WAVELET} "
                f"J={chip_smoke.VIT_LEVELS}, IG {chip_smoke.VIT_STEPS} steps, chunk "
                f"{chip_smoke.VIT_CHUNK}, TF32 on{', model in bfloat16' if bf16 else ''})")
    elif vol:
        chip_smoke._precision(torch, True)
        _, fn, x, y = chip_smoke.build_vol(torch, wtt)
        wam = chip_smoke.vol_wam(wtt, fn, torch.device(chip_smoke.DEVICE))
        path = (f"vol ({chip_smoke.VOL_BATCH}x1x{chip_smoke.VOL_SIDE}^3, 3D ResNet-18 width "
                f"{chip_smoke.VOL_WIDTH}, {chip_smoke.VOL_WAVELET} J={chip_smoke.VOL_LEVELS}, "
                f"n={chip_smoke.VOL_SAMPLES}, chunk {chip_smoke.VOL_CHUNK}, TF32 on for the model)")
    elif audio:
        _, fn, x, y = chip_smoke.build_audio(torch, wtt)
        wam = chip_smoke.audio_wam(wtt, fn, torch.device(chip_smoke.DEVICE))
        path = (f"audio ({chip_smoke.AUDIO_BATCH}x{chip_smoke.AUDIO_LEN}, AudioCNN, "
                f"{chip_smoke.AUDIO_WAVELET} J={chip_smoke.AUDIO_LEVELS}, "
                f"n={chip_smoke.AUDIO_SAMPLES}, chunk {chip_smoke.AUDIO_CHUNK})")
    elif "--nhwc" in sys.argv[1:]:
        _, _, _, _, wam, x, y, _ = chip_smoke.build_nhwc(torch, wtt)
        path = "flagship (224^2) with model_layout='nhwc'"
    else:
        side = chip_smoke.SIDE2 if path2 else chip_smoke.SIDE
        _, wam, x, y, _ = chip_smoke.build_slice(torch, wtt, side=side, fused_relu_vjp=path2)
        path = "path2 (288^2, fused_relu_vjp)" if path2 else "flagship (224^2)"
    if not (eval2d or baselines or custom in ("anytime", "attention")):
        def run():
            return wam(x, y)
    run()
    torch.cuda.synchronize()

    import tempfile

    from wam_tpu_torch.profiling import kernel_events, named_op_split, profile_to

    with tempfile.TemporaryDirectory() as logdir:
        with profile_to(logdir):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        split = named_op_split(logdir, classify=_classifier(bool(arch), SPAN_1D, SPAN_3D),
                               launches=True)
        top = {}
        for ev in kernel_events(logdir) or []:
            ms, n = top.get(ev.name, (0.0, 0))
            top[ev.name] = (ms + ev.dur / 1e3, n + 1)
    seconds, launches = split if split is not None else ({"total": 0.0}, {})
    seconds.pop("total")
    groups = {k: v * 1e3 for k, v in seconds.items() if launches.get(k)}
    top = [(ms, n, name[:120]) for name, (ms, n) in top.items()]
    busy_ms = sum(groups.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({
        "path": path,
        "gpu": smi, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
        "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "groups_share": {k: v / busy_ms for k, v in sorted(groups.items(), key=lambda kv: -kv[1])}
        if busy_ms else None,
        "kernel_launches": launches,
        "kernel_launches_total": sum(launches.values()),
        "top_kernels": [{"ms": ms, "launches": n, "name": name}
                        for ms, n, name in sorted(top, reverse=True)[:15]],
    }))
    if busy_ms == 0:
        print("torch_slice_profile: the profiler recorded no device time", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
