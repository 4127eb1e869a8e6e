"""Chunk sweep of the non-flagship canonical workloads (audio 1D, 3D
volumes, ViT IG), PyTorch port of `wam_tpu.tune.sweep`.

The workloads are the port's own builders at ``bench_workloads.py``'s
configurations (the reference's: audio 8 x 220,500 samples, AudioCNN (50
classes), db6 J=5, n=50, σ-spread 0.001; vol 8 x 1x32³ on the 3D ResNet-18
(10 classes), haar J=2, n=25; ViT-B/16 (1000 classes) IG on one 3x224²
image, haar J=3, 64 path points, the model in bfloat16), with seeded
weights. Each is measured by the autotuner's protocol
(`autotuner.measure_candidate`: CUDA events on the card, the host clock
elsewhere; the plane is printed). One JSON line per (workload, chunk).

    python -m wam_tpu_torch.tune.sweep audio 4 8 25 50
    python -m wam_tpu_torch.tune.sweep vol 5 25 --device cuda
    python -m wam_tpu_torch.tune.sweep vit 4 8 16
"""

from __future__ import annotations

import json
import sys

import torch

__all__ = ["audio_workload", "vol_workload", "vit_workload", "main"]


def audio_workload(chunk, *, b: int = 8, n: int = 50, wave_len: int = 220500,
                   compute_dtype=None, device="cuda"):
    """WAM-1D SmoothGrad on the ESC-50-shaped AudioCNN. Returns (explainer,
    x, y)."""
    from wam_tpu_torch.models.audio import AudioCNN, bind_audio_inference
    from wam_tpu_torch.wam1d import WaveletAttribution1D

    torch.manual_seed(0)
    fn = bind_audio_inference(AudioCNN(num_classes=50), compute_dtype=compute_dtype,
                              device=device)
    ex = WaveletAttribution1D(fn, wavelet="db6", J=5, method="smooth", n_samples=n,
                              stdev_spread=0.001, sample_batch_size=chunk, device=device)
    x = torch.randn((b, wave_len), generator=torch.Generator().manual_seed(3)).to(device)
    return ex, x, (torch.arange(b) % 50).to(device)


def vol_workload(chunk, *, b: int = 8, n: int = 25, size: int = 32, device="cuda"):
    """WAM-3D SmoothGrad on the 3D ResNet-18."""
    from wam_tpu_torch.models.resnet import bind_inference
    from wam_tpu_torch.models.resnet3d import resnet3d_18
    from wam_tpu_torch.wam3d import WaveletAttribution3D

    torch.manual_seed(0)
    fn = bind_inference(resnet3d_18(num_classes=10), device=device)
    ex = WaveletAttribution3D(fn, wavelet="haar", J=2, method="smooth", n_samples=n,
                              sample_batch_size=chunk, device=device)
    x = torch.randn((b, 1, size, size, size), generator=torch.Generator().manual_seed(4))
    return ex, x.to(device), (torch.arange(b) % 10).to(device)


def vit_workload(chunk, *, steps: int = 64, image: int = 224, compute_dtype=None,
                 device="cuda"):
    """WAM-2D IG on ViT-B/16."""
    from wam_tpu_torch.models.resnet import bind_inference
    from wam_tpu_torch.models.vit import vit_b16
    from wam_tpu_torch.wam2d import WaveletAttribution2D

    torch.manual_seed(0)
    fn = bind_inference(vit_b16(num_classes=1000), nchw=True, compute_dtype=compute_dtype,
                        device=device)
    ex = WaveletAttribution2D(fn, wavelet="haar", J=3, method="integratedgrad",
                              n_samples=steps, sample_batch_size=chunk, device=device)
    x = torch.randn((1, 3, image, image), generator=torch.Generator().manual_seed(5))
    return ex, x.to(device), torch.zeros((1,), dtype=torch.int64, device=device)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    from wam_tpu_torch.device import resolve_device

    device = None  # the card; an error without one
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    device = str(resolve_device(device))
    from wam_tpu_torch.config import enable_compilation_cache

    enable_compilation_cache()
    if not argv:
        sys.exit("usage: python -m wam_tpu_torch.tune.sweep {audio|vol|vit} [chunk ...] "
                 "[--device cuda|cpu]")
    kind = argv[0]
    chunks = [int(c) for c in argv[1:]] or [None]
    if kind not in ("audio", "vol", "vit"):
        sys.exit(f"unknown workload {kind!r}")

    from wam_tpu_torch.profiling import median_iqr
    from wam_tpu_torch.tune.autotuner import measure_candidate

    for chunk in chunks:
        if kind == "audio":
            ex, x, y = audio_workload(chunk, device=device)
        elif kind == "vol":
            ex, x, y = vol_workload(chunk, device=device)
        else:
            ex, x, y = vit_workload(chunk, compute_dtype=torch.bfloat16, device=device)
        samples, plane = measure_candidate(lambda x, y: ex(x, y), (x, y), k=3, laps=4)
        med, q1, q3, _ = median_iqr(samples)
        print(json.dumps({"device": device, "workload": kind, "chunk": chunk,
                          "step_s": round(med, 4), "q1_s": round(q1, 4), "q3_s": round(q3, 4),
                          "plane": plane, "items_per_s": round(x.shape[0] / med, 2)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
