"""Per-level attribution shares across models and wavelets on the PyTorch
port: the normalized per-level |gradient| mass for each (model, wavelet)
into ``<out>_variance.csv``, and the grouped bar plot
``<out>_mean_grads.png``.

    python examples/torch_level_attribution.py --quick --out levels   # on the card
    python examples/torch_level_attribution.py --quick --device cpu
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, HERE)  # _png, the figures' writer, beside this script

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--models", nargs="+", default=["resnet18", "convnext_tiny"])
    parser.add_argument("--wavelet", default="haar")
    parser.add_argument("--levels", type=int, default=3)
    parser.add_argument("--n-images", type=int, default=4)
    parser.add_argument("--samples", type=int, default=25)
    parser.add_argument("--size", type=int, default=224)
    parser.add_argument("--device", default="auto",
                        help="auto (the CUDA card, or an error without one), cuda[:i] or cpu")
    parser.add_argument("--out", default="levels")
    parser.add_argument("--quick", action="store_true")
    args = parser.parse_args(argv)

    import torch

    from wam_tpu_torch import WaveletAttribution2D
    from wam_tpu_torch.analysis import (
        get_gradients_attribution_on_levels,
        get_mean_across_images,
        rank_images,
    )
    from wam_tpu_torch.data import build_vision_model
    from wam_tpu_torch.device import resolve_device

    import _png

    device = resolve_device(args.device)
    if args.quick:
        args.size, args.samples, args.n_images = 64, 4, 2

    rng = np.random.default_rng(0)
    images = [rng.standard_normal((3, args.size, args.size)).astype(np.float32)
              for _ in range(args.n_images)]

    per_model = []
    for name in args.models:
        _, _, model_fn = build_vision_model(name, image_size=args.size, device=device)
        explainer = WaveletAttribution2D(model_fn, wavelet=args.wavelet, J=args.levels,
                                         method="smooth", n_samples=args.samples, device=device)
        explanations = []
        for img in images:
            x = torch.as_tensor(img, device=device)[None]
            with torch.no_grad():
                y = int(model_fn(x).argmax())
            mosaic = explainer(x, torch.tensor([y], device=device))[0]
            explanations.append(mosaic.detach().cpu().numpy())
        shares = get_gradients_attribution_on_levels(explanations, args.levels)
        per_model.append(shares)
        ranked = rank_images(explanations, args.levels)
        print(f"{name}: per-level shares mean={np.mean(shares, axis=0)}, "
              f"variance ranking={ranked}")

    means = get_mean_across_images(per_model)
    stds = [np.asarray(g).std(axis=0) for g in per_model]
    with open(f"{args.out}_variance.csv", "w") as f:
        header = ",".join(f"level_{j}_mean,level_{j}_std" for j in range(args.levels + 1))
        # provenance column: seeded models on random noise images, not
        # comparable to results from trained weights on real images
        f.write(f"model,{header},provenance\n")
        for name, mean, std in zip(args.models, means, stds):
            cells = ",".join(f"{m},{s}" for m, s in zip(mean, std))
            f.write(f"{name},{cells},random-noise-images+random-init\n")

    # the mean per-level shares: one group of bars a level, one bar a model
    _png.write_png(f"{args.out}_mean_grads.png", _png.bars(np.asarray(means).T))
    print(f"wrote {args.out}_variance.csv and {args.out}_mean_grads.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
