"""Cross-wavelet IoU experiment on the PyTorch port: for each top-p
fraction, explain each image with WAM-IG under several wavelets, take the
top-p% masks of the mean reprojection map, and record the mean pairwise IoU
across wavelet pairs. Writes ``iou.csv`` in the layout of the published
``results/iou.csv``.

Runs without downloads (synthetic images and a seeded ConvNeXt-Tiny by
default); point --images at a directory of images and --checkpoint at a
state dict for the real experiment, and add --assert-reference to hold the
IoUs to the published table.

    python examples/torch_iou_experiment.py --out iou.csv --quick   # on the card
    python examples/torch_iou_experiment.py --quick --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

# The published cross-wavelet IoU table (`results/iou.csv`; wavelets
# haar/db4/sym4/sym8, mean pairwise IoU per image, then the mean over the
# images, the computation below). --assert-reference compares with it:
# with trained weights and the same images the values must agree.
REFERENCE_IOU = {
    0.05: 0.156, 0.10: 0.234, 0.15: 0.293, 0.20: 0.340, 0.25: 0.384,
    0.30: 0.425, 0.35: 0.466, 0.40: 0.506, 0.45: 0.547, 0.50: 0.587,
}


def synthetic_images(n: int, size: int) -> list:
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        yy, xx = np.mgrid[0:size, 0:size] / size
        base = np.sin((8 + i) * xx) * np.cos((5 + i) * yy)
        img = np.stack([base] * 3) + 0.1 * rng.standard_normal((3, size, size))
        out.append(img.astype(np.float32))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--images", default=None, help="directory of images")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--model", default="convnext_tiny")
    parser.add_argument("--wavelets", nargs="+", default=["haar", "db4", "sym4", "sym8"])
    parser.add_argument("--levels", type=int, default=3)
    parser.add_argument("--ps", nargs="+", type=float,
                        default=[0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4, 0.45, 0.5])
    parser.add_argument("--samples", type=int, default=25, help="IG path steps")
    parser.add_argument("--size", type=int, default=224)
    parser.add_argument("--device", default="auto",
                        help="auto (the CUDA card, or an error without one), cuda[:i] or cpu")
    parser.add_argument("--out", default="iou.csv")
    parser.add_argument("--quick", action="store_true", help="tiny shapes, 2 images")
    parser.add_argument(
        "--assert-reference", action="store_true",
        help="diff the produced IoUs against the published results/iou.csv values and exit "
             "nonzero on disagreement (meaningful with --images and --checkpoint)")
    parser.add_argument("--reference-atol", type=float, default=0.03,
                        help="tolerance for --assert-reference")
    args = parser.parse_args(argv)

    import torch

    from wam_tpu_torch import WaveletAttribution2D
    from wam_tpu_torch.analysis import cross_wavelet_reprojection_maps, iou_from_reprojection_maps
    from wam_tpu_torch.data import build_vision_model, preprocess_image
    from wam_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    if args.quick:
        args.size, args.samples, args.ps = 64, 4, args.ps[:3]

    if args.images:
        from PIL import Image

        paths = sorted(os.path.join(args.images, f) for f in os.listdir(args.images)
                       if f.lower().endswith((".jpg", ".jpeg", ".png")))
        # the 256-resize / 224-crop ratio at whatever --size
        images = [preprocess_image(Image.open(p), resize=round(args.size * 256 / 224),
                                   crop=args.size) for p in paths]
    else:
        images = synthetic_images(2 if args.quick else 5, args.size)

    _, _, model_fn = build_vision_model(args.model, checkpoint_path=args.checkpoint,
                                        image_size=args.size, device=device)

    def make_explainer(wavelet: str):
        return WaveletAttribution2D(model_fn, wavelet=wavelet, J=args.levels,
                                    method="integratedgrad", n_samples=args.samples,
                                    device=device)

    # the explanations do not depend on p: one map set an image, then the
    # top-p threshold swept over the cached maps
    map_sets = [cross_wavelet_reprojection_maps(
        img, make_explainer, args.wavelets, model_fn,
        preprocess=lambda im: torch.as_tensor(im, device=device)[None], J=args.levels,
        device=device) for img in images]
    rows = []
    for p in args.ps:
        ious = [iou_from_reprojection_maps(maps, p) for maps in map_sets]
        rows.append((p, float(np.mean(ious))))
        print(f"p={p:.2f}  mean IoU={rows[-1][1]:.3f}")

    # provenance: runs on synthetic images or seeded weights must not pass
    # for the published numbers
    img_src = "image-dir" if args.images else "synthetic-sines"
    init_src = "checkpoint" if args.checkpoint else "random-init"
    provenance = f"{img_src}+{init_src}"
    comparable = bool(args.images and args.checkpoint)
    with open(args.out, "w") as f:
        f.write(",iou,provenance,comparable_to_reference\n")
        for p, v in rows:
            f.write(f"{p},{v},{provenance},{comparable}\n")
    print(f"wrote {args.out} (provenance: {provenance})")

    if args.assert_reference:
        if not comparable:
            print("WARNING: --assert-reference on a synthetic/random-init run is not a "
                  "quality-parity claim (pass --images and --checkpoint); diffing anyway:")
        worst, matched = 0.0, 0
        for p, v in rows:
            ref = REFERENCE_IOU.get(round(p, 2))
            if ref is None:
                print(f"p={p:.2f}  ours={v:.3f}  (no reference row — skipped)")
                continue
            matched += 1
            diff = abs(v - ref)
            worst = max(worst, diff)
            flag = "OK" if diff <= args.reference_atol else "MISMATCH"
            print(f"p={p:.2f}  ours={v:.3f}  reference={ref:.3f}  |diff|={diff:.3f}  {flag}")
        if matched == 0:
            sys.exit("quality-parity INCONCLUSIVE: none of the requested --ps values match a "
                     f"published reference row ({sorted(REFERENCE_IOU)})")
        if worst > args.reference_atol:
            sys.exit(f"quality-parity FAILED: worst |diff|={worst:.3f} > "
                     f"atol={args.reference_atol}")
        print(f"quality-parity OK over {matched} rows: worst |diff|={worst:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
