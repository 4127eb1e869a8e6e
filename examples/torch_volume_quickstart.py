"""3D quick-start on the PyTorch port: WAM-3D on a voxel volume (3D DWT ->
IDWT -> 3D CNN -> gradients -> dyadic cube), the ``y=None`` representation
mode and the per-level maps. Runs without downloads: a synthetic blob and a
seeded VoxelModel; pass --h5 at a 3D-MNIST dataset root / --checkpoint for
real data.

    python examples/torch_volume_quickstart.py --quick --out volume.png   # on the card
    python examples/torch_volume_quickstart.py --quick --device cpu
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, HERE)  # _png, the figures' writer, beside this script

import numpy as np


def synthetic_blob(s: int) -> np.ndarray:
    g = np.mgrid[0:s, 0:s, 0:s] / s - 0.5
    r = np.sqrt((g**2).sum(axis=0))
    vol = (r < 0.3).astype(np.float32) + 0.1 * np.random.default_rng(0).standard_normal((s, s, s))
    return vol.astype(np.float32)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--h5", default=None,
                        help="dataset root containing 3DMNIST/full_dataset_vectors.h5")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--wavelet", default="haar")
    parser.add_argument("--levels", type=int, default=2)
    parser.add_argument("--samples", type=int, default=25)
    parser.add_argument("--size", type=int, default=16)
    parser.add_argument("--device", default="auto",
                        help="auto (the CUDA card, or an error without one), cuda[:i] or cpu")
    parser.add_argument("--out", default="volume.png")
    parser.add_argument("--quick", action="store_true")
    args = parser.parse_args(argv)

    import torch

    from wam_tpu_torch import WaveletAttribution3D
    from wam_tpu_torch.data.checkpoints import load_3dvoxel_model
    from wam_tpu_torch.device import resolve_device

    import _png

    device = resolve_device(args.device)
    if args.quick:
        args.samples = 4
    if args.h5:
        from wam_tpu_torch.data.mnist3d import load_3dvoxel_mnist

        (vols_test, _), _ = load_3dvoxel_mnist(args.h5)
        vol = np.asarray(vols_test[0])
    else:
        vol = synthetic_blob(args.size)

    _, _, model_fn = load_3dvoxel_model(args.checkpoint, num_classes=10, size=vol.shape[-1],
                                        device=device)
    x = torch.as_tensor(vol, device=device)[None, None]  # (B, 1, S, S, S)
    with torch.no_grad():
        y = int(model_fn(x).argmax())
    print(f"explaining class {y}")

    explainer = WaveletAttribution3D(model_fn, wavelet=args.wavelet, J=args.levels,
                                     method="smooth", n_samples=args.samples, device=device)
    cube = explainer(x, torch.tensor([y], device=device)).detach().cpu().numpy()
    print("gradient cube:", cube.shape)

    # representation mode: explain the mean embedding, no label needed
    cube_repr = explainer(x, None).detach().cpu().numpy()
    per_level = explainer.visualize()
    print("representation-mode cube:", cube_repr.shape,
          "| per-level maps:", tuple(per_level.shape))

    mid = vol.shape[-1] // 2
    # the volume, the WAM cube (labeled) and the WAM cube (y=None), mid slices
    _png.write_png(args.out, _png.panels([_png.heatmap(vol[:, :, mid], "gray"),
                                          _png.heatmap(cube[0][:, :, mid], "coolwarm"),
                                          _png.heatmap(cube_repr[0][:, :, mid], "coolwarm")]))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
