"""Quick-start on the PyTorch port: ResNet + image -> WAM mosaic plot,
runnable without any downloads. Pass --image / --checkpoint for real data;
otherwise a synthetic image and a seeded ResNet-18 are used.

    python examples/torch_quickstart.py --out wam_mosaic.png            # on the card
    python examples/torch_quickstart.py --device cpu --size 64 --samples 4

``--layout nchw`` (the default) runs the transforms through the port's
wavelet kernels on the card; ``nhwc`` binds the model channel-last and runs
the NHWC transforms (dense contractions, no kernel).
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, HERE)  # _png, the figures' writer, beside this script

import numpy as np


def synthetic_image(size: int) -> np.ndarray:
    """(1, 3, size, size) float32: crossed sines and a little seeded noise."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:size, 0:size] / size
    synth = np.stack([np.sin(12 * xx) * np.cos(9 * yy)] * 3) + 0.1 * rng.standard_normal(
        (3, size, size))
    return synth[None].astype(np.float32)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--image", default=None, help="path to an input image")
    parser.add_argument("--checkpoint", default=None, help="torch ResNet state-dict path")
    parser.add_argument("--model", default="resnet18")
    parser.add_argument("--wavelet", default="haar")
    parser.add_argument("--levels", type=int, default=3)
    parser.add_argument("--device", default="auto",
                        help="auto (the CUDA card, or an error without one), cuda[:i] or cpu")
    parser.add_argument("--out", default="wam_mosaic.png")
    parser.add_argument("--samples", type=int, default=25)
    parser.add_argument("--size", type=int, default=224)
    parser.add_argument("--layout", default="nchw", choices=["nhwc", "nchw"],
                        help="nchw = the wavelet kernels' route (default); nhwc = the model "
                             "channel-last and the NHWC transforms")
    args = parser.parse_args(argv)

    import torch

    from wam_tpu_torch import WaveletAttribution2D
    from wam_tpu_torch.data import build_vision_model, preprocess_image
    from wam_tpu_torch.device import resolve_device

    import _png

    device = resolve_device(args.device)
    if args.image:
        from PIL import Image

        x = preprocess_image(Image.open(args.image))[None]
    else:
        x = synthetic_image(args.size)

    # __call__ takes NCHW input in either layout; "nhwc" binds the model
    # channel-last and runs the whole engine channel-last
    nhwc = args.layout == "nhwc"
    _, _, model_fn = build_vision_model(args.model, checkpoint_path=args.checkpoint,
                                        image_size=x.shape[-1], nchw=not nhwc, device=device)
    xin = torch.as_tensor(x, device=device)
    with torch.no_grad():
        y = int(model_fn(xin.permute(0, 2, 3, 1) if nhwc else xin).argmax())
    print(f"explaining class {y}")

    explainer = WaveletAttribution2D(model_fn, wavelet=args.wavelet, J=args.levels,
                                     method="smooth", n_samples=args.samples,
                                     model_layout=args.layout, device=device)
    mosaic = explainer(xin, torch.tensor([y], device=device))

    _png.write_png(args.out, _png.heatmap(mosaic[0]))
    print(f"wrote {args.out}; per-level maps shape: {tuple(explainer.scales.shape)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
