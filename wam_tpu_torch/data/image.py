"""Image data (PyTorch port of `wam_tpu.data.image`): the reference's
preprocessing (resize the shorter side, center crop, ImageNet
standardization) in PIL and numpy, the assets and ImageNet-validation
loaders, and the display helpers. PIL and matplotlib are imported inside
the functions that use them; arrays come back as numpy, for
`upload`-ing to the device."""

from __future__ import annotations

import json
import os

import numpy as np

from wam_tpu_torch.optional import require

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

__all__ = [
    "preprocess_image",
    "load_images",
    "load_imagenet_validation",
    "show",
    "get_alpha_cmap",
]


def preprocess_image(img, resize: int = 256, crop: int | None = 224,
                     normalize: bool = True) -> np.ndarray:
    """PIL image (or an array PIL can read) -> (3, H, W) float32: the
    shorter side resized (bilinear) and a center crop, or with
    ``crop=None`` a resize to (resize, resize); ImageNet-standardized when
    ``normalize``."""
    Image = require("PIL.Image", "preprocess_image")
    if not hasattr(img, "convert"):
        img = Image.fromarray(np.asarray(img))
    img = img.convert("RGB")
    if crop is None:
        img = img.resize((resize, resize), Image.BILINEAR)
    else:
        w, h = img.size
        scale = resize / min(w, h)
        img = img.resize((round(w * scale), round(h * scale)), Image.BILINEAR)
        w, h = img.size
        left, top = (w - crop) // 2, (h - crop) // 2
        img = img.crop((left, top, left + crop, top + crop))
    arr = np.asarray(img, dtype=np.float32) / 255.0  # (H, W, 3)
    if normalize:
        arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return arr.transpose(2, 0, 1)


def load_images(source_dir: str | None = None, label_file: str = "labels.json",
                labels=None, images_dir: str | None = None):
    """Assets-style loader: ``source_dir/assets`` with a labels.json mapping
    name -> class (resized to 224 x 224), or ``images_dir`` with ``labels``
    in sorted-name order (256 resize, 224 crop). Returns ((N, 3, 224, 224)
    float32, labels)."""
    Image = require("PIL.Image", "load_images")
    if labels is None:
        images_dir = os.path.join(source_dir, "assets")
        with open(os.path.join(images_dir, label_file)) as f:
            mapping = json.load(f)
        names, labels_list = list(mapping.keys()), list(mapping.values())
        crop = None  # the reference resizes to (224, 224) here
    else:
        names, labels_list = sorted(os.listdir(images_dir)), labels
        crop = 224
    stack = [
        preprocess_image(Image.open(os.path.join(images_dir, n)),
                         resize=224 if crop is None else 256, crop=crop)
        for n in names
    ]
    return np.stack(stack), labels_list


def load_imagenet_validation(source_dir: str, ground_truth: str = "val.txt",
                             count: int = 1000, seed: int = 42):
    """A folder of .JPEG validation images and a ``name label`` text file."""
    Image = require("PIL.Image", "load_imagenet_validation")
    with open(os.path.join(source_dir, ground_truth)) as f:
        gt = {line.split()[0]: int(line.split()[1]) for line in f if line.strip()}
    examples = [e for e in sorted(os.listdir(source_dir)) if e.endswith(".JPEG")]
    if len(examples) != count:
        raise ValueError(f"expected {count} images, found {len(examples)}")
    images = [preprocess_image(Image.open(os.path.join(source_dir, e))) for e in examples]
    return np.stack(images), [gt[e] for e in examples]


def show(img, p=False, inverse_c: bool = False, plot: bool = True, **kwargs):
    """An image as displayed: channels moved last, out-of-range data min-max
    normalized, an optional percentile clip; drawn with matplotlib when
    ``plot``, else returned."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    img = np.array(img, dtype=np.float32)
    if img.ndim == 3 and img.shape[0] == 1:
        img = img[0]
    elif img.ndim == 3 and img.shape[0] == 3:
        img = np.moveaxis(img, 0, 2)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[:, :, 0]
    if img.max() > 1 or img.min() < 0:
        img = img - img.min()
        img = img / (img.max() if img.max() else 1.0)
    if p is not False:
        img = np.clip(img, np.percentile(img, p), np.percentile(img, 100 - p))
    if img.ndim == 3 and img.shape[-1] == 3 and inverse_c:
        img = img[..., ::-1]
    if plot:
        plt = require("matplotlib.pyplot", "show")
        plt.imshow(img, **kwargs)
        plt.axis("off")
        plt.grid(None)
        return None
    return img


def get_alpha_cmap(cmap, min_alpha: float = 0.0):
    """A colormap with an alpha ramp, for heatmap overlays: a named map, or
    one RGB color (0-255) ramped to its brightest shade."""
    import colorsys

    matplotlib = require("matplotlib", "get_alpha_cmap")
    plt = require("matplotlib.pyplot", "get_alpha_cmap")
    colors_mod = require("matplotlib.colors", "get_alpha_cmap")
    if isinstance(cmap, str):
        base = plt.get_cmap(cmap)
        colors = base(np.arange(base.N))
    else:
        c = np.array(cmap, dtype=np.float64) / 255.0
        hls = np.array(colorsys.rgb_to_hls(*c))
        hls[-1] = 1.0
        cmax = np.clip(np.array(colorsys.hls_to_rgb(*hls)), 0, 1)
        lin = matplotlib.colors.LinearSegmentedColormap.from_list("", [c, cmax])
        colors = lin(np.arange(256))
    colors[:, -1] = np.linspace(min_alpha, 0.85, len(colors))
    return colors_mod.ListedColormap(colors)
