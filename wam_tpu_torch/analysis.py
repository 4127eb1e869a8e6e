"""The fork's analytics (PyTorch port of `wam_tpu.analysis`): diagonal-block
extraction, cross-level pixel-wise variance ranking, per-level attribution
shares, and the cross-wavelet IoU of top-p% attribution masks (the metrics
behind the reference's `results/iou.csv` and `results/results_variance.csv`).

Everything but the reprojection is numpy on the host. `reprojection_map`
and the cross-wavelet functions reproject through the port's
`ops.packing2d.reproject_mosaic` on ``device`` (None: the card, or
RuntimeError), and read each map back once.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from wam_tpu_torch.device import resolve_device
from wam_tpu_torch.ops.packing2d import reproject_mosaic

__all__ = [
    "get_explanation_for_image",
    "get_diagonal",
    "get_mean_pixelwise_variance",
    "rank_images",
    "get_gradients_attribution_on_levels",
    "get_multiple_grad_attr",
    "get_mean_across_images",
    "top_percentage_mask",
    "iou",
    "mean_pairwise_iou",
    "cross_wavelet_iou",
    "cross_wavelet_reprojection_maps",
    "iou_from_reprojection_maps",
    "reprojection_map",
]


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def get_explanation_for_image(image, model_fn, explainer, preprocess) -> np.ndarray:
    """Single-image explanation at the model's argmax class. ``preprocess``
    maps the raw image to a (1, C, H, W) tensor."""
    x = preprocess(image)
    y = int(_host(model_fn(x)).argmax())
    return _host(explainer(x, [y])).squeeze()


def get_diagonal(grad_wam: np.ndarray, J: int) -> dict:
    """Diagonal blocks level_0 (finest) .. level_{J-1}, and the approximation."""
    grad_wam = _host(grad_wam)
    H, W = grad_wam.shape
    assert H == W, "grad_wam must be square"
    out = {}
    for j in range(J):
        s, e = H // (2 ** (j + 1)), H // (2**j)
        out[f"level_{j}"] = grad_wam[s:e, s:e]
    a = H // (2**J)
    out["approx"] = grad_wam[:a, :a]
    return out


def _zoom_linear_np(a: np.ndarray, target: int) -> np.ndarray:
    """The reference's resize for the variance experiment:
    ``scipy.ndimage.zoom(lvl, target / n, order=1)``, then a crop. Its
    origin-aligned sampling differs from a half-pixel bilinear resize at
    the edges, so the published variance numbers need zoom itself."""
    from scipy.ndimage import zoom

    scale = target / a.shape[0]
    return zoom(np.asarray(a, dtype=np.float64), scale, order=1)[:target, :target]


def get_mean_pixelwise_variance(grad_wam: np.ndarray, J: int, size: str = "maximal"):
    """Pixel-wise variance across the detail levels, resized to the largest
    or the smallest level. Returns (mean, variance map)."""
    diags = get_diagonal(grad_wam, J)
    details = [diags[f"level_{j}"] for j in range(J)]
    sizes = [d.shape[0] for d in details]
    if size == "maximal":
        target = max(sizes)
    elif size == "minimal":
        target = min(sizes)
    else:
        raise ValueError("size must be 'maximal' or 'minimal'")
    stack = np.stack([_zoom_linear_np(d, target) for d in details])
    var_map = stack.var(axis=0)
    return float(var_map.mean()), var_map


def rank_images(explanations: Sequence[np.ndarray], J: int, size: str = "maximal"):
    """Images sorted by cross-level variance, descending."""
    ranking = [
        {"image_index": i, "mean_pixelwise_variance": get_mean_pixelwise_variance(e, J, size)[0]}
        for i, e in enumerate(explanations)
    ]
    ranking.sort(key=lambda r: r["mean_pixelwise_variance"], reverse=True)
    return ranking


def get_gradients_attribution_on_levels(explanations: Sequence[np.ndarray], J: int):
    """Normalized per-level attribution mass, sum |grad| per diagonal block."""
    out = []
    for expl in explanations:
        sums = np.array([np.abs(v).sum() for v in get_diagonal(expl, J).values()])
        out.append(sums / sums.sum())
    return out


def get_multiple_grad_attr(explanations_per_model: Sequence[Sequence[np.ndarray]], J: int):
    """Per-(model, image) level shares."""
    return [get_gradients_attribution_on_levels(expls, J) for expls in explanations_per_model]


def get_mean_across_images(all_grads):
    """Mean level share per model."""
    return [np.asarray(g).mean(axis=0) for g in all_grads]


# -- cross-wavelet IoU ----------------------------------------------------------


def top_percentage_mask(a: np.ndarray, p: float) -> np.ndarray:
    """Boolean mask of the top-p fraction of values."""
    flat = np.asarray(a).ravel()
    k = max(1, int(len(flat) * p))
    thr = np.sort(flat)[::-1][k - 1]
    return np.asarray(a) >= thr


def iou(m1: np.ndarray, m2: np.ndarray) -> float:
    union = np.logical_or(m1, m2).sum()
    if union == 0:
        return 0.0
    return float(np.logical_and(m1, m2).sum() / union)


def mean_pairwise_iou(masks: Sequence[np.ndarray]) -> float:
    vals = [iou(masks[i], masks[j]) for i in range(len(masks)) for j in range(i + 1, len(masks))]
    return float(np.mean(vals)) if vals else 0.0


def reprojection_map(explanation, J: int, device=None) -> np.ndarray:
    """Mosaic -> mean over its per-level reprojections -> one pixel map,
    reprojected on ``device`` (a tensor already there is not copied)."""
    expl = torch.as_tensor(explanation, device=resolve_device(device))[None]
    return _host(reproject_mosaic(expl, J).mean(dim=1)[0])


def cross_wavelet_reprojection_maps(
    image,
    make_explainer: Callable[[str], Callable],
    wavelets: Sequence[str],
    model_fn,
    preprocess,
    J: int,
    device=None,
) -> list[np.ndarray]:
    """One reprojection pixel map per wavelet for ``image``: the expensive,
    p-independent half of the cross-wavelet IoU experiment. As in the
    reference, the mosaic is cropped to the input's resolution BEFORE the
    reprojection (longer filters grow the mosaic past the image, and
    crop-first against crop-last moves every block boundary)."""
    x = preprocess(image)  # (1, C, H, W)
    h, w = x.shape[-2:]
    y = int(_host(model_fn(x)).argmax())  # the class is wavelet-independent
    maps = []
    for wave in wavelets:
        expl = make_explainer(wave)(x, [y]).squeeze()
        maps.append(reprojection_map(expl[:h, :w], J, device))
    return maps


def iou_from_reprojection_maps(maps: Sequence[np.ndarray], p: float) -> float:
    """Mean pairwise IoU of the top-p% masks of precomputed reprojection
    maps: the cheap half, swept over p without explaining again."""
    return mean_pairwise_iou([top_percentage_mask(m, p) for m in maps])


def cross_wavelet_iou(
    image,
    make_explainer: Callable[[str], Callable],
    wavelets: Sequence[str],
    p: float,
    model_fn,
    preprocess,
    J: int,
    device=None,
) -> float:
    """Mean pairwise IoU of the top-p% reprojection masks across wavelets."""
    maps = cross_wavelet_reprojection_maps(
        image, make_explainer, wavelets, model_fn, preprocess, J, device
    )
    return iou_from_reprojection_maps(maps, p)
