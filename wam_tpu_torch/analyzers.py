"""Scale analyzers (PyTorch port of `wam_tpu.analyzers`): decompose an image
into per-scale partial images, and search for the smallest set of wavelet
components that keeps the prediction.

Each image's masked reconstructions are one masked multiply of its packed
coefficients and one batched `waverec2`: on CUDA tensors, at haar J=3 and
224², one decomposition is 3 K1 launches and the whole family's synthesis
one K3 forward over masks x 3 channels rows, reading the masked packed
array in place. The quantile sweep runs every quantile's reconstruction in
one model call an image and reads the class probabilities back once an
image, as the reference does; the reconstructions and masks it returns stay
on the device.

The quantile thresholds follow the reference's arithmetic (``jnp.quantile``,
method "linear", as XLA compiles it): the sorted values lo and hi at floor
and ceil of q (n - 1) in float32, and the threshold fma(hi, w, lo (1 - w)),
one fused multiply-add (XLA contracts the weighted sum). The port rounds
lo (1 - w) to float32, then adds hi w in float64, where the product is
exact, and rounds once. ``torch.quantile`` rounds its interpolation another
way, which flips ``wam >= thr`` at the cells next to a threshold, and
refuses inputs over 2^24 elements (a 224² mosaic is far below that).
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import numpy as np
import torch

from wam_tpu_torch.device import resolve_device
from wam_tpu_torch.evalsuite.eval2d import _minmax01, imagenet_denormalize, imagenet_preprocess
from wam_tpu_torch.evalsuite.fan import upload
from wam_tpu_torch.evalsuite.metrics import host_labels, softmax_probs
from wam_tpu_torch.evalsuite.packing import array_to_coeffs2d, coeff_shapes2d, coeffs_to_array2d
from wam_tpu_torch.ops.filters import upsample_nearest
from wam_tpu_torch.wavelets.transform import wavedec2, waverec2

__all__ = [
    "compute_levelized_masks",
    "generate_partial_image",
    "generate_disentangled_images",
    "WAMAnalyzer2D",
    "WAMAnalyzerViT",
]


def compute_levelized_masks(grad_wam: torch.Tensor, J: int) -> torch.Tensor:
    """(S, S) mosaic -> (J+1, S, S): per-level masks carrying that level's
    H/V/D blocks (finest first), the last the approximation corner."""
    size = grad_wam.shape[-1]
    out = grad_wam.new_zeros((J + 1, size, size))
    for j in range(J):
        s = size // (2 ** (j + 1))
        e = size // (2**j)
        out[j, s:e, s:e] = grad_wam[s:e, s:e]
        out[j, s:e, :s] = grad_wam[s:e, :s]
        out[j, :s, s:e] = grad_wam[:s, s:e]
    sa = size // (2**J)
    out[J, :sa, :sa] = grad_wam[:sa, :sa]
    return out


@functools.lru_cache(maxsize=64)
def _quantile_plan(qs: tuple, n: int, device) -> tuple[torch.Tensor, ...]:
    """Positions and weights of ``jnp.quantile``'s linear method over n
    sorted values, in its float32 arithmetic: q (n - 1), its floor and ceil
    (clamped to [0, n - 1]), w = q (n - 1) - floor and 1 - w. Built once per
    (qs, n, device): a copy from host memory waits for the queue."""
    f32 = np.float32
    pos = np.asarray(qs, dtype=f32) * (f32(n) - f32(1))
    low, high = np.floor(pos), np.ceil(pos)
    hw = (pos - low).astype(f32)
    lw = (f32(1) - hw).astype(f32)
    idx = [np.clip(v, 0, n - 1).astype(np.int64) for v in (low, high)]
    return tuple(torch.as_tensor(a, device=device) for a in (*idx, lw, hw))


def quantile(a: torch.Tensor, qs: Sequence[float]) -> torch.Tensor:
    """``jnp.quantile(a, qs)`` (flattened, method "linear"), value for
    value: (len(qs),)."""
    flat = torch.sort(a.reshape(-1)).values
    low, high, lw, hw = _quantile_plan(tuple(float(q) for q in qs), flat.numel(), flat.device)
    low_part = flat[low] * lw.to(flat.dtype)
    return (flat[high].double() * hw.double() + low_part.double()).to(flat.dtype)


def _masked_rec(image: torch.Tensor, masks: torch.Tensor, J: int, wavelet: str,
                mode: str = "reflect", impl: str | None = None) -> torch.Tensor:
    """image (3, H, W) x packed-domain masks (M, Ph, Pw) -> (M, 3, H, W);
    masks of another size are resized to the packed array's (nearest, the
    reference's half-pixel rule)."""
    H, W = image.shape[-2:]
    coeffs = wavedec2(image, wavelet, J, mode, impl=impl)
    packed = coeffs_to_array2d(coeffs)
    if tuple(masks.shape[-2:]) != tuple(packed.shape[-2:]):
        masks = upsample_nearest(masks, packed.shape[-2:])
    rec = waverec2(array_to_coeffs2d(packed[None] * masks[:, None], coeff_shapes2d(coeffs)),
                   wavelet, impl=impl)
    return rec[..., :H, :W]


def generate_partial_image(image: torch.Tensor, grad_wam: torch.Tensor, q: float, J: int,
                           wavelet: str = "haar", impl: str | None = None):
    """The reconstruction that keeps the coefficients at or above the q-th
    quantile of the mosaic. Returns (image (3, H, W), the filtered mosaic)."""
    thr = quantile(grad_wam, (q,))[0]
    mask = (grad_wam >= thr).to(image.dtype)
    rec = _masked_rec(image, mask[None], J, wavelet, impl=impl)[0]
    return rec, mask * grad_wam


def generate_disentangled_images(grad_wam: torch.Tensor, image: torch.Tensor, J: int,
                                 EPS: float = 0.1, wavelet: str = "haar",
                                 impl: str | None = None):
    """Per-level partial images (J+1, 3, H, W) and the levelized masks: a
    level keeps the cells above min + EPS. The reconstruction pads in the
    reference's default mode, "reflect", whatever the analyzer's mode."""
    masks = compute_levelized_masks(grad_wam, J)
    binary = (masks > (masks.min() + EPS)).to(image.dtype)
    partial = _masked_rec(image, binary, J, wavelet, impl=impl)
    return partial, masks


class WAMAnalyzerViT:
    """Token-grid aggregation of patch-aligned WAM mosaics. ``explainer`` must
    be a `WaveletAttribution2D` built with ``level_plan="patch"``, which
    waits for slice D (ROADMAP.md); any other explainer raises the
    reference's ValueError."""

    def __init__(self, explainer):
        plan = getattr(explainer, "patch_plan", None)
        if plan is None:
            raise ValueError(
                "WAMAnalyzerViT needs an explainer constructed with "
                "level_plan='patch' (WaveletAttribution2D) — an explicit-J "
                "explainer carries no token grid to aggregate onto"
            )
        self.explainer = explainer
        self.plan = plan

    def token_maps(self, x, y=None):
        raise NotImplementedError("token_maps needs level_plan='patch' (ROADMAP.md, slice D)")

    def token_importance(self, x, y=None):
        return self.token_maps(x, y).sum(dim=1)


class WAMAnalyzer2D:
    """The reference's scale analyzer. ``explainer``: (x, y) -> (B, S, S)
    mosaics (e.g. `WaveletAttribution2D`); ``model_fn``: (B, 3, H, W) ->
    logits. ``device``: where the analysis runs, CUDA unless the caller asks
    otherwise; ``impl``: the transforms' implementation
    (`wavelets.transform`; None is the kernels on CUDA)."""

    def __init__(
        self,
        model_fn: Callable[[torch.Tensor], torch.Tensor],
        explainer: Callable,
        wavelet: str = "haar",
        J: int = 3,
        mode: str = "reflect",
        denormalize_fn: Callable = imagenet_denormalize,
        preprocess_fn: Callable = imagenet_preprocess,
        device=None,
        impl: str | None = None,
    ):
        self.device = resolve_device(device)
        self.model_fn = model_fn
        self.explainer = explainer
        self.wavelet = wavelet
        self.J = J
        self.mode = mode
        self.denormalize_fn = denormalize_fn
        self.preprocess_fn = preprocess_fn
        self.impl = impl
        self.grad_wams = None
        self.insertion_quantile: list = []
        self.deletion_quantile: list = []

    def precompute(self, x, y):
        """The explanations of the first batch, cached on the instance."""
        if self.grad_wams is None:
            self.grad_wams = upload(self.explainer(x, y), self.device)
        return self.grad_wams

    def isolate_scales(self, x, y, EPS: float = 0.1):
        """Per image, (partial images (J+1, 3, H, W), masks (J+1, S, S)).
        No host wait: everything stays on the device."""
        x = upload(x, self.device)
        wams = self.precompute(x, y)
        return [generate_disentangled_images(wams[i], self.denormalize_fn(x[i]), self.J,
                                             EPS=EPS, wavelet=self.wavelet, impl=self.impl)
                for i in range(x.shape[0])]

    def isolate_necessary_components(self, x, y, qs: Sequence[float], mode: str):
        """Quantile sweep: the reconstructions at every q of ``qs`` in one
        model call an image; insertion keeps the first correctly predicted
        one, deletion the last, and records its quantile in
        ``insertion_quantile`` / ``deletion_quantile``. Per image:
        ((first, kept, last reconstruction), kept mask x mosaic, mosaic,
        (class probabilities (Q, K) as numpy, kept index)), the tensors on
        the device, or ((None, None, None), None, mosaic, (None, nan)) when
        no reconstruction predicts the true class. One host fetch an image:
        the probabilities."""
        if mode not in ("insertion", "deletion"):
            raise ValueError("mode must be 'insertion' or 'deletion'")
        qs = list(qs)
        if mode == "deletion" and len(qs) > 1:
            assert qs[0] <= qs[1]
        if mode == "insertion" and len(qs) > 1:
            assert qs[0] >= qs[1]

        x = upload(x, self.device)
        y = host_labels(y)
        wams = self.precompute(x, y)

        outs = []
        for i in range(x.shape[0]):
            image01 = self.denormalize_fn(x[i])
            wam = wams[i]
            thr = quantile(wam, qs)
            masks = (wam[None] >= thr[:, None, None]).to(x.dtype)
            recs = _masked_rec(image01, masks, self.J, self.wavelet, self.mode, self.impl)
            inputs = self.preprocess_fn(_minmax01(recs))
            probs = softmax_probs(self.model_fn(inputs)).float().cpu().numpy()
            correct = np.where(probs.argmax(axis=1) == y[i])[0]
            if len(correct):
                idx = int(correct[-1] if mode == "deletion" else correct[0])
                (self.deletion_quantile if mode == "deletion"
                 else self.insertion_quantile).append(qs[idx])
                outs.append(((recs[0], recs[idx], recs[-1]), masks[idx] * wam, wam,
                             (probs, idx)))
            else:
                outs.append(((None, None, None), None, wam, (None, np.nan)))
        return outs
