"""Eval2DWAM: faithfulness of 2D wavelet attributions (PyTorch port of
`wam_tpu.evalsuite.eval2d`): insertion and deletion AUC (Petsiuk et al.) and
μ-fidelity (Bhatt et al.).

Each image's mask family is one masked multiply of its packed coefficients
and one batched inverse transform, the model runs every perturbed image of
a chunk in one call, and each metric call ends in one counted fetch. An
image is decomposed once per metric call (the reference decomposes it twice
a fan, and four times for μ, and relies on XLA to merge the copies): on
CUDA tensors that is three K1 launches an image for its three analysis
levels at haar J=3, and each reconstruction family is one K3 launch over
M masks x 3 channels rows, forward only, reading the masked packed array in
place (`packing.array_to_coeffs2d` gives views).

Explanations are computed once and cached on the instance
(`precompute` / `reset`); assigning ``grad_wams`` hands them over.
Perturbation is on [0, 1] images: each input is denormalized, perturbed in
the wavelet domain, reconstructed, min-max rescaled per image and
preprocessed again (ImageNet normalization by default).
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from wam_tpu_torch.config import PrecisionPolicy
from wam_tpu_torch.device import resolve_device
from wam_tpu_torch.evalsuite.fan import (
    FanPlan,
    cast_model_fn,
    check_ported,
    fan_runner,
    make_chunked_forward,
    plan_fan,
    run_fan,
    upload,
)
from wam_tpu_torch.evalsuite.metrics import (
    batch_fingerprint,
    generate_masks,
    host_labels,
    mu_fidelity_draws,
    run_cached_auc,
    softmax_probs,
    spearman,
)
from wam_tpu_torch.evalsuite.packing import (
    array_to_coeffs2d,
    coeff_shapes2d,
    coeffs_to_array2d,
    packed2d_shape,
)
from wam_tpu_torch.ops.filters import gaussian_filter2d, superpixel_sum, upsample_nearest
from wam_tpu_torch.wavelets.transform import wavedec2, waverec2

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

__all__ = ["Eval2DWAM", "imagenet_preprocess", "imagenet_denormalize"]


@functools.lru_cache(maxsize=16)
def _imagenet_stats(device) -> tuple[torch.Tensor, torch.Tensor]:
    # built once per device: a copy from host memory waits for the queue
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device).reshape(3, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device).reshape(3, 1, 1)
    return mean, std


def imagenet_preprocess(img01: torch.Tensor) -> torch.Tensor:
    """[0, 1] image (..., 3, H, W) -> standardized."""
    mean, std = _imagenet_stats(img01.device)
    return (img01 - mean) / std


def imagenet_denormalize(x: torch.Tensor) -> torch.Tensor:
    """Standardized tensor -> [0, 1] image, clipped."""
    mean, std = _imagenet_stats(x.device)
    return torch.clamp(x * std + mean, 0.0, 1.0)


def _minmax01(a: torch.Tensor) -> torch.Tensor:
    """Each image rescaled to [0, 1] over its (C, H, W)."""
    lo = a.amin(dim=(-3, -2, -1), keepdim=True)
    hi = a.amax(dim=(-3, -2, -1), keepdim=True)
    return (a - lo) / torch.where(hi > lo, hi - lo, 1.0)


class Eval2DWAM:
    """Faithfulness evaluation of a 2D wavelet attribution explainer.

    ``explainer``: (x, y) -> (B, S, S) attribution mosaics (e.g.
    `WaveletAttribution2D`). ``model_fn``: (B, 3, H, W) -> logits.
    Constructor arguments are frozen configuration.

    ``batch_size`` caps the model rows a call (``"auto"``: 128).
    ``precision``: a `config.PrecisionPolicy`, a ``fan_dtype`` string, or
    None (``WAM_TPU_FAN_DTYPE``, then float32). ``device``: where the
    metrics run, CUDA unless the caller asks otherwise. ``impl``: the
    transforms' implementation (`wavelets.transform`; None is the kernels
    on CUDA). ``mesh``: a `parallel.Mesh`; every metric's fan splits its
    images over ``data_axis`` (`fan.make_sharded_runner`), still one
    result fetch a call. ``aot_key`` and ``donate_inputs=True`` are not
    ported yet and raise.
    """

    def __init__(
        self,
        model_fn: Callable[[torch.Tensor], torch.Tensor],
        explainer: Callable,
        wavelet: str = "haar",
        J: int = 3,
        mode: str = "reflect",
        batch_size: int | str = 128,
        denormalize_fn: Callable = imagenet_denormalize,
        preprocess_fn: Callable = imagenet_preprocess,
        random_seed: int = 42,
        mesh=None,
        data_axis: str = "data",
        donate_inputs: bool | None = None,
        aot_key: str | None = None,
        precision=None,
        device=None,
        impl: str | None = None,
    ):
        check_ported(donate=donate_inputs, aot_key=aot_key)
        self.mesh = mesh
        self.data_axis = data_axis
        self.device = resolve_device(device)
        self.model_fn = model_fn
        self.explainer = explainer
        self.wavelet = wavelet
        self.J = J
        self.mode = mode
        self.batch_size = batch_size
        self.denormalize_fn = denormalize_fn
        self.preprocess_fn = preprocess_fn
        self.random_seed = random_seed
        self.impl = impl
        if isinstance(precision, str):
            precision = PrecisionPolicy(fan_dtype=precision)
        self._fan_dtype = precision.fan_dtype if precision is not None else None
        self._auc_runners: dict = {}
        self._mu_runners: dict = {}
        self._mu_draw_cache: dict = {}
        self.grad_wams = None
        self._expl_key = None
        self.insertion_curves = []
        self.deletion_curves = []

    # -- explanation cache ---------------------------------------------------------

    def precompute(self, x, y):
        """Compute (or reuse) the cached explanations of this batch,
        fingerprinted on (shape, dtype, labels): another batch recomputes.
        Explanations assigned to ``grad_wams`` adopt the first fingerprint
        they are used with."""
        key = batch_fingerprint(x, y)
        if self.grad_wams is not None:
            if self._expl_key is None or self._expl_key == key:
                self._expl_key = key
                self.grad_wams = upload(self.grad_wams, self.device)
                return self.grad_wams
        self.grad_wams = upload(self.explainer(x, y), self.device)
        self._expl_key = key
        return self.grad_wams

    def reset(self):
        self.grad_wams = None
        self._expl_key = None

    def _fan_plan(self, fan: int) -> FanPlan:
        return plan_fan(self.batch_size, fan, fan_dtype=self._fan_dtype,
                        backend=torch.device(self.device).type)

    def _inputs(self, x):
        return upload(x, self.device).float()

    # -- shared reconstruction machinery ------------------------------------------

    def _decompose(self, img: torch.Tensor):
        """(3, H, W) standardized image -> ([0, 1] image, its coefficients)."""
        image01 = self.denormalize_fn(img)
        return image01, wavedec2(image01, self.wavelet, self.J, self.mode, impl=self.impl)

    def _masked_reconstructions(self, image01: torch.Tensor, coeffs,
                                masks: torch.Tensor) -> torch.Tensor:
        """image01 (3, H, W) and its coefficients, masks (M, Ph, Pw) in the
        packed domain -> (M, 3, H, W) preprocessed model inputs."""
        H, W = image01.shape[-2:]
        masked = coeffs_to_array2d(coeffs)[None] * masks[:, None]  # (M, 3, Ph, Pw)
        rec = waverec2(array_to_coeffs2d(masked, coeff_shapes2d(coeffs)), self.wavelet,
                       impl=self.impl)[..., :H, :W]
        return self.preprocess_fn(_minmax01(rec))

    # -- insertion / deletion -----------------------------------------------------

    def _perturb_for_auc(self, img, wam, mode: str, n_iter: int):
        """One image's fan: the mosaic resized to the packed domain (equal
        for haar on even sides), the mask family, the reconstructions."""
        image01, coeffs = self._decompose(img)
        packed = packed2d_shape(coeffs)
        if tuple(wam.shape) != packed:
            wam = upsample_nearest(wam, packed)
        ins, dele = generate_masks(n_iter, wam)
        return self._masked_reconstructions(image01, coeffs,
                                            ins if mode == "insertion" else dele)

    def evaluate_auc(self, x, y, mode: str, n_iter: int = 64):
        """Per-image AUC of the class probability along the nested mask
        family, in one fan step; returns (scores, curves)."""
        x = self._inputs(x)
        y = host_labels(y)
        wams = self.precompute(x, y)
        return run_cached_auc(
            self._auc_runners, (mode, tuple(wams.shape[1:])),
            lambda img, wam: self._perturb_for_auc(img, wam, mode, n_iter),
            self.model_fn, self._fan_plan(n_iter + 1), n_iter, x, wams, y, mesh=self.mesh,
            data_axis=self.data_axis)

    def insertion(self, x, y, n_iter: int = 64):
        scores, curves = self.evaluate_auc(x, y, "insertion", n_iter)
        self.insertion_curves = curves
        return scores

    def deletion(self, x, y, n_iter: int = 64):
        scores, curves = self.evaluate_auc(x, y, "deletion", n_iter)
        self.deletion_curves = curves
        return scores

    # -- μ-fidelity ----------------------------------------------------------------

    def _make_mu_runner(self, grid_size: int, sample_size: int, plan: FanPlan):
        """μ-fidelity of the whole batch in one fan step: per image, the
        baseline search over ``sample_size`` random continuous masks, then
        the subset masks on the chosen baseline, each a fan of
        ``sample_size`` reconstructions, and the Spearman correlation of
        the probability drops with the attribution mass of the masked
        superpixels; correlations stay on the device."""
        forward = cast_model_fn(make_chunked_forward(self.model_fn, plan.fan_chunk),
                                plan.fan_dtype)
        base_fn = cast_model_fn(self.model_fn, plan.fan_dtype)

        def probs_of(fans, labels):  # fans of one chunk -> (k, S) class probabilities
            logits = forward(fans[0] if len(fans) == 1 else torch.cat(fans))
            logits = logits.reshape(len(fans), sample_size, -1)
            return softmax_probs(logits).gather(
                2, labels.reshape(-1, 1, 1).expand(-1, sample_size, 1))[..., 0]

        def run(xb, wamsb, yb, randb, onehotb):
            base = softmax_probs(base_fn(xb)).gather(1, yb[:, None])[:, 0]
            out = []
            for start in range(0, xb.shape[0], plan.images_per_chunk):
                idx = range(start, min(start + plan.images_per_chunk, xb.shape[0]))
                labels = yb[idx.start:idx.stop]
                dec = [self._decompose(xb[i]) for i in idx]
                packed = packed2d_shape(dec[0][1])

                def fans(grids):
                    return [self._masked_reconstructions(
                        im, co, upsample_nearest(g, packed)) for (im, co), g in zip(dec, grids)]

                # the baseline state: the random continuous mask that
                # minimizes the class probability (an index on the device)
                probs = probs_of(fans([randb[i] for i in idx]), labels)
                best = probs.argmin(dim=1)
                grids = []
                for j, i in enumerate(idx):
                    baseline = randb[i].index_select(0, best[j:j + 1])  # (1, g, g)
                    onehot = onehotb[i].reshape(sample_size, grid_size, grid_size)
                    grids.append(torch.where(onehot > 0, baseline, 1.0))
                deltas = base[idx.start:idx.stop, None] - probs_of(fans(grids), labels)
                for j, i in enumerate(idx):
                    # attribution mass per superpixel of the blurred mosaic,
                    # each pixel in the cell the mask resize maps it to
                    cells = superpixel_sum(gaussian_filter2d(wamsb[i], sigma=2.0),
                                           grid_size).reshape(-1)
                    out.append(spearman(deltas[j], (onehotb[i] * cells).sum(dim=1)))
            return torch.stack(out)

        return fan_runner(run, mesh=self.mesh, data_axis=self.data_axis)

    def mu_fidelity(self, x, y, grid_size: int = 28, sample_size: int = 128,
                    subset_size: int = 157):
        """Mean-free Spearman rho per image between the drop of the class
        probability under superpixel masking and the summed attribution of
        the masked superpixels, in one fan step and one fetch."""
        x = self._inputs(x)
        y = host_labels(y)
        wams = self.precompute(x, y)
        rand_all, onehot_all = mu_fidelity_draws(
            self._mu_draw_cache, self.random_seed, x.shape[0], grid_size, sample_size,
            subset_size, with_rand_masks=True, device=self.device)
        plan = self._fan_plan(sample_size)
        key = (grid_size, sample_size, tuple(x.shape[1:]), tuple(wams.shape[1:]),
               plan.images_per_chunk, plan.fan_chunk, plan.fan_dtype)
        runner = self._mu_runners.get(key)
        if runner is None:
            runner = self._mu_runners[key] = self._make_mu_runner(grid_size, sample_size, plan)
        out = run_fan(runner, (x, wams, upload(y, self.device).long(), rand_all, onehot_all))
        return [float(v) for v in out]
