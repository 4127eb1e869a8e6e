"""Baseline-method evaluators (PyTorch port of
`wam_tpu.evalsuite.eval_baselines`): `EvalImageBaselines` and
`EvalAudioBaselines` run the classic attribution methods (saliency,
integrated gradients, SmoothGrad, GradCAM, GradCAM++, LayerCAM, guided
backprop, gradient x input, LRP) and score them with the insertion and
deletion AUC and μ-fidelity of the WAM evaluators, the perturbation in each
modality's own domain: pixels for images, mel-spectrogram cells for audio.
Every metric call is one fan step with one counted result fetch
(`evalsuite.fan`).
"""

from __future__ import annotations

import copy
from typing import Callable

import torch

from wam_tpu_torch.config import FP8, resolve_compute_dtype
from wam_tpu_torch.device import resolve_device
from wam_tpu_torch.evalsuite import baselines as B
from wam_tpu_torch.evalsuite.eval2d import _minmax01, imagenet_denormalize, imagenet_preprocess
from wam_tpu_torch.pipeline.donation import donation_safe, resolve_donate
from wam_tpu_torch.evalsuite.fan import (
    AUTO_CAP,
    FanPlan,
    cast_model_fn,
    fan_runner,
    make_chunked_forward,
    plan_fan,
    run_fan,
    upload,
)
from wam_tpu_torch.evalsuite.lrp import prepare_lrp_model
from wam_tpu_torch.evalsuite.metrics import (
    batch_fingerprint,
    generate_masks,
    host_labels,
    mu_fidelity_draws,
    run_cached_auc,
    softmax_probs,
    spearman,
)
from wam_tpu_torch.ops.filters import gaussian_filter2d, superpixel_sum, upsample_nearest

__all__ = ["EvalImageBaselines", "EvalAudioBaselines", "IMAGE_METHODS", "AUDIO_METHODS"]

IMAGE_METHODS = (
    "saliency",
    "integratedgrad",
    "smoothgrad",
    "gradcam",
    "gradcampp",
    "layercam",
    "guided_backprop",
    "gradxinput",
    "lrp",
    # transformer-native (xattr.attention): they need a ViT built with
    # capture_attn=True, whose softmax weights pass through taps
    "rollout",
    "attngrad",
)
AUDIO_METHODS = ("saliency", "integratedgrad", "smoothgrad", "gradcam")


class _BaseEvalBaselines:
    """The shared machinery: the method registry, the evaluator's own copy
    of the model at its compute dtype, cached explanations and the AUC fan.

    ``model`` is an `nn.Module`; ``variables``, a state dict (for example
    from `ingest.flax_resnet_to_torch`), is loaded into the evaluator's
    copy when given. The copy is put on ``device`` (CUDA unless the caller
    asks otherwise) in eval mode with frozen weights and cast ONCE to the
    compute dtype: the caller's module is never changed. ``compute_dtype``
    is a torch dtype or a policy string ("f32", "bf16", "fp8"),
    ``precision`` a `config.PrecisionPolicy` or a ``fan_dtype`` string
    (`config.resolve_compute_dtype` gives the reference's order). Inputs are
    cast at the model's boundary and logits come back float32. "fp8"
    (float8_e4m3fn, where `config.fp8_supported`) rounds the weights and
    the inputs through e4m3 and computes in bfloat16: cuDNN has no float8
    convolution; the input rounding passes gradients straight through.
    ``mesh``: a `parallel.Mesh`; every metric's fan splits its inputs over
    ``data_axis`` (`fan.make_sharded_runner`), one result fetch a call.
    ``donate_inputs`` and ``aot_key`` as for `Eval2DWAM`.
    Constructor arguments are frozen configuration."""

    def __init__(self, model, variables, method: str, batch_size: int | str,
                 random_seed: int, n_samples: int, stdev_spread: float, cam_layer: str,
                 nchw: bool, methods: tuple[str, ...], mesh=None, data_axis: str = "data",
                 compute_dtype=None, donate_inputs: bool | None = None,
                 aot_key: str | None = None, precision=None, device=None):
        if method == "srd":
            raise NotImplementedError(
                "'srd' is excluded by design: the reference imports it from a `lib.srd` "
                "package that does not exist in its repository, so its semantics cannot be "
                "reproduced faithfully (PARITY.md defect ledger #1). Use "
                "'guided_backprop' or 'lrp' instead.")
        if method not in methods:
            raise ValueError(f"Unknown method {method!r}; expected one of {methods}")
        if method in ("rollout", "attngrad") and not getattr(model, "capture_attn", False):
            raise ValueError(
                f"method {method!r} reads per-block attention weights — build "
                "the ViT with capture_attn=True (models/vit.py); the stock "
                "attention body never materializes them"
            )
        self.donate_inputs = donate_inputs
        self.aot_key = aot_key
        self.mesh = mesh
        self.data_axis = data_axis
        self.device = resolve_device(device)
        self.compute_dtype, self._fan_dtype = resolve_compute_dtype(compute_dtype, precision)
        self.model = self._own_copy(model, variables)
        self.method = method
        self.batch_size = batch_size
        self.random_seed = random_seed
        self.n_samples = n_samples
        self.stdev_spread = stdev_spread
        self.cam_layer = cam_layer
        self.nchw = nchw
        self.explanations = None
        self._expl_key = None
        self._lrp_model = None
        self.insertion_curves = []
        self.deletion_curves = []
        self._auc_runners: dict = {}
        self._mu_runners: dict = {}
        self._mu_draw_cache: dict = {}

    def _own_copy(self, model, variables):
        own = copy.deepcopy(model)
        if variables is not None:
            own.load_state_dict(variables)
        own.eval().to(self.device)
        own.requires_grad_(False)
        if self.compute_dtype == FP8:
            with torch.no_grad():  # e4m3 values, held (exactly) in bfloat16
                for t in list(own.parameters()) + list(own.buffers()):
                    if t.is_floating_point():
                        t.data = t.data.to(FP8).to(torch.bfloat16)
        elif self.compute_dtype is not None:
            own.to(self.compute_dtype)
        return own

    def _rounded(self, x: torch.Tensor) -> torch.Tensor:
        """An fp8 evaluator's inputs rounded through e4m3, gradients passed
        straight through; the module's boundary casts the rest
        (`baselines.module_forward`)."""
        if self.compute_dtype == FP8:
            return x + (x.to(FP8).to(x.dtype) - x).detach()
        return x

    def model_fn(self, x: torch.Tensor) -> torch.Tensor:
        """(B, ...) inputs -> float32 logits of the evaluator's model."""
        return B.module_forward(self.model, self._rounded(x), self.nchw)

    # -- explanations --------------------------------------------------------------

    def _sample_batch(self, n_images: int) -> int:
        """Path points or noisy copies a model call: the cap on rows a call
        over the image batch."""
        cap = AUTO_CAP if self.batch_size == "auto" else int(self.batch_size)
        return max(1, cap // max(1, n_images))

    def compute_explanations(self, x, y) -> torch.Tensor:
        """(B, H, W) maps in the perturbation domain, float32 on the device."""
        x = upload(x, self.device).float()
        yt = None if y is None else upload(host_labels(y), self.device).long()
        m = self.method
        if m == "saliency":
            return B.saliency(self.model_fn, x, yt)
        if m == "integratedgrad":
            return B.integrated_gradients(self.model_fn, x, yt, n_steps=self.n_samples,
                                          sample_batch_size=self._sample_batch(x.shape[0]))
        if m == "smoothgrad":
            g = torch.Generator(device=self.device).manual_seed(self.random_seed)
            return B.smoothgrad_pixel(self.model_fn, x, yt, g, n_samples=self.n_samples,
                                      stdev_spread=self.stdev_spread,
                                      sample_batch_size=self._sample_batch(x.shape[0]))
        if m == "gradxinput":
            return B.gradient_x_input(self.model_fn, x, yt)
        if m == "lrp":
            from wam_tpu_torch.models.resnet import ResNet

            if isinstance(self.model, ResNet):
                if self._lrp_model is None:
                    self._lrp_model = prepare_lrp_model(self.model)
                return B.lrp(self._lrp_model, x, yt, nchw=self.nchw)
            return B.lrp(self.model, self._rounded(x), yt, nchw=self.nchw)
        x = self._rounded(x)
        if m == "gradcam":
            return B.gradcam(self.model, x, yt, layer=self.cam_layer, nchw=self.nchw)
        if m == "gradcampp":
            return B.gradcam_pp(self.model, x, yt, layer=self.cam_layer, nchw=self.nchw)
        if m == "layercam":
            return B.layercam(self.model, x, yt, layer=self.cam_layer, nchw=self.nchw)
        if m == "guided_backprop":
            return B.guided_backprop(self.model, x, yt, nchw=self.nchw)
        if m == "rollout":
            return B.attention_rollout(self.model, x, yt, nchw=self.nchw)
        if m == "attngrad":
            return B.attention_gradient(self.model, x, yt, nchw=self.nchw)
        raise AssertionError(m)

    def precompute(self, x, y):
        """Compute (or reuse) the cached explanations, fingerprinted on
        (shape, dtype, labels): another batch recomputes; explanations
        assigned to ``explanations`` adopt the first fingerprint they are
        used with."""
        key = batch_fingerprint(x, y)
        if self.explanations is not None and self._expl_key in (None, key):
            self._expl_key = key
            self.explanations = upload(self.explanations, self.device)
            return self.explanations
        self.explanations = self.compute_explanations(x, y)
        self._expl_key = key
        return self.explanations

    def reset(self):
        self.explanations = None
        self._expl_key = None

    # -- metrics ---------------------------------------------------------------------

    def _perturb(self, x_s: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _fan_plan(self, fan: int) -> FanPlan:
        return plan_fan(self.batch_size, fan, fan_dtype=self._fan_dtype,
                        backend=torch.device(self.device).type)

    def evaluate_auc(self, x, y, mode: str, n_iter: int = 128, argmax: bool = False):
        """Per-input AUC of the class probability along the nested mask
        family, in one fan step; returns (scores, curves), or with
        ``argmax`` the logits rows of every input's family."""
        x = upload(x, self.device).float()
        y = host_labels(y)
        expl = self.precompute(x, y)

        def inputs_fn(x_s, expl_s):
            ins, dele = generate_masks(n_iter, expl_s)
            return self._perturb(x_s, ins if mode == "insertion" else dele)

        return run_cached_auc(self._auc_runners, (mode, tuple(expl.shape[1:])), inputs_fn,
                              self.model_fn, self._fan_plan(n_iter + 1), n_iter, x, expl, y,
                              return_logits=argmax, mesh=self.mesh, data_axis=self.data_axis,
                              donate=self.donate_inputs, aot_key=self.aot_key)

    def insertion(self, x, y, n_iter: int = 128):
        scores, curves = self.evaluate_auc(x, y, "insertion", n_iter)
        self.insertion_curves = curves
        return scores

    def deletion(self, x, y, n_iter: int = 128):
        scores, curves = self.evaluate_auc(x, y, "deletion", n_iter)
        self.deletion_curves = curves
        return scores


class EvalImageBaselines(_BaseEvalBaselines):
    """Pixel-domain perturbation of images (B, 3, H, W): each masked image
    is the denormalized image times the mask, min-max rescaled and
    preprocessed again (ImageNet normalization by default)."""

    def __init__(self, model, variables=None, method: str = "saliency",
                 batch_size: int | str = 128, random_seed: int = 42, n_samples: int = 25,
                 stdev_spread: float = 0.25, cam_layer: str = "stage4",
                 denormalize_fn: Callable = imagenet_denormalize,
                 preprocess_fn: Callable = imagenet_preprocess, nchw: bool = True, mesh=None,
                 data_axis: str = "data", compute_dtype=None,
                 donate_inputs: bool | None = None, aot_key: str | None = None,
                 precision=None, device=None):
        super().__init__(model, variables, method, batch_size, random_seed, n_samples,
                         stdev_spread, cam_layer, nchw=nchw, methods=IMAGE_METHODS, mesh=mesh,
                         data_axis=data_axis, compute_dtype=compute_dtype,
                         donate_inputs=donate_inputs, aot_key=aot_key, precision=precision,
                         device=device)
        self.denormalize_fn = denormalize_fn
        self.preprocess_fn = preprocess_fn

    def _perturb(self, x_s, masks):
        image01 = self.denormalize_fn(x_s)  # (3, H, W)
        return self.preprocess_fn(_minmax01(image01[None] * masks[:, None]))

    def _make_mu_runner(self, grid_size: int, sample_size: int, img_hw, plan: FanPlan):
        """μ-fidelity of the whole batch in one fan step: per image, the
        ``sample_size`` subset masks (superpixels of a grid_size^2 grid set
        to 0), upsampled to the image, the drop of the class probability,
        and its Spearman correlation with the masked cells' attribution
        mass; correlations stay on the device."""
        forward = cast_model_fn(make_chunked_forward(self.model_fn, plan.fan_chunk),
                                plan.fan_dtype)
        base_fn = cast_model_fn(self.model_fn, plan.fan_dtype)

        def run(xb, explb, yb, onehotb):
            base = softmax_probs(base_fn(xb)).gather(1, yb[:, None])[:, 0]
            out = []
            for start in range(0, xb.shape[0], plan.images_per_chunk):
                idx = range(start, min(start + plan.images_per_chunk, xb.shape[0]))
                fans = [self._perturb(xb[i], upsample_nearest(
                    1.0 - onehotb[i].reshape(sample_size, grid_size, grid_size), img_hw))
                    for i in idx]
                logits = forward(fans[0] if len(fans) == 1 else torch.cat(fans))
                logits = logits.reshape(len(fans), sample_size, -1)
                labels = yb[idx.start:idx.stop].reshape(-1, 1, 1).expand(-1, sample_size, 1)
                deltas = base[idx.start:idx.stop, None] - softmax_probs(logits).gather(
                    2, labels)[..., 0]
                for j, i in enumerate(idx):
                    # every pixel lands in the cell the mask upsample maps it to
                    cells = superpixel_sum(gaussian_filter2d(explb[i], sigma=2.0),
                                           grid_size).reshape(-1)
                    out.append(spearman(deltas[j], onehotb[i] @ cells))
            return torch.stack(out)

        aot_key = None
        if self.aot_key is not None:
            aot_key = (f"{self.aot_key}|mu|g{grid_size}|s{sample_size}"
                       f"|c{plan.images_per_chunk}|{plan.fan_dtype}")
        return fan_runner(run, mesh=self.mesh, data_axis=self.data_axis,
                          donate=self.donate_inputs, donate_argnums=(0,), aot_key=aot_key)

    def mu_fidelity(self, x, y, grid_size: int = 28, sample_size: int = 128,
                    subset_size: int = 157):
        """Pixel-domain μ-fidelity: one fan step and one fetch a call."""
        x = upload(x, self.device).float()
        y = host_labels(y)
        expl = self.precompute(x, y)
        onehot_all = mu_fidelity_draws(self._mu_draw_cache, self.random_seed, x.shape[0],
                                       grid_size, sample_size, subset_size,
                                       with_rand_masks=False, device=self.device)
        plan = self._fan_plan(sample_size)
        key = (grid_size, sample_size, tuple(x.shape[1:]), tuple(expl.shape[1:]),
               plan.images_per_chunk, plan.fan_chunk, plan.fan_dtype)
        runner = self._mu_runners.get(key)
        if runner is None:
            runner = self._mu_runners[key] = self._make_mu_runner(
                grid_size, sample_size, tuple(x.shape[-2:]), plan)
        if self.mesh is None and resolve_donate(self.donate_inputs):
            x = donation_safe(x, True)
        out = run_fan(runner, (x, expl, upload(y, self.device).long(), onehot_all))
        return [float(v) for v in out]


class EvalAudioBaselines(_BaseEvalBaselines):
    """Mel-spectrogram-domain perturbation of audio inputs (B, 1, T, M):
    explanations are computed on the mel input and masks multiply its
    cells. The AudioCNN takes (B, 1, T, M) as it comes."""

    def __init__(self, model, variables=None, method: str = "saliency",
                 batch_size: int | str = 128, random_seed: int = 42, n_samples: int = 25,
                 stdev_spread: float = 0.001, cam_layer: str = "out3", mesh=None,
                 data_axis: str = "data", compute_dtype=None,
                 donate_inputs: bool | None = None, aot_key: str | None = None,
                 precision=None, device=None):
        super().__init__(model, variables, method, batch_size, random_seed, n_samples,
                         stdev_spread, cam_layer, nchw=True, methods=AUDIO_METHODS, mesh=mesh,
                         data_axis=data_axis, compute_dtype=compute_dtype,
                         donate_inputs=donate_inputs, aot_key=aot_key, precision=precision,
                         device=device)

    def _perturb(self, x_s, masks):
        # x_s (1, T, M), masks (n_iter + 1, T, M) -> (n_iter + 1, 1, T, M)
        return x_s[None] * masks[:, None]

    def insertion(self, x, y, n_iter: int = 64):
        return super().insertion(x, y, n_iter)

    def deletion(self, x, y, n_iter: int = 64):
        return super().deletion(x, y, n_iter)

    def evaluate_auc(self, x, y, mode: str, n_iter: int = 64, argmax: bool = False):
        """AUC over mel-cell mask families; ``argmax=True`` returns the
        logits rows instead (the input-fidelity path)."""
        return super().evaluate_auc(x, y, mode, n_iter, argmax)

    def faithfulness_of_spectra(self, x, y):
        """FF_i = p(full) - p(half deleted): deletion with n_iter = 2."""
        _, curves = self.evaluate_auc(x, y, "deletion", n_iter=2)
        return [float(c[0] - c[1]) for c in curves]

    def input_fidelity(self, x, y):
        """The predicted class of the half-kept and the full input
        (insertion with n_iter = 2, the empty row dropped), per input."""
        raw = self.evaluate_auc(x, y, "insertion", n_iter=2, argmax=True)
        return [r[1:].argmax(axis=1).tolist() for r in raw]
