"""Temporal faithfulness of video attributions: `EvalVideoWAM` (PyTorch port
of `wam_tpu.xattr.video_eval`).

The video counterpart of `evalsuite.eval2d.Eval2DWAM`, with frames as the
unit of perturbation: the explainer's (B, T) frame scores rank the clip's
frames, `evalsuite.metrics.generate_masks` builds the nested insertion and
deletion families over that ranking, and each variant blanks whole frames.
Insertion starts from the blanked clip and reveals frames most important
first; deletion blanks them from the intact clip. "Blank" is the clip's
mean frame, so the model keeps seeing in-distribution luminance. Each
metric call is one fan step (`evalsuite.fan`: all n_iter + 1 variants of a
clip in one model call, under ``no_grad``) and exactly ONE result fetch.
No wavelet transform runs in a metric call: the blanking is in pixels.
"""

from __future__ import annotations

from typing import Callable

import torch

from wam_tpu_torch.device import resolve_device
from wam_tpu_torch.evalsuite.fan import FanPlan, check_ported, plan_fan, upload
from wam_tpu_torch.evalsuite.metrics import (
    batch_fingerprint,
    generate_masks,
    host_labels,
    run_cached_auc,
)
from wam_tpu_torch.xattr.video import frame_importance

__all__ = ["EvalVideoWAM"]


class EvalVideoWAM:
    """Temporal insertion/deletion AUC of clip explainers.

    ``explainer`` maps (x, y) to a (B, T, H, W) box (`WaveletAttributionVideo`)
    or to (B, T) frame scores; both reduce to (B, T) through
    `frame_importance`. ``model_fn`` maps clips (B, C, T, H, W) to logits.
    ``batch_size`` caps the model rows a call (`fan.plan_fan`). ``device``:
    CUDA unless the caller asks otherwise. ``mesh``: a `parallel.Mesh`;
    the fan splits its clips over ``data_axis`` (`fan.make_sharded_runner`),
    one result fetch a call. ``aot_key=`` and ``donate_inputs=True`` wait
    for ROADMAP.md slice E2 and raise.
    Constructor arguments are frozen configuration."""

    def __init__(self, model_fn: Callable[[torch.Tensor], torch.Tensor], explainer: Callable,
                 batch_size: int | str = 64, mesh=None, data_axis: str = "data",
                 donate_inputs: bool | None = None, aot_key: str | None = None, device=None):
        check_ported(donate=donate_inputs, aot_key=aot_key)
        self.mesh = mesh
        self.data_axis = data_axis
        self.device = resolve_device(device)
        self.model_fn = model_fn
        self.explainer = explainer
        self.batch_size = batch_size
        self.explanations = None
        self._expl_key = None
        self.insertion_curves = []
        self.deletion_curves = []
        self._auc_runners: dict = {}

    def precompute(self, x, y) -> torch.Tensor:
        """(B, T) frame scores, cached per batch fingerprint (shape, dtype,
        labels): another batch recomputes; explanations assigned to
        ``explanations`` adopt the first fingerprint they are used with."""
        key = batch_fingerprint(x, y)
        if self.explanations is not None and self._expl_key in (None, key):
            self._expl_key = key
            self.explanations = upload(self.explanations, self.device)
            return self.explanations
        expl = upload(self.explainer(x, y), self.device)
        self.explanations = frame_importance(expl) if expl.ndim > 2 else expl
        self._expl_key = key
        return self.explanations

    def reset(self):
        self.explanations = None
        self._expl_key = None

    def _fan_plan(self, fan: int) -> FanPlan:
        return plan_fan(self.batch_size, fan, workload="evalvid3d",
                        backend=torch.device(self.device).type)

    @staticmethod
    def _perturb(clip: torch.Tensor, scores: torch.Tensor, mode: str, n_iter: int) -> torch.Tensor:
        """clip (C, T, H, W), scores (T,) -> (n_iter + 1, C, T, H, W): revealed
        frames keep their pixels, hidden ones become the clip's mean frame."""
        ins, dele = generate_masks(n_iter, scores)
        masks = ins if mode == "insertion" else dele  # (n_iter + 1, T)
        blank = clip.mean(dim=1, keepdim=True)  # (C, 1, H, W)
        m = masks[:, None, :, None, None]
        return clip[None] * m + blank[None] * (1.0 - m)

    def evaluate_auc(self, x, y, mode: str, n_iter: int = 16):
        """Per-clip AUC of the class probability along the nested frame
        family, in one fan step and one fetch; returns (scores, curves)."""
        x = upload(x, self.device).float()
        y = host_labels(y)
        scores = self.precompute(x, y)
        return run_cached_auc(self._auc_runners, (mode, tuple(scores.shape[1:])),
                              lambda clip, s: self._perturb(clip, s, mode, n_iter),
                              self.model_fn, self._fan_plan(n_iter + 1), n_iter, x, scores, y,
                              mesh=self.mesh, data_axis=self.data_axis)

    def insertion(self, x, y, n_iter: int = 16):
        scores, curves = self.evaluate_auc(x, y, "insertion", n_iter)
        self.insertion_curves = curves
        return scores

    def deletion(self, x, y, n_iter: int = 16):
        scores, curves = self.evaluate_auc(x, y, "deletion", n_iter)
        self.deletion_curves = curves
        return scores
