"""Eval1DWAM: faithfulness of audio wavelet attributions (PyTorch port of
`wam_tpu.evalsuite.eval1d`): insertion and deletion AUC with the
perturbation in the mel-spectrogram or in the wavelet domain,
faithfulness-of-spectra (Parekh et al.) and input fidelity (Paissan et al.).

A waveform's wavelet-domain family is one masked multiply of its
concatenated coefficients, one batched inverse transform of the n_iter + 1
masked copies, each renormalized by its peak, and one mel spectrogram of
them all. The 1D transform, the STFT and the model are library calls
(cuDNN, cuFFT, cuBLAS): no port kernel runs on this path.
"""

from __future__ import annotations

from typing import Callable

import torch

from wam_tpu_torch.config import PrecisionPolicy
from wam_tpu_torch.device import resolve_device
from wam_tpu_torch.evalsuite.fan import FanPlan, plan_fan, upload
from wam_tpu_torch.evalsuite.metrics import (
    batch_fingerprint,
    generate_masks,
    host_labels,
    run_cached_auc,
)
from wam_tpu_torch.evalsuite.packing import array_to_coeffs1d, coeffs_to_array1d
from wam_tpu_torch.ops.melspec import get_mel_bf16, melspectrogram
from wam_tpu_torch.wam1d import normalize_waveforms
from wam_tpu_torch.wavelets.transform import wavedec, waverec

__all__ = ["Eval1DWAM"]


class Eval1DWAM:
    """``explainer``: (x, y) -> (mel gradients (B, T, M), coefficient
    gradient list), e.g. `WaveletAttribution1D`; ``model_fn``: mel batches
    (B, 1, T, M) -> logits. Constructor arguments are frozen configuration;
    ``batch_size``, ``precision``, ``device``, ``mesh`` (with
    ``data_axis``), ``aot_key`` and ``donate_inputs`` as for `Eval2DWAM`.
    Without ``precision`` the mel front end follows the melspec module's
    default (`ops.melspec.set_mel_bf16`) at each call."""

    def __init__(
        self,
        model_fn: Callable[[torch.Tensor], torch.Tensor],
        explainer: Callable,
        wavelet: str = "haar",
        J: int = 3,
        mode: str = "reflect",
        n_mels: int = 128,
        n_fft: int = 1024,
        sample_rate: int = 44100,
        batch_size: int | str = 128,
        mesh=None,
        data_axis: str = "data",
        donate_inputs: bool | None = None,
        aot_key: str | None = None,
        precision=None,
        device=None,
    ):
        self.donate_inputs = donate_inputs
        self.aot_key = aot_key
        self.mesh = mesh
        self.data_axis = data_axis
        self.device = resolve_device(device)
        self.model_fn = model_fn
        self.explainer = explainer
        self.wavelet = wavelet
        self.J = J
        self.mode = mode
        self.n_mels = n_mels
        self.n_fft = n_fft
        self.sample_rate = sample_rate
        self.batch_size = batch_size
        if isinstance(precision, str):
            precision = PrecisionPolicy(fan_dtype=precision)
        self._fan_dtype = precision.fan_dtype if precision is not None else None
        self._mel_bf16 = precision.mel_bf16 if precision is not None else None
        self._auc_runners: dict = {}
        self.grad_wams = None
        self._expl_key = None
        self.insertion_curves = []
        self.deletion_curves = []

    def precompute(self, x, y):
        """Compute (or reuse) the cached explanations, fingerprinted on
        (shape, dtype, labels) as `Eval2DWAM.precompute` does."""
        key = batch_fingerprint(x, y)
        if self.grad_wams is not None and self._expl_key in (None, key):
            self._expl_key = key
            return self.grad_wams
        self.grad_wams = self.explainer(x, y)
        self._expl_key = key
        return self.grad_wams

    def reset(self):
        self.grad_wams = None
        self._expl_key = None

    def _fan_plan(self, fan: int) -> FanPlan:
        return plan_fan(self.batch_size, fan, workload="eval1d", fan_dtype=self._fan_dtype,
                        backend=torch.device(self.device).type)

    def _melspec(self, wave: torch.Tensor) -> torch.Tensor:
        mel = melspectrogram(wave, sample_rate=self.sample_rate, n_fft=self.n_fft,
                             n_mels=self.n_mels, bf16=self._mel_bf16)
        return mel[:, None, :, :]  # (B, 1, T, M)

    # -- perturbation families -------------------------------------------------

    def perturbed_from_melspec(self, grad_mel: torch.Tensor, source_mel: torch.Tensor,
                               mode: str, n_iter: int) -> torch.Tensor:
        """(T, M) gradients and source mel -> (n_iter + 1, 1, T, M) masked
        mel spectrograms."""
        ins, dele = generate_masks(n_iter, grad_mel)
        masks = ins if mode == "insertion" else dele
        return (masks * source_mel[None])[:, None]

    def perturbed_from_wavelet(self, wave: torch.Tensor, grads, mode: str,
                               n_iter: int) -> torch.Tensor:
        """Masks over the flattened multi-scale coefficients of one waveform
        (W,), ranked by |gradient| -> (n_iter + 1, 1, T, M) mel
        spectrograms of the reconstructions."""
        coeffs = wavedec(wave[None], self.wavelet, level=self.J, mode=self.mode)
        lengths = [c.shape[-1] for c in coeffs]
        ins, dele = generate_masks(n_iter, coeffs_to_array1d(list(grads)), signed=True)
        masks = ins if mode == "insertion" else dele  # (n_iter + 1, total)
        masked = coeffs_to_array1d([c[0] for c in coeffs])[None] * masks
        rec = waverec(array_to_coeffs1d(masked, lengths), self.wavelet)[..., :wave.shape[-1]]
        # each reconstruction divided by its peak (wf / wf.max())
        peak = rec.amax(dim=-1, keepdim=True)
        rec = rec / torch.where(peak.abs() > 0, peak, 1.0)
        return self._melspec(rec)

    # -- metrics ---------------------------------------------------------------

    def evaluate_auc(self, x, y, mode: str, target: str, n_iter: int = 64,
                     argmax: bool = False):
        x = normalize_waveforms(x, self.device)
        y = host_labels(y)
        mel_grads, coeff_grads = self.precompute(x, y)
        if target == "melspec":
            with torch.no_grad():
                source_mels = self._melspec(x)[:, 0]
            expl = (upload(mel_grads, self.device), source_mels)

            def inputs_fn(x_s, expl_s):
                grad_mel, source_mel = expl_s
                return self.perturbed_from_melspec(grad_mel, source_mel, mode, n_iter)

        elif target == "wavelet":
            expl = tuple(upload(g, self.device) for g in coeff_grads)

            def inputs_fn(x_s, expl_s):
                return self.perturbed_from_wavelet(x_s, expl_s, mode, n_iter)

        else:
            raise ValueError(f"Unknown target {target!r}")
        mel_bf16 = get_mel_bf16() if self._mel_bf16 is None else self._mel_bf16
        return run_cached_auc(self._auc_runners, (mode, target, mel_bf16), inputs_fn,
                              self.model_fn, self._fan_plan(n_iter + 1), n_iter, x, expl, y,
                              return_logits=argmax, mesh=self.mesh, data_axis=self.data_axis,
                              donate=self.donate_inputs, aot_key=self.aot_key)

    def insertion(self, x, y, target: str = "wavelet", n_iter: int = 64):
        scores, curves = self.evaluate_auc(x, y, "insertion", target, n_iter)
        self.insertion_curves = curves
        return scores

    def deletion(self, x, y, target: str = "wavelet", n_iter: int = 64):
        scores, curves = self.evaluate_auc(x, y, "deletion", target, n_iter)
        self.deletion_curves = curves
        return scores

    def faithfulness_of_spectra(self, x, y, target: str = "wavelet"):
        """FF_i = p(full) - p(half deleted): deletion with n_iter = 2."""
        _, curves = self.evaluate_auc(x, y, "deletion", target, n_iter=2)
        return [float(c[0] - c[1]) for c in curves]

    def input_fidelity(self, x, y, target: str = "wavelet"):
        """The predicted class of the half-kept and the full input
        (insertion with n_iter = 2, the empty-signal row dropped), per
        waveform, for agreement with the full input's."""
        raw = self.evaluate_auc(x, y, "insertion", target, n_iter=2, argmax=True)
        return [r[1:].argmax(axis=1).tolist() for r in raw]
