"""WAM-1D: audio attribution in the wavelet domain (PyTorch port).

Counterpart of `wam_tpu.wam1d`. The differentiable chain is

    waveform -> wavedec -> coefficient leaves -> waverec -> mel spectrogram
             -> model -> diag-logit loss

and one autograd backward gives the gradients at both taps, the wavelet
coefficients and the mel spectrogram (`core.engine.WamEngine` with the mel
front end). Outputs follow the reference's layout: mel gradients
(N, T, n_mels) and a coefficient-gradient list [cA_J, cD_J, ..., cD_1].

The model is a function ``mel (N, 1, T, n_mels) -> scores (N, K)`` already
bound to its device (e.g. `models.audio.bind_audio_inference`). The 1D
transform, the STFT and the model run on library calls (cuDNN convolutions,
cuFFT): no TPU kernel lies on this path, and none of the port's CUDA
kernels is launched by it.

``serve_entry(aot_key=)`` compiles each chunk step through the
compiled-step cache (`pipeline.aot`): inside the graph the 1D levels are
the operators of `wavelets.transform` (the impl of the 1D knob when the
step was traced) and the mel chain's constants come from
`ops.graph_const`.
"""

from __future__ import annotations

import copy
from typing import Callable, Sequence

import numpy as np
import torch

from wam_tpu_torch.core.engine import WamEngine
from wam_tpu_torch.core.estimators import (
    block_draws,
    integrated_path,
    resolve_sample_chunk,
    smoothgrad,
    validate_sample_batch_size,
)
from wam_tpu_torch.device import resolve_device
from wam_tpu_torch.ops.melspec import mel_to_stft_magnitude, melspectrogram, stft_power
from wam_tpu_torch.wavelets.transform import wavedec, waverec

__all__ = [
    "normalize_waveforms",
    "BaseWAM1D",
    "WaveletAttribution1D",
    "VisualizerWAM1D",
    "scaleogram",
]


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def normalize_waveforms(x, device=None) -> torch.Tensor:
    """A list of (possibly int16) waveforms -> (N, W) float32, each divided
    by its max; an array or tensor is only cast to float32. On ``device``
    (CUDA unless the caller asks otherwise)."""
    if isinstance(x, (list, tuple)):
        x = np.stack([np.asarray(wf) / np.asarray(wf).max() for wf in x])
    return torch.as_tensor(x, dtype=torch.float32, device=resolve_device(device))


def scaleogram(coeff_grads: Sequence, J: int) -> np.ndarray:
    """Pseudo-scaleogram (B, J+1, maxlen), NaN-padded: row 0 the normalized
    |approximation| gradients, row j+1 level j's details, coarsest first.
    Host-side numpy."""
    arrs = [_host(c) for c in coeff_grads]
    batch = arrs[0].shape[0]
    maxlen = arrs[-1].shape[-1]
    out = np.full((batch, J + 1, maxlen), np.nan)
    for i in range(batch):
        for j, level in enumerate(arrs):
            a = np.abs(level[i])
            m = a.max()
            out[i, j, : a.shape[-1]] = a / (m if m > 0 else 1.0)
    return out


class BaseWAM1D:
    """Single-pass WAM-1D.

    ``model_fn`` maps mel batches (N, 1, T, n_mels) to scores; the mel front
    end (`ops.melspec.melspectrogram`, in dB) is built in. ``device``: where
    the computation runs, CUDA unless the caller asks otherwise.
    """

    def __init__(
        self,
        model_fn: Callable[[torch.Tensor], torch.Tensor],
        wavelet: str = "haar",
        J: int = 2,
        mode: str = "symmetric",
        approx_coeffs: bool = False,
        n_mels: int = 128,
        n_fft: int = 1024,
        sample_rate: int = 44100,
        device=None,
    ):
        self.device = resolve_device(device)
        self.wavelet = wavelet
        self.J = J
        self.mode = mode
        self.approx_coeffs = approx_coeffs
        self.n_mels = n_mels
        self.n_fft = n_fft
        self.sample_rate = sample_rate
        self.engine = WamEngine(model_fn, ndim=1, wavelet=wavelet, level=J, mode=mode,
                                front_fn=self.compute_melspec)

    def compute_melspec(self, wave: torch.Tensor) -> torch.Tensor:
        """(N, W) -> (N, 1, T, n_mels) in dB."""
        mel = melspectrogram(wave, sample_rate=self.sample_rate, n_fft=self.n_fft,
                             n_mels=self.n_mels)
        return mel[:, None, :, :]

    def _inputs(self, x, y):
        return normalize_waveforms(x, self.device), torch.as_tensor(y, device=self.device)

    def __call__(self, x, y, waveform: bool = True):
        """Returns (mel gradients (N, T, n_mels), coefficient-gradient list).
        ``waveform=False`` takes a coefficient list instead of waveforms."""
        y = torch.as_tensor(y, device=self.device)
        if waveform:
            x = normalize_waveforms(x, self.device)
            with torch.no_grad():
                coeffs = self.engine.decompose(x)
            length = x.shape[-1]
        else:
            coeffs = [torch.as_tensor(c, dtype=torch.float32, device=self.device) for c in x]
            with torch.no_grad():
                length = waverec(coeffs, self.wavelet).shape[-1]
        g_coeffs, g_mel = self.engine.grads_from_coeffs(coeffs, y, (length,), front=True)
        self.wavelet_coeffs = coeffs
        self.gradient_coeffs = g_coeffs
        return g_mel[:, 0, :, :], g_coeffs

    def visualize_grad_wam(self, coeff_grads):
        return scaleogram(coeff_grads, self.J)

    def filter(self, EPS: float) -> torch.Tensor:
        """Hard-threshold reconstruction: keep the coefficients whose
        normalized |gradient| exceeds EPS, then the inverse transform."""
        with torch.no_grad():
            filtered = [c * (g.abs() / g.abs().max() > EPS).float()
                        for c, g in zip(self.wavelet_coeffs, self.gradient_coeffs)]
            return waverec(filtered, self.wavelet)


class WaveletAttribution1D(BaseWAM1D):
    """SmoothGrad / Integrated-Gradients WAM-1D.

    method="smooth": the mean over ``n_samples`` noisy passes (per-waveform
    sigma = stdev_spread * (max - min)) of both taps' gradients.
    method="integratedgrad": the trapezoid integral of both taps' gradients
    along alpha * coeffs, each times its baseline (the input's mel
    spectrogram, the input's coefficients).

    ``sample_batch_size`` samples (or path points) run as one batch of
    sample_batch_size * N model rows; "auto" and None run them all at once.
    Each sample keeps its own loss scale, so the result does not depend on
    the chunk.

    SmoothGrad noise: standard-normal draws from a ``torch.Generator`` on the
    device seeded with ``random_seed``, materialized for all samples at once;
    with ``stream_noise=True`` each chunk draws its own samples' noise, sample
    i's from (random_seed, i) (`core.estimators.sample_noise`), so the
    (n_samples, N, W) buffer is never allocated and the result does not
    depend on the chunk (the draws differ from the materialized ones); or
    the explicit ``noise`` tensor (n_samples, *x.shape) given to ``__call__``.

    ``mesh=`` runs the estimator sequence-sharded over the mesh's
    ``seq_axis`` (`parallel.SeqShardedWam`; ``batch_axis`` splits the batch
    too, ``seq_fused`` is its ``fused``): the transforms, coefficient blocks
    and accumulators stay in blocks; the mel front end (the matmul STFT,
    pinned as the reference pins it) and the model run on the gathered
    reconstruction. SmoothGrad noise there is sample i's ``sample_noise(
    random_seed, i)`` (the ``stream_noise=True`` stream) or the handed
    ``noise``.
    """

    def __init__(
        self,
        model_fn,
        wavelet: str = "haar",
        J: int = 3,
        method: str = "smooth",
        mode: str = "reflect",
        approx_coeffs: bool = False,
        n_mels: int = 128,
        n_fft: int = 1024,
        sample_rate: int = 44100,
        n_samples: int = 25,
        stdev_spread: float = 0.001,
        random_seed: int = 42,
        sample_batch_size: int | None | str = "auto",
        stream_noise: bool = False,
        mesh=None,
        seq_axis: str = "data",
        batch_axis: str | None = None,
        seq_fused: bool | str = "auto",
        device=None,
    ):
        super().__init__(model_fn, wavelet=wavelet, J=J, mode=mode, approx_coeffs=approx_coeffs,
                         n_mels=n_mels, n_fft=n_fft, sample_rate=sample_rate, device=device)
        if mesh is None and batch_axis is not None:
            raise ValueError("batch_axis= requires mesh=")
        self.mesh = mesh
        self.seq_axis = seq_axis
        self.batch_axis = batch_axis
        if mesh is not None:
            from wam_tpu_torch.parallel.seq_estimators import SeqShardedWam

            # the mesh path pins the matmul STFT, as the reference does
            def seq_front(wave):
                mel = melspectrogram(wave, sample_rate=sample_rate, n_fft=n_fft, n_mels=n_mels,
                                     impl="matmul")
                return mel[:, None, :, :]

            self._seq_front = seq_front
            self._seq = SeqShardedWam(
                mesh, self.engine.model_fn, ndim=1, wavelet=wavelet, level=J, mode=mode,
                seq_axis=seq_axis, front_fn=seq_front, front_grads=True,
                batch_axis=batch_axis, fused=seq_fused)
        if method not in ("smooth", "integratedgrad"):
            raise ValueError(f"Unknown method {method!r}")
        validate_sample_batch_size(sample_batch_size)
        self.method = method
        self.n_samples = n_samples
        self.stdev_spread = stdev_spread
        self.random_seed = random_seed
        self.sample_batch_size = sample_batch_size
        self.stream_noise = stream_noise

    def _chunk(self, x) -> int | None:
        """sample_batch_size resolved for the waveforms ``x``: explicit, or
        for "auto" the tuned chunk of the schedule key ("wam1d", the item
        shape, batch, backend), else every sample at once."""
        return resolve_sample_chunk(self.sample_batch_size, self.n_samples, workload="wam1d",
                                    shape=tuple(x.shape[1:]), batch=int(x.shape[0]),
                                    backend=x.device.type)

    def _tap_grads(self, coeffs, y, length: int, s: int, scale: float = 1.0,
                   anchor=None) -> list[torch.Tensor]:
        """Both taps' gradients for ``s`` stacked copies (coefficient leaves
        (s*N, n_l), sample-major): [mel (s, N, T, M), cA_J, cD_J, ..., cD_1
        each (s, N, n_l)], times ``scale`` (a block's rows over its batch's,
        `_rows`). ``anchor``: the engine's, in a compiled step
        (`core.engine.WamEngine.grads_from_coeffs`)."""
        g_coeffs, g_mel = self.engine.grads_from_coeffs(
            coeffs, y.repeat(s), (length,), samples=s, front=True, anchor=anchor)
        return [(g if scale == 1.0 else g * scale).reshape((s, -1) + tuple(g.shape[1:]))
                for g in [g_mel[:, 0], *g_coeffs]]

    def _smooth_step(self, scale: float = 1.0):
        """One chunk of SmoothGrad, the compiled unit of `pipeline.aot`:
        ``step(noisy, y)`` maps a stack of noisy batches (s, N, W) to both
        taps' gradients (`_tap_grads`). The noise is drawn outside it."""

        def step(noisy: torch.Tensor, y, anchor=None) -> list[torch.Tensor]:
            length = noisy.shape[-1]
            with torch.no_grad():
                coeffs = self.engine.decompose(noisy.reshape(-1, length))
            return self._tap_grads(coeffs, y, length, noisy.shape[0], scale, anchor)

        return step

    def _ig_step(self, length: int, scale: float = 1.0):
        """One chunk of Integrated Gradients, the compiled unit of
        `pipeline.aot`: ``step(alphas, y, anchor, *coeffs)`` maps path points
        (s,) and the input's coefficients to both taps' gradients along
        alpha * coefficients."""

        def step(alphas: torch.Tensor, y, anchor, *coeffs) -> list[torch.Tensor]:
            s = alphas.shape[0]
            scaled = [(c[None] * alphas.to(c.dtype).reshape(-1, 1, 1)).reshape((-1, c.shape[-1]))
                      for c in coeffs]
            return self._tap_grads(scaled, y, length, s, scale, anchor)

        return step

    def _compile_twin(self):
        """A shallow copy of this explainer for compiled graphs
        (`pipeline.aot`): its engine holds the Wavelet object, registered by
        name for the graph's level operators (`matmul.remember_wavelet`)."""
        from wam_tpu_torch.wavelets.matmul import remember_wavelet

        twin = copy.copy(self)
        twin.engine = copy.copy(self.engine)
        twin.engine.wavelet = remember_wavelet(self.engine.wavelet)
        return twin

    def _aot_steps(self, aot_key: str, **kw):
        """``steps(kind, *step_args)`` -> the chunk step ("smooth" or "ig")
        compiled through the compiled-step cache, one program per (kind,
        argument signature), keyed ``{aot_key}|{kind}|dwt1-{impl}|stft-{impl}|...``
        (`pipeline.aot.cached_entry`): the 1D knob's impl and the STFT form
        are traced into the graph, so a step compiled under another is
        another program. A step whose compile fails raises, naming the 1D
        impl, where other compiled steps run eager (`pipeline.aot`)."""
        from wam_tpu_torch.ops.melspec import get_stft_impl
        from wam_tpu_torch.wam2d import _anchor, _aot_entry
        from wam_tpu_torch.wavelets.transform import _dwt1_name

        twin = self._compile_twin()
        made: dict = {}

        def steps(kind: str, *extra):
            impl = _dwt1_name()
            stft = "fft" if get_stft_impl() == "auto" else get_stft_impl()
            tag = (kind, impl, stft) + extra
            if tag not in made:
                unit = twin._smooth_step() if kind == "smooth" else twin._ig_step(*extra)
                entry = _aot_entry(unit, f"{aot_key}|{kind}|dwt1-{impl}|stft-{stft}", **kw)

                def call(a, y, *rest, entry=entry):
                    # int64 labels, as every caller's labels are read
                    out = entry(a, y.long(), _anchor(a.device), *rest)
                    failed = [f.error for f in entry.fns.values() if f.aot_status == "fallback"]
                    if failed:  # the selected impl, compiled, or nothing
                        raise RuntimeError(f"WaveletAttribution1D aot_key={aot_key!r}: the "
                                           f"compiled step of the 1D impl {impl!r} failed "
                                           f"to compile: {failed[0]}")
                    return out

                made[tag] = call
            return made[tag]

        return steps

    # -- SmoothGrad --------------------------------------------------------

    def smooth_wam(self, x, y, noise=None):
        mel_avg, grad_avg = self._smooth(x, y, noise)
        self.melspecs = mel_avg
        self.grad_coeffs = grad_avg
        return mel_avg, grad_avg

    def _smooth(self, x, y, noise=None, scale: float = 1.0, stream: bool | None = None,
                steps=None):
        """``(mel_avg, [coefficient averages])``, with no instance attribute
        set. ``scale`` and ``stream`` are `_rows`' (a block of a batch);
        ``steps`` (`_aot_steps`) runs each chunk compiled."""
        x, y = self._inputs(x, y)
        chunk = self._chunk(x)
        stream = self.stream_noise if stream is None else stream
        if self.mesh is not None:
            grad_avg, mel_tap = self._seq.smoothgrad(
                x, y, self.random_seed, n_samples=self.n_samples,
                stdev_spread=self.stdev_spread, sample_chunk=chunk,
                noise=None if noise is None else torch.as_tensor(noise, device=x.device))
            return mel_tap[:, 0], grad_avg
        run = self._smooth_step(scale) if steps is None else steps("smooth")

        def step(noisy: torch.Tensor) -> list[torch.Tensor]:  # (s, N, W)
            return run(noisy, y)

        generator = None
        if noise is None and not stream:
            generator = torch.Generator(device=self.device).manual_seed(self.random_seed)
        if noise is not None:
            noise = torch.as_tensor(noise, device=self.device)
        mel_avg, *grad_avg = smoothgrad(
            step, x, n_samples=self.n_samples, stdev_spread=self.stdev_spread,
            batch_size=chunk, generator=generator, noise=noise,
            materialize_noise=not stream, seed=self.random_seed)
        return mel_avg, grad_avg

    # -- Integrated gradients ---------------------------------------------

    def integrated_wam(self, x, y):
        mel_attr, coeff_attr = self._integrated(x, y)
        self.melspecs = mel_attr
        self.grad_coeffs = coeff_attr
        return mel_attr, coeff_attr

    def _integrated(self, x, y, scale: float = 1.0, steps=None):
        """``(mel_attr, [coefficient attributions])``, with no instance
        attribute set; ``scale`` is `_rows`'; ``steps`` (`_aot_steps`) runs
        each chunk compiled."""
        x, y = self._inputs(x, y)
        chunk = self._chunk(x)
        if self.mesh is not None:
            coeffs, (coeff_integ, mel_integ) = self._seq.integrated(
                x, y, n_steps=self.n_samples, sample_chunk=chunk)
            with torch.no_grad():
                baseline_mel = self._seq_front(x)[:, 0]
            return (baseline_mel * mel_integ[:, 0],
                    [c * g for c, g in zip(coeffs, coeff_integ)])
        length = x.shape[-1]
        with torch.no_grad():
            coeffs = self.engine.decompose(x)
            baseline_mel = self.compute_melspec(x)[:, 0]

        if steps is None:
            run, extra = self._ig_step(length, scale), (None,)
        else:
            run, extra = steps("ig", length), ()

        def grad_fn(alphas: torch.Tensor) -> list[torch.Tensor]:  # (s,)
            return run(alphas, y, *extra, *coeffs)

        mel_integ, *coeff_integ = integrated_path(
            grad_fn, n_steps=self.n_samples, batch_size=chunk, device=self.device)
        mel_attr = baseline_mel * mel_integ
        coeff_attr = [c * g for c, g in zip(coeffs, coeff_integ)]
        return mel_attr, coeff_attr

    def __call__(self, x, y, noise=None):
        if self.method == "smooth":
            return self.smooth_wam(x, y, noise)
        if noise is not None:
            raise ValueError("noise= applies to method='smooth' only")
        return self.integrated_wam(x, y)

    def serve_entry(self, donate: bool | None = None, on_trace=None,
                    aot_key: str | None = None, with_health: bool = False):
        """Batched serving entry ``(x, y) -> (mel_attr, coeff_attr)`` for the
        `wam_tpu_torch.serve` worker: x is (B, W) float32 waveforms (already
        peak-normalized — the list form of `normalize_waveforms` is a host
        step), y is (B,) int labels. Returns what ``__call__`` returns minus
        the instance-attribute stashing (``self.melspecs`` /
        ``self.grad_coeffs``) that makes it thread-unsafe; the serve runtime
        distributes rows of every leaf. SmoothGrad seeds its generator with
        the instance seed on every call (one noise stream for every batch).
        ``mesh=`` is rejected: the serving worker owns one device.
        ``with_health=True`` computes the numeric-health vector over the
        result tree in the same call (`serve.entry.jit_entry`). The entry
        carries the `serve.entry.RowBlocks` of `_rows` (the fleet's "pjit"
        oversize route). With ``aot_key`` each chunk step (`_smooth_step`,
        `_ig_step`) is a program of the compiled-step cache
        (`pipeline.aot`, `_aot_steps`); the noise draws and the loop over
        chunks stay eager."""
        if self.mesh is not None:
            raise ValueError(
                "serve_entry() does not support mesh=; the serve worker owns "
                "a single device — drive the sharded estimator directly")
        from wam_tpu_torch.serve.entry import RowBlocks, jit_entry

        impl = self._smooth if self.method == "smooth" else self._integrated

        def entry_impl(x, y):
            return impl(torch.as_tensor(x).float(), y)

        def wam_aot(key, **kw):
            steps = self._aot_steps(key, **kw)
            return lambda x, y: impl(torch.as_tensor(x).float(), y, steps=steps)

        entry_impl.wam_aot = wam_aot
        return jit_entry(entry_impl, donate=donate, on_trace=on_trace, aot_key=aot_key,
                         with_health=with_health, blocks=RowBlocks.local(self._rows))

    def _rows(self, x, y, lo: int, total: int):
        """Rows [lo, lo + len(x)) of the entry's result on a ``total``-row
        batch: SmoothGrad's draws are the whole batch's cut to these rows,
        and the gradients are scaled to the whole batch's loss (the mean
        over its rows). No reduction crosses rows, so nothing else is
        shared (`RowBlocks.local`)."""
        x = torch.as_tensor(x).float()
        scale = x.shape[0] / total
        if self.method != "smooth":
            return self._integrated(x, y, scale)
        xs, _ = self._inputs(x, y)
        draw = block_draws(self.random_seed, self.n_samples, (total,) + tuple(xs.shape[1:]), lo,
                           xs.shape[0], xs.device, xs.dtype, self.stream_noise)
        return self._smooth(x, y, draw(0, self.n_samples), scale, stream=False)


def _minmax_normalize(a):
    lo, hi = np.min(a), np.max(a)
    return (a - lo) / (hi - lo if hi > lo else 1.0)


class VisualizerWAM1D(WaveletAttribution1D):
    """Spectrogram-domain filtering and rendering of attribution outputs:
    mel filtering (ht / modulation), wavelet-domain filtering (ht / st /
    modulation) and spectrograms. Host numpy on the port's own transforms
    and mel chain (run on the instance's device); the mel -> STFT inversion
    is the NNLS of `ops.melspec.mel_to_stft_magnitude`."""

    def __init__(self, model_fn, x, **kwargs):
        super().__init__(model_fn, **kwargs)
        self.x = x
        self.source_spectrograms = None

    def compute_melspec_power(self, x) -> np.ndarray:
        """Power-scale mel spectrogram (no dB), (N, n_mels, T) mel-major."""
        with torch.no_grad():
            mel = melspectrogram(normalize_waveforms(x, self.device), sample_rate=self.sample_rate,
                                 n_fft=self.n_fft, n_mels=self.n_mels, to_db=False)
        return np.transpose(_host(mel), (0, 2, 1))

    def compute_spectrogram(self, melspecs: np.ndarray) -> np.ndarray:
        """Approximate STFT magnitudes from mel-power spectrograms."""
        return np.asarray([
            mel_to_stft_magnitude(m.T, self.sample_rate, self.n_fft, self.n_mels).T
            for m in melspecs])

    def filter_melspec(self, audio_melspecs, grad_melspecs, filtering_method, EPS=0.2):
        """ht: binary mask of the min-max-normalized gradients > EPS;
        modulation: mel spectrogram x |gradients|."""
        grads = np.transpose(_host(grad_melspecs), (0, 2, 1))
        if filtering_method == "ht":
            mask = (_minmax_normalize(grads) > EPS).astype(audio_melspecs.dtype)
            return audio_melspecs * mask
        if filtering_method == "modulation":
            return audio_melspecs * np.abs(grads)
        raise ValueError(f"Unknown filtering method {filtering_method!r}")

    def spectrogram_from_waveform(self, waveform) -> np.ndarray:
        """|STFT| with hop n_fft // 4, frequency-major."""
        with torch.no_grad():
            p = stft_power(normalize_waveforms(waveform, self.device), n_fft=self.n_fft,
                           hop=self.n_fft // 4)
        return np.sqrt(_host(p)).transpose(0, 2, 1)

    def filter_from_wavelet_coefficients(self, coefficients, gradients, filtering_method="ht",
                                         EPS=0.2):
        """Wavelet-domain filtering, then the inverse transform: ht = binary
        mask on the normalized |gradients|; st = soft shrinkage of the
        normalized coeff * grad; modulation = coeff * |grad| re-weighted by
        each level's share of the summed gradients."""
        coefficients = [_host(c) for c in coefficients]
        gradients = [_host(g) for g in gradients]
        if filtering_method == "ht":
            masks = [(np.abs(g) / np.max(np.abs(g)) > EPS).astype(np.float32) for g in gradients]
            filtered = [c * m for c, m in zip(coefficients, masks)]
        elif filtering_method == "st":
            masks = [np.maximum(_minmax_normalize(c * g) - EPS, 0.0)
                     for c, g in zip(coefficients, gradients)]
            filtered = [c * m for c, m in zip(coefficients, masks)]
        elif filtering_method == "modulation":
            importances = np.stack([g.sum(axis=-1) for g in gradients])  # (levels, B)
            shares = importances / np.maximum(importances.sum(axis=0, keepdims=True), 1e-12)
            modulated = [c * np.abs(g) for c, g in zip(coefficients, gradients)]
            filtered = [m * shares[i][:, None] for i, m in enumerate(modulated)]
        else:
            raise ValueError(f"Unknown filtering method {filtering_method!r}")
        with torch.no_grad():
            rec = waverec([torch.as_tensor(c, dtype=torch.float32, device=self.device)
                           for c in filtered], self.wavelet)
        return _host(rec)

    def filtered_spectrogram_from_wavelet_coefficients(self, grad_coeffs, filtering_method,
                                                       EPS=0.2):
        wave = normalize_waveforms(self.x, self.device)
        self.source_spectrograms = self.spectrogram_from_waveform(wave)
        with torch.no_grad():
            coeffs = wavedec(wave, self.wavelet, level=self.J, mode=self.mode)
        filtered = self.filter_from_wavelet_coefficients(
            coeffs, grad_coeffs, filtering_method=filtering_method, EPS=EPS)
        return self.source_spectrograms, self.spectrogram_from_waveform(filtered)

    def filtered_spectrogram_from_melspec(self, grad_melspecs, filtering_method, EPS=0.2):
        audio_melspecs = self.compute_melspec_power(self.x)
        self.source_spectrograms = self.compute_spectrogram(audio_melspecs)
        filtered = self.filter_melspec(audio_melspecs, grad_melspecs, filtering_method, EPS=EPS)
        return self.source_spectrograms, self.compute_spectrogram(filtered)
