"""Differentiable mel-spectrogram front end (PyTorch).

Counterpart of `wam_tpu.ops.melspec`, the torchaudio chain
``MelSpectrogram(sample_rate, n_fft, n_mels)`` + ``AmplitudeToDB()`` that the
1D attribution path backpropagates through: centred reflect padding, framing
as a view (`Tensor.unfold`, no gather), a periodic Hann window, the power
spectrum re^2 + im^2 (differentiable at 0, where ``abs() ** 2`` is not), the
HTK mel filterbank as a matmul, and a clamped ``10 * log10``.

Two STFT forms, chosen by ``impl`` or `set_stft_impl`: "fft" (`torch.fft.rfft`,
cuFFT on the card) and "matmul" (one windowed real-DFT matmul pair, O(n_fft^2)
operations). "auto" is "fft" here on every device, as the reference resolves
it off the TPU.

``bf16=True`` (or `set_mel_bf16`) feeds the DFT (matmul form only) and
filterbank matmuls bf16 inputs with float32 products and sums, as the
reference's ``preferred_element_type=float32``: both operands are rounded
to bf16 and multiplied as float32 (`_bf16_matmul`; a bf16 x bf16 product
is exact in float32, and a TF32 matmul reads bf16 values exactly). A plain
torch bf16 matmul would round its output to bf16 as well, one rounding
more than the reference (the cosine to float32 of the AudioCNN's mel
attribution moved from 0.9927 to 0.9888 with it). The power and dB math
stays float32 (float64 for float64 input).

Also the host-side approximate inverse (mel -> STFT magnitude by
non-negative least squares), for visualization only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["mel_filterbank", "stft_power", "melspectrogram", "amplitude_to_db",
           "mel_to_stft_magnitude", "set_stft_impl", "get_stft_impl",
           "set_mel_bf16", "get_mel_bf16"]

_STFT_IMPLS = ("auto", "fft", "matmul")
_stft_impl = "auto"
_mel_bf16 = False


def set_stft_impl(name: str) -> None:
    """Select the default STFT form ("auto" | "fft" | "matmul")."""
    global _stft_impl
    if name not in _STFT_IMPLS:
        raise ValueError(f"impl {name!r} not one of {_STFT_IMPLS}")
    _stft_impl = name


def get_stft_impl() -> str:
    return _stft_impl


def set_mel_bf16(on: bool) -> None:
    """Default the mel chain's matmuls to bf16 inputs (per-call ``bf16=``
    overrides this)."""
    global _mel_bf16
    _mel_bf16 = bool(on)


def get_mel_bf16() -> bool:
    return _mel_bf16


@functools.lru_cache(maxsize=8)
def _dft_matrices_np(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT matrices (n_fft, n_fft//2+1): frames @ C, frames @ S
    give the real and imaginary parts of rfft(frames * hann) up to the sign
    of the imaginary part, which the power does not see."""
    win = np.hanning(n_fft + 1)[:-1]
    ang = 2.0 * np.pi * np.arange(n_fft)[:, None] * np.arange(n_fft // 2 + 1)[None, :] / n_fft
    C = (np.cos(ang) * win[:, None]).astype(np.float32)
    S = (np.sin(ang) * win[:, None]).astype(np.float32)
    return C, S


def _bf16_matmul(a: torch.Tensor, b: torch.Tensor, out: torch.dtype) -> torch.Tensor:
    """a @ b from bf16-rounded operands, multiplied and summed in ``out``
    (float32 for float32 input): the reference's bf16 matmul with
    ``preferred_element_type=float32`` (module docstring)."""
    return a.to(torch.bfloat16).to(out) @ b.to(torch.bfloat16).to(out)


@functools.lru_cache(maxsize=16)
def _dft_matrices(n_fft: int, dtype: torch.dtype, device: torch.device):
    return tuple(torch.as_tensor(m, dtype=dtype, device=device) for m in _dft_matrices_np(n_fft))


@functools.lru_cache(maxsize=16)
def _hann(n_fft: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.hanning(n_fft + 1)[:-1], dtype=dtype, device=device)


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int, f_min: float = 0.0,
                   f_max: float | None = None) -> np.ndarray:
    """Triangular HTK-scale filterbank, shape (n_freqs, n_mels), float32."""
    f_max = sample_rate / 2 if f_max is None else f_max
    freqs = np.linspace(0, sample_rate / 2, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fb = np.zeros((n_freqs, n_mels))
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.clip(np.minimum(up, down), 0.0, None)
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _filterbank(n_freqs: int, n_mels: int, sample_rate: int, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    return torch.as_tensor(mel_filterbank(n_freqs, n_mels, sample_rate), dtype=dtype,
                           device=device)


def _use_matmul(impl: str | None) -> bool:
    if impl is not None and impl not in _STFT_IMPLS:
        raise ValueError(f"impl {impl!r} not one of {_STFT_IMPLS}")
    return (_stft_impl if impl is None or impl == "auto" else impl) == "matmul"


def stft_power(x: torch.Tensor, n_fft: int = 1024, hop: int | None = None, center: bool = True,
               impl: str | None = None, bf16: bool | None = None) -> torch.Tensor:
    """Power spectrogram |STFT|^2 with a periodic Hann window,
    (..., L) -> (..., n_frames, n_fft//2 + 1). Differentiable. ``impl``
    overrides `set_stft_impl` and ``bf16`` overrides `set_mel_bf16` for this
    call (bf16 applies to the matmul form only)."""
    hop = n_fft // 2 if hop is None else hop
    use_matmul = _use_matmul(impl)
    if center:
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (n_fft // 2, n_fft // 2), mode="reflect")
        x = x.reshape(lead + x.shape[-1:])
    frames = x.unfold(-1, n_fft, hop)  # (..., n_frames, n_fft), a view
    if use_matmul:
        use_bf16 = _mel_bf16 if bf16 is None else bool(bf16)
        out = torch.promote_types(x.dtype, torch.float32)
        C, S = _dft_matrices(n_fft, x.dtype, x.device)
        if use_bf16:
            re, im = _bf16_matmul(frames, C, out), _bf16_matmul(frames, S, out)
        else:
            re, im = (frames @ C).to(out), (frames @ S).to(out)
    else:
        spec = torch.fft.rfft(frames * _hann(n_fft, x.dtype, x.device), dim=-1)
        re, im = spec.real, spec.imag
    return re * re + im * im


def amplitude_to_db(power: torch.Tensor, amin: float = 1e-10) -> torch.Tensor:
    """10 * log10(max(x, amin)): torchaudio's AmplitudeToDB('power'), ref 1."""
    return 10.0 * torch.log10(torch.clamp_min(power, amin))


def melspectrogram(x: torch.Tensor, sample_rate: int = 44100, n_fft: int = 1024,
                   n_mels: int = 128, hop: int | None = None, to_db: bool = True,
                   impl: str | None = None, bf16: bool | None = None) -> torch.Tensor:
    """Batch mel spectrogram: (..., L) -> (..., n_frames, n_mels), time-major
    with the mel channels last, in dB unless ``to_db=False``. ``impl`` and
    ``bf16`` are the per-call overrides of `stft_power`; with bf16 the
    filterbank matmul takes bf16 inputs too."""
    use_bf16 = _mel_bf16 if bf16 is None else bool(bf16)
    p = stft_power(x, n_fft=n_fft, hop=hop, impl=impl, bf16=use_bf16)
    fb = _filterbank(n_fft // 2 + 1, n_mels, sample_rate, p.dtype, p.device)
    mel = _bf16_matmul(p, fb, p.dtype) if use_bf16 else p @ fb
    return amplitude_to_db(mel) if to_db else mel


def _nnls_projected_gradient(A: np.ndarray, B: np.ndarray, x0: np.ndarray, iters: int = 200,
                             tol: float = 1e-7) -> np.ndarray:
    """Minimize ||x @ A - B||^2 subject to x >= 0 (rows independent) by
    projected gradient with the exact Lipschitz step 1/lambda_max(A A^T).
    Host-side numpy."""
    AAt = A @ A.T
    step = 1.0 / max(float(np.linalg.eigvalsh(AAt).max()), 1e-12)
    BAt = B @ A.T
    x = np.maximum(x0, 0.0)
    prev = np.inf
    for _ in range(iters):
        x = np.maximum(x - step * (x @ AAt - BAt), 0.0)
        loss = float(np.square(x @ A - B).sum())
        if prev - loss <= tol * max(prev, 1.0):
            break
        prev = loss
    return x


def mel_to_stft_magnitude(mel_power: np.ndarray, sample_rate: int, n_fft: int,
                          n_mels: int) -> np.ndarray:
    """Inverse mel projection (host-side, visualization only): non-negative
    least squares from the clipped pinv solution, then sqrt to magnitude.
    ``mel_power`` (..., n_mels) -> (..., n_fft//2 + 1)."""
    fb = mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate)  # (F, M)
    x0 = np.clip(mel_power @ np.linalg.pinv(fb), 0.0, None)  # (..., F)
    lead = x0.shape[:-1]
    power = _nnls_projected_gradient(fb, mel_power.reshape(-1, mel_power.shape[-1]),
                                     x0.reshape(-1, x0.shape[-1]))
    return np.sqrt(power.reshape(lead + (fb.shape[0],)))
