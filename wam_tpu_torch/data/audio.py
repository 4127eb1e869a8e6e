"""Audio data, the numpy half (PyTorch port of part of
`wam_tpu.data.audio`): 0 dB noise injection, the centered Hann STFT and the
log-mel features the reference's ESC-50 pipeline computes on the host, and
balanced-class sample weights. The ESC-50 dataset and the sound sampler
read WAV files through the reference's native reader and wait for its port
(ROADMAP.md, slice F)."""

from __future__ import annotations

import numpy as np

from wam_tpu_torch.ops.melspec import mel_filterbank

__all__ = [
    "add_0db_noise",
    "stft_np",
    "logmel_np",
    "make_weights_for_balanced_classes",
]


def add_0db_noise(audio: np.ndarray) -> np.ndarray:
    """Gaussian noise at 0 dB SNR (noise RMS = signal RMS) from numpy's
    global generator, keeping int16 range and dtype for int16 input."""
    was_int = audio.dtype == np.int16
    a = audio.astype(np.float32)
    rms_signal = np.sqrt(np.mean(a**2))
    noise = np.random.normal(0, 1, a.shape)
    noise *= rms_signal / np.sqrt(np.mean(noise**2))
    noisy = a + noise
    if was_int:
        return np.clip(noisy, -32768, 32767).astype(np.int16)
    return noisy.astype(np.float32)


def stft_np(x: np.ndarray, n_fft: int = 1024, hop: int = 512) -> np.ndarray:
    """Centered (reflect-padded) Hann STFT, (F, T) complex: librosa.stft's
    layout."""
    x = np.asarray(x, dtype=np.float32)
    pad = n_fft // 2
    xp = np.pad(x, (pad, pad), mode="reflect")
    n_frames = 1 + (len(xp) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    window = np.hanning(n_fft + 1)[:-1]
    spec = np.fft.rfft(xp[idx] * window, axis=-1)
    return spec.T


def _power_to_db(p: np.ndarray, amin: float = 1e-10) -> np.ndarray:
    return 10.0 * np.log10(np.maximum(p, amin))


def logmel_np(x: np.ndarray, sr: int = 44100, n_fft: int = 1024, hop: int = 512,
              n_mels: int = 128):
    """(log-mel (T, M), |STFT| (F, T), log1p |STFT|, phase): the reference's
    feature tuple."""
    Xs = stft_np(x, n_fft, hop)
    mag = np.abs(Xs)
    fb = mel_filterbank(n_fft // 2 + 1, n_mels, sr)  # (F, M)
    mel = (mag.T @ fb).T  # (M, T)
    return _power_to_db(mel).T, mag, np.log1p(mag), Xs / (1e-9 + mag)


def make_weights_for_balanced_classes(dataset, nclasses: int = 10) -> list[float]:
    """Inverse-frequency sample weights; ``dataset[i][1]`` is item i's label."""
    count = [0] * nclasses
    labels = [int(dataset[i][1]) for i in range(len(dataset))]
    for y in labels:
        count[y] += 1
    total = float(sum(count))
    per_class = [total / c if c else 0.0 for c in count]
    return [per_class[y] for y in labels]
