"""Audio data (PyTorch port of `wam_tpu.data.audio`): the ESC-50 dataset
(fold split from ``meta/esc50.csv``, noise injection, log-mel items,
``overlap_two`` mixing), the sound sampler `load_sound`, 0 dB noise
injection, the centered Hann STFT and log-mel features the pipeline
computes on the host, and balanced-class sample weights. WAV files are
decoded by the port's native reader (`wam_tpu_torch.native`); features are
numpy, on the host."""

from __future__ import annotations

import csv
import os
from typing import Sequence

import numpy as np

from wam_tpu_torch.native import WavPrefetcher, read_wav
from wam_tpu_torch.ops.melspec import mel_filterbank

__all__ = [
    "add_0db_noise",
    "stft_np",
    "logmel_np",
    "ESC50",
    "load_sound",
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


class ESC50:
    """ESC-50 with its fold split: ``mode="test"`` keeps fold ``num_FOLD``,
    ``"train"`` the others, of the classes in ``select_class`` (all 50 when
    empty; labels then index into it). Items: (log-mel (1, T, M) float32,
    label, |STFT|, log1p |STFT|, phase, path, idx); duck-compatible with
    ``torch.utils.data.Dataset``."""

    def __init__(self, mode: str = "train", num_FOLD: int = 1, root_dir: str = "ESC50",
                 select_class: Sequence[int] = (), add_noise: bool = False,
                 nfft: int = 1024, hop: int = 512, sr: int = 44100, nmel: int = 128):
        self.mode = mode
        self.num_FOLD = num_FOLD
        self.root_dir = root_dir
        self.subset = list(select_class) if select_class else list(range(50))
        self.nfft, self.hop, self.sr, self.nmel = nfft, hop, sr, nmel
        self.noise = add_noise

        rows = []
        with open(os.path.join(root_dir, "meta", "esc50.csv")) as f:
            for row in csv.DictReader(f):
                fold, target = int(row["fold"]), int(row["target"])
                if target not in self.subset:
                    continue
                if (mode == "test") == (fold == num_FOLD):
                    rows.append(row)
        self.rows = rows
        self.noise_strength = np.zeros(len(rows))
        self.signal_strength = np.zeros(len(rows))

    def __len__(self) -> int:
        return len(self.rows)

    def _path(self, row) -> str:
        return os.path.join(self.root_dir, "audio", row["filename"])

    def _label(self, row) -> int:
        y = int(row["target"])
        return self.subset.index(y) if len(self.subset) < 50 else y

    def iter_waveforms(self, indices=None, workers: int = 4, capacity: int = 8):
        """Stream (idx, normalized waveform) through the native prefetcher:
        ``workers`` C++ threads decode up to ``capacity`` files ahead of the
        consumer, delivered in order (a Python thread pool without the
        toolchain)."""
        idxs = list(range(len(self.rows))) if indices is None else list(indices)
        paths = [self._path(self.rows[i]) for i in idxs]
        with WavPrefetcher(paths, workers=workers, capacity=capacity) as pf:
            for i, (_, audio) in zip(idxs, pf):
                yield i, self._normalize(audio)

    @staticmethod
    def _normalize(audio: np.ndarray) -> np.ndarray:
        """First channel, float32, divided by the signed maximum (the
        reference's ``wf / wf.max()``); an all-zero clip stays zeros."""
        if audio.ndim > 1:
            audio = audio[:, 0]
        audio = audio.astype(np.float32)
        peak = audio.max()
        return audio / (peak if peak != 0 else 1.0)

    def _load(self, row) -> np.ndarray:
        _, audio = read_wav(self._path(row))
        return self._normalize(audio)

    def _features(self, audio: np.ndarray):
        return logmel_np(audio, self.sr, self.nfft, self.hop, self.nmel)

    def __getitem__(self, idx: int):
        row = self.rows[idx]
        audio = self._load(row)
        if self.noise:
            energy = (audio**2).mean()
            noise = np.random.normal(0, 0.05, audio.shape[0])
            noise *= np.sqrt(energy / (noise**2).mean())
            audio = audio + noise
        logmel, mag, logmag, phase = self._features(audio)
        return logmel[None].astype(np.float32), self._label(row), mag, logmag, phase, \
            self._path(row), idx

    def overlap_two(self, idx1: int, idx2: int, lambda2: float = 0.2):
        """Clip 1 + ``lambda2`` x clip 2 (cut to the shorter), clip 1's label."""
        a1 = self._load(self.rows[idx1])
        a2 = self._load(self.rows[idx2])
        n = min(len(a1), len(a2))
        logmel, mag, logmag, phase = self._features(a1[:n] + lambda2 * a2[:n])
        paths = self.rows[idx1]["filename"] + self.rows[idx2]["filename"]
        return logmel[None].astype(np.float32), self._label(self.rows[idx1]), mag, logmag, \
            phase, paths


def load_sound(root_dir: str, n=42, noise: bool = False) -> dict:
    """``n`` clips drawn with ``RandomState(42)`` from ``meta/esc50.csv``'s
    rows (or the files named when ``n`` is a list): {"x": waveforms (first
    channel), "y": labels}, 0 dB noise added when ``noise``."""
    meta = {}
    order = []
    with open(os.path.join(root_dir, "meta", "esc50.csv")) as f:
        for row in csv.DictReader(f):
            meta[row["filename"]] = int(row["target"])
            order.append(row["filename"])

    if isinstance(n, list):
        names = n
    else:
        rng = np.random.RandomState(42)
        names = [order[i] for i in rng.randint(0, len(order), n)]

    waveforms, labels = [], []
    for name in names:
        _, audio = read_wav(os.path.join(root_dir, "audio", name))
        if audio.ndim > 1:
            audio = audio[:, 0]
        labels.append(meta[name])
        waveforms.append(add_0db_noise(audio) if noise else audio)
    return {"x": waveforms, "y": labels}


def make_weights_for_balanced_classes(dataset, nclasses: int = 10) -> list[float]:
    """Inverse-frequency sample weights; ``dataset[i][1]`` is item i's label."""
    count = [0] * nclasses
    labels = [int(dataset[i][1]) for i in range(len(dataset))]
    for y in labels:
        count[y] += 1
    total = float(sum(count))
    per_class = [total / c if c else 0.0 for c in count]
    return [per_class[y] for y in labels]
