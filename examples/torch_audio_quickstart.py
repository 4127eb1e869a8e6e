"""Audio quick-start on the PyTorch port: WAM-1D on a waveform through the
differentiable mel-spectrogram front end (waveform -> DWT coefficients ->
IDWT -> mel spectrogram -> CNN -> gradients at both taps). Runs without
downloads: a synthetic chirp and a seeded audio CNN by default; pass --wav
(decoded by the port's native reader) / --checkpoint for real data.

    python examples/torch_audio_quickstart.py --quick --out scaleogram.png   # on the card
    python examples/torch_audio_quickstart.py --quick --device cpu
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, HERE)  # _png, the figures' writer, beside this script

import numpy as np


def synthetic_chirp(n: int, sr: int) -> np.ndarray:
    t = np.arange(n) / sr
    f = 200.0 + 1800.0 * t / t[-1]
    wave = np.sin(2 * np.pi * f * t) * np.hanning(n)
    return (wave * 0.8).astype(np.float32)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--wav", default=None, help="path to a WAV file")
    parser.add_argument("--checkpoint", default=None, help="audio-CNN checkpoint")
    parser.add_argument("--wavelet", default="db6")
    parser.add_argument("--levels", type=int, default=5)
    parser.add_argument("--samples", type=int, default=25)
    parser.add_argument("--device", default="auto",
                        help="auto (the CUDA card, or an error without one), cuda[:i] or cpu")
    parser.add_argument("--out", default="scaleogram.png")
    parser.add_argument("--quick", action="store_true")
    args = parser.parse_args(argv)

    import torch

    from wam_tpu_torch import WaveletAttribution1D
    from wam_tpu_torch.data.checkpoints import load_audio_model
    from wam_tpu_torch.device import resolve_device
    from wam_tpu_torch.ops.melspec import melspectrogram

    import _png

    device = resolve_device(args.device)
    sr = 44100
    if args.quick:
        args.samples, args.levels = 4, 3
    if args.wav:
        from wam_tpu_torch.native import read_wav

        sr, wave = read_wav(args.wav)
        wave = np.asarray(wave, dtype=np.float32)
        if wave.ndim > 1:
            wave = wave.mean(axis=-1)
    else:
        # the CNN pools T and M six times; keep the mel spectrogram >= 128 frames
        wave = synthetic_chirp(2**17, sr)

    n_mels = 128
    x = torch.as_tensor(wave, device=device)[None]
    probe = melspectrogram(x, sample_rate=sr, n_fft=1024, n_mels=n_mels)[:, None]
    _, _, model_fn = load_audio_model(args.checkpoint, num_classes=50, n_mels=n_mels,
                                      time_frames=probe.shape[2], device=device)
    explainer = WaveletAttribution1D(model_fn, wavelet=args.wavelet, J=args.levels,
                                     method="smooth", n_samples=args.samples, sample_rate=sr,
                                     n_mels=n_mels, device=device)
    with torch.no_grad():
        y = int(model_fn(probe).argmax())
    print(f"explaining class {y}")

    mel_grads, coeff_grads = explainer(x, torch.tensor([y], device=device))
    scale = explainer.visualize_grad_wam(coeff_grads)
    mel = mel_grads.detach().cpu().numpy()
    print("melspec-grad:", mel.shape, "scaleogram:", scale.shape)

    # above: the gradients at the mel-spectrogram tap, mel bins upward and time
    # across; below: the wavelet-coefficient pseudo-scaleogram, cut to 1024 columns
    cols = np.linspace(0, scale.shape[-1] - 1, 1024).astype(int)
    _png.write_png(args.out, _png.panels(
        [_png.heatmap(mel[0].T[::-1], "coolwarm", symmetric=True),
         _png.heatmap(np.nan_to_num(scale[0][:, cols]), "coolwarm")], axis=0))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
