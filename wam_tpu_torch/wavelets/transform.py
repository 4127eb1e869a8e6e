"""Differentiable multi-level 2D discrete wavelet transforms (PyTorch).

Counterpart of the 2D half of `wam_tpu.wavelets.transform`, with the same
coefficient layouts and pywt boundary semantics: ``wavedec2`` returns
``[cA_J, Detail2D(H_J, V_J, D_J), ..., Detail2D_1]`` where H = hi-pass along
rows (axis -2), V = hi-pass along columns (axis -1), D = both.

Three implementations of the same linear maps, chosen per call by ``impl``:

- ``"conv"``: strided conv2d over 4 fused subband channels (plain torch);
- ``"matmul"``: the banded-matrix form `matmul.analysis2_mm` /
  `matmul.synthesis2_mm` (plain torch);
- ``"kernel"``: the hand-written CUDA kernels — K1 (`matmul.dwt2_kernel`)
  for every analysis level, K3 (`matmul.waverec2_collapsed`) for the
  contiguous run of coarsest synthesis levels whose sides all fall below
  ``SYNTH_COLLAPSE``, and K2 (`matmul.idwt2_kernel`) for every remaining
  synthesis level. CPU tensors run the kernels' plain versions.

``impl=None`` resolves to ``"kernel"`` for CUDA tensors and ``"conv"`` for
CPU tensors. bf16 inputs give float32 coefficients on every impl.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from wam_tpu_torch.wavelets import matmul as _mm
from wam_tpu_torch.wavelets.filters import Wavelet, build_wavelet

__all__ = [
    "Detail2D",
    "dwt2",
    "idwt2",
    "wavedec2",
    "waverec2",
    "dwt_max_level",
    "SYNTH_COLLAPSE",
]

IMPLS = ("conv", "matmul", "kernel")

# Level-collapse crossover: the coarsest contiguous levels whose detail sides
# are all BELOW this run as one K3 operator pair. 128 is the starting value
# (the reference's); it is a configuration value, to be set by a sweep on
# the card.
SYNTH_COLLAPSE = 128


class Detail2D(NamedTuple):
    """One level of 2D detail coefficients."""

    horizontal: torch.Tensor
    vertical: torch.Tensor
    diagonal: torch.Tensor


# pywt boundary-mode name -> numpy-pad mode. pywt 'constant' replicates the
# edge value (numpy 'edge'); pywt 'zero' pads zeros (numpy 'constant');
# 'reflect' is whole-sample, 'symmetric' half-sample.
_PAD_MODE = {
    "zero": "constant",
    "constant": "edge",
    "symmetric": "symmetric",
    "reflect": "reflect",
    "periodic": "wrap",
}


def _resolve(wavelet) -> Wavelet:
    return wavelet if isinstance(wavelet, Wavelet) else build_wavelet(wavelet)


def _resolve_impl(impl: str | None, x: torch.Tensor) -> str:
    if impl is None:
        return "kernel" if x.is_cuda else "conv"
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not one of {IMPLS}")
    return impl


def dwt_max_level(data_len: int, filt_len: int) -> int:
    """pywt.dwt_max_level: floor(log2(data_len / (filt_len - 1)))."""
    if data_len < filt_len - 1 or filt_len < 2:
        return 0
    return int(np.floor(np.log2(data_len / (filt_len - 1.0))))


def _pad_axes(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """Pad the last two axes by ``pad`` on each side in a pywt mode. Any
    width works (the index map wraps as often as needed)."""
    if mode not in _PAD_MODE:
        raise ValueError(f"Unsupported mode {mode!r}; one of {sorted(_PAD_MODE)}")
    if mode == "zero":
        return F.pad(x, (pad, pad, pad, pad))
    for axis in (-2, -1):
        n = x.shape[axis]
        idx = torch.tensor([_mm._source_index(p, n, mode) for p in range(-pad, n + pad)],
                           device=x.device)
        x = x.index_select(axis % x.ndim, idx)
    return x


def _subband_kernel(wav: Wavelet, dtype, device) -> torch.Tensor:
    """Fused analysis kernel (4, 1, L, L) of flipped dec-filter outer
    products, channel order = binary a/d over (rows, cols)."""
    lo = np.asarray(wav.dec_lo[::-1])
    hi = np.asarray(wav.dec_hi[::-1])
    banks = [np.multiply.outer(r, c) for r in (lo, hi) for c in (lo, hi)]
    return torch.as_tensor(np.stack(banks)[:, None], dtype=dtype, device=device)


def _inv_subband_kernel(wav: Wavelet, dtype, device) -> torch.Tensor:
    """Fused synthesis kernel (1, 4, L, L): rec-filter outer products flipped
    along both axes (true convolution)."""
    lo = np.asarray(wav.rec_lo)
    hi = np.asarray(wav.rec_hi)
    banks = [np.multiply.outer(r, c)[::-1, ::-1] for r in (lo, hi) for c in (lo, hi)]
    return torch.as_tensor(np.stack(banks)[None].copy(), dtype=dtype, device=device)


def _analysis(x: torch.Tensor, wav: Wavelet, mode: str) -> torch.Tensor:
    """One analysis level over the last two axes, conv form.
    x: (..., H, W) -> (..., 4, H', W') with H' = floor((H + L - 1)/2)."""
    L = wav.filt_len
    batch_shape = x.shape[:-2]
    xb = x.reshape((-1, 1) + tuple(x.shape[-2:]))
    # offset by one so the stride-2 correlation lands on pywt's positions
    xp = _pad_axes(xb, L - 1, mode)[..., 1:, 1:]
    out = F.conv2d(xp, _subband_kernel(wav, x.dtype, x.device), stride=2)
    return out.reshape(batch_shape + out.shape[1:])


def _synthesis(subbands: torch.Tensor, wav: Wavelet, out_shape: Sequence[int]) -> torch.Tensor:
    """Inverse of one analysis level, conv form: zero-stuff by 2, pad 1 and
    correlate with the flipped rec kernel (= the true convolution trimmed by
    L-2 per side). subbands: (..., 4, h, w) -> (..., out_shape)."""
    batch_shape = subbands.shape[:-3]
    h, w = subbands.shape[-2:]
    xb = subbands.reshape((-1, 4, h, w))
    up = xb.new_zeros((xb.shape[0], 4, 2 * h - 1, 2 * w - 1))
    up[..., ::2, ::2] = xb
    out = F.conv2d(F.pad(up, (1, 1, 1, 1)), _inv_subband_kernel(wav, xb.dtype, xb.device))
    out = out[:, 0, : out_shape[0], : out_shape[1]]
    return out.reshape(batch_shape + tuple(out.shape[-2:]))


def dwt2(x: torch.Tensor, wavelet, mode: str = "reflect", impl: str | None = None):
    """Single-level 2D DWT over the last two axes. Returns (cA, Detail2D).

    bf16 inputs produce FLOAT32 coefficients on every impl: the kernel reads
    bf16 and upcasts on load; conv/matmul upcast here."""
    wav = _resolve(wavelet)
    impl = _resolve_impl(impl, x)
    if impl == "kernel":
        out = _mm.dwt2_kernel(x, wav, mode)
    else:
        if x.dtype == torch.bfloat16:
            x = x.float()
        out = _mm.analysis2_mm(x, wav, mode) if impl == "matmul" else _analysis(x, wav, mode)
    # channel order (row, col): 0=aa, 1=ad, 2=da, 3=dd
    return out[..., 0, :, :], Detail2D(
        horizontal=out[..., 2, :, :], vertical=out[..., 1, :, :], diagonal=out[..., 3, :, :]
    )


def idwt2(cA: torch.Tensor, detail: Detail2D, wavelet, out_shape=None,
          impl: str | None = None):
    """Single-level inverse 2D DWT; bf16 coefficients give float32 pixels.

    On ``impl="kernel"`` the level runs through K2 (`matmul.idwt2_kernel`,
    ``idwt2_pallas`` on the TPU), which reads bf16 subbands as they are;
    conv and matmul upcast them here."""
    wav = _resolve(wavelet)
    n0, n1 = cA.shape[-2:]
    L = wav.filt_len
    target = (2 * n0 - L + 2, 2 * n1 - L + 2) if out_shape is None else tuple(out_shape)
    impl = _resolve_impl(impl, cA)
    sub = torch.stack([cA, detail.vertical, detail.horizontal, detail.diagonal], dim=-3)
    if impl == "kernel":
        return _mm.idwt2_kernel(sub, wav, target)
    if sub.dtype == torch.bfloat16:
        sub = sub.float()
    if impl == "conv":
        return _synthesis(sub, wav, target)
    return _mm.synthesis2_mm(sub, wav, target)


def wavedec2(x: torch.Tensor, wavelet, level: int, mode: str = "reflect",
             impl: str | None = None):
    """Multi-level 2D DWT: [cA_J, Detail2D_J, ..., Detail2D_1]."""
    wav = _resolve(wavelet)
    coeffs = []
    a = x
    for _ in range(level):
        a, det = dwt2(a, wav, mode, impl)
        coeffs.append(det)
    coeffs.append(a)
    return coeffs[::-1]


def _collapse_count(details) -> int:
    """How many contiguous COARSEST levels fall below the collapse
    crossover (every detail side < SYNTH_COLLAPSE)."""
    k = 0
    for det in details:
        if max(det.horizontal.shape[-2:]) >= SYNTH_COLLAPSE:
            break
        k += 1
    return k


def waverec2(coeffs, wavelet, impl: str | None = None):
    """Inverse of `wavedec2`. On ``impl="kernel"`` the coarsest contiguous
    run of >= 2 levels below ``SYNTH_COLLAPSE`` is one K3 operator pair
    (`matmul.waverec2_collapsed`); remaining levels run through `idwt2`
    (K2)."""
    wav = _resolve(wavelet)
    a = coeffs[0]
    details = list(coeffs[1:])
    impl = _resolve_impl(impl, a)
    start = 0
    if impl == "kernel":
        k = _collapse_count(details)
        if k >= 2:
            a = _mm.waverec2_collapsed(a, details[:k], wav)
            start = k
    L = wav.filt_len
    for det in details[start:]:
        tgt = det.horizontal.shape[-2:]
        a = a[..., : tgt[0], : tgt[1]]
        a = idwt2(a, det, wav, out_shape=(2 * tgt[0] - L + 2, 2 * tgt[1] - L + 2), impl=impl)
    return a
