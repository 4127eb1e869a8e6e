"""Polyphase-folded 1D DWT/IDWT (PyTorch port of `wam_tpu.wavelets.folded1d`).

The plain form of the 1D transform is a strided convolution with one input
channel over a (B, 1, n) signal. Folding P signal phases into the channel
dimension turns the same linear map into a convolution with 2P = 128 input
and 2P output channels and 2-3 taps: a dense 128 x 128 product a tap.

Analysis: with xp the padded signal (out[i] = sum_k f_rev[k] xp[2i + k]),
write xp's indices as n = 2P m + r and the outputs' as i = P mo + s. Then

    out[f, P mo + s] = sum_{r, j} W[(f, s), r, j] ph[r, mo + j],
    W[(f, s), r, j]  = f_rev[2P j + r - 2s]   (0 <= . < L, else 0),

one valid stride-1 convolution over the chunks. Synthesis folds the
transposed map the same way (its input padded on the right). Both are the
conv form's linear map; only the order of the float sums differs.

Layouts: "nch" runs the convolution on (B, 2P, chunks), which costs a
transpose on each side of the phase split. "nhc" keeps the chunks outer: the
analysis phase split (B, total) -> (B, chunks, 2P) and the synthesis
flatten (B, Mt, 2P) -> (B, Mt 2P) are free reshapes, and the convolution
runs channels-last (a (B, 2P, 1, chunks) tensor in ``torch.channels_last``
memory, cuDNN's NHWC form); one transpose a direction remains.

The fold matrices are built once per (wavelet, P, dtype, device) from the
float64 taps. The reference builds them in float32 and casts them to the
signal's dtype, so its float64 fold rounds every tap to float32; this one
keeps float64 taps for float64 signals (float32 entries are the same).

Both directions are autograd Functions whose backward is the adjoint map,
run inside the transform's profiler span, and every convolution runs in
full float32 (TF32 off), as the conv form does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from wam_tpu_torch.wavelets.filters import Wavelet
from wam_tpu_torch.wavelets.transform import SPAN_1D, _f32_convs

__all__ = ["fold_analysis1d", "fold_synthesis1d", "FOLD_P"]

FOLD_P = 64  # phases a chunk: 2P = 128 channels
LAYOUTS = ("nch", "nhc")


@functools.lru_cache(maxsize=128)
def _analysis_kernel_np(dec_lo: tuple, dec_hi: tuple, P: int) -> np.ndarray:
    """(out = (f, s): 2P, in = r: 2P, taps J) folded analysis kernel."""
    L = len(dec_lo)
    J = (2 * (P - 1) + L - 1) // (2 * P) + 1
    W = np.zeros((2 * P, 2 * P, J), dtype=np.float64)
    for f, filt in enumerate((dec_lo, dec_hi)):
        f_rev = np.asarray(filt[::-1], dtype=np.float64)
        for s in range(P):
            for j in range(J):
                for r in range(2 * P):
                    k = 2 * P * j + r - 2 * s
                    if 0 <= k < L:
                        W[f * P + s, r, j] = f_rev[k]
    return W


@functools.lru_cache(maxsize=128)
def _synthesis_kernel_np(rec_lo: tuple, rec_hi: tuple, P: int) -> np.ndarray:
    """(out = rt: 2P, in = (f, si): 2P, taps T) folded synthesis kernel:
    out[2P mt + rt] = sum_i sub[f, i] rec_f[t + L - 2 - 2i]; tap tau reads
    input chunk mt + tau (the input padded on the right by T - 1 chunks)."""
    L = len(rec_lo)
    T = (2 * P + L - 3) // (2 * P) + 1
    W = np.zeros((2 * P, 2 * P, T), dtype=np.float64)
    for f, filt in enumerate((rec_lo, rec_hi)):
        rec = np.asarray(filt, dtype=np.float64)
        for rt in range(2 * P):
            for si in range(P):
                for tau in range(T):
                    g = -2 * P * tau + rt + (L - 2) - 2 * si
                    if 0 <= g < L:
                        W[rt, f * P + si, tau] = rec[g]
    return W


@functools.lru_cache(maxsize=64)
def _weight(kind: str, lo: tuple, hi: tuple, P: int, layout: str, dtype, device) -> torch.Tensor:
    """The fold matrix on ``device``, built once (a copy from host memory
    waits for the queue): (2P, 2P, taps) for "nch", (2P, 2P, 1, taps) in
    channels-last memory for "nhc"."""
    W = (_analysis_kernel_np if kind == "analysis" else _synthesis_kernel_np)(lo, hi, P)
    w = torch.as_tensor(W, dtype=dtype, device=device)
    if layout == "nhc":
        w = w[:, :, None].contiguous(memory_format=torch.channels_last)
    return w


def _fit(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad or crop the last axis to ``n``."""
    m = x.shape[-1]
    return F.pad(x, (0, n - m)) if n > m else x[..., :n]


def _split(x: torch.Tensor, layout: str, width: int) -> torch.Tensor:
    """(B, K width) -> chunks of ``width`` samples as channels: (B, width, K)
    for "nch", (B, K, width) for "nhc" (a free reshape)."""
    h = x.reshape(x.shape[0], -1, width)
    return h.transpose(1, 2) if layout == "nch" else h


def _merge(h: torch.Tensor, layout: str) -> torch.Tensor:
    """The inverse of `_split`: (B, K width)."""
    if layout == "nch":
        h = h.transpose(1, 2)
    return h.reshape(h.shape[0], -1)


def _group(x: torch.Tensor, layout: str, P: int) -> torch.Tensor:
    """(B, 2, K P) -> channels (f, s) of chunk k = x[f, P k + s]:
    (B, 2P, K) for "nch", (B, K, 2P) for "nhc"."""
    B, K = x.shape[0], x.shape[-1] // P
    h = x.reshape(B, 2, K, P)
    if layout == "nch":
        return h.transpose(2, 3).reshape(B, 2 * P, K)
    return h.transpose(1, 2).reshape(B, K, 2 * P)


def _ungroup(h: torch.Tensor, layout: str, P: int) -> torch.Tensor:
    """The inverse of `_group`: (B, 2, K P)."""
    if layout == "nch":
        B, _, K = h.shape
        return h.reshape(B, 2, P, K).transpose(2, 3).reshape(B, 2, K * P)
    B, K, _ = h.shape
    return h.reshape(B, K, 2, P).transpose(1, 2).reshape(B, 2, K * P)


def _conv(h: torch.Tensor, w: torch.Tensor, layout: str, transpose: bool) -> torch.Tensor:
    """The valid stride-1 convolution with the fold matrix (or its
    transpose, the adjoint) in ``layout``'s form: "nch" a conv1d on
    (B, 2P, K), "nhc" a conv2d on the channels-last view (B, 2P, 1, K) of
    (B, K, 2P), returned as (B, K', 2P)."""
    with _f32_convs():
        if layout == "nch":
            return (F.conv_transpose1d if transpose else F.conv1d)(h, w)
        out = (F.conv_transpose2d if transpose else F.conv2d)(h[:, None].permute(0, 3, 1, 2), w)
    return out.permute(0, 2, 3, 1)[:, 0]


class _FoldAnalysis(torch.autograd.Function):
    """(B, Np) padded signal -> (B, 2, n_out) [cA; cD]; the backward is the
    adjoint map inside the transform's span."""

    @staticmethod
    def forward(ctx, xb, w, n_out: int, M: int, layout: str, P: int):
        ctx.save_for_backward(w)
        ctx.meta = (xb.shape[-1], M, layout, P)
        total = (M + w.shape[-1] - 1) * 2 * P
        h = _conv(_split(_fit(xb, total), layout, 2 * P), w, layout, False)
        return _ungroup(h, layout, P)[..., :n_out]

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        n, M, layout, P = ctx.meta
        with torch.profiler.record_function(SPAN_1D):
            h = _conv(_group(_fit(g, M * P), layout, P), w, layout, True)
            return _fit(_merge(h, layout), n), None, None, None, None, None


class _FoldSynthesis(torch.autograd.Function):
    """(B, 2, n) [cA; cD] -> (B, full) full reconstruction; the backward is
    the adjoint map inside the transform's span."""

    @staticmethod
    def forward(ctx, sb, w, full: int, Mt: int, layout: str, P: int):
        ctx.save_for_backward(w)
        ctx.meta = (sb.shape[-1], Mt, layout, P)
        Mi = Mt + w.shape[-1] - 1
        h = _conv(_group(_fit(sb, Mi * P), layout, P), w, layout, False)
        return _fit(_merge(h, layout), full)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        n, Mt, layout, P = ctx.meta
        with torch.profiler.record_function(SPAN_1D):
            h = _conv(_split(_fit(g, Mt * 2 * P), layout, 2 * P), w, layout, True)
            return _fit(_ungroup(h, layout, P), n), None, None, None, None, None


def _check_layout(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} not one of {LAYOUTS}")


def fold_analysis1d(xp: torch.Tensor, wav: Wavelet, n_out: int, P: int = FOLD_P,
                    layout: str = "nch") -> torch.Tensor:
    """The folded form of the 1D analysis convolution.

    ``xp``: the already padded signal (``pad(x, L - 1)[..., 1:]``), shape
    (..., Np). Returns (..., 2, n_out) in the conv form's channel layout
    ([cA; cD]). ``layout``: "nch" or "nhc" (module docstring)."""
    _check_layout(layout)
    batch_shape = xp.shape[:-1]
    w = _weight("analysis", tuple(wav.dec_lo), tuple(wav.dec_hi), P, layout, xp.dtype,
                xp.device)
    out = _FoldAnalysis.apply(xp.reshape(-1, xp.shape[-1]), w, n_out, -(-n_out // P), layout, P)
    return out.reshape(batch_shape + (2, n_out))


def fold_synthesis1d(sub: torch.Tensor, wav: Wavelet, P: int = FOLD_P,
                     layout: str = "nch") -> torch.Tensor:
    """The folded form of the 1D synthesis convolution.

    ``sub``: (..., 2, n) [cA; cD]. Returns the full reconstruction
    (..., 2n - L + 2); the caller crops it as it crops the conv form's.
    ``layout`` as in `fold_analysis1d`; under "nhc" the output flatten is
    a free reshape."""
    _check_layout(layout)
    batch_shape = sub.shape[:-2]
    n = sub.shape[-1]
    full = 2 * n - wav.filt_len + 2
    w = _weight("synthesis", tuple(wav.rec_lo), tuple(wav.rec_hi), P, layout, sub.dtype,
                sub.device)
    y = _FoldSynthesis.apply(sub.reshape(-1, 2, n), w, full, -(-full // (2 * P)), layout, P)
    return y.reshape(batch_shape + (full,))
