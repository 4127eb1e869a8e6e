"""Periodized (orthogonal) DWT in PyTorch.

Counterpart of `wam_tpu.wavelets.periodized`. With circular boundary
handling the DWT is an exactly orthogonal N -> N map (N/2 + N/2
coefficients), so its inverse is its adjoint. One level along the last
axis is a stride-2 ``conv1d`` over the fused (lo, hi) analysis bank after
the last L - 2 samples are prepended once (the reference's one-time wrap,
not a true circle: its output needs N >= L - 2, and a shorter axis raises
here as the reference's reshape does). The inverse is the adjoint: a
``conv_transpose1d`` over the same bank, with the first L - 2 outputs
folded back onto the tail. The two are one `torch.autograd.Function` pair,
each the other's backward, both in full float32 (TF32 off, as the
reference's transforms run at ``Precision.HIGHEST``); bf16 inputs give
float32 coefficients, float64 stays float64.

The 2D and 3D forms are separable: `separable_dwt2` runs the H axis first
and names the subbands as `transform.dwt2` does (horizontal = detail along
H, vertical = detail along W), `separable_dwt3` runs D, then H, then W and
keys the subbands by their a/d letters over (D, H, W). Their inverses
apply the 1D adjoints in the reverse order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from wam_tpu_torch.wavelets.filters import Wavelet, build_wavelet
from wam_tpu_torch.wavelets.transform import Detail2D, _f32_convs

__all__ = ["dwt_per", "idwt_per", "wavedec_per", "waverec_per", "separable_dwt2", "dwt2_per",
           "wavedec2_per", "idwt2_per", "waverec2_per", "separable_dwt3", "dwt3_per",
           "wavedec3_per", "idwt3_per", "waverec3_per"]


def _resolve(wavelet) -> Wavelet:
    return wavelet if isinstance(wavelet, Wavelet) else build_wavelet(wavelet)


@functools.lru_cache(maxsize=64)
def _bank(dec_lo: tuple, dec_hi: tuple, dtype, device) -> torch.Tensor:
    """(2, 1, L) correlation bank of the flipped dec filters, built once per
    device (a copy from host memory waits for the queue)."""
    k = np.stack([np.asarray(dec_lo[::-1]), np.asarray(dec_hi[::-1])])[:, None]
    return torch.as_tensor(k, dtype=dtype, device=device)


def _wrap_analysis(x: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """(B, 1, N) -> (B, 2, N/2): the last L - 2 samples prepended once, then
    the stride-2 correlation."""
    wrap = bank.shape[-1] - 2
    if wrap > 0:
        x = torch.cat([x[..., -wrap:], x], dim=-1)
    with _f32_convs():
        return F.conv1d(x, bank, stride=2)


def _wrap_synthesis(sub: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """(B, 2, n) -> (B, 1, 2n), the adjoint of `_wrap_analysis`: the
    transposed correlation gives the 2n + L - 2 padded samples, and the
    first L - 2 of them (the prepended copy) are added back onto the tail."""
    with _f32_convs():
        full = F.conv_transpose1d(sub, bank, stride=2)
    wrap = bank.shape[-1] - 2
    if wrap <= 0:
        return full
    out = full[..., wrap:].clone()
    out[..., -wrap:] += full[..., :wrap]
    return out


class _DwtPer(torch.autograd.Function):
    """One periodized analysis level; its backward is the synthesis."""

    @staticmethod
    def forward(ctx, x, bank):
        ctx.save_for_backward(bank)
        return _wrap_analysis(x, bank)

    @staticmethod
    def backward(ctx, g):
        (bank,) = ctx.saved_tensors
        return _IdwtPer.apply(g, bank), None


class _IdwtPer(torch.autograd.Function):
    """One periodized synthesis level (the adjoint); its backward is the
    analysis."""

    @staticmethod
    def forward(ctx, sub, bank):
        ctx.save_for_backward(bank)
        return _wrap_synthesis(sub, bank)

    @staticmethod
    def backward(ctx, g):
        (bank,) = ctx.saved_tensors
        return _DwtPer.apply(g, bank), None


def _float(x: torch.Tensor) -> torch.Tensor:
    return x.float() if x.dtype == torch.bfloat16 else x


def dwt_per(x: torch.Tensor, wavelet) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-level periodized DWT along the last axis (even length N >=
    L - 2): out[k] = sum_j f[j] x[(2k - L + 2 + j) mod N], k < N/2, the
    alignment of the zero-padded transform with a circular wrap."""
    wav = _resolve(wavelet)
    L, N = wav.filt_len, x.shape[-1]
    if N % 2:
        raise ValueError("periodized DWT requires even length")
    if N < L - 2:
        raise ValueError(f"periodized DWT of a {wavelet!r} ({L} taps) needs length >= {L - 2}, "
                         f"got {N}")
    x = _float(x)
    batch_shape = x.shape[:-1]
    out = _DwtPer.apply(x.reshape(-1, 1, N),
                        _bank(tuple(wav.dec_lo), tuple(wav.dec_hi), x.dtype, x.device))
    out = out.reshape(batch_shape + (2, N // 2))
    return out[..., 0, :], out[..., 1, :]


def idwt_per(cA: torch.Tensor, cD: torch.Tensor, wavelet) -> torch.Tensor:
    """Exact inverse of `dwt_per` (its adjoint; the transform is orthogonal)."""
    wav = _resolve(wavelet)
    sub = _float(torch.stack([cA, cD], dim=-2))
    n = sub.shape[-1]
    batch_shape = sub.shape[:-2]
    if 2 * n < wav.filt_len - 2:
        raise ValueError(f"periodized IDWT of a {wavelet!r} needs length >= {wav.filt_len - 2}, "
                         f"got {2 * n}")
    out = _IdwtPer.apply(sub.reshape(-1, 2, n),
                         _bank(tuple(wav.dec_lo), tuple(wav.dec_hi), sub.dtype, sub.device))
    return out.reshape(batch_shape + (2 * n,))


def wavedec_per(x: torch.Tensor, wavelet, level: int):
    """Multi-level periodized decomposition [cA_J, cD_J, ..., cD_1]."""
    coeffs = []
    a = x
    for _ in range(level):
        a, d = dwt_per(a, wavelet)
        coeffs.append(d)
    coeffs.append(a)
    return coeffs[::-1]


def waverec_per(coeffs, wavelet):
    """Inverse of `wavedec_per`."""
    a = coeffs[0]
    for d in coeffs[1:]:
        a = idwt_per(a, d, wavelet)
    return a


def _along(t: torch.Tensor, axis: int, fn):
    """``fn`` (a 1D transform along the last axis, two outputs) applied
    along ``axis``."""
    a, d = fn(torch.movedim(t, axis, -1))
    return torch.movedim(a, -1, axis), torch.movedim(d, -1, axis)


def separable_dwt2(x: torch.Tensor, dwt1_w, dwt1_h):
    """Single-level separable 2D DWT from two 1D transforms: ``dwt1_h``
    along H (axis -2) FIRST, then ``dwt1_w`` along W on both halves.
    Returns (cA, Detail2D) with `transform.dwt2`'s subband naming."""
    aH, dH = _along(x, -2, dwt1_h)
    aa, ad = dwt1_w(aH)
    da, dd = dwt1_w(dH)
    return aa, Detail2D(horizontal=da, vertical=ad, diagonal=dd)


def dwt2_per(x: torch.Tensor, wavelet):
    """Single-level separable periodized 2D DWT over the last two axes (both
    even). Returns (cA, Detail2D) named as `transform.dwt2` names them."""
    wav = _resolve(wavelet)

    def one(t):
        return dwt_per(t, wav)

    return separable_dwt2(x, one, one)


def wavedec2_per(x: torch.Tensor, wavelet, level: int):
    """Multi-level periodized 2D decomposition [cA_J, Detail2D_J, ...,
    Detail2D_1]."""
    coeffs = []
    a = x
    for _ in range(level):
        a, det = dwt2_per(a, wavelet)
        coeffs.append(det)
    coeffs.append(a)
    return coeffs[::-1]


def idwt2_per(cA: torch.Tensor, detail, wavelet) -> torch.Tensor:
    """Exact inverse of `dwt2_per` (its adjoint): W first, then H."""
    wav = _resolve(wavelet)
    aH = idwt_per(cA, detail.vertical, wav)
    dH = idwt_per(detail.horizontal, detail.diagonal, wav)
    x = idwt_per(aH.transpose(-1, -2), dH.transpose(-1, -2), wav)
    return x.transpose(-1, -2)


def waverec2_per(coeffs, wavelet):
    """Inverse of `wavedec2_per`."""
    a = coeffs[0]
    for det in coeffs[1:]:
        a = idwt2_per(a, det, wavelet)
    return a


def separable_dwt3(x: torch.Tensor, dwt1_w, dwt1_h, dwt1_d):
    """Single-level separable 3D DWT over the last three axes (D, H, W) from
    three 1D transforms, D first, then H, then W. Returns (cA, {key: arr})
    with `transform.dwt3`'s naming: key letters in (D, H, W) order, 'aad' =
    approx D, approx H, detail W."""
    out = {}
    aD, dD = _along(x, -3, dwt1_d)
    for d_letter, d_arr in (("a", aD), ("d", dD)):
        aH, dH = _along(d_arr, -2, dwt1_h)
        for h_letter, h_arr in (("a", aH), ("d", dH)):
            aW, dW = dwt1_w(h_arr)
            out[d_letter + h_letter + "a"] = aW
            out[d_letter + h_letter + "d"] = dW
    return out.pop("aaa"), out


def dwt3_per(x: torch.Tensor, wavelet):
    """Single-level separable periodized 3D DWT (all three sizes even)."""
    wav = _resolve(wavelet)

    def one(t):
        return dwt_per(t, wav)

    return separable_dwt3(x, one, one, one)


def wavedec3_per(x: torch.Tensor, wavelet, level: int):
    """Multi-level periodized 3D decomposition [cA_J, {aad..ddd}_J, ...,
    {aad..ddd}_1]."""
    coeffs = []
    a = x
    for _ in range(level):
        a, det = dwt3_per(a, wavelet)
        coeffs.append(det)
    coeffs.append(a)
    return coeffs[::-1]


def _inverse_along(a: torch.Tensor, d: torch.Tensor, axis: int, wav: Wavelet) -> torch.Tensor:
    out = idwt_per(torch.movedim(a, axis, -1), torch.movedim(d, axis, -1), wav)
    return torch.movedim(out, -1, axis)


def idwt3_per(cA: torch.Tensor, details: dict, wavelet) -> torch.Tensor:
    """Exact inverse of `dwt3_per` (its adjoint): W, then H, then D."""
    wav = _resolve(wavelet)
    sub = {"aaa": cA, **details}
    by_d = {}
    for dl in "ad":
        by_h = {hl: idwt_per(sub[dl + hl + "a"], sub[dl + hl + "d"], wav) for hl in "ad"}
        by_d[dl] = _inverse_along(by_h["a"], by_h["d"], -2, wav)
    return _inverse_along(by_d["a"], by_d["d"], -3, wav)


def waverec3_per(coeffs, wavelet):
    """Inverse of `wavedec3_per`."""
    a = coeffs[0]
    for det in coeffs[1:]:
        a = idwt3_per(a, det, wavelet)
    return a
