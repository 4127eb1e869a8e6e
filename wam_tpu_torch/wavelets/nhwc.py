"""Channel-last (NHWC) 2D DWT / IDWT in PyTorch.

Counterpart of `wam_tpu.wavelets.nhwc`: the analysis and synthesis run over
axes (-3, -2) of an (..., H, W, C) tensor as two banded-matrix contractions
with the dense per-axis operators of `matmul.analysis_matrices` /
`matmul.synthesis_matrices` (the same boundary modes, filters and values as
the NCHW path), so a model bound with ``bind_inference(nchw=False)`` takes
the reconstruction with no layout conversion, and the coefficient
gradients come back NHWC for `ops.packing2d.mosaic2d(channel_axis=-1)`.

The reference runs these contractions as XLA einsums, not as Pallas
kernels, and so does the port: two ``torch.matmul`` a contraction (`_contract`,
with two transposing copies for the W axis), in full float32 forward and
backward whatever the caller's TF32 setting (the reference contracts at
``Precision.HIGHEST`` with float32 accumulation). bf16 inputs are upcast
first (bf16 in, float32 out); float64 stays float64.
"""

from __future__ import annotations

import torch

from wam_tpu_torch.wavelets.matmul import _analysis_operator, _f32_matmuls, _synthesis_operator
from wam_tpu_torch.wavelets.transform import Detail2D, _resolve

__all__ = ["dwt2_nhwc", "idwt2_nhwc", "wavedec2_nhwc", "waverec2_nhwc"]


def _contract(x: torch.Tensor, Mr: torch.Tensor, Mc: torch.Tensor) -> torch.Tensor:
    """y[..., p, q, c] = sum_{h, w} Mr[p, h] x[..., h, w, c] Mc[q, w].

    Mr runs over axis -3 as a batched matmul on the (..., H, W*C) view (no
    copy). Mc runs over axis -2 as ONE matmul of the (N*p*C, W) rows of a
    transposed copy. On the (N*p, W, C) view it would be N*p products of
    (q x W) by (W x C), three columns wide: that form took 11.3 ms for the
    transforms of one flagship chunk on an H100 80GB HBM3 (700 W), against
    1.2 ms on K1 / K3 (`chip_smoke.py` phase nhwc, ``transform_layer``)."""
    *lead, h, w, c = x.shape
    p, q = Mr.shape[0], Mc.shape[0]
    with _f32_matmuls():
        y = torch.matmul(Mr, x.reshape(tuple(lead) + (h, w * c)))  # (..., p, W*C)
        rows = y.reshape(-1, w, c).transpose(1, 2).reshape(-1, w)  # (N*p*C, W): a copy
        z = torch.matmul(rows, Mc.T)  # (N*p*C, q)
    # a contiguous (..., p, q, C): a model bound with nchw=False then runs on
    # channels-last strides (a reshape alone would keep the transposed view)
    return z.reshape(-1, c, q).transpose(1, 2).contiguous().view(tuple(lead) + (p, q, c))


class _Contract2(torch.autograd.Function):
    """`_contract` with its adjoint (Mr^T, Mc^T) as the backward, both in
    full float32."""

    @staticmethod
    def forward(ctx, x, Mr, Mc):
        ctx.save_for_backward(Mr, Mc)
        return _contract(x, Mr, Mc)

    @staticmethod
    def backward(ctx, g):
        Mr, Mc = ctx.saved_tensors
        return _contract(g.contiguous(), Mr.T, Mc.T), None, None


def _operand(x: torch.Tensor) -> torch.Tensor:
    return x.float() if x.dtype != torch.float64 else x


def dwt2_nhwc(x: torch.Tensor, wavelet, mode: str = "reflect"):
    """Single-level 2D DWT over axes (-3, -2) of (..., H, W, C). Returns
    (cA, Detail2D), every leaf (..., H', W', C) float32 (float64 for a
    float64 input): the values and subband convention of `transform.dwt2`
    on the transposed input."""
    wav = _resolve(wavelet)
    x = _operand(x)
    h, w = x.shape[-3], x.shape[-2]
    lo, hi = tuple(wav.dec_lo), tuple(wav.dec_hi)
    A = _analysis_operator(h, lo, hi, mode, x.dtype, x.device)
    B = _analysis_operator(w, lo, hi, mode, x.dtype, x.device)
    y = _Contract2.apply(x.contiguous(), A, B)  # (..., 2h', 2w', C) blocks
    hp, wp = A.shape[0] // 2, B.shape[0] // 2
    aa = y[..., :hp, :wp, :]
    ad = y[..., :hp, wp:, :]
    da = y[..., hp:, :wp, :]
    dd = y[..., hp:, wp:, :]
    return aa, Detail2D(horizontal=da, vertical=ad, diagonal=dd)


def idwt2_nhwc(cA: torch.Tensor, detail: Detail2D, wavelet, out_shape=None):
    """Inverse of `dwt2_nhwc`: (..., H', W', C) leaves -> (..., H, W, C)."""
    wav = _resolve(wavelet)
    n0, n1 = cA.shape[-3], cA.shape[-2]
    L = wav.filt_len
    target = (2 * n0 - L + 2, 2 * n1 - L + 2) if out_shape is None else tuple(out_shape)
    top = torch.cat([cA, detail.vertical], dim=-2)
    bot = torch.cat([detail.horizontal, detail.diagonal], dim=-2)
    y = _operand(torch.cat([top, bot], dim=-3))  # (..., 2h', 2w', C) blocks
    rec = (tuple(wav.rec_lo), tuple(wav.rec_hi))
    S_r = _synthesis_operator(n0, *rec, y.dtype, y.device)
    S_c = _synthesis_operator(n1, *rec, y.dtype, y.device)
    out = _Contract2.apply(y, S_r, S_c)
    return out[..., : target[0], : target[1], :]


def wavedec2_nhwc(x: torch.Tensor, wavelet, level: int, mode: str = "reflect"):
    """Multi-level NHWC 2D DWT: [cA_J, Detail2D_J, ..., Detail2D_1], each
    leaf (..., h, w, C): `transform.wavedec2`'s structure, channel-last."""
    wav = _resolve(wavelet)
    coeffs = []
    a = x
    for _ in range(level):
        a, det = dwt2_nhwc(a, wav, mode)
        coeffs.append(det)
    coeffs.append(a)
    return coeffs[::-1]


def waverec2_nhwc(coeffs, wavelet):
    """Inverse of `wavedec2_nhwc`: each level's approximation is trimmed to
    its details' shape before the synthesis."""
    wav = _resolve(wavelet)
    L = wav.filt_len
    a = coeffs[0]
    for det in coeffs[1:]:
        tgt = det.horizontal.shape[-3:-1]
        a = a[..., : tgt[0], : tgt[1], :]
        a = idwt2_nhwc(a, det, wav, out_shape=(2 * tgt[0] - L + 2, 2 * tgt[1] - L + 2))
    return a
