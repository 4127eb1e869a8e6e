"""Plain 2D discrete wavelet transforms with PyWavelets' conventions.

Written from the published definitions, not from the measured package:
the filter taps are PyWavelets' (`pywt.Wavelet(name).rec_lo`), the
boundary extension is the whole-sample reflection of pywt's "reflect"
mode, and one analysis level of a signal of length n keeps
floor((n + L - 1) / 2) coefficients per band, as pywt's `dwt` does:

    cA[i] = sum_k dec_lo[k] * x[2i + 1 - k]        (x reflected at both ends)
    x[t]  = sum_i cA[i] * rec_lo[t + L - 2 - 2i] + cD[i] * rec_hi[t + L - 2 - 2i]

Each axis is one dense matrix built in float64 on the host and applied as a
matrix product, so the 2D level is A X B^T. Band names follow pywt's
`dwt2`: H is high-pass along the rows axis (-2), V along the columns axis
(-1), D along both. No TF32: the caller runs with TF32 off.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# rec_lo (the scaling filter h) as PyWavelets tabulates it; dec_lo is its
# reverse and the high-pass pair follows by the quadrature-mirror relation
REC_LO = {
    "haar": (0.7071067811865476, 0.7071067811865476),
    "db4": (0.23037781330885523, 0.7148465705525415, 0.6308807679295904,
            -0.02798376941698385, -0.18703481171888114, 0.030841381835986965,
            0.032883011666982945, -0.010597401784997278),
}


def filters(name: str):
    """(dec_lo, dec_hi, rec_lo, rec_hi) as float64 arrays."""
    h = np.asarray(REC_LO[name], dtype=np.float64)
    g = h[::-1].copy()
    g[1::2] = -g[1::2]  # rec_hi[k] = (-1)^k h[L-1-k]
    return h[::-1].copy(), g[::-1].copy(), h, g


def _reflect(p: int, n: int) -> int:
    period = max(2 * n - 2, 1)
    m = p % period
    return m if m < n else period - m


@functools.lru_cache(maxsize=64)
def _analysis_np(n: int, name: str) -> tuple[np.ndarray, np.ndarray]:
    dec_lo, dec_hi, _, _ = filters(name)
    L = len(dec_lo)
    m = (n + L - 1) // 2
    lo = np.zeros((m, n))
    hi = np.zeros((m, n))
    for i in range(m):
        for k in range(L):
            j = _reflect(2 * i + 1 - k, n)
            lo[i, j] += dec_lo[k]
            hi[i, j] += dec_hi[k]
    return lo, hi


@functools.lru_cache(maxsize=64)
def _synthesis_np(m: int, n_out: int, name: str) -> tuple[np.ndarray, np.ndarray]:
    _, _, rec_lo, rec_hi = filters(name)
    L = len(rec_lo)
    lo = np.zeros((n_out, m))
    hi = np.zeros((n_out, m))
    for t in range(n_out):
        for i in range(m):
            k = t + L - 2 - 2 * i
            if 0 <= k < L:
                lo[t, i] = rec_lo[k]
                hi[t, i] = rec_hi[k]
    return lo, hi


def _dev(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def dwt2(x: torch.Tensor, name: str):
    """One level over the last two axes: (cA, (H, V, D))."""
    rl, rh = (_dev(a, x) for a in _analysis_np(x.shape[-2], name))
    cl, ch = (_dev(a, x) for a in _analysis_np(x.shape[-1], name))
    lo_c = x @ cl.T  # low-pass along the columns axis
    hi_c = x @ ch.T
    return rl @ lo_c, (rh @ lo_c, rl @ hi_c, rh @ hi_c)


def idwt2(cA: torch.Tensor, details, name: str) -> torch.Tensor:
    """Inverse of one level: pywt's `idwt2` output of (2h - L + 2, 2w - L + 2)."""
    H, V, D = details
    L = len(REC_LO[name])
    h, w = H.shape[-2:]
    cA = cA[..., :h, :w]
    rl, rh = (_dev(a, cA) for a in _synthesis_np(h, 2 * h - L + 2, name))
    cl, ch = (_dev(a, cA) for a in _synthesis_np(w, 2 * w - L + 2, name))
    return rl @ (cA @ cl.T + V @ ch.T) + rh @ (H @ cl.T + D @ ch.T)


def wavedec2(x: torch.Tensor, name: str, levels: int) -> list:
    """[cA_J, (H_J, V_J, D_J), ..., (H_1, V_1, D_1)]."""
    out = []
    a = x
    for _ in range(levels):
        a, det = dwt2(a, name)
        out.append(det)
    return [a] + out[::-1]


def waverec2(coeffs, name: str) -> torch.Tensor:
    a = coeffs[0]
    for det in coeffs[1:]:
        a = idwt2(a, det, name)
    return a
