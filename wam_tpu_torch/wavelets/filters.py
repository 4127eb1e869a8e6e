"""Orthogonal wavelet filter-bank generation (the PyTorch port's own copy of
`wam_tpu.wavelets.filters`: pure numpy, float64, identical taps).

The reference stack obtains its filters from PyWavelets / ptwt (C/Cython), e.g.
``ptwt.wavedec2(x, "haar", ...)`` at ``lib/wam_2D.py:96`` and the wavelet names
exercised by the reference experiments (haar, db4, db6, db8, sym3, sym4, sym8 —
`compare_iou_models.ipynb` cell 4, `results/plots_mean_grads/*.png`).

Here the filters are *generated* numerically at import time (host-side, float64
numpy) rather than vendored as tables:

- Daubechies (dbN): spectral factorization of the maximally-flat half-band
  product filter — roots of the binomial polynomial P(y), minimum-phase root
  selection (|z| < 1).
- Symlets (symN): same product filter, root assignment chosen per
  conjugate-reciprocal group to minimize phase non-linearity
  (least-asymmetric Daubechies).
- Haar = db1.

Filter layout follows the pywt convention so coefficient semantics match the
reference: ``rec_lo`` is the scaling filter h (sum = sqrt(2)), ``dec_lo`` its
reverse, and the high-pass pair comes from the quadrature-mirror relation
g[k] = (-1)^k h[L-1-k].
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

__all__ = ["Wavelet", "build_wavelet", "qmf", "daubechies_scaling", "symlet_scaling"]


@dataclasses.dataclass(frozen=True)
class Wavelet:
    """An orthogonal wavelet filter bank (pywt-compatible layout)."""

    name: str
    dec_lo: np.ndarray  # analysis low-pass (reversed scaling filter)
    dec_hi: np.ndarray  # analysis high-pass
    rec_lo: np.ndarray  # synthesis low-pass (the scaling filter h)
    rec_hi: np.ndarray  # synthesis high-pass

    @property
    def filt_len(self) -> int:
        return len(self.dec_lo)


def qmf(h: np.ndarray) -> np.ndarray:
    """Quadrature-mirror high-pass from scaling filter: g[k] = (-1)^k h[L-1-k]."""
    g = h[::-1].copy()
    g[1::2] = -g[1::2]
    return g


def _binomial_poly(N: int) -> np.ndarray:
    """P(y) = sum_{k=0}^{N-1} C(N-1+k, k) y^k, descending-order coeffs for np.roots."""
    coeffs = [math.comb(N - 1 + k, k) for k in range(N)]
    return np.array(coeffs[::-1], dtype=np.float64)


def _z_roots_of_y(y: complex) -> tuple[complex, complex]:
    """Solve z^2 + (4y - 2) z + 1 = 0, i.e. y = (2 - z - 1/z)/4; roots are reciprocal."""
    b = 4.0 * y - 2.0
    disc = np.sqrt(b * b - 4.0 + 0j)
    z1 = (-b + disc) / 2.0
    z2 = (-b - disc) / 2.0
    return z1, z2


def _poly_from_roots(roots: list[complex]) -> np.ndarray:
    p = np.array([1.0 + 0j])
    for r in roots:
        p = np.convolve(p, np.array([1.0, -r]))
    return p


def _assemble_scaling(N: int, selected_z: list[complex]) -> np.ndarray:
    """h(z) = ((1+z)/2)^N * L(z) with L built from selected roots; normalize sum=sqrt(2)."""
    h = np.array([1.0 + 0j])
    for _ in range(N):
        h = np.convolve(h, np.array([0.5, 0.5]))
    h = np.convolve(h, _poly_from_roots(selected_z))
    h = np.real(h)
    h *= np.sqrt(2.0) / h.sum()
    return h


@functools.lru_cache(maxsize=None)
def daubechies_scaling(N: int) -> np.ndarray:
    """Minimum-phase (standard dbN) scaling filter of length 2N.

    Verified against the closed-form db2 coefficients
    ((1±sqrt(3))/(4 sqrt(2)) family) in tests/test_filters.py.
    """
    if N < 1:
        raise ValueError("Daubechies order must be >= 1")
    if N == 1:
        return np.array([1.0, 1.0]) / np.sqrt(2.0)
    yroots = np.roots(_binomial_poly(N))
    selected = []
    for y in yroots:
        z1, z2 = _z_roots_of_y(y)
        selected.append(z1 if abs(z1) < abs(z2) else z2)
    h = _assemble_scaling(N, selected)
    # Standard orientation: energy front-loaded (matches pywt rec_lo for dbN).
    if abs(h[0]) < abs(h[-1]):
        h = h[::-1]
    return h


def _phase_nonlinearity(h: np.ndarray) -> float:
    """Squared deviation of the unwrapped frequency-response phase from linear."""
    n = 1024
    w = np.linspace(1e-3, np.pi - 1e-3, n)
    H = np.polyval(h[::-1].astype(complex), np.exp(-1j * w))
    phase = np.unwrap(np.angle(H))
    # least-squares linear fit
    A = np.stack([w, np.ones_like(w)], axis=1)
    resid = phase - A @ np.linalg.lstsq(A, phase, rcond=None)[0]
    return float(np.sum(resid**2))


@functools.lru_cache(maxsize=None)
def symlet_scaling(N: int) -> np.ndarray:
    """Least-asymmetric Daubechies (symN) scaling filter of length 2N.

    Enumerates root-group assignments of the shared product filter and picks
    the one with the most linear phase.
    """
    if N < 2:
        raise ValueError("Symlet order must be >= 2")
    yroots = list(np.roots(_binomial_poly(N)))
    # Group y-roots: complex-conjugate pairs must flip together to keep h real.
    groups: list[list[complex]] = []
    used = [False] * len(yroots)
    for i, y in enumerate(yroots):
        if used[i]:
            continue
        used[i] = True
        if abs(y.imag) < 1e-12:
            groups.append([complex(y.real, 0.0)])
        else:
            for j in range(i + 1, len(yroots)):
                if not used[j] and abs(yroots[j] - np.conj(y)) < 1e-8:
                    used[j] = True
                    groups.append([y, yroots[j]])
                    break
            else:
                groups.append([y])  # unpaired (numerical); treat alone
    best_h, best_score = None, np.inf
    for mask in range(1 << len(groups)):
        selected: list[complex] = []
        for gi, group in enumerate(groups):
            take_inside = not (mask >> gi) & 1
            for y in group:
                z1, z2 = _z_roots_of_y(y)
                zin, zout = (z1, z2) if abs(z1) < abs(z2) else (z2, z1)
                selected.append(zin if take_inside else zout)
        h = _assemble_scaling(N, selected)
        score = _phase_nonlinearity(h)
        if score < best_score:
            best_score, best_h = score, h
    h = best_h
    if abs(h[0]) < abs(h[-1]):
        h = h[::-1]
    return h


@functools.lru_cache(maxsize=None)
def build_wavelet(name: str) -> Wavelet:
    """Build a named wavelet filter bank: 'haar', 'dbN', 'symN'."""
    key = name.lower().strip()
    if key == "haar" or key == "db1":
        h = daubechies_scaling(1)
    elif key.startswith("db"):
        h = daubechies_scaling(int(key[2:]))
    elif key.startswith("sym"):
        h = symlet_scaling(int(key[3:]))
    else:
        raise ValueError(f"Unsupported wavelet: {name!r} (expected haar/dbN/symN)")
    g = qmf(h)
    return Wavelet(
        name=key,
        dec_lo=h[::-1].copy(),
        dec_hi=g[::-1].copy(),
        rec_lo=h.copy(),
        rec_hi=g.copy(),
    )
