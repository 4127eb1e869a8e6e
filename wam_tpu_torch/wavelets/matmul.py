"""DWT as banded matrix products, with the hand-written CUDA kernels K1-K3.

PyTorch counterpart of `wam_tpu.wavelets.matmul`. Boundary padding (reflect /
symmetric / zero / edge / periodic, pywt semantics) is folded into a dense
per-axis analysis matrix, so one full 2D level is

    [[aa, ad], [da, dd]] = [A_lo; A_hi] @ X @ [B_lo; B_hi]^T

and the deep tail of small synthesis levels collapses into one operator pair
``R @ Y @ C^T``. The operators are built host-side in float64 numpy and cached.

Three functions carry a kernel, each a ``torch.autograd.Function`` with its
plain PyTorch version beside it:

- `dwt2_kernel` (counterpart of ``dwt2_pallas``): K1, ``csrc/dwt2.cu``;
  backward is the plain adjoint ``A^T gY B`` (``_core_bwd``).
- `idwt2_kernel` (counterpart of ``idwt2_pallas``): K2, ``csrc/synth2.cu``,
  which merges the subbands inside the kernel; backward is the quadrant
  split of ``Sr^T g Sc``, a launch of K1 (``_synth_bwd``).
- `waverec2_collapsed`: K3, ``csrc/pair.cu``, which reads the coefficient
  leaves in place of the assembled Y; backward ``R^T g C`` (``_pair_bwd``)
  and its slices, one launch of K3's adjoint that writes the leaves'
  gradients.

The kernels skip the operators' zeros: they take each operator in band form
(`band_form`: the nonzeros of each row, or column, and their indices) laid
out for the kernel as a `kernels.BandPlan` (`dwt2_band`, `idwt2_band`), or,
for K3, one such plan per collapsed level and direction (`pair_band`). The
plain versions stay dense matmul pairs.

A CUDA tensor goes to the kernel, or the call raises; the plain version
serves CPU tensors only. `analysis2_mm` / `synthesis2_mm` are the plain
matmul forms, differentiable by construction. `synthesis3_mm` is the 3D
synthesis as three banded products (no TPU kernel covers 3D), in full
float32 forward and backward whatever the caller's TF32 setting.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from wam_tpu_torch import kernels
from wam_tpu_torch.device import on_cpu
from wam_tpu_torch.wavelets.filters import Wavelet, build_wavelet

__all__ = [
    "analysis_matrices",
    "synthesis_matrices",
    "analysis2_mm",
    "synthesis2_mm",
    "synthesis3_mm",
    "band_form",
    "dwt2_band",
    "idwt2_band",
    "pair_band",
    "dwt2_kernel",
    "idwt2_kernel",
    "waverec2_collapsed",
]


def _source_index(p: int, n: int, mode: str) -> int:
    """Map an (possibly out-of-range) padded position to an index in [0, n),
    or -1 when the contribution is zero (mode='zero'). Follows pywt/numpy pad
    semantics: 'reflect' = whole-sample, 'symmetric' = half-sample,
    'constant' = edge-replicate (pywt naming), 'periodic' = wrap."""
    if 0 <= p < n:
        return p
    if mode == "zero":
        return -1
    if mode == "constant":  # pywt 'constant' replicates the edge value
        return 0 if p < 0 else n - 1
    if mode == "periodic":
        return p % n
    if mode == "reflect":
        if n == 1:
            return 0
        period = 2 * n - 2
        m = p % period
        return m if m < n else period - m
    if mode == "symmetric":
        period = 2 * n
        m = p % period
        return m if m < n else period - 1 - m
    raise ValueError(f"Unsupported mode {mode!r}")


@functools.lru_cache(maxsize=256)
def _analysis_np(n: int, dec_lo: tuple, dec_hi: tuple, mode: str) -> np.ndarray:
    """Stacked analysis matrix [A_lo; A_hi] of shape (2*n_out, n): row i of
    A_f computes coefficient i of the f-subband, boundary handling folded in.
    out[i] = sum_k f_rev[k] * xp[2i + k] with xp = pad(x, L-1)[1:]
    (transform._analysis)."""
    L = len(dec_lo)
    n_out = (n + L - 1) // 2
    mats = []
    for filt in (dec_lo, dec_hi):
        f_rev = np.asarray(filt[::-1], dtype=np.float64)
        A = np.zeros((n_out, n))
        for i in range(n_out):
            for k in range(L):
                s = _source_index(2 * i + k - L + 2, n, mode)
                if s >= 0:
                    A[i, s] += f_rev[k]
        mats.append(A)
    return np.concatenate(mats, axis=0)


@functools.lru_cache(maxsize=256)
def _synthesis_np(n_out: int, rec_lo: tuple, rec_hi: tuple) -> np.ndarray:
    """Stacked synthesis matrix [S_lo | S_hi] of shape (full, 2*n_out) with
    full = 2*n_out - L + 2: the zero-stuffed true convolution with the rec
    filters, trimmed by L-2 per side (transform._synthesis)."""
    L = len(rec_lo)
    full = 2 * n_out - L + 2
    mats = []
    for filt in (rec_lo, rec_hi):
        f = np.asarray(filt, dtype=np.float64)
        S = np.zeros((full, n_out))
        for i in range(n_out):
            for k in range(L):
                t = 2 * i + k - (L - 2)
                if 0 <= t < full:
                    S[t, i] += f[k]
        mats.append(S)
    return np.concatenate(mats, axis=1)


@functools.lru_cache(maxsize=256)
def _collapsed_axis_np(sizes: tuple, rec_lo: tuple, rec_hi: tuple) -> np.ndarray:
    """Per-axis level-collapsed synthesis operator.

    ``sizes`` are the per-level coefficient lengths along one axis, COARSEST
    FIRST (n_J, ..., n_1). The synthesis cascade is linear, so it composes
    into one banded matrix: with S_l = [S_lo | S_hi] the level-l synthesis
    matrix and the inter-level trim folded in as a row slice,

        C_1 = S_1,   C_l = C_{l-1}[:, :n_{l-1}] @ S_l[:n_{l-1}, :]

    maps level-l [lo; hi] coefficients straight to the finest level's full
    output. Returns [C_J | ... | C_1], shape (2*n_1 - L + 2, 2*sum(sizes))."""
    fine_first = sizes[::-1]
    blocks: list[np.ndarray] = []
    e_lo = None  # C_{l-1}[:, :n_{l-1}]: the lo chain up to the previous level
    for i, n in enumerate(fine_first):
        S = _synthesis_np(int(n), rec_lo, rec_hi)
        if e_lo is None:
            C = S
        else:
            n_prev = int(fine_first[i - 1])
            C = e_lo @ S[:n_prev, :]
        blocks.append(C)
        e_lo = C[:, : int(n)]
    return np.concatenate(blocks[::-1], axis=1)


def _wav(wavelet) -> Wavelet:
    return wavelet if isinstance(wavelet, Wavelet) else build_wavelet(str(wavelet))


def analysis_matrices(n: int, wavelet, mode: str, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """(2*n_out, n) stacked [A_lo; A_hi] analysis matrix for one axis."""
    w = _wav(wavelet)
    return torch.as_tensor(_analysis_np(n, tuple(w.dec_lo), tuple(w.dec_hi), mode),
                           dtype=dtype, device=device)


def synthesis_matrices(n_out: int, wavelet, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """(2*n_out - L + 2, 2*n_out) stacked [S_lo | S_hi] synthesis matrix."""
    w = _wav(wavelet)
    return torch.as_tensor(_synthesis_np(n_out, tuple(w.rec_lo), tuple(w.rec_hi)),
                           dtype=dtype, device=device)


@functools.lru_cache(maxsize=256)
def _kernel_analysis(n: int, dec_lo: tuple, dec_hi: tuple, mode: str,
                     device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(A, A^T) float32 on ``device``, both contiguous; cached so the hot
    path copies no operator to the device."""
    A = torch.as_tensor(_analysis_np(n, dec_lo, dec_hi, mode), dtype=torch.float32,
                        device=device)
    return A, A.T.contiguous()


@functools.lru_cache(maxsize=256)
def _kernel_synthesis(n: int, rec_lo: tuple, rec_hi: tuple,
                      device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(S, S^T) float32 on ``device``, both contiguous: the synthesis
    operator [S_lo | S_hi] of an n-long coefficient axis and its transpose."""
    S = torch.as_tensor(_synthesis_np(n, rec_lo, rec_hi), dtype=torch.float32, device=device)
    return S, S.T.contiguous()


@functools.lru_cache(maxsize=256)
def _kernel_collapsed(sizes: tuple, rec_lo: tuple, rec_hi: tuple,
                      device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, C^T) float32 on ``device``, both contiguous."""
    C = torch.as_tensor(_collapsed_axis_np(sizes, rec_lo, rec_hi), dtype=torch.float32,
                        device=device)
    return C, C.T.contiguous()


# ---------------------------------------------------------------------------
# Band form: what K1 and K2 read instead of the dense operators
# ---------------------------------------------------------------------------


def band_form(M: np.ndarray, along: str = "rows") -> tuple[np.ndarray, np.ndarray]:
    """ELL form of a banded operator: for each row of ``M`` (``along="rows"``,
    the M1 of a product M1 . X . M2) or each column (``"cols"``, the M2), the
    indices of its nonzeros in ascending order and their values, padded to
    K = the most nonzeros of any row (column) with weight 0 at the row's
    first index. Returns (idx int32 (R, K), w float64 (R, K)); scattering
    ``w`` to ``idx`` gives ``M`` (or ``M.T``) back bit for bit."""
    if along not in ("rows", "cols"):
        raise ValueError(f"along must be 'rows' or 'cols', got {along!r}")
    rows = M if along == "rows" else M.T
    nz = rows != 0
    k = max(1, int(nz.sum(1).max(initial=0)))
    idx = np.zeros((rows.shape[0], k), np.int32)
    w = np.zeros((rows.shape[0], k))
    for r in range(rows.shape[0]):
        cols = np.flatnonzero(nz[r])
        if len(cols):
            idx[r] = cols[0]
            idx[r, :len(cols)] = cols
            w[r, :len(cols)] = rows[r, cols]
    return idx, w


def _pairs(n: int, pairing: str) -> list[tuple[int, int]]:
    """Output rows (or columns) that share their taps, two by two: K1's lo
    and hi halves (i, n/2 + i), or K2's neighbours (2m, 2m + 1); -1 pads."""
    if pairing == "halves":
        return [(i, n // 2 + i) for i in range(n // 2)]
    return [(2 * m, 2 * m + 1 if 2 * m + 1 < n else -1) for m in range((n + 1) // 2)]


def _pair_taps(ell, pairs) -> list[tuple[list, list, list]]:
    """For each pair: the union of its two rows' taps (ascending) and each
    row's weight on them (0 where it has none)."""
    idx, w = ell
    out = []
    for a, b in pairs:
        wts = [{int(i): float(v) for i, v in zip(idx[r], w[r]) if v != 0} if r >= 0 else {}
               for r in (a, b)]
        cols = sorted(set(wts[0]) | set(wts[1]))
        out.append((cols, [wts[0].get(c, 0.0) for c in cols], [wts[1].get(c, 0.0) for c in cols]))
    return out


# Shared memory a band block aims for: two blocks share an SM (228 KB, 1 KB
# reserved per block). Measured against three, four and six blocks with
# scripts/torch_band_sweep.py: the larger tiles of two blocks won every case.
SMEM_TARGET = 228 * 1024 // 2 - 1024


def _taps_kc(k: int) -> int:
    """Taps held in registers for rows of at most ``k`` taps: 2, 4, 8 or 16."""
    return next((c for c in (2, 4, 8) if k <= c), 16)


def _fold(s: int, fold: int) -> tuple[np.ndarray, int, int]:
    """Where a strip of ``s`` columns keeps column c when it groups its
    columns by c mod ``fold`` (1: unpermuted; 2: K1's even and odd halves).
    Group i starts at i * fstride, fstride = 32 / fold (mod 32), so a warp
    that reads one tap of 32 neighbouring column pairs, ``fold`` columns
    apart, hits 32 banks. Returns (position of each column, fstride, floats
    per strip row)."""
    c = np.arange(s)
    if fold == 1:
        return c, 0, s
    block = -(-s // fold)
    fstride = block + (32 // fold - block) % 32
    return (c % fold) * fstride + c // fold, fstride, (fold - 1) * fstride + s // fold


def _tiling(row_taps, rt: int):
    """Row tiles of ``rt`` row pairs, each tile's staged source rows (the
    union of its pairs' taps) and the most rows any tile stages."""
    tiles = [row_taps[i:i + rt] for i in range(0, len(row_taps), rt)]
    slots = [sorted({c for cols, _, _ in tile for c in cols}) or [0] for tile in tiles]
    return tiles, slots, max(len(sl) for sl in slots)


def _tile_arrays(tiles, slots, sm: int, row_pairs, rt: int, k: int) -> dict:
    """tsrc, trow, tidx, tw of a tiling (``csrc/band2.cuh``'s layout)."""
    ntiles = len(tiles)
    tsrc = np.full((ntiles, sm), -1, np.int32)
    trow = np.full((ntiles, rt, 2), -1, np.int32)
    tidx = np.zeros((ntiles, rt, k), np.int32)
    tw = np.zeros((ntiles, rt, 2, k), np.float32)
    for j, (tile, sl) in enumerate(zip(tiles, slots)):
        tsrc[j, :len(sl)] = sl
        local = {c: i for i, c in enumerate(sl)}
        for r, (cols, wa, wb) in enumerate(tile):
            trow[j, r] = row_pairs[j * rt + r]
            if cols:
                tidx[j, r, :] = local[cols[0]]
                tidx[j, r, :len(cols)] = [local[c] for c in cols]
                tw[j, r, 0, :len(cols)] = wa
                tw[j, r, 1, :len(cols)] = wb
    return dict(tsrc=tsrc, trow=trow, tidx=tidx, tw=tw, ntiles=ntiles, rt=rt, sm=sm)


def _col_arrays(col_taps, col_pairs, k: int, perm: np.ndarray) -> dict:
    """ccol, cidx, cw of the column pairs, taps at their strip positions."""
    tp = len(col_pairs)
    ccol = np.asarray(col_pairs, np.int32).reshape(tp, 2)
    cidx = np.zeros((tp, k), np.int32)
    cw = np.zeros((tp, 2, k), np.float32)
    for u, (cols, wa, wb) in enumerate(col_taps):
        if cols:
            cidx[u, :] = perm[cols[0]]
            cidx[u, :len(cols)] = perm[cols]
            cw[u, 0, :len(cols)] = wa
            cw[u, 1, :len(cols)] = wb
    return dict(ccol=ccol, cidx=cidx, cw=cw, tp=tp)


def _band_plan_np(m1, m2, q: int, s: int, pairing: str, deinterleave: bool,
                  smem_target: int = SMEM_TARGET) -> dict:
    """The `kernels.BandPlan` fields of out[n] = M1 . X[n] . M2 as numpy
    arrays and ints (``csrc/band2.cuh`` documents the layout). ``m1`` is the
    band form of M1's rows (P of them, taps in [0, q)), ``m2`` of M2's
    columns (T, taps in [0, s)). Output rows and columns are paired by
    ``pairing``; ``deinterleave`` stores the strip's odd columns apart (K1's
    analysis taps step by 2). Row tiles take the most row pairs (16 at
    most) whose block fits ``smem_target`` bytes, else the whole of a
    block's shared memory; failing that, the column pairs' taps stay in
    device memory, then one stage is tried in place of two."""
    p, t = m1[0].shape[0], m2[0].shape[0]
    row_pairs, col_pairs = _pairs(p, pairing), _pairs(t, pairing)
    row_taps, col_taps = _pair_taps(m1, row_pairs), _pair_taps(m2, col_pairs)
    k = max(len(c) for c, _, _ in row_taps + col_taps)
    kc = _taps_kc(k)
    k = max(k, kc)
    perm, odd_off, ts_stride = _fold(s, 2 if deinterleave else 1)

    choice = None
    options = [(2, 1, smem_target)] + [(st, cs, kernels.MAX_SMEM)
                                       for st in (2, 1) for cs in (1, 0)]
    for stages, cols_shared, budget in options:
        for rt in (16, 8, 4, 2, 1):
            tiles, slots, sm = _tiling(row_taps, rt)
            if kernels.band_smem_bytes(s, sm, rt, k, len(col_pairs), ts_stride, stages,
                                       cols_shared) <= budget:
                choice = (stages, cols_shared, rt, tiles, slots, sm)
                break
        if choice:
            break
    if choice is None:
        raise ValueError(f"band plan: a {q} x {s} source with {k} taps does not fit "
                         f"{kernels.MAX_SMEM} bytes of shared memory")
    stages, cols_shared, rt, tiles, slots, sm = choice
    return dict(**_tile_arrays(tiles, slots, sm, row_pairs, rt, k),
                **_col_arrays(col_taps, col_pairs, k, perm), q=q, s=s, p=p, t=t, kc=kc, k=k,
                odd_off=odd_off, ts_stride=ts_stride, stages=stages, cols_shared=cols_shared)


def _plan_blob(plan: dict) -> np.ndarray:
    """The int32 blob ``csrc/band2.cuh`` reads: tsrc, then each tile's row
    pairs (trow, tidx, tw) side by side, then ccol, cidx, cw with the column
    pair as the last (fastest) axis."""
    nt = plan["ntiles"]
    tdat = np.concatenate([plan[f].view(np.int32).reshape(nt, -1) for f in ("trow", "tidx", "tw")],
                          axis=1)
    return np.concatenate([plan["tsrc"].ravel(), tdat.ravel()]
                          + [np.moveaxis(plan[f].view(np.int32), 0, -1).ravel()
                             for f in ("ccol", "cidx", "cw")])


def _device_plan(plan: dict, device) -> kernels.BandPlan:
    blob = _plan_blob(plan)
    return kernels.BandPlan(torch.from_numpy(blob).to(device),
                            **{f: plan[f] for f in kernels.BandPlan._fields if f != "blob"})


@functools.lru_cache(maxsize=256)
def _dwt2_plan_np(h: int, w: int, dec_lo: tuple, dec_hi: tuple, mode: str,
                  smem_target: int = SMEM_TARGET) -> dict:
    """K1's plan: M1 = A (rows of H), M2 = B^T (columns of W)."""
    A, B = _analysis_np(h, dec_lo, dec_hi, mode), _analysis_np(w, dec_lo, dec_hi, mode)
    return _band_plan_np(band_form(A, "rows"), band_form(B.T, "cols"), h, w, "halves", True,
                         smem_target)


@functools.lru_cache(maxsize=256)
def _idwt2_plan_np(h: int, w: int, rec_lo: tuple, rec_hi: tuple, backward: bool,
                   smem_target: int = SMEM_TARGET) -> dict:
    """K2's plan (M1 = Sr, M2 = Sc^T on the 2h x 2w merged subbands) or,
    with ``backward``, its adjoint's on K1 (M1 = Sr^T, M2 = Sc on the full
    reconstruction)."""
    Sr, Sc = _synthesis_np(h, rec_lo, rec_hi), _synthesis_np(w, rec_lo, rec_hi)
    if backward:
        return _band_plan_np(band_form(Sr.T, "rows"), band_form(Sc, "cols"), Sr.shape[0],
                             Sc.shape[0], "halves", True, smem_target)
    return _band_plan_np(band_form(Sr, "rows"), band_form(Sc.T, "cols"), 2 * h, 2 * w,
                         "adjacent", False, smem_target)


@functools.lru_cache(maxsize=256)
def dwt2_band(h: int, w: int, dec_lo: tuple, dec_hi: tuple, mode: str,
              device: torch.device) -> kernels.BandPlan:
    """K1's operators for an h x w level on ``device``; cached so the hot
    path copies nothing to the device."""
    return _device_plan(_dwt2_plan_np(h, w, dec_lo, dec_hi, mode), device)


@functools.lru_cache(maxsize=256)
def idwt2_band(h: int, w: int, rec_lo: tuple, rec_hi: tuple,
               device: torch.device) -> tuple[kernels.BandPlan, kernels.BandPlan]:
    """(forward, backward) plans of K2 for (4, h, w) subbands on ``device``:
    K2's own and its adjoint's, which runs on K1; cached."""
    return tuple(_device_plan(_idwt2_plan_np(h, w, rec_lo, rec_hi, bwd), device)
                 for bwd in (False, True))


# ---------------------------------------------------------------------------
# K3's plans: one band plan per collapsed level, in each direction
# ---------------------------------------------------------------------------


def _level_blocks(sizes: tuple, rec_lo: tuple, rec_hi: tuple) -> list[np.ndarray]:
    """The per-level blocks [C_J, ..., C_1] of `_collapsed_axis_np`, each
    (F, 2 n_l), coarsest first."""
    C = _collapsed_axis_np(sizes, rec_lo, rec_hi)
    edges = np.cumsum([0] + [2 * int(n) for n in sizes])
    return [C[:, a:b] for a, b in zip(edges[:-1], edges[1:])]


def _tap_step(col_taps) -> int:
    """The power of two nearest the median step between neighbouring column
    pairs' first taps (2, 4, 8 at the finest, middle and coarsest of three
    collapsed levels), at most 32: the strip's `_fold`."""
    firsts = [cols[0] for cols, _, _ in col_taps if cols]
    step = float(np.median(np.diff(firsts))) if len(firsts) > 1 else 1.0
    return int(min(32, 2 ** max(0, round(np.log2(max(step, 1.0))))))


def _pair_words(levels: list[dict]) -> tuple[int, int]:
    """Floats of one stage (the largest level's staged rows and row-pair
    data) and of the strip, over a plan's levels (``csrc/collapsed.cuh``)."""
    stage = max(lv["sm"] * lv["s"] + 2 * lv["rt"] + 3 * lv["rt"] * lv["k"] for lv in levels)
    return stage, max(2 * lv["rt"] * lv["ts_stride"] for lv in levels)


def _level_plan(row_taps, row_pairs, col_taps, col_pairs, rt: int, s: int, fold: int) -> dict:
    """One level's band plan (`_band_plan_np`'s fields: taps in registers
    as `kc` allows, the rest in a loop; the strip folded by ``fold``) for
    output rows ``row_pairs`` and columns ``col_pairs`` from ``s``-wide
    source rows."""
    k = max(len(c) for c, _, _ in row_taps + col_taps)
    kc = _taps_kc(k)
    k = max(k, kc)
    tiles, slots, sm = _tiling(row_taps, rt)
    perm, fstride, ts_stride = _fold(s, fold)
    return dict(**_tile_arrays(tiles, slots, sm, row_pairs, rt, k),
                **_col_arrays(col_taps, col_pairs, k, perm), s=s, k=k, kc=kc,
                fold_log2=int(np.log2(fold)), fstride=fstride, ts_stride=ts_stride,
                p=max(max(pr) for pr in row_pairs) + 1, t=max(max(pr) for pr in col_pairs) + 1)


def _pair_fwd_plan_np(rsizes: tuple, csizes: tuple, rec_lo: tuple, rec_hi: tuple,
                      smem_target: int, stages: int) -> dict:
    """K3's forward: out = sum_l R_l . Y_l . C_l^T, one level plan per
    collapsed level (M1 = R_l, taps in Y_l's 2 r_l rows; M2 = C_l^T, taps in
    its 2 c_l columns), output rows and columns paired (2m, 2m + 1). The
    levels share their row tiles and column pairs, since a block sums every
    level of a tile in registers: one row-tile size for all, the largest
    (16 pairs at most) whose block fits ``smem_target`` bytes (else the
    whole of a block's shared memory) and whose rows fit a thread's 16
    accumulators."""
    Rb, Cb = _level_blocks(rsizes, rec_lo, rec_hi), _level_blocks(csizes, rec_lo, rec_hi)
    row_pairs = _pairs(Rb[0].shape[0], "adjacent")
    col_pairs = _pairs(Cb[0].shape[0], "adjacent")
    tp, s_out = len(col_pairs), Cb[0].shape[0]
    if tp > kernels.MAX_THREADS:
        raise ValueError(f"collapsed synthesis: {s_out} output columns, more than "
                         f"{2 * kernels.MAX_THREADS}")
    threads = kernels.pair_fwd_threads(tp)
    groups = threads // tp
    taps = [(_pair_taps(band_form(R, "rows"), row_pairs),
             _pair_taps(band_form(C.T, "cols"), col_pairs)) for R, C in zip(Rb, Cb)]
    for budget in (smem_target, kernels.MAX_SMEM):
        for rt in (16, 8, 4, 2, 1):
            if 2 * rt > kernels.PAIR_ROWS_PER_THREAD * groups:
                continue
            levels = [_level_plan(rows, row_pairs, cols, col_pairs, rt, C.shape[1], 1)
                      for (rows, cols), C in zip(taps, Cb)]
            stage, strip = _pair_words(levels)
            if kernels.pair_smem_bytes(stages, stage, strip) <= budget:
                return dict(levels=levels, threads=threads, stages=stages, stage_words=stage,
                            strip_words=strip, p=Rb[0].shape[0], t=s_out)
    raise ValueError(f"collapsed synthesis of sides {rsizes} x {csizes} does not fit "
                     f"{kernels.MAX_SMEM} bytes of shared memory")


# A backward block takes one stage in place of two (larger tiles, no copy
# overlap but a second block on the SM) when two stages would stage this many
# times more rows of g: at the flagship's levels one stage stages half the
# rows and ran 1.5x faster, at path 2's 1.1x fewer rows and 8% slower
# (scripts/torch_band_sweep.py on an H100 80GB HBM3 at 700 W).
PAIR_ONE_STAGE_GAIN = 1.5


def _pair_bwd_plan_np(rsizes: tuple, csizes: tuple, rec_lo: tuple, rec_hi: tuple,
                      smem_target: int, stages: int | None) -> dict:
    """K3's backward: each level's gradient R_l^T . g . C_l as its own
    product on g (M1 = R_l^T, taps in g's rows; M2 = C_l, taps in its
    columns), rows and columns paired (i, n_l + i) as K1 pairs them, so a
    pair's four outputs are the same element of aa, V, H and D. The strip
    groups its columns by the level's tap step (`_tap_step`). Each level
    takes its own row tiles: all start at 16 pairs, and the level whose
    stage and strip are largest halves its tiles until the block fits
    ``smem_target`` bytes (else the whole of a block's shared memory).
    ``stages`` None picks one or two by `PAIR_ONE_STAGE_GAIN`."""
    Rb, Cb = _level_blocks(rsizes, rec_lo, rec_hi), _level_blocks(csizes, rec_lo, rec_hi)
    s = Cb[0].shape[0]
    taps = []
    for R, C in zip(Rb, Cb):
        row_pairs, col_pairs = _pairs(R.shape[1], "halves"), _pairs(C.shape[1], "halves")
        cols = _pair_taps(band_form(C, "cols"), col_pairs)
        taps.append((_pair_taps(band_form(R.T, "rows"), row_pairs), row_pairs, cols, col_pairs,
                     _tap_step(cols)))

    def plan(i, rt):
        rows, row_pairs, cols, col_pairs, fold = taps[i]
        return _level_plan(rows, row_pairs, cols, col_pairs, rt, s, fold)

    def fit(stages):
        for budget in (smem_target, kernels.MAX_SMEM):
            rts = [16] * len(taps)
            levels = [plan(i, rt) for i, rt in enumerate(rts)]
            while True:
                stage, strip = _pair_words(levels)
                if kernels.pair_smem_bytes(stages, stage, strip) <= budget:
                    return dict(levels=levels, threads=kernels.PAIR_BWD_THREADS, stages=stages,
                                stage_words=stage, strip_words=strip, p=Rb[0].shape[0], t=s)
                sizes = [(lv["sm"] * s + 2 * lv["rt"] * lv["ts_stride"], i)
                         for i, lv in enumerate(levels) if lv["rt"] > 1]
                if not sizes:
                    break
                i = max(sizes)[1]
                rts[i] //= 2
                levels[i] = plan(i, rts[i])
        return None

    def staged(p):  # rows of g an image stages
        return sum(lv["ntiles"] * lv["sm"] for lv in p["levels"])

    if stages is None:
        two, one = fit(2), fit(1)
        best = one if two is None or (one and staged(two) > PAIR_ONE_STAGE_GAIN * staged(one)) \
            else two
    else:
        best = fit(stages)
    if best is None:
        raise ValueError(f"collapsed synthesis backward of sides {rsizes} x {csizes} does not "
                         f"fit {kernels.MAX_SMEM} bytes of shared memory")
    return best


@functools.lru_cache(maxsize=64)
def _pair_plans_np(rsizes: tuple, csizes: tuple, rec_lo: tuple, rec_hi: tuple,
                   smem_target: int = SMEM_TARGET,
                   stages: tuple = (2, None)) -> tuple[dict, dict]:
    """(forward, backward) plans of K3 for levels of ``rsizes`` x
    ``csizes`` coefficients, coarsest first, with ``stages`` stages a block
    (forward, backward; None: the backward chooses)."""
    if len(rsizes) > kernels.MAX_LEVELS:
        raise ValueError(f"collapsed synthesis of {len(rsizes)} levels: at most "
                         f"{kernels.MAX_LEVELS}")
    return (_pair_fwd_plan_np(rsizes, csizes, rec_lo, rec_hi, smem_target, stages[0]),
            _pair_bwd_plan_np(rsizes, csizes, rec_lo, rec_hi, smem_target, stages[1]))


@functools.lru_cache(maxsize=64)
def pair_band(rsizes: tuple, csizes: tuple, rec_lo: tuple, rec_hi: tuple,
              device: torch.device, smem_target: int = SMEM_TARGET,
              stages: tuple = (2, None)) -> tuple[kernels.PairPlan, kernels.PairPlan]:
    """(forward, backward) `kernels.PairPlan` of K3 on ``device``: the level
    plans' blobs end to end; cached so the hot path copies nothing to the
    device."""
    out = []
    for plan in _pair_plans_np(rsizes, csizes, rec_lo, rec_hi, smem_target, stages):
        blobs, levels, at = [], [], 0
        for lv in plan["levels"]:
            blob = _plan_blob(lv)
            tdat = at + lv["ntiles"] * lv["sm"]
            ccols = tdat + lv["ntiles"] * (2 * lv["rt"] + 3 * lv["rt"] * lv["k"])
            levels.append(kernels.PairLevel(tsrc=at, tdat=tdat, ccols=ccols,
                                            **{f: lv[f] for f in kernels.PairLevel._fields[3:]}))
            blobs.append(blob)
            at += blob.size
        out.append(kernels.pair_plan(
            torch.from_numpy(np.concatenate(blobs)).to(device), levels, plan["threads"],
            plan["stages"], plan["stage_words"], plan["strip_words"], rsizes, csizes, plan["p"],
            plan["t"]))
    return tuple(out)


def _split_quadrants(y: torch.Tensor, h_out: int, w_out: int) -> torch.Tensor:
    """(..., 2*h_out, 2*w_out) block matrix -> (..., 4, h_out, w_out) in the
    conv path's channel order (row, col): 0=aa, 1=ad, 2=da, 3=dd."""
    return torch.stack([y[..., :h_out, :w_out], y[..., :h_out, w_out:],
                        y[..., h_out:, :w_out], y[..., h_out:, w_out:]], dim=-3)


def _merge_quadrants(sub: torch.Tensor) -> torch.Tensor:
    """(..., 4, h, w) in (aa, ad, da, dd) order -> (..., 2h, 2w) block matrix."""
    top = torch.cat([sub[..., 0, :, :], sub[..., 1, :, :]], dim=-1)
    bot = torch.cat([sub[..., 2, :, :], sub[..., 3, :, :]], dim=-1)
    return torch.cat([top, bot], dim=-2)


def analysis2_mm(x: torch.Tensor, wavelet, mode: str) -> torch.Tensor:
    """One 2D analysis level as two matmuls. x: (..., H, W) ->
    (..., 4, H', W') matching `transform._analysis(x, wav, mode)`."""
    h, w = x.shape[-2:]
    A = analysis_matrices(h, wavelet, mode, x.dtype, x.device)
    B = analysis_matrices(w, wavelet, mode, x.dtype, x.device)
    y = torch.matmul(torch.matmul(A, x), B.T)
    return _split_quadrants(y, A.shape[0] // 2, B.shape[0] // 2)


def synthesis2_mm(subbands: torch.Tensor, wavelet, out_shape) -> torch.Tensor:
    """Inverse of one 2D level as two matmuls. subbands: (..., 4, h, w) ->
    (..., out_shape), trimmed like `transform._synthesis`."""
    h, w = subbands.shape[-2:]
    S_r = synthesis_matrices(h, wavelet, subbands.dtype, subbands.device)
    S_c = synthesis_matrices(w, wavelet, subbands.dtype, subbands.device)
    out = torch.matmul(torch.matmul(S_r, _merge_quadrants(subbands)), S_c.T)
    return out[..., : out_shape[0], : out_shape[1]]


SPAN_3D = "wam_dwt3"  # the 3D transform's profiler span (`transform.SPAN_3D`)


@functools.lru_cache(maxsize=64)
def _synthesis_operator(n: int, rec_lo: tuple, rec_hi: tuple, dtype,
                        device: torch.device) -> torch.Tensor:
    """`synthesis_matrices` built once per (side, wavelet, dtype, device)."""
    return torch.as_tensor(_synthesis_np(n, rec_lo, rec_hi), dtype=dtype, device=device)


@functools.lru_cache(maxsize=64)
def _analysis_operator(n: int, dec_lo: tuple, dec_hi: tuple, mode: str, dtype,
                       device: torch.device) -> torch.Tensor:
    """`analysis_matrices` built once per (side, wavelet, mode, dtype, device)."""
    return torch.as_tensor(_analysis_np(n, dec_lo, dec_hi, mode), dtype=dtype, device=device)


@contextlib.contextmanager
def _f32_matmuls():
    """cuBLAS float32 matmuls in full float32 inside the block (TF32 off),
    the caller's setting restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _axis_products(y: torch.Tensor, m0, m1, m2) -> torch.Tensor:
    """m0, m1, m2 applied along axes -3, -2, -1 of y, in full float32."""
    with _f32_matmuls():
        y = torch.einsum("ij,...jkl->...ikl", m0, y)
        y = torch.einsum("ij,...kjl->...kil", m1, y)
        return torch.einsum("ij,...klj->...kli", m2, y)


class _Synthesis3(torch.autograd.Function):
    """(..., 2 d0, 2 d1, 2 d2) block layout -> S0, S1, S2 along the three
    axes; the backward applies their transposes, also in full float32 and
    inside the transform's profiler span."""

    @staticmethod
    def forward(ctx, y, S0, S1, S2):
        ctx.save_for_backward(S0, S1, S2)
        return _axis_products(y, S0, S1, S2)

    @staticmethod
    def backward(ctx, g):
        S0, S1, S2 = ctx.saved_tensors
        with torch.profiler.record_function(SPAN_3D):
            return _axis_products(g, S0.T, S1.T, S2.T), None, None, None


def synthesis3_mm(subbands: torch.Tensor, wavelet, out_shape) -> torch.Tensor:
    """Inverse of one 3D level as three banded products (counterpart of
    `wam_tpu.wavelets.matmul.synthesis3_mm`). subbands: (..., 8, d0, d1, d2)
    in the binary a/d channel order over axes (-3, -2, -1) -> (..., out_shape);
    bf16 subbands are upcast, float64 stays float64."""
    d = tuple(int(s) for s in subbands.shape[-3:])
    batch_shape = subbands.shape[:-4]
    if subbands.dtype == torch.bfloat16:
        subbands = subbands.float()
    w = _wav(wavelet)
    S = [_synthesis_operator(n, tuple(w.rec_lo), tuple(w.rec_hi), subbands.dtype,
                             subbands.device) for n in d]
    # channel (b0, b1, b2) is the (b0 d0.., b1 d1.., b2 d2..) block of the
    # stacked [lo; hi] coefficients per axis, the layout [S_lo | S_hi] reads
    y = subbands.reshape(batch_shape + (2, 2, 2) + d)
    y = torch.movedim(y, (-6, -5, -4), (-6, -4, -2))  # (..., 2, d0, 2, d1, 2, d2)
    y = y.reshape(batch_shape + tuple(2 * n for n in d))
    y = _Synthesis3.apply(y, *S)
    return y[..., : out_shape[0], : out_shape[1], : out_shape[2]]


# ---------------------------------------------------------------------------
# The two-sided product m1t^T @ x[n] @ m2: the kernel on CUDA, plain on CPU
# ---------------------------------------------------------------------------


def pair_plain(x3: torch.Tensor, m1t: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: m1t^T @ x3[n] @ m2 (f32 accumulate)."""
    return torch.matmul(torch.matmul(m1t.T, x3.float()), m2)


def dwt2_plain(x3: torch.Tensor, At: torch.Tensor, Bt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: quadrant split of A @ x3[n] @ B^T."""
    return _split_quadrants(pair_plain(x3, At, Bt), At.shape[1] // 2, Bt.shape[1] // 2)


def idwt2_plain(sub3: torch.Tensor, Sr: torch.Tensor, Sct: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: Sr @ [[aa, ad], [da, dd]] @ Sct per image
    (f32 accumulate)."""
    return torch.matmul(torch.matmul(Sr, _merge_quadrants(sub3.float())), Sct)


def _dwt2_forward(x3, At, Bt, plan) -> torch.Tensor:
    if on_cpu(x3):
        return dwt2_plain(x3, At, Bt)
    return kernels.dwt2(x3, plan)


def _idwt2_forward(sub3, Sr, Sct, plan) -> torch.Tensor:
    if on_cpu(sub3):
        return idwt2_plain(sub3, Sr, Sct)
    return kernels.synth2(sub3, plan)


class _Dwt2Core(torch.autograd.Function):
    """x3 (N, H, W) -> (N, 4, h', w') float32; backward ``_core_bwd``.
    ``plan`` is K1's band plan (None on the CPU, which takes At, Bt)."""

    @staticmethod
    def forward(ctx, x3, A, At, Bt, plan):
        ctx.save_for_backward(A, Bt)
        ctx.x_dtype = x3.dtype
        return _dwt2_forward(x3, At, Bt, plan)

    @staticmethod
    def backward(ctx, g):
        A, Bt = ctx.saved_tensors
        dx = torch.matmul(torch.matmul(A.T, _merge_quadrants(g)), Bt.T)
        return dx.to(ctx.x_dtype), None, None, None, None


class _Idwt2Core(torch.autograd.Function):
    """sub3 (N, 4, h, w) -> (N, F_r, F_c) = Sr Y Sc^T float32; backward
    ``_synth_bwd``: the quadrant split of Sr^T g Sc, which is K1 with
    M1 = Sr^T and M2 = Sc. ``plans`` are K2's (forward, backward) band
    plans (None on the CPU, which takes the dense operators)."""

    @staticmethod
    def forward(ctx, sub3, Sr, Sc, Sct, plans):
        ctx.save_for_backward(Sr, Sc)
        ctx.sub_dtype = sub3.dtype
        ctx.bwd_plan = plans and plans[1]
        return _idwt2_forward(sub3, Sr, Sct, plans and plans[0])

    @staticmethod
    def backward(ctx, g):
        Sr, Sc = ctx.saved_tensors
        dsub = _dwt2_forward(g.contiguous(), Sr, Sc, ctx.bwd_plan)
        return dsub.to(ctx.sub_dtype), None, None, None, None


class _CollapsedCore(torch.autograd.Function):
    """The collapsed levels' leaves -> (N, F_r, F_c) = sum_l R_l Y_l C_l^T
    on K3, which reads the leaves where they lie; backward ``_pair_bwd``
    followed by the leaves' slices of dY, one K3 launch that writes each
    leaf's gradient. Y and dY never exist. ``leaves`` as `kernels.pair`
    takes them; ``plans`` are `pair_band`'s (forward, backward)."""

    @staticmethod
    def forward(ctx, plans, *leaves):
        ctx.bwd_plan = plans[1]
        return kernels.pair(leaves, plans[0])

    @staticmethod
    def backward(ctx, g):
        return (None, *kernels.pair_bwd(g.contiguous(), ctx.bwd_plan))


def dwt2_kernel(x: torch.Tensor, wavelet, mode: str) -> torch.Tensor:
    """One 2D analysis level through K1 (counterpart of ``dwt2_pallas``).

    x: (..., H, W) -> (..., 4, H', W'), identical layout and values to
    `transform._analysis(x, wav, mode)`; differentiable. bf16 inputs are read
    as bf16 and upcast inside the kernel; bf16 and f32 inputs both return
    FLOAT32 coefficients, so the multi-level cascade never re-rounds to bf16;
    other dtypes are computed in float32 (the conv and matmul impls of
    `transform` keep float64)."""
    w = _wav(wavelet)
    h, wd = x.shape[-2:]
    taps = (tuple(w.dec_lo), tuple(w.dec_hi), mode)
    A, At = _kernel_analysis(h, *taps, x.device)
    _, Bt = _kernel_analysis(wd, *taps, x.device)
    plan = None if on_cpu(x) else dwt2_band(h, wd, *taps, x.device)
    batch_shape = x.shape[:-2]
    x3 = x.reshape((-1, h, wd))
    if x3.dtype != torch.bfloat16:
        x3 = x3.float()
    out = _Dwt2Core.apply(x3.contiguous(), A, At, Bt, plan)
    return out.reshape(batch_shape + out.shape[1:])


def idwt2_kernel(subbands: torch.Tensor, wavelet, out_shape=None) -> torch.Tensor:
    """Inverse of one 2D level through K2 (counterpart of ``idwt2_pallas``).

    subbands: (..., 4, h, w) in the conv channel order (aa, ad, da, dd) ->
    (..., out_shape), the full (2h - L + 2, 2w - L + 2) when None; the trim
    is applied after the kernel. Differentiable: the backward is K1. bf16
    subbands are read as bf16 and upcast inside the kernel; bf16 and f32
    both give FLOAT32 pixels; other dtypes are computed in float32."""
    w = _wav(wavelet)
    h, wd = subbands.shape[-2:]
    rec = (tuple(w.rec_lo), tuple(w.rec_hi))
    Sr, _ = _kernel_synthesis(h, *rec, subbands.device)
    Sc, Sct = _kernel_synthesis(wd, *rec, subbands.device)
    plans = None if on_cpu(subbands) else idwt2_band(h, wd, *rec, subbands.device)
    batch_shape = subbands.shape[:-3]
    sub3 = subbands.reshape((-1, 4, h, wd))
    if sub3.dtype != torch.bfloat16:
        sub3 = sub3.float()
    out = _Idwt2Core.apply(sub3.contiguous(), Sr, Sc, Sct, plans)
    out = out.reshape(batch_shape + out.shape[1:])
    if out_shape is not None and tuple(out_shape) != tuple(out.shape[-2:]):
        out = out[..., : out_shape[0], : out_shape[1]]
    return out


def waverec2_collapsed(cA: torch.Tensor, details, wavelet) -> torch.Tensor:
    """Multi-level 2D synthesis of the given levels as ONE operator pair
    through K3: out = R @ Y @ C^T with R/C the host-composed per-axis
    collapsed operators and Y the block-diagonal coefficient matrix — per
    level a 2x2 block [[aa, V], [H, D]] whose aa slot is zero except at the
    coarsest level (the approximation cascade is folded into the operators).

    ``details`` are Detail2D levels COARSEST FIRST. Returns the FULL
    reconstruction of the finest given level (2n - L + 2 per side); the
    caller trims. Leaves of any dtype are computed in float32 (f32
    accumulate). CPU tensors take the plain version (`assemble_collapsed`,
    then `pair_plain`); on CUDA tensors K3 sums R_l Y_l C_l^T level by
    level from the leaves themselves (views such as K1's subbands are read
    in place), so neither Y nor its gradient is ever allocated."""
    batch_shape = cA.shape[:-2]
    if on_cpu(cA):
        Y = assemble_collapsed(cA, details)
        _, Rt, _, Ct = collapsed_operators(details, wavelet, cA.device)
        out = pair_plain(Y.reshape((-1,) + Y.shape[-2:]), Rt, Ct)
        return out.reshape(batch_shape + out.shape[1:])
    w = _wav(wavelet)
    rsizes = tuple(int(d.horizontal.shape[-2]) for d in details)
    csizes = tuple(int(d.horizontal.shape[-1]) for d in details)
    plans = pair_band(rsizes, csizes, tuple(w.rec_lo), tuple(w.rec_hi), cA.device)
    leaves = [cA[..., :rsizes[0], :csizes[0]]] + [t for d in details for t in d]
    out = _CollapsedCore.apply(plans, *(_leaf3(t) for t in leaves))
    return out.reshape(batch_shape + out.shape[1:])


def _leaf3(t: torch.Tensor) -> torch.Tensor:
    """A leaf as K3 reads it: (N, r, c) float32 with contiguous columns, a
    view wherever the leaf's strides allow (K1's subbands are), else a
    copy. bf16 and other dtypes are upcast here (differentiably)."""
    t = t.float().reshape((-1,) + t.shape[-2:])
    return t if t.stride(-1) == 1 or t.shape[-1] == 1 else t.contiguous()


def collapsed_operators(details, wavelet, device) -> tuple[torch.Tensor, ...]:
    """(R, R^T, C, C^T) float32 on ``device`` for Detail2D levels given
    COARSEST FIRST: the K3 operands of `waverec2_collapsed`."""
    w = _wav(wavelet)
    rlo, rhi = tuple(w.rec_lo), tuple(w.rec_hi)
    R, Rt = _kernel_collapsed(tuple(int(d.horizontal.shape[-2]) for d in details), rlo, rhi,
                              device)
    C, Ct = _kernel_collapsed(tuple(int(d.horizontal.shape[-1]) for d in details), rlo, rhi,
                              device)
    return R, Rt, C, Ct


def assemble_collapsed(cA: torch.Tensor, details) -> torch.Tensor:
    """The block-diagonal coefficient matrix Y (..., 2*sum(r), 2*sum(c)) of
    the collapsed levels: per level [[aa, V], [H, D]], aa only at the
    coarsest; float32. Differentiable (slice assignment into a fresh zero
    tensor)."""
    rsizes = [int(d.horizontal.shape[-2]) for d in details]
    csizes = [int(d.horizontal.shape[-1]) for d in details]
    Y = torch.zeros(cA.shape[:-2] + (2 * sum(rsizes), 2 * sum(csizes)),
                    dtype=torch.float32, device=cA.device)
    off_r = off_c = 0
    for i, det in enumerate(details):
        hr, wc = rsizes[i], csizes[i]
        if i == 0:  # coarsest: the only level whose aa slot carries data
            Y[..., off_r:off_r + hr, off_c:off_c + wc] = cA[..., :hr, :wc]
        Y[..., off_r:off_r + hr, off_c + wc:off_c + 2 * wc] = det.vertical
        Y[..., off_r + hr:off_r + 2 * hr, off_c:off_c + wc] = det.horizontal
        Y[..., off_r + hr:off_r + 2 * hr, off_c + wc:off_c + 2 * wc] = det.diagonal
        off_r += 2 * hr
        off_c += 2 * wc
    return Y
