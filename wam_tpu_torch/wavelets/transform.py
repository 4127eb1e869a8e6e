"""Differentiable multi-level 1D, 2D and 3D discrete wavelet transforms (PyTorch).

Counterpart of `wam_tpu.wavelets.transform`, with the same coefficient
layouts and pywt boundary semantics: ``wavedec`` returns
``[cA_J, cD_J, ..., cD_1]`` with per-level length floor((n + L - 1)/2),
``wavedec2`` returns ``[cA_J, Detail2D(H_J, V_J, D_J), ..., Detail2D_1]``
where H = hi-pass along rows (axis -2), V = hi-pass along columns (axis -1),
D = both, and ``wavedec3`` returns ``[cA_J, {aad..ddd}_J, ..., {aad..ddd}_1]``
with the keys of `DETAIL3D_KEYS` (a/d over axes -3, -2, -1).

The 1D transform has one implementation on every device: a strided
``conv1d`` over the fused two-channel (lo, hi) analysis kernel and its
adjoint ``conv_transpose1d`` for synthesis, both in full float32 (TF32 off
inside the transform whatever the caller's cuDNN setting, as the reference
runs its transform convs at ``Precision.HIGHEST``). Each 1D level and each
backward of one runs inside a ``torch.profiler.record_function`` span named
``SPAN_1D``, so a profile can tell the transform's convolutions from a
model's.

The 3D transform analyses with one strided ``conv3d`` over the 8 fused
subband filters and synthesizes with one ``conv_transpose3d`` (``impl=
"conv"``, and ``None`` on every device: measured the faster on the card) or
three banded products (`matmul.synthesis3_mm`, ``"matmul"`` and
``"kernel"``: no TPU kernel covers 3D), all in full float32 and inside
``SPAN_3D`` spans.

The 2D transform has three implementations of the same linear maps, chosen
per call by ``impl``:

- ``"conv"``: strided conv2d over 4 fused subband channels (plain torch);
- ``"matmul"``: the banded-matrix form `matmul.analysis2_mm` /
  `matmul.synthesis2_mm` (plain torch);
- ``"kernel"``: the hand-written CUDA kernels — K1 (`matmul.dwt2_kernel`)
  for every analysis level, K3 (`matmul.waverec2_collapsed`) for the
  contiguous run of coarsest synthesis levels whose sides all fall below
  ``SYNTH_COLLAPSE``, and K2 (`matmul.idwt2_kernel`) for every remaining
  synthesis level. CPU tensors run the kernels' plain versions.

``impl=None`` resolves through the process-wide knobs: `set_dwt2_impl`
for analysis and `set_synth2_impl` for synthesis (the reference's names;
the port's ``"kernel"`` is the reference's ``"pallas"``). Both default to
``"auto"``: ``"kernel"`` for CUDA tensors and ``"conv"`` for CPU tensors
(synthesis follows the analysis impl off the card, ``"matmul"`` unless it
is ``"conv"``). A per-call ``impl=`` wins over the knobs. The knobs start
from ``WAM_TORCH_DWT2_IMPL`` / ``WAM_TORCH_SYNTH2_IMPL`` when set.
bf16 inputs give float32 coefficients on every impl.

The 2D analysis runs inside ``torch.profiler`` spans named
``SPAN_ANALYSIS`` and the 2D synthesis inside ``SPAN_SYNTH`` (forward), so
`profiling.synth_device_split` can split a profile by them.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from wam_tpu_torch.wavelets import matmul as _mm
from wam_tpu_torch.wavelets.filters import Wavelet, build_wavelet

__all__ = [
    "Detail2D",
    "dwt",
    "idwt",
    "wavedec",
    "waverec",
    "dwt2",
    "idwt2",
    "wavedec2",
    "waverec2",
    "DETAIL3D_KEYS",
    "dwt3",
    "idwt3",
    "wavedec3",
    "waverec3",
    "dwt_max_level",
    "SYNTH_COLLAPSE",
    "set_dwt2_impl",
    "get_dwt2_impl",
    "set_dwt1_impl",
    "set_synth2_impl",
    "get_synth2_impl",
    "resolved_dwt2_impl",
    "resolved_synth2_impl",
]

IMPLS = ("conv", "matmul", "kernel")
SPAN_1D = "wam_dwt1"
SPAN_3D = _mm.SPAN_3D
SPAN_ANALYSIS = "wam_analysis"
SPAN_SYNTH = "wam_synth"

# -- the process-wide impl knobs (the reference's set_dwt2_impl & co.) -----------

_DWT2_IMPLS = ("auto",) + IMPLS
_SYNTH2_IMPLS = ("auto",) + IMPLS
# the 1D transform has one implementation (a strided conv1d); the reference's
# "folded" / "folded_nhc" polyphase forms have no counterpart in the port
_DWT1_IMPLS = ("auto", "conv")


def _check_knob(name: str, allowed: tuple) -> str:
    if name not in allowed:
        raise ValueError(f"impl {name!r} not one of {allowed}")
    return name


def set_dwt2_impl(name: str) -> None:
    """Select the 2D analysis impl for calls that pass no ``impl=``:
    ``"auto"`` (``"kernel"`` on CUDA tensors, ``"conv"`` on CPU tensors),
    ``"conv"``, ``"matmul"`` or ``"kernel"`` (K1; its plain version on CPU
    tensors). Eager PyTorch has no trace to keep an old choice: the next
    call reads the knob."""
    global _dwt2_impl
    _dwt2_impl = _check_knob(name, _DWT2_IMPLS)


def get_dwt2_impl() -> str:
    return _dwt2_impl


def set_dwt1_impl(name: str) -> None:
    """The reference's 1D impl knob, as far as the port has 1D impls:
    ``"auto"`` and ``"conv"`` name the strided conv1d, the only 1D form, so
    the knob keeps no state; the reference's folded forms raise."""
    _check_knob(name, _DWT1_IMPLS)


def set_synth2_impl(name: str) -> None:
    """Select the 2D synthesis impl for calls that pass no ``impl=``:
    ``"auto"`` (``"kernel"`` on CUDA tensors; off the card the analysis
    impl's pair, ``"conv"`` with ``"conv"`` and ``"matmul"`` otherwise),
    ``"conv"``, ``"matmul"`` or ``"kernel"`` (K3 for the collapsed coarsest
    levels, K2 for the others)."""
    global _synth2_impl
    _synth2_impl = _check_knob(name, _SYNTH2_IMPLS)


def get_synth2_impl() -> str:
    return _synth2_impl


_dwt2_impl = _synth2_impl = "auto"
set_dwt2_impl(os.environ.get("WAM_TORCH_DWT2_IMPL", "auto"))
set_synth2_impl(os.environ.get("WAM_TORCH_SYNTH2_IMPL", "auto"))


def _on_card(device) -> bool:
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def resolved_dwt2_impl(device=None) -> str:
    """The analysis impl a call on ``device`` takes with no ``impl=``
    (``device`` None: the card when there is one, else the CPU)."""
    if _dwt2_impl == "auto":
        return "kernel" if _on_card(device) else "conv"
    return _dwt2_impl


def resolved_synth2_impl(device=None) -> str:
    """The synthesis impl a call on ``device`` takes with no ``impl=``
    (``"conv"``, ``"matmul"`` or ``"kernel"``)."""
    if _synth2_impl == "auto":
        if _on_card(device):
            return "kernel"
        return "conv" if resolved_dwt2_impl(device) == "conv" else "matmul"
    return _synth2_impl

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
    """The analysis impl of a call on ``x``: ``impl`` when given, else the
    knob's (`resolved_dwt2_impl`)."""
    if impl is None:
        return resolved_dwt2_impl("cuda" if x.is_cuda else "cpu")
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not one of {IMPLS}")
    return impl


def _resolve_synth_impl(impl: str | None, x: torch.Tensor) -> str:
    """The synthesis impl of a call on ``x``: ``impl`` when given, else the
    knob's (`resolved_synth2_impl`)."""
    if impl is None:
        return resolved_synth2_impl("cuda" if x.is_cuda else "cpu")
    return _resolve_impl(impl, x)


def dwt_max_level(data_len: int, filt_len: int) -> int:
    """pywt.dwt_max_level: floor(log2(data_len / (filt_len - 1)))."""
    if data_len < filt_len - 1 or filt_len < 2:
        return 0
    return int(np.floor(np.log2(data_len / (filt_len - 1.0))))


@functools.lru_cache(maxsize=256)
def _pad_index(n: int, pad: int, mode: str, device: torch.device) -> torch.Tensor:
    """Source index of every position of an axis of length ``n`` padded by
    ``pad`` per side (`matmul._source_index` over range(-pad, n + pad),
    vectorized), built once per (n, pad, mode, device)."""
    p = np.arange(-pad, n + pad)
    if mode == "constant":
        idx = np.clip(p, 0, n - 1)
    elif mode == "periodic":
        idx = p % n
    elif mode == "reflect":
        period = max(2 * n - 2, 1)
        m = p % period
        idx = np.where(m < n, m, period - m)
    else:  # symmetric
        m = p % (2 * n)
        idx = np.where(m < n, m, 2 * n - 1 - m)
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def _pad_axes(x: torch.Tensor, pad: int, mode: str, axes: Sequence[int] = (-2, -1)) -> torch.Tensor:
    """Pad ``axes`` (the last two by default) by ``pad`` on each side in a
    pywt mode. Any width works (the index map wraps as often as needed)."""
    if mode not in _PAD_MODE:
        raise ValueError(f"Unsupported mode {mode!r}; one of {sorted(_PAD_MODE)}")
    if mode == "zero":
        return F.pad(x, (pad, pad) * len(axes))
    for axis in axes:
        x = x.index_select(axis % x.ndim, _pad_index(x.shape[axis], pad, mode, x.device))
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


# -- 1D --------------------------------------------------------------------------


@contextlib.contextmanager
def _f32_convs():
    """cuDNN convolutions in full float32 inside the block (TF32 off), the
    caller's setting restored after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _bank(wav: Wavelet, ndim: int, dtype, device, rec: bool) -> torch.Tensor:
    """(2^ndim, 1, L, ..., L) fused filter bank, channel order binary a/d
    counting over the axes (the first axis the most significant bit): outer
    products of the flipped dec filters (analysis correlation) or of the rec
    filters as they are (synthesis as a transposed convolution)."""
    lo, hi = (wav.rec_lo, wav.rec_hi) if rec else (wav.dec_lo[::-1], wav.dec_hi[::-1])
    return _bank_cached(tuple(lo), tuple(hi), ndim, dtype, device)


@functools.lru_cache(maxsize=64)
def _bank_cached(lo: tuple, hi: tuple, ndim: int, dtype, device) -> torch.Tensor:
    # built once per device: a copy from host memory waits for the queue
    banks = []
    for code in range(2**ndim):
        k = np.array(1.0)
        for axis in range(ndim):
            k = np.multiply.outer(k, hi if (code >> (ndim - 1 - axis)) & 1 else lo)
        banks.append(k)
    return torch.as_tensor(np.stack(banks)[:, None], dtype=dtype, device=device)


# spatial rank -> (convolution, its transpose, the transform's profiler span); the 2D
# entry serves the unsharded (H, W) axes of the sequence-sharded 3D transform
# (`parallel.halo_modes`), whose 2D levels must stay full float32 both ways
_CONVS = {1: (F.conv1d, F.conv_transpose1d, SPAN_1D), 2: (F.conv2d, F.conv_transpose2d, SPAN_1D),
          3: (F.conv3d, F.conv_transpose3d, SPAN_3D)}


class _Analysis(torch.autograd.Function):
    """One 1D or 3D analysis level on the padded input: (B, 1, *n) ->
    (B, 2^d, *m) by a stride-2 correlation with the fused bank; the backward
    is its adjoint, the transposed convolution, inside the transform's
    profiler span. Both directions run in full float32."""

    @staticmethod
    def forward(ctx, xp, bank):
        ctx.save_for_backward(bank)
        ctx.n = tuple(xp.shape[2:])
        with _f32_convs():
            return _CONVS[bank.ndim - 2][0](xp, bank, stride=2)

    @staticmethod
    def backward(ctx, g):
        (bank,) = ctx.saved_tensors
        L = bank.shape[-1]
        # 0 or 1 trailing sample per axis
        extra = tuple(n - (2 * (m - 1) + L) for n, m in zip(ctx.n, g.shape[2:]))
        _, conv_t, span = _CONVS[bank.ndim - 2]
        with torch.profiler.record_function(span), _f32_convs():
            return conv_t(g, bank, stride=2, output_padding=extra), None


class _Synthesis(torch.autograd.Function):
    """One 1D or 3D synthesis level: (B, 2^d, *h) -> (B, 1, *(2h - L + 2)),
    the true convolution of the zero-stuffed subbands with the rec filters
    trimmed by L - 2 per side, as one transposed convolution; the backward
    is the stride-2 correlation, inside the transform's profiler span. Both
    directions run in full float32."""

    @staticmethod
    def forward(ctx, sub, bank):
        ctx.save_for_backward(bank)
        with _f32_convs():
            return _CONVS[bank.ndim - 2][1](sub, bank, stride=2, padding=bank.shape[-1] - 2)

    @staticmethod
    def backward(ctx, g):
        (bank,) = ctx.saved_tensors
        conv, _, span = _CONVS[bank.ndim - 2]
        with torch.profiler.record_function(span), _f32_convs():
            return conv(g, bank, stride=2, padding=bank.shape[-1] - 2), None


def dwt(x: torch.Tensor, wavelet, mode: str = "symmetric"):
    """Single-level 1D DWT along the last axis. Returns (cA, cD), each of
    length floor((n + L - 1)/2); bf16 inputs give float32 coefficients."""
    wav = _resolve(wavelet)
    if x.dtype == torch.bfloat16:
        x = x.float()
    batch_shape = x.shape[:-1]
    with torch.profiler.record_function(SPAN_1D):
        # offset by one so the stride-2 correlation lands on pywt's positions
        xp = _pad_axes(x.reshape(-1, 1, x.shape[-1]), wav.filt_len - 1, mode, axes=(-1,))[..., 1:]
        out = _Analysis.apply(xp, _bank(wav, 1, x.dtype, x.device, rec=False))
    out = out.reshape(batch_shape + out.shape[1:])
    return out[..., 0, :], out[..., 1, :]


def idwt(cA: torch.Tensor, cD: torch.Tensor, wavelet, out_len: int | None = None):
    """Single-level inverse 1D DWT: length 2n - L + 2, or ``out_len`` when
    given (a crop); bf16 coefficients give float32 samples."""
    wav = _resolve(wavelet)
    sub = torch.stack([cA, cD], dim=-2)
    if sub.dtype == torch.bfloat16:
        sub = sub.float()
    batch_shape = sub.shape[:-2]
    with torch.profiler.record_function(SPAN_1D):
        out = _Synthesis.apply(sub.reshape(-1, 2, sub.shape[-1]),
                               _bank(wav, 1, sub.dtype, sub.device, rec=True))[:, 0]
    if out_len is not None:
        out = out[:, :out_len]
    return out.reshape(batch_shape + out.shape[-1:])


def wavedec(x: torch.Tensor, wavelet, level: int, mode: str = "symmetric"):
    """Multi-level 1D DWT: [cA_J, cD_J, ..., cD_1] (coarsest first)."""
    wav = _resolve(wavelet)
    coeffs = []
    a = x
    for _ in range(level):
        a, d = dwt(a, wav, mode)
        coeffs.append(d)
    coeffs.append(a)
    return coeffs[::-1]


def waverec(coeffs, wavelet):
    """Inverse of `wavedec`: each level's approximation is trimmed to its
    detail's length, and each synthesis to the next detail's length."""
    wav = _resolve(wavelet)
    a = coeffs[0]
    for i in range(1, len(coeffs)):
        d = coeffs[i]
        a = a[..., : d.shape[-1]]
        nxt = coeffs[i + 1].shape[-1] if i + 1 < len(coeffs) else None
        a = idwt(a, d, wav, out_len=nxt)
    return a


# -- 2D --------------------------------------------------------------------------


def dwt2(x: torch.Tensor, wavelet, mode: str = "reflect", impl: str | None = None):
    """Single-level 2D DWT over the last two axes. Returns (cA, Detail2D).

    bf16 inputs produce FLOAT32 coefficients on every impl: the kernel reads
    bf16 and upcasts on load; conv/matmul upcast here."""
    wav = _resolve(wavelet)
    impl = _resolve_impl(impl, x)
    with torch.profiler.record_function(SPAN_ANALYSIS):
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
    impl = _resolve_synth_impl(impl, cA)
    with torch.profiler.record_function(SPAN_SYNTH):
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
    impl = _resolve_synth_impl(impl, a)
    start = 0
    if impl == "kernel":
        k = _collapse_count(details)
        if k >= 2:
            with torch.profiler.record_function(SPAN_SYNTH):
                a = _mm.waverec2_collapsed(a, details[:k], wav)
            start = k
    L = wav.filt_len
    for det in details[start:]:
        tgt = det.horizontal.shape[-2:]
        a = a[..., : tgt[0], : tgt[1]]
        a = idwt2(a, det, wav, out_shape=(2 * tgt[0] - L + 2, 2 * tgt[1] - L + 2), impl=impl)
    return a


# -- 3D --------------------------------------------------------------------------

DETAIL3D_KEYS = ("aad", "ada", "add", "daa", "dad", "dda", "ddd")


def dwt3(x: torch.Tensor, wavelet, mode: str = "symmetric"):
    """Single-level 3D DWT over the last three axes. Returns (cA, {key:
    detail}) with the keys of `DETAIL3D_KEYS` (a/d over axes -3, -2, -1),
    each of side floor((n + L - 1)/2) per axis; bf16 inputs give float32
    coefficients. One strided ``conv3d`` over the 8 fused subband filters."""
    wav = _resolve(wavelet)
    if x.dtype == torch.bfloat16:
        x = x.float()
    batch_shape = x.shape[:-3]
    with torch.profiler.record_function(SPAN_3D):
        xb = x.reshape((-1, 1) + tuple(x.shape[-3:]))
        # offset by one so the stride-2 correlation lands on pywt's positions
        xp = _pad_axes(xb, wav.filt_len - 1, mode, axes=(-3, -2, -1))[..., 1:, 1:, 1:]
        out = _Analysis.apply(xp, _bank(wav, 3, x.dtype, x.device, rec=False))
    out = out.reshape(batch_shape + out.shape[1:])
    coeffs = {k: out[..., i, :, :, :] for i, k in enumerate(("aaa",) + DETAIL3D_KEYS)}
    return coeffs.pop("aaa"), coeffs


def idwt3(cA: torch.Tensor, details: dict, wavelet, out_shape=None, impl: str | None = None):
    """Single-level inverse 3D DWT: side 2n - L + 2 per axis, or ``out_shape``
    when given (a crop); bf16 coefficients give float32 voxels.

    ``impl="conv"``: one ``conv_transpose3d`` over the 8 subbands;
    ``"matmul"`` and ``"kernel"``: `matmul.synthesis3_mm`, three banded
    products (no TPU kernel covers 3D, so "kernel" takes the matmul form as
    the reference's "pallas" does). ``None`` is "conv" on every device: on
    an H100 80GB HBM3 (700 W) the conv form took 0.74-0.87 ms and the matmul
    form 1.21-1.44 ms for a forward and backward of `waverec3` at 128 x 32^3,
    haar, J=2 (`chip_smoke.py`'s vol phase, timed in turns)."""
    wav = _resolve(wavelet)
    L = wav.filt_len
    target = (tuple(2 * s - L + 2 for s in cA.shape[-3:]) if out_shape is None
              else tuple(out_shape))
    impl = "conv" if impl is None else _resolve_impl(impl, cA)
    sub = torch.stack([cA] + [details[k] for k in DETAIL3D_KEYS], dim=-4)
    if sub.dtype == torch.bfloat16:
        sub = sub.float()
    with torch.profiler.record_function(SPAN_3D):
        if impl != "conv":
            return _mm.synthesis3_mm(sub, wav, target)
        batch_shape = sub.shape[:-4]
        out = _Synthesis.apply(sub.reshape((-1,) + tuple(sub.shape[-4:])),
                               _bank(wav, 3, sub.dtype, sub.device, rec=True))[:, 0]
        out = out[:, : target[0], : target[1], : target[2]]
    return out.reshape(batch_shape + tuple(out.shape[-3:]))


def wavedec3(x: torch.Tensor, wavelet, level: int, mode: str = "symmetric"):
    """Multi-level 3D DWT: [cA_J, {aad..ddd}_J, ..., {aad..ddd}_1]."""
    wav = _resolve(wavelet)
    coeffs = []
    a = x
    for _ in range(level):
        a, det = dwt3(a, wav, mode)
        coeffs.append(det)
    coeffs.append(a)
    return coeffs[::-1]


def waverec3(coeffs, wavelet, impl: str | None = None):
    """Inverse of `wavedec3`: each level's approximation is trimmed to its
    details' shape before the synthesis."""
    wav = _resolve(wavelet)
    a = coeffs[0]
    L = wav.filt_len
    for det in coeffs[1:]:
        tgt = det["ddd"].shape[-3:]
        a = a[..., : tgt[0], : tgt[1], : tgt[2]]
        a = idwt3(a, det, wav, out_shape=tuple(2 * s - L + 2 for s in tgt), impl=impl)
    return a
