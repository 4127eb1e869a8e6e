"""Sequence-sharded DWT in the engines' expansive boundary modes (PyTorch
port of `wam_tpu.parallel.halo_modes`).

`halo` covers the periodized transforms, where every leaf tiles evenly
over the shards. The engines default to pywt's expansive modes (reflect
2D, symmetric 1D/3D), whose per-level output length (n + L - 1)//2 exceeds
n/2: the extra boundary coefficients do not tile. Every coefficient array
is therefore a **core + tail** pair. For one analysis level over a length-N
signal (N = C + T, C the evenly sharded core, T the tail), output j's
window covers samples [2j - L + 2, 2j + 1], so:

- outputs j < C/2 ("core outputs") touch the interior and the LEFT
  boundary extension only. Shard 0 builds that extension from its own head
  (`_pad_axes` of the head, entries [1, L - 1)); every other shard needs
  the L - 2 samples of its predecessor (`halo.Ring.shift`, one ring step a
  level, shard 0 receiving none).
- outputs j >= C/2 ("tail outputs", (T + L - 1)//2 of them) cross the right
  edge. They depend on the core's last samples and the tail only, stay O(L)
  for any signal (T_next = (T + L - 1)//2 converges to <= L - 2), and are
  computed whole beside the last shard (`Ring.tail_device`) from its end
  segment; across processes every rank computes them from that segment,
  broadcast by the last shard's owner, as the reference replicates them.

Every leaf is a `TailedLeaf(core, tail)`: the core a `halo.Sharded`, the
tail a whole tensor, or ``None`` when statically empty (haar chains, the
top-level reconstruction), so the leaves' structure is the reference's.
`gather_leaf` / `gather_coeffs` concatenate them into the exact
`wavelets.transform.wavedec*` arrays. The periodic modes are refused: their
boundary is the ring wrap itself (`halo.sharded_wavedec*_per`).

The synthesis inverts level by level: output sample t depends on
coefficients [ceil((t - 1)/2), floor((t + L - 2)/2)], so the synthesis halo
((L - 1)//2 coefficients) comes from the SUCCESSOR, the last shard taking
the head of the tail's subbands; the tail outputs come from the tails
alone. The unsharded axes of the 2D and 3D transforms run the port's own
per-block transforms (cuDNN convolutions in full float32 both ways), so the
sharded axis never enters a reshape that merges it.

Constraints (checked eagerly, the reference's messages): the sharded axis
must divide by 2 * shards at every level, and each level's block must be at
least the filter length L, so the halo is one hop and shard 0's extension
reads its own samples only. ``batch_axis=`` splits the flattened leading
axis of the cores over a second mesh axis; the tails stay whole.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from wam_tpu_torch.parallel.halo import (
    Ring,
    Sharded,
    _check_batch_divisible,
    _first,
    _gmap,
    _sharded_input,
    broadcast_from,
    coeff_grads,
)
from wam_tpu_torch.parallel.mesh import Mesh
from wam_tpu_torch.wavelets.filters import Wavelet
from wam_tpu_torch.wavelets.transform import (
    _PAD_MODE,
    DETAIL3D_KEYS,
    Detail2D,
    _Analysis,
    _bank,
    _pad_axes,
    _resolve,
    _Synthesis,
    dwt,
)

__all__ = [
    "TailedLeaf",
    "gather_leaf",
    "gather_coeffs",
    "sharded_wavedec_mode",
    "sharded_wavedec2_mode",
    "sharded_wavedec3_mode",
    "sharded_waverec_mode",
    "sharded_waverec2_mode",
    "sharded_waverec3_mode",
    "sharded_coeff_grads_mode",
]


class TailedLeaf(NamedTuple):
    """One coefficient array as (evenly sharded core, whole tail); ``tail``
    is None when statically empty."""

    core: Sharded
    tail: Optional[torch.Tensor]


def _tail_len(tail, axis: int = -1) -> int:
    return 0 if tail is None else tail.shape[axis]


def gather_leaf(leaf: TailedLeaf, axis: int = -1) -> torch.Tensor:
    """Core and tail concatenated into the full coefficient array, on the
    ring's model device (the core alone when the tail is empty).
    Differentiable; across processes the tail is the last shard owner's."""
    core = leaf.core.gather() if isinstance(leaf.core, Sharded) else leaf.core
    if _tail_len(leaf.tail, axis) == 0:
        return core
    tail = leaf.tail
    if isinstance(leaf.core, Sharded):
        ring = leaf.core.ring
        tail = broadcast_from(ring, tail, (0, ring.k - 1), tail)
    return torch.cat([core, tail.to(core.device)], dim=axis)


def gather_coeffs(coeffs, ndim: int = 1):
    """The full `transform.wavedec{,2,3}`-shaped coefficient list of a
    TailedLeaf structure (concatenated along the sharded axis)."""
    axis = -ndim
    out = []
    for c in coeffs:
        if isinstance(c, TailedLeaf):
            out.append(gather_leaf(c, axis))
        elif isinstance(c, Detail2D):
            out.append(Detail2D(*(gather_leaf(f, axis) for f in c)))
        elif isinstance(c, dict):
            out.append({k: gather_leaf(v, axis) for k, v in c.items()})
        else:
            raise TypeError(f"unexpected leaf type {type(c)!r}")
    return out


def _normalize_tails(coeffs, axis: int):
    """Hand-built zero-size tails as the ``tail=None`` form."""

    def norm(leaf: TailedLeaf) -> TailedLeaf:
        if leaf.tail is not None and leaf.tail.shape[axis] == 0:
            return TailedLeaf(leaf.core, None)
        return leaf

    out = []
    for c in coeffs:
        if isinstance(c, TailedLeaf):
            out.append(norm(c))
        elif isinstance(c, dict):
            out.append({k: norm(v) for k, v in c.items()})
        else:
            out.append(type(c)(*(norm(f) for f in c)))
    return out


def _check_mode(mode: str):
    if mode in ("periodic", "periodization"):
        raise ValueError(
            f"mode {mode!r}: the wrap boundary IS the ring — use "
            "wam_tpu_torch.parallel.sharded_wavedec{,2,3}_per, which is non-"
            "expansive and fully sharded"
        )
    if mode not in _PAD_MODE:
        raise ValueError(f"Unsupported mode {mode!r}; one of "
                         f"{sorted(set(_PAD_MODE) - {'periodic'})}")


def _check_divisibility(n: int, k: int, L: int, level: int, what: str):
    c = n
    for lev in range(1, level + 1):
        if c % (2 * k):
            raise ValueError(
                f"{what} length {n}: level-{lev} core length {c} is not "
                f"divisible by 2*shards={2 * k}"
            )
        m = c // k
        if m < L:
            raise ValueError(
                f"{what} length {n}: level-{lev} per-shard block {m} is "
                f"shorter than the filter (L={L}); use fewer shards or "
                f"levels"
            )
        c //= 2


# -- one analysis level along the last axis of (R, n) blocks ---------------------------


def _corr2(x2: torch.Tensor, wav: Wavelet) -> torch.Tensor:
    """Valid stride-2 correlation with the fused (lo, hi) bank: (R, n) ->
    (R, 2, (n - L)//2 + 1), in full float32 both ways."""
    return _Analysis.apply(x2[:, None, :], _bank(wav, 1, x2.dtype, x2.device, rec=False))


def _core_level(grid, wav: Wavelet, mode: str, ring: Ring):
    """Core outputs of every block: (R, m) -> (R, 2, m/2), shard 0 from its
    own left extension, the others from their predecessor's L - 2 samples."""
    L = wav.filt_len
    if L > 2:
        halos, grid = ring.prev_halo(grid, L - 2, skip=(0,))

        def ext(h, t):
            if h is not None:
                return torch.cat([h, t], dim=-1)
            head = t[:, : min(t.shape[-1], 2 * L)]
            return torch.cat([_pad_axes(head, L - 1, mode, axes=(-1,))[:, 1:L - 1], t], dim=-1)

        grid = [[None if t is None else ext(h, t) for h, t in zip(hrow, trow)]
                for hrow, trow in zip(halos, grid)]
    return _gmap(lambda e: _corr2(e, wav), grid)


def _end_segment(grid, take: int, ring: Ring) -> torch.Tensor:
    """The last ``take`` samples of every row group's last block, rows in
    group order, on the tail device (broadcast by the last shard's owner
    across processes)."""
    k = ring.k
    if ring.distributed:
        last = grid[0][k - 1]
        mine = None if last is None else last[:, -take:]
        like = _first(grid)[:, -take:]
        return broadcast_from(ring, mine, (0, k - 1), like)
    return torch.cat([row[k - 1][:, -take:].to(ring.tail_device) for row in grid], dim=0)


def _tail_level(grid, tail, wav: Wavelet, mode: str, ring: Ring):
    """Tail outputs of one level, (R, 2, (T + L - 1)//2) on the tail device,
    or None when statically empty. Windows j >= C/2 read the core's last
    L - 2 samples, the tail and the right extension, which reflects at most
    L samples of the segment: a segment of min(block, 2L) >= L core
    samples gives the reference's values (it takes min(C, 2L))."""
    L = wav.filt_len
    T = _tail_len(tail)
    if (T + L - 1) // 2 == 0:
        return None
    take = min(_first(grid).shape[-1], 2 * L)
    end = _end_segment(grid, take, ring)
    seg = end if T == 0 else torch.cat([end, tail.to(end.device)], dim=-1)
    segp = _pad_axes(seg, L - 1, mode, axes=(-1,))[:, L - 1:]
    return _corr2(segp[:, take - L + 2:], wav)


def _level_1d(grid, tail, wav, mode, ring):
    """One analysis level on (R, C) blocks and the (R_all, T) tail:
    ((cA grid, cA tail), (cD grid, cD tail)), tails None when empty."""
    out = _core_level(grid, wav, mode, ring)
    t2 = _tail_level(grid, tail, wav, mode, ring)
    a = _gmap(lambda o: o[:, 0], out)
    d = _gmap(lambda o: o[:, 1], out)
    if t2 is None:
        return (a, None), (d, None)
    return (a, t2[:, 0]), (d, t2[:, 1])


def _flat(t, axis: int):
    """``axis`` moved last, every other axis flattened into rows."""
    m = t.movedim(axis, -1)
    return m.reshape(-1, m.shape[-1]), tuple(m.shape[:-1])


def _axis_level(core, tail, axis, wav, mode, ring):
    """One analysis level along ``axis`` (negative) of every block and the
    tail: ((a core, a tail), (d core, d tail)) with ``axis`` halved."""
    leads = _gmap(lambda c: _flat(c, axis)[1], core)
    flat = _gmap(lambda c: _flat(c, axis)[0], core)
    tflat, tlead = (None, None) if tail is None else _flat(tail, axis)
    if tlead is None:  # the first tail: every row group's rows
        lead0 = _first(leads)
        tlead = (ring.g * lead0[0],) + lead0[1:]
    (a_c, a_t), (d_c, d_t) = _level_1d(flat, tflat, wav, mode, ring)

    def back(o, lead):
        return o.reshape(lead + (o.shape[-1],)).movedim(-1, axis)

    unt = lambda o: None if o is None else back(o, tlead)  # noqa: E731
    return ((_gmap(back, a_c, leads), unt(a_t)), (_gmap(back, d_c, leads), unt(d_t)))


def _dwt_last(x, wav, mode):
    """The single-device 1D level along the last axis: (..., n) -> (..., 2,
    n'), full float32 both ways (`transform.dwt`)."""
    a, d = dwt(x, wav, mode)
    return torch.stack([a, d], dim=-2)


def _dwt_hw(x, wav, mode):
    """One 2D level over the last two axes: (..., H, W) -> (..., 4, H', W'),
    channels aa, ad, da, dd; full float32 both ways."""
    L = wav.filt_len
    xb = x.reshape((-1, 1) + tuple(x.shape[-2:]))
    xp = _pad_axes(xb, L - 1, mode, axes=(-2, -1))[..., 1:, 1:]
    out = _Analysis.apply(xp, _bank(wav, 2, x.dtype, x.device, rec=False))
    return out.reshape(tuple(x.shape[:-2]) + tuple(out.shape[1:]))


def _leaf(grid, tail, ring, ndim, lead):
    return TailedLeaf(Sharded(grid, -ndim, ring, lead),
                      None if tail is None else tail.reshape(lead + tuple(tail.shape[1:])))


def _mode_dec(mesh: Mesh, wavelet, level: int, mode: str, seq_axis: str,
              batch_axis: str | None, ndim: int, what: str):
    wav = _resolve(wavelet)
    _check_mode(mode)
    ring = Ring(mesh, seq_axis, batch_axis)
    keys = ("aaa",) + DETAIL3D_KEYS

    def check(x):
        _check_divisibility(x.shape[-ndim], ring.k, wav.filt_len, level, what)
        lead = math.prod(x.shape[:-ndim]) if len(x.shape) > ndim else 1
        _check_batch_divisible(lead, mesh, batch_axis)

    def apply(x):
        sx = _sharded_input(x, ring, ndim)
        lead = sx.lead
        core, tail = sx.blocks, None
        leaves = []
        for _ in range(level):
            if ndim == 1:
                (core, a_t), (d_c, d_t) = _level_1d(core, tail, wav, mode, ring)
                leaves.append(_leaf(d_c, d_t, ring, 1, lead))
                tail = a_t
                continue
            local = _dwt_last if ndim == 2 else _dwt_hw
            cw = _gmap(lambda c: local(c, wav, mode), core)
            tw = None if tail is None else local(tail, wav, mode)
            (a_c, a_t), (d_c, d_t) = _axis_level(cw, tw, -(ndim + 1), wav, mode, ring)
            sel = (lambda t, ch: t[..., ch, :]) if ndim == 2 else (lambda t, ch: t[..., ch, :, :])
            tsel = lambda t, ch, sel=sel: None if t is None else sel(t, ch)  # noqa: E731
            csel = lambda g, ch, sel=sel: _gmap(lambda t: sel(t, ch), g)  # noqa: E731
            if ndim == 2:
                leaves.append(Detail2D(
                    horizontal=_leaf(csel(d_c, 0), tsel(d_t, 0), ring, 2, lead),
                    vertical=_leaf(csel(a_c, 1), tsel(a_t, 1), ring, 2, lead),
                    diagonal=_leaf(csel(d_c, 1), tsel(d_t, 1), ring, 2, lead)))
            else:
                det = {}
                for code in range(1, 8):
                    d_bit, ch = code >> 2, code & 3
                    src_c, src_t = (d_c, d_t) if d_bit else (a_c, a_t)
                    det[keys[code]] = _leaf(csel(src_c, ch), tsel(src_t, ch), ring, 3, lead)
                leaves.append(det)
            core, tail = csel(a_c, 0), tsel(a_t, 0)
        leaves.append(_leaf(core, tail, ring, ndim, lead))
        return leaves[::-1]

    def run(x):
        check(x)
        return apply(x)

    run._apply, run._check, run.ring = apply, check, ring
    return run


def sharded_wavedec_mode(mesh: Mesh, wavelet, level: int, mode: str = "symmetric",
                         seq_axis: str = "data", batch_axis: str | None = None):
    """Multi-level 1D decomposition in a pywt boundary mode, sequence-
    sharded over ``seq_axis`` on the LAST axis: ``x -> [cA_J, cD_J, ...,
    cD_1]`` of `TailedLeaf` pairs; `gather_coeffs` gives
    `transform.wavedec(x, wavelet, level, mode)`. ``batch_axis`` also
    splits the flattened leading axis of the cores over that mesh axis."""
    return _mode_dec(mesh, wavelet, level, mode, seq_axis, batch_axis, 1, "sequence axis")


def sharded_wavedec2_mode(mesh: Mesh, wavelet, level: int, mode: str = "reflect",
                          seq_axis: str = "data", batch_axis: str | None = None):
    """Multi-level 2D decomposition for images whose ROW axis is sharded:
    x (..., H, W), ``x -> [cA_J, Detail2D_J, ..., Detail2D_1]`` with every
    field a `TailedLeaf` split along H; ``gather_coeffs(out, ndim=2)`` gives
    `transform.wavedec2`. The W axis is transformed on each block."""
    return _mode_dec(mesh, wavelet, level, mode, seq_axis, batch_axis, 2, "row axis")


def sharded_wavedec3_mode(mesh: Mesh, wavelet, level: int, mode: str = "symmetric",
                          seq_axis: str = "data", batch_axis: str | None = None):
    """Multi-level 3D decomposition for volumes whose DEPTH axis is sharded:
    x (..., D, H, W), ``x -> [cA_J, {aad..ddd}_J, ...]`` of `TailedLeaf`
    values split along D; ``gather_coeffs(out, ndim=3)`` gives
    `transform.wavedec3`. H and W are transformed on each block."""
    return _mode_dec(mesh, wavelet, level, mode, seq_axis, batch_axis, 3, "depth axis")


# -- synthesis ---------------------------------------------------------------------------


def _synth_1d(sub: torch.Tensor, wav: Wavelet, n: int) -> torch.Tensor:
    """(R, 2, h) subbands -> (R, n) samples, the first n of the trimmed
    transposed convolution (`transform.idwt`'s), full float32 both ways."""
    return _Synthesis.apply(sub, _bank(wav, 1, sub.dtype, sub.device, rec=True))[:, 0, :n]


def _synth_core(subs, halo_src, wav: Wavelet, ring: Ring):
    """Core synthesis of every block: (R, 2, m) -> (R, 2m), the (L - 1)//2
    coefficients after the block from its successor, the last shard's from
    ``halo_src`` (the tail subbands' head, rows in group order)."""
    h = (wav.filt_len - 1) // 2
    if h > 0:
        k = ring.k
        pieces, subs = ring.shift(subs, 1, 0, h, skip=(k - 1,))
        rows = _first(subs).shape[0]
        for i in range(ring.g):
            if ring.owned[i][k - 1]:
                pieces[i][k - 1] = halo_src[i * rows:(i + 1) * rows].to(ring.devices[i][k - 1])
        subs = _gmap(lambda s, p: torch.cat([s, p], dim=-1), subs, pieces)
    return _gmap(lambda s: _synth_1d(s, wav, 2 * (s.shape[-1] - h)), subs)


def _level_inv_1d(coreA, tailA, coreD, tailD, wav: Wavelet, ring: Ring):
    """One synthesis level on (R, C) blocks and (R_all, T) tails: (core
    (R, 2C) blocks, tail (R_all, 2T - L + 2) or None)."""
    L = wav.filt_len
    T = _tail_len(tailA)
    h = (L - 1) // 2
    if T < h:
        raise ValueError(
            f"tail length {T} < {h} coefficients: the last shard's synthesis "
            "halo must come from the tail; feed leaves produced by "
            "sharded_wavedec_mode (its tails always satisfy this)"
        )
    subs = _gmap(lambda a, d: torch.stack([a, d], dim=-2), coreA, coreD)
    if tailA is None:
        return _synth_core(subs, None, wav, ring), None
    tail_subs = torch.stack([tailA, tailD.to(tailA.device)], dim=-2)
    core_out = _synth_core(subs, tail_subs[..., :h], wav, ring)
    t_len = max(2 * T - L + 2, 0)
    if t_len == 0:
        return core_out, None
    return core_out, _synth_1d(tail_subs, wav, t_len)


def _check_coeff_leaves(coeffs, wav: Wavelet, axis: int, k: int, producer: str, what: str):
    """Eager validation for the waverec wrappers (the reference's): every
    core divides over the shards along ``axis``, every tail holds at least
    (L - 1)//2 coefficients (None counts as 0 and passes for haar only)."""
    h_min = (wav.filt_len - 1) // 2
    for c in coeffs:
        if isinstance(c, TailedLeaf):
            pieces = [c]
        elif isinstance(c, dict):
            pieces = list(c.values())
        else:
            pieces = list(c)
        for piece in pieces:
            n = piece.core.shape[axis]
            if n % k:
                raise ValueError(
                    f"coefficient core {what} {n} is not divisible by "
                    f"shards={k}: these leaves were not produced by "
                    f"{producer} on this mesh"
                )
            if _tail_len(piece.tail, axis) < h_min:
                raise ValueError(
                    f"coefficient tail length {_tail_len(piece.tail, axis)} < "
                    f"{h_min}: the last shard's synthesis halo must come "
                    f"from the tail; feed leaves produced by {producer}"
                )


def _axis_level_inv(a_pair, d_pair, axis, wav, ring):
    """One synthesis level along ``axis`` (negative): the inverse of
    `_axis_level`, (core, tail) with ``axis`` doubled."""
    (a_c, a_t), (d_c, d_t) = a_pair, d_pair
    leads = _gmap(lambda c: _flat(c, axis)[1], a_c)
    fa = _gmap(lambda c: _flat(c, axis)[0], a_c)
    fd = _gmap(lambda c: _flat(c, axis)[0], d_c)
    ta, tlead = (None, None) if a_t is None else _flat(a_t, axis)
    td = None if d_t is None else _flat(d_t, axis)[0]
    core, tail = _level_inv_1d(fa, ta, fd, td, wav, ring)

    def back(o, lead):
        return o.reshape(lead + (o.shape[-1],)).movedim(-1, axis)

    return _gmap(back, core, leads), None if tail is None else back(tail, tlead)


def _tcat(tails, g: int):
    """Whole tails stacked along rows group by group (each group's rows of
    every part in turn), so a group's rows stay contiguous; None if empty."""
    if tails[0] is None:
        return None
    r = tails[0].shape[0] // g
    dev = tails[0].device
    return torch.cat([t[i * r:(i + 1) * r].to(dev) for i in range(g) for t in tails], dim=0)


def _tsplit(t, n: int, g: int):
    """Inverse of `_tcat`: the n parts of a group-major stack."""
    r = t.shape[0] // (n * g)
    parts = [t[(i * n + p) * r:(i * n + p + 1) * r] for i in range(g) for p in range(n)]
    return [torch.cat(parts[p::n], dim=0) for p in range(n)]


def _flat_leaf(leaf: TailedLeaf, ndim: int):
    t = leaf.tail
    return (leaf.core.blocks,
            None if t is None else t.reshape((-1,) + tuple(t.shape[t.ndim - ndim:])))


def _mode_rec(mesh: Mesh, wavelet, seq_axis: str, batch_axis: str | None, ndim: int,
              producer: str, what: str):
    wav = _resolve(wavelet)
    L = wav.filt_len
    ring = Ring(mesh, seq_axis, batch_axis)
    g = ring.g

    def apply(coeffs):
        lead = coeffs[0].core.lead
        a_c, a_t = _flat_leaf(coeffs[0], ndim)
        for det in coeffs[1:]:
            if ndim == 1:
                d_c, d_t = _flat_leaf(det, 1)
                td = _tail_len(d_t)
                if _tail_len(a_t) > td:
                    a_t = a_t[..., :td] if td else None
                a_c, a_t = _level_inv_1d(a_c, a_t, d_c, d_t, wav, ring)
                continue
            if ndim == 2:
                hor, ver, dia = (_flat_leaf(f, 2) for f in det)
                ht, wt = _tail_len(hor[1], -2), _first(hor[0]).shape[-1]
                a_c = _gmap(lambda c: c[..., :wt], a_c)
                a_t = None if a_t is None else a_t[..., :ht, :wt]
                a_parts, d_parts = [(a_c, a_t), ver], [hor, dia]
                target = (2 * wt - L + 2,)
            else:
                det_f = {kk: _flat_leaf(v, 3) for kk, v in det.items()}
                ref_c, ref_t = det_f["ddd"]
                dt_ = _tail_len(ref_t, -3)
                ht, wt = _first(ref_c).shape[-2:]
                a_c = _gmap(lambda c: c[..., :ht, :wt], a_c)
                a_t = None if a_t is None else a_t[..., :dt_, :ht, :wt]
                order = ("aa", "ad", "da", "dd")
                a_parts = [(a_c, a_t) if kk == "aa" else det_f["a" + kk] for kk in order]
                d_parts = [det_f["d" + kk] for kk in order]
                target = (2 * ht - L + 2, 2 * wt - L + 2)
            n = len(a_parts)
            # every subband pair of the level rides ONE exchange, stacked on the rows
            ac = _gmap(lambda *c: torch.cat(c, dim=0), *[p[0] for p in a_parts])
            dc = _gmap(lambda *c: torch.cat(c, dim=0), *[p[0] for p in d_parts])
            cc, tt = _axis_level_inv((ac, _tcat([p[1] for p in a_parts], g)),
                                     (dc, _tcat([p[1] for p in d_parts], g)), -ndim, wav, ring)
            a_c = _gmap(lambda c: _local_synth(torch.stack(c.chunk(n, dim=0), dim=-ndim),
                                               wav, target), cc)
            a_t = (None if tt is None
                   else _local_synth(torch.stack(_tsplit(tt, n, g), dim=-ndim), wav, target))
        return TailedLeaf(Sharded(a_c, -ndim, ring, lead),
                          None if a_t is None else a_t.reshape(lead + tuple(a_t.shape[1:])))

    def run(coeffs):
        axis = -ndim
        coeffs = _normalize_tails(coeffs, axis)
        _check_coeff_leaves(coeffs, wav, axis, ring.k, producer, what)
        lead = coeffs[0].core.lead
        _check_batch_divisible(math.prod(lead) if lead else 1, mesh, batch_axis)
        return apply(coeffs)

    run._apply, run.ring = apply, ring
    return run


def _local_synth(sub: torch.Tensor, wav: Wavelet, target: tuple) -> torch.Tensor:
    """The unsharded axes' synthesis of stacked subbands: (..., 2, n) ->
    (..., target) along the last axis, or (..., 4, h, w) -> (..., *target)
    over the last two; full float32 both ways."""
    nd = len(target)
    lead = tuple(sub.shape[:-(nd + 1)])
    flat = sub.reshape((-1,) + tuple(sub.shape[-(nd + 1):]))
    out = _Synthesis.apply(flat, _bank(wav, nd, sub.dtype, sub.device, rec=True))[:, 0]
    out = out[(Ellipsis,) + tuple(slice(0, s) for s in target)]
    return out.reshape(lead + tuple(out.shape[1:]))


def sharded_waverec_mode(mesh: Mesh, wavelet, seq_axis: str = "data",
                         batch_axis: str | None = None):
    """Inverse of `sharded_wavedec_mode`: the TailedLeaf list back to the
    (..., N) signal as a `TailedLeaf` (core sharded, tail None for every
    even-length filter, so `gather_leaf` is the signal). Matches
    `transform.waverec`, its trim-to-detail convention included (it touches
    the tails only)."""
    return _mode_rec(mesh, wavelet, seq_axis, batch_axis, 1, "sharded_wavedec_mode", "length")


def sharded_waverec2_mode(mesh: Mesh, wavelet, seq_axis: str = "data",
                          batch_axis: str | None = None):
    """Inverse of `sharded_wavedec2_mode` (rows sharded): the (..., H, W)
    image as a `TailedLeaf` split along H; matches `transform.waverec2`.
    Both W-subband letters of a level ride one ring exchange."""
    return _mode_rec(mesh, wavelet, seq_axis, batch_axis, 2, "sharded_wavedec2_mode",
                     "row count")


def sharded_waverec3_mode(mesh: Mesh, wavelet, seq_axis: str = "data",
                          batch_axis: str | None = None):
    """Inverse of `sharded_wavedec3_mode` (depth sharded); matches
    `transform.waverec3`. The four (H, W) letter pairs of a level ride one
    ring exchange."""
    return _mode_rec(mesh, wavelet, seq_axis, batch_axis, 3, "sharded_wavedec3_mode", "depth")


def sharded_coeff_grads_mode(mesh: Mesh, wavelet, level: int, model_fn, mode: str = "symmetric",
                             seq_axis: str = "data", ndim: int = 1, fused: bool = True):
    """Long-context WAM gradient core in the engines' default boundary
    modes (the periodized one is `halo.sharded_coeff_grads_per`): sharded
    decompose -> reconstruct -> model -> the gradient of sum(logits[b, y[b]])
    (mean of the logits when y is None) in the coefficients' TailedLeaf
    structure. The model runs on the whole reconstruction on the ring's
    model device. ``fused=True`` is one step (the eager checks, then
    decompose and gradients); ``fused=False`` two (decompose, gradients),
    the same operations; ``step._dec`` / ``step._grads`` are the halves."""
    wav = _resolve(wavelet)
    if ndim not in (1, 2, 3):
        raise ValueError(f"ndim must be 1, 2, or 3; got {ndim!r}")
    dec = {1: sharded_wavedec_mode, 2: sharded_wavedec2_mode,
           3: sharded_wavedec3_mode}[ndim](mesh, wav, level, mode, seq_axis)
    rec = {1: sharded_waverec_mode, 2: sharded_waverec2_mode,
           3: sharded_waverec3_mode}[ndim](mesh, wav, seq_axis)

    def grads(cs, y=None):
        return coeff_grads(cs, lambda c: gather_leaf(rec._apply(c), axis=-ndim), model_fn, y)

    if fused:
        def step(x, y=None):
            dec._check(x)
            with torch.no_grad():
                cs = dec._apply(x)
            return grads(cs, y)
    else:
        def step(x, y=None):
            with torch.no_grad():
                cs = dec(x)
            return grads(cs, y)

    step._dec, step._grads = dec, grads
    return step
