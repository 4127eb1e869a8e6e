"""Sequence-sharded DWT with a ring halo exchange (PyTorch port of
`wam_tpu.parallel.halo`).

The 1D DWT is a filter-width stencil, so a signal split into blocks along
its sequence axis needs only L - 2 boundary samples of its ring neighbour a
level. The reference exchanges them with one ``lax.ppermute`` a level
inside ``shard_map``; here the blocks are the entries of a `Mesh` along
``seq_axis`` (`Mesh.block` splits the input), each held on its device, and
`Ring.shift` is the exchange: it gives every block a slice of another
block's tensor, moved to its device.

- Within one process the slice is sent with ``.to(device)``, a view when
  the two blocks share a card; autograd carries the adjoint back.
- Across processes (a `multihost.hybrid_mesh` whose ``process_ids`` name
  other ranks) one ring step is `_RingStep`, an autograd Function whose
  forward is one matched ``torch.distributed.batch_isend_irecv`` and whose
  backward sends each received slice's gradient back the other way round
  the ring.
- A ring whose blocks all belong to this process makes no distributed call
  at all (a process group of one rank included).
- With ``batch_axis`` the rows come in row groups, one ring each; every
  step, gather and broadcast carries all of them, so the row groups may
  sit on any ranks (a sequence ring across processes included).

The exchange counts the elements it moves from one block to another
(`halo_elements`): the counterpart of the reference's HLO audit that no
transform all-gathers a signal-sized operand. A level moves L - 2 elements
a row into each block (the whole predecessors only where L - 2 exceeds a
block), never the signal.

With the periodized transforms the ring wrap IS the boundary condition, so
the sharded result equals the single-device ``*_per`` transforms; every
leaf is a `Sharded` tensor, its blocks on their devices. The engines'
expansive modes are `halo_modes`'s. A long filter at a deep level may need
more than one block's worth of halo: the exchange then takes slices of
several predecessors (one ring step a hop), as the reference's multi-hop
``ppermute`` does.

The inverse is written out as the adjoint of the analysis (the transform
is orthogonal): each block's transposed convolution yields L - 2 samples
that belong to its predecessor, so the synthesis halo travels the other
way round the ring, as the reference's ``linear_transpose`` makes it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from wam_tpu_torch.parallel.mesh import Mesh
from wam_tpu_torch.parallel.tree import tree_leaves, tree_map
from wam_tpu_torch.wavelets import periodized as _per
from wam_tpu_torch.wavelets.transform import (
    DETAIL3D_KEYS,
    Detail2D,
    _Analysis,
    _bank,
    _f32_convs,
    _resolve,
)

__all__ = [
    "sharded_dwt_per",
    "sharded_wavedec_per",
    "sharded_wavedec2_per",
    "sharded_wavedec3_per",
    "sharded_waverec_per",
    "sharded_waverec2_per",
    "sharded_waverec3_per",
    "sharded_coeff_grads_per",
]

_moved = [0]  # elements moved between blocks by ring steps since the last reset


def halo_elements() -> int:
    """Elements the ring exchange moved from one block to another (received
    by this process's blocks) since `reset_halo_elements`."""
    return _moved[0]


def reset_halo_elements() -> None:
    _moved[0] = 0


# -- the ring: geometry and the exchange ---------------------------------------------


class Ring:
    """The blocks of ``mesh`` along ``seq_axis`` (k shards), in ``g`` row
    groups along ``batch_axis`` (1 without one); blocks at index 0 of every
    other mesh axis. ``devices[i][j]`` is block (i, j)'s device (None for a
    block of another process), ``owned[i][j]`` whether this process runs
    it."""

    def __init__(self, mesh: Mesh, seq_axis: str = "data", batch_axis: str | None = None):
        if seq_axis not in mesh.axis_names:
            raise ValueError(f"seq_axis {seq_axis!r} is not a mesh axis {mesh.axis_names}")
        self.mesh, self.seq_axis, self.batch_axis = mesh, seq_axis, batch_axis
        self.k = mesh.shape[seq_axis]
        self.g = 1 if batch_axis is None else mesh.shape[batch_axis]

        def coords(i, j):
            c = {seq_axis: j}
            if batch_axis is not None:
                c[batch_axis] = i
            return c

        idx = [[coords(i, j) for j in range(self.k)] for i in range(self.g)]
        self.devices = [[mesh.device(**c) for c in row] for row in idx]
        self.owned = [[mesh.owns(**c) for c in row] for row in idx]
        self.ranks = [[mesh.rank if mesh.process_ids is None
                       else int(mesh.process_ids[mesh._index(c)]) for c in row] for row in idx]
        self.rank = mesh.rank
        self.distributed = not all(all(row) for row in self.owned)
        local = [d for row, own in zip(self.devices, self.owned)
                 for d, o in zip(row, own) if o]
        if not local:
            raise ValueError(f"this process owns no block of {mesh} along {seq_axis!r}")
        self.local_device = local[0]
        # the replicated tails of `halo_modes` live beside the last shard (one
        # process), or on every rank's own device (each rank computes them)
        self.tail_device = self.local_device if self.distributed else self.devices[0][-1]
        self.model_device = self.local_device if self.distributed else self.devices[0][0]

    def blocks(self, fn) -> list[list]:
        """``fn(i, j)`` for every block this process owns, None elsewhere."""
        return [[fn(i, j) if self.owned[i][j] else None for j in range(self.k)]
                for i in range(self.g)]

    def shift(self, grid, offset: int, start: int, length: int, axis: int = -1, skip=()):
        """One ring step: block j of every row group receives ``grid[i][(j +
        offset) % k].narrow(axis, start, length)`` (``start`` < 0 counts from
        the end) on its own device; None for the shards in ``skip`` and the
        blocks of other processes. Returns (pieces, grid): across processes
        the sources come back through the step's autograd node and must be
        used in place of the old ones (the same grid otherwise)."""
        if self.distributed:
            return _ring_step(self, grid, offset, start, length, axis, skip)
        pieces = []
        for i, row in enumerate(grid):
            out = []
            for j in range(self.k):
                if j in skip:
                    out.append(None)
                    continue
                s = (j + offset) % self.k
                src = row[s]
                st = start if start >= 0 else src.shape[axis] + start
                piece = src.narrow(axis, st, length).to(self.devices[i][j])
                if s != j:
                    _moved[0] += piece.numel()
                out.append(piece)
            pieces.append(out)
        return pieces, grid

    def prev_halo(self, grid, need: int, axis: int = -1, skip=()):
        """Each block's ``need`` samples preceding it along ``axis`` round
        the ring: the predecessor's tail, or slices of several predecessors
        when ``need`` exceeds a block (one ring step a hop). Returns (halos,
        grid)."""
        m = _first(grid).shape[axis]
        hops = -(-need // m)
        parts = []
        for t in range(hops, 0, -1):  # farthest first
            ln = need - (hops - 1) * m if t == hops else m
            piece, grid = self.shift(grid, -t, -ln, ln, axis, skip)
            parts.append(piece)
        if hops == 1:
            return parts[0], grid
        return [[None if parts[0][i][j] is None else
                 torch.cat([p[i][j] for p in parts], dim=axis) for j in range(self.k)]
                for i in range(self.g)], grid


def _first(grid):
    return next(t for row in grid for t in row if t is not None)


def _ring_step(ring: Ring, grid, offset, start, length, axis, skip):
    """`Ring.shift` on a ring that spans processes (module docstring)."""
    srcs, src_index = [], {}
    for i in range(ring.g):
        for j in range(ring.k):
            if ring.owned[i][j]:
                src_index[(i, j)] = len(srcs)
                srcs.append(grid[i][j])
    shape = list(srcs[0].shape)
    st = start if start >= 0 else shape[axis] + start
    shape[axis] = length
    local, sends, recvs, slots = [], [], [], []
    for i in range(ring.g):
        for j in range(ring.k):
            s = (j + offset) % ring.k
            if j in skip:
                continue
            tag = i * ring.k + j
            dst_here, src_here = ring.owned[i][j], ring.owned[i][s]
            if dst_here:
                slots.append((i, j))
                if src_here:
                    local.append((len(slots) - 1, src_index[(i, s)], ring.devices[i][j], s != j))
                else:
                    recvs.append((len(slots) - 1, ring.ranks[i][s], tag, ring.devices[i][j]))
            elif src_here:
                sends.append((src_index[(i, s)], ring.ranks[i][j], tag))
    plan = {"axis": axis, "start": st, "length": length, "shape": tuple(shape),
            "local": local, "sends": sends, "recvs": recvs, "n": len(slots)}
    out = _RingStep.apply(plan, *srcs)
    new_srcs, got = out[:len(srcs)], out[len(srcs):]
    new_grid = [[None] * ring.k for _ in range(ring.g)]
    for (i, j), n in src_index.items():
        new_grid[i][j] = new_srcs[n]
    pieces = [[None] * ring.k for _ in range(ring.g)]
    for n, (i, j) in enumerate(slots):
        pieces[i][j] = got[n]
    return pieces, new_grid


def _p2p(ops) -> None:
    import torch.distributed as dist

    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class _RingStep(torch.autograd.Function):
    """One ring step across processes: forward sends this process's slices
    to the blocks of other ranks and receives theirs (one batch of isend /
    irecv), copies the slices between its own blocks; the sources pass
    through as outputs so that their gradient always reaches this node.
    Backward: each received slice's gradient goes back to its sender, whose
    sources get it added on their slice."""

    @staticmethod
    def forward(ctx, plan, *srcs):
        import torch.distributed as dist

        ax, st, ln = plan["axis"], plan["start"], plan["length"]
        got = [None] * plan["n"]
        ops = [dist.P2POp(dist.isend, srcs[s].narrow(ax, st, ln).contiguous(), peer, tag=tag)
               for s, peer, tag in plan["sends"]]
        for slot, peer, tag, dev in plan["recvs"]:
            got[slot] = torch.empty(plan["shape"], dtype=srcs[0].dtype, device=dev)
            ops.append(dist.P2POp(dist.irecv, got[slot], peer, tag=tag))
        _p2p(ops)
        for slot, s, dev, moved in plan["local"]:
            got[slot] = srcs[s].narrow(ax, st, ln).to(dev, copy=True)
            if moved:
                _moved[0] += got[slot].numel()
        for slot, *_ in plan["recvs"]:
            _moved[0] += got[slot].numel()
        ctx.plan = plan
        ctx.like = [(s.shape, s.dtype, s.device) for s in srcs]
        return tuple(s.view_as(s) for s in srcs) + tuple(got)

    @staticmethod
    def backward(ctx, *grads):
        import torch.distributed as dist

        plan = ctx.plan
        ax, st, ln = plan["axis"], plan["start"], plan["length"]
        n_src = len(ctx.like)
        g_src = [torch.zeros(sh, dtype=dt, device=dv) if g is None else g.clone()
                 for g, (sh, dt, dv) in zip(grads[:n_src], ctx.like)]
        g_got = list(grads[n_src:])
        for slot, s, _, _ in plan["local"]:
            if g_got[slot] is not None:
                g_src[s].narrow(ax, st, ln).add_(g_got[slot].to(g_src[s].device))
        ops, back = [], []
        for slot, peer, tag, dev in plan["recvs"]:
            g = g_got[slot]
            g = torch.zeros(plan["shape"], dtype=ctx.like[0][1], device=dev) if g is None else g
            ops.append(dist.P2POp(dist.isend, g.contiguous(), peer, tag=tag))
        for s, peer, tag in plan["sends"]:
            buf = torch.empty(plan["shape"], dtype=ctx.like[s][1], device=ctx.like[s][2])
            back.append((s, buf))
            ops.append(dist.P2POp(dist.irecv, buf, peer, tag=tag))
        _p2p(ops)
        for s, buf in back:
            g_src[s].narrow(ax, st, ln).add_(buf)
        return (None, *g_src)


# -- sharded tensors -------------------------------------------------------------------


class Sharded:
    """A tensor held in blocks over a `Ring`: its rows (the leading axis,
    the flattened leading dims ``lead``) in ``ring.g`` groups, its sequence
    axis ``axis`` (negative) in ``ring.k`` shards; ``blocks[i][j]`` on
    ``ring.devices[i][j]``, None for a block of another process."""

    __slots__ = ("blocks", "axis", "ring", "lead")

    def __init__(self, blocks, axis: int, ring: Ring, lead: tuple | None = None):
        self.blocks, self.axis, self.ring, self.lead = blocks, axis, ring, lead

    @classmethod
    def split(cls, x: torch.Tensor, ring: Ring, axis: int, lead_dims: int = 1) -> "Sharded":
        """``x`` (its first ``lead_dims`` axes flattened into rows) split
        into the ring's blocks: rows over the row groups, ``axis`` over the
        shards, each block moved to its device."""
        lead = tuple(x.shape[:lead_dims])
        flat = x.reshape((math.prod(lead),) + tuple(x.shape[lead_dims:]))
        r, m = flat.shape[0] // ring.g, flat.shape[axis] // ring.k
        return cls(ring.blocks(lambda i, j: flat.narrow(0, i * r, r).narrow(axis, j * m, m)
                               .to(ring.devices[i][j])), axis, ring, lead)

    def first(self) -> torch.Tensor:
        return _first(self.blocks)

    @property
    def shape(self) -> tuple:
        b = list(self.first().shape)
        b[0] *= self.ring.g
        b[self.axis] *= self.ring.k
        return tuple(b)

    def map_blocks(self, fn) -> "Sharded":
        return Sharded([[None if t is None else fn(t) for t in row] for row in self.blocks],
                       self.axis, self.ring, self.lead)

    def gather(self, device=None, samples: int = 1) -> torch.Tensor:
        """The whole tensor on ``device`` (the ring's model device by
        default), leading dims restored. ``samples`` > 1: every block's rows
        are that many stacked copies, sample-major, and the result is
        sample-major over the whole batch. Differentiable; across processes
        every rank gets the whole tensor (each block broadcast from its
        owner; the backward keeps this rank's blocks' slices)."""
        device = self.ring.model_device if device is None else device
        if self.ring.distributed:
            whole = _Gather.apply(self, device, *[t for row in self.blocks for t in row
                                                 if t is not None])
        else:
            whole = torch.cat([torch.cat([t.to(device) for t in row], dim=self.axis)
                               for row in self.blocks], dim=0)
        g = self.ring.g
        if samples > 1 and g > 1:  # group-major (G, s, r) rows -> sample-major
            rest = tuple(whole.shape[1:])
            whole = whole.reshape((g, samples, -1) + rest).transpose(0, 1).reshape((-1,) + rest)
        if self.lead is not None and samples == 1:
            whole = whole.reshape(self.lead + tuple(whole.shape[1:]))
        return whole

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, axis={self.axis}, blocks={self.ring.g}x"
                f"{self.ring.k})")


class _Gather(torch.autograd.Function):
    """Every block broadcast from its owner, concatenated on ``device`` (row
    groups along the rows, in group order); the backward keeps the slices
    of this rank's blocks (every rank computes
    the same function of the whole tensor, so no gradient crosses)."""

    @staticmethod
    def forward(ctx, sh, device, *owned):
        import torch.distributed as dist

        like = owned[0]
        it = iter(owned)
        rows = []
        for i in range(sh.ring.g):
            parts = []
            for j in range(sh.ring.k):
                if sh.ring.owned[i][j]:
                    buf = next(it).to(device).contiguous()
                else:
                    buf = torch.empty(like.shape, dtype=like.dtype, device=device)
                dist.broadcast(buf, src=sh.ring.ranks[i][j])
                parts.append(buf)
            rows.append(torch.cat(parts, dim=sh.axis))
        ctx.sh, ctx.devs = sh, [t.device for t in owned]
        ctx.m = like.shape[sh.axis]
        return torch.cat(rows, dim=0)

    @staticmethod
    def backward(ctx, g):
        sh, m = ctx.sh, ctx.m
        r = g.shape[0] // sh.ring.g
        outs = []
        it = iter(ctx.devs)
        for i in range(sh.ring.g):
            for j in range(sh.ring.k):
                if sh.ring.owned[i][j]:
                    outs.append(g.narrow(0, i * r, r).narrow(sh.axis, j * m, m).to(next(it)))
        return (None, None, *outs)


def broadcast_from(ring: Ring, t: torch.Tensor | None, owner: tuple, like) -> torch.Tensor:
    """``t`` (held by block ``owner``'s process) on every rank's local
    device; one broadcast across processes, ``t`` itself in one process.
    ``like``: a tensor of the same shape and dtype on every rank."""
    if not ring.distributed:
        return t
    import torch.distributed as dist

    src = ring.ranks[owner[0]][owner[1]]
    buf = (t.to(ring.local_device).contiguous().clone() if ring.rank == src
           else torch.empty(like.shape, dtype=like.dtype, device=ring.local_device))
    dist.broadcast(buf, src=src)
    return buf


def _check_batch_divisible(n: int, mesh: Mesh, batch_axis: str | None):
    """Eager guard for the batch_axis contract (the reference's message)."""
    if batch_axis is not None and n % mesh.shape[batch_axis]:
        raise ValueError(
            f"flattened leading axis {n} is not divisible by "
            f"{batch_axis}={mesh.shape[batch_axis]}: batch_axis sharding "
            "needs the (product of) leading dims divisible by that mesh "
            "axis; reshape, pad, or drop batch_axis"
        )


def _check_seq_divisible(n: int, ring: Ring, level: int, what: str):
    """Every level's blocks must stay even (the periodized transforms halve
    them): ``n`` divisible by shards * 2^level."""
    step = ring.k * 2 ** level
    if n % step:
        raise ValueError(f"{what} length {n} is not divisible by shards*2^level={step}")


# -- per-block 1D kernels --------------------------------------------------------------


def _gmap(fn, *grids):
    """``fn`` over the matching owned blocks of grids."""
    return [[None if row[0][j] is None else fn(*(r[j] for r in row)) for j in range(len(row[0]))]
            for row in (list(rows) for rows in zip(*grids))]


class _FullSynthesis(torch.autograd.Function):
    """(R, 2, n) -> (R, 1, 2n + L - 2): the transposed stride-2 correlation
    (the adjoint of the analysis, untrimmed); backward the correlation.
    Both directions in full float32."""

    @staticmethod
    def forward(ctx, sub, bank):
        ctx.save_for_backward(bank)
        with _f32_convs():
            return F.conv_transpose1d(sub, bank, stride=2)

    @staticmethod
    def backward(ctx, g):
        (bank,) = ctx.saved_tensors
        with _f32_convs():
            return F.conv1d(g, bank, stride=2), None


def _float(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.dtype == torch.bfloat16 else t


def _dwt_halo(grid, wav, ring: Ring):
    """One periodized level along the LAST axis of every block (..., m):
    the L - 2 samples before the block round the ring prepended, then the
    stride-2 correlation. Returns (cA grid, cD grid), each (..., m/2)."""
    need = wav.filt_len - 2
    if need > 0:
        halos, grid = ring.prev_halo(grid, need)
        ext = _gmap(lambda h, t: torch.cat([h, t], dim=-1), halos, grid)
    else:
        ext = grid

    def one(e, t):
        out = _Analysis.apply(e.reshape(-1, 1, e.shape[-1]),
                              _bank(wav, 1, e.dtype, e.device, rec=False))
        out = out.reshape(tuple(t.shape[:-1]) + (2, t.shape[-1] // 2))
        return out[..., 0, :], out[..., 1, :]

    pairs = _gmap(one, ext, grid)
    return _gmap(lambda p: p[0], pairs), _gmap(lambda p: p[1], pairs)


def _idwt_halo(a_grid, d_grid, wav, ring: Ring):
    """Adjoint (= inverse) of `_dwt_halo`: each block's untrimmed transposed
    correlation, whose first L - 2 samples belong before the block and are
    added onto its predecessors' ends (the halo from the successor)."""
    need = wav.filt_len - 2

    def full(a, d):
        sub = torch.stack([a, d], dim=-2)
        out = _FullSynthesis.apply(sub.reshape(-1, 2, sub.shape[-1]),
                                   _bank(wav, 1, sub.dtype, sub.device, rec=False))
        return out.reshape(tuple(a.shape[:-1]) + (out.shape[-1],))

    fulls = _gmap(full, a_grid, d_grid)
    if need <= 0:
        return fulls
    m = 2 * _first(a_grid).shape[-1]
    hops = -(-need // m)
    adds = []
    for t in range(1, hops + 1):
        h0 = max(0, need - t * m)
        pieces, fulls = ring.shift(fulls, t, h0, need - (t - 1) * m - h0)
        adds.append((t * m - need + h0, pieces))
    out = _gmap(lambda f: f[..., need:], fulls)
    for q0, pieces in adds:
        out = _gmap(lambda x, p, q0=q0: torch.cat([x[..., :q0], x[..., q0:] + p], dim=-1),
                    out, pieces)
    return out


def _along(grid, axis: int, fn):
    """``fn`` (a grid 1D level along the last axis, two outputs) along
    ``axis`` of every block."""
    a, d = fn(_gmap(lambda t: t.movedim(axis, -1), grid))
    back = lambda t: t.movedim(-1, axis)  # noqa: E731
    return _gmap(back, a), _gmap(back, d)


def _inverse_along(a, d, axis: int, fn):
    out = fn(_gmap(lambda t: t.movedim(axis, -1), a), _gmap(lambda t: t.movedim(axis, -1), d))
    return _gmap(lambda t: t.movedim(-1, axis), out)


def _level_per(grid, wav, ring: Ring, ndim: int):
    """One periodized analysis level of every block, the sharded axis
    (first of the trailing ``ndim``) through the halo, the others local
    (`wavelets.periodized`): (cA grid, details) with the single-device
    transforms' subband names."""
    halo = lambda g: _dwt_halo(g, wav, ring)  # noqa: E731
    one = lambda t: _per.dwt_per(t, wav)  # noqa: E731
    if ndim == 1:
        a, d = halo(grid)
        return a, d
    if ndim == 2:
        aH, dH = _along(grid, -2, halo)
        aa, ad = _gmap(lambda t: one(t)[0], aH), _gmap(lambda t: one(t)[1], aH)
        da, dd = _gmap(lambda t: one(t)[0], dH), _gmap(lambda t: one(t)[1], dH)
        return aa, Detail2D(horizontal=da, vertical=ad, diagonal=dd)
    out = {}
    aD, dD = _along(grid, -3, halo)
    for dl, arr in (("a", aD), ("d", dD)):
        pairs = _gmap(lambda t: _per._along(t, -2, one), arr)
        for hl, k in (("a", 0), ("d", 1)):
            h = _gmap(lambda p, k=k: p[k], pairs)
            w = _gmap(one, h)
            out[dl + hl + "a"] = _gmap(lambda p: p[0], w)
            out[dl + hl + "d"] = _gmap(lambda p: p[1], w)
    return out.pop("aaa"), out


def _inverse_per(a, det, wav, ring: Ring, ndim: int):
    """Inverse of `_level_per` (its adjoint): the local axes first, then the
    sharded one through the reversed halo."""
    halo = lambda x, y: _idwt_halo(x, y, wav, ring)  # noqa: E731
    one = lambda x, y: _per.idwt_per(x, y, wav)  # noqa: E731
    if ndim == 1:
        return halo(a, det)
    if ndim == 2:
        aH = _gmap(one, a, det.vertical)
        dH = _gmap(one, det.horizontal, det.diagonal)
        return _inverse_along(aH, dH, -2, halo)
    sub = {"aaa": a, **det}
    by_d = {}
    for dl in "ad":
        by_h = {hl: _gmap(one, sub[dl + hl + "a"], sub[dl + hl + "d"]) for hl in "ad"}
        by_d[dl] = _gmap(lambda x, y: _per._inverse_along(x, y, -2, wav), by_h["a"], by_h["d"])
    return _inverse_along(by_d["a"], by_d["d"], -3, halo)


def _wrap(tree, axis: int, ring: Ring, lead):
    """Grids of a coefficient tree as `Sharded` leaves."""
    def one(grid):
        return Sharded(grid, axis, ring, lead)

    out = []
    for c in tree:
        if isinstance(c, Detail2D):
            out.append(Detail2D(*(one(f) for f in c)))
        elif isinstance(c, dict):
            out.append({k: one(v) for k, v in c.items()})
        else:
            out.append(one(c))
    return out


def _grids(c):
    """The grid of one leaf or of each field of a detail level."""
    if isinstance(c, Detail2D):
        return Detail2D(*(f.blocks for f in c))
    if isinstance(c, dict):
        return {k: v.blocks for k, v in c.items()}
    return c.blocks


def _sharded_input(x, ring: Ring, ndim: int) -> Sharded:
    """The transforms' input as `Sharded` blocks, bf16 read as float32 (the
    framework's bf16-in / f32-accumulate rule)."""
    if isinstance(x, Sharded):
        return x.map_blocks(_float)
    x = _float(x)
    return Sharded.split(x, ring, -ndim, lead_dims=x.ndim - ndim)


def _wavedec_per_nd(mesh: Mesh, wavelet, level: int, seq_axis: str, ndim: int,
                    batch_axis: str | None, what: str):
    wav = _resolve(wavelet)
    ring = Ring(mesh, seq_axis, batch_axis)

    def check(x):
        lead = math.prod(x.shape[:-ndim]) if len(x.shape) > ndim else 1
        _check_batch_divisible(lead, mesh, batch_axis)
        _check_seq_divisible(x.shape[-ndim], ring, level, what)

    def apply(x):
        sx = _sharded_input(x, ring, ndim)
        coeffs = []
        a = sx.blocks
        for _ in range(level):
            a, det = _level_per(a, wav, ring, ndim)
            coeffs.append(det)
        coeffs.append(a)
        return _wrap(coeffs[::-1], -ndim, ring, sx.lead)

    def run(x):
        check(x)
        return apply(x)

    run._apply, run._check, run.ring = apply, check, ring
    return run


def sharded_dwt_per(mesh: Mesh, wavelet, seq_axis: str = "data"):
    """``(x,) -> (cA, cD)`` single-level sharded periodized DWT: x (..., N)
    split over ``seq_axis`` on its last axis, both outputs `Sharded` the
    same way. Matches `wavelets.periodized.dwt_per`."""
    dec = sharded_wavedec_per(mesh, wavelet, 1, seq_axis)

    def run(x):
        cA, cD = dec(x)
        return cA, cD

    run.ring = dec.ring
    return run


def sharded_wavedec_per(mesh: Mesh, wavelet, level: int, seq_axis: str = "data",
                        batch_axis: str | None = None):
    """Multi-level sharded periodized decomposition ``x -> [cA_J, cD_J, ...,
    cD_1]``: x (..., N), every leaf `Sharded` over ``seq_axis`` on its last
    axis (``.gather()`` is `periodized.wavedec_per`'s array). N must divide
    by shards * 2^level. ``batch_axis`` also splits the flattened leading
    axis over that mesh axis (it must divide; checked eagerly)."""
    return _wavedec_per_nd(mesh, wavelet, level, seq_axis, 1, batch_axis, "sequence axis")


def sharded_wavedec2_per(mesh: Mesh, wavelet, level: int, seq_axis: str = "data",
                         batch_axis: str | None = None):
    """Multi-level 2D sharded periodized decomposition for x (..., H, W), H
    over ``seq_axis``: `periodized.wavedec2_per`'s leaves as `Sharded`.
    H must divide by shards * 2^level, W by 2^level."""
    return _wavedec_per_nd(mesh, wavelet, level, seq_axis, 2, batch_axis, "row axis")


def sharded_wavedec3_per(mesh: Mesh, wavelet, level: int, seq_axis: str = "data",
                         batch_axis: str | None = None):
    """Multi-level 3D sharded periodized decomposition for x (..., D, H, W),
    D over ``seq_axis``: `periodized.wavedec3_per`'s leaves as `Sharded`."""
    return _wavedec_per_nd(mesh, wavelet, level, seq_axis, 3, batch_axis, "depth axis")


def _waverec_per_nd(mesh: Mesh, wavelet, seq_axis: str, ndim: int, batch_axis: str | None):
    wav = _resolve(wavelet)
    ring = Ring(mesh, seq_axis, batch_axis)

    def check(coeffs):
        lead = coeffs[0].lead
        _check_batch_divisible(math.prod(lead) if lead else 1, mesh, batch_axis)

    def apply(coeffs):
        a = coeffs[0].blocks
        for det in coeffs[1:]:
            a = _inverse_per(a, _grids(det), wav, ring, ndim)
        return Sharded(a, -ndim, ring, coeffs[0].lead)

    def run(coeffs):
        check(coeffs)
        return apply(coeffs)

    run._apply, run._check, run.ring = apply, check, ring
    return run


def sharded_waverec_per(mesh: Mesh, wavelet, seq_axis: str = "data",
                        batch_axis: str | None = None):
    """Inverse of `sharded_wavedec_per`: the `Sharded` coefficient list back
    to the `Sharded` (..., N) signal (`periodized.waverec_per`)."""
    return _waverec_per_nd(mesh, wavelet, seq_axis, 1, batch_axis)


def sharded_waverec2_per(mesh: Mesh, wavelet, seq_axis: str = "data",
                         batch_axis: str | None = None):
    """Inverse of `sharded_wavedec2_per` (rows sharded)."""
    return _waverec_per_nd(mesh, wavelet, seq_axis, 2, batch_axis)


def sharded_waverec3_per(mesh: Mesh, wavelet, seq_axis: str = "data",
                         batch_axis: str | None = None):
    """Inverse of `sharded_wavedec3_per` (depth sharded)."""
    return _waverec_per_nd(mesh, wavelet, seq_axis, 3, batch_axis)


def _objective(out: torch.Tensor, y) -> torch.Tensor:
    """The reference's objective of the coefficient-gradient cores: the sum
    of logit[b, y[b]], or the mean of the logits when y is None."""
    if y is None:
        return out.mean()
    return out.gather(1, torch.as_tensor(y, device=out.device).reshape(-1, 1).long()).sum()


def coeff_grads(coeffs, rec_signal, model_fn, y):
    """Gradient of `_objective` of ``model_fn(rec_signal(coeffs))`` with
    respect to every block and tail of ``coeffs`` (zeros for a tail the
    loss does not reach), in the coefficients' structure."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(coeffs)]
    it = iter(leaves)
    cs = tree_map(lambda _: next(it), coeffs)
    with torch.enable_grad():
        loss = _objective(model_fn(rec_signal(cs)), y)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)])
    return tree_map(lambda _: next(it), coeffs)


def sharded_coeff_grads_per(mesh: Mesh, wavelet, level: int, model_fn, seq_axis: str = "data",
                            ndim: int = 1):
    """Long-context WAM gradient core over a sequence-sharded input:
    decompose -> reconstruct -> model -> the gradient of sum(logits[b, y[b]])
    (the mean of the logits when y is None) with respect to every
    coefficient, each gradient leaf `Sharded` as its coefficient. ``ndim``:
    1 waveform, 2 image rows, 3 volume depth. The model runs on the whole
    reconstruction, gathered on the ring's model device (PyTorch does not
    partition a module over the sequence axis)."""
    if ndim not in (1, 2, 3):
        raise ValueError(f"ndim must be 1, 2, or 3; got {ndim!r}")
    dec = _wavedec_per_nd(mesh, wavelet, level, seq_axis, ndim, None,
                          {1: "sequence axis", 2: "row axis", 3: "depth axis"}[ndim])
    rec = _waverec_per_nd(mesh, wavelet, seq_axis, ndim, None)

    def step(x, y=None):
        with torch.no_grad():
            coeffs = dec(x)
        return coeff_grads(coeffs, lambda cs: rec(cs).gather(), model_fn, y)

    step._dec, step._rec = dec, rec
    return step
