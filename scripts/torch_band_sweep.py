#!/usr/bin/env python3
"""Times K1, K2 and K3 on the card against the shared-memory target of their
band plans, the knob that sets a tile's row pairs and so how many blocks
share an SM.

    python3 scripts/torch_band_sweep.py [TARGET_BYTES ...]

For each target (default: two, three, four and six blocks per SM) it
builds the band plans (`wam_tpu_torch.wavelets.matmul`, ``smem_target``)
of K1 at the flagship's and path 2's three analysis levels and of K2
forward and K2's backward at path 2's finest synthesis level, and of K3
forward and backward at each path's collapsed levels (on leaves that are
views of K1's output; two stages a block and one), checks each launch against its dense plain version,
and times it: device time under
`torch.profiler` and CUDA-event time (host launch gaps included), float32,
one sample chunk of images per launch, inputs from one seed. Prints one
JSON line per target (with each plan's rows per tile, staged rows and
shared memory) and the card. Needs one CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from torch_kernel_ab import _device_ms
    from wam_tpu_torch import kernels
    from wam_tpu_torch.wavelets import matmul as tmm
    from wam_tpu_torch.wavelets.filters import build_wavelet

    kernels.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(cs.DEVICE)
    per_sm = 228 * 1024
    targets = [int(a) for a in sys.argv[1:]] or [per_sm // b - 1024 for b in (2, 3, 4, 6)]
    n = cs.SAMPLE_CHUNK * cs.BATCH * cs.CHANNELS
    w = build_wavelet(cs.WAVELET)
    dec, rec = (tuple(w.dec_lo), tuple(w.dec_hi)), (tuple(w.rec_lo), tuple(w.rec_hi))
    g = torch.Generator(device=dev).manual_seed(cs.SEED)

    cases = []  # (name, launcher, input, plan at a target, dense reference)
    for tag, side in (("flagship", cs.SIDE), ("path2", cs.SIDE2)):
        x = torch.randn((n, side, side), generator=g, device=dev)
        for level in range(1, cs.LEVELS + 1):
            q = x.shape[-1]
            _, At = tmm._kernel_analysis(q, *dec, cs.MODE, dev)
            cases.append((f"K1_{tag}_level{level}", kernels.dwt2, x,
                          lambda t, q=q: tmm._dwt2_plan_np(q, q, *dec, cs.MODE, t),
                          tmm.dwt2_plain(x, At, At)))
            x = cases[-1][-1][:, 0].contiguous()
    h = (cs.SIDE2 + w.filt_len - 1) // 2
    Sr, _ = tmm._kernel_synthesis(h, *rec, dev)
    _, Sct = tmm._kernel_synthesis(h, *rec, dev)
    sub = torch.randn((n, 4, h, h), generator=g, device=dev)
    gout = torch.randn((n, Sr.shape[0], Sr.shape[0]), generator=g, device=dev)
    cases.append(("K2_forward", kernels.synth2, sub,
                  lambda t: tmm._idwt2_plan_np(h, h, *rec, False, t),
                  tmm.idwt2_plain(sub, Sr, Sct)))
    cases.append(("K2_backward", kernels.dwt2, gout,
                  lambda t: tmm._idwt2_plan_np(h, h, *rec, True, t),
                  tmm.dwt2_plain(gout, Sr, Sr)))

    from wam_tpu_torch.wavelets import transform as tt

    k3 = []  # (tag, leaves, rows, cols, forward reference, g, backward reference)
    for tag, side in (("flagship", cs.SIDE), ("path2", cs.SIDE2)):
        imgs = torch.randn((n // cs.CHANNELS, cs.CHANNELS, side, side), generator=g, device=dev)
        coeffs = tt.wavedec2(imgs, cs.WAVELET, cs.LEVELS, cs.MODE, impl="kernel")
        dets = coeffs[1:][:tt._collapse_count(coeffs[1:])]
        leaves = [tmm._leaf3(t) for t in [coeffs[0]] + [t for d in dets for t in d]]
        rs = tuple(d.horizontal.shape[-2] for d in dets)
        cols = tuple(d.horizontal.shape[-1] for d in dets)
        R, Rt, C, Ct = tmm.collapsed_operators(dets, cs.WAVELET, dev)
        y = tmm.assemble_collapsed(leaves[0], [tt.Detail2D(*leaves[1 + 3 * i:4 + 3 * i])
                                               for i in range(len(dets))])
        gk = torch.randn((n, R.shape[0], C.shape[0]), generator=g, device=dev)
        k3.append((tag, leaves, rs, cols, tmm.pair_plain(y, Rt, Ct), gk, tmm.pair_plain(gk, R, C)))
        del y

    def k3_check(name, got, want):
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= cs.KERNEL_RTOL * max(1.0, float(want.abs().max())):
            raise AssertionError(f"{name}: max abs err {err:.3e}")

    for target in targets:
        row = {"smem_target": target}
        for (tag, leaves, rs, cols, want, gk, dy), st in (
                (case, st) for case in k3 for st in (2, 1)):
            fwd, bwd = tmm.pair_band(rs, cols, *rec, dev, target, (st, st))
            k3_check(f"K3_{tag}_forward at {target}", kernels.pair(leaves, fwd), want)
            grads, off_r, off_c = kernels.pair_bwd(gk, bwd), 0, 0
            for i, (r, c) in enumerate(zip(rs, cols)):  # the leaves' blocks of dY
                blk = dy[:, off_r:off_r + 2 * r, off_c:off_c + 2 * c]
                quads = ([blk[:, :r, :c]] if i == 0 else []) + [
                    blk[:, r:, :c], blk[:, :r, c:], blk[:, r:, c:]]
                for q, got in zip(quads, grads[(1 if i else 0) + 3 * i:4 + 3 * i]):
                    k3_check(f"K3_{tag}_backward at {target}", got, q)
                off_r, off_c = off_r + 2 * r, off_c + 2 * c
            for name, fn, plan in (
                    (f"K3_{tag}_forward_{st}stage", lambda: kernels.pair(leaves, fwd), fwd),
                    (f"K3_{tag}_backward_{st}stage", lambda: kernels.pair_bwd(gk, bwd), bwd)):
                row[name] = {"ms": cs._time_ms(fn, iters=50, warmup=5),
                             "device_ms": _device_ms(torch, fn), "threads": plan.threads,
                             "rt": [lv.rt for lv in plan.levels],
                             "sm": [lv.sm for lv in plan.levels], "smem_bytes": plan.smem_bytes()}
        for name, launch, x, build, want in cases:
            plan = tmm._device_plan(build(target), dev)
            got = launch(x, plan)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not err <= cs.KERNEL_RTOL * max(1.0, float(want.abs().max())):
                raise AssertionError(f"{name} at target {target}: max abs err {err:.3e}")
            row[name] = {"ms": cs._time_ms(lambda: launch(x, plan), iters=50, warmup=5),
                         "device_ms": _device_ms(torch, lambda: launch(x, plan)),
                         "rt": plan.rt, "sm": plan.sm, "stages": plan.stages,
                         "smem_bytes": plan.smem_bytes()}
        for tag in ("flagship", "path2"):
            row[f"K1_{tag}_chunk_device_ms"] = sum(row[f"K1_{tag}_level{lv}"]["device_ms"]
                                                   for lv in range(1, cs.LEVELS + 1))
        row["K1_path2_chunk_device_ms"] += row["K2_backward"]["device_ms"]
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
