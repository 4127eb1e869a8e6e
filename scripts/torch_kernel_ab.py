#!/usr/bin/env python3
"""Times the wavelet kernels of two or more checkouts of the port, in turns.

    python3 scripts/torch_kernel_ab.py DIR [DIR ...]

Each DIR is the root of a checkout (for example the parent commit unpacked
with ``git archive`` into a git-ignored directory). The checkouts run in the
order given, each in its own process that imports ``wam_tpu_torch`` from
that DIR and builds its kernels there, so list them as A B B A to see the
spread. Each process times K1 at the flagship's three analysis levels and
K3 forward and backward (float32, one sample chunk of images per launch, the
inputs made from one seed) with CUDA events, and the script prints one JSON
line per process and a last line with the card. The flagship's constants and
the timer come from that DIR's own ``chip_smoke.py``, so every checkout is
timed at the shapes and in the way its smoke test states. Needs one CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def one(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from wam_tpu_torch import kernels
    from wam_tpu_torch.wavelets import matmul as tmm
    from wam_tpu_torch.wavelets import transform as tt
    from wam_tpu_torch.wavelets.filters import build_wavelet

    for mod in (cs, kernels):
        assert Path(mod.__file__).resolve().is_relative_to(Path(root).resolve())
    kernels.build_all()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    n = cs.SAMPLE_CHUNK * cs.BATCH * cs.CHANNELS
    w = build_wavelet(cs.WAVELET)
    taps = (tuple(w.dec_lo), tuple(w.dec_hi), cs.MODE)

    def time_ms(fn):
        return cs._time_ms(fn, iters=50, warmup=5)

    res = {"tree": root}
    x = torch.randn((n, cs.SIDE, cs.SIDE), generator=g, device=dev)
    for level in range(1, cs.LEVELS + 1):
        _, At = tmm._kernel_analysis(x.shape[-1], *taps, dev)
        res[f"K1_level{level}_ms"] = time_ms(lambda: kernels.dwt2(x, At, At))
        x = kernels.dwt2(x, At, At)[:, 0].contiguous()
    imgs = torch.randn((n // cs.CHANNELS, cs.CHANNELS, cs.SIDE, cs.SIDE), generator=g,
                       device=dev)
    coeffs = tt.wavedec2(imgs, cs.WAVELET, cs.LEVELS, cs.MODE, impl="matmul")
    R, Rt, C, Ct = tmm.collapsed_operators(coeffs[1:], cs.WAVELET, dev)
    y3 = tmm.assemble_collapsed(coeffs[0], coeffs[1:]).reshape(n, Rt.shape[0], Ct.shape[0])
    gout = torch.randn((n, R.shape[0], C.shape[0]), generator=g, device=dev)
    res["K3_forward_ms"] = time_ms(lambda: kernels.pair(y3, Rt, Ct))
    res["K3_backward_ms"] = time_ms(lambda: kernels.pair(gout, R, C))
    return res


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    for root in sys.argv[1:]:
        proc = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
