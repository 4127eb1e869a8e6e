#!/usr/bin/env python3
"""Whether `torch.profiler` captures of the audio path's call leave the
process's later captures without device events.

    python3 scripts/torch_profiler_repro.py [--captures K]

On the card this has been seen in `chip_smoke.py`: after phase esc50
profiled the audio call under each 1D transform in the script's own
process, phase pod's later capture of its entry held no device event (two
whole runs), so esc50 now profiles in a child process. This script does the
same two things and nothing between them. It sets up the audio path as
chip_smoke.py does (`build_audio`, `audio_wam`: AudioCNN with 50 classes,
8 x 220,500 samples, db6, J=5, n=50), makes one warm call and one call under
`profiling.profile_to` for each of "conv", "folded" and "folded_nhc" (read
back through `profiling.named_op_split`, as phase esc50 read them). Then it
makes K captures with `torch.profiler.profile` of phase pod's in-process
entry (`pod.worker.toy_wam(n=25)`, a batch of 8 seeded 3x224x224 images,
the port's K1 and K3 kernels), each read by `profiling.kernel_events`.

Prints one JSON line: the device events of each capture, and ``"reproduced"``,
whether a later capture held none. Exits 1 when it did (the fault is still
there), 0 when every capture held device events. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--captures", type=int, default=5,
                        help="captures of the pod entry after the audio captures")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_profiler_repro: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import wam_tpu_torch as wtt
    from torch.profiler import ProfilerActivity, profile
    from wam_tpu_torch import kernels
    from wam_tpu_torch.pod.worker import toy_wam
    from wam_tpu_torch.profiling import kernel_events, named_op_split, profile_to
    from wam_tpu_torch.wavelets import transform as tt

    kernels.build_all()
    card = torch.device(chip_smoke.DEVICE)
    _, fn, x, y = chip_smoke.build_audio(torch, wtt)
    wam = chip_smoke.audio_wam(wtt, fn, card)
    audio = {}
    for impl in chip_smoke.ESC50_IMPLS:
        tt.set_dwt1_impl(impl)
        wam(x, y)
        with tempfile.TemporaryDirectory() as logdir:
            with profile_to(logdir):
                wam(x, y)
                torch.cuda.synchronize()
            split = named_op_split(logdir, tokens=(tt.SPAN_1D,))
        audio[impl] = None if split is None else split[tt.SPAN_1D] * 1e3
    tt.set_dwt1_impl("auto")

    entry = toy_wam(chip_smoke.N_SAMPLES, card).serve_entry(donate=False)
    g = torch.Generator().manual_seed(chip_smoke.SEED)
    xs = torch.randn(chip_smoke.POD_MAX_BATCH, 3, chip_smoke.POD_SIDE, chip_smoke.POD_SIDE,
                     generator=g).to(card)
    ys = torch.zeros(chip_smoke.POD_MAX_BATCH, dtype=torch.int32, device=card)
    entry(xs, ys)
    torch.cuda.synchronize()
    later = []
    for _ in range(args.captures):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            entry(xs, ys)
            torch.cuda.synchronize()
        events = kernel_events(prof)
        later.append(None if events is None else len(events))
    reproduced = any(not n for n in later)
    print(json.dumps({"audio_dwt1_device_ms": audio, "later_device_events": later,
                      "reproduced": reproduced,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 1 if reproduced else 0


if __name__ == "__main__":
    sys.exit(main())
