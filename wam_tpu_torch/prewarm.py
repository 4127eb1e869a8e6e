"""Cache prewarm CLI — one command to pay every cold cost offline (PyTorch
port of `wam_tpu.prewarm`).

    python -m wam_tpu_torch.prewarm --config flagship          # on the card
    python -m wam_tpu_torch.prewarm --config toy --device cpu  # CPU smoke

A serving process that compiles on its hot path blows its first requests'
deadlines. This CLI populates the persistent layers in one run:

- the **compile cache** (`config.enable_compilation_cache`:
  ``$WAM_TPU_CACHE_DIR`` or ``~/.cache/wam_tpu/inductor``: Inductor's,
  AOTAutograd's and Triton's) by compiling and running the config's runner
  once, at the schedule production resolves: the tuned schedule-cache entry
  when one exists, else the 128-row rule (the chunk of samples that gives
  128 model rows a call);
- the **schedule cache** (`wam_tpu_torch.tune`), loaded before the compile,
  as `AttributionServer.start()` does;
- the **compiled-step cache** (`wam_tpu_torch.pipeline.aot`,
  ``~/.cache/wam_tpu/aot``) under a key derived from the schedule-cache key
  plus the resolved schedule: a later process with the same config loads
  the compiled steps instead of compiling (``--no-aot`` opts out: the
  runner then runs eager; the JSON line reports exported / hit /
  registry_hit / fallback / disabled).

The 2D presets run their chunk steps compiled (one program per chunk
shape; the noise draws and the loop over chunks stay eager) on the
``nchw`` layout, where the kernels run: the flagship's steps launch K1 and
K3 as its eager call does. ``--device auto`` takes the card or raises.

Prints ONE JSON summary line with the reference's keys, except that the
reference's ``xla_cache_dir`` is ``compile_cache_dir`` here, plus
``aot_key`` (the runner's key, which a server's ``serve_entry(aot_key=)``
takes to load the same programs), ``aot_steps`` (each compiled step's key,
status and compiles) and ``compiles``; ``--manifest`` also writes it, with the ``warmed`` block
``python -m wam_tpu_torch.registry publish --from-prewarm`` reads.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# the worst status of a runner's compiled steps is the runner's
_STATUS_ORDER = ("fallback", "miss", "exported", "disabled", "registry_hit", "hit")


def _runner_status(fns) -> str:
    statuses = {f.aot_status for d in fns for f in d.fns.values()}
    for status in _STATUS_ORDER:
        if status in statuses:
            return status
    return "fallback"  # nothing was compiled


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m wam_tpu_torch.prewarm",
        description="Populate the compile, schedule and compiled-step caches.")
    p.add_argument("--config", default="flagship",
                   help="workload preset: flagship | toy | mu2d (wam_tpu_torch.tune.workloads)")
    p.add_argument("--device", default="auto", help="auto | cuda | cpu (auto: the card or raise)")
    p.add_argument("--batch", type=int, default=None, help="override the preset's batch size")
    p.add_argument("--no-aot", action="store_true",
                   help="skip the compiled-step cache (the runner runs eager)")
    p.add_argument("--manifest", default=None, metavar="PATH",
                   help="also write the JSON summary (with its 'warmed' block) to this "
                        "file, the handoff `python -m wam_tpu_torch.registry publish "
                        "--from-prewarm` reads")
    args = p.parse_args(argv)

    from wam_tpu_torch.config import enable_compilation_cache

    compile_dir = enable_compilation_cache()

    from wam_tpu_torch.device import resolve_device
    from wam_tpu_torch.pipeline import aot as aot_cache
    from wam_tpu_torch.profiling import device_sync
    from wam_tpu_torch.registry.bundle import platform_fingerprint
    from wam_tpu_torch.tune import load_schedule_cache, lookup_schedule, schedule_key
    from wam_tpu_torch.tune.autotuner import Candidate
    from wam_tpu_torch.tune.cache import SCHEDULE_CACHE_VERSION
    from wam_tpu_torch.tune.workloads import _synth, get_workload

    dev = resolve_device(None if args.device == "auto" else args.device)
    cache = load_schedule_cache()  # the pre-compile load serve warmup makes
    overrides = {"device": dev} if args.batch is None else {"device": dev, "batch": args.batch}
    wl = get_workload(args.config, **overrides)

    # the schedule production runs: the tuned entry, else the 128-row rule;
    # the nchw layout, where the 2D presets' kernels run
    ent = lookup_schedule(wl.workload, wl.shape, wl.batch, wl.dtype, backend=dev.type) or {}
    chunk = ent["sample_chunk"] if "sample_chunk" in ent else max(1, 128 // wl.batch)
    cand = Candidate(sample_chunk=chunk, stream_noise=ent.get("stream_noise"),
                     synth_impl=ent.get("synth_impl"), layout=ent.get("layout") or "nchw",
                     fan_cap=ent.get("fan_cap", 128))
    fn, wargs = wl.build(cand)
    synth = _synth(cand, dev)
    bucket = schedule_key(wl.workload, wl.shape, wl.batch, wl.dtype, backend=dev.type)

    runner, fns, aot_key = fn, [], None
    if not args.no_aot:
        # the key extends the schedule key with the resolved schedule: a
        # retune that changes the chunk or the noise mode changes the key.
        # The presets seed their models' init, so the key names the
        # parameters too (the `pipeline.aot` keying contract).
        aot_key = "|".join((
            "prewarm", bucket, f"chunk{chunk}", f"stream{ent.get('stream_noise')}",
            f"synth{synth}", aot_cache.aval_signature(wargs)))

        def record(d):
            fns.append(d)
            return d

        make = getattr(fn, "wam_aot", None)
        if make is not None:
            runner = make(aot_key, obs_kind="prewarm", record=record)
        else:
            runner = record(aot_cache.cached_entry(fn, aot_key, obs_kind="prewarm"))

    t0 = time.perf_counter()
    device_sync(runner(*wargs))  # compile (or load the compiled steps) + one run
    warm_s = time.perf_counter() - t0

    steps = [{"key": f.key, "aot": f.aot_status, "compiles": f.compiles, "error": f.error}
             for d in fns for f in d.fns.values()]
    status = "disabled" if args.no_aot else _runner_status(fns)
    summary = {
        "config": wl.name,
        "backend": dev.type,
        "batch": wl.batch,
        "sample_chunk": chunk,
        "stream_noise": ent.get("stream_noise"),
        "synth_impl": synth,
        "schedule_entries": len(cache.entries),
        "schedule_stale_files": cache.stale_files,
        "compile_cache_dir": compile_dir,
        "aot": status,
        "aot_key": aot_key,
        "aot_cache_dir": aot_cache.default_aot_dir(),
        "warm_s": round(warm_s, 3),
        "aot_steps": steps,
        "compiles": sum(s["compiles"] for s in steps),
        "warmed": {
            "bucket_keys": [bucket],
            "aot_keys": [s["key"] for s in steps],
            "schedule_version": SCHEDULE_CACHE_VERSION,
            "platform": platform_fingerprint(dev.type),
        },
    }
    line = json.dumps(summary)
    print(line)
    if args.manifest:
        with open(args.manifest, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
