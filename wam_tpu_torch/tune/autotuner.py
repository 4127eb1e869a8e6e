"""Schedule autotuner: measure candidate schedules, crown one, persist it
(PyTorch port of `wam_tpu.tune.autotuner`).

A workload preset (`wam_tpu_torch.tune.workloads`) builds a runner per
`Candidate` (sample chunk, stream_noise, transform impls, layout, eval fan
cap / fan chunk, ...). Each runner is measured on the card's clock first
(`profiling.device_time_samples`: CUDA events around regions of warm
calls, plane ``"device"``) and on the host clock where no card is involved
(`profiling.bench_samples`, plane ``"wall"``: the CPU, the ``--dry-run``
smoke). Every result row also records the peak memory the candidate
allocated on the card (``torch.cuda.max_memory_allocated`` after a reset,
None on the CPU) and its kernel launches a call (`kernels.launch_counts`).
The winner (least median) is persisted to the schedule cache that the
"auto" readers consult (`wam_tpu_torch.tune.cache`).

CLI: ``python -m wam_tpu_torch.tune --workload flagship`` (see `__main__`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

__all__ = ["Candidate", "chunk_candidates", "measure_candidate", "autotune"]


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point in the schedule space. ``None`` fields mean "workload
    default" and are left out of the persisted entry, except
    ``sample_chunk``, where None IS the value (every sample at once, as
    `core.estimators.resolve_sample_chunk` reads it)."""

    sample_chunk: int | None = None
    stream_noise: bool | None = None
    dwt_impl: str | None = None
    synth_impl: str | None = None  # synthesis impl (the explainers' synth_impl=)
    layout: str | None = None  # "nhwc" | "nchw" (2D engines)
    fan_cap: int | None = None  # evaluation fan cap (eval workloads)
    fan_chunk: int | None = None  # eval images-a-chunk override
    seq_fused: bool | None = None  # sequence-sharded fused step or split loop
    anytime_stride: int | None = None  # anytime checkpoint stride k
    fan_dtype: str | None = None  # eval fan compute dtype ("f32" / "bf16" / "fp8")
    mel_bf16: bool | None = None  # the bf16 mel chain

    def label(self) -> str:
        parts = [f"chunk={self.sample_chunk if self.sample_chunk else 'full'}"]
        if self.stream_noise is not None:
            parts.append(f"stream={'on' if self.stream_noise else 'off'}")
        if self.dwt_impl is not None:
            parts.append(f"dwt={self.dwt_impl}")
        if self.synth_impl is not None:
            parts.append(f"synth={self.synth_impl}")
        if self.layout is not None:
            parts.append(self.layout)
        if self.fan_cap is not None:
            parts.append(f"fan={self.fan_cap}")
        if self.fan_chunk is not None:
            parts.append(f"fchunk={self.fan_chunk}")
        if self.seq_fused is not None:
            parts.append("fused" if self.seq_fused else "split")
        if self.anytime_stride is not None:
            parts.append(f"k={self.anytime_stride}")
        if self.fan_dtype is not None:
            parts.append(f"dtype={self.fan_dtype}")
        if self.mel_bf16 is not None:
            parts.append(f"mel={'bf16' if self.mel_bf16 else 'f32'}")
        return " ".join(parts)

    def entry(self) -> dict:
        """The knob fields of a schedule-cache entry."""
        out: dict = {"sample_chunk": self.sample_chunk}
        for field in ("stream_noise", "dwt_impl", "synth_impl", "layout", "fan_cap",
                      "fan_chunk", "seq_fused", "anytime_stride", "fan_dtype", "mel_bf16"):
            v = getattr(self, field)
            if v is not None:
                out[field] = v
        return out


def chunk_candidates(batch: int, n_samples: int, targets=(128, 256, 512)) -> list[int | None]:
    """Sample chunks to sweep: the chunk that gives each target of model
    rows a call (chunk x batch ~ target), then every sample at once (None).
    Deduplicated in order; a chunk >= n_samples is the None candidate."""
    seen: list[int | None] = []
    for rows in targets:
        chunk = max(1, int(rows) // max(1, int(batch)))
        if chunk >= n_samples:
            chunk = None
        if chunk not in seen:
            seen.append(chunk)
    if None not in seen:
        seen.append(None)
    return seen


def measure_candidate(fn: Callable, args: tuple, *, k: int = 3,
                      laps: int = 2) -> tuple[list[float], str]:
    """(samples in seconds, plane) of one runner: ``"device"`` samples
    (CUDA events) when the runner touches a card, else ``"wall"`` samples
    (host clock) over at least 3 regions."""
    from wam_tpu_torch.profiling import bench_samples, device_time_samples

    dev = device_time_samples(fn, *args, k=k, laps=laps)
    if dev:
        return dev, "device"
    return bench_samples(fn, *args, k=max(3, k), laps=laps), "wall"


def autotune(workload, *, k: int = 3, laps: int = 2, persist: bool = True,
             log: Callable[[str], None] | None = None) -> dict:
    """Sweep ``workload.candidates``, report every measurement, and persist
    the winner (unless ``persist=False``, the CLI's ``--dry-run``).

    ``workload`` is a `wam_tpu_torch.tune.workloads.Workload`: its
    ``build(cand)`` returns a ``(fn, args)`` runner with the candidate's
    knobs as explicit values (never "auto": the sweep must not read the
    cache it is about to write).

    Returns {"key", "winner", "entry", "results", "persisted"}; ``results``
    rows carry median / q1 / q3 seconds, items/s, the plane, ``peak_gb``
    and ``launches`` (kernel launches a call)."""
    import torch

    from wam_tpu_torch.tune.cache import record_schedule, schedule_key

    say = log or (lambda s: None)
    backend = torch.device(getattr(workload, "device", "cpu")).type
    results = _sweep(workload, k, laps, backend, say)
    winner = min(results, key=lambda r: r["median_s"])

    entry = {
        **winner["candidate"].entry(),
        "median_s": round(winner["median_s"], 6),
        "items_per_s": round(winner["items_per_s"], 3),
        "plane": winner["plane"],
        "source": f"autotune:{workload.name}",
        "tuned_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    if persist:
        key = record_schedule(workload.workload, workload.shape, workload.batch, entry,
                              dtype=workload.dtype, backend=backend)
    else:
        key = schedule_key(workload.workload, workload.shape, workload.batch, workload.dtype,
                           backend=backend)
    say(f"winner: {winner['label']} -> {key}" + ("" if persist else "  (dry-run, not persisted)"))
    return {"key": key, "winner": winner, "entry": entry, "results": results,
            "persisted": persist}


def _sweep(workload, k: int, laps: int, backend: str, say) -> list[dict]:
    """One measured result row per candidate (`autotune`)."""
    import torch

    from wam_tpu_torch import kernels
    from wam_tpu_torch.profiling import median_iqr

    results = []
    for cand in workload.candidates:
        fn, args = workload.build(cand)
        calls = [0]

        def counted(*a, fn=fn):
            calls[0] += 1
            return fn(*a)

        on_card = backend == "cuda"
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        samples, plane = measure_candidate(counted, args, k=k, laps=laps)
        launches = {n: c // max(1, calls[0]) for n, c in kernels.launch_counts().items()}
        peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
        med, q1, q3, _ = median_iqr(samples)
        row = {
            "candidate": cand,
            "label": cand.label(),
            "median_s": med,
            "q1_s": q1,
            "q3_s": q3,
            "items_per_s": workload.items / med,
            "plane": plane,
            "peak_gb": peak,
            "launches": launches,
            "calls": calls[0],
            "sweep_wall_s": time.perf_counter() - t0,
        }
        results.append(row)
        del fn, args, counted
        mem = "" if peak is None else f"  peak {peak:.2f} GB"
        say(f"  {cand.label():<40s} {row['items_per_s']:9.2f} items/s "
            f"median {med * 1e3:8.2f} ms  [{plane}]{mem}")
    return results
