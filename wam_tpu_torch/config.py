"""Typed configuration (PyTorch port of `wam_tpu.config`, less the JAX
backend glue: ``select_backend`` / ``ensure_usable_backend``, whose
counterpart is `device.resolve_device`, and ``enable_compilation_cache``,
which waits for the port's AOT cache, ROADMAP.md slice E).

`WAM2DConfig`, `WAM1DConfig`, `WAM3DConfig` and `EvalConfig` keep the
reference's defaults; ``device="auto"`` is `resolve_device(None)`: the card,
or RuntimeError. `add_config_args` / `config_from_args` are the thin CLI
over any of them.

`PrecisionPolicy` says in which dtype the evaluation fans' model forwards
run ("f32", "bf16" or "fp8") and whether the mel front end's matmuls take
bf16 inputs; `resolve_precision` resolves it from an explicit argument, then
the ``WAM_TPU_FAN_DTYPE`` / ``WAM_TPU_MEL_BF16`` environment knobs, then
float32. (The reference's third layer, a tuned schedule entry, waits for the
port's tune cache.) `resolve_compute_dtype` turns the baseline evaluators'
``compute_dtype`` / ``precision`` pair into a torch dtype and a fan tag.
`EvalConfig` holds the evaluation suite's defaults.

`ServeConfig` and `ObsConfig` are the knobs of `wam_tpu_torch.serve` and
`wam_tpu_torch.obs`; `probe_accelerator` asks a throwaway subprocess, under
a timeout, whether the card still works (the serving runtime's degradation
check).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, fields

import torch

__all__ = ["FAN_DTYPES", "PrecisionPolicy", "resolve_precision", "resolve_compute_dtype",
           "precision_tag", "compute_cast", "fp8_supported", "probe_accelerator",
           "enable_compilation_cache",
           "WAM2DConfig", "WAM1DConfig", "WAM3DConfig", "EvalConfig", "ServeConfig",
           "ObsConfig", "add_config_args", "config_from_args"]

FAN_DTYPES = ("f32", "bf16", "fp8")
FP8 = torch.float8_e4m3fn

_fp8_results: dict[str, bool] = {}


def _current_device() -> torch.device:
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def fp8_supported() -> bool:
    """Whether the current device (the current CUDA device, else the CPU)
    runs an fp8 matmul with float32 accumulation: one ``torch._scaled_mm``
    of two 16 x 16 float8_e4m3fn operands, run once per device and
    remembered for the process. Having the dtype is not enough: most devices
    store fp8 and cannot multiply it."""
    device = _current_device()
    key = str(device)
    if key not in _fp8_results:
        try:
            a = torch.ones((16, 16), device=device).to(FP8)
            one = torch.ones((), device=device)
            out = torch._scaled_mm(a, a.t(), scale_a=one, scale_b=one, out_dtype=torch.float32)
            _fp8_results[key] = out.dtype == torch.float32 and bool((out == 16).all())
        except (RuntimeError, NotImplementedError, TypeError, AttributeError):
            _fp8_results[key] = False
    return _fp8_results[key]


@dataclass(frozen=True)
class PrecisionPolicy:
    """Low-precision policy for the evaluation fans and the mel chain.

    ``fan_dtype`` is the compute dtype of the fans' model forwards;
    ``mel_bf16`` feeds the mel front end's DFT and filterbank matmuls bf16
    inputs. The cast is a boundary shim (`evalsuite.fan.cast_model_fn`):
    every reduction that ranks things (softmax, AUC, Spearman) runs in
    float32. "fp8" runs as bf16 on a device that fails `fp8_supported`."""

    fan_dtype: str = "f32"
    mel_bf16: bool = False

    def __post_init__(self):
        if self.fan_dtype not in FAN_DTYPES:
            raise ValueError(f"fan_dtype must be one of {FAN_DTYPES}, got {self.fan_dtype!r}")

    def compute_dtype(self) -> torch.dtype | None:
        """The torch dtype the fan's inputs are quantized to, or None for
        pure float32 (then the shim adds no op)."""
        if self.fan_dtype == "f32":
            return None
        if self.fan_dtype == "fp8" and fp8_supported():
            return FP8
        return torch.bfloat16

    def tag(self) -> str:
        """Short stable tag for cache keys ("f32", "bf16", "bf16+mel", ...)."""
        return self.fan_dtype + ("+mel" if self.mel_bf16 else "")


def _validate_fan_dtype(value: str, source: str) -> str:
    if value not in FAN_DTYPES:
        raise ValueError(f"{source} must be one of {FAN_DTYPES}, got {value!r}")
    return value


def resolve_precision(workload: str | None = None, shape: tuple | None = None,
                      batch: int | None = None, *, fan_dtype: str | None = None,
                      mel_bf16: bool | None = None, backend: str | None = None) -> PrecisionPolicy:
    """Explicit arguments win; then the ``WAM_TPU_FAN_DTYPE`` /
    ``WAM_TPU_MEL_BF16`` environment knobs (validated when read); then, only
    when a (``workload``, ``batch``) key is given, the tuned schedule
    entry's ``fan_dtype`` / ``mel_bf16`` (`wam_tpu_torch.tune`); then float32
    and no bf16 mel."""
    ent = None
    if workload is not None and batch is not None:
        from wam_tpu_torch.tune.cache import lookup_schedule

        ent = lookup_schedule(workload, shape or (batch,), batch, backend=backend)
    if fan_dtype is None:
        env = os.environ.get("WAM_TPU_FAN_DTYPE", "")
        if env:
            fan_dtype = _validate_fan_dtype(env, "WAM_TPU_FAN_DTYPE")
        elif ent and ent.get("fan_dtype"):
            fan_dtype = _validate_fan_dtype(str(ent["fan_dtype"]), "tuned fan_dtype")
        else:
            fan_dtype = "f32"
    else:
        fan_dtype = _validate_fan_dtype(fan_dtype, "fan_dtype")
    if mel_bf16 is None:
        env = os.environ.get("WAM_TPU_MEL_BF16", "")
        if env:
            mel_bf16 = env not in ("0", "false", "no")
        elif ent is not None:
            mel_bf16 = bool(ent.get("mel_bf16", False))
        else:
            mel_bf16 = False
    return PrecisionPolicy(fan_dtype=fan_dtype, mel_bf16=bool(mel_bf16))


def precision_tag() -> str:
    """The live process-level precision tag (the environment knobs only),
    read per call."""
    return resolve_precision().tag()


_FAN_TAGS = {torch.bfloat16: "bf16", FP8: "fp8"}


def resolve_compute_dtype(compute_dtype=None, precision=None):
    """The (compute dtype, fan tag) of an evaluator given ``compute_dtype``
    (a torch dtype, a policy string "f32" / "bf16" / "fp8", or None) and
    ``precision`` (a `PrecisionPolicy`, a ``fan_dtype`` string, or None),
    in the reference's order: a string ``compute_dtype`` resolves through
    `PrecisionPolicy.compute_dtype` ("fp8" is float8_e4m3fn where
    `fp8_supported`, else bfloat16); without one, ``precision`` supplies
    it. The tag is the policy's ``fan_dtype`` when ``precision`` is given,
    else the dtype's ("bf16", "fp8"; None for float32 or no dtype)."""
    if isinstance(precision, str):
        precision = PrecisionPolicy(fan_dtype=precision)
    if isinstance(compute_dtype, str):
        compute_dtype = PrecisionPolicy(fan_dtype=compute_dtype).compute_dtype()
    if compute_dtype is None and precision is not None:
        compute_dtype = precision.compute_dtype()
    if precision is not None:
        tag = precision.fan_dtype
    else:
        tag = _FAN_TAGS.get(compute_dtype)
    return compute_dtype, tag


def compute_cast(x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """Cast to a policy compute dtype at a precision boundary; ``None`` (the
    float32 policy) is the identity."""
    return x if dtype is None else x.to(dtype)


def probe_accelerator(timeout_s: float = 180.0) -> bool:
    """Check in a SUBPROCESS whether a CUDA card can be initialized and run
    one small computation. A card lost mid-run can leave CUDA calls in this
    process failing or hanging; a throwaway subprocess with a hard timeout
    is the safe probe. Every call probes anew: the serving runtime calls it
    after an entry failure to tell a device loss from an in-process bug
    before it degrades to its fallback entry."""
    import subprocess
    import sys

    code = ("import sys, torch\n"
            "ok = torch.cuda.is_available() and float(torch.ones(8, device='cuda').sum()) == 8.0\n"
            "sys.exit(0 if ok else 1)")
    try:
        proc = subprocess.run([sys.executable, "-c", code], timeout=timeout_s,
                              capture_output=True)
    except subprocess.TimeoutExpired:
        return False
    return proc.returncode == 0


def enable_compilation_cache(cache_dir: str | None = None,
                             min_compile_time_secs: float | None = None) -> str:
    """Persist compiled programs across processes (the counterpart of the
    reference's persistent XLA cache): turns on Inductor's FX-graph cache
    and AOTAutograd's cache and points ``TORCHINDUCTOR_CACHE_DIR`` and
    ``TRITON_CACHE_DIR`` under ``cache_dir`` (default
    ``$WAM_TPU_CACHE_DIR`` or ``~/.cache/wam_tpu/inductor``), as the
    reference sets JAX's cache directory. Returns the directory. A process that loads
    the compiled-step cache's artifacts (`pipeline.aot`) installs them
    here. ``min_compile_time_secs`` has no counterpart (Inductor caches
    every graph) and is accepted for the reference's signature."""
    del min_compile_time_secs
    cache_dir = cache_dir or os.environ.get(
        "WAM_TPU_CACHE_DIR", os.path.expanduser("~/.cache/wam_tpu/inductor"))
    os.makedirs(cache_dir, exist_ok=True)
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = cache_dir
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache_dir, "triton")
    import torch._functorch.config as functorch_config
    import torch._inductor.config as inductor_config

    inductor_config.fx_graph_cache = True
    functorch_config.enable_autograd_cache = True
    return cache_dir


@dataclass
class WAM2DConfig:
    wavelet: str = "haar"
    method: str = "smooth"
    J: int = 3
    mode: str = "reflect"
    approx_coeffs: bool = False
    normalize_coeffs: bool = True
    n_samples: int = 25
    stdev_spread: float = 0.25
    random_seed: int = 42
    # "auto" = all samples in one model call (`core.estimators.resolve_sample_chunk`)
    sample_batch_size: int | None | str = "auto"
    device: str = "auto"


@dataclass
class WAM1DConfig:
    wavelet: str = "haar"
    method: str = "smooth"
    J: int = 3
    mode: str = "reflect"
    approx_coeffs: bool = False
    n_mels: int = 128
    n_fft: int = 1024
    sample_rate: int = 44100
    n_samples: int = 25
    stdev_spread: float = 0.001
    random_seed: int = 42
    sample_batch_size: int | None | str = "auto"
    device: str = "auto"


@dataclass
class WAM3DConfig:
    wavelet: str = "haar"
    method: str = "smooth"
    J: int = 3
    mode: str = "symmetric"
    instance: str = "voxels"
    normalize: bool = True
    EPS: float = 0.451
    n_samples: int = 25
    stdev_spread: float = 1e-4
    random_seed: int = 42
    sample_batch_size: int | None | str = "auto"
    device: str = "auto"


@dataclass
class EvalConfig:
    n_iter: int = 64
    baseline_n_iter: int = 128
    grid_size: int = 28
    sample_size: int = 128
    subset_size: int = 157
    # "auto" = 128 rows a model call, the reference's fallback (the port has
    # no tuned cap yet)
    batch_size: int | str = 128
    device: str = "auto"


@dataclass
class ServeConfig:
    """Knobs of `wam_tpu_torch.serve.AttributionServer` /
    `serve.FleetServer`. ``buckets`` is the admitted item-shape set as a
    CLI-friendly string: comma-separated, dims joined by 'x' — e.g.
    "3x224x224,3x256x256" for images, "32768,65536" for waveforms; "" lets
    the caller pick programmatically. ``fleet`` > 1 serves with one replica
    worker per device; ``oversize`` picks what happens to a whole batch
    larger than one replica's bucket cap ("pjit" = data-parallel over the
    fleet mesh, "fanout" = per-item routing); ``supervise`` and
    ``restart_*`` are the replicas' restart policy. `serve.FleetServer.from_config`
    reads these knobs; the single-device server has no reader yet (the
    serving benchmark's port, ROADMAP.md queue 1 item 1). ``max_batch`` accepts "auto":
    the tuned per-bucket cap from the schedule cache
    (`tune.resolve_bucket_cap`, keyed by the fleet's replica count), else 8.
    ``compilation_cache`` (`config.enable_compilation_cache` at start) and
    ``registry`` (a bundle of `wam_tpu_torch.registry` hydrated before
    warmup) are the cold-start knobs, with the reference's defaults."""

    max_batch: int | str = 8  # rows per dispatched batch, or "auto"
    max_wait_ms: float = 5.0
    # cross-request admission window (serve/runtime "Coalescing"): hold a
    # bucket's dispatch up to this long for batch fill, with deadline-
    # pressure early release. 0 = max_wait-only behavior. ON by default for
    # config-built servers, as in the reference.
    coalesce_ms: float = 3.0
    # content-addressed result cache budget (serve/result_cache), MB per
    # server. 0 = off.
    result_cache_mb: float = 64.0
    queue_depth: int = 64
    deadline_ms: float = 0.0  # 0 = no per-request deadline
    buckets: str = ""
    warmup: bool = True
    pipelined: bool = True  # one-in-flight overlapped dispatch (serve/runtime)
    compilation_cache: bool = True
    metrics_path: str = ""
    device: str = "auto"
    fleet: int = 1  # replica workers (one per device); 1 = single-device server
    oversize: str = "pjit"  # "pjit" | "fanout" (serve/fleet oversize path)
    # -- health plane (obs.health / obs.memory / obs.slo) -------------------
    health: bool = True  # numeric-health monitors + quarantine
    health_quarantine_n: int = 3  # consecutive non-finite batches -> degraded
    health_recovery_s: float = 30.0  # quarantine probation window
    hbm_budget_mb: float = 0.0  # device memory budget (MiB); 0 = no limit
    # per-tenant admission quota as a fraction of queue_depth: one tenant may
    # hold at most max(1, queue_depth * tenant_quota) queued requests
    tenant_quota: float = 0.0
    # per-bucket SLOs, e.g. "p99_ms=50,error_rate=0.01,health_rate=0.999"
    # optionally bucket-prefixed: "3x224x224: p99_ms=30; *: p99_ms=80"
    slo: str = ""
    # -- resilience (serve.supervisor / serve.retry) ------------------------
    supervise: bool = True  # restart dead replicas (fleets only)
    restart_max: int = 3  # completed restarts in restart_window_s -> permanent
    restart_window_s: float = 60.0
    restart_backoff_ms: float = 50.0  # base restart backoff (exp, jittered)
    retry_attempts: int = 4  # client-side submit attempts (serve.retry)
    retry_budget_s: float = 30.0  # total per-request retry budget; 0 = none
    # -- cold start (wam_tpu_torch.registry) --------------------------------
    registry: str = ""  # compile-artifact bundle to hydrate before warmup

    def bucket_shapes(self) -> list[tuple[int, ...]]:
        if not self.buckets:
            return []
        return [
            tuple(int(d) for d in part.strip().split("x"))
            for part in self.buckets.split(",")
            if part.strip()
        ]


@dataclass
class ObsConfig:
    """Knobs of the unified observability layer (`wam_tpu_torch.obs`).
    Apply with ``wam_tpu_torch.obs.configure(cfg)``. ``enabled=False`` turns
    every span/counter call into a near-zero-overhead no-op (the first-call
    sentinel keeps counting). ``prom_port``: the port of
    `obs.start_metrics_server`; 0 = no endpoint."""

    enabled: bool = True
    ring_size: int = 4096  # span ring capacity (oldest spans drop first)
    prom_port: int = 0  # /metrics HTTP port; 0 = disabled


def _int_or_str(s: str):
    """Converter for ``int | None | str`` fields (``sample_batch_size``: 4
    or "auto"): argparse applies ``type`` to string defaults too, so a plain
    int converter would fail on the "auto" default."""
    try:
        return int(s)
    except ValueError:
        return s


def add_config_args(parser: argparse.ArgumentParser, cfg_cls, prefix: str = "") -> None:
    """Register every dataclass field as a ``--prefix-field-name`` flag;
    booleans read "1", "true" or "yes" (any case) as True and anything else
    as False."""
    for f in fields(cfg_cls):
        name = f"--{prefix}{f.name.replace('_', '-')}"
        if f.type in ("bool", bool):
            parser.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=f.default)
        else:
            typ = {int: int, float: float}.get(f.type, str)
            if isinstance(f.type, str):
                parts = {p.strip() for p in f.type.replace("|", " ").split()}
                if "int" in parts and "str" in parts:
                    typ = _int_or_str
                elif "int" in parts:
                    typ = int
                elif "float" in parts:
                    typ = float
                else:
                    typ = str
            default = f.default if f.default is not dataclasses.MISSING else None
            parser.add_argument(name, type=typ, default=default)


def config_from_args(args: argparse.Namespace, cfg_cls, prefix: str = ""):
    """The dataclass from parsed flags (fields left None keep their default)."""
    kwargs = {}
    for f in fields(cfg_cls):
        key = f"{prefix}{f.name}"
        if hasattr(args, key):
            v = getattr(args, key)
            if v is not None:
                kwargs[f.name] = v
    return cfg_cls(**kwargs)
