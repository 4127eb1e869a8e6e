"""Precision policy and evaluation configuration (PyTorch port, part of
`wam_tpu.config`).

`PrecisionPolicy` says in which dtype the evaluation fans' model forwards
run ("f32", "bf16" or "fp8") and whether the mel front end's matmuls take
bf16 inputs; `resolve_precision` resolves it from an explicit argument, then
the ``WAM_TPU_FAN_DTYPE`` / ``WAM_TPU_MEL_BF16`` environment knobs, then
float32. (The reference's third layer, a tuned schedule entry, waits for the
port's tune cache.) `resolve_compute_dtype` turns the baseline evaluators'
``compute_dtype`` / ``precision`` pair into a torch dtype and a fan tag.
`EvalConfig` holds the evaluation suite's defaults.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

__all__ = ["FAN_DTYPES", "PrecisionPolicy", "resolve_precision", "resolve_compute_dtype",
           "compute_cast", "fp8_supported", "EvalConfig"]

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


def resolve_precision(*, fan_dtype: str | None = None,
                      mel_bf16: bool | None = None) -> PrecisionPolicy:
    """Explicit arguments win; then the ``WAM_TPU_FAN_DTYPE`` /
    ``WAM_TPU_MEL_BF16`` environment knobs (validated when read); then
    float32 and no bf16 mel."""
    if fan_dtype is None:
        env = os.environ.get("WAM_TPU_FAN_DTYPE", "")
        fan_dtype = _validate_fan_dtype(env, "WAM_TPU_FAN_DTYPE") if env else "f32"
    else:
        fan_dtype = _validate_fan_dtype(fan_dtype, "fan_dtype")
    if mel_bf16 is None:
        env = os.environ.get("WAM_TPU_MEL_BF16", "")
        mel_bf16 = env not in ("0", "false", "no") if env else False
    return PrecisionPolicy(fan_dtype=fan_dtype, mel_bf16=bool(mel_bf16))


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
