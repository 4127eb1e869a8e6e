"""wam_tpu_torch.obs — unified observability: tracing, metrics, first-call
sentinel (PyTorch port of `wam_tpu.obs`).

Three pillars, one import surface:

- **Request-scoped tracing** (`obs.span`, `obs.start_span`,
  `obs.record_span`, `obs.export_chrome_trace`) — per-request span trees
  with trace/parent ids on monotonic clocks, exported as Chrome
  trace-event JSON; live spans are also `torch.profiler.record_function`
  scopes. See `wam_tpu_torch.obs.tracing`.
- **Metrics registry** (`obs.registry`, `obs.render_prom`,
  `obs.start_metrics_server`) — process-level counters/gauges/histograms
  in the reference's ``wam_tpu_<subsystem>_<name>`` namespace with
  Prometheus text exposition. See `wam_tpu_torch.obs.registry`.
- **First-call sentinel** (`obs.sentinel`, `obs.assert_no_retrace`) —
  every first call of an entry at a new input signature (the port's
  counterpart of a jit trace) counted and attributed. See
  `wam_tpu_torch.obs.sentinel`, which also counts the compiled-step
  cache's events (`record_aot`, `wam_tpu_compile_aot_events_total`).

The health plane builds on the pillars:

- **Numeric health** (`obs.health`) — NaN/Inf + saturation + grad-norm
  reductions riding inside existing result fetches, and the
  `HealthMonitor` quarantine state machine.
- **Memory accounting** (`obs.memory`) — per-bucket peak-bytes watermarks
  at warmup from the caching allocator, a live staged-bytes gauge, and
  the `MemoryBudget` cold-bucket admission check.
- **SLO engine** (`obs.slo`) — declarative per-bucket objectives, rolling
  burn rates, and the routing penalty.

`configure(ObsConfig(...))` (or `configure(enabled=False)`) flips the
shared enabled flag: disabled, spans are a shared no-op singleton and
registry mutations return on one branch. The sentinel keeps counting
regardless.

`reset()` clears spans, registry values, and sentinel events — tests call
it between runs so process-global state can't leak across measurements.

This package imports only the standard library at import time (torch
inside the helpers that touch tensors) and never
wam_tpu_torch.serve/pipeline/evalsuite, which all import obs.
"""

from __future__ import annotations

from wam_tpu_torch.obs import health, memory, sentinel, slo
from wam_tpu_torch.obs.health import HealthConfig, HealthMonitor, health_stats
from wam_tpu_torch.obs.httpd import start_metrics_server, stop_metrics_server
from wam_tpu_torch.obs.memory import MemoryBudget
from wam_tpu_torch.obs.slo import SLObjectives, SLOTracker, parse_slo
from wam_tpu_torch.obs.registry import Registry, registry, render_prom
from wam_tpu_torch.obs.sentinel import (RetraceError, assert_no_retrace, compile_events,
                                        record_aot, record_trace, trace_count)
from wam_tpu_torch.obs.tracing import (NULL_SPAN, Span, clear_spans, current_context, enabled,
                                       export_chrome_trace, record_span, set_enabled,
                                       set_ring_size, span, spans, start_span, use_context)

__all__ = [
    "span", "start_span", "record_span", "current_context", "use_context",
    "spans", "clear_spans", "export_chrome_trace", "Span", "NULL_SPAN",
    "registry", "Registry", "render_prom", "start_metrics_server",
    "stop_metrics_server",
    "sentinel", "record_trace", "record_aot", "trace_count",
    "compile_events", "assert_no_retrace", "RetraceError",
    "health", "memory", "slo",
    "HealthConfig", "HealthMonitor", "health_stats", "MemoryBudget",
    "SLObjectives", "SLOTracker", "parse_slo",
    "configure", "reset", "enabled", "set_enabled", "set_ring_size",
]


def configure(cfg=None, *, enabled: bool | None = None,
              ring_size: int | None = None) -> None:
    """Apply an `ObsConfig` (duck-typed: any object with
    enabled/ring_size/prom_port attrs) or individual overrides. Starting
    the prom endpoint is the caller's job (`start_metrics_server`) —
    configure only sets process-level tracing state."""
    if cfg is not None:
        enabled = cfg.enabled if enabled is None else enabled
        ring_size = getattr(cfg, "ring_size", None) if ring_size is None else ring_size
    if enabled is not None:
        set_enabled(enabled)
    if ring_size is not None:
        set_ring_size(ring_size)


def reset() -> None:
    """Clear all recorded observability state: span ring, registry
    values (instruments stay registered), sentinel events + counts."""
    clear_spans()
    registry.reset()
    sentinel.clear_events()
