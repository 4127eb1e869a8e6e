"""Declared observability schema: the single source of truth for metric
instrument names and v2 ledger row types (a copy of `wam_tpu.obs.schema`:
the port publishes under the same names, so one schema covers both
packages).

Dashboards, alert rules, and ledger readers key on these literals, so
they are an *external contract*: renaming an instrument or adding a row
type without updating this registry silently breaks consumers. The
port's `schema-drift` lint rule (``python -m wam_tpu_torch.lint --rules
schema-drift``) AST-scans the port and flags any ``registry.counter/gauge/histogram``
name or ``{"metric": ...}`` row literal that is not declared here — so
the workflow for a new instrument is: declare it here first, then wire
it up.

Both containers are pure string literals on purpose: the lint rule
reads this file with ``ast.parse`` (never imports it), which only works
if every entry is a constant.
"""

from __future__ import annotations

# Prometheus-style instrument names, grouped by subsystem family.
METRIC_NAMES = frozenset({
    # serve admission / batching (serve/runtime.py, serve/metrics.py)
    "wam_tpu_serve_batch_occupancy",
    "wam_tpu_serve_batches_total",
    "wam_tpu_serve_compile_total",
    "wam_tpu_serve_completed_total",
    "wam_tpu_serve_ema_service_seconds",
    "wam_tpu_serve_expired_total",
    "wam_tpu_serve_failed_total",
    "wam_tpu_serve_fallback_batches_total",
    "wam_tpu_serve_latency_seconds",
    "wam_tpu_serve_ledger_corrupt_lines_total",
    "wam_tpu_serve_queue_depth",
    "wam_tpu_serve_rejected_total",
    "wam_tpu_serve_restarts_total",
    "wam_tpu_serve_service_seconds",
    "wam_tpu_serve_submitted_total",
    # multi-model residency (serve/models.py)
    "wam_tpu_serve_model_pagein_seconds",
    "wam_tpu_serve_model_pagein_total",
    "wam_tpu_serve_model_pageout_total",
    "wam_tpu_serve_model_resident",
    "wam_tpu_serve_model_resident_bytes",
    # serve result cache (serve/result_cache.py)
    "wam_tpu_serve_cache_bytes",
    "wam_tpu_serve_cache_entries",
    "wam_tpu_serve_cache_evictions_total",
    "wam_tpu_serve_cache_hits_total",
    "wam_tpu_serve_cache_misses_total",
    # fleet (serve/fleet.py)
    "wam_tpu_fleet_compile_count",
    "wam_tpu_fleet_replica_deaths_total",
    "wam_tpu_fleet_warmup_seconds",
    # numeric health (obs/health.py)
    "wam_tpu_health_checks_total",
    "wam_tpu_health_consecutive_nonfinite",
    "wam_tpu_health_grad_norm",
    "wam_tpu_health_max_abs",
    "wam_tpu_health_nonfinite_batches_total",
    "wam_tpu_health_nonfinite_values_total",
    "wam_tpu_health_quarantined",
    "wam_tpu_health_saturation_fraction",
    # HBM budget / admission (obs/memory.py)
    "wam_tpu_memory_admission_rejects_total",
    "wam_tpu_memory_bucket_watermark_bytes",
    "wam_tpu_memory_budget_bytes",
    "wam_tpu_memory_device_bytes_in_use",
    "wam_tpu_memory_staged_bytes",
    # SLO tracker (obs/slo.py)
    "wam_tpu_slo_burn_rate",
    "wam_tpu_slo_confidence",
    "wam_tpu_slo_error_rate",
    "wam_tpu_slo_health_rate",
    "wam_tpu_slo_p99_seconds",
    "wam_tpu_slo_window_requests",
    # anytime attribution (anytime/, serve/metrics.py)
    "wam_tpu_anytime_batches_total",
    "wam_tpu_anytime_confidence",
    "wam_tpu_anytime_deadline_partial_total",
    "wam_tpu_anytime_early_exit_total",
    "wam_tpu_anytime_samples_fraction",
    "wam_tpu_anytime_strides_total",
    # retry / hedging (serve/retry.py)
    "wam_tpu_retry_attempts_total",
    "wam_tpu_retry_exhausted_total",
    "wam_tpu_retry_hedge_wins_total",
    "wam_tpu_retry_hedges_total",
    "wam_tpu_retry_retries_total",
    # pod router / workers (pod/)
    "wam_tpu_pod_autoscale_total",
    "wam_tpu_pod_requests_completed_total",
    "wam_tpu_pod_worker_deaths_total",
    "wam_tpu_pod_worker_drain_seconds",
    "wam_tpu_pod_worker_restarts_total",
    "wam_tpu_pod_workers_alive",
    # pod wire transport (pod/netchannel.py, pod/metrics.py)
    "wam_tpu_pod_net_handshakes_total",
    "wam_tpu_pod_net_heartbeats_coalesced_total",
    "wam_tpu_pod_net_host_rtt_seconds",
    "wam_tpu_pod_net_messages_total",
    "wam_tpu_pod_net_registry_stream_bytes_total",
    "wam_tpu_pod_net_rx_bytes_total",
    "wam_tpu_pod_net_tx_bytes_total",
    # compile-artifact registry (registry/)
    "wam_tpu_registry_artifacts_total",
    "wam_tpu_registry_hydrations_total",
    "wam_tpu_registry_schedules_total",
    # online schedule tuner (tune/online.py, tune/mix.py)
    "wam_tpu_tune_drift_ratio",
    "wam_tpu_tune_promotions_total",
    "wam_tpu_tune_sweeps_total",
    # compile observability + fan engine + chaos + stager
    "wam_tpu_chaos_injected_total",
    "wam_tpu_compile_aot_events_total",
    "wam_tpu_compile_jit_traces_total",
    "wam_tpu_fan_result_fetches_total",
    "wam_tpu_stager_h2d_bytes_total",
})

# v2 JSONL ledger row discriminators: the "metric" field of every row
# appended by obs ledgers (SCHEMA_VERSION = 2 in serve/metrics.py).
LEDGER_ROW_TYPES = frozenset({
    "fleet_summary",
    "obs_snapshot",
    "partial_result",
    "pod_autoscale",
    "pod_host",
    "pod_summary",
    "pod_worker",
    "registry_hydration",
    "replica_restart",
    "result_cache",
    "schedule_drift",
    "schedule_promotion",
    "serve_batch",
    "serve_summary",
    "slo_status",
    "worker_restart",
})
