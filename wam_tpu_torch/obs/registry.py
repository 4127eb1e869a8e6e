"""Fleet-wide metrics registry — the second pillar of `wam_tpu_torch.obs`
(PyTorch port of `wam_tpu.obs.registry`, standard library only; the
instrument names keep the reference's ``wam_tpu_`` namespace, so one
dashboard reads either package).

One process-level `Registry` of counters, gauges, and histograms that the
serving runtime (`ServeMetrics`/`FleetMetrics`), the AOT cache, the
stager, and the eval fan engine publish into. The registry is a SECOND
sink alongside the v2 JSONL ledger, not a replacement: JSONL rows stay
the per-run archival record, the registry is the live cross-subsystem
view that `render_prom()` exposes in Prometheus text exposition format
(and the optional `/metrics` stdlib HTTP endpoint serves — see
`wam_tpu_torch.obs.httpd`).

Naming convention (documented in DESIGN.md): every metric is
``wam_tpu_<subsystem>_<name>`` with unit suffixes per Prometheus custom —
``_total`` for counters, ``_seconds``/``_bytes`` for unit-carrying
values. Labels are low-cardinality only (replica id, bucket, event kind);
never request ids.

Instruments are get-or-create (`registry.counter(name, ...)` returns the
existing instrument on a second call with the same name) so publishing
call sites don't coordinate. Mutations honor the shared obs enabled flag:
when observability is off every `inc`/`set`/`observe` returns on one
branch without taking the lock (the satellite-1 overhead contract).
"""

from __future__ import annotations

import threading

from wam_tpu_torch.obs import tracing as _tracing

__all__ = ["Registry", "Counter", "Gauge", "Histogram", "registry",
           "render_prom"]

DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)


def _escape_label(v) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _fmt(v: float) -> str:
    # Prometheus exposition wants plain decimals; repr keeps full precision
    # for floats while ints stay ints.
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


class _Instrument:
    """Base: named, typed, label-keyed values behind the registry lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple, lock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._values: dict = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"declared {sorted(self.labelnames)}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def _reset(self) -> None:
        self._values.clear()


class Counter(_Instrument):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not _tracing._STATE.enabled:
            return
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        if not _tracing._STATE.enabled:
            return
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not _tracing._STATE.enabled:
            return
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)


class Histogram(_Instrument):
    """Cumulative-bucket histogram; per-label-set value is
    ``[counts_per_bucket..., +Inf_count, sum]``."""

    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, lock)
        self.buckets = tuple(sorted(buckets))

    def observe(self, value: float, **labels) -> None:
        if not _tracing._STATE.enabled:
            return
        key = self._key(labels)
        with self._lock:
            row = self._values.get(key)
            if row is None:
                row = self._values[key] = [0] * (len(self.buckets) + 1) + [0.0]
            for i, le in enumerate(self.buckets):
                if value <= le:
                    row[i] += 1
            row[len(self.buckets)] += 1  # +Inf / _count
            row[-1] += value  # _sum

    def count(self, **labels) -> int:
        with self._lock:
            row = self._values.get(self._key(labels))
            return int(row[len(self.buckets)]) if row else 0

    def sum(self, **labels) -> float:
        with self._lock:
            row = self._values.get(self._key(labels))
            return float(row[-1]) if row else 0.0


class Registry:
    """Get-or-create instrument registry with Prometheus rendering."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, _Instrument] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise ValueError(
                        f"{name} already registered as {inst.kind}")
                return inst
            inst = cls(name, help, tuple(labelnames), self._lock, **kw)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "", labels=()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def collect(self) -> dict:
        """Flat snapshot for ledger rows: ``{name{label="v",...}: value}``
        (histograms contribute ``name_count`` and ``name_sum``)."""
        out: dict[str, float] = {}
        with self._lock:
            for inst in self._instruments.values():
                for key, val in inst._values.items():
                    lbl = ",".join(
                        f'{k}="{_escape_label(v)}"'
                        for k, v in zip(inst.labelnames, key))
                    suffix = f"{{{lbl}}}" if lbl else ""
                    if inst.kind == "histogram":
                        out[f"{inst.name}_count{suffix}"] = float(
                            val[len(inst.buckets)])
                        out[f"{inst.name}_sum{suffix}"] = float(val[-1])
                    else:
                        out[f"{inst.name}{suffix}"] = float(val)
        return out

    def render_prom(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: list[str] = []
        with self._lock:
            for name in sorted(self._instruments):
                inst = self._instruments[name]
                lines.append(f"# HELP {name} {inst.help}")
                lines.append(f"# TYPE {name} {inst.kind}")
                for key in sorted(inst._values):
                    val = inst._values[key]
                    pairs = [
                        f'{k}="{_escape_label(v)}"'
                        for k, v in zip(inst.labelnames, key)]
                    if inst.kind == "histogram":
                        # bucket counts are stored cumulatively (observe()
                        # increments every le >= value), as exposition wants
                        for i, le in enumerate(inst.buckets):
                            blbl = "{" + ",".join(pairs + [f'le="{_fmt(float(le))}"']) + "}"
                            lines.append(f"{name}_bucket{blbl} {val[i]}")
                        inf_lbl = "{" + ",".join(pairs + ['le="+Inf"']) + "}"
                        lines.append(
                            f"{name}_bucket{inf_lbl} {val[len(inst.buckets)]}")
                        base = "{" + ",".join(pairs) + "}" if pairs else ""
                        lines.append(f"{name}_sum{base} {_fmt(val[-1])}")
                        lines.append(
                            f"{name}_count{base} {val[len(inst.buckets)]}")
                    else:
                        lbl = "{" + ",".join(pairs) + "}" if pairs else ""
                        lines.append(f"{name}{lbl} {_fmt(val)}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Zero every instrument's values (instruments stay registered) —
        bench sweep points and tests call this between runs."""
        with self._lock:
            for inst in self._instruments.values():
                inst._reset()


registry = Registry()


def render_prom() -> str:
    return registry.render_prom()
