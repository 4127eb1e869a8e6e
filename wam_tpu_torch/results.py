"""Metric persistence (PyTorch port of `wam_tpu.results`, standard library
only): `MetricRecord` rows appended to a JSONL ledger one whole line a
write, so long sweeps resume where they stopped, and a CSV writer with a
fixed header. A torn last line of a crashed writer is skipped by the reader
with a `LedgerCorruptWarning` (the reference also counts it in its metrics
registry, which is not ported yet).
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import time
import warnings
from dataclasses import dataclass, field

__all__ = ["MetricRecord", "JsonlWriter", "CsvWriter", "read_jsonl",
           "read_jsonl_stats", "LedgerCorruptWarning"]


class LedgerCorruptWarning(UserWarning):
    """A JSONL ledger carried unparsable line(s) — typically a torn final
    write from a crashed process. Readers skip them (counted)."""


@dataclass
class MetricRecord:
    metric: str
    value: float
    unit: str = ""
    config: dict = field(default_factory=dict)
    timestamp: float = field(default_factory=time.time)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class JsonlWriter:
    """Append-only JSONL sink. Each `write` is ONE ``os.write`` of a
    complete line on an ``O_APPEND`` fd: on POSIX the kernel serializes
    appends per write call, so concurrent writers (N replica ledgers into
    one fleet file) never interleave mid-line and a row is either wholly
    present or wholly absent. A process killed mid-syscall can still leave
    a torn final line — that is the reader's half of the contract
    (`read_jsonl` skips it with a counted `LedgerCorruptWarning`)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def write(self, record: MetricRecord | dict) -> None:
        row = record.to_dict() if isinstance(record, MetricRecord) else record
        data = (json.dumps(row) + "\n").encode("utf-8")
        fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, data)
        finally:
            os.close(fd)

    def done_keys(self, key: str = "metric") -> set:
        """Keys already written — skip these on resume."""
        if not os.path.exists(self.path):
            return set()
        return {row.get(key) for row in read_jsonl(self.path)}


def read_jsonl(path: str, *, strict: bool = False) -> list[dict]:
    """Parse a JSONL ledger, tolerating corrupt lines (a torn trailing
    write from a crashed process): bad lines are skipped with one
    `LedgerCorruptWarning` per call and counted into the
    ``wam_tpu_serve_ledger_corrupt_lines_total`` registry counter.
    ``strict=True`` raises on a bad line instead."""
    rows, corrupt = read_jsonl_stats(path, strict=strict)
    return rows


def read_jsonl_stats(path: str, *, strict: bool = False) -> tuple[list[dict], int]:
    """`read_jsonl` plus the count of skipped lines."""
    out, corrupt = [], 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                if strict:
                    raise
                corrupt += 1
    if corrupt:
        warnings.warn(
            f"{path}: skipped {corrupt} corrupt JSONL line(s) "
            "(torn write from an interrupted process?)",
            LedgerCorruptWarning, stacklevel=2)
        _note_corrupt_lines(corrupt)
    return out, corrupt


def _note_corrupt_lines(n: int) -> None:
    # obs is stdlib-only at import time, so this lazy import cannot cycle
    # back into results; mutations no-op when the obs layer is disabled
    from wam_tpu_torch.obs.registry import registry as _registry

    _registry.counter(
        "wam_tpu_serve_ledger_corrupt_lines_total",
        "corrupt JSONL ledger lines skipped by tolerant readers",
    ).inc(n)


class CsvWriter:
    """Row-wise CSV writer with a fixed header (the results/*.csv shape)."""

    def __init__(self, path: str, fieldnames: list[str]):
        self.path = path
        self.fieldnames = fieldnames
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if not os.path.exists(path):
            with open(path, "w", newline="") as f:
                csv.DictWriter(f, fieldnames=fieldnames).writeheader()

    def write(self, row: dict) -> None:
        with open(self.path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self.fieldnames).writerow(row)
