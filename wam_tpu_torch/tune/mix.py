"""Ledger-mined workload mixes + schedule drift detection (PyTorch port of
`wam_tpu.tune.mix`; pure Python over the serve ledger's rows).

The obs ledger already records the exact reward signal a tuner needs —
every ``serve_batch`` row carries the bucket, real-row count, occupancy,
queue depth, service time, per-class QoS counts, and the schedule
fingerprint that produced it. This module mines that ledger into a `WorkloadMix` — the OBSERVED
bucket × qos histogram with per-bucket service-time samples — which

- `wam_tpu_torch.tune.workloads` turns into the ``wamlive`` autotune preset
  (a `Candidate` sweep weighted by what the fleet actually served instead
  of a canned geometry), and
- `drift_report` scores against a prediction (the tuned schedule entry's
  measured per-item time, or the window's own earliest batches when no
  prediction exists) to decide whether the live workload has drifted away
  from whatever the current schedule was tuned for. Drift in EITHER
  direction counts: per-item service times rising past ``threshold`` ×
  the baseline mean the schedule is under-provisioned; times falling
  below ``1/threshold`` × mean the mix shifted toward work the schedule
  over-provisions (fuller batches, colder caches). Both are the trigger
  that kicks off a shadow sweep (`wam_tpu_torch.tune.online`).

Reading is tolerant by construction — `results.read_jsonl_stats` skips
torn lines with a counted `LedgerCorruptWarning`, and the corrupt count is
surfaced on the mix so a mostly-torn ledger is visible to operators.
"""

from __future__ import annotations

import dataclasses

from wam_tpu_torch.results import read_jsonl_stats

__all__ = [
    "BucketObservation",
    "WorkloadMix",
    "mine_ledger",
    "mine_rows",
    "drift_report",
    "DEFAULT_DRIFT_THRESHOLD",
    "BASELINE_FRAC",
    "RECENT_FRAC",
]

# two-sided drift gate: a bucket drifts when observed/baseline per-item
# service leaves [1/threshold, threshold]
DEFAULT_DRIFT_THRESHOLD = 1.5

# self-baseline split when no tuned prediction exists: the earliest this
# fraction of a bucket's batches (by timestamp) is "what the schedule was
# tuned for"
BASELINE_FRAC = 0.25

# the observation the baseline is scored against: the LATEST this fraction
# of the bucket's batches. Comparing head against tail (not head against
# everything-after-head) keeps a recent shift visible even when most of
# the window predates it — a 70%-light/30%-heavy window must read as
# "drifted heavy", not as a mildly-worse average.
RECENT_FRAC = 0.25

# below this many batches a bucket carries no drift signal (a ratio of
# two 2-batch means is noise, not evidence)
MIN_DRIFT_BATCHES = 6


@dataclasses.dataclass
class BucketObservation:
    """One bucket's observed traffic over the mined window."""

    key: str
    shape: tuple
    model_id: str | None = None  # paged-model identity, None = default entry
    batches: int = 0
    items: int = 0  # total real rows served
    per_item_s: list = dataclasses.field(default_factory=list)
    timestamps: list = dataclasses.field(default_factory=list)
    occupancies: list = dataclasses.field(default_factory=list)
    queue_depths: list = dataclasses.field(default_factory=list)
    qos: dict = dataclasses.field(default_factory=dict)
    fingerprints: dict = dataclasses.field(default_factory=dict)

    @property
    def mean_per_item_s(self) -> float:
        if not self.per_item_s:
            return 0.0
        return sum(self.per_item_s) / len(self.per_item_s)

    @property
    def mean_batch(self) -> float:
        """Mean real rows per dispatched batch (the wamlive batch size)."""
        return self.items / self.batches if self.batches else 0.0


@dataclasses.dataclass
class WorkloadMix:
    """The observed workload distribution mined from a serve ledger."""

    source: str
    rows: int  # serve_batch rows inside the window
    corrupt_lines: int
    window: tuple  # (earliest, latest) row timestamp
    buckets: dict  # bucket key -> BucketObservation
    qos: dict  # class -> items (aggregate across buckets)
    fingerprints: dict  # schedule fingerprint -> batches observed under it
    # tenant -> items (aggregate), mined from the per-batch tenant counts;
    # empty for ledgers whose rows carry no ``tenants`` field
    tenants: dict = dataclasses.field(default_factory=dict)

    @property
    def total_items(self) -> int:
        return sum(b.items for b in self.buckets.values())

    def weights(self) -> dict:
        """Items-proportional bucket weights (sum to 1.0)."""
        total = self.total_items
        if total <= 0:
            return {k: 0.0 for k in self.buckets}
        return {k: b.items / total for k, b in self.buckets.items()}

    def dominant(self, n: int = 3) -> list:
        """The ``n`` heaviest buckets by served items (stable key order on
        ties — the wamlive preset must be deterministic for a given mix)."""
        ranked = sorted(self.buckets.values(),
                        key=lambda b: (-b.items, b.key))
        return ranked[:n]

    def to_dict(self) -> dict:
        """JSON-friendly report body (the online tuner's ``mix`` block)."""
        return {
            "source": self.source,
            "rows": self.rows,
            "corrupt_lines": self.corrupt_lines,
            "window_s": (self.window[1] - self.window[0]) if self.rows else 0.0,
            "total_items": self.total_items,
            "qos": dict(self.qos),
            "fingerprints": dict(self.fingerprints),
            "tenants": dict(self.tenants),
            "buckets": {
                k: {
                    "batches": b.batches,
                    "items": b.items,
                    "weight": round(w, 4),
                    "mean_per_item_s": round(b.mean_per_item_s, 6),
                    "mean_batch": round(b.mean_batch, 2),
                    "qos": dict(b.qos),
                    **({"model_id": b.model_id} if b.model_id else {}),
                }
                for (k, b), w in zip(sorted(self.buckets.items()),
                                     (self.weights()[k]
                                      for k in sorted(self.buckets)))
            },
        }


def mine_rows(rows: list, *, source: str = "<rows>", corrupt: int = 0,
              window_s: float | None = None) -> WorkloadMix | None:
    """Build a `WorkloadMix` from already-parsed ledger rows. Only
    ``serve_batch`` rows count; with ``window_s`` the window is anchored at
    the LATEST row's timestamp (the ledger's own clock — mining an old
    ledger must see the same window a live miner saw). Returns None when
    the window holds no batches (an empty mix steers nothing)."""
    batches = [r for r in rows if r.get("metric") == "serve_batch"
               and r.get("timestamp") is not None and r.get("n_real")]
    if not batches:
        return None
    latest = max(r["timestamp"] for r in batches)
    if window_s is not None:
        batches = [r for r in batches if r["timestamp"] >= latest - window_s]
    earliest = min(r["timestamp"] for r in batches)
    buckets: dict[str, BucketObservation] = {}
    qos_total: dict[str, int] = {}
    fingerprints: dict[str, int] = {}
    tenants_total: dict[str, int] = {}
    for r in sorted(batches, key=lambda r: r["timestamp"]):
        shape = tuple(int(d) for d in r.get("bucket", ()))
        key = "x".join(str(d) for d in shape) if shape else "-"
        # paged-model batches mine under model-qualified keys (the serve
        # EMA convention, "model|bucket") so one model's service times
        # never pollute another's drift baseline on a shared fleet
        mid = r.get("model_id")
        if mid:
            key = f"{mid}|{key}"
        obs = buckets.get(key)
        if obs is None:
            obs = buckets[key] = BucketObservation(key=key, shape=shape,
                                                   model_id=mid)
        n = int(r["n_real"])
        obs.batches += 1
        obs.items += n
        obs.per_item_s.append(float(r.get("service_s", 0.0)) / max(1, n))
        obs.timestamps.append(float(r["timestamp"]))
        obs.occupancies.append(float(r.get("occupancy",
                                           r.get("fill_ratio", 0.0))))
        obs.queue_depths.append(float(r.get("queue_depth", 0)))
        for cls, cnt in (r.get("qos") or {}).items():
            obs.qos[cls] = obs.qos.get(cls, 0) + int(cnt)
            qos_total[cls] = qos_total.get(cls, 0) + int(cnt)
        for tenant, cnt in (r.get("tenants") or {}).items():
            tenants_total[tenant] = tenants_total.get(tenant, 0) + int(cnt)
        fp = r.get("schedule_fingerprint")
        if fp:
            fingerprints[fp] = fingerprints.get(fp, 0) + 1
    return WorkloadMix(source=source, rows=len(batches),
                       corrupt_lines=corrupt, window=(earliest, latest),
                       buckets=buckets, qos=qos_total,
                       fingerprints=fingerprints, tenants=tenants_total)


def mine_ledger(path: str, *, window_s: float | None = None) -> WorkloadMix | None:
    """Mine one JSONL serve ledger into a `WorkloadMix` via the tolerant
    reader (torn lines are skipped, counted onto the mix). Returns None
    for a missing/empty ledger or one with no ``serve_batch`` rows."""
    try:
        rows, corrupt = read_jsonl_stats(path)
    except OSError:
        return None
    return mine_rows(rows, source=path, corrupt=corrupt, window_s=window_s)


def drift_report(mix: WorkloadMix, *, threshold: float = DEFAULT_DRIFT_THRESHOLD,
                 predictions: dict | None = None,
                 min_batches: int = MIN_DRIFT_BATCHES) -> dict:
    """Score each bucket's observed per-item service against its
    prediction. The observation is always the trailing `RECENT_FRAC` of
    the bucket's batches — drift is about what the fleet serves NOW.
    ``predictions`` maps bucket key -> predicted per-item seconds (the
    tuned schedule entry's measured ``median_s / items``); buckets
    without one fall back to the self-baseline: the earliest
    `BASELINE_FRAC` of the bucket's own batches. A bucket with fewer than
    ``min_batches`` batches is reported but never drifts (two-batch ratios
    are noise). The report is pure data — the online tuner publishes the
    gauge and the ``schedule_drift`` ledger rows from it."""
    if threshold <= 1.0:
        raise ValueError(f"drift threshold must be > 1.0, got {threshold}")
    out: dict[str, dict] = {}
    drifted: list[str] = []
    for key in sorted(mix.buckets):
        obs = mix.buckets[key]
        pred = (predictions or {}).get(key)
        tail = max(2, int(len(obs.per_item_s) * RECENT_FRAC))
        recent = obs.per_item_s[-tail:]
        if pred is not None and pred > 0:
            baseline = float(pred)
            source = "tuned"
        else:
            split = max(2, int(len(obs.per_item_s) * BASELINE_FRAC))
            base = obs.per_item_s[:split]
            baseline = sum(base) / len(base) if base else 0.0
            source = "self"
            if split >= len(obs.per_item_s):
                # window too small to hold both a head and a tail
                recent = []
        if obs.batches < min_batches or not recent or baseline <= 0:
            out[key] = {"ratio": 1.0, "baseline_s": baseline,
                        "observed_s": obs.mean_per_item_s,
                        "batches": obs.batches, "source": "insufficient",
                        "drifted": False}
            continue
        observed = sum(recent) / len(recent)
        ratio = observed / baseline
        is_drift = ratio > threshold or ratio < 1.0 / threshold
        out[key] = {"ratio": ratio, "baseline_s": baseline,
                    "observed_s": observed, "batches": obs.batches,
                    "source": source, "drifted": is_drift}
        if is_drift:
            drifted.append(key)
    ratios = [b["ratio"] for b in out.values()]
    # the headline ratio is the FARTHEST from 1.0 in log space, so a
    # 0.4x speed-up drift ranks above a 1.6x slow-down drift
    worst = max(ratios, key=lambda r: abs(r - 1.0) + abs(1.0 / max(r, 1e-9) - 1.0),
                default=1.0)
    return {"threshold": threshold, "buckets": out, "drifted": drifted,
            "worst_ratio": worst}
