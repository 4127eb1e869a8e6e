"""Declarative SLOs + rolling-window burn rates (health-plane pillar 3;
PyTorch port of `wam_tpu.obs.slo`, standard library only).

An *objective* is a per-bucket target over a rolling window: p99 latency,
error rate, health rate (`SLObjectives`). A *burn rate* is how fast the
window is consuming its error budget — 1.0 means exactly on budget, >1
means the objective will be violated if the window's behavior persists
(the standard SRE multi-window formulation, collapsed to one window):

- latency burn  = fraction of requests over the p99 target / 0.01 (the 1%
  a p99 objective budgets for),
- error burn    = observed error rate / error-rate budget,
- health burn   = observed unhealthy fraction / (1 - health-rate target),
- burn_rate     = max of the enabled components (disabled ones — target
  0/unset — contribute nothing).

`SLOTracker` keeps one deque of ``(t, latency_s, ok, healthy)`` per bucket,
prunes it to ``window_s`` on every read, and surfaces the results three
ways, all fed from the SAME floats so they can be cross-checked exactly:

- ``wam_tpu_slo_*`` registry gauges (→ ``/metrics``), republished at most
  once a second from the note path so scrapes see live values;
- an ``slo_status`` row in the v2 JSONL ledger
  (`serve.metrics.write_slo_status` wraps `snapshot_row`);
- a routing penalty: `penalty_s` maps burn > 1 onto seconds added to the
  fleet's load score, so a replica burning its budget sheds load *before*
  it dies (`serve.fleet.FleetServer._score`).

Objective policies are declared as CLI-friendly strings in
``ServeConfig.slo`` (`parse_slo`): ``"p99_ms=250,error_rate=0.01"`` applies
one objective set to every bucket; per-bucket overrides are
``;``-separated with a bucket-key prefix —
``"*:p99_ms=250;3x32x32:p99_ms=100,health_rate=0.99"``.

**QoS class dimension** (the serve admission lanes): a key may carry an
``@<class>`` suffix — ``"*@interactive:p99_ms=50;*:p99_ms=500"`` holds
interactive traffic to a tight p99 while batch traffic rides the loose
default. The serve worker notes each request with its class
(``note(bkey, ..., qos="interactive")``), which lands the sample in the
``<bucket>@<class>`` window, so burn rates stay per bucket×class.
Objective resolution for a classed window walks ``bucket@class`` →
``*@class`` → ``bucket`` → ``*``; class-less notes keep their historical
plain-bucket windows and ladder. `penalty_s` aggregates a bucket's
windows across classes (max burn), so the fleet's per-bucket routing
penalty sees a violated class even when the bucket aggregate looks fine.

**Tenant dimension** (multi-tenant serving): a classed key may carry a
second suffix — ``bucket@class@tenant`` — so each tenant's traffic burns
its own window (``note(bkey, ..., qos="interactive", tenant="acme")``).
Resolution for a tenant window walks the exact key →
``*@class@tenant`` → ``bucket@class`` → ``*@class`` → ``bucket`` → ``*``,
so a tenant with no dedicated objective inherits its class's. `penalty_s`
already aggregates by bucket prefix, so tenant windows feed the same
routing penalty.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import asdict, dataclass

from wam_tpu_torch.obs.registry import registry as _registry

__all__ = ["SLObjectives", "parse_slo", "SLOTracker", "PENALTY_SCALE_S"]

# penalty_s = max(0, burn_rate - 1) * this — at burn 2x the replica looks
# one EMA-seed's worth of service time busier than it is, enough to lose
# routing ties without starving it outright
PENALTY_SCALE_S = 0.05

# republish gauges from the note path at most this often (full window
# stats per note would sort the latency sample on every request)
_PUBLISH_MIN_INTERVAL_S = 1.0


@dataclass(frozen=True)
class SLObjectives:
    """One bucket's objectives over a rolling window. A zero/unset target
    disables that component (its burn contributes 0)."""

    p99_ms: float = 0.0
    error_rate: float = 0.0
    health_rate: float = 0.0
    window_s: float = 60.0
    # anytime serving (wam_tpu.anytime): confidence-at-delivery floor —
    # burn counts requests delivered BELOW this confidence against a 1%
    # budget (the p99 convention: an anytime server may hand out up to 1%
    # of its maps under the floor before the objective burns)
    min_confidence: float = 0.0


def parse_slo(spec) -> dict | None:
    """Parse a ``ServeConfig.slo`` policy string into a ``{bucket_key:
    SLObjectives}`` map ('*' = default). Keys may carry an ``@<class>``
    QoS suffix (``*@interactive``, ``3x32x32@batch`` — module docstring).
    Accepts an existing map or a bare `SLObjectives` (becomes the '*'
    entry); returns None for empty specs."""
    if spec is None or spec == "":
        return None
    if isinstance(spec, SLObjectives):
        return {"*": spec}
    if isinstance(spec, dict):
        return {
            str(k): (v if isinstance(v, SLObjectives) else SLObjectives(**v))
            for k, v in spec.items()
        }
    policy: dict[str, SLObjectives] = {}
    for part in str(spec).split(";"):
        part = part.strip()
        if not part:
            continue
        bucket = "*"
        body = part
        # a bucket prefix is "<key>:"; objective keys always carry '='
        if ":" in part and "=" not in part.split(":", 1)[0]:
            bucket, body = part.split(":", 1)
            bucket = bucket.strip()
        kwargs = {}
        for kv in body.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, _, v = kv.partition("=")
            k = k.strip()
            if k not in ("p99_ms", "error_rate", "health_rate", "window_s",
                         "min_confidence"):
                raise ValueError(f"unknown SLO objective {k!r} in {spec!r}")
            kwargs[k] = float(v)
        parts = bucket.split("@")
        if any(not p for p in parts[1:]):
            raise ValueError(f"empty QoS class in SLO key {bucket!r}")
        policy[bucket] = SLObjectives(**kwargs)
    return policy or None


def _label(value) -> str:
    return "-" if value is None else str(value)


_g_burn = _registry.gauge(
    "wam_tpu_slo_burn_rate",
    "error-budget burn rate over the rolling window (max component; "
    ">1 = violating)", labels=("replica", "bucket"))
_g_err = _registry.gauge(
    "wam_tpu_slo_error_rate", "observed error rate over the window",
    labels=("replica", "bucket"))
_g_health = _registry.gauge(
    "wam_tpu_slo_health_rate", "observed healthy fraction over the window",
    labels=("replica", "bucket"))
_g_p99 = _registry.gauge(
    "wam_tpu_slo_p99_seconds", "observed p99 latency over the window",
    labels=("replica", "bucket"))
_g_n = _registry.gauge(
    "wam_tpu_slo_window_requests", "requests inside the rolling window",
    labels=("replica", "bucket"))
_g_conf = _registry.gauge(
    "wam_tpu_slo_confidence",
    "mean anytime confidence-at-delivery over the window",
    labels=("replica", "bucket"))


class SLOTracker:
    """Rolling-window SLO accounting for one server (fleet replicas each
    carry their own). ``policy`` is anything `parse_slo` accepts; a None
    policy tracks nothing and burns nothing. Thread-safe; ``now`` is
    injectable for deterministic tests."""

    def __init__(self, policy, *, replica_id=None):
        self.policy = parse_slo(policy) or {}
        self.replica_id = replica_id
        self._rl = _label(replica_id)
        self._lock = threading.Lock()
        self._windows: dict[str, deque] = {}
        self._last_publish = 0.0

    def objectives_for(self, bucket_key: str) -> SLObjectives | None:
        """Policy lookup for a (possibly suffixed) window key:
        ``bucket@class`` → ``*@class`` → ``bucket`` → ``*``, and for a
        tenant window (``bucket@class@tenant``) the exact key →
        ``*@class@tenant`` → ``bucket@class`` → ``*@class`` → ``bucket``
        → ``*`` (module docstring)."""
        obj = self.policy.get(bucket_key)
        if obj is not None:
            return obj
        if "@" in bucket_key:
            bare, rest = bucket_key.split("@", 1)
            candidates = [f"*@{rest}"]
            if "@" in rest:
                qos = rest.split("@", 1)[0]
                candidates += [f"{bare}@{qos}", f"*@{qos}"]
            candidates.append(bare)
            for k in candidates:
                obj = self.policy.get(k)
                if obj is not None:
                    return obj
        return self.policy.get("*")

    # -- note path (serve worker) -------------------------------------------

    def note(self, bucket_key: str, *, latency_s: float = 0.0,
             ok: bool = True, healthy: bool = True,
             confidence: float = 1.0,
             now: float | None = None, qos: str | None = None,
             tenant: str | None = None) -> None:
        """One resolved request. ``qos`` lands the sample in the
        ``bucket@class`` window and ``tenant`` (only meaningful with a
        class) narrows it to ``bucket@class@tenant`` (module docstring).
        ``confidence`` is the anytime confidence-at-delivery (1.0 for
        full-n results, so plain servers never burn a confidence budget).
        Errors and expiries go through `note_error` (they have no
        meaningful latency sample)."""
        key = f"{bucket_key}@{qos}" if qos else bucket_key
        if qos and tenant:
            key = f"{key}@{tenant}"
        if self.objectives_for(key) is None:
            return
        now = time.perf_counter() if now is None else now
        publish = False
        with self._lock:
            self._windows.setdefault(key, deque()).append(
                (now, float(latency_s), bool(ok), bool(healthy),
                 float(confidence)))
            if now - self._last_publish >= _PUBLISH_MIN_INTERVAL_S:
                self._last_publish = now
                publish = True
        if publish:
            self.snapshot_row(now=now)

    def note_error(self, bucket_key: str, n: int = 1,
                   now: float | None = None, qos: str | None = None,
                   tenant: str | None = None) -> None:
        """Failed/expired requests: counted against the error AND health
        budgets, no latency sample."""
        key = f"{bucket_key}@{qos}" if qos else bucket_key
        if qos and tenant:
            key = f"{key}@{tenant}"
        if self.objectives_for(key) is None:
            return
        now = time.perf_counter() if now is None else now
        with self._lock:
            w = self._windows.setdefault(key, deque())
            for _ in range(int(n)):
                w.append((now, 0.0, False, False, 0.0))

    # -- window reads -------------------------------------------------------

    def _pruned(self, bucket_key: str, now: float) -> list:
        """Prune + copy one bucket's window. Caller holds no lock."""
        obj = self.objectives_for(bucket_key)
        horizon = now - (obj.window_s if obj else 60.0)
        with self._lock:
            w = self._windows.get(bucket_key)
            if w is None:
                return []
            while w and w[0][0] < horizon:
                w.popleft()
            return list(w)

    def bucket_stats(self, bucket_key: str, now: float | None = None) -> dict:
        """The window's observed rates + burn components, computed once and
        shared verbatim by the gauges, the ledger row, and the routing
        penalty (the exact-round-trip invariant). p99 is reported in
        SECONDS everywhere — no ms<->s conversion between the sinks."""
        now = time.perf_counter() if now is None else now
        obj = self.objectives_for(bucket_key) or SLObjectives()
        window = self._pruned(bucket_key, now)
        n = len(window)
        if n == 0:
            return {"n": 0, "error_rate": 0.0, "health_rate": 1.0,
                    "p99_s": 0.0, "mean_confidence": 1.0, "burn_rate": 0.0}
        errors = sum(1 for _, _, ok, _, _ in window if not ok)
        unhealthy = sum(1 for _, _, _, h, _ in window if not h)
        error_rate = errors / n
        health_rate = 1.0 - unhealthy / n
        lats = sorted(lat for _, lat, ok, _, _ in window if ok)
        confs = [c for _, _, ok, _, c in window if ok]
        mean_conf = sum(confs) / len(confs) if confs else 1.0
        if lats:
            i = min(len(lats) - 1, int(round(0.99 * (len(lats) - 1))))
            p99_s = lats[i]
        else:
            p99_s = 0.0
        burn = 0.0
        if obj.error_rate > 0.0:
            burn = max(burn, error_rate / obj.error_rate)
        if obj.health_rate > 0.0:
            allowed = max(1.0 - obj.health_rate, 1e-9)
            burn = max(burn, (1.0 - health_rate) / allowed)
        if obj.p99_ms > 0.0 and lats:
            over = sum(1 for lat in lats if lat > obj.p99_ms / 1e3)
            burn = max(burn, (over / len(lats)) / 0.01)
        if obj.min_confidence > 0.0 and confs:
            # the p99 convention: 1% of delivered maps may land under the
            # confidence floor before the objective burns (docstring)
            under = sum(1 for c in confs if c < obj.min_confidence)
            burn = max(burn, (under / len(confs)) / 0.01)
        return {"n": n, "error_rate": error_rate, "health_rate": health_rate,
                "p99_s": p99_s, "mean_confidence": mean_conf,
                "burn_rate": burn}

    def burn_rate(self, bucket_key: str, now: float | None = None) -> float:
        return self.bucket_stats(bucket_key, now=now)["burn_rate"]

    def penalty_s(self, bucket_key: str, now: float | None = None) -> float:
        """Routing penalty: seconds added to the fleet's load score while
        this bucket burns over budget (0 at/below burn 1.0). Takes the MAX
        burn across the bucket's windows — the aggregate window plus every
        per-class one — so one violated class penalizes the bucket even
        when the other class dilutes the aggregate."""
        with self._lock:
            keys = [k for k in self._windows
                    if k == bucket_key or k.startswith(bucket_key + "@")]
        if not keys:
            keys = [bucket_key]
        burn = max(self.burn_rate(k, now=now) for k in keys)
        return max(0.0, burn - 1.0) * PENALTY_SCALE_S

    # -- snapshot (gauges + ledger row, same floats) ------------------------

    def snapshot_row(self, publish: bool = True,
                     now: float | None = None) -> dict:
        """Per-bucket stats as an ``slo_status`` ledger-row body, publishing
        the same float values to the ``wam_tpu_slo_*`` gauges when asked —
        one computation, two sinks, exact agreement by construction.
        (`serve.metrics.write_slo_status` adds the schema envelope.)"""
        now = time.perf_counter() if now is None else now
        with self._lock:
            keys = sorted(self._windows)
        buckets = {}
        for bkey in keys:
            st = self.bucket_stats(bkey, now=now)
            buckets[bkey] = st
            if publish:
                _g_burn.set(st["burn_rate"], replica=self._rl, bucket=bkey)
                _g_err.set(st["error_rate"], replica=self._rl, bucket=bkey)
                _g_health.set(st["health_rate"], replica=self._rl, bucket=bkey)
                _g_p99.set(st["p99_s"], replica=self._rl, bucket=bkey)
                _g_n.set(st["n"], replica=self._rl, bucket=bkey)
                _g_conf.set(st["mean_confidence"], replica=self._rl,
                            bucket=bkey)
        row = {
            "metric": "slo_status",
            "replica_id": self.replica_id,
            "objectives": {k: asdict(v) for k, v in self.policy.items()},
            "buckets": buckets,
            "timestamp": time.time(),
        }
        tenants = sorted({k.rsplit("@", 1)[1] for k in keys
                          if k.count("@") >= 2})
        if tenants:
            row["tenants"] = tenants
        return row
