"""Online schedule learning: the ledger-mined shadow tuner (PyTorch port
of `wam_tpu.tune.online`).

A champion / challenger pipeline over the serve ledger:

1. **Mine** the JSONL ledger into a `WorkloadMix` (`tune.mix`, tolerant
   readers): the observed bucket x qos histogram.
2. **Detect drift**: score each bucket's observed service against the tuned
   prediction (`mix.drift_report`, two-sided). Drifted buckets publish the
   ``wam_tpu_tune_drift_ratio`` gauge and a ``schedule_drift`` v2 ledger
   row, and trigger step 3.
3. **Shadow sweep**: re-run the `Candidate` sweep on the observed
   distribution (the ``wamlive`` preset) plus a serve-plane proposal
   (`plan_serve_schedule`: grow / shrink the admission ``bucket_cap`` from
   observed occupancy and queue pressure). The result is a CHALLENGER
   table, written to its own file and fingerprinted as serving would
   fingerprint it (`cache.entries_fingerprint`), never installed yet.
4. **Canary A/B**: the fleet pins one replica to the challenger
   (`serve.FleetServer.pin_canary`) and ``serve_batch`` rows carry each
   replica's fingerprint, so `canary_verdict` compares the two arms from
   the ledger alone.
5. **Promote**: on a clear win, install the challenger's entries into the
   live table, publish them as a registry bundle (``bundle_dir``:
   `wam_tpu_torch.registry`, the schedules and the compiled steps named by
   ``bundle_aot_keys``), and record a ``schedule_promotion`` v2 row.

``python -m wam_tpu_torch.tune.online --ledger L --once`` runs one
mine -> drift -> sweep pass (exit 1 when the ledger yields no mix);
without ``--once`` it loops on ``--interval-s``. ``WAM_TPU_NO_ONLINE_TUNE``
is the kill switch: every pass becomes a no-op reporting
``{"disabled": true}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

from wam_tpu_torch.obs.registry import registry as _obs_registry
from wam_tpu_torch.tune.mix import (
    DEFAULT_DRIFT_THRESHOLD,
    MIN_DRIFT_BATCHES,
    WorkloadMix,
    drift_report,
    mine_ledger,
)

__all__ = [
    "ONLINE_TUNE_ENV",
    "online_tune_disabled",
    "OnlineTuneConfig",
    "OnlineTuner",
    "plan_serve_schedule",
    "canary_verdict",
    "main",
]

# kill switch: freeze all online schedule churn (mining still works — it
# is read-only — but drift rows, sweeps, and promotions are suppressed)
ONLINE_TUNE_ENV = "WAM_TPU_NO_ONLINE_TUNE"

_g_drift = _obs_registry.gauge(
    "wam_tpu_tune_drift_ratio",
    "observed/predicted per-item service ratio per bucket (1.0 = on "
    "prediction; outside [1/θ, θ] raises the drift alarm)",
    labels=("bucket",))
_c_sweeps = _obs_registry.counter(
    "wam_tpu_tune_sweeps_total", "shadow sweeps run by the online tuner")
_c_promotions = _obs_registry.counter(
    "wam_tpu_tune_promotions_total",
    "challenger schedules promoted to champion")

# v2 ledger rows share the serve schema version
from wam_tpu_torch.serve.metrics import SCHEMA_VERSION  # noqa: E402


def online_tune_disabled() -> bool:
    return os.environ.get(ONLINE_TUNE_ENV, "") not in ("", "0")


@dataclasses.dataclass
class OnlineTuneConfig:
    """One shadow-tuner pass, fully file-driven (testable without a fleet).

    ``ledger`` is the serve JSONL to mine; ``out_ledger`` receives the
    tuner's own ``schedule_drift`` / ``schedule_promotion`` rows (defaults
    to the input ledger — the tuner annotates the stream it reads)."""

    ledger: str
    out_ledger: str | None = None
    window_s: float | None = None
    drift_threshold: float = DEFAULT_DRIFT_THRESHOLD
    min_batches: int = MIN_DRIFT_BATCHES
    force_sweep: bool = False  # sweep even without a drift alarm
    n_samples: int = 8
    sweep_k: int = 2
    sweep_laps: int = 1
    promote_margin: float = 0.05  # challenger must win by ≥ 5%
    canary_min_batches: int = 8  # per arm, before a verdict counts
    max_cap: int = 32  # bucket_cap growth ceiling (plan_serve_schedule)
    default_cap: int = 8  # the fleet's preset cap when no entry resolves
    replicas: int = 1  # fleet width the serve entries are keyed under
    challenger_path: str | None = None  # default: <ledger>.challenger.json
    bundle_dir: str | None = None  # publish target; None = no bundle
    # compiled-step keys to ship in the promotion bundle; None publishes
    # every local entry, [] a schedules-only bundle (the common case: a
    # promotion changes admission caps and sweep winners, not kernels)
    bundle_aot_keys: list | None = None
    # where the shadow sweep runs: None takes the card, or raises without
    # one (`device.resolve_device`); "cpu" asks for the plain versions
    device: str | None = None

    def __post_init__(self):
        from wam_tpu_torch.device import resolve_device

        self.device = str(resolve_device(self.device))


def plan_serve_schedule(mix: WorkloadMix, *, current_cap: int | None = None,
                        max_cap: int = 32, default_cap: int = 8,
                        replicas: int = 1) -> dict:
    """Admission-plane proposal from observed occupancy + queue pressure:
    per dominant bucket, a ``{"bucket_cap": N}`` entry keyed the way the
    serve path resolves it (workload "serve", the bucket's item shape,
    batch=``replicas`` — `resolve_bucket_cap` keys the cap by fleet width,
    so a challenger tuned against a 2-replica fleet only steers 2-replica
    fleets). Saturated buckets
    (mean occupancy ≥ 0.85 with standing queue) double the cap toward
    ``max_cap``; cold ones (occupancy < 0.35) halve back toward
    ``default_cap``; in between keeps the current cap. ``current_cap``
    None resolves each bucket's LIVE tuned cap (the table the challenger
    would replace), so growth is relative to what is actually serving.
    Returns {bucket_key: (shape, entry)} — the sweep merges these into
    the challenger table."""
    from wam_tpu_torch.tune.cache import resolve_bucket_cap

    out: dict[str, tuple] = {}
    for b in mix.dominant(3):
        if not b.occupancies:
            continue
        occ = sum(b.occupancies) / len(b.occupancies)
        queue = (sum(b.queue_depths) / len(b.queue_depths)
                 if b.queue_depths else 0.0)
        cap = (int(current_cap) if current_cap is not None
               else resolve_bucket_cap("auto", b.shape, replicas=replicas,
                                       default=default_cap))
        if occ >= 0.85 and queue > 0.5:
            cap = min(int(max_cap), cap * 2)
        elif occ < 0.35 and cap > default_cap:
            cap = max(default_cap, cap // 2)
        out[b.key] = (b.shape, replicas, {
            "bucket_cap": cap,
            "occupancy_mean": round(occ, 3),
            "queue_depth_mean": round(queue, 2),
            "source": "online:plan_serve_schedule",
        })
    return out


def canary_verdict(rows: list, champion_fp: str, challenger_fp: str, *,
                   margin: float = 0.05, min_batches: int = 8,
                   since: float | None = None) -> dict:
    """Champion-vs-challenger comparison from fingerprint-stamped
    ``serve_batch`` rows alone (each row carries its replica's schedule
    fingerprint). Pure: no fleet handle, no clock — testable from a synthetic ledger.

    ``since`` drops rows stamped before the canary window opened: the
    champion fingerprint also stamps every PRE-canary row, and a window
    that opened after a mix shift must not let the champion arm coast on
    its light-era history.

    The challenger **wins** when both arms have ≥ ``min_batches`` batches
    and its mean per-item service is at least ``margin`` below the
    champion's. ``insufficient`` (not a loss) until both arms qualify."""
    arms: dict[str, list] = {champion_fp: [], challenger_fp: []}
    for r in rows:
        if r.get("metric") != "serve_batch" or not r.get("n_real"):
            continue
        if since is not None and float(r.get("timestamp", 0.0)) < since:
            continue
        fp = r.get("schedule_fingerprint")
        if fp in arms:
            arms[fp].append(float(r.get("service_s", 0.0))
                            / max(1, int(r["n_real"])))
    champ, chall = arms[champion_fp], arms[challenger_fp]
    out = {
        "champion_fp": champion_fp,
        "challenger_fp": challenger_fp,
        "champion_batches": len(champ),
        "challenger_batches": len(chall),
        "margin": margin,
    }
    if len(champ) < min_batches or len(chall) < min_batches:
        out.update(verdict="insufficient", win=False)
        return out
    champ_s = sum(champ) / len(champ)
    chall_s = sum(chall) / len(chall)
    win = chall_s <= champ_s * (1.0 - margin)
    out.update(
        champion_per_item_s=champ_s,
        challenger_per_item_s=chall_s,
        improvement=(champ_s - chall_s) / champ_s if champ_s > 0 else 0.0,
        verdict="challenger" if win else "champion",
        win=win,
    )
    return out


class OnlineTuner:
    """The composable shadow tuner: ``mine`` → ``detect_drift`` →
    ``sweep`` → (external canary window) → ``promote``. ``step`` wires the
    whole pass for the CLI loop; the pieces stay separately callable so the
    serving harness can interleave its own canary phase between sweep and
    promote."""

    def __init__(self, config: OnlineTuneConfig, *, log=None):
        self.config = config
        self.log = log or (lambda s: None)
        self._writer = None

    # -- ledger output -----------------------------------------------------

    def _write_row(self, row: dict) -> None:
        from wam_tpu_torch.results import JsonlWriter

        path = self.config.out_ledger or self.config.ledger
        if self._writer is None or self._writer.path != path:
            self._writer = JsonlWriter(path)
        self._writer.write(row)

    # -- pipeline stages ---------------------------------------------------

    def mine(self) -> WorkloadMix | None:
        mix = mine_ledger(self.config.ledger, window_s=self.config.window_s)
        if mix is None:
            self.log(f"mine: no serve_batch rows in {self.config.ledger}")
        else:
            self.log(f"mine: {mix.rows} batches / {mix.total_items} items "
                     f"across {len(mix.buckets)} buckets "
                     f"({mix.corrupt_lines} corrupt lines skipped)")
        return mix

    def predictions(self, mix: WorkloadMix) -> dict:
        """Tuned per-item service predictions per observed bucket: the
        serve-key entry's measured ``median_s / items`` when a sweep
        recorded one. Buckets without a prediction drift against their own
        early window (mix.drift_report's self-baseline)."""
        from wam_tpu_torch.tune.cache import load_schedule_cache, schedule_key

        cache = load_schedule_cache()
        out: dict[str, float] = {}
        for key, b in mix.buckets.items():
            try:
                skey = schedule_key("serve", b.shape, self.config.replicas)
            except Exception:
                continue
            ent = cache.get(skey)
            if ent and ent.get("median_s") and ent.get("items"):
                out[key] = float(ent["median_s"]) / max(1, int(ent["items"]))
        return out

    def detect_drift(self, mix: WorkloadMix) -> dict:
        """Drift pass: gauge per bucket always; ``schedule_drift`` ledger
        rows only for buckets that actually drifted (and only when the
        kill switch is off — alarms are schedule churn too)."""
        report = drift_report(mix, threshold=self.config.drift_threshold,
                              predictions=self.predictions(mix),
                              min_batches=self.config.min_batches)
        for key, b in report["buckets"].items():
            _g_drift.set(b["ratio"], bucket=key)
        if online_tune_disabled():
            return report
        for key in report["drifted"]:
            b = report["buckets"][key]
            self._write_row({
                "metric": "schedule_drift",
                "schema_version": SCHEMA_VERSION,
                "bucket": key,
                "ratio": round(b["ratio"], 4),
                "observed_s": round(b["observed_s"], 6),
                "baseline_s": round(b["baseline_s"], 6),
                "baseline_source": b["source"],
                "threshold": self.config.drift_threshold,
                "batches": b["batches"],
                "timestamp": time.time(),
            })
            self.log(f"drift: bucket {key} ratio {b['ratio']:.2f} "
                     f"(baseline {b['source']})")
        return report

    def sweep(self, mix: WorkloadMix) -> dict:
        """Shadow sweep → challenger table ON DISK (never the live table):
        the wamlive `Candidate` sweep at the observed geometry plus the
        `plan_serve_schedule` admission entries, merged OVER a copy of the
        live entries so the challenger fingerprint reflects the table a
        promotion would produce. Returns {"path", "fingerprint", "keys",
        "entries", "sweep"}."""
        from wam_tpu_torch.tune.autotuner import autotune
        from wam_tpu_torch.tune.cache import (
            ScheduleCache,
            entries_fingerprint,
            schedule_key,
        )
        from wam_tpu_torch.tune.workloads import get_workload

        _c_sweeps.inc()
        wl = get_workload("wamlive", mix=mix, n_samples=self.config.n_samples,
                          device=self.config.device)
        self.log(f"sweep: wamlive over {len(wl.candidates)} candidates "
                 f"(shape {wl.shape}, batch {wl.batch})")
        res = autotune(wl, k=self.config.sweep_k, laps=self.config.sweep_laps,
                       persist=False, log=self.log)
        challenger: dict[str, dict] = {res["key"]: res["entry"]}
        plan = plan_serve_schedule(mix, max_cap=self.config.max_cap,
                                   default_cap=self.config.default_cap,
                                   replicas=self.config.replicas)
        for _bkey, (shape, replicas, entry) in sorted(plan.items()):
            challenger[schedule_key("serve", shape, replicas)] = entry
        # challenger table = live entries (pinned + user layers) +
        # challenger overrides, so its fingerprint is EXACTLY what
        # schedule_fingerprint() will return after a promotion installs
        # the same overrides
        merged = dict(ScheduleCache().entries)
        merged.update(challenger)
        fp = entries_fingerprint(merged)
        path = (self.config.challenger_path
                or f"{self.config.ledger}.challenger.json")
        out = ScheduleCache(path=path, pinned=True)
        out.entries.update(challenger)
        out.save(path)
        self.log(f"sweep: challenger {fp} -> {path} "
                 f"({len(challenger)} retuned keys)")
        return {"path": path, "fingerprint": fp,
                "keys": sorted(challenger), "entries": challenger,
                "sweep": {"key": res["key"],
                          "winner": res["winner"]["label"],
                          "items_per_s": round(res["winner"]["items_per_s"], 3),
                          "plane": res["winner"]["plane"]}}

    def promote(self, challenger: dict, verdict: dict) -> dict:
        """Install the winning challenger entries into the live user table,
        publish the bundle (schedules + the chosen compiled steps; the
        compile-cache files are skipped: a schedule flip does not
        invalidate compiled code), and record the flip as a
        ``schedule_promotion`` v2 row."""
        from wam_tpu_torch.tune.cache import (
            invalidate_process_cache,
            load_schedule_cache,
            schedule_fingerprint,
        )

        cache = load_schedule_cache()
        for key, entry in challenger["entries"].items():
            cache.put(key, entry)
        cache.save()
        invalidate_process_cache()
        live_fp = schedule_fingerprint()
        bundle = None
        if self.config.bundle_dir:
            from wam_tpu_torch.registry.bundle import publish_bundle

            manifest = publish_bundle(
                self.config.bundle_dir, keys=self.config.bundle_aot_keys,
                include_compile=False,
                source={"publisher": "tune.online",
                        "challenger_fingerprint": challenger["fingerprint"],
                        "verdict": verdict.get("verdict")},
                backend=str(self.config.device).split(":")[0])
            bundle = {"dir": self.config.bundle_dir, "artifacts": len(manifest["artifacts"])}
            self.log(f"promote: bundle -> {self.config.bundle_dir} "
                     f"({bundle['artifacts']} artifacts)")
        _c_promotions.inc()
        row = {
            "metric": "schedule_promotion",
            "schema_version": SCHEMA_VERSION,
            "champion_fp": verdict.get("champion_fp"),
            "challenger_fp": challenger["fingerprint"],
            "live_fp": live_fp,
            "keys": challenger["keys"],
            "improvement": round(float(verdict.get("improvement", 0.0)), 4),
            "champion_batches": verdict.get("champion_batches"),
            "challenger_batches": verdict.get("challenger_batches"),
            "bundle": bundle,
            "timestamp": time.time(),
        }
        self._write_row(row)
        self.log(f"promote: {challenger['fingerprint']} is champion "
                 f"(+{row['improvement'] * 100:.1f}%)")
        return {"live_fingerprint": live_fp, "bundle": bundle, "row": row}

    # -- one full pass -----------------------------------------------------

    def step(self) -> dict:
        """One mine→drift→sweep pass (the ``--once`` body). The canary
        verdict needs fingerprint-stamped traffic that only exists after a
        fleet serves WITH the challenger pinned, so ``step`` ends at the
        challenger table + drift report; the serving harness (the fleet
        loop) runs the canary window and calls ``promote`` with its
        `canary_verdict`."""
        if online_tune_disabled():
            self.log(f"online tuning disabled ({ONLINE_TUNE_ENV}=1)")
            return {"disabled": True}
        mix = self.mine()
        if mix is None:
            return {"mix": None}
        report = self.detect_drift(mix)
        out: dict = {"mix": mix.to_dict(), "drift": report}
        if report["drifted"] or self.config.force_sweep:
            out["challenger"] = self.sweep(mix)
        else:
            self.log("sweep: skipped (no drift; pass --force-sweep to "
                     "override)")
        return out


def main(argv=None) -> int:
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="python -m wam_tpu_torch.tune.online",
        description="Ledger-mined shadow tuner: mine the serve ledger, "
                    "raise drift alarms, sweep a challenger schedule.",
    )
    p.add_argument("--ledger", required=True,
                   help="serve JSONL ledger to mine")
    p.add_argument("--once", action="store_true",
                   help="one pass then exit (CI smoke); exit 1 on no mix")
    p.add_argument("--interval-s", type=float, default=300.0,
                   help="loop period without --once")
    p.add_argument("--window-s", type=float, default=None,
                   help="mine only the trailing window (ledger clock)")
    p.add_argument("--device", default="auto",
                   help="device of the shadow sweep: auto (the card; an error "
                        "without one) | cuda | cpu")
    p.add_argument("--drift-threshold", type=float,
                   default=DEFAULT_DRIFT_THRESHOLD)
    p.add_argument("--force-sweep", action="store_true",
                   help="sweep even when no bucket drifted")
    p.add_argument("--challenger", default=None,
                   help="challenger schedule file "
                        "(default <ledger>.challenger.json)")
    p.add_argument("--bundle-dir", default=None,
                   help="publish promotions as a registry bundle here")
    p.add_argument("--out-ledger", default=None,
                   help="where drift/promotion rows go (default: the "
                        "input ledger)")
    p.add_argument("--replicas", type=int, default=1,
                   help="fleet width the challenger serve entries are "
                        "keyed under (resolve_bucket_cap keys by it)")
    p.add_argument("--n-samples", type=int, default=8,
                   help="smoothgrad samples per wamlive body")
    p.add_argument("--k", type=int, default=2, help="samples per candidate")
    p.add_argument("--laps", type=int, default=1,
                   help="calls per timed region")
    args = p.parse_args(argv)

    from wam_tpu_torch.config import enable_compilation_cache
    from wam_tpu_torch.device import resolve_device

    device = str(resolve_device(args.device))
    enable_compilation_cache()

    cfg = OnlineTuneConfig(
        ledger=args.ledger,
        out_ledger=args.out_ledger,
        window_s=args.window_s,
        drift_threshold=args.drift_threshold,
        force_sweep=args.force_sweep,
        n_samples=args.n_samples,
        sweep_k=args.k,
        sweep_laps=args.laps,
        replicas=args.replicas,
        challenger_path=args.challenger,
        bundle_dir=args.bundle_dir,
        device=device,
    )
    tuner = OnlineTuner(cfg, log=lambda s: print(s, file=sys.stderr))
    while True:
        out = tuner.step()
        print(json.dumps(out))
        if args.once:
            return 0 if (out.get("disabled") or out.get("mix")) else 1
        time.sleep(args.interval_s)


if __name__ == "__main__":
    import sys

    sys.exit(main())
