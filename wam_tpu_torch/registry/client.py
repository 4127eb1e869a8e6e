"""Hydrate side of the compile-artifact registry (PyTorch port of
`wam_tpu.registry.client`).

`RegistryClient` turns a published bundle (`bundle.publish_bundle`) into
warm local caches: verified compiled-step payloads seeded into the
compiled-step cache (`pipeline.aot.seed_aot_payload`, header origin
"registry" so later consults attribute the skipped compile), compile-cache
files and kernel libraries copied in by name, and the tuned-schedule
snapshot merged under local entries. The serve stack calls `hydrate()`
before any warmup (`AttributionServer.start()`, `FleetServer.start(
registry=)`, supervisor rebuilds, a paged `ModelSpec`), so a fresh process
with cold caches serves its first request at ``compile_count == 0``.

Miss semantics mirror the caches this layer feeds: **any mismatch is a
silent per-artifact miss, never an error**. A torn manifest is an empty
bundle; a stale registry schema or a foreign platform fingerprint skips the
bundle wholesale; a digest mismatch skips that one artifact (and records a
``registry_miss`` AOT event); a kernel library whose name is not what this
checkout's sources hash to is skipped ("stale"). Whatever could not hydrate
simply compiles, as if no bundle had been offered. ``WAM_TPU_NO_REGISTRY=1``
is the kill switch: no bundle IO at all.

Bundles are read through a ``fetcher(relpath) -> bytes`` callable
(default: the local bundle directory). Every hydration gives a
`HydrationReport`: one ledger row (``metric: "registry_hydration"``)
written by the serve close path, plus ``wam_tpu_registry_*`` counters on
the obs registry.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import time

from wam_tpu_torch.obs.registry import registry as _obs_registry
from wam_tpu_torch.registry.bundle import (
    INDUCTOR,
    KERNELS,
    REGISTRY_SCHEMA_VERSION,
    default_compile_dir,
    fingerprint_mismatch,
    kernel_library_dir,
    load_manifest,
)

__all__ = [
    "registry_disabled",
    "local_fetcher",
    "HydrationReport",
    "RegistryClient",
    "resolve_client",
]

_hydrations = _obs_registry.counter(
    "wam_tpu_registry_hydrations_total",
    "registry bundle hydration attempts by terminal status",
    labels=("status",))
_artifacts = _obs_registry.counter(
    "wam_tpu_registry_artifacts_total",
    "per-artifact hydration outcomes", labels=("kind", "outcome"))
_schedules = _obs_registry.counter(
    "wam_tpu_registry_schedules_total",
    "schedule-snapshot merge outcomes", labels=("outcome",))


def registry_disabled() -> bool:
    """`WAM_TPU_NO_REGISTRY=1`: hydrate becomes a no-op reporting status
    "disabled", with zero bundle IO."""
    return os.environ.get("WAM_TPU_NO_REGISTRY", "") not in ("", "0")


def local_fetcher(bundle_dir: str):
    """``fetcher(relpath) -> bytes`` over a local bundle directory. Raises
    OSError on a missing file (the callers turn that into a miss)."""

    def fetch(relpath: str) -> bytes:
        with open(os.path.join(bundle_dir, relpath), "rb") as f:
            return f.read()

    return fetch


class HydrationReport:
    """What one `RegistryClient.hydrate` did: terminal ``status`` (a
    wholesale status, or "hydrated"/"empty" when the bundle was walked),
    per-(kind, outcome) artifact ``counts``, and the number of schedule
    entries merged. `row()` is the serve-ledger form."""

    def __init__(self, bundle: str, status: str,
                 counts: dict | None = None, schedules_added: int = 0,
                 schedules_status: str = "none", duration_s: float = 0.0):
        self.bundle = bundle
        self.status = status
        self.counts = dict(counts or {})
        self.schedules_added = schedules_added
        self.schedules_status = schedules_status
        self.duration_s = duration_s

    def count(self, kind: str, outcome: str) -> int:
        return self.counts.get(f"{kind}:{outcome}", 0)

    @property
    def hydrated(self) -> int:
        return sum(n for k, n in self.counts.items() if k.endswith(":hydrated"))

    def row(self) -> dict:
        from wam_tpu_torch.serve.metrics import SCHEMA_VERSION

        return {
            "metric": "registry_hydration",
            "schema_version": SCHEMA_VERSION,
            "bundle": self.bundle,
            "status": self.status,
            "artifacts": dict(self.counts),
            "hydrated": self.hydrated,
            "schedules_added": self.schedules_added,
            "schedules_status": self.schedules_status,
            "duration_s": self.duration_s,
            "t": time.time(),
        }

    def __repr__(self):
        return (f"HydrationReport(bundle={self.bundle!r}, "
                f"status={self.status!r}, hydrated={self.hydrated}, "
                f"schedules_added={self.schedules_added})")


def _library_names() -> set[str]:
    """The kernel library names this checkout's sources hash to."""
    from wam_tpu_torch.kernels import KERNELS as _K

    return {k.library_path().name for k in _K.values()}


class RegistryClient:
    """Probe / hydrate one bundle. ``bundle`` is a local directory path;
    pass ``fetcher`` to read the same layout from anywhere."""

    def __init__(self, bundle: str, fetcher=None):
        self.bundle = str(bundle)
        self.fetcher = fetcher or local_fetcher(self.bundle)
        self._manifest: dict | None = None
        self._loaded = False

    def manifest(self) -> dict | None:
        """Cached tolerant manifest read: None on missing/torn/non-JSON."""
        if not self._loaded:
            self._manifest = load_manifest(self.bundle, self.fetcher)
            self._loaded = True
        return self._manifest

    # -- classification ---------------------------------------------------

    def _wholesale_status(self, manifest) -> str | None:
        """The reason the WHOLE bundle cannot hydrate here, or None."""
        if manifest is None:
            return "no_manifest"
        if manifest.get("registry_schema_version") != REGISTRY_SCHEMA_VERSION:
            return "stale_schema"
        cause = fingerprint_mismatch(manifest.get("platform"))
        if cause == "version":
            return "version_mismatch"
        if cause == "platform":
            return "platform_mismatch"
        return None

    def _fetch_verified(self, art: dict):
        """(payload, outcome): the bytes when the artifact fetched and its
        digest verified, else (None, "fetch_error"|"digest_mismatch")."""
        try:
            payload = self.fetcher(art["file"])
        except Exception:
            return None, "fetch_error"
        if hashlib.sha256(payload).hexdigest() != art.get("sha256"):
            return None, "digest_mismatch"
        return payload, "ok"

    def _target(self, key: str, compile_dir, library_dir) -> str | None:
        """Where a compile artifact goes on this host, or None when it must
        not be written: a path escaping its root, an unknown prefix, or a
        kernel library this checkout's sources do not hash to."""
        if key.startswith(KERNELS):
            name = key[len(KERNELS):]
            if name not in _library_names():
                return None
            return os.path.join(library_dir or kernel_library_dir(), name)
        if not key.startswith(INDUCTOR):
            return None
        root = os.path.normpath(compile_dir or default_compile_dir())
        path = os.path.normpath(os.path.join(root, key[len(INDUCTOR):]))
        return path if path.startswith(root + os.sep) else None

    def _locally_present(self, art: dict, aot_dir, compile_dir, library_dir) -> bool:
        """Is this artifact already a VALID local cache entry? (A corrupt
        local file is not present: hydrate overwrites it.)"""
        from wam_tpu_torch.pipeline.aot import read_aot_payload

        if art.get("kind") == "aot":
            payload, _ = read_aot_payload(str(art.get("key")), aot_dir)
            return payload is not None
        if art.get("kind") == "compile":
            path = self._target(str(art.get("key")), compile_dir, library_dir)
            return path is not None and os.path.isfile(path)
        return False

    def probe(self, aot_dir: str | None = None, compile_dir: str | None = None,
              library_dir: str | None = None) -> dict:
        """Non-writing per-artifact breakdown. The kill switch does NOT
        silence this. Each artifact row gains an ``outcome``: "ok" (would
        hydrate), "present" (already local), "stale" (a kernel library of
        other sources), "digest_mismatch" / "fetch_error", or the wholesale
        cause stamped on every row."""
        manifest = self.manifest()
        wholesale = self._wholesale_status(manifest)
        rows = []
        hydratable = 0
        for art in (manifest or {}).get("artifacts") or []:
            if not isinstance(art, dict):
                continue
            row = {k: art.get(k) for k in ("kind", "key", "file", "sha256", "bytes")}
            if wholesale:
                row["outcome"] = wholesale
            else:
                payload, outcome = self._fetch_verified(art)
                if payload is None:
                    row["outcome"] = outcome
                elif (art.get("kind") == "compile"
                      and self._target(str(art.get("key")), compile_dir, library_dir) is None):
                    row["outcome"] = "stale"
                elif self._locally_present(art, aot_dir, compile_dir, library_dir):
                    row["outcome"] = "present"
                    hydratable += 1  # present counts: the cache IS warm
                else:
                    row["outcome"] = "ok"
                    hydratable += 1
            rows.append(row)
        sched = (manifest or {}).get("schedules") if not wholesale else None
        return {
            "bundle": self.bundle,
            "status": wholesale or "ok",
            "artifacts": rows,
            "hydratable": hydratable,
            "schedules": len((sched or {}).get("schedules") or {}),
        }

    # -- hydrate ----------------------------------------------------------

    def hydrate(self, aot_dir: str | None = None, schedule_path: str | None = None,
                compile_dir: str | None = None,
                library_dir: str | None = None) -> HydrationReport:
        """Seed the local caches from the bundle. Never raises for bundle
        problems; the report says what happened and the process compiles
        whatever did not hydrate."""
        t0 = time.time()
        if registry_disabled():
            return self._finish(HydrationReport(self.bundle, "disabled"), t0)
        manifest = self.manifest()
        wholesale = self._wholesale_status(manifest)
        if wholesale:
            return self._finish(HydrationReport(self.bundle, wholesale), t0)

        from wam_tpu_torch.obs import sentinel
        from wam_tpu_torch.pipeline.aot import _key_backend, platform, seed_aot_payload

        counts: dict[str, int] = {}

        def bump(kind: str, outcome: str):
            counts[f"{kind}:{outcome}"] = counts.get(f"{kind}:{outcome}", 0) + 1
            _artifacts.inc(kind=kind, outcome=outcome)

        plat = manifest.get("platform") or {}
        for art in manifest.get("artifacts") or []:
            if not isinstance(art, dict):
                continue
            kind, key = art.get("kind"), str(art.get("key"))
            if kind not in ("aot", "compile"):
                bump(str(kind), "unknown_kind")
                continue
            target = None
            if kind == "compile":
                target = self._target(key, compile_dir, library_dir)
                if target is None:
                    bump(kind, "stale")
                    continue
            if self._locally_present(art, aot_dir, compile_dir, library_dir):
                bump(kind, "present")  # the local cache wins: hydrate is idempotent
                continue
            payload, outcome = self._fetch_verified(art)
            if payload is None:
                bump(kind, outcome)
                if kind == "aot":
                    sentinel.record_aot("registry_miss", key)
                continue
            if kind == "aot":
                path = seed_aot_payload(key, payload, aot_dir, torch_version=plat.get("torch"),
                                        platform_=platform(_key_backend(key)))
                bump(kind, "hydrated" if path else "write_error")
            else:
                bump(kind, "hydrated" if _write_file(target, payload) else "write_error")

        added, sched_status = self._merge_schedules(manifest.get("schedules"), schedule_path)
        status = "hydrated" if (counts or added) else "empty"
        report = HydrationReport(self.bundle, status, counts, schedules_added=added,
                                 schedules_status=sched_status)
        return self._finish(report, t0)

    def _merge_schedules(self, snapshot, schedule_path) -> tuple[int, str]:
        """Merge the bundle's schedule snapshot UNDER local entries (local
        wins: a locally tuned schedule reflects this machine). A stale
        snapshot version is ignored wholesale."""
        from wam_tpu_torch.tune.cache import (
            SCHEDULE_CACHE_VERSION,
            ScheduleCache,
            invalidate_process_cache,
        )

        if not isinstance(snapshot, dict):
            _schedules.inc(outcome="absent")
            return 0, "absent"
        if snapshot.get("version") != SCHEDULE_CACHE_VERSION:
            _schedules.inc(outcome="stale")
            return 0, "stale"
        entries = snapshot.get("schedules")
        if not isinstance(entries, dict) or not entries:
            _schedules.inc(outcome="empty")
            return 0, "empty"
        cache = ScheduleCache(path=schedule_path)
        added = 0
        for key, ent in entries.items():
            if isinstance(ent, dict) and cache.get(key) is None:
                cache.put(key, ent)
                added += 1
        if added:
            cache.save()
            invalidate_process_cache()
            _schedules.inc(added, outcome="added")
        _schedules.inc(outcome="merged")
        return added, "merged"

    def _finish(self, report: HydrationReport, t0: float) -> HydrationReport:
        report.duration_s = time.time() - t0
        _hydrations.inc(status=report.status)
        return report


def _write_file(path: str, payload: bytes) -> bool:
    """Atomic write of one hydrated file (tmp + rename)."""
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
    except OSError:
        return False
    return True


def resolve_client(registry) -> "RegistryClient | None":
    """Normalize the serve stack's ``registry=``: None/"" -> None, a path
    -> `RegistryClient(path)`, a client -> itself."""
    if registry is None or registry == "":
        return None
    if isinstance(registry, RegistryClient):
        return registry
    return RegistryClient(str(registry))
