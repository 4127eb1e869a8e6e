"""Bundle format + publish side of the compile-artifact registry (PyTorch
port of `wam_tpu.registry.bundle`).

A **bundle** is one directory (`client.RegistryClient` takes a fetcher
callable, so a remote store slots in without touching this format):

    bundle/
      manifest.json              # everything below, written atomically
      artifacts/<sha256-32>.bin  # content-addressed artifact payloads

The manifest is version-headed (`REGISTRY_SCHEMA_VERSION`: a reader that
does not speak the schema ignores the bundle WHOLESALE) and carries:

- a **platform fingerprint**: backend, torch, CUDA and Triton versions,
  the device's name and compute capability, and the compiled-step and
  schedule cache versions the artifacts were produced under. Any of the
  first six differing makes the whole bundle a silent miss on hydrate (a
  compiled program is specific to all of them), as does another
  compiled-step cache version.
- **aot artifacts**: the compiled steps of the local cache
  (`pipeline/aot.py`): the cache artifacts of each compile, stored WITHOUT
  their local JSON header; hydration re-heads each with ``origin:
  "registry"`` so later consults attribute their skipped compile to the
  bundle.
- **compile artifacts** (the reference's ``xla`` kind): the port's built
  kernel libraries, keyed ``kernels/lib<source>-<hash>.so``: the compiled
  device code of K1-K5 (`kernels.BUILD_DIR`), so a new host skips
  ``nvcc``. A library is hydrated only under the name this checkout's
  sources hash to (`kernels.Kernel.library_path`), so the repo's own
  sources decide whether one is ever loaded. The files of the persistent
  compile cache (`config.enable_compilation_cache`: Inductor's and
  Triton's), keyed ``inductor/<path>``, come only on request
  (``include_compile_tree``): an aot payload already carries its
  compile's AOTAutograd, Inductor and Triton entries, so a hydrated host
  hits without them.
- a **tuned-schedule snapshot**: the merged schedule table (repo-pinned
  defaults + user cache) with its schema version, so a hydrated host
  resolves the knobs the publisher compiled under (an AOT key embeds the
  schedule).
- per-artifact **sha256 digests**: hydration verifies every payload before
  seeding; a flipped bit is one artifact's miss, never an error.

Reads are tolerant and writes atomic, as in the caches it snapshots.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time

__all__ = [
    "REGISTRY_SCHEMA_VERSION",
    "platform_fingerprint",
    "fingerprint_mismatch",
    "default_compile_dir",
    "kernel_library_dir",
    "publish_bundle",
    "load_manifest",
    "write_manifest",
]

REGISTRY_SCHEMA_VERSION = 1

# manifest-relative directory for content-addressed payloads
_ARTIFACT_DIR = "artifacts"
# compile-artifact key prefixes: compile-cache files and kernel libraries
INDUCTOR, KERNELS = "inductor/", "kernels/"
# the fingerprint fields a hydrating host must match exactly
_PLATFORM_FIELDS = ("backend", "torch", "cuda", "triton", "device", "capability")


def platform_fingerprint(backend: str | None = None) -> dict:
    """What the artifacts of a bundle were produced under (``backend``:
    "cuda" or "cpu"; None: the card when there is one). The platform
    fields and the compiled-step cache version gate hydration; the
    schedule version gates only the schedule snapshot (`client`)."""
    import torch

    from wam_tpu_torch.pipeline.aot import AOT_CACHE_VERSION, platform
    from wam_tpu_torch.tune.cache import SCHEDULE_CACHE_VERSION

    plat = platform(backend)
    return {
        "backend": plat["backend"],
        "torch": torch.__version__,
        "cuda": plat["cuda"],
        "triton": plat["triton"],
        "device": plat["device"],
        "capability": plat["capability"],
        "aot_cache_version": AOT_CACHE_VERSION,
        "schedule_cache_version": SCHEDULE_CACHE_VERSION,
    }


def fingerprint_mismatch(fingerprint: dict) -> str | None:
    """Why a manifest's fingerprint cannot hydrate HERE: "version" (the
    compiled-step cache schema differs) or "platform" (the backend, the
    card when there is one, else the CPU, as the reference compares JAX's
    default backend; or torch, CUDA, Triton, the device or its capability
    differ), None when compatible."""
    from wam_tpu_torch.pipeline.aot import AOT_CACHE_VERSION

    if not isinstance(fingerprint, dict):
        return "version"
    if fingerprint.get("aot_cache_version") != AOT_CACHE_VERSION:
        return "version"
    here = platform_fingerprint()
    if any(fingerprint.get(f) != here[f] for f in _PLATFORM_FIELDS):
        return "platform"
    return None


def default_compile_dir() -> str:
    """The persistent compile-cache directory
    (`config.enable_compilation_cache`'s default)."""
    return os.environ.get(
        "WAM_TPU_CACHE_DIR", os.path.expanduser("~/.cache/wam_tpu/inductor")
    )


def kernel_library_dir() -> str:
    """Where the port's kernel libraries are built (`kernels.BUILD_DIR`)."""
    from wam_tpu_torch.kernels import BUILD_DIR

    return str(BUILD_DIR)


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _store_payload(out_dir: str, payload: bytes) -> tuple[str, str]:
    """Write one content-addressed payload (atomic, dedup by digest);
    returns (manifest-relative file, sha256)."""
    digest = _sha256(payload)
    rel = f"{_ARTIFACT_DIR}/{digest[:32]}.bin"
    path = os.path.join(out_dir, rel)
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
    return rel, digest


def write_manifest(out_dir: str, manifest: dict) -> str:
    """Atomic manifest write (tmp + rename): a torn publish leaves the
    previous manifest or none, never half a document."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "manifest.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def load_manifest(bundle: str, fetcher=None) -> dict | None:
    """Tolerant manifest read: None on a missing, torn or non-JSON
    manifest. ``fetcher(relpath) -> bytes`` maps bundle-relative names to
    content; default is the local directory."""
    if fetcher is None:
        from wam_tpu_torch.registry.client import local_fetcher

        fetcher = local_fetcher(bundle)
    try:
        data = json.loads(fetcher("manifest.json").decode("utf-8"))
    except Exception:
        return None
    return data if isinstance(data, dict) else None


def _tree_files(root: str) -> list[tuple[str, str]]:
    """(relative key, absolute path) of every file under ``root``."""
    out: list[tuple[str, str]] = []
    for dirpath, _, names in os.walk(root):
        for name in names:
            if name.endswith((".tmp", ".lock")) or ".tmp." in name:
                continue  # in-flight writes and lock files
            path = os.path.join(dirpath, name)
            out.append((os.path.relpath(path, root), path))
    return sorted(out)


def compile_files(compile_dir: str | None = None, library_dir: str | None = None,
                  include_tree: bool = False) -> list[tuple[str, str]]:
    """(artifact key, path) of the compile artifacts this host holds: the
    kernel libraries, and with ``include_tree`` the compile cache's files
    (module docstring)."""
    rows = []
    root = compile_dir or default_compile_dir()
    if include_tree and os.path.isdir(root):
        rows += [(INDUCTOR + rel, path) for rel, path in _tree_files(root)]
    lib_root = library_dir or kernel_library_dir()
    if os.path.isdir(lib_root):
        rows += [(KERNELS + name, os.path.join(lib_root, name))
                 for name in sorted(os.listdir(lib_root))
                 if name.startswith("lib") and name.endswith(".so")]
    return rows


def publish_bundle(
    out_dir: str,
    *,
    aot_dir: str | None = None,
    schedule_path: str | None = None,
    compile_dir: str | None = None,
    library_dir: str | None = None,
    keys=None,
    include_compile: bool = True,
    include_compile_tree: bool = False,
    include_schedules: bool = True,
    source: dict | None = None,
    backend: str | None = None,
) -> dict:
    """Walk the local caches and emit a bundle directory; returns the
    manifest. ``keys`` filters the compiled-step walk to an explicit key set
    (the prewarm-manifest handoff, ``python -m wam_tpu_torch.prewarm
    --manifest``); None publishes every valid entry. Stale or corrupt local
    files are skipped: publish never fails on what the consult path would
    have ignored anyway. ``include_compile`` publishes the kernel
    libraries, and ``include_compile_tree`` the compile cache's files as
    well (module docstring). ``backend`` is the fingerprint's (None: the
    card when there is one)."""
    from wam_tpu_torch.pipeline.aot import list_aot_entries, read_aot_payload
    from wam_tpu_torch.tune.cache import SCHEDULE_CACHE_VERSION, ScheduleCache

    keyset = set(keys) if keys is not None else None
    artifacts: list[dict] = []
    for entry in list_aot_entries(aot_dir):
        if keyset is not None and entry["key"] not in keyset:
            continue
        payload, header = read_aot_payload(entry["key"], aot_dir)
        if payload is None:
            continue
        rel, digest = _store_payload(out_dir, payload)
        artifacts.append({"kind": "aot", "key": entry["key"], "file": rel,
                          "sha256": digest, "bytes": len(payload),
                          "torch": header.get("torch")})
    if include_compile:
        for key, path in compile_files(compile_dir, library_dir, include_compile_tree):
            try:
                with open(path, "rb") as f:
                    payload = f.read()
            except OSError:
                continue
            rel, digest = _store_payload(out_dir, payload)
            artifacts.append({"kind": "compile", "key": key, "file": rel,
                              "sha256": digest, "bytes": len(payload)})
    schedules = None
    if include_schedules:
        cache = ScheduleCache(path=schedule_path)
        schedules = {"version": SCHEDULE_CACHE_VERSION, "schedules": dict(cache.entries)}
    manifest = {
        "registry_schema_version": REGISTRY_SCHEMA_VERSION,
        "created_unix": time.time(),
        "platform": platform_fingerprint(backend),
        "artifacts": artifacts,
        "schedules": schedules,
    }
    if source:
        manifest["source"] = source
    write_manifest(out_dir, manifest)
    return manifest
