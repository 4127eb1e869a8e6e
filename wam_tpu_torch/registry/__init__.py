"""Versioned compile-artifact registry — publish/hydrate bundles for
compile-free cold start (PyTorch port of `wam_tpu.registry`).

The cold-start stack, bottom to top: the persistent compile cache
(`config.enable_compilation_cache`: Inductor's, AOTAutograd's and
Triton's) absorbs repeated compiles; the compiled-step cache
(`pipeline/aot.py`) keeps each keyed step's compiled artifacts; the
schedule cache (`tune/cache.py`) remembers the tuned knobs those steps were
compiled under; the port's kernel libraries (`kernels.BUILD_DIR`) are the
hand-written kernels' device code. All are per machine: a new host or a
wiped cache pays the compiles (and ``nvcc``) again. This package makes the
warm state portable: `publish_bundle` snapshots them into one
content-addressed, version-headed bundle directory, and
`RegistryClient.hydrate` verifies and seeds them on any compatible host,
so `FleetServer.start(registry=...)` serves its first request at
``compile_count == 0``.

CLI: ``python -m wam_tpu_torch.registry {publish,inspect,hydrate}``.
"""

from wam_tpu_torch.registry.bundle import (
    REGISTRY_SCHEMA_VERSION,
    load_manifest,
    platform_fingerprint,
    publish_bundle,
)
from wam_tpu_torch.registry.client import (
    HydrationReport,
    RegistryClient,
    local_fetcher,
    registry_disabled,
    resolve_client,
)

__all__ = [
    "REGISTRY_SCHEMA_VERSION",
    "platform_fingerprint",
    "publish_bundle",
    "load_manifest",
    "HydrationReport",
    "RegistryClient",
    "local_fetcher",
    "registry_disabled",
    "resolve_client",
]
