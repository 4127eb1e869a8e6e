"""CLI for the compile-artifact registry.

    # snapshot a prewarmed machine's caches into a bundle
    python -m wam_tpu_torch.prewarm --config flagship --manifest warm.json
    python -m wam_tpu_torch.registry publish --out bundle/ --from-prewarm warm.json

    # what is in it / would it hydrate here?
    python -m wam_tpu_torch.registry inspect bundle/

    # seed this machine's caches (servers do this through registry=)
    python -m wam_tpu_torch.registry hydrate bundle/

Each subcommand prints ONE JSON document to stdout. `inspect` exits 1 when
no artifact is hydratable; `publish` exits 1 when the bundle came out
empty. ``--device`` names the backend the platform fingerprint records
and is checked against (default: the card when there is one). The
reference's ``--xla-dir`` / ``--no-xla`` are ``--compile-dir`` /
``--no-compile`` here (the kernel libraries; ``publish
--with-compile-tree`` adds the compile cache's files, which the compiled
steps' own payloads make redundant, `registry.bundle`).
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_cache_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--aot-dir", default=None,
                   help="compiled-step cache dir (default: $WAM_TPU_AOT_CACHE or "
                        "~/.cache/wam_tpu/aot)")
    p.add_argument("--schedule-cache", default=None,
                   help="user schedule cache path (default: $WAM_TORCH_SCHEDULE_CACHE "
                        "or ~/.cache/wam_tpu_torch/schedules.json)")
    p.add_argument("--compile-dir", default=None,
                   help="persistent compile-cache dir (default: $WAM_TPU_CACHE_DIR or "
                        "~/.cache/wam_tpu/inductor)")
    p.add_argument("--library-dir", default=None,
                   help="kernel library dir (default: the checkout's build/wam_tpu_torch)")


def _prewarm_keys(paths: list[str]) -> tuple[list[str] | None, list[dict]]:
    """AOT keys + source descriptors from prewarm --manifest JSON files. A
    manifest without a ``warmed`` block contributes nothing; publish then
    walks the whole cache."""
    keys: list[str] = []
    sources: list[dict] = []
    saw_warmed = False
    for path in paths:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"warning: unreadable prewarm manifest {path}: {e}", file=sys.stderr)
            continue
        warmed = doc.get("warmed") if isinstance(doc, dict) else None
        if not isinstance(warmed, dict):
            continue
        saw_warmed = True
        keys.extend(k for k in warmed.get("aot_keys", ()) if isinstance(k, str))
        sources.append({
            "prewarm_manifest": path,
            "bucket_keys": warmed.get("bucket_keys"),
            "schedule_version": warmed.get("schedule_version"),
        })
    return (sorted(set(keys)) if saw_warmed else None), sources


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m wam_tpu_torch.registry",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="the backend of the platform fingerprint")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pub = sub.add_parser("publish", help="snapshot local caches -> bundle")
    pub.add_argument("--out", required=True, help="bundle output directory")
    _add_cache_flags(pub)
    pub.add_argument("--no-compile", action="store_true",
                     help="skip the kernel libraries (and the compile-cache files)")
    pub.add_argument("--with-compile-tree", action="store_true",
                     help="also publish every file of the compile cache")
    pub.add_argument("--no-schedules", action="store_true",
                     help="skip the tuned-schedule snapshot")
    pub.add_argument("--from-prewarm", nargs="+", default=None, metavar="JSON",
                     help="prewarm --manifest files: publish exactly the compiled "
                          "steps they warmed")

    ins = sub.add_parser("inspect", help="per-artifact hydratability breakdown "
                                         "(exit 1 when nothing is hydratable)")
    ins.add_argument("bundle")
    _add_cache_flags(ins)

    hyd = sub.add_parser("hydrate", help="seed local caches from a bundle")
    hyd.add_argument("bundle")
    _add_cache_flags(hyd)

    args = ap.parse_args(argv)

    if args.cmd == "publish":
        from wam_tpu_torch.registry.bundle import publish_bundle

        keys, sources = (None, [])
        if args.from_prewarm:
            keys, sources = _prewarm_keys(args.from_prewarm)
        manifest = publish_bundle(
            args.out, aot_dir=args.aot_dir, schedule_path=args.schedule_cache,
            compile_dir=args.compile_dir, library_dir=args.library_dir, keys=keys,
            include_compile=not args.no_compile,
            include_compile_tree=args.with_compile_tree and not args.no_compile,
            include_schedules=not args.no_schedules,
            source={"prewarm": sources} if sources else None, backend=args.device)
        arts = manifest["artifacts"]
        print(json.dumps({
            "bundle": args.out,
            "artifacts": len(arts),
            "aot": sum(1 for a in arts if a["kind"] == "aot"),
            "compile": sum(1 for a in arts if a["kind"] == "compile"),
            "schedules": len((manifest.get("schedules") or {}).get("schedules") or {}),
            "platform": manifest["platform"],
        }, indent=1))
        return 0 if arts else 1

    from wam_tpu_torch.registry.client import RegistryClient

    client = RegistryClient(args.bundle)
    if args.cmd == "inspect":
        report = client.probe(aot_dir=args.aot_dir, compile_dir=args.compile_dir,
                              library_dir=args.library_dir)
        print(json.dumps(report, indent=1))
        return 0 if report["hydratable"] > 0 else 1

    report = client.hydrate(aot_dir=args.aot_dir, schedule_path=args.schedule_cache,
                            compile_dir=args.compile_dir, library_dir=args.library_dir)
    print(json.dumps(report.row(), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
