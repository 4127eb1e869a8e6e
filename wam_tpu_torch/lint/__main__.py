"""CLI for the port's static-analysis subsystem.

    python -m wam_tpu_torch.lint --all                 # every rule, own scopes
    python -m wam_tpu_torch.lint wam_tpu_torch/serve   # explicit paths, all rules
    python -m wam_tpu_torch.lint --rules host-sync     # subset of rules
    python -m wam_tpu_torch.lint --format sarif        # text | json | sarif
    python -m wam_tpu_torch.lint --write-baseline      # ratchet current findings
    python -m wam_tpu_torch.lint --knobs               # env-knob audit
    python -m wam_tpu_torch.lint --knobs --write-docs  # + regenerate README table
    python -m wam_tpu_torch.lint --list-rules

Exit 1 on any non-baselined, non-pragma'd finding (or knob-audit
problem); 0 otherwise. Explicit paths disable per-rule scope filtering —
you asked for this file, every rule scans it (the legacy
check_host_syncs contract).
"""

from __future__ import annotations

import argparse
import os
import sys

from wam_tpu_torch.lint import core
from wam_tpu_torch.lint.emitters import EMITTERS
from wam_tpu_torch.lint.registry import all_rules, get_rule


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m wam_tpu_torch.lint",
        description="static analysis of the port's hot paths (AST scan, no "
                    "imports of the scanned code)")
    p.add_argument("paths", nargs="*",
                   help="files/dirs to scan (default: each rule's scope)")
    p.add_argument("--all", action="store_true",
                   help="scan every rule over its default scope "
                        "(the default when no paths are given; the flag "
                        "exists so CI lines read explicitly)")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule ids (default: all)")
    p.add_argument("--format", default="text", choices=sorted(EMITTERS),
                   dest="fmt")
    p.add_argument("--baseline", default=None,
                   help=f"baseline file (default: {core.DEFAULT_BASELINE})")
    p.add_argument("--no-baseline", action="store_true",
                   help="report baselined findings too")
    p.add_argument("--write-baseline", action="store_true",
                   help="ratchet: write current findings to the baseline")
    p.add_argument("--knobs", action="store_true",
                   help="audit the port's WAM_TPU_* / WAM_TORCH_* env knobs "
                        "against README")
    p.add_argument("--write-docs", action="store_true",
                   help="with --knobs: regenerate the README knob table")
    p.add_argument("--list-rules", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    root = core.repo_root()

    if args.list_rules:
        for cls in all_rules():
            scope = ", ".join(cls.scope) if cls.scope else "(everything)"
            print(f"{cls.id:<16} {cls.severity:<8} {scope}")
            print(f"{'':<16} {cls.description}")
        return 0

    if args.knobs:
        from wam_tpu_torch.lint import knobs
        problems, report = knobs.audit(root, write_docs=args.write_docs)
        for line in report:
            print(line)
        for line in problems:
            print(f"PROBLEM: {line}", file=sys.stderr)
        print(f"wam_tpu_torch.lint --knobs: {len(report)} knobs, "
              f"{len(problems)} problems")
        return 1 if problems else 0

    if args.rules:
        rule_classes = [get_rule(r.strip())
                        for r in args.rules.split(",") if r.strip()]
    else:
        rule_classes = all_rules()
    rules = [cls() for cls in rule_classes]

    explicit = bool(args.paths)
    if explicit:
        files = core.load_files(args.paths, root=root)
    else:
        scopes = set()
        for cls in rule_classes:
            scopes.update(cls.scope or ("wam_tpu_torch",))
        files = core.load_files(sorted(scopes), root=root)
        # de-dup: nested scopes (wam_tpu + wam_tpu/serve) load twice
        seen: set[str] = set()
        files = [f for f in files
                 if not (f.rel in seen or seen.add(f.rel))]

    ctx = core.LintContext(root=root)
    result = core.run_rules(rules, files, ctx,
                            respect_scope=not explicit,
                            apply_pragmas=True)

    if args.write_baseline:
        path = args.baseline or os.path.join(root, core.DEFAULT_BASELINE)
        data = core.write_baseline(path, result.findings)
        print(f"wrote {path}: {len(data['findings'])} keys, "
              f"{sum(data['findings'].values())} findings")
        return 0

    if not args.no_baseline:
        path = args.baseline or os.path.join(root, core.DEFAULT_BASELINE)
        baseline = core.load_baseline(path)
        result.findings, result.baselined = core.apply_baseline(
            result.findings, baseline)

    out = EMITTERS[args.fmt](result)
    print(out, end="" if out.endswith("\n") else "\n")
    return 1 if result.findings else 0


if __name__ == "__main__":
    sys.exit(main())
