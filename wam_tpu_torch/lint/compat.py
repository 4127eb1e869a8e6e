"""The host-sync script's output contract, for the port
(`scripts/torch_check_host_syncs.py`, the counterpart of
`scripts/check_host_syncs.py` over `wam_tpu.lint.compat`).

The reference script prints absolute-path findings in sorted-file order
with syntax errors interleaved at the file's position, a
``check_host_syncs: N files, M findings`` summary, and exits 1 on any
finding. The port's script prints the same contract under its own name
(``torch_check_host_syncs: ...``), driving the `host-sync` rule directly
(in that order, with NO pragma or baseline filtering) instead of going
through `run_rules`.

tests/test_torch_lint.py pins this by diffing the script's output against
``python -m wam_tpu_torch.lint --rules host-sync`` findings on the live
tree.
"""

from __future__ import annotations

import sys

from wam_tpu_torch.lint.core import iter_traced_functions, load_files, repo_root
from wam_tpu_torch.lint.rules.host_sync import LEGACY_SCOPE, sync_messages

SUMMARY = "torch_check_host_syncs"


def legacy_host_sync_lines(argv=None) -> tuple[list[str], int]:
    """(output lines sans summary, file count) in the script's format and
    order."""
    args = list(argv) if argv else list(LEGACY_SCOPE)
    files = load_files(args, root=repo_root())
    findings: list[str] = []
    for src in files:
        if src.error is not None:
            findings.append(f"{src.path}: syntax error: {src.error}")
            continue
        for fn in iter_traced_functions(src.tree):
            for line, msg in sync_messages(fn):
                findings.append(f"{src.path}:{line}: {msg}")
    return findings, len(files)


def legacy_host_sync_main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    findings, nfiles = legacy_host_sync_lines(argv)
    for line in findings:
        print(line)
    print(f"{SUMMARY}: {nfiles} files, {len(findings)} findings")
    return 1 if findings else 0
