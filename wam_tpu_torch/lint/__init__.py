"""`wam_tpu_torch.lint` — rule-based static analysis of the port's hot-path
invariants (the port of `wam_tpu.lint`, retargeted to eager PyTorch).

The invariants the port's performance and correctness rest on are mostly
*invisible to the type system*: no host syncs inside bodies a compiled
step runs, compiled-step wrappers constructed once, donated tensors never
re-read, `_GUARDED_BY` attributes mutated under their lock, bf16
contractions multiplied and summed in float32, metric/ledger names
matching the declared schema. Each is cheap to state as an AST rule and
expensive to discover on the card — so they live here, as a pure-stdlib
AST scan: the scanned code is never imported or executed, so the lint
runs on broken trees and needs neither a card nor torch.

Layout:
  core.py       loader, traced-fn detection, findings, pragmas, baseline
  registry.py   Rule base class + @register
  rules/        one module per rule (host_sync, retrace, donation,
                locks, precision[+schema-drift])
  emitters.py   text / json / sarif
  knobs.py      WAM_TPU_* / WAM_TORCH_* env-knob audit (--knobs)
  compat.py     scripts/torch_check_host_syncs.py's output
  baseline.json ratcheted pre-existing findings (counts only decrease)

CLI: ``python -m wam_tpu_torch.lint --all`` (see __main__.py). Suppress a
deliberate finding inline with ``# wamlint: disable=<rule-id>`` on (or
one line above) the flagged line, with a justification comment.
"""

from wam_tpu_torch.lint.core import (DEFAULT_BASELINE, Finding, LintContext,
                                     LintResult, SourceFile, apply_baseline,
                                     load_baseline, load_files, repo_root,
                                     run_rules, write_baseline)
from wam_tpu_torch.lint.registry import Rule, all_rules, get_rule, rule_ids

__all__ = [
    "Finding", "SourceFile", "LintContext", "LintResult",
    "Rule", "all_rules", "get_rule", "rule_ids",
    "load_files", "repo_root", "run_rules",
    "load_baseline", "apply_baseline", "write_baseline",
    "DEFAULT_BASELINE",
]
