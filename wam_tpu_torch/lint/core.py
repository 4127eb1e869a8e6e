"""Shared analysis core for `wam_tpu_torch.lint` (the port of
`wam_tpu.lint.core`, retargeted to eager PyTorch).

Everything the rules have in common lives here so a new rule is ~one
class: the module loader (parse once, share the AST), the traced-function
detection, the finding model (rule id + severity + file:line), inline
``# wamlint: disable=<rule>`` pragma resolution, and the baseline ratchet
(pre-existing findings are *capped*, never bulk-suppressed: the count per
(path, rule, message) key may only go down).

"Traced" here means a body that runs inside a compiled graph or under a
transform whose tracing a host sync breaks: a function handed to one of
the port's wrappers (`jit_entry`, `cached_jit`, `cached_entry`,
`donating_jit`, `smoothgrad`, `fan_runner`, `make_sharded_runner`, whose
bodies the compiled steps of `pipeline.aot` run), to ``torch.compile``, to
a `torch.func` transform, to ``torch.utils.checkpoint.checkpoint`` or
``torch.cuda.make_graphed_callables``, a function registered with
`torch.library` (an operator's implementation, fake or autograd formula),
and the ``forward`` / ``backward`` of a `torch.autograd.Function` subclass
and the ``forward`` of an `nn.Module` subclass (the compiled chunk steps
run them). Nested defs inherit.

No module under analysis is ever imported: the whole subsystem is a
static AST scan over the stdlib, so it runs on broken trees, without a
card and without torch.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field, replace

__all__ = [
    "Finding", "SourceFile", "LintContext", "LintResult",
    "repo_root", "load_files", "tail_name", "ref_names",
    "collect_traced_names", "iter_traced_functions", "TRACING_CALLS",
    "suppressed_by_pragma", "load_baseline", "apply_baseline",
    "baseline_key", "write_baseline", "DEFAULT_BASELINE",
]

SEVERITIES = ("error", "warning")

# call targets whose function-valued arguments get traced (the port's
# wrappers, the reference's names, and torch's own; kept in one place so
# host-sync, retrace-risk and donation-safety agree on what "traced" means)
TRACING_CALLS = {
    "make_sharded_runner", "jit_entry", "cached_jit", "cached_entry",
    "donating_jit", "smoothgrad", "fan_runner",
    # torch.func (from-imported names; `grad` only as `func.grad`, since a
    # bare `grad` is as often `torch.autograd.grad`, which traces nothing)
    "vmap", "grad_and_value", "vjp", "jacrev", "jacfwd", "functional_call",
    # torch.utils.checkpoint.checkpoint, torch.cuda.make_graphed_callables
    "checkpoint", "make_graphed_callables",
    # torch.library registrations (decorators and calls)
    "custom_op", "register_fake", "register_kernel", "register_autograd",
}

# torch.func's transforms, matched as attributes of `func` (`torch.func.grad`)
FUNC_TRANSFORMS = {"vmap", "grad", "grad_and_value", "vjp", "jacrev",
                   "jacfwd", "functional_call"}

# methods that run inside a compiled step: base-class tail -> method names
TRACED_METHODS = {"Function": ("forward", "backward"), "Module": ("forward",)}

DEFAULT_BASELINE = os.path.join("wam_tpu_torch", "lint", "baseline.json")

_PRAGMA_RE = re.compile(r"#\s*wamlint:\s*disable=([A-Za-z0-9_,\-]+)")
_PRAGMA_FILE_RE = re.compile(r"#\s*wamlint:\s*disable-file=([A-Za-z0-9_,\-]+)")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a file:line."""

    rule: str
    severity: str
    path: str       # repo-relative, "/" separators (stable across hosts)
    line: int
    message: str
    abspath: str = ""  # as-loaded path (legacy-parity emitters want it)

    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class SourceFile:
    """One parsed module. ``tree`` is None when the file failed to parse
    (``error`` carries the SyntaxError) — rules skip those; `run_rules`
    reports a ``parse-error`` finding so broken files fail the gate."""

    path: str               # absolute
    rel: str                # repo-relative, "/" separators
    text: str = ""
    tree: ast.AST | None = None
    error: SyntaxError | None = None
    _pragma_cache: dict | None = None

    @property
    def lines(self) -> list[str]:
        return self.text.splitlines()

    def pragmas(self) -> tuple[dict[int, set[str]], set[str]]:
        """(line -> disabled rule ids, file-wide disabled rule ids)."""
        if self._pragma_cache is None:
            per_line: dict[int, set[str]] = {}
            whole: set[str] = set()
            for i, line in enumerate(self.lines, start=1):
                m = _PRAGMA_RE.search(line)
                if m:
                    per_line.setdefault(i, set()).update(
                        r.strip() for r in m.group(1).split(",") if r.strip())
                m = _PRAGMA_FILE_RE.search(line)
                if m:
                    whole.update(
                        r.strip() for r in m.group(1).split(",") if r.strip())
            self._pragma_cache = (per_line, whole)
        return self._pragma_cache


@dataclass
class LintContext:
    """Run-wide state shared by every rule: the repo root (README and the
    schema registry are resolved against it) and per-rule config
    overrides keyed by rule id (tests inject fixture schemas here)."""

    root: str
    config: dict = field(default_factory=dict)

    def rule_config(self, rule_id: str) -> dict:
        return self.config.get(rule_id, {})


@dataclass
class LintResult:
    findings: list[Finding]
    files: list[SourceFile]
    suppressed: int = 0      # dropped by inline pragmas
    baselined: int = 0       # absorbed by the baseline ratchet


def repo_root() -> str:
    """The checkout root: two levels above this file (wam_tpu_torch/lint/)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def load_files(paths, root: str | None = None) -> list[SourceFile]:
    """Resolve files/dirs (relative paths against ``root``) into parsed
    `SourceFile`s, sorted by path (a reproducible finding order)."""
    root = root if root is not None else repo_root()
    out: list[str] = []
    for a in paths:
        p = a if os.path.isabs(a) else os.path.join(root, a)
        if os.path.isfile(p):
            out.append(p)
        else:
            for dirpath, _, names in os.walk(p):
                out.extend(os.path.join(dirpath, n)
                           for n in sorted(names) if n.endswith(".py"))
    files: list[SourceFile] = []
    for p in sorted(out):
        rel = os.path.relpath(p, root).replace(os.sep, "/")
        try:
            with open(p, "r", encoding="utf-8") as f:
                text = f.read()
        except OSError as e:
            files.append(SourceFile(p, rel, "", None,
                                    SyntaxError(str(e))))
            continue
        try:
            tree = ast.parse(text, filename=p)
            files.append(SourceFile(p, rel, text, tree))
        except SyntaxError as e:
            files.append(SourceFile(p, rel, text, None, e))
    return files


# -- traced-function detection -----------------------------------------------

def tail_name(node: ast.AST) -> str | None:
    """`torch.compile` -> "compile", `jit_entry` -> "jit_entry"."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def ref_names(node: ast.AST) -> set[str]:
    """Function names referenced by an argument expression: bare names,
    `self._method` / `obj.method` attributes, and the same inside a
    `functools.partial(...)` first argument."""
    out: set[str] = set()
    if isinstance(node, ast.Name):
        out.add(node.id)
    elif isinstance(node, ast.Attribute):
        out.add(node.attr)
    elif isinstance(node, ast.Call) and tail_name(node.func) == "partial":
        if node.args:
            out |= ref_names(node.args[0])
    return out


def is_torch_compile(func: ast.AST) -> bool:
    """`torch.compile`, in its attribute form only (so `re.compile` and a
    bare `compile` are not it)."""
    return (isinstance(func, ast.Attribute) and func.attr == "compile"
            and tail_name(func.value) == "torch")


def is_tracing_call(node: ast.Call) -> bool:
    """Whether this call traces its function-valued arguments. `compile`
    counts only off `torch`, `grad` only off `func` (`torch.func.grad`)."""
    if is_torch_compile(node.func):
        return True
    name = tail_name(node.func)
    if (isinstance(node.func, ast.Attribute) and name in FUNC_TRANSFORMS
            and tail_name(node.func.value) == "func"):
        return True
    return name in TRACING_CALLS


def collect_traced_names(tree: ast.AST) -> set[str]:
    """Names of functions that run traced in this module: defs decorated
    with a tracing decorator, or referenced (incl. `self.<name>` /
    `partial(<name>, ...)`) as an argument to a tracing call."""
    traced: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if isinstance(target, ast.AST) and (
                        is_torch_compile(target)
                        or tail_name(target) in TRACING_CALLS):
                    traced.add(node.name)
        elif isinstance(node, ast.Call) and is_tracing_call(node):
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                traced |= ref_names(arg)
    return traced


def traced_methods(tree: ast.AST) -> list[ast.AST]:
    """The ``forward`` / ``backward`` defs of this module's
    `torch.autograd.Function` subclasses and the ``forward`` defs of its
    `nn.Module` subclasses, a subclass of a subclass defined here too."""
    kinds: dict[str, str] = {}
    classes = [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]
    changed = True
    while changed:  # a class whose base is a local Function/Module class
        changed = False
        for cls in classes:
            if cls.name in kinds:
                continue
            for base in cls.bases:
                t = tail_name(base)
                kind = t if t in TRACED_METHODS else kinds.get(t)
                if kind is not None:
                    kinds[cls.name] = kind
                    changed = True
                    break
    out = []
    for cls in classes:
        names = TRACED_METHODS.get(kinds.get(cls.name, ""), ())
        out.extend(s for s in cls.body
                   if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))
                   and s.name in names)
    return out


def iter_traced_functions(tree: ast.AST):
    """Yield each outermost traced function def exactly once (nested defs
    share the traced body and are not yielded separately) — the shared
    traversal under host-sync and friends."""
    traced = collect_traced_names(tree)
    methods = {id(m) for m in traced_methods(tree)}
    seen: set[int] = set()
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            continue
        name = getattr(node, "name", None)
        if (name not in traced and id(node) not in methods) or id(node) in seen:
            continue
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                seen.add(id(sub))
        yield node


# -- pragma + baseline plumbing ---------------------------------------------

def suppressed_by_pragma(finding: Finding, src: SourceFile) -> bool:
    """True when an inline pragma disables this finding: file-wide
    ``# wamlint: disable-file=<rule>``, or ``# wamlint: disable=<rule>``
    on the finding's line or the line directly above it."""
    per_line, whole = src.pragmas()
    if finding.rule in whole:
        return True
    for ln in (finding.line, finding.line - 1):
        if finding.rule in per_line.get(ln, set()):
            return True
    return False


def baseline_key(f: Finding) -> str:
    """Line-number-free identity so unrelated edits above a baselined
    finding do not churn the file."""
    return f"{f.path}::{f.rule}::{f.message}"


def load_baseline(path: str) -> dict[str, int]:
    if not os.path.isfile(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return {str(k): int(v) for k, v in data.get("findings", {}).items()}


def apply_baseline(findings: list[Finding],
                   baseline: dict[str, int]) -> tuple[list[Finding], int]:
    """Ratchet semantics: each baseline key absorbs up to its recorded
    count of matching findings; everything beyond that (new findings, or
    a file getting WORSE than its baseline) is reported. Returns
    (non-baselined findings, absorbed count)."""
    budget = dict(baseline)
    kept: list[Finding] = []
    absorbed = 0
    for f in findings:
        k = baseline_key(f)
        if budget.get(k, 0) > 0:
            budget[k] -= 1
            absorbed += 1
        else:
            kept.append(f)
    return kept, absorbed


def write_baseline(path: str, findings: list[Finding]) -> dict:
    counts: dict[str, int] = {}
    for f in findings:
        counts[baseline_key(f)] = counts.get(baseline_key(f), 0) + 1
    data = {
        "version": 1,
        "comment": ("wam_tpu_torch.lint baseline — pre-existing findings "
                    "ratcheted here; counts may only decrease. Regenerate "
                    "with `python -m wam_tpu_torch.lint --all "
                    "--write-baseline`."),
        "findings": dict(sorted(counts.items())),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=1, sort_keys=False)
        f.write("\n")
    return data


def parse_error_findings(files: list[SourceFile]) -> list[Finding]:
    out = []
    for src in files:
        if src.error is not None:
            out.append(Finding(
                rule="parse-error", severity="error", path=src.rel,
                line=getattr(src.error, "lineno", 1) or 1,
                message=f"syntax error: {src.error}", abspath=src.path))
    return out


def _rel_in_scope(rel: str, scope) -> bool:
    if scope is None:
        return True
    for s in scope:
        s = s.rstrip("/")
        if rel == s or rel.startswith(s + "/"):
            return True
    return False


def run_rules(rules, files: list[SourceFile], ctx: LintContext,
              respect_scope: bool = True,
              apply_pragmas: bool = True) -> LintResult:
    """Drive ``rules`` over ``files``. Scope filtering keeps each rule on
    its curated directory set when the caller ran with the default scope;
    explicit path runs pass ``respect_scope=False`` (you asked for this
    file, you get scanned)."""
    findings: list[Finding] = list(parse_error_findings(files))
    for rule in rules:
        scope = rule.scope if respect_scope else None
        for src in files:
            if src.tree is None or not _rel_in_scope(src.rel, scope):
                continue
            for f in rule.check_file(src, ctx):
                findings.append(replace(
                    f, rule=rule.id, severity=rule.severity,
                    path=src.rel, abspath=src.path))
    suppressed = 0
    if apply_pragmas:
        by_rel = {src.rel: src for src in files}
        kept = []
        for f in findings:
            src = by_rel.get(f.path)
            if src is not None and suppressed_by_pragma(f, src):
                suppressed += 1
            else:
                kept.append(f)
        findings = kept
    return LintResult(findings=findings, files=files, suppressed=suppressed)
