"""lock-discipline: `_GUARDED_BY`-declared attributes mutated outside
their lock.

Classes opt in by declaring a class-level map from attribute name to the
lock attribute that guards it::

    class AttributionServer:
        _GUARDED_BY = {"_queues": "_cond", "_started": "_cond"}

The rule then checks every method of the class: a mutation of
``self._queues`` (assignment, augmented assignment, subscript store,
or a mutating method call like ``.append(...)``) must be lexically
enclosed in ``with self._cond:`` (or ``with self._cond: ...`` via an
alias bound from ``self._cond`` is NOT recognized — the convention is
the direct form, which is what the serve/pod code uses).

Deliberately lexical, not flow-sensitive: it catches the real bug class
we have hit (a `_started = True` slipped outside the lock during a
refactor) without needing alias analysis. ``__init__`` is exempt —
construction happens-before any concurrent access. Nested functions
reset the held-lock set: a closure may run on another thread after the
``with`` block exits.
"""

from __future__ import annotations

import ast

from wam_tpu_torch.lint.core import Finding, LintContext, SourceFile
from wam_tpu_torch.lint.registry import Rule, register

# method names that mutate their receiver in place
MUTATORS = {"append", "extend", "insert", "remove", "pop", "popitem",
            "clear", "update", "add", "discard", "setdefault", "appendleft"}

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _guarded_by_map(cls: ast.ClassDef) -> dict[str, str] | None:
    """The literal `_GUARDED_BY` dict of a class body, or None."""
    for stmt in cls.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets = [stmt.target]
        if not any(isinstance(t, ast.Name) and t.id == "_GUARDED_BY"
                   for t in targets):
            continue
        value = stmt.value
        if not isinstance(value, ast.Dict):
            return None
        out: dict[str, str] = {}
        for k, v in zip(value.keys, value.values):
            if (isinstance(k, ast.Constant) and isinstance(k.value, str)
                    and isinstance(v, ast.Constant)
                    and isinstance(v.value, str)):
                out[k.value] = v.value
        return out
    return None


def _self_attr(node: ast.AST) -> str | None:
    """'x' for a `self.x` expression, else None."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _MethodScan:
    """Walk one method body tracking which `self.<lock>` locks are
    lexically held; report guarded-attr mutations made without them."""

    def __init__(self, rule: Rule, guarded: dict[str, str], method: str):
        self.rule = rule
        self.guarded = guarded
        self.method = method
        self.findings: list[Finding] = []

    def scan(self, body: list[ast.stmt]) -> list[Finding]:
        for stmt in body:
            self._visit(stmt, held=frozenset())
        return self.findings

    def _visit(self, node: ast.AST, held: frozenset) -> None:
        if isinstance(node, ast.With) or isinstance(node, ast.AsyncWith):
            for item in node.items:
                lock = _self_attr(item.context_expr)
                if lock is not None:
                    held = held | {lock}
            for stmt in node.body:
                self._visit(stmt, held)
            return
        if isinstance(node, _FUNCS):
            # closures may run on another thread, after the with-block
            body = node.body if not isinstance(node, ast.Lambda) else [node.body]
            for stmt in body:
                self._visit(stmt, frozenset())
            return
        self._check(node, held)
        for child in ast.iter_child_nodes(node):
            self._visit(child, held)

    def _check(self, node: ast.AST, held: frozenset) -> None:
        attr = None
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                a = _self_attr(t)
                if a is None and isinstance(t, ast.Subscript):
                    a = _self_attr(t.value)  # self._queues[k] = v
                if a is not None and a in self.guarded:
                    attr = a
                    break
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in MUTATORS:
                a = _self_attr(node.func.value)
                if a is not None and a in self.guarded:
                    attr = a
        elif isinstance(node, (ast.Delete,)):
            for t in node.targets:
                a = _self_attr(t)
                if a is None and isinstance(t, ast.Subscript):
                    a = _self_attr(t.value)
                if a is not None and a in self.guarded:
                    attr = a
                    break
        if attr is None:
            return
        lock = self.guarded[attr]
        if lock not in held:
            self.findings.append(self.rule.finding(
                node.lineno,
                f"self.{attr} mutated in {self.method}() without holding "
                f"self.{lock} (declared in _GUARDED_BY)"))


@register
class LockDisciplineRule(Rule):
    id = "lock-discipline"
    severity = "error"
    scope = ("wam_tpu_torch",)
    description = ("_GUARDED_BY-declared attributes mutated outside "
                   "`with self.<lock>:` blocks")

    def check_file(self, src: SourceFile, ctx: LintContext) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            guarded = _guarded_by_map(node)
            if not guarded:
                continue
            for stmt in node.body:
                if not isinstance(stmt, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if stmt.name == "__init__":
                    continue  # construction happens-before concurrency
                scan = _MethodScan(self, guarded, stmt.name)
                out.extend(scan.scan(stmt.body))
        return out
