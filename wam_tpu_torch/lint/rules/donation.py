"""donation-safety: use-after-donate on tensors handed to donating calls
(the port of `wam_tpu.lint.rules.donation`).

Donation releases the caller's tensor (`pipeline.donation`): after a
donating call has enqueued its last use, a donated CUDA tensor is emptied
(`Tensor.set_`) and its memory goes back to the caching allocator, so a
later read of the caller's handle sees 0 elements and raises (on the CPU
donation is off by default, so the same read passes there and fails on
the card). The rule tracks, per function scope:

1. names bound to donating wrappers — ``w = donating_jit(f)``,
   ``w = cached_jit(f, args, key, donate_argnums=(0,))`` or
   ``cached_entry(..., donate_argnums=...)``, ``w = jit_entry(impl,
   ...)`` (the serving entry releases its staged batch, argument 0, on the
   card by policy);
2. calls through those names (or a construct-and-call in one
   expression): the plain-Name arguments at the donated positions are
   marked *donated* at that source position;
3. any later read of a donated name in the same scope -> finding.
   Re-assigning the name clears the mark (a fresh tensor is fine), and
   arguments wrapped in `donation_safe(...)` are never marked (that IS
   the sanctioned way to keep a handle alive across a donating call).

Scope-local and position-based by design: cross-function flows and
loop-carried reads need runtime information a static pass does not have
— those stay the job of the donation tests.
"""

from __future__ import annotations

import ast

from wam_tpu_torch.lint.core import Finding, LintContext, SourceFile, tail_name
from wam_tpu_torch.lint.registry import Rule, register

# constructors that ALWAYS donate (by repo policy) -> donated positions
ALWAYS_DONATING = {"donating_jit": (0,), "jit_entry": (0,)}

# constructors that donate the positions of their ``donate_argnums``
ARGNUM_DONATING = {"cached_jit", "cached_entry"}


def _donate_positions(call: ast.Call):
    """Donated arg positions for a wrapper construction, or None when the
    construction does not donate. `cached_jit` / `cached_entry` donate
    only with a non-empty ``donate_argnums``; literal positions are
    honored, non-literal ones conservatively mean "position 0"."""
    name = tail_name(call.func)
    if name in ALWAYS_DONATING:
        return ALWAYS_DONATING[name]
    if name in ARGNUM_DONATING:
        for kw in call.keywords:
            if kw.arg == "donate_argnums":
                v = kw.value
                if isinstance(v, ast.Constant) and isinstance(v.value, int):
                    return (v.value,)
                if isinstance(v, (ast.Tuple, ast.List)):
                    elts = [e.value for e in v.elts
                            if isinstance(e, ast.Constant)]
                    return tuple(elts) if elts else None  # () donates nothing
                return (0,)  # dynamic donate_argnums: assume arg 0
    return None


class _ScopeScan(ast.NodeVisitor):
    """Collect, in (line, col) order: wrapper bindings, donation events,
    name stores, and name loads for one function scope (nested defs are
    separate scopes and skipped here)."""

    def __init__(self):
        self.wrappers: dict[str, tuple] = {}  # name -> donated positions
        self.events: list[tuple] = []  # (pos, kind, payload)
        self._donated_arg_ids: set[int] = set()
        self._moved_store_ids: set[int] = set()
        self._depth = 0

    def visit_FunctionDef(self, node):  # nested scope: not ours
        if self._depth == 0:
            self._depth += 1
            self.generic_visit(node)
            self._depth -= 1

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_Assign(self, node):
        if isinstance(node.value, ast.Call):
            pos = _donate_positions(node.value)
            if pos is not None:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.wrappers[t.id] = pos
        # the store takes effect AFTER the RHS evaluates: position target
        # stores at the end of the statement so `x = g(x)` (donate + rebind
        # in one statement) is donate-then-clear, not clear-then-donate
        end = (node.end_lineno or node.lineno, 1 << 30)
        for t in node.targets:
            if isinstance(t, ast.Name):
                self._moved_store_ids.add(id(t))
                self.events.append((end, "store", t.id))
        self.generic_visit(node)

    def visit_Call(self, node):
        donated_pos = None
        callee = None
        if isinstance(node.func, ast.Name) and node.func.id in self.wrappers:
            donated_pos = self.wrappers[node.func.id]
            callee = node.func.id
        elif isinstance(node.func, ast.Call):
            donated_pos = _donate_positions(node.func)
            callee = tail_name(node.func.func)
        if donated_pos is not None:
            for i in donated_pos:
                if i < len(node.args) and isinstance(node.args[i], ast.Name):
                    arg = node.args[i]
                    self._donated_arg_ids.add(id(arg))
                    self.events.append(((node.lineno, node.col_offset),
                                        "donate", (arg.id, callee)))
        self.generic_visit(node)

    def visit_Name(self, node):
        pos = (node.lineno, node.col_offset)
        if isinstance(node.ctx, ast.Store):
            if id(node) not in self._moved_store_ids:
                self.events.append((pos, "store", node.id))
        elif isinstance(node.ctx, ast.Load) and id(node) not in self._donated_arg_ids:
            self.events.append((pos, "load", node.id))
        self.generic_visit(node)


@register
class DonationSafetyRule(Rule):
    id = "donation-safety"
    severity = "error"
    scope = ("wam_tpu_torch",)
    description = ("variables read after being passed to a donating call "
                   "(donating_jit / donate_argnums / jit_entry)")

    def check_file(self, src: SourceFile, ctx: LintContext) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(src.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            scan = _ScopeScan()
            scan._depth = 1  # we're already inside `node`
            for stmt in node.body:
                scan.visit(stmt)
            donated: dict[str, str] = {}  # name -> callee it was donated to
            for _pos, kind, payload in sorted(scan.events,
                                              key=lambda e: e[0]):
                if kind == "donate":
                    name, callee = payload
                    donated[name] = callee or "a donating call"
                elif kind == "store":
                    donated.pop(payload, None)
                elif kind == "load" and payload in donated:
                    out.append(self.finding(
                        _pos[0],
                        f"'{payload}' read after being donated to "
                        f"{donated[payload]}() — the tensor is released on "
                        "the card (0 elements); copy it first "
                        "(pipeline.donation.donation_safe) or rebind the "
                        "name"))
                    donated.pop(payload)  # one report per donation
        return out
