"""retrace-risk: compiled-step wrappers whose construction pattern
defeats the first-call count (`serve.entry`) and the compiled-step cache
(`pipeline.aot`) — the port of `wam_tpu.lint.rules.retrace`.

Three shapes:

1. A wrapper (the port's `cached_jit` / `cached_entry` / `jit_entry` /
   `donating_jit`, or ``torch.compile``) constructed inside a loop —
   every iteration builds a fresh wrapper with empty caches: a fresh
   first-call count, a fresh Dynamo code object to compile, so the
   compiled-step cache and the registry's hydration never hit.
2. The same wrapper constructed AND invoked in one expression inside a
   function body (``torch.compile(f)(x)``): the wrapper is garbage after
   the call, so each call of the enclosing function compiles again.
3. A tensor-valued default argument (`torch.zeros(...)`,
   `torch.tensor(...)`, `np.array(...)`, ...) on a traced function: the
   default is one object shared by every call, captured into the graph
   as a constant (Dynamo guards on its identity), so the "same" step
   recompiles when it is rebuilt, and a write to it leaks across calls.

Module-level one-shot constructions are fine (they run once per process)
and are not flagged.
"""

from __future__ import annotations

import ast

from wam_tpu_torch.lint.core import (Finding, LintContext, SourceFile,
                                     collect_traced_names, is_torch_compile,
                                     tail_name, traced_methods)
from wam_tpu_torch.lint.registry import Rule, register

# wrapper constructors: a call to one of these BUILDS a compiled-callable
# wrapper (vs. invoking one); torch.compile is matched in attribute form
JIT_WRAPPERS = {"cached_jit", "cached_entry", "jit_entry", "donating_jit"}

ARRAY_CTORS = {"array", "asarray", "as_tensor", "tensor", "zeros", "ones",
               "full", "arange", "linspace", "eye", "empty", "rand", "randn"}
ARRAY_MODULES = {"np", "numpy", "onp", "torch"}

_LOOPS = (ast.For, ast.AsyncFor, ast.While)
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _wrapper_name(node: ast.Call) -> str | None:
    if is_torch_compile(node.func):
        return "torch.compile"
    name = tail_name(node.func)
    return name if name in JIT_WRAPPERS else None


def _is_array_default(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and tail_name(node.func) in ARRAY_CTORS
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in ARRAY_MODULES)


@register
class RetraceRiskRule(Rule):
    id = "retrace-risk"
    severity = "error"
    scope = ("wam_tpu_torch",)
    description = ("compiled-step wrappers constructed per loop iteration / "
                   "per call, or tensor-valued defaults captured into "
                   "compiled bodies")

    def check_file(self, src: SourceFile, ctx: LintContext) -> list[Finding]:
        out: list[Finding] = []
        self._visit(src.tree, in_loop=False, in_func=False, out=out)
        traced = collect_traced_names(src.tree)
        methods = {id(m) for m in traced_methods(src.tree)}
        for node in ast.walk(src.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            decorated = any(
                _wrapper_name(d) if isinstance(d, ast.Call)
                else (is_torch_compile(d) or tail_name(d) in JIT_WRAPPERS)
                for d in node.decorator_list)
            if node.name not in traced and id(node) not in methods and not decorated:
                continue
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]
            for d in defaults:
                if _is_array_default(d):
                    out.append(self.finding(
                        d.lineno,
                        f"tensor-valued default argument on traced function "
                        f"'{node.name}' is captured into the compiled body "
                        "(one shared object, guarded by identity -> a "
                        "recompile per construction)"))
        return out

    def _visit(self, node: ast.AST, in_loop: bool, in_func: bool, out) -> None:
        for child in ast.iter_child_nodes(node):
            child_in_loop = in_loop or isinstance(child, _LOOPS)
            child_in_func = in_func or isinstance(child, _FUNCS)
            if isinstance(child, ast.Call):
                name = _wrapper_name(child)
                inner = (_wrapper_name(child.func)
                         if isinstance(child.func, ast.Call) else None)
                if name and in_loop:
                    out.append(self.finding(
                        child.lineno,
                        f"{name}(...) constructed inside a loop: every "
                        "iteration rebuilds the wrapper and compiles again "
                        "(hoist it, or cache by shape)"))
                elif inner and in_func and not in_loop:  # in-loop: the inner call reports
                    out.append(self.finding(
                        child.lineno,
                        f"{inner}(f)(...) constructed and invoked in one "
                        "expression inside a function body: the wrapper "
                        "(and its caches) is discarded after the call -> a "
                        "compile per call"))
            self._visit(child, child_in_loop, child_in_func, out)
