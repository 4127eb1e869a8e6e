"""precision-flow + schema-drift: numeric and observability contracts (the
port of `wam_tpu.lint.rules.precision`).

**precision-flow** — a bfloat16 value that reaches a contraction
(`torch.matmul` / `mm` / `bmm` / `einsum` / `tensordot`, `F.linear`,
`F.conv1d/2d/3d`, or the `@` operator) multiplies in bf16 and rounds the
product to bf16: one rounding more than the reference's
``preferred_element_type=jnp.float32`` (the bf16 mel chain's attribution
cosine to float32 fell from 0.9927 to 0.9888 with it, `ops.melspec`).
Torch's calls have no accumulator argument, so the sanctioned form is an
explicit upcast: both operands rounded to bf16 and multiplied and summed
in float32 (`ops.melspec._bf16_matmul`, `wavelets.matmul`'s float32
products). The rule taints names assigned from a bf16 cast
(``x.to(torch.bfloat16)``, ``x.bfloat16()``, ``x.half()``, a call with
``dtype=torch.bfloat16``) or from the policy casting shim
(``compute_cast(x, dtype)`` with a non-f32 dtype), clears the taint on any
other rebind (an upcast ``.to(torch.float32)`` / ``.float()`` among them),
and flags contractions fed a tainted name or an inline bf16 cast.

**schema-drift** — metric instruments and ledger row types are an
external contract (dashboards, ledger readers). Every
``registry.counter/gauge/histogram("wam_tpu_...")`` name and every
``{"metric": "<row_type>", ...}`` ledger row literal must appear in
the declared registry `wam_tpu_torch/obs/schema.py`; a literal that isn't
declared is drift — either a typo or a schema change that skipped the
registry (and therefore the dashboards).
"""

from __future__ import annotations

import ast
import os

from wam_tpu_torch.lint.core import Finding, LintContext, SourceFile, tail_name
from wam_tpu_torch.lint.registry import Rule, register

CONTRACTIONS = {"matmul", "mm", "bmm", "einsum", "tensordot", "linear",
                "conv1d", "conv2d", "conv3d"}

# dtype-casting methods that take no dtype argument
_BF16_METHODS = {"bfloat16", "half"}
_F32_METHODS = {"float", "double"}

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

SCHEMA_PATH = "wam_tpu_torch/obs/schema.py"


def _is_bf16_dtype(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and node.value in ("bfloat16", "float16"):
        return True
    if isinstance(node, ast.Attribute) and node.attr in ("bfloat16", "float16",
                                                         "half"):
        return True
    return False


def _is_f32_dtype(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and node.value in ("float32", "f32"):
        return True
    if isinstance(node, ast.Attribute) and node.attr in ("float32", "float64",
                                                         "float", "double"):
        return True
    return False


def _cast_dtype(expr: ast.AST) -> str | None:
    """'bf16' / 'f32' / None for the *outermost* cast in an expression:
    ``<x>.to(<dtype>)``, ``<x>.bfloat16()`` / ``.half()`` / ``.float()``,
    a call carrying ``dtype=<dtype>``, or the policy casting shim
    ``compute_cast(x, <policy dtype>)`` (`wam_tpu_torch.config.compute_cast`
    — its dtype is usually a runtime policy value that may resolve to
    bf16/fp8, so the shim is treated as a low-precision taint source unless
    its dtype argument is statically f32/None)."""
    if not isinstance(expr, ast.Call):
        return None
    if isinstance(expr.func, ast.Attribute) and not expr.args:
        if expr.func.attr in _BF16_METHODS:
            return "bf16"
        if expr.func.attr in _F32_METHODS:
            return "f32"
    dtype_nodes = []
    if isinstance(expr.func, ast.Attribute) and expr.func.attr == "to":
        dtype_nodes.extend(expr.args[:1])
    dtype_nodes.extend(kw.value for kw in expr.keywords if kw.arg == "dtype")
    if tail_name(expr.func) == "compute_cast":
        d = expr.args[1] if len(expr.args) > 1 else None
        d = next((kw.value for kw in expr.keywords if kw.arg == "dtype"), d)
        if d is None or _is_f32_dtype(d) or (
                isinstance(d, ast.Constant) and d.value is None):
            return "f32"
        return "bf16"
    for d in dtype_nodes:
        if _is_bf16_dtype(d):
            return "bf16"
        if _is_f32_dtype(d):
            return "f32"
    return None


def _walk_no_defs(node: ast.AST):
    """ast.walk that does not descend into nested function definitions."""
    stack = [node]
    while stack:
        cur = stack.pop()
        yield cur
        for child in ast.iter_child_nodes(cur):
            if not isinstance(child, _FUNCS):
                stack.append(child)


class _PrecisionScan:
    """Source-order bf16-taint pass over one scope. Nested defs are their
    own scope (fresh taint set — closures see outer tensors, but flow
    through a closure boundary is beyond a lexical pass)."""

    def __init__(self, rule: Rule):
        self.rule = rule
        self.findings: list[Finding] = []

    def scan(self, body: list[ast.stmt], tainted: set | None = None) -> list:
        tainted = set() if tainted is None else tainted
        for stmt in body:
            self._stmt(stmt, tainted)
        return self.findings

    def _stmt(self, node: ast.stmt, tainted: set) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.scan(node.body, set())
            return
        # check sinks in this statement's own expressions (bodies of
        # compound statements are recursed into below, statement by
        # statement, so taint updates inside them are seen in order)
        bodies: list[list[ast.stmt]] = []
        exprs: list[ast.AST] = []
        if isinstance(node, (ast.If, ast.While)):
            exprs.append(node.test)
            bodies = [node.body, node.orelse]
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            exprs.append(node.iter)
            bodies = [node.body, node.orelse]
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            exprs.extend(i.context_expr for i in node.items)
            bodies = [node.body]
        elif isinstance(node, ast.Try):
            bodies = [node.body, node.orelse, node.finalbody]
            bodies.extend(h.body for h in node.handlers)
        elif isinstance(node, ast.ClassDef):
            bodies = [node.body]
        else:
            exprs.append(node)  # simple statement: scan it whole
        for e in exprs:
            self._check_exprs(e, tainted)
        # taint update AFTER the RHS sinks were checked
        if isinstance(node, ast.Assign):
            kind = _cast_dtype(node.value)
            src = node.value.id if isinstance(node.value, ast.Name) else None
            for t in node.targets:
                if isinstance(t, ast.Name):
                    if kind == "bf16" or (kind is None and src in tainted):
                        tainted.add(t.id)
                    else:
                        tainted.discard(t.id)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            if isinstance(node.target, ast.Name):
                tainted.discard(node.target.id)
        for body in bodies:
            for stmt in body:
                self._stmt(stmt, tainted)

    def _check_exprs(self, root: ast.AST, tainted: set) -> None:
        for sub in _walk_no_defs(root):
            if isinstance(sub, ast.Call):
                self._check_sink(sub, tainted)
            elif (isinstance(sub, ast.BinOp)
                  and isinstance(sub.op, ast.MatMult)):
                for side in (sub.left, sub.right):
                    name = side.id if isinstance(side, ast.Name) else None
                    if name in tainted or _cast_dtype(side) == "bf16":
                        self.findings.append(self.rule.finding(
                            sub.lineno,
                            "bf16 operand in `@` matmul: the product is "
                            "rounded to bf16; upcast both operands and "
                            "multiply in float32 (ops.melspec._bf16_matmul)"))
                        break

    def _check_sink(self, call: ast.Call, tainted: set) -> None:
        if tail_name(call.func) not in CONTRACTIONS:
            return
        for arg in call.args:
            bf16 = (isinstance(arg, ast.Name) and arg.id in tainted) \
                or _cast_dtype(arg) == "bf16"
            if bf16:
                what = (f"'{arg.id}'" if isinstance(arg, ast.Name)
                        else "a bf16-cast value")
                self.findings.append(self.rule.finding(
                    call.lineno,
                    f"{tail_name(call.func)}() consumes {what} (bfloat16) in "
                    "bf16: the product is rounded to bf16 (~8 mantissa "
                    "bits); upcast both operands and contract in float32 "
                    "(ops.melspec._bf16_matmul)"))
                return


@register
class PrecisionFlowRule(Rule):
    id = "precision-flow"
    severity = "error"
    scope = ("wam_tpu_torch",)
    description = ("bf16 values reaching matmul/einsum/linear/conv without "
                   "an upcast to float32")

    def check_file(self, src: SourceFile, ctx: LintContext) -> list[Finding]:
        return _PrecisionScan(self).scan(src.tree.body)


# ---------------------------------------------------------------------------
# schema-drift


def _load_declared(ctx: LintContext):
    """(metric_names, row_types) from rule config or the declared registry
    wam_tpu_torch/obs/schema.py, AST-parsed (never imported)."""
    cfg = ctx.rule_config("schema-drift")
    if "metric_names" in cfg or "row_types" in cfg:
        return (set(cfg.get("metric_names", ())),
                set(cfg.get("row_types", ())))
    cached = getattr(ctx, "_schema_cache", None)
    if cached is not None:
        return cached
    path = os.path.join(ctx.root, *SCHEMA_PATH.split("/"))
    metric_names: set[str] = set()
    row_types: set[str] = set()
    try:
        with open(path, "r", encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=path)
    except (OSError, SyntaxError):
        tree = None
    if tree is not None:
        for node in tree.body:
            if not isinstance(node, ast.Assign):
                continue
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
            target = None
            if "METRIC_NAMES" in names:
                target = metric_names
            elif "LEDGER_ROW_TYPES" in names:
                target = row_types
            if target is None:
                continue
            for sub in ast.walk(node.value):
                if (isinstance(sub, ast.Constant)
                        and isinstance(sub.value, str)):
                    target.add(sub.value)
    ctx._schema_cache = (metric_names, row_types)
    return ctx._schema_cache


@register
class SchemaDriftRule(Rule):
    id = "schema-drift"
    severity = "error"
    scope = ("wam_tpu_torch",)
    description = ("wam_tpu_* metric names / ledger row types not declared "
                   "in wam_tpu_torch/obs/schema.py")

    INSTRUMENTS = {"counter", "gauge", "histogram"}

    def check_file(self, src: SourceFile, ctx: LintContext) -> list[Finding]:
        if src.rel.replace(os.sep, "/") == SCHEMA_PATH:
            return []  # the registry itself
        metric_names, row_types = _load_declared(ctx)
        out: list[Finding] = []
        for node in ast.walk(src.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self.INSTRUMENTS and node.args):
                first = node.args[0]
                if (isinstance(first, ast.Constant)
                        and isinstance(first.value, str)
                        and first.value.startswith("wam_tpu_")
                        and first.value not in metric_names):
                    out.append(self.finding(
                        node.lineno,
                        f"metric '{first.value}' is not declared in "
                        f"{SCHEMA_PATH} METRIC_NAMES (dashboards "
                        "key on declared names)"))
            elif isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if (isinstance(k, ast.Constant) and k.value == "metric"
                            and isinstance(v, ast.Constant)
                            and isinstance(v.value, str)
                            and v.value not in row_types):
                        out.append(self.finding(
                            node.lineno,
                            f"ledger row type '{v.value}' is not declared "
                            f"in {SCHEMA_PATH} LEDGER_ROW_TYPES"))
        return out
