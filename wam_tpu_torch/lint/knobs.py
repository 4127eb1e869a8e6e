"""Env-knob audit of the port (`python -m wam_tpu_torch.lint --knobs`).

Every ``WAM_TPU_*`` and ``WAM_TORCH_*`` environment variable read in
``wam_tpu_torch/``, ``scripts/torch_*.py``, ``examples/torch_*.py`` or
``chip_smoke.py`` is an operational surface of the port: kill switches,
cache locations, transform-impl overrides. This mode AST-scans for the
reads (``os.environ[...]`` / ``.get`` / ``.setdefault`` / ``.pop`` /
``os.getenv``, including reads through a module-level ``FOO_ENV =
"WAM_..."`` constant) and regenerates the port's knob table, which
README carries between the ``<!-- wamlint-torch-knobs:begin/end -->``
markers (the reference's own table, `wam_tpu.lint.knobs`, sits between
markers of its own).

Exit-1 conditions: a knob read in code with no curated description here,
a ``WAM_TORCH_*`` knob that README mentions and no code of the port reads
(dead — stale docs; the ``WAM_TPU_*`` names README mentions are the
reference's audit's to check), or a stale generated table.
``--knobs --write-docs`` rewrites the table in place.
"""

from __future__ import annotations

import ast
import glob
import os
import re

from wam_tpu_torch.lint.core import load_files, repo_root, tail_name

KNOB_RE = re.compile(r"\bWAM_(?:TPU|TORCH)_[A-Z0-9_]+\b")
PORT_KNOB_RE = re.compile(r"\bWAM_TORCH_[A-Z0-9_]+\b")

BEGIN_MARK = "<!-- wamlint-torch-knobs:begin -->"
END_MARK = "<!-- wamlint-torch-knobs:end -->"

SCAN_PATHS = ("wam_tpu_torch", "scripts/torch_*.py", "examples/torch_*.py",
              "chip_smoke.py")
DOC_FILES = ("README.md",)

# curated one-liners for the generated README table; the audit fails on a
# knob read in code that has no entry here (add one when adding a knob)
KNOB_DOCS = {
    "WAM_TPU_AOT_CACHE":
        "compiled-step cache directory (default `~/.cache/wam_tpu/aot`)",
    "WAM_TPU_NO_AOT_CACHE":
        "`1` compiles the steps but persists and loads nothing (kill switch)",
    "WAM_TPU_CACHE_DIR":
        "Inductor's persistent compile-cache directory (default "
        "`~/.cache/wam_tpu/inductor`)",
    "WAM_TORCH_SCHEDULE_CACHE":
        "tuner schedule-cache path (default "
        "`~/.cache/wam_tpu_torch/schedules.json`)",
    "WAM_TPU_NO_SCHEDULE_CACHE":
        "`1` disables schedule-cache lookups (law-only tuning)",
    "WAM_TPU_NO_REGISTRY":
        "`1` skips compile-artifact registry hydration (kill switch)",
    "WAM_TPU_NO_RESULT_CACHE":
        "`1` bypasses the serve result cache; read per call, so it can "
        "be flipped live",
    "WAM_TPU_NO_ONLINE_TUNE":
        "`1` disables the online schedule tuner (kill switch; gauges still "
        "update)",
    "WAM_TPU_NO_ANYTIME":
        "`1` disables anytime serving: servers over anytime entries run "
        "full-n synchronous attribution (kill switch)",
    "WAM_TPU_NO_MODEL_PAGING":
        "`1` freezes multi-model residency (kill switch; read per call)",
    "WAM_TORCH_DWT2_IMPL":
        "2-D analysis impl at import (`auto`/`conv`/`matmul`/`kernel`; "
        "`set_dwt2_impl`)",
    "WAM_TORCH_SYNTH2_IMPL":
        "2-D synthesis impl at import (`auto`/`conv`/`matmul`/`kernel`; "
        "`set_synth2_impl`)",
    "WAM_TORCH_DWT1_IMPL":
        "1-D transform impl at import (`auto`/`conv`/`folded`/`folded_nhc`; "
        "`set_dwt1_impl`); a compiled 1-D step compiles the selected impl",
    "WAM_TPU_FUSED_RELU_IMPL":
        "fused-ReLU impl (`auto`: K4/K5 on CUDA tensors; `xla`, "
        "`pallas_interpret`: the plain version; `pallas`: K4/K5, raising "
        "on a CPU tensor; `set_fused_relu_impl`)",
    "WAM_TPU_FAN_DTYPE":
        "eval-fan compute dtype override (`f32`/`bf16`/`fp8`), validated "
        "when read",
    "WAM_TPU_MEL_BF16":
        "`1` runs the mel chain's matmuls on bf16 operands with float32 "
        "products and sums",
    "WAM_TPU_POD_AUTHKEY":
        "hex connection auth key the pod router hands its worker "
        "processes (set by the router)",
    "WAM_TPU_POD_TRANSPORT":
        "pod control-plane transport (`tcp`, the default; `pipe`)",
    "WAM_TPU_POD_HEARTBEAT_S":
        "pod router heartbeat interval in seconds (default 0.25)",
}

_ENV_METHODS = {"get", "setdefault", "pop"}


def _is_environ(node: ast.AST) -> bool:
    return ((isinstance(node, ast.Attribute) and node.attr == "environ")
            or (isinstance(node, ast.Name) and node.id == "environ"))


def _module_env_consts(tree: ast.AST) -> dict[str, str]:
    """Module-level ``NAME = "WAM_..."`` constants (e.g. the schedule
    cache's CACHE_ENV) so reads through the name still count."""
    out: dict[str, str] = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
                and KNOB_RE.fullmatch(node.value.value)):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node.value.value
    return out


def _key_name(node: ast.AST, consts: dict[str, str]) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value if KNOB_RE.fullmatch(node.value) else None
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    return None


def _scan_paths(root: str) -> list[str]:
    out: list[str] = []
    for p in SCAN_PATHS:
        if any(c in p for c in "*?["):
            out.extend(sorted(glob.glob(os.path.join(root, p))))
        elif os.path.exists(os.path.join(root, p)):
            out.append(p)
    return out


def scan_knob_reads(root: str | None = None) -> dict[str, list[str]]:
    """knob name -> sorted read sites ("path:line") across SCAN_PATHS."""
    root = root if root is not None else repo_root()
    reads: dict[str, set[str]] = {}
    for src in load_files(_scan_paths(root), root=root):
        if src.tree is None:
            continue
        consts = _module_env_consts(src.tree)
        for node in ast.walk(src.tree):
            key = None
            if isinstance(node, ast.Call):
                f = node.func
                if tail_name(f) == "getenv" and node.args:
                    key = _key_name(node.args[0], consts)
                elif (isinstance(f, ast.Attribute)
                        and f.attr in _ENV_METHODS
                        and _is_environ(f.value) and node.args):
                    key = _key_name(node.args[0], consts)
            elif (isinstance(node, ast.Subscript)
                    and isinstance(node.ctx, ast.Load)
                    and _is_environ(node.value)):
                key = _key_name(node.slice, consts)
            if key is not None:
                reads.setdefault(key, set()).add(
                    f"{src.rel}:{node.lineno}")
    return {k: sorted(v) for k, v in sorted(reads.items())}


def doc_mentions(root: str | None = None) -> dict[str, set[str]]:
    """Knob name -> doc files mentioning it."""
    root = root if root is not None else repo_root()
    out: dict[str, set[str]] = {}
    for doc in DOC_FILES:
        p = os.path.join(root, doc)
        if not os.path.isfile(p):
            continue
        with open(p, "r", encoding="utf-8") as f:
            for m in KNOB_RE.finditer(f.read()):
                out.setdefault(m.group(0), set()).add(doc)
    return out


def render_table(reads: dict[str, list[str]]) -> str:
    lines = [
        BEGIN_MARK,
        "<!-- generated by `python -m wam_tpu_torch.lint --knobs --write-docs`"
        " — do not edit by hand -->",
        "| Knob | Read in | Meaning |",
        "| --- | --- | --- |",
    ]
    for knob, sites in reads.items():
        mods = sorted({s.rsplit(":", 1)[0] for s in sites})
        shown = ", ".join(f"`{m}`" for m in mods[:2])
        if len(mods) > 2:
            shown += f" (+{len(mods) - 2} more)"
        desc = KNOB_DOCS.get(knob, "*(undocumented)*")
        lines.append(f"| `{knob}` | {shown} | {desc} |")
    lines.append(END_MARK)
    return "\n".join(lines)


def current_table(root: str) -> str | None:
    p = os.path.join(root, "README.md")
    if not os.path.isfile(p):
        return None
    with open(p, "r", encoding="utf-8") as f:
        text = f.read()
    b, e = text.find(BEGIN_MARK), text.find(END_MARK)
    if b < 0 or e < 0:
        return None
    return text[b:e + len(END_MARK)]


def write_table(root: str, table: str) -> bool:
    p = os.path.join(root, "README.md")
    with open(p, "r", encoding="utf-8") as f:
        text = f.read()
    b, e = text.find(BEGIN_MARK), text.find(END_MARK)
    if b < 0 or e < 0:
        return False
    new = text[:b] + table + text[e + len(END_MARK):]
    with open(p, "w", encoding="utf-8") as f:
        f.write(new)
    return True


def audit(root: str | None = None, write_docs: bool = False):
    """Returns (problem lines, report lines). Non-empty problems => exit 1."""
    root = root if root is not None else repo_root()
    reads = scan_knob_reads(root)
    docs = doc_mentions(root)
    problems: list[str] = []
    report: list[str] = []
    for knob, sites in reads.items():
        where = sites[0] + (f" (+{len(sites) - 1} more)"
                            if len(sites) > 1 else "")
        report.append(f"{knob}: read at {where}; documented in "
                      f"{sorted(docs.get(knob, set())) or 'nowhere'}")
        if knob not in KNOB_DOCS:
            problems.append(
                f"undocumented knob {knob} (read at {where}): add a "
                "KNOB_DOCS entry in wam_tpu_torch/lint/knobs.py and "
                "regenerate the README table")
    for knob, places in sorted(docs.items()):
        if PORT_KNOB_RE.fullmatch(knob) and knob not in reads:
            problems.append(
                f"dead knob {knob}: mentioned in {sorted(places)} but no "
                "code of the port reads it")
    table = render_table(reads)
    if write_docs:
        if not write_table(root, table):
            problems.append(
                "README.md has no wamlint-torch-knobs markers to write the "
                "table between")
    elif current_table(root) != table:
        problems.append(
            "README knob table is stale (or missing): run "
            "`python -m wam_tpu_torch.lint --knobs --write-docs`")
    return problems, report
