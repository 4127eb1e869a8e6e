"""host-sync: device→host transfers inside traced code (the port of
`wam_tpu.lint.rules.host_sync`, retargeted to eager PyTorch).

A host sync inside a body that a compiled step runs (`pipeline.aot`:
``torch.compile(fullgraph=True)``) either fails the compile outright or,
in an eager chunk loop, stalls the host until the card drains, once a
chunk. The reference's sinks keep their messages byte for byte where the
hazard is the same: `np.asarray(...)`, `.item()`, `float(...)`/`int(...)`
on a value, `device_get` / `device_fetch` (a fetch inside a fan step
breaks the fan engine's one-fetch-per-metric contract), and wall-clock
reads (frozen to a trace-time constant inside a compiled step). Torch's
own sinks are added: `.cpu()`, `.to("cpu")`, `.tolist()`, `.numpy()`,
`bool(...)` on a value, `torch.cuda.synchronize()` and
`<event|stream>.synchronize()`, and the ops whose output shape depends on
the data (`nonzero`, one-argument `torch.where`, `masked_select`,
`unique`), which must read the device's answer before they can allocate.

`scripts/torch_check_host_syncs.py` prints this rule's findings in the
reference script's format (`wam_tpu_torch.lint.compat`).
"""

from __future__ import annotations

import ast

from wam_tpu_torch.lint.core import (Finding, LintContext, SourceFile,
                                     iter_traced_functions, load_files, repo_root,
                                     tail_name)
from wam_tpu_torch.lint.registry import Rule, register

# the reference's curated hot-path scope, and the port's modules whose
# bodies the compiled steps reach (the explainers' chunk steps, the
# models' forward methods, the ops, the kernel wrappers and the fused-ReLU
# operators)
LEGACY_SCOPE = (
    "wam_tpu_torch/core", "wam_tpu_torch/evalsuite", "wam_tpu_torch/serve",
    "wam_tpu_torch/pipeline", "wam_tpu_torch/wavelets", "wam_tpu_torch/obs",
    "wam_tpu_torch/testing", "wam_tpu_torch/registry", "wam_tpu_torch/pod",
    "wam_tpu_torch/xattr",
    "wam_tpu_torch/parallel/mesh.py", "wam_tpu_torch/parallel/multihost.py",
    "wam_tpu_torch/parallel/halo.py", "wam_tpu_torch/parallel/halo_modes.py",
    "wam_tpu_torch/parallel/seq_estimators.py",
    "wam_tpu_torch/wam1d.py", "wam_tpu_torch/wam2d.py", "wam_tpu_torch/wam3d.py",
    "wam_tpu_torch/models", "wam_tpu_torch/ops", "wam_tpu_torch/kernels.py",
    "wam_tpu_torch/tune/fused_relu.py",
)

# wall-clock reads that become trace-time constants inside a compiled body
CLOCK_CALLS = {"time", "perf_counter", "monotonic", "monotonic_ns",
               "perf_counter_ns", "time_ns"}

NP_MODULES = {"np", "numpy", "onp"}

# ops whose output shape depends on the data: the host reads the count
DATA_SHAPED = {"nonzero", "masked_select", "unique", "unique_consecutive"}

_SHAPE_MSG = ("() in traced function (its output shape depends on the data: "
              "the host waits for the device's count)")


def _is_cpu_device(node: ast.AST) -> bool:
    """'cpu', torch.device('cpu')."""
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    return (isinstance(node, ast.Call) and tail_name(node.func) == "device"
            and len(node.args) == 1 and _is_cpu_device(node.args[0]))


def sync_messages(fn: ast.AST) -> list[tuple[int, str]]:
    """(line, message) pairs for host-sync calls inside ``fn``; the
    reference's sinks carry the reference's messages."""
    found: list[tuple[int, str]] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        attr = f.attr if isinstance(f, ast.Attribute) else None
        if (attr == "asarray" and isinstance(f.value, ast.Name)
                and f.value.id in NP_MODULES):
            found.append((node.lineno, "np.asarray() in traced function"))
        elif attr == "item" and not node.args:
            found.append((node.lineno, ".item() in traced function"))
        elif (isinstance(f, ast.Name) and f.id in ("float", "int", "bool")
              and len(node.args) == 1
              and isinstance(node.args[0], (ast.Name, ast.Attribute, ast.Call))):
            found.append((node.lineno,
                          f"{f.id}() on a value in traced function"))
        elif tail_name(f) in ("device_get", "device_fetch"):
            found.append((node.lineno,
                          f"{tail_name(f)}() in traced function "
                          "(fetches belong in run_fan, after the fan step)"))
        elif (attr in CLOCK_CALLS and isinstance(f.value, ast.Name)
              and f.value.id == "time"):
            found.append((node.lineno,
                          f"time.{f.attr}() in traced function "
                          "(freezes to a trace-time constant; time spans "
                          "outside the jitted body)"))
        elif attr in ("cpu", "tolist", "numpy") and not node.args:
            found.append((node.lineno, f".{attr}() in traced function"))
        elif attr == "to" and (
                any(_is_cpu_device(a) for a in node.args[:1])
                or any(kw.arg == "device" and _is_cpu_device(kw.value)
                       for kw in node.keywords)):
            found.append((node.lineno, '.to("cpu") in traced function'))
        elif attr == "synchronize":
            what = ("torch.cuda.synchronize()"
                    if tail_name(f.value) == "cuda" else ".synchronize()")
            found.append((node.lineno,
                          f"{what} in traced function (the host waits for "
                          "the device)"))
        elif tail_name(f) in DATA_SHAPED:
            found.append((node.lineno, f"{tail_name(f)}{_SHAPE_MSG}"))
        elif (tail_name(f) == "where" and len(node.args) == 1
              and not node.keywords):
            found.append((node.lineno, f"where{_SHAPE_MSG}"))
    return found


@register
class HostSyncRule(Rule):
    id = "host-sync"
    severity = "error"
    scope = LEGACY_SCOPE
    description = ("host-sync calls (np.asarray/.item()/float()/.cpu()/"
                   ".tolist()/synchronize()/data-shaped ops/wall-clock "
                   "reads) inside traced functions")

    def check_file(self, src: SourceFile, ctx: LintContext) -> list[Finding]:
        out: list[Finding] = []
        for fn in iter_traced_functions(src.tree):
            for line, msg in sync_messages(fn):
                out.append(self.finding(line, msg))
        return out


def scanned_bodies(root: str | None = None) -> dict[str, list[tuple[int, int, str]]]:
    """Repo-relative path -> ``(first line, last line, name)`` of every body
    this rule scans on the tree at ``root`` (its scope): what a run on the
    card checks its host waits against (`chip_smoke.py`)."""
    out: dict[str, list[tuple[int, int, str]]] = {}
    for src in load_files(LEGACY_SCOPE, root=root if root is not None else repo_root()):
        if src.tree is None:
            continue
        spans = [(fn.lineno, fn.end_lineno or fn.lineno, getattr(fn, "name", "<lambda>"))
                 for fn in iter_traced_functions(src.tree)]
        if spans:
            out[src.rel] = spans
    return out
