"""The port's static analysis (`wam_tpu_torch.lint`) against the reference's
(`wam_tpu.lint`, `tests/test_lint.py`).

Every fixture of the reference's tests has a counterpart here:

- rules whose meaning is the same (lock-discipline, schema-drift, parse
  errors, pragmas, the baseline ratchet, the emitters' schemas, the CLI's
  exit codes) take the reference's own fixture through both packages and
  must give the same findings (rule, line, message), apart from the
  tool's and the package's names;
- the retargeted rules (host-sync, retrace-risk, donation-safety,
  precision-flow) take the reference's JAX-form fixture through the
  reference and a torch-form fixture of the same hazard, written line for
  line, through the port: findings of the same rule at the same lines, and
  byte-identical messages for the host-sync sinks the two share; a bad
  fixture each rule MUST flag (these tests fail if detection is disabled)
  and a good twin it must stay silent on; torch's own sinks, tracing
  surface and wrapper names;
- the live-tree gates: ``--all`` and ``--knobs`` are clean, the baseline
  is empty, `scripts/torch_check_host_syncs.py` prints the rule's
  findings.

Everything is pure AST: no fixture module is ever imported."""

import ast
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from wam_tpu.lint import core as jcore
from wam_tpu.lint.__main__ import main as jlint_main
from wam_tpu.lint.emitters import emit_json as jemit_json
from wam_tpu.lint.emitters import emit_sarif as jemit_sarif
from wam_tpu.lint.emitters import emit_text as jemit_text
from wam_tpu.lint.registry import get_rule as jget_rule
from wam_tpu.lint.registry import rule_ids as jrule_ids
from wam_tpu_torch.lint import compat, core, knobs
from wam_tpu_torch.lint.__main__ import main as lint_main
from wam_tpu_torch.lint.emitters import emit_json, emit_sarif, emit_text
from wam_tpu_torch.lint.registry import all_rules, get_rule, rule_ids
from wam_tpu_torch.lint.rules.host_sync import LEGACY_SCOPE, scanned_bodies

# the suite runs in several pytest-xdist worker processes at once
torch.set_num_threads(1)

REPO = core.repo_root()


def _reference_fixtures():
    """tests/test_lint.py as a module (its fixtures are module constants)."""
    p = os.path.join(REPO, "tests", "test_lint.py")
    spec = importlib.util.spec_from_file_location("reference_test_lint", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference_fixtures()
ALL_RULE_IDS = REF.ALL_RULE_IDS


def _src(source, rel):
    text = textwrap.dedent(source)
    tree, err = None, None
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        err = e
    return text, tree, err


def _run(source, rule_id, config=None, rel="wam_tpu_torch/fixture.py", apply_pragmas=True):
    """One rule of the port over one in-memory fixture."""
    text, tree, err = _src(source, rel)
    ctx = core.LintContext(root=REPO, config=config or {})
    rule = get_rule(rule_id)(ctx.rule_config(rule_id))
    src = core.SourceFile(path="/fix/" + rel, rel=rel, text=text, tree=tree, error=err)
    return core.run_rules([rule], [src], ctx, respect_scope=False, apply_pragmas=apply_pragmas)


def _jrun(source, rule_id, config=None, rel="wam_tpu/fixture.py", apply_pragmas=True):
    """The same through the reference."""
    text, tree, err = _src(source, rel)
    ctx = jcore.LintContext(root=REPO, config=config or {})
    rule = jget_rule(rule_id)(ctx.rule_config(rule_id))
    src = jcore.SourceFile(path="/fix/" + rel, rel=rel, text=text, tree=tree, error=err)
    return jcore.run_rules([rule], [src], ctx, respect_scope=False, apply_pragmas=apply_pragmas)


def _lines(result):
    return sorted((f.rule, f.line) for f in result.findings)


def _triples(result):
    """(rule, line, message) with the package names made one."""
    return sorted((f.rule, f.line, f.message.replace("wam_tpu_torch/", "wam_tpu/"))
                  for f in result.findings)


# -- registry ----------------------------------------------------------------

def test_registry_has_the_references_rules():
    assert set(rule_ids()) == ALL_RULE_IDS == set(jrule_ids())
    for cls in all_rules():
        assert cls.description, cls.id
        assert cls.severity in ("error", "warning")
        assert cls.severity == jget_rule(cls.id).severity


def test_the_lint_runs_without_torch():
    """The lint scans without importing what it scans: in a process where
    torch, numpy, jax and the reference cannot be imported (and the port's
    package root, which imports torch, is a bare namespace), the CLI runs
    on the live tree and finds nothing."""
    code = ("import sys, types\n"
            "for m in ('torch', 'numpy', 'jax', 'wam_tpu'):\n"
            "    sys.modules[m] = None\n"
            "pkg = types.ModuleType('wam_tpu_torch')\n"
            f"pkg.__path__ = [{os.path.join(REPO, 'wam_tpu_torch')!r}]\n"
            "sys.modules['wam_tpu_torch'] = pkg\n"
            "from wam_tpu_torch.lint.__main__ import main\n"
            "sys.exit(main(['--all']))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 findings" in proc.stdout.splitlines()[-1]


# -- host-sync ---------------------------------------------------------------

# REF.HOST_SYNC_BAD line for line: the same sinks in a torch.compile body
HOST_SYNC_BAD = '''\
import time
import numpy as np
import torch

@torch.compile
def traced(x):
    a = np.asarray(x)          # line 7
    b = x.item()               # line 8
    c = float(x)               # line 9
    d = device_fetch(x)        # line 10
    t = time.perf_counter()    # line 11
    return a, b, c, d, t
'''

HOST_SYNC_GOOD = '''\
import numpy as np
import torch

def untraced(x):
    return float(np.asarray(x))   # host code: fine

@torch.compile
def traced(x):
    return x * 2.0
'''

# torch's own sinks
HOST_SYNC_TORCH = '''\
import torch

@torch.compile(fullgraph=True)
def traced(x, ev):
    a = x.cpu()                    # line 5
    b = x.to("cpu")                # line 6
    c = x.tolist()                 # line 7
    d = x.numpy()                  # line 8
    e = bool(x)                    # line 9
    torch.cuda.synchronize()       # line 10
    ev.synchronize()               # line 11
    f = torch.nonzero(x)           # line 12
    g = torch.where(x > 0)         # line 13
    h = x.masked_select(x > 0)     # line 14
    i = torch.unique(x)            # line 15
    j = x.to(device=torch.device("cpu"))   # line 16
    k = torch.where(x > 0, x, 0.0)  # three arguments: no sync
    return a, b, c, d, e, f, g, h, i, j, k
'''


def test_host_sync_bad_fixture():
    res, ref = _run(HOST_SYNC_BAD, "host-sync"), _jrun(REF.HOST_SYNC_BAD, "host-sync")
    assert _lines(res) == _lines(ref) == [("host-sync", n) for n in (7, 8, 9, 10, 11)]
    msgs, jmsgs = ({f.line: f.message for f in r.findings} for r in (res, ref))
    for line in (7, 8, 9, 11):  # the shared sinks: byte-identical messages
        assert msgs[line] == jmsgs[line]
    assert msgs[10].startswith("device_fetch() in traced function") and "run_fan" in msgs[10]


def test_host_sync_good_fixture():
    assert _run(HOST_SYNC_GOOD, "host-sync").findings == []
    assert _jrun(REF.HOST_SYNC_GOOD, "host-sync").findings == []


def test_host_sync_torch_sinks():
    res = _run(HOST_SYNC_TORCH, "host-sync")
    assert _lines(res) == [("host-sync", n) for n in range(5, 17)]
    msgs = {f.line: f.message for f in res.findings}
    assert msgs[5] == ".cpu() in traced function"
    assert msgs[6] == msgs[16] == '.to("cpu") in traced function'
    assert msgs[9] == "bool() on a value in traced function"
    assert msgs[10].startswith("torch.cuda.synchronize() in traced function")
    assert msgs[11].startswith(".synchronize() in traced function")
    for line, op in ((12, "nonzero"), (13, "where"), (14, "masked_select"), (15, "unique")):
        assert msgs[line].startswith(f"{op}() in traced function (its output shape")


def test_host_sync_traced_by_reference_and_partial():
    src = '''\
    from functools import partial
    import numpy as np

    def step(x):
        return np.asarray(x)       # line 5: traced via cached_jit(partial(step))

    w = cached_jit(partial(step, 1), (), "k")
    '''
    jsrc = src.replace('cached_jit(partial(step, 1), (), "k")', "jit(partial(step, 1))")
    assert _lines(_run(src, "host-sync")) == _lines(_jrun(jsrc, "host-sync")) \
        == [("host-sync", 5)]


def test_host_sync_nested_def_reported_once():
    src = '''\
    import numpy as np
    import torch

    @torch.compile
    def outer(x):
        def inner(y):
            return np.asarray(y)   # line 7: inside the traced body
        return inner(x)
    '''
    jsrc = src.replace("import torch", "import jax").replace("@torch.compile", "@jax.jit")
    assert _lines(_run(src, "host-sync")) == _lines(_jrun(jsrc, "host-sync")) \
        == [("host-sync", 7)]


TRACING_SURFACE = '''\
import re
import torch
from torch.func import vmap


class Level(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.cpu()             # line 9: a Function's forward

    @staticmethod
    def backward(ctx, g):
        return g.item()            # line 13: and its backward


class Block(torch.nn.Module):
    def forward(self, x):
        return x.tolist()          # line 18: a Module's forward

    def extra_repr(self):
        return str(self.w.tolist())  # not traced


class Deeper(Block):
    def forward(self, x):
        return float(x)            # line 26: a subclass of a local Module


@torch.library.custom_op("ns::op", mutates_args=())
def op(x: torch.Tensor) -> torch.Tensor:
    return x.numpy()               # line 31: an operator's implementation


@op.register_fake
def _(x):
    return x.cpu()                 # line 36: its fake


def per_sample(x):
    return x.item()                # line 40: under torch.func.vmap


def chunk(x):
    return x.tolist()              # line 44: under checkpoint


def step(x):
    return x.cpu()                 # line 48: handed to jit_entry


def host(pattern):
    return re.compile(pattern).match(pattern.item())  # not traced: re.compile


batched = vmap(per_sample)
out = torch.utils.checkpoint.checkpoint(chunk, torch.zeros(1), use_reentrant=False)
entry = jit_entry(step, aot_key="k")
'''


def test_host_sync_sees_torchs_tracing_surface():
    res = _run(TRACING_SURFACE, "host-sync")
    assert _lines(res) == [("host-sync", n) for n in (9, 13, 18, 26, 31, 36, 40, 44, 48)]


# -- retrace-risk ------------------------------------------------------------

# REF.RETRACE_BAD line for line
RETRACE_BAD = '''\
import torch
import torch.nn.functional as F

def serve_loop(batches, f):
    for b in batches:
        g = torch.compile(f)       # line 6: wrapper rebuilt per iteration
        yield g(b)

def per_call(f, x):
    return torch.compile(f)(x)     # line 10: construct-and-invoke

@torch.compile
def traced(x, w=torch.zeros(3)):   # line 13: tensor default on traced fn
    return x + w
'''

RETRACE_GOOD = '''\
import torch

g = torch.compile(lambda x: x * 2)  # module-level: cached once

def serve(batches):
    return [g(b) for b in batches]
'''

# the port's wrapper names
RETRACE_BAD_PORT = '''\
import torch

def warm(keys, impl, args):
    for k in keys:
        e = cached_entry(impl, k)            # line 5
        e(*args)

def once(impl, x, y):
    return jit_entry(impl, aot_key="k")(x, y)   # line 9

def step(x, w=torch.tensor([1.0])):          # line 11: traced below
    return x * w

run = cached_jit(step, (), "k")
'''


def test_retrace_bad_fixture():
    res = _run(RETRACE_BAD, "retrace-risk")
    assert _lines(res) == _lines(_jrun(REF.RETRACE_BAD, "retrace-risk")) \
        == [("retrace-risk", n) for n in (6, 10, 13)]
    assert _lines(_run(RETRACE_BAD_PORT, "retrace-risk")) == [("retrace-risk", n)
                                                              for n in (5, 9, 11)]


def test_retrace_good_fixture():
    assert _run(RETRACE_GOOD, "retrace-risk").findings == []
    assert _jrun(REF.RETRACE_GOOD, "retrace-risk").findings == []
    # re.compile is not torch.compile
    assert _run("import re\n\ndef f(ps):\n    for p in ps:\n        re.compile(p)\n",
                "retrace-risk").findings == []


def test_retrace_no_double_report_in_loop():
    src = '''\
    import torch

    def f(batches, fn):
        for b in batches:
            y = torch.compile(fn)(b)     # ONE finding, not two
        return y
    '''
    jsrc = src.replace("import torch", "import jax").replace("torch.compile", "jax.jit")
    assert _lines(_run(src, "retrace-risk")) == _lines(_jrun(jsrc, "retrace-risk")) \
        == [("retrace-risk", 5)]


# -- donation-safety ---------------------------------------------------------

# REF.DONATION_BAD line for line (jit(f, donate_argnums=...) -> cached_jit)
DONATION_BAD = '''\
def bad(f, x):
    g = donating_jit(f)
    out = g(x)
    return x + out                 # line 4: x was donated on line 3

def bad_inline(f, x):
    y = cached_jit(f, (), "k", donate_argnums=(0,))(x)
    return x - y                   # line 8
'''

DONATION_GOOD = '''\
from wam_tpu_torch.pipeline.donation import donation_safe

def rebind(f, x):
    x = donating_jit(f)(x)         # donate + rebind in ONE statement
    return x                       # fresh tensor: fine

def chained(f, x):
    w = cached_jit(f, (), "k", donate_argnums=(0,))
    x = w(x)
    x = w(x)                       # each call donates the rebound x
    return x

def safe(f, x):
    g = donating_jit(f)
    out = g(donation_safe(x, True))   # sanctioned keep-alive wrapper
    return x + out

def no_donation(f, x):
    g = cached_jit(f, (), "k", donate_argnums=())  # empty tuple donates nothing
    out = g(x)
    return x + out
'''


def test_donation_bad_fixture():
    res = _run(DONATION_BAD, "donation-safety")
    assert _lines(res) == _lines(_jrun(REF.DONATION_BAD, "donation-safety")) \
        == [("donation-safety", 4), ("donation-safety", 8)]
    assert "donated" in res.findings[0].message
    assert "donation_safe" in res.findings[0].message


def test_donation_good_fixture():
    assert _run(DONATION_GOOD, "donation-safety").findings == []
    assert _jrun(REF.DONATION_GOOD, "donation-safety").findings == []


def test_donation_reports_once_per_donation():
    src = '''\
    def f(g, x):
        w = donating_jit(g)
        y = w(x)
        a = x + 1                  # line 4: first read -> finding
        b = x + 2                  # same donation: not re-reported
        return a, b, y
    '''
    assert _lines(_run(src, "donation-safety")) == _lines(_jrun(src, "donation-safety")) \
        == [("donation-safety", 4)]


def test_donation_of_the_serving_entry():
    src = '''\
    def serve(impl, x, y):
        entry = jit_entry(impl, donate=True)
        out = entry(x, y)
        return out, x.shape        # line 4: the staged batch was released
    '''
    assert _lines(_run(src, "donation-safety")) == [("donation-safety", 4)]


# -- lock-discipline (same meaning: the reference's fixtures) ----------------

@pytest.mark.parametrize("name,want", [("LOCKS_BAD", [12, 15]), ("LOCKS_GOOD", [])])
def test_locks_fixtures(name, want):
    source = getattr(REF, name)
    res = _run(source, "lock-discipline")
    assert _triples(res) == _triples(_jrun(source, "lock-discipline"))
    assert [f.line for f in res.findings] == want
    if want:
        assert "_GUARDED_BY" in res.findings[0].message
        assert "self._lock" in res.findings[0].message


def test_locks_nested_def_does_not_inherit_lock():
    src = '''\
    import threading

    class S:
        _GUARDED_BY = {"_rows": "_lock"}

        def __init__(self):
            self._lock = threading.Lock()
            self._rows = []

        def spawn(self):
            with self._lock:
                def cb():
                    self._rows.append(1)   # line 13: closure outlives block
                return cb
    '''
    res = _run(src, "lock-discipline")
    assert _triples(res) == _triples(_jrun(src, "lock-discipline"))
    assert _lines(res) == [("lock-discipline", 13)]


# -- precision-flow ----------------------------------------------------------

# REF.PRECISION_BAD line for line
PRECISION_BAD = '''\
import torch

def kernel(x, w):
    xb = x.to(torch.bfloat16)
    return torch.matmul(xb, w)     # line 5: bf16 contraction, bf16 product

def op(x, w):
    xb = x.to(torch.bfloat16)
    return xb @ w                  # line 9: @ rounds the product to bf16
'''

PRECISION_GOOD = '''\
import torch

def kernel(x, w):
    xb = x.to(torch.bfloat16)
    return torch.matmul(xb.float(), w.to(torch.bfloat16).float())

def upcast_clears(x, w):
    xb = x.to(torch.bfloat16)
    xf = xb.to(torch.float32)      # back to f32: taint cleared
    return torch.matmul(xf, w)

def f32_only(x, w):
    return torch.matmul(x, w)      # no bf16 in sight
'''

# the shape of the bf16 mel chain's repaired fault: the DFT and filterbank
# matmuls fed bf16 operands, so every product rounded to bf16
PRECISION_MEL_BAD = '''\
import torch

def mel(frames, C, S, fb):
    fb16 = fb.to(torch.bfloat16)
    re = frames.bfloat16() @ C.bfloat16()              # line 5
    im = torch.matmul(frames.bfloat16(), S.bfloat16())  # line 6
    power = re.float() * re.float() + im.float() * im.float()
    half = power.half()
    return torch.matmul(half, fb16)                    # line 9
'''

# the sanctioned form: bf16-rounded operands multiplied and summed in float32
PRECISION_MEL_GOOD = '''\
import torch

def _bf16_matmul(a, b, out):
    return a.to(torch.bfloat16).to(out) @ b.to(torch.bfloat16).to(out)

def mel(frames, C, fb):
    re = _bf16_matmul(frames, C, torch.float32)
    return _bf16_matmul(re * re, fb, torch.float32)
'''


def test_precision_bad_fixture():
    res = _run(PRECISION_BAD, "precision-flow")
    assert _lines(res) == _lines(_jrun(REF.PRECISION_BAD, "precision-flow")) \
        == [("precision-flow", 5), ("precision-flow", 9)]
    assert "float32" in res.findings[0].message
    assert _lines(_run(PRECISION_MEL_BAD, "precision-flow")) == [("precision-flow", n)
                                                                 for n in (5, 6, 9)]


def test_precision_good_fixture():
    assert _run(PRECISION_GOOD, "precision-flow").findings == []
    assert _jrun(REF.PRECISION_GOOD, "precision-flow").findings == []
    assert _run(PRECISION_MEL_GOOD, "precision-flow").findings == []


def test_precision_taint_flows_through_branches():
    src = '''\
    import torch

    def f(x, w, flag):
        xb = x.to(torch.bfloat16)
        if flag:
            return torch.mm(xb, w)             # line 6
        return torch.mm(xb.float(), w.float())
    '''
    jsrc = '''\
    import jax.numpy as jnp

    def f(x, w, flag):
        xb = x.astype(jnp.bfloat16)
        if flag:
            return jnp.dot(xb, w)          # line 6
        return jnp.dot(xb, w, preferred_element_type=jnp.float32)
    '''
    assert _lines(_run(src, "precision-flow")) == _lines(_jrun(jsrc, "precision-flow")) \
        == [("precision-flow", 6)]


def test_precision_sources_and_sinks():
    src = '''\
    import torch
    import torch.nn.functional as F

    def f(x, w, b, policy):
        h = x.half()
        F.linear(h, w)                           # line 6
        c = compute_cast(x, policy)
        F.conv2d(c, w)                           # line 8
        z = torch.zeros(3, dtype=torch.bfloat16)
        torch.einsum("i,i->", z, b)              # line 10
        d = compute_cast(x, torch.float32)
        return torch.bmm(d, w)                   # f32 shim: fine
    '''
    assert _lines(_run(src, "precision-flow")) == [("precision-flow", n) for n in (6, 8, 10)]


# -- schema-drift (same meaning: the reference's fixtures) -------------------

@pytest.mark.parametrize("name,want", [("SCHEMA_BAD", [2, 3]), ("SCHEMA_GOOD", [])])
def test_schema_drift_fixtures(name, want):
    source = getattr(REF, name)
    res = _run(source, "schema-drift", config=REF.SCHEMA_CONFIG)
    assert _triples(res) == _triples(_jrun(source, "schema-drift", config=REF.SCHEMA_CONFIG))
    assert [f.line for f in res.findings] == want


def test_schema_registry_parses_from_live_tree():
    """The port's registry (wam_tpu_torch/obs/schema.py) AST-parses without
    importing, and declares what the reference's declares."""
    from wam_tpu.lint.rules.precision import _load_declared as jload
    from wam_tpu_torch.lint.rules.precision import _load_declared

    metrics, rows = _load_declared(core.LintContext(root=REPO, config={}))
    assert len(metrics) >= 40 and len(rows) >= 10
    assert all(m.startswith("wam_tpu_") for m in metrics)
    assert (metrics, rows) == jload(jcore.LintContext(root=REPO, config={}))


def test_schema_drift_catches_a_rogue_metric_in_the_port(tmp_path):
    """The live registry, a port module with an undeclared instrument."""
    res = _run('def f(reg):\n    reg.counter("wam_tpu_rogue_total", 1)\n', "schema-drift")
    assert _lines(res) == [("schema-drift", 2)]
    assert "wam_tpu_torch/obs/schema.py" in res.findings[0].message


# -- parse errors ------------------------------------------------------------

def test_parse_error_becomes_finding(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def oops(:\n")
    files = core.load_files([str(bad)], root=str(tmp_path))
    res = core.run_rules([get_rule("host-sync")()], files, core.LintContext(root=str(tmp_path)),
                         respect_scope=False)
    jfiles = jcore.load_files([str(bad)], root=str(tmp_path))
    jres = jcore.run_rules([jget_rule("host-sync")()], jfiles,
                           jcore.LintContext(root=str(tmp_path)), respect_scope=False)
    assert [f.rule for f in res.findings] == ["parse-error"]
    assert "syntax error" in res.findings[0].message
    assert _triples(res) == _triples(jres)


# -- pragmas (the same fixtures through both) ---------------------------------

def _pragma_cases():
    line7 = "a = np.asarray(x)          # line 7"
    return {
        "same_line": (line7, "a = np.asarray(x)  # wamlint: disable=host-sync", 2, 3),
        "disable_file": (None, "# wamlint: disable-file=host-sync\n", 5, 0),
        "other_rule": (line7, "a = np.asarray(x)  # wamlint: disable=retrace-risk", 0, 5),
    }


@pytest.mark.parametrize("case", sorted(_pragma_cases()))
def test_pragmas_match_the_reference(case):
    old, new, suppressed, left = _pragma_cases()[case]

    def patch(src):
        return new + src if old is None else src.replace(old, new)

    res = _run(patch(HOST_SYNC_BAD), "host-sync")
    jres = _jrun(patch(REF.HOST_SYNC_BAD), "host-sync")
    assert res.suppressed == jres.suppressed == suppressed
    assert len(res.findings) == len(jres.findings) == left
    assert _lines(res) == _lines(jres)


def test_pragma_line_above_suppresses():
    src = '''\
    import numpy as np

    @jit_entry
    def traced(x):
        # wamlint: disable=host-sync
        return np.asarray(x)
    '''
    res = _run(src, "host-sync")
    assert res.findings == [] and res.suppressed == 1
    jres = _jrun(src.replace("@jit_entry", "@jit"), "host-sync")
    assert jres.findings == [] and jres.suppressed == 1


# -- baseline ratchet --------------------------------------------------------

def test_baseline_roundtrip_and_ratchet(tmp_path):
    res = _run(HOST_SYNC_BAD, "host-sync")
    assert len(res.findings) == 5
    path = str(tmp_path / "baseline.json")
    core.write_baseline(path, res.findings)
    baseline = core.load_baseline(path)
    assert sum(baseline.values()) == 5
    kept, absorbed = core.apply_baseline(res.findings, baseline)
    assert kept == [] and absorbed == 5
    kept, absorbed = core.apply_baseline(res.findings + res.findings, baseline)
    assert absorbed == 5 and len(kept) == 5
    shifted = [dataclasses.replace(f, line=f.line + 100) for f in res.findings]
    kept, absorbed = core.apply_baseline(shifted, baseline)
    assert kept == [] and absorbed == 5
    # the reference's ratchet on its own findings agrees count for count
    jres = _jrun(REF.HOST_SYNC_BAD, "host-sync")
    jpath = str(tmp_path / "jbaseline.json")
    jcore.write_baseline(jpath, jres.findings)
    assert sorted(jcore.load_baseline(jpath).values()) == sorted(baseline.values())


def test_checked_in_baseline_is_valid_and_empty():
    path = os.path.join(REPO, core.DEFAULT_BASELINE)
    assert core.DEFAULT_BASELINE == os.path.join("wam_tpu_torch", "lint", "baseline.json")
    with open(path) as f:
        data = json.load(f)
    assert data["version"] == 1
    assert data["findings"] == {}


# -- emitters ----------------------------------------------------------------

def _both():
    return _run(HOST_SYNC_BAD, "host-sync"), _jrun(REF.HOST_SYNC_BAD, "host-sync")


def test_text_emitter_summary():
    out, jout = (f(r) for f, r in zip((emit_text, jemit_text), _both()))
    assert out.splitlines()[-1] == ("wam_tpu_torch.lint: 1 files, 5 findings "
                                    "(0 pragma-suppressed, 0 baselined)")
    assert out.splitlines()[-1].replace("wam_tpu_torch.lint", "wam_tpu.lint") \
        == jout.splitlines()[-1]
    assert "wam_tpu_torch/fixture.py:7: [host-sync] np.asarray()" in out


def test_json_emitter_schema():
    res, jres = _both()
    doc, jdoc = json.loads(emit_json(res)), json.loads(jemit_json(jres))
    assert doc["version"] == 1 and doc["files"] == 1 and len(doc["findings"]) == 5
    assert set(doc) == set(jdoc)
    for f, jf in zip(doc["findings"], jdoc["findings"]):
        assert set(f) == set(jf) == {"rule", "severity", "path", "line", "message"}
        assert f["path"] == "wam_tpu_torch/fixture.py"
        assert (f["rule"], f["severity"], f["line"]) == (jf["rule"], jf["severity"], jf["line"])


def test_sarif_emitter_schema():
    res, jres = _both()
    doc, jdoc = json.loads(emit_sarif(res)), json.loads(jemit_sarif(jres))
    assert doc["version"] == jdoc["version"] == "2.1.0"
    assert doc["$schema"] == jdoc["$schema"]
    run, jrun = doc["runs"][0], jdoc["runs"][0]
    assert run["tool"]["driver"]["name"] == "wam_tpu_torch.lint"
    assert {r["id"] for r in run["tool"]["driver"]["rules"]} == ALL_RULE_IDS
    assert len(run["results"]) == len(jrun["results"]) == 5
    for r, jr in zip(run["results"], jrun["results"]):
        assert (r["ruleId"], r["level"]) == (jr["ruleId"], jr["level"])
        loc, jloc = (x["locations"][0]["physicalLocation"] for x in (r, jr))
        assert loc["region"] == jloc["region"]
        assert loc["artifactLocation"]["uriBaseId"] == "SRCROOT"


# -- the host-sync script ------------------------------------------------------

def _load_script():
    p = os.path.join(REPO, "scripts", "torch_check_host_syncs.py")
    spec = importlib.util.spec_from_file_location("torch_check_host_syncs", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_script_output_contract_on_fixture(tmp_path, capsys):
    bad = tmp_path / "mod.py"
    bad.write_text(HOST_SYNC_BAD)
    script = _load_script()
    assert script.main([str(bad)]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"{bad}:7: np.asarray() in traced function"
    assert len(out) == 6
    assert out[-1] == "torch_check_host_syncs: 1 files, 5 findings"
    good = tmp_path / "ok.py"
    good.write_text(HOST_SYNC_GOOD)
    assert script.main([str(good)]) == 0
    assert capsys.readouterr().out.splitlines() == ["torch_check_host_syncs: 1 files, 0 findings"]


def test_script_interleaves_syntax_errors(tmp_path, capsys):
    (tmp_path / "a_broken.py").write_text("def oops(:\n")
    (tmp_path / "b_bad.py").write_text(HOST_SYNC_BAD)
    assert _load_script().main([str(tmp_path)]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{tmp_path / 'a_broken.py'}: syntax error:")
    assert out[1].startswith(f"{tmp_path / 'b_bad.py'}:7:")
    assert out[-1] == "torch_check_host_syncs: 2 files, 6 findings"


def test_live_tree_parity_script_vs_rule():
    legacy_lines, nfiles = compat.legacy_host_sync_lines(None)
    assert nfiles > 50  # the scope really was walked
    files = core.load_files(list(LEGACY_SCOPE), root=REPO)
    res = core.run_rules([get_rule("host-sync")()], files, core.LintContext(root=REPO),
                         respect_scope=True, apply_pragmas=False)
    modern = [f"{f.abspath}:{f.line}: {f.message}" for f in res.findings]
    assert sorted(modern) == sorted(legacy_lines)
    proc = subprocess.run([sys.executable, "scripts/torch_check_host_syncs.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout
    assert proc.stdout.splitlines()[-1] == f"torch_check_host_syncs: {nfiles} files, 0 findings"


def test_scanned_bodies_cover_the_compiled_steps():
    """What the card's check holds its host waits against: the chunk steps
    of every compiled entry, the kernel operators, the models' forwards."""
    bodies = scanned_bodies(REPO)
    names = {(rel, name) for rel, spans in bodies.items() for _, _, name in spans}
    for rel in ("wam_tpu_torch/wam1d.py", "wam_tpu_torch/wam2d.py", "wam_tpu_torch/wam3d.py",
                "wam_tpu_torch/xattr/video.py"):
        assert (rel, "step") in names
    assert ("wam_tpu_torch/wavelets/matmul.py", "dwt2_op") in names
    assert ("wam_tpu_torch/wavelets/transform.py", "_level_op") in names
    assert ("wam_tpu_torch/models/resnet3d.py", "forward") in names
    for spans in bodies.values():
        assert all(a <= b for a, b, _ in spans)


# -- knob audit --------------------------------------------------------------

def test_knob_scan_finds_direct_and_const_reads(tmp_path):
    pkg = tmp_path / "wam_tpu_torch"
    pkg.mkdir()
    (pkg / "m.py").write_text(textwrap.dedent('''\
        import os
        KEY_ENV = "WAM_TORCH_FIXTURE_KEY"
        a = os.getenv("WAM_TPU_FIXTURE_DIRECT")
        b = os.environ.get(KEY_ENV)
        c = os.environ["WAM_TORCH_FIXTURE_SUB"]
        os.environ["WAM_TORCH_FIXTURE_WRITE"] = "1"
    '''))
    (tmp_path / "scripts").mkdir()
    (tmp_path / "scripts" / "torch_x.py").write_text(
        'import os\nv = os.environ.setdefault("WAM_TORCH_FIXTURE_SCRIPT", "")\n')
    (tmp_path / "scripts" / "bench_x.py").write_text(  # not the port's
        'import os\nv = os.getenv("WAM_TPU_FIXTURE_REFERENCE")\n')
    (tmp_path / "chip_smoke.py").write_text('import os\nv = os.getenv("WAM_TORCH_FIXTURE_CHIP")\n')
    reads = knobs.scan_knob_reads(str(tmp_path))
    assert set(reads) == {"WAM_TPU_FIXTURE_DIRECT", "WAM_TORCH_FIXTURE_KEY",
                          "WAM_TORCH_FIXTURE_SUB", "WAM_TORCH_FIXTURE_SCRIPT",
                          "WAM_TORCH_FIXTURE_CHIP"}
    assert reads["WAM_TORCH_FIXTURE_KEY"] == ["wam_tpu_torch/m.py:4"]


def test_knob_audit_clean_on_live_tree():
    problems, report = knobs.audit(REPO, write_docs=False)
    assert problems == []
    assert len(report) >= 10
    reads = knobs.scan_knob_reads(REPO)
    for knob in reads:
        assert knob in knobs.KNOB_DOCS, knob
    assert "WAM_TORCH_DWT1_IMPL" in reads and "WAM_TPU_FUSED_RELU_IMPL" in reads
    # the port adds no WAM_TPU_* name: each is one the reference reads too
    from wam_tpu.lint import knobs as jknobs

    jreads = jknobs.scan_knob_reads(REPO)
    assert {k for k in reads if k.startswith("WAM_TPU_")} <= set(jreads)


def test_knob_audit_flags_undocumented_dead_and_stale(tmp_path):
    (tmp_path / "README.md").write_text(
        f"# x\nWAM_TORCH_GONE\n\n{knobs.BEGIN_MARK}\nstale\n{knobs.END_MARK}\n")
    pkg = tmp_path / "wam_tpu_torch"
    pkg.mkdir()
    (pkg / "m.py").write_text('import os\nv = os.getenv("WAM_TORCH_NEW_KNOB")\n')
    problems, _ = knobs.audit(str(tmp_path))
    assert any("undocumented knob WAM_TORCH_NEW_KNOB" in p for p in problems)
    assert any("dead knob WAM_TORCH_GONE" in p for p in problems)
    assert any("stale" in p for p in problems)


def test_knob_table_write_roundtrip(tmp_path):
    (tmp_path / "README.md").write_text(
        f"# x\n\n{knobs.BEGIN_MARK}\nstale\n{knobs.END_MARK}\n\ntail\n")
    pkg = tmp_path / "wam_tpu_torch"
    pkg.mkdir()
    (pkg / "m.py").write_text('import os\nv = os.getenv("WAM_TORCH_DWT1_IMPL")\n')
    table = knobs.render_table(knobs.scan_knob_reads(str(tmp_path)))
    assert knobs.write_table(str(tmp_path), table)
    assert knobs.current_table(str(tmp_path)) == table
    assert knobs.KNOB_DOCS["WAM_TORCH_DWT1_IMPL"] in table


# -- CLI ---------------------------------------------------------------------

def test_cli_all_clean_on_live_tree(capsys):
    """THE gate: every rule over its own scope, current checkout, zero
    non-baselined findings."""
    assert lint_main(["--all"]) == 0
    assert "0 findings" in capsys.readouterr().out.splitlines()[-1]


def test_cli_knobs_clean_on_live_tree(capsys):
    assert lint_main(["--knobs"]) == 0
    assert capsys.readouterr().out.splitlines()[-1].endswith(" 0 problems")


def test_cli_explicit_path_json(tmp_path, capsys):
    bad, jbad = tmp_path / "fixture.py", tmp_path / "jfixture.py"
    bad.write_text(RETRACE_BAD)
    jbad.write_text(REF.RETRACE_BAD)
    rc = lint_main([str(bad), "--rules", "retrace-risk", "--format", "json", "--no-baseline"])
    doc = json.loads(capsys.readouterr().out)
    jrc = jlint_main([str(jbad), "--rules", "retrace-risk", "--format", "json",
                      "--no-baseline"])
    jdoc = json.loads(capsys.readouterr().out)
    assert rc == jrc == 1
    assert [f["line"] for f in doc["findings"]] == [f["line"] for f in jdoc["findings"]] \
        == [6, 10, 13]


def test_cli_baseline_write_then_absorb(tmp_path, capsys):
    bad = tmp_path / "fixture.py"
    bad.write_text(RETRACE_BAD)
    base = str(tmp_path / "baseline.json")
    assert lint_main([str(bad), "--rules", "retrace-risk", "--write-baseline",
                      "--baseline", base]) == 0
    capsys.readouterr()
    assert lint_main([str(bad), "--rules", "retrace-risk", "--baseline", base]) == 0
    assert "3 baselined" in capsys.readouterr().out.splitlines()[-1]


def test_cli_list_rules(capsys):
    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in ALL_RULE_IDS:
        assert rid in out
    assert "wam_tpu_torch/models" in out  # host-sync's scope reaches the forwards


def test_cli_unknown_rule_errors():
    with pytest.raises(KeyError):
        lint_main(["--rules", "nonesuch"])
    with pytest.raises(KeyError):
        jlint_main(["--rules", "nonesuch"])


def test_module_cli_in_a_subprocess():
    """``python -m wam_tpu_torch.lint`` exits 0 on the tree and 1 on a bad
    file, as the reference's CLI does."""
    proc = subprocess.run([sys.executable, "-m", "wam_tpu_torch.lint", "--all"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout
    assert proc.stdout.splitlines()[-1].startswith("wam_tpu_torch.lint: ")
