"""The correctness check can fail: the control (the reference in bfloat16
in the package's place) and faults planted under the timed path make
``correct`` false, on the CPU at a tiny size. The control's readings at
the cells' own sizes come from the card (`wambench/control.py`, PERF.md).

    python -m pytest wambench/tests -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from wambench import common, control, run  # noqa: E402
from wambench.tests.test_wambench_harness import CELLS, SEED, run_line, tiny  # noqa: E402

KIND = {w["name"]: common.load_json(ROOT / "wambench" / "traffic" / f"{w['traffic']}.json")["kind"]
        for w in common.load_json(ROOT / "BENCHMARK.json")["workloads"]}


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_check(cell):
    checks = control.control_run(cell, SEED, "cpu", tiny(cell))
    assert not run.is_correct(checks), checks


def _half_the_samples(monkeypatch):
    """The estimators' sample (path-point) batch cut in half, the mean or
    the path sum taken over the rest."""
    from wam_tpu_torch.core import estimators

    orig = estimators._chunked_map

    def half(fn, xs, batch_size):
        return orig(fn, xs[: max(1, xs.shape[0] // 2)], batch_size)

    monkeypatch.setattr(estimators, "_chunked_map", half)


def _edit_maps(monkeypatch, edit_batch, edit_served):
    """Every attribution mosaic edited where it is produced: the explainer's
    batch (offline calls and the evaluators' explanations) by
    ``edit_batch``, the served entry's rows by ``edit_served``."""
    from wam_tpu_torch import wam2d

    orig = wam2d.WaveletAttribution2D.__call__
    orig_entry = wam2d.WaveletAttribution2D.serve_entry

    def edited(self, x, y, noise=None):
        return edit_batch(orig(self, x, y, noise).clone())

    def edited_entry(self, *a, **kw):
        entry = orig_entry(self, *a, **kw)

        def call(x, y):
            return edit_served(entry(x, y).clone())

        for k, v in vars(entry).items():
            setattr(call, k, v)
        return call

    monkeypatch.setattr(wam2d.WaveletAttribution2D, "__call__", edited)
    monkeypatch.setattr(wam2d.WaveletAttribution2D, "serve_entry", edited_entry)


def _answer_altered(monkeypatch, kind):
    """One image's answer altered where it is produced: half of its
    attribution mosaic (offline, served), or its class probability along
    the masks (the evaluators' fan)."""
    if kind == "eval_insdel":
        from wam_tpu_torch.evalsuite import metrics

        orig = metrics.softmax_probs

        def altered(logits):
            p = orig(logits).clone()
            p[0] = p[0] * 1.5
            return p

        monkeypatch.setattr(metrics, "softmax_probs", altered)
        return

    def half(out):
        out[0, : out.shape[1] // 2] *= 1.5
        return out

    def half_rows(out):
        out[:, : out.shape[1] // 2] *= 1.5
        return out

    _edit_maps(monkeypatch, half, half_rows)


def _images_zeroed(monkeypatch, kind):
    """Half of the batch left out: its images' mosaics all zero (a served
    batch: every row), which no ranking can be read from."""

    def zero_half(out):
        out[out.shape[0] // 2:] = 0
        return out

    def zero_rows(out):
        return out.zero_()

    _edit_maps(monkeypatch, zero_half, zero_rows)


def _image_scaled(monkeypatch, kind):
    """A whole image's mosaic scaled by 1.5 (a served batch: every row), as
    a mean taken over the wrong count would: its ranks do not move."""

    def scale_first(out):
        out[0] *= 1.5
        return out

    def scale_rows(out):
        return out.mul_(1.5)

    _edit_maps(monkeypatch, scale_first, scale_rows)


FAULTS = {"half_the_samples": lambda mp, kind: _half_the_samples(mp),
          "answer_altered": _answer_altered, "images_zeroed": _images_zeroed,
          "image_scaled": _image_scaled}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_under_the_timed_path_fails_the_check(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch, KIND[cell])
    rc, res = run_line(cell, 0)
    assert rc == 0
    assert res["correct"] is False, res["checks"]


def test_constant_or_mismatched_maps_never_compare_as_equal():
    """A map with no ranks (all zeros), a scaled map, and two sides of
    different image counts: the ranks read inf where they cannot compare
    and nothing of a scale, which the L2 distance reads; never 0."""
    import math

    import torch

    from wambench import compare

    g = torch.Generator().manual_seed(0)
    want = torch.rand((3, 8, 8), generator=g) + 0.1
    zero = want.clone()
    zero[1] = 0
    assert compare.rank_err(zero, want) == math.inf
    assert compare.rank_err(want, zero) == math.inf
    assert compare.rel_err(want, zero) == math.inf
    assert abs(compare.rel_err(zero, want) - 1.0) < 1e-12
    scaled = want.clone()
    scaled[2] *= 1.5
    assert compare.rank_err(scaled, want) < 1e-12
    assert abs(compare.rel_err(scaled, want) - 0.5) < 1e-6  # float32 maps
    for f in (compare.rank_err, compare.rel_err):
        assert f(want[:2], want) == math.inf
        assert f(want, want) < 1e-12
