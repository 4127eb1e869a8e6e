"""The compiled WAM-1D entry (`serve_entry(aot_key=)`) on the CPU: its
compiled rows against its eager rows and against the reference's
``serve_entry(aot_key=)`` (Integrated Gradients: no noise draw, so both
packages compute the same function), and a second process with the same
key at 0 first-call compiles (`tests/torch_aot_entries.py`). One compile
a file: the 1D, 3D and video entries each have a file of their own."""

import numpy as np
import pytest
import torch

from tests.torch_aot_entries import inputs, kernel_shape, leaves, port_explainer, run_case
from tests.torch_aot_stub import record_aot_keys

# the suite runs in several pytest-xdist worker processes at once
torch.set_num_threads(1)


def test_compiled_1d_entry_matches_eager_the_reference_and_a_second_process(tmp_path,
                                                                            monkeypatch):
    run_case("1d", tmp_path, monkeypatch)


@pytest.mark.parametrize("kind,method,tag", [
    ("1d", "smooth", "smooth|dwt1-conv|stft-fft"), ("1d", "integratedgrad", "ig|dwt1-conv|stft-fft"),
    ("3d", "smooth", "smooth|synth-conv"), ("3d", "integratedgrad", "ig|synth-conv"),
    ("video", "smooth", "smooth|synth-kernel"), ("video", "integratedgrad", "ig|synth-kernel")])
def test_the_steps_keys_and_the_health_tag(kind, method, tag, monkeypatch):
    """The keys each entry asks the compiled-step cache for (a recording
    stand-in: nothing is compiled): ``{key}|{kind}|{tag}``, with the
    reference's ``|health`` after the key for ``with_health=True``, whose
    vector rides on the compiled rows; the rows equal the eager entry's
    (the video step's spatial levels on the kernel route's plain versions:
    1e-6 of the max)."""
    keys = record_aot_keys(monkeypatch)
    m = port_explainer(kind, np.zeros(kernel_shape(kind), np.float32) + 0.1, method=method)
    x, y = (torch.from_numpy(a) for a in inputs(kind))
    out, vec = m.serve_entry(aot_key="k", with_health=True)(x, y)
    assert keys == [f"k|health|{tag}"]
    want, want_vec = m.serve_entry(with_health=True)(x, y)
    for g, w in zip(leaves(out), leaves(want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max())
    np.testing.assert_allclose(vec.numpy(), want_vec.numpy(), rtol=1e-5)


def test_a_1d_step_that_fails_to_compile_raises_naming_the_impl(monkeypatch):
    """A compiled 1D step runs the impl the 1D knob selects (its key says
    which) or raises, naming it: it never runs another impl in its place
    (a stand-in cache whose program reports a failed compile)."""
    from wam_tpu_torch.pipeline import aot
    from wam_tpu_torch.wavelets import transform as tt

    keys = []

    def cached_entry(unit, key, **kw):
        keys.append(key)

        def entry(*args):
            entry.fns = {"sig": type("P", (), {"aot_status": "fallback",
                                               "error": "Unsupported: a stand-in"})()}
            return unit(*args)

        entry.fns = {}
        return entry

    monkeypatch.setattr(aot, "cached_entry", cached_entry)
    prev = tt._dwt1_impl
    try:
        tt.set_dwt1_impl("folded")
        m = port_explainer("1d", np.zeros(kernel_shape("1d"), np.float32) + 0.1)
        x, y = (torch.from_numpy(a) for a in inputs("1d"))
        with pytest.raises(RuntimeError, match="1D impl 'folded' failed to compile"):
            m.serve_entry(aot_key="k")(x, y)
    finally:
        tt.set_dwt1_impl(prev)
    assert keys == ["k|ig|dwt1-folded|stft-fft"]
