"""The compiled WAM-3D entry (`serve_entry(aot_key=)`) on the CPU: its
compiled rows against its eager rows and against the reference's
``serve_entry(aot_key=)`` (Integrated Gradients: no noise draw, so both
packages compute the same function), and a second process with the same
key at 0 first-call compiles (`tests/torch_aot_entries.py`). One compile
a file: the 1D, 3D and video entries each have a file of their own."""

import torch

from tests.torch_aot_entries import run_case

# the suite runs in several pytest-xdist worker processes at once
torch.set_num_threads(1)


def test_compiled_3d_entry_matches_eager_the_reference_and_a_second_process(tmp_path,
                                                                            monkeypatch):
    run_case("3d", tmp_path, monkeypatch)
