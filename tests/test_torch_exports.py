"""The port's public names against the reference's: every subpackage's
``__all__`` equals `wam_tpu`'s less the names whose slice has not landed
(`PENDING`, each with the ROADMAP.md item that brings it), the top level
exports every name of `wam_tpu.__all__` but those, and ``import
wam_tpu_torch`` needs none of PIL, matplotlib, h5py or plotly: the modules
that use them import them where they are called and name the missing
package when it is not there."""

import importlib
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import wam_tpu
import wam_tpu_torch

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SLICE_F = "ROADMAP.md queue 1 item 2 (slice F)"
VIZ3D = "ROADMAP.md queue 1 item 3 (viz/viz3d.py)"

# name -> the ROADMAP item that brings it, per package
PENDING = {
    "": {},
    "wavelets": {},
    "core": {},
    "ops": {},
    "data": {"ESC50": SLICE_F, "load_sound": SLICE_F},
    "xattr": {},
    "anytime": {},
    "serve": {},
    "parallel": {},
    "testing": {},
    "pod": {},
    "obs": {},
    "pipeline": {},
    # the port's fused ReLU picks the kernel or its plain version by the
    # tensor's device: no process-wide impl knob (wam_tpu_torch/tune/__init__.py)
    "tune": {"set_fused_relu_impl": "no counterpart", "get_fused_relu_impl": "no counterpart"},
    "viz": {name: VIZ3D for name in ("scatter3d", "scatter3d_batch", "scatter3d_superpose",
                                     "scatter3d_colors", "scatter3d_explanation_batch",
                                     "voxel_figure", "voxel_superpose", "voxel_surface_mesh",
                                     "scatter3d_plotly", "voxels_plotly",
                                     "voxel_superpose_plotly", "HAS_PLOTLY")},
}


def _pkgs(sub: str):
    suffix = f".{sub}" if sub else ""
    return (importlib.import_module(f"wam_tpu{suffix}"),
            importlib.import_module(f"wam_tpu_torch{suffix}"))


@pytest.mark.parametrize("sub", ["wavelets", "core", "ops", "data", "viz", "xattr", "anytime",
                                 "serve", "obs", "pipeline", "parallel", "testing", "tune",
                                 "pod"])
def test_subpackage_all_equals_the_reference_less_pending(sub):
    ref, port = _pkgs(sub)
    want = [n for n in ref.__all__ if n not in PENDING[sub]]
    assert port.__all__ == want
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    for name in PENDING[sub]:
        assert name in ref.__all__, f"{name} is not a reference name"
        assert not hasattr(port, name), f"{name} has landed: take it out of PENDING"


def test_top_level_exports_the_reference_names_less_pending():
    missing = [n for n in wam_tpu.__all__
               if n not in PENDING[""] and n not in wam_tpu_torch.__all__]
    assert not missing, missing
    for name in wam_tpu_torch.__all__:
        assert hasattr(wam_tpu_torch, name), name
    for name in PENDING[""]:
        assert name in wam_tpu.__all__ and not hasattr(wam_tpu_torch, name), name


def test_the_queue3_entry_a_imports():
    from wam_tpu_torch import WAMAnalyzer2D, Wavelet, build_wavelet  # noqa: F401
    from wam_tpu_torch.core import WamEngine, target_loss  # noqa: F401
    from wam_tpu_torch.ops import mosaic2d  # noqa: F401
    from wam_tpu_torch.wavelets import dwt2_per, wavedec2, wavedec2_nhwc  # noqa: F401

    assert build_wavelet("db4").filt_len == 8 and isinstance(build_wavelet("haar"), Wavelet)


BLOCKER = """
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("PIL", "matplotlib", "h5py", "plotly"):
            raise ModuleNotFoundError(f"No module named {name!r} (blocked)")
        return None

sys.meta_path.insert(0, Block())
import pkgutil
import wam_tpu_torch
for mod in pkgutil.walk_packages(wam_tpu_torch.__path__, "wam_tpu_torch."):
    importlib.import_module(mod.name)
assert not any(m.split(".")[0] in ("PIL", "matplotlib", "h5py", "plotly") for m in sys.modules)

import numpy as np
from wam_tpu_torch.data import load_3dvoxel_mnist, preprocess_image, show
from wam_tpu_torch.viz import plot_diagonal
for call, package in ((lambda: preprocess_image(np.zeros((4, 4, 3), np.uint8)), "PIL"),
                      (lambda: show(np.zeros((3, 4, 4))), "matplotlib"),
                      (lambda: plot_diagonal({}), "matplotlib"),
                      (lambda: load_3dvoxel_mnist("."), "h5py")):
    try:
        call()
    except ImportError as err:
        assert package in str(err), err
    else:
        raise AssertionError(f"no ImportError without {package}")
print("ok")
"""


def test_import_needs_no_pil_matplotlib_h5py_or_plotly():
    proc = subprocess.run([sys.executable, "-c", BLOCKER], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
