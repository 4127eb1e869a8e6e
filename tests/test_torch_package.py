"""Guards on the PyTorch port's boundaries: it never imports the JAX package,
it never runs on the CPU (or on a plain version) unless the caller asked,
its kernels are built for Hopper from the repository's sources, and
`chip_smoke.py` refuses to report anything without a card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import wam_tpu_torch
from wam_tpu_torch import kernels
from wam_tpu_torch.device import resolve_device
from wam_tpu_torch.models import resnet as tres
from wam_tpu_torch.models.toy import toy_conv_model
from wam_tpu_torch.wam2d import BaseWAM2D, WaveletAttribution2D
from wam_tpu_torch.wavelets import matmul as tmm
from wam_tpu_torch.wavelets import transform as tt

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "wam_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "wam_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_package_imports_with_jax_blocked():
    """Every module of the port imports in a process where jax, flax and
    wam_tpu cannot be imported."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py"))
    code = ("import sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
            + "".join(f"import {m}\n" for m in mods))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_pyproject_packages_include_the_port():
    from setuptools import find_packages

    found = set(find_packages(where=str(ROOT), include=["wam_tpu*"]))
    assert {"wam_tpu_torch", "wam_tpu_torch.wavelets", "wam_tpu_torch.core",
            "wam_tpu_torch.ops", "wam_tpu_torch.models"} <= found
    assert 'include = ["wam_tpu*"]' in (ROOT / "pyproject.toml").read_text()


# -- no silent CPU path ----------------------------------------------------------


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    fn = toy_conv_model(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WaveletAttribution2D(fn)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BaseWAM2D(fn)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tres.bind_inference(tres.resnet18(num_classes=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        toy_conv_model()
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    """The kernel impl on CPU tensors runs the plain versions only: the
    launchers and the build are never called and no count moves."""
    def boom(*a, **k):
        raise AssertionError("CUDA path reached from CPU tensors")

    monkeypatch.setattr(kernels, "dwt2", boom)
    monkeypatch.setattr(kernels, "pair", boom)
    monkeypatch.setattr(kernels, "build_all", boom)
    before = kernels.launch_counts()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 1, 24, 24))
                         .astype(np.float32))
    coeffs = tt.wavedec2(x, "db4", 3, impl="kernel")
    assert tt._collapse_count(coeffs[1:]) == 3
    rec = tt.waverec2(coeffs, "db4", impl="kernel")
    torch.testing.assert_close(rec[..., :24, :24], x, atol=1e-4, rtol=0)
    toy = toy_conv_model(device="cpu")
    WaveletAttribution2D(lambda v: toy(v[:, 0]), wavelet="db4", n_samples=2, device="cpu",
                         impl="kernel")(x, torch.tensor([0, 1]))
    assert kernels.launch_counts() == before


def test_kernel_launchers_refuse_cpu_tensors(monkeypatch):
    """Called directly with CPU tensors, the launchers raise before any
    build: they have no CPU path of their own."""
    monkeypatch.setattr(kernels, "build_all", lambda *a: pytest.fail("built on CPU input"))
    x, m = torch.zeros(2, 8, 8), torch.zeros(8, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.dwt2(x, m, m)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.pair(x, m, m)
    with pytest.raises(TypeError):
        kernels.pair(x.double(), m, m)


def test_unknown_device_is_rejected():
    x = torch.zeros(1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tmm.dwt2_kernel(x, "haar", "reflect")


def test_per_level_synthesis_on_cuda_raises_until_k2_is_ported(monkeypatch):
    """impl="kernel" on a CUDA tensor never quietly runs the plain
    per-level synthesis: it raises and points at the roadmap."""
    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    cA = torch.zeros(1, 1, 8, 8).as_subclass(FakeCuda)
    det = tt.Detail2D(cA, cA, cA)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.idwt2(cA, det, "haar", impl="kernel")


# -- build -------------------------------------------------------------------------


def test_nvcc_command_targets_hopper_from_repo_sources(tmp_path):
    for k in kernels.KERNELS.values():
        cmd = kernels.nvcc_command(k, tmp_path / "lib.so")
        assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
        for flag in ("-O3", "-shared", "-fPIC"):
            assert flag in cmd
        assert Path(cmd[-1]).is_relative_to(PKG / "csrc") and Path(cmd[-1]).exists()
        lib = k.library_path()
        assert lib.parent == ROOT / "build" / "wam_tpu_torch"
    assert "build/" in (ROOT / ".gitignore").read_text().splitlines()


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    """An edited source gets a new library name, so a stale build is never
    loaded."""
    k = kernels.KERNELS["pair"]
    before = k.library_path()
    src = tmp_path / "pair.cu"
    src.write_text(k.source.read_text() + "\n// edited\n")
    monkeypatch.setattr(k, "source", src)
    assert k.library_path() != before


def test_every_cu_source_names_the_tpu_kernel_it_replaces():
    for src in (PKG / "csrc").glob("*.cu"):
        head = src.read_text()[:1500]
        assert "Replaces the TPU kernel wam_tpu/wavelets/matmul.py::" in head, src.name
        assert "Bound on an H100" in head, src.name


# -- chip_smoke.py ---------------------------------------------------------------


def test_chip_smoke_fails_without_a_card():
    """With every card hidden, so the check holds on a machine that has one."""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120, env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_public_names_exported():
    for name in ("WaveletAttribution2D", "BaseWAM2D", "WamEngine", "wavedec2", "waverec2",
                 "mosaic2d", "reproject_mosaic", "bind_inference", "resnet50",
                 "flax_resnet_to_torch", "smoothgrad"):
        assert hasattr(wam_tpu_torch, name), name
