"""Guards on the PyTorch port's boundaries: it never imports the JAX package,
it never runs on the CPU (or on a plain version) unless the caller asked,
its kernels are built for Hopper from the repository's sources, and
`chip_smoke.py` refuses to report anything without a card."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import wam_tpu_torch
from wam_tpu_torch import kernels
from wam_tpu_torch.device import resolve_device
from wam_tpu_torch.evalsuite import Eval1DWAM, Eval2DWAM
from wam_tpu_torch import wam1d as tw1
from wam_tpu_torch import wam3d as tw3
from wam_tpu_torch.models import audio as taudio
from wam_tpu_torch.models import convnext as tconvnext
from wam_tpu_torch.models import pointnet as tpn
from wam_tpu_torch.models import resnet as tres
from wam_tpu_torch.models import resnet3d as tr3
from wam_tpu_torch.models import vit as tvit
from wam_tpu_torch.models import voxel as tvoxel
from wam_tpu_torch.models.toy import toy_conv_model
from wam_tpu_torch.tune import fused_relu as tfr
from wam_tpu_torch.wam2d import BaseWAM2D, WaveletAttribution2D
from wam_tpu_torch.wavelets import filters as tfilters
from wam_tpu_torch.wavelets import matmul as tmm
from wam_tpu_torch.wavelets import transform as tt

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "wam_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "wam_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "scripts").glob("torch_*.py")),
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
            "wam_tpu_torch.ops", "wam_tpu_torch.models", "wam_tpu_torch.tune",
            "wam_tpu_torch.evalsuite", "wam_tpu_torch.serve", "wam_tpu_torch.obs",
            "wam_tpu_torch.pipeline"} <= found
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


LAUNCHERS = ("dwt2", "synth2", "pair", "pair_bwd", "relu_fwd", "relu_bwd")


@pytest.mark.parametrize("crossover", [128, 9], ids=["collapsed", "per-level"])
def test_cpu_tensors_never_reach_the_kernels(monkeypatch, crossover):
    """The kernel impl on CPU tensors runs the plain versions only: the
    launchers and the build are never called and no count moves, on the
    collapsed synthesis (K3), the per-level one (K2) and a model bound with
    the fused ReLU (K4/K5)."""
    def boom(*a, **k):
        raise AssertionError("CUDA path reached from CPU tensors")

    for name in (*LAUNCHERS, "build_all"):
        monkeypatch.setattr(kernels, name, boom)
    monkeypatch.setattr(tt, "SYNTH_COLLAPSE", crossover)
    before = kernels.launch_counts()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 1, 24, 24))
                         .astype(np.float32))
    coeffs = tt.wavedec2(x, "db4", 3, impl="kernel")
    assert tt._collapse_count(coeffs[1:]) == {128: 3, 9: 0}[crossover]
    rec = tt.waverec2(coeffs, "db4", impl="kernel")
    torch.testing.assert_close(rec[..., :24, :24], x, atol=1e-4, rtol=0)
    toy = toy_conv_model(device="cpu")
    WaveletAttribution2D(lambda v: toy(v[:, 0]), wavelet="db4", n_samples=2, device="cpu",
                         impl="kernel")(x, torch.tensor([0, 1]))
    fn = tres.bind_inference(tres.resnet18(num_classes=2), fused_relu_vjp=True, device="cpu")
    WaveletAttribution2D(fn, wavelet="db4", n_samples=2, device="cpu",
                         impl="kernel")(x.expand(2, 3, 24, 24), torch.tensor([0, 1]))
    assert kernels.launch_counts() == before


def test_vit_slice_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tvit.bind_vit_inference(tvit.vit_tiny_test(image_size=32)),
                 lambda: tres.bind_inference(tconvnext.convnext_test(), nchw=True)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_vit_on_cpu_tensors_never_reaches_the_kernels(monkeypatch):
    """IG and SmoothGrad on the tiny ViT and ConvNeXt with the kernel impl on
    CPU tensors run the plain versions only."""
    def boom(*a, **k):
        raise AssertionError("CUDA path reached from CPU tensors")

    for name in (*LAUNCHERS, "build_all"):
        monkeypatch.setattr(kernels, name, boom)
    before = kernels.launch_counts()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 3, 32, 32))
                         .astype(np.float32))
    for model in (tvit.vit_tiny_test(num_classes=3, image_size=32),
                  tconvnext.convnext_test(num_classes=3)):
        fn = tvit.bind_vit_inference(model, nchw=True, device="cpu")
        for method in ("integratedgrad", "smooth"):
            out = WaveletAttribution2D(fn, wavelet="haar", J=3, method=method, n_samples=2,
                                       device="cpu", impl="kernel")(x, torch.tensor([1]))
            assert out.shape == (1, 32, 32)
    assert kernels.launch_counts() == before


def test_audio_entry_points_raise_without_a_card(monkeypatch):
    """The audio slice's entry points run on CUDA unless asked: with no
    device and no card each raises, naming device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = taudio.toy_wave_model(device="cpu")
    x = np.zeros((1, 4096), np.float32)
    for make in (lambda: tw1.BaseWAM1D(fn), lambda: tw1.WaveletAttribution1D(fn),
                 lambda: tw1.VisualizerWAM1D(fn, x), lambda: tw1.normalize_waveforms(x),
                 lambda: taudio.bind_audio_inference(taudio.AudioCNN()),
                 lambda: taudio.toy_wave_model()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tw1.WaveletAttribution1D(fn, device="cuda")


def test_audio_path_launches_no_kernel(monkeypatch):
    """The 1D path (transform, mel front end, AudioCNN) reaches no port
    kernel: the launchers and the build are never called and no count
    moves, even with CUDA routes taken wherever the wrappers ask."""
    def boom(*a, **k):
        raise AssertionError("a port kernel was reached from the 1D path")

    for name in (*LAUNCHERS, "build_all"):
        monkeypatch.setattr(kernels, name, boom)
    monkeypatch.setattr(tmm, "on_cpu", lambda t: False)
    monkeypatch.setattr(tfr, "on_cpu", lambda t: False)
    before = kernels.launch_counts()
    fn = taudio.bind_audio_inference(taudio.AudioCNN(num_classes=5), device="cpu")
    x = np.random.default_rng(0).standard_normal((1, 65536)).astype(np.float32)
    for kw in ({"method": "smooth", "stream_noise": True}, {"method": "integratedgrad"}):
        mel, coeffs = tw1.WaveletAttribution1D(fn, wavelet="db6", J=5, n_samples=2, device="cpu",
                                               **kw)(x, [3])
        assert mel.shape == (1, 129, 128) and len(coeffs) == 6
    assert kernels.launch_counts() == before


def test_wam3d_entry_points_raise_without_a_card(monkeypatch):
    """The 3D slice's entry points run on CUDA unless asked: with no device
    and no card each raises, naming device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = tres.bind_inference(tr3.resnet3d_10(width=4), device="cpu")
    for make in (lambda: tw3.WaveletAttribution3D(fn), lambda: tw3.BaseWAM3D(fn),
                 lambda: tw3.BaseWAM3D(fn, instance="point_clouds"),
                 lambda: tres.bind_inference(tr3.resnet3d_18()),
                 lambda: tres.bind_inference(tvoxel.VoxelModel()),
                 lambda: tres.bind_inference(tpn.PointNetCls(k=4))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_vol_path_launches_k4_k5_on_the_fused_arm_only(monkeypatch):
    """The vol path as the card runs it (impl="kernel", 25 samples in chunks
    of 16 and 9), at a tiny size, with the CUDA routes taken wherever the
    wrappers ask: the plain 3D ResNet-18 and the voxel and point-cloud paths
    reach no kernel; bound with fold_bn and fused_relu_vjp it launches K4
    and K5 at each of its 17 ReLU sites once a chunk, 34 times each a
    call, and nothing else."""
    def boom(*a, **k):
        raise AssertionError("a wavelet kernel was reached from the 3D path")

    counts = {"relu_fwd": 0, "relu_bwd": 0}

    def counted(name, plain):
        def launch(*a):
            counts[name] += 1
            return plain(*a)
        return launch

    for name in ("dwt2", "synth2", "pair", "pair_bwd", "build_all"):
        monkeypatch.setattr(kernels, name, boom)
    monkeypatch.setattr(kernels, "relu_fwd", counted("relu_fwd", tfr.relu_fwd_plain))
    monkeypatch.setattr(kernels, "relu_bwd", counted("relu_bwd", tfr.relu_bwd_plain))
    monkeypatch.setattr(tmm, "on_cpu", lambda t: False)
    monkeypatch.setattr(tfr, "on_cpu", lambda t: False)
    x = np.random.default_rng(0).standard_normal((1, 1, 8, 8, 8)).astype(np.float32)
    kw = dict(wavelet="haar", J=2, n_samples=25, sample_batch_size=16, device="cpu",
              impl="kernel")
    state = tr3.resnet3d_18(num_classes=10, width=4).state_dict()
    for fused, want in ((False, 0), (True, 34)):
        fn = tres.bind_inference(tr3.resnet3d_18(num_classes=10, width=4), state, fold_bn=fused,
                                 fused_relu_vjp=fused, device="cpu")
        for method in ("smooth", "integratedgrad"):
            counts.update(relu_fwd=0, relu_bwd=0)
            out = tw3.WaveletAttribution3D(fn, method=method, **kw)(x, [3])
            assert out.shape == (1, 8, 8, 8)
            assert counts == {"relu_fwd": want, "relu_bwd": want}, (fused, method)
    counts.update(relu_fwd=0, relu_bwd=0)
    vox = tres.bind_inference(tvoxel.VoxelModel(), device="cpu")
    tw3.WaveletAttribution3D(vox, **{**kw, "n_samples": 2})(
        np.zeros((2, 1, 16, 16, 16), np.float32), [0, 1])
    pn = tres.bind_inference(tpn.PointNetCls(k=4), device="cpu")
    tw3.BaseWAM3D(pn, J=3, instance="point_clouds", device="cpu")(
        np.random.default_rng(1).standard_normal((2, 3, 64)).astype(np.float32), [0, 1])
    assert counts == {"relu_fwd": 0, "relu_bwd": 0}


def test_evaluators_raise_without_a_card(monkeypatch):
    """The evaluators run on CUDA unless asked: with no device and no card
    each raises, naming device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = toy_conv_model(device="cpu")
    for cls in (Eval2DWAM, Eval1DWAM):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(fn, None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(fn, None, device="cuda")
        assert cls(fn, None, device="cpu").device == torch.device("cpu")


def _haar():
    w = tfilters.build_wavelet("haar")
    return tuple(w.dec_lo), tuple(w.dec_hi), tuple(w.rec_lo), tuple(w.rec_hi)


def test_eval2d_on_cuda_resolves_to_the_kernels(monkeypatch):
    """`Eval2DWAM` with no ``impl`` on CUDA tensors (a CPU tensor that says
    it is on CUDA) at the headline's image geometry (haar J=3, 224²): each
    image decomposes once a metric call through K1 (3 levels), and each
    reconstruction family is one K3 forward over masks x 3 channels rows
    (insertion 65 x 3 = 195 rows; μ two families an image), never K3's backward,
    K2, K4 or K5; followed with stand-ins of the launchers that run the
    plain versions, and held against the conv route on plain tensors."""
    dec_lo, dec_hi, rec_lo, rec_hi = _haar()
    cpu = torch.device("cpu")
    calls = []

    def dwt2(x3, plan):
        calls.append(("dwt2", x3.shape[0]))
        _, At = tmm._kernel_analysis(plan.q, dec_lo, dec_hi, "reflect", cpu)
        _, Bt = tmm._kernel_analysis(plan.s, dec_lo, dec_hi, "reflect", cpu)
        return tmm.dwt2_plain(x3, At, Bt)

    def pair(leaves, plan):
        calls.append(("pair", leaves[0].shape[0]))
        out = 0
        for i, (R, C) in enumerate(zip(tmm._level_blocks(plan.rows, rec_lo, rec_hi),
                                       tmm._level_blocks(plan.cols, rec_lo, rec_hi))):
            h, v, d = leaves[1 + 3 * i:4 + 3 * i]
            aa = leaves[0] if i == 0 else torch.zeros_like(h)
            y = torch.cat([torch.cat([aa, v], -1), torch.cat([h, d], -1)], -2)
            out = out + torch.from_numpy(R).float() @ y @ torch.from_numpy(C).float().T
        return out

    for name, fn in (("dwt2", dwt2), ("pair", pair)):
        monkeypatch.setattr(kernels, name, fn)
    for name in ("pair_bwd", "synth2", "relu_fwd", "relu_bwd", "build_all"):
        monkeypatch.setattr(kernels, name, lambda *a: pytest.fail("not on the eval2d path"))
    rng = np.random.default_rng(11)
    weights = torch.from_numpy(rng.standard_normal((4, 3 * 224 * 224)).astype(np.float32) / 400)

    def model_fn(v):  # a cheap classifier of (B, 3, 224, 224), every pixel weighed
        return torch.tanh(v.reshape(v.shape[0], -1) @ weights.T)

    x = torch.from_numpy(rng.standard_normal((2, 3, 224, 224)).astype(np.float32))
    wams = rng.random((2, 224, 224)).astype(np.float32)
    out = {}
    for tag, xin in (("cuda", x.as_subclass(FakeCuda)), ("plain", x)):
        ev = Eval2DWAM(model_fn, None, wavelet="haar", J=3, batch_size=128, device="cpu")
        ev.grad_wams = torch.from_numpy(wams)
        calls.clear()
        out[tag] = ev.insertion(xin, [0, 3], n_iter=64), ev.insertion_curves
        want = ([("dwt2", 3)] * 3 + [("pair", 195)]) * 2  # 65-mask fans: an image a chunk
        assert calls == (want if tag == "cuda" else []), calls
        calls.clear()
        out[tag] += (ev.mu_fidelity(xin, [0, 3], grid_size=28, sample_size=16,
                                    subset_size=157),)
        # 16-mask fans: both images in one chunk (8 a chunk under the cap)
        assert calls == ([("dwt2", 3)] * 6 + [("pair", 48)] * 4 if tag == "cuda" else []), calls
    np.testing.assert_allclose(out["cuda"][0], out["plain"][0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.stack(out["cuda"][1]), np.stack(out["plain"][1]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(out["cuda"][2], out["plain"][2], rtol=0, atol=1e-5)


@pytest.mark.parametrize("side, k2", [(224, 0), (256, 1)], ids=["224", "256"])
def test_serve_buckets_route_through_the_kernels(monkeypatch, side, k2):
    """The flagship's served entry (db4, J=3, SmoothGrad) on each bucket of
    the README's server, one dispatched batch on the kernel route (the
    kernels' plain versions behind counted wrappers of the route
    functions): 224² collapses every synthesis level (detail sides
    115/61/34: K1 3, K3 forward and backward), 256² runs its finest level
    (131 >= SYNTH_COLLAPSE) through K2, whose backward is one more K1
    launch, and K3 the two coarser ones. The counts do not depend on the
    batch's rows (one launch a level for the whole batch)."""
    counts = dict.fromkeys(("dwt2", "synth2", "pair"), 0)

    def counted(name, fn, backward=None):
        def wrapped(*a, **k):
            counts[name] += 1
            out = fn(*a, **k)
            if backward is not None and out.requires_grad:
                out.register_hook(lambda g: counts.__setitem__(backward, counts[backward] + 1))
            return out
        return wrapped

    monkeypatch.setattr(tmm, "dwt2_kernel", counted("dwt2", tmm.dwt2_kernel))
    monkeypatch.setattr(tmm, "idwt2_kernel", counted("synth2", tmm.idwt2_kernel, "dwt2"))
    monkeypatch.setattr(tmm, "waverec2_collapsed", counted("pair", tmm.waverec2_collapsed,
                                                           "pair"))
    coeffs = tt.wavedec2(torch.zeros(1, 3, side, side), "db4", 3, impl="kernel")
    sides = [d.horizontal.shape[-1] for d in coeffs[1:]]
    assert sides == ([34, 61, 115] if side == 224 else [38, 69, 131])
    assert tt._collapse_count(coeffs[1:]) == 3 - k2
    for k in counts:
        counts[k] = 0
    rng = np.random.default_rng(side)
    weights = torch.from_numpy(rng.standard_normal((5, 3 * side * side)).astype(np.float32))

    def model_fn(v):
        return v.reshape(v.shape[0], -1) @ weights.T

    wam = WaveletAttribution2D(model_fn, wavelet="db4", J=3, n_samples=2, device="cpu",
                               impl="kernel")
    out = wam.serve_entry()(torch.from_numpy(rng.standard_normal(
        (2, 3, side, side)).astype(np.float32)), torch.tensor([0, 4]))
    assert out.shape[0] == 2 and bool(torch.isfinite(out).all())
    assert counts == {"dwt2": 3 + k2, "synth2": k2, "pair": 2}, counts


def test_kernel_launchers_refuse_cpu_tensors(monkeypatch):
    """Called directly with CPU tensors, the launchers raise before any
    build: they have no CPU path of their own."""
    monkeypatch.setattr(kernels, "build_all", lambda *a: pytest.fail("built on CPU input"))
    x = torch.zeros(2, 8, 8)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.dwt2(x, tmm.dwt2_band(8, 8, (0.5, 0.5), (-0.5, 0.5), "reflect", cpu))
    fwd, bwd = tmm.pair_band((3, 5), (3, 5), (0.5, 0.5), (0.5, -0.5), cpu)
    leaves = [torch.zeros(2, 3, 3)] + [torch.zeros(2, r, r) for r in (3, 5) for _ in range(3)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.pair(leaves, fwd)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.pair_bwd(torch.zeros(2, bwd.p, bwd.t), bwd)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.synth2(torch.zeros(2, 4, 4, 4),
                       tmm.idwt2_band(4, 4, (0.5, 0.5), (0.5, -0.5), cpu)[0])
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.relu_fwd(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.relu_bwd(torch.zeros(1, 128, dtype=torch.uint8), x)
    with pytest.raises(TypeError):
        kernels.pair([t.double() for t in leaves], fwd)


def test_unknown_device_is_rejected():
    x = torch.zeros(1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tmm.dwt2_kernel(x, "haar", "reflect")


class FakeCuda(torch.Tensor):
    """A CPU tensor that says it lives on CUDA, to follow the CUDA route."""

    @property
    def is_cuda(self):
        return True


def test_per_level_synthesis_on_cuda_reaches_k2(monkeypatch):
    """impl="kernel" on a CUDA tensor runs the per-level synthesis through
    the K2 launcher, with the subbands stacked (aa, ad, da, dd) and the band
    plan of Sr, Sc^T, and its backward through the K1 launcher with the plan
    of Sr^T, Sc; never through a plain version."""
    calls = []
    plain = tmm.idwt2_plain
    w = tfilters.build_wavelet("db4")
    Sr, _ = tmm._kernel_synthesis(9, tuple(w.rec_lo), tuple(w.rec_hi), torch.device("cpu"))
    Sc, Sct = tmm._kernel_synthesis(7, tuple(w.rec_lo), tuple(w.rec_hi), torch.device("cpu"))

    def dims(plan):
        return plan.q, plan.s, plan.p, plan.t

    def synth2(sub, plan):
        calls.append(("synth2", tuple(sub.shape), dims(plan)))
        return plain(sub, Sr, Sct)

    def dwt2(g, plan):
        calls.append(("dwt2", tuple(g.shape), dims(plan)))
        return tmm.dwt2_plain(g, Sr, Sc)

    monkeypatch.setattr(kernels, "synth2", synth2)
    monkeypatch.setattr(kernels, "dwt2", dwt2)
    monkeypatch.setattr(tmm, "idwt2_plain", lambda *a: pytest.fail("plain K2 on CUDA"))
    leaves = [torch.randn(1, 1, 9, 7).as_subclass(FakeCuda).requires_grad_(True)
              for _ in range(4)]
    out = tt.idwt2(leaves[0], tt.Detail2D(*leaves[1:]), "db4", impl="kernel")
    assert tuple(out.shape[-2:]) == (12, 8)
    # autograd hands the backward a plain tensor: follow the CUDA route there too
    monkeypatch.setattr(tmm, "on_cpu", lambda t: False)
    torch.autograd.grad(out.sum(), leaves)
    assert calls == [("synth2", (1, 4, 9, 7), (18, 14, 12, 8)),
                     ("dwt2", (1, 12, 8), (12, 8, 18, 14))]


def test_collapsed_synthesis_on_cuda_reaches_k3_with_the_leaves(monkeypatch):
    """impl="kernel" on CUDA tensors runs the collapsed levels through the K3
    launchers in both directions: the forward gets the leaves themselves
    (cA, then H, V, D per level, coarsest first), K1's subband views passed
    in place, and the backward returns every leaf's gradient. Neither the
    assembly of Y nor the plain pair runs, and no op of the forward or the
    backward makes a tensor of Y's (or dY's) shape. Values and gradients
    equal the plain CPU route."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Shapes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes, self.paused = [], False

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not self.paused:
                self.shapes += [tuple(t.shape) for t in tree_flatten(out)[0]
                                if isinstance(t, torch.Tensor)]
            return out

    w = tfilters.build_wavelet("db4")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, 40, 44)).astype(np.float32))
    coeffs = tt.wavedec2(x, "db4", 3, impl="kernel")  # leaves: views of (N, 4, h, w) outputs
    flat = [coeffs[0]] + [t for d in coeffs[1:] for t in d]
    rs = tuple(d.horizontal.shape[-2] for d in coeffs[1:])
    cs = tuple(d.horizontal.shape[-1] for d in coeffs[1:])
    assert tt._collapse_count(coeffs[1:]) == 3
    Rb = [torch.from_numpy(b).float() for b in tmm._level_blocks(rs, tuple(w.rec_lo), tuple(w.rec_hi))]
    Cb = [torch.from_numpy(b).float() for b in tmm._level_blocks(cs, tuple(w.rec_lo), tuple(w.rec_hi))]
    mode, calls = Shapes(), []

    def pair(leaves, plan):  # sum_l R_l Y_l C_l^T, level by level
        calls.append(("pair", [t.data_ptr() for t in leaves], plan.rows, plan.cols))
        mode.paused = True
        out = 0
        for i, (R, C) in enumerate(zip(Rb, Cb)):
            h, v, d = leaves[1 + 3 * i:4 + 3 * i]
            aa = leaves[0] if i == 0 else torch.zeros_like(h)
            y = torch.cat([torch.cat([aa, v], -1), torch.cat([h, d], -1)], -2)
            out = out + R @ y @ C.T
        mode.paused = False
        return out

    def pair_bwd(g, plan):
        calls.append(("pair_bwd", tuple(g.shape), plan.rows, plan.cols))
        mode.paused = True
        grads = []
        for i, (R, C, r, c) in enumerate(zip(Rb, Cb, rs, cs)):
            dy = R.T @ g @ C
            grads += ([dy[:, :r, :c]] if i == 0 else []) + [
                dy[:, r:, :c], dy[:, :r, c:], dy[:, r:, c:]]  # (aa,) H, V, D
        mode.paused = False
        return [t.contiguous() for t in grads]

    monkeypatch.setattr(kernels, "pair", pair)
    monkeypatch.setattr(kernels, "pair_bwd", pair_bwd)
    monkeypatch.setattr(tmm, "assemble_collapsed", lambda *a: pytest.fail("Y assembled on CUDA"))
    monkeypatch.setattr(tmm, "pair_plain", lambda *a: pytest.fail("plain K3 on CUDA"))
    leaves = [t.detach().as_subclass(FakeCuda).requires_grad_(True) for t in flat]
    g = torch.from_numpy(rng.standard_normal((2, 3, 40, 44)).astype(np.float32))
    with mode:
        rec = tt.waverec2([leaves[0]] + [tt.Detail2D(*leaves[1 + 3 * i:4 + 3 * i])
                                         for i in range(3)], "db4", impl="kernel")
        got = rec[..., :40, :44]
        grads = torch.autograd.grad(got, leaves, g)
    y_shape = (2 * sum(rs), 2 * sum(cs))
    assert [c[0] for c in calls] == ["pair", "pair_bwd"]
    assert calls[0][1] == [t.data_ptr() for t in flat]  # the leaves, read in place
    assert calls[0][2:] == calls[1][2:] == (rs, cs)
    assert not any(s[-2:] == y_shape for s in mode.shapes if len(s) >= 2), y_shape

    monkeypatch.undo()
    plain = [t.detach().clone().requires_grad_(True) for t in flat]
    want = tt.waverec2([plain[0]] + [tt.Detail2D(*plain[1 + 3 * i:4 + 3 * i]) for i in range(3)],
                       "db4", impl="kernel")[..., :40, :44]
    torch.testing.assert_close(got.as_subclass(torch.Tensor), want, atol=1e-5, rtol=0)
    for a, b in zip(grads, torch.autograd.grad(want, plain, g)):
        torch.testing.assert_close(a.as_subclass(torch.Tensor), b, atol=1e-5, rtol=0)


def test_fused_relu_on_cuda_reaches_k4_and_k5(monkeypatch):
    calls = []
    plain = tfr.relu_fwd_plain

    def relu_fwd(x):
        calls.append("relu_fwd")
        return plain(x)

    def relu_bwd(m, g):
        calls.append("relu_bwd")
        return tfr.relu_bwd_plain(m, g)

    monkeypatch.setattr(kernels, "relu_fwd", relu_fwd)
    monkeypatch.setattr(kernels, "relu_bwd", relu_bwd)
    monkeypatch.setattr(tfr, "relu_fwd_plain", lambda *a: pytest.fail("plain K4 on CUDA"))
    x = torch.randn(3, 50).as_subclass(FakeCuda).requires_grad_(True)
    y = tfr.fused_relu(x)
    torch.autograd.grad(y, x, torch.ones_like(y).as_subclass(FakeCuda))
    assert calls == ["relu_fwd", "relu_bwd"]


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


@pytest.mark.parametrize("header", ["collapsed.cuh", "band2.cuh"])
def test_library_name_follows_the_headers(monkeypatch, tmp_path, header):
    """Both shared headers (band2.cuh for K1-K3, collapsed.cuh for K3) are
    hashed into every library's name: an edited header never loads a stale
    build of K1-K3."""
    assert header in kernels._HEADERS
    before = {k: kernels.KERNELS[k].library_path() for k in ("dwt2", "synth2", "pair")}
    edited = tmp_path / "csrc"
    edited.mkdir()
    for src in kernels._CSRC.iterdir():
        (edited / src.name).write_text(src.read_text() + ("\n// edited\n" if src.name == header
                                                          else ""))
    monkeypatch.setattr(kernels, "_CSRC", edited)
    for name, path in before.items():
        k = kernels.KERNELS[name]
        monkeypatch.setattr(k, "source", edited / k.source.name)
        assert k.library_path() != path, name


def test_every_cu_source_names_the_tpu_kernel_it_replaces():
    """Each source's head names the TPU kernel(s) it replaces as
    wam_tpu/<path>.py::<function>, each a function of that file, and says
    what bounds it on the card; together they cover every kernel."""
    named = set()
    for src in (PKG / "csrc").glob("*.cu"):
        head = " ".join(src.read_text()[:2000].replace("//", " ").split())
        found = re.findall(r"(wam_tpu/[\w/]+\.py)::(\w+)", head)
        assert "Replaces the TPU kernel" in head and found, src.name
        for path, fn in found:
            defs = {n.name for n in ast.walk(ast.parse((ROOT / path).read_text()))
                    if isinstance(n, ast.FunctionDef)}
            assert fn in defs, f"{src.name}: {path} has no function {fn}"
            named.add(fn)
        assert "Bound on an H100" in head, src.name
    assert named == {"_fused_kernel", "_fused_synth_kernel", "_pair_kernel", "_fwd_kernel",
                     "_bwd_kernel"}


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


def test_audio_public_names_exported():
    for name in ("WaveletAttribution1D", "BaseWAM1D", "VisualizerWAM1D", "normalize_waveforms",
                 "scaleogram", "wavedec", "waverec", "dwt", "idwt", "melspectrogram",
                 "stft_power", "mel_filterbank", "amplitude_to_db", "AudioCNN",
                 "bind_audio_inference", "toy_wave_model", "flax_audio_to_torch",
                 "sample_noise"):
        assert hasattr(wam_tpu_torch, name), name
        assert name in wam_tpu_torch.__all__, name


def test_vit_slice_public_names_exported():
    import wam_tpu_torch.models as tmodels

    for name in ("ViT", "vit_b16", "vit_tiny_test", "bind_vit_inference", "ConvNeXt",
                 "convnext_tiny", "convnext_test", "PatchConv", "flax_vit_to_torch",
                 "flax_convnext_to_torch"):
        for pkg in (wam_tpu_torch, tmodels):
            assert hasattr(pkg, name), (pkg.__name__, name)
            assert name in pkg.__all__, (pkg.__name__, name)


def test_wam3d_public_names_exported():
    import wam_tpu_torch.models as tmodels

    for name in ("WaveletAttribution3D", "BaseWAM3D", "filter_coeffs", "cube3d", "cube_size",
                 "visualize_cube", "dwt3", "idwt3", "wavedec3", "waverec3", "DETAIL3D_KEYS",
                 "ResNet3D", "resnet3d_10", "resnet3d_18", "VoxelModel", "PointNetCls",
                 "PointNetDenseCls", "PointNetFeat", "feature_transform_regularizer",
                 "flax_resnet3d_to_torch", "flax_voxel_to_torch", "flax_pointnet_to_torch"):
        assert hasattr(wam_tpu_torch, name), name
        assert name in wam_tpu_torch.__all__, name
    for name in ("ResNet3D", "resnet3d_10", "resnet3d_18", "VoxelModel", "STN", "STN3d", "STNkd",
                 "PointNetFeat", "PointNetfeat", "PointNetCls", "PointNetDenseCls",
                 "feature_transform_regularizer", "flax_resnet3d_to_torch",
                 "flax_voxel_to_torch", "flax_pointnet_to_torch"):
        assert hasattr(tmodels, name) and name in tmodels.__all__, name


def test_eval_public_names_exported():
    import wam_tpu_torch.evalsuite as tev

    for name in ("Eval2DWAM", "Eval1DWAM", "EvalConfig", "PrecisionPolicy",
                 "resolve_precision"):
        assert hasattr(wam_tpu_torch, name) and name in wam_tpu_torch.__all__, name
    for name in ("Eval1DWAM", "Eval2DWAM", "FanPlan", "plan_fan", "fan_runner", "run_fan",
                 "device_fetch", "fetch_count", "fetch_scope", "reset_fetch_count",
                 "compute_auc", "generate_masks", "minmax_normalize", "softmax_probs",
                 "spearman", "coeffs_to_array1d", "array_to_coeffs1d", "coeffs_to_array2d",
                 "array_to_coeffs2d", "packed2d_shape", "imagenet_preprocess",
                 "imagenet_denormalize"):
        assert hasattr(tev, name) and name in tev.__all__, name


def test_public_names_exported():
    for name in ("WaveletAttribution2D", "BaseWAM2D", "WamEngine", "wavedec2", "waverec2",
                 "mosaic2d", "reproject_mosaic", "bind_inference", "resnet50",
                 "flax_resnet_to_torch", "smoothgrad", "fused_relu", "idwt2_kernel"):
        assert hasattr(wam_tpu_torch, name), name


def test_baselines_path_launches_no_kernel(monkeypatch):
    """The baseline methods and their evaluators reach no port kernel (their
    models, gradients and fans are library calls): the launchers and the
    build are never called and no count moves, even with CUDA routes taken
    wherever the wrappers ask."""
    from wam_tpu_torch.evalsuite import (
        AUDIO_METHODS,
        IMAGE_METHODS,
        EvalAudioBaselines,
        EvalImageBaselines,
    )

    def boom(*a, **k):
        raise AssertionError("a port kernel was reached from the baselines path")

    for name in (*LAUNCHERS, "build_all"):
        monkeypatch.setattr(kernels, name, boom)
    monkeypatch.setattr(tmm, "on_cpu", lambda t: False)
    monkeypatch.setattr(tfr, "on_cpu", lambda t: False)
    before = kernels.launch_counts()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    for method in IMAGE_METHODS[:9]:
        ev = EvalImageBaselines(tres.resnet18(num_classes=4), method=method, n_samples=2,
                                batch_size=16, cam_layer="stage3", device="cpu")
        assert len(ev.insertion(x, [0, 3], n_iter=4)) == 2
    mel = rng.standard_normal((1, 1, 129, 128)).astype(np.float32)
    for method in AUDIO_METHODS:
        ev = EvalAudioBaselines(taudio.AudioCNN(num_classes=4), method=method, n_samples=2,
                                device="cpu")
        assert ev.precompute(mel, [1]).shape == (1, 129, 128)
    assert kernels.launch_counts() == before


def test_baselines_public_names_exported():
    import wam_tpu_torch.evalsuite as tev
    import wam_tpu_torch.models as tmodels

    for name in ("EvalImageBaselines", "EvalAudioBaselines", "IMAGE_METHODS", "AUDIO_METHODS",
                 "ResNet", "resnet34", "resnet101"):
        assert hasattr(wam_tpu_torch, name) and name in wam_tpu_torch.__all__, name
    for name in ("EvalImageBaselines", "EvalAudioBaselines", "IMAGE_METHODS", "AUDIO_METHODS",
                 "saliency", "integrated_gradients", "smoothgrad_pixel", "gradcam",
                 "gradcam_pp", "layercam"):
        assert hasattr(tev, name) and name in tev.__all__, name
    for name in ("resnet34", "resnet101"):
        assert hasattr(tmodels, name) and name in tmodels.__all__, name
