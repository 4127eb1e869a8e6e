"""Parity of the PyTorch port's WAM-3D slice with the JAX package: the 3D
transform (analysis, both synthesis forms, their VJPs), the cube packing and
its visualization, `BaseWAM3D` (voxels, labeled and ``y=None``, voxel
filtering, point clouds and their filtering), `WaveletAttribution3D`
(SmoothGrad and IG), and the fused-ReLU model.

Inputs, weights and SmoothGrad draws come from numpy seeds and go to both
packages (the JAX side averages `BaseWAM3D` passes on x + sigma * z_i; the
port takes the draws through ``noise=``). Models: the 3D ResNet-10 at width 4
on 8^3 volumes and PointNetCls on clouds of 64 points, weights drawn into the
JAX models' variable trees (`tests/test_torch_models3d.py`) and carried
across by the port's ingest. The JAX side's 2D/3D synthesis and 1D transform
knobs are pinned for the module and put back after.

Tolerances: transform values and VJPs within 1e-5 in float32 (of the
largest value where it exceeds 1) and 1e-12 in float64 (different summation
orders); packing within 1e-6; attributions
within 1e-4 of their largest value (float32 gradients through the model).
"""

import contextlib
import importlib
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models3d import _jax_model
from wam_tpu import wam3d as jw3
from wam_tpu.core import estimators as jest
from wam_tpu.models import pointnet as jpn
from wam_tpu.models import resnet3d as jr3
from wam_tpu.ops import packing3d as jpack
from wam_tpu.wavelets import transform as jt
from wam_tpu_torch import wam3d as tw3
from wam_tpu_torch.core import engine as tengine
from wam_tpu_torch.models import pointnet as tpn
from wam_tpu_torch.models import resnet as tres
from wam_tpu_torch.models import resnet3d as tr3
from wam_tpu_torch.models.ingest import flax_pointnet_to_torch, flax_resnet3d_to_torch
from wam_tpu_torch.ops import packing3d as tpack
from wam_tpu_torch.wavelets import matmul as tmm
from wam_tpu_torch.wavelets import transform as tt

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

MODES = ["reflect", "symmetric", "zero", "constant", "periodic"]
KEYS = tt.DETAIL3D_KEYS
TOL = 1e-5
SLICE_TOL = 1e-4
jfr = importlib.import_module("wam_tpu.tune.fused_relu")


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _np(t):
    return t.detach().numpy()


def _leaves(coeffs) -> list:
    return [coeffs[0]] + [d[k] for d in coeffs[1:] for k in KEYS]


def _tree(leaves, level: int, wrap) -> list:
    it = iter(leaves)
    return [wrap(next(it))] + [{k: wrap(next(it)) for k in KEYS} for _ in range(level)]


def _near(got, want, tol=TOL, err_msg=""):
    """Within ``tol`` x max(1, the largest reference value): coefficients of
    a second 3D level grow to ~10, where float32 sums of 8^3 products
    differ by a few 1e-5."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, float(np.abs(want).max())), rtol=0,
                               err_msg=err_msg)


def _close(got, want, tol):
    """Within ``tol`` of the largest reference value."""
    want = np.asarray(want)
    got = _np(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0)


@pytest.fixture(scope="module", autouse=True)
def jax_default_route():
    """The JAX side on its default CPU route (conv analysis, conv synthesis,
    conv 1D transform, XLA's ReLU) for the whole module, the knobs put back
    after: they are module globals other test files of the process may
    leave changed, and `WaveletAttribution3D` may set the synthesis knob at
    trace time from a tuned schedule."""
    saved = (jt.get_dwt2_impl(), jt.get_synth2_impl(), jt._dwt1_impl,
             jfr.get_fused_relu_impl())
    jt.set_dwt2_impl("auto")
    jt.set_synth2_impl("auto")
    jt.set_dwt1_impl("conv")
    jfr.set_fused_relu_impl("auto")
    yield
    jt.set_dwt2_impl(saved[0])
    jt.set_synth2_impl(saved[1])
    jt.set_dwt1_impl(saved[2])
    jfr.set_fused_relu_impl(saved[3])


@contextlib.contextmanager
def jax_synthesis(impl: str):
    """The JAX 3D synthesis on ``impl`` ("auto" is the conv form on the
    CPU; "matmul" its `synthesis3_mm`) inside the block."""
    saved = jt.get_synth2_impl()
    jt.set_synth2_impl(impl)
    try:
        yield
    finally:
        jt.set_synth2_impl(saved)


# -- the transform ------------------------------------------------------------------

SHAPES = {"cubic": (2, 8, 8, 8), "odd": (1, 2, 9, 10, 11)}


@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
@pytest.mark.parametrize("wavelet", ["haar", "db2", "db4"])
def test_wavedec3_matches_jax_every_mode(wavelet, shape):
    """Coefficients (J=2) and the analysis VJP against the JAX conv form in
    every pywt mode; db4 at 8^3 pads its second level past the signal."""
    rng = _rng("dec3", wavelet, shape)
    x = rng.standard_normal(SHAPES[shape]).astype(np.float32)
    jc, jvjp = jax.vjp(jax.jit(lambda v: [jt.wavedec3(v, wavelet, 2, m) for m in MODES]),
                       jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tc = [tt.wavedec3(xt, wavelet, 2, m) for m in MODES]
    got, want = sum(map(_leaves, tc), []), sum(map(_leaves, jc), [])
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        _near(_np(g), w)
    cot = [rng.standard_normal(w.shape).astype(np.float32) for w in want]
    (want_dx,) = jvjp(jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jc),
                                                   [jnp.asarray(c) for c in cot]))
    (got_dx,) = torch.autograd.grad(got, xt, [torch.from_numpy(c) for c in cot])
    _near(_np(got_dx), want_dx)


def _jax_synthesis(wavelet, shape, leaves, r):
    """The JAX reconstruction of ``leaves`` (J=2) and its VJP on the
    cotangent ``r``, on both synthesis forms."""
    out = {}
    for impl in ("auto", "matmul"):
        with jax_synthesis(impl):
            rec, vjp = jax.vjp(jax.jit(lambda ls: jt.waverec3(_tree(ls, 2, lambda a: a), wavelet)),
                               [jnp.asarray(v) for v in leaves])
            out[impl] = (np.asarray(rec), [np.asarray(g) for g in vjp(jnp.asarray(r))[0]])
    return out


@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
@pytest.mark.parametrize("wavelet", ["haar", "db2", "db4"])
def test_waverec3_matches_both_jax_forms(wavelet, shape):
    """The reconstruction of arbitrary coefficients and every coefficient's
    gradient, on each port form ("conv": conv_transpose3d; "matmul" and
    "kernel": synthesis3_mm), against the JAX conv form and its
    `synthesis3_mm`; and the decompose/reconstruct round trip."""
    rng = _rng("rec3", wavelet, shape)
    x = rng.standard_normal(SHAPES[shape]).astype(np.float32)
    shapes = [tuple(t.shape) for t in _leaves(tt.wavedec3(torch.from_numpy(x), wavelet, 2))]
    leaves = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    full = tuple(2 * s - tt._resolve(wavelet).filt_len + 2 for s in shapes[-1][-3:])
    r = rng.standard_normal(SHAPES[shape][:-3] + full).astype(np.float32)
    want = _jax_synthesis(wavelet, shape, leaves, r)
    for impl in ("conv", "matmul", "kernel"):
        lt = [torch.from_numpy(v).requires_grad_(True) for v in leaves]
        rec = tt.waverec3(_tree(lt, 2, lambda a: a), wavelet, impl=impl)
        grads = torch.autograd.grad(rec, lt, torch.from_numpy(r))
        for form, (w_rec, w_grads) in want.items():
            assert tuple(rec.shape) == w_rec.shape, (impl, form)
            _near(_np(rec), w_rec, err_msg=f"{impl} {form}")
            for g, w in zip(grads, w_grads):
                _near(_np(g), w, err_msg=f"{impl} {form}")
        back = tt.waverec3(tt.wavedec3(torch.from_numpy(x), wavelet, 2), wavelet, impl=impl)
        n = x.shape[-3:]
        np.testing.assert_allclose(_np(back)[..., : n[0], : n[1], : n[2]], x, atol=1e-4, rtol=0)


@pytest.mark.parametrize("wavelet", ["haar", "db2", "db4"])
def test_transform3d_float64_matches_jax(wavelet):
    """In float64 (JAX in x64 mode) the coefficients and both synthesis
    forms agree to 1e-12 on an odd non-cubic shape, symmetric mode."""
    x = _rng("f64", wavelet).standard_normal((2, 7, 9, 6))
    with jax.enable_x64(True):
        jc = jax.jit(lambda v: jt.wavedec3(v, wavelet, 2, "symmetric"))(jnp.asarray(x))
        want_rec = {}
        for impl in ("auto", "matmul"):
            with jax_synthesis(impl):
                want_rec[impl] = np.asarray(jax.jit(lambda cs: jt.waverec3(cs, wavelet))(jc))
        want = [np.asarray(t) for t in _leaves(jc)]
    tc = tt.wavedec3(torch.from_numpy(x), wavelet, 2, "symmetric")
    for g, w in zip(_leaves(tc), want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(_np(g), w, atol=1e-12, rtol=0)
    for impl in ("conv", "matmul"):
        rec = tt.waverec3(tc, wavelet, impl=impl)
        assert rec.dtype == torch.float64
        for w in want_rec.values():
            np.testing.assert_allclose(_np(rec), w, atol=1e-12, rtol=0)


@pytest.mark.parametrize("form", ["analysis", "conv", "matmul"])
def test_transform3d_gradcheck(form):
    """Each form's backward is its function's adjoint (float64 gradcheck,
    db2, odd sides, symmetric padding)."""
    x = torch.from_numpy(_rng("gc").standard_normal((1, 3, 4, 5))).requires_grad_(True)
    if form == "analysis":
        def analysis(v):
            cA, det = tt.dwt3(v, "db2", "symmetric")
            return (cA, *det.values())

        assert torch.autograd.gradcheck(analysis, (x,))
        return
    cA, det = tt.dwt3(x.detach(), "db2")
    leaves = [t.clone().requires_grad_(True) for t in [cA] + [det[k] for k in KEYS]]
    assert torch.autograd.gradcheck(
        lambda *ls: tt.idwt3(ls[0], dict(zip(KEYS, ls[1:])), "db2", impl=form), tuple(leaves))


def test_transform3d_bf16_in_f32_out():
    """bf16 volumes give float32 coefficients equal to the float32 transform
    of the bf16-rounded volume; bf16 coefficients give float32 voxels on both
    synthesis forms."""
    x = torch.from_numpy(_rng("bf16-3d").standard_normal((2, 8, 8, 8)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    got, want = tt.wavedec3(xb, "db2", 2), tt.wavedec3(xb.float(), "db2", 2)
    for g, w in zip(_leaves(got), _leaves(want)):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    low = _tree([t.to(torch.bfloat16) for t in _leaves(got)], 2, lambda a: a)
    for impl in ("conv", "matmul"):
        assert tt.waverec3(low, "db2", impl=impl).dtype == torch.float32


def test_synthesis3_mm_turns_tf32_off_and_restores_it():
    """The matmul form's products run with cuBLAS TF32 off (the reference's
    Precision.HIGHEST) whatever the caller set, and the caller's setting
    comes back, also after an error."""
    prev = torch.backends.cuda.matmul.allow_tf32
    seen = []
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with tmm._f32_matmuls():
            seen.append(torch.backends.cuda.matmul.allow_tf32)
        assert torch.backends.cuda.matmul.allow_tf32 is True
        with pytest.raises(RuntimeError), tmm._f32_matmuls():
            raise RuntimeError
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen == [False]


class FakeCuda(torch.Tensor):
    """A CPU tensor that says it lives on CUDA, to follow the CUDA route."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_idwt3_impl_resolution(device):
    """impl=None is the conv form on CPU and on CUDA tensors (measured the
    faster on the card); "kernel" and "matmul" are both `synthesis3_mm`; an
    unknown impl raises."""
    cA, det = tt.dwt3(torch.zeros(1, 4, 4, 4), "haar")
    if device == "cuda":
        cA = cA.as_subclass(FakeCuda)
    calls = []
    real = tmm.synthesis3_mm

    def spy(*a):
        calls.append(1)
        return real(*a)

    tmm.synthesis3_mm, saved = spy, tmm.synthesis3_mm
    try:
        for impl, n in ((None, 0), ("conv", 0), ("matmul", 1), ("kernel", 2)):
            tt.idwt3(cA, det, "haar", impl=impl)
            assert len(calls) == n, impl
    finally:
        tmm.synthesis3_mm = saved
    with pytest.raises(ValueError, match="impl"):
        tt.idwt3(cA, det, "haar", impl="pallas")


# -- packing ------------------------------------------------------------------------


@pytest.mark.parametrize("wavelet,side,level", [("haar", 16, 2), ("db4", 32, 2), ("db2", 12, 3)])
def test_cube3d_and_visualize_match_jax(wavelet, side, level):
    """The cube of arbitrary coefficients and its per-level maps; db4 at
    32^3 crops levels to their slabs (finest side 17 in a cube of 34)."""
    rng = _rng("cube", wavelet, side)
    shapes = [tuple(t.shape) for t in _leaves(tt.wavedec3(torch.zeros(2, side, side, side),
                                                           wavelet, level))]
    leaves = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want = jax.jit(jpack.cube3d)(_tree(leaves, level, jnp.asarray))
    got = tpack.cube3d(_tree(leaves, level, torch.from_numpy))
    assert tpack.cube_size(_tree(leaves, level, torch.from_numpy)) == want.shape[-1]
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6, rtol=0)
    vis = tpack.visualize_cube(got, level)
    assert vis.shape == (2, level + 2) + (want.shape[-1],) * 3
    want_vis = jax.jit(jpack.visualize_cube, static_argnums=1)(want, level)
    np.testing.assert_allclose(_np(vis), np.asarray(want_vis), atol=1e-6, rtol=0)


def test_filter_coeffs_matches_jax():
    c = _rng("filter").standard_normal((3, 5, 5)).astype(np.float32)
    for normalized in (False, True):
        want = np.asarray(jw3.filter_coeffs(jnp.asarray(c), 0.451, normalized))
        got = tw3.filter_coeffs(torch.from_numpy(c), 0.451, normalized)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), want)


# -- the slice: WAM-3D on the 3D ResNet ---------------------------------------------


@pytest.fixture(scope="module")
def r3d():
    """The JAX model function (jitted) and the port's, on the same weights,
    two 8^3 volumes and their labels."""
    jm = jr3.resnet3d_10(num_classes=5, width=4)
    variables = _jax_model(jm, (1, 1, 8, 8, 8), 7)
    jfn = jax.jit(lambda v: jm.apply(variables, v))
    state = flax_resnet3d_to_torch(variables)
    tfn = tres.bind_inference(tr3.resnet3d_10(num_classes=5, width=4), state, device="cpu")
    x = _rng("vol").standard_normal((2, 1, 8, 8, 8)).astype(np.float32)
    return jfn, tfn, x, np.array([1, 3]), state


@pytest.mark.parametrize("impl", ["conv", "kernel"])
@pytest.mark.parametrize("labeled", [True, False], ids=["labeled", "y=None"])
def test_base_wam3d_matches_jax(r3d, labeled, impl):
    """The gradient cube of one pass, labeled and in representation mode,
    on each synthesis form; then `filter_voxels` on the kept state."""
    jfn, tfn, x, y, _ = r3d
    yy = y if labeled else None
    jm = jw3.BaseWAM3D(jfn, wavelet="haar", J=2)
    want = np.asarray(jm(jnp.asarray(x), None if yy is None else jnp.asarray(yy)))
    tm = tw3.BaseWAM3D(tfn, wavelet="haar", J=2, device="cpu", impl=impl)
    got = tm(torch.from_numpy(x), None if yy is None else torch.from_numpy(yy))
    assert got.shape == (2, 8, 8, 8) and np.abs(want).max() > 0
    _close(got, want, SLICE_TOL)
    for g, w in zip(_leaves(tm.grads_pytree), _leaves(jm.grads_pytree)):
        _close(g, w, SLICE_TOL)
    filt = tm.filter_voxels()
    assert filt.shape == (2, 1, 8, 8, 8)
    _close(filt, jm.filter_voxels(), SLICE_TOL)


@pytest.fixture(scope="module")
def jax_smooth(r3d):
    """JAX SmoothGrad on handed-over draws: the mean of `BaseWAM3D` cubes on
    x + sigma * z_i, sigma per volume from the JAX package's rule."""
    jfn, _, x, y, _ = r3d
    z = _rng("noise3d").standard_normal((3,) + x.shape).astype(np.float32)
    sigma = np.asarray(jest.noise_sigma(jnp.asarray(x[:, 0]), 0.1)).reshape(-1, 1, 1, 1, 1)
    jm = jw3.BaseWAM3D(jfn, wavelet="haar", J=2)
    cubes = [np.asarray(jm(jnp.asarray(x + zi * sigma), jnp.asarray(y))) for zi in z]
    return z, np.mean(cubes, axis=0)


@pytest.mark.parametrize("impl", ["conv", "kernel"])
def test_smooth_matches_jax_with_handed_noise(r3d, jax_smooth, impl):
    _, tfn, x, y, _ = r3d
    z, want = jax_smooth
    tm = tw3.WaveletAttribution3D(tfn, wavelet="haar", J=2, n_samples=3, stdev_spread=0.1,
                                  device="cpu", impl=impl)
    got = tm(torch.from_numpy(x), torch.from_numpy(y), noise=torch.from_numpy(z))
    _close(got, want, SLICE_TOL)
    vis = tm.visualize()
    assert vis.shape == (2, 4, 8, 8, 8)
    _close(vis, jpack.visualize_cube(jnp.asarray(want), 2), SLICE_TOL)


def test_integrated_wam_matches_jax(r3d):
    """IG against the JAX class (one jitted map over 3 path points) and
    against the JAX package's pieces evaluated op by op: the input
    coefficients' cube times the trapezoid (dx = 1) over alpha in
    {0, .5, 1} of the gradient cubes."""
    jfn, tfn, x, y, _ = r3d
    cls = np.asarray(jw3.WaveletAttribution3D(jfn, wavelet="haar", J=2, method="integratedgrad",
                                              n_samples=3, sample_batch_size=None)(
        jnp.asarray(x), jnp.asarray(y)))
    base = jw3.BaseWAM3D(jfn, wavelet="haar", J=2)
    coeffs = base.engine.decompose(jnp.asarray(x[:, 0]))
    path = []
    for a in (0.0, 0.5, 1.0):
        scaled = jax.tree_util.tree_map(lambda c, a=a: c * a, coeffs)

        def loss(cs):
            rec = base.engine.reconstruct(cs, x.shape[-3:])
            return jnp.take_along_axis(jfn(rec[:, None]), jnp.asarray(y)[:, None], 1).mean()

        path.append(np.asarray(jpack.cube3d(jax.grad(loss)(scaled))))
    eager = np.asarray(jpack.cube3d(coeffs)) * (path[0] / 2 + path[1] + path[2] / 2)
    tm = tw3.WaveletAttribution3D(tfn, wavelet="haar", J=2, method="integratedgrad",
                                  n_samples=3, device="cpu")
    got = tm(torch.from_numpy(x), torch.from_numpy(y))
    assert tm.intergrated_wam == tm.integrated_wam
    _close(got, eager, SLICE_TOL)
    _close(got, cls, SLICE_TOL)


@pytest.mark.parametrize("method", ["smooth", "integratedgrad"])
def test_chunk_of_one_equals_one_chunk(r3d, method):
    """sample_batch_size=1 runs one model call a sample, None all samples
    in one call: each sample keeps its own loss scale, so the cubes agree."""
    _, tfn, x, y, _ = r3d
    z = torch.from_numpy(_rng("chunk3").standard_normal((3,) + x.shape).astype(np.float32))
    kw = dict(wavelet="haar", J=2, method=method, n_samples=3, stdev_spread=0.1, device="cpu")
    extra = {"noise": z} if method == "smooth" else {}
    one = tw3.WaveletAttribution3D(tfn, sample_batch_size=None, **kw)(x, y, **extra)
    each = tw3.WaveletAttribution3D(tfn, sample_batch_size=1, **kw)(x, y, **extra)
    assert float(one.abs().max()) > 0
    torch.testing.assert_close(each, one, atol=1e-5 * float(one.abs().max()), rtol=1e-5)


def test_stream_noise_does_not_depend_on_the_chunk(r3d):
    _, tfn, x, y, _ = r3d
    kw = dict(wavelet="haar", J=2, n_samples=3, stdev_spread=0.1, stream_noise=True,
              device="cpu")
    one = tw3.WaveletAttribution3D(tfn, sample_batch_size=None, **kw)(x, y)
    two = tw3.WaveletAttribution3D(tfn, sample_batch_size=2, **kw)(x, y)
    torch.testing.assert_close(two, one, atol=1e-5 * float(one.abs().max()), rtol=1e-5)


def test_fused_relu_model_equals_the_plain_one(r3d):
    """The 3D ResNet bound with fused_relu_vjp=True (K4/K5's plain versions
    on the CPU) gives the plain model's SmoothGrad cube, and fold_bn on top
    stays within float32 rounding of it."""
    _, tfn, x, y, state = r3d
    z = torch.from_numpy(_rng("fused3").standard_normal((2,) + x.shape).astype(np.float32))
    kw = dict(wavelet="haar", J=2, n_samples=2, stdev_spread=0.1, device="cpu")
    want = tw3.WaveletAttribution3D(tfn, **kw)(x, y, noise=z)
    for fold in (False, True):
        fn = tres.bind_inference(tr3.resnet3d_10(num_classes=5, width=4), state, fold_bn=fold,
                                 fused_relu_vjp=True, device="cpu")
        got = tw3.WaveletAttribution3D(fn, **kw)(x, y, noise=z)
        torch.testing.assert_close(got, want, atol=(1e-5 if fold else 0) * float(want.abs().max()),
                                   rtol=0)


# -- point clouds -------------------------------------------------------------------


@pytest.mark.parametrize("labeled", [True, False], ids=["labeled", "y=None"])
def test_point_clouds_match_jax(labeled):
    """The per-axis 1D coefficient gradients of PointNetCls (read through
    ``out[0]``) on 64-point clouds, haar J=3, and `filter_point_clouds`:
    the per-point importance within 1e-4 and the same points kept, as
    (n_kept, 3) arrays."""
    jm = jpn.PointNetCls(k=4)
    variables = _jax_model(jm, (1, 3, 64), 11)
    jfn = jax.jit(lambda v: jm.apply(variables, v))
    tfn = tres.bind_inference(tpn.PointNetCls(k=4), flax_pointnet_to_torch(variables),
                              device="cpu")
    x = _rng("cloud").standard_normal((2, 3, 64)).astype(np.float32)
    y = np.array([0, 3]) if labeled else None
    jb = jw3.BaseWAM3D(jfn, wavelet="haar", J=3, instance="point_clouds")
    want = jb(jnp.asarray(x), None if y is None else jnp.asarray(y))
    tb = tw3.BaseWAM3D(tfn, wavelet="haar", J=3, instance="point_clouds", device="cpu")
    got = tb(torch.from_numpy(x), None if y is None else torch.from_numpy(y))
    assert len(got) == 3 and all(len(g) == 4 for g in got)
    peak = max(np.abs(np.asarray(w)).max() for d in want for w in d)
    for gd, wd in zip(got, want):
        for g, w in zip(gd, wd):
            np.testing.assert_allclose(_np(g), np.asarray(w), atol=SLICE_TOL * peak, rtol=0)
    kept, norm = tb.filter_point_clouds(0.5)
    want_kept, want_norm = jb.filter_point_clouds(0.5)
    np.testing.assert_allclose(norm, want_norm, atol=SLICE_TOL, rtol=0)
    for k, w in zip(kept, want_kept):
        assert k.shape == w.shape and k.shape[1] == 3
        np.testing.assert_allclose(k, w, atol=0, rtol=0)


# -- the rest of the surface --------------------------------------------------------


def test_wam3d_rejects_unported_options(r3d, monkeypatch):
    _, tfn, x, y, _ = r3d
    # mesh= is ported (tests/test_torch_seq_estimators.py): batch_axis needs a
    # mesh, seq_axis alone is inert, a meshed explainer refuses serve_entry
    from wam_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="batch_axis= requires mesh="):
        tw3.WaveletAttribution3D(tfn, device="cpu", batch_axis="batch")
    tw3.WaveletAttribution3D(tfn, device="cpu", seq_axis="model")
    meshed = tw3.WaveletAttribution3D(tfn, device="cpu", mesh=make_mesh({"data": 2}, ["cpu"] * 2))
    with pytest.raises(ValueError, match="serve_entry"):
        meshed.serve_entry()
    assert callable(tw3.WaveletAttribution3D(tfn, device="cpu").serve_entry())
    # the AOT key is ported: each chunk step is a program of the
    # compiled-step cache, keyed by the 3D synthesis it runs (compiled for
    # real in tests/test_torch_aot_entries.py; a recording stand-in here)
    from tests.torch_aot_stub import record_aot_keys

    keys = record_aot_keys(monkeypatch)
    small = tw3.WaveletAttribution3D(tfn, device="cpu", J=2, n_samples=2)
    entry = small.serve_entry(aot_key="vol")
    assert entry.wam_aot_fns == []  # steps made at the first call
    got = entry(torch.from_numpy(x), torch.from_numpy(y))
    assert keys == ["vol|smooth|synth-conv"] and len(entry.wam_aot_fns) == 1
    assert torch.equal(got, small.serve_entry()(torch.from_numpy(x), torch.from_numpy(y)))
    with pytest.raises(ValueError):
        tw3.WaveletAttribution3D(tfn, method="gradcam", device="cpu")
    with pytest.raises(ValueError):
        tw3.BaseWAM3D(tfn, instance="meshes", device="cpu")
    with pytest.raises(ValueError, match="smooth"):
        tw3.WaveletAttribution3D(tfn, method="integratedgrad", device="cpu")(
            np.zeros((1, 1, 8, 8, 8), np.float32), [0], noise=np.zeros((25, 1, 1, 8, 8, 8)))


def test_engine_3d_structure_round_trip():
    """The engine flattens the 3D dict levels in `DETAIL3D_KEYS` order and
    rebuilds them; its reconstruction is cropped to the volume's shape."""
    x = torch.from_numpy(_rng("eng3").standard_normal((2, 7, 9, 8)).astype(np.float32))
    eng = tengine.WamEngine(lambda v: v, ndim=3, wavelet="db2", level=2, mode="symmetric")
    coeffs = eng.decompose(x)
    flat = tengine._flatten(coeffs)
    assert len(flat) == 1 + 2 * 7 and flat[1] is coeffs[1]["aad"]
    back = tengine._unflatten(flat, coeffs)
    assert all(back[i][k] is coeffs[i][k] for i in (1, 2) for k in KEYS)
    torch.testing.assert_close(eng.reconstruct(coeffs, (7, 9, 8)), x, atol=1e-5, rtol=0)
