"""Parity of the port's transformer and temporal attribution (`wam_tpu_torch.xattr`,
the ViT's ``capture_attn``, ``level_plan="patch"``, `WAMAnalyzerViT.token_maps`)
with the JAX package's.

The tiny ViT (depth 2, 4 heads, patch 8) runs on 2 images of 3x32²; its
weights are drawn with numpy into the tree of the reference's ``init`` and
carried over with `flax_vit_to_torch`. Video runs the reference's toy 3D conv
model on 2 clips of 1x8x16², its kernel handed across. SmoothGrad noise is
drawn with ``jax.random`` as the reference's class draws it and handed to
the port.

Tolerances: captured weights and their gradients 1e-5 of their largest
value (float32 attention in another summation order); rollout, relevance,
the evaluators' maps 1e-5 of the largest value and AUCs 1e-5; patch-plan IG,
token maps, the spacetime box and video SmoothGrad / IG 1e-4 of the largest
value; the video transforms 1e-5; token pooling 1e-6; plans, errors and
fetch counts exact.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from wam_tpu import analyzers as jan
from wam_tpu import wam2d as jwam
from wam_tpu import xattr as jx
from wam_tpu.evalsuite import eval_baselines as jeb
from wam_tpu.models import vit as jvit
from wam_tpu.models.toy import toy_conv_model as jtoy
from wam_tpu.wavelets import transform as jt
from wam_tpu_torch import analyzers as tan
from wam_tpu_torch import wam2d as twam
from wam_tpu_torch import xattr as tx
from wam_tpu_torch.evalsuite import eval_baselines as teb
from wam_tpu_torch.evalsuite import fan as tfan
from wam_tpu_torch.models import vit as tvit
from wam_tpu_torch.models.ingest import flax_vit_to_torch
from wam_tpu_torch.models.resnet import bind_inference
from wam_tpu_torch.models.toy import toy_conv_model as ttoy

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

CLASSES, SIDE, PATCH = 5, 32, 8
CLIP = (2, 1, 8, 16, 16)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel_close(got, want, tol, tag=""):
    got, want = np.asarray(_np(got), np.float64), np.asarray(_np(want), np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), (tag, got.shape, want.shape)
    peak = np.abs(want).max()
    assert peak > 0, tag
    err = np.abs(got - want).max()
    assert err <= tol * peak, (tag, err / peak)


@pytest.fixture(scope="module", autouse=True)
def jax_default_route():
    """The JAX transforms on their default route (conv on the CPU), the
    knobs put back after: other test files of the process may change them."""
    saved = jt.get_dwt2_impl(), jt.get_synth2_impl()
    jt.set_dwt2_impl("auto")
    jt.set_synth2_impl("auto")
    yield
    jt.set_dwt2_impl(saved[0])
    jt.set_synth2_impl(saved[1])


# -- the tiny ViT, both packages ---------------------------------------------------------


def _vit_params(model):
    """float32 parameters drawn with numpy in ``model.init``'s tree: kernels
    N(0, 1/fan_in) (q/k/v fan in the model width), LayerNorm scales near 1,
    everything else N(0, 0.05^2)."""
    rng = _rng("vit")
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3)))

    def draw(path, leaf):
        keys, n = [p.key for p in path], leaf.shape
        if keys[-1] == "kernel":
            fan = n[0] if keys[-2] in ("query", "key", "value") else np.prod(n[:-1])
            v = rng.standard_normal(n) * 1.5 / np.sqrt(fan)
        elif keys[-1] == "scale":
            v = rng.uniform(0.8, 1.2, n)
        else:
            v = 0.05 * rng.standard_normal(n)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree["params"])


@pytest.fixture(scope="module")
def vit():
    """(JAX capture model, its variables, port capture model, port plain
    model, x (2, 3, 32, 32) numpy, y)."""
    jmodel = jvit.vit_tiny_test(num_classes=CLASSES, capture_attn=True)
    params = _vit_params(jmodel)
    variables = {"params": params}
    state = flax_vit_to_torch(variables)
    models = []
    for capture in (True, False):
        m = tvit.vit_tiny_test(num_classes=CLASSES, image_size=SIDE, capture_attn=capture)
        m.load_state_dict(state, strict=True)
        models.append(m.eval().requires_grad_(False))
    x = _rng("x").standard_normal((2, 3, SIDE, SIDE)).astype(np.float32)
    return jmodel, variables, models[0], models[1], x, np.array([1, 3])


def test_capture_weights_and_grads_match_jax(vit):
    """The softmax weights read back after a forward, and ∂(picked-logit
    sum)/∂A at every block's tap, against the reference's sown weights and
    its zero perturb taps; the two port forms give the same logits."""
    jmodel, variables, tmodel, tplain, x, y = vit
    want_w = jx.capture_attention_weights(jmodel, variables, jnp.asarray(x))
    got_w = tx.capture_attention_weights(tmodel, torch.from_numpy(x))
    assert got_w.shape == (2, 2, 4, 17, 17)
    _rel_close(got_w, want_w, 1e-5, "weights")
    jw, jg = jx.attention_weight_grads(jmodel, variables, jnp.asarray(x), jnp.asarray(y))
    tw, tg = tx.attention_weight_grads(tmodel, torch.from_numpy(x), torch.from_numpy(y))
    _rel_close(tw, jw, 1e-5, "weights (grad pass)")
    _rel_close(tg, jg, 1e-5, "grads")
    with torch.no_grad():
        on, off = tmodel(torch.from_numpy(x)), tplain(torch.from_numpy(x))
    _rel_close(on, off, 1e-5, "capture on vs off")
    # y=None: the whole output's sum
    _, jg0 = jx.attention_weight_grads(jmodel, variables, jnp.asarray(x), None)
    _rel_close(tx.attention_weight_grads(tmodel, torch.from_numpy(x), None)[1], jg0, 1e-5,
               "grads, y=None")


def test_rollout_and_relevance_match_jax(vit):
    """Both propagation rules on the same (reference) weights and grads."""
    jmodel, variables, *_, x, y = vit
    jw, jg = jx.attention_weight_grads(jmodel, variables, jnp.asarray(x), jnp.asarray(y))
    tw, tg = torch.tensor(np.asarray(jw)), torch.tensor(np.asarray(jg))
    for residual in (0.5, 0.25):
        _rel_close(tx.rollout_from_weights(tw, residual), jx.rollout_from_weights(jw, residual),
                   1e-5, f"rollout {residual}")
    got = tx.relevance_from_grads(tw, tg)
    assert got.shape == (2, 4, 4)
    _rel_close(got, jx.relevance_from_grads(jw, jg), 1e-5, "relevance")
    with pytest.raises(ValueError, match="square grid"):
        tx.rollout_from_weights(tw[..., :16, :16])


@pytest.mark.parametrize("method", ["rollout", "attngrad"])
def test_attention_baselines_through_the_evaluator_match_jax(vit, method):
    """`EvalImageBaselines` with rollout / attngrad: the (B, H, W) maps, and
    insertion on the reference's map handed to both, in one fetch."""
    jmodel, variables, tmodel, _, x, y = vit
    jev = jeb.EvalImageBaselines(jmodel, variables, method=method, batch_size=32)
    tev = teb.EvalImageBaselines(tmodel, None, method=method, batch_size=32, device="cpu")
    want = np.asarray(jev.compute_explanations(jnp.asarray(x), jnp.asarray(y)))
    got = tev.compute_explanations(torch.from_numpy(x), y)
    assert got.shape == (2, SIDE, SIDE)
    _rel_close(got, want, 1e-5, method)
    jev.explanations = jnp.asarray(want)
    tev.explanations = torch.tensor(want)
    ref = jev.insertion(jnp.asarray(x), y, n_iter=4)
    with tfan.fetch_scope() as fs:
        ins = tev.insertion(torch.from_numpy(x), y, n_iter=4)
    assert fs.count == 1
    np.testing.assert_allclose(ins, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.stack(tev.insertion_curves), np.stack(jev.insertion_curves),
                               rtol=0, atol=1e-5)


def test_attention_needs_capture(vit):
    *_, tplain, x, y = vit
    with pytest.raises(ValueError, match="capture_attn=True"):
        teb.EvalImageBaselines(tplain, None, method="attngrad", device="cpu")
    with pytest.raises(ValueError, match="capture_attn=True"):
        tx.attention_rollout(tplain, torch.from_numpy(x))


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _sdpa_forward(self, x):
    """`Attention.forward` as it was before ``capture_attn`` existed."""
    B, N, D = x.shape
    q, k, v = self.qkv(x).reshape(B, N, 3, self.heads, D // self.heads).permute(2, 0, 3, 1, 4)
    y = F.scaled_dot_product_attention(q, k, v)
    return self.proj(y.transpose(1, 2).reshape(B, N, D))


def _ops(model, x, grad: bool):
    leaf = x.clone().requires_grad_(grad)
    with _OpLog() as log, torch.set_grad_enabled(grad):
        out = model(leaf)
        if grad:
            torch.autograd.grad(out.sum(), leaf)
    return log.ops


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "forward+backward"])
def test_capture_off_records_no_extra_op(vit, monkeypatch, grad):
    """With ``capture_attn=False`` the forward (and its backward) runs the
    same aten operations, in the same order, as the SDPA forward from before
    the flag; the capture form runs others (the explicit softmax)."""
    *_, tmodel, tplain, x, _ = vit
    xt = torch.from_numpy(x)
    now, capture = _ops(tplain, xt, grad), _ops(tmodel, xt, grad)
    monkeypatch.setattr(tvit.Attention, "forward", _sdpa_forward)
    assert now == _ops(tplain, xt, grad)
    assert any("softmax" in op for op in capture) and not any("softmax" in op for op in now)


def test_ingest_accepts_capture_variables(vit):
    """A capture model's variables (with the init's ``perturbations`` and
    ``intermediates``) load into both port forms strictly."""
    jmodel, variables, tmodel, *_ = vit
    full = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3)))
    assert "perturbations" in full
    extra = {k: jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), v)
             for k, v in full.items() if k != "params"}
    state = flax_vit_to_torch({**variables, **extra})
    for capture in (True, False):
        tvit.vit_tiny_test(num_classes=CLASSES, image_size=SIDE,
                           capture_attn=capture).load_state_dict(state, strict=True)
    assert all(torch.equal(state[k], v) for k, v in tmodel.state_dict().items())


# -- patch-aligned level planning ---------------------------------------------------------


@pytest.mark.parametrize("image,patch,wavelet", [(224, 16, "haar"), (384, 16, "haar"),
                                                 (224, 32, "haar"), (384, 32, "haar"),
                                                 (224, 16, "db4")])
def test_plan_patch_levels_matches_jax(image, patch, wavelet):
    want = jx.plan_patch_levels(image, patch, wavelet)
    got = tx.plan_patch_levels(image, patch, wavelet)
    assert (got.J, got.patch, got.image_size, got.tokens, got.wavelet) == (
        want.J, want.patch, want.image_size, want.tokens, want.wavelet)
    assert [got.level_cell_px(j) for j in range(1, got.J + 1)] == [
        want.level_cell_px(j) for j in range(1, want.J + 1)]
    assert got.token_granular_levels() == want.token_granular_levels() == (got.J,)


@pytest.mark.parametrize("image,patch,wavelet", [(225, 16, "haar"), (100, 16, "haar"),
                                                 (224, 12, "haar"), (16, 32, "haar"),
                                                 (0, 16, "haar"), (32, 32, "db4")])
def test_plan_patch_levels_rejects_as_jax(image, patch, wavelet):
    with pytest.raises(ValueError) as want:
        jx.plan_patch_levels(image, patch, wavelet)
    with pytest.raises(ValueError) as got:
        tx.plan_patch_levels(image, patch, wavelet)
    assert str(got.value) == str(want.value)


def test_token_grid_map_matches_jax():
    x = _rng("tg").standard_normal((2, 3, 32, 32)).astype(np.float32)
    for tokens in (1, 2, 4, 8, 32):  # float32 means in another summation order
        np.testing.assert_allclose(_np(tx.token_grid_map(torch.from_numpy(x), tokens)),
                                   np.asarray(jx.token_grid_map(jnp.asarray(x), tokens)),
                                   rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="token grid"):
        tx.token_grid_map(torch.zeros(1, 15, 15), 2)


def test_patch_plan_ig_and_token_maps_match_jax(vit):
    """``level_plan="patch"`` (patch 8 at 32²: J=3) Integrated Gradients on the
    tiny ViT, through the kernels' plain versions, and the analyzer's token
    maps (B, J, 4, 4) and token importance."""
    jmodel, variables, _, tplain, x, y = vit
    jbase = jvit.vit_tiny_test(num_classes=CLASSES)
    jfn = lambda v: jbase.apply(variables, jnp.transpose(v, (0, 2, 3, 1)))  # noqa: E731
    tfn = bind_inference(tplain, nchw=True, device="cpu")
    kw = dict(method="integratedgrad", level_plan="patch", patch=PATCH, image_size=SIDE,
              n_samples=4, sample_batch_size=None, J=99)
    jw = jwam.WaveletAttribution2D(jfn, **kw)
    tw = twam.WaveletAttribution2D(tfn, device="cpu", impl="kernel", **kw)
    assert tw.J == jw.J == 3 and tw.patch_plan.tokens == 4
    want = np.asarray(jw(jnp.asarray(x), jnp.asarray(y)))
    _rel_close(tw(torch.from_numpy(x), torch.from_numpy(y)), want, 1e-4, "patch IG")
    jmaps = jan.WAMAnalyzerViT(jw).token_maps(jnp.asarray(x), jnp.asarray(y))
    tmaps = tan.WAMAnalyzerViT(tw).token_maps(torch.from_numpy(x), torch.from_numpy(y))
    assert tmaps.shape == (2, 3, 4, 4)
    _rel_close(tmaps, jmaps, 1e-4, "token maps")
    _rel_close(tan.WAMAnalyzerViT(tw).token_importance(torch.from_numpy(x), torch.from_numpy(y)),
               jmaps.sum(axis=1), 1e-4, "token importance")


def test_patch_plan_constructor_errors_as_jax():
    fn = lambda v: v.reshape(v.shape[0], -1)[:, :4]  # noqa: E731
    for kw in ({"level_plan": "patch", "patch": 16, "image_size": 100},
               {"level_plan": "patch"}, {"level_plan": "tokens"}):
        with pytest.raises(ValueError) as want:
            jwam.WaveletAttribution2D(fn, **kw)
        with pytest.raises(ValueError) as got:
            twam.WaveletAttribution2D(fn, device="cpu", **kw)
        assert str(got.value) == str(want.value)
    assert twam.WaveletAttribution2D(fn, device="cpu").patch_plan is None


# -- video ---------------------------------------------------------------------------------


def _clip():
    return _rng("clip").standard_normal(CLIP).astype(np.float32)


@pytest.mark.parametrize("levels", [(3, 1), (2, 2), (2, 0)])
def test_video_transforms_match_jax(levels):
    """`wavedec_video`'s coefficients, in the reference's structure (3D
    dicts for the finest ``temporal`` levels, Detail2D for the rest), and
    `waverec_video`'s round trip, on the conv and the kernel route."""
    clip = _clip()
    want = jx.wavedec_video(jnp.asarray(clip), "haar", levels)
    for impl in (None, "kernel"):
        got = tx.wavedec_video(torch.from_numpy(clip), "haar", levels, impl=impl)
        assert [isinstance(d, dict) for d in got[1:]] == [isinstance(d, dict) for d in want[1:]]
        for g, w in zip(tx.video.coeff_leaves(got), jx.video.coeff_leaves(want)):
            _rel_close(g, w, 1e-5, f"coefficients {levels} {impl}")
        rec = tx.waverec_video(got, "haar", impl=impl)[..., :8, :16, :16]
        np.testing.assert_allclose(_np(rec), clip, rtol=0, atol=1e-5)
        np.testing.assert_allclose(_np(rec), np.asarray(jx.waverec_video(want, "haar"))
                                   [..., :8, :16, :16], rtol=0, atol=1e-5)


def test_video_levels_validation_as_jax():
    for args in ((0, 0), (2, 3), (2, -1)):
        with pytest.raises(ValueError) as want:
            jx.VideoLevels(*args)
        with pytest.raises(ValueError) as got:
            tx.VideoLevels(*args)
        assert str(got.value) == str(want.value)
    assert tx.VideoLevels(2, 2).uniform and not tx.VideoLevels(2, 1).uniform


@pytest.mark.parametrize("approx", [False, True])
def test_spacetime_map_and_frames_match_jax(approx):
    """The box of a gradient list in `wavedec_video`'s structure, with the
    reference's nearest index arithmetic on each of (T, H, W) (odd sizes),
    and its frame scores."""
    clip = _rng("st").standard_normal((2, 1, 7, 13, 11)).astype(np.float32)
    want_c = jx.wavedec_video(jnp.asarray(clip), "db2", (2, 1))
    got_c = tx.wavedec_video(torch.from_numpy(clip), "db2", (2, 1))
    want = jx.spacetime_map(want_c, (7, 13, 11), approx)
    got = tx.spacetime_map(got_c, (7, 13, 11), approx)
    assert got.shape == (2, 1, 7, 13, 11)
    _rel_close(got, want, 1e-5, "box")
    _rel_close(tx.frame_importance(got[:, 0]), jx.frame_importance(want[:, 0]), 1e-5, "frames")


@pytest.fixture(scope="module")
def video():
    """(JAX model_fn, port model_fn): the reference's toy 3D conv model on
    the clip's single channel, its kernel handed across."""
    key = jax.random.PRNGKey(3)
    kern = np.asarray(jax.random.normal(key, (4, 1, 5, 5, 5), jnp.float32) * 0.3)
    jm, tm = jtoy(key, ndim=3, classes=4), ttoy(kern, ndim=3, classes=4, device="cpu")
    return (lambda c: jm(c[:, 0])), (lambda c: tm(c[:, 0]))


@pytest.mark.parametrize("method,chunk", [("smooth", None), ("smooth", 2),
                                          ("integratedgrad", None), ("integratedgrad", 2)])
def test_video_wam_matches_jax(video, method, chunk):
    """Video SmoothGrad (the reference's own draws handed over) and IG, in
    one sample chunk and in chunks of 2, through the kernels' plain
    versions; the frame scores."""
    jfn, tfn = video
    clip, y = _clip(), np.array([0, 2])
    kw = dict(levels=(2, 1), method=method, n_samples=3, sample_batch_size=chunk)
    jw = jx.WaveletAttributionVideo(jfn, **kw)
    tw = tx.WaveletAttributionVideo(tfn, device="cpu", impl="kernel", **kw)
    want = np.asarray(jw(jnp.asarray(clip), jnp.asarray(y)))
    noise = None
    if method == "smooth":
        noise = torch.tensor(np.asarray(jax.random.normal(
            jax.random.PRNGKey(jw.random_seed), (3,) + CLIP, jnp.float32)))
    got = tw(torch.from_numpy(clip), torch.from_numpy(y), noise=noise)
    assert got.shape == (2, 8, 16, 16) and bool((got >= 0).all())
    _rel_close(got, want, 1e-4, method)
    _rel_close(tw.frame_scores(torch.from_numpy(clip), torch.from_numpy(y), noise=noise),
               jx.frame_importance(want), 1e-4, "frames")


def test_video_wam_without_labels_matches_jax(video):
    jfn, tfn = video
    clip = _clip()
    jw = jx.WaveletAttributionVideo(jfn, levels=(2, 2), method="integratedgrad", n_samples=3)
    tw = tx.WaveletAttributionVideo(tfn, levels=(2, 2), method="integratedgrad", n_samples=3,
                                    device="cpu")
    _rel_close(tw(torch.from_numpy(clip)), jw(jnp.asarray(clip)), 1e-4, "y=None")


def test_video_wam_rejects_as_jax(video):
    jfn, tfn = video
    for kw in ({"levels": (2, 1), "mesh": object()}, {"levels": (2, 2), "batch_axis": "data"},
               {"method": "occlusion"}, {"sample_batch_size": "all"}):
        with pytest.raises(ValueError) as want:
            jx.WaveletAttributionVideo(jfn, **kw)
        with pytest.raises(ValueError) as got:
            tx.WaveletAttributionVideo(tfn, device="cpu", **kw)
        assert str(got.value) == str(want.value)
    # mesh= is ported (tests/test_torch_seq_estimators.py): the constructor
    # takes a mesh, IG and the serving entry refuse it as the reference does
    from wam_tpu_torch.parallel import make_mesh

    meshed = tx.WaveletAttributionVideo(tfn, levels=(2, 2), device="cpu",
                                        mesh=make_mesh({"data": 2}, ["cpu"] * 2))
    with pytest.raises(ValueError, match="serve_entry"):
        meshed.serve_entry()
    tw = tx.WaveletAttributionVideo(tfn, method="integratedgrad", device="cpu")
    assert callable(tw.serve_entry())
    with pytest.warns(UserWarning, match="no compiled step"):  # eager, no programs
        assert tw.serve_entry(aot_key="video").wam_aot_fns == []
    with pytest.raises(ValueError, match="noise"):
        tw(torch.zeros(CLIP), noise=torch.zeros((25,) + CLIP))


@pytest.mark.parametrize("explained", ["box", "frames"])
def test_eval_video_matches_jax(video, explained):
    """Temporal insertion and deletion on the reference's frame scores
    handed to both (as a box, or as (B, T) scores): AUCs and curves, one
    result fetch a metric call; and the explainer run end to end."""
    jfn, tfn = video
    clip, y = _clip(), np.array([0, 2])
    box = _rng("box").random((2, 8, 16, 16)).astype(np.float32)
    expl = box if explained == "box" else box.mean(axis=(-2, -1))
    jev = jx.EvalVideoWAM(jfn, lambda c, yy: jnp.asarray(expl), batch_size=32)
    tev = tx.EvalVideoWAM(tfn, lambda c, yy: torch.from_numpy(expl), batch_size=32,
                          device="cpu")
    for mode in ("insertion", "deletion"):
        want = getattr(jev, mode)(jnp.asarray(clip), y, n_iter=4)
        with tfan.fetch_scope() as fs:
            got = getattr(tev, mode)(torch.from_numpy(clip), y, n_iter=4)
        assert fs.count == 1, mode
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=mode)
        np.testing.assert_allclose(np.stack(getattr(tev, f"{mode}_curves")),
                                   np.stack(getattr(jev, f"{mode}_curves")), rtol=0, atol=1e-5)
        assert np.stack(getattr(tev, f"{mode}_curves")).shape == (2, 5)
    wam = tx.WaveletAttributionVideo(tfn, levels=(2, 1), n_samples=3, device="cpu")
    ev = tx.EvalVideoWAM(tfn, wam, batch_size=32, device="cpu")
    with tfan.fetch_scope() as fs:
        ins = ev.insertion(torch.from_numpy(clip), y, n_iter=4)
    assert fs.count == 1 and len(ins) == 2 and ev.explanations.shape == (2, 8)
    # mesh= is ported (tests/test_torch_parallel.py): the clips split over it
    from wam_tpu_torch.parallel import make_mesh

    sharded = tx.EvalVideoWAM(tfn, wam, batch_size=32, mesh=make_mesh({"data": 2}, ["cpu"] * 2),
                              device="cpu")
    sharded.explanations, sharded._expl_key = ev.explanations, None
    with tfan.fetch_scope() as fs:
        np.testing.assert_allclose(sharded.insertion(torch.from_numpy(clip), y, n_iter=4), ins,
                                   rtol=0, atol=1e-6)
    assert fs.count == 1


# -- the CUDA route's launches, through stand-ins of the launchers ------------------------


def _standins(monkeypatch, calls):
    """Stand-ins of the K1/K2/K3 launchers that record each launch and run
    the dense operators their band plans stand for; every wrapper takes the
    CUDA route (`matmul.on_cpu` false)."""
    from tests.test_torch_wavelets import _dense_from_blob
    from wam_tpu_torch import kernels
    from wam_tpu_torch.wavelets import matmul as tmm
    from wam_tpu_torch.wavelets.filters import build_wavelet

    rec_lo, rec_hi = (tuple(v) for v in (build_wavelet("haar").rec_lo,
                                         build_wavelet("haar").rec_hi))

    def dense(plan):
        m1, m2 = _dense_from_blob(plan)
        return torch.from_numpy(m1).float(), torch.from_numpy(m2).float()

    def dwt2(x3, plan):
        calls.append("dwt2")
        m1, m2 = dense(plan)
        return tmm.dwt2_plain(x3, m1.T, m2)

    def synth2(sub, plan):
        calls.append("synth2")
        return tmm.idwt2_plain(sub, *dense(plan))

    def blocks(plan):
        return zip(tmm._level_blocks(plan.rows, rec_lo, rec_hi),
                   tmm._level_blocks(plan.cols, rec_lo, rec_hi))

    def pair(leaves, plan):
        calls.append("pair")
        out = 0
        for i, (R, C) in enumerate(blocks(plan)):
            h, v, d = leaves[1 + 3 * i:4 + 3 * i]
            aa = leaves[0] if i == 0 else torch.zeros_like(h)
            y = torch.cat([torch.cat([aa, v], -1), torch.cat([h, d], -1)], -2)
            out = out + torch.from_numpy(R).float() @ y @ torch.from_numpy(C).float().T
        return out

    def pair_bwd(g, plan):
        calls.append("pair")  # K3's backward counts as a K3 launch
        grads = []
        for i, ((R, C), r, c) in enumerate(zip(blocks(plan), plan.rows, plan.cols)):
            dy = torch.from_numpy(R).float().T @ g @ torch.from_numpy(C).float()
            grads += ([dy[:, :r, :c]] if i == 0 else []) + [
                dy[:, r:, :c], dy[:, :r, c:], dy[:, r:, c:]]
        return [t.contiguous() for t in grads]

    for name, fn in (("dwt2", dwt2), ("synth2", synth2), ("pair", pair), ("pair_bwd", pair_bwd)):
        monkeypatch.setattr(kernels, name, fn)
    for name in ("relu_fwd", "relu_bwd", "build_all"):
        monkeypatch.setattr(kernels, name, lambda *a: pytest.fail("not on these paths"))
    monkeypatch.setattr(tmm, "on_cpu", lambda t: False)


def test_patch_plan_on_cuda_launches_k1_four_times_and_k3_eight(monkeypatch):
    """The patch path's call (one 224² image, patch 16: haar J=4, 64 path
    points in chunks of 16) decomposes once through K1 (4 levels) and runs
    the 4 collapsed levels through K3 forward and backward once a chunk;
    held against the plain route."""
    rng = _rng("patch-cuda")
    weights = torch.from_numpy(rng.standard_normal((4, 3 * 224 * 224)).astype(np.float32) / 400)

    def model_fn(v):  # a cheap classifier of (B, 3, 224, 224), every pixel weighed
        return torch.tanh(v.reshape(v.shape[0], -1) @ weights.T)

    x = torch.from_numpy(rng.standard_normal((1, 3, 224, 224)).astype(np.float32))
    kw = dict(method="integratedgrad", n_samples=64, sample_batch_size=16, level_plan="patch",
              patch=16, image_size=224, device="cpu")
    want = twam.WaveletAttribution2D(model_fn, impl="matmul", **kw)(x, torch.tensor([2]))
    calls = []
    _standins(monkeypatch, calls)
    got = twam.WaveletAttribution2D(model_fn, impl="kernel", **kw)(x, torch.tensor([2]))
    assert calls == ["dwt2"] * 4 + ["pair"] * 8, calls
    _rel_close(got, want, 1e-5, "patch, CUDA route")


def test_video_on_cuda_launches_k1_twice_and_k2_once(monkeypatch, video):
    """The video path's call (levels (2, 1), every sample in one chunk): K1
    at the spatial-only level, K2 at its synthesis and K1 again as K2's
    backward, nothing else (level 1 is 3D: conv3d and conv_transpose3d);
    SmoothGrad and IG, held against the conv route."""
    _, tfn = video
    clip, y = torch.from_numpy(_clip()), torch.tensor([0, 2])
    noise = torch.from_numpy(_rng("vnoise").standard_normal((3,) + CLIP).astype(np.float32))
    for method in ("smooth", "integratedgrad"):
        kw = dict(levels=(2, 1), method=method, n_samples=3, device="cpu")
        z = noise if method == "smooth" else None
        want = tx.WaveletAttributionVideo(tfn, impl="conv", **kw)(clip, y, noise=z)
        calls = []
        with monkeypatch.context() as m:
            _standins(m, calls)
            got = tx.WaveletAttributionVideo(tfn, impl="kernel", **kw)(clip, y, noise=z)
        assert sorted(calls) == ["dwt2", "dwt2", "synth2"] and calls[0] == "dwt2", calls
        _rel_close(got, want, 1e-5, f"video {method}, CUDA route")
