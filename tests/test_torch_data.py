"""Parity of the port's support modules with the JAX package: the configs and
their CLI (`config`), `models.ingest.strip_module_prefix`, the model
registry and checkpoints (`data.checkpoints`), the image, 3D-MNIST and
audio data (`data.image`, `data.mnist3d`, `data.audio`), the viewers
(`viz.viewers`, under matplotlib's Agg backend) and the VoxelModel's
``features`` tap.

Every file is written by the test itself (PNGs, h5 files, checkpoints) in
pytest's temporary directory. Checkpoint parity: a seeded port model's
state dict is saved with DataParallel's ``module.`` prefix and loaded into
both packages (the reference through its ``torch_*_to_flax``); logits
agree to 1e-4 of their largest value. Host-side numpy code is held equal.
"""

import argparse
import dataclasses
import json
import os
import zlib

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
from PIL import Image  # noqa: E402

from wam_tpu import config as jcfg  # noqa: E402
from wam_tpu.data import audio as jaudio  # noqa: E402
from wam_tpu.data import image as jimage  # noqa: E402
from wam_tpu.data import mnist3d as jmnist  # noqa: E402
from wam_tpu.models import bind_inference as jbind  # noqa: E402
from wam_tpu.models import convnext as jconvnext  # noqa: E402
from wam_tpu.models import ingest as jingest  # noqa: E402
from wam_tpu.models import resnet18 as jresnet18  # noqa: E402
from wam_tpu.models.voxel import VoxelModel as JVoxel  # noqa: E402
from wam_tpu.viz import viewers as jview  # noqa: E402
from wam_tpu_torch import config as tcfg  # noqa: E402
from wam_tpu_torch.data import audio as taudio  # noqa: E402
from wam_tpu_torch.data import checkpoints as tck  # noqa: E402
from wam_tpu_torch.data import image as timage  # noqa: E402
from wam_tpu_torch.data import mnist3d as tmnist  # noqa: E402
from wam_tpu_torch.device import resolve_device  # noqa: E402
from wam_tpu_torch.models import convnext as tconvnext  # noqa: E402
from wam_tpu_torch.models import ingest as tingest  # noqa: E402
from wam_tpu_torch.models import resnet as tres  # noqa: E402
from wam_tpu_torch.models.layers import tap_scope  # noqa: E402
from wam_tpu_torch.models.voxel import VoxelModel as TVoxel  # noqa: E402
from wam_tpu_torch.viz import viewers as tview  # noqa: E402

LOGIT_TOL = 1e-4


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


# -- config ------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["WAM2DConfig", "WAM1DConfig", "WAM3DConfig", "EvalConfig"])
def test_config_defaults_match_the_reference(name):
    got = [(f.name, f.default) for f in dataclasses.fields(getattr(tcfg, name))]
    want = [(f.name, f.default) for f in dataclasses.fields(getattr(jcfg, name))]
    assert got == want


@pytest.mark.parametrize("argv", [
    [],
    ["--sample-batch-size", "4", "--normalize-coeffs", "no", "--device", "cpu"],
    ["--sample-batch-size", "auto", "--approx-coeffs", "TRUE", "--stdev-spread", "0.5",
     "--J", "2", "--wavelet", "db4"],
])
def test_config_cli_round_trip_matches_the_reference(argv):
    """Flags parse to the same config in both packages, "auto" survives as a
    string and an int as an int, and booleans read "1" / "true" / "yes" (any
    case) as True and anything else, "no" included, as False."""
    out = {}
    for tag, mod in (("port", tcfg), ("ref", jcfg)):
        parser = argparse.ArgumentParser()
        mod.add_config_args(parser, mod.WAM2DConfig)
        out[tag] = dataclasses.asdict(mod.config_from_args(parser.parse_args(argv),
                                                           mod.WAM2DConfig))
    assert out["port"] == out["ref"]
    if "4" in argv:
        assert out["port"]["sample_batch_size"] == 4 and out["port"]["normalize_coeffs"] is False
    if "auto" in argv:
        assert out["port"]["sample_batch_size"] == "auto" and out["port"]["approx_coeffs"]
    parser = argparse.ArgumentParser()
    tcfg.add_config_args(parser, tcfg.EvalConfig, prefix="ev_")
    cfg = tcfg.config_from_args(parser.parse_args(["--ev_n-iter", "8"]), tcfg.EvalConfig,
                                prefix="ev_")
    assert cfg.n_iter == 8 and cfg.batch_size == 128


def test_config_device_auto_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcfg.WAM2DConfig().device == "auto"
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(tcfg.WAM2DConfig().device)
    assert resolve_device(tcfg.WAM2DConfig(device="cpu").device) == torch.device("cpu")


@pytest.mark.parametrize("env", [{}, {"WAM_TPU_FAN_DTYPE": "bf16"},
                                 {"WAM_TPU_FAN_DTYPE": "fp8", "WAM_TPU_MEL_BF16": "1"}])
def test_precision_tag_matches_the_reference(monkeypatch, env):
    for key in ("WAM_TPU_FAN_DTYPE", "WAM_TPU_MEL_BF16"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert tcfg.precision_tag() == jcfg.precision_tag()


# -- checkpoints ---------------------------------------------------------------------


def test_strip_module_prefix():
    state = {"module.fc.weight": np.ones(2), "module.layer1.0.bn1.bias": np.zeros(3),
             "head.bias": np.arange(2)}
    want = jingest.strip_module_prefix(state)
    got = tingest.strip_module_prefix(state)
    assert list(got) == list(want) == ["fc.weight", "layer1.0.bn1.bias", "head.bias"]
    assert all(got[k] is state.get("module." + k, state.get(k)) for k in got)
    tstate = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in state.items()}
    assert all(isinstance(v, torch.Tensor) for v in tingest.strip_module_prefix(tstate).values())


def _save_prefixed(path, model) -> dict:
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.save({"module." + k: v for k, v in state.items()}, path)
    return state


def _perturbed_bn(model, seed):
    """BatchNorm statistics and affines moved off their defaults, so the
    checkpoint carries them."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(1 + 0.2 * torch.rand(m.running_var.shape, generator=g))
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape, generator=g))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
    return model


def test_build_vision_model_resnet_checkpoint_matches_the_reference(tmp_path):
    torch.manual_seed(1)
    path = str(tmp_path / "r18.pth")
    state = _save_prefixed(path, _perturbed_bn(tres.resnet18(num_classes=10), 2))
    model, variables, fn = tck.build_vision_model("resnet18", num_classes=10,
                                                  checkpoint_path=path, device="cpu")
    assert all(torch.equal(variables[k], v) for k, v in state.items())
    x = _rng("r18").standard_normal((2, 3, 32, 32)).astype(np.float32)
    got = fn(torch.from_numpy(x)).numpy()
    loaded = jingest.torch_resnet_to_flax(torch.load(path, weights_only=True))
    jfn = jax.jit(jbind(jresnet18(num_classes=10), jax.tree_util.tree_map(jnp.asarray, loaded),
                        nchw=True))
    want = np.asarray(jfn(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL * np.abs(want).max(), rtol=0)
    _, _, fn_nhwc = tck.build_vision_model("resnet18", num_classes=10, checkpoint_path=path,
                                           nchw=False, device="cpu")
    torch.testing.assert_close(fn_nhwc(torch.from_numpy(x.transpose(0, 2, 3, 1).copy())),
                               torch.from_numpy(got))


def test_build_vision_model_convnext_checkpoint_matches_the_reference(tmp_path, monkeypatch):
    """ConvNeXt at test size: the registry's convnext_tiny entry is pointed
    at convnext_test, the checkpoint goes through the same loader."""
    torch.manual_seed(3)
    model = tconvnext.convnext_test(num_classes=10)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("layer_scale"):
                p.uniform_(0.5, 1.5)
    path = str(tmp_path / "cnx.bin")
    _save_prefixed(path, model)
    monkeypatch.setitem(tck.VISION_MODELS, "convnext_tiny", tconvnext.convnext_test)
    _, _, fn = tck.build_vision_model("convnext_tiny", num_classes=10, checkpoint_path=path,
                                      image_size=32, device="cpu")
    x = _rng("cnx").standard_normal((2, 3, 32, 32)).astype(np.float32)
    got = fn(torch.from_numpy(x)).numpy()
    loaded = jingest.torch_convnext_to_flax(torch.load(path, weights_only=True))
    jfn = jax.jit(jbind(jconvnext.convnext_test(num_classes=10),
                        jax.tree_util.tree_map(jnp.asarray, loaded), nchw=True))
    want = np.asarray(jfn(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL * np.abs(want).max(), rtol=0)


def test_build_vision_model_seeds_and_keys(tmp_path):
    """The init is seeded (the same weights every call) and leaves torch's
    generator as it was; a native checkpoint round-trips; a wrong key or a
    mismatched checkpoint raises."""
    state = torch.get_rng_state()
    a = tck.build_vision_model("resnet18", num_classes=4, device="cpu")[1]
    b = tck.build_vision_model("resnet18", num_classes=4, device="cpu")[1]
    assert torch.equal(torch.get_rng_state(), state)
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = {k: v + 0.5 if v.is_floating_point() else v for k, v in a.items()}
    path = str(tmp_path / "native.ckpt")
    tck.save_variables(path, c)
    d = tck.build_vision_model("resnet18", num_classes=4, checkpoint_path=path, device="cpu")[1]
    assert all(torch.equal(c[k], d[k]) for k in c)
    with pytest.raises(ValueError, match="Unknown model key"):
        tck.build_vision_model("alexnet", device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        tck.load_variables(path, {k: v for k, v in c.items() if k != "fc.bias"})
    tck.save_variables(path, tres.resnet18(num_classes=3))
    with pytest.raises(RuntimeError):
        tck.build_vision_model("resnet18", num_classes=4, checkpoint_path=path, device="cpu")


@pytest.mark.parametrize("loader,args,shape", [
    ("load_3d_model", dict(num_classes=10, feature_transform=True), (2, 3, 64)),
    ("load_3dvoxel_model", dict(num_classes=10, size=16), (2, 1, 16, 16, 16)),
    ("load_audio_model", dict(num_classes=6), (2, 1, 129, 128)),
])
def test_load_models_round_trip_their_checkpoints(tmp_path, loader, args, shape):
    """A native checkpoint of moved weights loads over the seeded init and
    gives the moved weights' outputs."""
    fn_load = getattr(tck, loader)
    model, state, fn = fn_load(None, device="cpu", **args)
    g = torch.Generator().manual_seed(1)
    moved = {k: v + 0.05 * torch.randn(v.shape, generator=g) if v.is_floating_point() else v
             for k, v in state.items()}
    path = str(tmp_path / "m.ckpt")
    tck.save_variables(path, moved)
    _, state2, fn2 = fn_load(path, device="cpu", **args)
    assert all(torch.equal(moved[k], state2[k]) for k in moved)
    model.load_state_dict(moved)
    x = torch.from_numpy(_rng(loader).standard_normal(shape).astype(np.float32))
    torch.testing.assert_close(fn2(x), fn(x))
    assert torch.isfinite(fn(x)).all()


def test_voxel_features_tap_matches_the_reference_sow():
    """The pooled features the reference sows (NDHWC) are the port's
    ``features`` tap (NCDHW), with the same weights; the voxel model's other
    sides (24^3) size its dense layer as the reference's init does."""
    model = JVoxel(num_classes=10)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 1, 16, 16, 16)))
    params = jax.tree_util.tree_map_with_path(
        lambda p, s: (_rng("vox", jax.tree_util.keystr(p)).standard_normal(s.shape)
                      * 0.1).astype(np.float32), shapes)
    x = _rng("vox-x").standard_normal((2, 1, 16, 16, 16)).astype(np.float32)
    logits, sown = model.apply(params, jnp.asarray(x), mutable=["intermediates"])
    want = np.asarray(sown["intermediates"]["features"][0]).transpose(0, 4, 1, 2, 3)
    tmodel = TVoxel(num_classes=10)
    tmodel.load_state_dict(tingest.flax_voxel_to_torch(params), strict=True)
    with tap_scope(["features"]) as taps:
        out = tmodel(torch.from_numpy(x))
    np.testing.assert_allclose(taps["features"].detach().numpy(), want,
                               atol=1e-5 * np.abs(want).max(), rtol=0)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(logits),
                               atol=LOGIT_TOL * np.abs(np.asarray(logits)).max(), rtol=0)
    assert TVoxel.TAPS == ("features",)
    assert TVoxel(size=24)(torch.zeros(1, 1, 24, 24, 24)).shape == (1, 10)


# -- data ---------------------------------------------------------------------------


def _png(path, seed, size=(40, 30)):
    arr = _rng("png", seed).integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
    Image.fromarray(arr).save(path)
    return arr


def test_image_data_matches_the_reference(tmp_path):
    arr = _png(tmp_path / "a.png", 0, (300, 260))
    for kw in ({}, {"crop": None, "resize": 64}, {"normalize": False, "resize": 40, "crop": 32}):
        np.testing.assert_array_equal(timage.preprocess_image(arr, **kw),
                                      jimage.preprocess_image(arr, **kw))
    assets = tmp_path / "src" / "assets"
    assets.mkdir(parents=True)
    for i in range(3):
        _png(assets / f"img{i}.png", i + 1)
    (assets / "labels.json").write_text(json.dumps({f"img{i}.png": i * 2 for i in range(3)}))
    got, want = timage.load_images(str(tmp_path / "src")), jimage.load_images(str(tmp_path / "src"))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == [0, 2, 4] and got[0].shape == (3, 3, 224, 224)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i in range(2):
        _png(imgs / f"p{i}.png", 5 + i)
    got = timage.load_images(labels=[5, 6], images_dir=str(imgs))
    want = jimage.load_images(labels=[5, 6], images_dir=str(imgs))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == [5, 6]
    val = tmp_path / "val"
    val.mkdir()
    for i in range(2):
        Image.fromarray(_png(val / f"x{i}.png", 10 + i)).save(val / f"v{i}.JPEG")
    (val / "val.txt").write_text("v0.JPEG 3\nv1.JPEG 9\n")
    got = timage.load_imagenet_validation(str(val), count=2)
    want = jimage.load_imagenet_validation(str(val), count=2)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == [3, 9]
    with pytest.raises(ValueError, match="expected 3 images"):
        timage.load_imagenet_validation(str(val), count=3)
    img = _rng("show").standard_normal((3, 8, 8)).astype(np.float32)
    for kw in ({}, {"p": 5}, {"inverse_c": True}):
        np.testing.assert_array_equal(timage.show(img, plot=False, **kw),
                                      jimage.show(img, plot=False, **kw))
    np.testing.assert_array_equal(timage.show(torch.from_numpy(img[:1]), plot=False),
                                  jimage.show(img[:1], plot=False))
    assert timage.show(img) is None
    plt.close("all")
    for cmap in ("viridis", (200, 30, 30)):
        np.testing.assert_array_equal(timage.get_alpha_cmap(cmap, 0.1).colors,
                                      jimage.get_alpha_cmap(cmap, 0.1).colors)


def test_mnist3d_matches_the_reference(tmp_path):
    import h5py

    rng = _rng("h5")
    root = tmp_path / "3DMNIST"
    root.mkdir()
    for split, n in (("test", 3), ("train", 4)):
        with h5py.File(root / f"{split}_point_clouds.h5", "w") as f:
            for i in range(n):
                grp = f.create_group(str(i))
                grp.create_dataset("points", data=rng.standard_normal((50 + i, 3)))
                grp.attrs["label"] = i % 10
    with h5py.File(root / "full_dataset_vectors.h5", "w") as f:
        for split, n in (("train", 5), ("test", 2)):
            f.create_dataset(f"X_{split}", data=rng.random((n, 4096)))
            f.create_dataset(f"y_{split}", data=np.arange(n))
    for train in (False, True):
        got = tmnist.load_3d_mnist(str(tmp_path), num_points=16, train=train, seed=3)
        want = jmnist.load_3d_mnist(str(tmp_path), num_points=16, train=train, seed=3)
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)
    got, want = tmnist.load_3dvoxel_mnist(str(tmp_path)), jmnist.load_3dvoxel_mnist(str(tmp_path))
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert got[1][0].shape == (5, 16, 16, 16)
    x, y = got[1]
    for shuffle in (False, True):
        for (a, b), (c, d) in zip(tmnist.batches(x, y, 2, shuffle=shuffle),
                                  jmnist.batches(x, y, 2, shuffle=shuffle)):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def test_audio_numpy_half_matches_the_reference():
    wave = _rng("wave").standard_normal(8192).astype(np.float32)
    np.testing.assert_array_equal(taudio.stft_np(wave, 512, 128), jaudio.stft_np(wave, 512, 128))
    for a, b in zip(taudio.logmel_np(wave, n_fft=512, hop=256, n_mels=32),
                    jaudio.logmel_np(wave, n_fft=512, hop=256, n_mels=32)):
        np.testing.assert_array_equal(a, b)
    for dtype in (np.float32, np.int16):
        audio = (wave * 1000).astype(dtype)
        np.random.seed(7)
        got = taudio.add_0db_noise(audio)
        np.random.seed(7)
        want = jaudio.add_0db_noise(audio)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == dtype
    dataset = [(None, y) for y in (0, 1, 1, 3, 3, 3)]
    assert (taudio.make_weights_for_balanced_classes(dataset, 4)
            == jaudio.make_weights_for_balanced_classes(dataset, 4))


# -- viewers ------------------------------------------------------------------------


def test_viewers_match_the_reference():
    wam = _rng("wam").random((32, 32)).astype(np.float32)
    assert tview.wavelet_region_lines(32, 3) == jview.wavelet_region_lines(32, 3)
    for a, b in zip(tview.plot_wavelet_regions(32, 3), jview.plot_wavelet_regions(32, 3)):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    for kw in ({}, {"normalize_approx": True}, {"smooth": True, "sigma": 1.5}):
        shown = []
        for mod, extra in ((tview, {"device": "cpu"}), (jview, {})):
            fig, ax = plt.subplots()
            mod.plot_wam(ax, wam, 3, **kw, **extra)
            shown.append((np.asarray(ax.images[0].get_array()), len(ax.lines)))
            plt.close(fig)
        np.testing.assert_allclose(shown[0][0], shown[1][0], atol=1e-6, rtol=0)
        assert shown[0][1] == shown[1][1] == 6
    fig = tview.plot_diagonal({"level_0": wam[16:, 16:], "approx": wam[:4, :4]})
    assert len(fig.axes) == 4  # two panels and their colorbars
    figs = tview.visualize_explanations_basic([wam, wam], np.zeros((2, 32, 32, 3)), 3,
                                              which="all", device="cpu")
    assert len(figs) == 2
    fig = tview.visualize_gradients_at_levels([[0.5, 0.3, 0.2], [0.2, 0.3, 0.5]], "shares")
    assert len(fig.axes[0].patches) == 6
    plt.close("all")


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tck.build_vision_model("resnet18", num_classes=4)
    fig, ax = plt.subplots()
    with pytest.raises(RuntimeError, match="CUDA"):
        tview.plot_wam(ax, np.zeros((8, 8), np.float32), 2, smooth=True)
    plt.close(fig)
