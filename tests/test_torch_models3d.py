"""Parity of the PyTorch port's 3D models with the JAX package: the 3D ResNet,
the voxel CNN and the PointNet family, their weights carried across by
`flax_resnet3d_to_torch`, `flax_voxel_to_torch` and `flax_pointnet_to_torch`,
and the BatchNorm fold on 3D convolutions.

Weights are drawn with numpy into the JAX models' variable trees, every
BatchNorm a non-identity (scales, biases and running statistics drawn), so a
wrong pairing or a missed fold shows. Inputs are drawn with numpy. Tolerance: scores within
1e-4 (float32 in different summation orders agree to ~1e-6); the folded
state dict within 1e-6 of the JAX package's folded variables.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wam_tpu.models import pointnet as jpn
from wam_tpu.models import resnet as jres
from wam_tpu.models import resnet3d as jr3
from wam_tpu.models.voxel import VoxelModel as JVoxel
from wam_tpu_torch.models import pointnet as tpn
from wam_tpu_torch.models import resnet as tres
from wam_tpu_torch.models import resnet3d as tr3
from wam_tpu_torch.models.ingest import (
    flax_pointnet_to_torch,
    flax_resnet3d_to_torch,
    flax_voxel_to_torch,
)
from wam_tpu_torch.models.voxel import VoxelModel as TVoxel

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

TOL = 1e-4


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _np(t):
    return t.detach().numpy()


def _jax_model(model, shape, seed):
    """Variables of ``model`` drawn with numpy, no JAX init (which compiles
    an initialiser per kernel shape): kernels N(0, 1/fan_in), biases
    N(0, 0.05^2), every BatchNorm a non-identity (scale, bias, mean and var
    drawn), in the tree `model.init` would give."""
    rng = _rng("vars", type(model).__name__, seed)
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros(shape))

    def draw(path, leaf):
        name, n = path[-1].key, leaf.shape
        if name == "kernel":
            v = rng.standard_normal(n) / np.sqrt(np.prod(n[:-1]))
        elif name in ("bias", "mean"):
            v = (0.05 if name == "bias" and path[0].key == "params" else 0.1) \
                * rng.standard_normal(n)
        elif name == "scale":
            v = rng.uniform(0.8, 1.2, n)
        else:  # var
            v = rng.uniform(0.5, 1.5, n)
        return v.astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, tree)
    return {k: variables[k] for k in ("params", "batch_stats") if k in variables}


# -- the 3D ResNet ------------------------------------------------------------------


@pytest.mark.parametrize("arch,side", [("resnet3d_10", 8), ("resnet3d_18", 9)],
                         ids=["r10-8", "r18-9-odd"])
def test_resnet3d_logits_match_jax(arch, side):
    """The logits of both packages on the same weights; the odd side takes
    the stride-2 convs and the 1x1x1 shortcut (flax's SAME pads it by 0)
    through sides 9 -> 5 -> 3 -> 2."""
    jm = getattr(jr3, arch)(num_classes=5, width=4)
    variables = _jax_model(jm, (1, 1, side, side, side), 0)
    x = _rng("r3d", arch).standard_normal((2, 1, side, side, side)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    tm = getattr(tr3, arch)(num_classes=5, width=4)
    fn = tres.bind_inference(tm, flax_resnet3d_to_torch(variables), device="cpu")
    got = _np(fn(torch.from_numpy(x)))
    assert got.shape == want.shape == (2, 5)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_resnet3d_state_dict_names_and_initialisers():
    """The ingested state dict loads strictly (every name paired), the
    BatchNorms are named after their convs, and fresh weights follow flax's
    initialisers: lecun_normal kernels (std sqrt(1/fan_in), truncated at two
    standard deviations), zero dense bias."""
    jm = jr3.resnet3d_18(num_classes=10, width=4)
    variables = _jax_model(jm, (1, 1, 8, 8, 8), 1)
    tm = tr3.resnet3d_18(num_classes=10, width=4)
    tm.load_state_dict(flax_resnet3d_to_torch(variables), strict=True)
    names = dict(tm.named_modules())
    for name, m in names.items():
        if isinstance(m, torch.nn.BatchNorm3d):
            assert isinstance(names[tres._conv_of(name)], torch.nn.Conv3d), name
    torch.manual_seed(0)
    fresh = tr3.resnet3d_18(num_classes=10, width=16)
    w = fresh.layer4[0].conv2.weight.detach()
    fan_in = 128 * 27
    std = float(w.std())
    assert abs(std - (1 / fan_in) ** 0.5) < 0.03 * (1 / fan_in) ** 0.5
    assert float(w.abs().max()) <= 2 * (1 / fan_in) ** 0.5 / 0.8796 + 1e-6
    assert float(fresh.fc.bias.detach().abs().max()) == 0.0


def test_resnet3d_taps_raise():
    """The stage taps are ported (`models.layers.tap`, the reference's names
    stage1..stage4); a tap the model does not have raises where a CAM asks
    for it."""
    from wam_tpu_torch.evalsuite.baselines import gradcam

    m = tr3.resnet3d_10(width=4).eval()
    assert m.TAPS == ("stage1", "stage2", "stage3", "stage4")
    with pytest.raises(ValueError, match="no activation tap 'stage5'"):
        gradcam(m, torch.zeros(1, 1, 8, 8, 8), [0], layer="stage5")


def test_fold_bn_folds_3d_pairs_as_jax_does():
    """`bind_inference(fold_bn=True)` on a 3D ResNet folds every
    Conv3d/BatchNorm3d pair: the port's folded state equals the ingest of
    the JAX package's folded variables within 1e-6, the weights did change,
    and the folded model's scores match the unfolded model's within 1e-4."""
    jm = jr3.resnet3d_18(num_classes=6, width=4)
    variables = _jax_model(jm, (1, 1, 8, 8, 8), 2)
    want = flax_resnet3d_to_torch(jres._fold_bn_variables(variables))
    state = flax_resnet3d_to_torch(variables)
    tm = tr3.resnet3d_18(num_classes=6, width=4)
    folded = tres.bind_inference(tm, state, fold_bn=True, device="cpu")
    got = tm.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(_np(got[k]).astype(np.float64), _np(want[k]), atol=1e-6,
                                   rtol=0, err_msg=k)
    assert not torch.allclose(got["layer2.0.downsample_conv.weight"],
                              state["layer2.0.downsample_conv.weight"])
    plain = tres.bind_inference(tr3.resnet3d_18(num_classes=6, width=4), state, device="cpu")
    x = torch.from_numpy(_rng("fold").standard_normal((2, 1, 8, 8, 8)).astype(np.float32))
    torch.testing.assert_close(folded(x), plain(x), atol=TOL, rtol=0)


def test_fold_bn_folds_1d_pairs():
    """Conv1d/BatchNorm1d pairs fold too (any rank); a transposed conv is
    left alone."""
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = torch.nn.Conv1d(2, 3, 3, padding=1)
            self.bn1 = torch.nn.BatchNorm1d(3)
            self.conv2 = torch.nn.ConvTranspose1d(3, 3, 2)
            self.bn2 = torch.nn.BatchNorm1d(3)

        def forward(self, x):
            return self.bn2(self.conv2(self.bn1(self.conv1(x))))

    torch.manual_seed(0)
    net = Net()
    with torch.no_grad():
        for bn in (net.bn1, net.bn2):
            bn.running_mean.uniform_(-0.5, 0.5)
            bn.running_var.uniform_(0.5, 1.5)
            bn.weight.uniform_(0.5, 1.5)
    x = torch.randn(2, 2, 7)
    want = net.eval()(x)
    w2 = net.conv2.weight.clone()
    got = tres.bind_inference(net, fold_bn=True, device="cpu")(x)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert float(net.bn1.weight.sub(1).abs().max()) == 0.0
    assert torch.equal(net.conv2.weight, w2)


def test_fused_relu_binds_on_the_3d_resnet():
    """`fused_relu_vjp=True` is legal on the 3D ResNet (it has ``act``) and
    swaps every block's activation; the scores are unchanged."""
    state = tr3.resnet3d_10(num_classes=3, width=4).state_dict()
    tm = tr3.resnet3d_10(num_classes=3, width=4)
    fn = tres.bind_inference(tm, state, fused_relu_vjp=True, device="cpu")
    acts = [m.act for m in tm.modules() if hasattr(m, "act")]
    assert len(acts) == 5 and all(a is not torch.relu for a in acts)
    plain = tres.bind_inference(tr3.resnet3d_10(num_classes=3, width=4), state, device="cpu")
    x = torch.randn(2, 1, 8, 8, 8)
    torch.testing.assert_close(fn(x), plain(x), atol=0, rtol=0)


# -- the voxel CNN ------------------------------------------------------------------


def test_voxel_model_matches_jax():
    """The voxel CNN's logits on the same weights. ``fc1`` is drawn with no
    symmetry, so a wrong order of its 1024 input rows (JAX flattens NDHWC,
    the port NCDHW) fails."""
    jm = JVoxel(num_classes=10)
    variables = _jax_model(jm, (1, 1, 16, 16, 16), 3)
    params = {k: dict(v) for k, v in variables["params"].items()}
    rng = _rng("voxel-fc1")
    params["fc1"]["kernel"] = rng.standard_normal((1024, 256)).astype(np.float32) / 32
    params["conv2"]["bias"] = (0.1 * rng.standard_normal(128)).astype(np.float32)
    variables = {"params": params}
    x = _rng("voxel-x").standard_normal((3, 1, 16, 16, 16)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    tm = TVoxel(num_classes=10)
    fn = tres.bind_inference(tm, flax_voxel_to_torch(variables), device="cpu")
    got = _np(fn(torch.from_numpy(x)))
    assert got.shape == (3, 10)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # the unpermuted rows give other scores: the test sees the order
    bad = flax_voxel_to_torch(variables)
    bad["fc1.weight"] = torch.from_numpy(params["fc1"]["kernel"].T.copy())
    tm.load_state_dict(bad)
    assert np.abs(_np(tm(torch.from_numpy(x))) - want).max() > 1e-2


# -- PointNet -----------------------------------------------------------------------


def _pointnet(kind: str, ft: bool, n_pts: int = 64):
    jm = getattr(jpn, kind)(k=4, feature_transform=ft)
    variables = _jax_model(jm, (1, 3, n_pts), 4)
    tm = getattr(tpn, kind)(k=4, feature_transform=ft)
    fn = tres.bind_inference(tm, flax_pointnet_to_torch(variables), device="cpu")
    return jm, variables, fn


@pytest.mark.parametrize("ft", [False, True], ids=["plain", "feature_transform"])
@pytest.mark.parametrize("kind", ["PointNetCls", "PointNetDenseCls"])
def test_pointnet_matches_jax(kind, ft):
    """Log-probabilities, the input transform and the feature transform of
    both packages on the same weights, clouds of 64 points."""
    jm, variables, fn = _pointnet(kind, ft)
    x = _rng("pn", kind, ft).standard_normal((2, 3, 64)).astype(np.float32)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    got = fn(torch.from_numpy(x))
    assert got[0].shape == np.asarray(want[0]).shape
    assert got[0].shape == ((2, 4) if kind == "PointNetCls" else (2, 64, 4))
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_allclose(_np(g), np.asarray(w), atol=TOL, rtol=0)
    if ft:
        np.testing.assert_allclose(
            float(tpn.feature_transform_regularizer(got[2])),
            float(jpn.feature_transform_regularizer(want[2])), rtol=1e-5)


def test_pointnet_aliases_and_names():
    assert tpn.STN3d().k == 3 and tpn.STNkd().k == 64
    assert tpn.PointNetfeat is tpn.PointNetFeat
    state = tpn.PointNetCls(k=4, feature_transform=True).state_dict()
    jm = jpn.PointNetCls(k=4, feature_transform=True)
    got = flax_pointnet_to_torch(_jax_model(jm, (1, 3, 16), 5))
    assert got.keys() == state.keys()
    assert all(got[k].shape == state[k].shape for k in state)
