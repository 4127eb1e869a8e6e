"""The PointNet family as PyTorch modules.

Counterpart of `wam_tpu.models.pointnet` (the reference's STN3d / STNkd /
PointNetfeat / PointNetCls / PointNetDenseCls and
`feature_transform_regularizer`). Point clouds are (B, 3, N), the
reference's layout, and stay (B, C, N) inside: the point-shared layers are
1x1 ``Conv1d``s and their BatchNorms ``BatchNorm1d`` (eps 1e-5), the layout
of the reference's own (PyTorch) model, where the JAX package applies dense
layers to (B, N, C). Submodules carry the JAX package's names (``mlp1``,
``bn1``, ``fc1``, ``stn``, ``fstn``, ``feat``, ``c1`` ...), so
`ingest.flax_pointnet_to_torch` maps its variables across by name. The
global max over the points is ``amax``, which splits the gradient of tied
points evenly, as JAX's ``max`` does. Fresh weights are drawn as flax's
initialisers draw them (lecun_normal kernels, zero biases).

The classifiers return ``(log-probabilities, trans, trans_feat)``, as the
reference's do; `wam3d.BaseWAM3D` reads the scores as ``out[0]``.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn as nn

from wam_tpu_torch.models.layers import dense, lecun_normal_

__all__ = [
    "STN",
    "STN3d",
    "STNkd",
    "PointNetFeat",
    "PointNetfeat",
    "PointNetCls",
    "PointNetDenseCls",
    "feature_transform_regularizer",
]


def _shared(in_ch: int, out_ch: int) -> nn.Conv1d:
    """A point-shared dense layer: a 1x1 Conv1d drawn as flax's Dense."""
    conv = nn.Conv1d(in_ch, out_ch, 1)
    lecun_normal_(conv.weight, in_ch)
    nn.init.zeros_(conv.bias)
    return conv


def _bn(ch: int) -> nn.BatchNorm1d:
    return nn.BatchNorm1d(ch, eps=1e-5)


class STN(nn.Module):
    """Spatial transformer: (B, k, N) -> a (B, k, k) alignment matrix
    (+identity)."""

    def __init__(self, k: int = 3):
        super().__init__()
        self.k = k
        self.mlp1, self.bn1 = _shared(k, 64), _bn(64)
        self.mlp2, self.bn2 = _shared(64, 128), _bn(128)
        self.mlp3, self.bn3 = _shared(128, 1024), _bn(1024)
        self.fc1, self.bn4 = dense(1024, 512), _bn(512)
        self.fc2, self.bn5 = dense(512, 256), _bn(256)
        self.fc3 = dense(256, k * k)

    def forward(self, x):
        z = torch.relu(self.bn1(self.mlp1(x)))
        z = torch.relu(self.bn2(self.mlp2(z)))
        z = torch.relu(self.bn3(self.mlp3(z))).amax(dim=2)  # global max over points
        z = torch.relu(self.bn4(self.fc1(z)))
        z = torch.relu(self.bn5(self.fc2(z)))
        z = self.fc3(z) + torch.eye(self.k, dtype=z.dtype, device=z.device).reshape(-1)
        return z.reshape(-1, self.k, self.k)


def _transform(x: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """Points (B, k, N) times the (B, k, k) matrix: x^T @ trans, kept (B, k, N)."""
    return torch.bmm(trans.transpose(1, 2), x)


class PointNetFeat(nn.Module):
    """(B, 3, N) -> (global feature (B, 1024), or per-point features
    (B, 1088, N) when ``global_feat=False``; trans; trans_feat or None)."""

    def __init__(self, global_feat: bool = True, feature_transform: bool = False):
        super().__init__()
        self.global_feat = global_feat
        self.feature_transform = feature_transform
        self.stn = STN(k=3)
        self.mlp1, self.bn1 = _shared(3, 64), _bn(64)
        self.fstn = STN(k=64) if feature_transform else None
        self.mlp2, self.bn2 = _shared(64, 128), _bn(128)
        self.mlp3, self.bn3 = _shared(128, 1024), _bn(1024)

    def forward(self, x):
        n_pts = x.shape[2]
        trans = self.stn(x)
        x = torch.relu(self.bn1(self.mlp1(_transform(x, trans))))
        trans_feat = None
        if self.fstn is not None:
            trans_feat = self.fstn(x)
            x = _transform(x, trans_feat)
        point_feat = x
        x = torch.relu(self.bn2(self.mlp2(x)))
        x = self.bn3(self.mlp3(x)).amax(dim=2)
        if self.global_feat:
            return x, trans, trans_feat
        tiled = x[:, :, None].expand(-1, -1, n_pts)
        return torch.cat([tiled, point_feat], dim=1), trans, trans_feat


class PointNetCls(nn.Module):
    """(B, 3, N) -> (log-probabilities (B, k), trans, trans_feat)."""

    def __init__(self, k: int = 2, feature_transform: bool = False):
        super().__init__()
        self.feat = PointNetFeat(global_feat=True, feature_transform=feature_transform)
        self.fc1, self.bn1 = dense(1024, 512), _bn(512)
        self.fc2, self.bn2 = dense(512, 256), _bn(256)
        self.dropout = nn.Dropout(0.3)  # train mode only, as in the reference
        self.fc3 = dense(256, k)

    def forward(self, x):
        feat, trans, trans_feat = self.feat(x)
        z = torch.relu(self.bn1(self.fc1(feat)))
        z = torch.relu(self.bn2(self.dropout(self.fc2(z))))
        return torch.log_softmax(self.fc3(z), dim=1), trans, trans_feat


class PointNetDenseCls(nn.Module):
    """Per-point segmentation head: (B, 3, N) -> (log-probabilities
    (B, N, k), trans, trans_feat)."""

    def __init__(self, k: int = 2, feature_transform: bool = False):
        super().__init__()
        self.feat = PointNetFeat(global_feat=False, feature_transform=feature_transform)
        self.c1, self.bn1 = _shared(1088, 512), _bn(512)
        self.c2, self.bn2 = _shared(512, 256), _bn(256)
        self.c3, self.bn3 = _shared(256, 128), _bn(128)
        self.c4 = _shared(128, k)

    def forward(self, x):
        feat, trans, trans_feat = self.feat(x)
        z = torch.relu(self.bn1(self.c1(feat)))
        z = torch.relu(self.bn2(self.c2(z)))
        z = torch.relu(self.bn3(self.c3(z)))
        return torch.log_softmax(self.c4(z).transpose(1, 2), dim=-1), trans, trans_feat


def feature_transform_regularizer(trans: torch.Tensor) -> torch.Tensor:
    """||T T^T - I|| (Frobenius), the mean over the batch."""
    eye = torch.eye(trans.shape[1], dtype=trans.dtype, device=trans.device)
    diff = torch.bmm(trans, trans.transpose(1, 2)) - eye
    return torch.linalg.matrix_norm(diff).mean()


# The reference's names and defaults: STN3d is k=3, STNkd defaults to k=64;
# PointNetfeat spells feat lowercase.
STN3d = partial(STN, k=3)
STNkd = partial(STN, k=64)
PointNetfeat = PointNetFeat
