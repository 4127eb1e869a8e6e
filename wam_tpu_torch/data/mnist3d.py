"""3D-MNIST loaders (PyTorch port of `wam_tpu.data.mnist3d`): point clouds
from ``train/test_point_clouds.h5`` and 16^3 voxel grids from
``full_dataset_vectors.h5``, as numpy arrays, and a batch iterator. h5py is
imported inside the readers."""

from __future__ import annotations

import os

import numpy as np

from wam_tpu_torch.optional import require

__all__ = ["load_3d_mnist", "load_3dvoxel_mnist", "batches"]


def batches(x: np.ndarray, y: np.ndarray, batch_size: int, shuffle: bool = False,
            seed: int = 42):
    """Yield (x_batch, y_batch) minibatches, shuffled by
    ``np.random.RandomState(seed)`` when asked."""
    idx = np.arange(len(x))
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    for i in range(0, len(idx), batch_size):
        sel = idx[i : i + batch_size]
        yield x[sel], y[sel]


def _read_point_clouds(path: str, num_points: int, rng: np.random.RandomState):
    h5py = require("h5py", "load_3d_mnist")
    xs, ys = [], []
    with h5py.File(path, "r") as ds:
        for i in range(len(ds)):
            pc = ds[str(i)]["points"][:]
            idx = rng.choice(pc.shape[0], num_points)
            xs.append(pc[idx])
            ys.append(ds[str(i)].attrs["label"])
    return np.asarray(xs, dtype=np.float32), np.asarray(ys, dtype=np.int64)


def load_3d_mnist(source_dir: str, num_points: int = 1024, train: bool = False, seed: int = 42):
    """Point clouds (N, num_points, 3) and labels of the test split, and of
    the train split too with ``train``; points sampled with replacement by
    one ``np.random.RandomState(seed)`` across both splits."""
    data_dir = os.path.join(source_dir, "3DMNIST")
    rng = np.random.RandomState(seed)
    test = _read_point_clouds(os.path.join(data_dir, "test_point_clouds.h5"), num_points, rng)
    if not train:
        return test
    train_split = _read_point_clouds(os.path.join(data_dir, "train_point_clouds.h5"),
                                     num_points, rng)
    return test, train_split


def load_3dvoxel_mnist(source_dir: str):
    """16^3 voxel grids: ((X_test, y_test), (X_train, y_train))."""
    h5py = require("h5py", "load_3dvoxel_mnist")
    with h5py.File(os.path.join(source_dir, "3DMNIST", "full_dataset_vectors.h5"), "r") as hf:
        x_train = hf["X_train"][:].reshape(-1, 16, 16, 16).astype(np.float32)
        y_train = hf["y_train"][:].astype(np.int64)
        x_test = hf["X_test"][:].reshape(-1, 16, 16, 16).astype(np.float32)
        y_test = hf["y_test"][:].astype(np.int64)
    return (x_test, y_test), (x_train, y_train)
