"""The port's ESC-50 dataset and `load_sound` (`wam_tpu_torch.data.audio`)
against the reference's (`wam_tpu.data.audio`) on a synthetic ESC-50 tree
the tests write (``meta/esc50.csv`` and ``audio/*.wav``; int16 mono and
stereo clips, a float32 clip and a silent one): the fold splits, class
subsets and their labels, the normalized waveforms (the signed-peak
convention), the log-mel items, ``overlap_two``, the noise draws under one
numpy seed, the prefetched stream, balanced-class weights and the sampler."""

import csv

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from wam_tpu.data import audio as jaudio
from wam_tpu_torch.data import audio as taudio

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

SR = 8000
FEATURES = dict(sr=SR, nfft=256, hop=128, nmel=32)
N_CLIPS = 20


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """20 clips over 5 folds and 5 classes (an ESC-50 layout): clip 3 is
    stereo, clip 5 float32, clip 7 silent, clip 9 all negative; lengths
    differ so ``overlap_two`` cuts to the shorter one."""
    root = tmp_path_factory.mktemp("esc") / "ESC50"
    (root / "audio").mkdir(parents=True)
    (root / "meta").mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i in range(N_CLIPS):
        fold, target = i % 5 + 1, (3 * i + i // 5) % 5
        name = f"{fold}-{100 + i}-A-{target}.wav"
        n = 2000 + 37 * i
        if i == 3:
            data = (rng.standard_normal((n, 2)) * 6000).astype(np.int16)
        elif i == 5:
            data = (0.2 * rng.standard_normal(n)).astype(np.float32)
        elif i == 7:
            data = np.zeros(n, np.int16)
        elif i == 9:
            data = -(np.abs(rng.standard_normal(n)) * 5000 + 1).astype(np.int16)
        else:
            data = (rng.standard_normal(n) * 8000).astype(np.int16)
        wavfile.write(root / "audio" / name, SR, data)
        rows.append({"filename": name, "fold": str(fold), "target": str(target),
                     "category": f"c{target}", "esc10": "False", "src_file": str(100 + i),
                     "take": "A"})
    with open(root / "meta" / "esc50.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return str(root)


def _pair(tree, **kw):
    kw = {**FEATURES, "root_dir": tree, **kw}
    return jaudio.ESC50(**kw), taudio.ESC50(**kw)


def _equal_items(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        if isinstance(u, np.ndarray):
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)
        else:
            assert u == v


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("fold", [1, 3])
@pytest.mark.parametrize("subset", [(), (1, 4)])
def test_splits_subsets_and_labels(tree, mode, fold, subset):
    ref, port = _pair(tree, mode=mode, num_FOLD=fold, select_class=subset)
    assert len(port) == len(ref) > 0
    assert port.rows == ref.rows and port.subset == ref.subset
    np.testing.assert_array_equal(port.noise_strength, ref.noise_strength)
    for i in range(len(ref)):
        _equal_items(port[i], ref[i])


def test_normalized_waveforms_keep_the_signed_peak_convention(tree):
    ref, port = _pair(tree, mode="train", num_FOLD=2)
    for row in ref.rows:
        got, want = port._load(row), ref._load(row)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    silent = np.zeros(10, np.float32)
    np.testing.assert_array_equal(taudio.ESC50._normalize(silent), silent)
    neg = -np.arange(1, 5, dtype=np.float32)  # max is -1: the signal flips sign
    np.testing.assert_array_equal(taudio.ESC50._normalize(neg), jaudio.ESC50._normalize(neg))
    assert taudio.ESC50._normalize(neg)[0] == 1.0


def test_noise_draws_equal_under_one_numpy_seed(tree):
    ref, port = _pair(tree, mode="train", num_FOLD=1, add_noise=True)
    for i in (0, 3, 5):
        np.random.seed(11)
        want = ref[i]
        np.random.seed(11)
        got = port[i]
        _equal_items(got, want)


def test_overlap_two(tree):
    ref, port = _pair(tree, mode="train", num_FOLD=4, select_class=(0, 2, 3))
    for i, j, lam in ((0, 1, 0.2), (2, 0, 0.5)):
        _equal_items(port.overlap_two(i, j, lam), ref.overlap_two(i, j, lam))


def test_iter_waveforms_streams_in_order_through_the_prefetcher(tree):
    ref, port = _pair(tree, mode="train", num_FOLD=5)
    want = list(ref.iter_waveforms(workers=3, capacity=2))
    got = list(port.iter_waveforms(workers=3, capacity=2))
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(len(port)))
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    idx = [4, 1, 2]
    got = list(port.iter_waveforms(indices=idx, workers=2, capacity=1))
    assert [i for i, _ in got] == idx
    for i, wave in got:
        np.testing.assert_array_equal(wave, port._load(port.rows[i]))


def test_balanced_class_weights(tree):
    ref, port = _pair(tree, mode="train", num_FOLD=1)
    assert (taudio.make_weights_for_balanced_classes(port, nclasses=5)
            == jaudio.make_weights_for_balanced_classes(ref, nclasses=5))


@pytest.mark.parametrize("noise", [False, True])
def test_load_sound(tree, noise):
    with open(f"{tree}/meta/esc50.csv") as f:
        names = [row["filename"] for row in csv.DictReader(f)]
    for n in (7, [names[0], names[3]]):  # a draw, then named files (one stereo)
        np.random.seed(5)
        want = jaudio.load_sound(tree, n=n, noise=noise)
        np.random.seed(5)
        got = taudio.load_sound(tree, n=n, noise=noise)
        assert got["y"] == want["y"]
        assert len(got["x"]) == len(want["x"]) == (n if isinstance(n, int) else len(n))
        for a, b in zip(got["x"], want["x"]):
            assert a.dtype == b.dtype and a.ndim == 1
            np.testing.assert_array_equal(a, b)
