"""The port's example scripts (`examples/torch_*.py`) run with ``--device
cpu`` at small sizes (``--quick`` where the reference's script has it,
``--size`` / ``--samples`` for the quickstart and the sharded example), and
their outputs are checked: the PNGs (drawn by the examples' own writer,
`examples/_png.py`, which is held here too), the CSVs with their provenance,
the printed shapes. Five run in this process through their ``main(argv)``;
the sharded example runs as a subprocess in the four variants of the
reference's own test (`tests/test_parallel.py::
test_sharded_attribution_example_runs`), and the quickstart once more as a
subprocess without ``--device``, where it must take the card or fail."""

import csv
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
PNG = b"\x89PNG\r\n\x1a\n"


def _example(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name: str, argv: list, capsys) -> str:
    assert _example(name).main([*argv, "--device", "cpu"]) == 0
    return capsys.readouterr().out


def _png(path) -> tuple:
    """The (height, width) of the RGB PNG file at ``path``, which PIL reads
    back and which is not of one colour."""
    from PIL import Image

    with Image.open(path) as im:
        assert im.format == "PNG" and im.mode == "RGB", path
        rgb = np.asarray(im)
    assert Path(path).read_bytes()[:8] == PNG and (rgb != rgb[0, 0]).any(), path
    return rgb.shape[:2]


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_quickstart(tmp_path, capsys, layout):
    out = tmp_path / "mosaic.png"
    text = _run("torch_quickstart", ["--size", "64", "--samples", "4", "--out", str(out),
                                     "--layout", layout], capsys)
    assert _png(out) == (128, 128)  # the 64^2 mosaic, each pixel drawn 2 x 2
    assert "explaining class" in text and "per-level maps shape: (1, 3, 64, 64)" in text


def test_quickstart_takes_the_card_or_fails():
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, whatever the machine has
    proc = subprocess.run([sys.executable, str(EXAMPLES / "torch_quickstart.py"), "--size",
                           "32", "--samples", "2", "--out", os.devnull], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr, proc.stderr[-2000:]


@pytest.mark.parametrize("wav", [False, True])
def test_audio_quickstart(tmp_path, capsys, wav):
    out = tmp_path / "scaleogram.png"
    argv = ["--quick", "--out", str(out)]
    if wav:  # a stereo file through the port's native reader (>= 128 mel frames)
        path = tmp_path / "clip.wav"
        rng = np.random.default_rng(0)
        wavfile.write(path, 16000, (rng.standard_normal((70000, 2)) * 4000).astype(np.int16))
        argv += ["--wav", str(path)]
    text = _run("torch_audio_quickstart", argv, capsys)
    frames = 1 + (70000 if wav else 2**17) // 512
    # the 128 mel bins over the frames above the scaleogram's 4 rows (each
    # drawn 32 high) at 1024 columns, 8 pixels apart
    assert _png(out) == (128 + 8 + 128, 1024)
    assert f"melspec-grad: (1, {frames}, 128)" in text and "scaleogram: (1, 4," in text


def test_volume_quickstart(tmp_path, capsys):
    out = tmp_path / "volume.png"
    text = _run("torch_volume_quickstart", ["--quick", "--out", str(out)], capsys)
    assert _png(out) == (128, 3 * 128 + 2 * 8)  # three 16^2 mid slices, 8 x 8 a voxel
    assert "gradient cube: (1, 16, 16, 16)" in text
    assert ("representation-mode cube: (1, 16, 16, 16) | per-level maps: (1, 4, 16, 16, 16)"
            in text)


def test_level_attribution(tmp_path, capsys):
    out = tmp_path / "levels"
    text = _run("torch_level_attribution", ["--quick", "--out", str(out)], capsys)
    # 4 levels of 2 bars (one a model), 12 pixels wide, 6 pixels of gap on each side
    assert _png(f"{out}_mean_grads.png") == (160, 4 * (2 * 12 + 2 * 6))
    with open(f"{out}_variance.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["model"] + [f"level_{j}_{s}" for j in range(4) for s in ("mean", "std")] \
        + ["provenance"]
    assert [r[0] for r in rows[1:]] == ["resnet18", "convnext_tiny"]
    for r in rows[1:]:
        means = np.array(r[1:-1:2], dtype=float)
        assert np.isclose(means.sum(), 1.0) and r[-1] == "random-noise-images+random-init"
    assert "resnet18: per-level shares" in text and "convnext_tiny: per-level shares" in text


def test_iou_experiment(tmp_path, capsys):
    out = tmp_path / "iou.csv"
    text = _run("torch_iou_experiment", ["--quick", "--out", str(out)], capsys)
    with open(out) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["", "iou", "provenance", "comparable_to_reference"]
    assert [float(r[0]) for r in rows[1:]] == [0.05, 0.1, 0.15]
    ious = [float(r[1]) for r in rows[1:]]
    assert all(0.0 <= v <= 1.0 for v in ious) and ious == sorted(ious)
    assert all(r[2:] == ["synthetic-sines+random-init", "False"] for r in rows[1:])
    assert "provenance: synthetic-sines+random-init" in text


@pytest.mark.parametrize("extra", [
    [],
    ["--spmd"],
    ["--long-context", "16384"],
    ["--long-context", "16384", "--boundary", "symmetric"],
])
def test_sharded_attribution_example_runs(extra):
    """The parallel API's front door, run as a user would, on an 8-block
    mesh laid on the CPU."""
    out = subprocess.run(
        [sys.executable, str(EXAMPLES / "torch_sharded_attribution.py"), "--device", "cpu",
         "--virtual", "8", "--batch", "2", "--samples", "4", "--size", "32",
         "--wavelet", "db2", "--levels", "2", *extra],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "mesh: {'data': 4, 'sample': 2}" in out.stdout
    if extra[:1] == ["--long-context"]:
        assert "computed over 8 sequence blocks" in out.stdout, out.stdout[-1000:]
    else:
        assert "attribution mosaics: (2, 34, 34), computed over 8 blocks" in out.stdout


def test_sharded_class_api(capsys):
    text = _run("torch_sharded_attribution", ["--virtual", "4", "--batch", "2", "--wavelet",
                                              "db2", "--levels", "2", "--long-context", "4096",
                                              "--class-api"], capsys)
    assert "long-context class-level SmoothGrad (periodization)" in text


def test_png_figures_are_read_back_by_pil(tmp_path):
    """The examples' figure writer (`examples/_png.py`): a heat map of a
    tensor (NaN as the lowest value, small sides repeated up to min_side),
    a symmetric one, grouped bars and panels, written as PNGs that PIL
    reads back pixel for pixel."""
    from PIL import Image

    png_ = _example("_png")
    a = torch.tensor([[0.0, 1.0, float("nan")], [2.0, 3.0, 4.0]])
    img = png_.heatmap(a, "gray", min_side=4)
    assert img.shape == (4, 6, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(img[::2, ::2, 0], [[0, 64, 0], [128, 191, 255]])
    sym = png_.heatmap(np.array([[-2.0, 0.0, 1.0]]), "gray", symmetric=True, min_side=1)
    np.testing.assert_array_equal(sym[0, :, 0], [0, 128, 191])
    b = png_.bars([[1.0, 0.5], [0.25, 0.0]], height=8, bar=2, gap=1)
    assert b.shape == (8, 12, 3)
    assert (b[:, 1:3] != 255).any(axis=-1).sum() == 2 * 8 and (b[:, 3:5] != 255).any(-1).sum() == 8
    both = png_.panels([img, b], axis=0, pad=2)
    assert both.shape == (4 + 2 + 8, 12, 3) and (both[4:6] == 255).all()
    for i, rgb in enumerate((img, sym, b, both)):
        path = tmp_path / f"f{i}.png"
        png_.write_png(str(path), rgb)
        np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), rgb)
    with pytest.raises(ValueError):
        png_.heatmap(np.zeros(3))


@pytest.mark.parametrize("cmap", ["viridis", "coolwarm", "gray"])
def test_heatmap_spans_its_colour_map(cmap):
    """The lowest value takes the map's first anchor colour, the highest its
    last, the middle of a symmetric map its middle colour, and NaN the
    lowest colour."""
    png_ = _example("_png")
    anchors = np.asarray(png_._CMAPS[cmap])
    img = png_.heatmap(np.array([[-1.0, 0.5, 3.0, np.nan]]), cmap, min_side=1)
    np.testing.assert_array_equal(img[0, [0, 2, 3]], anchors[[0, -1, 0]])
    sym = png_.heatmap(np.array([[-2.0, 0.0, 2.0]]), cmap, symmetric=True, min_side=1)
    mid = np.rint((anchors[(len(anchors) - 1) // 2] + anchors[len(anchors) // 2]) / 2)
    np.testing.assert_array_equal(sym[0], [anchors[0], mid, anchors[-1]])


@pytest.mark.parametrize("shape", [(4, 4), (4, 4, 4), (4, 4, 1)])
def test_write_png_takes_rgb_images_only(tmp_path, shape):
    with pytest.raises(ValueError, match=r"\(H, W, 3\) uint8"):
        _example("_png").write_png(str(tmp_path / "x.png"), np.zeros(shape, np.uint8))
    assert not (tmp_path / "x.png").exists()
