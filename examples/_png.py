"""The example scripts' figures: heat maps of arrays, grouped bars, panels
side by side, written as PNG files with zlib. They need no plotting library
(matplotlib is not installed everywhere the examples run), and they draw the
data alone, without axes, ticks or labels."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

__all__ = ["heatmap", "bars", "panels", "write_png"]

# anchor colours, evenly spaced over [0, 1], linearly interpolated between
_CMAPS = {
    "viridis": ((68, 1, 84), (59, 82, 139), (33, 145, 140), (94, 201, 98), (253, 231, 37)),
    "coolwarm": ((59, 76, 192), (141, 176, 254), (221, 221, 221), (244, 154, 123),
                 (180, 4, 38)),
    "gray": ((0, 0, 0), (255, 255, 255)),
}
WHITE = 255



def heatmap(a, cmap: str = "viridis", symmetric: bool = False, min_side: int = 128) -> np.ndarray:
    """A 2D array (tensor or array; NaN as the lowest value) as an RGB uint8
    image: scaled to [0, 1] over its range (``symmetric``: 0 at the middle,
    over its largest magnitude), coloured by ``cmap``, its rows (columns)
    repeated until there are at least ``min_side`` of them."""
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    a = np.asarray(a, dtype=np.float64)
    if a.ndim != 2:
        raise ValueError(f"heatmap takes a 2D array, got shape {a.shape}")
    finite = np.isfinite(a)
    vals = a[finite]
    if symmetric:
        m = np.abs(vals).max() if vals.size else 0.0
        t = 0.5 + a / (2 * m) if m > 0 else np.full(a.shape, 0.5)
    else:
        lo, hi = (vals.min(), vals.max()) if vals.size else (0.0, 0.0)
        t = (a - lo) / (hi - lo) if hi > lo else np.zeros(a.shape)
    t = np.where(finite, np.clip(t, 0.0, 1.0), 0.0)
    anchors = np.asarray(_CMAPS[cmap], dtype=np.float64)
    xs = np.linspace(0.0, 1.0, len(anchors))
    rgb = np.stack([np.interp(t, xs, anchors[:, c]) for c in range(3)], axis=-1)
    kr, kc = (max(1, -(-min_side // max(1, n))) for n in a.shape)
    return np.repeat(np.repeat(np.rint(rgb).astype(np.uint8), kr, axis=0), kc, axis=1)


def bars(values, height: int = 160, bar: int = 12, gap: int = 6,
         cmap: str = "viridis") -> np.ndarray:
    """Grouped bars on white: ``values`` (groups, series), non-negative, the
    tallest ``height`` pixels; series i of every group in the i-th colour of
    ``cmap``."""
    v = np.asarray(values, dtype=np.float64)
    groups, series = v.shape
    top = v.max() if v.size and v.max() > 0 else 1.0
    width = groups * (series * bar + 2 * gap)
    img = np.full((height, width, 3), WHITE, dtype=np.uint8)
    colours = heatmap(np.linspace(0, 1, series)[None], cmap, min_side=1)[0]
    for g in range(groups):
        for s in range(series):
            h = int(round(height * max(0.0, v[g, s]) / top))
            x0 = g * (series * bar + 2 * gap) + gap + s * bar
            img[height - h:, x0:x0 + bar] = colours[s]
    return img


def panels(images, axis: int = 1, pad: int = 8) -> np.ndarray:
    """RGB images side by side (``axis`` 1) or stacked (``axis`` 0) on white,
    ``pad`` pixels apart, each placed at the top left of its cell."""
    across = 1 - axis
    size = max(im.shape[across] for im in images)
    cells = []
    for i, im in enumerate(images):
        shape = list(im.shape)
        shape[across] = size
        shape[axis] += 0 if i == len(images) - 1 else pad
        cell = np.full(shape, WHITE, dtype=np.uint8)
        cell[:im.shape[0], :im.shape[1]] = im
        cells.append(cell)
    return np.concatenate(cells, axis=axis)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got shape {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
