"""Plain WAM-2D: SmoothGrad and Integrated Gradients on wavelet
coefficients, and the dyadic gradient mosaic (Kasmi et al., "One Wave To
Explain Them All", the method the measured package implements).

For a batch x (B, C, H, W) with labels y, the attribution of one pass is
the gradient of mean_b logit[b, y_b] with respect to every coefficient of
the J-level transform of x, taken through the inverse transform and the
model. The mosaic packs a level's per-coefficient values, each leaf as
|mean over channels| divided by that leaf's largest value over the batch:
the approximation top-left, then for each level with block span [s, e)
(finest level first, e = S / 2^i) D at [s:e, s:e], V at [s:e, :s] and H at
[:s, s:e], S twice the finest detail side. A later block overwrites an
earlier one where long filters make them overlap.

- SmoothGrad: the mean of the mosaics of n noisy copies x + sigma_b z_i,
  sigma_b = spread * (max x_b - min x_b), z_i standard normal draws of the
  input's shape.
- Integrated Gradients: the mosaic of the input's own coefficients
  (normalized as above) times the trapezoid sum (unit spacing) of the
  mosaics of the gradients at alpha * coefficients, alpha on n evenly spaced
  points of [0, 1].

Everything runs in ``dtype`` (float32 for the reference, bfloat16 for the
control): the transforms, the model, the gradients; the mosaic in float32.
Samples run ``chunk`` at a time so the reference fits beside the caller's
tensors.
"""

from __future__ import annotations

import torch

from wambench.reference import wavelets as rw


def _prep(leaf: torch.Tensor) -> torch.Tensor:
    a = leaf.float().mean(dim=1).abs()  # (B, h, w)
    m = a.amax()
    return a / torch.where(m == 0, torch.ones_like(m), m)


def mosaic(coeffs) -> torch.Tensor:
    """(B, S, S) mosaic of one pass's per-coefficient values."""
    size = 2 * coeffs[-1][0].shape[-1]
    a = coeffs[0]
    out = torch.zeros((a.shape[0], size, size), dtype=torch.float32, device=a.device)
    out[:, : min(a.shape[-2], size), : min(a.shape[-1], size)] = _prep(a)[:, :size, :size]
    for i, (H, V, D) in enumerate(coeffs[1:][::-1]):
        e, s = size // 2**i, size // 2 ** (i + 1)
        b = e - s
        out[:, s:e, s:e] = _prep(D)[:, :b, :b]
        out[:, s:e, :s] = _prep(V)[:, :b, :s]
        out[:, :s, s:e] = _prep(H)[:, :s, :b]
    return out


def _leaves(coeffs) -> list:
    return [coeffs[0]] + [t for det in coeffs[1:] for t in det]


def _tree(leaves) -> list:
    return [leaves[0]] + [tuple(leaves[1 + 3 * i: 4 + 3 * i]) for i in range((len(leaves) - 1) // 3)]


def coefficient_grads(model, coeffs, y: torch.Tensor, name: str, spatial) -> list:
    """d mean_b logit[b, y_b] / d coefficient, for rows that may stack
    several copies of one batch (the mean is per copy: each row's gradient
    is d logit / B_copy, B_copy = len(y_copy) — the caller passes y repeated
    and the copy size as ``spatial[2]``)."""
    H, W, per_copy = spatial
    leaves = [t.detach().requires_grad_(True) for t in _leaves(coeffs)]
    with torch.enable_grad():
        rec = rw.waverec2(_tree(leaves), name)[..., :H, :W]
        logits = model(rec).float()
        loss = logits.gather(1, y.reshape(-1, 1).long())[:, 0].sum() / per_copy
        grads = torch.autograd.grad(loss, leaves)
    return _tree(list(grads))


def _split(tree, s: int) -> list:
    """The coefficient tree of s stacked copies -> s trees."""
    leaves = [t.reshape((s, -1) + tuple(t.shape[1:])) for t in _leaves(tree)]
    return [_tree([t[i] for t in leaves]) for i in range(s)]


def smoothgrad(model, x: torch.Tensor, y: torch.Tensor, noise: torch.Tensor, *, name: str,
               levels: int, spread: float, chunk: int, dtype=torch.float32) -> torch.Tensor:
    """SmoothGrad mosaic (B, S, S) from the draws ``noise`` (n, B, C, H, W)."""
    B = x.shape[0]
    flat = x.reshape(B, -1)
    sigma = (spread * (flat.amax(1) - flat.amin(1))).reshape(B, 1, 1, 1)
    n = noise.shape[0]
    total = None
    for i0 in range(0, n, chunk):
        z = noise[i0:i0 + chunk]
        s = z.shape[0]
        noisy = (x[None] + z * sigma).reshape((s * B,) + tuple(x.shape[1:])).to(dtype)
        with torch.no_grad():
            coeffs = rw.wavedec2(noisy, name, levels)
        grads = coefficient_grads(model, coeffs, y.repeat(s), name, (x.shape[-2], x.shape[-1], B))
        part = sum(mosaic(g) for g in _split(grads, s))
        total = part if total is None else total + part
        del coeffs, grads
    return total / n


def integrated(model, x: torch.Tensor, y: torch.Tensor, *, name: str, levels: int,
               steps: int, chunk: int, dtype=torch.float32) -> torch.Tensor:
    """Integrated-Gradients mosaic (B, S, S)."""
    B = x.shape[0]
    with torch.no_grad():
        coeffs = rw.wavedec2(x.to(dtype), name, levels)
    base = mosaic(coeffs)
    alphas = torch.linspace(0.0, 1.0, steps, dtype=torch.float32, device=x.device)
    path = []
    for i0 in range(0, steps, chunk):
        a = alphas[i0:i0 + chunk]
        s = a.shape[0]
        scaled = _tree([(t[None] * a.to(t.dtype).reshape(-1, 1, 1, 1, 1))
                        .reshape((s * B,) + tuple(t.shape[1:])) for t in _leaves(coeffs)])
        grads = coefficient_grads(model, scaled, y.repeat(s), name, (x.shape[-2], x.shape[-1], B))
        path += [mosaic(g) for g in _split(grads, s)]
        del grads
    path = torch.nan_to_num(torch.stack(path))
    integral = path[0] / 2 + path[1:-1].sum(0) + path[-1] / 2
    return base * integral
