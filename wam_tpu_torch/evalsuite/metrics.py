"""Shared metric machinery of the evaluation suite (PyTorch port of
`wam_tpu.evalsuite.metrics`): AUC, nested insertion/deletion masks, softmax
probabilities, min-max normalization, Spearman rank correlation, the
μ-fidelity draws, and the insertion/deletion fan runner.

The whole (n_iter + 1)-mask family is one broadcast comparison against a
rank array, ready for one batched reconstruction.
"""

from __future__ import annotations

import numpy as np
import torch

from wam_tpu_torch.evalsuite.fan import (
    FanPlan,
    cast_model_fn,
    fan_chunk_geometry,
    fan_runner,
    make_chunked_forward,
    run_fan,
    upload,
)
from wam_tpu_torch.pipeline.donation import donation_safe, resolve_donate

__all__ = ["host_labels", "batch_fingerprint", "softmax_probs", "compute_auc", "generate_masks",
           "minmax_normalize", "spearman", "mu_fidelity_draws", "batched_auc_runner",
           "run_cached_auc"]


def host_labels(y) -> np.ndarray:
    """Labels as a host array. Labels in a CUDA tensor are read back, which
    waits for the device's queue: pass host ints to keep a metric call free
    of any wait but its result fetch."""
    if isinstance(y, torch.Tensor):
        return y.detach().cpu().numpy()
    return np.asarray(y)


def batch_fingerprint(x, y) -> tuple:
    """Identity of an evaluation batch for the explanation caches:
    ``(shape, dtype, labels)``, labels as `host_labels` reads them."""
    ys = () if y is None else tuple(int(v) for v in host_labels(y).reshape(-1))
    return (tuple(x.shape), str(x.dtype).removeprefix("torch."), ys)


def softmax_probs(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits, dim=-1)


def compute_auc(probs: torch.Tensor) -> torch.Tensor:
    """sum(p) / (max(p) * len(p)) over the last axis."""
    denom = probs.amax(dim=-1) * probs.shape[-1]
    return probs.sum(dim=-1) / torch.where(denom == 0, 1.0, denom)


def generate_masks(n_iter: int, attribution: torch.Tensor, signed: bool = False):
    """Nested insertion/deletion masks from an attribution map of any shape.

    Returns (insertion, deletion), each (n_iter + 1, *attribution.shape):
    insertion[k] keeps the k * (size // n_iter) most important cells
    (insertion[0] empty, insertion[-1] full); deletion is the complement
    family, starting full. Importance is the value, or |value| when
    ``signed``. Ties keep their order in the flattened map (a stable
    descending sort, as the reference's ``argsort(-flat)``): mosaics tie
    often, and another order keeps other cells."""
    flat = attribution.reshape(-1)
    if signed:
        flat = flat.abs()
    n = flat.shape[0]
    order = torch.argsort(-flat, stable=True)
    rank = torch.empty(n, dtype=torch.int64, device=flat.device)
    rank.scatter_(0, order, torch.arange(n, device=flat.device))
    ks = torch.arange(1, n_iter + 1, device=flat.device) * (n // n_iter)
    keep = rank[None, :] < ks[:, None]  # (n_iter, n)
    ins = torch.cat([torch.zeros((1, n), dtype=torch.bool, device=flat.device), keep])
    ins[-1] = True  # the last mask keeps everything
    dele = torch.cat([torch.ones((1, n), dtype=torch.bool, device=flat.device), ~keep])
    dele[-1] = False
    shape = (n_iter + 1,) + tuple(attribution.shape)
    return ins.to(attribution.dtype).reshape(shape), dele.to(attribution.dtype).reshape(shape)


def minmax_normalize(a: torch.Tensor) -> torch.Tensor:
    lo, hi = a.min(), a.max()
    return (a - lo) / torch.where(hi > lo, hi - lo, 1.0)


def _average_ranks(v: torch.Tensor) -> torch.Tensor:
    """0-based ranks with ties given their average: #less + (#leq - 1) / 2."""
    sv = torch.sort(v).values
    lo = torch.searchsorted(sv, v, right=False)
    hi = torch.searchsorted(sv, v, right=True)
    return (lo + hi - 1).to(v.dtype) / 2.0


def spearman(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Spearman rank correlation of two 1D vectors, on the device, with tied
    values given their average rank (scipy.stats.spearmanr's default)."""
    ra, rb = _average_ranks(a), _average_ranks(b)
    ra = ra - ra.mean()
    rb = rb - rb.mean()
    denom = torch.sqrt((ra**2).sum() * (rb**2).sum())
    return (ra * rb).sum() / torch.where(denom == 0, 1.0, denom)


def mu_fidelity_draws(cache: dict, seed: int, n_images: int, grid_size: int,
                      sample_size: int, subset_size: int, with_rand_masks: bool, device):
    """The μ-fidelity randomness, drawn on the host with numpy in the
    reference's order (per image: the continuous baseline-search masks when
    used, then ``sample_size`` feature subsets), cached per configuration,
    seed and device, and uploaded once. With ``with_rand_masks`` the two
    arrays go up as one (B, 2, S, g^2) buffer and come back as its views
    (rand_masks (B, S, g, g), onehots (B, S, g^2)); else the onehots."""
    key = (seed, n_images, grid_size, sample_size, subset_size, with_rand_masks, str(device))
    cached = cache.get(key)
    if cached is not None:
        return cached
    rng = np.random.default_rng(seed)
    rand_masks, onehots = [], []
    for _ in range(n_images):
        if with_rand_masks:
            rand_masks.append(
                rng.uniform(size=(sample_size, grid_size, grid_size)).astype(np.float32))
        subsets = np.stack([rng.choice(grid_size * grid_size, size=subset_size, replace=False)
                            for _ in range(sample_size)])
        onehot = np.zeros((sample_size, grid_size * grid_size), dtype=np.float32)
        np.put_along_axis(onehot, subsets, 1.0, axis=1)
        onehots.append(onehot)
    if with_rand_masks:
        g2 = grid_size * grid_size
        fused = upload(np.stack([np.stack(rand_masks).reshape(n_images, sample_size, g2),
                                 np.stack(onehots)], axis=1), device)
        out = (fused[:, 0].reshape(n_images, sample_size, grid_size, grid_size), fused[:, 1])
    else:
        out = upload(np.stack(onehots), device)
    cache[key] = out
    return out


def _image_expl(expl, i: int):
    """Image ``i``'s explanation: one tensor, or a tuple of them (1D)."""
    return tuple(e[i] for e in expl) if isinstance(expl, tuple) else expl[i]


def batched_auc_runner(inputs_fn, model_fn, images_per_chunk: int, return_logits: bool = False,
                       fan_chunk: int | None = None, fan_dtype: str = "f32", mesh=None,
                       data_axis: str = "data", donate: bool | None = None,
                       aot_key: str | None = None):
    """Insertion/deletion over an image batch in one fan step.

    ``inputs_fn(x_s, expl_s) -> (M, ...)`` builds one image's perturbation
    fan (masks included). ``images_per_chunk`` images' fans run as one model
    call (cut into ``fan_chunk``-row calls when one fan exceeds the cap);
    each image's class probability along its fan stays on the device. The
    step returns ONE (B, 1 + M) tensor, column 0 the AUC and columns 1: the
    curve, or with ``return_logits`` the (B, M, K) logits. ``fan_dtype``
    wraps the forward in the precision boundary (`fan.cast_model_fn`), so
    softmax and AUC run in float32. ``mesh`` splits the images over
    ``data_axis`` (`fan.make_sharded_runner`). ``donate`` releases the
    images and explanations after the call (`fan.fan_runner`: on the card
    only by default); ``aot_key`` runs the step through the compiled-step
    cache (single device only)."""
    forward = cast_model_fn(make_chunked_forward(model_fn, fan_chunk), fan_dtype)

    def body(xb, explb, yb):
        out = []
        for start in range(0, xb.shape[0], images_per_chunk):
            stop = min(start + images_per_chunk, xb.shape[0])
            fans = [inputs_fn(xb[i], _image_expl(explb, i)) for i in range(start, stop)]
            m = fans[0].shape[0]
            logits = forward(fans[0] if len(fans) == 1 else torch.cat(fans))
            logits = logits.reshape(stop - start, m, -1)
            if return_logits:
                out.append(logits)
            else:
                lab = yb[start:stop].reshape(-1, 1, 1).expand(-1, m, 1)
                out.append(softmax_probs(logits).gather(2, lab)[..., 0])
        out = torch.cat(out)
        if return_logits:
            return out
        return torch.cat([compute_auc(out)[:, None], out], dim=1)

    return fan_runner(body, mesh=mesh, data_axis=data_axis, donate=donate,
                      donate_argnums=(0, 1), aot_key=aot_key)


def run_cached_auc(cache: dict, key_extra, inputs_fn, model_fn, batch_size, n_iter: int,
                   x, expl, y, return_logits: bool = False, mesh=None, data_axis: str = "data",
                   donate: bool | None = None, aot_key: str | None = None):
    """Memoized `batched_auc_runner` call shared by the evaluators.

    ``batch_size`` is a `FanPlan` or an int cap (geometry by the cap // fan
    law). The call ends in EXACTLY ONE `fan.device_fetch`: the [score |
    curve] array, or the logits on the ``return_logits`` path. Returns
    (scores, curves) as host lists, or the list of per-image logits.
    ``mesh`` / ``data_axis``: the evaluator's, for `batched_auc_runner`.
    ``donate`` / ``aot_key`` go there too, with ``x`` / ``expl`` passed
    through `donation_safe` so caller-held and instance-cached tensors
    survive the release; the AOT key is the reference's: the caller's key,
    the runner's cache key and the synthesis impl."""
    if isinstance(batch_size, FanPlan):
        plan = batch_size
    else:
        plan = FanPlan(batch_size, *fan_chunk_geometry(batch_size, n_iter + 1))
    key = (n_iter, return_logits, tuple(x.shape[1:]), key_extra, plan.images_per_chunk,
           plan.fan_chunk, plan.fan_dtype)
    runner = cache.get(key)
    if runner is None:
        if aot_key is not None:
            # the caller's key names model + params; the runner-cache key the
            # metric mode and fan geometry the body bakes in; the synth tag
            # the synthesis impl the fan's reconstructions run
            from wam_tpu_torch.wavelets.transform import resolved_synth2_impl

            aot_key = f"{aot_key}|auc|{key!r}|synth-{resolved_synth2_impl(x.device)}"
        runner = batched_auc_runner(inputs_fn, model_fn, plan.images_per_chunk, return_logits,
                                    plan.fan_chunk, plan.fan_dtype, mesh, data_axis, donate,
                                    aot_key)
        cache[key] = runner
    if mesh is None and resolve_donate(donate):
        x, expl = donation_safe((x, expl), True)
    out = run_fan(runner, (x, expl, upload(y, x.device).long()))
    if return_logits:
        return list(out)
    return [float(v) for v in out[:, 0]], list(out[:, 1:])
