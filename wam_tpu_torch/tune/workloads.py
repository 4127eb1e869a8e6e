"""Autotune workload presets: each builds candidate runners for `autotune`
(PyTorch port of `wam_tpu.tune.workloads`).

A `Workload` bundles the cache-key identity (workload / shape / batch /
dtype), the candidate list, the device, and ``build(candidate)``, which
returns a ``(fn, args)`` runner with the candidate's knobs as EXPLICIT
values: a runner never resolves "auto", so the sweep cannot read the entry
it is about to write. Models come from seeded torch inits (never a
download) and are built at the first ``build``, so listing a preset's
candidates costs nothing.

Presets (the reference's geometries and candidate lists; the port's
``"kernel"`` impl is the reference's ``"pallas"``):

- ``toy`` — a tiny haar geometry over a toy conv model, seconds on the
  CPU: the ``--dry-run`` smoke.
- ``flagship`` — the north-star: ResNet-50 (1000 classes) bound in bfloat16
  with ``fold_bn``, 32 x 3x224², db4 J=3 reflect, n=25, σ-spread 0.25, the
  noisy input rounded to bfloat16 at the transform (``dwt_bf16``). It
  sweeps chunks at 128/256/512 rows and every sample at once (800 rows),
  stream_noise on/off, an ``nchw`` layout probe and the synthesis A/B. The
  default layout is channel-last (``nhwc``), as the reference's bench runs
  it: there the transforms are `wavelets.nhwc`'s einsums and no kernel
  launches, so the synthesis candidates' knob is inert on that layout (they
  are measured all the same, as the reference measures them). The ``nchw``
  probe is where K1 (three analysis levels a chunk, bfloat16 in) and K3
  (the collapsed synthesis, forward and backward: two a chunk) run.
- ``mu2d`` / ``fan2d`` — the μ-fidelity and insertion fans of `Eval2DWAM`
  on ResNet-50 at 224², sweeping the fan cap, the images a chunk and the
  bf16 fan.
- ``mel1d`` — the mel front end at the audio geometry (8 x 220,500
  samples, matmul STFT), float32 against the bf16 mel chain.
- ``wamvit2d`` — patch-aligned ViT WAM (a tiny ViT, patch 8 on 64²: J=3).
- ``wamvid3d`` — video WAM over a toy 3D conv.
- ``wamseq1d`` / ``wamseq2d`` — `parallel.SeqShardedWam` over the largest
  power-of-two mesh of the device's kind, chunk x fused/split and the
  anytime stride.
- ``wamlive`` — synthesized from a ledger-mined `tune.mix.WorkloadMix`
  (`tune.online`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from wam_tpu_torch.tune.autotuner import Candidate, chunk_candidates

__all__ = ["Workload", "WORKLOADS", "get_workload"]


@dataclasses.dataclass
class Workload:
    name: str
    workload: str  # cache-key workload field ("wam2d", "eval2d", ...)
    shape: tuple  # per-item shape (cache-key field)
    batch: int
    items: int  # items a runner call (the throughput denominator)
    candidates: list
    build: Callable[[Candidate], tuple[Callable, tuple]]
    dtype: str = "f32"
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cpu"))


def _device(device) -> torch.device:
    """The preset's device: the card for None (`device.resolve_device`,
    which raises when none is visible), else the one asked for."""
    from wam_tpu_torch.device import resolve_device

    return resolve_device(device)


def _synth(cand: Candidate, dev: torch.device) -> str:
    """The candidate's synthesis impl. With none, the impl "auto" takes on
    ``dev`` (the kernels on the card; off it the analysis impl's pair),
    pinned so that an entry already in the table never feeds the sweep."""
    if cand.synth_impl is not None:
        return cand.synth_impl
    if dev.type == "cuda":
        return "kernel"
    from wam_tpu_torch.wavelets.transform import resolved_dwt2_impl

    return "conv" if (cand.dwt_impl or resolved_dwt2_impl(dev)) == "conv" else "matmul"


def _wam2d_runner(model_fn, x, y, cand: Candidate, dev, *, wavelet: str, J: int,
                  n_samples: int, dwt_bf16: bool = False, model_layout: str = "nchw",
                  seed: int = 42):
    """The `WaveletAttribution2D` SmoothGrad call the candidate schedules
    (σ-spread 0.25), on the caller's NCHW ``x``: its chunk, noise mode,
    analysis and synthesis impls given as explicit values, so the call
    reads nothing from the schedule table."""
    from wam_tpu_torch.wam2d import WaveletAttribution2D

    ex = WaveletAttribution2D(model_fn, wavelet=wavelet, J=J, mode="reflect",
                              n_samples=n_samples, stdev_spread=0.25, random_seed=seed,
                              sample_batch_size=cand.sample_chunk,
                              stream_noise=bool(cand.stream_noise), dwt_bf16=dwt_bf16,
                              model_layout=model_layout, device=dev, impl=cand.dwt_impl,
                              synth_impl=_synth(cand, dev))
    return (lambda x: ex._smooth(x, y)), (x,)


def _toy_workload(n_samples: int = 8, batch: int = 4, size: int = 32, device=None) -> Workload:
    """A toy conv model under the flagship's runner, at a geometry whose
    whole sweep takes seconds on the CPU."""
    from wam_tpu_torch.models.toy import toy_conv_model

    dev = _device(device)
    model = toy_conv_model(ndim=2, device=dev)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((batch, size, size), generator=g).to(dev)
    y = (torch.arange(batch) % 4).to(dev)

    def build(cand: Candidate):
        # one channel axis in front of the images, as the explainer takes them
        return _wam2d_runner(lambda v: model(v[:, 0]), x[:, None], y, cand, dev,
                             wavelet="haar", J=2, n_samples=n_samples)

    chunks = chunk_candidates(batch, n_samples, targets=(8, 16))
    cands = [Candidate(sample_chunk=c, stream_noise=False) for c in chunks]
    cands.append(Candidate(sample_chunk=chunks[0], stream_noise=True))
    # the synthesis probe (matmul; the kernel probe is the flagship's)
    cands.append(Candidate(sample_chunk=chunks[0], stream_noise=False, synth_impl="matmul"))
    return Workload(name="toy", workload="wam2d_toy", shape=(size, size), batch=batch,
                    items=batch, candidates=cands, build=build, device=dev)


def _resnet50_fn(dev, *, nchw: bool = True, compute_dtype=None, fold_bn: bool = True,
                 seed: int = 0):
    """ResNet-50 (1000 classes) from a seeded init, bound for attribution."""
    from wam_tpu_torch.models.resnet import bind_inference, resnet50

    torch.manual_seed(seed)
    return bind_inference(resnet50(num_classes=1000), nchw=nchw, compute_dtype=compute_dtype,
                          fold_bn=fold_bn, device=dev)


def flagship_candidates(batch: int = 32, n_samples: int = 25) -> list[Candidate]:
    chunks = chunk_candidates(batch, n_samples)  # 128/256/512 rows + every sample
    cands = [Candidate(sample_chunk=c, stream_noise=True) for c in chunks]
    cands.append(Candidate(sample_chunk=chunks[0], stream_noise=False))
    cands.append(Candidate(sample_chunk=chunks[0], stream_noise=True, layout="nchw"))
    # the synthesis A/B at the first chunk: the kernels against the banded products
    cands.append(Candidate(sample_chunk=chunks[0], stream_noise=True, synth_impl="kernel"))
    cands.append(Candidate(sample_chunk=chunks[0], stream_noise=True, synth_impl="matmul"))
    return cands


def _flagship_workload(n_samples: int = 25, batch: int = 32, image: int = 224,
                       device=None) -> Workload:
    """The flagship (module docstring): candidates of `flagship_candidates`."""
    dev = _device(device)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((batch, 3, image, image), generator=g).to(dev)
    y = (torch.arange(batch) % 1000).to(dev)
    bound: dict[bool, Callable] = {}

    def build(cand: Candidate):
        nchw = cand.layout == "nchw"
        if nchw not in bound:
            bound[nchw] = _resnet50_fn(dev, nchw=nchw, compute_dtype=torch.bfloat16)
        return _wam2d_runner(bound[nchw], x, y, cand, dev, wavelet="db4", J=3,
                             n_samples=n_samples, dwt_bf16=True,
                             model_layout="nchw" if nchw else "nhwc")

    return Workload(name="flagship", workload="wam2d", shape=(3, image, image), batch=batch,
                    items=batch, candidates=flagship_candidates(batch, n_samples), build=build,
                    dtype="bf16", device=dev)


def _explicit_plan(cand: Candidate, fan: int):
    """Candidate knobs -> an explicit `FanPlan` (never "auto")."""
    from wam_tpu_torch.evalsuite.fan import FanPlan, fan_chunk_geometry

    cap = int(cand.fan_cap)
    images_per_chunk, fan_chunk = fan_chunk_geometry(cap, fan)
    if cand.fan_chunk:
        images_per_chunk, fan_chunk = max(1, int(cand.fan_chunk)), None
    return FanPlan(cap, images_per_chunk, fan_chunk, cand.fan_dtype or "f32")


def _eval_model(bound: dict, dt: str, dev):
    """One ResNet-50 a fan dtype (a bf16 candidate runs a bf16-bound model)."""
    if dt not in bound:
        bound[dt] = _resnet50_fn(dev, compute_dtype=None if dt == "f32" else torch.bfloat16)
    return bound[dt]


def mu2d_candidates() -> list[Candidate]:
    cands = [Candidate(fan_cap=c) for c in (64, 128, 256, 512)]
    cands += [Candidate(fan_cap=256, fan_chunk=1), Candidate(fan_cap=256, fan_chunk=4)]
    cands.append(Candidate(fan_cap=256, fan_dtype="bf16"))
    return cands


def _mu2d_workload(n_images: int = 4, image: int = 224, grid_size: int = 28,
                   sample_size: int = 128, subset_size: int = 157, device=None) -> Workload:
    """The μ-fidelity fan runner of `Eval2DWAM` at grid 28, 128 subsets of
    157 cells, on fixed random mosaics (the explainer is outside the timed
    region). The winner's ``fan_cap`` / ``fan_chunk`` / ``fan_dtype`` are
    what ``Eval2DWAM(batch_size="auto")`` resolves (`evalsuite.fan.plan_fan`)."""
    from wam_tpu_torch.evalsuite.eval2d import Eval2DWAM
    from wam_tpu_torch.evalsuite.metrics import mu_fidelity_draws

    dev = _device(device)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((n_images, 3, image, image), generator=g).to(dev)
    wams = torch.rand((n_images, image, image), generator=g).to(dev)
    y = (torch.arange(n_images) % 1000).to(dev)
    bound: dict[str, Callable] = {}

    def build(cand: Candidate):
        dt = cand.fan_dtype or "f32"
        ev = Eval2DWAM(_eval_model(bound, dt, dev), lambda xx, yy: wams,
                       batch_size=int(cand.fan_cap), device=dev)
        rand_all, onehot_all = mu_fidelity_draws(
            {}, ev.random_seed, n_images, grid_size, sample_size, subset_size,
            with_rand_masks=True, device=dev)
        runner = ev._make_mu_runner(grid_size, sample_size, _explicit_plan(cand, sample_size))
        return runner, (x, wams, y, rand_all, onehot_all)

    return Workload(name="mu2d", workload="eval2d", shape=(sample_size,), batch=sample_size,
                    items=n_images, candidates=mu2d_candidates(), build=build, device=dev)


def fan2d_candidates() -> list[Candidate]:
    cands = [Candidate(fan_cap=c) for c in (128, 256, 512)]
    cands += [Candidate(fan_cap=256, fan_chunk=1), Candidate(fan_cap=512, fan_chunk=4)]
    cands.append(Candidate(fan_cap=256, fan_dtype="bf16"))
    return cands


def _fan2d_workload(n_images: int = 8, image: int = 224, n_iter: int = 64,
                    device=None) -> Workload:
    """The insertion fan of `Eval2DWAM` (n_iter + 1 rows an image), under the
    (n_iter + 1)-row eval2d key every AUC metric resolves."""
    from wam_tpu_torch.evalsuite.eval2d import Eval2DWAM
    from wam_tpu_torch.evalsuite.fan import fan_runner
    from wam_tpu_torch.evalsuite.metrics import batched_auc_runner

    dev = _device(device)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((n_images, 3, image, image), generator=g).to(dev)
    wams = torch.rand((n_images, image, image), generator=g).to(dev)
    y = (torch.arange(n_images) % 1000).to(dev)
    bound: dict[str, Callable] = {}

    def build(cand: Candidate):
        dt = cand.fan_dtype or "f32"
        fn = _eval_model(bound, dt, dev)
        ev = Eval2DWAM(fn, lambda xx, yy: wams, batch_size=int(cand.fan_cap), device=dev)
        plan = _explicit_plan(cand, n_iter + 1)
        body = batched_auc_runner(
            lambda img, wam: ev._perturb_for_auc(img, wam, "insertion", n_iter), fn,
            plan.images_per_chunk, fan_chunk=plan.fan_chunk, fan_dtype=plan.fan_dtype)
        return fan_runner(body), (x, wams, y)

    return Workload(name="fan2d", workload="eval2d", shape=(n_iter + 1,), batch=n_iter + 1,
                    items=n_images, candidates=fan2d_candidates(), build=build, device=dev)


def _mel1d_workload(batch: int = 8, n: int = 220500, device=None) -> Workload:
    """The mel front end at the audio geometry (matmul STFT): float32
    against the bf16 mel chain (`ops.melspec.melspectrogram(bf16=True)`)."""
    from wam_tpu_torch.ops.melspec import melspectrogram

    dev = _device(device)
    x = torch.randn((batch, n), generator=torch.Generator().manual_seed(1)).to(dev)

    def build(cand: Candidate):
        bf = bool(cand.mel_bf16)
        return (lambda v: melspectrogram(v, impl="matmul", bf16=bf)), (x,)

    cands = [Candidate(mel_bf16=False), Candidate(mel_bf16=True)]
    return Workload(name="mel1d", workload="mel1d", shape=(n,), batch=batch, items=batch,
                    candidates=cands, build=build, device=dev)


def _seq_mesh(dev):
    """The largest power-of-two ("data",) mesh (at most 8) of the device's
    kind: the cards visible, or one CPU block."""
    from wam_tpu_torch.parallel.mesh import make_mesh

    if dev.type == "cuda":
        count = torch.cuda.device_count()
        n = 1
        while n * 2 <= count and n < 8:
            n *= 2
        return make_mesh({"data": n}, [torch.device("cuda", i) for i in range(n)])
    return make_mesh({"data": 1}, ["cpu"])


def seq_candidates(chunks=(1, 2, None), strides=(2, 4)) -> list[Candidate]:
    """The seq sweep: chunk ladder x fused / split, plus the anytime stride
    ladder on the fused path (one sample a step)."""
    cands = [Candidate(sample_chunk=c, seq_fused=f) for f in (True, False) for c in chunks]
    cands += [Candidate(sample_chunk=1, seq_fused=True, anytime_stride=k) for k in strides]
    return cands


def _seq_runner(sw, x, y, n_samples: int, cand: Candidate):
    if cand.anytime_stride is not None:
        def run(x):
            out, _ = sw.smoothgrad_checkpointed(x, y, 42, n_samples=n_samples, stdev_spread=0.25,
                                                stride=cand.anytime_stride)
            return out
    else:
        def run(x):
            return sw.smoothgrad(x, y, 42, n_samples=n_samples, stdev_spread=0.25,
                                 sample_chunk=cand.sample_chunk)
    return run, (x,)


def _wamseq1d_workload(n_samples: int = 4, batch: int = 2, length: int = 2048,
                       device=None) -> Workload:
    """1D SmoothGrad over the sequence-sharded estimator; the winner
    persists under the ``wamseq1d`` key `SeqShardedWam` resolves "auto"
    from."""
    from wam_tpu_torch.models.audio import toy_wave_model
    from wam_tpu_torch.parallel.seq_estimators import SeqShardedWam

    dev = _device(device)
    mesh = _seq_mesh(dev)
    model = toy_wave_model(device=dev)
    x = torch.randn((batch, length), generator=torch.Generator().manual_seed(1)).to(dev)
    y = (torch.arange(batch) % 4).to(dev)

    def build(cand: Candidate):
        sw = SeqShardedWam(mesh, model, ndim=1, wavelet="db2", level=2, mode="symmetric",
                           fused=bool(cand.seq_fused))
        return _seq_runner(sw, x, y, n_samples, cand)

    return Workload(name="wamseq1d", workload="wamseq1d", shape=(length,), batch=batch,
                    items=batch, candidates=seq_candidates(), build=build, device=dev)


def _wamseq2d_workload(n_samples: int = 4, batch: int = 2, rows: int = 64, cols: int = 32,
                       device=None) -> Workload:
    """2D row-sharded SmoothGrad over a linear model, the seq sweep."""
    from wam_tpu_torch.parallel.seq_estimators import SeqShardedWam

    dev = _device(device)
    mesh = _seq_mesh(dev)
    g = torch.Generator().manual_seed(0)
    w = torch.randn((5, 3, rows, cols), generator=g).to(dev)
    x = torch.randn((batch, 3, rows, cols), generator=g).to(dev)
    y = (torch.arange(batch) % 5).to(dev)

    def model(xx):  # (B, C, H, W) -> (B, 5)
        return torch.einsum("bchw,kchw->bk", xx, w)

    def build(cand: Candidate):
        sw = SeqShardedWam(mesh, model, ndim=2, wavelet="db2", level=2, mode="reflect",
                           fused=bool(cand.seq_fused))
        return _seq_runner(sw, x, y, n_samples, cand)

    return Workload(name="wamseq2d", workload="wamseq2d", shape=(3, rows, cols), batch=batch,
                    items=batch, candidates=seq_candidates(), build=build, device=dev)


def wamvit2d_candidates(batch: int = 4, n_samples: int = 8) -> list[Candidate]:
    chunks = chunk_candidates(batch, n_samples, targets=(8, 16))
    cands = [Candidate(sample_chunk=c, stream_noise=False) for c in chunks]
    cands.append(Candidate(sample_chunk=chunks[0], stream_noise=True))
    cands.append(Candidate(sample_chunk=chunks[0], stream_noise=False, layout="nchw"))
    cands.append(Candidate(sample_chunk=chunks[0], stream_noise=False, synth_impl="matmul"))
    return cands


def _wamvit2d_workload(n_samples: int = 8, batch: int = 4, image: int = 64, patch: int = 8,
                       device=None) -> Workload:
    """Patch-aligned ViT WAM (the planner's J for image / patch) on a tiny
    seeded ViT: the default candidates feed it channel-last input, the
    ``nchw`` probe NCHW."""
    from wam_tpu_torch.models.vit import ViT
    from wam_tpu_torch.xattr.planner import plan_patch_levels

    dev = _device(device)
    plan = plan_patch_levels(image, patch)
    torch.manual_seed(0)
    model = ViT(num_classes=8, patch=patch, dim=32, depth=2, heads=2, mlp_hidden=64,
                image_size=image).to(dev).eval()
    x = torch.randn((batch, 3, image, image), generator=torch.Generator().manual_seed(1)).to(dev)
    y = (torch.arange(batch) % 8).to(dev)

    def build(cand: Candidate):
        nchw = cand.layout == "nchw"
        model_fn = model if nchw else (lambda xx: model(xx.permute(0, 3, 1, 2)))
        return _wam2d_runner(model_fn, x, y, cand, dev, wavelet="haar", J=plan.J,
                             n_samples=n_samples, model_layout="nchw" if nchw else "nhwc")

    return Workload(name="wamvit2d", workload="wam2d", shape=(3, image, image), batch=batch,
                    items=batch, candidates=wamvit2d_candidates(batch, n_samples), build=build,
                    device=dev)


def wamlive_candidates(dom_batch: int, n_samples: int = 8) -> list[Candidate]:
    chunks = chunk_candidates(dom_batch, n_samples, targets=(8, 16))
    cands = [Candidate(sample_chunk=c, stream_noise=False) for c in chunks]
    cands.append(Candidate(sample_chunk=chunks[0], stream_noise=True))
    return cands


def _wamlive_workload(mix=None, n_samples: int = 8, top_n: int = 3, total_reps: int = 4,
                      device=None) -> Workload:
    """The live mix's dominant buckets as toy-conv SmoothGrad bodies at the
    observed geometry (item side from the bucket's last dim, clamped to
    [8, 64]; batch from the mean real rows a dispatch, clamped to [1, 8]),
    each repeated in proportion to its served items inside one runner.
    Every draw is seeded by the bucket's rank in the mix, so one mix always
    builds the same runner."""
    if mix is None:
        raise ValueError(
            "wamlive synthesizes its preset from an observed mix: pass "
            "mix=<WorkloadMix> (wam_tpu_torch.tune.mix.mine_ledger)")
    from wam_tpu_torch.models.toy import toy_conv_model

    dev = _device(device)
    weights = mix.weights()
    specs = []  # (size, batch, weight) per dominant bucket, heaviest first
    for b in mix.dominant(top_n):
        size = int(b.shape[-1]) if b.shape else 16
        size = max(8, min(64, size))
        batch = max(1, min(8, int(round(b.mean_batch)) or 1))
        specs.append((size, batch, weights.get(b.key, 0.0)))
    wsum = sum(w for _, _, w in specs) or 1.0
    reps = [max(1, int(round(total_reps * w / wsum))) for _, _, w in specs]
    dom_size, dom_batch, _ = specs[0]
    model = toy_conv_model(ndim=2, device=dev)
    inputs = []
    for rank, (size, batch, _w) in enumerate(specs):
        x = torch.randn((batch, size, size), generator=torch.Generator().manual_seed(rank + 1))
        inputs.append((x.to(dev)[:, None], (torch.arange(batch) % 4).to(dev)))

    def build(cand: Candidate):
        runs = [(_wam2d_runner(lambda v: model(v[:, 0]), x, y, cand, dev, wavelet="haar", J=2,
                               n_samples=n_samples, seed=42 + i)[0], x, r)
                for i, ((x, y), r) in enumerate(zip(inputs, reps))]

        def run():
            # weight-proportional repeats, reduced to one scalar
            total = torch.zeros((), device=dev)
            for fn, x, r in runs:
                for _ in range(r):
                    total = total + fn(x).abs().sum()
            return total

        return run, ()

    items = sum(b * r for (_s, b, _w), r in zip(specs, reps))
    return Workload(name="wamlive", workload="wamlive", shape=(dom_size, dom_size),
                    batch=dom_batch, items=items,
                    candidates=wamlive_candidates(dom_batch, n_samples), build=build, device=dev)


def wamvid3d_candidates(batch: int = 2, n_samples: int = 8) -> list[Candidate]:
    chunks = chunk_candidates(batch, n_samples, targets=(4, 8))
    cands = [Candidate(sample_chunk=c, stream_noise=False) for c in chunks]
    cands.append(Candidate(sample_chunk=chunks[0], stream_noise=True))
    cands.append(Candidate(sample_chunk=chunks[0], stream_noise=False, synth_impl="matmul"))
    return cands


def _wamvid3d_workload(n_samples: int = 8, batch: int = 2, frames: int = 8, size: int = 16,
                       device=None) -> Workload:
    """Video WAM (levels (2, 1): two spatial levels, one temporal) over a
    toy 3D conv: the `WaveletAttributionVideo` SmoothGrad call with the
    candidate's chunk, noise mode and synthesis of the spatial-only level
    as explicit values. Winners persist under the ``wamvid3d`` key
    `WaveletAttributionVideo(sample_batch_size="auto")` resolves."""
    from wam_tpu_torch.models.toy import toy_conv_model
    from wam_tpu_torch.xattr.video import WaveletAttributionVideo

    dev = _device(device)
    toy = toy_conv_model(ndim=3, classes=4, device=dev)
    x = torch.randn((batch, 1, frames, size, size),
                    generator=torch.Generator().manual_seed(1)).to(dev)
    y = (torch.arange(batch) % 4).to(dev)

    def build(cand: Candidate):
        ex = WaveletAttributionVideo(lambda clip: toy(clip[:, 0]), wavelet="haar", levels=(2, 1),
                                     mode="symmetric", n_samples=n_samples, stdev_spread=1e-4,
                                     random_seed=42, sample_batch_size=cand.sample_chunk,
                                     stream_noise=bool(cand.stream_noise), device=dev,
                                     synth_impl=_synth(cand, dev))
        return (lambda x: ex._smooth(x, y)), (x,)

    return Workload(name="wamvid3d", workload="wamvid3d", shape=(1, frames, size, size),
                    batch=batch, items=batch, candidates=wamvid3d_candidates(batch, n_samples),
                    build=build, device=dev)


WORKLOADS: dict[str, Callable[..., Workload]] = {
    "toy": _toy_workload,
    "flagship": _flagship_workload,
    "mu2d": _mu2d_workload,
    "fan2d": _fan2d_workload,
    "mel1d": _mel1d_workload,
    "wamlive": _wamlive_workload,
    "wamvit2d": _wamvit2d_workload,
    "wamvid3d": _wamvid3d_workload,
    "wamseq1d": _wamseq1d_workload,
    "wamseq2d": _wamseq2d_workload,
}


def get_workload(name: str, **overrides) -> Workload:
    """The preset ``name`` (``overrides``: its geometry, and ``device``: the
    card by default, RuntimeError when none is visible; ``"cpu"`` runs it
    on the CPU)."""
    if name not in WORKLOADS:
        raise ValueError(f"unknown workload {name!r}; have {sorted(WORKLOADS)}")
    return WORKLOADS[name](**overrides)
