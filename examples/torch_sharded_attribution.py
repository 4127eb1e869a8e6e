"""Multi-device attribution on the PyTorch port: the SmoothGrad estimator
split over a ('data', 'sample') mesh, or the sequence-sharded 1D loop.

Runs anywhere: without --virtual the mesh takes every visible card (the CPU
with --device cpu); with --virtual N it lays N blocks on the one device, the
same mesh mechanics as N devices (the blocks run in turn), so the sharding
can be exercised on one card or a laptop.

    python examples/torch_sharded_attribution.py --virtual 8          # on the card
    python examples/torch_sharded_attribution.py --virtual 8 --spmd --device cpu
    python examples/torch_sharded_attribution.py --virtual 4 --long-context 16384

--spmd uses `sharded_smoothgrad_spmd`: each block computes only its
(sample, data) rows, with the mosaic normalized per block. The default
propagation form keeps the single-device semantics (the step sees the whole
batch; the data axis does not split it).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--virtual", type=int, default=0,
                        help="lay an N-block mesh on the one device")
    parser.add_argument("--device", default="auto",
                        help="auto (the CUDA card, or an error without one), cuda[:i] or cpu")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--samples", type=int, default=16)
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--wavelet", default="db4")
    parser.add_argument("--levels", type=int, default=3)
    parser.add_argument("--spmd", action="store_true",
                        help="use the block-local sharded_smoothgrad_spmd estimator")
    parser.add_argument("--long-context", type=int, default=0, metavar="N",
                        help="instead of the 2D estimator, run the sequence-sharded 1D "
                             "attribution loop on an N-sample waveform (N divisible by "
                             "blocks*2^levels)")
    parser.add_argument("--boundary", default="periodization",
                        help="boundary mode for --long-context: periodization (ring wrap, "
                             "default) or an expansive mode (symmetric/reflect/zero) through "
                             "the core+tail path")
    parser.add_argument("--class-api", action="store_true",
                        help="with --long-context: run SeqShardedWam SmoothGrad (the class "
                             "path) instead of the raw gradient core")
    args = parser.parse_args(argv)

    import torch

    from wam_tpu_torch.core.engine import WamEngine, map_coeffs
    from wam_tpu_torch.device import resolve_device
    from wam_tpu_torch.models import bind_inference, resnet18
    from wam_tpu_torch.ops.packing2d import mosaic2d
    from wam_tpu_torch.parallel import (
        data_sample_mesh,
        init_distributed,
        make_mesh,
        sharded_smoothgrad,
        sharded_smoothgrad_spmd,
    )
    from wam_tpu_torch.parallel.mesh import visible_devices
    from wam_tpu_torch.parallel.tree import tree_leaves

    device = resolve_device(args.device)
    if args.virtual:
        devices = [device] * args.virtual
    else:
        devices = visible_devices(None) if device.type == "cuda" else [device]
    info = init_distributed(device=device)
    mesh = data_sample_mesh(devices=devices)
    print(f"processes: {info['process_count']}  blocks: {len(devices)} on "
          f"{sorted({str(d) for d in devices})}  mesh: {dict(mesh.shape)}")
    g = torch.Generator().manual_seed(1)

    if args.long_context:
        # long context: the waveform's sequence axis is sharded through the
        # transforms (ring halo), the gradient core and the accumulators
        from wam_tpu_torch.models.audio import toy_wave_model
        from wam_tpu_torch.parallel import (
            SeqShardedWam,
            sharded_coeff_grads_mode,
            sharded_coeff_grads_per,
        )

        seq_mesh = make_mesh({"data": len(devices)}, devices)
        wf = torch.randn((args.batch, args.long_context), generator=g).to(device)
        model = toy_wave_model(seed=2, device=device)
        y = torch.arange(args.batch, device=device) % 4
        if args.class_api:
            sw = SeqShardedWam(seq_mesh, model, ndim=1, wavelet=args.wavelet,
                               level=args.levels, mode=args.boundary)
            grads = sw.smoothgrad(wf, y, 5, n_samples=4, stdev_spread=0.1)
        else:
            if args.boundary == "periodization":
                step = sharded_coeff_grads_per(seq_mesh, args.wavelet, args.levels, model)
            else:
                step = sharded_coeff_grads_mode(seq_mesh, args.wavelet, args.levels, model,
                                                args.boundary)
            grads = step(wf, y)
        leaves = tree_leaves(grads)
        shown = [tuple(t.shape) for t in leaves[:4]]
        more = "..." if len(leaves) > 4 else ""
        what = "class-level SmoothGrad" if args.class_api else "coefficient gradients"
        print(f"long-context {what} ({args.boundary}): {shown}{more}, computed over "
              f"{len(devices)} sequence blocks")
        return 0

    with torch.random.fork_rng(devices=[]):  # a seeded init, the caller's stream kept
        torch.manual_seed(0)
        model = resnet18(num_classes=10)
    model_fn = bind_inference(model, nchw=True, device=device)
    engine = WamEngine(model_fn, ndim=2, wavelet=args.wavelet, level=args.levels,
                       mode="reflect")
    y = torch.arange(args.batch, device=device) % 10
    x = torch.randn((args.batch, 3, args.size, args.size), generator=g).to(device)
    spatial = (args.size, args.size)

    def grads_of(noisy, y_rows, scale: float, normalize: bool):
        """A stack (s, b, C, H, W) of noisy rows -> (s, b, S, S) mosaics:
        one decomposition and one backward for the whole stack."""
        s = noisy.shape[0]
        flat = noisy.reshape((-1,) + tuple(noisy.shape[2:]))
        with torch.no_grad():
            coeffs = engine.decompose(flat)
        grads = engine.grads_from_coeffs(coeffs, y_rows.repeat(s), spatial, samples=s)
        return mosaic2d(map_coeffs(lambda t: (t * scale).reshape((s, -1) + tuple(t.shape[1:])),
                                   grads), normalize)

    if args.spmd:
        runner = sharded_smoothgrad_spmd(
            lambda noisy, y_l, grad_scale: grads_of(noisy, y_l, grad_scale, False), mesh,
            n_samples=args.samples, stdev_spread=0.25)
        mosaic = runner(x, y, generator=torch.Generator(device=device).manual_seed(42))
    else:
        runner = sharded_smoothgrad(lambda noisy: grads_of(noisy, y, 1.0, True), mesh,
                                    n_samples=args.samples, stdev_spread=0.25)
        mosaic = runner(x, generator=torch.Generator(device=device).manual_seed(42))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"attribution mosaics: {tuple(mosaic.shape)}, computed over {len(devices)} blocks "
          f"of mesh {dict(mesh.shape)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
