#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port, `wam_tpu_torch`.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (Hopper,
sm_90a). Phases, each fatal on failure:

1. device: the card's name and power limit (nvidia-smi);
2. build:  every kernel, compiled from ``wam_tpu_torch/csrc`` by nvcc (one
   process per source, all at once), with ptxas's report of K1, K2 and K3;
   then the preflight, `wam_tpu_torch.env_check`'s checks once (the core
   packages, the device line, a 32^2 db2 J=2 attribution through K1/K3);
3. kernels: each kernel against its plain PyTorch version at the shapes
   each path that runs it gives it, TF32 off, and timed with CUDA events:
   K1 and K3 at the flagship's, at path 2's and at the ViT path's (haar),
   K2 (both directions) and K4/K5 at path 2's, K4/K5 also at the vol
   path's 17 ReLU shapes (128 rows, float32), K1 and K3 (forward only, on
   leaves that are views of the masked packed array of one image's 65 and
   128 masks) at the eval2d path's, K1 and K3 (forward, 4 and 20 masks) at
   the analyzers path's, K1 and K3 (forward and backward, 25 path points)
   at the iou path's under each of its four wavelets, K1 and K3 (forward
   and backward, haar J=2) on one pod worker's batch of 8 requests x 25
   samples x 3 planes at 224^2; one line per kernel and path, each case
   and line
   with its bound and bound_share (bound / kernel time). K1-K3 launch
   with their band plans (K3 on the coefficient leaves, views of K1's
   output, forward and every leaf's gradient checked); the plain versions
   and the einsum yardstick use the dense operators. Then the periodized
   transforms (no kernel: a strided conv1d and its transpose): wavedec2_per
   and waverec2_per (db4, J=3) on 32 images of 3x224^2, the card against
   the CPU in float64 (coefficients, gradient, round trip within 1e-9 x
   max), no port kernel launched (asserted), and a float32 forward and
   backward timed;
4. slice:  the flagship path, `WaveletAttribution2D` SmoothGrad on
   ResNet-50 (1000 classes, seeded random weights) at batch 32, 3x224x224,
   db4, J=3, reflect, n_samples=25, stdev_spread=0.25, sample_batch_size=4,
   with launch counts reset just before and read just after (K1 and K3
   must have run); then a reduced run (2 images, 2 samples) of the kernel
   path against the same call on the plain versions;
5. slice2: path 2, the same call at 3x288x288 on ResNet-50 bound with
   ``fused_relu_vjp=True``, where the finest synthesis level runs through K2
   and every ReLU through K4/K5 (all five kernels must have run, at least as
   often as the path needs); the same call with ``fused_relu_vjp=False``,
   timed; and the reduced check at 288², kernel path with the fused ReLU
   against plain path without it;
6. audio:  the audio path, `WaveletAttribution1D` SmoothGrad on the ESC-50
   AudioCNN (50 classes, seeded random weights and BatchNorm statistics)
   at 8 waveforms of 220,500 samples (5 s at 44.1 kHz), db6, J=5, reflect,
   n_samples=50, stdev_spread=0.001, sample_batch_size=16 (128 model rows
   a step), mel front end at n_fft 1024, hop 512, 128 mels, in dB: one warm
   call, then CUDA-event times of a few calls (median, spread, waveforms/s,
   peak memory); no port kernel may launch on this path (its transform,
   STFT and model are cuDNN, cuFFT and cuBLAS calls). Beside it, timed and
   printed only: the same call with ``stream_noise=True`` and with the
   model in bfloat16 (its mel-attribution cosine to float32). Then the
   reduced check: the port on the card against the port on the CPU (2
   waveforms of 65,536 samples, 2 samples, noise handed over, TF32 off),
   cosine and max abs error on the mel attribution and every coefficient
   level, in float32 through `WaveletAttribution1D` and in float64 through
   its engine;
7. vit: the ViT path (`BASELINE.json`'s config #5, as
   ``bench_workloads.vit_workload`` defines it): `WaveletAttribution2D`
   Integrated Gradients on ViT-B/16 (1000 classes, seeded weights drawn as
   the reference's initialisers draw them) bound with ``bind_inference(
   nchw=True)``, one 3x224x224 image, haar, J=3, reflect, 64 path points,
   sample_batch_size=16. The matmul and convolution precision is set and
   printed for each arm: the headline with TF32 on (matmuls and
   convolutions), a second float32 arm with TF32 off; one call with the
   launch counts set to 0 just before and read just after (K1 3, K3 8,
   K2/K4/K5 0, asserted), then CUDA-event times of 5 calls (median, spread,
   attributions/s, host enqueue time, peak memory). Timed beside it: the
   model in bfloat16 (its mosaic cosine to the float32 TF32-off result, no
   gate).
   Then the reduced check: the kernel path against the plain path on the
   same model, one image, 4 path points, TF32 off (cosine >= 0.99999, max
   abs <= 1e-4 x the plain result's max);
8. convnext: the same call on ConvNeXt-T (1000 classes): launch counts as
   for the ViT, median of 3 calls, peak memory, and the same reduced check;
9. vol: the 3D path (`BASELINE.json`'s config #4, as
   ``bench_workloads.vol_workload`` defines it): `WaveletAttribution3D`
   SmoothGrad on the 3D ResNet-18 (10 classes, width 16, seeded weights
   drawn as the reference's initialisers draw them, BatchNorm statistics
   from one train-mode pass over two seeded volumes) bound with
   ``bind_inference``, 8 volumes of 1x32^3, haar, J=2, symmetric,
   n_samples=25, stdev_spread=1e-4, sample_batch_size=16 (128 model rows a
   step). TF32 on for the model (set and printed); the transform always
   in full float32. One call with the launch counts set to 0 just before
   and read just after (all 0, asserted), then CUDA-event times of 5 calls
   (median, spread, volumes/s, host enqueue time, peak memory). Arms, timed
   and printed: IG with 25 path points; the synthesis3_mm synthesis
   (``impl="kernel"``; the default is conv_transpose3d); the model bound
   with ``fold_bn=True, fused_relu_vjp=True``, where K4 and K5 launch at
   the 17 ReLU sites once a chunk (34 each a call, asserted), with its cube
   cosine to the headline. `waverec3` on both synthesis forms at the
   headline's shapes, forward and backward, timed in turns. Then the
   checks: the fused model (without fold_bn) against the plain one on the
   card, cuDNN deterministic (cosine >= 0.999999, max abs <= 1e-6 x max),
   and the port on the card against the port on the CPU (2 volumes of
   16^3, 2 samples, noise handed over, TF32 off) in float32 through the
   class (cosine >= 0.99999, max abs <= 1e-4 x max) and in float64 through
   its engine (cosine >= 0.9999999, max abs <= 1e-9 x max);
10. voxel3d: the reference's own 3D models: `VoxelModel` (10 classes) on 32
   volumes of 16^3 (3D-MNIST), `WaveletAttribution3D` SmoothGrad (haar,
   J=2, symmetric, n_samples=25, chunk 4) timed over 3 calls, then
   `visualize`, one pass and `filter_voxels`; `PointNetCls` (k=10) on 32
   clouds of 2,500 points with `BaseWAM3D(instance="point_clouds")` (haar,
   J=3, symmetric), 3 timed passes and `filter_point_clouds`; no port
   kernel may launch (asserted); then card against CPU in float64 (the
   voxel model's coefficient gradients on 4 volumes of 16^3, PointNet's on
   2 clouds of 256 points; cosine >= 0.9999999, max abs <= 1e-9 x max);
11. eval2d: the evaluation of 2D attributions at scripts/bench_eval.py's
   full geometry: `Eval2DWAM` (haar, J=3, 128 rows a model call) on
   ResNet-50 (1000 classes, seeded weights) bound in bfloat16 with fold_bn,
   8 images of 3x224^2, explanations from `WaveletAttribution2D` (haar,
   J=3, 8 SmoothGrad samples, streamed noise) computed once; insertion and
   deletion (n_iter 64: 520 model rows a call) and μ-fidelity (28 x 28
   grid, 128 subsets of 157 cells: 2,056 rows), each a warm call, a counted
   call (K1 24 and K3 8, or 16 for μ, the others 0; exactly one result
   fetch and one host wait on the device, by torch's sync debug mode: all
   asserted) and 3 CUDA-event-timed calls (median, spread, images/s, rows/s,
   host enqueue time to the fetch, peak memory); then the reduced check:
   the kernel path against the plain path (impl="matmul") on 2 images with
   the mosaics handed to both, ResNet-50 in float32, TF32 off (scores,
   curves and μ values within EVAL_TOL);
12. eval1d: `Eval1DWAM` (db6, J=5, 32 rows a model call) on the audio
   phase's AudioCNN, 4 waveforms of 220,500 samples, explanations from
   `WaveletAttribution1D` SmoothGrad (8 samples) computed once; insertion
   on the wavelet target (n_iter 64) and input fidelity, counted (no port
   kernel, one fetch, one host wait: asserted) and timed as in eval2d; then
   the port on the card against the port on the CPU (2 waveforms of 65,536
   samples, seeded explanations handed to both, TF32 off) in float32
   through the class (probabilities and AUCs within 1e-4, input fidelity's
   classes equal) and in float64 through one waveform's fan step and the
   model's scores on it (within 1e-9 x max);
13. baselines: the baseline methods and their evaluators. The image
   registry at scripts/bench_methods.py's geometry: `EvalImageBaselines`
   on ResNet-50 (1000 classes, seeded weights) in bfloat16, 64 rows a model
   call, 8 path points or noisy copies, 4 images of 3x224^2, each of the
   nine methods (saliency, integratedgrad, smoothgrad, gradcam, gradcampp,
   layercam, guided_backprop, gradxinput, lrp): one warm explanation, one
   with its host waits counted, 3 CUDA-event-timed (median, spread, host
   enqueue, peak memory), then insertion at n_iter 32, counted (no port
   kernel, one fetch, one host wait: asserted) and timed as in eval2d;
   rollout and attngrad must raise ValueError on ResNet-50 (they need a ViT
   built with capture_attn=True: phase attention).
   Saliency against WAM at equal precision (bench_eval.py:185-193):
   insertion (n_iter 64) and μ-fidelity on the eval2d phase's 8 images.
   Audio: `EvalAudioBaselines` (saliency, integratedgrad, smoothgrad,
   gradcam on out3) on the eval1d phase's AudioCNN and the mels of its 4
   waveforms, each with insertion (n_iter 64), faithfulness of spectra and
   input fidelity, counted and timed. The stem conv plain and
   space-to-depth (``stem_s2d``), forward plus input gradient at 32 x 3 x
   224^2, float32 and bfloat16, timed in turns and not gated. No port
   kernel launches over the phase (asserted). Then the reduced check: the
   card against the CPU, TF32 off, on 2 images of 64^2 through a seeded
   ResNet-18 (saliency, IG, gradcam, gradcampp, guided backprop, LRP) and 2
   of the audio mels (saliency, IG, gradcam): float64 through
   the methods within 1e-9 x max, float32 through the evaluators within
   BASE_F32_TOL, insertion on a handed-over map within 1e-5;
14. nhwc: the flagship's call (phase slice's model weights, batch, labels
   and precision) with ``WaveletAttribution2D(model_layout="nhwc")`` on the
   same ResNet-50 bound with ``bind_inference(nchw=False)``, bench.py's
   layout: the NCHW and NHWC arms in turns (nchw, nhwc, nhwc, nchw), each a
   counted call (NHWC: K1-K5 0; NCHW: K1 21, K3 14; asserted) and 5
   CUDA-event-timed calls (median, spread, attributions/s, host enqueue,
   peak memory); one chunk's transforms in both layouts and the input's
   layout copy, timed; then the reduced check (2 images x 2 samples, noise
   handed over, TF32 off): the two layouts' transforms (leaves,
   reconstruction, leaf gradients; NCHW on K1/K3) within 1e-5 x max, the
   whole call in float64 (NCHW on the plain transforms) within 1e-9 x max,
   and in float32 against the NCHW kernel path at cosine >= 0.99999 and max
   abs <= 2e-2 x max (ReLU gates at zero flip between the layouts, as
   between phase slice's kernel and plain paths);
15. analyzers: `WAMAnalyzer2D` (haar, J=3) on the flagship's ResNet-50 in
   float32 (TF32 on), 8 images of 3x224^2 labelled with the model's own
   classes, explainer `WaveletAttribution2D` SmoothGrad (n=25) computed once
   by ``precompute`` (counted and event-timed); `isolate_scales` (EPS 0.1)
   and `isolate_necessary_components` (20 quantiles 0.95..0 for insertion,
   reversed for deletion), each a warm call, a counted call (K1 24, K3 8,
   the others 0; host waits 0 for isolate_scales, one an image for the
   sweeps, by torch's sync debug mode; all asserted) and 3 event-timed
   calls; then the reduced check: kernel path against impl="matmul" on 2
   images with the mosaics handed to both, TF32 off (partial images and kept
   reconstructions within 1e-5 x max; masks, kept masks, indices and
   recorded quantiles equal);
16. iou: the fork's cross-wavelet IoU experiment at
   examples/iou_experiment.py's defaults: ConvNeXt-T (1000 classes) from
   `data.build_vision_model`, the script's 5 synthetic 224^2 images (its
   own copy), WAM-IG (J=3, 25 path points) under haar, db4, sym4 and sym8:
   one explanation per wavelet counted (K1 3, K3 2; asserted) and 3
   event-timed; the whole experiment on the host clock (its launches
   asserted), peak memory, the 10 mean IoUs over p = 0.05..0.50 and the
   provenance "synthetic-sines+random-init"; then the reduced check: image
   0's maps on the kernel path against impl="matmul", TF32 off (each map
   within 1e-5 x max, the IoUs equal);
17. patch: bench_workloads.vit_patch_workload's geometry: the vit phase's
   call with ``level_plan="patch", patch=16, image_size=224`` (J=4): the
   TF32 headline with one call's launches asserted (K1 4, K3 8, the rest
   0) and 5 event-timed calls, the TF32-off arm, `WAMAnalyzerViT.token_maps`
   ((1, 4, 14, 14), asserted), and the reduced check (kernel vs
   impl="matmul", 4 path points, TF32 off, the vit phase's bounds);
18. attention: `EvalImageBaselines` rollout and attngrad on ViT-B/16 built
   with ``capture_attn=True`` (the vit phase's weights), 4 x 3x224^2, 64
   rows a model call: each explanation counted and 3 event-timed, insertion
   and deletion (n_iter 32) counted (no port kernel, one fetch, one host
   wait: asserted) and timed as in eval2d; then the logits of the capture
   form against the SDPA form (TF32 off, within 1e-5 x max) and both maps
   of one image on the card against the CPU in float64 (within 1e-9 x max);
19. video: bench_workloads.video_workload's full row: `WaveletAttributionVideo`
   SmoothGrad on the 3D ResNet-18 (10 classes, seeded, calibrated) at 4
   clips of 1x16x32^2, haar, levels (2, 1), symmetric, n=25 in one chunk
   ("auto"): one call's launches asserted (K1 2, K2 1) and 5 event-timed
   calls, the IG arm (25 points, the same launches, 3 calls); `EvalVideoWAM`
   insertion and deletion (n_iter 16) on the headline's frame scores,
   counted (launches 0, one fetch, one host wait: asserted) and timed; the
   reduced check, the card against the CPU (2 clips x 2 samples, noise
   handed over, TF32 off): float32 through the kernels (cosine >= 0.99999,
   max abs <= 1e-2 x max: a gate flip), float64 on the conv route (<= 1e-9
   x max);
20. anytime: the flagship's explainer through ``anytime_serve_entry(
   stride=5)`` and `anytime.run_anytime`: a counted full run (5 strides,
   complete, one fetch, K1 75 and K3 50: asserted), 3 runs timed by CUDA
   events with each stride's host time and its wait on the confidence
   vector, peak memory; the full map against the streamed smooth_wam on
   the same draws (one sample a chunk: cosine >= 0.999999, max abs <= 1e-5
   x max); a deadline run at 2.5 strides (deadline hit, fewer than 25
   samples: asserted), its confidence vector printed per row. The kernels
   phase holds K1/K3 at the patch plan's and the anytime step's shapes and
   K1/K2 at the video's; each ``kernels`` row carries every path's launches;
21. serve: README.md's server, ``AttributionServer(wam.serve_entry(),
   [(3, 224, 224), (3, 256, 256)], max_batch=8)``, over the flagship's
   explainer (ResNet-50, db4, J=3, n=25 in one call: 200 model rows a
   batch): both buckets warmed (one first call each, asserted, none after:
   `obs.assert_no_retrace`), then 64 seeded requests (shapes round-robin
   over 224², 256², 220², 250², one in four interactive) from 4 client
   threads with 4 requests in flight each, through the pipelined and the
   unpipelined arm: launch counts set to 0 just before the stream and read
   just after, every batch's launches asserted (224²: K1 3, K3 2; 256²: K1
   4, K2 1, K3 2), zero lost requests, ``degraded`` false, every served
   mosaic against its batch's output (exact) and against the entry run
   again on the same assembled batch (<= 1e-5 x max); requests/s, p50/p99,
   EMA batch service per bucket, host assemble + stage, the device's idle
   share between batches (CUDA events around each batch) and peak memory
   printed. Then a QueueFullError with its retry_after_s, a
   DeadlineExceededError, an InvalidDeadlineError and a result-cache hit
   with no kernel launched; the ``with_health=True`` entry's vector against
   `health_stats` of the fetched mosaic; the anytime server on the 224²
   bucket (a full batch against the streamed serve_entry on the same batch
   within 1e-5 x max, a deadline at half its time: n_used < 25); and the
   served path in float64 (ResNet-18, 32², IG) against the CPU within 1e-9
   x max. The kernels phase holds K1/K3 (and K2 at 256²) at a served
   batch's 600 planes;
22. parallel: the flagship (TF32 off, normalize=False) through
   `parallel.sharded_smoothgrad_spmd` over ``make_mesh({"data": 2,
   "sample": 5}, ["cuda"] * 10)``: ten blocks of 5 samples x 16 images (80
   model rows), run one after another on the one card; a warm call, a
   counted one (K1 30, K3 20: asserted) and 3 event-timed (median, host
   enqueue, peak memory), then with TF32 convolutions in turns with the
   flagship's single-device call (the same 800 rows), held to the single-device `smoothgrad` on the
   same noise at the blocks' model-call shapes (each data half alone, 5
   samples a call) within 1e-5 x max; `sharded_smoothgrad` (the step on
   the whole batch, one block a sample shard: K1 15, K3 10) against
   `smoothgrad` at its shapes; `sharded_integrated_path` with 16 path
   points over {data 2, sample 4} (K1 6, K3 16) against `integrated_path`
   at the blocks' shapes; a one-rank NCCL group (`init_distributed`): the
   spmd runner on ``hybrid_mesh({"data": 2, "sample": 5}, ["cuda"] * 10)``
   through its all_reduce branch equal to the one-process mesh (the
   flagship's 32 images and 25 samples, cuDNN deterministic); `Eval2DWAM(mesh=make_mesh({"data": 2}, ...))`
   insertion at the eval2d phase's geometry (launches as there, one fetch,
   AUCs and curves within EVAL_TOL of the mesh-less call, both timed in
   turns); and the float64 check, the spmd runner on the card against the
   CPU (ResNet-18, 2 x 32², db4 J=2, plain transforms) within 1e-9 x max.
   The kernels phase holds K1/K3 at a block's 240 planes and at the IG
   block's shapes;
23. fleet: the serve phase's server as `FleetServer(devices=["cuda"] * 2,
   supervise=True)` over the flagship's explainer, each replica's entry
   from ``lambda rid, m, dev: wam_on(dev).serve_entry(on_trace=m.note_compile)``
   (the explainer of the replica's device) behind
   a recorder and a `testing.faults` injector: one first call a bucket a
   replica at warmup (asserted), the serve phase's 32 requests from 4
   clients (zero lost, both replicas serving, launches the sum of the
   batches' SERVE_LAUNCHES, served rows against the entry on the same batch
   within 1e-5 x max; requests/s, batch fill, p50/p99, peak memory of two
   replicas on one card), and a second fleet under 8 clients x 4 in flight
   (64 requests: full batches); an oversize `attribute_batch` of 16 images through "pjit"
   (8 rows a replica, each replica's oversize entry on its own device; the
   entry's `RowBlocks` draw each block's rows of the 16-row batch's noise,
   scale its loss to 16 rows and normalize over all 16, so the whole batch
   is held to the entry on all 16 within 1e-5 x max with cuDNN off, whose
   algorithm otherwise changes with a call's row count; a row-wise entry on
   the same route gathers each replica's rows exactly); one `ChaosFault` on
   replica 1: zero lost, ``replica_restart`` rows restarting -> alive, the
   rebuilt replica serves again, its first calls at its warmup; and
   `NoLiveReplicaError` from an unsupervised fleet whose replicas all die;
24. seq: sequence-sharded attribution (`parallel.SeqShardedWam` under the
   explainers' ``mesh=``) on meshes that name the card once a block, no
   port kernel (K1-K5 0 on every counted call: the sharded transforms are
   cuDNN convolutions), each arm one counted call (its halo elements
   printed) and 3 CUDA-event-timed calls (median, host enqueue, peak
   memory), then held to the single-device explainer on the same noise at
   equal model-call shapes (2 samples, one a call, TF32 off) within
   SEQ_TOL, and in float64 at a reduced size (the card against the CPU,
   seq against single, within 1e-9 x max): seq1d, the audio phase's
   AudioCNN at 8 x 220,160 samples (every level's core divides 2 x 4), db6
   J=5, n=50 over {data: 4}; seq2d, the flagship's rows over {data: 4} (n=25
   chunk 4, IG 16 points, ``smoothgrad_checkpointed`` at stride 5 bit-equal
   to one sample a step), the one-rank NCCL group (no distributed call,
   equal to the one-process mesh) and a two-replica `FleetServer` serving
   224² items above its one bucket through ``seq_factory`` (equal to the
   entry); seq3d, the vol phase's volumes, depth over {data: 4}, haar n=25
   (no halo) and db2 n=5; video, the video phase's clips, time over {data:
   2}, haar levels (2, 2), n=25.
25. tune: the autotuner (`wam_tpu_torch.tune`) on the flagship preset:
   ResNet-50 bound in bfloat16 with fold_bn, 32 x 3x224^2, db4 J=3, n=25,
   the input rounded to bfloat16 at the transform; its eight candidates
   (chunks of 128/256/512 rows and all 800, stream_noise off, an nchw
   probe, the synthesis A/B), each measured by CUDA events (TUNE_K regions
   of TUNE_LAPS calls) with its peak memory, the device plane and its
   K1/K3 launches a call asserted (3 and 2 a sample chunk on the nchw
   probe, 0 channel-last); ``python -m wam_tpu_torch.tune --workload toy
   --dry-run --device cuda``; the winner recorded into a cache file of the
   phase's own and an explainer with ``sample_batch_size="auto"`` resolving
   to its chunk, bit-equal to the explicit call (cuDNN deterministic);
   the phase within TUNE_BUDGET_S. The kernels phase holds K1 (first level
   on bfloat16 input) and K3 at its nchw probe's shapes.
26. aot: cold start through the compiled-step cache (`pipeline.aot`),
   ``python -m wam_tpu_torch.prewarm`` and the artifact registry, in cache
   directories of the phase's own (``WAM_TPU_AOT_CACHE``,
   ``WAM_TPU_CACHE_DIR``, ``TORCHINDUCTOR_CACHE_DIR``, ``TRITON_CACHE_DIR``):
   two fresh processes prewarm the flagship preset (the tune phase's nchw
   runner, each chunk step compiled by Inductor), "exported" then "hit"
   (0 compiles), their warm seconds printed; ``registry publish
   --from-prewarm``, then empty caches: ``inspect`` (the checkout's four
   kernel libraries present or hydratable), ``hydrate`` and a third prewarm:
   "registry_hit", 0 compiles (the bundle: the compiled steps, the kernel
   libraries and the schedules, no compile-cache file). In this process
   the compiled runner (loaded from the cache: 0 compiles after every
   earlier phase) against the eager one: K1 21 and K3 14 each (asserted),
   no fallback, no graph break, the distance (`_distance`) within
   AOT_BF16_TOL, ms a call (CUDA events, median of AOT_CALLS after a warm
   call) and peak GB of both, in turns, and one call of each under
   ``torch.profiler`` by kernel group; then an
   ``AttributionServer(compilation_cache=True)`` over the runner's
   explainer's ``serve_entry(aot_key=)`` (the prewarm's key) serves
   AOT_REQUESTS 224² requests in one batch with ``compile_count == 0``,
   every program a "hit" and the batch's launches as the runner's
   (asserted), its rows within AOT_BF16_TOL of the eager entry on the same
   batch; a float32 ResNet-18 under the same runner, one chunk step
   compiled in this process, within AOT_TOL of eager (cuDNN deterministic,
   TF32 off: `_aot_f32`). Then every custom operator on CUDA tensors at
   its path's shapes (`_aot_operators`: each wrapper's operator branch
   bit-equal to its eager route, forward and backward, the operators
   within KERNEL_RTOL of the plain versions, `torch.library.opcheck`), and
   the host cost of that branch a launch (`_aot_dispatch`), with what it
   would add to a call of the vit, video and eval2d phases. Each kernels
   row carries ``aot_launches``.
27. pod: pod serving (`wam_tpu_torch.pod`) on the card. First the
   workers' entry in this process (the toy `WaveletAttribution2D`, haar
   J=2, n=25, over 3x224^2 items, `pod.worker.toy_wam`) on a batch of
   POD_MAX_BATCH copies of the phase's one seeded request: its rows, its
   launches (POD_LAUNCHES: K1 2 and K3 2 a batch, K2, K4, K5 0; asserted,
   and the same kernels counted in a ``torch.profiler`` capture), its ms a
   batch. Then ``PodRouter(transport="tcp")`` over POD_WORKERS worker
   processes, every one on cuda:0 (``--device cuda:0 --buckets 3x224x224
   --n-samples 25 --max-batch 8``), supervised: each worker's
   spawn-to-ready seconds by part (interpreter and imports, CUDA context,
   kernel libraries, fleet warmup, from the worker's stamps) and its peak
   memory; POD_REQUESTS requests of that item from POD_CLIENTS client
   threads through ``submit_with_retry`` while `testing.PodChaosKiller`
   SIGKILLs a worker at POD_KILLS of the stream: 0 lost, two deaths and two
   respawns (asserted), requests/s, p50/p99, kill to rejoin seconds; every
   answer within POD_TOL (x max) of the in-process entry's rows (the
   batch is copies of the one item: the answer's row is one of them), the
   bit-equal count printed; then POD_THROUGHPUT_REQUESTS requests from
   POD_THROUGHPUT_CLIENTS clients on the two workers and, after a
   ``shrink`` that drains, on one; the workers' own launch counts after
   warmup (reported beside their snapshots): K1 and K3 above 0, K2, K4,
   K5 0 (asserted). Last, a cold join from a wire bundle: this process
   compiles the toy step (``--aot-key-base``'s, at a worker's batch
   signature) under throwaway caches, the compiled step and the kernel
   libraries are published, and a worker
   with empty caches and ``--registry wire`` over tcp is ready at
   ``compile_count == 0`` (asserted), its ready seconds printed, its answer
   within POD_AOT_TOL of the eager rows. Each kernels row carries
   ``pod_launches``.

Prints a summary JSON line (with the script's wall time), the kernels' JSON
line, the nvidia-smi line, and as its last line
``{"ok": true, "device": {...}}``. Exits nonzero, printing no result, when
there is no CUDA device or the port is not beside this script.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

BATCH, CHANNELS, SIDE = 32, 3, 224
SIDE2 = 288               # path 2: timm's resnet50.a1_in1k test size
WAVELET, LEVELS, MODE = "db4", 3, "reflect"
N_SAMPLES, SPREAD = 25, 0.25
SAMPLE_CHUNK = 4          # samples per model call: 4 x 32 = 128 ResNet-50 rows
SEED = 0
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12    # H100 SXM f32 outside the tensor cores
# kernel vs plain: both accumulate float32 in another order; 1e-5 of the
# largest reference value is ~100 float32 ulps of headroom
KERNEL_RTOL = 1e-5

# the audio path: BASELINE.json's config #3, as bench_workloads.py defines it
AUDIO_BATCH, AUDIO_LEN = 8, 220500      # 5 s at 44.1 kHz
AUDIO_WAVELET, AUDIO_LEVELS = "db6", 5
AUDIO_SAMPLES, AUDIO_SPREAD = 50, 0.001
AUDIO_CHUNK = 16                        # samples per model call: 16 x 8 = 128 rows
AUDIO_CLASSES, N_MELS, N_FFT, SAMPLE_RATE = 50, 128, 1024, 44100
AUDIO_CALLS = 5                         # timed calls after the warm one (arms: 3)
# the ViT path: BASELINE.json's config #5, as bench_workloads.py defines it
VIT_SIDE, VIT_WAVELET, VIT_LEVELS, VIT_MODE = 224, "haar", 3, "reflect"
VIT_STEPS, VIT_CHUNK = 64, 16           # 64 path points, 16 a model call
VIT_CALLS, CONVNEXT_CALLS = 5, 3        # timed calls after the counted one
VIT_REDUCED_STEPS = 4
# reduced check bound (cosine, max abs / max): only K1's and K3's summation
# order differs between the two paths, and the models have no ReLU gate
VIT_TOL = (0.99999, 1e-4)
# reduced check: waveforms, samples (the shortest length whose 129 frames
# survive the AudioCNN's six pools), n_samples; (cosine, max abs / max)
# bounds in float32 (measured, see _audio_reduced_check) and in float64
AUDIO_REDUCED = (2, 65536, 2)
AUDIO_TOL = {"float32": (0.999, 1e-1), "float64": (0.9999999, 1e-9)}
# the vol path: BASELINE.json's config #4, as bench_workloads.vol_workload defines it
VOL_BATCH, VOL_SIDE, VOL_CLASSES, VOL_WIDTH = 8, 32, 10, 16
VOL_WAVELET, VOL_LEVELS, VOL_MODE = "haar", 2, "symmetric"
VOL_SAMPLES, VOL_SPREAD = 25, 1e-4
VOL_CHUNK = 16                          # samples per model call: 16 x 8 = 128 rows
VOL_CALLS = 5                           # timed calls after the counted one (arms: 3)
VOL_SITES = 17                          # ReLUs of the 3D ResNet-18: the stem's, 2 a block
VOL_FUSED_LAUNCHES = {"dwt2": 0, "synth2": 0, "pair": 0,
                      "relu_fwd": VOL_SITES * -(-VOL_SAMPLES // VOL_CHUNK),
                      "relu_bwd": VOL_SITES * -(-VOL_SAMPLES // VOL_CHUNK)}
# reduced checks: volumes, side, samples; (cosine, max abs / max) bounds of
# the card against the CPU and of the fused arm against the plain model on
# the card. float32 measured 7.6e-7 and 8.2e-7 of the max at cosine 1 - 1e-10
# (no ReLU gate flipped; H100 80GB HBM3, 700 W): the bound leaves ~100x of
# headroom
VOL_REDUCED = (2, 16, 2)
VOL_TOL = {"float32": (0.99999, 1e-4), "float64": (0.9999999, 1e-9)}
VOL_FUSED_TOL = (0.999999, 1e-6)
# the voxel3d phase: the reference's VoxelModel on 3D-MNIST-sized grids, and
# PointNetCls on clouds of the PointNet reference's 2,500 points
VOXEL_BATCH, VOXEL_SIDE, VOXEL_CHUNK, VOXEL_CALLS = 32, 16, 4, 3
CLOUD_BATCH, CLOUD_POINTS, CLOUD_LEVELS = 32, 2500, 3
CLOUD_REDUCED = (2, 256)
ZERO_LAUNCHES = {"dwt2": 0, "synth2": 0, "pair": 0, "relu_fwd": 0, "relu_bwd": 0}
# the eval2d phase: scripts/bench_eval.py's full geometry (its lines 58-80, 134-149)
EVAL_BATCH, EVAL_SIDE, EVAL_CLASSES = 8, 224, 1000
EVAL_WAVELET, EVAL_LEVELS = "haar", 3
EVAL_EXPLAIN_SAMPLES = 8                # the explainer's SmoothGrad samples, streamed noise
EVAL_CAP, EVAL_N_ITER = 128, 64         # model rows a call; insertion/deletion steps
MU_GRID, MU_SAMPLES, MU_SUBSET = 28, 128, 157
EVAL_CALLS = 3                          # timed calls per metric after the counted one
EVAL_METRICS = ("insertion", "deletion", "mu_fidelity")
# model rows a metric call: the image fans, and μ's baseline forward
EVAL_ROWS = {"insertion": EVAL_BATCH * (EVAL_N_ITER + 1),
             "deletion": EVAL_BATCH * (EVAL_N_ITER + 1),
             "mu_fidelity": EVAL_BATCH * (1 + 2 * MU_SAMPLES)}
# one metric call's launches: K1 at each image's 3 analysis levels (one
# decomposition an image), K3 forward once a reconstruction family (one an
# image for insertion and deletion, two for μ); nothing else
EVAL_LAUNCHES = {m: {**ZERO_LAUNCHES, "dwt2": EVAL_LEVELS * EVAL_BATCH,
                     "pair": (2 if m == "mu_fidelity" else 1) * EVAL_BATCH}
                 for m in EVAL_METRICS}
# reduced check, kernel path against plain path on EVAL_REDUCED images, a
# float32 model, TF32 off: max abs error of the AUCs, of the curves (over the
# largest probability) and of the μ values. The two paths differ only in the
# summation order of K1 and K3 (~1e-7 relative); a swap of two adjacent
# ranks of 128 moves a Spearman value by 12 / (128 (128^2 - 1)) = 5.7e-6
EVAL_REDUCED = 2
EVAL_TOL = {"auc": 1e-5, "curve": 1e-5, "mu": 1e-4}
# the eval1d phase: bench_eval.py's lines 204-222
EVAL1D_BATCH, EVAL1D_SAMPLES, EVAL1D_CHUNK, EVAL1D_CAP = 4, 8, 8, 32
EVAL1D_METRICS = ("insertion", "input_fidelity")
EVAL1D_ROWS = {"insertion": EVAL1D_BATCH * (EVAL_N_ITER + 1), "input_fidelity": EVAL1D_BATCH * 3}
# reduced check, the card against the CPU: waveforms, samples, steps; max abs
# error of probabilities and AUCs in float32 through `Eval1DWAM`, and of the
# fan's mel spectrograms and scores in float64 (over their largest value).
# float32 measured 4.4e-6 on the AUCs and 1.9e-7 on the probabilities (H100
# 80GB HBM3, 700 W): the AudioCNN's convolutions sum in another order on
# each device; the bound leaves ~20x of headroom
EVAL1D_REDUCED = (2, 65536, 8)
EVAL1D_TOL = {"float32": 1e-4, "float64": 1e-9}
# the baselines phase: the image registry at scripts/bench_methods.py's
# geometry (lines 31-62), ResNet-50 in bfloat16, b4 x 3 x 224^2
BASE_BATCH, BASE_CAP, BASE_SAMPLES, BASE_N_ITER, BASE_CALLS = 4, 64, 8, 32, 3
BASE_METHODS = ("saliency", "integratedgrad", "smoothgrad", "gradcam", "gradcampp", "layercam",
                "guided_backprop", "gradxinput", "lrp")
BASE_ATTENTION = ("rollout", "attngrad")  # on a ViT built with capture_attn: phase attention
# saliency against WAM at equal precision (bench_eval.py:185-193): the eval2d
# phase's 8 images, insertion at n_iter 64 and μ, 128 rows a model call
BASE_WAM_ROWS = {"insertion": EVAL_BATCH * (EVAL_N_ITER + 1),
                 "mu_fidelity": EVAL_BATCH * (1 + MU_SAMPLES)}
# audio: the eval1d phase's AudioCNN on the mels of its 4 waveforms
BASE_AUDIO_METHODS = ("saliency", "integratedgrad", "smoothgrad", "gradcam")
BASE_AUDIO_METRICS = ("insertion", "faithfulness_of_spectra", "input_fidelity")
BASE_STEM_BATCH, BASE_STEM_CALLS = 32, 10
# reduced check, the card against the CPU, TF32 off: 2 images of 64^2 through a
# seeded ResNet-18 (10 classes) and 2 of the audio mels; float64 through the
# methods on float64 models (<= 1e-9 x max), float32 through the evaluators
# at a bound per method over the largest CPU value, and insertion (the CPU's
# map handed to both) within 1e-5. Each float32 bound is ~10x the largest of
# three runs on the card (H100 80GB HBM3, 700 W), measured in the comment
# beside it; audio IG's 2.5e-3 is an AudioCNN ReLU gate that flips between
# the devices, and its float64 check (4e-15) holds the method itself
BASE_REDUCED = (2, 64, 4, 16)  # images, side, IG / SmoothGrad samples, insertion steps
BASE_REDUCED_FRAMES = 257      # the audio mels cut to 257 frames: out3 is a 3 x 1 grid
BASE_REDUCED_METHODS = ("saliency", "integratedgrad", "gradcam", "gradcampp",
                        "guided_backprop", "lrp")
BASE_REDUCED_AUDIO = ("saliency", "integratedgrad", "gradcam")  # AUDIO_METHODS' but smoothgrad
BASE_F32_TOL = {"image": {"saliency": 4e-6,          # 3.675e-7
                          "integratedgrad": 7e-6,    # 7.045e-7
                          "gradcam": 4e-5,           # 4.120e-6
                          "gradcampp": 5e-6,         # 4.508e-7
                          "guided_backprop": 4e-6,   # 3.636e-7
                          "lrp": 1.2e-5},            # 1.237e-6
                "audio": {"saliency": 1.4e-5,        # 1.381e-6
                          "integratedgrad": 2.5e-2,  # 2.457e-3, a gate flip
                          "gradcam": 3e-4}}          # 2.983e-5
BASE_TOL = {"float64": 1e-9, "auc": 1e-5}
# the periodized check (in phase kernels): wavedec2_per / waverec2_per on
# PER_BATCH images of 3 x 224^2, the card against the CPU in float64
PER_BATCH, PER_WAVELET, PER_LEVELS, PER_TOL = 32, "db4", 3, 1e-9
# the nhwc phase: the flagship's call with model_layout="nhwc" on ResNet-50
# bound with bind_inference(nchw=False), bench.py's layout (its lines 184-198)
NHWC_CALLS = 5                          # timed calls after the counted one, each arm
NHWC_REDUCED = (2, 2)                   # images, samples
# reduced check bounds: the transforms of the two layouts (the same operators
# contracted in another order) within 1e-5 x max; the whole call in float64
# (cosine, max abs / max) to 1e-9; in float32 the two layouts' convolutions
# and transforms round differently and flip ReLU gates that sit at zero:
# measured 1.395e-3 at a max of 0.785 (1.8e-3 of the max) at cosine
# 0.99999997 (H100 80GB HBM3, 700 W), so the float32 bound is ~10x that
NHWC_TOL = {"transforms": 1e-5, "float64": (0.9999999, 1e-9), "float32": (0.99999, 2e-2)}
# the analyzers phase: WAMAnalyzer2D on the flagship's ResNet-50 (float32)
AN_BATCH, AN_WAVELET, AN_LEVELS, AN_SAMPLES = 8, "haar", 3, 25
AN_EPS, AN_QUANTILES, AN_CALLS = 0.1, 20, 3  # EPS; np.linspace(0.95, 0, 20) and reversed
# one analyzer call's launches: K1 at each image's 3 analysis levels, K3
# forward once an image (its mask family: J + 1 masks, or the quantiles)
AN_LAUNCHES = {**ZERO_LAUNCHES, "dwt2": AN_LEVELS * AN_BATCH, "pair": AN_BATCH}
# host waits of one call: none for isolate_scales, one an image (its class
# probabilities) for the quantile sweeps
AN_SYNCS = {"isolate_scales": 0, "insertion": AN_BATCH, "deletion": AN_BATCH}
AN_REDUCED, AN_TOL = 2, 1e-5
# the iou phase: examples/iou_experiment.py's defaults (its lines 47-58, 107-125)
IOU_IMAGES, IOU_SIDE, IOU_LEVELS, IOU_STEPS = 5, 224, 3, 25
IOU_WAVELETS = ("haar", "db4", "sym4", "sym8")
IOU_PS = (0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4, 0.45, 0.5)
IOU_CALLS = 3                           # timed explanations per wavelet
# one explanation: K1 at its 3 analysis levels, K3 forward and backward
# (all 25 path points in one chunk; every detail side at 224^2 is < 128)
IOU_LAUNCHES = {**ZERO_LAUNCHES, "dwt2": IOU_LEVELS, "pair": 2}
IOU_TOL = 1e-5
# the patch phase: bench_workloads.vit_patch_workload's geometry (its lines 68-89):
# the vit phase's call with level_plan="patch", patch 16 at 224^2 -> J = 4
PATCH, PATCH_LEVELS = 16, 4
PATCH_TOKENS = VIT_SIDE // PATCH
# one call: K1 at the 4 analysis levels (once a call), K3 forward and backward
# a chunk of VIT_CHUNK path points (every detail side, 112 to 14, is < 128)
PATCH_LAUNCHES = {**ZERO_LAUNCHES, "dwt2": PATCH_LEVELS, "pair": 2 * (VIT_STEPS // VIT_CHUNK)}
# the attention phase: rollout and attngrad of EvalImageBaselines on ViT-B/16
# (capture_attn=True, the vit phase's weights) at the baselines phase's geometry
ATTN_METHODS = ("rollout", "attngrad")
ATTN_BATCH, ATTN_CAP, ATTN_N_ITER = 4, 64, 32
# logits with capture_attn=True against False (TF32 off), and the card against
# the CPU in float64 for both maps of one image, each over the largest value
ATTN_TOL = {"capture": 1e-5, "float64": 1e-9}
# the video phase: bench_workloads.video_workload's full row (its lines 92-112)
VID_BATCH, VID_FRAMES, VID_SIDE, VID_CLASSES = 4, 16, 32, 10
VID_WAVELET, VID_LEVELS, VID_SAMPLES, VID_CALLS = "haar", (2, 1), 25, 5
VID_N_ITER, VID_CAP = 16, 64            # temporal insertion/deletion steps; rows a call
# one call ("auto": all 25 samples, or IG points, in one chunk): K1 at the
# spatial-only level 2 (8 frames of 16^2 -> 8^2) and as K2's backward, K2 at
# its synthesis; level 1 is 3D (conv3d / conv_transpose3d)
VID_LAUNCHES = {**ZERO_LAUNCHES, "dwt2": 2, "synth2": 1}
VID_PLANES = VID_BATCH * VID_SAMPLES * VID_FRAMES // 2  # level-2 planes of one chunk
# reduced check, the card against the CPU: clips, samples (noise handed over,
# TF32 off); float32 through the kernels, float64 on the conv route (a kernel
# computes float64 input in float32). float32 measured 1.07e-3 of the max at
# cosine 0.99999999 (H100 80GB HBM3, 700 W): a ReLU gate of the 3D ResNet
# within rounding of zero flips between the devices, as the audio path's
# do, so its max abs bound is ~10x that; the float64 check holds the path
VID_REDUCED = (2, 2)
VID_TOL = {"float32": (0.99999, 1e-2), "float64": (0.9999999, 1e-9)}
# the anytime phase: the flagship's explainer through anytime_serve_entry
ANY_STRIDE, ANY_CALLS, ANY_DEADLINE = 5, 3, 2.5  # samples a stride; timed runs; strides
# one run: every sample decomposes (3 K1) and reconstructs (K3 forward and backward)
ANY_LAUNCHES = {**ZERO_LAUNCHES, "dwt2": LEVELS * N_SAMPLES, "pair": 2 * N_SAMPLES}
# against the streamed smooth_wam (one sample a chunk, the same draws): only
# the order of the sample sum differs
ANY_TOL = (0.999999, 1e-5)

# the serve phase: README.md's server (`AttributionServer(wam.serve_entry(),
# [(3, 224, 224), (3, 256, 256)], max_batch=8)`) over the flagship's explainer,
# all 25 samples of a batch in one call (8 x 25 = 200 ResNet-50 rows)
SERVE_BUCKETS = ((CHANNELS, 224, 224), (CHANNELS, 256, 256))
SERVE_MAX_BATCH = 8
SERVE_SHAPES = ((CHANNELS, 224, 224), (CHANNELS, 256, 256), (CHANNELS, 220, 220),
                (CHANNELS, 250, 250))                # request shapes, round-robin
# an arm's requests (two full batches of each bucket); client threads;
# requests each keeps in flight (16 in all: a batch waits behind the one in
# flight and the pipelined worker has the next one to stage)
SERVE_REQUESTS, SERVE_CLIENTS, SERVE_WINDOW = 32, 4, 4
SERVE_ARMS = (True, False)  # pipelined, then not
SERVE_ROWS = SERVE_MAX_BATCH * N_SAMPLES * CHANNELS  # K1 planes / K3 rows of a batch
# a dispatched batch: 224² collapses all three synthesis levels (detail sides
# 115/61/34 < SYNTH_COLLAPSE); 256²'s finest level (131) runs through K2,
# whose backward is one more K1 launch
SERVE_LAUNCHES = {224: {**ZERO_LAUNCHES, "dwt2": LEVELS, "pair": 2},
                  256: {**ZERO_LAUNCHES, "dwt2": LEVELS + 1, "synth2": 1, "pair": 2}}
SERVE_TOL = 1e-5         # a served row against the entry's own output, x max
SERVE_TIMEOUT_S = 300.0  # every future is waited on at most this long
SERVE_ANY_STRIDE = 5
SERVE_REDUCED = (2, 32, 2)  # images, side, IG path points (ResNet-18, J=2, float64)
SERVE_F64_TOL = 1e-9
# the parallel phase: the flagship over a (data, sample) mesh of blocks on the
# one card (no speed-up: the blocks run one after another); each block is one
# decomposition and one backward, K1 LEVELS and K3 2
PAR_MESH = {"data": 2, "sample": 5}       # 10 blocks of 5 samples x 16 images = 80 rows
PAR_BLOCK_PLANES = (N_SAMPLES // 5) * (BATCH // 2) * CHANNELS   # K1 planes / K3 rows a block
PAR_LAUNCHES = {**ZERO_LAUNCHES, "dwt2": LEVELS * 10, "pair": 2 * 10}
PAR_PROP_LAUNCHES = {**ZERO_LAUNCHES, "dwt2": LEVELS * 5, "pair": 2 * 5}  # a block a sample shard
PAR_IG_MESH, PAR_IG_STEPS = {"data": 2, "sample": 4}, 16  # blocks of 4 points x 16 images
PAR_IG_PLANES = (PAR_IG_STEPS // 4) * (BATCH // 2) * CHANNELS
PAR_IG_LAUNCHES = {**ZERO_LAUNCHES, "dwt2": LEVELS * 2, "pair": 2 * 8}  # K1 once a data shard
PAR_CALLS = 3            # event-timed spmd calls after the counted one
PAR_TOL = (0.999999, 1e-5)  # against the single-device estimator: the sample sum's order
PAR_REDUCED = (2, 32, 4)  # images, side, samples (ResNet-18, float64, card against CPU)
PAR_F64_TOL = 1e-9
# the fleet phase: the serve phase's server as a supervised fleet of two
# replicas on the one card
FLEET_REPLICAS = 2
FLEET_OVERSIZE = 16      # an oversize batch: max_batch rows a replica
FLEET_RESTART_TIMEOUT_S = 120.0
# the seq phase: sequence-sharded attribution (parallel.SeqShardedWam) at the
# widths of the audio, flagship, vol and video phases, on a mesh that names
# the one card once a block
SEQ_SHARDS = 4                          # {data: 4}
SEQ_LEN = 220160    # the 5 s clip's 220,500 less 340: each of db6's 5 levels' cores divides 2 x 4
SEQ_CALLS = 3                           # event-timed calls after the counted one
SEQ_IG_STEPS, SEQ_STRIDE = 16, 5        # seq2d's IG path points; its checkpoint stride
SEQ_DB2_SAMPLES = 5                     # seq3d's db2 arm, whose depth exchange haar does not need
SEQ_VID_LEVELS, SEQ_VID_SHARDS = (2, 2), 2  # uniform levels only under mesh=
SEQ_CHECK_SAMPLES = 2   # seq against single at full width: samples, one a model call on both
# float32 bounds (cosine, max abs / max) of seq against single on the same
# noise at equal model-call shapes, TF32 off, ~10x the distance measured on
# an H100 80GB HBM3 (700 W) before they were set: seq1d 1.27e-2 at cosine
# 0.99998372, seq2d 3.58e-3 at 0.99999992, seq3d 1.18e-2 / 1.27e-2 (haar /
# db2) at 0.99999794 / 0.99999829, video 4.71e-3 at 0.99999989. The transforms
# alone differ by ~1e-7 (float64: ~1e-15); a ReLU gate of the model within
# rounding of zero flips between the two routes and moves a few coefficients
# by percents of the max, as between the card and the CPU (audio, video).
SEQ_TOL = {"seq1d": (0.9998, 1.3e-1), "seq2d": (0.999999, 3.6e-2),
           "seq3d": (0.99998, 1.3e-1), "video": (0.999999, 4.7e-2),
           "float64": (0.9999999, 1e-9)}
# the tune phase: the autotuner on the flagship preset (wam_tpu_torch.tune)
TUNE_K, TUNE_LAPS = 3, 1                # timed regions a candidate, calls a region
TUNE_BUDGET_S = 45.0
# the aot phase: cold start through the compiled-step cache on the flagship
# preset prewarm builds (wam_tpu_torch.prewarm)
AOT_CONFIG = "flagship"
AOT_CHUNKS = math.ceil(N_SAMPLES / SAMPLE_CHUNK)
AOT_LAUNCHES = {**ZERO_LAUNCHES, "dwt2": LEVELS * AOT_CHUNKS, "pair": 2 * AOT_CHUNKS}
AOT_CALLS = 5               # event-timed calls of each route after a warm one
AOT_REQUESTS = 16           # served 224^2 requests after the prewarm
AOT_CLASSES = 1000          # the preset's ResNet-50 classes (the requests' labels)
# compiled against eager (`_distance`). AOT_TOL holds the compiled step of a
# float32 model (`_aot_f32`: cuDNN deterministic, TF32 off), where only
# Inductor's summation order differs: measured max 5.267e-3, ||d||/||m||
# 2.467e-4, 8.0e-5 of the elements off by > 1e-3 max (a typical value is
# 6.6e-2 of the max; the same in two runs on an H100 80GB HBM3, 700 W). The
# few elements off are where ReLU gates within rounding of zero flip, as
# between layouts (phase nhwc); a wrong tap, mode or missing chunk moves
# most elements. AOT_BF16_TOL holds the flagship's bf16 model and the
# served rows, whose roundings flip many more gates: measured max 4.052e-2 /
# 3.207e-2 and ||d||/||m|| 2.382e-2 / 2.446e-2 (runner / served rows, 35% /
# 33% of the elements off by > 1e-3 max; the same runs)
AOT_TOL = {"max": 1.5e-2, "rel_l2": 2.5e-3, "off": 1e-3}
AOT_BF16_TOL = {"max": 0.1, "rel_l2": 0.06}
AOT_WAIT_MS = 250.0         # the server's batch window: the 16 requests make one batch
AOT_OP_CALLS = 200          # eager calls of each route in the dispatch measurement
AOT_TIMEOUT_S = 900.0       # a prewarm or registry subprocess at most

# phase pod: the toy entry at the flagship's image side and sample count
POD_WORKERS = 2
POD_DEVICE = "cuda:0"       # every worker on the one card
POD_SIDE = 224
POD_MAX_BATCH = 8
POD_REQUESTS = 64           # the chaos stream: seeded requests
POD_CLIENTS = 4
POD_KILLS = (0.25, 0.6)     # PodChaosKiller's fractions of the stream
POD_THROUGHPUT_REQUESTS = 128   # the clean streams, two workers then one
POD_THROUGHPUT_CLIENTS = 16
POD_LAUNCHES = {**ZERO_LAUNCHES, "dwt2": 2, "pair": 2}  # a batch: haar J=2, one chunk
POD_TOL = 2e-6              # an answer against the in-process entry's row, x max: ~9x the
                            # 2.23e-7 two calls of that entry differ by (cuDNN's default
                            # algorithms, on an H100)
POD_AOT_TOL = 2e-6          # the compiled worker's answer against the eager rows, x max
                            # (the same 2.23e-7 read there)
POD_READY_S = 300.0         # a worker's spawn to hello, at most
POD_BUDGET_S = 150.0


def _log(*args):
    print(*args, flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Milliseconds a call of ``fn()``: CUDA events around ``iters`` warm
    calls after ``warmup`` (`wam_tpu_torch.profiling.device_time_samples`,
    one region of ``iters`` laps)."""
    from wam_tpu_torch.profiling import device_time_samples

    return device_time_samples(fn, k=1, laps=iters, warmup=warmup, device=DEVICE)[0] * 1e3


def _bound_ms(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _product_macs(left, right) -> int:
    """Multiply-adds of left @ right when both skip their zeros:
    sum over k of nnz(left[:, k]) * nnz(right[k, :]) (boolean masks)."""
    import torch

    return int((left.sum(0, dtype=torch.int64) * right.sum(1, dtype=torch.int64)).sum())


def _needed_flops(x, m1t, m2) -> int:
    """FLOP that out[n] = m1t^T . x[n] . m2 needs when it skips the zeros of
    the operators and of x (the wavelet operators are banded or sparse, the
    collapsed synthesis input is block-diagonal), in the cheaper of the two
    association orders. x's zeros are taken as those every image shares."""
    import torch

    a = (m1t != 0).T.cpu()
    xm = (x != 0).any(0).cpu()
    b = (m2 != 0).cpu()
    f64 = torch.float64

    def mask_mm(u, v):
        return (u.to(f64) @ v.to(f64)) > 0

    left_first = _product_macs(a, xm) + _product_macs(mask_mm(a, xm), b)
    right_first = _product_macs(xm, b) + _product_macs(a, mask_mm(xm, b))
    return 2 * x.shape[0] * min(left_first, right_first)


def _dense_flops(x, m1t, m2) -> int:
    """FLOP of the dense products, as the kernels do them (T = M1 . X first)."""
    n, q, s = x.shape
    return 2 * n * m1t.shape[1] * s * (q + m2.shape[1])


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _check(name: str, got, want) -> tuple[float, float]:
    import torch

    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = KERNEL_RTOL * max(1.0, float(want.abs().max()))
    _log(f"  {name}: max_abs_err={err:.3e} tol={tol:.3e}")
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {err:.3e} > {tol:.3e})")
    return err, tol


def _case(torch, label: str, got, want, kernel_fn, plain_fn, product, reads, out_bytes: int,
          library: bool = True, extra=None, flops: int | None = None, **tags) -> dict:
    """One launch shape of a two-sided product kernel (K1-K3): ``got`` held
    against ``want``, then the kernel, its plain version, the einsum of the
    pair on ``product`` = (M1^T, X, M2) as the product sees it (when
    ``library``) and any ``extra`` callables timed. The bound counts the
    tensors in ``reads`` read once and ``out_bytes`` written once, and the
    FLOP the product needs (`_needed_flops`, unless ``flops`` is given)."""
    m1t, x, m2 = product
    err, tol = _check(label, got, want)
    case = {**tags, "max_abs_err": err, "tol": tol, "ms": _time_ms(kernel_fn),
            "plain_ms": _time_ms(plain_fn), "library_ms": None}
    if library:
        lm1t, lm2 = m1t.to(x.dtype), m2.to(x.dtype)  # a bf16 x: bf16 operands, bf16 out
        case["library_ms"] = _time_ms(lambda: torch.einsum("qp,nqs,st->npt", lm1t, x, lm2))
    for key, fn in (extra or {}).items():
        case[key] = _time_ms(fn)
    nbytes = _nbytes(*reads) + out_bytes
    flops, dense = flops or _needed_flops(x, m1t, m2), _dense_flops(x, m1t, m2)
    bound, by = _bound_ms(nbytes, flops)
    case.update(bound_ms=bound, bound_by=by, bound_share=bound / case["ms"], flops=flops,
                dense_flops=dense, bytes=nbytes, dense_bound_ms=_bound_ms(nbytes, dense)[0])
    lib = "" if case["library_ms"] is None else f", einsum {case['library_ms']:.4f}"
    _log(f"  {label}: {case['ms']:.4f} ms (plain {case['plain_ms']:.4f}{lib}, "
         f"bound {bound:.4f} by {by}, bound_share {case['bound_share']:.3f})")
    return case


def _plan_tags(kernels, plan) -> dict:
    """The band plan's shape, as the kernel launches it (K1, K2)."""
    return {"plan": {"rt": plan.rt, "sm": plan.sm, "k": plan.k, "kc": plan.kc,
                     "stages": plan.stages, "cols_shared": plan.cols_shared,
                     "tiles_per_image": plan.ntiles, "smem_bytes": plan.smem_bytes()}}


def _row(kernel: str, name: str, source: str, replaces: str, path: str, cases: list,
         library: str, work: str, main: list | None = None) -> dict:
    """A kernel's line for one path: its cases, and ms / plain_ms /
    library_ms / bound summed over the cases the path launches (``main``;
    by default the float32 ones): one sample chunk's launches of this
    kernel."""
    if main is None:
        main = [c for c in cases if c["dtype"] == "float32"]

    def total(key):
        return sum(c[key] for c in main)

    bound, by = _bound_ms(total("bytes"), total("flops"))
    return {"name": f"{name}, {path}", "kernel": kernel, "path": path, "route": "cuda",
            "source": source, "replaces": replaces, "launches": None,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tol": max(c["tol"] for c in cases), "ms": total("ms"),
            "plain_ms": total("plain_ms"), "bound_ms": bound, "bound_by": by,
            "bound_share": bound / total("ms"),
            "flops": total("flops"), "bytes": total("bytes"),
            "dense_bound_ms": _bound_ms(total("bytes"), total("dense_flops"))[0],
            "library_ms": total("library_ms"), "library": library, "work": work,
            "cases": cases}


def _k1_cases(torch, tmm, kernels, g, side: int, wavelet: str = WAVELET,
              n: int = SAMPLE_CHUNK * BATCH * CHANNELS, levels: int = LEVELS,
              mode: str = MODE) -> list[dict]:
    """K1 at the ``levels`` analysis levels of a side x side path on ``n``
    images, float32 and bfloat16 input; level l reads level l-1's float32
    approximation."""
    dev = torch.device(DEVICE)
    from wam_tpu_torch.wavelets.filters import build_wavelet

    w = build_wavelet(wavelet)
    taps = (tuple(w.dec_lo), tuple(w.dec_hi), mode)
    cases = []
    x = torch.randn((n, side, side), generator=g, device=dev)
    for level in range(1, levels + 1):
        q = x.shape[-1]
        _, At = tmm._kernel_analysis(q, *taps, dev)  # dense: the plain version and einsum
        Bt = At
        plan = tmm.dwt2_band(q, q, *taps, dev)
        out_bytes = n * At.shape[1] * Bt.shape[1] * 4
        for dtype in (torch.float32, torch.bfloat16):
            xin = x.to(dtype).contiguous()
            want = tmm.dwt2_plain(xin, At, Bt)
            f32 = dtype == torch.float32
            cases.append(_case(
                torch, f"K1 {wavelet} {side}^2 level {level} {str(dtype)[6:]}",
                kernels.dwt2(xin, plan),
                want, lambda: kernels.dwt2(xin, plan), lambda: tmm.dwt2_plain(xin, At, Bt),
                (At, xin, Bt), (xin, At, Bt), out_bytes,
                extra={"matmul_pair_ms": lambda: tmm.pair_plain(xin, At, Bt)} if f32 else None,
                part=f"analysis level {level}", dtype=str(dtype)[6:], shape=[n, q, q],
                **_plan_tags(kernels, plan)))
            if f32:
                nxt = want[:, 0].contiguous()
        x = nxt
    return cases


def _k3_cases(torch, tmm, kernels, g, side: int, wavelet: str = WAVELET,
              n: int = SAMPLE_CHUNK * BATCH * CHANNELS, levels: int = LEVELS) -> list[dict]:
    """K3 forward and backward over the levels that `transform.waverec2`
    collapses at a side x side path, on ``n`` images (CHANNELS a sample),
    on leaves made as the engine makes them:
    detached views of K1's output for a noisy batch, which the kernel reads
    in place. The output and every leaf's gradient (through autograd of
    `waverec2_collapsed`) are held against the plain version, the assembly
    of Y and `pair_plain`. The bound counts the bytes the function must
    move: the leaves read and the output written (forward), g read and the
    leaves' gradients written (backward). The einsum yardstick runs on the
    assembled Y (forward) and gives the dense dY (backward); the assembly is
    timed apart as ``assemble_ms``."""
    from wam_tpu_torch.wavelets import transform as tt
    from wam_tpu_torch.wavelets.filters import build_wavelet

    dev = torch.device(DEVICE)
    imgs = torch.randn((n // CHANNELS, CHANNELS, side, side), generator=g, device=dev)
    with torch.no_grad():
        coeffs = tt.wavedec2(imgs, wavelet, levels, MODE, impl="kernel")
    details = coeffs[1:][:tt._collapse_count(coeffs[1:])]
    flat = [coeffs[0]] + [t for d in details for t in d]

    def unflat(ls):
        return ls[0], [tt.Detail2D(*ls[1 + 3 * i:4 + 3 * i]) for i in range(len(details))]

    w = build_wavelet(wavelet)
    rs = tuple(int(d.horizontal.shape[-2]) for d in details)
    cs = tuple(int(d.horizontal.shape[-1]) for d in details)
    fwd, bwd = tmm.pair_band(rs, cs, tuple(w.rec_lo), tuple(w.rec_hi), dev)
    R, Rt, C, Ct = tmm.collapsed_operators(details, wavelet, dev)
    leaves = [tmm._leaf3(t) for t in flat]  # (n, r, c) views of K1's output
    if any(a.data_ptr() != b.data_ptr() for a, b in zip(leaves, flat)):
        raise AssertionError("K3: a leaf view of K1's output was copied")

    def plain_fwd(ls):
        cA, dets = unflat(ls)
        y = tmm.assemble_collapsed(cA, dets)
        return tmm.pair_plain(y.reshape((n,) + y.shape[-2:]), Rt, Ct)

    def plain_bwd():  # _pair_bwd and the leaves' slices of dY
        return tmm.pair_plain(gout, R, C)

    gout = torch.randn((n, fwd.p, fwd.t), generator=g, device=dev)
    kv = [t.detach().requires_grad_(True) for t in flat]
    out = tmm.waverec2_collapsed(kv[0], unflat(kv)[1], wavelet)
    kgrads = torch.autograd.grad(out, kv, gout.reshape(out.shape))
    out = out.detach().reshape(n, fwd.p, fwd.t)
    pv = [t.detach().clone().requires_grad_(True) for t in leaves]
    want = plain_fwd(pv)
    wgrads = torch.autograd.grad(want, pv, gout)
    want = want.detach()
    names = ["cA"] + [f"{q}{len(rs) - i}" for i in range(len(rs)) for q in "HVD"]
    for name, got_g, want_g in zip(names, kgrads, wgrads):
        _check(f"K3 {wavelet} {side}^2 gradient of {name}", got_g.reshape(want_g.shape), want_g)
    with torch.no_grad():
        y3 = tmm.assemble_collapsed(*unflat(leaves))
        y3 = y3.reshape((n,) + y3.shape[-2:])
    tags = {"dtype": "float32", "levels": list(zip(rs, cs)),
            "plan": {"threads": [fwd.threads, bwd.threads],
                     "smem_bytes": [fwd.smem_bytes(), bwd.smem_bytes()],
                     "rt": [[lv.rt for lv in p.levels] for p in (fwd, bwd)],
                     "k": [[lv.k for lv in p.levels] for p in (fwd, bwd)],
                     "fold_log2": [lv.fold_log2 for lv in bwd.levels]}}
    bwd_flops = 0
    off_r = off_c = 0
    for r, c in zip(rs, cs):  # the leaves' blocks of R^T g C, level by level
        bwd_flops += _needed_flops(gout, R[:, off_r:off_r + 2 * r], C[:, off_c:off_c + 2 * c])
        off_r, off_c = off_r + 2 * r, off_c + 2 * c
    leaf_bytes = _nbytes(*leaves)
    cases = [
        _case(torch, f"K3 {wavelet} {side}^2 forward", out, want, lambda: kernels.pair(leaves, fwd),
              lambda: plain_fwd(leaves), (Rt, y3, Ct), leaves, n * fwd.p * fwd.t * 4,
              extra={"assemble_ms": lambda: tmm.assemble_collapsed(*unflat(leaves))},
              part="forward", shape=[n, fwd.p, fwd.t], **tags),
        _case(torch, f"K3 {wavelet} {side}^2 backward (autograd)",
              torch.cat([t.reshape(-1) for t in kgrads]), torch.cat([t.reshape(-1) for t in wgrads]),
              lambda: kernels.pair_bwd(gout, bwd), plain_bwd, (R, gout, C), (gout,), leaf_bytes,
              flops=bwd_flops, part="backward (autograd)", shape=[n, fwd.p, fwd.t], **tags)]
    del y3
    return cases


def _k2_cases(torch, tmm, kernels, g, side: int = SIDE2, wavelet: str = WAVELET,
              n: int = SAMPLE_CHUNK * BATCH * CHANNELS) -> tuple[list[dict], dict]:
    """K2 forward (float32 and bfloat16 subbands) at a synthesis level whose
    output is side x side, on ``n`` images: path 2's finest level (4, 147,
    147) -> 288 x 288 by default; and its backward through autograd, which
    is a K1 launch (returned apart: it is one of K1's launches)."""
    dev = torch.device(DEVICE)
    from wam_tpu_torch.wavelets.filters import build_wavelet

    w = build_wavelet(wavelet)
    h = (side + w.filt_len - 1) // 2
    rec = (tuple(w.rec_lo), tuple(w.rec_hi))
    Sr, Srt = tmm._kernel_synthesis(h, *rec, dev)  # dense: the plain version and einsum
    Sc, Sct = Sr, Srt
    plans = tmm.idwt2_band(h, h, *rec, dev)  # (K2's, its backward's on K1)
    full = Sr.shape[0]
    sub = torch.randn((n, 4, h, h), generator=g, device=dev)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        sin = sub.to(dtype).contiguous()
        merged = tmm._merge_quadrants(sin.float())  # the product as the einsum sees it
        cases.append(_case(
            torch, f"K2 {wavelet} -> {side}^2 forward {str(dtype)[6:]}",
            kernels.synth2(sin, plans[0]),
            tmm.idwt2_plain(sin, Sr, Sct), lambda: kernels.synth2(sin, plans[0]),
            lambda: tmm.idwt2_plain(sin, Sr, Sct), (Srt, merged, Sct), (sin, Srt, Sct),
            n * full * full * 4, part="forward", dtype=str(dtype)[6:], shape=[n, 4, h, h],
            **_plan_tags(kernels, plans[0])))
        del merged

    # the backward as autograd runs it: the quadrant split of Sr^T g Sc on K1
    gout = torch.randn((n, full, full), generator=g, device=dev)
    sv = sub.clone().requires_grad_(True)
    (dsub,) = torch.autograd.grad(tmm._Idwt2Core.apply(sv, Sr, Sc, Sct, plans), sv, gout)
    bwd = _case(torch, f"K2 {wavelet} -> {side}^2 backward (autograd, a K1 launch)", dsub,
                tmm.dwt2_plain(gout, Sr, Sc),
                lambda: kernels.dwt2(gout, plans[1]), lambda: tmm.dwt2_plain(gout, Sr, Sc),
                (Sr, gout, Sc), (gout, Sr, Sc), n * 4 * h * h * 4,
                extra={"matmul_pair_ms": lambda: tmm.pair_plain(gout, Sr, Sc)},
                part="K2 backward (autograd)", dtype="float32", shape=[n, full, full],
                **_plan_tags(kernels, plans[1]))
    return cases, bwd


def _k3_eval_case(torch, tmm, kernels, g, masks: int) -> dict:
    """K3 forward as the eval2d path runs it: the collapsed synthesis (all
    three haar levels at 224^2) of one image's mask family, ``masks`` masks
    x CHANNELS rows, its leaves views of the masked packed array (the mask
    family of a random mosaic, `evalsuite.metrics.generate_masks`), read in
    place; held against the plain version, with the einsum on the assembled
    Y and the assembly (``assemble_ms``) timed beside it."""
    from wam_tpu_torch.evalsuite import packing
    from wam_tpu_torch.evalsuite.metrics import generate_masks
    from wam_tpu_torch.wavelets import transform as tt
    from wam_tpu_torch.wavelets.filters import build_wavelet

    dev = torch.device(DEVICE)
    img = torch.rand((CHANNELS, EVAL_SIDE, EVAL_SIDE), generator=g, device=dev)
    with torch.no_grad():
        coeffs = tt.wavedec2(img, EVAL_WAVELET, EVAL_LEVELS, MODE, impl="kernel")
    family = generate_masks(masks - 1, torch.rand((EVAL_SIDE, EVAL_SIDE), generator=g,
                                                  device=dev))[0]
    masked = packing.coeffs_to_array2d(coeffs)[None] * family[:, None]
    rec = packing.array_to_coeffs2d(masked, packing.coeff_shapes2d(coeffs))
    details = rec[1:]
    if tt._collapse_count(details) != EVAL_LEVELS:
        raise AssertionError("eval2d: not every level collapses into K3")
    w = build_wavelet(EVAL_WAVELET)
    rs = tuple(int(d.horizontal.shape[-2]) for d in details)
    cs = tuple(int(d.horizontal.shape[-1]) for d in details)
    fwd, _ = tmm.pair_band(rs, cs, tuple(w.rec_lo), tuple(w.rec_hi), dev)
    _, Rt, _, Ct = tmm.collapsed_operators(details, EVAL_WAVELET, dev)
    leaves = [tmm._leaf3(t) for t in [rec[0]] + [t for d in details for t in d]]
    lo, hi = masked.data_ptr(), masked.data_ptr() + masked.numel() * masked.element_size()
    if not all(lo <= t.data_ptr() < hi for t in leaves):
        raise AssertionError("K3 eval: a leaf view of the masked packed array was copied")
    n = leaves[0].shape[0]

    def assemble():
        y = tmm.assemble_collapsed(leaves[0], [tt.Detail2D(*leaves[1 + 3 * i:4 + 3 * i])
                                               for i in range(len(details))])
        return y.reshape((n,) + y.shape[-2:])

    with torch.no_grad():
        got = tmm.waverec2_collapsed(rec[0], details, EVAL_WAVELET).reshape(n, fwd.p, fwd.t)
        y3 = assemble()
        want = tmm.pair_plain(y3, Rt, Ct)
    return _case(torch, f"K3 {EVAL_WAVELET} {EVAL_SIDE}^2 forward, {masks} masks x {CHANNELS}",
                 got, want, lambda: kernels.pair(leaves, fwd),
                 lambda: tmm.pair_plain(assemble(), Rt, Ct), (Rt, y3, Ct), leaves,
                 n * fwd.p * fwd.t * 4, extra={"assemble_ms": assemble}, part="forward",
                 dtype="float32", shape=[n, fwd.p, fwd.t], masks=masks,
                 plan={"threads": fwd.threads, "smem_bytes": fwd.smem_bytes(),
                       "rt": [lv.rt for lv in fwd.levels]})


def phase_kernels(torch, tmm, kernels, sites, vol_sites) -> list[dict]:
    """Every kernel against its plain version at the launch shapes of each
    path that runs it, TF32 off: K1 and K3 at the flagship's and at path
    2's (N = SAMPLE_CHUNK * BATCH * CHANNELS images per launch) and at the
    ViT path's (haar: K1 on the image's CHANNELS planes, K3 on a chunk's
    VIT_CHUNK * CHANNELS), K2 and K4/K5 (at the ReLU ``sites``) at path 2's,
    and K4/K5 at the vol path's fused arm (its ReLU ``vol_sites``); K1 and
    K3 at the eval2d, analyzers and iou paths', at the patch path's (4
    levels) and at the anytime step's (one sample of BATCH images), K1 and
    K2 at the video path's. One line per kernel and path."""
    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log("phase kernels: torch.backends.cuda.matmul.allow_tf32=False "
         "torch.backends.cudnn.allow_tf32=False")
    g = torch.Generator(device=dev).manual_seed(SEED)
    k2_cases, k2_bwd = _k2_cases(torch, tmm, kernels, g)
    k1 = ("dwt2", "dwt2_kernel (K1)", "wam_tpu_torch/csrc/dwt2.cu",
          "wam_tpu/wavelets/matmul.py:176")
    k3 = ("pair", "waverec2_collapsed (K3)", "wam_tpu_torch/csrc/pair.cu",
          "wam_tpu/wavelets/matmul.py:439")
    einsum = "torch.einsum (the matmul pair, without the quadrant split)"
    rows = []
    chunk = SAMPLE_CHUNK * BATCH * CHANNELS
    for path, side, wavelet, n1, n3, once in (
            ("flagship", SIDE, WAVELET, chunk, chunk, "one sample chunk"),
            ("path 2", SIDE2, WAVELET, chunk, chunk, "one sample chunk"),
            ("vit", VIT_SIDE, VIT_WAVELET, CHANNELS, VIT_CHUNK * CHANNELS, "")):
        k1_cases = _k1_cases(torch, tmm, kernels, g, side, wavelet, n1)
        k1_work = (f"3 analysis levels at {side}^2, {wavelet}, f32 input, "
                   + (once or "the image's 3 planes (once a call)"))
        if path == "path 2":
            k1_cases.append(k2_bwd)
            k1_work += ", and K2's backward at the finest synthesis level"
        rows.append(_row(*k1, path, k1_cases, einsum, k1_work))
        k3_cases = _k3_cases(torch, tmm, kernels, g, side, wavelet, n3)
        if path == "flagship":  # the tune path's nchw probe runs these shapes
            tune_k1, tune_k3 = k1_cases, k3_cases
        rows.append(_row(*k3, path, k3_cases,
                         "torch.einsum (the matmul pair on the assembled Y; dense dY)",
                         f"forward + backward of the collapsed levels at {side}^2, {wavelet}, "
                         + (once or f"one chunk of {VIT_CHUNK} path points")))
        rows[-1]["assemble_ms"] = k3_cases[0]["assemble_ms"]
    # the tune path's nchw probe (the flagship preset, chunk 4): K1's first
    # level on the preset's bfloat16 input (dwt_bf16), the next two on its
    # own float32 approximations; K3 on K1's float32 leaves
    tune_main = [c for c in tune_k1 if (c["dtype"] == "bfloat16")
                 == (c["part"] == "analysis level 1")]
    rows.append(_row(*k1, "tune", tune_k1, einsum + " (bfloat16 x: bf16 operands, bf16 out)",
                     f"3 analysis levels at {SIDE}^2, {WAVELET}, the first on bfloat16 input "
                     "(dwt_bf16), one sample chunk of the tune phase's nchw candidate",
                     main=tune_main))
    rows.append(_row(*k3, "tune", tune_k3,
                     "torch.einsum (the matmul pair on the assembled Y; dense dY)",
                     f"forward + backward of the collapsed levels at {SIDE}^2, {WAVELET}, one "
                     "sample chunk of the tune phase's nchw candidate"))
    rows[-1]["assemble_ms"] = tune_k3[0]["assemble_ms"]
    # the eval2d path: K1 on one image's planes a metric call (the ViT
    # path's shape), K3 forward only on a reconstruction family
    rows.append(_row(*k1, "eval2d", _k1_cases(torch, tmm, kernels, g, EVAL_SIDE, EVAL_WAVELET,
                                              CHANNELS), einsum,
                     f"3 analysis levels at {EVAL_SIDE}^2, {EVAL_WAVELET}, f32 input, one "
                     "image's 3 planes (once an image a metric call)"))
    for path, masks in (("eval2d insertion", EVAL_N_ITER + 1), ("eval2d mu", MU_SAMPLES)):
        case = _k3_eval_case(torch, tmm, kernels, g, masks)
        rows.append(_row(*k3, path, [case], "torch.einsum (the matmul pair on the assembled Y)",
                         f"forward of the collapsed levels at {EVAL_SIDE}^2, {EVAL_WAVELET}, "
                         f"one image's {masks} masks x {CHANNELS} planes"))
        rows[-1]["assemble_ms"] = case["assemble_ms"]
    # the analyzers path: K1 on one image's planes a call (haar, 224^2), K3
    # forward on an image's mask family (J + 1 masks, or the quantiles)
    rows.append(_row(*k1, "analyzers", _k1_cases(torch, tmm, kernels, g, SIDE, AN_WAVELET,
                                                 CHANNELS), einsum,
                     f"3 analysis levels at {SIDE}^2, {AN_WAVELET}, f32 input, one image's "
                     f"{CHANNELS} planes (once an image a call)"))
    for path, masks in (("analyzers scales", AN_LEVELS + 1),
                        ("analyzers components", AN_QUANTILES)):
        case = _k3_eval_case(torch, tmm, kernels, g, masks)
        rows.append(_row(*k3, path, [case], "torch.einsum (the matmul pair on the assembled Y)",
                         f"forward of the collapsed levels at {SIDE}^2, {AN_WAVELET}, one "
                         f"image's {masks} masks x {CHANNELS} planes"))
        rows[-1]["assemble_ms"] = case["assemble_ms"]
    # the iou path, per wavelet: K1 on the image's planes, K3 forward and
    # backward on one IG call's 25 path points x 3 planes
    for wavelet in IOU_WAVELETS:
        rows.append(_row(*k1, f"iou {wavelet}", _k1_cases(torch, tmm, kernels, g, IOU_SIDE,
                                                          wavelet, CHANNELS), einsum,
                         f"3 analysis levels at {IOU_SIDE}^2, {wavelet}, f32 input, the image's "
                         f"{CHANNELS} planes (once an explanation)"))
        k3_cases = _k3_cases(torch, tmm, kernels, g, IOU_SIDE, wavelet, IOU_STEPS * CHANNELS)
        rows.append(_row(*k3, f"iou {wavelet}", k3_cases,
                         "torch.einsum (the matmul pair on the assembled Y; dense dY)",
                         f"forward + backward of the collapsed levels at {IOU_SIDE}^2, "
                         f"{wavelet}, one explanation's {IOU_STEPS} path points"))
        rows[-1]["assemble_ms"] = k3_cases[0]["assemble_ms"]
    # the patch path: K1 at the plan's 4 levels on the image's planes, K3
    # forward and backward over 4 collapsed levels, one chunk of path points
    rows.append(_row(*k1, "patch", _k1_cases(torch, tmm, kernels, g, VIT_SIDE, VIT_WAVELET,
                                             CHANNELS, PATCH_LEVELS), einsum,
                     f"{PATCH_LEVELS} analysis levels at {VIT_SIDE}^2, {VIT_WAVELET}, f32 input, "
                     f"the image's {CHANNELS} planes (once a call)"))
    k3_cases = _k3_cases(torch, tmm, kernels, g, VIT_SIDE, VIT_WAVELET, VIT_CHUNK * CHANNELS,
                         PATCH_LEVELS)
    rows.append(_row(*k3, "patch", k3_cases,
                     "torch.einsum (the matmul pair on the assembled Y; dense dY)",
                     f"forward + backward of {PATCH_LEVELS} collapsed levels at {VIT_SIDE}^2, "
                     f"{VIT_WAVELET}, one chunk of {VIT_CHUNK} path points"))
    rows[-1]["assemble_ms"] = k3_cases[0]["assemble_ms"]
    # the video path: K1 and K2 at the spatial-only level 2, one chunk's
    # planes (clips x samples x 8 decimated frames) of 16^2, symmetric
    vid_k1 = _k1_cases(torch, tmm, kernels, g, VID_SIDE // 2, VID_WAVELET, VID_PLANES, 1,
                       "symmetric")
    vid_k2, vid_k2_bwd = _k2_cases(torch, tmm, kernels, g, VID_SIDE // 2, VID_WAVELET,
                                   VID_PLANES)
    rows.append(_row(*k1, "video", vid_k1 + [vid_k2_bwd], einsum,
                     f"the spatial-only level 2 on {VID_PLANES} planes of {VID_SIDE // 2}^2 "
                     "(one chunk), forward and as K2's backward"))
    rows.append(_row("synth2", "idwt2_kernel (K2)", "wam_tpu_torch/csrc/synth2.cu",
                     "wam_tpu/wavelets/matmul.py:313", "video", vid_k2,
                     "torch.einsum (the matmul pair on the merged matrix, merge not timed)",
                     f"forward, f32 subbands, {VID_PLANES} planes to {VID_SIDE // 2}^2 (one "
                     "chunk; its backward is on K1's video line)"))
    # the anytime path: K1 and K3 of one sample's step (the flagship's 32
    # images x 3 planes, db4)
    rows.append(_row(*k1, "anytime", _k1_cases(torch, tmm, kernels, g, SIDE, WAVELET,
                                               BATCH * CHANNELS), einsum,
                     f"3 analysis levels at {SIDE}^2, {WAVELET}, f32 input, one sample's "
                     f"{BATCH} images x {CHANNELS} planes"))
    k3_cases = _k3_cases(torch, tmm, kernels, g, SIDE, WAVELET, BATCH * CHANNELS)
    rows.append(_row(*k3, "anytime", k3_cases,
                     "torch.einsum (the matmul pair on the assembled Y; dense dY)",
                     f"forward + backward of the collapsed levels at {SIDE}^2, {WAVELET}, one "
                     f"sample's {BATCH} images"))
    rows[-1]["assemble_ms"] = k3_cases[0]["assemble_ms"]
    # the serve path: one dispatched batch of each bucket, 8 requests x 25
    # samples x 3 planes; 256²'s finest level runs through K2 (its backward
    # a K1 launch), its two coarser levels through K3
    for side in (224, 256):
        k1_cases = _k1_cases(torch, tmm, kernels, g, side, WAVELET, SERVE_ROWS)
        work = (f"3 analysis levels at {side}^2, {WAVELET}, f32 input, one served batch "
                f"({SERVE_MAX_BATCH} requests x {N_SAMPLES} samples x {CHANNELS} planes)")
        if side == 256:
            k2_serve, k2_serve_bwd = _k2_cases(torch, tmm, kernels, g, side, WAVELET, SERVE_ROWS)
            k1_cases.append(k2_serve_bwd)
            work += ", and K2's backward at the finest synthesis level"
        rows.append(_row(*k1, f"serve {side}", k1_cases, einsum, work))
        k3_cases = _k3_cases(torch, tmm, kernels, g, side, WAVELET, SERVE_ROWS)
        rows.append(_row(*k3, f"serve {side}", k3_cases,
                         "torch.einsum (the matmul pair on the assembled Y; dense dY)",
                         f"forward + backward of the collapsed levels at {side}^2, {WAVELET}, "
                         f"one served batch ({SERVE_ROWS} rows)"))
        rows[-1]["assemble_ms"] = k3_cases[0]["assemble_ms"]
        if side == 256:
            rows.append(_row("synth2", "idwt2_kernel (K2)", "wam_tpu_torch/csrc/synth2.cu",
                             "wam_tpu/wavelets/matmul.py:313", "serve 256", k2_serve,
                             "torch.einsum (the matmul pair on the merged matrix, merge not "
                             "timed)", f"forward, f32 subbands, one served batch at {side}^2 "
                             "(its backward is on K1's serve 256 line)"))
    # the pod path: the workers' toy entry, one batch of POD_MAX_BATCH
    # requests x 25 samples x 3 planes at 224^2, haar J=2 (detail sides 112
    # and 56, under the collapse crossover: K1 both levels, K3 the synthesis)
    pod_rows = POD_MAX_BATCH * N_SAMPLES * CHANNELS
    rows.append(_row(*k1, "pod", _k1_cases(torch, tmm, kernels, g, POD_SIDE, "haar", pod_rows,
                                           levels=2), einsum,
                     f"2 analysis levels at {POD_SIDE}^2, haar, f32 input, one pod worker's "
                     f"batch ({POD_MAX_BATCH} requests x {N_SAMPLES} samples x {CHANNELS} "
                     "planes)"))
    k3_cases = _k3_cases(torch, tmm, kernels, g, POD_SIDE, "haar", pod_rows, levels=2)
    rows.append(_row(*k3, "pod", k3_cases,
                     "torch.einsum (the matmul pair on the assembled Y; dense dY)",
                     f"forward + backward of the collapsed levels at {POD_SIDE}^2, haar J=2, "
                     f"one pod worker's batch ({pod_rows} rows)"))
    rows[-1]["assemble_ms"] = k3_cases[0]["assemble_ms"]
    # the parallel path: one block of the spmd mesh (5 samples x 16 images x
    # 3 planes); the IG mesh's block (4 path points x 16 images), whose K1
    # runs once a data shard on its 16 images
    rows.append(_row(*k1, "parallel", _k1_cases(torch, tmm, kernels, g, SIDE, WAVELET,
                                                PAR_BLOCK_PLANES), einsum,
                     f"3 analysis levels at {SIDE}^2, {WAVELET}, f32 input, one spmd block "
                     f"({PAR_BLOCK_PLANES} planes)"))
    k3_cases = _k3_cases(torch, tmm, kernels, g, SIDE, WAVELET, PAR_BLOCK_PLANES)
    rows.append(_row(*k3, "parallel", k3_cases,
                     "torch.einsum (the matmul pair on the assembled Y; dense dY)",
                     f"forward + backward of the collapsed levels at {SIDE}^2, {WAVELET}, one "
                     f"spmd block ({PAR_BLOCK_PLANES} rows)"))
    rows[-1]["assemble_ms"] = k3_cases[0]["assemble_ms"]
    rows.append(_row(*k1, "parallel ig", _k1_cases(torch, tmm, kernels, g, SIDE, WAVELET,
                                                   (BATCH // 2) * CHANNELS), einsum,
                     f"3 analysis levels at {SIDE}^2, {WAVELET}, f32 input, one data shard's "
                     f"{BATCH // 2} images x {CHANNELS} planes"))
    k3_cases = _k3_cases(torch, tmm, kernels, g, SIDE, WAVELET, PAR_IG_PLANES)
    rows.append(_row(*k3, "parallel ig", k3_cases,
                     "torch.einsum (the matmul pair on the assembled Y; dense dY)",
                     f"forward + backward of the collapsed levels at {SIDE}^2, {WAVELET}, one IG "
                     f"block ({PAR_IG_PLANES} rows)"))
    rows[-1]["assemble_ms"] = k3_cases[0]["assemble_ms"]
    rows.insert(3, _row("synth2", "idwt2_kernel (K2)", "wam_tpu_torch/csrc/synth2.cu",
                        "wam_tpu/wavelets/matmul.py:313", "path 2", k2_cases,
                        "torch.einsum (the matmul pair on the merged matrix, merge not timed)",
                        f"forward, f32 subbands, one sample chunk at {SIDE2}^2 (its backward "
                        "is a K1 launch, timed and counted on K1's path-2 line)"))
    rows += _relu_rows(torch, kernels, g, sites, "path 2", SAMPLE_CHUNK * BATCH,
                       (torch.float32, torch.bfloat16),
                       f"one {SAMPLE_CHUNK * BATCH}-row ResNet-50 step at {SIDE2}^2")
    return rows + _relu_rows(torch, kernels, g, vol_sites, "vol", VOL_CHUNK * VOL_BATCH,
                             (torch.float32,),
                             f"one {VOL_CHUNK * VOL_BATCH}-row 3D ResNet-18 step at {VOL_SIDE}^3")


def _record_sites(torch, model, shape) -> list[tuple[int, ...]]:
    """The shape (less the batch axis) of every ReLU site of ``model`` on
    one input of ``shape``, in call order, recorded through its ``act``."""
    sites = []

    def record(t):
        sites.append(tuple(t.shape[1:]))
        return torch.relu(t)

    model = model.to(DEVICE).eval()
    for m in model.modules():
        if hasattr(m, "act"):
            m.act = record
    with torch.no_grad():
        model(torch.zeros((1,) + shape, device=DEVICE))
    return sites


def relu_sites(torch, wtt) -> list[tuple[int, ...]]:
    """(C, H, W) of every ReLU site of ResNet-50 at SIDE2."""
    return _record_sites(torch, wtt.resnet50(num_classes=1000), (CHANNELS, SIDE2, SIDE2))


def vol_relu_sites(torch, wtt) -> list[tuple[int, ...]]:
    """(C, D, H, W) of every ReLU site of the vol path's 3D ResNet-18."""
    return _record_sites(torch, wtt.resnet3d_18(num_classes=VOL_CLASSES, width=VOL_WIDTH),
                         (1, VOL_SIDE, VOL_SIDE, VOL_SIDE))


def _equal(name: str, got, want) -> None:
    import torch

    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{name}: kernel output is not equal to its plain version")


def _relu_rows(torch, kernels, g, sites, path: str, rows: int, dtypes, step: str) -> list[dict]:
    """K4 and K5 at every ReLU site shape of one step of ``path`` (``rows``
    rows; ``sites`` from `relu_sites` / `vol_relu_sites`) in ``dtypes``,
    the float32 times summed over the sites with their multiplicity (the
    paths run float32); ragged sizes. Outputs must EQUAL the plain versions
    (mask bytes, y, dx)."""
    from collections import Counter

    from wam_tpu_torch.tune import fused_relu as tfr

    dev = torch.device(DEVICE)
    by_size = sorted(Counter(sites).items(), key=lambda kv: -math.prod(kv[0]))
    total = {k: {"ms": 0.0, "plain_ms": 0.0, "nearest_ms": 0.0, "bytes": 0, "ops": 0}
             for k in ("K4", "K5")}
    cases = {"K4": [], "K5": []}
    for dtype in dtypes:
        for shape, count in by_size:
            x = torch.randn((rows,) + shape, generator=g, device=dev).to(dtype)
            x.view(-1)[::97] = 0  # exact zeros: gate x > 0
            gout = torch.randn((rows,) + shape, generator=g, device=dev).to(dtype)
            numel, tag = x.numel(), f"{(rows,) + shape} {str(dtype)[6:]}"
            y, m = kernels.relu_fwd(x)
            dx = kernels.relu_bwd(m, gout)
            _equal(f"K4 {tag}", (y, m), tfr.relu_fwd_plain(x))
            _equal(f"K5 {tag}", (dx,), (tfr.relu_bwd_plain(m, gout),))
            timings = {
                "K4": (_time_ms(lambda: kernels.relu_fwd(x)),
                       _time_ms(lambda: tfr.relu_fwd_plain(x)),
                       _time_ms(lambda: torch.relu(x)), _nbytes(x, y, m)),
                "K5": (_time_ms(lambda: kernels.relu_bwd(m, gout)),
                       _time_ms(lambda: tfr.relu_bwd_plain(m, gout)),
                       _time_ms(lambda: torch.ops.aten.threshold_backward(gout, y, 0)),
                       _nbytes(m, gout, dx)),
            }
            for k, (ms, plain_ms, nearest_ms, nbytes) in timings.items():
                bound, by = _bound_ms(nbytes, numel)
                cases[k].append({"shape": [rows, *shape], "dtype": str(dtype)[6:],
                                 "sites": count, "ms": ms, "plain_ms": plain_ms,
                                 "nearest_ms": nearest_ms, "bound_ms": bound, "bound_by": by,
                                 "bound_share": bound / ms, "bytes": nbytes,
                                 "max_abs_err": 0.0})
                if dtype == torch.float32:
                    for key, v in (("ms", ms), ("plain_ms", plain_ms), ("nearest_ms", nearest_ms),
                                   ("bytes", nbytes), ("ops", numel)):
                        total[k][key] += count * v
            _log(f"  K4/K5 {tag} x{count}: K4 {timings['K4'][0]:.4f} ms (plain "
                 f"{timings['K4'][1]:.4f}, torch.relu {timings['K4'][2]:.4f}); K5 "
                 f"{timings['K5'][0]:.4f} ms (plain {timings['K5'][1]:.4f}, threshold_backward "
                 f"{timings['K5'][2]:.4f}); equal")
            del x, gout, y, m, dx
    for numel in (1, 1000, 3 * 1025):  # the ragged tail is masked in the kernels
        x = torch.randn(numel, generator=g, device=dev)
        gout = torch.randn(numel, generator=g, device=dev)
        y, m = kernels.relu_fwd(x)
        _equal(f"K4 ragged {numel}", (y, m), tfr.relu_fwd_plain(x))
        _equal(f"K5 ragged {numel}", (kernels.relu_bwd(m, gout),), (tfr.relu_bwd_plain(m, gout),))
    _log(f"  K4/K5 ({path}): {len(sites)} ReLU sites, {len(by_size)} shapes; ragged sizes equal")

    out = []
    for k, line, nearest in (("K4", 110, "torch.relu"),
                             ("K5", 116, "torch.ops.aten.threshold_backward")):
        t = total[k]
        bound, by = _bound_ms(t["bytes"], t["ops"])
        out.append({
            "name": f"fused_relu {'forward' if k == 'K4' else 'backward'} ({k}), {path}",
            "kernel": "relu_fwd" if k == "K4" else "relu_bwd", "path": path, "route": "cuda",
            "source": "wam_tpu_torch/csrc/relu_mask.cu",
            "replaces": f"wam_tpu/tune/fused_relu.py:{line}", "launches": None,
            "max_abs_err": 0.0, "tol": 0.0, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": bound, "bound_by": by, "bound_share": bound / t["ms"],
            "bytes": t["bytes"], "ops": t["ops"],
            "library_ms": None, "nearest_call": nearest, "nearest_call_ms": t["nearest_ms"],
            "work": f"all {len(sites)} ReLU sites of {step}, float32 (the nearest call "
                    "computes relu or its gate-from-output backward, not the packed mask)",
            "cases": cases[k]})
    return out


def build_slice(torch, wtt, side: int | None = None, fused_relu_vjp: bool = False):
    """A path's set-up, shared with scripts/torch_slice_profile.py: the
    library's precision defaults, stated (cuDNN convolutions in TF32, matmuls
    in float32), ResNet-50 with 1000 classes and weights from SEED (bound with
    ``fused_relu_vjp``), a (BATCH, CHANNELS, side, side) batch and its labels
    from a generator seeded SEED + 1, and the SmoothGrad attribution object
    on the kernels. The flagship is ``side=SIDE`` (the default); path 2 is
    ``side=SIDE2, fused_relu_vjp=True``. Returns (model_fn, wam, x, y,
    generator)."""
    dev = torch.device(DEVICE)
    side = SIDE if side is None else side
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(SEED)
    fn = wtt.bind_inference(wtt.resnet50(num_classes=1000), device=dev,
                            fused_relu_vjp=fused_relu_vjp)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn((BATCH, CHANNELS, side, side), generator=g, device=dev)
    y = torch.randint(0, 1000, (BATCH,), generator=g, device=dev)
    wam = wtt.WaveletAttribution2D(fn, wavelet=WAVELET, J=LEVELS, mode=MODE, method="smooth",
                                   n_samples=N_SAMPLES, stdev_spread=SPREAD,
                                   sample_batch_size=SAMPLE_CHUNK, device=dev, impl="kernel")
    return fn, wam, x, y, g


def _drive(torch, kernels, wam, x, y) -> dict:
    """One warm-up call (cuDNN plans, allocator), then the timed call with
    the launch counts set to 0 just before and read just after."""
    t0 = time.perf_counter()
    wam(x, y)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = wam(x, y)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    return {"out": out, "launches": kernels.launch_counts(), "seconds": run_s,
            "first_call_s": warm_s, "attributions_per_s": BATCH / run_s,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def _check_result(wtt, wam, run: dict, side: int, expected: dict) -> None:
    """The mosaic and the scales have the path's shapes, the mosaic is
    finite and nonzero, and every kernel of the path ran at least as often
    as the path needs."""
    import torch

    out = run["out"]
    mosaic = 2 * ((side + wtt.wavelets.filters.build_wavelet(WAVELET).filt_len - 1) // 2)
    if tuple(out.shape) != (BATCH, mosaic, mosaic):
        raise AssertionError(f"mosaic shape {tuple(out.shape)} != {(BATCH, mosaic, mosaic)}")
    if not bool(torch.isfinite(out).all()) or float(out.abs().sum()) == 0.0:
        raise AssertionError("mosaic is not finite and nonzero")
    if tuple(wam.scales.shape) != (BATCH, LEVELS, mosaic, mosaic):
        raise AssertionError(f"scales shape {tuple(wam.scales.shape)}")
    for name, need in expected.items():
        if run["launches"][name] < need:
            raise AssertionError(f"kernel {name} launched {run['launches'][name]} times on "
                                 f"this path, expected at least {need}")


def _reduced_check(torch, wtt, fn_kernel, fn_plain, x, y, g) -> dict:
    """The kernel path (impl="kernel" on ``fn_kernel``) against the plain
    path (impl="matmul" on ``fn_plain``) on 2 images x 2 samples, TF32 off."""
    dev = torch.device(DEVICE)
    torch.backends.cudnn.allow_tf32 = False
    n_img, n_smp = 2, 2
    z = torch.randn((n_smp, n_img) + tuple(x.shape[1:]), generator=g, device=dev)
    res = {}
    for impl, fn in (("kernel", fn_kernel), ("matmul", fn_plain)):
        small = wtt.WaveletAttribution2D(fn, wavelet=WAVELET, J=LEVELS, mode=MODE,
                                         n_samples=n_smp, stdev_spread=SPREAD,
                                         sample_batch_size=SAMPLE_CHUNK, device=dev, impl=impl)
        res[impl] = small(x[:n_img], y[:n_img], noise=z)
    diff = (res["kernel"] - res["matmul"]).abs()
    err = float(diff.max())
    cos = float(torch.nn.functional.cosine_similarity(
        res["kernel"].flatten(), res["matmul"].flatten(), dim=0))
    # mosaics lie in [0, 1] per block (n_smp-sample mean). The two paths
    # round the coefficients differently (~1e-7 relative); through ResNet-50
    # that can flip a ReLU gate sitting at zero and move a few entries, so
    # the check is on the cosine and a max-abs bound of 1e-2.
    _log(f"  reduced check (TF32 off, {n_img} images x {n_smp} samples): kernel vs plain "
         f"max_abs_err={err:.3e} (tol 1e-2) cosine={cos:.8f} (tol >= 0.9999) "
         f"mean_abs_err={float(diff.mean()):.3e}")
    if not (err <= 1e-2 and cos >= 0.9999):
        raise AssertionError("reduced check: kernel path disagrees with the plain path")
    return {"reduced_max_abs_err": err, "reduced_cosine": cos}


def _summary(run: dict) -> dict:
    return {k: v for k, v in run.items() if k != "out"}


def phase_slice(torch, wtt, kernels, smi: str) -> dict:
    """The flagship at full width, then the reduced kernel-vs-plain check."""
    fn, wam, x, y, g = build_slice(torch, wtt)
    _log(f"phase slice: ResNet-50 x ({BATCH},{CHANNELS},{SIDE},{SIDE}) {WAVELET} J={LEVELS} "
         f"{MODE} n_samples={N_SAMPLES} sample_batch_size={SAMPLE_CHUNK} "
         "cudnn.allow_tf32=True matmul.allow_tf32=False")
    run = _drive(torch, kernels, wam, x, y)
    chunks = -(-N_SAMPLES // SAMPLE_CHUNK)
    _check_result(wtt, wam, run, SIDE, {"dwt2": LEVELS * chunks, "pair": 2 * chunks})
    _log(f"  launches on the flagship path: {run['launches']}")
    _log(f"  first call {run['first_call_s']:.3f} s; timed call {run['seconds']:.3f} s = "
         f"{run['attributions_per_s']:.2f} attributions/s; peak memory "
         f"{run['peak_memory_gb']:.2f} GB on {smi}")
    return {**_summary(run), **_reduced_check(torch, wtt, fn, fn, x, y, g)}


def phase_slice2(torch, wtt, kernels, smi: str, n_sites: int) -> dict:
    """Path 2 at full width (288², fused ReLU VJP): every kernel must run;
    then the same call without the fused ReLU, timed; then the reduced check
    of the kernel path with the fused ReLU against the plain path without."""
    fn, wam, x, y, g = build_slice(torch, wtt, side=SIDE2, fused_relu_vjp=True)
    _log(f"phase slice2: ResNet-50 (fused_relu_vjp=True) x ({BATCH},{CHANNELS},{SIDE2},{SIDE2}) "
         f"{WAVELET} J={LEVELS} {MODE} n_samples={N_SAMPLES} sample_batch_size={SAMPLE_CHUNK} "
         "cudnn.allow_tf32=True matmul.allow_tf32=False")
    run = _drive(torch, kernels, wam, x, y)
    chunks = -(-N_SAMPLES // SAMPLE_CHUNK)
    # per chunk: 3 analysis levels + K2's backward on K1, one K2 level, K3
    # forward and backward, and K4/K5 at every ReLU site
    expected = {"dwt2": (LEVELS + 1) * chunks, "synth2": chunks, "pair": 2 * chunks,
                "relu_fwd": n_sites * chunks, "relu_bwd": n_sites * chunks}
    _check_result(wtt, wam, run, SIDE2, expected)
    _log(f"  launches on path 2: {run['launches']} (at least {expected})")
    _log(f"  first call {run['first_call_s']:.3f} s; timed call {run['seconds']:.3f} s = "
         f"{run['attributions_per_s']:.2f} attributions/s; peak memory "
         f"{run['peak_memory_gb']:.2f} GB on {smi}")
    del wam, run["out"]

    fn_plain, wam_plain, *_ = build_slice(torch, wtt, side=SIDE2, fused_relu_vjp=False)
    plain = _drive(torch, kernels, wam_plain, x, y)
    _log(f"  same call, fused_relu_vjp=False: first call {plain['first_call_s']:.3f} s; timed "
         f"call {plain['seconds']:.3f} s = {plain['attributions_per_s']:.2f} attributions/s; "
         f"peak memory {plain['peak_memory_gb']:.2f} GB on {smi}")
    del wam_plain
    unfused = {f"unfused_{k}": v for k, v in _summary(plain).items() if k != "launches"}
    return {**_summary(run), **unfused,
            **_reduced_check(torch, wtt, fn, fn_plain, x, y, g)}


def build_audio(torch, wtt, compute_dtype=None):
    """The audio path's set-up, shared with scripts/torch_slice_profile.py:
    cuDNN convolutions in TF32 and matmuls in float32 (as the image paths
    run); AudioCNN with 50 classes, its conv weights He-normal and biases
    N(0, 0.01^2) from torch's generator seeded SEED, BatchNorm affines drawn
    from SEED + 2 and running statistics of the model's own inputs (one
    train-mode pass over the mel spectrograms of two waveforms, cumulative
    averages), so activations stay O(1) through the twelve blocks as in a
    trained model; bound in float32 (or ``compute_dtype``). Waveforms are
    0.1 x standard normal from numpy seeded SEED + 1 (the calibration pair
    from SEED + 4), labels arange(8) % 50. Returns (model, model_fn, x, y)."""
    import numpy as np

    dev = torch.device(DEVICE)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(SEED)
    model = wtt.AudioCNN(num_classes=AUDIO_CLASSES)
    g = torch.Generator().manual_seed(SEED + 2)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                torch.nn.init.kaiming_normal_(m.weight, nonlinearity="relu")
                m.bias.normal_(0.0, 0.01)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.8, 1.2, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
                m.momentum = None  # cumulative running averages
        model.to(dev).train()
        calib = 0.1 * np.random.default_rng(SEED + 4).standard_normal((2, AUDIO_LEN))
        calib = torch.from_numpy(calib.astype(np.float32)).to(dev)
        model(wtt.melspectrogram(calib, sample_rate=SAMPLE_RATE, n_fft=N_FFT,
                                 n_mels=N_MELS)[:, None])
    fn = wtt.bind_audio_inference(model, compute_dtype=compute_dtype, device=dev)
    x = 0.1 * np.random.default_rng(SEED + 1).standard_normal((AUDIO_BATCH, AUDIO_LEN))
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    y = torch.arange(AUDIO_BATCH, device=dev) % AUDIO_CLASSES
    return model, fn, x, y


def audio_wam(wtt, fn, device, n_samples: int = AUDIO_SAMPLES, **kw):
    """The audio path's `WaveletAttribution1D` SmoothGrad object."""
    return wtt.WaveletAttribution1D(
        fn, wavelet=AUDIO_WAVELET, J=AUDIO_LEVELS, method="smooth", n_samples=n_samples,
        stdev_spread=AUDIO_SPREAD, n_mels=N_MELS, n_fft=N_FFT, sample_rate=SAMPLE_RATE,
        sample_batch_size=AUDIO_CHUNK, device=device, **kw)


def _time_calls(torch, kernels, wam, x, y, calls: int, items: int = AUDIO_BATCH,
                unit: str = "waveforms") -> dict:
    """Launch counts set to 0, one warm call (cuDNN and cuFFT plans, the
    allocator) with the counts read just after it (``call_launches``: one
    call's launches), then ``calls`` calls each timed by CUDA events, the
    peak memory over them, and the counts read just after (``launches``: all
    the calls'); ``items`` inputs a call give the rate ``{unit}_per_s``. Each
    call's host time until it returns, before the device has finished
    (``enqueue_ms``; no op of these paths waits for the device), says how
    far the host holds the device back: near the event time, the call is
    bound by the host."""
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    wam(x, y)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    call_launches = kernels.launch_counts()
    torch.cuda.reset_peak_memory_stats()
    times, enqueue = [], []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = wam(x, y)
        end.record()
        enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    med = sorted(times)[len(times) // 2]
    return {"out": out, "launches": kernels.launch_counts(), "call_launches": call_launches,
            "first_call_s": warm_s,
            "calls_ms": times, "median_ms": med, "spread_ms": [min(times), max(times)],
            "enqueue_ms": sorted(enqueue)[len(enqueue) // 2], f"{unit}_per_s": items / (med / 1e3),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def _check_audio_result(torch, run: dict) -> None:
    """The mel attribution is (8, 431, 128), the coefficient levels have
    wavedec's lengths, all finite and nonzero, and no port kernel ran."""
    mel, coeffs = run["out"]
    frames = 1 + AUDIO_LEN // (N_FFT // 2)
    if tuple(mel.shape) != (AUDIO_BATCH, frames, N_MELS):
        raise AssertionError(f"mel attribution shape {tuple(mel.shape)}")
    lens, n = [], AUDIO_LEN
    for _ in range(AUDIO_LEVELS):
        n = (n + 12 - 1) // 2  # db6 has 12 taps
        lens.append(n)
    want = [(AUDIO_BATCH, m) for m in [lens[-1]] + lens[::-1]]
    if [tuple(c.shape) for c in coeffs] != want:
        raise AssertionError(f"coefficient shapes {[tuple(c.shape) for c in coeffs]} != {want}")
    for t in (mel, *coeffs):
        if not bool(torch.isfinite(t).all()) or float(t.abs().sum()) == 0.0:
            raise AssertionError("audio attribution is not finite and nonzero")
    if any(run["launches"].values()):
        raise AssertionError(f"a port kernel launched on the audio path: {run['launches']}")


def _cosine(torch, a, b) -> float:
    return float(torch.nn.functional.cosine_similarity(
        a.double().flatten(), b.double().flatten(), dim=0))


def _compare_taps(torch, tag: str, got: list, want: list, dtype: str) -> dict:
    """Cosine and max abs error of each tap (mel, then cA5, cD5 ... cD1),
    held to AUDIO_TOL[dtype]."""
    cos_tol, rel_tol = AUDIO_TOL[dtype]
    names = ["mel", f"cA{AUDIO_LEVELS}"] + [f"cD{AUDIO_LEVELS - i}" for i in range(AUDIO_LEVELS)]
    out = {}
    for name, a, b in zip(names, got, want):
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        err, tol, cos = float((a - b).abs().max()), rel_tol * float(b.abs().max()), _cosine(torch, a, b)
        _log(f"  reduced check {tag} {name}: cosine={cos:.10f} (tol >= {cos_tol}) "
             f"max_abs_err={err:.3e} (tol {tol:.3e}, {err / float(b.abs().max()):.2e} of the max)")
        if not (math.isfinite(err) and err <= tol and cos >= cos_tol):
            raise AssertionError(f"audio reduced check ({tag}): {name} on the card disagrees "
                                 "with the CPU")
        out[name] = {"cosine": cos, "max_abs_err": err, "tol": tol}
    return out


def _audio_reduced_check(torch, wtt, model, fn) -> dict:
    """The port on the card (``fn``, bound from ``model``) against the port
    on the CPU, the same weights, waveforms and handed-over noise, TF32 off,
    twice:

    - float32 through `WaveletAttribution1D`, the path as it runs. An
      AudioCNN ReLU gate or max-pool flips where an activation lies within
      rounding of zero or of its neighbour, and one flip moves a few percent
      of the largest gradient: on these inputs a ReLU gate flips, which
      moves the mel attribution by 2.6% of its max at cosine 0.99994, and
      cD4 to cosine 0.99990 (measured on an H100 80GB HBM3). The bound is
      cosine >= 0.999 and max abs <= 0.1 x the largest CPU value.
    - float64 through the same object's engine (the same transform, mel
      front end and model, on the stacked noisy batch): no gate lies within
      rounding there, and the two devices agree to ~1e-13 of the max
      (measured on the same card), so cosine >= 0.9999999 and max abs
      <= 1e-9 x the max."""
    import numpy as np

    n_wave, length, n_smp = AUDIO_REDUCED
    torch.backends.cudnn.allow_tf32 = False
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(SEED + 3)
    x = torch.from_numpy((0.1 * rng.standard_normal((n_wave, length))).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((n_smp, n_wave, length)).astype(np.float32))
    y = torch.arange(n_wave) % AUDIO_CLASSES
    f32, f64 = {}, {}
    for dev in (DEVICE, "cpu"):
        f = fn if dev == DEVICE else wtt.bind_audio_inference(
            wtt.AudioCNN(num_classes=AUDIO_CLASSES), state, device="cpu")
        mel, coeffs = audio_wam(wtt, f, dev, n_samples=n_smp)(x.to(dev), y.to(dev),
                                                              noise=z.to(dev))
        f32[dev] = [mel, *coeffs]
        f = wtt.bind_audio_inference(wtt.AudioCNN(num_classes=AUDIO_CLASSES).double(), state,
                                     device=dev)
        x64, z64 = x.to(dev, torch.float64), z.to(dev, torch.float64)
        noisy = x64 + z64 * wtt.noise_sigma(x64, AUDIO_SPREAD).reshape(-1, 1)
        _, grads, g_mel = audio_wam(wtt, f, dev, n_samples=n_smp).engine.attribute_with_front_grads(
            noisy.reshape(-1, length), y.to(dev).repeat(n_smp), samples=n_smp)
        f64[dev] = [g_mel[:, 0], *grads]
    return {"float32": _compare_taps(torch, "float32, WaveletAttribution1D", f32[DEVICE],
                                     f32["cpu"], "float32"),
            "float64": _compare_taps(torch, "float64, engine", f64[DEVICE], f64["cpu"],
                                     "float64")}


def phase_audio(torch, wtt, kernels, smi: str) -> dict:
    """The audio path at full width and depth, its stream-noise and bf16
    arms, and the reduced card-against-CPU check."""
    model, fn, x, y = build_audio(torch, wtt)
    dev = torch.device(DEVICE)
    _log(f"phase audio: AudioCNN({AUDIO_CLASSES}) x ({AUDIO_BATCH},{AUDIO_LEN}) {AUDIO_WAVELET} "
         f"J={AUDIO_LEVELS} reflect n_samples={AUDIO_SAMPLES} stdev_spread={AUDIO_SPREAD} "
         f"sample_batch_size={AUDIO_CHUNK} mel n_fft={N_FFT} hop={N_FFT // 2} n_mels={N_MELS} "
         f"sr={SAMPLE_RATE} cudnn.allow_tf32=True matmul.allow_tf32=False")
    run = _time_calls(torch, kernels, audio_wam(wtt, fn, dev), x, y, AUDIO_CALLS)
    _check_audio_result(torch, run)
    mel, coeffs = run["out"]
    _log(f"  launches on the audio path: {run['launches']} (all must be 0)")
    _log(f"  outputs: mel {tuple(mel.shape)}, coefficients {[tuple(c.shape) for c in coeffs]}")
    _log(f"  first call {run['first_call_s']:.3f} s; {AUDIO_CALLS} calls (CUDA events) "
         f"{[round(t, 3) for t in run['calls_ms']]} ms, median {run['median_ms']:.3f} ms = "
         f"{run['waveforms_per_s']:.2f} waveforms/s; peak memory {run['peak_memory_gb']:.2f} GB "
         f"on {smi}")
    summary = {k: v for k, v in run.items() if k != "out"}

    stream = _time_calls(torch, kernels, audio_wam(wtt, fn, dev, stream_noise=True), x, y, 3)
    _check_audio_result(torch, stream)
    _log(f"  stream_noise=True: median {stream['median_ms']:.3f} ms "
         f"(spread {stream['spread_ms'][0]:.3f}-{stream['spread_ms'][1]:.3f}) = "
         f"{stream['waveforms_per_s']:.2f} waveforms/s; peak memory "
         f"{stream['peak_memory_gb']:.2f} GB")
    summary["stream_noise"] = {k: v for k, v in stream.items() if k not in ("out", "launches")}
    del stream

    _, fn16, _, _ = build_audio(torch, wtt, compute_dtype=torch.bfloat16)
    bf16 = _time_calls(torch, kernels, audio_wam(wtt, fn16, dev), x, y, 3)
    _check_audio_result(torch, bf16)
    cos = _cosine(torch, bf16["out"][0], mel)
    _log(f"  model in bfloat16: median {bf16['median_ms']:.3f} ms (spread "
         f"{bf16['spread_ms'][0]:.3f}-{bf16['spread_ms'][1]:.3f}) = "
         f"{bf16['waveforms_per_s']:.2f} waveforms/s; peak memory {bf16['peak_memory_gb']:.2f} GB; "
         f"mel-attribution cosine to float32 {cos:.6f}")
    summary["bf16_model"] = {**{k: v for k, v in bf16.items() if k not in ("out", "launches")},
                             "mel_cosine_to_f32": cos}
    del bf16, fn16, run, mel, coeffs
    summary["reduced_check"] = _audio_reduced_check(torch, wtt, model, fn)
    return summary


def _precision(torch, tf32: bool) -> str:
    """Set TF32 for matmuls and cuDNN convolutions together; the setting
    as printed."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    return (f"torch.backends.cuda.matmul.allow_tf32={tf32} "
            f"torch.backends.cudnn.allow_tf32={tf32}")


def build_vit(torch, wtt, arch: str = "vit", compute_dtype=None):
    """The ViT path's set-up, shared with scripts/torch_slice_profile.py:
    ViT-B/16 (``arch="vit"``) or ConvNeXt-T (``"convnext"``) with 1000
    classes, its weights drawn by the port's initialisers (the reference's:
    lecun_normal kernels, zero biases, ...) from torch's generator seeded
    SEED, bound with ``bind_inference(nchw=True)`` as
    ``bench_workloads.vit_workload`` binds it (in ``compute_dtype`` when
    given); one (1, CHANNELS, VIT_SIDE, VIT_SIDE) image from a generator
    seeded SEED + 1 and label 0. Returns (model, model_fn, x, y)."""
    dev = torch.device(DEVICE)
    torch.manual_seed(SEED)
    model = wtt.vit_b16(num_classes=1000) if arch == "vit" else wtt.convnext_tiny(num_classes=1000)
    fn = wtt.bind_inference(model, nchw=True, compute_dtype=compute_dtype, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn((1, CHANNELS, VIT_SIDE, VIT_SIDE), generator=g, device=dev)
    return model, fn, x, torch.zeros((1,), dtype=torch.int64, device=dev)


def vit_wam(wtt, fn, device, n_samples: int | None = None, impl: str = "kernel"):
    """The ViT path's `WaveletAttribution2D` Integrated-Gradients object
    (VIT_STEPS path points unless ``n_samples`` is given)."""
    return wtt.WaveletAttribution2D(fn, wavelet=VIT_WAVELET, J=VIT_LEVELS, mode=VIT_MODE,
                                    method="integratedgrad", n_samples=n_samples or VIT_STEPS,
                                    sample_batch_size=VIT_CHUNK, device=device, impl=impl)


VIT_LAUNCHES = {"dwt2": VIT_LEVELS, "synth2": 0, "pair": 2 * (VIT_STEPS // VIT_CHUNK),
                "relu_fwd": 0, "relu_bwd": 0}


def _check_vit_result(torch, wam, run: dict, arch: str) -> None:
    """The mosaic is (1, 224, 224) (haar keeps the side), finite and
    nonzero, the scales (1, J, 224, 224), and one call launched exactly
    K1 3 times (the analysis levels, once a call) and K3 8 times (forward
    and backward of each of the 4 chunks), no other kernel."""
    out = run["out"]
    if tuple(out.shape) != (1, VIT_SIDE, VIT_SIDE):
        raise AssertionError(f"{arch}: mosaic shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()) or float(out.abs().sum()) == 0.0:
        raise AssertionError(f"{arch}: mosaic is not finite and nonzero")
    if tuple(wam.scales.shape) != (1, VIT_LEVELS, VIT_SIDE, VIT_SIDE):
        raise AssertionError(f"{arch}: scales shape {tuple(wam.scales.shape)}")
    if run["call_launches"] != VIT_LAUNCHES:
        raise AssertionError(f"{arch}: launches of one call {run['call_launches']}, expected "
                             f"{VIT_LAUNCHES}")


def _timed(torch, kernels, wam, x, y, calls: int) -> dict:
    return _time_calls(torch, kernels, wam, x, y, calls, items=1, unit="attributions")


def _log_run(tag: str, run: dict, smi: str, unit: str = "attributions") -> None:
    _log(f"  {tag}: first call {run['first_call_s']:.3f} s; {len(run['calls_ms'])} calls (CUDA "
         f"events) {[round(t, 3) for t in run['calls_ms']]} ms, median {run['median_ms']:.3f} ms "
         f"(spread {run['spread_ms'][0]:.3f}-{run['spread_ms'][1]:.3f}) = "
         f"{run[f'{unit}_per_s']:.2f} {unit}/s; host enqueue {run['enqueue_ms']:.3f} ms "
         f"(median); peak memory {run['peak_memory_gb']:.3f} GB on {smi}")


def _reduced_vit_check(torch, wtt, fn, x, y, arch: str) -> dict:
    """The kernel path against the plain path (impl="matmul") on the same
    model and image, VIT_REDUCED_STEPS path points, TF32 off; cosine and
    max abs error of the attribution, held to VIT_TOL."""
    _precision(torch, False)
    dev = torch.device(DEVICE)
    res = {impl: vit_wam(wtt, fn, dev, VIT_REDUCED_STEPS, impl)(x, y)
           for impl in ("kernel", "matmul")}
    a, b = res["kernel"].double(), res["matmul"].double()
    err, peak = float((a - b).abs().max()), float(b.abs().max())
    cos = _cosine(torch, a, b)
    cos_tol, rel_tol = VIT_TOL
    _log(f"  reduced check ({arch}, TF32 off, 1 image x {VIT_REDUCED_STEPS} path points): "
         f"kernel vs plain cosine={cos:.10f} (tol >= {cos_tol}) max_abs_err={err:.3e} "
         f"(tol {rel_tol * peak:.3e} = {rel_tol} x max {peak:.3e}; {err / peak:.2e} of the max)")
    if not (math.isfinite(err) and err <= rel_tol * peak and cos >= cos_tol):
        raise AssertionError(f"{arch} reduced check: kernel path disagrees with the plain path")
    return {"cosine": cos, "max_abs_err": err, "max": peak, "rel_err": err / peak}


def phase_vit(torch, wtt, kernels, smi: str) -> dict:
    """The ViT path: the headline arm (TF32 on) with the launch counts
    checked, the TF32-off arm, the bf16-model arm, and the reduced
    kernel-vs-plain check."""
    _, fn, x, y = build_vit(torch, wtt)
    dev = torch.device(DEVICE)
    wam = vit_wam(wtt, fn, dev)
    _log(f"phase vit: ViT-B/16(1000) x (1,{CHANNELS},{VIT_SIDE},{VIT_SIDE}) {VIT_WAVELET} "
         f"J={VIT_LEVELS} {VIT_MODE} integratedgrad n_samples={VIT_STEPS} "
         f"sample_batch_size={VIT_CHUNK}")
    prec = _precision(torch, True)
    run = _timed(torch, kernels, wam, x, y, VIT_CALLS)
    _check_vit_result(torch, wam, run, "vit")
    _log(f"  launches of one call: {run['call_launches']} (asserted == {VIT_LAUNCHES})")
    _log_run(f"headline, {prec}", run, smi)
    summary = {k: v for k, v in run.items() if k != "out"}
    summary["precision"] = prec

    prec_off = _precision(torch, False)
    exact = _timed(torch, kernels, wam, x, y, VIT_CALLS)
    _check_vit_result(torch, wam, exact, "vit, TF32 off")
    cos_tf32 = _cosine(torch, run["out"], exact["out"])
    _log_run(f"float32, {prec_off}", exact, smi)
    _log(f"  mosaic cosine, TF32 on to TF32 off: {cos_tf32:.8f}")
    summary["tf32_off"] = {k: v for k, v in exact.items()
                           if k not in ("out", "launches", "call_launches")}
    summary["tf32_cosine_to_f32"] = cos_tf32

    _precision(torch, True)
    _, fn16, _, _ = build_vit(torch, wtt, compute_dtype=torch.bfloat16)
    wam16 = vit_wam(wtt, fn16, dev)
    bf16 = _timed(torch, kernels, wam16, x, y, 3)
    _check_vit_result(torch, wam16, bf16, "vit, bf16")
    cos16 = _cosine(torch, bf16["out"], exact["out"])
    _log_run(f"model in bfloat16, {prec}", bf16, smi)
    _log(f"  bf16 mosaic cosine to the float32 TF32-off result: {cos16:.6f} (no gate)")
    summary["bf16_model"] = {**{k: v for k, v in bf16.items() if k != "out"},
                             "cosine_to_f32": cos16}
    del fn16, wam16, bf16
    summary["reduced_check"] = _reduced_vit_check(torch, wtt, fn, x, y, "vit")
    return summary


def phase_convnext(torch, wtt, kernels, smi: str) -> dict:
    """The same call on ConvNeXt-T: launch counts checked, median of 3
    calls (TF32 on), and the reduced check."""
    _, fn, x, y = build_vit(torch, wtt, "convnext")
    wam = vit_wam(wtt, fn, torch.device(DEVICE))
    _log(f"phase convnext: ConvNeXt-T(1000) x (1,{CHANNELS},{VIT_SIDE},{VIT_SIDE}) {VIT_WAVELET} "
         f"J={VIT_LEVELS} {VIT_MODE} integratedgrad n_samples={VIT_STEPS} "
         f"sample_batch_size={VIT_CHUNK}")
    prec = _precision(torch, True)
    run = _timed(torch, kernels, wam, x, y, CONVNEXT_CALLS)
    _check_vit_result(torch, wam, run, "convnext")
    _log(f"  launches of one call: {run['call_launches']} (asserted == {VIT_LAUNCHES})")
    _log_run(f"headline, {prec}", run, smi)
    summary = {k: v for k, v in run.items() if k != "out"}
    summary["precision"] = prec
    summary["reduced_check"] = _reduced_vit_check(torch, wtt, fn, x, y, "convnext")
    return summary

def _calibrate(torch, model, calib) -> None:
    """BatchNorm affines drawn from a generator seeded SEED + 2 and running
    statistics of one train-mode pass of ``model`` over ``calib``
    (cumulative averages), so no BatchNorm is an identity and activations
    stay O(1), as in a trained model."""
    g = torch.Generator().manual_seed(SEED + 2)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    with torch.no_grad():
        for m in bns:
            m.weight.copy_(torch.empty_like(m.weight, device="cpu").uniform_(0.8, 1.2, generator=g))
            m.bias.copy_(torch.empty_like(m.bias, device="cpu").normal_(0.0, 0.1, generator=g))
            m.momentum = None
        model.train()
        model(calib)
    model.eval()


def build_vol(torch, wtt):
    """The vol path's set-up, shared with scripts/torch_slice_profile.py: the
    3D ResNet-18 (VOL_CLASSES classes, width VOL_WIDTH), its weights drawn
    by the port's initialisers (flax's: lecun_normal kernels, zero biases)
    from torch's generator seeded SEED, calibrated on two volumes from numpy
    seeded SEED + 4 (`_calibrate`), bound with ``bind_inference`` (its
    default ``nchw=True``: the model takes (B, 1, D, H, W) as it comes);
    VOL_BATCH standard-normal volumes (VOL_BATCH, 1, VOL_SIDE^3) from numpy
    seeded SEED + 1 and labels arange(VOL_BATCH) % VOL_CLASSES. Returns
    (state dict on the CPU, model_fn, x, y): the arms bind their own
    models from the state."""
    import numpy as np

    dev = torch.device(DEVICE)
    torch.manual_seed(SEED)
    model = wtt.resnet3d_18(num_classes=VOL_CLASSES, width=VOL_WIDTH).to(dev)
    calib = np.random.default_rng(SEED + 4).standard_normal((2, 1) + (VOL_SIDE,) * 3)
    _calibrate(torch, model, torch.from_numpy(calib.astype(np.float32)).to(dev))
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    fn = wtt.bind_inference(model, device=dev)
    x = np.random.default_rng(SEED + 1).standard_normal((VOL_BATCH, 1) + (VOL_SIDE,) * 3)
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    y = torch.arange(VOL_BATCH, device=dev) % VOL_CLASSES
    return state, fn, x, y


def bind_vol(torch, wtt, state, device, dtype=None, **kw):
    """A fresh 3D ResNet-18 with ``state``, bound on ``device`` (``kw``:
    ``fold_bn``, ``fused_relu_vjp``); in ``dtype`` (e.g. float64) when given."""
    model = wtt.resnet3d_18(num_classes=VOL_CLASSES, width=VOL_WIDTH)
    if dtype is not None:
        model = model.to(dtype)
    return wtt.bind_inference(model, state, device=device, **kw)


def vol_wam(wtt, fn, device, method: str = "smooth", n_samples: int | None = None,
            impl: str | None = None):
    """The vol path's `WaveletAttribution3D` object (SmoothGrad, or IG with
    ``method="integratedgrad"``; VOL_SAMPLES samples or path points unless
    ``n_samples`` is given)."""
    return wtt.WaveletAttribution3D(fn, wavelet=VOL_WAVELET, J=VOL_LEVELS, mode=VOL_MODE,
                                    method=method, n_samples=n_samples or VOL_SAMPLES,
                                    stdev_spread=VOL_SPREAD, sample_batch_size=VOL_CHUNK,
                                    device=device, impl=impl)


def _check_cube(torch, run: dict, tag: str, shape: tuple, launches: dict) -> None:
    """The cube has ``shape`` and is finite and nonzero, and one call
    launched exactly ``launches``."""
    out = run["out"]
    if tuple(out.shape) != shape:
        raise AssertionError(f"{tag}: cube shape {tuple(out.shape)} != {shape}")
    if not bool(torch.isfinite(out).all()) or float(out.abs().sum()) == 0.0:
        raise AssertionError(f"{tag}: cube is not finite and nonzero")
    if run["call_launches"] != launches:
        raise AssertionError(f"{tag}: launches of one call {run['call_launches']}, expected "
                             f"{launches}")


def _held(torch, tag: str, got, want, tol: tuple) -> dict:
    """Cosine and max abs error of ``got`` against ``want``, held to
    ``tol`` = (cosine, max abs / the largest value of ``want``)."""
    a, b = got.detach().cpu().double().flatten(), want.detach().cpu().double().flatten()
    err, peak, cos = float((a - b).abs().max()), float(b.abs().max()), _cosine(torch, a, b)
    _log(f"  {tag}: cosine={cos:.10f} (tol >= {tol[0]}) max_abs_err={err:.3e} (tol "
         f"{tol[1] * peak:.3e} = {tol[1]} x max {peak:.3e}; {err / peak:.2e} of the max)")
    if not (math.isfinite(err) and err <= tol[1] * peak and cos >= tol[0]):
        raise AssertionError(f"{tag}: outside its bound")
    return {"cosine": cos, "max_abs_err": err, "max": peak, "rel_err": err / peak}


def _flat_grads(coeffs) -> "list":
    from wam_tpu_torch.core.engine import _flatten

    return [t.reshape(-1) for t in _flatten(coeffs)]


def _vol_reduced_check(torch, wtt, state) -> dict:
    """The port on the card against the port on the CPU: the same weights,
    VOL_REDUCED volumes and handed-over noise, TF32 off, twice:

    - float32 through `WaveletAttribution3D`, the path as it runs, held to
      VOL_TOL["float32"], a bound set from the measurement: a ReLU gate
      within rounding of zero could flip between devices (the audio path's
      case, ROADMAP queue 3), and on these inputs none does;
    - float64 through the same object's engine on the stacked noisy batch
      (every coefficient's gradient), held to VOL_TOL["float64"]."""
    import numpy as np

    n_vol, side, n_smp = VOL_REDUCED
    _precision(torch, False)
    rng = np.random.default_rng(SEED + 3)
    x = torch.from_numpy(rng.standard_normal((n_vol, 1) + (side,) * 3).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((n_smp,) + tuple(x.shape)).astype(np.float32))
    y = torch.arange(n_vol) % VOL_CLASSES
    f32, f64 = {}, {}
    for dev in (DEVICE, "cpu"):
        wam = vol_wam(wtt, bind_vol(torch, wtt, state, dev), dev, n_samples=n_smp)
        f32[dev] = wam(x.to(dev), y.to(dev), noise=z.to(dev))
        wam = vol_wam(wtt, bind_vol(torch, wtt, state, dev, torch.float64), dev, n_samples=n_smp)
        x64, z64 = x[:, 0].to(dev, torch.float64), z[:, :, 0].to(dev, torch.float64)
        noisy = x64 + z64 * wtt.noise_sigma(x64, VOL_SPREAD).reshape(-1, 1, 1, 1)
        _, grads = wam.engine.attribute(noisy.reshape((-1,) + (side,) * 3),
                                        y.to(dev).repeat(n_smp), samples=n_smp)
        f64[dev] = torch.cat(_flat_grads(grads))
    return {"float32": _held(torch, "reduced check vol float32, WaveletAttribution3D cube",
                             f32[DEVICE], f32["cpu"], VOL_TOL["float32"]),
            "float64": _held(torch, "reduced check vol float64, engine coefficient gradients",
                             f64[DEVICE], f64["cpu"], VOL_TOL["float64"])}


def _waverec3_forms(torch, wtt, x) -> dict:
    """`waverec3` on both synthesis forms at the headline's shapes (one
    128-row chunk of VOL_SIDE^3 volumes), forward and forward + backward,
    event-timed in turns (conv, matmul, matmul, conv)."""
    dev = torch.device(DEVICE)
    vol = x[:, 0].repeat(VOL_CHUNK, 1, 1, 1)
    from wam_tpu_torch.core.engine import _flatten, _unflatten

    with torch.no_grad():
        coeffs = wtt.wavedec3(vol, VOL_WAVELET, VOL_LEVELS, VOL_MODE)
    leaves = [t.detach().requires_grad_(True) for t in _flatten(coeffs)]
    tree = _unflatten(leaves, coeffs)
    g = torch.randn(vol.shape, device=dev)
    out = {}
    for impl in ("conv", "matmul", "matmul", "conv"):
        def fwd():
            with torch.no_grad():
                return wtt.waverec3(tree, VOL_WAVELET, impl=impl)

        def fwd_bwd():
            rec = wtt.waverec3(tree, VOL_WAVELET, impl=impl)
            return torch.autograd.grad(rec, leaves, g)

        out.setdefault(impl, []).append({"forward_ms": _time_ms(fwd),
                                         "forward_backward_ms": _time_ms(fwd_bwd)})
    with torch.no_grad():
        rec = {impl: wtt.waverec3(tree, VOL_WAVELET, impl=impl) for impl in ("conv", "matmul")}
    out["max_abs_diff"] = float((rec["conv"] - rec["matmul"]).abs().max())
    _log(f"  waverec3 forms at ({VOL_CHUNK * VOL_BATCH}, {VOL_SIDE}^3), haar J=2, ms in turns: "
         f"conv {out['conv']}, matmul {out['matmul']}; max abs diff {out['max_abs_diff']:.3e}")
    return out


def phase_vol(torch, wtt, kernels, smi: str) -> dict:
    """The vol path: the headline (TF32 on for the model) with its launch
    counts checked, the IG arm, the matmul-synthesis arm, the fold_bn +
    fused_relu_vjp arm (K4/K5 asserted), both synthesis forms of
    `waverec3` timed, and the reduced checks."""
    import numpy as np

    state, fn, x, y = build_vol(torch, wtt)
    dev = torch.device(DEVICE)
    _log(f"phase vol: ResNet3D-18({VOL_CLASSES}, width {VOL_WIDTH}) x ({VOL_BATCH},1,{VOL_SIDE},"
         f"{VOL_SIDE},{VOL_SIDE}) {VOL_WAVELET} J={VOL_LEVELS} {VOL_MODE} smooth "
         f"n_samples={VOL_SAMPLES} stdev_spread={VOL_SPREAD} sample_batch_size={VOL_CHUNK}")
    prec = _precision(torch, True)
    _log(f"  precision: {prec} (the model); the transform in full float32 whatever the "
         "setting (conv3d / conv_transpose3d with cuDNN TF32 off, synthesis3_mm with cuBLAS "
         "TF32 off)")
    cube = (VOL_BATCH,) + (VOL_SIDE,) * 3
    run = _time_calls(torch, kernels, vol_wam(wtt, fn, dev), x, y, VOL_CALLS, items=VOL_BATCH,
                      unit="volumes")
    _check_cube(torch, run, "vol", cube, ZERO_LAUNCHES)
    _log(f"  launches of one call: {run['call_launches']} (asserted == {ZERO_LAUNCHES})")
    _log_run(f"headline, {prec}", run, smi, "volumes")
    summary = {k: v for k, v in run.items() if k != "out"}
    summary["precision"] = prec

    arms = (("integratedgrad", "IG, 25 path points", dict(method="integratedgrad"), fn,
             ZERO_LAUNCHES),
            ("matmul_synthesis", "synthesis3_mm synthesis (impl='kernel')",
             dict(impl="kernel"), fn, ZERO_LAUNCHES),
            ("fused", "fold_bn=True, fused_relu_vjp=True",
             {}, bind_vol(torch, wtt, state, dev, fold_bn=True, fused_relu_vjp=True),
             VOL_FUSED_LAUNCHES))
    for key, tag, kw, arm_fn, launches in arms:
        arm = _time_calls(torch, kernels, vol_wam(wtt, arm_fn, dev, **kw), x, y, 3,
                          items=VOL_BATCH, unit="volumes")
        _check_cube(torch, arm, f"vol, {tag}", cube, launches)
        cos = _cosine(torch, arm["out"], run["out"])
        _log(f"  {tag}: launches of one call {arm['call_launches']} (asserted == {launches})")
        _log_run(f"{tag}, {prec}", arm, smi, "volumes")
        _log(f"  {tag}: cube cosine to the headline {cos:.8f}")
        summary[key] = {**{k: v for k, v in arm.items() if k not in ("out", "launches")},
                        "cosine_to_headline": cos}
        del arm
    summary["waverec3_forms"] = _waverec3_forms(torch, wtt, x)

    # the fused ReLU against the plain model: TF32 off, and cuDNN on its
    # deterministic algorithms, whose sums do not vary from call to call
    # (its split-K input-gradient kernels move a result by ~1e-6 of the max)
    _precision(torch, False)
    torch.backends.cudnn.deterministic = True
    n_smp = VOL_REDUCED[2]
    z = np.random.default_rng(SEED + 5).standard_normal((n_smp,) + tuple(x.shape))
    z = torch.from_numpy(z.astype(np.float32)).to(dev)
    plain = vol_wam(wtt, fn, dev, n_samples=n_smp)(x, y, noise=z)
    fused = vol_wam(wtt, bind_vol(torch, wtt, state, dev, fused_relu_vjp=True), dev,
                    n_samples=n_smp)(x, y, noise=z)
    torch.backends.cudnn.deterministic = False
    summary["fused_check"] = _held(
        torch, f"fused check (TF32 off, cudnn.deterministic, {VOL_BATCH} volumes x {n_smp} "
        "samples): fused_relu_vjp vs plain model", fused, plain, VOL_FUSED_TOL)
    summary["reduced_check"] = _vol_reduced_check(torch, wtt, state)
    return summary


def build_voxel(torch, wtt):
    """The voxel3d phase's set-up: `VoxelModel` (10 classes, weights by the
    port's initialisers from torch's generator seeded SEED) bound on the
    card, VOXEL_BATCH volumes of VOXEL_SIDE^3 occupancies uniform in [0, 1)
    from numpy seeded SEED + 5, labels arange % 10; and `PointNetCls` (k=10,
    seeded the same way, calibrated on 16 clouds from SEED + 7), CLOUD_BATCH
    standard-normal clouds of CLOUD_POINTS points from SEED + 6. Returns
    (voxel state, voxel fn, x, y, cloud state, cloud fn, clouds, labels)."""
    import numpy as np

    dev = torch.device(DEVICE)
    torch.manual_seed(SEED)
    voxel = wtt.VoxelModel(num_classes=10)
    vstate = {k: v.detach().clone() for k, v in voxel.state_dict().items()}
    vfn = wtt.bind_inference(voxel, device=dev)
    x = np.random.default_rng(SEED + 5).uniform(size=(VOXEL_BATCH, 1) + (VOXEL_SIDE,) * 3)
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    y = torch.arange(VOXEL_BATCH, device=dev) % 10
    torch.manual_seed(SEED)
    cloud = wtt.PointNetCls(k=10).to(dev)
    calib = np.random.default_rng(SEED + 7).standard_normal((16, 3, CLOUD_POINTS))
    _calibrate(torch, cloud, torch.from_numpy(calib.astype(np.float32)).to(dev))
    cstate = {k: v.detach().cpu() for k, v in cloud.state_dict().items()}
    cfn = wtt.bind_inference(cloud, device=dev)
    pts = np.random.default_rng(SEED + 6).standard_normal((CLOUD_BATCH, 3, CLOUD_POINTS))
    pts = torch.from_numpy(pts.astype(np.float32)).to(dev)
    return vstate, vfn, x, y, cstate, cfn, pts, torch.arange(CLOUD_BATCH, device=dev) % 10


def voxel_wam(wtt, fn, device, n_samples: int | None = None):
    return wtt.WaveletAttribution3D(fn, wavelet=VOL_WAVELET, J=VOL_LEVELS, mode=VOL_MODE,
                                    n_samples=n_samples or VOL_SAMPLES, stdev_spread=VOL_SPREAD,
                                    sample_batch_size=VOXEL_CHUNK, device=device)


def cloud_wam(wtt, fn, device):
    return wtt.BaseWAM3D(fn, wavelet=VOL_WAVELET, J=CLOUD_LEVELS, mode=VOL_MODE,
                         instance="point_clouds", device=device)


def _voxel3d_reduced_check(torch, wtt, vstate, cstate) -> dict:
    """Card against CPU in float64 (TF32 off), held to VOL_TOL["float64"]:
    the voxel model's coefficient gradients through the engine on
    VOL_REDUCED[2] noisy copies of VOL_REDUCED[0] volumes of VOXEL_SIDE^3,
    and PointNetCls's per-axis coefficient gradients on CLOUD_REDUCED
    clouds."""
    import numpy as np

    _precision(torch, False)
    n_vol, _, n_smp = VOL_REDUCED
    rng = np.random.default_rng(SEED + 8)
    x = torch.from_numpy(rng.uniform(size=(n_smp * n_vol,) + (VOXEL_SIDE,) * 3))
    pts = torch.from_numpy(rng.standard_normal((CLOUD_REDUCED[0], 3, CLOUD_REDUCED[1])))
    yv, yc = torch.arange(n_smp * n_vol) % 10, torch.arange(CLOUD_REDUCED[0]) % 10
    vox, cloud = {}, {}
    for dev in (DEVICE, "cpu"):
        vfn = wtt.bind_inference(wtt.VoxelModel(num_classes=10).double(), vstate, device=dev)
        _, grads = voxel_wam(wtt, vfn, dev, n_smp).engine.attribute(
            x.to(dev), yv.to(dev), samples=n_smp)
        vox[dev] = torch.cat(_flat_grads(grads))
        cfn = wtt.bind_inference(wtt.PointNetCls(k=10).double(), cstate, device=dev)
        grads = cloud_wam(wtt, cfn, dev)(pts.to(dev), yc.to(dev))
        cloud[dev] = torch.cat([g.reshape(-1) for axis in grads for g in axis])
    return {"voxel": _held(torch, "reduced check voxel float64, engine coefficient gradients",
                           vox[DEVICE], vox["cpu"], VOL_TOL["float64"]),
            "point_clouds": _held(torch, "reduced check PointNet float64, per-axis coefficient "
                                  "gradients", cloud[DEVICE], cloud["cpu"], VOL_TOL["float64"])}


def phase_voxel3d(torch, wtt, kernels, smi: str) -> dict:
    """The reference's own 3D models: `VoxelModel` SmoothGrad timed, then
    `visualize`, one `BaseWAM3D` pass and `filter_voxels`; `PointNetCls`
    with `BaseWAM3D(instance="point_clouds")` timed, then
    `filter_point_clouds`; no port kernel may launch; then the float64
    card-against-CPU check."""
    vstate, vfn, x, y, cstate, cfn, pts, yc = build_voxel(torch, wtt)
    dev = torch.device(DEVICE)
    prec = _precision(torch, True)
    _log(f"phase voxel3d: VoxelModel(10) x ({VOXEL_BATCH},1,{VOXEL_SIDE},{VOXEL_SIDE},"
         f"{VOXEL_SIDE}) {VOL_WAVELET} J={VOL_LEVELS} {VOL_MODE} smooth n_samples={VOL_SAMPLES} "
         f"sample_batch_size={VOXEL_CHUNK}; {prec}")
    wam = voxel_wam(wtt, vfn, dev)
    run = _time_calls(torch, kernels, wam, x, y, VOXEL_CALLS, items=VOXEL_BATCH, unit="volumes")
    _check_cube(torch, run, "voxel3d", (VOXEL_BATCH,) + (VOXEL_SIDE,) * 3, ZERO_LAUNCHES)
    _log_run("VoxelModel SmoothGrad", run, smi, "volumes")
    vis = wam.visualize()
    wam.evaluate_voxels(x, y)
    filt = wam.filter_voxels()
    launches = kernels.launch_counts()
    for name, t, shape in (("visualize", vis, (VOXEL_BATCH, VOL_LEVELS + 2) + (VOXEL_SIDE,) * 3),
                           ("filter_voxels", filt, (VOXEL_BATCH, 1) + (VOXEL_SIDE,) * 3)):
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"voxel3d {name}: shape {tuple(t.shape)} != {shape} or not finite")
    _log(f"  visualize {tuple(vis.shape)}, filter_voxels {tuple(filt.shape)}: finite")
    summary = {"voxel": {k: v for k, v in run.items() if k != "out"}, "precision": prec}

    _log(f"  PointNetCls(10) x ({CLOUD_BATCH},3,{CLOUD_POINTS}) BaseWAM3D point_clouds "
         f"{VOL_WAVELET} J={CLOUD_LEVELS} {VOL_MODE}")
    cwam = cloud_wam(wtt, cfn, dev)
    crun = _time_calls(torch, kernels, cwam, pts, yc, VOXEL_CALLS, items=CLOUD_BATCH,
                       unit="clouds")
    grads = crun["out"]
    if [len(a) for a in grads] != [CLOUD_LEVELS + 1] * 3 or not all(
            bool(torch.isfinite(g).all()) for a in grads for g in a):
        raise AssertionError("point clouds: gradients are not 3 x (J + 1) finite levels")
    kept, norm = cwam.filter_point_clouds()
    if len(kept) != CLOUD_BATCH or any(k.ndim != 2 or k.shape[1] != 3 for k in kept) \
            or norm.shape != (CLOUD_BATCH, CLOUD_POINTS):
        raise AssertionError("filter_point_clouds: not (n_kept, 3) arrays per cloud")
    for tag, counts in (("voxel", run["call_launches"]), ("visualize and filter", launches),
                        ("point clouds", crun["launches"])):
        if counts != ZERO_LAUNCHES:
            raise AssertionError(f"voxel3d {tag}: a port kernel launched: {counts}")
    _log(f"  launches: voxel {run['call_launches']}, point clouds {crun['launches']} (all 0, "
         "asserted)")
    _log_run("PointNetCls point-cloud pass", crun, smi, "clouds")
    _log(f"  filter_point_clouds: kept {sum(len(k) for k in kept)} of "
         f"{CLOUD_BATCH * CLOUD_POINTS} points")
    summary["point_clouds"] = {k: v for k, v in crun.items() if k != "out"}
    summary["reduced_check"] = _voxel3d_reduced_check(torch, wtt, vstate, cstate)
    return summary


# -- the evaluation phases --------------------------------------------------------


def build_eval2d(torch, wtt):
    """The eval2d phase's set-up, shared with scripts/torch_slice_profile.py,
    as scripts/bench_eval.py sets it up: ResNet-50 with 1000 classes, weights
    from torch's generator seeded SEED, bound with ``nchw=True,
    compute_dtype=torch.bfloat16, fold_bn=True``; EVAL_BATCH standard-normal
    images of 3 x 224^2 from a generator seeded SEED + 1, labels 0..7 as host
    ints; `WaveletAttribution2D` (haar, J=3, 8 SmoothGrad samples, streamed
    noise) as the explainer and `Eval2DWAM` (haar, J=3, 128 rows a model
    call) on the kernels. Returns (float32 state dict of the model, evaluator,
    x, y)."""
    dev = torch.device(DEVICE)
    torch.manual_seed(SEED)
    model = wtt.resnet50(num_classes=EVAL_CLASSES)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    fn = wtt.bind_inference(model, nchw=True, compute_dtype=torch.bfloat16, fold_bn=True,
                            device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn((EVAL_BATCH, CHANNELS, EVAL_SIDE, EVAL_SIDE), generator=g, device=dev)
    explainer = wtt.WaveletAttribution2D(fn, wavelet=EVAL_WAVELET, J=EVAL_LEVELS,
                                         n_samples=EVAL_EXPLAIN_SAMPLES, stream_noise=True,
                                         device=dev)
    ev = wtt.Eval2DWAM(fn, explainer, wavelet=EVAL_WAVELET, J=EVAL_LEVELS, batch_size=EVAL_CAP,
                       device=dev)
    return state, ev, x, list(range(EVAL_BATCH))


def eval2d_calls(ev, x, y) -> dict:
    """The eval2d phase's metric calls at the headline geometry; insertion
    and deletion return (scores, curves)."""
    return {"insertion": lambda: (ev.insertion(x, y, n_iter=EVAL_N_ITER), ev.insertion_curves),
            "deletion": lambda: (ev.deletion(x, y, n_iter=EVAL_N_ITER), ev.deletion_curves),
            "mu_fidelity": lambda: ev.mu_fidelity(x, y, grid_size=MU_GRID,
                                                  sample_size=MU_SAMPLES,
                                                  subset_size=MU_SUBSET)}


def _sync_sites(torch, call) -> tuple:
    """``call()``'s result and its host waits on the device, counted by
    torch's sync debug mode (each synchronizing CUDA call warns), each with
    the innermost lines of the repository's code on its stack."""
    import traceback
    import warnings

    syncs = []

    def record(message, category, filename, lineno, file=None, line=None):
        # the debug mode's own one-time notice ("... a prototype feature ...
        # synchronizing operations") is not a wait
        if "called a synchronizing CUDA operation" in str(message):
            frames = [f"{Path(f.filename).name}:{f.lineno} {f.name}"
                      for f in traceback.extract_stack()[:-1] if str(ROOT) in f.filename]
            syncs.append(frames[-3:] + [f"{Path(filename).name}:{lineno}"])

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, syncs


def _counted_call(torch, kernels, fan, call) -> dict:
    """One metric call with the launch counts set to 0 just before and read
    just after; its counted result fetches (`fan.fetch_scope`); and its host
    waits on the device (`_sync_sites`: the result fetch is one)."""
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    with fan.fetch_scope() as fs:
        out, syncs = _sync_sites(torch, call)
    return {"out": out, "launches": kernels.launch_counts(), "fetches": fs.count,
            "host_syncs": len(syncs), "sync_sites": syncs}


def _time_metric(torch, fan, call, calls: int, items: int, unit: str,
                 fetched: bool = True) -> dict:
    """``calls`` calls of a metric, each timed by CUDA events around it (it
    ends in its result fetch, so the events span the whole call) and by the
    host clock; ``enqueue_ms`` is the host time from the call's start to its
    fetch (to its return where ``fetched`` is false: an explanation fetches
    nothing), the time the host took to queue the call's device work (near
    the event time, the call is bound by the host). Peak memory over the
    calls; ``items`` a call give ``{unit}_per_s``."""
    real, marks = fan.device_fetch, []

    def marked(out):
        marks.append(time.perf_counter())
        return real(out)

    torch.cuda.reset_peak_memory_stats()
    times, walls, enqueue = [], [], []
    fan.device_fetch = marked
    try:
        for _ in range(calls):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            call()
            done = time.perf_counter()
            end.record()
            walls.append((time.perf_counter() - t0) * 1e3)
            enqueue.append(((marks[-1] if fetched else done) - t0) * 1e3)
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
    finally:
        fan.device_fetch = real
    med = sorted(times)[len(times) // 2]
    return {"calls_ms": times, "median_ms": med, "spread_ms": [min(times), max(times)],
            "wall_ms": walls, "enqueue_ms": sorted(enqueue)[len(enqueue) // 2],
            f"{unit}_per_s": items / (med / 1e3),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def _run_metrics(torch, kernels, fan, calls: dict, expected: dict, rows: dict, items: int,
                 unit: str, smi: str) -> dict:
    """Each metric: a warm call, the counted call (launches == ``expected``,
    exactly one fetch and one host wait, asserted), then EVAL_CALLS timed
    calls."""
    out = {}
    for name, call in calls.items():
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        run = _counted_call(torch, kernels, fan, call)
        _log(f"  {name}: launches of one call {run['launches']} (asserted == {expected[name]}); "
             f"result fetches {run['fetches']}, host waits on the device {run['host_syncs']} "
             f"{run['sync_sites']} (each asserted == 1)")
        if run["launches"] != expected[name]:
            raise AssertionError(f"{name}: launches {run['launches']} != {expected[name]}")
        if run["fetches"] != 1 or run["host_syncs"] != 1:
            raise AssertionError(f"{name}: {run['fetches']} result fetches and "
                                 f"{run['host_syncs']} host waits in one call, expected 1 each")
        timed = _time_metric(torch, fan, call, EVAL_CALLS, items, unit)
        _log(f"  {name}: first call {first_s:.3f} s; {EVAL_CALLS} calls (CUDA events) "
             f"{[round(t, 3) for t in timed['calls_ms']]} ms, median {timed['median_ms']:.3f} ms "
             f"(spread {timed['spread_ms'][0]:.3f}-{timed['spread_ms'][1]:.3f}) = "
             f"{timed[f'{unit}_per_s']:.2f} {unit}/s, {rows[name]} model rows a call = "
             f"{rows[name] / (timed['median_ms'] / 1e3):.1f} rows/s; host enqueue "
             f"{timed['enqueue_ms']:.3f} ms; peak memory {timed['peak_memory_gb']:.3f} GB on {smi}")
        out[name] = {**{k: v for k, v in run.items() if k != "out"}, **timed,
                     "first_call_s": first_s, "rows": rows[name], "result": run["out"]}
    return out


def _check_eval2d(np, res: dict) -> None:
    """Scores in [0, 1], curves (B, 65) of probabilities, μ in [-1, 1], all
    finite; insertion's last step and deletion's first both run the full
    reconstruction, so they give the same probability."""
    for name in ("insertion", "deletion"):
        scores, curves = res[name]["result"]
        curves = np.stack(curves)
        if len(scores) != EVAL_BATCH or curves.shape != (EVAL_BATCH, EVAL_N_ITER + 1):
            raise AssertionError(f"{name}: {len(scores)} scores, curves {curves.shape}")
        if not (np.isfinite(scores).all() and np.isfinite(curves).all()
                and 0 <= min(scores) and max(scores) <= 1 and curves.min() >= 0
                and curves.max() <= 1):
            raise AssertionError(f"{name}: scores or curves not finite probabilities")
    full_ins = np.stack(res["insertion"]["result"][1])[:, -1]
    full_del = np.stack(res["deletion"]["result"][1])[:, 0]
    err = float(np.abs(full_ins - full_del).max())
    _log(f"  insertion's full step against deletion's: max abs diff {err:.3e} (tol "
         f"{1e-6 * float(full_del.max()):.3e})")
    if err > 1e-6 * float(full_del.max()):
        raise AssertionError("the full reconstruction gives two probabilities")
    mu = np.asarray(res["mu_fidelity"]["result"])
    if mu.shape != (EVAL_BATCH,) or not np.isfinite(mu).all() or np.abs(mu).max() > 1:
        raise AssertionError(f"μ-fidelity values {mu}")


def _eval2d_reduced_check(torch, wtt, state, x, wams) -> dict:
    """The kernel path (impl="kernel") against the plain path
    (impl="matmul") on EVAL_REDUCED images with the headline explainer's
    mosaics handed to both, ResNet-50 in float32 with the same weights, TF32
    off: insertion and deletion scores and curves, μ values, held to
    EVAL_TOL."""
    import numpy as np

    _precision(torch, False)
    dev = torch.device(DEVICE)
    fn = wtt.bind_inference(wtt.resnet50(num_classes=EVAL_CLASSES), state, nchw=True, device=dev)
    n, res = EVAL_REDUCED, {}
    for impl in ("kernel", "matmul"):
        ev = wtt.Eval2DWAM(fn, None, wavelet=EVAL_WAVELET, J=EVAL_LEVELS, batch_size=EVAL_CAP,
                           device=dev, impl=impl)
        ev.grad_wams = wams[:n]
        xs, ys = x[:n], list(range(n))
        res[impl] = {"insertion": ev.insertion(xs, ys, n_iter=EVAL_N_ITER),
                     "insertion_curves": np.stack(ev.insertion_curves),
                     "deletion": ev.deletion(xs, ys, n_iter=EVAL_N_ITER),
                     "deletion_curves": np.stack(ev.deletion_curves),
                     "mu_fidelity": ev.mu_fidelity(xs, ys, grid_size=MU_GRID,
                                                   sample_size=MU_SAMPLES, subset_size=MU_SUBSET)}
    out = {}
    for key, tol in (("insertion", "auc"), ("deletion", "auc"), ("insertion_curves", "curve"),
                     ("deletion_curves", "curve"), ("mu_fidelity", "mu")):
        a, b = np.asarray(res["kernel"][key], np.float64), np.asarray(res["matmul"][key], np.float64)
        err = float(np.abs(a - b).max())
        bound = EVAL_TOL[tol] * (float(np.abs(b).max()) if tol == "curve" else 1.0)
        _log(f"  reduced check ({n} images, float32 model, TF32 off) {key}: kernel vs plain max "
             f"abs err {err:.3e} (tol {bound:.3e}); kernel {np.round(a.ravel()[:4], 6).tolist()} "
             f"plain {np.round(b.ravel()[:4], 6).tolist()}")
        if not (math.isfinite(err) and err <= bound):
            raise AssertionError(f"eval2d reduced check: {key} on the kernel path disagrees "
                                 "with the plain path")
        out[key] = {"max_abs_err": err, "tol": bound}
    return out


def phase_eval2d(torch, wtt, kernels, smi: str) -> dict:
    """The evaluation of 2D attributions at bench_eval.py's full geometry:
    the explainer's mosaics once, then insertion, deletion and μ-fidelity,
    each counted (K1 and K3 as EVAL_LAUNCHES says, one fetch, one host wait)
    and timed; then the reduced kernel-vs-plain check."""
    import numpy as np

    from wam_tpu_torch.evalsuite import fan

    state, ev, x, y = build_eval2d(torch, wtt)
    prec = _precision(torch, True)
    _log(f"phase eval2d: Eval2DWAM on ResNet-50({EVAL_CLASSES}, bfloat16, fold_bn) x "
         f"({EVAL_BATCH},{CHANNELS},{EVAL_SIDE},{EVAL_SIDE}) {EVAL_WAVELET} J={EVAL_LEVELS} "
         f"batch_size={EVAL_CAP}; insertion/deletion n_iter={EVAL_N_ITER}; μ grid={MU_GRID} "
         f"samples={MU_SAMPLES} subset={MU_SUBSET}; explainer SmoothGrad "
         f"n={EVAL_EXPLAIN_SAMPLES} stream_noise; {prec}")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ev.precompute(x, y)
    end.record()
    torch.cuda.synchronize()
    explain_ms = start.elapsed_time(end)
    _log(f"  explainer (first call, cached for the metrics): {explain_ms:.3f} ms, mosaics "
         f"{tuple(ev.grad_wams.shape)}")
    res = _run_metrics(torch, kernels, fan, eval2d_calls(ev, x, y), EVAL_LAUNCHES, EVAL_ROWS,
                       EVAL_BATCH, "images", smi)
    _check_eval2d(np, res)
    summary = {name: {k: v for k, v in r.items() if k != "result"} for name, r in res.items()}
    summary.update(precision=prec, explain_first_call_ms=explain_ms,
                   insertion_scores=res["insertion"]["result"][0],
                   deletion_scores=res["deletion"]["result"][0],
                   mu_values=res["mu_fidelity"]["result"])
    summary["reduced_check"] = _eval2d_reduced_check(torch, wtt, state, x, ev.grad_wams)
    return summary


def build_eval1d(torch, wtt):
    """The eval1d phase's set-up, as bench_eval.py sets it up: the audio
    phase's AudioCNN (`build_audio`: 50 classes, float32) and its first
    EVAL1D_BATCH waveforms of 220,500 samples, `WaveletAttribution1D`
    SmoothGrad (db6, J=5, 8 samples, 8 a model call) as the explainer, and
    `Eval1DWAM` (db6, J=5, 32 rows a model call). Returns (model, evaluator,
    x, y)."""
    model, fn, x, y = build_audio(torch, wtt)
    dev = torch.device(DEVICE)
    kw = dict(n_mels=N_MELS, n_fft=N_FFT, sample_rate=SAMPLE_RATE, device=dev)
    explainer = wtt.WaveletAttribution1D(fn, wavelet=AUDIO_WAVELET, J=AUDIO_LEVELS,
                                         method="smooth", n_samples=EVAL1D_SAMPLES,
                                         stdev_spread=AUDIO_SPREAD,
                                         sample_batch_size=EVAL1D_CHUNK, **kw)
    ev = wtt.Eval1DWAM(fn, explainer, wavelet=AUDIO_WAVELET, J=AUDIO_LEVELS,
                       batch_size=EVAL1D_CAP, **kw)
    return model, ev, x[:EVAL1D_BATCH].contiguous(), y[:EVAL1D_BATCH].tolist()


def _eval1d_reduced_check(torch, wtt, model) -> dict:
    """The port on the card against the port on the CPU, the same weights,
    waveforms and seeded explanations (ties included) handed to both, TF32
    off, EVAL1D_REDUCED waveforms, samples and steps:

    - float32 through `Eval1DWAM`: insertion on the wavelet target and
      deletion on the mel target (scores and curves), faithfulness of
      spectra, and input fidelity (its classes equal);
    - float64 through one waveform's fan step
      (`Eval1DWAM.perturbed_from_wavelet`, the mask family, the inverse
      transform, the peak renormalization and the mel front end) and the
      model's scores on it."""
    import numpy as np

    n_wave, length, n_iter = EVAL1D_REDUCED
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(SEED + 5)
    x = (0.1 * rng.standard_normal((n_wave, length))).astype(np.float32)
    lens, m = [], length
    for _ in range(AUDIO_LEVELS):
        m = (m + 12 - 1) // 2  # db6 has 12 taps
        lens.append(m)
    mel = np.round(rng.standard_normal((n_wave, 1 + length // (N_FFT // 2), N_MELS)), 1)
    coeffs = [np.round(rng.standard_normal((n_wave, k)), 2) for k in [lens[-1]] + lens[::-1]]
    y = list(range(n_wave))
    kw = dict(wavelet=AUDIO_WAVELET, J=AUDIO_LEVELS, n_mels=N_MELS, n_fft=N_FFT,
              sample_rate=SAMPLE_RATE, batch_size=EVAL1D_CAP)
    f32, f64 = {}, {}
    for dev in (DEVICE, "cpu"):
        fn = wtt.bind_audio_inference(wtt.AudioCNN(num_classes=AUDIO_CLASSES), state, device=dev)
        ev = wtt.Eval1DWAM(fn, None, device=dev, **kw)
        ev.grad_wams = (torch.tensor(mel, dtype=torch.float32, device=dev),
                        [torch.tensor(c, dtype=torch.float32, device=dev) for c in coeffs])
        xs = torch.from_numpy(x).to(dev)
        ins = ev.insertion(xs, y, target="wavelet", n_iter=n_iter)
        dele = ev.deletion(xs, y, target="melspec", n_iter=n_iter)
        f32[dev] = {"insertion": ins, "insertion_curves": np.stack(ev.insertion_curves),
                    "deletion": dele, "deletion_curves": np.stack(ev.deletion_curves),
                    "faithfulness_of_spectra": ev.faithfulness_of_spectra(xs, y),
                    "input_fidelity": ev.input_fidelity(xs, y)}
        fn = wtt.bind_audio_inference(wtt.AudioCNN(num_classes=AUDIO_CLASSES).double(), state,
                                      device=dev)
        ev = wtt.Eval1DWAM(fn, None, device=dev, **kw)
        with torch.no_grad():
            fan = ev.perturbed_from_wavelet(
                torch.tensor(x[0], dtype=torch.float64, device=dev),
                [torch.tensor(c[0], dtype=torch.float64, device=dev) for c in coeffs],
                "insertion", n_iter)
            f64[dev] = {"fan_mels": fan.cpu().numpy(), "scores": fn(fan).cpu().numpy()}
    out = {}
    if f32[DEVICE]["input_fidelity"] != f32["cpu"]["input_fidelity"]:
        raise AssertionError(f"eval1d reduced check: input fidelity's classes differ: card "
                             f"{f32[DEVICE]['input_fidelity']}, CPU {f32['cpu']['input_fidelity']}")
    for prec, res in (("float32", f32), ("float64", f64)):
        for key in res["cpu"]:
            if key == "input_fidelity":
                continue
            a, b = np.asarray(res[DEVICE][key], np.float64), np.asarray(res["cpu"][key], np.float64)
            peak = float(np.abs(b).max()) if prec == "float64" else 1.0
            err, bound = float(np.abs(a - b).max()), EVAL1D_TOL[prec] * peak
            _log(f"  reduced check {prec} {key}: card vs CPU max abs err {err:.3e} "
                 f"(tol {bound:.3e})")
            if not (math.isfinite(err) and err <= bound):
                raise AssertionError(f"eval1d reduced check ({prec}): {key} on the card "
                                     "disagrees with the CPU")
            out[f"{prec} {key}"] = {"max_abs_err": err, "tol": bound}
    out["input_fidelity"] = f32[DEVICE]["input_fidelity"]
    return out


def phase_eval1d(torch, wtt, kernels, smi: str) -> dict:
    """The evaluation of 1D attributions at bench_eval.py's geometry: the
    explainer once, then wavelet-target insertion (n_iter 64) and input
    fidelity, each counted (no port kernel launches, one fetch, one host
    wait) and timed; then the card-against-CPU checks."""
    import numpy as np

    from wam_tpu_torch.evalsuite import fan

    model, ev, x, y = build_eval1d(torch, wtt)
    _log(f"phase eval1d: Eval1DWAM on AudioCNN({AUDIO_CLASSES}) x ({EVAL1D_BATCH},{AUDIO_LEN}) "
         f"{AUDIO_WAVELET} J={AUDIO_LEVELS} batch_size={EVAL1D_CAP}; insertion target=wavelet "
         f"n_iter={EVAL_N_ITER}; input_fidelity target=wavelet; explainer SmoothGrad "
         f"n={EVAL1D_SAMPLES} chunk {EVAL1D_CHUNK}; cudnn.allow_tf32=True "
         "matmul.allow_tf32=False")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ev.precompute(x, y)
    end.record()
    torch.cuda.synchronize()
    explain_ms = start.elapsed_time(end)
    _log(f"  explainer (first call, cached for the metrics): {explain_ms:.3f} ms")
    calls = {"insertion": lambda: (ev.insertion(x, y, target="wavelet", n_iter=EVAL_N_ITER),
                                   ev.insertion_curves),
             "input_fidelity": lambda: ev.input_fidelity(x, y, target="wavelet")}
    res = _run_metrics(torch, kernels, fan, calls, {m: ZERO_LAUNCHES for m in calls},
                       EVAL1D_ROWS, EVAL1D_BATCH, "waveforms", smi)
    scores, curves = res["insertion"]["result"]
    curves = np.stack(curves)
    if (curves.shape != (EVAL1D_BATCH, EVAL_N_ITER + 1) or not np.isfinite(curves).all()
            or not np.isfinite(scores).all()):
        raise AssertionError(f"eval1d insertion: curves {curves.shape} not finite")
    preds = res["input_fidelity"]["result"]
    if [len(p) for p in preds] != [2] * EVAL1D_BATCH:
        raise AssertionError(f"eval1d input fidelity: {preds}")
    summary = {name: {k: v for k, v in r.items() if k != "result"} for name, r in res.items()}
    summary.update(explain_first_call_ms=explain_ms, insertion_scores=scores,
                   input_fidelity_classes=preds)
    summary["reduced_check"] = _eval1d_reduced_check(torch, wtt, model)
    return summary


# -- the baselines phase ------------------------------------------------------------


def build_baselines(torch, wtt, method: str):
    """The baselines phase's image registry, shared with
    scripts/torch_slice_profile.py, at scripts/bench_methods.py's geometry:
    ResNet-50 with 1000 classes, weights from torch's generator seeded SEED
    (built on the host and copied by the evaluator), `EvalImageBaselines`
    (``method``, bfloat16, 64 rows a model call, 8 path points or noisy
    copies); BASE_BATCH standard-normal images of 3 x
    224^2 from a generator seeded SEED + 7, labels 0..3 as host ints.
    Returns (evaluator, x, y)."""
    dev = torch.device(DEVICE)
    torch.manual_seed(SEED)
    model = wtt.resnet50(num_classes=EVAL_CLASSES)
    ev = wtt.EvalImageBaselines(model, None, method=method, compute_dtype=torch.bfloat16,
                                batch_size=BASE_CAP, n_samples=BASE_SAMPLES, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    x = torch.randn((BASE_BATCH, CHANNELS, EVAL_SIDE, EVAL_SIDE), generator=g, device=dev)
    return ev, x, list(range(BASE_BATCH))


def _time_explain(torch, kernels, fan, ev, x, y, unit: str) -> dict:
    """One warm explanation; one counted by `_counted_call` (launches
    asserted == ZERO_LAUNCHES; its fetches and host waits); then BASE_CALLS
    timed by `_time_metric`, the enqueue time ending where the call
    returns. Returns the counted call's explanation under ``out``."""
    call = lambda: ev.compute_explanations(x, y)  # noqa: E731
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    run = _counted_call(torch, kernels, fan, call)
    if run["launches"] != ZERO_LAUNCHES:
        raise AssertionError(f"explanation launched port kernels: {run['launches']}")
    timed = _time_metric(torch, fan, call, BASE_CALLS, x.shape[0], unit, fetched=False)
    return {"out": run["out"], "first_call_s": first_s, "launches": run["launches"],
            "fetches": run["fetches"], "host_syncs": run["host_syncs"], **timed}


def _check_scores(np, tag: str, scores, n: int) -> None:
    scores = np.asarray(scores, np.float64)
    if scores.shape != (n,) or not np.isfinite(scores).all() or scores.min() < 0 \
            or scores.max() > 1:
        raise AssertionError(f"{tag}: scores {scores} are not {n} finite values in [0, 1]")


def _stem_forms(torch, wtt) -> dict:
    """The ResNet stem conv, plain 7x7/2 and space-to-depth (``stem_s2d``),
    forward plus input gradient at BASE_STEM_BATCH x 3 x 224^2 in float32
    (TF32 on) and bfloat16, timed in turns (plain, s2d, s2d, plain) by CUDA
    events over BASE_STEM_CALLS calls each; recorded, not gated."""
    import torch.nn.functional as F

    from wam_tpu_torch.models.resnet import _s2d_stem

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        w = (0.05 * torch.randn((64, CHANNELS, 7, 7), generator=g, device=dev)).to(dtype)
        x = torch.randn((BASE_STEM_BATCH, CHANNELS, EVAL_SIDE, EVAL_SIDE), generator=g,
                        device=dev).to(dtype)
        gy = torch.randn((BASE_STEM_BATCH, 64, EVAL_SIDE // 2, EVAL_SIDE // 2), generator=g,
                         device=dev).to(dtype)
        forms = {"plain": lambda t: F.conv2d(t, w, stride=2, padding=3),
                 "s2d": lambda t: _s2d_stem(t, w)}

        def step(form):
            leaf = x.detach().requires_grad_()
            y = forms[form](leaf)
            return y, torch.autograd.grad(y, leaf, gy)[0]

        ys = {f: step(f) for f in forms}
        err = float((ys["s2d"][0] - ys["plain"][0]).detach().abs().max()
                    / ys["plain"][0].detach().abs().max())
        times = {f: [] for f in forms}
        for form in ("plain", "s2d", "s2d", "plain"):
            for _ in range(3):
                step(form)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(BASE_STEM_CALLS):
                step(form)
            end.record()
            torch.cuda.synchronize()
            times[form].append(start.elapsed_time(end) / BASE_STEM_CALLS)
        name = str(dtype).removeprefix("torch.")
        out[name] = {f: {"ms": t, "mean_ms": sum(t) / len(t)} for f, t in times.items()}
        out[name]["max_rel_diff"] = err
        _log(f"  stem forward + input gradient, {BASE_STEM_BATCH}x3x{EVAL_SIDE}^2 {name}: plain "
             f"{[round(t, 4) for t in times['plain']]} ms, s2d "
             f"{[round(t, 4) for t in times['s2d']]} ms (in turns); s2d vs plain max rel diff "
             f"{err:.2e} (not gated)")
    return out


def _baselines_reduced_check(torch, wtt, audio_state, mels) -> dict:
    """The port on the card against the port on the CPU, TF32 off: a
    seeded ResNet-18 (10 classes) on BASE_REDUCED images of 64^2, and the
    audio phase's AudioCNN on 2 of its mels, their first 257 frames.

    - float32 through the evaluators (`EvalImageBaselines`,
      `EvalAudioBaselines`): each method's map within BASE_F32_TOL of the
      CPU's largest value, and insertion with the CPU's map handed to both
      within 1e-5 (scores and curves);
    - float64 through the methods on float64 models (`baselines`,
      `lrp.lrp_resnet`): within 1e-9 x the CPU's largest value."""
    import numpy as np

    from wam_tpu_torch.evalsuite import baselines as TB
    from wam_tpu_torch.evalsuite.lrp import lrp_resnet

    _precision(torch, False)
    n, side, smp, n_iter = BASE_REDUCED
    torch.manual_seed(SEED + 6)
    r18_state = {k: v.detach().clone() for k, v in
                 wtt.resnet18(num_classes=10).state_dict().items()}
    rng = np.random.default_rng(SEED + 6)
    x_img = torch.from_numpy(rng.standard_normal((n, CHANNELS, side, side)).astype(np.float32))
    cases = [("image", BASE_REDUCED_METHODS, x_img, list(range(n)),
              lambda: wtt.resnet18(num_classes=10), r18_state, wtt.EvalImageBaselines),
             ("audio", BASE_REDUCED_AUDIO, mels[:2, :, :BASE_REDUCED_FRAMES].detach().cpu(),
              [0, 1], lambda: wtt.AudioCNN(num_classes=AUDIO_CLASSES), audio_state,
              wtt.EvalAudioBaselines)]
    out = {}
    for kind, methods, x, y, make, state, cls in cases:
        for method in methods:
            f32, f64 = {}, {}
            for dev in ("cpu", DEVICE):
                ev = cls(make(), state, method=method, n_samples=smp, device=dev)
                xs = x.to(dev)
                f32[dev] = ev.compute_explanations(xs, y).cpu().numpy()
                m64 = make()
                m64.load_state_dict(state)
                m64 = m64.double().to(dev).eval().requires_grad_(False)
                x64, y64 = xs.double(), torch.tensor(y, device=dev)

                def fn(a, m=m64):
                    return TB.module_forward(m, a)

                f64[dev] = {"saliency": lambda: TB.saliency(fn, x64, y64),
                            "integratedgrad": lambda: TB.integrated_gradients(
                                fn, x64, y64, n_steps=smp),
                            "gradcam": lambda: TB.gradcam(m64, x64, y64, layer=ev.cam_layer),
                            "gradcampp": lambda: TB.gradcam_pp(m64, x64, y64,
                                                               layer=ev.cam_layer),
                            "guided_backprop": lambda: TB.guided_backprop(m64, x64, y64),
                            "lrp": lambda: lrp_resnet(m64, x64, y64)}[method]().cpu().numpy()
            if kind == "image" and method == methods[0]:
                auc = {}
                for dev in ("cpu", DEVICE):
                    ev = cls(make(), state, method=method, device=dev)
                    ev.explanations = torch.from_numpy(f32["cpu"])
                    auc[dev] = (ev.insertion(x.to(dev), y, n_iter=n_iter),
                                np.stack(ev.insertion_curves))
                for i, key in enumerate(("insertion", "insertion curves")):
                    diff = np.asarray(auc[DEVICE][i]) - np.asarray(auc["cpu"][i])
                    err = float(np.abs(diff).max())
                    _log(f"  reduced check {kind} {key} (the CPU's {method} map handed to both): "
                         f"card vs CPU max abs err {err:.3e} (tol {BASE_TOL['auc']:.0e})")
                    if not err <= BASE_TOL["auc"]:
                        raise AssertionError(f"baselines reduced check: {kind} {key} differs")
                    out[f"{kind} {key}"] = {"max_abs_err": err, "tol": BASE_TOL["auc"]}
            for prec, res, tol in (("float32", f32, BASE_F32_TOL[kind][method]),
                                   ("float64", f64, BASE_TOL["float64"])):
                peak = float(np.abs(res["cpu"]).max())
                err = float(np.abs(res[DEVICE] - res["cpu"]).max()) / (peak or 1.0)
                _log(f"  reduced check {kind} {method} {prec}: card vs CPU max abs err "
                     f"{err:.3e} of the CPU's max {peak:.3e} (tol {tol:g})")
                if not (math.isfinite(err) and err <= tol and np.isfinite(res[DEVICE]).all()):
                    raise AssertionError(f"baselines reduced check: {kind} {method} {prec} on "
                                         "the card disagrees with the CPU")
                out[f"{kind} {method} {prec}"] = {"max_rel_err": err, "tol": tol}
    return out


def phase_baselines(torch, wtt, kernels, smi: str) -> dict:
    """The baseline methods and their evaluators: the image registry (every
    method of `IMAGE_METHODS` but slice D's two, each explained and scored by
    a counted and timed insertion), saliency against WAM at eval2d's
    geometry, the audio methods with their three metrics, the stem forms,
    and the card-against-CPU reduced check. No port kernel launches: every
    explanation and metric call of the phase is counted with the counts set
    to 0 just before it and read just after (each asserted 0), and the
    phase's ``launches`` is their sum."""
    import numpy as np

    from wam_tpu_torch.evalsuite import fan

    prec = _precision(torch, True)
    counted = []  # the launch counts of every counted call
    _log(f"phase baselines: EvalImageBaselines on ResNet-50({EVAL_CLASSES}, bfloat16) x "
         f"({BASE_BATCH},{CHANNELS},{EVAL_SIDE},{EVAL_SIDE}), batch_size={BASE_CAP}, "
         f"n_samples={BASE_SAMPLES}; insertion n_iter={BASE_N_ITER}; {prec}")
    rows = BASE_BATCH * (BASE_N_ITER + 1)
    image = {}
    for method in BASE_METHODS:
        ev, x, y = build_baselines(torch, wtt, method)
        run = _time_explain(torch, kernels, fan, ev, x, y, "images")
        expl = run.pop("out")
        counted.append(run["launches"])
        if expl.shape != (BASE_BATCH, EVAL_SIDE, EVAL_SIDE) or not bool(
                torch.isfinite(expl).all()):
            raise AssertionError(f"{method}: explanation {tuple(expl.shape)} not finite")
        ev.explanations = expl
        _log(f"  {method}: explanation first call {run['first_call_s']:.3f} s; one call's "
             f"launches {run['launches']} (asserted 0), host waits {run['host_syncs']}; {BASE_CALLS} calls (CUDA events) "
             f"{[round(t, 3) for t in run['calls_ms']]} ms, median {run['median_ms']:.3f} ms "
             f"(spread {run['spread_ms'][0]:.3f}-{run['spread_ms'][1]:.3f}) = "
             f"{run['images_per_s']:.2f} images/s; host enqueue {run['enqueue_ms']:.3f} ms; "
             f"peak memory {run['peak_memory_gb']:.3f} GB on {smi}")
        res = _run_metrics(torch, kernels, fan,
                           {"insertion": lambda: ev.insertion(x, y, n_iter=BASE_N_ITER)},
                           {"insertion": ZERO_LAUNCHES}, {"insertion": rows}, BASE_BATCH,
                           "images", smi)["insertion"]
        counted.append(res["launches"])
        _check_scores(np, f"{method} insertion", res["result"], BASE_BATCH)
        image[method] = {"explain": run, "insertion": res}
        del ev, expl
    for method in BASE_ATTENTION:  # ResNet-50 captures no attention (phase attention)
        try:
            build_baselines(torch, wtt, method)
        except ValueError as err:
            _log(f"  {method}: ValueError as expected ({str(err)[:60]}...)")
        else:
            raise AssertionError(f"{method} did not raise ValueError on ResNet-50")

    # saliency against WAM at equal precision, on the eval2d phase's images
    state, _, x8, y8 = build_eval2d(torch, wtt)
    ev = wtt.EvalImageBaselines(wtt.resnet50(num_classes=EVAL_CLASSES), state,
                                method="saliency", compute_dtype=torch.bfloat16,
                                batch_size=EVAL_CAP, device=torch.device(DEVICE))
    pre = _counted_call(torch, kernels, fan, lambda: ev.precompute(x8, y8))
    counted.append(pre["launches"])
    _log(f"  saliency vs WAM (eval2d's {EVAL_BATCH} images, bfloat16, batch_size={EVAL_CAP}): "
         f"insertion n_iter={EVAL_N_ITER}, μ grid={MU_GRID} samples={MU_SAMPLES} "
         f"subset={MU_SUBSET}")
    calls = {"insertion": lambda: ev.insertion(x8, y8, n_iter=EVAL_N_ITER),
             "mu_fidelity": lambda: ev.mu_fidelity(x8, y8, grid_size=MU_GRID,
                                                   sample_size=MU_SAMPLES, subset_size=MU_SUBSET)}
    wam_cmp = _run_metrics(torch, kernels, fan, calls, {m: ZERO_LAUNCHES for m in calls},
                           BASE_WAM_ROWS, EVAL_BATCH, "images", smi)
    counted += [r["launches"] for r in wam_cmp.values()]
    _check_scores(np, "saliency insertion (8 images)", wam_cmp["insertion"]["result"], EVAL_BATCH)
    mu = np.asarray(wam_cmp["mu_fidelity"]["result"])
    if mu.shape != (EVAL_BATCH,) or not np.isfinite(mu).all() or np.abs(mu).max() > 1:
        raise AssertionError(f"saliency μ-fidelity values {mu}")
    del ev, state, x8

    # audio: the eval1d phase's AudioCNN on the mels of its 4 waveforms
    model, _, xa, ya = build_audio(torch, wtt)
    _precision(torch, True)
    with torch.no_grad():
        mels = wtt.melspectrogram(xa[:EVAL1D_BATCH], sample_rate=SAMPLE_RATE, n_fft=N_FFT,
                                  n_mels=N_MELS)[:, None]
    ya = ya[:EVAL1D_BATCH].tolist()
    audio_rows = {"insertion": EVAL1D_BATCH * (EVAL_N_ITER + 1),
                  "faithfulness_of_spectra": EVAL1D_BATCH * 3, "input_fidelity": EVAL1D_BATCH * 3}
    _log(f"  audio: EvalAudioBaselines on AudioCNN({AUDIO_CLASSES}) x {tuple(mels.shape)} mels, "
         f"n_samples={BASE_SAMPLES}, cam_layer out3; insertion n_iter={EVAL_N_ITER}")
    audio = {}
    for method in BASE_AUDIO_METHODS:
        ev = wtt.EvalAudioBaselines(model, None, method=method, n_samples=BASE_SAMPLES,
                                    device=torch.device(DEVICE))
        run = _time_explain(torch, kernels, fan, ev, mels, ya, "inputs")
        expl = run.pop("out")
        counted.append(run["launches"])
        if expl.shape != mels.shape[:1] + mels.shape[2:] or not bool(torch.isfinite(expl).all()):
            raise AssertionError(f"audio {method}: explanation {tuple(expl.shape)} not finite")
        ev.explanations = expl
        _log(f"  audio {method}: explanation median {run['median_ms']:.3f} ms (spread "
             f"{run['spread_ms'][0]:.3f}-{run['spread_ms'][1]:.3f}), host enqueue "
             f"{run['enqueue_ms']:.3f} ms, launches {run['launches']} (asserted 0), host waits "
             f"{run['host_syncs']}, peak "
             f"{run['peak_memory_gb']:.3f} GB")
        calls = {"insertion": lambda: ev.insertion(mels, ya, n_iter=EVAL_N_ITER),
                 "faithfulness_of_spectra": lambda: ev.faithfulness_of_spectra(mels, ya),
                 "input_fidelity": lambda: ev.input_fidelity(mels, ya)}
        res = _run_metrics(torch, kernels, fan, calls, {m: ZERO_LAUNCHES for m in calls},
                           audio_rows, EVAL1D_BATCH, "inputs", smi)
        counted += [r["launches"] for r in res.values()]
        _check_scores(np, f"audio {method} insertion", res["insertion"]["result"], EVAL1D_BATCH)
        preds = res["input_fidelity"]["result"]
        if [len(p) for p in preds] != [2] * EVAL1D_BATCH:
            raise AssertionError(f"audio {method} input fidelity: {preds}")
        audio[method] = {"explain": run, **res}
        del ev, expl

    stem = _stem_forms(torch, wtt)
    launches = {k: sum(c[k] for c in counted) for k in ZERO_LAUNCHES}
    _log(f"  launches over the phase's {len(counted)} counted calls: {launches} "
         f"(asserted == {ZERO_LAUNCHES})")
    if launches != ZERO_LAUNCHES:
        raise AssertionError(f"baselines phase launched port kernels: {launches}")
    audio_state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    reduced = _baselines_reduced_check(torch, wtt, audio_state, mels)
    strip = lambda d: {k: v for k, v in d.items() if k != "result"}  # noqa: E731
    return {"precision": prec, "launches": launches,
            "image": {m: {"explain": r["explain"], "insertion": strip(r["insertion"]),
                          "insertion_scores": r["insertion"]["result"]}
                      for m, r in image.items()},
            "saliency_vs_wam": {m: strip(r) for m, r in wam_cmp.items()},
            "saliency_vs_wam_scores": {"insertion": wam_cmp["insertion"]["result"],
                                       "mu_fidelity": wam_cmp["mu_fidelity"]["result"]},
            "audio": {m: {"explain": r["explain"],
                          **{k: strip(v) for k, v in r.items() if k != "explain"}}
                      for m, r in audio.items()},
            "stem": stem, "reduced_check": reduced}


# -- the periodized transforms (checked in phase kernels) --------------------------------


def check_periodized(torch, wtt, kernels) -> dict:
    """`wavedec2_per` / `waverec2_per` (db4, J=3) on PER_BATCH images of
    3 x 224^2 in float64, the card against the CPU: the coefficients, the
    round trip and the gradient of the decomposition on a seeded cotangent,
    each within PER_TOL x max; no port kernel launches (a strided conv1d and
    its transpose); then a float32 forward and backward timed on the card."""
    from wam_tpu_torch.core.engine import _flatten
    from wam_tpu_torch.wavelets import periodized as per

    dev = torch.device(DEVICE)
    g = torch.Generator().manual_seed(SEED + 3)
    x = torch.randn((PER_BATCH, CHANNELS, SIDE, SIDE), generator=g, dtype=torch.float64)
    cots = [torch.randn(t.shape, generator=g, dtype=torch.float64)
            for t in _flatten(per.wavedec2_per(x, PER_WAVELET, PER_LEVELS))]

    def run(where, dtype=torch.float64):
        xin = x.to(where, dtype).requires_grad_(True)
        leaves = _flatten(per.wavedec2_per(xin, PER_WAVELET, PER_LEVELS))
        (grad,) = torch.autograd.grad(leaves, xin, [c.to(where, dtype) for c in cots])
        coeffs = per.wavedec2_per(xin.detach(), PER_WAVELET, PER_LEVELS)
        return leaves, grad, per.waverec2_per(coeffs, PER_WAVELET)

    kernels.reset_launch_counts()
    card = run(dev)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if launches != ZERO_LAUNCHES:
        raise AssertionError(f"periodized transforms launched port kernels: {launches}")
    cpu = run("cpu")
    out = {}
    for name, a, b in (("coefficients", torch.cat([t.reshape(-1) for t in card[0]]),
                        torch.cat([t.reshape(-1) for t in cpu[0]])),
                       ("gradient", card[1], cpu[1]), ("round trip", card[2], cpu[2]),
                       ("round trip against the input", card[2], x)):
        a, b = a.detach().cpu(), b.detach()
        err, peak = float((a - b).abs().max()), float(b.abs().max())
        _log(f"  periodized {PER_WAVELET} J={PER_LEVELS} ({PER_BATCH},{CHANNELS},{SIDE},{SIDE}) "
             f"float64 {name}: card vs CPU max abs err {err:.3e} (tol {PER_TOL * peak:.3e})")
        if not (math.isfinite(err) and err <= PER_TOL * peak):
            raise AssertionError(f"periodized {name}: the card disagrees with the CPU")
        out[name] = {"max_abs_err": err, "max": peak}
    x32 = x.to(dev, torch.float32).requires_grad_(True)
    cots32 = [c.to(dev, torch.float32) for c in cots]
    ms = _time_ms(lambda: torch.autograd.grad(
        _flatten(per.wavedec2_per(x32, PER_WAVELET, PER_LEVELS)), x32, cots32), iters=10)
    _log(f"  periodized float32 forward + backward on the card: {ms:.3f} ms")
    return {**out, "launches": launches, "f32_fwd_bwd_ms": ms}


# -- nhwc: the flagship in bench.py's layout -----------------------------------------------


def build_nhwc(torch, wtt):
    """The nhwc phase's set-up, shared with scripts/torch_slice_profile.py:
    `build_slice`'s flagship (precision, ResNet-50 weights from SEED, batch,
    labels, SmoothGrad on the kernels) and the same weights bound with
    ``bind_inference(nchw=False)`` under ``WaveletAttribution2D(
    model_layout="nhwc")``. Returns (fn, fn_nhwc, the weights as a state
    dict, wam, wam_nhwc, x, y, g)."""
    dev = torch.device(DEVICE)
    fn, wam, x, y, g = build_slice(torch, wtt)
    torch.manual_seed(SEED)
    model = wtt.resnet50(num_classes=1000)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    fn_nhwc = wtt.bind_inference(model, nchw=False, device=dev)
    wam_nhwc = wtt.WaveletAttribution2D(fn_nhwc, wavelet=WAVELET, J=LEVELS, mode=MODE,
                                        method="smooth", n_samples=N_SAMPLES,
                                        stdev_spread=SPREAD, sample_batch_size=SAMPLE_CHUNK,
                                        model_layout="nhwc", device=dev)
    return fn, fn_nhwc, state, wam, wam_nhwc, x, y, g


def _transform_chain(torch, dec, rec, xin, gout) -> None:
    """One engine step's transforms: decompose, then reconstruct from the
    coefficient leaves and take every leaf's gradient."""
    from wam_tpu_torch.core.engine import _flatten, _unflatten

    with torch.no_grad():
        coeffs = dec(xin)
    leaves = [t.detach().requires_grad_(True) for t in _flatten(coeffs)]
    out = rec(_unflatten(leaves, coeffs))
    torch.autograd.grad(out, leaves, gout[tuple(slice(0, s) for s in out.shape)])


def _nhwc_reduced_check(torch, wtt, fn, fn_nhwc, state, x, y, g) -> dict:
    """The NHWC path against the NCHW path on NHWC_REDUCED images x samples,
    noise handed over, TF32 off: the transforms of the two layouts (leaves,
    reconstruction and every leaf's gradient; NCHW on the kernels); the
    whole call in float64 (ResNet-50 bound in float64 on both sides, NCHW
    on the plain transforms, which take float64); and the whole call in
    float32 (NCHW on the kernels). Each held to NHWC_TOL."""
    from wam_tpu_torch.core.engine import _flatten, _unflatten
    from wam_tpu_torch.wavelets import nhwc
    from wam_tpu_torch.wavelets import transform as tt

    _precision(torch, False)
    dev = torch.device(DEVICE)
    n_img, n_smp = NHWC_REDUCED
    z = torch.randn((n_smp, n_img) + tuple(x.shape[1:]), generator=g, device=dev)
    xs, ys = x[:n_img], y[:n_img]
    out = {}

    def leaves_and_grads(dec, rec, xin, gout, perm):
        with torch.no_grad():
            coeffs = dec(xin)
        leaves = [t.detach().requires_grad_(True) for t in _flatten(coeffs)]
        r = rec(_unflatten(leaves, coeffs))
        grads = torch.autograd.grad(r, leaves, gout)
        return [perm(t.detach()) for t in [*leaves, r, *grads]]

    gout = torch.randn(xs.shape, generator=g, device=dev)
    nchw = leaves_and_grads(lambda v: tt.wavedec2(v, WAVELET, LEVELS, MODE, impl="kernel"),
                            lambda c: tt.waverec2(c, WAVELET, impl="kernel")[..., :SIDE, :SIDE],
                            xs, gout, lambda t: t)
    nhwc_ = leaves_and_grads(lambda v: nhwc.wavedec2_nhwc(v, WAVELET, LEVELS, MODE),
                             lambda c: nhwc.waverec2_nhwc(c, WAVELET)[..., :SIDE, :SIDE, :],
                             xs.permute(0, 2, 3, 1).contiguous(), gout.permute(0, 2, 3, 1),
                             lambda t: t.movedim(-1, -3))
    err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(nhwc_, nchw))
    _log(f"  reduced check, transforms ({n_img} images, TF32 off): NHWC contractions vs NCHW "
         f"K1/K3 leaves, reconstruction and leaf gradients max abs err {err:.3e} of the max "
         f"(tol {NHWC_TOL['transforms']})")
    if not (math.isfinite(err) and err <= NHWC_TOL["transforms"]):
        raise AssertionError("nhwc reduced check: the NHWC transforms disagree with K1/K3")
    out["transforms"] = {"rel_err": err}

    kw = dict(wavelet=WAVELET, J=LEVELS, mode=MODE, n_samples=n_smp, stdev_spread=SPREAD,
              device=dev)
    fn64 = wtt.bind_inference(wtt.resnet50(num_classes=1000), state, device=dev,
                              compute_dtype=torch.float64)
    fn64_nhwc = wtt.bind_inference(wtt.resnet50(num_classes=1000), state, nchw=False,
                                   device=dev, compute_dtype=torch.float64)
    arms = {"float64": (fn64, fn64_nhwc, "matmul", torch.float64),
            "float32": (fn, fn_nhwc, "kernel", torch.float32)}
    for tag, (f_nchw, f_nhwc, impl, dtype) in arms.items():
        xin, zin = xs.to(dtype), z.to(dtype)
        want = wtt.WaveletAttribution2D(f_nchw, impl=impl, **kw)(xin, ys, noise=zin)
        got = wtt.WaveletAttribution2D(f_nhwc, model_layout="nhwc", **kw)(xin, ys, noise=zin)
        a, b = got.double(), want.double()
        err, peak = float((a - b).abs().max()), float(b.abs().max())
        cos = _cosine(torch, a, b)
        cos_tol, rel_tol = NHWC_TOL[tag]
        _log(f"  reduced check, {tag} ({n_img} images x {n_smp} samples, noise handed over): "
             f"NHWC vs NCHW ({impl}) cosine={cos:.10f} (tol >= {cos_tol}) max_abs_err={err:.3e} "
             f"(tol {rel_tol * peak:.3e} = {rel_tol} x max {peak:.3e}) mean_abs_err="
             f"{float((a - b).abs().mean()):.3e}")
        if not (math.isfinite(err) and err <= rel_tol * peak and cos >= cos_tol):
            raise AssertionError(f"nhwc reduced check ({tag}): the NHWC path disagrees with the "
                                 "NCHW path")
        out[tag] = {"cosine": cos, "max_abs_err": err, "max": peak, "rel_err": err / peak}
    return out


def phase_nhwc(torch, wtt, kernels, smi: str) -> dict:
    """The flagship's call with model_layout="nhwc": the NCHW and NHWC arms
    timed in turns (nchw, nhwc, nhwc, nchw), each a counted call (NHWC: no
    port kernel, asserted; NCHW: the flagship's K1 / K3) and NHWC_CALLS
    event-timed calls; the transforms of one chunk in both layouts and the
    input's one layout copy, timed; then the reduced check."""
    from wam_tpu_torch.wavelets import nhwc
    from wam_tpu_torch.wavelets import transform as tt

    fn, fn_nhwc, state, wam, wam_nhwc, x, y, g = build_nhwc(torch, wtt)
    prec = ("torch.backends.cudnn.allow_tf32=True torch.backends.cuda.matmul.allow_tf32=False "
            "(the NHWC contractions in full float32 whatever the setting)")
    _log(f"phase nhwc: ResNet-50(1000) x ({BATCH},{CHANNELS},{SIDE},{SIDE}) {WAVELET} J={LEVELS} "
         f"{MODE} n_samples={N_SAMPLES} sample_batch_size={SAMPLE_CHUNK}, NCHW (kernels) against "
         f"model_layout='nhwc' on bind_inference(nchw=False); {prec}")
    chunks = -(-N_SAMPLES // SAMPLE_CHUNK)
    expected = {"nchw": {**ZERO_LAUNCHES, "dwt2": LEVELS * chunks, "pair": 2 * chunks},
                "nhwc": ZERO_LAUNCHES}
    mosaic = 2 * ((SIDE + wtt.build_wavelet(WAVELET).filt_len - 1) // 2)
    runs, outs = {"nchw": [], "nhwc": []}, {}
    for arm in ("nchw", "nhwc", "nhwc", "nchw"):
        run = _time_calls(torch, kernels, wam if arm == "nchw" else wam_nhwc, x, y, NHWC_CALLS,
                          items=BATCH, unit="attributions")
        out = run.pop("out")
        if tuple(out.shape) != (BATCH, mosaic, mosaic) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"nhwc phase, {arm}: mosaic {tuple(out.shape)} not finite")
        if run["call_launches"] != expected[arm]:
            raise AssertionError(f"nhwc phase, {arm}: one call launched {run['call_launches']}, "
                                 f"expected {expected[arm]}")
        _log_run(f"{arm}, one call's launches {run['call_launches']} (asserted)", run, smi)
        runs[arm].append({k: v for k, v in run.items() if k != "launches"})
        outs[arm] = out
    cos = _cosine(torch, outs["nhwc"].double(), outs["nchw"].double())
    _log(f"  NHWC mosaic cosine to NCHW (TF32 convolutions): {cos:.8f} (no gate)")

    gen = torch.Generator(device=torch.device(DEVICE)).manual_seed(SEED + 4)
    xc = torch.randn((SAMPLE_CHUNK * BATCH, CHANNELS, SIDE, SIDE), generator=gen,
                     device=torch.device(DEVICE))
    xh = xc.permute(0, 2, 3, 1).contiguous()
    gout = torch.randn((SAMPLE_CHUNK * BATCH, CHANNELS, SIDE + 8, SIDE + 8), generator=gen,
                       device=torch.device(DEVICE))
    gout_h = gout.permute(0, 2, 3, 1).contiguous()
    layer = {
        "nchw_kernels_ms": _time_ms(lambda: _transform_chain(
            torch, lambda v: tt.wavedec2(v, WAVELET, LEVELS, MODE, impl="kernel"),
            lambda c: tt.waverec2(c, WAVELET, impl="kernel"), xc, gout), iters=10),
        "nhwc_contractions_ms": _time_ms(lambda: _transform_chain(
            torch, lambda v: nhwc.wavedec2_nhwc(v, WAVELET, LEVELS, MODE),
            lambda c: nhwc.waverec2_nhwc(c, WAVELET), xh, gout_h), iters=10),
        "layout_copy_ms": _time_ms(lambda: x.permute(0, 2, 3, 1).contiguous()),
    }
    _log(f"  transforms of one chunk ({SAMPLE_CHUNK * BATCH} x {CHANNELS} x {SIDE}^2: decompose, "
         f"reconstruct, every leaf's gradient): NCHW on K1/K3 {layer['nchw_kernels_ms']:.3f} ms, "
         f"NHWC contractions {layer['nhwc_contractions_ms']:.3f} ms; the input's layout copy "
         f"({BATCH} images, once a call) {layer['layout_copy_ms']:.4f} ms")
    reduced = _nhwc_reduced_check(torch, wtt, fn, fn_nhwc, state, x, y, g)
    return {"precision": prec, "launches": runs["nhwc"][0]["call_launches"], "runs": runs,
            "nhwc_cosine_to_nchw": cos, "transform_layer": layer, "reduced_check": reduced}


# -- analyzers: the paper's scale analyzers on ResNet-50 --------------------------------------


def build_analyzers(torch, wtt):
    """The analyzers phase's set-up: the flagship's ResNet-50 (1000 classes,
    weights from SEED, float32), AN_BATCH standard-normal images of
    3 x 224^2 from a generator seeded SEED + 1 with the model's own classes
    as labels (host ints), `WaveletAttribution2D` (haar, J=3, SmoothGrad,
    AN_SAMPLES samples) as the explainer, and `WAMAnalyzer2D` (haar, J=3) on
    the kernels. Returns (model_fn, analyzer, x, y)."""
    dev = torch.device(DEVICE)
    torch.manual_seed(SEED)
    fn = wtt.bind_inference(wtt.resnet50(num_classes=1000), device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn((AN_BATCH, CHANNELS, SIDE, SIDE), generator=g, device=dev)
    with torch.no_grad():
        y = fn(x).argmax(dim=1).tolist()
    explainer = wtt.WaveletAttribution2D(fn, wavelet=AN_WAVELET, J=AN_LEVELS, method="smooth",
                                         n_samples=AN_SAMPLES, device=dev)
    return fn, wtt.WAMAnalyzer2D(fn, explainer, wavelet=AN_WAVELET, J=AN_LEVELS, device=dev), x, y


def _check_analyzers(torch, name: str, out) -> None:
    """Each image's result has the call's shapes and finite values."""
    if len(out) != AN_BATCH:
        raise AssertionError(f"analyzers {name}: {len(out)} results")
    for res in out:
        if name == "isolate_scales":
            partial, masks = res
            ok = (tuple(partial.shape) == (AN_LEVELS + 1, CHANNELS, SIDE, SIDE)
                  and tuple(masks.shape) == (AN_LEVELS + 1, SIDE, SIDE)
                  and bool(torch.isfinite(partial).all()))
        else:
            recs, kept, wam, (probs, idx) = res
            ok = tuple(wam.shape) == (SIDE, SIDE) and (kept is None or (
                all(tuple(r.shape) == (CHANNELS, SIDE, SIDE) for r in recs)
                and probs.shape == (AN_QUANTILES, 1000) and 0 <= idx < AN_QUANTILES))
        if not ok:
            raise AssertionError(f"analyzers {name}: a result of the wrong shape")


def _analyzers_reduced_check(torch, wtt, fn, x, y, wams, qs) -> dict:
    """The kernel path against the plain path (impl="matmul") on AN_REDUCED
    images with the headline mosaics handed to both, TF32 off: partial
    images and kept reconstructions within AN_TOL x max, masks, kept masks,
    kept indices and recorded quantiles equal."""
    _precision(torch, False)
    dev = torch.device(DEVICE)
    n, res = AN_REDUCED, {}
    for impl in ("kernel", "matmul"):
        an = wtt.WAMAnalyzer2D(fn, None, wavelet=AN_WAVELET, J=AN_LEVELS, device=dev, impl=impl)
        an.grad_wams = wams[:n]
        res[impl] = (an.isolate_scales(x[:n], y[:n], EPS=AN_EPS),
                     an.isolate_necessary_components(x[:n], y[:n], qs, "insertion"),
                     an.insertion_quantile)
    (ks, kc, kq), (ps, pc, pq) = res["kernel"], res["matmul"]
    err = peak = 0.0
    equal = kq == pq
    for (a, ma), (b, mb) in zip(ks, ps):
        err, peak = max(err, float((a - b).abs().max())), max(peak, float(b.abs().max()))
        equal &= bool(torch.equal(ma, mb))
    for a, b in zip(kc, pc):
        equal &= a[3][1] == b[3][1] or (a[1] is None and b[1] is None)
        if a[1] is not None and b[1] is not None:
            equal &= bool(torch.equal(a[1], b[1]))
            for ra, rb in zip(a[0], b[0]):
                err, peak = max(err, float((ra - rb).abs().max())), max(peak, float(rb.abs().max()))
    _log(f"  reduced check ({n} images, mosaics handed over, TF32 off): kernel vs plain partial "
         f"images and kept reconstructions max abs err {err:.3e} (tol {AN_TOL * peak:.3e}); "
         f"masks, kept masks, indices and quantiles {kq} equal: {equal}")
    if not (math.isfinite(err) and err <= AN_TOL * peak and equal):
        raise AssertionError("analyzers reduced check: the kernel path disagrees with the plain "
                             "path")
    return {"max_abs_err": err, "max": peak, "quantiles": kq, "equal": equal}


def phase_analyzers(torch, wtt, kernels, smi: str) -> dict:
    """`WAMAnalyzer2D` on ResNet-50: the explainer's mosaics once
    (`precompute`, counted and event-timed), then `isolate_scales` and
    `isolate_necessary_components` (insertion and deletion), each a warm
    call, a counted call (launches == AN_LAUNCHES, host waits == AN_SYNCS,
    asserted) and AN_CALLS event-timed calls; then the reduced check."""
    import numpy as np

    from wam_tpu_torch.evalsuite import fan

    prec = _precision(torch, True)
    fn, an, x, y = build_analyzers(torch, wtt)
    qs = {"insertion": [float(q) for q in np.linspace(0.95, 0.0, AN_QUANTILES)]}
    qs["deletion"] = qs["insertion"][::-1]
    _log(f"phase analyzers: WAMAnalyzer2D on ResNet-50(1000, float32) x ({AN_BATCH},{CHANNELS},"
         f"{SIDE},{SIDE}) {AN_WAVELET} J={AN_LEVELS} reflect; explainer SmoothGrad "
         f"n={AN_SAMPLES}; isolate_scales EPS={AN_EPS}; isolate_necessary_components "
         f"{AN_QUANTILES} quantiles 0.95..0 (deletion reversed); {prec}")
    an.explainer(x, y)  # warm: cuDNN plans and the allocator at 200 rows
    kernels.reset_launch_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.reset_peak_memory_stats()
    start.record()
    wams = an.precompute(x, y)
    end.record()
    torch.cuda.synchronize()
    explain = {"ms": start.elapsed_time(end), "launches": kernels.launch_counts(),
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if tuple(wams.shape) != (AN_BATCH, SIDE, SIDE) or not bool(torch.isfinite(wams).all()):
        raise AssertionError(f"analyzers: mosaics {tuple(wams.shape)} not finite")
    _log(f"  explainer (precompute, after a warm call): {explain['ms']:.3f} ms, launches "
         f"{explain['launches']}, peak memory {explain['peak_memory_gb']:.3f} GB on {smi}")
    calls = {"isolate_scales": lambda: an.isolate_scales(x, y, EPS=AN_EPS),
             "insertion": lambda: an.isolate_necessary_components(x, y, qs["insertion"],
                                                                  "insertion"),
             "deletion": lambda: an.isolate_necessary_components(x, y, qs["deletion"],
                                                                 "deletion")}
    out = {}
    for name, call in calls.items():
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        run = _counted_call(torch, kernels, fan, call)
        _check_analyzers(torch, name, run["out"])
        _log(f"  {name}: launches of one call {run['launches']} (asserted == {AN_LAUNCHES}); "
             f"host waits {run['host_syncs']} (asserted == {AN_SYNCS[name]})")
        if run["launches"] != AN_LAUNCHES or run["host_syncs"] != AN_SYNCS[name]:
            raise AssertionError(f"analyzers {name}: launches {run['launches']}, host waits "
                                 f"{run['host_syncs']}")
        timed = _time_metric(torch, fan, call, AN_CALLS, AN_BATCH, "images", fetched=False)
        kept = ([] if name == "isolate_scales" else
                [None if r[1] is None else qs[name][r[3][1]] for r in run["out"]])
        _log(f"  {name}: first call {first_s:.3f} s; {AN_CALLS} calls (CUDA events) "
             f"{[round(t, 3) for t in timed['calls_ms']]} ms, median {timed['median_ms']:.3f} ms "
             f"(spread {timed['spread_ms'][0]:.3f}-{timed['spread_ms'][1]:.3f}) = "
             f"{timed['images_per_s']:.2f} images/s; host enqueue {timed['enqueue_ms']:.3f} ms; "
             f"peak memory {timed['peak_memory_gb']:.3f} GB on {smi}"
             + (f"; kept quantile an image {kept}" if kept else ""))
        out[name] = {**{k: v for k, v in run.items() if k != "out"}, **timed,
                     "first_call_s": first_s, "kept_quantiles": kept}
    out["reduced_check"] = _analyzers_reduced_check(torch, wtt, fn, x, y, wams,
                                                    qs["insertion"])
    return {"precision": prec, "explain": explain, **out}


# -- iou: the fork's cross-wavelet IoU experiment ---------------------------------------------


def synthetic_images(n: int, size: int) -> list:
    """examples/iou_experiment.py's synthetic images (its own copy: the
    script imports nothing of the examples): sines and cosines of rising
    frequency per image, the same on the three channels, plus N(0, 0.1^2)
    noise from numpy's generator seeded 0."""
    import numpy as np

    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        yy, xx = np.mgrid[0:size, 0:size] / size
        base = np.sin((8 + i) * xx) * np.cos((5 + i) * yy)
        img = np.stack([base] * 3) + 0.1 * rng.standard_normal((3, size, size))
        out.append(img.astype(np.float32))
    return out


def build_iou(torch, wtt):
    """The iou phase's set-up, as the example sets it up by default:
    ConvNeXt-T (1000 classes) from `data.build_vision_model` (the port's
    initialisers, seeded 0), IOU_IMAGES synthetic images of 224^2, and a
    factory of WAM-IG explainers (J=3, IOU_STEPS path points) per wavelet.
    Returns (model_fn, images, make_explainer, preprocess)."""
    from wam_tpu_torch.data import build_vision_model

    dev = torch.device(DEVICE)
    _, _, fn = build_vision_model("convnext_tiny", num_classes=1000, image_size=IOU_SIDE,
                                  device=dev)

    def make_explainer(wavelet: str, impl: str | None = None):
        return wtt.WaveletAttribution2D(fn, wavelet=wavelet, J=IOU_LEVELS,
                                        method="integratedgrad", n_samples=IOU_STEPS,
                                        device=dev, impl=impl)

    def preprocess(image):
        return torch.as_tensor(image, device=dev)[None]

    return fn, synthetic_images(IOU_IMAGES, IOU_SIDE), make_explainer, preprocess


def _iou_reduced_check(torch, fn, images, make_explainer, preprocess) -> dict:
    """The kernel path against the plain path (impl="matmul") on the first
    image, TF32 off: each wavelet's reprojection map within IOU_TOL x max,
    and the IoUs at every p equal."""
    from wam_tpu_torch import analysis

    _precision(torch, False)
    maps = {impl: analysis.cross_wavelet_reprojection_maps(
        images[0], lambda w, i=impl: make_explainer(w, i), IOU_WAVELETS, fn, preprocess,
        IOU_LEVELS, device=torch.device(DEVICE)) for impl in ("kernel", "matmul")}
    errs = [float(abs(a - b).max() / abs(b).max()) for a, b in zip(maps["kernel"], maps["matmul"])]
    ious = {impl: [analysis.iou_from_reprojection_maps(m, p) for p in IOU_PS]
            for impl, m in maps.items()}
    _log(f"  reduced check (image 0, TF32 off): kernel vs plain reprojection maps max abs err "
         f"over max {['%.2e' % e for e in errs]} (tol {IOU_TOL}); IoUs equal: "
         f"{ious['kernel'] == ious['matmul']}")
    if not (all(math.isfinite(e) and e <= IOU_TOL for e in errs)
            and ious["kernel"] == ious["matmul"]):
        raise AssertionError("iou reduced check: the kernel path disagrees with the plain path")
    return {"rel_err": errs, "ious": ious["kernel"]}


def phase_iou(torch, wtt, kernels, smi: str) -> dict:
    """The cross-wavelet IoU experiment at the example's defaults: per
    wavelet, one explanation counted (launches == IOU_LAUNCHES, asserted)
    and IOU_CALLS event-timed; then the whole experiment (every image's
    reprojection maps under every wavelet, the mean pairwise IoU at each p)
    on the host clock, its launches asserted; then the reduced check."""
    import numpy as np

    from wam_tpu_torch import analysis

    prec = _precision(torch, True)
    fn, images, make_explainer, preprocess = build_iou(torch, wtt)
    _log(f"phase iou: ConvNeXt-T(1000, data.build_vision_model, seeded 0) x {IOU_IMAGES} "
         f"synthetic images (1,{CHANNELS},{IOU_SIDE},{IOU_SIDE}); WAM-IG J={IOU_LEVELS} "
         f"{IOU_STEPS} path points under {list(IOU_WAVELETS)}; p {list(IOU_PS)}; {prec}")
    x0 = preprocess(images[0])
    with torch.no_grad():
        y0 = [int(fn(x0).argmax())]
    per_wavelet = {}
    for wavelet in IOU_WAVELETS:
        run = _time_calls(torch, kernels, make_explainer(wavelet), x0, y0, IOU_CALLS, items=1,
                          unit="attributions")
        out = run.pop("out")
        if run["call_launches"] != IOU_LAUNCHES or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"iou {wavelet}: launches {run['call_launches']} (expected "
                                 f"{IOU_LAUNCHES}), or a mosaic not finite")
        _log_run(f"{wavelet}: one explanation's launches {run['call_launches']} (asserted), "
                 f"mosaic {tuple(out.shape)}", run, smi)
        per_wavelet[wavelet] = {k: v for k, v in run.items() if k != "launches"}

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    map_sets = [analysis.cross_wavelet_reprojection_maps(
        img, make_explainer, IOU_WAVELETS, fn, preprocess, IOU_LEVELS,
        device=torch.device(DEVICE)) for img in images]
    ious = [float(np.mean([analysis.iou_from_reprojection_maps(m, p) for m in map_sets]))
            for p in IOU_PS]
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    want = {k: v * IOU_IMAGES * len(IOU_WAVELETS) for k, v in IOU_LAUNCHES.items()}
    if launches != want:
        raise AssertionError(f"iou experiment launched {launches}, expected {want}")
    if not all(m.shape == (IOU_SIDE, IOU_SIDE) and np.isfinite(m).all()
               for maps in map_sets for m in maps) or not all(0 <= v <= 1 for v in ious):
        raise AssertionError(f"iou experiment: maps not finite, or IoUs {ious}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    _log(f"  the whole experiment ({IOU_IMAGES} images x {len(IOU_WAVELETS)} wavelets, "
         f"{len(IOU_PS)} p): {wall_s:.3f} s (host clock), launches {launches} (asserted), peak "
         f"memory {peak:.3f} GB on {smi}")
    _log(f"  mean IoU by p: {dict(zip(IOU_PS, [round(v, 4) for v in ious]))} "
         f"provenance=synthetic-sines+random-init")
    reduced = _iou_reduced_check(torch, fn, images, make_explainer, preprocess)
    return {"precision": prec, "per_wavelet": per_wavelet, "experiment_s": wall_s,
            "launches": launches, "peak_memory_gb": peak, "ious": dict(zip(IOU_PS, ious)),
            "provenance": "synthetic-sines+random-init", "reduced_check": reduced}


# -- slice D: patch-aligned ViT WAM, attention baselines, video WAM, anytime ----------


def patch_wam(wtt, fn, device, n_samples: int | None = None, impl: str = "kernel"):
    """The patch path's `WaveletAttribution2D`: the vit phase's IG call with
    ``level_plan="patch"`` (patch PATCH at VIT_SIDE: J = PATCH_LEVELS)."""
    return wtt.WaveletAttribution2D(fn, wavelet=VIT_WAVELET, mode=VIT_MODE,
                                    method="integratedgrad", n_samples=n_samples or VIT_STEPS,
                                    sample_batch_size=VIT_CHUNK, level_plan="patch", patch=PATCH,
                                    image_size=VIT_SIDE, device=device, impl=impl)


def _check_patch_result(torch, wam, run: dict) -> None:
    """The mosaic is (1, 224, 224), finite and nonzero, the scales (1, 4,
    224, 224), and one call launched exactly PATCH_LAUNCHES."""
    out = run["out"]
    if wam.J != PATCH_LEVELS or tuple(out.shape) != (1, VIT_SIDE, VIT_SIDE):
        raise AssertionError(f"patch: J={wam.J}, mosaic shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()) or float(out.abs().sum()) == 0.0:
        raise AssertionError("patch: mosaic is not finite and nonzero")
    if tuple(wam.scales.shape) != (1, PATCH_LEVELS, VIT_SIDE, VIT_SIDE):
        raise AssertionError(f"patch: scales shape {tuple(wam.scales.shape)}")
    if run["call_launches"] != PATCH_LAUNCHES:
        raise AssertionError(f"patch: launches of one call {run['call_launches']}, expected "
                             f"{PATCH_LAUNCHES}")


def phase_patch(torch, wtt, kernels, smi: str) -> dict:
    """The patch path: the headline (TF32 on) with its launch counts checked,
    the TF32-off arm, `WAMAnalyzerViT.token_maps`, and the reduced
    kernel-vs-plain check."""
    _, fn, x, y = build_vit(torch, wtt)
    dev = torch.device(DEVICE)
    wam = patch_wam(wtt, fn, dev)
    _log(f"phase patch: ViT-B/16(1000) x (1,{CHANNELS},{VIT_SIDE},{VIT_SIDE}) {VIT_WAVELET} "
         f"level_plan='patch' patch={PATCH} (J={wam.J}) {VIT_MODE} integratedgrad "
         f"n_samples={VIT_STEPS} sample_batch_size={VIT_CHUNK}")
    prec = _precision(torch, True)
    run = _timed(torch, kernels, wam, x, y, VIT_CALLS)
    _check_patch_result(torch, wam, run)
    _log(f"  launches of one call: {run['call_launches']} (asserted == {PATCH_LAUNCHES})")
    _log_run(f"headline, {prec}", run, smi)
    summary = {k: v for k, v in run.items() if k != "out"}
    summary["precision"] = prec

    prec_off = _precision(torch, False)
    exact = _timed(torch, kernels, wam, x, y, VIT_CALLS)
    _check_patch_result(torch, wam, exact)
    _log_run(f"float32, {prec_off}", exact, smi)
    summary["tf32_off"] = {k: v for k, v in exact.items()
                           if k not in ("out", "launches", "call_launches")}
    summary["tf32_cosine_to_f32"] = _cosine(torch, run["out"], exact["out"])

    _precision(torch, True)
    kernels.reset_launch_counts()
    maps = wtt.WAMAnalyzerViT(wam).token_maps(x, y)
    torch.cuda.synchronize()
    want = (1, PATCH_LEVELS, PATCH_TOKENS, PATCH_TOKENS)
    if tuple(maps.shape) != want or not bool(torch.isfinite(maps).all()):
        raise AssertionError(f"patch: token maps {tuple(maps.shape)}, expected {want}, finite")
    _log(f"  WAMAnalyzerViT.token_maps: {tuple(maps.shape)} (asserted == {want}), launches "
         f"{kernels.launch_counts()}; token importance per level "
         f"{[round(float(v), 6) for v in maps.sum(dim=(0, 2, 3))]}")
    summary["token_maps_shape"] = list(maps.shape)
    _precision(torch, False)
    res = {impl: patch_wam(wtt, fn, dev, VIT_REDUCED_STEPS, impl)(x, y)
           for impl in ("kernel", "matmul")}
    summary["reduced_check"] = _held(
        torch, f"reduced check (patch, TF32 off, 1 image x {VIT_REDUCED_STEPS} path points): "
        "kernel vs plain", res["kernel"], res["matmul"], VIT_TOL)
    return summary


def build_attention(torch, wtt):
    """The attention phase's model: ViT-B/16 (1000 classes) with
    ``capture_attn=True`` and the vit phase's weights (`build_vit`'s
    model, loaded strictly), on the host (the evaluators copy it); ATTN_BATCH
    standard-normal images from a generator seeded SEED + 8, labels 0..3
    as host ints. Returns (capture model, plain model, x, y)."""
    dev = torch.device(DEVICE)
    plain, _, _, _ = build_vit(torch, wtt)
    model = wtt.vit_b16(num_classes=1000, capture_attn=True)
    model.load_state_dict(plain.state_dict(), strict=True)
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    x = torch.randn((ATTN_BATCH, CHANNELS, VIT_SIDE, VIT_SIDE), generator=g, device=dev)
    return model.eval(), plain.eval(), x, list(range(ATTN_BATCH))


def _attention_reduced_check(torch, wtt, model, plain, x, y) -> dict:
    """TF32 off: the logits of the capture form against the SDPA form on the
    card (ATTN_TOL["capture"] x max); then both maps of one image on the
    card against the CPU, the models in float64 (ATTN_TOL["float64"] x max)."""
    _precision(torch, False)
    dev = torch.device(DEVICE)
    on, off = model.to(dev).requires_grad_(False), plain.to(dev).requires_grad_(False)
    with torch.no_grad():
        lon, loff = on(x), off(x)
    out = {"capture": _held(torch, "reduced check attention: logits, capture_attn=True vs "
                            "False (TF32 off)", lon, loff, (0.99999, ATTN_TOL["capture"]))}
    maps = {}
    for d in (DEVICE, "cpu"):
        m64 = model.to(d, torch.float64)
        x64 = x[:1].to(d, torch.float64)
        maps[d] = (wtt.attention_rollout(m64, x64), wtt.attention_gradient(m64, x64, y[:1]))
    for i, name in enumerate(ATTN_METHODS):
        out[f"{name}_float64"] = _held(
            torch, f"reduced check attention {name}: card vs CPU, float64, one image",
            maps[DEVICE][i], maps["cpu"][i], (0.9999999, ATTN_TOL["float64"]))
    model.float()
    return out


def phase_attention(torch, wtt, kernels, smi: str) -> dict:
    """The transformer baselines: `EvalImageBaselines` rollout and attngrad
    on ViT-B/16 with captured attention, each explanation counted and timed,
    then insertion and deletion counted (no port kernel, one fetch, one
    host wait: asserted) and timed; the reduced checks."""
    import numpy as np

    from wam_tpu_torch.evalsuite import fan

    model, plain, x, y = build_attention(torch, wtt)
    prec = _precision(torch, True)
    _log(f"phase attention: EvalImageBaselines on ViT-B/16(1000, capture_attn=True) x "
         f"({ATTN_BATCH},{CHANNELS},{VIT_SIDE},{VIT_SIDE}), batch_size={ATTN_CAP}; insertion "
         f"and deletion n_iter={ATTN_N_ITER}; {prec}")
    rows = ATTN_BATCH * (ATTN_N_ITER + 1)
    out, counted = {}, []
    for method in ATTN_METHODS:
        ev = wtt.EvalImageBaselines(model, None, method=method, batch_size=ATTN_CAP,
                                    device=torch.device(DEVICE))
        run = _time_explain(torch, kernels, fan, ev, x, y, "images")
        expl = run.pop("out")
        counted.append(run["launches"])
        if expl.shape != (ATTN_BATCH, VIT_SIDE, VIT_SIDE) or not bool(torch.isfinite(expl).all()):
            raise AssertionError(f"{method}: explanation {tuple(expl.shape)} not finite")
        ev.explanations = expl
        _log(f"  {method}: explanation first call {run['first_call_s']:.3f} s; one call's "
             f"launches {run['launches']} (asserted 0), host waits {run['host_syncs']}; "
             f"{BASE_CALLS} calls (CUDA events) {[round(t, 3) for t in run['calls_ms']]} ms, "
             f"median {run['median_ms']:.3f} ms (spread {run['spread_ms'][0]:.3f}-"
             f"{run['spread_ms'][1]:.3f}) = {run['images_per_s']:.2f} images/s; host enqueue "
             f"{run['enqueue_ms']:.3f} ms; peak memory {run['peak_memory_gb']:.3f} GB on {smi}")
        calls = {"insertion": lambda: ev.insertion(x, y, n_iter=ATTN_N_ITER),
                 "deletion": lambda: ev.deletion(x, y, n_iter=ATTN_N_ITER)}
        res = _run_metrics(torch, kernels, fan, calls, {m: ZERO_LAUNCHES for m in calls},
                           {m: rows for m in calls}, ATTN_BATCH, "images", smi)
        for name, r in res.items():
            counted.append(r["launches"])
            _check_scores(np, f"{method} {name}", r["result"], ATTN_BATCH)
        out[method] = {"explain": run, **{k: {kk: vv for kk, vv in r.items() if kk != "result"}
                                          for k, r in res.items()},
                       "scores": {k: r["result"] for k, r in res.items()}}
        del ev, expl
    launches = {k: sum(c[k] for c in counted) for k in ZERO_LAUNCHES}
    if launches != ZERO_LAUNCHES:
        raise AssertionError(f"attention phase launched port kernels: {launches}")
    _log(f"  launches over the phase's {len(counted)} counted calls: {launches} (asserted 0)")
    return {"precision": prec, "launches": launches, **out,
            "reduced_check": _attention_reduced_check(torch, wtt, model, plain, x, y)}


def build_video(torch, wtt):
    """The video phase's set-up (bench_workloads.video_workload): the 3D
    ResNet-18 (VID_CLASSES classes, width 16) drawn by the port's
    initialisers from torch's generator seeded SEED, calibrated on two clips
    from numpy seeded SEED + 4 (`_calibrate`), bound with ``bind_inference``
    (the model takes the clip (B, 1, T, H, W) as it comes); VID_BATCH
    standard-normal clips from numpy seeded SEED + 6, labels arange % 10.
    Returns (state dict on the CPU, model_fn, x, y)."""
    import numpy as np

    dev = torch.device(DEVICE)
    torch.manual_seed(SEED)
    model = wtt.resnet3d_18(num_classes=VID_CLASSES).to(dev)
    shape = (1, VID_FRAMES, VID_SIDE, VID_SIDE)
    calib = np.random.default_rng(SEED + 4).standard_normal((2,) + shape)
    _calibrate(torch, model, torch.from_numpy(calib.astype(np.float32)).to(dev))
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    fn = wtt.bind_inference(model, device=dev)
    x = np.random.default_rng(SEED + 6).standard_normal((VID_BATCH,) + shape)
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    return state, fn, x, torch.arange(VID_BATCH, device=dev) % VID_CLASSES


def video_wam(wtt, fn, device, method: str = "smooth", n_samples: int | None = None,
              impl: str | None = None):
    """The video path's `WaveletAttributionVideo` (haar, levels (2, 1),
    symmetric, every sample in one chunk: sample_batch_size="auto")."""
    return wtt.WaveletAttributionVideo(fn, wavelet=VID_WAVELET, levels=VID_LEVELS, method=method,
                                       n_samples=n_samples or VID_SAMPLES,
                                       sample_batch_size="auto", device=device, impl=impl)


def _check_box(torch, run: dict, tag: str) -> None:
    out = run["out"]
    if tuple(out.shape) != (VID_BATCH, VID_FRAMES, VID_SIDE, VID_SIDE):
        raise AssertionError(f"{tag}: box shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()) or float(out.abs().sum()) == 0.0:
        raise AssertionError(f"{tag}: box is not finite and nonzero")
    if run["call_launches"] != VID_LAUNCHES:
        raise AssertionError(f"{tag}: launches of one call {run['call_launches']}, expected "
                             f"{VID_LAUNCHES}")


def _video_reduced_check(torch, wtt, state) -> dict:
    """The port on the card against the port on the CPU, the same weights,
    VID_REDUCED clips and handed-over noise, TF32 off: float32 through
    `WaveletAttributionVideo` on its default route (K1/K2 on the card),
    held to VID_TOL["float32"]; float64 through the same class on the conv
    route, held to VID_TOL["float64"]."""
    import numpy as np

    n_clip, n_smp = VID_REDUCED
    _precision(torch, False)
    rng = np.random.default_rng(SEED + 9)
    shape = (n_clip, 1, VID_FRAMES, VID_SIDE, VID_SIDE)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((n_smp,) + shape).astype(np.float32))
    y = torch.arange(n_clip) % VID_CLASSES
    res = {}
    for dtype, impl in ((torch.float32, None), (torch.float64, "conv")):
        for d in (DEVICE, "cpu"):
            model = wtt.resnet3d_18(num_classes=VID_CLASSES).to(dtype)
            fn = wtt.bind_inference(model, state, device=d)
            wam = video_wam(wtt, fn, d, n_samples=n_smp, impl=impl)
            res[(dtype, d)] = wam(x.to(d, dtype), y.to(d), noise=z.to(d, dtype))
    return {name: _held(torch, f"reduced check video {name}, card vs CPU ({n_clip} clips x "
                        f"{n_smp} samples, {'kernels' if dt == torch.float32 else 'conv'})",
                        res[(dt, DEVICE)], res[(dt, "cpu")], VID_TOL[name])
            for name, dt in (("float32", torch.float32), ("float64", torch.float64))}


def phase_video(torch, wtt, kernels, smi: str) -> dict:
    """The video path: SmoothGrad (the headline) and IG, each with one
    call's launches asserted (K1 2, K2 1) and CUDA-event timed calls; the
    temporal insertion and deletion of `EvalVideoWAM` on the headline's
    frame scores (no port kernel, one fetch, one host wait: asserted); the
    reduced check."""
    import numpy as np

    from wam_tpu_torch.evalsuite import fan

    state, fn, x, y = build_video(torch, wtt)
    dev = torch.device(DEVICE)
    prec = _precision(torch, True)
    _log(f"phase video: ResNet3D-18({VID_CLASSES}) x ({VID_BATCH},1,{VID_FRAMES},{VID_SIDE},"
         f"{VID_SIDE}) {VID_WAVELET} levels={VID_LEVELS} symmetric smooth n_samples="
         f"{VID_SAMPLES} sample_batch_size='auto'; {prec} (the model; the transforms in full "
         "float32)")
    run = _time_calls(torch, kernels, video_wam(wtt, fn, dev), x, y, VID_CALLS, items=VID_BATCH,
                      unit="clips")
    _check_box(torch, run, "video")
    _log(f"  launches of one call: {run['call_launches']} (asserted == {VID_LAUNCHES})")
    _log_run(f"headline, {prec}", run, smi, "clips")
    summary = {k: v for k, v in run.items() if k != "out"}
    summary["precision"] = prec
    ig = _time_calls(torch, kernels, video_wam(wtt, fn, dev, "integratedgrad"), x, y, 3,
                     items=VID_BATCH, unit="clips")
    _check_box(torch, ig, "video IG")
    _log(f"  IG, {VID_SAMPLES} path points: launches of one call {ig['call_launches']} "
         f"(asserted == {VID_LAUNCHES})")
    _log_run(f"IG, {prec}", ig, smi, "clips")
    summary["integratedgrad"] = {k: v for k, v in ig.items() if k not in ("out", "launches")}

    ev = wtt.EvalVideoWAM(fn, None, batch_size=VID_CAP, device=dev)
    ev.explanations = wtt.xattr.frame_importance(run["out"])
    labels = y.tolist()  # host ints: a metric call waits for nothing but its fetch
    calls = {"insertion": lambda: ev.insertion(x, labels, n_iter=VID_N_ITER),
             "deletion": lambda: ev.deletion(x, labels, n_iter=VID_N_ITER)}
    rows = VID_BATCH * (VID_N_ITER + 1)
    _log(f"  EvalVideoWAM (batch_size={VID_CAP}) on the headline's frame scores: insertion and "
         f"deletion n_iter={VID_N_ITER}, {rows} model rows a call")
    res = _run_metrics(torch, kernels, fan, calls, {m: ZERO_LAUNCHES for m in calls},
                       {m: rows for m in calls}, VID_BATCH, "clips", smi)
    for name, r in res.items():
        _check_scores(np, f"video {name}", r["result"], VID_BATCH)
    summary["eval"] = {k: {kk: vv for kk, vv in r.items() if kk != "result"}
                       for k, r in res.items()}
    summary["eval_scores"] = {k: r["result"] for k, r in res.items()}
    summary["eval_launches"] = {k: sum(r["launches"][k] for r in res.values())
                                for k in ZERO_LAUNCHES}
    summary["reduced_check"] = _video_reduced_check(torch, wtt, state)
    return summary


def phase_anytime(torch, wtt, kernels, smi: str) -> dict:
    """Anytime SmoothGrad on the flagship's explainer: a counted full run
    (every stride, one fetch, K1 75 and K3 50: asserted), ANY_CALLS runs
    timed by CUDA events with each stride's host time and its wait on the
    confidence vector, the full map against the streamed smooth_wam on the
    same draws, and a deadline run at ANY_DEADLINE strides."""
    from wam_tpu_torch import anytime
    from wam_tpu_torch.evalsuite import fan

    fn, wam, x, y, _ = build_slice(torch, wtt)
    dev = torch.device(DEVICE)
    ent = wam.anytime_serve_entry(stride=ANY_STRIDE)
    _log(f"phase anytime: the flagship's explainer (ResNet-50 x ({BATCH},{CHANNELS},{SIDE},"
         f"{SIDE}) {WAVELET} J={LEVELS} n_samples={N_SAMPLES}) through anytime_serve_entry("
         f"stride={ANY_STRIDE}) and run_anytime; cudnn.allow_tf32=True matmul.allow_tf32=False")
    anytime.run_anytime(ent, x, y)  # warm
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with fan.fetch_scope() as fs:
        full = anytime.run_anytime(ent, x, y)
    launches = kernels.launch_counts()
    _log(f"  counted run: launches {launches} (asserted == {ANY_LAUNCHES}), fetches {fs.count} "
         f"(asserted 1), n_used {full.n_used}, strides {full.strides}, complete {full.complete}")
    if launches != ANY_LAUNCHES or fs.count != 1:
        raise AssertionError(f"anytime: launches {launches}, fetches {fs.count}")
    if not (full.complete and full.n_used == N_SAMPLES and full.strides == N_SAMPLES // ANY_STRIDE):
        raise AssertionError(f"anytime: n_used {full.n_used}, strides {full.strides}")
    torch.cuda.reset_peak_memory_stats()
    times, strides, syncs = [], [], []
    for _ in range(ANY_CALLS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = anytime.run_anytime(ent, x, y)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        strides += [t * 1e3 for t in res.stride_s]
        syncs += [t * 1e3 for t in res.sync_s]
    med = sorted(times)[len(times) // 2]
    stride_ms = sorted(strides)[len(strides) // 2]
    sync_ms = sorted(syncs)[len(syncs) // 2]
    peak = torch.cuda.max_memory_allocated() / 1e9
    _log(f"  {ANY_CALLS} full runs (CUDA events) {[round(t, 3) for t in times]} ms, median "
         f"{med:.3f} ms = {BATCH / (med / 1e3):.2f} attributions/s; a stride (host clock, "
         f"median of {len(strides)}) {stride_ms:.3f} ms, of it waiting on the confidence vector "
         f"{sync_ms:.3f} ms ({sync_ms / stride_ms:.1%}); peak memory {peak:.3f} GB on {smi}")
    streamed = wtt.WaveletAttribution2D(fn, wavelet=WAVELET, J=LEVELS, mode=MODE,
                                        n_samples=N_SAMPLES, stdev_spread=SPREAD,
                                        random_seed=wam.random_seed, stream_noise=True,
                                        sample_batch_size=1, device=dev, impl="kernel")
    check = _held(torch, "anytime full run vs streamed smooth_wam (one sample a chunk, the "
                  "same draws)", torch.from_numpy(full.out), streamed(x, y), ANY_TOL)
    deadline_ms = ANY_DEADLINE * stride_ms
    dl = anytime.run_anytime(ent, x, y, deadline_ms=deadline_ms)
    conf = dl.conf
    _log(f"  deadline run ({deadline_ms:.3f} ms = {ANY_DEADLINE} strides): deadline_hit "
         f"{dl.deadline_hit}, n_used {dl.n_used} (expected 10 or 15), strides {dl.strides}, "
         f"complete {dl.complete}, converged {dl.converged}")
    _log("  confidence vector per row (count, rel_sem, delta, confidence): "
         + "; ".join(",".join(f"{v:.4g}" for v in row) for row in conf.tolist()))
    if not dl.deadline_hit or dl.n_used >= N_SAMPLES or dl.n_used % ANY_STRIDE:
        raise AssertionError(f"anytime deadline run: hit {dl.deadline_hit}, n_used {dl.n_used}")
    return {"launches": launches, "fetches": fs.count, "calls_ms": times, "median_ms": med,
            "spread_ms": [min(times), max(times)], "attributions_per_s": BATCH / (med / 1e3),
            "stride_ms": stride_ms, "sync_ms": sync_ms, "peak_memory_gb": peak,
            "check": check,
            "deadline": {"deadline_ms": deadline_ms, "deadline_hit": dl.deadline_hit,
                         "n_used": dl.n_used, "strides": dl.strides,
                         "stride_ms": [t * 1e3 for t in dl.stride_s],
                         "conf": conf.tolist()}}


class _ServeRecorder:
    """The served entry behind a recorder: each dispatched batch's inputs
    (copies: the entry releases its input on the card), its output, the
    kernels launched while the entry enqueued it (host-side counts: one
    worker thread calls the entry), and CUDA events on the compute stream
    just before and after it (the device's gap between two batches is its
    idle time there)."""

    def __init__(self, torch, kernels, entry):
        self.torch, self.kernels, self.entry = torch, kernels, entry
        self.batches = []

    def __call__(self, xs, ys):
        torch = self.torch
        before = self.kernels.launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        keep = (xs.clone(), ys.clone())
        t0 = time.perf_counter()
        start.record()
        out = self.entry(xs, ys)
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        after = self.kernels.launch_counts()
        self.batches.append({"x": keep[0], "y": keep[1], "out": out, "start": start, "end": end,
                             "side": int(keep[0].shape[-1]), "host_ms": host_ms,
                             "launches": {k: after[k] - before[k] for k in after}})
        return out

    def idle_share(self) -> tuple[float, float]:
        """(device idle ms between consecutive batches, its share of the span
        from the first batch's start to the last one's end)."""
        self.torch.cuda.synchronize()
        bs = self.batches
        gaps = [max(0.0, bs[i - 1]["end"].elapsed_time(bs[i]["start"])) for i in range(1, len(bs))]
        span = bs[0]["start"].elapsed_time(bs[-1]["end"])
        return sum(gaps), sum(gaps) / span if span > 0 else 0.0

    def per_batch(self) -> list:
        """(side, device ms, host enqueue ms) of each batch in dispatch order."""
        self.torch.cuda.synchronize()
        return [(b["side"], b["start"].elapsed_time(b["end"]), b["host_ms"]) for b in self.batches]

    def device_ms(self) -> dict:
        """Median device ms a batch, per bucket side: from the event before
        its first kernel to the one after its last (the batch's own work:
        the event before it fires once the stream reaches it)."""
        self.torch.cuda.synchronize()
        by = {}
        for b in self.batches:
            by.setdefault(b["side"], []).append(b["start"].elapsed_time(b["end"]))
        return {s: sorted(v)[len(v) // 2] for s, v in sorted(by.items())}


def _serve_requests(np, n: int, seed: int):
    """n seeded requests: (image, label, qos); shapes round-robin over
    SERVE_SHAPES, one in four interactive."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        shape = SERVE_SHAPES[i % len(SERVE_SHAPES)]
        reqs.append((rng.standard_normal(shape).astype(np.float32),
                     int(rng.integers(0, 1000)), "interactive" if i % 4 == 0 else "batch"))
    return reqs


def _drive_clients(server, reqs, clients: int = SERVE_CLIENTS, window: int = SERVE_WINDOW):
    """``clients`` closed-loop client threads, each keeping ``window``
    requests in flight; every future waited on with a timeout. Returns the
    results by request index, the lost indices and the wall seconds."""
    import threading

    results, lost = {}, []
    lock = threading.Lock()

    def client(j):
        pending = []
        for i in range(j, len(reqs), clients):
            x, y, qos = reqs[i]
            pending.append((i, server.submit(x, y, qos=qos)))
            while len(pending) >= window or (pending and i + clients >= len(reqs)):
                k, fut = pending.pop(0)
                try:
                    out = fut.result(timeout=SERVE_TIMEOUT_S)
                    with lock:
                        results[k] = out
                except Exception as e:  # noqa: BLE001 - a lost request is the finding
                    with lock:
                        lost.append((k, repr(e)))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(j,)) for j in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=SERVE_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lost += [(i, "no result") for i in range(len(reqs)) if i not in results
             and i not in {k for k, _ in lost}]
    return results, lost, wall


def _check_served_rows(torch, np, rec, reqs, results, tag: str) -> dict:
    """Every served mosaic against the entry's output for the batch it was
    served from: the recorded output (exactly: the server's row
    distribution) and the entry run again on a copy of the same assembled
    batch (<= SERVE_TOL x max: the entry itself), row for row. Requests are
    found in their batch by the bytes of their padded image."""
    from wam_tpu_torch.serve import BucketTable, pad_item

    table = BucketTable(SERVE_BUCKETS)
    where = {}
    for b, batch in enumerate(rec.batches):
        rows = batch["x"].cpu().numpy()
        for i in range(rows.shape[0]):
            where.setdefault(rows[i].tobytes(), (b, i))
    rerun = {}
    worst_exact, worst = 0.0, 0.0
    for k, (x, y, _) in enumerate(reqs):
        b, i = where[pad_item(x, table.select(x.shape)).tobytes()]
        batch = rec.batches[b]
        if int(batch["y"][i]) != y:
            raise AssertionError(f"serve {tag}: request {k} found in a row with another label")
        if b not in rerun:
            rerun[b] = rec.entry(batch["x"].clone(), batch["y"].clone()).detach().cpu().numpy()
        got = results[k]
        worst_exact = max(worst_exact, float(np.abs(got - batch["out"][i].cpu().numpy()).max()))
        want = rerun[b][i]
        worst = max(worst, float(np.abs(got - want).max()) / float(np.abs(want).max()))
    _log(f"  {tag}: {len(reqs)} served mosaics against their batches' outputs: dispatched "
         f"output max abs diff {worst_exact:.3e} (must be 0), the entry run again on the "
         f"same batch {worst:.3e} of the max (tol {SERVE_TOL})")
    if worst_exact != 0.0 or not worst <= SERVE_TOL:
        raise AssertionError(f"serve {tag}: a served row disagrees with its batch")
    return {"rows_exact_max_abs": worst_exact, "rows_rerun_rel_err": worst}


def _serve_arm(torch, np, wtt, kernels, entry, reqs, pipelined: bool, smi: str) -> dict:
    """One server arm over the request stream: launches counted from 0 just
    before the stream and read just after; every batch's launches against
    SERVE_LAUNCHES; the rates, latency, EMA service, assembly, the device's
    idle share between batches and the peak memory printed."""
    from wam_tpu_torch import obs
    from wam_tpu_torch.serve import AttributionServer, ServeMetrics

    metrics = ServeMetrics()
    rec = _ServeRecorder(torch, kernels, entry)
    server = AttributionServer(rec, list(SERVE_BUCKETS), max_batch=SERVE_MAX_BATCH,
                               pipelined=pipelined, metrics=metrics, device=DEVICE)
    warm = len(rec.batches)
    try:
        rec.batches.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with obs.assert_no_retrace():
            results, lost, wall = _drive_clients(server, reqs)
        launches = kernels.launch_counts()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        server.close()
    tag = "pipelined" if pipelined else "unpipelined"
    if lost:
        raise AssertionError(f"serve {tag}: {len(lost)} requests lost: {lost[:4]}")
    for b in rec.batches:
        if b["launches"] != SERVE_LAUNCHES[b["side"]]:
            raise AssertionError(f"serve {tag}: a {b['side']}^2 batch launched {b['launches']}, "
                                 f"expected {SERVE_LAUNCHES[b['side']]}")
    total = {k: sum(b["launches"][k] for b in rec.batches) for k in ZERO_LAUNCHES}
    if launches != total:
        raise AssertionError(f"serve {tag}: launches {launches} != the batches' sum {total}")
    idle_ms, idle = rec.idle_share()
    device_ms = rec.device_ms()
    per_batch = rec.per_batch()
    snap = metrics.snapshot()
    stages = snap["stages"]
    sides = sorted({b["side"] for b in rec.batches})
    per_side = {s: sum(1 for b in rec.batches if b["side"] == s) for s in sides}
    ema = {k: v * 1e3 for k, v in snap["ema_service_s"].items()}
    rate = len(reqs) / wall
    _log(f"  {tag}: {len(reqs)} requests ({SERVE_CLIENTS} clients x {SERVE_WINDOW} in flight) in "
         f"{wall:.3f} s = {rate:.2f} requests/s; {snap['batches']} batches {per_side} (fill "
         f"{snap['fill_ratio_mean']:.3f}); latency p50 {snap['latency_p50_ms']:.1f} ms, p99 "
         f"{snap['latency_p99_ms']:.1f} ms; EMA batch service ms "
         + ", ".join(f"{k}: {v:.2f}" for k, v in sorted(ema.items()))
         + "; device ms a batch (median, events) "
         + ", ".join(f"{s}^2: {v:.2f}" for s, v in device_ms.items())
         + f"; host assemble + stage {stages['assemble']['mean_s'] * 1e3:.3f} ms a batch, "
         f"dispatch (enqueue) {stages['dispatch']['mean_s'] * 1e3:.3f} ms; device idle between "
         f"batches {idle_ms:.3f} ms = {idle:.2%}; peak memory {peak:.2f} GB; launches {launches} "
         f"(per batch as expected); degraded {server.degraded} on {smi}")
    _log(f"  {tag}: each batch in dispatch order (side, device ms, host enqueue ms): "
         + ", ".join(f"({s}, {d:.2f}, {h:.2f})" for s, d, h in per_batch))
    if server.degraded or snap["completed"] != len(reqs):
        raise AssertionError(f"serve {tag}: degraded {server.degraded}, completed "
                             f"{snap['completed']} of {len(reqs)}")
    check = _check_served_rows(torch, np, rec, reqs, results, tag)
    first = {}
    for b in rec.batches:
        first.setdefault(b["side"], b["launches"])
    return {"requests": len(reqs), "wall_s": wall, "requests_per_s": rate,
            "batches": snap["batches"], "batches_by_side": per_side,
            "fill_ratio_mean": snap["fill_ratio_mean"],
            "latency_p50_ms": snap["latency_p50_ms"], "latency_p99_ms": snap["latency_p99_ms"],
            "latency_by_qos": snap["latency_by_qos"], "ema_service_ms": ema,
            "device_ms_by_side": device_ms, "per_batch": per_batch,
            "assemble_ms": stages["assemble"]["mean_s"] * 1e3,
            "dispatch_ms": stages["dispatch"]["mean_s"] * 1e3,
            "harvest_ms": stages["harvest"]["mean_s"] * 1e3,
            "device_idle_ms": idle_ms, "device_idle_share": idle, "peak_memory_gb": peak,
            "launches": launches, "batch_launches": first, "warmup_calls": warm,
            "degraded": server.degraded,
            "warmup_s": snap["warmup_s"], **check}


def _serve_admission(torch, np, kernels, entry, reqs) -> dict:
    """One server with a small queue, a long fill window and a result cache:
    a QueueFullError with its retry_after_s, a DeadlineExceededError (the
    deadline lapses inside the window), an InvalidDeadlineError, and a cache
    hit that resolves with no kernel launched."""
    from wam_tpu_torch.serve import (AttributionServer, DeadlineExceededError,
                                     InvalidDeadlineError, QueueFullError)

    server = AttributionServer(entry, [SERVE_BUCKETS[0]], max_batch=SERVE_MAX_BATCH,
                               max_wait_ms=400.0, queue_depth=2, result_cache=1 << 30,
                               cache_id="flagship", device=DEVICE)
    x, y, _ = reqs[0]
    try:
        first = server.submit(x, y)
        doomed = server.submit(reqs[4][0], reqs[4][1], deadline_ms=5.0)
        try:
            server.submit(reqs[8][0], reqs[8][1])
        except QueueFullError as e:
            retry = e.retry_after_s
        else:
            raise AssertionError("serve: a full queue admitted a request")
        out = first.result(timeout=SERVE_TIMEOUT_S)
        try:
            doomed.result(timeout=SERVE_TIMEOUT_S)
        except DeadlineExceededError:
            expired = True
        else:
            expired = False
        try:
            server.submit(x, y, deadline_ms=0)
        except InvalidDeadlineError as e:
            invalid = e.deadline_ms
        else:
            raise AssertionError("serve: deadline_ms=0 was admitted")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        again = server.submit(x, y).result(timeout=SERVE_TIMEOUT_S)
        hit_launches = kernels.launch_counts()
        hits = server.metrics.cache_hits
    finally:
        server.close()
    _log(f"  admission: QueueFullError retry_after_s={retry:.4f} (queue_depth 2); "
         f"DeadlineExceededError {expired} (5 ms deadline in a 400 ms window); "
         f"InvalidDeadlineError for deadline_ms={invalid}; resubmitted item: cache hits {hits}, "
         f"launches {hit_launches}, equal {bool(np.array_equal(out, again))}")
    if not (retry > 0 and expired and hits == 1 and np.array_equal(out, again)
            and all(v == 0 for v in hit_launches.values())):
        raise AssertionError("serve: admission checks failed")
    return {"retry_after_s": retry, "deadline_exceeded": expired, "invalid_deadline": invalid,
            "cache_hits": hits, "cache_hit_launches": hit_launches}


def _serve_health(torch, np, wam, reqs) -> dict:
    """The with_health=True entry: its health vector against `health_stats`
    recomputed from the fetched mosaic, and a health-monitored server."""
    from wam_tpu_torch import obs
    from wam_tpu_torch.evalsuite.fan import device_fetch
    from wam_tpu_torch.serve import AttributionServer

    ent = wam.serve_entry(with_health=True, donate=False)
    dev = torch.device(DEVICE)
    xs = torch.from_numpy(np.stack([r[0] for r in reqs[:SERVE_MAX_BATCH * 4:4]])).to(dev)
    ys = torch.tensor([r[1] for r in reqs[:SERVE_MAX_BATCH * 4:4]], device=dev)
    out, hvec = device_fetch(ent(xs, ys))
    want = obs.health.health_stats(torch.from_numpy(out)).numpy()
    err = float(np.abs(hvec[:5] - want[:5]).max())
    rel = abs(float(hvec[5]) - float(want[5])) / float(want[5])
    server = AttributionServer(ent, [SERVE_BUCKETS[0]], max_batch=SERVE_MAX_BATCH, health=True,
                               device=DEVICE)
    try:
        server.submit(reqs[0][0], reqs[0][1]).result(timeout=SERVE_TIMEOUT_S)
        monitor = server.describe()["health"]
    finally:
        server.close()
    _log(f"  with_health=True: vector {[round(float(v), 6) for v in hvec]} against health_stats "
         f"of the fetched mosaic: counts and max abs diff {err:.3e}, sum of squares rel "
         f"{rel:.2e}; monitored server: {monitor}")
    if err != 0.0 or rel > 1e-5 or monitor["checks"] < 1 or monitor["quarantined"]:
        raise AssertionError("serve: health vector disagrees with the fetched mosaic")
    return {"health_vector": [float(v) for v in hvec], "counts_max_abs_diff": err,
            "sumsq_rel_err": rel, "monitor": monitor}


def _serve_anytime(torch, np, wtt, fn, reqs, smi: str) -> dict:
    """The anytime server on the 224² bucket: a full batch (every sample,
    against the streamed serve_entry on the same assembled batch within
    ANY_TOL: one sample a model call, as the anytime step runs them, so the
    convolutions see the same batch shape and only the order of the sample
    sum differs), then a deadline at half the full batch's time (n_used <
    25, confidence in (0, 1])."""
    from wam_tpu_torch.anytime import AnytimeResult
    from wam_tpu_torch.serve import AttributionServer

    dev = torch.device(DEVICE)
    kw = dict(wavelet=WAVELET, J=LEVELS, mode=MODE, n_samples=N_SAMPLES, stdev_spread=SPREAD,
              device=dev)
    wam = wtt.WaveletAttribution2D(fn, **kw)
    streamed = wtt.WaveletAttribution2D(fn, stream_noise=True, sample_batch_size=1, **kw)
    exact = [r for r in reqs if r[0].shape == SERVE_BUCKETS[0]][:SERVE_MAX_BATCH]
    server = AttributionServer(wam.anytime_serve_entry(stride=SERVE_ANY_STRIDE),
                               [SERVE_BUCKETS[0]], max_batch=SERVE_MAX_BATCH,
                               coalesce_ms=5000.0, device=DEVICE)
    try:
        t0 = time.perf_counter()
        full = [f.result(timeout=SERVE_TIMEOUT_S)
                for f in [server.submit(x, y) for x, y, _ in exact]]
        full_ms = (time.perf_counter() - t0) * 1e3
        deadline_ms = 0.5 * full_ms
        part = [f.result(timeout=SERVE_TIMEOUT_S)
                for f in [server.submit(x, y, deadline_ms=deadline_ms) for x, y, _ in exact]]
    finally:
        server.close()
    if not all(isinstance(r, AnytimeResult) and r.complete and r.n_used == N_SAMPLES
               for r in full):
        raise AssertionError("serve anytime: a request with no deadline did not complete")
    pad = SERVE_MAX_BATCH - len(exact)  # the server pads a batch with copies of row 0
    xs = torch.from_numpy(np.stack([x for x, _, _ in exact] + [exact[0][0]] * pad)).to(dev)
    ys = torch.tensor([y for _, y, _ in exact] + [exact[0][1]] * pad, device=dev)
    want = streamed.serve_entry(donate=False)(xs, ys)[:len(exact)]
    check = _held(torch, "anytime server's full maps vs the streamed serve_entry on the same "
                  "batch", torch.from_numpy(np.stack([r.attribution for r in full])), want,
                  ANY_TOL)
    conf = [r.confidence for r in part]
    _log(f"  anytime server (stride {SERVE_ANY_STRIDE}): full batch {full_ms:.1f} ms (host "
         f"clock, submit to the last result); deadline {deadline_ms:.1f} ms: n_used "
         f"{part[0].n_used} of {part[0].n_total}, deadline partial {not part[0].complete}, "
         f"confidence {min(conf):.4f}-{max(conf):.4f} on {smi}")
    if not (part[0].n_used < N_SAMPLES and all(0.0 < c <= 1.0 for c in conf)):
        raise AssertionError(f"serve anytime: deadline run n_used {part[0].n_used}, conf {conf}")
    return {"full_batch_ms": full_ms, "deadline_ms": deadline_ms, "n_used": part[0].n_used,
            "n_total": part[0].n_total, "confidence": conf, "check": check}


def _serve_reduced_check(torch, np, wtt) -> dict:
    """The served path on the card against the CPU plain path: a seeded
    ResNet-18 in float64, SERVE_REDUCED images of 32², db4 J=2, IG with 2
    path points (no noise to match across devices), the plain transforms
    (impl="matmul"; the kernels are float32), through an AttributionServer
    staging float64 batches on the card; <= SERVE_F64_TOL x max."""
    from wam_tpu_torch.serve import AttributionServer

    n, side, steps = SERVE_REDUCED
    torch.manual_seed(SEED)
    model = wtt.resnet18(num_classes=10).double()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(SEED + 7)
    x = rng.standard_normal((n, CHANNELS, side, side))
    y = [1, 7][:n]
    kw = dict(wavelet=WAVELET, J=2, method="integratedgrad", n_samples=steps, impl="matmul")
    outs = {}
    for dev in ("card", "cpu"):
        m = wtt.resnet18(num_classes=10).double()
        m.load_state_dict(state)
        where = DEVICE if dev == "card" else "cpu"
        ent = wtt.WaveletAttribution2D(wtt.bind_inference(m, device=where), device=where,
                                       **kw).serve_entry(donate=False)
        if dev == "card":
            server = AttributionServer(ent, [(CHANNELS, side, side)], max_batch=n,
                                       dtype=np.float64, device=DEVICE)
            try:
                outs[dev] = np.stack([f.result(timeout=SERVE_TIMEOUT_S) for f in
                                      [server.submit(x[i], y[i]) for i in range(n)]])
            finally:
                server.close()
        else:
            outs[dev] = ent(torch.from_numpy(x), torch.tensor(y)).numpy()
    err = float(np.abs(outs["card"] - outs["cpu"]).max())
    peak = float(np.abs(outs["cpu"]).max())
    _log(f"  reduced check: served on the card vs the CPU plain path (float64 ResNet-18, {n} x "
         f"{side}^2, IG {steps} points, J=2): max abs {err:.3e} = {err / peak:.2e} of the max "
         f"(tol {SERVE_F64_TOL})")
    if not (outs["card"].dtype == np.float64 and err <= SERVE_F64_TOL * peak):
        raise AssertionError("serve reduced check: the card's served path disagrees with the CPU")
    return {"max_abs_err": err, "max": peak, "rel_err": err / peak}


def phase_serve(torch, wtt, kernels, smi: str) -> dict:
    """The serving runtime at the README's server over the flagship's
    explainer: both buckets warmed (one first call each, none after), the
    request stream through the pipelined and the unpipelined arm, the
    admission, health and anytime checks and the reduced check."""
    import numpy as np

    from wam_tpu_torch import obs
    from wam_tpu_torch.serve import ServeMetrics

    fn, _, _, _, _ = build_slice(torch, wtt)
    dev = torch.device(DEVICE)
    wam = wtt.WaveletAttribution2D(fn, wavelet=WAVELET, J=LEVELS, mode=MODE, n_samples=N_SAMPLES,
                                   stdev_spread=SPREAD, device=dev)
    _log(f"phase serve: AttributionServer(WaveletAttribution2D(ResNet-50, {WAVELET}, J={LEVELS}, "
         f"n={N_SAMPLES}).serve_entry(), {list(SERVE_BUCKETS)}, max_batch={SERVE_MAX_BATCH}): "
         f"{SERVE_MAX_BATCH * N_SAMPLES} model rows a batch; cudnn.allow_tf32=True "
         "matmul.allow_tf32=False")
    obs.reset()
    counter = ServeMetrics()
    entry = wam.serve_entry(on_trace=counter.note_compile)
    reqs = _serve_requests(np, SERVE_REQUESTS, SEED + 11)
    t0 = time.perf_counter()
    arms = {}
    for i, pipelined in enumerate(SERVE_ARMS):
        arms[f"{i + 1}: {'pipelined' if pipelined else 'unpipelined'}"] = _serve_arm(
            torch, np, wtt, kernels, entry, reqs, pipelined, smi)
    events = obs.sentinel.compile_events()
    _log(f"  first calls (sentinel): {[(e['bucket'], e['phase']) for e in events]}")
    if (counter.compile_count != len(SERVE_BUCKETS) or len(events) != len(SERVE_BUCKETS)
            or any(e["phase"] != "warmup" for e in events)):
        raise AssertionError(f"serve: first calls {events}, expected one per bucket at warmup")
    first = next(iter(arms.values()))
    out = {"arms": arms, "first_calls": [e["bucket"] for e in events],
           "launches": first["launches"], "batch_launches": first["batch_launches"]}
    part_s = {"arms": time.perf_counter() - t0}
    for name, fn_, args in (("admission", _serve_admission, (torch, np, kernels, entry, reqs)),
                            ("health", _serve_health, (torch, np, wam, reqs)),
                            ("anytime", _serve_anytime, (torch, np, wtt, fn, reqs, smi)),
                            ("reduced_check", _serve_reduced_check, (torch, np, wtt))):
        t = time.perf_counter()
        out[name] = fn_(*args)
        part_s[name] = time.perf_counter() - t
    _log("  serve parts (s): " + ", ".join(f"{k} {v:.1f}" for k, v in part_s.items()))
    out["part_s"] = part_s
    return out


# -- phase parallel: the sharded estimators on the flagship ---------------------------


def _spmd_step(torch, wam):
    """The spmd step contract (`parallel.sharded_smoothgrad_spmd`) on the
    flagship explainer's engine: a block's (s, b, C, H, W) noisy rows, its
    labels and the loss-mean rescale -> (s, b, S, S) mosaics, normalize=False
    (one decomposition and one backward a block: K1 LEVELS, K3 2)."""
    from wam_tpu_torch.core.engine import map_coeffs
    from wam_tpu_torch.ops.packing2d import mosaic2d

    def step(noisy, y_local, grad_scale):
        s = noisy.shape[0]
        spatial = tuple(noisy.shape[-2:])
        flat = noisy.reshape((-1,) + tuple(noisy.shape[2:]))
        with torch.no_grad():
            coeffs = wam.engine.decompose(flat)
        grads = wam.engine.grads_from_coeffs(coeffs, y_local.repeat(s), spatial, samples=s)
        grads = map_coeffs(lambda t: (t * grad_scale).reshape((s, -1) + tuple(t.shape[1:])),
                           grads)
        return mosaic2d(grads, normalize=False)

    return step


def _ig_grad_fn(torch, wam):
    """`parallel.sharded_integrated_path`'s grad_fn on the flagship's engine:
    a block's coefficients scaled by its path points, stacked into one model
    call, their rescaled gradients as (s, b, S, S) mosaics (K3 2 a block)."""
    from wam_tpu_torch.core.engine import map_coeffs
    from wam_tpu_torch.ops.packing2d import mosaic2d

    def grad_fn(coeffs, y_local, alphas, grad_scale):
        s = alphas.shape[0]
        scaled = map_coeffs(lambda c: (c[None] * alphas.to(c.dtype).reshape(-1, 1, 1, 1, 1))
                            .reshape((-1,) + tuple(c.shape[1:])), coeffs)
        grads = wam.engine.grads_from_coeffs(scaled, y_local.repeat(s), (SIDE, SIDE), samples=s)
        grads = map_coeffs(lambda g: (g * grad_scale).reshape((s, -1) + tuple(g.shape[1:])),
                           grads)
        return mosaic2d(grads, normalize=False)

    return grad_fn


def _timed_runs(torch, kernels, run, launches: dict, calls: int, tag: str, smi: str) -> dict:
    """One warm call, one with the launch counts set to 0 just before and
    read just after (asserted == ``launches``), then ``calls`` CUDA-event-
    timed calls with the host's enqueue time beside each; peak memory."""
    run()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    got = kernels.launch_counts()
    if got != launches:
        raise AssertionError(f"{tag}: launches {got}, expected {launches}")
    torch.cuda.reset_peak_memory_stats()
    times, enqueue = [], []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        run()
        end.record()
        enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    med = sorted(times)[len(times) // 2]
    peak = torch.cuda.max_memory_allocated() / 1e9
    _log(f"  {tag}: launches {got} (asserted); {calls} calls (CUDA events) "
         f"{[round(t, 3) for t in times]} ms, median {med:.3f} ms = "
         f"{BATCH / (med / 1e3):.2f} attributions/s; host enqueue "
         f"{[round(t, 3) for t in enqueue]} ms; peak memory {peak:.3f} GB on {smi}")
    return {"out": out, "launches": got, "calls_ms": times, "median_ms": med,
            "spread_ms": [min(times), max(times)], "enqueue_ms": enqueue,
            "attributions_per_s": BATCH / (med / 1e3), "peak_memory_gb": peak}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _par_turns(torch, wam, spmd_call, x, y, smi: str) -> dict:
    """The spmd call against the flagship's single-device call (the same
    800 rows in chunks of SAMPLE_CHUNK x BATCH) at the flagship's headline
    precision (TF32 convolutions), CUDA events, in turns (flagship, spmd,
    spmd, flagship) after a warm call of each; TF32 goes back off."""
    torch.backends.cudnn.allow_tf32 = True
    try:
        calls = {"flagship": lambda: wam(x, y), "spmd": spmd_call}
        for fn in calls.values():
            fn()
        times, enqueue = {k: [] for k in calls}, {k: [] for k in calls}
        for arm in ("flagship", "spmd", "spmd", "flagship"):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            calls[arm]()
            end.record()
            enqueue[arm].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            times[arm].append(start.elapsed_time(end))
    finally:
        torch.backends.cudnn.allow_tf32 = False
    ms = {k: [round(t, 2) for t in v] for k, v in times.items()}
    host = {k: [round(t, 1) for t in v] for k, v in enqueue.items()}
    _log("  TF32 convolutions, in turns (flagship, spmd, spmd, flagship; CUDA events): flagship "
         f"{ms['flagship']} ms (host enqueue {host['flagship']}), spmd {ms['spmd']} ms (host "
         f"enqueue {host['spmd']}) on {smi}")
    return {"ms": times, "enqueue_ms": enqueue}


def _par_nccl_check(torch, wtt, wam, x, y, z) -> dict:
    """A process group of one rank on NCCL (`parallel.init_distributed`):
    the spmd runner on ``hybrid_mesh(PAR_MESH, [DEVICE] * 10)`` (every block
    owned by rank 0) takes its all_reduce branch at the flagship's shapes
    (blocks of 5 samples x 16 images) and must equal the same runner on the
    one-process mesh exactly (cuDNN deterministic for both)."""
    import os

    import torch.distributed as dist

    from wam_tpu_torch import parallel

    step = _spmd_step(torch, wam)
    n_blocks = math.prod(PAR_MESH.values())
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one rank: its bootstrap on loopback
    info = parallel.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                                     initialization_timeout=120)
    torch.backends.cudnn.deterministic = True
    try:
        mesh = parallel.hybrid_mesh(PAR_MESH, devices=[DEVICE] * n_blocks)
        kw = dict(n_samples=N_SAMPLES, stdev_spread=SPREAD)
        got = parallel.sharded_smoothgrad_spmd(step, mesh, **kw)(x, y, noise=z)
        want = parallel.sharded_smoothgrad_spmd(
            step, parallel.make_mesh(PAR_MESH, [DEVICE] * n_blocks), **kw)(x, y, noise=z)
        backend = dist.get_backend()
    finally:
        torch.backends.cudnn.deterministic = False
        dist.destroy_process_group()
    err = float((got - want).abs().max())
    _log(f"  NCCL group of one ({info}, backend {backend}): hybrid_mesh "
         f"{mesh.shape} (every block on rank {sorted(set(mesh.process_ids.ravel().tolist()))}) "
         f"through the all_reduce branch against the one-process mesh, {BATCH} images x "
         f"{N_SAMPLES} samples: max abs diff {err:.3e} (must be 0)")
    if backend != "nccl" or mesh.process_ids is None or err != 0.0:
        raise AssertionError("parallel: the all_reduce branch changed the map")
    return {"info": info, "backend": backend, "max_abs_diff": err}


def _par_eval2d(torch, wtt, kernels, smi: str) -> dict:
    """`Eval2DWAM(mesh=)` insertion at the eval2d phase's geometry over a
    {data: 2} mesh on the one card: the mosaics handed to it from the
    mesh-less evaluator, one counted call (launches EVAL_LAUNCHES, one
    fetch), AUCs and curves against the mesh-less call within EVAL_TOL,
    and event times of both in turns."""
    from wam_tpu_torch import parallel
    from wam_tpu_torch.evalsuite import fan

    _, ev, x, y = build_eval2d(torch, wtt)
    prec = _precision(torch, True)
    ev.precompute(x, y)
    mesh = parallel.make_mesh({"data": 2}, [DEVICE] * 2)
    sharded = wtt.Eval2DWAM(ev.model_fn, ev.explainer, wavelet=EVAL_WAVELET, J=EVAL_LEVELS,
                            batch_size=EVAL_CAP, mesh=mesh, device=DEVICE)
    sharded.grad_wams = ev.grad_wams
    want = (ev.insertion(x, y, n_iter=EVAL_N_ITER), ev.insertion_curves)
    sharded.insertion(x, y, n_iter=EVAL_N_ITER)  # warm
    counted = _counted_call(torch, kernels, fan, lambda: (
        sharded.insertion(x, y, n_iter=EVAL_N_ITER), sharded.insertion_curves))
    got = counted["out"]
    err_auc = max(abs(a - b) for a, b in zip(got[0], want[0]))
    err_curve = max(float(abs(a - b).max()) for a, b in zip(got[1], want[1]))
    times = {"mesh": [], "single": []}
    for arm in ("mesh", "single", "single", "mesh"):
        e = sharded if arm == "mesh" else ev
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        e.insertion(x, y, n_iter=EVAL_N_ITER)
        end.record()
        torch.cuda.synchronize()
        times[arm].append(start.elapsed_time(end))
    _log(f"  Eval2DWAM(mesh={mesh.shape}) insertion ({EVAL_BATCH} images, n_iter {EVAL_N_ITER}, "
         f"{prec}): launches {counted['launches']} (asserted {EVAL_LAUNCHES['insertion']}), "
         f"fetches {counted['fetches']} (asserted 1); against the mesh-less call: AUC max abs "
         f"{err_auc:.3e} (tol {EVAL_TOL['auc']}), curves {err_curve:.3e} (tol "
         f"{EVAL_TOL['curve']}); ms in turns mesh {[round(t, 2) for t in times['mesh']]}, "
         f"single {[round(t, 2) for t in times['single']]} on {smi}")
    if (counted["launches"] != EVAL_LAUNCHES["insertion"] or counted["fetches"] != 1
            or err_auc > EVAL_TOL["auc"] or err_curve > EVAL_TOL["curve"]):
        raise AssertionError("parallel: the evaluator on a mesh disagrees with its mesh-less call")
    return {"launches": counted["launches"], "fetches": counted["fetches"],
            "auc_max_abs_err": err_auc, "curve_max_abs_err": err_curve, "ms": times,
            "scores": got[0]}


def _par_f64_check(torch, wtt) -> dict:
    """The spmd runner on the card against the same runner on the CPU in
    float64: a seeded ResNet-18 (10 classes), PAR_REDUCED images of 32²,
    db4 J=2 on the plain transforms (the kernels are float32), noise handed
    over, {data: 2, sample: 2} over the card and over the CPU."""
    from wam_tpu_torch import parallel

    n_img, side, n_smp = PAR_REDUCED
    torch.manual_seed(SEED)
    state = {k: v.clone() for k, v in wtt.resnet18(num_classes=10).double().state_dict().items()}
    g = torch.Generator().manual_seed(SEED + 9)
    x = torch.randn((n_img, CHANNELS, side, side), generator=g, dtype=torch.float64)
    z = torch.randn((n_smp,) + tuple(x.shape), generator=g, dtype=torch.float64)
    y = torch.tensor([1, 7][:n_img])
    outs = {}
    for where in ("card", "cpu"):
        dev = DEVICE if where == "card" else "cpu"
        m = wtt.resnet18(num_classes=10).double()
        m.load_state_dict(state)
        wam = wtt.WaveletAttribution2D(wtt.bind_inference(m, device=dev), wavelet=WAVELET, J=2,
                                       mode=MODE, device=dev, impl="matmul")
        mesh = parallel.make_mesh({"data": 2, "sample": 2}, [dev] * 4)
        run = parallel.sharded_smoothgrad_spmd(_spmd_step(torch, wam), mesh, n_samples=n_smp,
                                               stdev_spread=SPREAD)
        outs[where] = run(x.to(dev), y.to(dev), noise=z.to(dev)).cpu()
    err = float((outs["card"] - outs["cpu"]).abs().max())
    peak = float(outs["cpu"].abs().max())
    _log(f"  reduced check: spmd SmoothGrad on the card vs the CPU (float64 ResNet-18, {n_img} x "
         f"{side}^2, {n_smp} samples, db4 J=2, plain transforms): max abs {err:.3e} = "
         f"{err / peak:.2e} of the max (tol {PAR_F64_TOL})")
    if not (outs["card"].dtype == torch.float64 and err <= PAR_F64_TOL * peak):
        raise AssertionError("parallel reduced check: the card disagrees with the CPU")
    return {"max_abs_err": err, "max": peak, "rel_err": err / peak}


def phase_parallel(torch, wtt, kernels, smi: str) -> dict:
    """The sharded estimators on the flagship (module docstring, phase 22):
    spmd SmoothGrad over {data 2, sample 5} and the propagation runner over
    the same mesh, IG over {data 2, sample 4}, each counted and timed and
    held to the single-device estimator at the blocks' model-call shapes;
    the NCCL group of one, the evaluator on a mesh, the float64 check."""
    from wam_tpu_torch import parallel
    from wam_tpu_torch.core.estimators import integrated_path, smoothgrad

    fn, wam, x, y, g = build_slice(torch, wtt)
    prec = _precision(torch, False)
    dev = torch.device(DEVICE)
    z = torch.randn((N_SAMPLES,) + tuple(x.shape), generator=g, device=dev)
    step = _spmd_step(torch, wam)
    mesh = parallel.make_mesh(PAR_MESH, [DEVICE] * math.prod(PAR_MESH.values()))
    ns, nb = N_SAMPLES // PAR_MESH["sample"], BATCH // PAR_MESH["data"]
    _log(f"phase parallel: the flagship (ResNet-50 x ({BATCH},{CHANNELS},{SIDE},{SIDE}) {WAVELET} "
         f"J={LEVELS} n={N_SAMPLES} spread={SPREAD}, normalize=False) over make_mesh({PAR_MESH}, "
         f"[{DEVICE}] * {mesh.size}): blocks of {ns} samples x {nb} images = {ns * nb} model "
         f"rows; {prec}")
    out = {"precision": prec}
    spmd = parallel.sharded_smoothgrad_spmd(step, mesh, n_samples=N_SAMPLES, stdev_spread=SPREAD)
    run = _timed_runs(torch, kernels, lambda: spmd(x, y, noise=z), PAR_LAUNCHES, PAR_CALLS,
                      "sharded_smoothgrad_spmd", smi)
    # the single-device smoothgrad at the blocks' model-call shapes: each
    # data half on its own, ns samples a model call, the same rescale
    halves = [slice(d * nb, (d + 1) * nb) for d in range(PAR_MESH["data"])]
    ref = torch.cat([smoothgrad(lambda n, h=h: step(n, y[h], nb / BATCH), x[h],
                                n_samples=N_SAMPLES, stdev_spread=SPREAD, batch_size=ns,
                                noise=z[:, h]) for h in halves])
    out["spmd"] = {**_summary(run), "check": _held(
        torch, "spmd vs single-device smoothgrad (same noise, the blocks' shapes)", run["out"],
        ref, PAR_TOL)}
    out["spmd"]["tf32_turns"] = _par_turns(torch, wam, lambda: spmd(x, y, noise=z), x, y, smi)
    # the propagation runner: the step sees the whole batch; one block a
    # sample shard (ns samples x BATCH images)
    full_step = lambda n: step(n, y, 1.0)  # noqa: E731
    prop = parallel.sharded_smoothgrad(full_step, mesh, n_samples=N_SAMPLES, stdev_spread=SPREAD)
    run = _timed_runs(torch, kernels, lambda: prop(x, noise=z), PAR_PROP_LAUNCHES, 1,
                      "sharded_smoothgrad", smi)
    ref = smoothgrad(full_step, x, n_samples=N_SAMPLES, stdev_spread=SPREAD, batch_size=ns,
                     noise=z)
    out["propagation"] = {**_summary(run), "check": _held(
        torch, "sharded_smoothgrad vs single-device smoothgrad (same noise, same shapes)",
        run["out"], ref, PAR_TOL)}
    # IG: the α-path over the sample axis, the batch over the data axis
    ig_mesh = parallel.make_mesh(PAR_IG_MESH, [DEVICE] * math.prod(PAR_IG_MESH.values()))
    grad_fn = _ig_grad_fn(torch, wam)
    ig = parallel.sharded_integrated_path(grad_fn, wam.engine.decompose, ig_mesh,
                                          n_steps=PAR_IG_STEPS)
    run = _timed_runs(torch, kernels, lambda: ig(x, y), PAR_IG_LAUNCHES, 1,
                      "sharded_integrated_path", smi)
    chunk = PAR_IG_STEPS // PAR_IG_MESH["sample"]
    ref = []
    for h in halves:
        with torch.no_grad():
            coeffs = wam.engine.decompose(x[h])
        ref.append(integrated_path(lambda a, c=coeffs, h=h: grad_fn(c, y[h], a, nb / BATCH),
                                   n_steps=PAR_IG_STEPS, batch_size=chunk, device=dev))
    out["ig"] = {**_summary(run), "check": _held(
        torch, f"sharded IG ({PAR_IG_STEPS} points over {PAR_IG_MESH}) vs single-device "
        "integrated_path (the blocks' shapes)", run["out"], torch.cat(ref), PAR_TOL)}
    out["nccl"] = _par_nccl_check(torch, wtt, wam, x, y, z)
    out["eval2d"] = _par_eval2d(torch, wtt, kernels, smi)
    out["reduced_check"] = _par_f64_check(torch, wtt)
    _precision(torch, False)
    return out


# -- phase fleet: the flagship's server as a supervised fleet ---------------------------


class _FleetRecorder:
    """A replica's served entry behind a recorder shared by the fleet: each
    dispatched batch's inputs (copies: the entry releases its input), its
    output, its side and the replica that ran it."""

    def __init__(self, log, lock, rid, entry):
        self.log, self.lock, self.rid, self.entry = log, lock, rid, entry
        self.wam_blocks = entry.wam_blocks  # the oversize route's split (not recorded)

    def __call__(self, xs, ys):
        keep = (xs.clone(), ys.clone())
        out = self.entry(xs, ys)
        with self.lock:
            self.log.append({"rid": self.rid, "x": keep[0], "y": keep[1], "out": out,
                             "side": int(keep[0].shape[-1]), "t": time.perf_counter()})
        return out


def _fleet_stream(torch, np, kernels, fleet, batches, reqs, smi: str,
                  clients: int = SERVE_CLIENTS, window: int = SERVE_WINDOW) -> dict:
    """The request stream through the fleet: launches counted from 0 just
    before and read just after (the sum of SERVE_LAUNCHES over the batches
    served: each batch's launches as in phase serve), zero lost, both
    replicas serving, the rate and the peak memory."""
    from wam_tpu_torch import obs

    batches.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with obs.assert_no_retrace():
        results, lost, wall = _drive_clients(fleet, reqs, clients, window)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    expect = {k: sum(SERVE_LAUNCHES[b["side"]][k] for b in batches) for k in ZERO_LAUNCHES}
    by_rid = {rid: sum(1 for b in batches if b["rid"] == rid) for rid in range(FLEET_REPLICAS)}
    fill = len(reqs) / (len(batches) * SERVE_MAX_BATCH)
    summary = fleet.metrics.fleet_summary()
    _log(f"  fleet stream: {len(reqs)} requests ({clients} clients x {window} in flight) in "
         f"{wall:.3f} s = "
         f"{len(reqs) / wall:.2f} requests/s; batches by replica {by_rid} (fill {fill:.3f}); "
         f"launches {launches} (the batches' sum {expect}); p50 "
         f"{summary['latency_p50_ms']:.1f} ms, p99 {summary['latency_p99_ms']:.1f} ms; peak "
         f"memory {peak:.2f} GB (two replicas on one card) on {smi}")
    if lost:
        raise AssertionError(f"fleet: {len(lost)} requests lost: {lost[:4]}")
    if launches != expect or min(by_rid.values()) == 0:
        raise AssertionError(f"fleet: launches {launches} != {expect}, or a replica idle "
                             f"({by_rid})")
    return {"results": results, "wall_s": wall, "requests_per_s": len(reqs) / wall,
            "batches_by_replica": by_rid, "fill": fill, "launches": launches,
            "peak_memory_gb": peak,
            "latency_p50_ms": summary["latency_p50_ms"],
            "latency_p99_ms": summary["latency_p99_ms"]}


def _fleet_oversize(torch, np, fleet, entry, reqs) -> dict:
    """An oversize `attribute_batch` of FLEET_OVERSIZE images at 224²
    through the "pjit" route: max_batch rows a replica, each run by the
    replica's own oversize entry on its device and thread. The flagship's
    entry reduces over its batch (noise drawn at the batch's shape, a
    batch-mean loss, a mosaic normalized over the batch's rows), so the
    route runs its `RowBlocks`. Timed at the served precision; then held,
    with cuDNN off, to the entry on all FLEET_OVERSIZE rows within 1e-5 x
    max: cuDNN picks its convolution algorithm by a call's row count (200
    rows a block, 400 for the entry), and the ResNet's ReLU gates turn the
    difference into ~1e-2 of the max of a gradient, where PyTorch's own
    convolutions give each row the same result at any row count. A row-wise
    entry on a second fleet holds the gather: each replica's rows in place,
    exactly."""
    from wam_tpu_torch.serve import FleetServer

    dev = torch.device(DEVICE)
    imgs = [r for r in reqs if r[0].shape == SERVE_BUCKETS[0]]
    imgs = (imgs * (-(-FLEET_OVERSIZE // len(imgs))))[:FLEET_OVERSIZE]
    xs = np.stack([r[0] for r in imgs])
    ys = np.array([r[1] for r in imgs], np.int32)

    xt, yt = torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)
    t0 = time.perf_counter()
    served = fleet.attribute_batch(xs, ys)
    wall = time.perf_counter() - t0
    one_call = entry(xt, yt).detach().cpu().numpy()
    cudnn_err = float(np.abs(served - one_call).max() / np.abs(one_call).max())
    torch.backends.cudnn.enabled = False
    try:
        t0 = time.perf_counter()
        got = fleet.attribute_batch(xs, ys)
        wall_native = time.perf_counter() - t0
        want = entry(xt, yt).detach().cpu().numpy()
    finally:
        torch.backends.cudnn.enabled = True
    whole_err = float(np.abs(got - want).max())
    whole_bound = 1e-5 * float(np.abs(want).max())

    def per_row(a, b):
        return a.mean(dim=1) * 2.0 + b.to(a.dtype)[:, None, None]

    per_row.wam_row_wise = True
    rows = FleetServer(lambda rid, m, d: per_row, list(SERVE_BUCKETS),
                       devices=[DEVICE] * FLEET_REPLICAS, max_batch=SERVE_MAX_BATCH, warmup=False)
    try:
        gathered = rows.attribute_batch(xs, ys)
    finally:
        rows.close()
    want_rows = per_row(torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)).cpu().numpy()
    halves = [float(np.abs(gathered[lo:lo + SERVE_MAX_BATCH]
                           - want_rows[lo:lo + SERVE_MAX_BATCH]).max())
              for lo in range(0, FLEET_OVERSIZE, SERVE_MAX_BATCH)]
    _log(f"  oversize attribute_batch ({FLEET_OVERSIZE} x 224², \"pjit\", "
         f"{SERVE_MAX_BATCH} rows a replica, RowBlocks): {wall * 1e3:.1f} ms host clock, "
         f"{cudnn_err:.3e} of the max from the entry on all {FLEET_OVERSIZE} rows (cuDNN's "
         f"algorithms for 200 and 400 rows; not held); with cuDNN off ({wall_native * 1e3:.1f} "
         f"ms) against the entry on all {FLEET_OVERSIZE} rows: max abs {whole_err:.3e} (bound "
         f"{whole_bound:.3e} = 1e-5 x max); a row-wise entry's rows gathered per replica: "
         f"max abs {halves} (must be 0)")
    if not whole_err <= whole_bound or any(h != 0.0 for h in halves):
        raise AssertionError("fleet: the oversize route disagrees with the entry")
    return {"wall_ms": wall * 1e3, "wall_ms_cudnn_off": wall_native * 1e3,
            "max_abs": whole_err, "bound": whole_bound, "cudnn_rel": cudnn_err,
            "row_wise_halves_max_abs": halves}


def _fleet_fault(torch, np, fleet, injector, batches, reqs, smi: str) -> dict:
    """A `testing.faults` fault on replica 1 (its injector armed for one
    `ChaosFault`): the fleet re-routes (zero lost), the supervisor rebuilds
    replica 1 (``replica_restart`` rows restarting -> alive), and replica 1
    serves again after it rejoins."""
    from wam_tpu_torch.testing import FaultSpec

    injector.spec = FaultSpec(exc_p=1.0)
    t0 = time.perf_counter()
    lost, served = [], 0
    while injector.total() == 0:
        _, lost_k, _ = _drive_clients(fleet, reqs[:SERVE_MAX_BATCH * FLEET_REPLICAS])
        lost += lost_k
        served += SERVE_MAX_BATCH * FLEET_REPLICAS
        if time.perf_counter() - t0 > FLEET_RESTART_TIMEOUT_S:
            raise AssertionError("fleet: replica 1 never took its fault")
    while not fleet._replicas[1].alive:
        if time.perf_counter() - t0 > FLEET_RESTART_TIMEOUT_S:
            raise AssertionError("fleet: replica 1 never restarted")
        time.sleep(0.01)
    rejoin_s = time.perf_counter() - t0
    t_alive = time.perf_counter()
    while not any(b["rid"] == 1 and b["t"] > t_alive for b in batches):
        _, lost_k, _ = _drive_clients(fleet, reqs[:SERVE_MAX_BATCH * FLEET_REPLICAS])
        lost += lost_k
        served += SERVE_MAX_BATCH * FLEET_REPLICAS
        if time.perf_counter() - t0 > FLEET_RESTART_TIMEOUT_S:
            raise AssertionError("fleet: the rebuilt replica 1 never served")
    transitions = [r["transition"] for r in fleet.metrics.restarts if r["replica_id"] == 1]
    deaths = fleet.metrics.fleet_summary()["deaths"]
    _log(f"  fault on replica 1 (ChaosFault, injected {injector.counts}): deaths "
         f"{[d['replica_id'] for d in deaths]}, {served} requests served around it, lost "
         f"{len(lost)}; replica_restart rows {transitions}; rejoined after {rejoin_s:.2f} s "
         f"and served again on {smi}")
    if lost or transitions != ["restarting", "alive"] or [d["replica_id"] for d in deaths] != [1]:
        raise AssertionError(f"fleet: lost {lost[:4]}, transitions {transitions}")
    return {"injected": dict(injector.counts), "lost": len(lost), "served": served,
            "transitions": transitions, "rejoin_s": rejoin_s}


def _fleet_no_live(np, wam) -> dict:
    """An unsupervised fleet whose replicas all die: NoLiveReplicaError."""
    from wam_tpu_torch.serve import FleetServer, NoLiveReplicaError
    from wam_tpu_torch.testing import FaultInjector, FaultSpec
    from wam_tpu_torch.testing.faults import ChaosEntry

    fleet = FleetServer(lambda rid, m, dev: ChaosEntry(wam.serve_entry(), FaultInjector(
        FaultSpec(exc_p=1.0), SEED, rid)), list(SERVE_BUCKETS), devices=[DEVICE] * FLEET_REPLICAS,
        max_batch=SERVE_MAX_BATCH, warmup=False, supervise=False)
    x = np.zeros(SERVE_BUCKETS[0], np.float32)
    try:
        fleet.submit(x, 0).result(timeout=SERVE_TIMEOUT_S)
    except NoLiveReplicaError as e:
        err = repr(e)
    else:
        raise AssertionError("fleet: a request succeeded with every replica dead")
    finally:
        fleet.close()
    dead = fleet.describe()["dead"]
    _log(f"  every replica killed, supervise=False: {err}; dead {dead}")
    if dead != list(range(FLEET_REPLICAS)):
        raise AssertionError(f"fleet: dead replicas {dead}")
    return {"error": err, "dead": dead}


def phase_fleet(torch, wtt, kernels, smi: str) -> dict:
    """The serve phase's server over the flagship's explainer as a
    supervised FleetServer of FLEET_REPLICAS replicas on the one card:
    warmup (one first call a bucket a replica), the request stream, the
    served rows against the entry, the oversize route, a fault on replica 1
    and its restart, and NoLiveReplicaError without supervision."""
    import threading

    import numpy as np

    from wam_tpu_torch import obs
    from wam_tpu_torch.serve import FleetMetrics, FleetServer, SupervisorConfig
    from wam_tpu_torch.testing import FaultInjector, FaultSpec
    from wam_tpu_torch.testing.faults import ChaosEntry

    class _OnceInjector(FaultInjector):
        """Fires at most one fault: its spec goes back to none after it."""

        def draw(self):
            kind = super().draw()
            if kind is not None:
                self.spec = FaultSpec()
            return kind

    fn, _, _, _, _ = build_slice(torch, wtt)  # the serve phase's precision, as build_slice sets it
    prec = "torch.backends.cuda.matmul.allow_tf32=False torch.backends.cudnn.allow_tf32=True"
    card = torch.device("cuda", torch.cuda.current_device())  # the fleet's device entries
    wams = {card: wtt.WaveletAttribution2D(fn, wavelet=WAVELET, J=LEVELS, mode=MODE,
                                           n_samples=N_SAMPLES, stdev_spread=SPREAD, device=card)}

    def wam_on(d):
        """The explainer of device ``d``: every replica here is on the one
        card, so one explainer serves them all; a replica on another card
        would need the model bound there."""
        if d not in wams:
            raise AssertionError(f"fleet: no model bound on {d}")
        return wams[d]

    wam = wams[card]
    batches, lock = [], threading.Lock()
    injectors = {rid: _OnceInjector(FaultSpec(), SEED, rid) for rid in range(FLEET_REPLICAS)}

    def factory(rid, m, d):
        inner = _FleetRecorder(batches, lock, rid, wam_on(d).serve_entry(on_trace=m.note_compile))
        return ChaosEntry(inner, injectors[rid]) if rid in injectors else inner

    obs.reset()
    metrics = FleetMetrics()
    t0 = time.perf_counter()
    fleet = FleetServer(factory, list(SERVE_BUCKETS), devices=[DEVICE] * FLEET_REPLICAS,
                        max_batch=SERVE_MAX_BATCH, metrics=metrics, oversize="pjit",
                        supervise=SupervisorConfig(seed=SEED))
    start_s = time.perf_counter() - t0
    _log(f"phase fleet: FleetServer(WaveletAttribution2D(ResNet-50, {WAVELET}, J={LEVELS}, "
         f"n={N_SAMPLES}).serve_entry(), {list(SERVE_BUCKETS)}, devices=[{DEVICE}] * "
         f"{FLEET_REPLICAS}, max_batch={SERVE_MAX_BATCH}, supervise=True): started (both "
         f"replicas warmed) in {start_s:.2f} s; {prec}")
    reqs = _serve_requests(np, SERVE_REQUESTS, SEED + 11)
    out = {"precision": prec, "start_s": start_s}
    try:
        warm = obs.sentinel.compile_events()
        per = [metrics.replica(rid).compile_count for rid in range(FLEET_REPLICAS)]
        if per != [len(SERVE_BUCKETS)] * FLEET_REPLICAS or any(
                e["phase"] != "warmup" for e in warm):
            raise AssertionError(f"fleet: first calls at warmup {per}, {warm}")
        stream = _fleet_stream(torch, np, kernels, fleet, batches, reqs, smi)
        results = stream.pop("results")
        rec = type("Rec", (), {"batches": list(batches), "entry": wam.serve_entry(donate=False)})
        stream["rows"] = _check_served_rows(torch, np, rec, reqs, results, "fleet")
        out["stream"] = stream
        out["oversize"] = _fleet_oversize(torch, np, fleet, rec.entry, reqs)
        out["fault"] = _fleet_fault(torch, np, fleet, injectors[1], batches, reqs, smi)
        # the fleet's entries' first calls (the checks' own entry carries
        # no replica label)
        events = [e for e in obs.sentinel.compile_events() if e["replica"] is not None]
        phases = sorted({e["phase"] for e in events})
        per = [metrics.replica(rid).compile_count for rid in range(FLEET_REPLICAS)]
        _log(f"  first calls (sentinel): "
             f"{[(e['replica'], e['bucket'], e['phase']) for e in events]}; per replica {per} "
             "(replica 1 rebuilt: its new entry's at its warmup)")
        if (phases != ["oversize", "warmup"]
                or per != [len(SERVE_BUCKETS), 2 * len(SERVE_BUCKETS)]):
            raise AssertionError(f"fleet: first calls outside warmup: {events}")
        out["first_calls"] = {"per_replica": per, "phases": phases, "events": len(events)}
        out["summary"] = {k: v for k, v in metrics.fleet_summary().items()
                          if k not in ("per_replica",)}
    finally:
        fleet.close()
    out["no_live"] = _fleet_no_live(np, wam)
    # the serve phase's 16 requests in flight split over two replicas fill
    # half of each batch (4 a bucket a replica, padded to 8 rows); a fresh
    # fleet under twice the clients (32 in flight) fills them
    wide = FleetServer(lambda rid, m, d: _FleetRecorder(batches, lock, rid, wam_on(d).serve_entry(
        on_trace=m.note_compile)), list(SERVE_BUCKETS), devices=[DEVICE] * FLEET_REPLICAS,
        max_batch=SERVE_MAX_BATCH, oversize="fanout")
    reqs = _serve_requests(np, 2 * SERVE_REQUESTS, SEED + 12)
    try:
        stream = _fleet_stream(torch, np, kernels, wide, batches, reqs, smi,
                               clients=2 * SERVE_CLIENTS)
        rec = type("Rec", (), {"batches": list(batches), "entry": wam.serve_entry(donate=False)})
        stream["rows"] = _check_served_rows(torch, np, rec, reqs, stream.pop("results"),
                                            "fleet, 32 in flight")
        out["stream_wide"] = stream
    finally:
        wide.close()
    return out


# -- phase seq: sequence-sharded attribution on the one card -----------------------------


def _seq_mesh(wtt, k: int = SEQ_SHARDS, device: str | None = None):
    """The seq arms' mesh: {data: k}, one block an entry, every entry the card
    (or ``device``)."""
    return wtt.parallel.make_mesh({"data": k}, [device or DEVICE] * k)


def _flat_out(torch, out):
    """An explainer's result (a map, or the 1D (mel, coefficients) pair) as
    one float64 vector on the CPU."""
    from wam_tpu_torch.parallel.tree import tree_leaves

    return torch.cat([t.detach().double().cpu().flatten() for t in tree_leaves(out)])


def _seq_timed(torch, kernels, call, tag: str, items: int, unit: str, smi: str) -> dict:
    """One counted call (first at its shapes: cuDNN plans, the allocator),
    with the launch counts and the halo counter set to 0 just before and read
    just after (K1-K5 must read 0: the sharded transforms are cuDNN
    convolutions), then SEQ_CALLS CUDA-event-timed calls with each call's
    host enqueue time; the peak memory over them."""
    from wam_tpu_torch.parallel import halo

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    halo.reset_halo_elements()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches, moved = kernels.launch_counts(), halo.halo_elements()
    if launches != ZERO_LAUNCHES:
        raise AssertionError(f"seq {tag}: launches {launches}, expected none")
    torch.cuda.reset_peak_memory_stats()
    times, enqueue = [], []
    for _ in range(SEQ_CALLS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        call()
        end.record()
        enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    med = sorted(times)[len(times) // 2]
    peak = torch.cuda.max_memory_allocated() / 1e9
    _log(f"  {tag}: launches {launches} (asserted 0); halo elements moved a call {moved:,} "
         f"(forward transforms); first call {first_s:.2f} s; {SEQ_CALLS} calls (CUDA events) "
         f"{[round(t, 2) for t in times]} ms, median {med:.2f} ms = "
         f"{items / (med / 1e3):.2f} {unit}/s; host enqueue {[round(t, 1) for t in enqueue]} "
         f"ms; peak memory {peak:.3f} GB on {smi}")
    if not bool(torch.isfinite(_flat_out(torch, out)).all()):
        raise AssertionError(f"seq {tag}: the result is not finite")
    return {"out": out, "launches": launches, "halo_elements": moved, "first_call_s": first_s,
            "calls_ms": times, "median_ms": med, "spread_ms": [min(times), max(times)],
            "enqueue_ms": enqueue, f"{unit}_per_s": items / (med / 1e3),
            "peak_memory_gb": peak}


def _seq_summary(run: dict) -> dict:
    return {k: v for k, v in run.items() if k != "out"}


def _seq_check(torch, tag: str, got, want, tol: tuple) -> dict:
    """A seq result against its reference: `_held` over the whole result."""
    return _held(torch, tag, _flat_out(torch, got), _flat_out(torch, want), tol)


def _seq_noise(torch, shape, n: int, seed: int):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return torch.randn((n,) + tuple(shape), generator=g, device=DEVICE)


def _seq1d(torch, wtt, kernels, smi: str) -> dict:
    """The audio phase's configuration over {data: 4}: the headline (n=50,
    chunk 16, TF32 convolutions as the audio phase runs), seq against the
    single-device explainer (SEQ_CHECK_SAMPLES samples, one a model call,
    the same noise, TF32 off), and float64 at 2 x 65,536: seq on the card
    against seq on the CPU and against the single-device engine."""
    import numpy as np

    model, fn, _, y = build_audio(torch, wtt)
    dev = torch.device(DEVICE)
    x = 0.1 * np.random.default_rng(SEED + 1).standard_normal((AUDIO_BATCH, SEQ_LEN))
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    mesh = _seq_mesh(wtt)
    _log(f"  seq1d: AudioCNN({AUDIO_CLASSES}) x ({AUDIO_BATCH}, {SEQ_LEN}) {AUDIO_WAVELET} "
         f"J={AUDIO_LEVELS} reflect n={AUDIO_SAMPLES} chunk {AUDIO_CHUNK} over {mesh.shape} "
         f"on {DEVICE} x {mesh.size}; cudnn TF32 on, matmuls float32 (the audio phase's)")
    wam = audio_wam(wtt, fn, dev, mesh=mesh)
    run = _seq_timed(torch, kernels, lambda: wam(x, y), "seq1d SmoothGrad", AUDIO_BATCH,
                     "waveforms", smi)
    mel, coeffs = run["out"]
    from wam_tpu_torch.wavelets.transform import wavedec

    lengths = [c.shape[-1] for c in wavedec(x[:1], AUDIO_WAVELET, AUDIO_LEVELS, "reflect")]
    if [c.shape[-1] for c in coeffs] != lengths or mel.shape[0] != AUDIO_BATCH:
        raise AssertionError("seq1d: result shapes")
    _precision(torch, False)
    z = _seq_noise(torch, x.shape, SEQ_CHECK_SAMPLES, SEED + 20)
    kw = dict(wavelet=AUDIO_WAVELET, J=AUDIO_LEVELS, n_samples=SEQ_CHECK_SAMPLES,
              stdev_spread=AUDIO_SPREAD, n_mels=N_MELS, n_fft=N_FFT, sample_rate=SAMPLE_RATE,
              sample_batch_size=1, device=dev)
    got = wtt.WaveletAttribution1D(fn, mesh=mesh, **kw)(x, y, noise=z)
    want = wtt.WaveletAttribution1D(fn, **kw)(x, y, noise=z)
    out = {**_seq_summary(run), "check": _seq_check(
        torch, f"seq1d vs single-device WaveletAttribution1D (float32, {SEQ_CHECK_SAMPLES} "
        "samples, one a model call, the same noise, TF32 off)", got, want, SEQ_TOL["seq1d"])}
    # float64 at a reduced size, through SeqShardedWam and the engine
    n_wave, length, n_smp = AUDIO_REDUCED
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(SEED + 21)
    x64 = torch.from_numpy(0.1 * rng.standard_normal((n_wave, length)))
    z64 = torch.from_numpy(rng.standard_normal((n_smp, n_wave, length)))
    y64 = torch.arange(n_wave) % AUDIO_CLASSES
    res = {}
    for d in (DEVICE, "cpu"):
        f = wtt.bind_audio_inference(wtt.AudioCNN(num_classes=AUDIO_CLASSES).double(), state,
                                     device=d)
        w = wtt.WaveletAttribution1D(f, mesh=_seq_mesh(wtt, device=d), **{**kw, "device": d})
        grads, tap = w._seq.smoothgrad(x64.to(d), y64.to(d), n_samples=n_smp,
                                       stdev_spread=AUDIO_SPREAD, sample_chunk=1,
                                       noise=z64.to(d))
        res[d] = [tap[:, 0], *grads]
        if d == DEVICE:
            sigma = wtt.noise_sigma(x64.to(d), AUDIO_SPREAD).reshape(-1, 1)
            noisy = (x64.to(d) + z64.to(d) * sigma).reshape(-1, length)
            w.engine.front_fn = w._seq_front
            _, g, g_mel = w.engine.attribute_with_front_grads(noisy, y64.to(d).repeat(n_smp),
                                                             samples=n_smp)
            res["single"] = [t.reshape((n_smp, n_wave) + tuple(t.shape[1:])).mean(dim=0)
                             for t in [g_mel[:, 0], *g]]
    tol = SEQ_TOL["float64"]
    out["float64"] = {
        "card_vs_cpu": _seq_check(torch, "seq1d float64 (2 x 65,536, 2 samples): seq on the card "
                                  "vs seq on the CPU", res[DEVICE], res["cpu"], tol),
        "seq_vs_single": _seq_check(torch, "seq1d float64: seq vs the single-device engine on "
                                    "the card", res[DEVICE], res["single"], tol)}
    return out


def _seq2d_f64(torch, wtt) -> dict:
    """Float64 at a reduced size: a seeded ResNet-18 (10 classes), 2 x 3x64²,
    db4 J=2 reflect, 2 samples, rows over {data: 4}: seq on the card against
    seq on the CPU and against the single-device explainer (plain conv
    transforms) on the card."""
    torch.manual_seed(SEED)
    state = {k: v.clone() for k, v in wtt.resnet18(num_classes=10).double().state_dict().items()}
    g = torch.Generator().manual_seed(SEED + 22)
    x = torch.randn((2, CHANNELS, 64, 64), generator=g, dtype=torch.float64)
    z = torch.randn((2,) + tuple(x.shape), generator=g, dtype=torch.float64)
    y = torch.tensor([1, 7])
    kw = dict(wavelet=WAVELET, J=2, mode=MODE, n_samples=2, stdev_spread=SPREAD,
              sample_batch_size=1)
    res = {}
    for d in (DEVICE, "cpu"):
        m = wtt.resnet18(num_classes=10).double()
        m.load_state_dict(state)
        f = wtt.bind_inference(m, device=d)
        res[d] = wtt.WaveletAttribution2D(f, mesh=_seq_mesh(wtt, device=d), device=d, **kw)(
            x.to(d), y.to(d), noise=z.to(d))
        if d == DEVICE:
            res["single"] = wtt.WaveletAttribution2D(f, device=d, impl="conv", **kw)(
                x.to(d), y.to(d), noise=z.to(d))
    tol = SEQ_TOL["float64"]
    return {"card_vs_cpu": _seq_check(torch, "seq2d float64 (ResNet-18, 2 x 64², db4 J=2): seq on "
                                      "the card vs seq on the CPU", res[DEVICE], res["cpu"], tol),
            "seq_vs_single": _seq_check(torch, "seq2d float64: seq vs the single-device explainer "
                                        "on the card", res[DEVICE], res["single"], tol)}


def _seq_nccl(torch, wtt, fn, x, y, z, kw: dict) -> dict:
    """The seq2d arm's blocks under a process group of one rank on NCCL
    (`parallel.init_distributed`): ``hybrid_mesh({data: 4})`` records every
    block as rank 0's, so the ring makes no distributed call (send, recv and
    broadcast counted) and the result equals the one-process mesh's exactly
    (cuDNN deterministic for both)."""
    import os

    import torch.distributed as dist

    from wam_tpu_torch import parallel

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one rank: its bootstrap on loopback
    info = parallel.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                                     initialization_timeout=120)
    names = ("batch_isend_irecv", "isend", "irecv", "send", "recv", "broadcast", "all_gather",
             "all_reduce")
    saved = {n: getattr(dist, n) for n in names}
    calls = []

    def counted(n):
        def call(*a, **k):
            calls.append(n)
            return saved[n](*a, **k)

        return call

    torch.backends.cudnn.deterministic = True
    try:
        for n in names:
            setattr(dist, n, counted(n))
        mesh = parallel.hybrid_mesh({"data": SEQ_SHARDS}, devices=[DEVICE] * SEQ_SHARDS)
        got = wtt.WaveletAttribution2D(fn, mesh=mesh, **kw)(x, y, noise=z)
        n_calls = len(calls)
        want = wtt.WaveletAttribution2D(fn, mesh=_seq_mesh(wtt), **kw)(x, y, noise=z)
        backend = dist.get_backend()
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)
        torch.backends.cudnn.deterministic = False
        dist.destroy_process_group()
    err = float((got - want).abs().max())
    _log(f"  NCCL group of one ({info}, backend {backend}): hybrid_mesh {mesh.shape} (every "
         f"block rank {sorted(set(mesh.process_ids.ravel().tolist()))}'s), {BATCH} images x "
         f"{kw['n_samples']} samples: distributed calls {n_calls} (must be 0), max abs diff "
         f"against the one-process mesh {err:.3e} (must be 0)")
    if backend != "nccl" or mesh.process_ids is None or err != 0.0 or n_calls:
        raise AssertionError("seq: the one-rank group changed the map or called the group")
    return {"info": info, "backend": backend, "distributed_calls": n_calls, "max_abs_diff": err}


def _seq_fleet(torch, wtt, kernels, fn, x, y) -> dict:
    """A two-replica FleetServer whose one bucket (3x32²) admits no 224²
    item, with ``seq_factory``: a batch of 2 flagship images goes through
    the sequence-sharded route (the factory builds its explainer on the
    fleet mesh {data: 2}, once) and equals that entry called directly on
    the same batch (cuDNN deterministic); K1-K5 0; one oversize ledger row,
    fill 1.0."""
    from wam_tpu_torch.serve import FleetServer

    dev = torch.device(DEVICE)
    built = {}
    kw = dict(wavelet=WAVELET, J=LEVELS, mode=MODE, n_samples=2, stdev_spread=SPREAD,
              sample_batch_size=1, device=dev)

    def seq_factory(mesh):
        built["mesh"] = mesh
        built["wam"] = wtt.WaveletAttribution2D(fn, mesh=mesh, **kw)
        return lambda xs, ys: built["wam"](xs.to(dev), ys.to(dev))

    fleet = FleetServer(lambda rid, m, d: (lambda xs, ys: xs), [(CHANNELS, 32, 32)],
                        devices=[DEVICE] * FLEET_REPLICAS, warmup=False, oversize="fanout",
                        max_batch=2, seq_factory=seq_factory)
    xs, ys = x[:2].cpu().numpy(), y[:2].cpu().numpy().astype("int32")
    torch.backends.cudnn.deterministic = True
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = fleet.attribute_batch(xs, ys)
        host_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
        rows = list(fleet.metrics.oversize.batch_rows)
        want = built["wam"](torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev))
        want = want.cpu().numpy()
    finally:
        torch.backends.cudnn.deterministic = False
        fleet.close()
    err = float(abs(got - want).max())
    _log(f"  fleet: FleetServer({FLEET_REPLICAS} replicas, bucket {CHANNELS}x32², seq_factory) "
         f"served 2 x {CHANNELS}x{SIDE}² through the route on mesh {built['mesh'].shape}: "
         f"{host_s * 1e3:.1f} ms host, launches {launches} (asserted 0), ledger rows "
         f"{len(rows)} fill {[r['fill_ratio'] for r in rows]}; max abs diff against the entry "
         f"called directly {err:.3e} (must be 0)")
    if (err != 0.0 or launches != ZERO_LAUNCHES or len(rows) != 1 or rows[0]["fill_ratio"] != 1.0
            or built["mesh"].shape != {"data": FLEET_REPLICAS}):
        raise AssertionError("seq: the fleet's route disagrees with its entry")
    return {"host_ms": host_s * 1e3, "launches": launches, "max_abs_diff": err}


def _seq2d(torch, wtt, kernels, smi: str) -> dict:
    """The flagship over {data: 4} (rows): SmoothGrad (n=25, chunk 4) and IG
    (16 points) at TF32 convolutions as the flagship runs; the checkpointed
    estimator at stride 5 bit-equal to one sample a step; seq against the
    single-device explainer (conv transforms, SEQ_CHECK_SAMPLES samples one a
    call, the same noise, TF32 off); the one-rank NCCL group; the fleet's
    route; float64 at a reduced size."""
    fn, _, x, y, _ = build_slice(torch, wtt)  # cuDNN TF32 on, matmuls off
    dev = torch.device(DEVICE)
    mesh = _seq_mesh(wtt)
    kw = dict(wavelet=WAVELET, J=LEVELS, mode=MODE, stdev_spread=SPREAD, device=dev)
    _log(f"  seq2d: ResNet-50 x ({BATCH},{CHANNELS},{SIDE},{SIDE}) {WAVELET} J={LEVELS} {MODE} "
         f"n={N_SAMPLES} chunk {SAMPLE_CHUNK}, rows over {mesh.shape} on {DEVICE} x {mesh.size}; "
         "cudnn TF32 on")
    wam = wtt.WaveletAttribution2D(fn, n_samples=N_SAMPLES, sample_batch_size=SAMPLE_CHUNK,
                                   mesh=mesh, **kw)
    run = _seq_timed(torch, kernels, lambda: wam(x, y), "seq2d SmoothGrad", BATCH,
                     "attributions", smi)
    side = 2 * ((SIDE + wtt.wavelets.filters.build_wavelet(WAVELET).filt_len - 1) // 2)
    if tuple(run["out"].shape) != (BATCH, side, side):
        raise AssertionError(f"seq2d: mosaic shape {tuple(run['out'].shape)}")
    ig = wtt.WaveletAttribution2D(fn, method="integratedgrad", n_samples=SEQ_IG_STEPS,
                                  sample_batch_size=SAMPLE_CHUNK, mesh=mesh, **kw)
    run_ig = _seq_timed(torch, kernels, lambda: ig(x, y), f"seq2d IG ({SEQ_IG_STEPS} points)",
                        BATCH, "attributions", smi)
    out = {**_seq_summary(run), "ig": _seq_summary(run_ig)}
    _precision(torch, False)
    sw = wam._seq
    torch.backends.cudnn.deterministic = True  # bit-equality needs run-to-run equal backwards
    try:
        t0 = time.perf_counter()
        plain = sw.smoothgrad(x, y, SEED, n_samples=N_SAMPLES, stdev_spread=SPREAD,
                              sample_chunk=1)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ckpt, info = sw.smoothgrad_checkpointed(x, y, SEED, n_samples=N_SAMPLES,
                                                stdev_spread=SPREAD, stride=SEQ_STRIDE)
        torch.cuda.synchronize()
        ckpt_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = False
    equal = bool(torch.equal(ckpt, plain))
    _log(f"  seq2d smoothgrad_checkpointed (stride {SEQ_STRIDE}, TF32 off, cuDNN "
         f"deterministic): n_used {info['n_used']}, complete {info['complete']}, row 0 conf "
         f"{[round(float(v), 4) for v in info['conf'][0]]}; bit-equal to smoothgrad one sample "
         f"a step: {equal}; host s {ckpt_s:.2f} / {plain_s:.2f}")
    if not (equal and info["n_used"] == N_SAMPLES and info["complete"]):
        raise AssertionError("seq2d: the checkpointed estimator differs from smoothgrad")
    out["checkpointed"] = {"bit_equal": equal, "n_used": info["n_used"], "host_s": ckpt_s,
                           "plain_host_s": plain_s}
    z = _seq_noise(torch, x.shape, SEQ_CHECK_SAMPLES, SEED + 23)
    kw1 = dict(kw, n_samples=SEQ_CHECK_SAMPLES, sample_batch_size=1)
    got = wtt.WaveletAttribution2D(fn, mesh=mesh, **kw1)(x, y, noise=z)
    want = wtt.WaveletAttribution2D(fn, impl="conv", **kw1)(x, y, noise=z)
    out["check"] = _seq_check(
        torch, f"seq2d vs single-device WaveletAttribution2D (float32, conv transforms, "
        f"{SEQ_CHECK_SAMPLES} samples, one a model call, the same noise, TF32 off)", got, want,
        SEQ_TOL["seq2d"])
    out["nccl"] = _seq_nccl(torch, wtt, fn, x, y, z, kw1)
    out["fleet"] = _seq_fleet(torch, wtt, kernels, fn, x, y)
    out["float64"] = _seq2d_f64(torch, wtt)
    return out


def _seq3d(torch, wtt, kernels, smi: str) -> dict:
    """The vol phase's configuration, depth over {data: 4}: haar (no halo:
    asserted 0 elements moved) and a db2 arm at n=SEQ_DB2_SAMPLES that
    exchanges; each held against the single-device explainer (the same
    noise, SEQ_CHECK_SAMPLES samples one a call, TF32 off); float64 on 2 x
    16³ over {data: 2}: seq on the card against the CPU and against single."""
    state, fn, x, y = build_vol(torch, wtt)
    dev = torch.device(DEVICE)
    prec = _precision(torch, True)
    mesh = _seq_mesh(wtt)
    _log(f"  seq3d: ResNet3D-18 x ({VOL_BATCH},1,{VOL_SIDE},{VOL_SIDE},{VOL_SIDE}) depth over "
         f"{mesh.shape}; {prec} (the model)")
    kw = dict(J=VOL_LEVELS, mode=VOL_MODE, stdev_spread=VOL_SPREAD, device=dev)
    out = {}
    for wavelet, n in ((VOL_WAVELET, VOL_SAMPLES), ("db2", SEQ_DB2_SAMPLES)):
        _precision(torch, True)
        wam = wtt.WaveletAttribution3D(fn, wavelet=wavelet, n_samples=n,
                                       sample_batch_size=VOL_CHUNK, mesh=mesh, **kw)
        run = _seq_timed(torch, kernels, lambda: wam(x, y), f"seq3d SmoothGrad {wavelet} n={n}",
                         VOL_BATCH, "volumes", smi)
        if (run["halo_elements"] == 0) != (wavelet == "haar"):
            raise AssertionError(f"seq3d {wavelet}: halo elements {run['halo_elements']}")
        _precision(torch, False)
        z = _seq_noise(torch, x.shape, SEQ_CHECK_SAMPLES, SEED + 24)
        kw1 = dict(kw, wavelet=wavelet, n_samples=SEQ_CHECK_SAMPLES, sample_batch_size=1)
        got = wtt.WaveletAttribution3D(fn, mesh=mesh, **kw1)(x, y, noise=z)
        want = wtt.WaveletAttribution3D(fn, **kw1)(x, y, noise=z)
        out[wavelet] = {**_seq_summary(run), "check": _seq_check(
            torch, f"seq3d {wavelet} vs single-device WaveletAttribution3D (float32, "
            f"{SEQ_CHECK_SAMPLES} samples, the same noise, TF32 off)", got, want,
            SEQ_TOL["seq3d"])}
    out["launches"] = out[VOL_WAVELET]["launches"]
    g = torch.Generator().manual_seed(SEED + 25)
    x64 = torch.randn((2, 1, 16, 16, 16), generator=g, dtype=torch.float64)
    z64 = torch.randn((2,) + tuple(x64.shape), generator=g, dtype=torch.float64)
    y64 = torch.tensor([1, 7])
    kw64 = dict(wavelet="db2", J=VOL_LEVELS, mode=VOL_MODE, n_samples=2, stdev_spread=VOL_SPREAD,
                sample_batch_size=1)
    res = {}
    for d in (DEVICE, "cpu"):
        f = bind_vol(torch, wtt, state, d, torch.float64)
        res[d] = wtt.WaveletAttribution3D(f, mesh=_seq_mesh(wtt, 2, d), device=d, **kw64)(
            x64.to(d), y64.to(d), noise=z64.to(d))
        if d == DEVICE:
            res["single"] = wtt.WaveletAttribution3D(f, device=d, **kw64)(
                x64.to(d), y64.to(d), noise=z64.to(d))
    tol = SEQ_TOL["float64"]
    out["float64"] = {
        "card_vs_cpu": _seq_check(torch, "seq3d float64 (2 x 16³, db2, over {data: 2}): seq on "
                                  "the card vs seq on the CPU", res[DEVICE], res["cpu"], tol),
        "seq_vs_single": _seq_check(torch, "seq3d float64: seq vs the single-device explainer on "
                                    "the card", res[DEVICE], res["single"], tol)}
    return out


def _seq_video(torch, wtt, kernels, smi: str) -> dict:
    """The video phase's clips, time over {data: 2}, uniform haar levels (2,
    2) (the reference refuses (2, 1) under mesh=), n=25 in one chunk; held
    against the single-device explainer at the same levels (the same noise,
    SEQ_CHECK_SAMPLES samples one a call, TF32 off); float64 on 2 x 1x16x16²:
    the card against the CPU and seq against single."""
    state, fn, x, y = build_video(torch, wtt)
    dev = torch.device(DEVICE)
    prec = _precision(torch, True)
    mesh = _seq_mesh(wtt, SEQ_VID_SHARDS)
    _log(f"  video: ResNet3D-18({VID_CLASSES}) x ({VID_BATCH},1,{VID_FRAMES},{VID_SIDE},"
         f"{VID_SIDE}) {VID_WAVELET} levels {SEQ_VID_LEVELS}, time over {mesh.shape}; {prec}")
    kw = dict(wavelet=VID_WAVELET, levels=SEQ_VID_LEVELS, device=dev)
    wam = wtt.WaveletAttributionVideo(fn, n_samples=VID_SAMPLES, sample_batch_size="auto",
                                      mesh=mesh, **kw)
    run = _seq_timed(torch, kernels, lambda: wam(x, y), "video SmoothGrad", VID_BATCH, "clips",
                     smi)
    _precision(torch, False)
    z = _seq_noise(torch, x.shape, SEQ_CHECK_SAMPLES, SEED + 26)
    kw1 = dict(kw, n_samples=SEQ_CHECK_SAMPLES, sample_batch_size=1)
    got = wtt.WaveletAttributionVideo(fn, mesh=mesh, **kw1)(x, y, noise=z)
    want = wtt.WaveletAttributionVideo(fn, **kw1)(x, y, noise=z)
    out = {**_seq_summary(run), "check": _seq_check(
        torch, f"video vs single-device WaveletAttributionVideo (float32, {SEQ_CHECK_SAMPLES} "
        "samples, the same noise, TF32 off)", got, want, SEQ_TOL["video"])}
    g = torch.Generator().manual_seed(SEED + 27)
    x64 = torch.randn((2, 1, VID_FRAMES, 16, 16), generator=g, dtype=torch.float64)
    z64 = torch.randn((2,) + tuple(x64.shape), generator=g, dtype=torch.float64)
    y64 = torch.tensor([1, 7])
    kw64 = dict(wavelet=VID_WAVELET, levels=SEQ_VID_LEVELS, n_samples=2, sample_batch_size=1)
    res = {}
    for d in (DEVICE, "cpu"):
        f = wtt.bind_inference(wtt.resnet3d_18(num_classes=VID_CLASSES).double(), state, device=d)
        res[d] = wtt.WaveletAttributionVideo(f, mesh=_seq_mesh(wtt, SEQ_VID_SHARDS, d), device=d,
                                             **kw64)(x64.to(d), y64.to(d), noise=z64.to(d))
        if d == DEVICE:
            res["single"] = wtt.WaveletAttributionVideo(f, device=d, **kw64)(
                x64.to(d), y64.to(d), noise=z64.to(d))
    tol = SEQ_TOL["float64"]
    out["float64"] = {
        "card_vs_cpu": _seq_check(torch, "video float64 (2 x 1x16x16²): seq on the card vs seq on "
                                  "the CPU", res[DEVICE], res["cpu"], tol),
        "seq_vs_single": _seq_check(torch, "video float64: seq vs the single-device explainer on "
                                    "the card", res[DEVICE], res["single"], tol)}
    return out


SEQ_ARMS = ("seq1d", "seq2d", "seq3d", "video")


def phase_seq(torch, wtt, kernels, smi: str) -> dict:
    """Sequence-sharded attribution (module docstring, phase 24): the four
    arms at full width, each counted (K1-K5 0), timed and held against the
    single-device explainer; the one-rank NCCL group and the fleet's route
    inside seq2d; float64 checks at reduced sizes."""
    _log("phase seq: parallel.SeqShardedWam through the explainers' mesh= on one card")
    out = {"seq1d": _seq1d(torch, wtt, kernels, smi), "seq2d": _seq2d(torch, wtt, kernels, smi),
           "seq3d": _seq3d(torch, wtt, kernels, smi),
           "video": _seq_video(torch, wtt, kernels, smi)}
    _precision(torch, False)
    return out


def preflight(torch) -> None:
    """`wam_tpu_torch.env_check`'s checks, once, before the phases: the core
    packages, the device line, the kernels' build and a 32^2 db2 J=2
    attribution through K1/K3 (fatal on failure)."""
    from wam_tpu_torch import env_check

    t0 = time.perf_counter()
    core, optional = env_check.check_imports()
    if core:
        raise AssertionError(f"preflight: missing packages {core}")
    line = env_check.device_line("cuda")
    counts = env_check.check_wam("cuda")
    _log(f"phase preflight: {line}; K1/K3 launches {counts['dwt2']}/{counts['pair']}; "
         f"optional packages absent: {optional}; {time.perf_counter() - t0:.1f} s")


def _tune_launches(cand) -> dict:
    """K1/K3 launches of one call of a flagship-preset candidate: at NCHW
    the three analysis levels and the collapsed synthesis (forward and
    backward) once a sample chunk; channel-last runs the NHWC einsums."""
    chunks = math.ceil(N_SAMPLES / (cand.sample_chunk or N_SAMPLES))
    if cand.layout != "nchw":
        return dict(ZERO_LAUNCHES)
    return {**ZERO_LAUNCHES, "dwt2": LEVELS * chunks, "pair": 2 * chunks}


def phase_tune(torch, wtt, kernels, smi: str) -> dict:
    """The autotuner on the card: `autotune(get_workload("flagship"))`
    (TUNE_K regions of TUNE_LAPS calls a candidate, not persisted), every
    candidate on the device plane with its peak memory and its K1/K3
    launches a call asserted; ``python -m wam_tpu_torch.tune --workload toy
    --dry-run --device cuda`` as a subprocess; then the winner recorded into
    a schedule cache of the phase's own (``WAM_TORCH_SCHEDULE_CACHE`` set
    for the phase only, inside the script's own empty table), and a `WaveletAttribution2D` built like the winner
    with ``sample_batch_size="auto"`` resolving to the winner's chunk and
    computing the explicit-chunk call's map bit for bit (cuDNN
    deterministic)."""
    from wam_tpu_torch.tune import cache as tcache
    from wam_tpu_torch.tune.autotuner import autotune
    from wam_tpu_torch.tune.workloads import _resnet50_fn, get_workload

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    wl = get_workload("flagship", device=dev)
    res = autotune(wl, k=TUNE_K, laps=TUNE_LAPS, persist=False, log=_log)
    cands = []
    for r in res["results"]:
        cand = r["candidate"]
        want = _tune_launches(cand)
        if r["plane"] != "device" or r["peak_gb"] is None:
            raise AssertionError(f"tune: {r['label']} measured on plane {r['plane']}, "
                                 f"peak {r['peak_gb']}")
        if r["launches"] != want:
            raise AssertionError(f"tune: {r['label']} launched {r['launches']} a call, "
                                 f"expected {want}")
        cands.append({k: r[k] for k in ("label", "median_s", "q1_s", "q3_s", "items_per_s",
                                        "plane", "peak_gb", "launches", "calls")})
    winner = res["winner"]["candidate"]
    _log(f"  tune: winner {res['winner']['label']} ({res['winner']['items_per_s']:.2f} "
         f"attributions/s) on {smi}")

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "wam_tpu_torch.tune", "--workload", "toy",
                           "--dry-run", "--device", "cuda"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"tune CLI failed: {proc.stderr[-2000:]}")
    cli = json.loads(proc.stdout.strip().splitlines()[-1])
    if cli["persisted"] or len(cli["candidates"]) < 2 or any(
            c["plane"] != "device" for c in cli["candidates"]):
        raise AssertionError(f"tune CLI: {cli}")
    cli_s = time.perf_counter() - t0

    saved = os.environ.get(tcache.CACHE_ENV)
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    with tempfile.TemporaryDirectory() as tmp:
        os.environ[tcache.CACHE_ENV] = os.path.join(tmp, "schedules.json")
        tcache.invalidate_process_cache()
        try:
            key = tcache.record_schedule(wl.workload, wl.shape, wl.batch, res["entry"],
                                         dtype=wl.dtype, backend=dev.type)
            nchw = winner.layout == "nchw"
            fn = _resnet50_fn(dev, nchw=nchw, compute_dtype=torch.bfloat16)
            g = torch.Generator().manual_seed(1)
            x = torch.randn((BATCH, CHANNELS, SIDE, SIDE), generator=g).to(dev)
            y = (torch.arange(BATCH) % 1000).to(dev)

            def explainer(chunk):
                return wtt.WaveletAttribution2D(
                    fn, wavelet=WAVELET, J=LEVELS, mode=MODE, n_samples=N_SAMPLES,
                    stdev_spread=SPREAD, sample_batch_size=chunk, dwt_bf16=True,
                    stream_noise=winner.stream_noise is not False,
                    model_layout="nchw" if nchw else "nhwc", device=dev)

            auto, explicit = explainer("auto"), explainer(winner.sample_chunk)
            resolved = auto._chunk(x)
            if resolved != winner.sample_chunk:
                raise AssertionError(f"tune: 'auto' resolved to {resolved}, the winner's chunk "
                                     f"is {winner.sample_chunk} ({key})")
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
            a, b = auto(x, y), explicit(x, y)
            if not torch.equal(a, b):
                raise AssertionError("tune: the resolved 'auto' call differs from the "
                                     f"explicit chunk's (max {float((a - b).abs().max()):.3e})")
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
            if saved is None:
                os.environ.pop(tcache.CACHE_ENV, None)
            else:
                os.environ[tcache.CACHE_ENV] = saved
            tcache.invalidate_process_cache()
    phase_s = time.perf_counter() - t_phase
    _log(f"  tune: 'auto' -> chunk {resolved}, bit-equal to the explicit call; "
         f"phase {phase_s:.1f} s (CLI {cli_s:.1f} s)")
    if phase_s > TUNE_BUDGET_S:
        raise AssertionError(f"tune: the phase took {phase_s:.1f} s > {TUNE_BUDGET_S} s")
    nchw_row = next(r for r in res["results"] if r["candidate"].layout == "nchw")
    return {"gpu": smi, "winner": res["winner"]["label"], "entry": res["entry"], "key": key,
            "candidates": cands, "nchw_launches": nchw_row["launches"],
            "cli": {"winner": cli["winner"], "candidates": cli["candidates"],
                    "device_name": cli.get("device_name"),
                    "power_limit": cli.get("power_limit"), "seconds": cli_s},
            "resolved_chunk": resolved, "bit_equal": True, "phase_s": phase_s}


_AOT_ENV = ("WAM_TPU_AOT_CACHE", "WAM_TPU_CACHE_DIR", "TORCHINDUCTOR_CACHE_DIR",
            "TRITON_CACHE_DIR")


def _aot_env(root: str, tag: str) -> dict:
    """The cache directories of one simulated host under ``root``."""
    compile_dir = os.path.join(root, f"compile{tag}")
    return {"WAM_TPU_AOT_CACHE": os.path.join(root, f"aot{tag}"),
            "WAM_TPU_CACHE_DIR": compile_dir, "TORCHINDUCTOR_CACHE_DIR": compile_dir,
            "TRITON_CACHE_DIR": os.path.join(compile_dir, "triton")}


def _aot_cli(args: list, env: dict) -> tuple[dict, float]:
    """One fresh process ``python -m <args>`` with the phase's cache
    directories; (its JSON output, seconds). Fails on a nonzero exit."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                          env={**os.environ, **env}, capture_output=True, text=True,
                          timeout=AOT_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"aot: {' '.join(args[:3])} exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    text = proc.stdout.strip()
    try:
        out = json.loads(text.splitlines()[-1])
    except ValueError:
        out = json.loads(text)  # an indented document
    return out, seconds


def _aot_prewarm(env: dict, manifest: str, want: str) -> dict:
    out, seconds = _aot_cli(["wam_tpu_torch.prewarm", "--config", AOT_CONFIG, "--device",
                             DEVICE, "--manifest", manifest], env)
    compiles = out["compiles"]
    if out["aot"] != want or out["backend"] != _device_type() or (
            (compiles == 0) == (want == "exported")):
        raise AssertionError(f"aot: prewarm gave {out['aot']} with {compiles} compiles, "
                             f"expected {want}: {out['aot_steps']}")
    _log(f"  aot: prewarm {want}: warm {out['warm_s']:.1f} s, process {seconds:.1f} s, "
         f"{compiles} compiles, steps "
         + ", ".join(f"{st['key'].rsplit('|', 3)[-3]}: {st['aot']}" for st in out["aot_steps"]))
    return {"warm_s": out["warm_s"], "process_s": seconds, "compiles": compiles,
            "aot": out["aot"], "aot_key": out["aot_key"],
            "steps": [st["aot"] for st in out["aot_steps"]]}


def _device_type() -> str:
    return "cuda" if str(DEVICE).startswith("cuda") else "cpu"


def _aot_timed(torch, fn, args) -> dict:
    """ms a call (CUDA events, median of AOT_CALLS after a warm call) and
    peak GB of one call."""
    from wam_tpu_torch.profiling import device_time_samples, median_iqr

    samples = device_time_samples(lambda: fn(*args), k=AOT_CALLS, laps=1, warmup=1,
                                  device=DEVICE)
    med, q1, q3, _ = median_iqr([t * 1e3 for t in samples])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn(*args)
    torch.cuda.synchronize()
    return {"ms": med, "q1_ms": q1, "q3_ms": q3,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _aot_serve(torch, np, wtt, kernels, ex, aot_key: str, smi: str) -> dict:
    """The prewarmed programs behind a server: `serve_entry(aot_key=)` of
    the runner's explainer, compilation_cache=True, AOT_REQUESTS requests
    in one batch (a window of AOT_WAIT_MS), every program a "hit"; the
    served rows against the eager entry on the batch the server built (its
    pad rows replicate the first request) within AOT_BF16_TOL."""
    from wam_tpu_torch.serve import AttributionServer, ServeMetrics

    metrics = ServeMetrics()
    entry = ex.serve_entry(on_trace=metrics.note_compile, aot_key=aot_key)
    t0 = time.perf_counter()
    server = AttributionServer(entry, [(CHANNELS, SIDE, SIDE)], max_batch=BATCH,
                               max_wait_ms=AOT_WAIT_MS, compilation_cache=True,
                               metrics=metrics, device=DEVICE)
    warm_s = time.perf_counter() - t0
    rng = np.random.default_rng(17)
    reqs = [(rng.standard_normal((CHANNELS, SIDE, SIDE)).astype(np.float32), i % AOT_CLASSES)
            for i in range(AOT_REQUESTS)]
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        futures = [server.submit(x, y) for x, y in reqs]
        rows = [f.result(timeout=SERVE_TIMEOUT_S) for f in futures]
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        server.close()
    snap = metrics.snapshot()  # the worker's counts, complete once it has joined
    statuses = sorted({f.aot_status for d in entry.wam_aot_fns for f in d.fns.values()})
    batches = snap["batches"]
    want = {k: v * batches for k, v in AOT_LAUNCHES.items()}
    if (metrics.compile_count != 0 or snap["completed"] != AOT_REQUESTS or launches != want
            or statuses != ["hit"] or batches != 1):
        raise AssertionError(f"aot serve: compile_count {metrics.compile_count}, completed "
                             f"{snap['completed']} of {AOT_REQUESTS}, launches {launches} "
                             f"(expected {want} for {batches} batches, want 1), programs "
                             f"{statuses} (want hit)")
    if any(not np.isfinite(np.asarray(r)).all() or np.asarray(r).shape != rows[0].shape
           for r in rows):
        raise AssertionError("aot serve: a served mosaic is not finite or has another shape")
    # the eager entry on the batch the server built
    pad = BATCH - AOT_REQUESTS
    xs = torch.from_numpy(np.stack([x for x, _ in reqs] + [reqs[0][0]] * pad)).to(DEVICE)
    ys = torch.tensor([y for _, y in reqs] + [reqs[0][1]] * pad, dtype=torch.int32,
                      device=DEVICE)
    eager = ex.serve_entry()(xs, ys)[:AOT_REQUESTS].float().cpu()
    served = torch.stack([torch.as_tensor(np.asarray(r)) for r in rows]).float()
    dist = _distance(torch, served, eager)
    _log(f"  aot: server (compilation_cache=True) warm {warm_s:.1f} s, {AOT_REQUESTS} "
         f"requests in {batches} batch, {wall:.2f} s = {AOT_REQUESTS / wall:.2f} requests/s, "
         f"compile_count {metrics.compile_count}, programs {statuses}, launches {launches}; "
         f"served rows vs the eager entry: {_distance_text(dist)} (bound {AOT_BF16_TOL}) "
         f"on {smi}")
    if not math.isfinite(dist["max"]) or not _within(dist, AOT_BF16_TOL):
        raise AssertionError(f"aot serve: served rows against the eager entry {dist} "
                             f"(bound {AOT_BF16_TOL})")
    return {"warm_s": warm_s, "wall_s": wall, "requests": AOT_REQUESTS, "batches": batches,
            "compile_count": metrics.compile_count, "programs": statuses,
            "launches": launches, "mosaic_shape": list(np.asarray(rows[0]).shape),
            "distance": dist}


@contextlib.contextmanager
def _operator_route(torch):
    """A context in which the kernel wrappers take the branch a compiled
    graph takes (`torch.compiler.is_compiling` reads True): each calls its
    custom operator (`torch.ops.wam_tpu_torch.*`) with the arguments the
    graph would pass, but eagerly."""
    real = torch.compiler.is_compiling
    torch.compiler.is_compiling = lambda: True
    try:
        yield
    finally:
        torch.compiler.is_compiling = real


def _bit_equal(name: str, got, want) -> None:
    import torch

    torch.cuda.synchronize()
    got = list(got) if isinstance(got, (list, tuple)) else [got]
    want = list(want) if isinstance(want, (list, tuple)) else [want]
    if len(got) != len(want) or not all(
            a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
            for a, b in zip(got, want)):
        raise AssertionError(f"aot operator {name}: not bit-equal to the eager wrapper")


def _plain_err(name: str, got, want) -> float:
    """`_check` (KERNEL_RTOL x max) over each pair of ``got`` / ``want``."""
    got = list(got) if isinstance(got, (list, tuple)) else [got]
    want = list(want) if isinstance(want, (list, tuple)) else [want]
    return max(_check(f"{name} [{i}]" if len(got) > 1 else name, a, b)[0]
               for i, (a, b) in enumerate(zip(got, want)))


def _aot_operators(torch, tmm, kernels, sites) -> dict:
    """Each custom operator on the card at the shapes its path gives it: K1
    (``dwt2``, ``dwt2_adjoint``) and K3 (``pair``, ``pair_bwd``) at the
    flagship preset's chunk (SAMPLE_CHUNK x BATCH x CHANNELS planes of
    SIDE^2, db4, level 1 on bfloat16 as ``dwt_bf16`` reads it), K2
    (``synth2``, ``synth2_bwd``) and K4/K5 (``relu_fwd``, ``relu_bwd``, at
    path 2's ReLU ``sites``) at path 2's. Each wrapper's operator branch
    (`_operator_route`), forward and backward through autograd, is
    bit-equal to its eager route on the same inputs, and the operators'
    outputs are within KERNEL_RTOL x max of the plain versions (K4/K5:
    equal); then `torch.library.opcheck` on CUDA tensors of these shapes
    (schema, fake shapes and strides against the kernel's output, autograd
    registration, AOT dispatch). Returns the largest error of each
    operator against its plain version."""
    from collections import Counter

    from wam_tpu_torch.tune import fused_relu as tfr
    from wam_tpu_torch.wavelets import transform as tt

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    ops = torch.ops.wam_tpu_torch
    lo, hi, rlo, rhi = tmm._taps(WAVELET)
    n = SAMPLE_CHUNK * BATCH * CHANNELS
    errs: dict = {}
    checks: list = []  # (name, operator, args) for opcheck

    def note(op, err):
        errs[op] = max(errs.get(op, 0.0), err)

    def both_routes(call, inputs, gout):
        """(out, grads) of ``call`` on fresh leaves of ``inputs``, eager
        route then operator route."""
        res = []
        for operator in (False, True):
            leaves = [t.detach().requires_grad_(True) for t in inputs]
            if operator:
                with _operator_route(torch):
                    out = call(leaves)
                    grads = torch.autograd.grad(out, leaves, gout)
            else:
                out = call(leaves)
                grads = torch.autograd.grad(out, leaves, gout)
            res.append((out.detach(), grads))
        return res

    # K1 at the flagship's three levels (level 1 on bfloat16), its adjoint
    x = torch.randn((n, SIDE, SIDE), generator=g, device=dev).to(torch.bfloat16)
    for level in range(1, LEVELS + 1):
        q = x.shape[-1]
        A, At = tmm._kernel_analysis(q, tuple(lo), tuple(hi), MODE, dev)
        tag = f"dwt2 {WAVELET} {q}^2 level {level} {str(x.dtype)[6:]}"
        gq = torch.randn((n, 4, A.shape[0] // 2, A.shape[0] // 2), generator=g, device=dev)
        (e_out, e_gr), (o_out, o_gr) = both_routes(
            lambda ls: tmm.dwt2_kernel(ls[0], WAVELET, MODE), [x], gq)
        _bit_equal(tag, (o_out, *o_gr), (e_out, *e_gr))
        got = ops.dwt2(x, lo, hi, MODE)
        _bit_equal(f"{tag} (operator)", got, kernels.dwt2(x, tmm.dwt2_band(
            q, q, tuple(lo), tuple(hi), MODE, dev)))
        note("dwt2", _plain_err(tag, got, tmm.dwt2_plain(x, At, At)))
        adj = ops.dwt2_adjoint(gq, q, q, lo, hi, MODE)
        note("dwt2_adjoint", _plain_err(f"{tag} adjoint", adj, torch.matmul(
            torch.matmul(A.T, tmm._merge_quadrants(gq)), A)))
        if level == 1:
            checks += [("dwt2", ops.dwt2, (x.detach().requires_grad_(True), lo, hi, MODE)),
                       ("dwt2_adjoint", ops.dwt2_adjoint, (gq, q, q, lo, hi, MODE))]
        x = got[:, 0].contiguous()
        del got, adj, gq, e_out, e_gr, o_out, o_gr

    # K3 forward and backward on the flagship's collapsed levels
    imgs = torch.randn((n // CHANNELS, CHANNELS, SIDE, SIDE), generator=g, device=dev)
    with torch.no_grad():
        coeffs = tt.wavedec2(imgs, WAVELET, LEVELS, MODE, impl="kernel")
    ncol = tt._collapse_count(coeffs[1:])
    flat = [coeffs[0]] + [t for d in coeffs[1:][:ncol] for t in d]
    rs = [int(d.horizontal.shape[-2]) for d in coeffs[1:][:ncol]]
    cs = [int(d.horizontal.shape[-1]) for d in coeffs[1:][:ncol]]

    def collapsed(ls):
        dets = [tt.Detail2D(*ls[1 + 3 * i:4 + 3 * i]) for i in range(ncol)]
        return tmm.waverec2_collapsed(ls[0], dets, WAVELET)

    fwd, bwd = tmm.pair_band(tuple(rs), tuple(cs), tuple(rlo), tuple(rhi), dev)
    gout = torch.randn(imgs.shape[:2] + (fwd.p, fwd.t), generator=g, device=dev)
    (e_out, e_gr), (o_out, o_gr) = both_routes(collapsed, flat, gout)
    tag = f"pair {WAVELET} {SIDE}^2 {ncol} levels"
    _bit_equal(tag, (o_out, *o_gr), (e_out, *e_gr))
    leaves = [tmm._leaf3(t) for t in [flat[0][..., :rs[0], :cs[0]]] + flat[1:]]
    got = ops.pair(leaves, rs, cs, rlo, rhi)
    _bit_equal(f"{tag} (operator)", got, kernels.pair(leaves, fwd))
    R, Rt, C, Ct = tmm.collapsed_operators(coeffs[1:][:ncol], WAVELET, dev)
    y = tmm.assemble_collapsed(flat[0], coeffs[1:][:ncol])
    note("pair", _plain_err(tag, got, tmm.pair_plain(y.reshape((n,) + y.shape[-2:]), Rt, Ct)))
    g3 = gout.reshape((n, fwd.p, fwd.t))
    got_b = ops.pair_bwd(g3, rs, cs, rlo, rhi)
    _bit_equal(f"{tag} backward (operator)", got_b, kernels.pair_bwd(g3, bwd))
    dY = tmm.pair_plain(g3, R, C)
    want_b, r0, c0 = [], 0, 0
    for i, (r, c) in enumerate(zip(rs, cs)):
        if i == 0:
            want_b.append(dY[:, r0:r0 + r, c0:c0 + c])
        want_b += [dY[:, r0 + r:r0 + 2 * r, c0:c0 + c], dY[:, r0:r0 + r, c0 + c:c0 + 2 * c],
                   dY[:, r0 + r:r0 + 2 * r, c0 + c:c0 + 2 * c]]
        r0, c0 = r0 + 2 * r, c0 + 2 * c
    note("pair_bwd", _plain_err(f"{tag} backward", got_b, want_b))
    checks += [("pair", ops.pair, ([t.detach().requires_grad_(True) for t in leaves], rs, cs,
                                   rlo, rhi)),
               ("pair_bwd", ops.pair_bwd, (g3, rs, cs, rlo, rhi))]
    del imgs, coeffs, flat, e_out, e_gr, o_out, o_gr, y, dY, got_b, want_b, got

    # K2 forward (float32 and bfloat16 subbands) and backward at path 2's finest level
    h = (SIDE2 + len(rlo) - 1) // 2
    Sr, Srt = tmm._kernel_synthesis(h, tuple(rlo), tuple(rhi), dev)
    full = Sr.shape[0]
    sub = torch.randn((n, 4, h, h), generator=g, device=dev)
    gfull = torch.randn((n, full, full), generator=g, device=dev)
    plans = tmm.idwt2_band(h, h, tuple(rlo), tuple(rhi), dev)
    for dtype in (torch.float32, torch.bfloat16):
        sin = sub.to(dtype)
        tag = f"synth2 {WAVELET} -> {SIDE2}^2 {str(dtype)[6:]}"
        (e_out, e_gr), (o_out, o_gr) = both_routes(
            lambda ls: tmm.idwt2_kernel(ls[0], WAVELET), [sin], gfull)
        _bit_equal(tag, (o_out, *o_gr), (e_out, *e_gr))
        got = ops.synth2(sin, rlo, rhi)
        _bit_equal(f"{tag} (operator)", got, kernels.synth2(sin, plans[0]))
        note("synth2", _plain_err(tag, got, tmm.idwt2_plain(sin, Sr, Srt)))
        del e_out, e_gr, o_out, o_gr, got
    got = ops.synth2_bwd(gfull, h, h, rlo, rhi)
    _bit_equal(f"synth2_bwd {WAVELET} {SIDE2}^2 (operator)", got, kernels.dwt2(gfull, plans[1]))
    note("synth2_bwd", _plain_err(f"synth2_bwd {WAVELET} {SIDE2}^2", got,
                                  tmm.dwt2_plain(gfull, Sr, Sr)))
    checks += [("synth2", ops.synth2, (sub.detach().requires_grad_(True), rlo, rhi)),
               ("synth2_bwd", ops.synth2_bwd, (gfull, h, h, rlo, rhi))]
    del got

    # K4/K5 at path 2's ReLU sites, one step's rows: fused_relu both routes, the operators
    for shape, _ in sorted(Counter(sites).items(), key=lambda kv: -math.prod(kv[0])):
        xr = torch.randn((SAMPLE_CHUNK * BATCH,) + shape, generator=g, device=dev)
        xr.view(-1)[::97] = 0  # exact zeros: gate x > 0
        gr = torch.randn(xr.shape, generator=g, device=dev)
        tag = f"relu {tuple(xr.shape)}"
        (e_out, e_gr), (o_out, o_gr) = both_routes(lambda ls: tfr.fused_relu(ls[0]), [xr], gr)
        _bit_equal(tag, (o_out, *o_gr), (e_out, *e_gr))
        y, m = ops.relu_fwd(xr)
        _bit_equal(f"{tag} relu_fwd (operator)", (y, m), kernels.relu_fwd(xr))
        _equal(f"{tag} relu_fwd", (y, m), tfr.relu_fwd_plain(xr))
        dx = ops.relu_bwd(m, gr)
        _bit_equal(f"{tag} relu_bwd (operator)", dx, kernels.relu_bwd(m, gr))
        _equal(f"{tag} relu_bwd", (dx,), (tfr.relu_bwd_plain(m, gr),))
        note("relu_fwd", 0.0)
        note("relu_bwd", 0.0)
        if "relu_fwd" not in {c[0] for c in checks}:  # opcheck at the largest site
            checks += [("relu_fwd", ops.relu_fwd, (xr.detach().requires_grad_(True),)),
                       ("relu_bwd", ops.relu_bwd, (m, gr))]
        del xr, gr, e_out, e_gr, o_out, o_gr, y, dx
    for _, op, args in checks:
        torch.library.opcheck(op, args)
    _log(f"  aot: every operator's branch bit-equal to the eager wrapper at its path's shapes, "
         f"forward and backward; against the plain versions "
         + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
         + f"; opcheck on CUDA: {', '.join(c[0] for c in checks)}")
    return errs


def _aot_dispatch(torch, tmm) -> dict:
    """Host microseconds an eager call of each kernel wrapper pays on its
    operator branch (`_operator_route`) over its autograd Function, forward
    and backward, at a small shape where the host bounds the call (haar,
    3 planes of 64^2; K4/K5 on 4096 elements): AOT_OP_CALLS calls of each
    route in turns (Function, operator, operator, Function), the faster turn
    of each; per launch (K1's backward is no launch; K2's is one K1)."""
    from wam_tpu_torch.tune import fused_relu as tfr
    from wam_tpu_torch.wavelets import transform as tt

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED + 19)
    img = torch.randn((1, CHANNELS, 64, 64), generator=g, device=dev)
    with torch.no_grad():
        coeffs = tt.wavedec2(img, "haar", LEVELS, MODE, impl="kernel")
    ncol = tt._collapse_count(coeffs[1:])
    flat = [coeffs[0]] + [t for d in coeffs[1:][:ncol] for t in d]

    def collapsed(ls):
        dets = [tt.Detail2D(*ls[1 + 3 * i:4 + 3 * i]) for i in range(ncol)]
        return tmm.waverec2_collapsed(ls[0], dets, "haar")

    sub = torch.randn((CHANNELS, 4, 32, 32), generator=g, device=dev)
    cases = {  # kernel: (call on leaves, inputs, launches of one forward + backward)
        "dwt2": (lambda ls: tmm.dwt2_kernel(ls[0], "haar", MODE), [img[0]], 1),
        "pair": (collapsed, flat, 2),
        "synth2": (lambda ls: tmm.idwt2_kernel(ls[0], "haar"), [sub], 2),
        "relu": (lambda ls: tfr.fused_relu(ls[0]), [torch.randn(4096, generator=g,
                                                                device=dev)], 2),
    }
    out = {}
    for name, (call, inputs, launches) in cases.items():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        gout = torch.ones_like(call(leaves))

        def turn(operator: bool) -> float:
            with _operator_route(torch) if operator else contextlib.nullcontext():
                for i in range(AOT_OP_CALLS + 1):  # a warm call, then the timed ones
                    if i == 1:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                    torch.autograd.grad(call(leaves), leaves, gout)
                torch.cuda.synchronize()
            return (time.perf_counter() - t0) / AOT_OP_CALLS * 1e6

        fn_a, op_a, op_b, fn_b = turn(False), turn(True), turn(True), turn(False)
        function_us, operator_us = min(fn_a, fn_b), min(op_a, op_b)
        out[name] = {"function_us": function_us, "operator_us": operator_us,
                     "launches": launches,
                     "extra_us_a_launch": (operator_us - function_us) / launches}
    _log("  aot: eager host us of a forward + backward, autograd Function / operator branch "
         "(extra a launch): " + "; ".join(
             f"{k} {v['function_us']:.1f} / {v['operator_us']:.1f} "
             f"({v['extra_us_a_launch']:+.1f})" for k, v in out.items()))
    return out


def aot_dispatch_estimate(dispatch: dict, phases: dict) -> dict:
    """What routing every eager launch of a host-bound phase through the
    operators would add to its call (`_aot_dispatch`'s extra microseconds
    a launch times the call's launches), beside the call's median and its
    spread (max - min of the timed calls). ``phases``: label -> (launches
    a call, median ms, [min, max] ms)."""
    per = {"dwt2": dispatch["dwt2"], "pair": dispatch["pair"], "synth2": dispatch["synth2"],
           "relu_fwd": dispatch["relu"], "relu_bwd": dispatch["relu"]}
    out = {}
    for label, (launches, median_ms, spread) in phases.items():
        extra = sum(launches.get(k, 0) * v["extra_us_a_launch"] for k, v in per.items()) / 1e3
        out[label] = {"extra_ms": extra, "median_ms": median_ms,
                      "spread_ms": spread[1] - spread[0], "share": extra / median_ms}
        _log(f"  aot dispatch: {label}: {extra:.3f} ms a call on the operator branch against "
             f"a median of {median_ms:.2f} ms (spread {spread[1] - spread[0]:.2f} ms)")
    return out


def _aot_profile_group(ev) -> str:
    """A device event's group in the compiled-vs-eager profile."""
    name = ev.name
    low = name.lower()
    if "band::band2_kernel" in name:
        return "K1/K2"
    if "collapsed::" in name:
        return "K3"
    if "wam_relu::" in name:
        return "K4/K5"
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return "layout conversions (NCHW<->NHWC)"
    if low.startswith("triton_") or "triton" in low:
        return "Inductor-generated (triton)"
    if any(k in low for k in ("conv", "cudnn", "xmma", "fprop", "dgrad", "wgrad", "implicit")):
        return "convolution (cuDNN)"
    if "gemm" in low or "cutlass" in low:
        return "matmul"
    return "other (elementwise, reductions, copies)"


def _aot_profile(torch, calls: dict, args) -> dict:
    """Device ms by group (`_aot_profile_group`) of one call of each route
    under ``torch.profiler`` (after the timed calls, so warm)."""
    from torch.profiler import ProfilerActivity, profile

    from wam_tpu_torch.profiling import named_op_split

    out = {}
    for tag, fn in calls.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
        split = named_op_split(prof, classify=_aot_profile_group)
        out[tag] = {k: v * 1e3 for k, v in (split or {}).items()}
    groups = sorted({k for v in out.values() for k in v if k != "total"})
    _log("  aot: device ms of one call by group, " + " / ".join(out) + ": " + "; ".join(
        f"{k} " + " / ".join(f"{out[t].get(k, 0.0):.1f}" for t in out) for k in groups)
        + "; busy " + " / ".join(f"{out[t].get('total', 0.0):.1f}" for t in out))
    return out


def _distance(torch, got, want) -> dict:
    """How far ``got`` lies from ``want``, over want's largest magnitude m:
    ``max`` = max |d| / m; ``rel_l2`` = ||d|| / ||want||; ``cosine``;
    ``typical`` = mean |want| / m; ``off`` = the share of elements with
    |d| > 1e-3 m (few where ReLU gates flip, most where the work differs)."""
    got, want = got.detach().double(), want.detach().double()
    d = got - want
    m = want.abs().max()
    return {"max": float(d.abs().max() / m), "rel_l2": float(d.norm() / want.norm()),
            "cosine": float((got * want).sum() / (got.norm() * want.norm())),
            "typical": float(want.abs().mean() / m),
            "off": float((d.abs() > 1e-3 * m).double().mean())}


def _distance_text(dist: dict) -> str:
    return (f"max|d|/max {dist['max']:.3e}, ||d||/||m|| {dist['rel_l2']:.3e}, cosine "
            f"{dist['cosine']:.9f}, share off by > 1e-3 max {dist['off']:.2e}, a typical "
            f"value mean|m|/max {dist['typical']:.3e}")


def _within(dist: dict, bound) -> bool:
    """``dist`` within every key of ``bound`` (None: no bound yet)."""
    return bound is None or all(dist[k] <= v for k, v in bound.items())


def _aot_f32(torch, kernels) -> dict:
    """The compiled chunk step against the eager one with a float32 model:
    ResNet-18 (AOT_CLASSES classes, ``fold_bn``, seeded) under the flagship
    preset's runner (`tune.workloads._wam2d_runner`: BATCH x CHANNELS x
    SIDE^2, db4 J=3 reflect, float32 transform input) with n = SAMPLE_CHUNK,
    one chunk step, compiled in this process; cuDNN deterministic, TF32 off
    for both routes (restored after). Returns the distance of the compiled
    mosaic from the eager one (`_distance`), the launches and the compile
    seconds."""
    from wam_tpu_torch.models.resnet import bind_inference, resnet18
    from wam_tpu_torch.tune.autotuner import Candidate
    from wam_tpu_torch.tune.workloads import _wam2d_runner

    dev = torch.device(DEVICE)
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        g = torch.Generator().manual_seed(SEED + 23)
        x = torch.randn((BATCH, CHANNELS, SIDE, SIDE), generator=g).to(dev)
        y = (torch.arange(BATCH) % AOT_CLASSES).to(dev)
        torch.manual_seed(SEED)
        model = bind_inference(resnet18(num_classes=AOT_CLASSES), fold_bn=True, device=dev)
        fn, wargs = _wam2d_runner(model, x, y, Candidate(sample_chunk=SAMPLE_CHUNK,
                                                         layout="nchw"), dev,
                                  wavelet=WAVELET, J=LEVELS, n_samples=SAMPLE_CHUNK)
        fns: list = []
        compiled = fn.wam_aot("chip_smoke|aot|resnet18-f32", obs_kind="prewarm",
                              record=lambda d: fns.append(d) or d)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out_c = compiled(*wargs)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        launches_c = kernels.launch_counts()
        kernels.reset_launch_counts()
        out_e = fn(*wargs)
        torch.cuda.synchronize()
        launches_e = kernels.launch_counts()
        statuses = sorted({f.aot_status for d in fns for f in d.fns.values()})
        want = {**ZERO_LAUNCHES, "dwt2": LEVELS, "pair": 2}
        if launches_c != want or launches_e != want or statuses != ["exported"]:
            raise AssertionError(f"aot f32: launches compiled {launches_c}, eager {launches_e} "
                                 f"(expected {want}), programs {statuses}")
        dist = _distance(torch, out_c, out_e)
        finite = bool(torch.isfinite(out_c).all())
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) = flags
    _log(f"  aot f32 (ResNet-18, float32, n={SAMPLE_CHUNK}, cuDNN deterministic, TF32 off): "
         f"compile + first call {compile_s:.1f} s, compiled vs eager {_distance_text(dist)} "
         f"(bound {AOT_TOL}), launches {launches_c}")
    if not finite or not _within(dist, AOT_TOL):
        raise AssertionError(f"aot f32: compiled against eager {dist} (bound {AOT_TOL})")
    return {"distance": dist, "compile_s": compile_s, "launches": launches_c,
            "programs": statuses}


def phase_aot(torch, wtt, kernels, smi: str, sites) -> dict:
    """Cold start on the card (module docstring, phase 26); ``sites`` are
    path 2's ReLU sites (`relu_sites`)."""
    import numpy as np

    from wam_tpu_torch.wavelets import matmul as tmm

    from wam_tpu_torch.pipeline import aot
    from wam_tpu_torch.tune.autotuner import Candidate
    from wam_tpu_torch.tune.workloads import get_workload

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="wam_aot_")
    atexit.register(shutil.rmtree, root, ignore_errors=True)
    host1, host2 = _aot_env(root, "1"), _aot_env(root, "2")
    manifest = os.path.join(root, "prewarm.json")
    cold = _aot_prewarm(host1, manifest, "exported")
    hit = _aot_prewarm(host1, os.path.join(root, "prewarm_hit.json"), "hit")

    bundle = os.path.join(root, "bundle")
    pub, pub_s = _aot_cli(["wam_tpu_torch.registry", "publish", "--out", bundle,
                           "--from-prewarm", manifest], host1)
    if pub["aot"] != len(cold["steps"]) or pub["compile"] < 1:
        raise AssertionError(f"aot: the bundle holds {pub['aot']} compiled steps and "
                             f"{pub['compile']} compile files: {pub}")
    probe, _ = _aot_cli(["wam_tpu_torch.registry", "inspect", bundle], host2)
    libs = {k.library_path().name for k in kernels.KERNELS.values()}
    outcomes = {r["key"].split("/", 1)[1]: r["outcome"] for r in probe["artifacts"]
                if r["key"].startswith("kernels/")}
    if any(outcomes.get(name) not in ("ok", "present") for name in libs):
        raise AssertionError(f"aot: kernel libraries {sorted(libs)} in the bundle: {outcomes}")
    hyd, hyd_s = _aot_cli(["wam_tpu_torch.registry", "hydrate", bundle], host2)
    if hyd["status"] != "hydrated" or hyd["artifacts"].get("aot:hydrated") != len(cold["steps"]):
        raise AssertionError(f"aot: hydration {hyd}")
    hydrated = _aot_prewarm(host2, os.path.join(root, "prewarm_registry.json"), "registry_hit")
    _log(f"  aot: bundle of {pub['artifacts']} artifacts ({pub['aot']} compiled steps, "
         f"{pub['compile']} compile files) published in {pub_s:.1f} s, hydrated into empty "
         f"caches in {hyd_s:.1f} s ({hyd['artifacts']}); kernel libraries {outcomes}")

    saved = {k: os.environ.get(k) for k in _AOT_ENV}
    os.environ.update(host1)
    dev = torch.device(DEVICE)
    try:
        wl = get_workload(AOT_CONFIG, device=dev)
        fn, wargs = wl.build(Candidate(sample_chunk=max(1, 128 // wl.batch), layout="nchw",
                                       fan_cap=128))
        fns: list = []
        compiled = fn.wam_aot(cold["aot_key"], obs_kind="prewarm",
                              record=lambda d: fns.append(d) or d)
        breaks = aot.graph_breaks()
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        out_c = compiled(*wargs)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        launches_c = kernels.launch_counts()
        kernels.reset_launch_counts()
        out_e = fn(*wargs)
        torch.cuda.synchronize()
        launches_e = kernels.launch_counts()
        statuses = sorted({f.aot_status for d in fns for f in d.fns.values()})
        compiles = sum(f.compiles for d in fns for f in d.fns.values())
        if launches_c != AOT_LAUNCHES or launches_e != AOT_LAUNCHES:
            raise AssertionError(f"aot: launches compiled {launches_c}, eager {launches_e}, "
                                 f"expected {AOT_LAUNCHES}")
        if statuses != ["hit"] or compiles or aot.graph_breaks() != breaks:
            raise AssertionError(f"aot: in-process programs {statuses} with {compiles} "
                                 f"compiles (want hit, 0), graph breaks "
                                 f"{aot.graph_breaks() - breaks}")
        dist = _distance(torch, out_c, out_e)
        if not torch.isfinite(out_c).all() or not _within(dist, AOT_BF16_TOL):
            raise AssertionError(f"aot: compiled against eager {dist} (bound {AOT_BF16_TOL})")
        turns = {}
        for tag, call in (("eager", fn), ("compiled", compiled), ("compiled", compiled),
                          ("eager", fn)):
            turns.setdefault(tag, []).append(_aot_timed(torch, call, wargs))
        _log(f"  aot: in-process load + first call {load_s:.1f} s (programs {statuses}, "
             f"{compiles} compiles, after every earlier phase); "
             f"compiled vs eager {_distance_text(dist)} (bound {AOT_BF16_TOL}); ms a call "
             f"(events, median of "
             f"{AOT_CALLS}) / peak GB: "
             + "; ".join(f"{tag} " + ", ".join(f"{r['ms']:.2f} ({r['q1_ms']:.2f}-"
                                               f"{r['q3_ms']:.2f}) / {r['peak_gb']:.2f}"
                                               for r in rs) for tag, rs in turns.items())
             + f"; launches {launches_c} each, 0 graph breaks, on {smi}")
        profile = _aot_profile(torch, {"eager": fn, "compiled": compiled}, wargs)
        served = _aot_serve(torch, np, wtt, kernels, fn.explainer, cold["aot_key"], smi)
        del fn, compiled, wargs, out_c, out_e
        f32 = _aot_f32(torch, kernels)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    operators = _aot_operators(torch, tmm, kernels, sites)
    dispatch = _aot_dispatch(torch, tmm)
    phase_s = time.perf_counter() - t_phase
    _log(f"  aot: cold warm {cold['warm_s']:.1f} s, hit {hit['warm_s']:.1f} s, registry "
         f"{hydrated['warm_s']:.1f} s; phase {phase_s:.1f} s")
    return {"gpu": smi, "cold": cold, "hit": hit, "registry": hydrated,
            "bundle": {k: pub[k] for k in ("artifacts", "aot", "compile")},
            "hydration": hyd["artifacts"], "libraries": outcomes, "load_s": load_s,
            "distance": dist, "launches": launches_c,
            "programs": statuses, "timed": turns, "profile_ms": profile, "serve": served,
            "f32": f32, "operators": operators, "dispatch": dispatch, "phase_s": phase_s}


# -- phase pod: worker processes behind PodRouter on the one card -------------------------


def _pod_argv(*extra) -> list:
    """The pod worker's command on the card: the reference's worker recipe
    at the flagship's image side and sample count (the toy entry), every
    worker on cuda:0."""
    return [sys.executable, "-m", "wam_tpu_torch.pod.worker", "--device", POD_DEVICE,
            "--buckets", f"{CHANNELS}x{POD_SIDE}x{POD_SIDE}", "--n-samples", str(N_SAMPLES),
            "--max-batch", str(POD_MAX_BATCH), *extra]


def _pod_env(extra: dict | None = None) -> dict:
    """The workers' environment beyond this process's: this checkout first
    on their import path, wherever the script was started from."""
    path = os.environ.get("PYTHONPATH", "")
    return {"PYTHONPATH": str(ROOT) + (os.pathsep + path if path else ""), **(extra or {})}


@contextlib.contextmanager
def _torch_defaults(torch):
    """cuDNN and TF32 at a fresh process's settings (a pod worker's), for the
    in-process entry its answers are held against; restored after."""
    b, c = torch.backends, torch.backends.cudnn
    saved = (c.benchmark, c.deterministic, c.allow_tf32, b.cuda.matmul.allow_tf32)
    c.benchmark, c.deterministic, c.allow_tf32, b.cuda.matmul.allow_tf32 = (
        False, False, True, False)
    try:
        yield
    finally:
        c.benchmark, c.deterministic, c.allow_tf32, b.cuda.matmul.allow_tf32 = saved


def _pod_reference(torch, np, kernels, x, y) -> dict:
    """The workers' entry in this process at their batch shape (POD_MAX_BATCH
    copies of the phase's one request, as a worker pads it): the rows a
    pod answer must equal, the launches of one batch (counts set to 0 just
    before, read just after; and the same call's device kernels under
    ``torch.profiler``), the batch's ms (CUDA events) and peak GB."""
    from torch.profiler import ProfilerActivity, profile

    from wam_tpu_torch.pod.worker import toy_wam
    from wam_tpu_torch.profiling import device_time_samples, kernel_events, median_iqr

    card = torch.device(POD_DEVICE)
    # donate=False: the workers' entry releases its staged batch on the card,
    # and this one is called again on the same tensors
    entry = toy_wam(N_SAMPLES, card).serve_entry(donate=False)
    xs = torch.from_numpy(np.repeat(x[None], POD_MAX_BATCH, axis=0)).to(card)
    ys = torch.full((POD_MAX_BATCH,), y, dtype=torch.int32, device=card)
    with _torch_defaults(torch):
        rows = entry(xs, ys).cpu().numpy()  # first call: cuDNN plans, the allocator
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            again = entry(xs, ys)
            torch.cuda.synchronize()
        launches = kernels.launch_counts()
        events = kernel_events(prof)
        samples = device_time_samples(lambda: entry(xs, ys), k=5, laps=1, warmup=1,
                                      device=card)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        entry(xs, ys)
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != POD_LAUNCHES:
        raise AssertionError(f"pod: the entry's batch launched {launches}, "
                             f"expected {POD_LAUNCHES}")
    scale = float(np.abs(rows).max())
    repeat = float(np.abs(again.cpu().numpy() - rows).max()) / scale
    if repeat > POD_TOL:
        raise AssertionError(f"pod: the in-process entry moved {repeat:.3e} x max between "
                             f"two calls on the same batch (bound {POD_TOL})")
    profiled = None
    if events is not None:
        profiled = {"dwt2": sum("band::band2_kernel" in e.name for e in events),
                    "pair": sum("collapsed::" in e.name for e in events),
                    "relu": sum("wam_relu::" in e.name for e in events)}
        want = {"dwt2": POD_LAUNCHES["dwt2"] + POD_LAUNCHES["synth2"],
                "pair": POD_LAUNCHES["pair"], "relu": 0}
        if profiled != want:
            raise AssertionError(f"pod: the profiler saw {profiled} of the port's kernels "
                                 f"in one batch, expected {want}")
    ms, q1, q3, _ = median_iqr([t * 1e3 for t in samples])
    if not np.isfinite(rows).all() or np.abs(rows).max() == 0:
        raise AssertionError("pod: the in-process entry's rows are not finite and nonzero")
    return {"rows": rows, "repeat_max_rel": repeat, "launches": launches,
            "profiled": profiled, "batch_ms": ms,
            "batch_q1_ms": q1, "batch_q3_ms": q3, "peak_gb": peak_gb}


def _pod_stream(router, x, y, n: int, clients: int, killer=None, budget_s: float = 240.0):
    """``n`` requests of (x, y) from ``clients`` threads, each one request
    in flight, every submit through `submit_with_retry` (retrying
    QueueFullError and NoLiveWorkerError, so an outage window is
    backpressure); ``killer.on_progress`` after every resolved request.
    Returns the results, the errors, each request's seconds and the wall
    seconds."""
    import random
    import threading

    from wam_tpu_torch.pod import NoLiveWorkerError
    from wam_tpu_torch.serve import QueueFullError, RetryPolicy, RetryStats

    policy = RetryPolicy(max_attempts=64, budget_s=budget_s, backoff_base_s=0.05,
                         retry_on=(QueueFullError, NoLiveWorkerError))
    stats = RetryStats()
    results, errors, latencies = [], [], []
    lock = threading.Lock()
    todo = iter(range(n))

    def client(cid):
        rng = random.Random(SEED * 1000 + cid)
        while True:
            with lock:
                i = next(todo, None)
            if i is None:
                return
            t0 = time.perf_counter()
            try:
                r = router.submit_with_retry(x, y, policy=policy, stats=stats,
                                             rng=rng).result(timeout=budget_s + 60.0)
            except Exception as e:  # noqa: BLE001 - every loss is reported and fails the phase
                with lock:
                    errors.append(repr(e))
                continue
            with lock:
                results.append(r)
                latencies.append(time.perf_counter() - t0)
                done = len(results)
            if killer is not None:
                killer.on_progress(done)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(budget_s + 120.0)
    if any(t.is_alive() for t in threads):
        raise AssertionError("pod: a client thread is still waiting after its budget")
    return {"results": results, "errors": errors, "latencies_s": latencies,
            "wall_s": time.perf_counter() - t0, "retries": stats.as_dict()}


def _pod_rows_held(np, results, ref_rows, tag: str) -> dict:
    """Every answer against the in-process entry's rows: a request's row is
    the one of its position in the worker's batch (the batch is copies of
    the one request, so any of the rows); the distance to the nearest row,
    x max, within POD_TOL."""
    scale = float(np.abs(ref_rows).max())
    worst, exact = 0.0, 0
    for r in results:
        r = np.asarray(r)
        if r.shape != ref_rows.shape[1:] or r.dtype != np.float32 or not np.isfinite(r).all():
            raise AssertionError(f"pod {tag}: an answer of shape {r.shape} {r.dtype}, "
                                 f"expected {ref_rows.shape[1:]} float32, finite")
        d = min(float(np.abs(r - row).max()) for row in ref_rows) / scale
        exact += d == 0.0
        worst = max(worst, d)
    if worst > POD_TOL:
        raise AssertionError(f"pod {tag}: an answer {worst:.3e} x max from the in-process "
                             f"entry's nearest row (bound {POD_TOL})")
    return {"max_rel": worst, "bit_equal": exact, "answers": len(results)}


def _pod_launch_delta(router) -> dict:
    """The kernels' launches the workers made after their warmup: each
    current incarnation's counts at its last heartbeat (which can fall
    inside a batch) less its counts at hello (its ready row)."""
    at_ready = {(r["worker_id"], r["incarnation"]): r["kernel_launches"]
                for r in _pod_ready(router)}
    total = dict.fromkeys(ZERO_LAUNCHES, 0)
    for w in router.pod_summary()["per_worker"]:
        for k in total:
            total[k] += (w["device"]["kernel_launches"][k]
                         - at_ready[(w["worker_id"], w["incarnation"])][k])
    return total


def _pod_ready(router, incarnation=None) -> list:
    return [r for r in router.metrics.worker_rows if r["phase"] == "ready"
            and (incarnation is None or r["incarnation"] == incarnation)]


def _pod_ms(np, latencies) -> dict:
    from wam_tpu_torch.serve.metrics import percentile_ms

    return {"p50_ms": percentile_ms(latencies, 50), "p99_ms": percentile_ms(latencies, 99)}


def _pod_wire(torch, np, wtt, ref_rows, x, y, smi: str) -> dict:
    """A cold worker joining from a wire bundle: this process compiles the
    workers' toy entry (``--aot-key-base``'s compiled step, on the batch
    signature a worker's warmup gives it) under throwaway caches, the
    compiled step and the kernel libraries are published as a bundle, and a
    worker with empty caches and ``--registry wire`` over tcp hydrates from
    the bytes the router streams: ready at compile_count 0."""
    from wam_tpu_torch.pod import PodRouter
    from wam_tpu_torch.pod.metrics import _c_registry_stream
    from wam_tpu_torch.pod.worker import toy_wam
    from wam_tpu_torch.registry import publish_bundle

    root = tempfile.mkdtemp(prefix="wam_pod_")
    atexit.register(shutil.rmtree, root, ignore_errors=True)
    key = f"chip_smoke|pod|toy2d|J2|n{N_SAMPLES}|mb{POD_MAX_BATCH}"
    seed_env = _aot_env(root, "seed")
    saved = {k: os.environ.get(k) for k in _AOT_ENV}
    os.environ.update(seed_env)
    card = torch.device(POD_DEVICE)
    compiles: list = []
    try:
        entry = toy_wam(N_SAMPLES, card).serve_entry(on_trace=lambda: compiles.append(1),
                                                     aot_key=key)
        xs = torch.from_numpy(np.repeat(x[None], POD_MAX_BATCH, axis=0)).to(card)
        ys = torch.full((POD_MAX_BATCH,), y, dtype=torch.int32, device=card)
        t0 = time.perf_counter()
        with _torch_defaults(torch):  # a fresh worker's flags: its program's key
            entry(xs, ys)
        if card.type == "cuda":
            torch.cuda.synchronize()
        seed_s = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if len(compiles) != 1:
        raise AssertionError(f"pod: the seed compile counted {len(compiles)} compiles, not 1")
    bundle = os.path.join(root, "bundle")
    manifest = publish_bundle(
        bundle, aot_dir=seed_env["WAM_TPU_AOT_CACHE"],
        schedule_path=os.path.join(root, "seed_schedules.json"), include_compile=True,
        source={"publisher": "chip_smoke phase pod"})
    kinds = {}
    for a in manifest["artifacts"]:
        kinds[a["kind"]] = kinds.get(a["kind"], 0) + 1
    if kinds.get("aot", 0) < 1:
        raise AssertionError(f"pod: the bundle holds no compiled step: {kinds}")
    streamed = _c_registry_stream.value()
    wire_env = {**_aot_env(root, "wire"), "WAM_TORCH_SCHEDULE_CACHE":
                os.path.join(root, "wire_schedules.json")}
    wire = PodRouter(_pod_argv("--aot-key-base", key, "--registry", "wire"),
                     f"{CHANNELS}x{POD_SIDE}x{POD_SIDE}", workers=1, env=_pod_env(wire_env),
                     transport="tcp", registry=bundle, ready_timeout_s=POD_READY_S)
    try:
        ready = _pod_ready(wire)[0]
        answer = np.asarray(wire.attribute(x, y))
    finally:
        wire.close()
    streamed = _c_registry_stream.value() - streamed
    if ready["compile_count"] != 0 or ready["post_warm_compiles"] != 0 or streamed <= 0:
        raise AssertionError(f"pod: the wire worker was ready at compile_count "
                             f"{ready['compile_count']} (post-warm "
                             f"{ready['post_warm_compiles']}) after {streamed} bytes streamed")
    scale = float(np.abs(ref_rows).max())
    dist = min(float(np.abs(answer - row).max()) for row in ref_rows) / scale
    if not np.isfinite(answer).all() or dist > POD_AOT_TOL:
        raise AssertionError(f"pod: the compiled worker's answer is {dist:.3e} x max from "
                             f"the eager entry's nearest row (bound {POD_AOT_TOL})")
    _log(f"  pod wire: the toy step compiled in this process in {seed_s:.1f} s (1 compile); "
         f"bundle {kinds}; the wire worker streamed {streamed} bytes "
         f"and was ready in {ready['spawn_s']:.2f} s (start-up "
         + ", ".join(f"{k} {v:.2f}" for k, v in ready["startup_s"].items())
         + f") at compile_count 0; its answer {dist:.3e} x max from eager (bound "
           f"{POD_AOT_TOL}); on {smi}")
    return {"seed_s": seed_s, "bundle": kinds,
            "streamed_bytes": streamed, "ready_s": ready["spawn_s"],
            "startup_s": ready["startup_s"], "compile_count": ready["compile_count"],
            "distance": dist}


def phase_pod(torch, wtt, kernels, smi: str) -> dict:
    """Pod serving on the card (module docstring, phase 27)."""
    import numpy as np

    from wam_tpu_torch.pod import PodRouter
    from wam_tpu_torch.serve import SupervisorConfig
    from wam_tpu_torch.testing import PodChaosKiller

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the workers share the card with this process
    rng = np.random.default_rng(SEED + 18)
    x = rng.standard_normal((CHANNELS, POD_SIDE, POD_SIDE)).astype(np.float32)
    y = int(rng.integers(0, 4))
    ref = _pod_reference(torch, np, kernels, x, y)
    _log(f"  pod: the workers' entry in process, toy WaveletAttribution2D (haar, J=2, "
         f"n={N_SAMPLES}) on a batch of {POD_MAX_BATCH} x {CHANNELS}x{POD_SIDE}^2: two calls "
         f"{ref['repeat_max_rel']:.3e} x max apart (cuDNN's default algorithms); launches "
         f"{ref['launches']} (asserted), the profiler's kernels {ref['profiled']}, "
         f"{ref['batch_ms']:.3f} ms ({ref['batch_q1_ms']:.3f}-{ref['batch_q3_ms']:.3f}) a "
         f"batch, peak {ref['peak_gb']:.2f} GB")
    bucket = f"{CHANNELS}x{POD_SIDE}x{POD_SIDE}"
    t0 = time.perf_counter()
    router = PodRouter(_pod_argv(), bucket, workers=POD_WORKERS, transport="tcp", env=_pod_env(),
                       supervise=SupervisorConfig(seed=SEED, backoff_base_s=0.05),
                       ready_timeout_s=POD_READY_S, seed=SEED)
    start_s = time.perf_counter() - t0
    out = {"gpu": smi, "start_s": start_s, "launches": ref["launches"],
           "repeat_max_rel": ref["repeat_max_rel"],
           "profiled": ref["profiled"], "in_process_batch_ms": ref["batch_ms"],
           "in_process_peak_gb": ref["peak_gb"]}
    try:
        ready = _pod_ready(router)
        if len(ready) != POD_WORKERS or any(r["compile_count"] != 1 for r in ready):
            raise AssertionError(f"pod: ready rows {ready}")
        out["ready"] = [{"worker": r["worker_id"], "spawn_s": r["spawn_s"],
                         "startup_s": r["startup_s"], "peak_gb": r["peak_memory_bytes"] / 1e9}
                        for r in ready]
        _log(f"  pod: PodRouter(transport=tcp) over {POD_WORKERS} workers on cuda:0 ready in "
             f"{start_s:.2f} s; spawn-to-ready " + "; ".join(
                 f"w{r['worker']} {r['spawn_s']:.2f} s ("
                 + ", ".join(f"{k} {v:.2f}" for k, v in r["startup_s"].items())
                 + f"), peak {r['peak_gb']:.2f} GB" for r in out["ready"]))

        killer = PodChaosKiller(router, POD_REQUESTS, fractions=POD_KILLS, seed=SEED)
        chaos = _pod_stream(router, x, y, POD_REQUESTS, POD_CLIENTS, killer=killer)
        if chaos["errors"] or len(chaos["results"]) != POD_REQUESTS:
            raise AssertionError(f"pod: lost {POD_REQUESTS - len(chaos['results'])} requests "
                                 f"under chaos: {chaos['errors'][:3]}")
        if [k["killed"] for k in killer.kills] != [True] * len(POD_KILLS):
            raise AssertionError(f"pod: kills {killer.kills}")

        def alive_rows():
            return [r for r in router.metrics.restarts if r["transition"] == "alive"]

        deadline = time.monotonic() + POD_READY_S
        while time.monotonic() < deadline and (
                len(alive_rows()) < len(POD_KILLS)
                or router.live_worker_ids() != list(range(POD_WORKERS))):
            time.sleep(0.05)
        deaths = router.metrics.deaths
        if len(deaths) != len(POD_KILLS) or len(alive_rows()) != len(POD_KILLS):
            raise AssertionError(f"pod: deaths {deaths}, restarts {router.metrics.restarts}")
        rejoin = []
        for d in deaths:
            back = [r["t_s"] for r in alive_rows()
                    if r["worker_id"] == d["worker_id"] and r["t_s"] > d["t_s"]]
            rejoin.append(min(back) - d["t_s"])
        held = _pod_rows_held(np, chaos["results"], ref["rows"], "chaos")
        out["chaos"] = {"requests": POD_REQUESTS, "lost": 0, "wall_s": chaos["wall_s"],
                        "requests_per_s": POD_REQUESTS / chaos["wall_s"],
                        **_pod_ms(np, chaos["latencies_s"]), "retries": chaos["retries"],
                        "kills": killer.kills, "deaths": deaths, "kill_to_rejoin_s": rejoin,
                        "respawn_ready": [{"worker": r["worker_id"],
                                           "incarnation": r["incarnation"],
                                           "spawn_s": r["spawn_s"],
                                           "startup_s": r["startup_s"],
                                           "compile_count": r["compile_count"]}
                                          for r in _pod_ready(router) if r["incarnation"] > 0],
                        "held": held}
        _log(f"  pod chaos: {POD_REQUESTS} requests from {POD_CLIENTS} clients, kills at "
             f"{POD_KILLS} of them ({[(k['threshold'], k['worker_id']) for k in killer.kills]})"
             f", 0 lost, {out['chaos']['requests_per_s']:.2f} requests/s, p50 "
             f"{out['chaos']['p50_ms']:.1f} ms, p99 {out['chaos']['p99_ms']:.1f} ms, retries "
             f"{chaos['retries']}; kill to rejoin "
             + ", ".join(f"{s:.2f}" for s in rejoin) + " s; respawns ready in "
             + ", ".join(f"{r['spawn_s']:.2f} s" for r in out["chaos"]["respawn_ready"])
             + f"; answers against the in-process entry: {held['bit_equal']} of "
               f"{held['answers']} bit-equal, worst {held['max_rel']:.3e} x max")

        for tag, n_workers in (("two", POD_WORKERS), ("one", 1)):
            if n_workers < len(router.live_worker_ids()):
                wid = router.shrink()
                deadline = time.monotonic() + 60.0
                while time.monotonic() < deadline and len(router.live_worker_ids()) > 1:
                    time.sleep(0.02)
                if router.live_worker_ids() != [1 - wid]:
                    raise AssertionError(f"pod: shrink left {router.live_worker_ids()}")
            clean = _pod_stream(router, x, y, POD_THROUGHPUT_REQUESTS, POD_THROUGHPUT_CLIENTS)
            if clean["errors"] or len(clean["results"]) != POD_THROUGHPUT_REQUESTS:
                raise AssertionError(f"pod {tag}: lost requests {clean['errors'][:3]}")
            held = _pod_rows_held(np, clean["results"], ref["rows"], tag)
            out[f"{tag}_worker"] = {"requests": POD_THROUGHPUT_REQUESTS,
                                    "clients": POD_THROUGHPUT_CLIENTS,
                                    "wall_s": clean["wall_s"],
                                    "requests_per_s": POD_THROUGHPUT_REQUESTS / clean["wall_s"],
                                    **_pod_ms(np, clean["latencies_s"]), "held": held}
            _log(f"  pod {tag} worker(s): {POD_THROUGHPUT_REQUESTS} requests from "
                 f"{POD_THROUGHPUT_CLIENTS} clients in {clean['wall_s']:.2f} s: "
                 f"{out[f'{tag}_worker']['requests_per_s']:.2f} requests/s, p50 "
                 f"{out[f'{tag}_worker']['p50_ms']:.1f} ms, p99 "
                 f"{out[f'{tag}_worker']['p99_ms']:.1f} ms; {held['bit_equal']} of "
                 f"{held['answers']} answers bit-equal, worst {held['max_rel']:.3e} x max")
        worker_launches = _pod_launch_delta(router)
    finally:
        router.close()
    summary = router.pod_summary()
    if any(worker_launches[k] <= 0 for k in ("dwt2", "pair")) or any(
            worker_launches[k] for k in ("synth2", "relu_fwd", "relu_bwd")):
        raise AssertionError(f"pod: the workers' launches after warmup {worker_launches}")
    out["worker_launches"] = worker_launches
    out["per_worker"] = summary["per_worker"]
    peaks = [w["device"]["peak_memory_bytes"] / 1e9 for w in summary["per_worker"]
             if "device" in w]
    out["peak_gb_per_worker"] = peaks
    _log(f"  pod: the workers' launches after their warmup (their current incarnations' "
         f"last heartbeats less their hello) {worker_launches}; peak GB of each worker's "
         "current incarnation "
         + ", ".join(f"{p:.3f}" for p in peaks))
    out["wire"] = _pod_wire(torch, np, wtt, ref["rows"], x, y, smi)
    out["phase_s"] = time.perf_counter() - t_phase
    _log(f"  pod: phase {out['phase_s']:.1f} s (budget {POD_BUDGET_S:.0f} s"
         + ("" if out["phase_s"] <= POD_BUDGET_S else ", OVER") + ")")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    if not (ROOT / "wam_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: wam_tpu_torch not found beside {Path(__file__).name}",
              file=sys.stderr)
        return 1
    # every "auto" of the script reads an empty schedule table of its own, so
    # a table persisted under the machine's HOME cannot move a phase's chunks
    table = tempfile.mkdtemp(prefix="wam_schedules_")
    atexit.register(shutil.rmtree, table, ignore_errors=True)
    os.environ["WAM_TORCH_SCHEDULE_CACHE"] = os.path.join(table, "schedules.json")
    os.environ.pop("WAM_TPU_NO_SCHEDULE_CACHE", None)
    sys.path.insert(0, str(ROOT))
    import wam_tpu_torch as wtt
    from wam_tpu_torch import kernels
    from wam_tpu_torch.wavelets import matmul as tmm

    t_start = time.perf_counter()
    smi = _nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    _log(f"phase device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    t0 = time.perf_counter()
    report = kernels.build_all()
    _log(f"phase build: {time.perf_counter() - t0:.2f} s for {sorted(report)} "
         f"into {kernels.BUILD_DIR}")
    for name, rep in report.items():  # ptxas: registers, static shared memory, spills
        keys = (("entry function", "registers", "spill", "smem")
                if name in ("dwt2", "synth2", "pair") else ("registers", "spill"))
        for line in rep["log"].splitlines():
            if any(k in line for k in keys):
                _log(f"  {name}: {line.strip()}")

    preflight(torch)
    sites = relu_sites(torch, wtt)
    vol_sites = vol_relu_sites(torch, wtt)
    if len(vol_sites) != VOL_SITES:
        raise AssertionError(f"the 3D ResNet-18 has {len(vol_sites)} ReLU sites, not {VOL_SITES}")
    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        _log(f"  phase {name}: {seconds[name]:.1f} s")
        return out

    rows = timed("kernels", phase_kernels, torch, tmm, kernels, sites, vol_sites)
    periodized = timed("periodized", check_periodized, torch, wtt, kernels)
    slice_ = timed("slice", phase_slice, torch, wtt, kernels, smi)
    slice2 = timed("slice2", phase_slice2, torch, wtt, kernels, smi, len(sites))
    audio = timed("audio", phase_audio, torch, wtt, kernels, smi)
    vit = timed("vit", phase_vit, torch, wtt, kernels, smi)
    convnext = timed("convnext", phase_convnext, torch, wtt, kernels, smi)
    vol = timed("vol", phase_vol, torch, wtt, kernels, smi)
    voxel3d = timed("voxel3d", phase_voxel3d, torch, wtt, kernels, smi)
    eval2d = timed("eval2d", phase_eval2d, torch, wtt, kernels, smi)
    eval1d = timed("eval1d", phase_eval1d, torch, wtt, kernels, smi)
    baselines = timed("baselines", phase_baselines, torch, wtt, kernels, smi)
    nhwc = timed("nhwc", phase_nhwc, torch, wtt, kernels, smi)
    analyzers = timed("analyzers", phase_analyzers, torch, wtt, kernels, smi)
    iou = timed("iou", phase_iou, torch, wtt, kernels, smi)
    patch = timed("patch", phase_patch, torch, wtt, kernels, smi)
    attention = timed("attention", phase_attention, torch, wtt, kernels, smi)
    video = timed("video", phase_video, torch, wtt, kernels, smi)
    anytime_ = timed("anytime", phase_anytime, torch, wtt, kernels, smi)
    serve_ = timed("serve", phase_serve, torch, wtt, kernels, smi)
    par = timed("parallel", phase_parallel, torch, wtt, kernels, smi)
    fleet = timed("fleet", phase_fleet, torch, wtt, kernels, smi)
    seq = timed("seq", phase_seq, torch, wtt, kernels, smi)
    tune = timed("tune", phase_tune, torch, wtt, kernels, smi)
    aot_ = timed("aot", phase_aot, torch, wtt, kernels, smi, sites)
    pod = timed("pod", phase_pod, torch, wtt, kernels, smi)
    # what routing the host-bound phases' eager launches through the
    # operators would add to a call (phase aot's dispatch measurement)
    aot_["dispatch_estimate"] = aot_dispatch_estimate(aot_["dispatch"], {
        "vit": (vit["call_launches"], vit["median_ms"], vit["spread_ms"]),
        "video": (video["call_launches"], video["median_ms"], video["spread_ms"]),
        **{f"eval2d {m}": (eval2d[m]["launches"], eval2d[m]["median_ms"],
                           eval2d[m]["spread_ms"]) for m in EVAL_METRICS}})
    an_calls = ("isolate_scales", "insertion", "deletion")
    launches = {"flagship": slice_["launches"], "path 2": slice2["launches"],
                "vit": vit["call_launches"], "vol": vol["fused"]["call_launches"],
                "eval2d": eval2d["insertion"]["launches"],
                "eval2d insertion": eval2d["insertion"]["launches"],
                "eval2d mu": eval2d["mu_fidelity"]["launches"],
                "analyzers": analyzers["isolate_scales"]["launches"],
                "analyzers scales": analyzers["isolate_scales"]["launches"],
                "analyzers components": analyzers["insertion"]["launches"],
                **{f"iou {w}": iou["per_wavelet"][w]["call_launches"] for w in IOU_WAVELETS},
                "patch": patch["call_launches"], "video": video["call_launches"],
                "anytime": anytime_["launches"],
                **{f"serve {s}": serve_["batch_launches"][s] for s in SERVE_LAUNCHES},
                "parallel": par["spmd"]["launches"], "parallel ig": par["ig"]["launches"],
                "tune": tune["nchw_launches"], "pod": pod["launches"]}
    for row in rows:
        row["launches"] = launches[row["path"]][row["kernel"]]
        row["audio_launches"] = audio["launches"][row["kernel"]]
        row["vit_launches"] = vit["call_launches"][row["kernel"]]
        row["convnext_launches"] = convnext["call_launches"][row["kernel"]]
        row["vol_launches"] = vol["call_launches"][row["kernel"]]
        row["vol_fused_launches"] = vol["fused"]["call_launches"][row["kernel"]]
        row["voxel3d_launches"] = voxel3d["voxel"]["call_launches"][row["kernel"]]
        row["eval2d_launches"] = {m: eval2d[m]["launches"][row["kernel"]] for m in EVAL_METRICS}
        row["eval1d_launches"] = {m: eval1d[m]["launches"][row["kernel"]]
                                  for m in EVAL1D_METRICS}
        row["baselines_launches"] = baselines["launches"][row["kernel"]]
        row["nhwc_launches"] = nhwc["launches"][row["kernel"]]
        row["analyzers_launches"] = {c: analyzers[c]["launches"][row["kernel"]] for c in an_calls}
        row["iou_launches"] = {w: iou["per_wavelet"][w]["call_launches"][row["kernel"]]
                               for w in IOU_WAVELETS}
        row["patch_launches"] = patch["call_launches"][row["kernel"]]
        row["attention_launches"] = attention["launches"][row["kernel"]]
        row["video_launches"] = video["call_launches"][row["kernel"]]
        row["video_eval_launches"] = video["eval_launches"][row["kernel"]]
        row["anytime_launches"] = anytime_["launches"][row["kernel"]]
        row["serve_launches"] = serve_["launches"][row["kernel"]]
        row["parallel_launches"] = {k: par[k]["launches"][row["kernel"]]
                                    for k in ("spmd", "propagation", "ig")}
        row["fleet_launches"] = fleet["stream"]["launches"][row["kernel"]]
        row["seq_launches"] = {arm: seq[arm]["launches"][row["kernel"]] for arm in SEQ_ARMS}
        row["tune_launches"] = {c["label"]: c["launches"][row["kernel"]]
                                for c in tune["candidates"]}
        row["aot_launches"] = aot_["launches"][row["kernel"]]
        row["pod_launches"] = pod["launches"][row["kernel"]]

    print(json.dumps({"slice": {k: v for k, v in slice_.items() if k != "launches"},
                      "slice2": {k: v for k, v in slice2.items() if k != "launches"},
                      "audio": audio, "vit": vit, "convnext": convnext, "vol": vol,
                      "voxel3d": voxel3d, "eval2d": eval2d, "eval1d": eval1d,
                      "baselines": baselines, "periodized": periodized, "nhwc": nhwc,
                      "analyzers": analyzers, "iou": iou, "patch": patch,
                      "attention": attention, "video": video, "anytime": anytime_,
                      "serve": serve_, "parallel": par, "fleet": fleet, "seq": seq,
                      "tune": {k: v for k, v in tune.items() if k != "entry"},
                      "aot": aot_, "pod": pod,
                      "phase_s": seconds,
                      "wall_s": time.perf_counter() - t_start, "gpu": smi}),
          flush=True)
    _log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s wall, the kernels' build included")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
