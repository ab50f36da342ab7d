#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (boxsegliver_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each raising on failure (the script exits non-zero and prints no
result line):
1. device  — a CUDA device is required; prints ``nvidia-smi`` name and
   power limit.
2. build   — builds every CUDA kernel of the port from csrc/ (B1, B2
   with B2s / B2y, G1: nvcc, one process per source, in parallel) and
   prints the build time and ptxas report.
3. kernels — kernel B1 (gaussian_guide_batch) against its plain PyTorch
   version on the card at the guided sweep's shapes and at edge cases (W
   not a multiple of 4, one row, K = 0, 1, 150); max abs error <= 1e-6.
   At the sweep's, the train preprocess's and the nf_inter click guides'
   (32 rows = fg and bg of batch 16, K = 8) shapes: device time per
   launch (``graph_ms``: launches captured in a CUDA graph), wrapper time
   per call and plain time (CUDA events), and the card's bound for the same
   work (bytes, or the least f32 operations beside one exponential per
   pixel at the SFU rate: b1_bound_ms).
4. labeling — label_components / ordered_seeds / object_moments on the
   card against scipy.ndimage.label and the numpy
   compute_robust_moments, on the synthetic dataset's GT tumor masks
   (exact).
5. slice   — the flagship guided eval (``002_gnet_sp`` eval flags) through
   ``boxsegliver_torch.cli.main.main`` on a synthetic LiTS-like dataset
   (4 cases of 24 x 256 x 256) with seeded full-width GUNet weights
   (init_channels 64, 4 down-samples, mod_layers 1-4, context_fc 256x2),
   256^2 inputs, 4-way mirror TTA, both sweep directions batched.  The
   head's kernel is scaled by 1e-3 and its bias gives Liver a margin no
   activation overturns, so no tumor component is predicted, no case
   overflows the sweep's object cap, and the metrics have a closed form
   that is checked.  B1's launch counter is zeroed right before this
   phase and must read at least the number of sweep steps after it.
   A card-vs-CPU check holds the whole sweep on the card against the CPU
   path (64^2, float32, a small GUNet fitted for 200 Adam steps so that
   tumor components are really labeled and propagated).
   Every full-affine instance-norm + ReLU pair of that forward runs kernel
   B2-fwd; its launches in this phase are printed, not claimed.
6. profile — one case's sweep in steady state: wall per step, the
   full-width forward alone, and torch.profiler's kernel time by group and
   by name (device busy share).
7. kernel B2 — the kernels of csrc/in_relu.cu (in_relu_fwd; the
   backward: in_relu_bwd, B2f, fused where a plane fits on chip, or
   in_relu_bwd_stats + in_relu_bwd_apply, B2a + B2b, split over several
   CTAs a plane) and the autograd Function that ties them against their
   plain PyTorch versions at the four flagship shapes in bf16, at edge
   cases (H·W not a multiple of the vector width, C = 1, bs = 1), one
   element either side of each path boundary of B2-fwd and of the
   backward, at each staged cluster size, in float32 and on an unaligned
   x and g, with the tolerances stated in ``b2_check``; every backward
   plan of ``bwd_alternatives`` (the chosen one, the split plan, the first
   design with one CTA a plane for B2a and B2b, other clusters) at every
   shape; the plans of each flagship shape; per shape and per train step
   each kernel's device time per launch (``graph_ms``), wrapper time per
   call, plain and library ("two calls", F.relu(F.instance_norm(...)),
   forward and backward) times, and the card's bound for the same work;
   the whole backward per shape and per step (``bwd_verdict``) against
   B2f's bound (6 B a bf16 element) and against the first design timed in
   the same run, failing if the chosen plan is over 5 % slower than it;
   B2-fwd's wrapper time through the registered operator
   boxseg::in_relu_fwd beside its CUDA implementation called without the
   dispatcher.  Then the five levels of the NF UNet / UNetInter at batch
   16 (b2_nf_levels): each against its plain version, its plans, device
   time per launch, plain, library and bound, and the sums over one NF
   train step (18 calls).  Then B2's and B3's NHWC plans (nhwc_phase:
   G-Net's channels-last activations) at the flagship's train-step shapes:
   every plan of nhwc_alternatives timed, the chosen one against the bound,
   the NCHW plans on the same data and the plain versions, per train step
   against the benchmark's 10 and 16 B an element; and cudnn_transposes,
   cuDNN's layout transposes of two G-Net convs with NCHW activations
   (cudnn.benchmark off and on) and channels-last ones.
8. train — the flagship G-Net training (``002_gnet_sp.sh train`` flags) at
   full width, batch 8, 256^2, bf16 through
   ``boxsegliver_torch.cli.main.main`` with --device_cache: 24 steps, an
   online 2D eval every 12, a best checkpoint; then a resume run on the
   streaming (device-resize) sampler to step 30, whose checkpoint is phase
   18's weights; both on one host worker (ONE_WORKER).  The launch counters are
   zeroed right before each run: B1 must launch at least once per step,
   B2-fwd at least ten times per step and the backward's kernels as
   in_relu_bwd_plan has them over the step's ten pairs (B2f; no B2a or
   B2b).  The loss must be finite and
   fall; checkpoints and sidecars must exist.  Then one train step of a
   small GUNet at 64^2 in float32 without TF32 on the card against the same
   step on the CPU (loss and updated parameters within 1e-4).
9. train profile — the flagship train step in steady state: ms/step,
   slices/s, device busy share and kernel time by group.
10. UNet train — the headline UNet training (``001_unet.sh train`` flags:
   UNet.yml at full width, init_channels 64, 4 down-samples, batch norm,
   batch 8, 256^2 x 3, bf16, numerical loss weights, plateau Adam) through
   ``boxsegliver_torch.cli.main.main`` with --device_cache and one host
   worker (ONE_WORKER): 24 steps, the inline whole-volume eval
   (--eval_per_epoch --eval_3d --eval_num 1) every 12, a best checkpoint
   (phase 12's weights); the loss must fall and the running
   statistics move; then a resume on the streaming sampler to step 30.
   The launch counters are zeroed before each run: the batch-norm path
   runs none of the hand-written kernels and must launch none.  Then one
   train step of UNet_TINY (batch norm) at 64^2 in float32 on the card
   against the CPU: loss, parameters and running statistics within 1e-4.
11. UNet steady state — the UNet train step at the ``001_unet.sh`` flags
   (batch 8, the smoke's dataset) and the ``bench.py`` workload on the port
   (its flags: batch 128, --device_cache, --noise_scale 0.1, float32 Adam
   moments, on 4 synthetic cases of 24 x 512 x 512, k_folds 4): warm-up,
   then 3 windows of 16 steps, each closed by one fetch of the window's
   metrics as the train loop's drain does; ms/step and slices/s per
   window; one profiled window of 8 steps gives the busy share and the
   device time by kernel group; the analytic GFLOP per slice (forward from
   the conv shapes, x3 for forward and backward) and its share of the bf16
   peak.
12. UNet eval — ``001_unet.sh eval`` through the CLI on phase 10's
   checkpoint: EvaluateVolume.run with a DeviceSlicePredictor over the
   test fold; s/case and slices/s (the CLI call, then the same run warm);
   then device_case on the card against the CPU in float32 on an 8-slice
   cut of one case (probabilities within 1e-4); the warm run's predictions
   are saved for phase 18's viewer.
13. host loop — run_g's per-slice host propagation loop at full width
   through the CLI: a seeded random init overflows the sweep's cap of 16
   objects and each case finishes through the host loop (B1 at least once
   per slice and direction); the liver-margin weights with --device_sweep
   on, off and --save_sp_guide (metrics within 1e-3, s/case of each, the
   guide volumes written); the host loop against the device sweep on the
   card at 64^2 in float32 with the fitted small GUNet (probabilities
   within 1e-4, equal tumor component counts).
14. K = 16 — ``--steps_per_dispatch 16`` (the train step captured in a
   CUDA graph, B1 and B2 inside) with the 002_gnet_sp.sh and 001_unet.sh
   train flags through the CLI, 32 steps and a resume to 48; 32 graphed
   flagship steps against 32 eager ones (noise, flips and dropout 0: loss
   per step within 1e-4 relative, all parameters together within 1e-4 in
   relative L2 norm; with them on: whether the draws are equal); K = 1 and
   K = 16 in steady state at batch 8 for both models (ms/step over 3
   windows, slices/s, busy share, host launches per step, B1 / B2 launches
   per replay).
15. bench knobs — the bench.py step with bf16 Adam moments, with K = 16 and
   with both.
16. loss weights — phase 8's card-vs-CPU train step with the boundary and
   the proportion loss weights (1e-4); then, in a child process started
   with CUBLAS_WORKSPACE_CONFIG=:4096:8, the tiny float32 G-Net of
   tests/test_torch_cuda.py trained twice for 6 eager steps from one
   --seed under deterministic algorithms (and twice without): whether the
   runs are bit-equal, the first parameter that differs, and the ops that
   have no deterministic CUDA version (printed, not gated).
17. serving — ``--mode export`` through ``boxsegliver_torch.cli.main.main``
   on the card: GUNet.yml at the ``002_gnet_sp.sh`` eval flags (batch 8,
   256^2 x 3, instance norm, histogram context 200, spatial guide, bf16)
   from phase 5's seeded init by --ckpt_path, and UNet.yml at the
   ``001_unet.sh`` eval flags from phase 10's best checkpoint.  Each bundle
   is served on the card by cli/serve.make_server in a thread: 20 npz
   requests of 8 slices (launch counters zeroed right before them), one of
   20 slices (chunked and padded), one JSON request; ms/request (median,
   min, max), slices/s, the forward alone (CUDA events) and launches per
   request: B2-fwd at least 10 per GUNet request, every kernel 0 for the
   UNet.  The GUNet response against the eager model + softmax on the card
   within one bf16 rounding step; a GUNet_TINY bundle (64^2, float32)
   exported on the card and served on the card and on the CPU (1e-4).
18. prepare -> annotate -> viewers — two LiTS-like NIfTI cases of 64 x
   512 x 512 int16 with labels (pid 49 inside the LiTS quirk's label range)
   through the port's ``prepare`` CLI: extract, hist, glcm, prior, kfold,
   infer_context (s/case each; the cache holds the arrays written).  The
   cache served by ``cli/annotate.make_server(port=0)`` in a thread, on the
   card by default, with the ``002_gnet_sp.sh`` eval flags at GUNet.yml
   full width and phase 8's trained weights after ``--``: /api/state,
   /api/slice
   for z, y and x (ms per payload), an interaction for the prior's first
   tumor and its z slice with the guide preview (B1 launches exactly once),
   /api/save, two /api/predict (s each; B1 and B2-fwd launch in each).  The
   live class map equals ``cli.main liver --mode infer --real_sp`` of the
   saved interactions on the same weights and card (max abs diff 0), and
   changes when the interaction is popped and the case predicted again;
   ``compare_preds --min_dice 1.0`` passes them; the preview drawn by B1 on
   the card against the plain version on the CPU (float 1e-6, uint8 one
   level); B1's device time per launch at the preview's shape; encode_png's
   ms per 512^2 payload at zlib levels 1, 6, 9.  Then ``cli/viewer`` over
   phase 12's predictions, ``cli/vis`` over phase 17's UNet bundle on the
   card (overlays written) and ``ckpt_tools list`` on phase 10's checkpoint.
19. NF — on the CLI's own ``synthetic_nf`` set (4 NF cases of 24 x 256^2,
   written by cli/main.resolve_dataset_dir), every train run on one host
   worker: (a) ``101_unet_v2.sh train`` flags through the CLI (UNet.yml
   full width, instance norm, batch 16, 256^2 x 3): 24 steps with the
   online eval every 12 (4 batches) and a resume to 30; exactly 18 B2-fwd
   and 18 backward launches a step (b2_train_counts: B2f at every level;
   B2-fwd 18 more per eval batch, B1 none);
   the step in steady state at K = 1 and K = 16 (ms/step, slices/s, busy
   share, device time by kernel group from a profiled window).  (b)
   ``101_unet_v2.sh eval`` with --save_predict on (a)'s best (s/case, 18
   B2-fwd a forward) and --mode infer of the other fold; device_case card
   vs CPU in float32 (1e-4).  (c) ``prepare negcache`` from (b)'s
   predictions, then ``101_unetinter_v10.sh train`` flags with --fp_sample
   (UNetInter.yml full width, batch 16): 24 steps, exactly one B1 launch
   (the fg and bg click guides) and 18 of each B2 kernel a step; the step
   in steady state (K = 1); a UNetInter_TINY float32 train step card vs CPU
   (loss, gradients, parameters after 3 Momentum steps: 1e-4).  (d)
   ``101_unetinter_v10.sh eval`` (the online eval, 8 fixed batches: one B1
   launch each) and ``nf --mode eval --use_spatial`` (run_sp: one B1
   launch per case with tumor slices) on (c)'s best; run_sp's
   probabilities card vs CPU on 8 slices around a lesion (1e-4).
20. click eval — (a) kernel G1 (geodesic2d_batch, csrc/geodesic.cu)
   against its plain version on the card at the device refiner's shapes
   [64, 128, 128] and [4, 256, 256] (512^2 slices), at the boundary of its
   two plans (w = 257) and at edge cases (127 x 129, one row, one column,
   no seed, corner seeds, w = 1024): relative 1e-5 of the finite field,
   +inf at the same pixels; against the host C++ scan; at [64, 128, 128]
   and [64, 256, 256] the plan, device time per launch, wrapper, plain,
   bound (g1_bound_ms), time per row step and the chain floor
   (g1_chain_floor); B1 at the refiner's [64 rows, K 10, 256^2].  (b)
   ``101_unetinter_v10.sh inter`` through
   ``boxsegliver_torch.cli.interactive_eval`` on phase 19c's best
   (UNetInter.yml full width, bf16, the NF test fold), --device_refine off
   and on, each with gaussian and geodesic guides: s/case, Dice, clicks,
   and exact launches (B1 one a click or a round, G1 one a refiner round,
   18 B2-fwd a forward); the refiner's s/case split by device time into
   G1, the forward, the guide render and largest_error_click, with its
   rounds (refiner_split).  (c) the host loop against the device refiner in
   float32 on a small UNetInter fit on the card (every guide kind: equal
   clicks, Dice 1e-4); the refiner's first round of the full-width model
   card vs CPU (1e-4).  (d) the --device_refine auto crossover: both
   paths at 128^2 and 256^2.  (e) nf_inter train at the flags of
   105_interunet_v1.sh, 104_small_v3.sh, 103_lgnet_v3.sh (full width,
   batch 16) and 101_unetinter_v13's --geodesic: 8 steps each with exact
   launches a step, the three models' step in steady state.  (f) --mode
   export of (b)'s UNetInter (zero click guides), 5 requests served on the
   card, the response against the eager model within one bf16 step.
21. 3D tower — nf_3d with UNet3D.yml at full width (init_channels 30,
   max 320, 4 pools) on phase 19's synthetic_nf set (4 cases of 24 x
   256^2).  (a) B2-fwd and every backward plan at every level of the
   201_unet_v1.sh train step ([4,30,10,256^2] ... [4,320,5,16^2], planes
   of D·H·W) and at
   the whole-volume eval's [1,30,24,256^2], each against its plain version
   (b2_check's tolerances): plan, device time per launch, plain, library
   (F.relu(F.instance_norm), forward and backward) and bound, summed over
   the step's 18 calls.  (b) ``201_unet_v1.sh train`` through the CLI (batch
   4, 10 x 256^2, --random_flip 7, --tumor_percent 0.75, one host worker),
   16 steps with the --eval_per_epoch volume eval every 8: exactly 18
   B2-fwd a step and the backward's kernels by b2_train_counts (14 B2f, 4
   B2a + B2b at the 10 x 256^2 level; 18 B2-fwd more a forward of the
   eval); the
   step in steady state at K = 1 and 4 (ms/step, patches/s, busy share,
   device time by kernel group, GFLOP/patch, share of the bf16 peak).
   (c) ``201_unet_v1.sh eval`` (whole volume) and the sliding window
   (--im_depth 10) on (b)'s best: s/case, 18 B2-fwd a forward;
   make_volume_predict card vs CPU in float32 on 8 slices (1e-4).  (d) 8
   steps of 202_unetinter_v2 training (the click guides), then
   ``interactive_eval --dim 3``: the host loop and DeviceRefiner3D, TTA off
   and on (s/case, clicks, 18 B2-fwd a forward); the two in float32 on the
   card: equal clicks, Dice within 1e-6.  (e) --use_cascade --use_2d with
   phase 19c's UNetInter as the frozen 2-D model: 4 train steps, exactly
   one B1 launch a predicted slice (fg and bg click guides) and 18 B2-fwd
   a 2-D forward; ``cli/hybrid_eval`` with the cascade channel (s/case).
   (f) --mode export of (b)'s UNet3D (10 x 256^2, batch 1) served on the
   card: ms/request, 18 B2-fwd a request, the response against the eager
   model within one bf16 step.  (g) a small UNet3D train step card vs CPU
   in float32: loss, gradients, Adam moments and the Adam update, and the
   parameters after 3 Momentum steps, within 1e-4.  (h) cli/eval_all_ckpt
   over (b)'s ckpt_best/<tag>: EvaluateVolume3D whole volumes per tag,
   exactly 18 B2-fwd a forward, s/checkpoint.
22. nf2 / IIN — ``004_gnet_iin.sh`` flags (GUNet_IIN.yml full width:
   GUNet.yml's encoder / decoder with the PatchCNN context over the 3 x
   32^2 patch pyramid; instance norm, --zscore --gamma, batch 8, 256^2 x 3,
   bf16) on phase 19's synthetic_nf set, one host worker.  (a) 12 train
   steps through the CLI with the online eval (IinSampler, 4 batches) every
   6: exactly one B1 launch (the one-click guides, K = 1), 10 B2-fwd and
   10 B2f a step (B1 1 and B2-fwd 10 an eval batch); the step in
   steady state at K = 1 and K = 16 (ms/step, slices/s, busy share, device
   time by kernel group, B1 and B2 device ms per step against b1_bound_ms
   and b2_bound_ms).  (b) ``004_gnet_iin.sh eval`` (run_patch) with and
   without --eval_mirror: s/case, exactly one B1 launch (the patches'
   guides) and one forward (10 B2-fwd) a patch batch.  (c) --mode infer
   --case_id --pos at a lesion: the npz, B1 1, B2-fwd 10.  (d) --mode
   export served once on the card: 10 B2-fwd a request.  (e) card vs CPU
   in float32 within 1e-4: the full-width forward at 2 x 128^2, a
   GUNet_IIN_TINY train step (loss, gradients, parameters after 3 Momentum
   steps) and run_patch's per-case metrics of a seeded GUNet_IIN_TINY.
   (f) B1 at nf2's shapes, card vs the plain version on the CPU within
   1e-6: the train preprocess of one full-width raw IinSampler batch (8 x
   256^2, K = 1, the same draws on both sides) with three sp_on = 0 rows,
   all zeros on the card; and render_guides of a 64^2 run_patch batch whose
   boxes differ in size.  B1's ``max_abs_err`` covers (f).
23. DenseUNet and GUNet's --use_se / VGG contexts — (a) ``003_denseunet.sh
   train`` through the CLI at full width (DenseUNet.yml: DenseNet-161
   encoder, batch norm only; batch 8, 256^2 x 3, bf16, one host worker):
   16 steps with the online eval at 8 and 16, a resume to 32 at
   --steps_per_dispatch 16, every kernel count 0; the step in steady state
   at K = 1 and 16 (ms/step, slices/s, busy share, host launches a step,
   the share of the bf16 peak) with the peak device memory.  (b) One
   train-mode forward and backward at full width (2 x 128^2) in float32 on
   the card and the CPU, in float64 on the CPU, the CPU's keep masks
   replayed: loss and running statistics within 1e-4 of the CPU's, the
   card's gradients at most twice as far from the float64 ones as the CPU
   float32 gradients.  (c) ``003_denseunet.sh eval`` (s/case), per-case
   metrics card vs CPU (1e-3) and device_case probabilities (1e-4) in
   float32, cli/eval_all_ckpt (s/checkpoint), the export served (3
   requests) against the eager model (one bf16 step); no kernel launches.  (d)
   ``002_gnet_sp.sh train --use_se`` (GUNet.yml): 8 steps with exactly one
   B1, 10 B2-fwd and 10 B2f launches a step, the step in steady state
   with B1 / B2 device ms per step against their bounds, a GUNet_TINY
   --use_se step card vs CPU (1e-4).  (e) GUNet.yml with each 1-D VGG
   context: one forward at 2 x 128^2 in float32, card vs CPU within 1e-4.
24. data parallel — two ranks of a gloo group sharing cuda:0 (spawned by
   ``boxsegliver_torch.parallel.launch`` after the kernels were built)
   against one process over the same global batches, every run in float32
   with TF32 off: (a) ``001_dist.sh train`` flags (UNet.yml full width,
   batch norm synchronized over the ranks, per-rank batch 8, global 16,
   --device_cache, numerical weights 0.2 / 0.4 / 4.4; Momentum): the
   global batch's gradient (relative L2 within 1e-4), 3 steps' losses
   (1e-4 relative), parameters (1e-4) and running statistics (1e-5), every
   rank equal to rank 0, no B1 / B2 launch; (b) the same with the
   flagship's ``002_gnet_sp.sh`` flags (GUNet.yml, instance norm) at
   --steps_per_dispatch 3, run eagerly under gloo, each rank's B1 / B2
   launches equal to one process's; both print ms/step and the share of
   the step in the collectives, labelled as a correctness run of ranks
   sharing one card, not a scaling figure; (c) ``run`` (phase 10's UNet)
   and ``run_sp`` (phase 19c's UNetInter) with each slice batch split over
   the ranks: per-case metrics within 1e-6, rank 0 alone scoring; (d) the
   click eval's DeviceRefiner2D with gaussian and geodesic guides: equal
   clicks and rounds, Dice within 1e-5, B1 / G1 launches a rank = rounds;
   (e) a 1-rank NCCL group on cuda:0: 32 flagship steps as two K = 16
   graph replays with the gradient all-reduce captured, parameters within
   1e-6 of (or bit-equal to) the groupless run, ms/step of both; (f) with
   two or more cards, ``001_dist.sh train`` through the CLI over NCCL
   (otherwise printed as not run).
25. spatial sharding — (a) the split B2 forward on the card: B2s
   (in_relu_fwd_partial, the per-plane partial sums) over the two halves of
   a plane, their sums, then B2y (in_relu_fwd_apply) on each half, at the
   sweep's level 0 ([8, 64, 256, 256], halves [8, 64, 128, 256]), the 3-D
   eval's level 0 ([1, 30, 24, 256^2], halves of 12 planes) and the sweep's
   16^2 level, bf16: each against its plain version, the halves' y against
   B2-fwd's unsharded y (b2_check's bar), device time per launch
   (graph_ms), wrapper, plain, torch.var_mean beside B2s, and the bytes
   bound.  (b) run_g at the 002_gnet_sp.sh eval flags (GUNet.yml, 256^2 x
   3, mirror TTA, --device_sweep on) in float32 on GUNet.yml's seeded init
   with a Liver margin, two gloo ranks sharing the card (each 128 rows of
   every image) against one process: merged probabilities within 1e-4,
   the same objects, every rank equal, classes equal except at near-ties
   (top two within 1e-4), per-case metrics within 1e-6 where no class
   flipped; s/case, halo exchanges and all-reduces per forward and their
   share of the step (timed between synchronizations), exact B1 / B2s /
   B2y launches.  (c) the whole-volume nf_3d eval with --z_shards 2 on
   phase 21's best in float32, ret pred and prob, held as (b); s/case.
   (d) with two or more cards, both CLIs over NCCL (otherwise printed as
   not run).
Then one JSON line with every kernel's numbers (launches: the train run of
phase 8 for B1 and B2's and B3's NHWC plans, UNet3D's train run of phase
21b for B2's NCHW plans (B2-fwd, B2f, B2a and B2b), the train run of phase
8 for B3's NCHW plans (0: no model path takes them since GUNet went
channels-last), the device refiner's geodesic run of phase 20 for G1, and per
path in ``launches_by_path``: the device sweep of phase 5,
the train run of phase 8, the overflow run of phase 13, the K = 16 train
run of phase 14, the 20 GUNet requests of phase 17, the annotator's
preview and two Predicts of phase 18, phase 19's nf_train, nf_eval,
nf_inter_train, nf_inter_eval and run_sp, phase 20's click evals, new
models' training and click serving, phase 21's UNet3D paths with the
checkpoint sweep, phase 22's nf2 train, run_patch (mirror TTA and
plain), infer --pos and serving, phase 23's DenseUNet train, eval,
checkpoint sweep and serving and the --use_se train, and phase 24's rank 0
of the 001_dist and G-Net trains, run, run_sp and the two refiners, and
the 1-rank NCCL group's K = 16 replays, and phase 25's rank 0 of the
sharded run_g and 3-D evals (B2s and B2y count the sharded run_g's
launches); B2's
``unet3d`` holds phase 21a's numbers per UNet3D train step and at the eval's
level 0, B2f's ``backward`` the whole backward per flagship, NF and UNet3D
step (chosen plans, the first design and the bound); ``ms``: wrapper
time, per call for B1 and G1 and summed over one
train step's calls for B2; ``device_ms``: device time per launch, for B2
averaged over one train step's launches; ``wrapper_ms``: wrapper time per
call), the card's name and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32 non-tensor
# arithmetic, used for the bounds of kernels B1 and B2
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# dense bf16 tensor-core peak of the H100 SXM (NVIDIA data sheet), for the
# share of peak of the UNet train step (phase 11)
BF16_FLOPS_PER_S = 989e12
# the least float work of B1's function: max_k exp(-e_k) = exp(-min_k e_k)
# takes one exp per pixel; e_k = ey_k(row) + ex_k(col) is separable, so each
# (row or column, valid object) costs 3 ops (sub, square, scale) and each
# (pixel, valid object) 2 (add, min); each pixel adds 5 (negate, clip low
# and high, scale, offset) to its exp
B1_OPS_PER_TERM = 2
B1_OPS_PER_LINE = 3
B1_OPS_PER_PIXEL = 5
# special-function units (MUFU: ex2 of expf) per SM per clock on Hopper; with
# the SM count and nvidia-smi's clocks.max.sm they give B1's exp rate
SFU_PER_SM_PER_CLOCK = 16
# bytes of fresh inputs a device-time loop cycles through: twice the 50 MB
# L2, so launches read device memory, as the bounds assume
COLD_BYTES = 100 * 2 ** 20
# float operations per element of B2: fwd = 3 (sum, square, sum) + 2
# (x − mean, · rstd) + 2 (·γ, + β) + 1 (max); B2a = 2 (affine) + 1 (select)
# + 3 (two sums, one product); B2b = 2 + 1 + 4 (two subtractions, two
# products); B2f, the backward as one function = 2 + 1 + 3 + 4
B2_OPS = {"in_relu_fwd": 8, "in_relu_bwd": 10, "in_relu_bwd_stats": 6,
          "in_relu_bwd_apply": 7}
# the instance-norm + ReLU pairs of one flagship train step (batch 8, 256^2,
# init_channels 64): Encode1_conv{1,2} and up_conv1_{1,2} at 64 channels,
# up_conv{2,3,4}_{1,2} below
B2_STEP_SHAPES = {(8, 64, 256, 256): 4, (8, 128, 128, 128): 2,
                  (8, 256, 64, 64): 2, (8, 512, 32, 32): 2}
# the pairs of one nf / nf_inter train step (UNet.yml and UNetInter.yml at
# batch 16, 256^2, init_channels 64, 4 down-samples): at each level l < 4
# two encoder and two decoder convs, at l = 4 the two bridge / deepest ones
NF_B2_STEP_SHAPES = {(16, 64, 256, 256): 4, (16, 128, 128, 128): 4,
                     (16, 256, 64, 64): 4, (16, 512, 32, 32): 4,
                     (16, 1024, 16, 16): 2}


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def max_sm_mhz() -> float:
    """nvidia-smi's clocks.max.sm of card 0."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(out.stdout.strip().splitlines()[0])


def sfu_per_s() -> float:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SFU_PER_SM_PER_CLOCK * sms * max_sm_mhz() * 1e6


def cuda_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Wrapper time per call: back-to-back calls timed with CUDA events.
    Where a call's host path outlasts its kernel this reads the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(call, n_inputs: int, iters: int, replays: int = 5) -> float:
    """Device time per launch: ``iters`` calls ``call(i % n_inputs)``
    captured into one CUDA graph, whose replays are timed with CUDA events,
    so no host time falls between the launches.  Every call's outputs are
    kept, so each launch writes fresh memory, and the inputs cycle over
    ``n_inputs`` sets (COLD_BYTES in all) so that reads miss the L2."""
    for i in range(min(n_inputs, 2)):
        call(i)                                   # warm-up outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    keep = []
    with torch.cuda.graph(graph):
        for i in range(iters):
            keep.append(call(i % n_inputs))
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph, keep
    return ms


# ---------------------------------------------------------------------------
# phase 3: kernel B1 against its plain version
# ---------------------------------------------------------------------------

def guide_inputs(rng, bs, k, h, w, dev, n_valid=None, off_image=False):
    centers = rng.uniform(0, max(h, w), (bs, k, 2)).astype(np.float32)
    if off_image:
        centers[:, ::2] = rng.uniform(-40, -1, (bs, len(range(0, k, 2)), 2))
        centers[:, 1::2] = rng.uniform(h, h + 40, (bs, len(range(1, k, 2)), 2))
    stds = rng.uniform(2.0, 24.0, (bs, k, 2)).astype(np.float32)
    valid = rng.random((bs, k)) < 0.5                   # not a prefix
    if n_valid is not None:
        valid = np.arange(k)[None] < np.asarray(n_valid)[:, None]
    return (torch.from_numpy(centers).to(dev), torch.from_numpy(stds).to(dev),
            torch.from_numpy(valid).to(dev))


def b1_bound_ms(c, s, v, h, w, sfu):
    """(bound ms, "bytes" | "operations", how) of B1 on these inputs: the
    inputs read and the [bs, h, w] float32 output written once against
    HBM_BYTES_PER_S, and the least float work (B1_OPS_*, over the valid
    objects of this run) against FP32_OPS_PER_S beside one exp per pixel
    against the SFU rate."""
    bs = c.shape[0]
    n_valid = int(v.sum())
    bytes_moved = (c.numel() + s.numel()) * 4 + v.numel() + bs * h * w * 4
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    n_exp = bs * h * w
    ops = (B1_OPS_PER_TERM * h * w * n_valid
           + B1_OPS_PER_LINE * (h + w) * n_valid + B1_OPS_PER_PIXEL * n_exp)
    t_ops = max(ops / FP32_OPS_PER_S, n_exp / sfu) * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    why = (f"{bytes_moved} B -> {t_bytes:.6f} ms; {n_exp} exp at "
           f"{sfu:.4g}/s, {ops} f32 ops -> {t_ops:.6f} ms")
    return max(t_bytes, t_ops), by, why


def kernel_phase(dev, seed):
    from boxsegliver_torch.ops import kernels

    rng = np.random.default_rng(seed)
    h = w = 256
    cases = {
        "sweep K=20": guide_inputs(rng, 2, 20, h, w, dev),
        "sweep K=48": guide_inputs(rng, 2, 48, h, w, dev),
        "all-invalid sample": guide_inputs(rng, 2, 20, h, w, dev,
                                           n_valid=[0, 20]),
        "off-image centers": guide_inputs(rng, 2, 20, h, w, dev,
                                          off_image=True),
    }
    c, s, v = guide_inputs(rng, 2, 20, h, w, dev)
    cases["sigma at min_std"] = (c, torch.full_like(s, 2.0), v)
    # odd sizes: W not a multiple of 4, one row, several chunks of objects
    odd = {"W=255": (256, 255, guide_inputs(rng, 2, 20, 256, 255, dev)),
           "H=1": (1, 256, guide_inputs(rng, 3, 7, 1, 256, dev)),
           "K=0": (64, 64, guide_inputs(rng, 2, 0, 64, 64, dev)),
           "K=1": (64, 64, guide_inputs(rng, 2, 1, 64, 64, dev, n_valid=[1, 1])),
           "K=150 all valid": (96, 80, guide_inputs(rng, 2, 150, 96, 80, dev,
                                                    n_valid=[150, 150]))}
    worst = 0.0
    for name, (c, s, v) in list(cases.items()) + [
            (n, t) for n, (_, _, t) in odd.items()]:
        hh, ww = odd[name][:2] if name in odd else (h, w)
        for scale, offset in ((1.0, 0.0), (0.85 / 2.0, 0.5)):
            out = kernels.gaussian_guide_batch(c, s, v, height=hh, width=ww,
                                               scale=scale, offset=offset)
            ref = kernels.gaussian_guide_batch_plain(
                c, s, v, height=hh, width=ww, scale=scale, offset=offset)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            worst = max(worst, err)
            print(f"  B1 {name:20s} scale={scale:<6} max_abs_err={err:.3e}")
            if not err <= 1e-6:
                raise AssertionError(f"B1 disagrees with plain on {name}: "
                                     f"{err}")
            if name == "all-invalid sample" and float(out[0].max()) != offset:
                raise AssertionError("B1: an all-invalid sample must render "
                                     "the flat offset")

    # the nf_inter step's one launch (phase 19): fg and bg click guides of
    # a batch of 16 as 32 rows, K = --max_clicks 8, a valid prefix, stddev
    # --stddev 5 / rescale (crop / target in [1, 1.4]), no epilogue
    clicks = guide_inputs(rng, 32, 8, h, w, dev,
                          n_valid=rng.integers(0, 9, 32))
    rescale = rng.uniform(1.0, 1.4, (32, 1, 2)).astype(np.float32)
    clicks = (clicks[0], torch.from_numpy(np.broadcast_to(
        5.0 / rescale, (32, 8, 2)).copy()).to(dev), clicks[2])
    out = kernels.gaussian_guide_batch(*clicks, height=h, width=w)
    ref = kernels.gaussian_guide_batch_plain(*clicks, height=h, width=w)
    err = float((out - ref).abs().max())
    worst = max(worst, err)
    print(f"  B1 {'clicks 32x8 (nf_inter)':20s} scale=1.0    "
          f"max_abs_err={err:.3e}")
    if not err <= 1e-6:
        raise AssertionError(f"B1 disagrees with plain on the click "
                             f"guides: {err}")

    # timing at the main path's shapes: the sweep's (bs 2 directions, 256^2,
    # K = 20: 4 user-prior slots + 16 propagated slots, sweep epilogue), the
    # train preprocess's (batch 8, max_objs 8, a valid prefix) and the
    # nf_inter click guides'
    shapes = {"sweep": cases["sweep K=20"],
              "train": guide_inputs(rng, 8, 8, h, w, dev,
                                    n_valid=rng.integers(0, 9, 8)),
              "clicks (nf_inter)": clicks}
    sfu = sfu_per_s()
    rec = None
    for shape_name, (c, s, v) in shapes.items():
        ep = ((1.0, 0.0) if shape_name.startswith("clicks")
              else (0.425, 0.5))

        def run_kernel(i=0, c=c, s=s, v=v, ep=ep):
            return kernels.gaussian_guide_batch(c, s, v, height=h, width=w,
                                                scale=ep[0], offset=ep[1])

        def run_plain(c=c, s=s, v=v, ep=ep):
            kernels.gaussian_guide_batch_plain(c, s, v, height=h, width=w,
                                               scale=ep[0], offset=ep[1])

        # plain, kernel, kernel, plain: compare within one call, in turns
        p1 = cuda_ms(run_plain)
        k1 = cuda_ms(run_kernel)
        d1 = graph_ms(run_kernel, 1, iters=200)
        d2 = graph_ms(run_kernel, 1, iters=200)
        k2 = cuda_ms(run_kernel)
        p2 = cuda_ms(run_plain)
        bs, k = c.shape[:2]
        bound, by, why = b1_bound_ms(c, s, v, h, w, sfu)
        row = {"name": "gaussian_guide_batch", "route": "cuda",
               "source": "boxsegliver_torch/csrc/guide_render.cu",
               "replaces": "boxsegliver_tpu/ops/pallas_kernels.py:263",
               "max_abs_err": worst, "ms": min(k1, k2),
               "device_ms": min(d1, d2), "wrapper_ms": min(k1, k2),
               "plain_ms": min(p1, p2), "bound_ms": bound, "bound_by": by,
               "library_ms": None}
        print(f"  B1 {shape_name} bs={bs} K={k} {h}x{w} ({int(v.sum())} "
              f"valid objects): device {d1:.5f}/{d2:.5f} ms per launch, "
              f"wrapper {k1:.4f}/{k2:.4f} ms per call, plain "
              f"{p1:.4f}/{p2:.4f} ms, bound {bound:.6f} ms ({by}: {why}; "
              f"{bound / min(d1, d2):.1%} of bound); {smi()}")
        rec = rec or row                          # the sweep's row is kept
    return rec


# ---------------------------------------------------------------------------
# phase 4: labeling against scipy / numpy
# ---------------------------------------------------------------------------

def spiral(h, w):
    """One 1-pixel-wide square spiral (a single 4-connected component)."""
    m = np.zeros((h, w), bool)
    top, left, bottom, right = 0, 0, h - 1, w - 1
    while top <= bottom and left <= right:
        m[top, left:right + 1] = True
        m[top:bottom + 1, right] = True
        if bottom - top < 2 or right - left < 2:
            break
        m[bottom, left:right + 1] = True
        m[top + 2:bottom + 1, left] = True
        top, left, bottom, right = top + 2, left + 2, bottom - 2, right - 2
        m[top - 1, left - 1] = False
        m[top, left - 1] = True
    return m


def labeling_phase(ds, dev):
    from scipy import ndimage as ndi

    from boxsegliver_torch.data.meta import load_meta
    from boxsegliver_torch.ops import array_kits
    from boxsegliver_torch.ops.labeling import (label_components,
                                                object_moments, ordered_seeds)

    masks = []
    for m in load_meta(ds):
        seg = np.load(Path(ds) / f"volume-{m['PID']}" / "segmentation.npy")
        masks += [sl == 2 for sl in seg if (sl == 2).any()]
    h, w = masks[0].shape
    # extra masks: many small components, and one long spiral that needs
    # many propagation passes
    rng = np.random.default_rng(1)
    masks += list(rng.random((2, h, w)) < 0.3) + [spiral(h, w)]
    masks = np.stack(masks)
    k = 64
    t0 = time.perf_counter()
    mt = torch.from_numpy(masks).to(dev)
    labels = label_components(mt)
    seeds, n = ordered_seeds(labels, k)
    n_cmp = 0
    for i, mask in enumerate(masks):
        ref, n_ref = ndi.label(mask)
        if int(n[i]) != n_ref:
            raise AssertionError(f"labeling: {int(n[i])} components, scipy "
                                 f"{n_ref}")
        lab = labels[i].cpu().numpy()
        sd = seeds[i].cpu().numpy()[:min(n_ref, k)]
        # first-raster-pixel labels in ndi.label order
        relabel = np.zeros(mask.size + 1, np.int64)
        relabel[sd] = np.arange(1, len(sd) + 1)
        if n_ref <= k and not np.array_equal(relabel[lab], ref):
            raise AssertionError(f"labeling: mask {i} labels differ")
        kk = min(n_ref, k)
        obj = labels[i][None] == seeds[i][:kk, None, None]
        cen, std = object_moments(obj, min_std=2.0)
        cen, std = cen.cpu().numpy(), std.cpu().numpy()
        for j in range(kk):
            c_ref, s_ref = array_kits.compute_robust_moments(
                ref == j + 1, indexing="ij", min_std=2.0)
            if not (np.array_equal(cen[j], c_ref)
                    and np.array_equal(std[j], s_ref)):
                raise AssertionError(f"moments of mask {i} object {j}: "
                                     f"{cen[j]} {std[j]} vs {c_ref} {s_ref}")
        n_cmp += kk
    torch.cuda.synchronize()
    print(f"  labeling: {len(masks)} masks {masks.shape[1:]}, {n_cmp} objects "
          f"equal to scipy / numpy ({time.perf_counter() - t0:.2f} s)")


# ---------------------------------------------------------------------------
# phase 5: the flagship guided eval through the CLI
# ---------------------------------------------------------------------------

FLAGS = ["liver", "--mode", "eval", "--tag", "chip_smoke", "--model", "GUNet",
         "--classes", "Liver", "Tumor", "--im_height", "256",
         "--im_width", "256", "--im_channel", "3", "--random_flip", "3",
         "--normalizer", "instance_norm", "--use_context", "--context_list",
         "hist", "200", "--use_spatial", "--min_std", "2", "--metrics_eval",
         "Dice", "VOE", "RVD", "--primary_metric", "Tumor/Dice",
         "--batch_size", "8", "--eval_mirror"]


def liver_margin_weights(model, seed):
    """Seeded flax-style init; the head's kernel scaled by 1e-3 and a Liver
    bias margin of 8 logits."""
    model.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.AdjustChannels.weight.mul_(1e-3)
        model.AdjustChannels.bias.copy_(torch.tensor([0.0, 8.0, 0.0]))
    return model


def expected_all_liver(ds, metas):
    """Metrics of a prediction that is Liver on every voxel of each crop:
    the largest liver component is the whole crop box."""
    from boxsegliver_torch.evaluators.eval_loader import aligned_bbox

    dice = []
    for m in metas:
        z1, z2, y1, y2, x1, x2 = aligned_bbox(m)
        seg = np.load(Path(ds) / f"volume-{m['PID']}" / "segmentation.npy")
        liver = np.count_nonzero(seg[z1:z2, y1:y2, x1:x2])
        box = (z2 - z1) * (y2 - y1) * (x2 - x1)
        dice.append(2.0 * liver / (box + liver))
    return float(np.mean(dice))


def slice_phase(tmp, ds, dev, seed):
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.data.kfold import read_or_create_k_folds, \
        train_test_split
    from boxsegliver_torch.data.meta import load_meta
    from boxsegliver_torch.evaluators.eval_loader import aligned_bbox
    from boxsegliver_torch.interactive.device_sweep import (_DEPTH_BUCKETS,
                                                            _bucket)
    from boxsegliver_torch.models import MODEL_CONFIGS, build_model
    from boxsegliver_torch.ops import kernels

    args = cli.get_args(FLAGS + ["--model_dir", str(Path(tmp) / "md")])
    model = build_model("GUNet", args=args,
                        model_kwargs=MODEL_CONFIGS["GUNet.yml"])
    n_params = sum(p.numel() for p in model.parameters())
    weights = Path(tmp) / "gunet_seed.pt"
    torch.save(liver_margin_weights(model, seed).state_dict(), weights)
    print(f"  full-width GUNet: {n_params} parameters, weights {weights.name}")

    metas = load_meta(ds)
    folds = read_or_create_k_folds(Path(ds) / "k_folds.txt", [])
    test_metas = [m for m in metas
                  if str(m["PID"]) in train_test_split(folds, 0)[1]]
    depths = [aligned_bbox(m)[1] - aligned_bbox(m)[0] for m in test_metas]
    steps = sum(max(_bucket(d, _DEPTH_BUCKETS), d) for d in depths)

    argv = FLAGS + ["--data_root", str(tmp), "--dataset", "ds",
                    "--k_folds", "2", "--test_fold", "0",
                    "--model_dir", str(Path(tmp) / "model_dir"),
                    "--ckpt_path", str(weights)]
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in kernels.KERNELS.items()}

    print("  run_g results: " + json.dumps(results))
    if not all(math.isfinite(v) for v in results.values()):
        raise AssertionError(f"non-finite metrics: {results}")
    if launches["gaussian_guide_batch"] < steps:
        raise AssertionError(f"B1 launched {launches['gaussian_guide_batch']}"
                             f" times for {steps} sweep steps")
    expect_b3_forwards("run_g (device sweep)", launches)
    want = expected_all_liver(ds, test_metas)
    if abs(results["Liver/Dice"] - want) > 1e-9 or results["Tumor/Dice"]:
        raise AssertionError(f"Liver/Dice {results['Liver/Dice']} (expected "
                             f"{want}), Tumor/Dice {results['Tumor/Dice']}")
    n_cases = len(test_metas)
    print(f"  slice: {n_cases} cases, {sum(depths)} slices, {steps} sweep "
          f"steps (x 8 images of 256^2), launches {launches} (B2-fwd and "
          f"B3-fwd run in every GUNet forward of the sweep)")
    print(f"  slice: {seconds / n_cases:.3f} s/case, "
          f"{sum(depths) / seconds:.2f} slices/s, "
          f"{steps / seconds:.2f} sweep steps/s on {smi()}")
    return launches


def fit_tiny_gunet(args, case, dev, seed, steps=200):
    """A small spatial GUNet (init 4, 2 down-samples) fitted for ``steps``
    Adam steps to one case's labels at 64^2, with each slice's GT-tumor
    guide, so that its predictions are tumor components the sweep
    propagates (a random init speckles hundreds of them per slice)."""
    import torch.nn.functional as F

    from boxsegliver_torch.evaluators.device_eval import _resize_stack
    from boxsegliver_torch.models import build_model
    from boxsegliver_torch.ops import array_kits
    from boxsegliver_torch.ops.image_ops import resize_nearest
    from boxsegliver_torch.ops.kernels import gaussian_guide_batch_plain

    size = (args.im_height, args.im_width)
    vol = _resize_stack(case.volume, size)
    seg = resize_nearest(torch.from_numpy(np.array(case.segmentation)),
                         size).numpy()
    guides = torch.full((case.depth,) + size + (1,), 0.5)
    for z in range(case.depth):
        if (seg[z] == 2).any():
            c, s = array_kits.compute_robust_moments(seg[z] == 2, min_std=2.0)
            guides[z] = gaussian_guide_batch_plain(
                torch.from_numpy(c)[None, None], torch.from_numpy(s)[None, None],
                torch.ones((1, 1), dtype=torch.bool), height=size[0],
                width=size[1], scale=0.425, offset=0.5)[0]
    feats = {"images": torch.stack([vol[z:z + 3].permute(1, 2, 0)
                                    for z in range(case.depth)]).to(dev),
             "sp_guide": guides.to(dev)}
    labels = torch.from_numpy(seg.astype(np.int64)).to(dev)
    model = build_model("GUNet", args=args, dtype=torch.float32,
                        model_kwargs={"init_channels": 4,
                                      "num_down_samples": 2,
                                      "mod_layers": [1, 2]})
    model.reset_parameters(torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    for _ in range(steps):
        loss = F.cross_entropy(model(feats).permute(0, 3, 1, 2), labels)
        opt.zero_grad()
        loss.backward()
        opt.step()
    return model.eval(), float(loss.detach())


def sweep_card_vs_cpu(ds, dev, seed):
    """The whole sweep on the card (B1, CUDA tensors) against the same
    sweep on the CPU (plain versions, held against the JAX package by
    tests/test_torch_sweep.py), float32 without TF32, at 64^2, with a model
    that predicts tumors, so real components are labeled, filtered and
    propagated on both."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.data.meta import load_meta
    from boxsegliver_torch.evaluators.eval_loader import parse_case_eval
    from boxsegliver_torch.interactive.device_sweep import GuidedSweepPredictor

    no_context = (FLAGS[:FLAGS.index("--use_context")]
                  + FLAGS[FLAGS.index("--use_spatial"):])
    args = cli.get_args(no_context + [
        "--im_height", "64", "--im_width", "64", "--compute_dtype", "float32",
        "--sweep_max_objects", "64", "--model_dir", str(Path(ds) / "md")])
    prior = json.loads((Path(ds) / "prior.json").read_text())
    cases = [parse_case_eval(m, ds, im_channel=3) for m in load_meta(ds)[:2]]
    model, loss = fit_tiny_gunet(args, cases[0], dev, seed)
    for case in cases:
        out = []
        for d in (dev, torch.device("cpu")):
            pred = GuidedSweepPredictor(model, args, num_classes=3,
                                        tumor_id=2, device=d)
            out.append(pred.sweep_case(case, prior[str(case.pid)], None))
        if out[0][0] is None or out[1][0] is None:
            raise AssertionError(f"sweep overflow: n_objs {out[0][1]} / "
                                 f"{out[1][1]}")
        err = float(np.abs(out[0][0] - out[1][0]).max())
        tumor = int((out[1][0].argmax(-1) == 2).sum())
        print(f"  sweep card vs CPU, case {case.pid} at 64^2 float32 (fit loss "
              f"{loss:.3f}): max abs err {err:.2e}, n_objs {out[0][1]} / "
              f"{out[1][1]}, {tumor} tumor pixels propagated")
        if not err <= 1e-4 or out[0][1] != out[1][1]:
            raise AssertionError("sweep on the card disagrees with the CPU")
        if case is cases[0] and not tumor:
            raise AssertionError("the fitted model propagated no tumor")


# ---------------------------------------------------------------------------
# phase 6: profile of the guided sweep
# ---------------------------------------------------------------------------

def kernel_groups(prof):
    """Device time by kernel group from a torch.profiler run (phases 6, 9
    and 11).  cuDNN's NCHW <-> NHWC layout transposes sit in the cudnn
    namespace and count with the convolutions."""
    from torch.autograd import DeviceType

    def self_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and self_us(e) > 0]
    kern.sort(key=self_us, reverse=True)
    groups = {"convolutions (cuDNN / CUTLASS)": 0.0,
              "batch norm (fwd, bwd)": 0.0,
              "B2 in_relu (fwd, bwd, bwd_stats, bwd_apply)": 0.0,
              "B3 modnorm_relu (fwd, bwd)": 0.0,
              "B1 guide_render": 0.0,
              "optimizer (multi-tensor foreach)": 0.0,
              "memcpy / memset": 0.0,
              "other elementwise, reductions, copies, gathers": 0.0}
    for e in kern:
        name = e.key.lower()
        if "in_relu" in name:
            key = "B2 in_relu (fwd, bwd, bwd_stats, bwd_apply)"
        elif "modnorm_relu" in name:
            key = "B3 modnorm_relu (fwd, bwd)"
        elif "guide_render" in name:
            key = "B1 guide_render"
        elif "batch_norm" in name or "::bn_" in name:
            key = "batch norm (fwd, bwd)"
        elif any(t in name for t in ("xmma", "cutlass", "convolve", "gemm",
                                     "conv2d", "dgrad", "wgrad", "cudnn")):
            key = "convolutions (cuDNN / CUTLASS)"
        elif "multi_tensor" in name or "foreach" in name:
            key = "optimizer (multi-tensor foreach)"
        elif name.startswith("memcpy") or name.startswith("memset"):
            key = "memcpy / memset"
        else:
            key = "other elementwise, reductions, copies, gathers"
        groups[key] += self_us(e)
    return kern, groups, self_us


def profile_sweep(tmp, ds):
    """Steady-state time of one case's double sweep, the full-width forward
    alone, and the card's kernel time by group and by name from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.data.meta import load_meta
    from boxsegliver_torch.evaluators.eval_loader import (load_eval_context,
                                                          parse_case_eval)
    from boxsegliver_torch.interactive.device_sweep import GuidedSweepPredictor

    args = cli.get_args(FLAGS + ["--model_dir", str(Path(tmp) / "md"),
                                 "--ckpt_path",
                                 str(Path(tmp) / "gunet_seed.pt")])
    model = cli.build_model_from_args(args, torch.device("cuda"))
    pred = GuidedSweepPredictor(model, args, num_classes=3, tumor_id=2,
                                device="cuda")
    meta = load_meta(ds)[0]
    case = parse_case_eval(meta, ds, im_channel=3)
    ctx = load_eval_context(ds, case.pid, [("hist", 200)], 20.0)
    prior = json.loads((Path(ds) / "prior.json").read_text())[str(case.pid)]

    def one_case():
        pred.sweep_case(case, prior, ctx)
        torch.cuda.synchronize()

    one_case()                                            # warm-up
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        steps0 = pred.steps
        one_case()
        walls.append(time.perf_counter() - t0)
    steps = pred.steps - steps0
    feats = {"images": torch.rand(8, 256, 256, 3, device="cuda"),
             "sp_guide": torch.rand(8, 256, 256, 1, device="cuda"),
             "context": torch.rand(8, 200, device="cuda")}
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(feats), iters=20, warmup=3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_case()
        prof_wall = time.perf_counter() - t0

    kern, groups, self_us = kernel_groups(prof)
    busy_ms = sum(groups.values()) / 1e3
    share = max(busy_ms, 1e-9)
    b1 = next((e for e in kern if "guide_render" in e.key), None)
    wall = min(walls)
    lines = [
        f"card: {smi()}",
        f"case {case.pid}: {case.depth} slices, {steps} sweep steps of "
        f"2 directions x 4 mirrors x 256^2",
        f"wall per case, unprofiled (3 runs): "
        + ", ".join(f"{w:.4f}" for w in walls) + " s",
        f"wall per step: {wall / steps * 1e3:.3f} ms; full-width GUNet "
        f"forward at batch 8 alone (CUDA events): {fwd_ms:.3f} ms",
        f"kernel time of the profiled case: {busy_ms:.3f} ms "
        f"({busy_ms / steps:.3f} ms/step) -> busy {busy_ms / 1e3 / wall:.1%}"
        f" of the unprofiled wall, {busy_ms / 1e3 / prof_wall:.1%} of the "
        f"profiled wall ({prof_wall:.4f} s)",
        "B1 device time: " + (
            f"{self_us(b1) / b1.count:.2f} us per launch ({b1.count} "
            f"launches)" if b1 is not None else "no guide_render events"),
        ""] + [f"{k:50s} {v / 1e3:9.3f} ms {v / 1e3 / share:7.1%}"
               for k, v in groups.items()] + [
        "",
        f"{'kernel':90s} {'calls':>7s} {'total ms':>10s} {'share':>7s}"]
    for e in kern[:20]:
        lines.append(f"{e.key[:90]:90s} {e.count:7d} "
                     f"{self_us(e) / 1e3:10.3f} "
                     f"{self_us(e) / 1e3 / share:7.1%}")
    print("\n".join("  " + ln for ln in lines))


# ---------------------------------------------------------------------------
# phase 7: kernel B2 against its plain version
# ---------------------------------------------------------------------------

def b2_inputs(shape, dtype, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=gen, device=dev) * 2.0 + 0.3).to(dtype)
    g = torch.randn(shape, generator=gen, device=dev).to(dtype)
    w = torch.randn(c, generator=gen, device=dev) * 0.3 + 1.0
    b = torch.randn(c, generator=gen, device=dev) * 0.3
    return x, g, w, b


def b2_check(shape, dtype, dev, seed, unaligned=False):
    """B2-fwd, the backward on every plan of ``bwd_alternatives`` (B2f's
    fused plans, B2a + B2b split and the first design, splits = 1) and
    InstanceNormReLU's backward against their plain versions on the same
    inputs; returns the worst abs error per kernel (B2f: dx, s1, s2 of its
    fused plans; B2a: s1, s2 and B2b: dx of the split ones).
    ``unaligned``: B2-fwd reads x and the backward g from contiguous views
    at an odd element offset (B2-fwd's general path, the split backward).

    Tolerances: x̂ and y (fwd) and dx are rounded once to the output
    dtype: float32 within 1e-5 (the per-plane sums in another order, rsqrt
    within 2 ulp), bf16 within one bf16 rounding step, 2^-7 of the value,
    plus 1e-5.  rstd within 1e-5 relative.  s1, s2 and dγ, dβ are float32
    sums over H·W (and N): 1e-4 relative plus 1e-6·√count."""
    from boxsegliver_torch.ops import kernels

    x, g, w, b = b2_inputs(shape, dtype, dev, seed)
    planes, hw = shape[0] * shape[1], math.prod(shape[2:])

    def close(name, got, ref, rel, abs_):
        err = (got.float() - ref.float()).abs()
        bad = err > abs_ + rel * ref.float().abs()
        if bool(bad.any()):
            raise AssertionError(f"B2 {name} {tuple(shape)} {dtype}: "
                                 f"{int(bad.sum())} elements off, max abs "
                                 f"err {float(err.max()):.3e}")
        return float(err.max())

    def odd_view(t):
        flat = torch.empty(t.numel() + 1, dtype=dtype, device=dev)
        flat[1:] = t.flatten()
        return flat[1:].view(t.shape)

    out_tol = (2.0 ** -7, 1e-5) if dtype == torch.bfloat16 else (1e-5, 1e-5)
    sum_tol = lambda n: (1e-4, 1e-6 * math.sqrt(n))          # noqa: E731
    x_in, g_in = (odd_view(x), odd_view(g)) if unaligned else (x, g)
    y, xh, rstd = kernels.in_relu_fwd(x_in, w, b)
    y_p, xh_p, rstd_p = kernels.in_relu_fwd_plain(x, w, b)
    dx_p, s1_p, s2_p = kernels.in_relu_bwd_plain(g, xh_p, w, b, rstd_p)
    errs = dict.fromkeys(B2_KERNELS, 0.0)
    errs["in_relu_fwd"] = max(close("y", y, y_p, *out_tol),
                              close("x_hat", xh, xh_p, *out_tol),
                              close("rstd", rstd, rstd_p, 1e-5, 0.0))

    def bwd_errs(what, plan, dx, s1, s2, dx_r, s1_r, s2_r, n):
        # s1, s2: the plane sums, or dγ, dβ (sums over N too) of autograd
        fused = plan.path != kernels.BWD_SPLIT
        sums = "in_relu_bwd" if fused else "in_relu_bwd_stats"
        grad = "in_relu_bwd" if fused else "in_relu_bwd_apply"
        errs[sums] = max(errs[sums], close(f"s1 ({what})", s1, s1_r,
                                           *sum_tol(n)),
                         close(f"s2 ({what})", s2, s2_r, *sum_tol(n)))
        errs[grad] = max(errs[grad], close(f"dx ({what})", dx, dx_r,
                                           *out_tol))

    alts = bwd_alternatives(planes, hw, dtype, not unaligned)
    for what, plan in alts.items():
        dx, s1, s2 = kernels.instance_norm_relu_bwd(g_in, xh_p, w, b, rstd_p,
                                                    plan)
        if not (dx.dtype == dtype and s1.dtype == torch.float32):
            raise AssertionError("B2 backward output dtypes")
        bwd_errs(what, plan, dx, s1, s2, dx_p, s1_p, s2_p, hw)
    torch.cuda.synchronize()
    if not (y.dtype == xh.dtype == dtype and rstd.dtype == torch.float32):
        raise AssertionError("B2 output dtypes")
    # the autograd Function: B2-fwd, then the chosen backward, dγ = Σ_n s2,
    # dβ = Σ_n s1; held against the plain backward on the x̂ and rstd that
    # the Function's own forward saved (xr is an aligned copy of x: its
    # B2-fwd path, and so x̂ within one bf16 step, may differ from x_in's)
    xr = x_in.clone().requires_grad_(True)
    wr = w.clone().requires_grad_(True)
    br = b.clone().requires_grad_(True)
    dxa, dw, db = torch.autograd.grad(kernels.instance_norm_relu(xr, wr, br),
                                      (xr, wr, br), g_in)
    _, xh_a, rstd_a = kernels.in_relu_fwd(xr.detach(), w, b)
    dx_r, s1_r, s2_r = kernels.in_relu_bwd_plain(g, xh_a, w, b, rstd_a)
    bwd_errs("autograd", alts["chosen"], dxa, dw, db, dx_r, s2_r.sum(dim=0),
             s1_r.sum(dim=0), shape[0] * hw)
    return errs


def b2_plan_name(plan):
    """The backward's path in words: fused warp / fused staged xN / split
    (B2a splits, B2b CTAs a plane)."""
    from boxsegliver_torch.ops import kernels as K

    if plan.path == K.FWD_WARP:
        return f"fused warp ({plan.packs} packs a lane)"
    if plan.path == K.FWD_STAGED:
        return f"fused staged x{plan.cluster} ({plan.smem_bytes} B a CTA)"
    return f"split (B2a x{plan.splits}, B2b x{plan.apply_ctas})"


def bwd_alternatives(planes, hw, dtype, aligned=True):
    """The backward's plans checked and timed at one shape: the chosen one
    (in_relu_bwd_plan), the split plan, the first design ("pair": B2a and
    B2b at one CTA a plane, splits = 1) and, for a fused staged plan, twice
    and half its cluster where those fit; for a fused warp plan, one staged
    CTA a plane."""
    from boxsegliver_torch.ops import kernels as K

    plan = K.in_relu_bwd_plan(planes, hw, dtype, aligned)
    alts = {"chosen": plan}
    for name, p in (("split", K.in_relu_bwd_split_plan(planes, hw, dtype,
                                                        aligned)),
                    ("pair", K.in_relu_bwd_split_plan(planes, hw, dtype,
                                                       aligned, False))):
        if p != plan:
            alts[name] = p
    esize = torch.finfo(dtype).bits // 8
    per = 16 // esize
    if plan.path == K.FWD_STAGED:
        for cs in (2 * plan.cluster, plan.cluster // 2):
            if 1 <= cs <= 8 and hw % (cs * per) == 0 and (
                    2 * (hw // cs) * esize <= K._BWD_STAGE_MAX):
                alts[f"staged x{cs}"] = plan._replace(
                    grid=planes * cs, cluster=cs,
                    smem_bytes=2 * (hw // cs) * esize)
    if plan.path == K.FWD_WARP and 2 * hw * esize <= K._BWD_STAGE_MAX:
        alts["staged x1"] = plan._replace(path=K.FWD_STAGED, grid=planes,
                                          packs=0, smem_bytes=2 * hw * esize)
    return alts


def b2_train_counts(shapes, steps, fwd=0):
    """Exact B2 launches of ``steps`` train steps over ``shapes`` ({[N, C,
    *S]: calls a step}, bf16) and ``fwd`` forwards more: one B2-fwd a call
    and forward; the backward's kernels from in_relu_bwd_plan: one B2f a
    fused call, one B2a and one B2b a split one.  B2a + B2f = blocks x
    steps."""
    from boxsegliver_torch.ops import kernels as K

    calls = sum(shapes.values())
    out = {"in_relu_fwd": calls * (steps + fwd), "in_relu_bwd": 0,
           "in_relu_bwd_stats": 0, "in_relu_bwd_apply": 0}
    for shape, k in shapes.items():
        plan = K.in_relu_bwd_plan(shape[0] * shape[1], math.prod(shape[2:]),
                                  torch.bfloat16)
        for n in (("in_relu_bwd",) if plan.path != K.BWD_SPLIT else
                  ("in_relu_bwd_stats", "in_relu_bwd_apply")):
            out[n] += k * steps
    return out


def b2_train_kernels(shapes):
    """The B2 kernels a train step over ``shapes`` launches."""
    return tuple(n for n, c in b2_train_counts(shapes, 1).items() if c)


def nhwc_counts(counts):
    """A G-Net path's launches: ``counts`` under the NCHW plans' names (as
    b2_train_counts gives them) moved to the NHWC plans', since GUNet's
    activations are channels-last: one in_relu_fwd_nhwc a B2-fwd, one
    in_relu_bwd_nhwc a backward (B2f, or B2a with its B2b), B3's to its
    NHWC wrappers, and 0 for the NCHW plans."""
    out = dict(counts)
    fwd = out.pop("in_relu_fwd", 0)
    bwd = out.pop("in_relu_bwd", 0) + out.pop("in_relu_bwd_stats", 0)
    out.pop("in_relu_bwd_apply", None)
    out.update({n: 0 for n in B2_KERNELS})
    if fwd:
        out["in_relu_fwd_nhwc"] = fwd
    if bwd:
        out["in_relu_bwd_nhwc"] = bwd
    for n in ("modnorm_relu_fwd", "modnorm_relu_bwd"):
        if out.get(n):
            out[n + "_nhwc"] = out[n]
        out[n] = 0
    return {n: c for n, c in out.items() if c or n in counts}


def fwd_alternatives(planes, hw):
    """Other B2-fwd plans for a bf16 shape, timed beside the chosen one: the
    general path (one CTA a plane, x read twice: the first design of this
    kernel, unchanged), twice the chosen cluster, and one staged CTA a plane
    where the warp path is chosen."""
    from boxsegliver_torch.ops import kernels as K

    plan = K.in_relu_fwd_plan(planes, hw, torch.bfloat16)
    alts = {"general": K.FwdPlan(K.FWD_GENERAL, planes, 1, 0, 1, 0)}
    if plan.path == K.FWD_STAGED and plan.cluster < 8:
        cs = 2 * plan.cluster
        alts[f"staged x{cs}"] = K.FwdPlan(K.FWD_STAGED, planes * cs, 1, 0, cs,
                                          plan.smem_bytes // 2)
    if plan.path == K.FWD_WARP:
        alts["staged x1"] = K.FwdPlan(K.FWD_STAGED, planes, 1, 0, 1, hw * 2)
    return alts


def b2_times(shape, dev):
    """Per-call ms at one bf16 shape: each kernel's device time per launch
    ("device <name>", graph_ms; B2a and B2b under the split plan) and
    wrapper time per call ("<name>"), plain, library ("two calls") for the
    forward and for the backward (the library's backward is the whole
    backward of F.relu(F.instance_norm(...)), dx and dγ, dβ); B2-fwd's
    device time under the other plans of ``fwd_alternatives`` ("fwd
    <plan>"); the whole backward's device time under each plan of
    ``bwd_alternatives`` ("bwd <plan>": one B2f, or B2a + B2b); the
    chosen backward's wrapper time ("in_relu_bwd") and its plain version's
    ("plain in_relu_bwd"); B2-fwd's CUDA implementation called without the
    operator's dispatcher ("in_relu_fwd direct")."""
    import torch.nn.functional as F

    from boxsegliver_torch.ops import kernels

    x, g, w, b = b2_inputs(shape, torch.bfloat16, dev, seed=1)
    _, xh, rstd = kernels.in_relu_fwd(x, w, b)
    s1, s2 = kernels.in_relu_bwd_stats(g, xh, w, b)
    xr = x.clone().requires_grad_(True)
    wr = w.clone().requires_grad_(True)
    br = b.clone().requires_grad_(True)
    lib_y = F.relu(F.instance_norm(xr, weight=wr, bias=br, eps=1e-6))
    planes, hw = shape[0] * shape[1], math.prod(shape[2:])
    iters = 20 if hw >= 128 * 128 else 50
    # input sets for the device-time loops: COLD_BYTES of x / g in all
    n_sets = max(1, min(iters, math.ceil(COLD_BYTES / (x.numel() * 2))))
    sets = [(x, g, xh, rstd, s1, s2)]
    for i in range(1, n_sets):
        xi, gi, _, _ = b2_inputs(shape, torch.bfloat16, dev, seed=1 + i)
        _, xhi, rstdi = kernels.in_relu_fwd(xi, w, b)
        sets.append((xi, gi, xhi, rstdi) + kernels.in_relu_bwd_stats(
            gi, xhi, w, b))
    bwd_plans = bwd_alternatives(planes, hw, torch.bfloat16)
    t = {}
    # kernel, plain, library, then the same again: the best of two turns
    for turn in range(2):
        for name, call in (
                ("in_relu_fwd",
                 lambda i: kernels.in_relu_fwd(sets[i][0], w, b)),
                ("in_relu_bwd_stats",
                 lambda i: kernels.in_relu_bwd_stats(sets[i][1], sets[i][2],
                                                     w, b)),
                ("in_relu_bwd_apply",
                 lambda i: kernels.in_relu_bwd_apply(
                     sets[i][1], sets[i][2], w, b, *sets[i][3:]))):
            ms = graph_ms(call, n_sets, iters)
            t["device " + name] = min(ms, t.get("device " + name, ms))
        for alt, plan in fwd_alternatives(planes, hw).items():
            ms = graph_ms(lambda i, plan=plan: kernels._fwd_launch(
                sets[i][0], w, b, kernels.IN_EPS, plan), n_sets, iters)
            t["fwd " + alt] = min(ms, t.get("fwd " + alt, ms))
        for alt, plan in bwd_plans.items():
            ms = graph_ms(lambda i, plan=plan: kernels.instance_norm_relu_bwd(
                sets[i][1], sets[i][2], w, b, sets[i][3], plan), n_sets,
                iters)
            t["bwd " + alt] = min(ms, t.get("bwd " + alt, ms))
        for name, fn in (
                ("in_relu_fwd", lambda: kernels.in_relu_fwd(x, w, b)),
                # the CUDA implementation without the dispatcher: the
                # wrapper's path before B2-fwd became a registered operator
                ("in_relu_fwd direct", lambda: kernels._in_relu_fwd_cuda(
                    x, w, b, kernels.IN_EPS)),
                ("in_relu_bwd", lambda: kernels.instance_norm_relu_bwd(
                    g, xh, w, b, rstd)),
                ("in_relu_bwd_stats",
                 lambda: kernels.in_relu_bwd_stats(g, xh, w, b)),
                ("in_relu_bwd_apply",
                 lambda: kernels.in_relu_bwd_apply(g, xh, w, b, rstd, s1,
                                                   s2)),
                ("plain in_relu_fwd", lambda: kernels.in_relu_fwd_plain(
                    x, w, b)),
                ("plain in_relu_bwd", lambda: kernels.in_relu_bwd_plain(
                    g, xh, w, b, rstd)),
                ("plain in_relu_bwd_stats",
                 lambda: kernels.in_relu_bwd_stats_plain(g, xh, w, b)),
                ("plain in_relu_bwd_apply",
                 lambda: kernels.in_relu_bwd_apply_plain(g, xh, w, b, rstd,
                                                         s1, s2)),
                ("library fwd", lambda: F.relu(F.instance_norm(
                    x, weight=w, bias=b, eps=1e-6))),
                ("library bwd", lambda: torch.autograd.grad(
                    lib_y, (xr, wr, br), g, retain_graph=True))):
            ms = cuda_ms(fn, iters=iters, warmup=3)
            t[name] = min(ms, t.get(name, ms))
    t["device in_relu_bwd"] = t["bwd chosen"]
    return t


def b2_bound_ms(name, shape):
    """(bound ms, bound_by) of one call: each input read once, each output
    written once, and B2_OPS float operations per element at the float32
    non-tensor peak.  ``shape``: [N, C, *S] (NCHW or NCDHW).  B2f's is the
    backward's as one function: g and x̂ read, dx written (6 B a bf16
    element), rstd read, s1 and s2 written.  The NHWC plans' forward writes
    no x̂ (4 B a bf16 element, the planes' mean and rstd); their backward
    reads x for x̂ (6 B, the planes' mean besides)."""
    n, c = shape[:2]
    elems = math.prod(shape)
    planes, params = n * c * 4, c * 4 * 2            # f32 per-plane, γ and β
    io = {"in_relu_fwd": 3 * elems * 2 + planes,     # x in; y, x̂ out; rstd
          "in_relu_bwd": 3 * elems * 2 + 3 * planes,
          "in_relu_bwd_stats": 2 * elems * 2 + 2 * planes,
          "in_relu_bwd_apply": 3 * elems * 2 + 3 * planes,
          "in_relu_fwd_nhwc": 2 * elems * 2 + 2 * planes,   # mean, rstd out
          "in_relu_bwd_nhwc": 3 * elems * 2 + 4 * planes}[name] + params
    t_bytes = io / HBM_BYTES_PER_S * 1e3
    t_ops = B2_OPS[NHWC_OF.get(name, name)] * elems / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def b2_step_bound_ms(shapes):
    """B2's bound over a train step's calls ({shape: calls}): the forward's
    and the backward's as one function each (B2f's: 6 B a bf16 element)."""
    return sum(k * (b2_bound_ms("in_relu_fwd", shape)[0]
                    + b2_bound_ms("in_relu_bwd", shape)[0])
               for shape, k in shapes.items())


def bwd_verdict(label, shape, t):
    """One shape's backward: the chosen plan's device ms against B2f's
    bound (6 B a bf16 element) and against the first design (the pair at
    splits = 1) and the other plans timed in the same run.  Fails if the
    chosen plan is more than 5 % slower than the pair (the spread of two
    timings of one kernel in one run)."""
    bound, _ = b2_bound_ms("in_relu_bwd", shape)
    chosen, pair = t["bwd chosen"], t.get("bwd pair", t["bwd chosen"])
    print(f"  {label} {str(shape):22s} backward: chosen {chosen:.4f} ms "
          f"({bound / chosen:.1%} of the 6 B bound {bound:.4f}), pair "
          f"(splits = 1) {pair:.4f} ({bound / pair:.1%}; chosen "
          f"{pair / chosen:.2f}x faster); " + ", ".join(
              f"{k[4:]} {v:.4f}" for k, v in t.items()
              if k.startswith("bwd ") and k not in ("bwd chosen",
                                                    "bwd pair")))
    if chosen > 1.05 * pair:
        raise AssertionError(f"{label} {shape}: the chosen backward "
                             f"({chosen:.4f} ms) is slower than the pair "
                             f"({pair:.4f} ms)")
    return chosen, pair, bound


B2_FWD_PATHS = {0: "general", 1: "warp", 2: "staged"}


def b2_phase(dev):
    from boxsegliver_torch.ops import kernels

    names = B2_KERNELS
    worst = dict.fromkeys(names, 0.0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(s, bf16) for s in B2_STEP_SHAPES] + [
        ((2, 8, 7, 9), f32), ((1, 1, 33, 31), f32), ((1, 3, 64, 64), f32),
        ((3, 1, 5, 3), f32), ((1, 2, 13, 11), bf16), ((2, 64, 32, 32), f32),
        # one element either side of the path boundaries of B2-fwd (warp:
        # 2,048 bf16 / 1,024 f32 a plane; staged: 8 chunks of 64 KiB) and
        # of the backward (the same warp limit; a staged CTA's 64 KiB of g
        # + x̂, 8 CTAs of 192 KiB), and each staged cluster size of both
        ((2, 3, 8, 256), bf16), ((2, 3, 1, 2049), bf16), ((2, 3, 8, 257), bf16),
        ((2, 3, 32, 32), f32), ((2, 3, 1, 1025), f32), ((2, 3, 4, 257), f32),
        ((1, 3, 128, 258), bf16), ((1, 2, 256, 256), f32),
        ((1, 2, 512, 512), bf16), ((1, 2, 1, 262152), bf16),
        ((1, 2, 512, 512), f32), ((1, 3, 128, 128), bf16),
        ((1, 3, 1, 16385), bf16), ((1, 2, 256, 512), bf16),
        ((1, 3, 128, 129), bf16), ((1, 2, 384, 1024), bf16),
        ((1, 2, 384, 1025), bf16), ((1, 2, 192, 1024), f32),
        ((1, 2, 192, 1025), f32)]
    for i, (shape, dtype) in enumerate(cases + [((2, 64, 32, 32), bf16)]):
        unaligned = i == len(cases)
        errs = b2_check(shape, dtype, dev, seed=i, unaligned=unaligned)
        planes, hw = shape[0] * shape[1], math.prod(shape[2:])
        plan = kernels.in_relu_fwd_plan(planes, hw, dtype, not unaligned)
        bplan = kernels.in_relu_bwd_plan(planes, hw, dtype, not unaligned)
        path = B2_FWD_PATHS[plan.path] + (
            f" x{plan.cluster}" if plan.cluster > 1 else "") + (
            " (unaligned x, g)" if unaligned else "")
        print(f"  B2 {str(shape):20s} {str(dtype)[6:]:8s} fwd {path}, bwd "
              f"{b2_plan_name(bplan)}; max abs err " + ", ".join(
                  f"{k} {v:.3e}" for k, v in errs.items()))
        for k, v in errs.items():
            worst[k] = max(worst[k], v)
    recs = {n: {"name": n, "route": "cuda",
                "source": "boxsegliver_torch/csrc/in_relu.cu",
                "max_abs_err": worst[n], "ms": 0.0, "device_ms": 0.0,
                "wrapper_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "library_ms": 0.0}
            for n in names}
    recs["in_relu_fwd"]["replaces"] = \
        "boxsegliver_tpu/ops/pallas_kernels.py:47 (_in_relu_fwd_impl, XLA)"
    recs["in_relu_bwd"]["replaces"] = (
        "boxsegliver_tpu/ops/pallas_kernels.py:114,124 (_bwd_stats_kernel "
        "and _bwd_apply_kernel, one pass)")
    recs["in_relu_bwd_stats"]["replaces"] = \
        "boxsegliver_tpu/ops/pallas_kernels.py:114"
    recs["in_relu_bwd_apply"]["replaces"] = \
        "boxsegliver_tpu/ops/pallas_kernels.py:124"
    print(f"  {'shape (bf16)':22s} {'kernel':>18s} {'device':>8s} "
          f"{'wrapper':>8s} {'plain':>8s} {'library':>8s} {'bound':>8s} "
          f"{'of bound':>8s}")
    calls = sum(B2_STEP_SHAPES.values())
    direct_ms, bwd = 0.0, {"chosen": 0.0, "pair": 0.0, "bound": 0.0}
    for shape, count in B2_STEP_SHAPES.items():
        planes, hw = shape[0] * shape[1], math.prod(shape[2:])
        plan = kernels.in_relu_fwd_plan(planes, hw, bf16)
        print(f"  {str(shape):22s} B2-fwd plan: {B2_FWD_PATHS[plan.path]}, "
              f"grid {plan.grid}, cluster {plan.cluster}, packs a lane "
              f"{plan.packs}, {plan.smem_bytes} B of dynamic shared memory; "
              f"backward plan: "
              f"{b2_plan_name(kernels.in_relu_bwd_plan(planes, hw, bf16))}")
        t = b2_times(shape, dev)
        bound, _ = b2_bound_ms("in_relu_fwd", shape)
        print(f"  {str(shape):22s} B2-fwd under other plans: " + ", ".join(
            f"{k[4:]} {v:.4f} ms ({bound / v:.1%} of bound)"
            for k, v in t.items() if k.startswith("fwd ")))
        for key, v in zip(("chosen", "pair", "bound"),
                          bwd_verdict("flagship", shape, t)):
            bwd[key] += count * v
        fused = kernels.in_relu_bwd_plan(planes, hw, bf16).path \
            != kernels.BWD_SPLIT
        for n in names:
            bound, by = b2_bound_ms(n, shape)
            lib = t["library fwd" if n == "in_relu_fwd" else "library bwd"]
            r = recs[n]
            # B2f at the shapes it runs; B2a and B2b (timed under the split
            # plan) at every shape
            if n == "in_relu_bwd" and not fused:
                continue
            r["ms"] += count * t[n]
            r["device_ms"] += count * t["device " + n] / calls
            r["wrapper_ms"] += count * t[n] / calls
            if n == "in_relu_fwd":
                direct_ms += count * t["in_relu_fwd direct"] / calls
            r["plain_ms"] += count * t["plain " + n]
            r["library_ms"] += count * lib
            r["bound_ms"] += count * bound
            r["bound_by"] = by
            print(f"  {str(shape):22s} {n:>18s} {t['device ' + n]:8.4f} "
                  f"{t[n]:8.4f} {t['plain ' + n]:8.4f} {lib:8.4f} "
                  f"{bound:8.4f} {bound / t['device ' + n]:8.1%}")
    for r in recs.values():
        step = r["device_ms"] * calls
        print(f"  B2 {r['name']} per train step ({calls} calls): device "
              f"{step:.4f} ms ({r['device_ms']:.5f} ms per launch), "
              f"wrapper {r['ms']:.4f} ms ({r['wrapper_ms']:.4f} ms per "
              f"call), plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms (two calls; the backward rows are "
              f"the whole backward), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {r['bound_ms'] / step:.1%} of bound"
              + (" (B2a and B2b: under the split plan, which no flagship "
                 "shape takes)" if r["name"] in ("in_relu_bwd_stats",
                                                 "in_relu_bwd_apply")
                 else ""))
    print(f"  B2 backward per flagship train step ({calls} calls): chosen "
          f"plans {bwd['chosen']:.4f} ms, {bwd['bound'] / bwd['chosen']:.1%}"
          f" of the 6 B bound {bwd['bound']:.4f} ms; the pair (splits = 1) "
          f"{bwd['pair']:.4f} ms ({bwd['bound'] / bwd['pair']:.1%}); "
          f"{smi()}")
    print(f"  B2-fwd wrapper per call through the operator "
          f"boxseg::in_relu_fwd {recs['in_relu_fwd']['wrapper_ms']:.4f} ms, "
          f"its CUDA implementation called directly (the wrapper before the "
          f"registration) {direct_ms:.4f} ms; {smi()}")
    recs["backward"] = bwd
    return recs


def b2_nf_levels(dev, shapes=None, label="NF", seed=100):
    """B2 at the five levels of the NF UNet / UNetInter at batch 16 (bf16;
    or at ``shapes``, {shape: calls a train step}): each level against its
    plain version (b2_check's tolerances, every backward plan) with its
    plans, then per level and per train step (18 calls of each kernel) the
    device time per launch, plain and library times and the bound, and
    the whole backward (bwd_verdict) per level and per step.  Returns
    {kernel: {"device_ms", "bound_ms", "plain_ms", "library_ms",
    "max_abs_err"} per train step} (B2f at the levels that take a fused
    plan; B2a and B2b at every level, under the split plan), with
    "backward": {"chosen", "pair", "bound"} ms per step."""
    from boxsegliver_torch.ops import kernels

    shapes = shapes or NF_B2_STEP_SHAPES
    names = B2_KERNELS
    step = {n: dict.fromkeys(("device_ms", "bound_ms", "plain_ms",
                              "library_ms", "max_abs_err"), 0.0)
            for n in names}
    bwd = {"chosen": 0.0, "pair": 0.0, "bound": 0.0}
    for i, (shape, count) in enumerate(shapes.items()):
        errs = b2_check(shape, torch.bfloat16, dev, seed=seed + i)
        planes, hw = shape[0] * shape[1], math.prod(shape[2:])
        plan = kernels.in_relu_fwd_plan(planes, hw, torch.bfloat16)
        bplan = kernels.in_relu_bwd_plan(planes, hw, torch.bfloat16)
        t = b2_times(shape, dev)
        print(f"  {label} {str(shape):20s} x{count} fwd "
              f"{B2_FWD_PATHS[plan.path]}"
              f"{f' x{plan.cluster}' if plan.cluster > 1 else ''}, bwd "
              f"{b2_plan_name(bplan)}; max abs err " + ", ".join(
                  f"{k} {v:.3e}" for k, v in errs.items()))
        for key, v in zip(("chosen", "pair", "bound"),
                          bwd_verdict(label, shape, t)):
            bwd[key] += count * v
        for n in names:
            step[n]["max_abs_err"] = max(step[n]["max_abs_err"], errs[n])
            if n == "in_relu_bwd" and bplan.path == kernels.BWD_SPLIT:
                continue
            bound, by = b2_bound_ms(n, shape)
            lib = t["library fwd" if n == "in_relu_fwd" else "library bwd"]
            d = t["device " + n]
            for key, v in (("device_ms", d), ("bound_ms", bound),
                           ("plain_ms", t["plain " + n]),
                           ("library_ms", lib)):
                step[n][key] += count * v
            print(f"  {label} {str(shape):20s} {n:>18s} device {d:.4f} ms per "
                  f"launch, plain {t['plain ' + n]:.4f}, library {lib:.4f},"
                  f" bound {bound:.4f} ({by}), {bound / d:.1%} of bound")
    calls = sum(shapes.values())
    for n, r in step.items():
        if not r["device_ms"]:
            continue
        print(f"  {label} B2 {n} per train step: device "
              f"{r['device_ms']:.4f} ms, plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} ms, "
              f"{r['bound_ms'] / r['device_ms']:.1%} of bound; {smi()}")
    print(f"  {label} B2 backward per train step ({calls} calls): chosen "
          f"plans {bwd['chosen']:.4f} ms, {bwd['bound'] / bwd['chosen']:.1%}"
          f" of the 6 B bound {bwd['bound']:.4f} ms; the pair (splits = 1) "
          f"{bwd['pair']:.4f} ms ({bwd['bound'] / bwd['pair']:.1%}), chosen "
          f"{bwd['pair'] / bwd['chosen']:.2f}x faster; {smi()}")
    step["backward"] = bwd
    return step


# ---------------------------------------------------------------------------
# phase 7b: kernel B3 (G-Net's modulated block) against its plain version
# ---------------------------------------------------------------------------

# GUNet.yml's modulated blocks of one flagship train step (batch 8, 256^2,
# bf16): the two convs of each encoder level 1-4; the guided sweep's
# forward takes the same shapes (2 sweeps x 4 mirrors)
B3_STEP_SHAPES = {(8, 128, 128, 128): 2, (8, 256, 64, 64): 2,
                  (8, 512, 32, 32): 2, (8, 1024, 16, 16): 2}
B3_KERNELS = ("modnorm_relu_fwd", "modnorm_relu_bwd")
# float operations per element of B3 (GUNet.yml's block: center b, no
# scale): fwd = 3 (sum, square, sum) + 2 (x − mean, · rstd) + 1 (+ b) + 2
# (·γ, + s) + 1 (max); bwd = 1 (select) + 3 (two sums, one product) + 4 (two
# subtractions, two products)
B3_OPS = {"modnorm_relu_fwd": 9, "modnorm_relu_bwd": 8}


def b3_inputs(shape, dtype, dev, seed, fix=False):
    """x, g and GUNet.yml's operands of B3: the context's γ [N, C], the
    spatial term s (a tensor of its own, as the spatial conv gives each
    block its half; with ``fix`` the first channel half of a [N, 2C, *S]
    tensor) and the norm's center b [C]; no scale."""
    x, g, _, b = b2_inputs(shape, dtype, dev, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    n, c = shape[:2]
    gamma = torch.randn((n, c), generator=gen, device=dev) * 0.5 + 1.0
    wide = torch.randn((n, 2 * c) + tuple(shape[2:]), generator=gen,
                       device=dev).to(dtype)
    s = wide[:, :c] if fix else wide[:, :c].contiguous()
    return x, g, gamma, s, b


def b3_fwd_plans(planes, hw, dtype, aligned):
    """B3-fwd's plans checked at one shape: the chosen one
    (in_relu_fwd_plan), the general path, and for aligned bf16 the other
    plans of fwd_alternatives that fit the shape (a staged cluster whose
    chunks are whole 16-byte packs within 64 KiB)."""
    from boxsegliver_torch.ops import kernels as K

    plans = {"chosen": K.in_relu_fwd_plan(planes, hw, dtype, aligned),
             "general": K.FwdPlan(K.FWD_GENERAL, planes, 1, 0, 1, 0)}
    if aligned and dtype == torch.bfloat16:
        plans.update({k: p for k, p in fwd_alternatives(planes, hw).items()
                      if p.path != K.FWD_STAGED or (
                          hw % (8 * p.cluster) == 0
                          and p.smem_bytes == 2 * hw // p.cluster
                          and p.smem_bytes <= 64 * 1024)})
    return plans


def b3_check(shape, dtype, dev, seed, unaligned=False, fix=False):
    """B3-fwd under every plan of b3_fwd_plans (training, and y alone under
    no-grad), B3-bwd under every plan of ``bwd_alternatives`` (twice: equal
    from run to run) and ModulatedNormReLU's backward against their plain
    versions on the same inputs, at b2_check's tolerances (y, x̂ and dx
    rounded once to their dtype, the plane sums and dγ, db float32 sums in
    another order); ds, a masked copy of g, must be equal.  ``unaligned``:
    x and g at an odd element offset; ``fix``: s the first half of a wider
    tensor.  Returns the worst abs error per kernel (B3-fwd: y, x̂; B3-bwd:
    dx and the plane sums)."""
    from boxsegliver_torch.ops import kernels

    x, g, gamma, s, b = b3_inputs(shape, dtype, dev, seed, fix)
    planes, hw = shape[0] * shape[1], math.prod(shape[2:])
    what = f"B3 {tuple(shape)} {dtype}"

    def close(name, got, ref, rel, abs_):
        err = (got.float() - ref.float()).abs()
        bad = err > abs_ + rel * ref.float().abs()
        if bool(bad.any()):
            raise AssertionError(f"{what} {name}: {int(bad.sum())} elements "
                                 f"off, max abs err {float(err.max()):.3e}")
        return float(err.max())

    def odd_view(t):
        flat = torch.empty(t.numel() + 1, dtype=dtype, device=dev)
        flat[1:] = t.flatten()
        return flat[1:].view(t.shape)

    out_tol = (2.0 ** -7, 1e-5) if dtype == torch.bfloat16 else (1e-5, 1e-5)
    sum_tol = lambda n: (1e-4, 1e-6 * math.sqrt(n))          # noqa: E731
    x_in, g_in = (odd_view(x), odd_view(g)) if unaligned else (x, g)
    y_p, xh_p, rstd_p = kernels.modnorm_relu_fwd_plain(x, gamma, s, None, b)
    dx_p, ds_p, a_p, b_p = kernels.modnorm_relu_bwd_plain(
        g, y_p, xh_p, rstd_p, gamma)
    errs = dict.fromkeys(B3_KERNELS, 0.0)
    for name, plan in b3_fwd_plans(planes, hw, dtype, not unaligned).items():
        y, xh, rstd = kernels._modnorm_fwd_launch(
            x_in, gamma, s, None, b, kernels.IN_EPS, True, plan)
        y0, _, _ = kernels._modnorm_fwd_launch(
            x_in, gamma, s, None, b, kernels.IN_EPS, False, plan)
        if not (y.dtype == xh.dtype == dtype and rstd.dtype == torch.float32):
            raise AssertionError(f"{what}: B3-fwd output dtypes")
        errs["modnorm_relu_fwd"] = max(
            errs["modnorm_relu_fwd"], close(f"y ({name})", y, y_p, *out_tol),
            close(f"x_hat ({name})", xh, xh_p, *out_tol),
            close(f"rstd ({name})", rstd, rstd_p, 1e-5, 0.0))
        if not torch.equal(y0, y):
            raise AssertionError(f"{what}: the no-grad y ({name}) is not "
                                 f"the training y")
    for name, plan in bwd_alternatives(planes, hw, dtype,
                                       not unaligned).items():
        dx, ds, a, b_ = kernels.modnorm_relu_bwd(g_in, y_p, xh_p, rstd_p,
                                                 gamma, plan=plan)
        again = kernels.modnorm_relu_bwd(g_in, y_p, xh_p, rstd_p, gamma,
                                         plan=plan)
        if not all(torch.equal(u, v) for u, v in zip(again, (dx, ds, a, b_))):
            raise AssertionError(f"{what}: B3-bwd ({name}) differs from run "
                                 f"to run")
        if not torch.equal(ds, ds_p):
            raise AssertionError(f"{what}: ds ({name}) is not g_m")
        errs["modnorm_relu_bwd"] = max(
            errs["modnorm_relu_bwd"],
            close(f"dx ({name})", dx, dx_p, *out_tol),
            close(f"a ({name})", a, a_p, *sum_tol(hw)),
            close(f"b ({name})", b_, b_p, *sum_tol(hw)))
    # the autograd Function: dx, ds as B3-bwd's, dγ = Σ g_m·x̂ + b_c·Σ g_m
    # per plane (no scale), db = Σ_n γ·Σ g_m; held against the plain
    # backward on the x̂ and rstd that the Function's own forward saved (its
    # leaf is an aligned copy of x_in, whose B3-fwd plan may differ)
    leaves = [t.clone().requires_grad_(True) for t in (x_in, gamma, s, b)]
    y_a = kernels.modulated_norm_relu(leaves[0], leaves[1], leaves[2], None,
                                      leaves[3])
    dxa, dga, dsa, dba = torch.autograd.grad(y_a, leaves, g_in)
    ya, xha, rstda = kernels._modnorm_fwd_launch(
        leaves[0].detach(), gamma, leaves[2].detach(), None, b,
        kernels.IN_EPS, True)
    dx_r, ds_r, a_r, b_r = kernels.modnorm_relu_bwd_plain(g, ya, xha, rstda,
                                                          gamma)
    torch.cuda.synchronize()
    if not torch.equal(dsa, ds_r):
        raise AssertionError(f"{what}: autograd's ds is not g_m")
    errs["modnorm_relu_bwd"] = max(
        errs["modnorm_relu_bwd"], close("dx (autograd)", dxa, dx_r, *out_tol),
        close("dgamma (autograd)", dga, b_r + a_r * b, *sum_tol(hw)),
        close("db (autograd)", dba, (a_r * gamma).sum(dim=0),
              *sum_tol(shape[0] * hw)))
    return errs


def b3_bound_ms(name, shape, train=True):
    """(bound ms, bound_by) of one call: the function's least bytes, B2's
    rule (portbench/flops.py): B3-fwd reads x and s and writes y (6 B a
    bf16 element; x̂, which the training forward also writes for B3-bwd, is
    the design's choice and not counted), B3-bwd reads g, y and x̂ and
    writes dx and ds (10 B): 16 B an element a training step, 6 under
    no-grad; the per-plane γ, rstd and sums besides, and B3_OPS at the
    float32 non-tensor peak."""
    n, c = shape[:2]
    elems, esize = math.prod(shape), 2
    planes = n * c * 4
    io = {"modnorm_relu_fwd": 3 * elems * esize + planes * (2 if train
                                                            else 1),
          "modnorm_relu_bwd": 5 * elems * esize + 4 * planes}[name] + c * 4
    t_bytes = io / HBM_BYTES_PER_S * 1e3
    t_ops = B3_OPS[name] * elems / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def b3_times(shape, dev):
    """Per-call ms at one bf16 shape: B3-fwd's device time per launch in
    training and under no-grad, B3-bwd's under the chosen plan ("device
    <name>", graph_ms over COLD_BYTES of inputs, so reads miss the L2), the
    wrappers ("<name>"), the plain versions, and the chain B3 replaced
    ("chain fwd": instance norm with its center, ·γ, + s, ReLU; "chain
    bwd": autograd's backward of it)."""
    import torch.nn.functional as F

    from boxsegliver_torch.ops import kernels

    x, g, gamma, s, b = b3_inputs(shape, torch.bfloat16, dev, seed=1)
    planes, hw = shape[0] * shape[1], math.prod(shape[2:])
    iters = 20 if hw >= 128 * 128 else 50
    per_set = 5 * x.numel() * 2              # x, s; g, y, x̂
    n_sets = max(1, min(iters, math.ceil(COLD_BYTES / per_set)))
    sets = []
    for i in range(n_sets):
        xi, gi, _, si, _ = b3_inputs(shape, torch.bfloat16, dev, seed=1 + i)
        sets.append((xi, gi, si) + kernels.modnorm_relu_fwd(xi, gamma, si,
                                                            None, b))
    leaves = [t.clone().requires_grad_(True) for t in (x, gamma, s, b)]

    def chain(xx, gm, ss, bb):
        z = F.instance_norm(xx.float(), eps=kernels.IN_EPS) + bb[:, None,
                                                                 None]
        return F.relu((z * gm[:, :, None, None] + ss.float()).to(xx.dtype))

    chain_y = chain(*leaves)
    t = {}
    for turn in range(2):
        for name, call in (
                ("modnorm_relu_fwd", lambda i: kernels.modnorm_relu_fwd(
                    sets[i][0], gamma, sets[i][2], None, b)),
                ("modnorm_relu_fwd no-grad",
                 lambda i: kernels.modnorm_relu_fwd(
                     sets[i][0], gamma, sets[i][2], None, b, train=False)),
                ("modnorm_relu_bwd", lambda i: kernels.modnorm_relu_bwd(
                    sets[i][1], *sets[i][3:], gamma))):
            ms = graph_ms(call, n_sets, iters)
            t["device " + name] = min(ms, t.get("device " + name, ms))
        y, xh, rstd = sets[0][3:]
        for name, fn in (
                ("modnorm_relu_fwd", lambda: kernels.modnorm_relu_fwd(
                    x, gamma, s, None, b)),
                ("modnorm_relu_bwd", lambda: kernels.modnorm_relu_bwd(
                    g, y, xh, rstd, gamma)),
                ("plain modnorm_relu_fwd",
                 lambda: kernels.modnorm_relu_fwd_plain(x, gamma, s, None,
                                                        b)),
                ("plain modnorm_relu_bwd",
                 lambda: kernels.modnorm_relu_bwd_plain(g, y, xh, rstd,
                                                        gamma)),
                ("chain fwd", lambda: chain(x, gamma, s, b)),
                ("chain bwd", lambda: torch.autograd.grad(
                    chain_y, leaves, g, retain_graph=True))):
            ms = cuda_ms(fn, iters=iters, warmup=3)
            t[name] = min(ms, t.get(name, ms))
    return t


def b3_phase(dev):
    """B3 at the flagship's four modulated levels (bf16, batch 8: the train
    step's and the sweep forward's shapes) on every plan, with s its own
    tensor and a half of a wider one (--fix), then f32, unaligned and
    boundary cases (b3_check); per level and per train step the device
    time per launch against b3_bound_ms, the plain versions and the chain
    B3 replaced.  Returns the kernels line's records of B3-fwd and
    B3-bwd."""
    from boxsegliver_torch.ops import kernels

    bf16, f32 = torch.bfloat16, torch.float32
    worst = dict.fromkeys(B3_KERNELS, 0.0)
    cases = [(s, bf16, False, False) for s in B3_STEP_SHAPES] + [
        (s, bf16, False, True) for s in B3_STEP_SHAPES] + [
        ((2, 64, 32, 32), f32, False, False), ((2, 8, 128, 128), f32, False,
                                               False),
        ((2, 3, 8, 257), bf16, False, False), ((2, 3, 1, 2049), bf16, False,
                                               False),
        ((1, 2, 512, 512), bf16, False, False), ((2, 3, 7, 9), f32, False,
                                                 False),
        ((2, 64, 32, 32), bf16, True, False), ((2, 8, 64, 64), f32, True,
                                               False)]
    for i, (shape, dtype, unaligned, fix) in enumerate(cases):
        errs = b3_check(shape, dtype, dev, seed=300 + i, unaligned=unaligned,
                        fix=fix)
        planes, hw = shape[0] * shape[1], math.prod(shape[2:])
        plan = kernels.in_relu_fwd_plan(planes, hw, dtype, not unaligned)
        bplan = kernels.in_relu_bwd_plan(planes, hw, dtype, not unaligned)
        print(f"  B3 {str(shape):20s} {str(dtype)[6:]:8s} fwd "
              f"{B2_FWD_PATHS[plan.path]}"
              f"{f' x{plan.cluster}' if plan.cluster > 1 else ''}, bwd "
              f"{b2_plan_name(bplan)}"
              f"{' (unaligned x, g)' if unaligned else ''}"
              f"{' (s a half of a wider tensor)' if fix else ''}; every "
              f"plan; max abs err " + ", ".join(f"{k} {v:.3e}"
                                               for k, v in errs.items()))
        for k, v in errs.items():
            worst[k] = max(worst[k], v)
    recs = {n: {"name": n, "route": "cuda",
                "source": "boxsegliver_torch/csrc/in_relu.cu",
                "replaces": "boxsegliver_tpu/models/gunet.py:215-232 (norm, "
                            "·γ, + s, ReLU; XLA)",
                "max_abs_err": worst[n], "ms": 0.0, "device_ms": 0.0,
                "wrapper_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "bound_by": "bytes", "library_ms": 0.0, "shapes": {}}
            for n in B3_KERNELS}
    calls = sum(B3_STEP_SHAPES.values())
    no_grad = {"device_ms": 0.0, "bound_ms": 0.0}
    for shape, count in B3_STEP_SHAPES.items():
        t = b3_times(shape, dev)
        for n in B3_KERNELS:
            bound, by = b3_bound_ms(n, shape)
            d = t["device " + n]
            lib = t["chain fwd" if n == "modnorm_relu_fwd" else "chain bwd"]
            r = recs[n]
            r["ms"] += count * t[n]
            r["device_ms"] += count * d / calls
            r["wrapper_ms"] += count * t[n] / calls
            r["plain_ms"] += count * t["plain " + n]
            r["library_ms"] += count * lib
            r["bound_ms"] += count * bound
            r["bound_by"] = by
            r["shapes"][str(shape)] = {"device_ms": d, "bound_ms": bound,
                                       "of_bound": bound / d}
            print(f"  {str(shape):22s} {n:>18s} device {d:.5f} ms per "
                  f"launch ({bound / d:.1%} of {bound:.5f}, {by}), wrapper "
                  f"{t[n]:.4f}, plain {t['plain ' + n]:.4f}, chain {lib:.4f}")
        both = t["device modnorm_relu_fwd"] + t["device modnorm_relu_bwd"]
        d0 = t["device modnorm_relu_fwd no-grad"]
        b0, _ = b3_bound_ms("modnorm_relu_fwd", shape, train=False)
        no_grad["device_ms"] += count * d0
        no_grad["bound_ms"] += count * b0
        print(f"  {str(shape):22s} B3-fwd no-grad device {d0:.5f} ms per "
              f"launch ({b0 / d0:.1%} of {b0:.5f}); B3 a step at this level "
              f"{both:.5f} ms a block against the chain's "
              f"{t['chain fwd'] + t['chain bwd']:.4f}")
    step = sum(r["device_ms"] * calls for r in recs.values())
    bound = sum(r["bound_ms"] for r in recs.values())
    chain = sum(r["library_ms"] for r in recs.values())
    print(f"  B3 per flagship train step ({calls} blocks): device {step:.4f} "
          f"ms, {bound / step:.1%} of the 16 B bound {bound:.4f} ms; the "
          f"chain it replaced {chain:.4f} ms; a sweep forward (no-grad) "
          f"{no_grad['device_ms']:.4f} ms, "
          f"{no_grad['bound_ms'] / no_grad['device_ms']:.1%} of the 6 B "
          f"bound; {smi()}")
    return recs


# ---------------------------------------------------------------------------
# phase 7c: B2 and B3 on their NHWC plans (G-Net's channels-last
# activations), and what cudnn.benchmark alone does to cuDNN's transposes
# ---------------------------------------------------------------------------

NHWC_KERNELS = ("in_relu_fwd_nhwc", "in_relu_bwd_nhwc",
                "modnorm_relu_fwd_nhwc", "modnorm_relu_bwd_nhwc")
# B2's (fwd, bwd) and B3's: the NCHW kernel each NHWC one stands beside
NHWC_OF = {"in_relu_fwd_nhwc": "in_relu_fwd", "in_relu_bwd_nhwc":
           "in_relu_bwd", "modnorm_relu_fwd_nhwc": "modnorm_relu_fwd",
           "modnorm_relu_bwd_nhwc": "modnorm_relu_bwd"}


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


def nhwc_alternatives(n, c, hw, arrays, grad):
    """The NHWC plans timed at one bf16 shape: the chosen one, the split
    plan (and with 2, 4 and 8 times its chunk), and each tile width's
    staged plan (32-byte rows and wider) at its fewest CTAs within 64 and
    192 KiB."""
    from boxsegliver_torch.ops import kernels as K

    bf16 = torch.bfloat16
    split = K.in_relu_nhwc_split_plan(n, c, hw, bf16, True, grad)
    out = {"chosen": K.in_relu_nhwc_plan(n, c, hw, bf16, True, arrays, grad),
           "split": split}
    for k in (2, 4, 8):                 # longer chunks: fewer partial sums
        chunk = split.chunk * k
        out[f"split chunk x{k}"] = split._replace(chunk=chunk,
                                                  splits=-(-hw // chunk))
    if grad:                            # the split backward at 8 channels
        wide = K._nhwc_widths(c, 8)[0]
        chunk = 256 // wide * 16
        out["split 8 channels"] = split._replace(pack=8, v=wide, chunk=chunk,
                                                 splits=-(-hw // chunk))
    for v in K._nhwc_widths(c, 8):
        for limit in (64 * 1024, 192 * 1024):
            fit = [cs for cs in (1, 2, 4, 8) if hw % cs == 0
                   and hw // cs * v * 16 * arrays <= limit]
            if fit and v > 1:
                cs = fit[0]
                out[f"staged v{v} x{cs}"] = K.NhwcPlan(
                    K.NHWC_STAGED, 8, v, cs, hw // cs * v * 16 * arrays, 1,
                    hw)
    return out


def nhwc_plan_name(p):
    from boxsegliver_torch.ops import kernels as K

    if p.path == K.NHWC_STAGED:
        return f"staged v{p.v} x{p.cluster} ({p.smem_bytes // 1024} KiB)"
    return f"split v{p.v}, {p.splits} chunks"


def nhwc_times(shape, dev, b3):
    """Device ms per launch at one bf16 shape (graph_ms over COLD_BYTES of
    inputs): the NHWC forward and backward under each plan of
    nhwc_alternatives, the NCHW plans' on the same data, B3's forward under
    no-grad; the chosen plans' and the plain versions' wrapper ms; and the
    worst error of every plan against the plain versions (nhwc_check)."""
    from boxsegliver_torch.ops import kernels as K

    n, c = shape[:2]
    hw = math.prod(shape[2:])
    iters = 20 if hw >= 128 * 128 else 50
    n_sets = max(1, min(iters, math.ceil(COLD_BYTES / (5 * n * c * hw * 2))))
    sets = []
    for i in range(n_sets):
        if b3:
            x, g, gamma, s, b = b3_inputs(shape, torch.bfloat16, dev, 11 + i)
            w = None
            y, xh, rstd = K.modnorm_relu_fwd(x, gamma, s, None, b)
        else:
            x, g, w, b = b2_inputs(shape, torch.bfloat16, dev, 11 + i)
            gamma = s = None
            y, xh, rstd = K.in_relu_fwd(x, w, b)
        xc, sc = _cl(x), None if s is None else _cl(s)
        _, mean_c, rstd_c = (K.modnorm_relu_fwd_nhwc(xc, gamma, sc, None, b)
                             if b3 else K.in_relu_fwd_nhwc(xc, w, b))
        sets.append(dict(x=x, g=g, y=y, xh=xh, rstd=rstd, s=s, xc=xc,
                         gc=_cl(g), yc=_cl(y), sc=sc, mean_c=mean_c,
                         rstd_c=rstd_c))
    if b3:
        fwd = lambda i, p=None, nchw=False, train=True: (  # noqa: E731
            K.modnorm_relu_fwd(sets[i]["x"], gamma, sets[i]["s"], None, b,
                               train=train) if nchw else
            K.modnorm_relu_fwd_nhwc(sets[i]["xc"], gamma, sets[i]["sc"], None,
                                    b, train=train, plan=p))
        bwd = lambda i, p=None, nchw=False: (  # noqa: E731
            K.modnorm_relu_bwd(sets[i]["g"], sets[i]["y"], sets[i]["xh"],
                               sets[i]["rstd"], gamma) if nchw else
            K.modnorm_relu_bwd_nhwc(sets[i]["gc"], sets[i]["yc"],
                                    sets[i]["xc"], sets[i]["mean_c"],
                                    sets[i]["rstd_c"], gamma, plan=p))
    else:
        fwd = lambda i, p=None, nchw=False, train=True: (  # noqa: E731
            K.in_relu_fwd(sets[i]["x"], w, b) if nchw else
            K.in_relu_fwd_nhwc(sets[i]["xc"], w, b, plan=p))
        bwd = lambda i, p=None, nchw=False: (  # noqa: E731
            K.instance_norm_relu_bwd(sets[i]["g"], sets[i]["xh"], w, b,
                                     sets[i]["rstd"]) if nchw else
            K.in_relu_bwd_nhwc(sets[i]["gc"], sets[i]["xc"],
                               sets[i]["mean_c"], w, b, sets[i]["rstd_c"],
                               plan=p))
    t = {}
    alts = {"fwd": nhwc_alternatives(n, c, hw, 2 if b3 else 1, False),
            "bwd": nhwc_alternatives(n, c, hw, 3 if b3 else 2, True)}
    for turn in range(2):
        for d, fn in (("fwd", fwd), ("bwd", bwd)):
            for name, p in alts[d].items():
                ms = graph_ms(lambda i, p=p: fn(i, p), n_sets, iters)
                t[f"{d} {name}"] = min(ms, t.get(f"{d} {name}", ms))
            ms = graph_ms(lambda i: fn(i, nchw=True), n_sets, iters)
            t[f"{d} nchw"] = min(ms, t.get(f"{d} nchw", ms))
        if b3:
            ms = graph_ms(lambda i: fwd(i, train=False), n_sets, iters)
            t["fwd no-grad"] = min(ms, t.get("fwd no-grad", ms))
    z = sets[0]
    xh_c = K._xhat(z["xc"], z["mean_c"], z["rstd_c"])
    if b3:
        plain_f = lambda: K.modnorm_relu_fwd_nhwc_plain(  # noqa: E731
            z["xc"], gamma, z["sc"], None, b)
        plain_b = lambda: K.modnorm_relu_bwd_plain(  # noqa: E731
            z["gc"], z["yc"], xh_c, z["rstd_c"], gamma)
    else:
        plain_f = lambda: K.in_relu_fwd_nhwc_plain(  # noqa: E731
            z["xc"], w, b)
        plain_b = lambda: K.in_relu_bwd_plain(  # noqa: E731
            z["gc"], xh_c, w, b, z["rstd_c"])
    t["plain fwd"] = cuda_ms(plain_f, iters=5, warmup=1)
    t["plain bwd"] = cuda_ms(plain_b, iters=5, warmup=1)
    t["wrapper fwd"] = cuda_ms(lambda: fwd(0), iters=20, warmup=2)
    t["wrapper bwd"] = cuda_ms(lambda: bwd(0), iters=20, warmup=2)
    t["err fwd"], t["err bwd"] = nhwc_check(
        f"{'B3' if b3 else 'B2'} NHWC {tuple(shape)}", alts, fwd, bwd,
        plain_f(), plain_b(), hw, b3)
    t["plans"] = {d: nhwc_plan_name(alts[d]["chosen"]) for d in alts}
    return t


def nhwc_check(what, alts, fwd, bwd, ref_f, ref_b, hw, b3):
    """Every plan of ``alts`` (the chosen one among them) on the first
    input set, run twice (bit-equal from run to run), each output against
    the plain versions' (ref_f: y, mean, rstd; ref_b: dx and the plane sums,
    B3's ds between them) at b2_check's tolerances: y and dx rounded once to
    bf16, the plane sums float32 sums in another order, the planes' mean
    and rstd float32, B3's ds (a masked copy of g) equal, B3's no-grad y the
    training y.  Returns the worst abs error (forward, backward)."""
    def close(name, got, ref, rel, abs_):
        err = (got.float() - ref.float()).abs()
        bad = err > abs_ + rel * ref.float().abs()
        if bool(bad.any()):
            raise AssertionError(f"{what} {name}: {int(bad.sum())} elements "
                                 f"off, max abs err {float(err.max()):.3e}")
        return float(err.max())

    out_tol, sums = (2.0 ** -7, 1e-5), (1e-4, 1e-6 * math.sqrt(hw))
    errs = {"fwd": 0.0, "bwd": 0.0}
    for d, fn, ref in (("fwd", fwd, ref_f), ("bwd", bwd, ref_b)):
        for name, p in alts[d].items():
            got, again = fn(0, p), fn(0, p)
            if not all(torch.equal(u, v) for u, v in zip(got, again)
                       if u is not None):
                raise AssertionError(f"{what} {d} ({name}) differs from run "
                                     "to run")
            want = ref
            if d == "fwd":
                outs = (("y", out_tol), ("mean", (1e-5, 1e-5)),
                        ("rstd", (1e-5, 0.0)))
                if b3 and not torch.equal(fn(0, p, train=False)[0], got[0]):
                    raise AssertionError(f"{what}: the no-grad y ({name}) is "
                                         "not the training y")
            elif b3:
                if not torch.equal(got[1], ref[1]):
                    raise AssertionError(f"{what}: ds ({name}) is not g_m")
                got, want = got[:1] + got[2:], ref[:1] + ref[2:]
                outs = ("dx", out_tol), ("a", sums), ("b", sums)
            else:
                outs = ("dx", out_tol), ("s1", sums), ("s2", sums)
            for (o, tol), u, v in zip(outs, got, want):
                errs[d] = max(errs[d], close(f"{d} {o} ({name})", u, v, *tol))
    return errs["fwd"], errs["bwd"]


def cudnn_transposes(dev):
    """cuDNN's layout transposes (kernels named nchwToNhwc / nhwcToNchw) and
    the convolutions' device ms in a profiled forward + backward of G-Net's
    level-0 and level-1 3x3 convs ([8, 64, 256^2] and [8, 128, 128^2],
    bf16): NCHW activations with cudnn.benchmark off (the parent's layout)
    and on, and channels-last activations."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for layout in ("nchw", "nchw benchmark", "channels-last"):
        torch.backends.cudnn.benchmark = layout == "nchw benchmark"
        xs, ws = [], []
        for c, h in ((64, 256), (128, 128)):
            x = torch.randn((8, c, h, h), device=dev, dtype=torch.bfloat16)
            w = torch.randn((c, c, 3, 3), device=dev) * 0.05
            if layout == "channels-last":
                x = _cl(x)
            xs.append(x.requires_grad_(True))
            ws.append(w.requires_grad_(True))

        def step():
            for x, w in zip(xs, ws):
                y = F.conv2d(x, w.to(x.dtype), padding=1)
                torch.autograd.grad(y, (x, w), torch.ones_like(y))

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                step()
            torch.cuda.synchronize()
        trans = conv = 0.0
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", 0.0) or getattr(
                e, "cuda_time_total", 0.0)
            name = e.key.lower()
            if "nchwtonhwc" in name or "nhwctonchw" in name:
                trans += us
            elif any(k in name for k in ("xmma", "conv", "gemm", "cudnn",
                                         "sm90_", "implicit")):
                conv += us
        out[layout] = {"transposes_ms": trans / 5e3, "conv_ms": conv / 5e3}
        print(f"  cuDNN, {layout:15s}: transposes {trans / 5e3:.4f} ms, "
              f"convolutions {conv / 5e3:.4f} ms a forward + backward of the "
              "two convs")
    torch.backends.cudnn.benchmark = False
    return out


def nhwc_phase(dev):
    """B2 and B3 on their NHWC plans at the flagship's train-step shapes
    (bf16, batch 8: B2 at levels 0-3, B3 at 1-4): every plan checked against
    the plain versions (nhwc_check), each plan's device time per launch, the
    chosen one against the bound (b2_bound_ms: 4 B an element forward, 6 B
    backward; b3_bound_ms: 6 and 10 B), the NCHW plans' time on the same
    data and the plain versions'; per train step against the benchmark's
    bounds (B2 10 B an element, B3 16 B); then channel_sums_phase and
    cudnn_transposes.  Returns the kernels line's records of the four NHWC
    kernels and channel_sums_nhwc (library_ms None: no single PyTorch call
    does what an NHWC plan does; the NCHW plans' times are under
    ``shapes``)."""
    recs = {n: {"name": n, "route": "cuda",
                "source": "boxsegliver_torch/csrc/in_relu.cu",
                "replaces": f"{NHWC_OF[n]}'s function on channels-last "
                            "operands",
                "max_abs_err": 0.0, "ms": 0.0, "device_ms": 0.0,
                "wrapper_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "bound_by": "bytes", "library_ms": None, "shapes": {}}
            for n in NHWC_KERNELS}
    step = {"b2": [0.0, 0.0, 0.0], "b3": [0.0, 0.0, 0.0]}  # nhwc, nchw, bound
    for b3, shapes in ((False, B2_STEP_SHAPES), (True, B3_STEP_SHAPES)):
        fam = "b3" if b3 else "b2"
        names = NHWC_KERNELS[2:] if b3 else NHWC_KERNELS[:2]
        calls = sum(shapes.values())
        for shape, count in shapes.items():
            t = nhwc_times(shape, dev, b3)
            print(f"  {fam.upper()} {str(shape):20s} plans: fwd "
                  f"{t['plans']['fwd']}, bwd {t['plans']['bwd']}; max abs "
                  f"err fwd {t['err fwd']:.3e}, bwd {t['err bwd']:.3e}")
            print("    " + ", ".join(f"{k} {v:.5f}" for k, v in t.items()
                                     if isinstance(v, float)
                                     and not k.startswith("err")))
            for d, n in zip(("fwd", "bwd"), names):
                if b3:
                    bound, by = b3_bound_ms(NHWC_OF[n], shape)
                else:
                    bound, by = b2_bound_ms(n, shape)
                dev_ms = t[f"{d} chosen"]
                r = recs[n]
                r["max_abs_err"] = max(r["max_abs_err"], t[f"err {d}"])
                r["device_ms"] += count * dev_ms / calls
                r["wrapper_ms"] += count * t[f"wrapper {d}"] / calls
                r["ms"] += count * dev_ms
                r["plain_ms"] += count * t[f"plain {d}"]
                r["bound_ms"] += count * bound
                r["bound_by"] = by
                r["shapes"][str(shape)] = {
                    "device_ms": dev_ms, "bound_ms": bound,
                    "of_bound": bound / dev_ms, "nchw_ms": t[f"{d} nchw"],
                    "plain_ms": t[f"plain {d}"]}
                print(f"    {n:22s} device {dev_ms:.5f} ms per launch "
                      f"({bound / dev_ms:.1%} of {bound:.5f}, {by}); NCHW "
                      f"plan {t[f'{d} nchw']:.5f}; plain "
                      f"{t[f'plain {d}']:.4f}")
                step[fam][0] += count * dev_ms
                step[fam][1] += count * t[f"{d} nchw"]
            elems = math.prod(shape)
            step[fam][2] += count * elems * (16 if b3 else 10) / \
                HBM_BYTES_PER_S * 1e3
    for fam, (nhwc, nchw, bound) in step.items():
        print(f"  {fam.upper()} per flagship train step: NHWC plans "
              f"{nhwc:.4f} ms ({bound / nhwc:.1%} of the benchmark's "
              f"{'16' if fam == 'b3' else '10'} B bound {bound:.4f} ms), "
              f"NCHW plans {nchw:.4f} ms ({bound / nchw:.1%})")
    recs["channel_sums_nhwc"] = channel_sums_phase(dev)
    cudnn_transposes(dev)
    print(f"  {smi()}")
    return recs


# the channels-last gradients whose channel sums a GUNet.yml backward takes
# for its 13 conv biases (models/layers.conv_with_bias: the spatial convs'
# halves at levels 1-4, the four transpose convs, the head), bf16 at batch
# 8; the head's [8, 3, 256^2] takes one element a thread
CHANNEL_SUMS_SHAPES = {(8, 64, 256, 256): 1, (8, 128, 128, 128): 3,
                       (8, 256, 64, 64): 3, (8, 512, 32, 32): 3,
                       (8, 1024, 16, 16): 2, (8, 3, 256, 256): 1}
GUNET_BIAS_SUMS = sum(CHANNEL_SUMS_SHAPES.values())


def channel_sums_phase(dev):
    """channel_sums_nhwc at CHANNEL_SUMS_SHAPES: twice (bit-equal from run
    to run) against its plain version, the float32 sum of the upcast
    gradient (1e-4 relative + 1e-5 sqrt(rows)); device ms (graph_ms over
    COLD_BYTES of inputs) against its bound (2 B an element read), wrapper
    ms, the plain version's ms and PyTorch's own reduction of the bf16
    gradient to float32 (library_ms: what the conv's backward ran for the
    bias).  Returns the kernels line's record, summed over one flagship
    backward's 13 launches."""
    from boxsegliver_torch.ops import kernels as K

    rec = {"name": "channel_sums_nhwc", "route": "cuda",
           "source": "boxsegliver_torch/csrc/in_relu.cu",
           "replaces": "a conv bias's gradient: the sum of a channels-last "
                       "output gradient over all but the channels (XLA's "
                       "reduction)",
           "max_abs_err": 0.0, "ms": 0.0, "device_ms": 0.0,
           "wrapper_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "bound_by": "bytes", "library_ms": 0.0, "shapes": {}}
    calls = sum(CHANNEL_SUMS_SHAPES.values())
    for shape, count in CHANNEL_SUMS_SHAPES.items():
        c = shape[1]
        rows = math.prod(shape) // c
        n_sets = max(1, min(20, math.ceil(COLD_BYTES / (2 * c * rows))))
        gen = torch.Generator(device=dev).manual_seed(31)
        gs = [_cl(torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)) for _ in range(n_sets)]
        got, again = K.channel_sums_nhwc(gs[0]), K.channel_sums_nhwc(gs[0])
        want = gs[0].float().sum(dim=(0, 2, 3))
        err = (got - want).abs()
        if not torch.equal(got, again):
            raise AssertionError(f"channel_sums_nhwc {shape} differs from run "
                                 "to run")
        if bool((err > 1e-5 * math.sqrt(rows) + 1e-4 * want.abs()).any()):
            raise AssertionError(f"channel_sums_nhwc {shape}: max abs err "
                                 f"{float(err.max()):.3e}")
        dev_ms = graph_ms(lambda i: K.channel_sums_nhwc(gs[i]), n_sets, 20)
        wrap = cuda_ms(lambda: K.channel_sums_nhwc(gs[0]), iters=20, warmup=2)
        plain = cuda_ms(lambda: gs[0].float().sum(dim=(0, 2, 3)), iters=10,
                        warmup=2)
        lib = graph_ms(lambda i: gs[i].sum(dim=(0, 2, 3), dtype=torch.float32),
                       n_sets, 20)
        bound = (math.prod(shape) * 2 + c * 8) / HBM_BYTES_PER_S * 1e3
        rec["max_abs_err"] = max(rec["max_abs_err"], float(err.max()))
        rec["device_ms"] += count * dev_ms / calls
        rec["wrapper_ms"] += count * wrap / calls
        rec["ms"] += count * dev_ms
        rec["plain_ms"] += count * plain
        rec["library_ms"] += count * lib
        rec["bound_ms"] += count * bound
        rec["shapes"][str(shape)] = {"device_ms": dev_ms, "bound_ms": bound,
                                     "of_bound": bound / dev_ms,
                                     "library_ms": lib}
        print(f"  channel_sums_nhwc {str(shape):20s} device {dev_ms:.5f} ms "
              f"({bound / dev_ms:.1%} of {bound:.5f}, bytes); wrapper "
              f"{wrap:.4f}; plain {plain:.4f}; PyTorch's reduction {lib:.5f};"
              f" max abs err {float(err.max()):.3e}")
    print(f"  channel_sums_nhwc per flagship backward ({calls} biases): "
          f"{rec['ms']:.4f} ms ({rec['bound_ms'] / rec['ms']:.1%} of "
          f"{rec['bound_ms']:.4f}), PyTorch's reduction "
          f"{rec['library_ms']:.4f} ms")
    return rec


# ---------------------------------------------------------------------------
# phase 8: the flagship G-Net training through the CLI
# ---------------------------------------------------------------------------

# run_scripts/template/002_gnet_sp.sh train flags (the dataset, the fold and
# the step counts are the smoke's own, appended in train_phase)
TRAIN_FLAGS = [
    "liver", "--mode", "train", "--tag", "chip_smoke_train", "--model",
    "GUNet", "--classes", "Liver", "Tumor", "--test_fold", "2",
    "--im_height", "256", "--im_width", "256", "--im_channel", "3",
    "--random_flip", "3", "--num_replicas", "0", "--dataset", "LiTS",
    "--normalizer", "instance_norm", "--use_context", "--context_list",
    "hist", "200", "--hist_noise", "--use_spatial", "--spatial_random",
    "1.0", "--spatial_inner_random", "--center_random_ratio", "0.2",
    "--stddev_random_ratio", "0.4", "--min_std", "2", "--noise_scale",
    "0.05", "--num_of_total_steps", "600000", "--primary_metric",
    "Tumor/Dice", "--secondary_metric", "Liver/Dice", "--loss_weight_type",
    "numerical", "--loss_numeric_w", "0.2", "0.4", "4.4",
    "--batches_per_epoch", "2000", "--batch_size", "8",
    "--weight_decay_rate", "0.000001", "--learning_policy", "plateau",
    "--learning_rate", "0.001", "--lr_end", "0.0000005", "--lr_decay_rate",
    "0.2", "--eval_per_epoch", "--evaluator", "Volume", "--save_best"]
B2_KERNELS = ("in_relu_fwd", "in_relu_bwd", "in_relu_bwd_stats",
              "in_relu_bwd_apply")


def train_kernels(shapes=None, b3=None):
    """The kernels a guided train step runs (G1 draws only the click eval's
    guides): B1, the B2 kernels of b2_train_kernels at ``shapes`` (the
    flagship's by default) and, where ``b3`` (by default for the flagship's
    GUNet.yml, ``shapes`` None), B3-fwd and B3-bwd; the flagship's
    channels-last, B2 and B3 on their NHWC plans."""
    b3 = shapes is None if b3 is None else b3
    counts = {**b2_train_counts(shapes or B2_STEP_SHAPES, 1),
              **({"modnorm_relu_fwd": 1, "modnorm_relu_bwd": 1} if b3
                 else {})}
    if shapes is None:
        counts = nhwc_counts(counts)
    return ("gaussian_guide_batch",) + tuple(n for n, c in counts.items()
                                             if c)


# the train runs whose checkpoints later phases check (phase 8's resume to
# step 30 for the annotator of phase 18, phase 10's best for phase 12's
# card-vs-CPU device_case) and the runs before them draw their batches from
# one host worker: with several, the workers race to fill the batch queue,
# so the batch order, the trained weights and with them the scale of the
# logits that float32 rounding is measured against change from run to run
# and from machine to machine
ONE_WORKER = ("--host_workers", "1")


def smoke_train_argv(tmp, steps, *extra):
    return TRAIN_FLAGS + [
        "--data_root", str(tmp), "--dataset", "ds", "--k_folds", "2",
        "--test_fold", "0", "--model_dir", str(Path(tmp) / "train_md"),
        "--num_of_steps", str(steps), "--batches_per_epoch", "12",
        "--eval_num_batches_per_epoch", "4", "--log_step", "4"] + list(extra)


def train_run(argv, steps_expected, b3=True):
    """One CLI train run of GUNet.yml with the launch counters zeroed right
    before it (``b3`` False: a variant whose modulated blocks stay off B3,
    whose caller checks its counts); returns (trainer, launches,
    seconds)."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.ops import kernels

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in kernels.KERNELS.items()}
    if launches["gaussian_guide_batch"] < steps_expected:
        raise AssertionError(f"B1 launched {launches['gaussian_guide_batch']}"
                             f" times in {steps_expected} train steps")
    # 10 pairs a step on B2's NHWC plans (GUNet's activations are
    # channels-last), none on its NCHW plans (the online eval and a K = 16
    # capture add launches: at least these)
    for n, c in nhwc_counts(b2_train_counts(B2_STEP_SHAPES,
                                            steps_expected)).items():
        if (launches[n] < c) if c else launches[n]:
            raise AssertionError(f"{n} launched {launches[n]} times in "
                                 f"{steps_expected} train steps ({c} at "
                                 "least, 0 if 0)")
    # B3: one B3-fwd a forward and one B3-bwd a backward for each of
    # GUNet.yml's 8 modulated blocks, where B2 runs its 10 pairs: exactly
    # 8/10 of B2's forwards and backwards, at least 8 a step; the NCHW
    # plans none
    want = {"modnorm_relu_fwd_nhwc": launches["in_relu_fwd_nhwc"],
            "modnorm_relu_bwd_nhwc": launches["in_relu_bwd_nhwc"]} if b3 \
        else {}
    if launches["modnorm_relu_fwd"] or launches["modnorm_relu_bwd"]:
        raise AssertionError(f"B3's NCHW plans launched in a GUNet train "
                             f"run: {launches}")
    for n, c in want.items():
        if (launches[n] * GUNET_B2_PAIRS != c * GUNET_MOD_BLOCKS
                or launches[n] < GUNET_MOD_BLOCKS * steps_expected):
            raise AssertionError(
                f"{n} launched {launches[n]} times in {steps_expected} train "
                f"steps, B2's counterpart {c}: {GUNET_MOD_BLOCKS} for every "
                f"{GUNET_B2_PAIRS} of B2's, {GUNET_MOD_BLOCKS} a step at "
                f"least")
    return trainer, launches, seconds


def train_phase(tmp):
    from boxsegliver_torch.ops import kernels

    md = Path(tmp) / "train_md"
    trainer, launches, seconds = train_run(
        smoke_train_argv(tmp, 24, "--device_cache", *ONE_WORKER), 24)
    # a GUNet.yml backward takes channel_sums_nhwc for each of its 13 conv
    # biases (CHANNEL_SUMS_SHAPES); the online eval none
    sums = launches["channel_sums_nhwc"] = kernels.channel_sums_nhwc.launches
    if sums != GUNET_BIAS_SUMS * 24:
        raise AssertionError(f"channel_sums_nhwc launched {sums} times in 24 "
                             f"train steps, not {GUNET_BIAS_SUMS} a step")
    if trainer.global_step != 24:
        raise AssertionError(f"train stopped at step {trainer.global_step}")
    for rel in ("ckpt/24/state.pt", "ckpt_best/best/state.pt", "best_result",
                "summaries/metrics.jsonl"):
        if not (md / rel).exists():
            raise AssertionError(f"train: {rel} was not written")
    lines = [json.loads(ln) for ln in
             (md / "summaries" / "metrics.jsonl").read_text().splitlines()]
    loss = {ln["step"]: ln["value"] for ln in lines
            if ln["tag"] == "chip_smoke_train/loss"}
    evals = sorted({ln["step"] for ln in lines
                    if ln["tag"].startswith("chip_smoke_train/eval/")})
    steps = sorted(loss)
    if not all(math.isfinite(v) for v in loss.values()):
        raise AssertionError(f"non-finite train loss: {loss}")
    late = float(np.mean([loss[s] for s in steps[-3:]]))
    if not late < loss[steps[0]]:
        raise AssertionError(f"train loss did not fall: {loss}")
    if evals != [12, 24]:
        raise AssertionError(f"online evals at steps {evals}, not [12, 24]")
    best = json.loads((md / "best_result").read_text())
    print(f"  train (--device_cache): 24 steps of 8 x 256^2 in {seconds:.2f} s "
          f"({seconds / 24 * 1e3:.1f} ms/step with set-up, two online evals "
          f"of 4 batches); loss " + ", ".join(f"{s}: {loss[s]:.4f}"
                                               for s in steps))
    print(f"  train launches {launches}; best {best}")

    again, launches2, seconds2 = train_run(
        smoke_train_argv(tmp, 30, *ONE_WORKER), 6)
    if again.global_step != 30 or not (md / "ckpt" / "30" / "state.pt").exists():
        raise AssertionError(f"resume ended at step {again.global_step}")
    print(f"  resume on the streaming sampler: steps 25-30 in {seconds2:.2f} s,"
          f" launches {launches2}")
    return launches


def train_card_vs_cpu(tmp, dev, seed, *extra):
    """One train step of a small GUNet (GUNet_TINY: init_channels 8, 2
    down-samples) at 64^2 in float32, TF32 off, on the card and on the CPU
    from the same weights and the same processed batch (side dropout 0: the
    two devices' generators draw different masks).  The update is Momentum:
    an Adam step is lr·g/(|g| + eps), which turns a gradient within
    round-off of zero into an update of either sign; what is compared here
    is the step's arithmetic."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.data.pipeline import (_process_batch,
                                                 batch_to_device, norm_statics)
    from boxsegliver_torch.data.sampler import TrainSampler
    from boxsegliver_torch.ops.image_ops import draw_augment

    argv = smoke_train_argv(tmp, 1, "--im_height", "64", "--im_width", "64",
                            "--compute_dtype", "float32", "--side_dropout",
                            "0", "--model_config", "GUNet_TINY.yml",
                            "--optimizer", "Momentum", "--batch_size", "4",
                            "--model_dir", str(Path(tmp) / "cmp_md"), *extra)
    args = cli.get_args(argv)
    sampler = TrainSampler(Path(tmp) / "ds", args, seed=seed)
    raw = sampler.sample_batch(4)
    draws = draw_augment(torch.Generator().manual_seed(seed), (4, 64, 64, 3),
                         noise=True, device="cpu")
    feats, labels = _process_batch(
        batch_to_device(raw, "cpu"), draws, im_h=64, im_w=64,
        noise_scale=0.05, random_flip=3, use_spatial=True, min_std=2.0,
        **norm_statics(args))
    out = []
    for d in (dev, torch.device("cpu")):
        ft = {k: v.to(d) for k, v in feats.items()}
        trainer = cli.build_trainer(args, d)
        trainer.preprocess_fn = lambda batch, gen, ft=ft: (ft, labels.to(d))
        vals, _ = trainer.train_step({"names": raw["names"]})
        out.append((float(vals[0]), {k: v.detach().cpu() for k, v in
                                     trainer.model.state_dict().items()}))
        trainer.summary.close()
    loss_err = abs(out[0][0] - out[1][0]) / abs(out[1][0])
    p_err = max(float((out[0][1][k] - v).abs().max())
                for k, v in out[1][1].items())
    print(f"  train step card vs CPU (GUNet_TINY, 64^2, float32): loss "
          f"{out[0][0]:.6f} / {out[1][0]:.6f} (rel err {loss_err:.2e}), "
          f"updated parameters max abs err {p_err:.2e}")
    if not (loss_err <= 1e-4 and p_err <= 1e-4):
        raise AssertionError("the train step on the card disagrees with the "
                             "CPU")


# ---------------------------------------------------------------------------
# phase 9: profile of the flagship train step
# ---------------------------------------------------------------------------

def profile_train(tmp):
    """Steady-state time of the flagship train step (device cache layout),
    and the card's kernel time by group from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.data.device_cache import DeviceVolumeCache
    from boxsegliver_torch.data.pipeline import TrainDataset
    from boxsegliver_torch.data.sampler import TrainSampler

    args = cli.get_args(smoke_train_argv(
        tmp, 10 ** 6, "--model_dir", str(Path(tmp) / "prof_md")))
    ds = Path(tmp) / "ds"
    train_pids, _ = cli._split_pids(args, ds)
    cache = DeviceVolumeCache(ds, [int(p) for p in train_pids], "cuda")
    trainer = cli.build_trainer(args, torch.device("cuda"), cache=cache)
    data = TrainDataset(TrainSampler(ds, args, seed=args.seed,
                                     zbase=cache.zbase), args, seed=args.seed)

    def steps(batches):
        vals = [trainer.train_step(b)[0] for b in batches]
        torch.stack(vals).cpu()               # one fetch, as the drain does

    try:
        steps(next(data) for _ in range(5))               # warm-up
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps(next(data) for _ in range(16))
            walls.append((time.perf_counter() - t0) / 16)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps(next(data) for _ in range(8))
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) / 8
        batches = [next(data) for _ in range(16)]
    finally:
        data.close()
        trainer.summary.close()
    # the same steps with the sampler's worker threads stopped: what the
    # host's dispatch costs without them
    walls_alone = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(batches)
        walls_alone.append((time.perf_counter() - t0) / 16)
    kern, groups, self_us = kernel_groups(prof)
    busy_ms = sum(groups.values()) / 1e3 / 8
    wall = min(walls)
    share = max(busy_ms, 1e-9)
    b2 = [e for e in kern if "in_relu" in e.key.lower()]
    lines = [
        f"card: {smi()}",
        "flagship train step: GUNet.yml full width, batch 8, 256^2 x 3, "
        "bf16, device cache, plateau Adam",
        "wall per step, unprofiled (3 runs of 16): "
        + ", ".join(f"{w * 1e3:.3f}" for w in walls) + " ms -> "
        f"{8 / wall:.1f} slices/s",
        "wall per step with the sampler threads stopped (2 runs of 16 "
        "pre-sampled batches): "
        + ", ".join(f"{w * 1e3:.3f}" for w in walls_alone) + " ms",
        f"kernel launches per step: {sum(e.count for e in kern) / 8:.0f}; "
        f"kernel time per step: {busy_ms:.3f} ms -> device busy "
        f"{busy_ms / 1e3 / wall:.1%} of the unprofiled wall, "
        f"{busy_ms / 1e3 / prof_wall:.1%} of the profiled wall "
        f"({prof_wall * 1e3:.3f} ms/step)",
        "B2 device time per step: " + ", ".join(
            f"{e.key[e.key.find('in_relu'):].split('<')[0]} "
            f"{self_us(e) / 1e3 / 8:.3f} ms "
            f"({e.count // 8}/step)" for e in b2),
        ""] + [f"{k:50s} {v / 1e3 / 8:9.3f} ms/step {v / 1e3 / 8 / share:7.1%}"
               for k, v in groups.items()] + [
        "",
        f"{'kernel':90s} {'calls':>7s} {'ms/step':>9s} {'share':>7s}"]
    for e in kern[:20]:
        lines.append(f"{e.key[:90]:90s} {e.count:7d} "
                     f"{self_us(e) / 1e3 / 8:9.3f} "
                     f"{self_us(e) / 1e3 / 8 / share:7.1%}")
    print("\n".join("  " + ln for ln in lines))


# ---------------------------------------------------------------------------
# phases 10-12: the headline UNet (001_unet.sh, bench.py) on the port
# ---------------------------------------------------------------------------

# run_scripts/template/001_unet.sh train and eval flags (the dataset, the
# fold and the step counts are the smoke's own, appended below)
UNET_COMMON = ["--tag", "chip_smoke_unet", "--model", "UNet", "--classes",
               "Liver", "Tumor", "--test_fold", "2", "--im_height", "256",
               "--im_width", "256", "--im_channel", "3", "--random_flip", "3",
               "--num_replicas", "0", "--dataset", "LiTS"]
UNET_TRAIN_FLAGS = ["liver", "--mode", "train"] + UNET_COMMON + [
    "--noise_scale", "0.05", "--num_of_total_steps", "600000",
    "--primary_metric", "Tumor/Dice", "--secondary_metric", "Liver/Dice",
    "--loss_weight_type", "numerical", "--loss_numeric_w", "0.2", "0.4",
    "4.4", "--batches_per_epoch", "2000", "--batch_size", "8",
    "--weight_decay_rate", "0.000001", "--learning_policy", "plateau",
    "--learning_rate", "0.001", "--lr_end", "0.0000005", "--lr_decay_rate",
    "0.2", "--eval_num_batches_per_epoch", "200", "--eval_per_epoch",
    "--evaluator", "Volume", "--save_best"]
UNET_EVAL_FLAGS = ["liver", "--mode", "eval"] + UNET_COMMON + [
    "--metrics_eval", "Dice", "VOE", "RVD", "--primary_metric", "Tumor/Dice",
    "--batch_size", "8", "--evaluator", "Volume"]


def smoke_data(tmp, md, *extra):
    return ["--data_root", str(tmp), "--dataset", "ds", "--k_folds", "2",
            "--test_fold", "0", "--model_dir", str(md)] + list(extra)


def no_kernel_run(fn, what):
    """counted_run(fn) on the batch-norm UNet path, which runs no
    hand-written kernel: every count must stay 0."""
    out, seconds, launches = counted_run(fn)
    if any(launches.values()):
        raise AssertionError(f"{what}: the batch-norm UNet path launched "
                             f"{launches}")
    return out, seconds, launches


def counted_run(fn):
    """fn() with the launch counters zeroed right before it; returns
    (result, seconds, launches)."""
    from boxsegliver_torch.ops import kernels

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, seconds, {n: f.launches for n, f in kernels.KERNELS.items()}


def cut_case(case, z0, n=8):
    """The n slices z0 .. z0 + n - 1 of an EvalCase's crop, with their
    halo."""
    from boxsegliver_torch.evaluators.eval_loader import EvalCase

    z1 = case.crop[0] + z0
    return EvalCase(pid=case.pid,
                    volume=case.volume[z0:z0 + n + case.lhc + case.rhc],
                    segmentation=None, crop=(z1, z1 + n) + case.crop[2:],
                    oshape=case.oshape, spacing=case.spacing, lhc=case.lhc,
                    rhc=case.rhc)


def unet_train_phase(tmp):
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.train.checkpoint import load_state

    md = Path(tmp) / "unet_md"
    argv = UNET_TRAIN_FLAGS + smoke_data(
        tmp, md, "--num_of_steps", "24", "--batches_per_epoch", "12",
        "--eval_3d", "--eval_num", "1", "--log_step", "4", *ONE_WORKER)
    trainer, seconds, launches = no_kernel_run(
        lambda: cli.main(argv + ["--device_cache"]), "UNet train")
    if trainer.global_step != 24:
        raise AssertionError(f"UNet train stopped at {trainer.global_step}")
    for rel in ("ckpt/24/state.pt", "ckpt_best/best/state.pt", "best_result",
                "summaries/metrics.jsonl"):
        if not (md / rel).exists():
            raise AssertionError(f"UNet train: {rel} was not written")
    lines = [json.loads(ln) for ln in
             (md / "summaries" / "metrics.jsonl").read_text().splitlines()]
    loss = {ln["step"]: ln["value"] for ln in lines
            if ln["tag"] == "chip_smoke_unet/loss"}
    evals = {ln["step"]: ln["value"] for ln in lines
             if ln["tag"] == "chip_smoke_unet/eval/Liver/Dice"}
    steps = sorted(loss)
    if not all(math.isfinite(v) for v in loss.values()):
        raise AssertionError(f"non-finite UNet train loss: {loss}")
    late = float(np.mean([loss[s] for s in steps[-3:]]))
    if not late < loss[steps[0]]:
        raise AssertionError(f"UNet train loss did not fall: {loss}")
    if sorted(evals) != [12, 24] or not all(math.isfinite(v)
                                            for v in evals.values()):
        raise AssertionError(f"inline volume evals {evals}, not at 12, 24")
    state = load_state(md / "ckpt" / "24" / "state.pt")["model"]
    rv = state["Encode1_conv1.norm.running_var"]
    if bool(torch.equal(rv, torch.ones_like(rv))):
        raise AssertionError("the running statistics did not move")
    print(f"  UNet train (001_unet flags, --device_cache): 24 steps of 8 x "
          f"256^2 in {seconds:.2f} s ({seconds / 24 * 1e3:.1f} ms/step with "
          f"set-up and two inline volume evals of 1 case); loss "
          + ", ".join(f"{s}: {loss[s]:.4f}" for s in steps)
          + f"; eval Liver/Dice {evals}; launches {launches}; {smi()}")

    again, seconds2, _ = no_kernel_run(
        lambda: cli.main(UNET_TRAIN_FLAGS + smoke_data(
            tmp, md, "--num_of_steps", "30", "--batches_per_epoch", "12",
            "--eval_3d", "--eval_num", "1", "--log_step", "4")),
        "UNet resume")
    if again.global_step != 30 or not (md / "ckpt" / "30" / "state.pt").exists():
        raise AssertionError(f"UNet resume ended at step {again.global_step}")
    print(f"  UNet resume on the streaming sampler: steps 25-30 in "
          f"{seconds2:.2f} s")
    return md


def unet_train_card_vs_cpu(tmp, dev, seed):
    """One train step of UNet_TINY (batch norm) at 64^2 in float32, TF32
    off, on the card and on the CPU from the same weights, running
    statistics and processed batch; Momentum, as in train_card_vs_cpu."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.data.pipeline import (_process_batch,
                                                 batch_to_device, norm_statics)
    from boxsegliver_torch.data.sampler import TrainSampler
    from boxsegliver_torch.ops.image_ops import draw_augment

    argv = UNET_TRAIN_FLAGS + smoke_data(
        tmp, Path(tmp) / "unet_cmp_md", "--im_height", "64", "--im_width",
        "64", "--compute_dtype", "float32", "--model_config", "UNet_TINY.yml",
        "--optimizer", "Momentum", "--batch_size", "4")
    args = cli.get_args(argv)
    raw = TrainSampler(Path(tmp) / "ds", args, seed=seed).sample_batch(4)
    draws = draw_augment(torch.Generator().manual_seed(seed), (4, 64, 64, 3),
                         noise=True, device="cpu")
    feats, labels = _process_batch(
        batch_to_device(raw, "cpu"), draws, im_h=64, im_w=64,
        noise_scale=0.05, random_flip=3, use_spatial=False, min_std=2.0,
        **norm_statics(args))
    out = []
    for d in (dev, torch.device("cpu")):
        ft = {k: v.to(d) for k, v in feats.items()}
        trainer = cli.build_trainer(args, d)
        trainer.preprocess_fn = lambda batch, gen, ft=ft: (ft, labels.to(d))
        vals, _ = trainer.train_step({"names": raw["names"]})
        out.append((float(vals[0]), {k: v.detach().cpu() for k, v in
                                     trainer.model.state_dict().items()}))
        trainer.summary.close()
    loss_err = abs(out[0][0] - out[1][0]) / abs(out[1][0])
    errs = {k: float((out[0][1][k] - v).abs().max())
            for k, v in out[1][1].items()}
    p_err = max(v for k, v in errs.items() if "running" not in k)
    s_err = max(v for k, v in errs.items() if "running" in k)
    print(f"  UNet train step card vs CPU (UNet_TINY, batch norm, 64^2, "
          f"float32): loss {out[0][0]:.6f} / {out[1][0]:.6f} (rel err "
          f"{loss_err:.2e}), parameters max abs err {p_err:.2e}, running "
          f"statistics max abs err {s_err:.2e}")
    if not (loss_err <= 1e-4 and p_err <= 1e-4 and s_err <= 1e-4):
        raise AssertionError("the UNet train step on the card disagrees "
                             "with the CPU")


def unet_gflop_per_slice(model, h, w):
    """Analytic forward GFLOP of one h x w slice, 2 per MAC: a k x k conv
    makes Cin·k² MACs per output element, the 2x2 stride-2 transpose conv
    Cin per output element (each output pixel takes one tap)."""
    from boxsegliver_torch.models.layers import Conv, UpConv

    macs = []

    def hook(mod, inp, out):
        per = inp[0].shape[1] * (mod.weight.shape[2] * mod.weight.shape[3]
                                 if isinstance(mod, Conv) else 1)
        macs.append(out[0].numel() * per)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (Conv, UpConv))]
    with torch.inference_mode():
        model({"images": torch.zeros(1, h, w, 3, device="cuda")})
    for hk in hooks:
        hk.remove()
    return 2 * sum(macs) / 1e9


def unet3d_gflop_per_patch(model, patch):
    """Analytic forward GFLOP of one UNet3D patch (d, h, w), 2 per MAC: a
    conv makes Cin·kd·kh·kw MACs per output element, a transpose conv
    (stride = kernel) Cin (each output voxel takes one tap)."""
    from boxsegliver_torch.models.layers import Conv3, UpConv3

    macs = []

    def hook(mod, inp, out):
        per = inp[0].shape[1] * (math.prod(mod.weight.shape[2:])
                                 if isinstance(mod, Conv3) else 1)
        macs.append(out[0].numel() * per)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (Conv3, UpConv3))]
    x = torch.zeros((1,) + tuple(patch) + (
        model.conv_e0_conv1.conv.weight.shape[1],), device="cuda")
    with torch.inference_mode():
        model({"images": x})
    for hk in hooks:
        hk.remove()
    return 2 * sum(macs) / 1e9


HOST_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                     "cudaMemcpy", "cudaMemset")


def host_launches(prof) -> int:
    """Launches the host issued in a profiled window: CUDA runtime and
    driver calls that enqueue a kernel, a graph or a copy."""
    from torch.autograd import DeviceType

    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CPU
               and e.key.startswith(HOST_LAUNCH_CALLS))


def steady(args, ds, what, kernels_used=False, prof_steps: int = 8,
           top: int = 15, groups_out=None):
    """Steady-state train steps of ``args`` on the dataset ``ds`` with the
    device cache (nf_inter: its InterSampler, which has none), as bench.py
    times them, in dispatches of --steps_per_dispatch K: a warm-up (3
    steps, or 2K under K > 1: the eager warm-up steps and both captures),
    3 windows of 16 steps, each closed by one fetch of the window's metrics
    (the train loop's drain), then one profiled window.
    The launch counters are zeroed before the warm-up: a path without
    hand-written kernels must launch none, one with them every train kernel
    of GUNet.yml (train_kernels(): B1, B2 and B3); ``kernels_used`` may
    instead name the kernels that must launch (the others must not).  ``groups_out`` (a dict) receives
    the profiled window's device ms per step by kernel group.  Returns
    (median s/step, launches, captured launches per replay)."""
    from torch.profiler import ProfilerActivity, profile

    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.data.device_cache import DeviceVolumeCache
    from boxsegliver_torch.data.pipeline import TrainDataset
    from boxsegliver_torch.data.sampler import TrainSampler
    from boxsegliver_torch.data.sampler_inter import InterSampler
    from boxsegliver_torch.ops import kernels

    bs, k = int(args.batch_size), int(args.steps_per_dispatch)
    unit, units, size = "slice", "slices", f"{args.im_height}^2 x 3"
    if cli.is_3d(args):
        from boxsegliver_torch.data.sampler3d import Sampler3D
        cache, unit, units = None, "patch", "patches"
        size = f"{args.im_depth} x {args.im_height}^2"
        sampler = Sampler3D(ds, args, mode="train", seed=1)
    elif cli.is_inter(args):
        cache = None
        sampler = InterSampler(ds, args, mode="train", seed=1,
                               max_clicks=args.max_clicks)
    elif cli.is_iin(args):
        from boxsegliver_torch.data.sampler_iin import IinSampler
        cache = None
        sampler = IinSampler(ds, args, mode="train", seed=1)
    else:
        train_pids, _ = cli._split_pids(args, ds)
        cache = DeviceVolumeCache(ds, [int(p) for p in train_pids], "cuda",
                                  budget_gb=args.device_cache_gb)
        sampler = TrainSampler(ds, args, mode="train", seed=1,
                               zbase=cache.zbase)
    trainer = cli.build_trainer(args, torch.device("cuda"), cache=cache)
    data = TrainDataset(sampler, args, seed=args.seed, workers=1, prefetch=4)
    gflop = (3 * unet_gflop_per_slice(trainer.model, args.im_height,
                                      args.im_width)
             if args.model in ("UNet", "DenseUNet")
             else 3 * unet3d_gflop_per_patch(
                 trainer.model, (args.im_depth, args.im_height,
                                 args.im_width))
             if args.model == "UNet3D" else None)

    waits = []                  # host seconds per step spent on next(data)

    def window(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals, wait = [], 0.0
        for i in range(0, n, k):
            t1 = time.perf_counter()
            batches = [next(data) for _ in range(min(k, n - i))]
            wait += time.perf_counter() - t1
            vals += [v for _, v, _ in trainer.train_multi_step(batches)]
        host = torch.stack(vals).cpu()             # the drain's one fetch
        seconds = time.perf_counter() - t0
        if not torch.isfinite(host).all():
            raise AssertionError(f"non-finite train step values {host}")
        waits.append(wait / n)
        return seconds / n

    try:
        kernels.reset_launch_counts()
        window(3 if k == 1 else 2 * k)
        torch.cuda.synchronize()
        launches = {n: f.launches for n, f in kernels.KERNELS.items()}
        used = (set(kernels_used) if isinstance(kernels_used, tuple)
                else set(train_kernels()) if kernels_used else set())
        # a model other than GUNet: its layout follows its input (fold_nhwc)
        seen = (launches if any(n in NHWC_OF for n in used)
                else fold_nhwc(launches))
        if not all(bool(c) == (n in used) for n, c in seen.items()):
            raise AssertionError(f"{what}: kernel launches {launches}")
        walls = [window(16) for _ in range(3)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prof_wall = window(prof_steps)
        replay = {("metrics" if m else "no metrics"): c
                  for m, (_, c) in trainer._graphs.items()}
    finally:
        data.close()
        trainer.summary.close()
    kern, groups, self_us = kernel_groups(prof)
    if groups_out is not None:
        groups_out.update({n: v / 1e3 / prof_steps
                           for n, v in groups.items()})
    busy_ms = sum(groups.values()) / 1e3 / prof_steps
    share = max(busy_ms, 1e-9)
    wall = statistics.median(walls)
    sps = bs / wall
    model = args.model_config or f"{args.model}.yml"
    lines = [
        f"card: {smi()}",
        f"{what}: {model} full width, batch {bs}, {size}, "
        f"bf16, {args.normalizer or 'batch_norm'}, "
        f"{'host sampler' if cache is None else '--device_cache'}, noise "
        f"{args.noise_scale}, loss weights {args.loss_weight_type}, "
        f"{args.optimizer}, {args.opt_moment_dtype} moments, "
        f"--steps_per_dispatch {k}; launches in the warm-up {launches}",
        "ms/step over 3 windows of 16 steps: "
        + ", ".join(f"{w * 1e3:.3f}" for w in walls)
        + f" -> median {wall * 1e3:.3f} ms/step, {sps:.1f} {units}/s "
        f"(best {bs / min(walls):.1f}); host waiting for the sampler "
        + ", ".join(f"{w * 1e3:.3f}" for w in waits[1:4]) + " ms/step"]
    if gflop is not None:
        lines.append(
            f"analytic {gflop:.2f} GFLOP/{unit} (forward x 3) -> "
            f"{sps * gflop / 1e3:.1f} TFLOP/s, "
            f"{sps * gflop * 1e9 / BF16_FLOPS_PER_S:.1%} of the bf16 peak "
            f"({BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s; bound "
            f"{gflop * 1e9 / BF16_FLOPS_PER_S * 1e3:.4f} ms/{unit})")
    lines += [
        f"profiled window of {prof_steps} steps: {prof_wall * 1e3:.3f} "
        f"ms/step; host launches per step "
        f"{host_launches(prof) / prof_steps:.1f}; kernel launches per step "
        f"{sum(e.count for e in kern) / prof_steps:.0f}; kernel time "
        f"{busy_ms:.3f} ms/step -> busy {busy_ms / 1e3 / prof_wall:.1%} of "
        f"the profiled wall, {busy_ms / 1e3 / wall:.1%} of the unprofiled "
        f"median",
        f"hand-written kernel launches captured per replay: "
        f"{replay or 'no graph (eager steps)'}",
        ""] + [f"{n:50s} {v / 1e3 / prof_steps:9.3f} ms/step "
               f"{v / 1e3 / prof_steps / share:7.1%}"
               for n, v in groups.items()] + [
        "",
        f"{'kernel':90s} {'calls':>7s} {'ms/step':>9s} {'share':>7s}"]
    for e in kern[:top]:
        lines.append(f"{e.key[:90]:90s} {e.count:7d} "
                     f"{self_us(e) / 1e3 / prof_steps:9.3f} "
                     f"{self_us(e) / 1e3 / prof_steps / share:7.1%}")
    print("\n".join("  " + ln for ln in lines))
    del trainer, cache
    torch.cuda.empty_cache()
    return wall, launches, replay


def unet_bench_phase(tmp, seed):
    """The UNet train step in steady state at the 001_unet.sh flags (batch
    8, the smoke's dataset) and at the bench.py flags (batch 128, its data
    geometry: 4 cases of 24 x 512 x 512, k_folds 4)."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.data.synthetic import make_synthetic_dataset

    steady(cli.get_args(UNET_TRAIN_FLAGS + smoke_data(
        tmp, Path(tmp) / "unet_b8_md", "--device_cache")), Path(tmp) / "ds",
        "001_unet.sh train step")

    ds = Path(tmp) / "bench_ds"
    t0 = time.perf_counter()
    make_synthetic_dataset(ds, n_cases=4, shape=(24, 512, 512), k_split=4,
                           seed=seed, with_features=False)
    print(f"  bench dataset 4 x (24, 512, 512) in "
          f"{time.perf_counter() - t0:.1f} s")
    steady(cli.get_args(bench_argv(tmp)), ds, "bench.py step on the port")


def bench_knobs_phase(tmp):
    """The bench.py step with its two A/B knobs: bf16 Adam moments, and
    K = 16 steps a dispatch (a CUDA graph), alone and together; phase 11
    printed the step with neither."""
    from boxsegliver_torch.cli import main as cli

    walls = {}
    for moments, k in (("bfloat16", 1), ("float32", 16), ("bfloat16", 16)):
        walls[moments, k], _, _ = steady(
            cli.get_args(bench_argv(tmp, moments, k)), Path(tmp) / "bench_ds",
            f"bench.py step, {moments} moments, K={k}", prof_steps=16,
            top=8)
    print("  bench.py step ms/step (median of 3 windows of 16): " + "; ".join(
        f"{m} moments K={k} {w * 1e3:.3f}" for (m, k), w in walls.items())
        + f"; {smi()}")


def bench_argv(tmp, moments="float32", k=1):
    """bench.py's product_args on the port, with its two A/B knobs."""
    return [
        "liver", "--mode", "train", "--tag", "bench", "--model", "UNet",
        "--classes", "Liver", "Tumor", "--batch_size", "128",
        "--im_channel", "3", "--noise_scale", "0.1", "--random_flip", "3",
        "--test_fold", "0", "--k_folds", "4", "--num_of_total_steps",
        "1000000", "--model_dir", str(Path(tmp) / "bench_md"),
        "--host_workers", "1", "--log_step", "1000000", "--device_cache",
        "--opt_moment_dtype", moments, "--steps_per_dispatch", str(k),
        "--metrics_train_steps", "0", "--data_root", str(tmp), "--dataset",
        "bench_ds"]


def unet_eval_phase(tmp, ds, dev, md):
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.evaluators.device_eval import DeviceSlicePredictor
    from boxsegliver_torch.evaluators.eval_loader import parse_case_eval
    from boxsegliver_torch.evaluators.volume import EvaluateVolume

    argv = UNET_EVAL_FLAGS + smoke_data(tmp, md)
    results, seconds, launches = no_kernel_run(lambda: cli.main(argv),
                                               "UNet eval")
    want = {"Liver/Dice", "Liver/VOE", "Liver/RVD", "Tumor/Dice",
            "GLiverDice", "GTumorDice"}
    if not want <= set(results) or not all(math.isfinite(v)
                                           for v in results.values()):
        raise AssertionError(f"UNet eval results {results}")
    args = cli.get_args(argv)
    metas = cli._test_metas(args, ds)
    slices = sum(parse_case_eval(m, ds, parse_label=False).depth
                 for m in metas)
    model = cli.build_model_from_args(args, dev)
    evaluator = EvaluateVolume(args, ds, ["Background"] + list(args.classes))
    pred = DeviceSlicePredictor(model, args, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluator.run(pred, metas)
    warm = time.perf_counter() - t0
    preds = Path(tmp) / "unet_pred"                 # for phase 18's viewer
    evaluator.run(pred, metas, save=True, save_path=preds, do_eval=False)
    print("  UNet eval results: " + json.dumps(results))
    print(f"  UNet eval (001_unet eval flags, restored {args.restored_from}):"
          f" {len(metas)} cases, {slices} slices; through the CLI "
          f"{seconds / len(metas):.3f} s/case, {slices / seconds:.2f} "
          f"slices/s; warm {warm / len(metas):.3f} s/case, "
          f"{slices / warm:.2f} slices/s; launches {launches}; {smi()}")

    # device_case on the card against the CPU, float32, 8 slices of a case
    args32 = cli.get_args(argv + ["--compute_dtype", "float32"])
    case = parse_case_eval(metas[0], ds, parse_label=False)
    cut = cut_case(case, 0)
    out, logit = [], []
    for d in (dev, torch.device("cpu")):
        m = cli.build_model_from_args(args32, d)
        hook = m.AdjustChannels.register_forward_hook(
            lambda mod, i, o: logit.append(float(o.abs().max())))
        out.append(DeviceSlicePredictor(m, args32, device=d).device_case(cut))
        hook.remove()
    err = float(np.abs(out[0] - out[1]).max())
    print(f"  UNet device_case card vs CPU (float32, case {case.pid}, 8 "
          f"slices of 256^2, max |logit| {max(logit):.1f}): max abs err "
          f"{err:.2e}")
    if not err <= 1e-4:
        raise AssertionError("device_case on the card disagrees with the CPU")
    return preds


# ---------------------------------------------------------------------------
# phase 13: run_g's per-slice host loop (the overflow fallback, --device_sweep
# off, --save_sp_guide)
# ---------------------------------------------------------------------------

def cli_eval(argv, what):
    """One CLI eval run with the launch counters zeroed right before it;
    returns (results, seconds, launches)."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.ops import kernels

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not results or not all(math.isfinite(v) for v in results.values()):
        raise AssertionError(f"{what}: results {results}")
    return results, seconds, {n: fn.launches
                              for n, fn in kernels.KERNELS.items()}


def host_loop_phase(tmp, ds, dev, seed):
    """(a) A seeded random init at full width speckles more tumor components
    than the sweep's cap of 16: the sweep reports the overflow and run_g
    finishes each case through the host loop (B1 once per slice and
    direction).  (b) The liver-margin weights of phase 5 through the CLI
    with --device_sweep on and off (metrics within 1e-3) and with
    --save_sp_guide (the guide volumes are written).  (c) The fitted small
    GUNet of phase 5 at 64^2 in float32: the host loop against the device
    sweep on the card, merged probabilities within 1e-4 and equal tumor
    component counts per slice."""
    from scipy import ndimage as ndi

    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.evaluators.eval_loader import (load_eval_context,
                                                          parse_case_eval)
    from boxsegliver_torch.evaluators.volume import EvaluateVolume
    from boxsegliver_torch.interactive.device_sweep import GuidedSweepPredictor
    from boxsegliver_torch.models import MODEL_CONFIGS, build_model

    base = FLAGS + ["--data_root", str(tmp), "--dataset", "ds",
                    "--k_folds", "2", "--test_fold", "0"]
    args = cli.get_args(base + ["--model_dir", str(Path(tmp) / "hl_md")])
    metas = cli._test_metas(args, ds)
    slices = sum(parse_case_eval(m, ds, parse_label=False).depth
                 for m in metas)
    prior = json.loads((Path(ds) / "prior.json").read_text())

    model = build_model("GUNet", args=args,
                        model_kwargs=MODEL_CONFIGS["GUNet.yml"])
    model.reset_parameters(torch.Generator().manual_seed(seed))
    random_w = Path(tmp) / "gunet_random.pt"
    torch.save(model.state_dict(), random_w)
    case = parse_case_eval(metas[0], ds)
    ctx = load_eval_context(ds, case.pid, [("hist", 200)], 20.0)
    pred = GuidedSweepPredictor(model.to(dev).eval(), args, num_classes=3,
                                tumor_id=2, device=dev)
    probs, n_objs = pred.sweep_case(case, prior[str(case.pid)], ctx)
    if probs is not None:
        raise AssertionError(f"the random init did not overflow the sweep "
                             f"({n_objs} objects)")
    del pred, model
    res, sec, launches = cli_eval(base + [
        "--model_dir", str(Path(tmp) / "hl_random"), "--ckpt_path",
        str(random_w)], "run_g overflow")
    if launches["gaussian_guide_batch"] < 2 * slices:
        raise AssertionError(f"B1 launched {launches['gaussian_guide_batch']}"
                             f" times for {slices} slices x 2 directions")
    print(f"  run_g, random init (overflow: {n_objs} objects on a slice of "
          f"case {case.pid}, cap 16): {len(metas)} cases, {slices} slices "
          f"through the sweep and then the host loop in "
          f"{sec / len(metas):.3f} s/case; launches {launches}; results "
          + json.dumps(res))

    margin = ["--ckpt_path", str(Path(tmp) / "gunet_seed.pt")]
    runs = {}
    for name, extra in (("on", []), ("off", ["--device_sweep", "off"]),
                        ("save_sp_guide", ["--save_sp_guide"])):
        md = Path(tmp) / f"hl_{name}"
        runs[name] = cli_eval(base + margin + ["--model_dir", str(md)] + extra,
                              f"run_g {name}")
        print(f"  run_g liver-margin weights, --device_sweep "
              f"{'off' if name == 'off' else 'on'}"
              f"{' --save_sp_guide' if name == 'save_sp_guide' else ''}: "
              f"{runs[name][1] / len(metas):.3f} s/case, "
              f"{slices / runs[name][1]:.2f} slices/s, launches "
              f"{runs[name][2]}; {smi()}")
    for k, v in runs["on"][0].items():
        for name in ("off", "save_sp_guide"):
            if abs(runs[name][0][k] - v) > 1e-3:
                raise AssertionError(f"run_g {name} {k} {runs[name][0][k]} "
                                     f"vs the device sweep's {v}")
    if runs["off"][2]["gaussian_guide_batch"] < 2 * slices:
        raise AssertionError("--device_sweep off: B1 launched "
                             f"{runs['off'][2]['gaussian_guide_batch']} times")
    for m in metas:
        for d in "FB":
            f = (Path(tmp) / "hl_save_sp_guide" / "sp_guide"
                 / f"guide-{d}-{m['PID']}.nii.gz")
            if not f.exists():
                raise AssertionError(f"--save_sp_guide did not write {f}")

    no_context = (FLAGS[:FLAGS.index("--use_context")]
                  + FLAGS[FLAGS.index("--use_spatial"):])
    args64 = cli.get_args(no_context + [
        "--im_height", "64", "--im_width", "64", "--compute_dtype", "float32",
        "--sweep_max_objects", "64", "--model_dir", str(Path(tmp) / "hl64")])
    cases = [parse_case_eval(m, ds, im_channel=3) for m in metas]
    small, _ = fit_tiny_gunet(args64, cases[0], dev, seed)
    pred = GuidedSweepPredictor(small, args64, num_classes=3, tumor_id=2,
                                device=dev)
    ev = EvaluateVolume(args64, ds, ["Liver", "Tumor"])
    for c in cases:
        pc = prior[str(c.pid)]
        t0 = time.perf_counter()
        dev_probs, n_max = pred.sweep_case(c, pc, None)
        t1 = time.perf_counter()
        host = ev._sweep_case_host(pred, c, pc, None, tumor_id=2)
        t2 = time.perf_counter()
        if dev_probs is None:
            raise AssertionError(f"sweep overflow at 64^2: {n_max}")
        err = float(np.abs(host - dev_probs).max())
        counts = [[ndi.label(sl == 2)[1] for sl in v.argmax(-1)]
                  for v in (host, dev_probs)]
        print(f"  host loop vs device sweep on the card (case {c.pid}, 64^2 "
              f"float32, fitted GUNet): max abs err {err:.2e}, tumor "
              f"components {sum(counts[0])} / {sum(counts[1])}; sweep "
              f"{t1 - t0:.3f} s, host loop {t2 - t1:.3f} s")
        if not err <= 1e-4 or counts[0] != counts[1]:
            raise AssertionError("the host loop disagrees with the sweep")
    return launches


# ---------------------------------------------------------------------------
# phase 14: --steps_per_dispatch 16 (the train step as a CUDA graph)
# ---------------------------------------------------------------------------

def graph_vs_eager(tmp, dev, noisy: bool):
    """2K = 32 flagship train steps (full width, batch 8, bf16, the
    streaming sampler's batches) as two dispatches of a captured step
    against 32 eager K = 1 steps from the same weights and batches.  Quiet
    (noise 0, flips 0, side dropout 0): per-step loss within 1e-4 relative
    and all parameters together within 1e-4 in relative L2 norm (a float32
    reduction may sum in another order from run to run, and Adam turns a
    gradient within round-off of 0 into ±lr: a small tensor alone can
    differ by more); the worst single tensor is printed beside it.  Noisy:
    whether the graph's draws equal the eager steps' is printed."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.data.sampler import TrainSampler

    quiet = [] if noisy else ["--noise_scale", "0", "--random_flip", "0",
                              "--side_dropout", "0"]
    out = {}
    for k in (16, 1):
        args = cli.get_args(smoke_train_argv(
            tmp, 32, "--steps_per_dispatch", str(k), "--model_dir",
            str(Path(tmp) / f"gve{k}"), *quiet))
        sampler = TrainSampler(Path(tmp) / "ds", args, seed=5)
        rng = np.random.RandomState(5)
        batches = [sampler.sample_batch(8, rng=rng) for _ in range(32)]
        trainer = cli.build_trainer(args, dev)
        vals = []
        for i in range(0, 32, k):
            vals += [v for _, v, _ in trainer.train_multi_step(
                batches[i:i + k])]
        out[k] = (torch.stack(vals).cpu(),
                  {n: v.detach().float().cpu()
                   for n, v in trainer.model.state_dict().items()})
        trainer.summary.close()
        del trainer
        torch.cuda.empty_cache()
    loss_err = float(((out[16][0][:, 0] - out[1][0][:, 0]).abs()
                      / out[1][0][:, 0].abs()).max())
    graphed, eager = out[16][1], out[1][1]
    p_err = float(torch.cat([(graphed[n] - v).flatten()
                             for n, v in eager.items()]).norm()
                  / torch.cat([v.flatten() for v in eager.values()]).norm())
    worst = max(float((graphed[n] - v).norm() / max(float(v.norm()), 1e-12))
                for n, v in eager.items())
    same = torch.equal(out[16][0][:, :2], out[1][0][:, :2])
    what = "noise, flips, dropout on" if noisy else "noise, flips, dropout 0"
    print(f"  graph (K=16) vs eager (K=1), 32 flagship steps, {what}: loss "
          f"per step max rel err {loss_err:.2e}, parameters relative L2 "
          f"err {p_err:.2e} (worst tensor {worst:.2e}), losses bit-equal: "
          f"{same}")
    if not noisy and not (loss_err <= 1e-4 and p_err <= 1e-4):
        raise AssertionError("the graphed train step disagrees with the "
                             "eager one")
    return same


def dispatch_phase(tmp, dev):
    """The 002_gnet_sp.sh and 001_unet.sh train flags with
    --steps_per_dispatch 16 through the CLI (32 steps with --device_cache,
    a resume to 48 on the streaming sampler); the graph against eager
    steps; K = 1 against K = 16 in steady state at batch 8."""
    from boxsegliver_torch.cli import main as cli

    md = Path(tmp) / "train16_md"
    k16 = ["--steps_per_dispatch", "16", "--model_dir", str(md)]
    trainer, launches, seconds = train_run(
        smoke_train_argv(tmp, 32, "--device_cache", *k16), 32)
    replay = {("metrics" if m else "no metrics"): c
              for m, (_, c) in trainer._graphs.items()}
    if trainer.global_step != 32 or len(trainer._graphs) != 2:
        raise AssertionError(f"K=16 train: step {trainer.global_step}, "
                             f"{len(trainer._graphs)} captured variants")
    lines = [json.loads(ln) for ln in
             (md / "summaries" / "metrics.jsonl").read_text().splitlines()]
    loss = {ln["step"]: ln["value"] for ln in lines
            if ln["tag"] == "chip_smoke_train/loss"}
    evals = sorted({ln["step"] for ln in lines
                    if ln["tag"].startswith("chip_smoke_train/eval/")})
    if not all(math.isfinite(v) for v in loss.values()) or evals != [16, 32]:
        raise AssertionError(f"K=16 train: loss {loss}, evals at {evals}")
    print(f"  G-Net train, --steps_per_dispatch 16 (--device_cache): 32 "
          f"steps in {seconds:.2f} s with set-up, 3 eager warm-up steps, two "
          f"captures and two online evals (at {evals}); launches {launches};"
          f" per replay {replay}; loss "
          + ", ".join(f"{s}: {loss[s]:.4f}" for s in sorted(loss)))
    del trainer
    again, launches2, seconds2 = train_run(smoke_train_argv(tmp, 48, *k16),
                                           16)
    if again.global_step != 48 or not (md / "ckpt" / "48" / "state.pt").exists():
        raise AssertionError(f"K=16 resume ended at {again.global_step}")
    print(f"  K=16 resume on the streaming sampler: steps 33-48 in "
          f"{seconds2:.2f} s, launches {launches2}")
    del again

    umd = Path(tmp) / "unet16_md"
    uargv = UNET_TRAIN_FLAGS + smoke_data(
        tmp, umd, "--batches_per_epoch", "12", "--eval_3d", "--eval_num",
        "1", "--log_step", "4", "--steps_per_dispatch", "16")
    utrainer, useconds, _ = no_kernel_run(
        lambda: cli.main(uargv + ["--num_of_steps", "32", "--device_cache"]),
        "UNet K=16 train")
    if utrainer.global_step != 32 or not utrainer._graphs:
        raise AssertionError(f"UNet K=16 train ended at "
                             f"{utrainer.global_step}")
    del utrainer
    uagain, useconds2, _ = no_kernel_run(
        lambda: cli.main(uargv + ["--num_of_steps", "48"]), "UNet K=16 resume")
    if uagain.global_step != 48:
        raise AssertionError(f"UNet K=16 resume ended at "
                             f"{uagain.global_step}")
    del uagain
    print(f"  UNet train, --steps_per_dispatch 16: 32 steps in "
          f"{useconds:.2f} s (--device_cache, inline volume evals), resume "
          f"to 48 in {useconds2:.2f} s; launches 0")

    graph_vs_eager(tmp, dev, noisy=False)
    graph_vs_eager(tmp, dev, noisy=True)

    ds = Path(tmp) / "ds"
    walls = {}
    for name, flags in (("G-Net", TRAIN_FLAGS), ("UNet", UNET_TRAIN_FLAGS)):
        for k in (1, 16):
            args = cli.get_args(flags + smoke_data(
                tmp, Path(tmp) / f"steady_{name}_{k}", "--device_cache",
                "--steps_per_dispatch", str(k)))
            walls[name, k], _, _ = steady(
                args, ds, f"{name} train step, K={k}",
                kernels_used=name == "G-Net", prof_steps=16, top=8)
    print("  ms/step (median of 3 windows of 16), K=1 -> K=16: " + "; ".join(
        f"{n} {walls[n, 1] * 1e3:.3f} -> {walls[n, 16] * 1e3:.3f}"
        for n in ("G-Net", "UNet")) + f"; {smi()}")
    return launches


def weights_card_vs_cpu(tmp, dev, seed):
    """Phase 8's card-against-CPU train step with the boundary and the
    proportion loss weights."""
    for w_type in ("boundary", "proportion"):
        print(f"  --loss_weight_type {w_type}:")
        train_card_vs_cpu(tmp, dev, seed, "--loss_weight_type", w_type)


def determinism_run(tmp: str, seed: int):
    """Run in a child process whose CUBLAS_WORKSPACE_CONFIG was set before
    CUDA started: the tiny float32 G-Net of tests/test_torch_cuda.py
    (GUNet_TINY, 64^2, batch 2, TF32 off) trained twice for 6 eager steps
    from the same --seed and batches, under deterministic algorithms
    (cuDNN deterministic, warn_only, so an op without a deterministic CUDA
    version is named, not fatal), then twice without them; prints whether
    each pair is bit-equal and, where not, the first parameter that
    differs."""
    import warnings

    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.config import resolve_device
    from boxsegliver_torch.data.sampler import TrainSampler
    from boxsegliver_torch.data.synthetic import make_synthetic_dataset

    dev = resolve_device("cuda")
    ds = Path(tmp) / "det_ds"
    make_synthetic_dataset(ds, n_cases=4, shape=(8, 64, 64), k_split=2,
                           seed=1)
    argv = ["liver", "--mode", "train", "--tag", "t", "--model", "GUNet",
            "--model_config", "GUNet_TINY.yml", "--classes", "Liver",
            "Tumor", "--k_folds", "2", "--test_fold", "0", "--im_height",
            "64", "--im_width", "64", "--normalizer", "instance_norm",
            "--use_context", "--context_list", "hist", "200",
            "--use_spatial", "--min_std", "2", "--batch_size", "2",
            "--compute_dtype", "float32", "--log_step", "2", "--seed",
            str(seed), "--data_root", str(tmp), "--dataset", "det_ds"]

    def run(i):
        args = cli.get_args(argv + ["--model_dir", str(Path(tmp) / f"det{i}")])
        sampler = TrainSampler(ds, args, seed=3)
        rng = np.random.RandomState(3)
        batches = [sampler.sample_batch(2, rng=rng) for _ in range(6)]
        trainer = cli.build_trainer(args, dev)
        losses = [float(v[0]) for _, v, _ in
                  (trainer.train_multi_step([b])[0] for b in batches)]
        params = {k: v.detach().cpu().clone()
                  for k, v in trainer.model.state_dict().items()}
        trainer.summary.close()
        return losses, params

    for mode in ("deterministic", "default"):
        on = mode == "deterministic"
        torch.use_deterministic_algorithms(on, warn_only=True)
        torch.backends.cudnn.deterministic = on
        torch.backends.cudnn.benchmark = False
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            (l1, p1), (l2, p2) = run(f"{mode}_a"), run(f"{mode}_b")
        ops = sorted({str(w.message).split(" does not have")[0]
                      for w in caught if "deterministic" in str(w.message)})
        differ = [k for k in p1 if not torch.equal(p1[k], p2[k])]
        first = ""
        if differ:
            k = differ[0]
            err = float((p1[k] - p2[k]).norm() / max(float(p1[k].norm()),
                                                     1e-30))
            first = (f"; first differing parameter {k} (relative L2 "
                     f"{err:.2e}), {len(differ)} of {len(p1)} differ")
        print(f"  --seed {seed} twice, 6 eager float32 steps, {mode} "
              f"algorithms: losses bit-equal {l1 == l2}, parameters "
              f"bit-equal {not differ}{first}; ops without a deterministic "
              f"CUDA version: {ops or 'none'}; {smi()}")
        if mode == "deterministic":
            print(json.dumps({"determinism": {"seed_reproduces_float32_run":
                                              not differ and l1 == l2,
                                              "first_differing": differ[:1],
                                              "nondeterministic_ops": ops}}))


def determinism_phase(tmp, seed):
    """determinism_run in a child process with CUBLAS_WORKSPACE_CONFIG
    set before CUDA starts there."""
    import os

    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--determinism", str(tmp), "--seed", str(seed)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    print(res.stdout, end="")
    if res.returncode != 0:
        raise RuntimeError(f"the determinism run failed: {res.stderr[-3000:]}")


# ---------------------------------------------------------------------------
# phase 17: serving — --mode export and the REST server over the bundle
# ---------------------------------------------------------------------------

# full-affine instance-norm + ReLU pairs of one GUNet.yml forward (kernel
# B2-fwd): the two of the unmodulated first level and the eight of the
# decoder
GUNET_B2_PAIRS = 10
# modulated blocks of one GUNet.yml (and GUNet_IIN.yml) forward, levels 1-4
# (kernel B3: one B3-fwd a forward, one B3-bwd a backward; under a spatial
# shard B3's split form, its statistics from B2s)
GUNET_MOD_BLOCKS = 8


def expect_b3_forwards(what, launches):
    """A no-grad GUNet.yml path (the sweep, serving): one B3-fwd for each
    of the 8 modulated blocks of every forward, whose 10 other pairs
    launch B2-fwd, all on the NHWC plans (GUNet's activations are
    channels-last), and no B3-bwd."""
    fwd, b2 = launches["modnorm_relu_fwd_nhwc"], launches["in_relu_fwd_nhwc"]
    if not fwd or fwd * GUNET_B2_PAIRS != b2 * GUNET_MOD_BLOCKS or any(
            launches[n] for n in ("modnorm_relu_bwd", "modnorm_relu_bwd_nhwc",
                                  "modnorm_relu_fwd", "in_relu_fwd")):
        raise AssertionError(f"{what}: B3 launches {launches}, expected "
                             f"{GUNET_MOD_BLOCKS} B3-fwd for every "
                             f"{GUNET_B2_PAIRS} B2-fwd and no B3-bwd")


def serve_features(sig, n, seed):
    """n slices of seeded features at the signature's shapes: images in
    [0, 1), guides in [0.25, 0.75), context in [0, 1)."""
    rng = np.random.default_rng(seed)
    feats = {}
    for key, (shape, dtype) in sig["inputs"].items():
        arr = rng.random((n,) + tuple(shape[1:]), dtype=np.float32)
        feats[key] = (arr * 0.5 + 0.25 if key == "sp_guide" else arr).astype(
            dtype)
    return feats


def _post(url, body, ctype):
    import urllib.request

    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=300) as r:
        if r.status != 200:
            raise AssertionError(f"{url}: HTTP {r.status}")
        return r.read()


def _post_timed(port, path, body, ctype):
    """One POST on a fresh connection, as a simple client sends it; returns
    (response body, seconds to send the request, seconds from the last
    byte sent to the response's headers, seconds to read the body)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, body=body, headers={"Content-Type": ctype})
        t1 = time.perf_counter()
        resp = conn.getresponse()
        t2 = time.perf_counter()
        raw = resp.read()
        t3 = time.perf_counter()
    finally:
        conn.close()
    if resp.status != 200:
        raise AssertionError(f"{path}: HTTP {resp.status}")
    return raw, t1 - t0, t2 - t1, t3 - t2


def _npz(**arrays) -> bytes:
    import io

    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def serve_bundle(bundle, what, requests=20, seed=0):
    """Serve ``bundle`` on the card with make_server(port=0) in a thread:
    ``requests`` npz requests of one exported batch (launch counters zeroed
    right before them), one of 2.5 batches (chunked and padded), one JSON
    request of one slice.  Returns (the first batch's features, its
    response, the launches of the ``requests`` requests, per request)."""
    import io
    import logging
    import threading

    from boxsegliver_torch.cli.serve import make_server
    from boxsegliver_torch.ops import kernels

    logging.getLogger("boxsegliver.serve").setLevel(logging.WARNING)
    threads = sorted(t.name for t in threading.enumerate())
    t0 = time.perf_counter()
    srv = make_server(bundle, host="127.0.0.1", port=0, device="cuda")
    load_s = time.perf_counter() - t0
    runner = srv.RequestHandlerClass.runner
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = (f"http://127.0.0.1:{srv.server_address[1]}/v1/models/"
               f"{runner.name}:predict")
        bs = runner.batch
        feats = serve_features(runner.signature, bs, seed)
        body = _npz(**feats)
        path = f"/v1/models/{runner.name}:predict"
        port = srv.server_address[1]
        for _ in range(2):                        # warm-up
            _post(url, body, "application/x-npz")
        kernels.reset_launch_counts()
        walls, legs = [], []
        for _ in range(requests):
            t0 = time.perf_counter()
            raw, *leg = _post_timed(port, path, body, "application/x-npz")
            walls.append(time.perf_counter() - t0)
            legs.append(leg)
        launches = {n: fn.launches for n, fn in kernels.KERNELS.items()}
        with np.load(io.BytesIO(raw)) as z:
            probs = z["predictions"]
        n_big = 5 * bs // 2
        big = serve_features(runner.signature, n_big, seed + 1)
        kernels.reset_launch_counts()
        with np.load(io.BytesIO(_post(url, _npz(**big),
                                      "application/x-npz"))) as z:
            big_probs = z["predictions"]
        big_fwd = (kernels.in_relu_fwd.launches
                   + kernels.in_relu_fwd_nhwc.launches)
        one = {k: v[:1].tolist() for k, v in feats.items()}
        js = json.loads(_post(url, json.dumps({"inputs": one}).encode(),
                              "application/json"))
        js_probs = np.asarray(js["predictions"], np.float32)
    finally:
        srv.shutdown()
        srv.server_close()
    shape = tuple(runner.signature["inputs"]["images"][0][1:-1])
    shape += (len(runner.signature["classes"]),)
    if (probs.shape != (bs,) + shape
            or big_probs.shape != (n_big,) + shape
            or js_probs.shape != (1,) + shape
            or not all(np.isfinite(a).all()
                       for a in (probs, big_probs, js_probs))):
        raise AssertionError(f"{what}: responses {probs.shape}, "
                             f"{big_probs.shape}, {js_probs.shape}")
    # the JSON slice is padded with copies of itself: each row depends only
    # on its own inputs, so it gives the first slice's probabilities within
    # one bf16 rounding step (b2_check's bound)
    err_pad = np.abs(js_probs[0] - probs[0])
    if not (np.abs(probs.sum(-1) - 1.0).max() <= 1e-3
            and (err_pad <= 2.0 ** -7 * np.abs(probs[0]) + 1e-5).all()):
        raise AssertionError(f"{what}: probabilities do not sum to 1 or the "
                             f"padded JSON slice differs by "
                             f"{float(err_pad.max()):.2e}")
    dev_feats = {k: torch.from_numpy(v).cuda() for k, v in feats.items()}
    fwd_ms = cuda_ms(lambda: runner.serve(dev_feats), iters=20, warmup=3)
    walls.sort()
    med = statistics.median(walls)
    # one request's host layers, each the median of 5: the client's npz
    # encode, the runner (validate, copy in, forward, copy out), the
    # response's npz encode and the client's decode; the rest is HTTP and
    # the server's decode
    resp = _npz(predictions=probs)
    parts = {}
    for name, fn in (("client encode", lambda: _npz(**feats)),
                     ("predict", lambda: runner.predict(feats)),
                     ("response encode", lambda: _npz(predictions=probs)),
                     ("client decode", lambda: np.load(io.BytesIO(resp))[
                         "predictions"])):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        parts[name] = statistics.median(times) * 1e3
    parts["rest (HTTP, server decode)"] = med * 1e3 - sum(parts.values())
    leg_ms = [statistics.median(leg[i] for leg in legs) * 1e3
              for i in range(3)]
    per_req = {n: c / requests for n, c in launches.items()}
    print(f"  {what}: bundle loaded in {load_s:.2f} s; {requests} npz "
          f"requests of {bs} slices: {med * 1e3:.3f} ms/request median "
          f"(min {walls[0] * 1e3:.3f}, max {walls[-1] * 1e3:.3f}), "
          f"{requests * bs / sum(walls):.2f} slices/s; forward alone "
          f"{fwd_ms:.3f} ms ({bs / fwd_ms * 1e3:.2f} slices/s); launches per "
          f"request {per_req}; {n_big} slices in one request ({-(-n_big // bs)}"
          f" chunks): B2-fwd {big_fwd}; JSON request of 1 slice ok; {smi()}")
    print(f"  {what}: one request's host layers (ms, medians of 5): "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f"; bytes in {len(body)}, out {len(resp)}; client side (medians "
          f"of the {requests}): send {leg_ms[0]:.3f}, wait for the response "
          f"{leg_ms[1]:.3f}, read it {leg_ms[2]:.3f}; "
          f"threads before the server started: {threads}")
    return feats, probs, launches, per_req


def serve_phase(tmp, dev, seed, unet_md):
    """Export the flagship GUNet (002_gnet_sp.sh eval flags, phase 5's
    seeded init) and the headline UNet (001_unet.sh eval flags, phase 10's
    best checkpoint) through the CLI on the card; serve each; hold the
    GUNet's response against the eager model on the card; a small float32
    bundle exported on the card, served on the CPU and on the card."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.cli.export import load_exported

    gmd = Path(tmp) / "serve_gunet_md"
    model = cli._build_model(cli.get_args(FLAGS + ["--model_dir", str(gmd)]))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    weights = Path(tmp) / "gunet_init.pt"
    torch.save(model.state_dict(), weights)
    export_flags = ["export" if a == "eval" else a for a in FLAGS]
    t0 = time.perf_counter()
    gbundle = cli.main(export_flags + ["--model_dir", str(gmd),
                                       "--ckpt_path", str(weights)])
    g_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    uargv = ["export" if a == "eval" else a for a in UNET_EVAL_FLAGS]
    ubundle = cli.main(uargv + smoke_data(tmp, unet_md))
    u_s = time.perf_counter() - t0
    sizes = {b.parent.name: sum(f.stat().st_size for f in b.iterdir())
             for b in (gbundle, ubundle)}
    print(f"  exported GUNet.yml (002_gnet_sp eval flags, batch 8, 256^2, "
          f"bf16) in {g_s:.2f} s and UNet.yml (001_unet eval flags, "
          f"{json.loads((ubundle / 'signature.json').read_text())['inputs']})"
          f" in {u_s:.2f} s on the card; bundle bytes {sizes}")

    feats, probs, glaunch, gper = serve_bundle(gbundle, "serve GUNet",
                                               seed=seed)
    if gper["in_relu_fwd_nhwc"] < GUNET_B2_PAIRS:
        raise AssertionError(f"GUNet serving launched B2-fwd "
                             f"{gper['in_relu_fwd_nhwc']} times per 8-slice "
                             f"request ({GUNET_B2_PAIRS} pairs per forward)")
    expect_b3_forwards("GUNet serving", gper)
    _, _, ulaunch, _ = serve_bundle(ubundle, "serve UNet", seed=seed)
    if any(ulaunch.values()):
        raise AssertionError(f"the batch-norm UNet bundle launched {ulaunch}")

    live = cli.build_model_from_args(cli.get_args(
        FLAGS + ["--model_dir", str(gmd), "--ckpt_path", str(weights)]), dev)
    with torch.no_grad():
        want = torch.softmax(live({k: torch.from_numpy(v).to(dev)
                                   for k, v in feats.items()}), -1).cpu()
    err = (torch.from_numpy(probs) - want).abs()
    bad = err > 2.0 ** -7 * want.abs() + 1e-5        # b2_check's bf16 bound
    print(f"  GUNet response vs the eager model + softmax on the card "
          f"(bf16): max abs err {float(err.max()):.3e}, {int(bad.sum())} "
          f"elements beyond one bf16 rounding step")
    if bool(bad.any()):
        raise AssertionError("the served GUNet disagrees with the eager "
                             "model")
    del live

    small = cli.main(["export" if a == "eval" else a for a in FLAGS] + [
        "--model_dir", str(Path(tmp) / "serve_small_md"), "--im_height",
        "64", "--im_width", "64", "--model_config", "GUNet_TINY.yml",
        "--compute_dtype", "float32", "--batch_size", "2"])
    sfeats = serve_features(json.loads((small / "signature.json")
                                       .read_text()), 2, seed + 2)
    on_cpu, _ = load_exported(small, "cpu")
    on_card, _ = load_exported(small, "cuda")
    err = float((on_card(sfeats).cpu() - on_cpu(sfeats)).abs().max())
    print(f"  one bundle (GUNet_TINY, 64^2, float32, exported on the card) "
          f"served on the card vs the CPU: max abs err {err:.2e}; {smi()}")
    if not err <= 1e-4:
        raise AssertionError("the bundle served on the card disagrees with "
                             "the CPU")
    return glaunch, ubundle


# ---------------------------------------------------------------------------
# phase 18: prepare -> annotate -> viewers on the card
# ---------------------------------------------------------------------------

# two LiTS-like cases at the LiTS plane size; pid 49 is inside the quirk's
# label range (28-51) and outside its volume range (28-47)
LITS_SHAPE = (64, 512, 512)
LITS_PIDS = (7, 49)


def _get(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=300) as r:
        return json.loads(r.read())


def _timed_get(url, n=5):
    """(the payload, the median of n GETs in ms)."""
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = _get(url)
        walls.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(walls)


def prepare_phase(tmp, seed):
    """Write LITS_PIDS as NIfTI (int16 volumes, uint8 labels, stored in the
    LiTS orientation) and run the port's prepare CLI over them: extract,
    hist, glcm, prior, kfold, infer_context; s/case for each; the cache
    holds the arrays the right way up."""
    import contextlib

    from boxsegliver_torch.cli import prepare
    from boxsegliver_torch.data import nii
    from boxsegliver_torch.data.meta import load_meta, window_clip_uint16
    from boxsegliver_torch.data.synthetic import make_case

    src, dst = Path(tmp) / "lits_nii", Path(tmp) / "lits"
    src.mkdir()
    rng = np.random.default_rng(seed)
    cases = {}
    t0 = time.perf_counter()
    for pid in LITS_PIDS:
        vol, lab, spacing = make_case(rng, LITS_SHAPE)
        nii.write_nii(vol, src / f"volume-{pid}.nii", zooms=spacing,
                      special=28 <= pid < 48)
        nii.write_nii(lab, src / f"segmentation-{pid}.nii", zooms=spacing,
                      special=28 <= pid < 52)
        cases[pid] = (vol, lab)
    print(f"  wrote {len(LITS_PIDS)} NIfTI cases of {LITS_SHAPE} int16 "
          f"(pids {LITS_PIDS}) in {time.perf_counter() - t0:.2f} s")
    per_case = {}
    for argv in (["extract", "--src", str(src)], ["hist"], ["glcm"],
                 ["prior"], ["kfold", "--k", "2"],
                 ["infer_context", "--guide_file", str(dst / "prior.json")]):
        t0 = time.perf_counter()
        with open(Path(tmp) / "prepare.log", "a") as log, \
                contextlib.redirect_stdout(log):
            prepare.main(argv[:1] + ["--dst", str(dst)] + argv[1:])
        per_case[argv[0]] = (time.perf_counter() - t0) / len(LITS_PIDS)
    print("  prepare s/case at " + "x".join(map(str, LITS_SHAPE)) + ": "
          + ", ".join(f"{k} {v:.3f}" for k, v in per_case.items())
          + f"; {smi()}")
    if [m["PID"] for m in load_meta(dst)] != list(LITS_PIDS):
        raise AssertionError("prepare extract: meta.json lists "
                             f"{[m['PID'] for m in load_meta(dst)]}")
    for pid, (vol, lab) in cases.items():
        d = dst / f"volume-{pid}"
        if not (np.array_equal(np.load(d / "segmentation.npy"), lab) and
                np.array_equal(np.load(d / "volume.npy"),
                               window_clip_uint16(vol))):
            raise AssertionError(f"prepare extract: case {pid}'s cache is "
                                 "not the volume written (LiTS quirk)")
    for rel in ("feat/hist/eval", "feat/glcm/eval", "feat/hist/infer"):
        if len(list((dst / rel).glob("*.npy"))) != len(LITS_PIDS):
            raise AssertionError(f"prepare: {rel} incomplete")
    return dst


def annotate_phase(tmp, dev, seed, lits, ds, unet_preds, unet_bundle,
                   unet_md):
    """Serve ``lits`` with cli/annotate.make_server(port=0) on the card, the
    002_gnet_sp eval flags at GUNet.yml full width after ``--`` with phase
    8's trained weights (its output depends on the guide): state, slice
    payloads (ms), an interaction and its preview (one B1 launch), save,
    two Predicts (s, launches), then the interaction popped and a third
    Predict, whose map must differ; the guided map against ``cli.main
    --mode infer --real_sp`` (equal) and compare_preds (--min_dice 1.0);
    the preview drawn by B1 against the plain version;
    then the viewer over phase 12's predictions, vis over phase 17's UNet
    bundle and ckpt_tools list on phase 10's checkpoint.  Returns the
    launches of the annotate path (the preview GET and the two Predicts)."""
    import contextlib
    import io
    import logging
    import threading

    from boxsegliver_torch.cli import annotate, compare_preds, viewer, vis
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.data import nii
    from boxsegliver_torch.data.kfold import (read_or_create_k_folds,
                                              train_test_split)
    from boxsegliver_torch.data.meta import load_meta
    from boxsegliver_torch.ops import kernels
    from boxsegliver_torch.utils import ckpt_tools

    logging.getLogger("boxsegliver.annotate").setLevel(logging.WARNING)
    # phase 8's G-Net after 30 steps: unlike phase 5's liver-margin weights
    # its class map depends on the guide
    weights = Path(tmp) / "train_md" / "ckpt" / "30" / "state.pt"
    folds = read_or_create_k_folds(lits / "k_folds.txt", [])
    pid = int(train_test_split(folds, 0)[1][0])
    meta = next(m for m in load_meta(lits) if m["PID"] == pid)
    data = ["--data_root", str(lits.parent), "--dataset", lits.name,
            "--k_folds", "2", "--test_fold", "0", "--ckpt_path", str(weights)]
    app = annotate.AnnotateApp(
        lits, interactions_file=Path(tmp) / "annotate" / "interactions.json",
        model_argv=FLAGS + data + ["--model_dir",
                                   str(Path(tmp) / "annotate_md")])
    if app.device.type != "cuda":
        raise AssertionError(f"the annotator defaults to {app.device}")
    srv = annotate.make_server(app, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        state = _get(base + "/api/state")
        if [c["pid"] for c in state["cases"]] != list(LITS_PIDS) or \
                not state["has_model"]:
            raise AssertionError(f"annotate state: {state['cases']}")
        ms = {}
        for axis, n in zip("zyx", meta["size"]):
            s, ms[axis] = _timed_get(
                f"{base}/api/slice?pid={pid}&axis={axis}&i={n // 2}")
            if not {"img", "gt"} <= set(s) or s["n"] != n:
                raise AssertionError(f"annotate slice {axis}: {sorted(s)}")
        prior = json.loads((lits / "prior.json").read_text())[str(pid)]
        sid, objs = next(iter(prior.items()))
        o = objs[0]
        _post(base + "/api/interaction", json.dumps({
            "pid": pid, "sid": int(sid), "center": o["center"],
            "radius": [v / annotate.ELLIPSE_TO_STD for v in o["stddev"]],
            "z": o["z"]}).encode(), "application/json")
        url = f"{base}/api/slice?pid={pid}&axis=z&i={sid}"
        _, ms["z + preview"] = _timed_get(url)

        # the annotate path: one preview GET, then two Predicts
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        s = _get(url)
        torch.cuda.synchronize()
        b1 = kernels.gaussian_guide_batch.launches
        if "guide" not in s or b1 != 1:
            raise AssertionError(f"the preview launched B1 {b1} times "
                                 f"(guide in payload: {'guide' in s})")
        saved = json.loads(_post(base + "/api/save", b"{}",
                                 "application/json"))["path"]
        per_predict, walls = [], []
        for _ in range(2):
            before = {n: f.launches for n, f in kernels.KERNELS.items()}
            t0 = time.perf_counter()
            r = json.loads(_post(base + "/api/predict", json.dumps(
                {"pid": pid}).encode(), "application/json"))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            per_predict.append({n: f.launches - before[n]
                                for n, f in kernels.KERNELS.items()})
        launches = {n: f.launches for n, f in kernels.KERNELS.items()}
        live = app._live[pid]
        objs = [dict(x) for x in app.interactions[str(pid)][str(sid)]]

        # without the interaction the map must change
        popped = json.loads(_post(base + "/api/interaction/pop", json.dumps(
            {"pid": pid, "sid": int(sid)}).encode(), "application/json"))
        _post(base + "/api/predict", json.dumps({"pid": pid}).encode(),
              "application/json")
        unguided = app._live[pid]
    finally:
        srv.shutdown()
        srv.server_close()
    print(f"  annotate (case {pid}, {'x'.join(map(str, meta['size']))}, "
          f"GUNet.yml 002_gnet_sp eval flags on {app.device}): ms per slice "
          "payload (median of 5) " + ", ".join(f"{k} {v:.3f}"
                                               for k, v in ms.items()))
    print(f"  annotate Predict: first {walls[0]:.3f} s, second "
          f"{walls[1]:.3f} s; launches per Predict {per_predict}; metrics "
          f"{r['metrics']}, {r['guides']} guide(s); {smi()}")
    for p in per_predict:
        if not (p["gaussian_guide_batch"] > 0 and p["in_relu_fwd_nhwc"] > 0):
            raise AssertionError(f"a Predict launched {p}")

    # the live map against the CLI's --real_sp infer on the same weights
    infer_md = Path(tmp) / "annotate_infer_md"
    cli.main(["infer" if a == "eval" else a for a in FLAGS] + data
             + ["--model_dir", str(infer_md), "--real_sp", saved])
    _, cli_map = nii.read_nii(infer_md / "prediction" /
                              f"predict-{pid}.nii.gz", out_dtype=np.uint8)
    err = int(np.abs(cli_map.astype(np.int32) - live).max())
    print(f"  annotate live map vs cli.main --mode infer --real_sp: max abs "
          f"diff {err} over {live.size} voxels, "
          f"{int(np.count_nonzero(live))} labeled")
    if err != 0 or cli_map.shape != live.shape:
        raise AssertionError("the annotator's live map differs from the "
                             "CLI's infer")
    n_moved = int(np.count_nonzero(unguided != live))
    print(f"  annotate without the interaction (popped: {popped['popped']}):"
          f" {n_moved} voxels change class, "
          f"{int(np.count_nonzero(unguided == 2))} tumor voxels against "
          f"{int(np.count_nonzero(live == 2))} with it")
    if not popped["popped"] or n_moved == 0:
        raise AssertionError("the live map does not depend on the "
                             "interaction")
    live_dir = Path(tmp) / "annotate_live"
    live_dir.mkdir()
    nii.write_nii(live, live_dir / f"predict-{pid}.nii.gz",
                  zooms=meta["spacing"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = compare_preds.main([str(live_dir), str(infer_md / "prediction"),
                                 "--min_dice", "1.0", "--json"])
    print(f"  compare_preds live vs infer (--min_dice 1.0): rc {rc}, "
          f"{json.loads(out.getvalue())['aggregate']}")
    if rc != 0:
        raise AssertionError("compare_preds failed the live map")

    # the preview: B1 on the card against the plain version on the CPU
    guide, guide8 = annotate.guide_preview(objs, meta["size"][1:], dev)
    plain, plain8 = annotate.guide_preview(objs, meta["size"][1:], "cpu")
    ferr = float(np.abs(guide - plain).max())
    uerr = int(np.abs(guide8.astype(np.int32) - plain8).max())
    print(f"  preview B1 (card) vs plain (CPU) at {meta['size'][1:]}: float "
          f"max abs err {ferr:.3e}, uint8 {uerr} level(s)")
    if not (ferr <= 1e-6 and uerr <= 1):
        raise AssertionError("the preview drawn by B1 disagrees with plain")
    preview_timing(dev, meta["size"][1:], seed)
    png_timing(lits, meta)

    # the viewers over the outputs of phases 10, 12 and 17
    t0 = time.perf_counter()
    html = viewer.build_viewer(unet_preds, ds, Path(tmp) / "viewer.html",
                               axes="zyx")
    print(f"  viewer over phase 12's predictions: {html.stat().st_size} B "
          f"in {time.perf_counter() - t0:.2f} s")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    pid0 = int(load_meta(ds)[0]["PID"])
    vis_out = vis.main(["--export_dir", str(unet_bundle), "--dataset_dir",
                        str(ds), "--pid", str(pid0), "--out",
                        str(Path(tmp) / "vis")])
    n_png = len(list(vis_out.glob("slice_*.png")))
    print(f"  vis over phase 17's UNet bundle on the card: {n_png} overlays "
          f"+ sheet in {time.perf_counter() - t0:.2f} s, launches "
          f"{ {n: f.launches for n, f in kernels.KERNELS.items()} }")
    if not n_png or not (vis_out / "sheet.png").exists():
        raise AssertionError("vis wrote no overlay")
    ckpt = ckpt_tools.find_checkpoint(unet_md)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ckpt_tools.main(["list", str(ckpt)])
    lines = out.getvalue().splitlines()
    print(f"  ckpt_tools list {ckpt}: {len(lines)} "
          f"variables, first {lines[0]!r}")
    if len(lines) != len(ckpt_tools.list_vars(ckpt)) or not lines:
        raise AssertionError("ckpt_tools list")
    return launches


def preview_timing(dev, shape, seed):
    """B1 at the preview's shape (bs 1, the plane): device time per launch
    for 1 and 40 objects, beside the plain version and the bound."""
    from boxsegliver_torch.ops import kernels

    rng = np.random.default_rng(seed)
    h, w = shape
    sfu = sfu_per_s()
    for k in (1, 40):
        c, s, v = guide_inputs(rng, 1, k, h, w, dev, n_valid=[k])

        def run_kernel(i=0, c=c, s=s, v=v):
            return kernels.gaussian_guide_batch(c, s, v, height=h, width=w)

        def run_plain(c=c, s=s, v=v):
            kernels.gaussian_guide_batch_plain(c, s, v, height=h, width=w)

        d = graph_ms(run_kernel, 1, iters=200)
        plain = cuda_ms(run_plain, iters=50)
        bound, by, why = b1_bound_ms(c, s, v, h, w, sfu)
        print(f"  B1 preview {h}x{w} K={k}: device {d:.5f} ms per launch, "
              f"plain {plain:.4f} ms, bound {bound:.6f} ms ({by}: {why}), "
              f"{bound / d:.1%} of bound")


def png_timing(lits, meta):
    """cli/viewer.encode_png on one 512^2 display slice and its label map:
    ms per payload (median of 10) and bytes at zlib levels 1, 6 and 9."""
    from boxsegliver_torch.cli import viewer

    pid, n = meta["PID"], meta["size"][0] // 2
    img = viewer._display_window(
        np.load(lits / f"volume-{pid}" / "volume.npy")[n:n + 1],
        False)[0].astype(np.uint8)
    lab = np.load(lits / f"volume-{pid}" / "segmentation.npy")[n]
    parts = []
    for name, arr in (("image", img), ("labels", lab)):
        for level in (1, 6, 9):
            walls = []
            for _ in range(10):
                t0 = time.perf_counter()
                png = viewer.encode_png(arr, level=level)
                walls.append((time.perf_counter() - t0) * 1e3)
            parts.append(f"{name} L{level} {statistics.median(walls):.3f} ms "
                         f"{len(png)} B")
    print(f"  encode_png {img.shape[0]}x{img.shape[1]} (ZLIB_LEVEL "
          f"{viewer.ZLIB_LEVEL}): " + "; ".join(parts))


# ---------------------------------------------------------------------------
# phase 19: the NF task — 101_unet_v2.sh, prepare negcache,
# 101_unetinter_v10.sh and run_sp
# ---------------------------------------------------------------------------

# run_scripts/nf/_lib.sh NF_BASE_FLAGS; the dataset (the CLI's own
# synthetic_nf), k_folds, the epoch length, the eval batch count and the
# step counts are the smoke's own, appended in nf_argv
NF_BASE = [
    "--classes", "NF", "--test_fold", "0", "--im_height", "256",
    "--im_width", "256", "--im_channel", "3", "--noise_scale", "0",
    "--random_flip", "3", "--primary_metric", "NF/Dice",
    "--loss_weight_type", "numerical", "--batches_per_epoch", "1200",
    "--batch_size", "16", "--learning_policy", "plateau",
    "--learning_rate", "0.0003", "--lr_end", "0.0000005",
    "--lr_decay_rate", "0.2", "--normalizer", "instance_norm",
    "--eval_num_batches_per_epoch", "120", "--evaluator", "Volume",
    "--summary_prefix", "nf", "--dataset", "NF", "--num_replicas", "0"]
# run_scripts/nf/101_unet_v2.sh train / eval and 101_unetinter_v10.sh
UNET_V2_TRAIN = ["--model", "UNet", "--filter_size", "10",
                 "--loss_numeric_w", "1", "10", "--weight_decay_rate",
                 "0.00001", "--num_of_total_steps", "999999",
                 "--eval_per_epoch", "--save_best"]
UNET_V2_EVAL = ["--model", "UNet", "--loss_numeric_w", "1", "10"]
INTER_MODEL = ["--model", "UNetInter", "--loss_numeric_w", "1", "1",
               "--use_spatial", "--local_enhance", "--stddev", "5."]
INTER_TRAIN = INTER_MODEL + [
    "--weight_decay_rate", "0.00003", "--num_of_total_steps", "250000",
    "--eval_per_epoch", "--save_best", "--save_interval", "50000"]
NF_EVAL_BATCHES = 4          # online eval batches of the smoke's train runs
NF_BLOCKS = 18               # full-affine IN + ReLU blocks of both models


def nf_argv(task, mode, tag, tmp, md, *extra):
    """The flags of one phase-19 CLI run: NF_BASE, the smoke's data and
    sizes, then ``extra`` (the launcher's flags; the last of a repeated
    flag wins)."""
    return [task, "--mode", mode, "--tag", tag] + NF_BASE + [
        "--data_root", str(tmp), "--dataset", "synthetic_nf", "--k_folds",
        "2", "--model_dir", str(md), "--batches_per_epoch", "12",
        "--eval_num_batches_per_epoch", str(NF_EVAL_BATCHES), "--log_step",
        "4", *ONE_WORKER] + list(extra)


def fold_nhwc(launches):
    """``launches`` with B2's and B3's NHWC plans counted under their NCHW
    counterparts (NHWC_OF): the count of a model whose layout follows its
    input's strides (UNet, UNetInter and the click models take the
    channels-last view of their input permute and keep it, UNet3D
    contiguous planes), where the strides choose which plans run."""
    out = dict(launches)
    for n, of in NHWC_OF.items():
        out[of] = out.get(of, 0) + out.pop(n, 0)
    return out


def expect_launches(what, launches, want):
    """Exact launch counts; a kernel ``want`` does not name must read 0.
    Where ``want`` names no NHWC plan (a model other than GUNet), the NHWC
    plans count as their NCHW counterparts (fold_nhwc)."""
    if not any(n in NHWC_OF for n in want):
        launches = fold_nhwc(launches)
    if set(want) - set(launches) or launches != {
            n: want.get(n, 0) for n in launches}:
        raise AssertionError(f"{what}: kernel launches {launches}, "
                             f"expected {want}")


def nf_dataset(tmp):
    """The CLI's own synthetic_nf set (cli.main.resolve_dataset_dir: 4 NF
    cases of 24 x 256^2) under ``tmp``."""
    from boxsegliver_torch.cli import main as cli

    args = cli.get_args(["nf", "--mode", "train", "--tag", "t", "--model",
                         "UNet", "--classes", "NF", "--k_folds", "2",
                         "--data_root", str(tmp), "--model_dir",
                         str(Path(tmp) / "nf_ds_md")])
    args.dataset = "synthetic"          # get_args maps it to NF for nf tasks
    t0 = time.perf_counter()
    root = cli.resolve_dataset_dir(args)
    print(f"  synthetic_nf 4 x (24, 256, 256) in "
          f"{time.perf_counter() - t0:.1f} s -> {root}")
    return root


def _train_log(md, prefix="nf", eval_steps=(12, 24)):
    lines = [json.loads(ln) for ln in
             (md / "summaries" / "metrics.jsonl").read_text().splitlines()]
    loss = {ln["step"]: ln["value"] for ln in lines
            if ln["tag"] == f"{prefix}/loss"}
    evals = {ln["step"]: ln["value"] for ln in lines
             if ln["tag"] == f"{prefix}/eval/NF/Dice"}
    if not loss or not all(math.isfinite(v) for v in loss.values()):
        raise AssertionError(f"non-finite train loss {loss}")
    if sorted(evals) != list(eval_steps):
        raise AssertionError(f"online evals at {sorted(evals)}, not "
                             f"{eval_steps}")
    return loss, evals


def nf_train_phase(tmp, ds):
    """(a) 101_unet_v2.sh train through the CLI: UNet.yml full width,
    instance norm, batch 16, 256^2 x 3; 24 steps with the online eval every
    12 (4 batches), then a resume to 30; then the step in steady state at
    K = 1 and K = 16."""
    from boxsegliver_torch.cli import main as cli

    md = Path(tmp) / "nf_md"
    trainer, seconds, launches = counted_run(lambda: cli.main(nf_argv(
        "nf", "train", "chip_smoke_nf", tmp, md, *UNET_V2_TRAIN,
        "--num_of_steps", "24")))
    if trainer.global_step != 24 or not (md / "ckpt_best" / "best" /
                                         "state.pt").exists():
        raise AssertionError(f"nf train stopped at {trainer.global_step}")
    steps, evals = 24, 2 * NF_EVAL_BATCHES
    expect_launches("nf train", launches, {
        "gaussian_guide_batch": 0,
        **b2_train_counts(NF_B2_STEP_SHAPES, steps, evals)})
    loss, dice = _train_log(md)
    s0 = sorted(loss)
    if not np.mean([loss[k] for k in s0[-3:]]) < loss[s0[0]]:
        raise AssertionError(f"nf train loss did not fall: {loss}")
    print(f"  nf train (101_unet_v2.sh flags): 24 steps of 16 x 256^2 in "
          f"{seconds:.2f} s ({seconds / 24 * 1e3:.1f} ms/step with set-up and"
          f" two online evals of {NF_EVAL_BATCHES} batches); per train step "
          f"B2-fwd {NF_BLOCKS} (+{NF_BLOCKS} per eval batch), B2f "
          f"{fold_nhwc(launches)['in_relu_bwd'] // steps} (NHWC plans "
          f"{launches['in_relu_bwd_nhwc'] // steps}), B2a "
          f"{launches['in_relu_bwd_stats'] // steps}, B2b "
          f"{launches['in_relu_bwd_apply'] // steps}, B1 0; loss "
          + ", ".join(f"{k}: {loss[k]:.4f}" for k in s0)
          + f"; eval NF/Dice {dice}; {smi()}")
    again, seconds2, _ = counted_run(lambda: cli.main(nf_argv(
        "nf", "train", "chip_smoke_nf", tmp, md, *UNET_V2_TRAIN,
        "--num_of_steps", "30")))
    if again.global_step != 30:
        raise AssertionError(f"nf resume ended at {again.global_step}")
    print(f"  nf resume: steps 25-30 in {seconds2:.2f} s")

    walls = {}
    for k in (1, 16):
        args = cli.get_args(nf_argv(
            "nf", "train", "chip_smoke_nf_b", tmp, Path(tmp) / f"nf_b{k}",
            *UNET_V2_TRAIN, "--steps_per_dispatch", str(k)))
        walls[k], warm, replay = steady(
            args, ds, f"101_unet_v2.sh train step, K={k}",
            kernels_used=b2_train_kernels(NF_B2_STEP_SHAPES),
            prof_steps=8 if k == 1 else 16, top=10)
        if k == 1:
            expect_launches("nf steady warm-up", warm, {
                "gaussian_guide_batch": 0,
                **b2_train_counts(NF_B2_STEP_SHAPES, 3)})
        elif any(fold_nhwc(c)[n] != v for c in replay.values() for n, v in
                 b2_train_counts(NF_B2_STEP_SHAPES, 1).items()):
            raise AssertionError(f"nf K=16 replay launches {replay}")
    print(f"  nf train step ms/step (median of 3 windows of 16): K=1 "
          f"{walls[1] * 1e3:.3f}, K=16 {walls[16] * 1e3:.3f}; slices/s "
          f"{16 / walls[1]:.1f} / {16 / walls[16]:.1f}; {smi()}")
    return md, launches


def nf_card_vs_cpu(argv, ds, dev, what, sp_point=False):
    """device_case of 8 slices of the first test case in float32 on the
    card and on the CPU from the same weights (with the sp-point guides,
    drawn by B1 on the card and by its plain version on the CPU, under
    ``sp_point``): max abs error of the probabilities, held at 1e-4."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.evaluators.device_eval import DeviceSlicePredictor
    from boxsegliver_torch.evaluators.eval_loader import parse_case_eval
    from boxsegliver_torch.evaluators.volume import EvaluateVolume

    args = cli.get_args(argv + ["--compute_dtype", "float32"])
    meta = cli._test_metas(args, ds)[0]
    ev = EvaluateVolume(args, ds, ["Background"] + list(args.classes))
    case = parse_case_eval(meta, ds, im_channel=3, parse_label=False,
                           norm=ev.norm, whole_frame=True)
    sids = meta["tumor_slices_index"]
    z0 = min(sids[0], case.depth - 8) if sids else 0
    cut = cut_case(case, z0)
    out, logit = [], []
    for d in (dev, torch.device("cpu")):
        m = cli.build_model_from_args(args, d)
        hook = m.AdjustChannels.register_forward_hook(
            lambda mod, i, o: logit.append(float(o.abs().max())))
        guide = (ev.sp_point_guides(meta, case, device=d)[z0:z0 + 8]
                 if sp_point else None)
        out.append(DeviceSlicePredictor(m, args, device=d).device_case(
            cut, sp_guide=guide))
        hook.remove()
    err = float(np.abs(out[0] - out[1]).max())
    print(f"  {what} card vs CPU (float32, case {case.pid}, slices "
          f"{z0}-{z0 + 7} of 256^2, max |logit| {max(logit):.1f}): max abs "
          f"err {err:.2e}")
    if not err <= 1e-4:
        raise AssertionError(f"{what} on the card disagrees with the CPU")


def nf_eval_phase(tmp, ds, dev, md):
    """(b) 101_unet_v2.sh eval (--save_predict) through the CLI on (a)'s
    best checkpoint: s/case and B2-fwd launches; --mode infer of the other
    fold into the same predictions (the negatives cache of (c) then covers
    the training cases); device_case card vs CPU."""
    from boxsegliver_torch.cli import main as cli

    argv = nf_argv("nf", "eval", "chip_smoke_nf", tmp, md, *UNET_V2_EVAL,
                   "--save_predict")
    results, seconds, launches = counted_run(lambda: cli.main(argv))
    metas = cli._test_metas(cli.get_args(argv), ds)
    depth = [m["size"][0] for m in metas]
    expect_launches("nf eval", launches, {
        "gaussian_guide_batch": 0, "in_relu_bwd_stats": 0,
        "in_relu_bwd_apply": 0,
        "in_relu_fwd": NF_BLOCKS * sum(-(-z // 16) for z in depth)})
    if "NF/Dice" not in results or not all(math.isfinite(v)
                                           for v in results.values()):
        raise AssertionError(f"nf eval results {results}")
    _, seconds_i, _ = counted_run(lambda: cli.main(nf_argv(
        "nf", "infer", "chip_smoke_nf", tmp, md, *UNET_V2_EVAL,
        "--test_fold", "1")))
    preds = sorted((md / "prediction").glob("predict-*.nii.gz"))
    if len(preds) != 4:
        raise AssertionError(f"predictions written: {preds}")
    print(f"  nf eval (101_unet_v2.sh eval flags): {json.dumps(results)}; "
          f"{len(metas)} cases of {depth} slices in {seconds:.2f} s "
          f"({seconds / len(metas):.3f} s/case); infer of fold 1 "
          f"{seconds_i / 2:.3f} s/case; launches {launches}; {smi()}")
    nf_card_vs_cpu(argv, ds, dev, "nf device_case")
    return launches, md / "prediction"


def inter_card_vs_cpu(tmp, ds, dev, seed):
    """A UNetInter_TINY nf_inter train step at 64^2 in float32, TF32 off,
    on the card and on the CPU from the same weights (norm offsets and
    transpose-conv biases at 3, away from the ReLUs' kinks) and the same
    processed batch: loss, gradients and, after 3 Momentum steps, the
    parameters within 1e-4."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.data.pipeline import batch_to_device
    from boxsegliver_torch.data.pipeline_inter import make_inter_preprocess_fn
    from boxsegliver_torch.data.sampler_inter import InterSampler

    args = cli.get_args(nf_argv(
        "nf_inter", "train", "chip_smoke_nf_cmp", tmp,
        Path(tmp) / "nf_inter_cmp", *INTER_TRAIN, "--fp_sample",
        "--im_height", "64", "--im_width", "64", "--compute_dtype",
        "float32", "--model_config", "UNetInter_TINY.yml", "--optimizer",
        "Momentum", "--batch_size", "4"))
    raw = InterSampler(ds, args, seed=seed).sample_batch(4)
    feats, labels = make_inter_preprocess_fn(args, train=False)(
        batch_to_device(raw, "cpu"), None)
    out = []
    for d in (dev, torch.device("cpu")):
        ft = {k: v.to(d) for k, v in feats.items()}
        trainer = cli.build_trainer(args, d)
        with torch.no_grad():
            for name, p in trainer.model.named_parameters():
                if name.endswith("norm.bias") or (
                        name.startswith("up") and name.count(".") == 1
                        and name.endswith("bias")):
                    p.fill_(3.0)
        trainer.preprocess_fn = (lambda batch, gen, ft=ft, d=d:
                                 (ft, labels.to(d)))
        grads = [g.detach().cpu() for g in
                 trainer.gradients(ft, labels.to(d))[0]]
        losses = [float(trainer.train_step({"names": raw["names"]})[0][0])
                  for _ in range(3)]
        out.append((losses, grads, {k: v.detach().cpu() for k, v in
                                    trainer.model.state_dict().items()}))
        trainer.summary.close()
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(out[0][0],
                                                       out[1][0]))
    g_err = max(float((a - b).abs().max()) for a, b in zip(out[0][1],
                                                           out[1][1]))
    p_err = max(float((out[0][2][k] - v).abs().max())
                for k, v in out[1][2].items())
    print(f"  nf_inter train step card vs CPU (UNetInter_TINY, 64^2, "
          f"float32): losses {out[0][0]} / {out[1][0]} (rel err "
          f"{loss_err:.2e}), gradients max abs err {g_err:.2e}, parameters "
          f"after 3 steps max abs err {p_err:.2e}")
    if not (loss_err <= 1e-4 and g_err <= 1e-4 and p_err <= 1e-4):
        raise AssertionError("the nf_inter train step on the card "
                             "disagrees with the CPU")


def nf_inter_train_phase(tmp, ds, dev, seed, preds):
    """(c) prepare negcache from (b)'s predictions, then 101_unetinter_v10.sh
    train with --fp_sample through the CLI: UNetInter.yml full width,
    instance norm, batch 16, 24 steps with the online eval every 12; the
    step in steady state (K = 1); UNetInter_TINY card vs CPU."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.cli import prepare

    _, seconds, _ = counted_run(lambda: prepare.main([
        "negcache", "--dst", str(ds), "--pred_dir", str(preds)]))
    neg = sorted((ds / "neg").glob("volume-*.npy"))
    n_fp = sum(int(np.load(p).sum()) for p in neg)
    print(f"  prepare negcache: {len(neg)} cases, {n_fp} false-positive "
          f"voxels, in {seconds:.2f} s")
    if len(neg) != 4:
        raise AssertionError(f"negatives cache {neg}")
    md = Path(tmp) / "nf_inter_md"
    trainer, seconds, launches = counted_run(lambda: cli.main(nf_argv(
        "nf_inter", "train", "chip_smoke_nf_inter", tmp, md, *INTER_TRAIN,
        "--fp_sample", "--num_of_steps", "24")))
    if trainer.global_step != 24 or not (md / "ckpt_best" / "best" /
                                         "state.pt").exists():
        raise AssertionError(f"nf_inter train stopped at "
                             f"{trainer.global_step}")
    steps, evals = 24, 2 * NF_EVAL_BATCHES
    expect_launches("nf_inter train", launches, {
        "gaussian_guide_batch": steps + evals,
        **b2_train_counts(NF_B2_STEP_SHAPES, steps, evals)})
    loss, dice = _train_log(md)
    print(f"  nf_inter train (101_unetinter_v10.sh flags, --fp_sample): 24 "
          f"steps of 16 x 256^2 in {seconds:.2f} s ({seconds / 24 * 1e3:.1f}"
          f" ms/step with set-up and two online evals); per train step B1 1,"
          f" B2-fwd / B2f {NF_BLOCKS} (each eval batch: B1 1, B2-fwd "
          f"{NF_BLOCKS}); loss " + ", ".join(
              f"{k}: {loss[k]:.4f}" for k in sorted(loss))
          + f"; eval NF/Dice {dice}; {smi()}")
    args = cli.get_args(nf_argv(
        "nf_inter", "train", "chip_smoke_nf_inter_b", tmp,
        Path(tmp) / "nf_inter_b", *INTER_TRAIN, "--fp_sample"))
    _, warm, _ = steady(args, ds, "101_unetinter_v10.sh train step, K=1",
                        kernels_used=train_kernels(NF_B2_STEP_SHAPES),
                        top=10)
    expect_launches("nf_inter steady warm-up", warm, {
        "gaussian_guide_batch": 3,
        **b2_train_counts(NF_B2_STEP_SHAPES, 3)})
    inter_card_vs_cpu(tmp, ds, dev, seed)
    return md, launches


def nf_inter_eval_phase(tmp, ds, dev, md):
    """(d) 101_unetinter_v10.sh eval (the online eval over fixed batches)
    and ``nf --mode eval --use_spatial`` (run_sp, its guides one B1 launch
    per case) through the CLI on (c)'s best checkpoint; run_sp card vs
    CPU."""
    from boxsegliver_torch.cli import main as cli

    n_batches = 8
    results, seconds, launches = counted_run(lambda: cli.main(nf_argv(
        "nf_inter", "eval", "chip_smoke_nf_inter", tmp, md, *INTER_MODEL,
        "--eval_num_batches_per_epoch", str(n_batches))))
    expect_launches("nf_inter eval", launches, {
        "gaussian_guide_batch": n_batches, "in_relu_bwd_stats": 0,
        "in_relu_bwd_apply": 0, "in_relu_fwd": NF_BLOCKS * n_batches})
    rows = (md / "eval_results_2d.txt").read_text().splitlines()
    if json.loads(rows[-1]) != {"results": results}:
        raise AssertionError("eval_results_2d.txt does not hold the run")
    print(f"  nf_inter eval (online, {n_batches} fixed batches of 16): "
          f"{json.dumps(results)} in {seconds:.2f} s "
          f"({seconds / n_batches:.3f} s/batch with the sampling); launches "
          f"{launches}")
    argv = nf_argv("nf", "eval", "chip_smoke_nf_inter", tmp, md,
                   *INTER_MODEL)
    results_sp, seconds_sp, launches_sp = counted_run(
        lambda: cli.main(argv))
    metas = cli._test_metas(cli.get_args(argv), ds)
    guided = sum(1 for m in metas if m["tumor_slices_index"])
    depth = [m["size"][0] for m in metas]
    expect_launches("run_sp", launches_sp, {
        "gaussian_guide_batch": guided, "in_relu_bwd_stats": 0,
        "in_relu_bwd_apply": 0,
        "in_relu_fwd": NF_BLOCKS * sum(-(-z // 16) for z in depth)})
    if not all(math.isfinite(v) for v in results_sp.values()):
        raise AssertionError(f"run_sp results {results_sp}")
    print(f"  run_sp (nf --mode eval --use_spatial, UNetInter.yml): "
          f"{json.dumps(results_sp)}; {len(metas)} cases in "
          f"{seconds_sp:.2f} s ({seconds_sp / len(metas):.3f} s/case), B1 "
          f"{launches_sp['gaussian_guide_batch'] / len(metas):.0f} per case;"
          f" launches {launches_sp}; {smi()}")
    nf_card_vs_cpu(argv, ds, dev, "run_sp device_case", sp_point=True)
    return launches, launches_sp


def nf_phase(tmp, dev, seed):
    """Phase 19: (a)-(d) on the CLI's synthetic_nf set; returns the launch
    counts of each path for the kernels line and (c)'s model_dir."""
    ds = nf_dataset(tmp)
    md, train_l = nf_train_phase(tmp, ds)
    eval_l, preds = nf_eval_phase(tmp, ds, dev, md)
    md_i, inter_l = nf_inter_train_phase(tmp, ds, dev, seed, preds)
    inter_eval_l, sp_l = nf_inter_eval_phase(tmp, ds, dev, md_i)
    return {"nf_train": train_l, "nf_eval": eval_l,
            "nf_inter_train": inter_l, "nf_inter_eval": inter_eval_l,
            "run_sp": sp_l}, md_i


# ---------------------------------------------------------------------------
# phase 20: the click eval (interactive_eval --dim 2), kernel G1 and the new
# click models
# ---------------------------------------------------------------------------

# the least float work of G1 per pixel: its four undirected edge weights
# sqrt((1-λ)·l² + λ·ΔI²) (difference, square, scaling, add, sqrt) once, as
# the image does not change between passes; then per raster pass three
# candidate adds, the min of them and the field (3), and the row fold's
# add and min
G1_WEIGHT_OPS_PER_PIXEL = 4 * 5
G1_OPS_PER_PIXEL_PASS = 3 + 3 + 2
G1_ITERATIONS = 4
# 101_unetinter_v10.sh inter (run_scripts/nf/101_unetinter_v10.sh:20-28)
INTER_EVAL = ["--mode", "eval", "--tag", "chip_smoke_inter"] + INTER_MODEL + [
    "--classes", "NF", "--test_fold", "0", "--im_height", "256",
    "--im_width", "256", "--im_channel", "3", "--normalizer",
    "instance_norm", "--batch_size", "1", "--dataset", "NF", "--dim", "2"]
# the model flags of 105_interunet_v1.sh, 104_small_v3.sh, 103_lgnet_v3.sh
# and 101_unetinter_v13's deltas on 101_unetinter_v10.sh
# path: (flags, the IN + ReLU blocks' shapes {[N, C, H, W]: blocks} at
# batch 16 and 256^2, B1 a step, steady)
NEW_MODEL_TRAIN = {
    "InterUNet train (105_interunet_v1)": (
        ["--model", "InterUNet", "--loss_numeric_w", "1", "1", "--use_spatial",
         "--local_enhance", "--stddev", "5.", "--img_grad",
         "--weight_decay_rate", "0.00003"],
        {(16, 32, 256, 256): 4, (16, 64, 128, 128): 4, (16, 128, 64, 64): 4,
         (16, 512, 32, 32): 5, (16, 1024, 32, 32): 2, (16, 256, 64, 64): 2,
         (16, 128, 128, 128): 2, (16, 64, 256, 256): 2}, True, True),
    "SmallUNet train (104_small_v3)": (
        ["--model", "SmallUNet", "--loss_numeric_w", "1", "1",
         "--use_spatial", "--local_enhance", "--stddev", "5.",
         "--weight_decay_rate", "0.00003", "--fp_sample"],
        {(16, 64, 256, 256): 4, (16, 128, 128, 128): 4, (16, 256, 64, 64): 4,
         (16, 512, 32, 32): 5, (16, 1024, 32, 32): 2}, True, True),
    "LGNet_v3 train (103_lgnet_v3)": (
        ["--model", "LGNet", "--model_config", "LGNet_v3.yml",
         "--loss_numeric_w", "1", "1", "--use_spatial",
         "--weight_decay_rate", "0.00001"],
        {(16, 64, 256, 256): 2, (16, 128, 128, 128): 2, (16, 256, 64, 64): 2,
         (16, 512, 32, 32): 2, (16, 1024, 16, 16): 1}, False, True),
    "UNetInter --geodesic train (101_unetinter_v13)": (
        ["--model", "UNetInter", "--loss_numeric_w", "1", "1",
         "--use_spatial", "--weight_decay_rate", "0.00003", "--fp_sample",
         "--geodesic"], NF_B2_STEP_SHAPES, False, False),
}


def g1_bound_ms(img):
    """(bound ms, "bytes" | "operations", how) of G1 on [n, h, w] fields:
    the image (4 B), the seed mask (1 B) read and the field (4 B) written
    once per pixel against HBM_BYTES_PER_S; the least float work (the edge
    weights once, G1_OPS_PER_PIXEL_PASS per pixel and pass, 2 passes an
    iteration) against FP32_OPS_PER_S."""
    n, h, w = img.shape
    bytes_moved = n * h * w * 9
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops = n * h * w * (G1_WEIGHT_OPS_PER_PIXEL
                       + 2 * G1_ITERATIONS * G1_OPS_PER_PIXEL_PASS)
    t_ops = ops / FP32_OPS_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    why = (f"{bytes_moved} B -> {t_bytes:.6f} ms; {ops} f32 ops -> "
           f"{t_ops:.6f} ms; serial chain {2 * G1_ITERATIONS * h} row steps")
    return max(t_bytes, t_ops), by, why


def g1_inputs(rng, n, h, w, dev, seeds_per_field=1, corners=False,
              none=False):
    img = torch.from_numpy((rng.normal(size=(n, h, w)) * 2.0).astype(
        np.float32)).to(dev)
    seeds = torch.zeros((n, h, w), dtype=torch.bool)
    for i in range(n):
        for _ in range(seeds_per_field):
            seeds[i, rng.integers(h), rng.integers(w)] = True
    if corners:
        seeds[:] = False
        seeds[:, 0, 0] = seeds[:, -1, -1] = True
    if none:
        seeds[0] = False
    return img, seeds.to(dev)


def g1_err(out, ref, what):
    """(max abs error, the same relative to the field's largest finite
    value) of G1 against ``ref``; the relative one must stay within 1e-5,
    and inf (or FLT_MAX) must sit at the same pixels."""
    fin = torch.isfinite(ref)
    if not torch.equal(torch.isfinite(out), fin):
        raise AssertionError(f"G1 {what}: unreached pixels differ")
    if not bool(fin.any()):
        return 0.0, 0.0
    err = float((out[fin] - ref[fin]).abs().max())
    rel = err / max(1.0, float(ref[fin].abs().max()))
    if not rel <= 1e-5:
        raise AssertionError(f"G1 {what}: relative error {rel:.3e}")
    return err, rel


def g1_chain_floor(h, k):
    """(floor ms, SM clocks a row step, SM MHz) of G1 on fields of h rows
    on the warp plan with k columns a lane: 2 * G1_ITERATIONS * h row steps
    times the time one step of geodesic_chain_clocks (the row step's chain
    alone, on inputs in registers) took, and the SM clock it ran at: its
    clock64 count over its global-timer nanoseconds."""
    from boxsegliver_torch.csrc import build

    rng = np.random.default_rng(k)
    vals = rng.uniform(0.5, 3.0, (32 * k, 5)).astype(np.float32)
    vals[:, 4] = rng.uniform(0.0, 400.0, 32 * k)          # the previous d
    vals = torch.from_numpy(vals).cuda()
    out = torch.empty(32, device="cuda")
    clocks = torch.zeros(2, dtype=torch.int64, device="cuda")
    fn = build.load("geodesic").geodesic_chain_clocks
    steps = 20000
    for _ in range(2):                    # the second run is the one read
        rc = fn(vals.data_ptr(), out.data_ptr(), clocks.data_ptr(), k, steps,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"geodesic_chain_clocks failed: CUDA error {rc}")
        torch.cuda.synchronize()
    clk, ns = clocks.tolist()
    floor = 2 * G1_ITERATIONS * h * ns / steps * 1e-6
    return floor, clk / steps, clk / ns * 1e3


def g1_timed(rng, dev, n, h, w, label, kernel=None):
    """G1's device time per launch at [n, h, w] (graph replays over inputs
    cycling through COLD_BYTES), wrapper and plain time, bound, chain floor
    and time per row step, printed and returned.  ``kernel``: another
    function of (img, seeds) to time in the wrapper's place."""
    from boxsegliver_torch.ops import kernels
    from boxsegliver_torch.ops.geodesic import geodesic2d

    n_sets = max(1, COLD_BYTES // (n * h * w * 5))
    sets = [g1_inputs(rng, n, h, w, dev) for _ in range(n_sets)]
    img, seeds = sets[0]
    fn = kernel or kernels.geodesic2d_batch

    def run_kernel(i=0):
        return fn(*sets[i])

    plain_iters = 2 if h * w <= 128 * 128 else 1
    p1 = cuda_ms(lambda: geodesic2d(img, seeds), iters=plain_iters, warmup=1)
    k1 = cuda_ms(run_kernel, iters=20, warmup=2)
    d1 = graph_ms(run_kernel, n_sets, iters=20, replays=3)
    d2 = graph_ms(run_kernel, n_sets, iters=20, replays=3)
    # the chain floor just after the timed replays, its clock read there
    plan = kernels.geodesic_plan(w)
    floor, clocks, mhz = g1_chain_floor(h, plan.k)
    k2 = cuda_ms(run_kernel, iters=20, warmup=2)
    p2 = cuda_ms(lambda: geodesic2d(img, seeds), iters=plain_iters, warmup=1)
    bound, by, why = g1_bound_ms(img)
    dev_ms = min(d1, d2)
    row_us = dev_ms * 1e3 / (2 * G1_ITERATIONS * h)
    which = f"plan {plan}" if kernel is None else "another kernel"
    print(f"  G1 [{n}, {h}, {w}] ({label}, {G1_ITERATIONS} iterations; "
          f"{which}): device {d1:.4f}/{d2:.4f} ms per launch, wrapper "
          f"{k1:.4f}/{k2:.4f} ms per call, plain {p1:.2f}/{p2:.2f} ms, "
          f"bound {bound:.6f} ms ({by}: {why}; {bound / dev_ms:.2%} of "
          f"bound); per row step {row_us:.4f} us = {row_us * mhz:.0f} "
          f"clocks at {mhz:.0f} MHz (the SM clock geodesic_chain_clocks ran "
          f"at just after the replays; clocks.max.sm {max_sm_mhz():.0f}); "
          f"chain floor {floor:.4f} ms ({clocks:.1f} clocks a row step of "
          f"the warp plan's k {plan.k}, geodesic_chain_clocks; "
          f"{floor / dev_ms:.1%} of the device time); {smi()}")
    return {"device_ms": dev_ms, "wrapper_ms": min(k1, k2),
            "plain_ms": min(p1, p2), "bound_ms": bound, "bound_by": by,
            "floor_ms": floor, "floor_clocks_per_row": clocks,
            "row_step_us": row_us, "sm_mhz": mhz, "plan": plan._asdict()}


def g1_phase(dev, seed):
    """(a) G1 against its plain version on the card (refiner shapes, the
    two plans' boundary, edge cases) and against the host C++ scan; its
    device time per launch at the refiner's fields of 256^2 and 512^2
    slices, wrapper, plain, bound and chain floor; B1 at the refiner's
    [2·sb, 256^2, K 10]."""
    from boxsegliver_torch.csrc import native
    from boxsegliver_torch.ops import kernels
    from boxsegliver_torch.ops.geodesic import geodesic2d

    rng = np.random.default_rng(seed)
    cases = {
        "refiner [64,128,128]": g1_inputs(rng, 64, 128, 128, dev),
        "512^2 [4,256,256]": g1_inputs(rng, 4, 256, 256, dev, 2),
        "plan boundary [2,48,257]": g1_inputs(rng, 2, 48, 257, dev, 2),
        "odd [3,127,129]": g1_inputs(rng, 3, 127, 129, dev, 3),
        "one row [4,1,200]": g1_inputs(rng, 4, 1, 200, dev),
        "one column [4,200,1]": g1_inputs(rng, 4, 200, 1, dev),
        "no seeds [2,64,64]": g1_inputs(rng, 2, 64, 64, dev, none=True),
        "corner seeds [2,96,80]": g1_inputs(rng, 2, 96, 80, dev,
                                            corners=True),
        "wide [2,16,1024]": g1_inputs(rng, 2, 16, 1024, dev, 4),
    }
    worst = 0.0
    for name, (img, seeds) in cases.items():
        out = kernels.geodesic2d_batch(img, seeds)
        err, rel = g1_err(out, geodesic2d(img, seeds), name)
        worst = max(worst, err)
        extra = ""
        if name.startswith(("refiner", "odd", "512")):
            cpp = torch.stack([torch.from_numpy(native.geodesic2d(
                img[i].cpu().numpy(), seeds[i].cpu().numpy()))
                for i in range(min(4, len(img)))])
            cpp = torch.where(cpp == native.FLT_MAX, float("inf"), cpp)
            c_err, c_rel = g1_err(out[:len(cpp)].cpu(), cpp, name + " C++")
            extra = f", vs the C++ scan {c_err:.3e} ({c_rel:.3e} rel)"
        plan = kernels.geodesic_plan(img.shape[2])
        path = "warp" if plan.path == kernels.GEO_WARP else "block"
        print(f"  G1 {name:24s} {path} plan, k {plan.k}: max abs err vs "
              f"plain {err:.3e} ({rel:.3e} rel){extra}")
        if name.startswith("no seeds") and bool(torch.isfinite(out[0]).any()):
            raise AssertionError("G1: a seedless field must stay +inf")

    shapes = {"[64,128,128]": g1_timed(
        rng, dev, 64, 128, 128, "the refiner's fields at 256^2"),
        "[64,256,256]": g1_timed(rng, dev, 64, 256, 256,
                                 "the refiner's fields at 512^2")}
    top = shapes["[64,128,128]"]
    rec = {"name": "geodesic2d_batch", "route": "cuda",
           "source": "boxsegliver_torch/csrc/geodesic.cu",
           "replaces": "boxsegliver_tpu/ops/geodesic.py:93",
           "max_abs_err": worst, "ms": top["wrapper_ms"],
           "device_ms": top["device_ms"], "wrapper_ms": top["wrapper_ms"],
           "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
           "bound_by": top["bound_by"], "library_ms": None,
           "shapes": shapes}

    # B1 at the device refiner's shape: fg and bg of 32 slices as 64 rows,
    # K = --max_iters 10 click slots, a valid prefix
    c, s, v = guide_inputs(rng, 64, 10, 256, 256, dev,
                           n_valid=rng.integers(0, 11, 64))
    s = torch.full_like(s, 5.0)
    out = kernels.gaussian_guide_batch(c, s, v, height=256, width=256)
    ref = kernels.gaussian_guide_batch_plain(c, s, v, height=256, width=256)
    err = float((out - ref).abs().max())
    if not err <= 1e-6:
        raise AssertionError(f"B1 at the refiner's shape: {err}")
    dm = graph_ms(lambda i=0: kernels.gaussian_guide_batch(
        c, s, v, height=256, width=256), 1, iters=100)
    bound_b1, by_b1, why_b1 = b1_bound_ms(c, s, v, 256, 256, sfu_per_s())
    print(f"  B1 at the refiner's shape [64, K 10, 256^2]: max abs err "
          f"{err:.1e}, device {dm:.5f} ms per launch, bound {bound_b1:.6f} "
          f"ms ({by_b1}: {why_b1}; {bound_b1 / dm:.1%} of bound)")
    return rec


class CaseRecorder:
    """Records each case of a click-eval CLI run (``dim`` 2 or 3): the host
    loop's and the device refiner's result dicts, and the refiner's click
    rounds."""

    def __init__(self, dim: int = 2):
        self.dim = dim

    def __enter__(self):
        from boxsegliver_torch.interactive import device_refine, refine

        self.cases, self.rounds = [], []
        self._loop = f"interactive_eval_{self.dim}d"
        self._cls = getattr(device_refine, f"DeviceRefiner{self.dim}D")
        self._host = getattr(refine, self._loop)
        self._dev = self._cls.refine_case

        def host(*a, **k):
            out = self._host(*a, **k)
            self.cases.append(dict(out))
            return out

        def dev(refiner, *a, **k):
            out = self._dev(refiner, *a, **k)
            self.cases.append(dict(out))
            self.rounds.append(refiner.rounds)
            return out

        setattr(refine, self._loop, host)
        self._cls.refine_case = dev
        return self

    def __exit__(self, *exc):
        from boxsegliver_torch.interactive import refine

        setattr(refine, self._loop, self._host)
        self._cls.refine_case = self._dev


def click_eval_argv(tmp, md, refine, kind, *extra, data_root=None):
    """``101_unetinter_v10.sh inter`` on the synthetic NF test fold with
    ``md``'s best checkpoint."""
    return INTER_EVAL + [
        "--task", "nf_inter", "--dataset", "synthetic", "--data_root",
        str(data_root or tmp), "--k_folds", "2", "--model_dir", str(md),
        "--guide_channel", "2", "--dice_thresh", "0.85", "--max_iters", "10",
        "--device_refine", refine, "--guide_kind", kind, *extra]


def click_eval(tmp, md, refine, kind, *extra, data_root=None):
    """One click_eval_argv run through boxsegliver_torch.cli.
    interactive_eval; exact launch counts: one B1 launch a click (host
    loop) or a round (refiner) for gaussian guides, one G1 launch a round
    for the refiner's geodesic guides, 18 B2-fwd a forward."""
    from boxsegliver_torch.cli import interactive_eval as icli

    argv = click_eval_argv(tmp, md, refine, kind, *extra,
                           data_root=data_root)
    with CaseRecorder() as rec:
        means, seconds, launches = counted_run(lambda: icli.main(argv))
    if refine == "on":
        forwards = sum(rec.rounds)
    else:
        forwards = sum(round(c["clicks"] * c["slices"]) for c in rec.cases)
    expect_launches(f"click eval {refine} {kind}", launches, {
        "gaussian_guide_batch": forwards if kind == "gaussian" else 0,
        "geodesic2d_batch": forwards if (kind == "geodesic"
                                         and refine == "on") else 0,
        "in_relu_fwd": NF_BLOCKS * forwards})
    if not rec.cases or not all(math.isfinite(c["Dice"]) for c in rec.cases):
        raise AssertionError(f"click eval results {rec.cases}")
    return means, seconds, launches, rec.cases


def click_eval_cases(args):
    """(images, labels) of the click eval's cases as cli/interactive_eval
    reads them: the test fold's lesion-bearing cases as 2.5-D stacks."""
    from boxsegliver_torch.cli import interactive_eval as icli
    from boxsegliver_torch.cli import main as cli

    ds = cli.resolve_dataset_dir(args)
    cases = []
    for meta in cli._test_metas(args, ds):
        if meta["tumors"]:
            case = Path(ds) / f"volume-{meta['PID']}"
            cases.append((
                icli.slice_stacks(np.load(case / "volume.npy"),
                                  args.im_channel),
                (np.load(case / "segmentation.npy") > 0).astype(np.uint8)))
    return cases


# the parts of a device-refiner round that refiner_split times apart
SPLIT_PARTS = ("G1", "forward", "guide render", "largest_error_click")


def refiner_split(model, args, cases, dev, g1=None):
    """DeviceRefiner2D (``args``' guide kind, built as the CLI builds it)
    over ``cases``: refine_case's wall s/case (a warm-up case first) and
    rounds; then a pass with each part of a round (G1, the forward, the
    guide render: _geo_render or _render's B1, largest_error_click) timed
    between two synchronisations, "rest" the pass's other time (the round's
    own elementwise work and host steps), all in ms a case; and the device
    time a case of all kernels and of G1's kernels by name from a profiled
    pass.  ``g1`` stands in for kernels.geodesic2d_batch where given
    (tools/g1_ab.py: an earlier commit's kernel)."""
    from torch.profiler import ProfilerActivity, profile

    from boxsegliver_torch.cli import interactive_eval as icli
    from boxsegliver_torch.interactive import device_refine as drm

    spent = dict.fromkeys(SPLIT_PARTS, 0.0)

    def timed(fn, name):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return call

    def run_all():
        for images, labels in cases:
            refiner.refine_case(images, labels)
        torch.cuda.synchronize()

    cls = drm.DeviceRefiner2D
    saved = (drm.geodesic2d_batch, drm.largest_error_click,
             cls.__dict__["_geo_render"], cls.__dict__["_render"])
    refiner = icli.build_refiner(args, model, dev)
    drm.geodesic2d_batch = g1 or saved[0]
    try:
        refiner.refine_case(*cases[0])
        torch.cuda.synchronize()
        walls, rounds = [], []
        for images, labels in cases:
            t0 = time.perf_counter()
            refiner.refine_case(images, labels)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            rounds.append(refiner.rounds)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_all()
        forward = refiner.model
        refiner.model = timed(forward, "forward")
        drm.geodesic2d_batch = timed(g1 or saved[0], "G1")
        drm.largest_error_click = timed(saved[1], "largest_error_click")
        cls._geo_render = staticmethod(timed(saved[2].__func__,
                                             "guide render"))
        cls._render = timed(saved[3], "guide render")
        t0 = time.perf_counter()
        run_all()
        timed_wall = time.perf_counter() - t0
        refiner.model = forward
    finally:
        (drm.geodesic2d_batch, drm.largest_error_click, cls._geo_render,
         cls._render) = saved
    kern, _, self_us = kernel_groups(prof)
    n = len(cases)
    parts = {k: v * 1e3 / n for k, v in spent.items()}
    parts["rest"] = timed_wall * 1e3 / n - sum(parts.values())
    return {"s_per_case": sum(walls) / n, "rounds": rounds,
            "parts_ms": parts,
            "device_ms": sum(self_us(e) for e in kern) / 1e3 / n,
            "g1_kernels_ms": sum(self_us(e) for e in kern
                                 if "geodesic" in e.key) / 1e3 / n,
            "slices": [int((np.asarray(lab) > 0).any(axis=(1, 2)).sum())
                       for _, lab in cases]}


def print_split(what, res, cli_s=None):
    cli = f", the CLI {cli_s:.3f} s/case" if cli_s is not None else ""
    print(f"  {what}: refine_case {res['s_per_case']:.4f} s/case{cli} "
          f"({len(res['rounds'])} cases, lesion slices {res['slices']}, "
          f"rounds {res['rounds']}); each part between synchronisations, "
          "ms a case: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                     res["parts_ms"].items())
          + f"; device time {res['device_ms']:.3f} ms a case, G1's kernels "
          f"{res['g1_kernels_ms']:.3f}; {smi()}")


def fit_tiny_unetinter(dev, seed, steps=150):
    """A small float32 UNetInter (UNetInter_TINY.yml, 64^2) fit on the card
    to blob slices with a click guide at each blob's center, so that it
    answers its guides with clear margins (the host loop and the refiner
    then see no near-tie pixel)."""
    from boxsegliver_torch.interactive.refine import render_click_guides
    from boxsegliver_torch.models import MODEL_CONFIGS, build_model

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:64, :64]
    labs = np.stack([(yy - 16 - 5 * i) ** 2 + (xx - 18 - 4 * i) ** 2
                     < (5 + i % 3) ** 2 for i in range(6)])
    ims = (labs[..., None] * 1.5 + rng.normal(size=(6, 64, 64, 3)) * 0.35
           ).astype(np.float32)
    guides = torch.stack([render_click_guides(
        (64, 64), [tuple(int(v) for v in np.argwhere(lab).mean(0))], [],
        5.0, device=dev) for lab in labs]).permute(0, 2, 3, 1)
    model = build_model("UNetInter", model_kwargs=dict(
        MODEL_CONFIGS["UNetInter_TINY.yml"], normalizer="instance_norm"),
        num_classes=2, dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    feats = {"images": torch.from_numpy(ims).to(dev), "sp_guide": guides}
    target = torch.from_numpy(labs).long().to(dev)
    for _ in range(steps):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(
            model(feats).permute(0, 3, 1, 2), target)
        loss.backward()
        opt.step()
    return model.eval(), ims, labs, float(loss.detach())


def refine_agreement(dev, seed, md, args_argv):
    """(c) The host loop and the device refiner in float32 on the card
    (every guide kind, a small UNetInter fit on the card): equal clicks per
    slice set, Dice within 1e-4; the first round's probabilities of the
    full-width model (md's best) on the card against the CPU (1e-4)."""
    from boxsegliver_torch.cli import interactive_eval as icli
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.interactive.device_refine import DeviceRefiner2D
    from boxsegliver_torch.interactive.refine import interactive_eval_2d
    from boxsegliver_torch.ops.labeling import largest_error_click

    model, ims, labs, loss = fit_tiny_unetinter(dev, seed)
    for kind in ("gaussian", "euclidean", "geodesic"):
        kw = dict(dice_thresh=0.97, max_iters=6, stddev=5.0,
                  guide_kind=kind, guide_channel=2)
        host = interactive_eval_2d(icli.make_predict(model), ims, labs,
                                   device=dev, **kw)
        ref = DeviceRefiner2D(model, device=dev, **kw).refine_case(ims, labs)
        print(f"  host loop vs device refiner, {kind}, float32 (UNetInter "
              f"fit to loss {loss:.4f}): host {host}, refiner {ref}")
        if not (host["clicks"] == ref["clicks"]
                and abs(host["Dice"] - ref["Dice"]) <= 1e-4):
            raise AssertionError(f"the device refiner ({kind}) disagrees "
                                 f"with the host loop")

    args = icli.build_parser().parse_args(args_argv + [
        "--compute_dtype", "float32"])
    from boxsegliver_torch import config as config_mod
    config_mod.fill_default_args(args)
    ds = cli.resolve_dataset_dir(args)
    meta = next(m for m in cli._test_metas(args, ds) if m["tumors"])
    case = ds / f"volume-{meta['PID']}"
    lab = np.load(case / "segmentation.npy") > 0
    z = [i for i in range(len(lab)) if lab[i].any()][:2]
    images = icli.slice_stacks(np.load(case / "volume.npy"), 3)[z]
    probs = []
    for d in (dev, torch.device("cpu")):
        m = cli.build_model_from_args(args, d)
        refiner = DeviceRefiner2D(m, device=d)
        labs_t = torch.from_numpy(lab[z]).to(d)
        coords, fg, has = largest_error_click(
            torch.zeros_like(labs_t), labs_t)
        g = refiner._render(coords[:, None], (fg & has)[:, None],
                            (~fg & has)[:, None], *lab.shape[1:])
        with torch.no_grad():
            p = torch.softmax(m({"images": torch.from_numpy(images).to(d),
                                 "sp_guide": torch.stack(list(g), -1)}), -1)
        probs.append(p.cpu())
        del m, refiner
    err = float((probs[0] - probs[1]).abs().max())
    print(f"  first round of the refiner, {args.model_config or 'UNetInter.yml'}"
          f" (phase 19c's best, float32), 2 slices of case {meta['PID']}: "
          f"card vs CPU max abs err {err:.2e}")
    if not err <= 1e-4:
        raise AssertionError("the refiner's first round on the card "
                             "disagrees with the CPU")


def new_models_phase(tmp, ds):
    """(e) nf_inter train at the flags of 105_interunet_v1.sh,
    104_small_v3.sh, 103_lgnet_v3.sh (full width, batch 16) and
    101_unetinter_v13's deltas: 8 steps each through the CLI with exact
    launches a step (B2-fwd and the backward's kernels by in_relu_bwd_plan
    over the model's IN + ReLU blocks; B1
    one a step under --local_enhance), then the three models' step in
    steady state (K = 1)."""
    from boxsegliver_torch.cli import main as cli

    paths, walls = {}, {}
    for i, (what, (flags, shapes, b1, timed)) in enumerate(
            NEW_MODEL_TRAIN.items()):
        md = Path(tmp) / f"new_model_{i}"
        trainer, seconds, launches = counted_run(lambda: cli.main(nf_argv(
            "nf_inter", "train", "chip_smoke_new", tmp, md, *flags,
            "--num_of_steps", "8")))
        if trainer.global_step != 8:
            raise AssertionError(f"{what} stopped at {trainer.global_step}")
        expect_launches(what, launches, {
            "gaussian_guide_batch": 8 if b1 else 0,
            **b2_train_counts(shapes, 8)})
        lines = [json.loads(ln) for ln in (md / "summaries" / "metrics.jsonl")
                 .read_text().splitlines()]
        loss = {ln["step"]: ln["value"] for ln in lines
                if ln["tag"] == "nf/loss"}
        if not loss or not all(math.isfinite(v) for v in loss.values()):
            raise AssertionError(f"{what}: train loss {loss}")
        print(f"  {what}: 8 steps of 16 x 256^2 in {seconds:.2f} s; per "
              f"step B2-fwd / B2f {sum(shapes.values())}, B1 {int(b1)}; loss "
              + ", ".join(f"{k}: {v:.4f}" for k, v in sorted(loss.items())))
        paths[what] = launches
        if timed:
            args = cli.get_args(nf_argv(
                "nf_inter", "train", "chip_smoke_new_b", tmp,
                Path(tmp) / f"new_model_b{i}", *flags))
            walls[what], _, _ = steady(
                args, ds, f"{what} step, K=1",
                kernels_used=(train_kernels(shapes) if b1
                              else b2_train_kernels(shapes)), top=6)
    print("  new click models, ms/step at batch 16 (median of 3 windows of "
          "16): " + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in walls.items())
          + f"; {smi()}")
    return paths


def click_export_phase(tmp, dev, seed, md):
    """(f) --mode export of phase 19c's UNetInter (nf_inter, zero click
    guides of --guide_channel 2), 5 requests through cli/serve.py on the
    card, the response against the eager model within one bf16 step."""
    from boxsegliver_torch.cli import main as cli

    argv = nf_argv("nf_inter", "export", "chip_smoke_nf_inter", tmp, md,
                   *INTER_MODEL)
    t0 = time.perf_counter()
    bundle = cli.main(argv)
    sig = json.loads((bundle / "signature.json").read_text())
    print(f"  exported UNetInter.yml (nf_inter, 101_unetinter_v10 flags, "
          f"batch 16, bf16) in {time.perf_counter() - t0:.2f} s: inputs "
          f"{sig['inputs']}")
    if sig["inputs"]["sp_guide"][0] != [16, 256, 256, 2]:
        raise AssertionError(f"click export signature {sig['inputs']}")
    feats, probs, launches, per_req = serve_bundle(
        bundle, "serve UNetInter (click export)", requests=5, seed=seed)
    if fold_nhwc(per_req)["in_relu_fwd"] != NF_BLOCKS:
        raise AssertionError(f"click serving B2-fwd per request {per_req}")
    live = cli.build_model_from_args(cli.get_args(
        ["eval" if a == "export" else a for a in argv]), dev)
    with torch.no_grad():
        want = torch.softmax(live({k: torch.from_numpy(v).to(dev)
                                   for k, v in feats.items()}), -1).cpu()
    err = (torch.from_numpy(probs) - want).abs()
    bad = err > 2.0 ** -7 * want.abs() + 1e-5        # b2_check's bf16 bound
    print(f"  UNetInter response vs the eager model + softmax on the card: "
          f"max abs err {float(err.max()):.3e}, {int(bad.sum())} elements "
          f"beyond one bf16 rounding step")
    if bool(bad.any()):
        raise AssertionError("the served UNetInter disagrees with the eager "
                             "model")
    return launches


def click_eval_phase(tmp, dev, seed, nf_md):
    """Phase 20: (a) G1; (b) the click eval through the CLI, host loop and
    device refiner, gaussian and geodesic guides, and where the refiner's
    time goes (refiner_split); (c) host loop vs refiner
    and card vs CPU; (d) the auto crossover at 128^2 and 256^2; (e) the new
    click models' training; (f) the click export served."""
    from boxsegliver_torch import config as config_mod
    from boxsegliver_torch.cli import interactive_eval as icli
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.data.synthetic import make_synthetic_dataset

    rec = g1_phase(dev, seed)
    ds = Path(tmp) / "synthetic_nf"
    paths, secs = {}, {}
    for refine in ("off", "on"):
        for kind in ("gaussian", "geodesic"):
            means, seconds, launches, cases = click_eval(tmp, nf_md, refine,
                                                         kind)
            paths[f"click eval {refine} {kind}"] = launches
            secs[refine, kind, 256] = means["sec_per_case"]
            print(f"  click eval (101_unetinter_v10.sh inter, UNetInter.yml "
                  f"full width, bf16) --device_refine {refine} --guide_kind "
                  f"{kind}: {means['sec_per_case']:.3f} s/case, Dice "
                  f"{means['Dice']:.4f}, clicks {means['clicks']:.3f}, "
                  f"slices {means['slices']:.0f}/case ({len(cases)} cases, "
                  f"{seconds:.2f} s); launches {launches}; {smi()}")
    cases = None
    for kind in ("gaussian", "geodesic"):
        args = icli.build_parser().parse_args(click_eval_argv(
            tmp, nf_md, "on", kind))
        config_mod.fill_default_args(args)
        cases = cases or click_eval_cases(args)
        res = refiner_split(cli.build_model_from_args(args, dev), args,
                            cases, dev)
        print_split(f"where the device refiner's time goes, {kind} guides "
                    "(UNetInter.yml full width, bf16, 256^2)", res,
                    secs["on", kind, 256])
    refine_agreement(dev, seed, nf_md, INTER_EVAL + [
        "--task", "nf_inter", "--dataset", "synthetic", "--data_root",
        str(tmp), "--k_folds", "2", "--model_dir", str(nf_md)])

    small = Path(tmp) / "nf128"
    make_synthetic_dataset(small / "synthetic_nf", n_cases=4,
                           shape=(24, 128, 128), k_split=2, modality="nf",
                           seed=seed)
    for refine in ("off", "on"):
        means, _, _, _ = click_eval(tmp, nf_md, refine, "gaussian",
                                    "--im_height", "128", "--im_width",
                                    "128", data_root=small)
        secs[refine, "gaussian", 128] = means["sec_per_case"]
    rule = {size: ("device refiner" if secs["on", "gaussian", size]
                   < secs["off", "gaussian", size] else "host loop")
            for size in (128, 256)}
    print("  auto crossover (gaussian, bf16, s/case host loop / refiner): "
          + ", ".join(f"{size}^2 {secs['off', 'gaussian', size]:.3f} / "
                      f"{secs['on', 'gaussian', size]:.3f} -> {rule[size]}"
                      for size in (128, 256))
          + "; the port's rule: auto = the device refiner; " + smi())
    if set(rule.values()) != {"device refiner"}:
        raise AssertionError(f"--device_refine auto takes the device refiner,"
                             f" but the host loop was faster: {rule}")
    paths.update(new_models_phase(tmp, ds))
    paths["serve (UNetInter click export)"] = click_export_phase(
        tmp, dev, seed, nf_md)
    return rec, paths


# ---------------------------------------------------------------------------
# phase 21: the 3D tower — UNet3D (201_unet_v1.sh) on the card
# ---------------------------------------------------------------------------

# the instance-norm + ReLU pairs of one 201_unet_v1.sh train step (UNet3D.yml
# at batch 4, 10 x 256^2 patches): two encoder and two decoder convs at each
# of the four levels above the bridge, the bridge's two at 5 x 16^2
UNET3D_B2_STEP_SHAPES = {(4, 30, 10, 256, 256): 4, (4, 60, 10, 128, 128): 4,
                         (4, 120, 10, 64, 64): 4, (4, 240, 10, 32, 32): 4,
                         (4, 320, 5, 16, 16): 2}
# level 0 of the batch-1 whole-volume eval of a 24 x 256^2 case
UNET3D_EVAL_SHAPE = (1, 30, 24, 256, 256)
UNET3D_BLOCKS = 18
# run_scripts/threed/201_unet_v1.sh COMMON, train and eval flags; the
# dataset (the CLI's own synthetic_nf), k_folds and the step counts are the
# smoke's own, appended in nf3d_argv and by each run
NF3D_COMMON = [
    "--model", "UNet3D", "--classes", "NF", "--test_fold", "0",
    "--im_height", "256", "--im_width", "256", "--im_channel", "1",
    "--primary_metric", "NF/Dice", "--loss_weight_type", "numerical",
    "--loss_numeric_w", "1", "1", "--weight_decay_rate", "0.00003",
    "--learning_policy", "plateau", "--learning_rate", "0.0003",
    "--lr_end", "0.0000005", "--lr_decay_rate", "0.2", "--normalizer",
    "instance_norm", "--evaluator", "Volume", "--summary_prefix", "nf",
    "--num_replicas", "0"]
NF3D_TRAIN = [
    "--im_depth", "10", "--random_flip", "7", "--num_of_total_steps",
    "999999", "--batches_per_epoch", "300", "--batch_size", "4",
    "--eval_num_batches_per_epoch", "30", "--eval_per_epoch", "--save_best",
    "--tumor_percent", "0.75", "--log_step", "125"]
NF3D_EVAL = ["--im_depth", "-1", "--batch_size", "1"]
# 202_unetinter_v2.sh beyond 201_unet_v1.sh: the click guides (its
# "--stddev 1. 5. 5." is a per-axis list the flag registry of both packages
# refuses, so the default 3 stands)
INTER3D = ["--use_spatial", "--local_enhance"]
NF3D_STEPS = 16           # the smoke's 201_unet_v1.sh run: an eval every 8
SMALL3D = {"init_channels": 8, "max_channels": 32, "num_pool_layers": 4}


def nf3d_argv(mode, tag, tmp, md, *extra):
    """The flags of one phase-21 CLI run: 201_unet_v1.sh's COMMON, the
    smoke's data, then ``extra`` (the last of a repeated flag wins)."""
    return ["nf_3d", "--mode", mode, "--tag", tag] + NF3D_COMMON + [
        "--data_root", str(tmp), "--dataset", "synthetic_nf", "--k_folds",
        "2", "--model_dir", str(md)] + list(extra)


def eval_forwards_3d(ds, args):
    """UNet3D forwards of one EvaluateVolume3D pass over the test fold:
    one a case for the whole volume, one a tile for a sliding window (the
    device one at --im_depth > 0 through the CLI, the host one in the train
    loop's eval when the padded depth exceeds --im_depth)."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.evaluators.volume3d import tile_starts

    n = 0
    for meta in cli._test_metas(args, ds):
        shape = np.load(ds / f"volume-{meta['PID']}" / "volume.npy",
                        mmap_mode="r").shape
        padded = [s + (-s) % m for s, m in zip(shape, (2, 16, 16))]
        if args.im_depth > 0 and padded[0] > args.im_depth:
            n += len(tile_starts(padded, (args.im_depth, args.im_height,
                                          args.im_width))[1])
        else:
            n += 1
    return n


def b2_3d_phase(dev):
    """(a) B2 at every UNet3D level of the 201_unet_v1.sh train step (18
    calls of each kernel) and at the whole-volume eval's level 0, each
    against its plain version, with its plan, device time per launch,
    plain, library (F.relu(F.instance_norm), forward and backward) and
    bound."""
    step = b2_nf_levels(dev, UNET3D_B2_STEP_SHAPES, "UNet3D", seed=200)
    ev = b2_nf_levels(dev, {UNET3D_EVAL_SHAPE: 1}, "UNet3D eval", seed=300)
    for n in B2_KERNELS:
        for what, r in (("train step", step[n]), ("eval level 0", ev[n])):
            if not r["device_ms"]:           # B2f: no fused plan there
                continue
            share = r["bound_ms"] / r["device_ms"]
            slower = r["device_ms"] > r["library_ms"]
            print(f"  UNet3D B2 {n} ({what}): {share:.1%} of its bound, "
                  f"{r['device_ms']:.4f} ms against the library's "
                  f"{r['library_ms']:.4f}"
                  + (" — under half its bound" if share < 0.5 else "")
                  + (" — slower than the library call" if slower else ""))
    return step, ev


def nf3d_train_phase(tmp, ds):
    """(b) 201_unet_v1.sh train through the CLI: UNet3D.yml full width,
    instance norm, batch 4, 10 x 256^2 patches, one host worker; 16 steps
    with the --eval_per_epoch volume eval every 8 (the host sliding window
    over the test fold); exact launches; then the step in steady state at
    K = 1 and K = 4."""
    from boxsegliver_torch.cli import main as cli

    md = Path(tmp) / "nf3d_md"
    argv = nf3d_argv("train", "chip_smoke_nf3d", tmp, md, *NF3D_TRAIN,
                     "--batches_per_epoch", "8", "--log_step", "4",
                     "--num_of_steps", str(NF3D_STEPS), *ONE_WORKER)
    trainer, seconds, launches = counted_run(lambda: cli.main(argv))
    if trainer.global_step != NF3D_STEPS or not (
            md / "ckpt_best" / "best" / "state.pt").exists():
        raise AssertionError(f"nf_3d train stopped at {trainer.global_step}")
    fwd = 2 * eval_forwards_3d(ds, cli.get_args(argv))
    expect_launches("nf_3d train", launches,
                    b2_train_counts(UNET3D_B2_STEP_SHAPES, NF3D_STEPS, fwd))
    loss, dice = _train_log(md, eval_steps=(8, 16))
    print(f"  nf_3d train (201_unet_v1.sh flags): {NF3D_STEPS} steps of 4 x "
          f"10 x 256^2 in {seconds:.2f} s (with set-up and two volume evals "
          f"of {fwd // 2} forwards); per train step B2-fwd {UNET3D_BLOCKS}"
          f" (+{UNET3D_BLOCKS} a forward of the eval), B2f "
          f"{launches['in_relu_bwd'] // NF3D_STEPS}, B2a / B2b "
          f"{launches['in_relu_bwd_stats'] // NF3D_STEPS}, B1 0; loss "
          + ", ".join(
              f"{k}: {loss[k]:.4f}" for k in sorted(loss))
          + f"; eval NF/Dice {dice}; {smi()}")
    walls = {}
    for k in (1, 4):
        args = cli.get_args(nf3d_argv(
            "train", "chip_smoke_nf3d_b", tmp, Path(tmp) / f"nf3d_b{k}",
            *NF3D_TRAIN, "--steps_per_dispatch", str(k)))
        walls[k], warm, replay = steady(
            args, ds, f"201_unet_v1.sh train step, K={k}",
            kernels_used=b2_train_kernels(UNET3D_B2_STEP_SHAPES),
            prof_steps=8, top=12)
        if k == 1:
            expect_launches("nf_3d steady warm-up", warm,
                            b2_train_counts(UNET3D_B2_STEP_SHAPES, 3))
        elif any(c[n] != v for c in replay.values() for n, v in
                 b2_train_counts(UNET3D_B2_STEP_SHAPES, 1).items()):
            raise AssertionError(f"nf_3d K=4 replay launches {replay}")
    print(f"  nf_3d train step ms/step (median of 3 windows of 16): K=1 "
          f"{walls[1] * 1e3:.3f}, K=4 {walls[4] * 1e3:.3f}; patches/s "
          f"{4 / walls[1]:.2f} / {4 / walls[4]:.2f}; {smi()}")
    return md, launches


class CaseTimer3D:
    """Times each EvaluateVolume3D.predict_case of a run (its predict
    functions return host arrays, so the card has finished)."""

    def __enter__(self):
        from boxsegliver_torch.evaluators import volume3d

        self.seconds = []
        self._orig = volume3d.EvaluateVolume3D.predict_case

        def timed(ev, *a, **k):
            t0 = time.perf_counter()
            out = self._orig(ev, *a, **k)
            self.seconds.append(time.perf_counter() - t0)
            return out

        volume3d.EvaluateVolume3D.predict_case = timed
        return self

    def __exit__(self, *exc):
        from boxsegliver_torch.evaluators import volume3d

        volume3d.EvaluateVolume3D.predict_case = self._orig


def nf3d_eval_phase(tmp, ds, dev, md):
    """(c) 201_unet_v1.sh eval (the whole volume: z-score and argmax on the
    card) and the sliding-window eval (--im_depth 10) through the CLI on
    (b)'s best: s/case, exact launches; make_volume_predict card vs CPU in
    float32 on 8 slices of the first test case (1e-4)."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.evaluators.volume3d import make_volume_predict

    paths = {}
    for name, depth in (("whole volume", "-1"), ("sliding window", "10")):
        argv = nf3d_argv("eval", "chip_smoke_nf3d", tmp, md, *NF3D_EVAL,
                         "--im_depth", depth)
        with CaseTimer3D() as timer:
            res, seconds, launches = counted_run(lambda: cli.main(argv))
        fwd = eval_forwards_3d(ds, cli.get_args(argv))
        expect_launches(f"nf_3d eval ({name})", launches,
                        {"in_relu_fwd": UNET3D_BLOCKS * fwd})
        if not math.isfinite(res["NF/Dice"]):
            raise AssertionError(f"nf_3d eval ({name}): {res}")
        print(f"  nf_3d eval, {name} (201_unet_v1.sh eval flags, --im_depth "
              f"{depth}, bf16): s/case " + ", ".join(
                  f"{t:.3f}" for t in timer.seconds)
              + f" ({seconds:.2f} s with set-up); {fwd} forwards, B2-fwd "
              f"{launches['in_relu_fwd']}; NF/Dice {res['NF/Dice']:.4f}, "
              f"GNFDice {res.get('GNFDice', float('nan')):.4f}; {smi()}")
        paths[f"UNet3D eval ({name})"] = launches
    args = cli.get_args(nf3d_argv("eval", "chip_smoke_nf3d", tmp, md,
                                  *NF3D_EVAL, "--compute_dtype", "float32"))
    meta = cli._test_metas(args, ds)[0]
    vol = np.load(ds / f"volume-{meta['PID']}" / "volume.npy")
    z0 = min(meta["tumor_slices_index"][0], vol.shape[0] - 8) \
        if meta["tumor_slices_index"] else 0
    vol = np.ascontiguousarray(vol[z0:z0 + 8])
    out = []
    for d in (dev, torch.device("cpu")):
        model = cli.build_model_from_args(args, d)
        predict = make_volume_predict(model, d, ret="prob", in_zscore=True)
        out.append(predict({"images": vol[None, ..., None]}))
    err = float(np.abs(out[0] - out[1]).max())
    print(f"  make_volume_predict card vs CPU (float32, case {meta['PID']}, "
          f"slices {z0}-{z0 + 7} of 256^2, the raw volume z-scored on each "
          f"device): max abs err of the probabilities {err:.2e}")
    if not err <= 1e-4:
        raise AssertionError("the 3-D volume predict on the card disagrees "
                             "with the CPU")
    return paths


def nf3d_sweep_phase(tmp, ds, md):
    """(h) cli/eval_all_ckpt over (b)'s ``ckpt_best/<tag>``: the whole
    volume of each test case a forward per tag (EvaluateVolume3D.run,
    blank click guides), exactly 18 B2-fwd a forward, s/tag, the rows."""
    from boxsegliver_torch.cli import eval_all_ckpt
    from boxsegliver_torch.cli import main as cli

    argv = nf3d_argv("eval", "chip_smoke_nf3d", tmp, md, *NF3D_EVAL)
    tags = sorted(p.name for p in (md / "ckpt_best").iterdir()
                  if p.is_dir())
    rows, seconds, launches = counted_run(lambda: eval_all_ckpt.main(argv))
    fwd = eval_forwards_3d(ds, cli.get_args(argv)) * len(tags)
    expect_launches("UNet3D checkpoint sweep", launches,
                    {"in_relu_fwd": UNET3D_BLOCKS * fwd})
    if [r["ckpt"] for r in rows] != tags or not all(
            math.isfinite(r["NF/Dice"]) for r in rows):
        raise AssertionError(f"UNet3D checkpoint sweep rows {rows}")
    print(f"  UNet3D checkpoint sweep (eval_all_ckpt, whole volume): "
          f"{len(tags)} checkpoints {tags} in {seconds:.2f} s "
          f"({seconds / len(tags):.3f} s/checkpoint); {fwd} forwards, "
          f"B2-fwd {launches['in_relu_fwd']}; NF/Dice "
          + ", ".join(f"{r['ckpt']} {r['NF/Dice']:.4f}" for r in rows)
          + f"; {smi()}")
    return launches


def click_eval_3d(tmp, md, refine, tta, *extra):
    """One 3-D click eval (interactive_eval --dim 3 at 202_unetinter_v2's
    flags) on the synthetic NF test fold with ``md``'s best; exact
    launches: 18 B2-fwd a forward, a forward a click (host loop) or a
    round (refiner), eight with TTA; no B1 (the 3-D guides are plain
    torch)."""
    from boxsegliver_torch.cli import interactive_eval as icli

    argv = ["--mode", "eval", "--tag", "chip_smoke_nf3d_inter"] + \
        NF3D_COMMON + INTER3D + [
            "--dim", "3", "--task", "nf", "--dataset", "synthetic_nf",
            "--data_root", str(tmp), "--k_folds", "2", "--model_dir",
            str(md), "--batch_size", "1", "--dice_thresh", "0.85",
            "--max_iters", "5", "--device_refine", refine,
            *(["--tta"] if tta else []), *extra]
    with CaseRecorder(3) as rec:
        means, seconds, launches = counted_run(lambda: icli.main(argv))
    flips = 8 if tta else 1
    forwards = flips * (sum(rec.rounds) if refine == "on" else
                        sum(round(c["clicks"]) for c in rec.cases))
    expect_launches(f"3-D click eval {refine} tta={tta}", launches,
                    {"in_relu_fwd": UNET3D_BLOCKS * forwards})
    if not rec.cases or not all(math.isfinite(c["Dice"]) for c in rec.cases):
        raise AssertionError(f"3-D click eval results {rec.cases}")
    return means, seconds, launches, rec.cases


def nf3d_click_phase(tmp, ds):
    """(d) 8 steps of 202_unetinter_v2.sh training (201_unet_v1.sh with the
    click guides: UNet3D.yml full width) through the CLI with its volume
    eval at step 8 (blank guides), then interactive_eval --dim 3 on it:
    the host loop and DeviceRefiner3D, TTA off and on (s/case, clicks,
    exact launches); in float32 on the card the two give equal clicks and
    Dice within 1e-6."""
    from boxsegliver_torch.cli import main as cli

    md = Path(tmp) / "nf3d_inter_md"
    argv = nf3d_argv("train", "chip_smoke_nf3d_inter", tmp, md, *NF3D_TRAIN,
                     *INTER3D, "--batches_per_epoch", "8", "--log_step", "4",
                     "--num_of_steps", "8", *ONE_WORKER)
    trainer, seconds, launches = counted_run(lambda: cli.main(argv))
    fwd = eval_forwards_3d(ds, cli.get_args(argv))
    expect_launches("202_unetinter_v2 train", launches,
                    b2_train_counts(UNET3D_B2_STEP_SHAPES, 8, fwd))
    print(f"  202_unetinter_v2 train: 8 steps of 4 x 10 x 256^2 with 2 "
          f"guide channels in {seconds:.2f} s (set-up and one volume eval "
          f"included); launches {launches}")
    paths = {"UNet3D click train (202_unetinter_v2)": launches}
    for refine in ("off", "on"):
        for tta in (False, True):
            means, seconds, launches, cases = click_eval_3d(tmp, md, refine,
                                                            tta)
            paths[f"3-D click eval {refine}{' tta' if tta else ''}"] = \
                launches
            print(f"  3-D click eval (--dim 3, UNet3D.yml full width, bf16) "
                  f"--device_refine {refine}{' --tta' if tta else ''}: "
                  f"{means['sec_per_case']:.3f} s/case, Dice "
                  f"{means['Dice']:.4f}, clicks {means['clicks']:.2f} "
                  f"({len(cases)} cases, {seconds:.2f} s); launches "
                  f"{launches}; {smi()}")
    both = [click_eval_3d(tmp, md, refine, False, "--compute_dtype",
                          "float32")[3] for refine in ("off", "on")]
    for host, dev in zip(*both):
        if host["clicks"] != dev["clicks"] or not abs(
                host["Dice"] - dev["Dice"]) <= 1e-6:
            raise AssertionError(f"3-D host loop {both[0]} and device "
                                 f"refiner {both[1]} disagree in float32")
    print(f"  3-D host loop vs DeviceRefiner3D in float32 on the card: "
          f"clicks {[c['clicks'] for c in both[0]]} both, Dice "
          f"{[round(c['Dice'], 7) for c in both[0]]} / "
          f"{[round(c['Dice'], 7) for c in both[1]]}")
    return paths


def nf3d_cascade_phase(tmp, ds, inter_md):
    """(e) --use_cascade --use_2d with phase 19c's UNetInter as the frozen
    2-D model (--ckpt_2d, --im_channel 3): 4 train steps through the CLI,
    whose sampler runs the 2-D model on every clicked slice of a patch (one
    B1 launch a slice draws its fg and bg click guides, four mirrored
    forwards); exact launches.  Then cli/hybrid_eval on that UNet3D with
    the frozen-2-D cascade channel (Cascade2D, blank guides) and 8-way TTA:
    s/case."""
    from boxsegliver_torch.cli import hybrid_eval
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.interactive import cascade
    from boxsegliver_torch.train.checkpoint import CheckpointManager

    md = Path(tmp) / "nf3d_cascade_md"
    ckpt_2d = str(CheckpointManager(inter_md).best_path())
    c2d = ["--use_cascade", "--ckpt_2d", ckpt_2d, "--model_2d", "UNetInter",
           "--im_channel", "3"]
    argv = nf3d_argv("train", "chip_smoke_nf3d_cascade", tmp, md,
                     *NF3D_TRAIN, *c2d, "--use_2d", "--num_of_steps", "4",
                     "--log_step", "2", *ONE_WORKER)
    orig = cascade.CascadeClick2D._slice_pred
    slices = []

    def counted(self, *a, **k):
        out = orig(self, *a, **k)
        slices.append(1)
        return out

    cascade.CascadeClick2D._slice_pred = counted
    try:
        trainer, seconds, launches = counted_run(lambda: cli.main(argv))
    finally:
        cascade.CascadeClick2D._slice_pred = orig
    n = len(slices)
    want = b2_train_counts(UNET3D_B2_STEP_SHAPES, 4)
    want["in_relu_fwd"] += NF_BLOCKS * 4 * n
    expect_launches("cascade train", launches,
                    {"gaussian_guide_batch": n, **want})
    if not n:
        raise AssertionError("the cascade train run predicted no slice")
    print(f"  cascade train (--use_cascade --use_2d, frozen UNetInter.yml of "
          f"phase 19c): 4 steps in {seconds:.2f} s; the sampler predicted {n}"
          f" clicked slices (prefetched batches included): B1 {n}, 2-D "
          f"B2-fwd {NF_BLOCKS * 4 * n}; launches {launches}; {smi()}")
    paths = {"UNet3D cascade train": launches}

    hargv = nf3d_argv("eval", "chip_smoke_nf3d_cascade", tmp, md, *NF3D_EVAL,
                      *c2d, "--eval_mirror")
    args = cli.get_args(hargv)
    metas = cli._test_metas(args, ds)
    per_case = []
    for meta in metas:
        d = np.load(ds / f"volume-{meta['PID']}" / "volume.npy",
                    mmap_mode="r").shape[0]
        d += d % 2
        per_case.append(4 * -(-d // args.batch_size) + 8)
    res, seconds, launches = counted_run(lambda: hybrid_eval.main(hargv))
    expect_launches("hybrid eval", launches,
                    {"in_relu_fwd": UNET3D_BLOCKS * sum(per_case)})
    if "GlobalDice" not in res and "Dice" not in res:
        raise AssertionError(f"hybrid eval results {res}")
    print(f"  cli/hybrid_eval (frozen-2-D cascade, 8-way TTA, slim labels):"
          f" {seconds / len(metas):.3f} s/case over {len(metas)} cases (set-"
          f"up included; {per_case} forwards a case); {res}; {smi()}")
    paths["hybrid eval (cascade)"] = launches
    return paths


def nf3d_serve_phase(tmp, dev, seed, md):
    """(f) --mode export of (b)'s UNet3D (10 x 256^2 volumes, batch 1) and
    cli/serve.make_server(port=0) on the card: ms/request; the response
    against the eager model within one bf16 step."""
    from boxsegliver_torch.cli import main as cli

    argv = nf3d_argv("export", "chip_smoke_nf3d", tmp, md, "--im_depth", "10",
                     "--batch_size", "1")
    t0 = time.perf_counter()
    bundle = cli.main(argv)
    sig = json.loads((bundle / "signature.json").read_text())
    print(f"  exported UNet3D.yml (201_unet_v1.sh, batch 1, bf16) in "
          f"{time.perf_counter() - t0:.2f} s: inputs {sig['inputs']}")
    if sig["inputs"]["images"][0] != [1, 10, 256, 256, 1]:
        raise AssertionError(f"UNet3D export signature {sig['inputs']}")
    feats, probs, launches, per_req = serve_bundle(
        bundle, "serve UNet3D", requests=10, seed=seed)
    if per_req["in_relu_fwd"] != UNET3D_BLOCKS:
        raise AssertionError(f"UNet3D serving B2-fwd per request {per_req}")
    live = cli.build_model_from_args(cli.get_args(
        ["eval" if a == "export" else a for a in argv]), dev)
    with torch.no_grad():
        want = torch.softmax(live({k: torch.from_numpy(v).to(dev)
                                   for k, v in feats.items()}), -1).cpu()
    err = (torch.from_numpy(probs) - want).abs()
    bad = err > 2.0 ** -7 * want.abs() + 1e-5        # b2_check's bf16 bound
    print(f"  UNet3D response vs the eager model + softmax on the card: max "
          f"abs err {float(err.max()):.3e}, {int(bad.sum())} elements beyond"
          f" one bf16 rounding step")
    if bool(bad.any()):
        raise AssertionError("the served UNet3D disagrees with the eager "
                             "model")
    return launches


def unet3d_card_vs_cpu(tmp, ds, dev, seed):
    """(g) A UNet3D train step at small width (init_channels 8, max 32,
    4 pools) on 2 x 4 x 64^2 patches of the smoke's data in float32, TF32
    off, on the card and on the CPU from the same weights (norm offsets at
    3, away from the ReLUs' kinks) and the same processed batch: the loss,
    the gradients, the Adam moments and the parameters after one Adam step,
    and the parameters after 3 Momentum steps, each within 1e-4.  (An Adam
    step is lr·g/(|g| + eps): a gradient within round-off of zero would
    move by ±lr on either device, and the Momentum steps hold the update's
    arithmetic apart from that.)"""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.data.pipeline import batch_to_device
    from boxsegliver_torch.data.pipeline3d import (process_batch_3d,
                                                   statics_3d)
    from boxsegliver_torch.data.sampler3d import Sampler3D
    from boxsegliver_torch.models import build_model
    from boxsegliver_torch.train.trainer import Trainer

    out = {}
    for opt in ("Adam", "Momentum"):
        args = cli.get_args(nf3d_argv(
            "train", "chip_smoke_nf3d_cmp", tmp, Path(tmp) / f"nf3d_cmp_{opt}",
            *NF3D_TRAIN, "--im_depth", "4", "--im_height", "64",
            "--im_width", "64", "--batch_size", "2", "--compute_dtype",
            "float32", "--optimizer", opt, "--random_flip", "0"))
        raw = Sampler3D(ds, args, seed=seed).sample_batch(
            2, rng=np.random.RandomState(seed))
        feats, labels = process_batch_3d(batch_to_device(raw, "cpu"), None,
                                         **statics_3d(args))
        for d in (dev, torch.device("cpu")):
            model = build_model("UNet3D", args=args, model_kwargs=SMALL3D,
                                dtype=torch.float32)
            model.reset_parameters(torch.Generator().manual_seed(seed))
            with torch.no_grad():
                for name, p in model.named_parameters():
                    if name.endswith("norm.bias"):
                        p.fill_(3.0)
            ft = {k: v.to(d) for k, v in feats.items()}
            trainer = Trainer(model, args, ["Background", "NF"], d,
                              preprocess_fn=lambda b, g, ft=ft, d=d:
                              (ft, labels.to(d)))
            grads = [g.detach().cpu() for g in
                     trainer.gradients(ft, labels.to(d))[0]]
            steps = 1 if opt == "Adam" else 3
            losses = [float(trainer.train_step({"names": raw["names"]})[0][0])
                      for _ in range(steps)]
            moments = [t.detach().cpu() for k in ("mu", "nu")
                       for t in trainer.optimizer.state.get(k, [])]
            out[opt, d.type] = (losses, grads, moments, [
                p.detach().cpu() for p in trainer.model.parameters()])
            trainer.summary.close()

    def worst(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    (la, ga, ma, pa), (lb, gb, mb, pb) = out["Adam", "cuda"], out["Adam",
                                                                  "cpu"]
    (lm, _, _, pm), (ln, _, _, pn) = out["Momentum", "cuda"], out["Momentum",
                                                                  "cpu"]
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(la + lm, lb + ln))
    errs = {"gradients": worst(ga, gb), "Adam moments": worst(ma, mb),
            "parameters after the Adam step": worst(pa, pb),
            "parameters after 3 Momentum steps": worst(pm, pn)}
    print(f"  UNet3D train step card vs CPU (init 8, max 32, 2 x 4 x 64^2, "
          f"float32): losses {la + lm} / {lb + ln} (rel err {loss_err:.2e}), "
          + ", ".join(f"{k} max abs err {v:.2e}" for k, v in errs.items()))
    if not (loss_err <= 1e-4 and all(v <= 1e-4 for v in errs.values())):
        raise AssertionError("the UNet3D train step on the card disagrees "
                             "with the CPU")


def nf3d_phase(tmp, dev, seed, inter_md):
    """Phase 21: (a) B2 at the 3-D shapes; (b) 201_unet_v1.sh train; (c)
    its evals; (h) the checkpoint sweep over its bests; (d) the 3-D click
    eval; (e) the cascade and hybrid eval; (f) the UNet3D export served;
    (g) a UNet3D step card vs CPU."""
    ds = Path(tmp) / "synthetic_nf"
    step, ev = b2_3d_phase(dev)
    md, launches = nf3d_train_phase(tmp, ds)
    paths = {"UNet3D train (201_unet_v1)": launches}
    paths.update(nf3d_eval_phase(tmp, ds, dev, md))
    paths["UNet3D checkpoint sweep"] = nf3d_sweep_phase(tmp, ds, md)
    paths.update(nf3d_click_phase(tmp, ds))
    paths.update(nf3d_cascade_phase(tmp, ds, inter_md))
    paths["serve (UNet3D export)"] = nf3d_serve_phase(tmp, dev, seed, md)
    unet3d_card_vs_cpu(tmp, ds, dev, seed)
    return {"step": step, "eval": ev}, paths


# ---------------------------------------------------------------------------
# phase 22: nf2 / IIN (004_gnet_iin.sh) train, eval, infer and export
# ---------------------------------------------------------------------------

# run_scripts/template/004_gnet_iin.sh COMMON_FLAGS, with the smoke's data
# (phase 19's synthetic_nf set, 2 folds) in place of NF's test fold 2
IIN_COMMON = [
    "--model", "GUNet", "--model_config", "GUNet_IIN.yml", "--classes",
    "NF", "--test_fold", "0", "--im_height", "256", "--im_width", "256",
    "--im_channel", "3", "--random_flip", "3", "--num_replicas", "0",
    "--normalizer", "instance_norm", "--use_context", "--ct_base", "32",
    "--use_spatial", "--spatial_random", "1.0", "--guide_scale", "5",
    "--min_std", "2", "--zscore", "--gamma", "--zoom_scale", "1.0", "1.25"]
IIN_TRAIN = [
    "--noise_scale", "0.1", "--num_of_total_steps", "300000",
    "--primary_metric", "NF/Dice", "--batch_size", "8",
    "--weight_decay_rate", "0.000001", "--learning_policy", "plateau",
    "--learning_rate", "0.001", "--lr_end", "0.0000005", "--lr_decay_rate",
    "0.2", "--eval_per_epoch", "--evaluator", "Volume", "--save_best"]
IIN_EVAL = ["--metrics_eval", "Dice", "VOE", "RVD", "--primary_metric",
            "NF/Dice", "--batch_size", "8", "--evaluator", "Volume"]
IIN_STEPS = 12               # the smoke's nf2 run: an online eval every 6
IIN_BLOCKS = 10              # B2 pairs of GUNet_IIN: level 0 and the decoder
# the B2 pairs of one nf2 train step (batch 8, 256^2, init_channels 64):
# those of the flagship step
IIN_B2_STEP_SHAPES = B2_STEP_SHAPES


def iin_argv(mode, tag, tmp, md, *extra):
    """The flags of one phase-22 CLI run: 004_gnet_iin.sh's COMMON, the
    smoke's data, then ``extra`` (the last of a repeated flag wins)."""
    return ["nf2", "--mode", mode, "--tag", tag] + IIN_COMMON + [
        "--data_root", str(tmp), "--dataset", "synthetic_nf", "--k_folds",
        "2", "--model_dir", str(md), "--summary_prefix", "nf"] + list(extra)


def iin_patch_batches(args, ds):
    """Patch batches of one run_patch pass over the test fold: each batch
    is one forward and one B1 launch (its guides)."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.evaluators.iin_eval import IinPatchLoader

    return [-(-len(IinPatchLoader(m, ds, args).items) // args.batch_size)
            for m in cli._test_metas(args, ds)]


def iin_train_phase(tmp, ds):
    """(a) 004_gnet_iin.sh train through the CLI: GUNet_IIN.yml full width,
    instance norm, PatchCNN context, batch 8, 256^2 x 3, bf16, one host
    worker; 12 steps with the online eval (IinSampler, 4 batches) every 6;
    exact launches; then the step in steady state at K = 1 and K = 16 with
    B1 / B2 device ms per step against their bounds (B2's: b2_step_bound_ms,
    the forward and the backward as one function each)."""
    from boxsegliver_torch.cli import main as cli

    md = Path(tmp) / "iin_md"
    argv = iin_argv("train", "chip_smoke_iin", tmp, md, *IIN_TRAIN,
                    "--batches_per_epoch", "6", "--log_step", "3",
                    "--eval_num_batches_per_epoch", str(NF_EVAL_BATCHES),
                    "--num_of_steps", str(IIN_STEPS), *ONE_WORKER)
    trainer, seconds, launches = counted_run(lambda: cli.main(argv))
    if trainer.global_step != IIN_STEPS or not (
            md / "ckpt_best" / "best" / "state.pt").exists():
        raise AssertionError(f"nf2 train stopped at {trainer.global_step}")
    evals = 2 * NF_EVAL_BATCHES
    expect_launches("nf2 train", launches, nhwc_counts({
        "gaussian_guide_batch": IIN_STEPS + evals,
        **b2_train_counts(IIN_B2_STEP_SHAPES, IIN_STEPS, evals),
        "modnorm_relu_fwd": GUNET_MOD_BLOCKS * (IIN_STEPS + evals),
        "modnorm_relu_bwd": GUNET_MOD_BLOCKS * IIN_STEPS}))
    loss, dice = _train_log(md, eval_steps=(6, 12))
    print(f"  nf2 train (004_gnet_iin.sh flags): {IIN_STEPS} steps of 8 x "
          f"256^2 in {seconds:.2f} s (with set-up and two online evals of "
          f"{NF_EVAL_BATCHES} batches); per train step B1 1 (K = 1), B2-fwd "
          f"/ B2f {IIN_BLOCKS} (each eval batch: B1 1, B2-fwd "
          f"{IIN_BLOCKS}); loss " + ", ".join(
              f"{k}: {loss[k]:.4f}" for k in sorted(loss))
          + f"; eval NF/Dice {dice}; {smi()}")

    rng = np.random.default_rng(0)
    c, sd, v = guide_inputs(rng, 8, 1, 256, 256, "cuda", n_valid=[1] * 8)
    b1_bound = b1_bound_ms(c, sd, v, 256, 256, sfu_per_s())[0]
    b2_bound = b2_step_bound_ms(IIN_B2_STEP_SHAPES)
    walls, groups = {}, {}
    for k in (1, 16):
        args = cli.get_args(iin_argv(
            "train", "chip_smoke_iin_b", tmp, Path(tmp) / f"iin_b{k}",
            *IIN_TRAIN, "--steps_per_dispatch", str(k)))
        groups[k] = {}
        walls[k], warm, replay = steady(
            args, ds, f"004_gnet_iin.sh train step, K={k}",
            kernels_used=True, prof_steps=8 if k == 1 else 16, top=10,
            groups_out=groups[k])
        if k == 1:
            expect_launches("nf2 steady warm-up", warm, nhwc_counts({
                "gaussian_guide_batch": 3,
                **b2_train_counts(IIN_B2_STEP_SHAPES, 3),
                "modnorm_relu_fwd": 3 * GUNET_MOD_BLOCKS,
                "modnorm_relu_bwd": 3 * GUNET_MOD_BLOCKS}))
        elif any(cnt["gaussian_guide_batch"] != 1
                 or any(cnt[n] != v for n, v in nhwc_counts({
                     **b2_train_counts(IIN_B2_STEP_SHAPES, 1),
                     "modnorm_relu_fwd": GUNET_MOD_BLOCKS,
                     "modnorm_relu_bwd": GUNET_MOD_BLOCKS}).items())
                 for cnt in replay.values()):
            raise AssertionError(f"nf2 K=16 replay launches {replay}")
    for k in (1, 16):
        b1 = groups[k]["B1 guide_render"]
        b2 = groups[k]["B2 in_relu (fwd, bwd, bwd_stats, bwd_apply)"]
        print(f"  nf2 step K={k}: B1 {b1:.5f} ms/step device (bound "
              f"{b1_bound:.6f} ms, {b1_bound / max(b1, 1e-12):.1%}), B2 "
              f"{b2:.4f} ms/step device (bound {b2_bound:.4f} ms, "
              f"{b2_bound / max(b2, 1e-12):.1%})")
    print(f"  nf2 train step ms/step (median of 3 windows of 16): K=1 "
          f"{walls[1] * 1e3:.3f}, K=16 {walls[16] * 1e3:.3f}; slices/s "
          f"{8 / walls[1]:.1f} / {8 / walls[16]:.1f}; {smi()}")
    return md, launches


def iin_eval_phase(tmp, ds, md):
    """(b) 004_gnet_iin.sh eval (run_patch) through the CLI on (a)'s best,
    with and without --eval_mirror: s/case, exactly one B1 launch and one
    forward (10 B2-fwd) a patch batch; (c) one --mode infer --case_id
    --pos at a lesion: the npz, one B1 launch, one forward."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.evaluators.volume import EvaluateVolume

    paths = {}
    for name, extra in (("mirror TTA", ["--eval_mirror"]), ("plain", [])):
        argv = iin_argv("eval", "chip_smoke_iin", tmp, md, *IIN_EVAL,
                        *extra)
        batches = iin_patch_batches(cli.get_args(argv), ds)
        timer = []
        orig = EvaluateVolume._finish_case

        def timed(ev, case, *a, **k):
            timer.append(time.perf_counter())
            return orig(ev, case, *a, **k)

        EvaluateVolume._finish_case = timed
        try:
            t0 = time.perf_counter()
            res, seconds, launches = counted_run(lambda: cli.main(argv))
        finally:
            EvaluateVolume._finish_case = orig
        expect_launches(f"nf2 eval ({name})", launches, nhwc_counts({
            "gaussian_guide_batch": sum(batches),
            "in_relu_fwd": IIN_BLOCKS * sum(batches),
            "modnorm_relu_fwd": GUNET_MOD_BLOCKS * sum(batches)}))
        if not all(math.isfinite(v) for v in res.values()):
            raise AssertionError(f"nf2 eval ({name}): {res}")
        per_case = np.diff([t0] + timer)
        print(f"  nf2 eval, run_patch ({name}, 004_gnet_iin.sh eval flags, "
              f"bf16): patch batches per case {batches}; s/case "
              + ", ".join(f"{t:.3f}" for t in per_case)
              + f" (the first with set-up; {seconds:.2f} s in all); "
              f"launches {launches}; {json.dumps(res)}; {smi()}")
        paths[f"nf2 eval (run_patch, {name})"] = launches
    meta = cli._test_metas(cli.get_args(argv), ds)[0]
    ft = meta["tumor_slices_from_to"]
    sid = meta["tumor_slices_index"][0]
    y, x = (int(round(v)) for v in meta["tumor_slices_centers"][ft[0]])
    out, seconds, launches = counted_run(lambda: cli.main(iin_argv(
        "infer", "chip_smoke_iin", tmp, md, *IIN_EVAL, "--case_id",
        str(meta["PID"]), "--pos", str(sid), str(y), str(x))))
    expect_launches("nf2 infer --pos", launches, nhwc_counts({
        "gaussian_guide_batch": 1, "in_relu_fwd": IIN_BLOCKS,
        "modnorm_relu_fwd": GUNET_MOD_BLOCKS}))
    with np.load(out["infer_path"]) as z:
        if z["prob"].shape != (256, 256, 2) or not np.isfinite(
                z["prob"]).all():
            raise AssertionError(f"nf2 infer npz {z['prob'].shape}")
        keys = sorted(z.files)
    print(f"  nf2 infer --case_id {meta['PID']} --pos {sid} {y} {x}: "
          f"{seconds:.3f} s with set-up, npz {keys}; launches {launches}")
    paths["nf2 infer --pos"] = launches
    return paths


def iin_card_vs_cpu(tmp, ds, dev, seed):
    """(e) card vs CPU in float32, TF32 off, 1e-4: the full-width
    GUNet_IIN forward on one nf2 batch at 128^2; a GUNet_IIN_TINY train
    step at 64^2 (loss, gradients, parameters after 3 Momentum steps; norm
    offsets and transpose-conv biases at 3, away from the ReLUs' kinks);
    run_patch's per-case metrics of a seeded GUNet_IIN_TINY."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.data.pipeline import batch_to_device
    from boxsegliver_torch.data.pipeline_iin import make_iin_preprocess_fn
    from boxsegliver_torch.data.sampler_iin import IinSampler
    from boxsegliver_torch.evaluators.iin_eval import make_patch_predict
    from boxsegliver_torch.evaluators.volume import EvaluateVolume

    big = cli.get_args(iin_argv(
        "train", "chip_smoke_iin_cmp", tmp, Path(tmp) / "iin_cmp_big",
        *IIN_TRAIN, "--im_height", "128", "--im_width", "128",
        "--compute_dtype", "float32", "--side_dropout", "0"))
    raw = IinSampler(ds, big, seed=seed, tumor_percent=1.0).sample_batch(2)
    feats, _ = make_iin_preprocess_fn(big, train=False)(
        batch_to_device(raw, "cpu"), None)
    feats.pop("names")
    model = cli._build_model(big)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    out = []
    for d in (dev, torch.device("cpu")):
        m = model.to(d).eval()
        with torch.no_grad():
            out.append(torch.softmax(m({k: v.to(d) for k, v in
                                        feats.items()}), -1).cpu())
    fwd_err = float((out[0] - out[1]).abs().max())

    args = cli.get_args(iin_argv(
        "train", "chip_smoke_iin_cmp", tmp, Path(tmp) / "iin_cmp",
        *IIN_TRAIN, "--im_height", "64", "--im_width", "64",
        "--compute_dtype", "float32", "--model_config",
        "GUNet_IIN_TINY.yml", "--optimizer", "Momentum", "--batch_size", "4",
        "--side_dropout", "0"))
    raw = IinSampler(ds, args, seed=seed, tumor_percent=1.0).sample_batch(4)
    feats, labels = make_iin_preprocess_fn(args, train=False)(
        batch_to_device(raw, "cpu"), None)
    res = []
    for d in (dev, torch.device("cpu")):
        ft = {k: v.to(d) for k, v in feats.items()}
        trainer = cli.build_trainer(args, d)
        with torch.no_grad():
            for name, p in trainer.model.named_parameters():
                if name.endswith("norm.bias") or (
                        name.startswith("up") and name.count(".") == 1
                        and name.endswith("bias")):
                    p.fill_(3.0)
        trainer.preprocess_fn = (lambda batch, gen, ft=ft, d=d:
                                 (ft, labels.to(d)))
        grads = [g.detach().cpu() for g in
                 trainer.gradients(ft, labels.to(d))[0]]
        losses = [float(trainer.train_step({"names": raw["names"]})[0][0])
                  for _ in range(3)]
        res.append((losses, grads, {k: v.detach().cpu() for k, v in
                                    trainer.model.state_dict().items()}))
        trainer.summary.close()
    ev_args = cli.get_args(iin_argv(
        "eval", "chip_smoke_iin_cmp", tmp, Path(tmp) / "iin_cmp", *IIN_EVAL,
        "--im_height", "64", "--im_width", "64", "--compute_dtype",
        "float32", "--model_config", "GUNet_IIN_TINY.yml", "--eval_mirror"))
    model = cli._build_model(ev_args)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    metrics = []
    for d in (dev, torch.device("cpu")):
        ev = EvaluateVolume(ev_args, ds, ["Background", "NF"])
        ev.run_patch(make_patch_predict(model, d, 3, mirror=True),
                     cli._test_metas(ev_args, ds))
        metrics.append({k: list(v) for k, v in ev._metric_values.items()})
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(res[0][0],
                                                       res[1][0]))
    g_err = max(float((a - b).abs().max()) for a, b in zip(res[0][1],
                                                           res[1][1]))
    p_err = max(float((res[0][2][k] - v).abs().max())
                for k, v in res[1][2].items())
    m_err = max(abs(a - b) for k, v in metrics[1].items()
                for a, b in zip(metrics[0][k], v))
    if sorted(metrics[0]) != sorted(metrics[1]) or any(
            len(metrics[0][k]) != len(v) for k, v in metrics[1].items()):
        raise AssertionError(f"nf2 run_patch rows {metrics}")
    print(f"  nf2 card vs CPU (float32): GUNet_IIN full-width forward at "
          f"2 x 128^2 max abs err {fwd_err:.2e}; GUNet_IIN_TINY step at "
          f"64^2: losses {res[0][0]} / {res[1][0]} (rel err {loss_err:.2e}),"
          f" gradients {g_err:.2e}, parameters after 3 steps {p_err:.2e}; "
          f"run_patch (mirror TTA, a seeded GUNet_IIN_TINY) per-case "
          f"metrics {m_err:.2e} ({json.dumps(metrics[0])})")
    if not (fwd_err <= 1e-4 and loss_err <= 1e-4 and g_err <= 1e-4
            and p_err <= 1e-4 and m_err <= 1e-4):
        raise AssertionError("nf2 on the card disagrees with the CPU")
    return ev_args


def iin_guides_card_vs_cpu(tmp, ds, dev, seed, ev_args):
    """(f) kernel B1 at nf2's shapes on the card against its plain version
    on the CPU, 1e-6 (phase 3's bar): the train preprocess of one raw
    IinSampler batch at full width (8 x 256^2, K = 1, one set of draws on
    both sides) with sp_on = 0 at rows 1, 4 and 6, which must come out all
    zeros, its other features at 1e-4 and its labels equal; and
    render_guides of a 64^2 run_patch batch whose boxes differ in size
    (one launch over the largest box, each row cropped to its own).
    Returns the larger B1 error."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.data import pipeline_iin
    from boxsegliver_torch.data.pipeline import batch_to_device
    from boxsegliver_torch.data.sampler_iin import IinSampler
    from boxsegliver_torch.evaluators.iin_eval import (IinPatchLoader,
                                                        render_guides)

    args = cli.get_args(iin_argv("train", "chip_smoke_iin_b1", tmp,
                                 Path(tmp) / "iin_b1", *IIN_TRAIN))
    raw = IinSampler(ds, args, seed=seed, tumor_percent=1.0).sample_batch(8)
    off = [1, 4, 6]
    raw["sp_on"][off] = 0.0
    if not raw["sp_on"].sum() == 5:
        raise AssertionError(f"nf2 B1 check: sp_on {raw['sp_on']}")
    draws = pipeline_iin.draw_iin(
        torch.Generator().manual_seed(seed),
        (8, args.im_height, args.im_width, args.im_channel), noise=True,
        gamma=True, device="cpu")
    orig = pipeline_iin.draw_iin
    pipeline_iin.draw_iin = lambda *a, device, **k: {
        n: v.to(device) for n, v in draws.items()}
    try:
        fn = pipeline_iin.make_iin_preprocess_fn(args, train=True)
        (card, card_lab), _, launches = counted_run(
            lambda: fn(batch_to_device(raw, dev), None))
        cpu, cpu_lab = fn(batch_to_device(raw, "cpu"), None)
    finally:
        pipeline_iin.draw_iin = orig
    expect_launches("nf2 preprocess (B1 check)", launches,
                    {"gaussian_guide_batch": 1})
    guide = card["sp_guide"].cpu()
    g_err = float((guide - cpu["sp_guide"]).abs().max())
    f_err = max(float((card[k].cpu() - cpu[k]).abs().max())
                for k in ("images", "context"))
    on = [i for i in range(8) if i not in off]
    if not (g_err <= 1e-6 and f_err <= 1e-4
            and torch.equal(card_lab.cpu(), cpu_lab)
            and float(guide[off].abs().max()) == 0.0
            and float(guide[on].amax(dim=(1, 2, 3)).min()) > 0.5):
        raise AssertionError(f"nf2 preprocess on the card disagrees with "
                             f"the CPU: sp_guide {g_err}, features {f_err}")

    sizes = []
    for meta in cli._test_metas(ev_args, ds):
        loader = IinPatchLoader(meta, ds, ev_args)
        for i in range(0, len(loader.items), ev_args.batch_size):
            rows = [loader._patch_features(*it) for it in
                    loader.items[i:i + ev_args.batch_size]]
            sizes = [(b[2] - b[0], b[3] - b[1]) for _, _, b in rows]
            if len(set(sizes)) > 1:
                break
        if len(set(sizes)) > 1:
            break
    else:
        raise AssertionError("nf2 B1 check: no run_patch batch with boxes "
                             "of different sizes")
    centers = [c for _, c, _ in rows]
    out, _, launches = counted_run(lambda: render_guides(
        centers, sizes, loader.guide_scale, loader.target, dev))
    expect_launches("nf2 render_guides (B1 check)", launches,
                    {"gaussian_guide_batch": 1})
    ref = render_guides(centers, sizes, loader.guide_scale, loader.target)
    worst = max(float(np.abs(a - b).max()) for a, b in zip(out, ref))
    print(f"  nf2 B1 card vs CPU: train preprocess 8 x 256^2, K = 1, sp_on "
          f"0 at rows {off}: sp_guide max abs err {g_err:.2e} (the sp_on = 0"
          f" rows all zeros), images and context {f_err:.2e}, labels equal; "
          f"render_guides of {len(rows)} patches, boxes {sorted(set(sizes))}"
          f" -> 64^2: max abs err {worst:.2e}")
    if not worst <= 1e-6:
        raise AssertionError(f"nf2 render_guides on the card disagrees with "
                             f"the CPU: {worst}")
    return max(g_err, worst)


def iin_phase(tmp, dev, seed):
    """Phase 22: (a) 004_gnet_iin.sh train and its steady state; (b)
    run_patch with and without mirror TTA; (c) --mode infer --pos; (d) the
    nf2 export served; (e) card vs CPU; (f) B1 at nf2's shapes, card vs
    CPU.  Returns the launches of each path and (f)'s B1 error."""
    from boxsegliver_torch.cli import main as cli

    ds = Path(tmp) / "synthetic_nf"
    md, launches = iin_train_phase(tmp, ds)
    paths = {"nf2 train (004_gnet_iin)": launches}
    paths.update(iin_eval_phase(tmp, ds, md))
    bundle = cli.main(iin_argv("export", "chip_smoke_iin", tmp, md,
                               *IIN_EVAL))
    *_, per_req = serve_bundle(bundle, "nf2 bundle (GUNet_IIN.yml)",
                               requests=1, seed=seed)
    expect_launches("nf2 serving", per_req, nhwc_counts({
        "in_relu_fwd": IIN_BLOCKS, "modnorm_relu_fwd": GUNET_MOD_BLOCKS}))
    paths["serve (nf2 export)"] = {n: int(v) for n, v in per_req.items()}
    ev_args = iin_card_vs_cpu(tmp, ds, dev, seed)
    b1_err = iin_guides_card_vs_cpu(tmp, ds, dev, seed, ev_args)
    return paths, b1_err


# ---------------------------------------------------------------------------
# phase 23: DenseUNet (003_denseunet.sh), GUNet's --use_se and VGG contexts
# ---------------------------------------------------------------------------

# run_scripts/template/003_denseunet.sh COMMON, train and eval flags (the
# dataset, the fold and the step counts are the smoke's own, appended below)
DENSE_COMMON = ["--tag", "chip_smoke_dense", "--model", "DenseUNet",
                "--classes", "Liver", "Tumor", "--test_fold", "2",
                "--im_height", "256", "--im_width", "256", "--im_channel",
                "3", "--random_flip", "3", "--num_replicas", "0",
                "--dataset", "LiTS"]
DENSE_TRAIN_FLAGS = ["liver", "--mode", "train"] + DENSE_COMMON + [
    "--noise_scale", "0.05", "--num_of_total_steps", "600000",
    "--primary_metric", "Tumor/Dice", "--secondary_metric", "Liver/Dice",
    "--loss_weight_type", "numerical", "--loss_numeric_w", "0.2", "0.4",
    "4.4", "--batches_per_epoch", "2000", "--batch_size", "8", "--dropout",
    "0.2", "--weight_decay_rate", "0.000001", "--learning_policy",
    "plateau", "--learning_rate", "0.001", "--lr_end", "0.0000005",
    "--lr_decay_rate", "0.2", "--eval_num_batches_per_epoch", "200",
    "--eval_per_epoch", "--evaluator", "Volume", "--save_best"]
DENSE_EVAL_FLAGS = ["liver", "--mode", "eval"] + DENSE_COMMON + [
    "--metrics_eval", "Dice", "VOE", "RVD", "--primary_metric", "Tumor/Dice",
    "--batch_size", "8", "--evaluator", "Volume"]
DENSE_STEPS = 16


class KeepMasks:
    """``layers.dropout_apply`` that records the keep masks of one run and,
    after ``replay()``, gives them again in the same order on the caller's
    device to each later run: the card's and the CPU's generators draw
    different masks."""

    def __init__(self, real):
        self.real, self.masks, self.next = real, [], None

    def replay(self):
        self.next = 0

    def __call__(self, x, keep, keep_prob):
        if self.next is None:
            self.masks.append(keep.cpu())
        else:
            keep = self.masks[self.next].to(x.device)
            self.next += 1
        return self.real(x, keep, keep_prob)


def grad_rel_err(grads, ref) -> float:
    """‖grads − ref‖ / ‖ref‖ over all the tensors together."""
    num = sum(float((g.double() - r.double()).pow(2).sum())
              for g, r in zip(grads, ref))
    return math.sqrt(num / sum(float(r.double().pow(2).sum()) for r in ref))


def dense_train_phase(tmp, ds):
    """(a) 003_denseunet.sh train through the CLI at full width
    (DenseUNet.yml: DenseNet-161, stem 96, growth 48, blocks 6/12/36/24),
    batch 8, 256^2 x 3, bf16, one host worker: 16 steps with the online
    eval every 8, then a resume to 32 at --steps_per_dispatch 16 (one CUDA
    graph replay a step); batch norm only, so every kernel count stays 0.
    Then the step in steady state at K = 1 and K = 16: ms/step, slices/s,
    busy share, host launches a step, the share of the bf16 peak and the
    peak device memory."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.train.checkpoint import load_state

    md = Path(tmp) / "dense_md"
    argv = DENSE_TRAIN_FLAGS + smoke_data(
        tmp, md, "--batches_per_epoch", "8", "--eval_num_batches_per_epoch",
        "4", "--log_step", "4", *ONE_WORKER)
    trainer, seconds, launches = no_kernel_run(
        lambda: cli.main(argv + ["--num_of_steps", str(DENSE_STEPS)]),
        "DenseUNet train")
    if trainer.global_step != DENSE_STEPS:
        raise AssertionError(f"DenseUNet train stopped at "
                             f"{trainer.global_step}")
    lines = [json.loads(ln) for ln in
             (md / "summaries" / "metrics.jsonl").read_text().splitlines()]
    loss = {ln["step"]: ln["value"] for ln in lines
            if ln["tag"] == "chip_smoke_dense/loss"}
    evals = {ln["step"]: ln["value"] for ln in lines
             if ln["tag"] == "chip_smoke_dense/eval/Liver/Dice"}
    if not loss or not all(math.isfinite(v) for v in loss.values()):
        raise AssertionError(f"non-finite DenseUNet train loss: {loss}")
    if sorted(evals) != [8, 16]:
        raise AssertionError(f"DenseUNet online evals at {sorted(evals)}")
    rv = load_state(md / "ckpt" / "16" / "state.pt")["model"][
        "conv1_bn.running_var"]
    if bool(torch.equal(rv, torch.ones_like(rv))):
        raise AssertionError("DenseUNet's running statistics did not move")
    del trainer
    again, seconds2, _ = no_kernel_run(
        lambda: cli.main(argv + ["--num_of_steps", "32",
                                 "--steps_per_dispatch", "16"]),
        "DenseUNet train, K=16")
    if again.global_step != 32 or not (md / "ckpt" / "32" /
                                       "state.pt").exists():
        raise AssertionError(f"DenseUNet K=16 resume ended at "
                             f"{again.global_step}")
    del again
    print(f"  DenseUNet train (003_denseunet.sh flags, DenseUNet.yml full "
          f"width): {DENSE_STEPS} steps of 8 x 256^2 in {seconds:.2f} s "
          f"(with set-up and two online evals of 4 batches); loss "
          + ", ".join(f"{s}: {loss[s]:.4f}" for s in sorted(loss))
          + f"; eval Liver/Dice {evals}; resume 17-32 at K = 16 in "
          f"{seconds2:.2f} s (graph captures included); launches "
          f"{launches}; {smi()}")

    walls = {}
    for k in (1, 16):
        args = cli.get_args(DENSE_TRAIN_FLAGS + smoke_data(
            tmp, Path(tmp) / f"dense_b{k}", "--steps_per_dispatch", str(k)))
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        walls[k], _, _ = steady(args, ds, f"003_denseunet.sh train step, "
                                f"K={k}", prof_steps=2 if k == 1 else 16,
                                top=10)
        print(f"  DenseUNet steady state K={k} in "
              f"{time.perf_counter() - t0:.1f} s")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        total = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
        print(f"  DenseUNet K={k}: peak device memory allocated {peak:.2f} "
              f"GiB of {total:.1f} GiB, {peak - base:.2f} GiB above the "
              f"{base:.2f} GiB held before the run")
    print(f"  DenseUNet train step ms/step (median of 3 windows of 16): K=1 "
          f"{walls[1] * 1e3:.3f}, K=16 {walls[16] * 1e3:.3f}; slices/s "
          f"{8 / walls[1]:.1f} / {8 / walls[16]:.1f}; {smi()}")
    return md, launches


def dense_card_vs_cpu(tmp, dev, seed):
    """(b) one train-mode forward and backward of DenseUNet.yml at full
    width (batch 2, 128^2, TF32 off) from the same seeded weights and
    processed batch, with the keep masks of --dropout 0.2 and of the
    decoder's 0.3 drawn once on the CPU and replayed: in float32 on the CPU
    and on the card, and in float64 on the CPU (the parameters, the inputs
    and the forward up to the float32 logits).  The card's loss and moved
    running statistics within 1e-4 of the CPU's.  Float32 gradients of this
    160-layer batch-norm network are ill-conditioned: the CPU's own float32
    gradients are about as far from the float64 ones as the card's are from
    the CPU's (PERF.md, PR 12), so the card's float32 gradients are held
    against the float64 ones: their error, over all tensors together, at
    most twice the CPU float32 gradients' error."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.data.pipeline import (_process_batch,
                                                 batch_to_device, norm_statics)
    from boxsegliver_torch.data.sampler import TrainSampler
    from boxsegliver_torch.models import layers
    from boxsegliver_torch.ops.image_ops import draw_augment

    t0 = time.perf_counter()
    argv = DENSE_TRAIN_FLAGS + smoke_data(
        tmp, Path(tmp) / "dense_cmp_md", "--im_height", "128", "--im_width",
        "128", "--compute_dtype", "float32", "--batch_size", "2")
    args = cli.get_args(argv)
    raw = TrainSampler(Path(tmp) / "ds", args, seed=seed).sample_batch(2)
    draws = draw_augment(torch.Generator().manual_seed(seed),
                         (2, 128, 128, 3), noise=True, device="cpu")
    feats, labels = _process_batch(
        batch_to_device(raw, "cpu"), draws, im_h=128, im_w=128,
        noise_scale=0.05, random_flip=3, use_spatial=False, min_std=2.0,
        **norm_statics(args))
    masks = KeepMasks(layers.dropout_apply)
    out = []
    layers.dropout_apply = masks
    try:
        for d, dt in ((torch.device("cpu"), torch.float32),
                      (torch.device("cpu"), torch.float64),
                      (dev, torch.float32)):
            trainer = cli.build_trainer(args, d)
            trainer.model.to(dt).dtype = dt
            ft = {k: v.to(d, dt) for k, v in feats.items()}
            grads, total, _, _ = trainer.gradients(ft, labels.to(d))
            out.append((float(total), [g.cpu() for g in grads], {
                k: v.cpu() for k, v in trainer.model.state_dict().items()
                if "running" in k}))
            trainer.summary.close()
            if masks.next not in (None, len(masks.masks)):
                raise AssertionError(f"{masks.next} of {len(masks.masks)} "
                                     "keep masks replayed")
            masks.replay()
    finally:
        layers.dropout_apply = masks.real
    (lc, gc, sc), (_, g64, _), (lg, gg, sg) = out
    loss_err = abs(lg - lc) / abs(lc)
    s_err = max(float((sg[k] - v).abs().max()) for k, v in sc.items())
    g_abs = max(float((a - b).abs().max()) for a, b in zip(gg, gc))
    e_card, e_cpu = grad_rel_err(gg, g64), grad_rel_err(gc, g64)
    print(f"  DenseUNet train step card vs CPU (DenseUNet.yml full width, 2 "
          f"x 128^2, float32, {len(masks.masks)} keep masks replayed): loss "
          f"{lg:.6f} / {lc:.6f} (rel err {loss_err:.2e}); running "
          f"statistics max abs err {s_err:.2e}; gradients card vs CPU max "
          f"abs err {g_abs:.2e} (largest |gradient| "
          f"{max(float(g.abs().max()) for g in gc):.3e}); against the "
          f"float64 CPU gradients (norm over all tensors): card "
          f"{e_card:.3e}, CPU float32 {e_cpu:.3e}; "
          f"{time.perf_counter() - t0:.1f} s")
    if not (loss_err <= 1e-4 and s_err <= 1e-4 and e_card <= 2 * e_cpu):
        raise AssertionError("the DenseUNet train step on the card disagrees "
                             "with the CPU")


def dense_eval_phase(tmp, ds, dev, md, seed):
    """(c) 003_denseunet.sh eval through the CLI on (a)'s best (s/case);
    the first test case's per-case metrics on the card against the CPU in
    float32 (1e-3: a voxel whose classes' probabilities differ by less than
    the two devices' ~1e-5 may take either argmax) and device_case's
    probabilities over 8 slices of it (1e-4); cli/eval_all_ckpt over
    ckpt_best/<tag> (s/checkpoint); --mode export served on the card (3
    requests after the warm-up, ms/request) against the eager model within
    one bf16 step.  Every kernel count stays 0."""
    from boxsegliver_torch.cli import eval_all_ckpt
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.evaluators.device_eval import DeviceSlicePredictor
    from boxsegliver_torch.evaluators.eval_loader import parse_case_eval
    from boxsegliver_torch.evaluators.volume import EvaluateVolume

    paths = {}
    argv = DENSE_EVAL_FLAGS + smoke_data(tmp, md)
    results, seconds, paths["DenseUNet eval (003_denseunet)"] = \
        no_kernel_run(lambda: cli.main(argv), "DenseUNet eval")
    if not {"Liver/Dice", "Liver/VOE", "Liver/RVD", "Tumor/Dice",
            "GLiverDice"} <= set(results) or not all(
                math.isfinite(v) for v in results.values()):
        raise AssertionError(f"DenseUNet eval results {results}")
    args = cli.get_args(argv)
    metas = cli._test_metas(args, ds)
    slices = sum(parse_case_eval(m, ds, parse_label=False).depth
                 for m in metas)
    print(f"  DenseUNet eval (003_denseunet eval flags, (a)'s best "
          f"checkpoint): {len(metas)} cases, {slices} slices; "
          f"{seconds / len(metas):.3f} s/case, {slices / seconds:.2f} "
          f"slices/s through the CLI; results " + json.dumps(results))

    args32 = cli.get_args(argv + ["--compute_dtype", "float32"])
    per_case, probs = [], []
    cut = cut_case(parse_case_eval(metas[0], ds, parse_label=False), 0)
    for d in (dev, torch.device("cpu")):
        model = cli.build_model_from_args(args32, d)
        ev = EvaluateVolume(args32, ds, ["Background"] + list(args.classes))
        pred = DeviceSlicePredictor(model, args32, device=d)
        ev.run(pred, metas[:1])
        per_case.append({k: v[0] for k, v in ev._metric_values.items()})
        probs.append(pred.device_case(cut))
    m_err = max(abs(per_case[0][k] - v) for k, v in per_case[1].items())
    p_err = float(np.abs(probs[0] - probs[1]).max())
    print(f"  DenseUNet eval card vs CPU (float32, case {metas[0]['PID']}): "
          f"per-case metrics max abs err {m_err:.2e} ({per_case[0]}); "
          f"device_case over 8 slices max abs err {p_err:.2e}")
    if not (m_err <= 1e-3 and p_err <= 1e-4):
        raise AssertionError("the DenseUNet eval on the card disagrees with "
                             "the CPU")

    rows, seconds, paths["DenseUNet checkpoint sweep"] = no_kernel_run(
        lambda: eval_all_ckpt.main(argv), "DenseUNet eval_all_ckpt")
    if not rows or not all(math.isfinite(r["Liver/Dice"]) for r in rows):
        raise AssertionError(f"DenseUNet eval_all_ckpt rows {rows}")
    print(f"  DenseUNet eval_all_ckpt over {[r['ckpt'] for r in rows]}: "
          f"{seconds / len(rows):.3f} s/checkpoint")

    t0 = time.perf_counter()
    bundle = cli.main(["export" if a == "eval" else a for a in argv])
    print(f"  DenseUNet export (003_denseunet eval flags, batch 8, 256^2, "
          f"bf16) in {time.perf_counter() - t0:.2f} s")
    feats, served, _, per_req = serve_bundle(bundle, "serve DenseUNet",
                                             requests=3, seed=seed)
    expect_launches("DenseUNet serving", per_req, {})
    paths["serve (DenseUNet export)"] = {n: int(v)
                                         for n, v in per_req.items()}
    live = cli.build_model_from_args(args, dev)
    with torch.no_grad():
        want = torch.softmax(live({k: torch.from_numpy(v).to(dev)
                                   for k, v in feats.items()}), -1).cpu()
    err = (torch.from_numpy(served) - want).abs()
    bad = err > 2.0 ** -7 * want.abs() + 1e-5        # b2_check's bf16 bound
    print(f"  DenseUNet response vs the eager model + softmax on the card "
          f"(bf16): max abs err {float(err.max()):.3e}, {int(bad.sum())} "
          f"elements beyond one bf16 rounding step")
    if bool(bad.any()):
        raise AssertionError("the served DenseUNet disagrees with the eager "
                             "model")
    return paths


def se_phase(tmp, dev, seed, ds):
    """(d) GUNet --use_se with the 002_gnet_sp.sh train flags (GUNet.yml
    full width, the flagship's dataset, one host worker): 8 steps through
    the CLI with exactly one B1 launch (the train guide) and 10 B2-fwd and
    10 backward launches a step (in_relu_bwd_plan: B2f); the step in steady state at K = 1 with B1 and B2
    device ms per step against their bounds; a GUNet_TINY --use_se train
    step card vs CPU (train_card_vs_cpu).  (e) A full-width GUNet.yml
    forward with each 1-D VGG context (2 x 128^2, float32, the context's
    final Dense drawn away from its zeros / ones init) on the card against
    the CPU within 1e-4.  Returns the launches of the --use_se run."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.models import MODEL_CONFIGS, build_model
    from boxsegliver_torch.models.layers import VGG_REPS

    steps = 8
    # --use_se with a context leaves the modulated blocks off B3
    trainer, launches, seconds = train_run(smoke_train_argv(
        tmp, steps, "--use_se", "--model_dir", str(Path(tmp) / "se_md"),
        *ONE_WORKER), steps, b3=False)
    if trainer.global_step != steps:
        raise AssertionError(f"--use_se train stopped at "
                             f"{trainer.global_step}")
    del trainer
    expect_launches("GUNet --use_se train", launches, nhwc_counts({
        "gaussian_guide_batch": steps,
        **b2_train_counts(B2_STEP_SHAPES, steps)}))
    print(f"  GUNet --use_se train (002_gnet_sp.sh flags, GUNet.yml): "
          f"{steps} steps of 8 x 256^2 in {seconds:.2f} s; launches "
          f"{launches}: B1 1 and B2-fwd / B2f {GUNET_B2_PAIRS} a step")

    rng = np.random.default_rng(seed)
    c, sd, v = guide_inputs(rng, 8, 8, 256, 256, "cuda",
                            n_valid=rng.integers(0, 9, 8))
    b1_bound = b1_bound_ms(c, sd, v, 256, 256, sfu_per_s())[0]
    # --use_se leaves the modulated levels on the plain norm: B2 runs on
    # the flagship step's pairs
    b2_bound = b2_step_bound_ms(B2_STEP_SHAPES)
    args = cli.get_args(smoke_train_argv(
        tmp, 10 ** 6, "--use_se", "--model_dir", str(Path(tmp) / "se_b1")))
    groups = {}
    wall, _, _ = steady(args, ds, "GUNet --use_se train step, K=1",
                        kernels_used=train_kernels(b3=False), top=10,
                        groups_out=groups)
    b1 = groups["B1 guide_render"]
    b2 = groups["B2 in_relu (fwd, bwd, bwd_stats, bwd_apply)"]
    print(f"  GUNet --use_se step K=1: {wall * 1e3:.3f} ms/step; B1 "
          f"{b1:.5f} ms/step device (bound {b1_bound:.6f} ms, "
          f"{b1_bound / max(b1, 1e-12):.1%}), B2 {b2:.4f} ms/step device "
          f"(bound {b2_bound:.4f} ms, {b2_bound / max(b2, 1e-12):.1%}); "
          f"{smi()}")
    train_card_vs_cpu(tmp, dev, seed, "--use_se")

    kw = MODEL_CONFIGS["GUNet.yml"]
    x = {"images": torch.rand(2, 128, 128, 3,
                              generator=torch.Generator().manual_seed(seed)),
         "sp_guide": torch.full((2, 128, 128, 1), 0.5),
         "context": torch.rand(2, 200,
                               generator=torch.Generator().manual_seed(1))}
    for variant in VGG_REPS:
        targs = cli.get_args(FLAGS + ["--model_dir", str(Path(tmp) / "vgg"),
                                      "--compute_dtype", "float32"])
        model = build_model("GUNet", args=targs, model_kwargs=dict(
            kw, context_model=variant), dtype=torch.float32)
        gen = torch.Generator().manual_seed(seed)
        model.reset_parameters(gen)
        last = model.context.MLP_0._modules[
            f"Dense_{model.context.MLP_0.n_layers - 1}"]
        with torch.no_grad():
            last.weight.normal_(0.0, 0.05, generator=gen)
        out = []
        for d in (dev, torch.device("cpu")):
            model = model.to(d).eval()
            with torch.no_grad():
                out.append(model({k: t.to(d) for k, t in x.items()}).cpu())
        err = float((out[0] - out[1]).abs().max())
        print(f"  GUNet.yml {variant} context ({len(model.context.plan)} "
              f"convs over 200 bins) forward card vs CPU (2 x 128^2, "
              f"float32): max abs err {err:.2e}, max |logit| "
              f"{float(out[1].abs().max()):.2f}")
        if not err <= 1e-4:
            raise AssertionError(f"the {variant} GUNet forward on the card "
                                 "disagrees with the CPU")
    return launches


def dense_phase(tmp, dev, seed):
    """Phase 23: (a)-(c) DenseUNet on the flagship's dataset, (d)-(e)
    GUNet --use_se and the VGG contexts.  Returns the launches of each
    path."""
    ds = Path(tmp) / "ds"
    t0 = time.perf_counter()
    md, launches = dense_train_phase(tmp, ds)
    paths = {"DenseUNet train (003_denseunet)": launches}
    t1 = time.perf_counter()
    dense_card_vs_cpu(tmp, dev, seed)
    t2 = time.perf_counter()
    paths.update(dense_eval_phase(tmp, ds, dev, md, seed))
    t3 = time.perf_counter()
    paths["GUNet --use_se train"] = se_phase(tmp, dev, seed, ds)
    print(f"  phase 23 seconds: train {t1 - t0:.1f}, card vs CPU "
          f"{t2 - t1:.1f}, eval / sweep / serving {t3 - t2:.1f}, --use_se "
          f"and VGG {time.perf_counter() - t3:.1f}")
    return paths


# ---------------------------------------------------------------------------
# phase 24: data parallel (001_dist.sh) over a process group
# ---------------------------------------------------------------------------

# run_scripts/template/001_dist.sh train flags for 2 ranks (per-rank batch 8,
# global 16); the dataset, the fold and the step counts are the smoke's own
DIST_RANKS = 2
DIST_TRAIN_FLAGS = ["liver", "--mode", "train", "--tag", "chip_smoke_dist",
                    "--model", "UNet", "--classes", "Liver", "Tumor",
                    "--im_height", "256", "--im_width", "256", "--im_channel",
                    "3", "--random_flip", "3", "--num_replicas",
                    str(DIST_RANKS), "--batch_size", str(8 * DIST_RANKS),
                    "--noise_scale", "0.05", "--num_of_total_steps",
                    "600000", "--primary_metric", "Tumor/Dice",
                    "--secondary_metric", "Liver/Dice", "--loss_weight_type",
                    "numerical", "--loss_numeric_w", "0.2", "0.4", "4.4",
                    "--batches_per_epoch", "2000", "--learning_policy",
                    "plateau", "--learning_rate", "0.001", "--lr_end", "0",
                    "--lr_decay_rate", "0.2", "--eval_per_epoch",
                    "--evaluator", "Volume", "--save_best", "--device_cache"]
# the ranks against one process: float32 (TF32 off) and Momentum, whose
# update is the gradient's arithmetic (an Adam step turns a gradient within
# round-off of 0 into ±lr; see train_card_vs_cpu)
DIST_EXACT = ["--compute_dtype", "float32", "--optimizer", "Momentum"]
DIST_STEPS = 3
DIST_TIMED = 8
DIST_LABEL = ("N ranks sharing one card over gloo: a correctness run, not a "
              "scaling figure")


def dist_train_argv(tmp, md, flags, *extra):
    return flags + smoke_data(tmp, md, *DIST_EXACT, *ONE_WORKER) + list(extra)


def dist_train(group, tmp, argv, seed):
    """DIST_STEPS steps of ``argv``'s trainer (a rank of ``group``, or one
    process over the global batch with None) on the same seeded global
    batches of the device-cache layout: the global batch's gradient at the
    start (the state restored after it), the step values, the parameters
    and buffers after the steps, the launches of the steps, then the step
    in steady state (DIST_TIMED steps), and again with each collective
    timed between synchronizations."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.data.device_cache import DeviceVolumeCache
    from boxsegliver_torch.data.pipeline import batch_to_device
    from boxsegliver_torch.data.sampler import TrainSampler
    from boxsegliver_torch.ops import kernels

    dev = torch.device("cuda")
    args = cli.get_args(argv)
    ds = Path(tmp) / "ds"
    train_pids, _ = cli._split_pids(args, ds)
    cache = DeviceVolumeCache(ds, [int(p) for p in train_pids], dev)
    sampler = TrainSampler(ds, args, mode="train", seed=seed,
                           zbase=cache.zbase)
    rng = np.random.RandomState(seed)
    bs, k = int(args.batch_size), int(args.steps_per_dispatch)
    batches = [sampler.sample_batch(bs, rng=rng)
               for _ in range(DIST_STEPS + DIST_TIMED)]
    trainer = cli.build_trainer(args, dev, cache=cache, group=group)
    model0 = {n: v.clone() for n, v in trainer.model.state_dict().items()}
    gen0 = trainer.generator.get_state()
    raw = batches[0] if group is None else group.take_rows(batches[0])
    feats, labels = trainer.preprocess_fn(batch_to_device(raw, dev),
                                          trainer.generator)
    grads, total, _, _ = trainer.gradients(feats, labels)
    grad = torch.cat([g.reshape(-1) for g in grads]).cpu()
    trainer.model.load_state_dict(model0)
    trainer.generator.set_state(gen0)
    del feats, labels, grads, model0
    kernels.reset_launch_counts()
    vals = []
    for i in range(0, DIST_STEPS, k):
        vals += [v for _, v, _ in trainer.train_multi_step(
            batches[i:i + k])]
    torch.cuda.synchronize()
    launches = {n: f.launches for n, f in kernels.KERNELS.items()}
    out = {"grad": grad, "total": float(total),
           "values": torch.stack(vals).cpu(), "launches": launches,
           "state": {n: v.detach().to("cpu", copy=True) for n, v in
                     trainer.model.state_dict().items()}}

    def window():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(DIST_STEPS, DIST_STEPS + DIST_TIMED, k):
            trainer.train_multi_step(batches[i:i + k])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / DIST_TIMED * 1e3

    window()                                        # warm
    out["ms"] = window()
    if group is not None:
        spent = [0.0, 0]
        plain = group.all_reduce_

        def timed(t):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain(t)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            spent[1] += 1
            return t

        group.all_reduce_ = timed
        out["ms_timed"] = window()
        group.all_reduce_ = plain
        out["coll_ms"] = spent[0] / DIST_TIMED * 1e3
        out["colls"] = spent[1] / DIST_TIMED
    if trainer.summary is not None:
        trainer.summary.close()
    return out


def train_errors(got, ref) -> dict:
    """A run's first 3 steps against one process over the global batch:
    loss (max relative), the gradient (relative L2 over all parameters),
    parameters and running statistics (max abs)."""
    stats = [n for n in ref["state"] if "running" in n]
    params = [n for n in ref["state"] if "running" not in n]
    return {
        "loss": float(((got["values"][:, 0] - ref["values"][:, 0]).abs()
                       / ref["values"][:, 0].abs()).max()),
        "grad": float((got["grad"] - ref["grad"]).norm()
                      / ref["grad"].norm()),
        "params": _max_err(got["state"], ref["state"], params),
        "stats": _max_err(got["state"], ref["state"], stats),
        "n_stats": len(stats)}


def rank_spread(group, state) -> float:
    """Largest difference between this rank's tensors and rank 0's."""
    flat = torch.cat([v.reshape(-1).float() for v in state.values()])
    ref = group.broadcast_(flat.clone())
    return float((flat - ref).abs().max())


def _max_err(a: dict, b: dict, keys) -> float:
    return max((float((a[n].float() - b[n].float()).abs().max())
                for n in keys), default=0.0)


def dist_evals(group, tmp, unet_md, inter_md):
    """The unguided ``run`` (phase 10's UNet on the flagship's set) and
    ``run_sp`` (phase 19c's UNetInter on synthetic_nf) of the eval CLI's
    flags in float32 (TF32 off: the per-case metrics are held at 1e-6), with
    the DeviceSlicePredictor and EvaluateVolume of ``group`` (None: one
    process): per-case metrics, results, launches, seconds."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.evaluators.device_eval import DeviceSlicePredictor
    from boxsegliver_torch.evaluators.volume import EvaluateVolume

    dev = torch.device("cuda")
    out = {}
    for name, argv in (
            ("run", UNET_EVAL_FLAGS + smoke_data(tmp, unet_md)),
            ("run_sp", nf_argv("nf", "eval", "chip_smoke_nf_inter", tmp,
                               inter_md, *INTER_MODEL))):
        args = cli.get_args(argv + ["--compute_dtype", "float32"])
        ds = cli.resolve_dataset_dir(args)
        model = cli.build_model_from_args(args, dev)
        pred = DeviceSlicePredictor(model, args, device=dev, group=group)
        ev = EvaluateVolume(args, ds, ["Background"] + list(args.classes),
                            group=group)
        metas = cli._test_metas(args, ds)
        run = ev.run if name == "run" else ev.run_sp
        res, seconds, launches = counted_run(lambda: run(pred, metas))
        out[name] = {"results": res, "s": seconds, "launches": launches,
                     "cases": len(metas),
                     "per_case": {m: list(v) for m, v in
                                  ev._metric_values.items()}}
    return out


def dist_refiners(group, tmp, inter_md):
    """Phase 20's click eval cases through the CLI's DeviceRefiner2D of
    ``group`` (None: one process), gaussian and geodesic guides, float32:
    per case Dice, clicks and rounds, and the launches."""
    from boxsegliver_torch import config as config_mod
    from boxsegliver_torch.cli import interactive_eval as icli
    from boxsegliver_torch.cli import main as cli

    dev = torch.device("cuda")
    parser = icli.build_parser()
    args = parser.parse_args(click_eval_argv(
        tmp, inter_md, "on", "gaussian", "--compute_dtype", "float32"))
    config_mod.check_args(args, parser)
    config_mod.fill_default_args(args)
    model = cli.build_model_from_args(args, dev)
    cases = click_eval_cases(args)
    out = {}
    for kind in ("gaussian", "geodesic"):
        args.guide_kind = kind
        refiner = icli.build_refiner(args, model, dev, group)
        rows, rounds = [], []

        def refine_all():
            for images, labels in cases:
                rows.append(refiner.refine_case(images, labels))
                rounds.append(refiner.rounds)

        _, seconds, launches = counted_run(refine_all)
        out[kind] = {"cases": rows, "rounds": rounds, "s": seconds,
                     "launches": launches}
    return out


def dist_runs(group, tmp, unet_md, inter_md, seed):
    """24a-d on this process: a rank of ``group``, or one process."""
    suffix = "" if group is None else "_group"
    return {"24a": dist_train(group, tmp, dist_train_argv(
                tmp, Path(tmp) / f"dist_md{suffix}", DIST_TRAIN_FLAGS), seed),
            "24b": dist_train(group, tmp, dist_train_argv(
                tmp, Path(tmp) / f"dist_gnet_md{suffix}", TRAIN_FLAGS,
                "--batch_size", str(8 * DIST_RANKS), "--device_cache",
                *(() if group is None else
                  ("--steps_per_dispatch", str(DIST_STEPS)))), seed),
            "24c": dist_evals(group, tmp, unet_md, inter_md),
            "24d": dist_refiners(group, tmp, inter_md)}


def dist_rank(group, tmp, unet_md, inter_md, seed, ref_path):
    """One rank of phase 24's gloo group (24a-d).  Rank 0 holds its train
    runs against one process's (``ref_path``); every rank's spread from
    rank 0 is measured; the small results of every rank are gathered to
    rank 0."""
    from boxsegliver_torch import config as config_mod

    config_mod.resolve_device("cuda")                # TF32 off here too
    out = dist_runs(group, tmp, unet_md, inter_md, seed)
    ref = torch.load(ref_path, weights_only=False) if group.chief else None
    for part in ("24a", "24b"):
        r = out[part]
        r["spread"] = rank_spread(group, r["state"])
        if group.chief:
            r["errors"] = train_errors(r, ref[part])
        for big in ("state", "grad"):
            r.pop(big)
    return group.gather_to_chief(out)


def dist_graph(group, tmp, seed, ref_path=None):
    """24e: 32 flagship train steps at --steps_per_dispatch 16 (two
    replays of the captured step), with ``group`` (a 1-rank NCCL group:
    its gradient all-reduce captured in the graph) or without one; the
    parameters after them (held against ``ref_path``'s when given) and the
    launches of the 32 steps, then 3 windows of 16 steps (median ms/step)
    and the NCCL kernels of one replay by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from boxsegliver_torch import config as config_mod
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.data.sampler import TrainSampler

    dev = config_mod.resolve_device("cuda")
    args = cli.get_args(smoke_train_argv(
        tmp, 32, "--steps_per_dispatch", "16", "--model_dir",
        str(Path(tmp) / ("graph_group" if group else "graph_none"))))
    sampler = TrainSampler(Path(tmp) / "ds", args, seed=5)
    rng = np.random.RandomState(5)
    batches = [sampler.sample_batch(8, rng=rng) for _ in range(32)]
    trainer = cli.build_trainer(args, dev, group=group)

    def steps():
        for i in range(0, 32, 16):
            trainer.train_multi_step(batches[i:i + 16])

    _, _, launches = counted_run(steps)
    state = {n: v.detach().to("cpu", copy=True) for n, v in
             trainer.model.state_dict().items()}
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_multi_step(batches[:16])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / 16 * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.train_multi_step(batches[:16])
        torch.cuda.synchronize()
    out = {"ms": statistics.median(walls), "graphs": len(trainer._graphs),
           "launches": launches,
           "nccl": sorted({e.key for e in prof.key_averages()
                           if "nccl" in e.key.lower()}),
           "replay": {("metrics" if m else "no metrics"): c
                      for m, (_, c) in trainer._graphs.items()}}
    if ref_path is None:
        out["state"] = state
    else:
        ref = torch.load(ref_path, weights_only=True)
        out["err"] = _max_err(state, ref, ref)
        out["same"] = all(torch.equal(state[n], v) for n, v in ref.items())
    trainer.summary.close()
    return out


def dist_phase(tmp, dev, seed, unet_md, inter_md):
    """Phase 24: 24a-d with DIST_RANKS gloo ranks sharing the card (the
    kernels were built before any spawn) against one process (run first,
    its train runs kept on disk for rank 0); 24e a 1-rank NCCL group's
    graphed steps against the groupless ones; 24f the CLI over NCCL where
    the machine has two cards.  Returns the launch counts per path (rank
    0's)."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.parallel import launch

    t0 = time.perf_counter()
    one = dist_runs(None, tmp, unet_md, inter_md, seed)
    ref_path = Path(tmp) / "dist_ref.pt"
    torch.save({p: {"values": one[p]["values"], "grad": one[p]["grad"],
                    "state": one[p]["state"]} for p in ("24a", "24b")},
               ref_path)
    t_one = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch(dist_rank, DIST_RANKS, "cuda:0", tmp, unet_md, inter_md,
                   seed, str(ref_path), backend="gloo")
    print(f"  {DIST_RANKS} gloo ranks on cuda:0 (24a-d) in "
          f"{time.perf_counter() - t0:.1f} s with their start; one process "
          f"in {t_one:.1f} s; {smi()}")
    paths = {}

    for part, what in (
            ("24a", "24a 001_dist.sh train (UNet.yml, sync batch norm)"),
            ("24b", "24b 002_gnet_sp.sh train (GUNet.yml, K = 3 run eagerly "
                    "under gloo)")):
        r0, ref = ranks[0][part], one[part]
        e = r0["errors"]
        spread = max(r[part]["spread"] for r in ranks)
        print(f"  {what}: {DIST_RANKS} ranks vs one process over the global "
              f"batch of {8 * DIST_RANKS}, {DIST_STEPS} steps: loss max rel "
              f"err {e['loss']:.2e}, gradient rel L2 err {e['grad']:.2e}, "
              f"parameters max abs err {e['params']:.2e}, running statistics "
              f"max abs err {e['stats']:.2e} ({e['n_stats']} tensors), ranks' "
              f"spread {spread:.1e}")
        if not (e["loss"] <= 1e-4 and e["grad"] <= 1e-4
                and e["params"] <= 1e-4 and e["stats"] <= 1e-5
                and spread == 0.0):
            raise AssertionError(f"{part}: the ranks disagree with one "
                                 "process")
        print(f"  {part}, {DIST_LABEL}: {r0['ms']:.3f} ms/step with "
              f"{DIST_RANKS} ranks (one process: {ref['ms']:.3f}); the "
              f"collectives ({r0['colls']:.0f} a step, each between "
              f"synchronizations) take {r0['coll_ms']:.3f} of "
              f"{r0['ms_timed']:.3f} ms a step "
              f"({100 * r0['coll_ms'] / r0['ms_timed']:.1f} %)")
        want = ref["launches"]
        for r in ranks:
            if r[part]["launches"] != want:
                raise AssertionError(f"{part}: a rank launched "
                                     f"{r[part]['launches']}, one process "
                                     f"{want}")
        if part == "24a" and any(want.values()):
            raise AssertionError(f"24a: the batch-norm UNet launched {want}")
        if part == "24b" and not (want["gaussian_guide_batch"]
                                  and want["in_relu_fwd_nhwc"]):
            raise AssertionError(f"24b: one process launched {want}")
        print(f"  {part} launches a rank over {DIST_STEPS} steps = one "
              f"process's (batch {8 * DIST_RANKS}): {want}")
    paths["dist 001_dist train (rank 0 of 2)"] = ranks[0]["24a"]["launches"]
    paths["dist G-Net train (rank 0 of 2)"] = ranks[0]["24b"]["launches"]

    for name in ("run", "run_sp"):                    # 24c
        got, ref = ranks[0]["24c"][name], one["24c"][name]
        errs = [float(np.max(np.abs(np.asarray(got["per_case"][m])
                                    - np.asarray(v))))
                for m, v in ref["per_case"].items()]
        tot = max(abs(got["results"][m] - v)
                  for m, v in ref["results"].items())
        print(f"  24c {name} over {DIST_RANKS} ranks: {ref['cases']} cases "
              f"in {got['s']:.2f} s (one process {ref['s']:.2f}); per-case "
              f"metrics max abs err {max(errs):.1e}, totals {tot:.1e}; "
              f"launches rank 0 {got['launches']}, one process "
              f"{ref['launches']}")
        if set(got["per_case"]) != set(ref["per_case"]) or max(errs) > 1e-6 \
                or tot > 1e-6 or any(r["24c"][name]["results"]
                                     for r in ranks[1:]):
            raise AssertionError(f"24c {name}: the ranks disagree with one "
                                 "process")
        if got["launches"]["gaussian_guide_batch"] != \
                ref["launches"]["gaussian_guide_batch"]:
            raise AssertionError(f"24c {name}: B1 launches differ")
        paths[f"dist {name} (rank 0 of 2)"] = got["launches"]

    for kind, kernel in (("gaussian", "gaussian_guide_batch"),  # 24d
                         ("geodesic", "geodesic2d_batch")):
        ref = one["24d"][kind]
        for r in ranks:
            got = r["24d"][kind]
            clicks = [c["clicks"] for c in got["cases"]]
            if clicks != [c["clicks"] for c in ref["cases"]] or \
                    got["rounds"] != ref["rounds"] or \
                    got["launches"][kernel] != sum(ref["rounds"]):
                raise AssertionError(f"24d {kind}: clicks {clicks} rounds "
                                     f"{got['rounds']} launches "
                                     f"{got['launches']}; one process "
                                     f"{ref['cases']} {ref['rounds']}")
        got = ranks[0]["24d"][kind]
        d_err = max(abs(a["Dice"] - b["Dice"])
                    for a, b in zip(got["cases"], ref["cases"]))
        print(f"  24d refiner {kind} over {DIST_RANKS} ranks: equal clicks "
              f"and rounds {got['rounds']}, Dice max abs err {d_err:.1e}; "
              f"{kernel} a rank {got['launches'][kernel]} (one process "
              f"{ref['launches'][kernel]}); {got['s']:.2f} s (one process "
              f"{ref['s']:.2f})")
        if d_err > 1e-5:
            raise AssertionError(f"24d {kind}: Dice off by {d_err}")
        paths[f"dist refiner {kind} (rank 0 of 2)"] = got["launches"]

    # 24e: a 1-rank NCCL group's K = 16 graph against the groupless one
    plain = dist_graph(None, tmp, seed)
    graph_ref = Path(tmp) / "graph_ref.pt"
    torch.save(plain.pop("state"), graph_ref)
    torch.cuda.empty_cache()
    grouped = launch(dist_graph, 1, "cuda:0", tmp, seed, str(graph_ref),
                     backend="nccl")
    print(f"  24e K = 16 graph with a 1-rank NCCL group (its gradient "
          f"all-reduce captured): {grouped['graphs']} captured variants, per "
          f"replay {grouped['replay']}, launches in 32 steps "
          f"{grouped['launches']}; parameters after 32 steps vs no "
          f"group: bit-equal {grouped['same']}, max abs err "
          f"{grouped['err']:.1e}; {grouped['ms']:.3f} ms/step with the "
          f"group, {plain['ms']:.3f} without (median of 3 windows of 16); "
          f"NCCL kernels in a replay: {grouped['nccl']}")
    if grouped["graphs"] != 2 or grouped["err"] > 1e-6 or \
            grouped["launches"] != plain["launches"]:
        raise AssertionError(f"24e: the graphed group step disagrees "
                             f"(launches {grouped['launches']}, without "
                             f"a group {plain['launches']})")
    paths["dist G-Net K=16 (1-rank NCCL graph)"] = grouped["launches"]

    if torch.cuda.device_count() >= 2:                 # 24f
        out, seconds, _ = counted_run(lambda: cli.main(
            DIST_TRAIN_FLAGS + smoke_data(tmp, Path(tmp) / "dist_cli_md",
                                          "--num_of_steps", "8",
                                          *ONE_WORKER)))
        print(f"  24f 001_dist.sh train through the CLI over NCCL on "
              f"{DIST_RANKS} cards: {out} in {seconds:.1f} s")
        if out != {"global_step": 8}:
            raise AssertionError(f"24f: {out}")
    else:
        print(f"  24f not run: {torch.cuda.device_count()} card (the CLI "
              f"over NCCL needs {DIST_RANKS})")
    return paths



# ---------------------------------------------------------------------------
# phase 25: spatial sharding — B2 split around a collective (B2s, B2y),
# run_g's height-sharded sweep, the depth-sharded 3-D eval
# ---------------------------------------------------------------------------

SPATIAL_RANKS = 2
# whole planes on the split kernels' paths, each cut along its first
# spatial axis into the halves that SPATIAL_RANKS ranks hold: the sweep's
# level 0 (2 directions x 4 mirrors, 64 channels, 256^2), the 3-D eval's
# level 0 (30 channels, 24 x 256^2) and the sweep's deepest level (16^2);
# bf16, the dtype both paths run in by default
SPLIT_SHAPES = {"sweep level 0": (8, 64, 256, 256),
                "3-D eval level 0": (1, 30, 24, 256, 256),
                "sweep level 4 (16^2)": (8, 1024, 16, 16)}
SPLIT_KERNELS = ("in_relu_fwd_partial", "in_relu_fwd_apply")
# float operations per element: B2s 3 (sum, square, sum); B2y 5 (x − mean,
# · rstd, · γ, + β, max)
SPLIT_OPS = {"in_relu_fwd_partial": 3, "in_relu_fwd_apply": 5}
# run_g's flags for 25b: 002_gnet_sp.sh eval (FLAGS) in float32 (TF32 off)
# to be held to one process at 1e-4, with a cap of 64 objects a slice so
# that a briefly trained model's components stay on the device sweep
SPATIAL_SWEEP = ["--compute_dtype", "float32", "--device_sweep", "on",
                 "--sweep_max_objects", "64"]
SPATIAL_LABEL = ("2 ranks sharing one card over gloo: a correctness run, not "
                 "a scaling figure")


def split_bound_ms(name, shape):
    """(bound ms, bound_by) of one B2s / B2y call on a rank's part
    ``shape`` in bf16: x read once (and y written once for B2y), the
    per-plane float32 statistics, against HBM_BYTES_PER_S; SPLIT_OPS float
    operations per element against FP32_OPS_PER_S."""
    n, c = shape[:2]
    elems = math.prod(shape)
    io = {"in_relu_fwd_partial": elems * 2 + n * c * 8,
          "in_relu_fwd_apply": 2 * elems * 2 + n * c * 8 + c * 8}[name]
    t_bytes = io / HBM_BYTES_PER_S * 1e3
    t_ops = SPLIT_OPS[name] * elems / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def split_stats(parts, hw):
    """Mean and rstd of planes of ``hw`` elements from the ranks' B2s sums,
    as ops/kernels.instance_norm_stats_split combines them (float64)."""
    from boxsegliver_torch.ops import kernels

    tot = sum(p.double() for p in parts)
    mean = tot[..., 0] / hw
    var = torch.clamp_min(tot[..., 1] / hw - mean * mean, 0.0)
    return mean.float(), torch.rsqrt(var.float() + kernels.IN_EPS)


def split_phase(dev):
    """25a: B2s over the halves of each SPLIT_SHAPES plane, their sums,
    then B2y on each half: each kernel against its plain version on the same
    inputs, and the halves' y against B2-fwd's unsharded y (b2_check's bar:
    one bf16 rounding step, 2^-7 of the value, plus 1e-5; B2s's sums 1e-4
    relative plus 1e-6·√count, as B2a's); per shape each kernel's device
    time per launch (graph_ms), wrapper, plain and library (torch.var_mean
    beside B2s; none computes B2y's function in one call) times and bound.
    Returns the two kernels' records (the sweep's level 0 as their main
    numbers, every shape under ``shapes``)."""
    from boxsegliver_torch.ops import kernels as K

    bf16 = torch.bfloat16
    out_tol = (2.0 ** -7, 1e-5)

    def close(name, got, ref, rel, abs_):
        err = (got.float() - ref.float()).abs()
        bad = err > abs_ + rel * ref.float().abs()
        if bool(bad.any()):
            raise AssertionError(f"{name}: {int(bad.sum())} elements off, "
                                 f"max abs err {float(err.max()):.3e}")
        return float(err.max())

    recs = {n: {"name": n, "route": "cuda",
                "source": "boxsegliver_torch/csrc/in_relu.cu",
                "replaces": "boxsegliver_tpu/ops/pallas_kernels.py:47 "
                            "(_in_relu_fwd_impl, XLA; split around the "
                            "all-reduce XLA's partitioner inserts under a "
                            "sharded spatial axis)",
                "max_abs_err": 0.0, "shapes": {}} for n in SPLIT_KERNELS}
    for i, (label, shape) in enumerate(SPLIT_SHAPES.items()):
        x, _, w, b = b2_inputs(shape, bf16, dev, seed=500 + i)
        halves = [h.contiguous() for h in x.chunk(SPATIAL_RANKS, dim=2)]
        part_shape = tuple(halves[0].shape)
        hw_part = math.prod(part_shape[2:])
        parts = [K.in_relu_fwd_partial(h) for h in halves]
        err_s = max(close(f"B2s {label}", p, K.in_relu_fwd_partial_plain(h),
                          1e-4, 1e-6 * math.sqrt(hw_part))
                    for p, h in zip(parts, halves))
        mean, rstd = split_stats(parts, math.prod(shape[2:]))
        ys = [K.in_relu_fwd_apply(h, mean, rstd, w, b) for h in halves]
        err_y = max(close(f"B2y {label}", y, K.in_relu_fwd_apply_plain(
            h, mean, rstd, w, b), *out_tol) for y, h in zip(ys, halves))
        err_w = close(f"B2s + B2y vs B2-fwd {label}", torch.cat(ys, dim=2),
                      K.in_relu_fwd(x, w, b)[0], *out_tol)
        torch.cuda.synchronize()
        recs["in_relu_fwd_partial"]["max_abs_err"] = max(
            recs["in_relu_fwd_partial"]["max_abs_err"], err_s)
        recs["in_relu_fwd_apply"]["max_abs_err"] = max(
            recs["in_relu_fwd_apply"]["max_abs_err"], err_y, err_w)
        splits, chunk = K.in_relu_partial_plan(part_shape[0] * part_shape[1],
                                               hw_part, bf16)
        print(f"  25a {label}: plane {shape} bf16 in {SPATIAL_RANKS} halves "
              f"{part_shape}; B2s plan {splits} CTAs a plane of {chunk} "
              f"elements; max abs err B2s vs plain {err_s:.3e}, B2y vs plain "
              f"{err_y:.3e}, the halves' y vs B2-fwd's unsharded y "
              f"{err_w:.3e}")

        # timing on a rank's half, inputs cycling past the L2
        iters = 20 if hw_part >= 128 * 128 else 50
        n_sets = max(1, min(iters, math.ceil(COLD_BYTES / (
            halves[0].numel() * 2))))
        sets = [halves[0]] + [b2_inputs(part_shape, bf16, dev,
                                        seed=600 + 10 * i + k)[0]
                              for k in range(1, n_sets)]
        h0 = halves[0]
        dims = tuple(range(2, h0.ndim))
        t = {"in_relu_fwd_partial": (
                 lambda j: K.in_relu_fwd_partial(sets[j]),
                 lambda: K.in_relu_fwd_partial(h0),
                 lambda: K.in_relu_fwd_partial_plain(h0),
                 lambda: torch.var_mean(h0, dim=dims)),
             "in_relu_fwd_apply": (
                 lambda j: K.in_relu_fwd_apply(sets[j], mean, rstd, w, b),
                 lambda: K.in_relu_fwd_apply(h0, mean, rstd, w, b),
                 lambda: K.in_relu_fwd_apply_plain(h0, mean, rstd, w, b),
                 None)}
        for n, (dev_call, call, plain, lib) in t.items():
            row = {"device_ms": min(graph_ms(dev_call, n_sets, iters)
                                    for _ in range(2)),
                   "wrapper_ms": cuda_ms(call, iters=iters, warmup=3),
                   "plain_ms": cuda_ms(plain, iters=iters, warmup=3),
                   "library_ms": (None if lib is None else
                                  cuda_ms(lib, iters=iters, warmup=3))}
            row["bound_ms"], row["bound_by"] = split_bound_ms(n, part_shape)
            recs[n]["shapes"][f"{label} {part_shape}"] = row
            lib_txt = ("none" if row["library_ms"] is None
                       else f"{row['library_ms']:.4f} (torch.var_mean)")
            print(f"  25a {label} {n} on {part_shape}: device "
                  f"{row['device_ms']:.4f} ms a launch "
                  f"({row['bound_ms'] / row['device_ms']:.1%} of its "
                  f"{row['bound_ms']:.4f} ms {row['bound_by']} bound), "
                  f"wrapper {row['wrapper_ms']:.4f}, plain "
                  f"{row['plain_ms']:.4f}, library {lib_txt}")
            if i == 0:
                recs[n].update(row, ms=row["wrapper_ms"])
        del x, halves, parts, ys, sets
        torch.cuda.empty_cache()
    print(f"  25a on {smi()}")
    return recs


def spatial_margin_weights(tmp, seed):
    """25b's weights: GUNet.yml's seeded init (the flags' model) with a
    Liver margin of 4 logits on the head's bias, its kernel unscaled so that
    the probabilities move with the forward and a few tumor components
    reach the sweep; a checkpoint trained for a few steps speckles more
    components than the sweep's cap and would leave it for the host loop."""
    from boxsegliver_torch.cli import main as cli

    args = cli.get_args(FLAGS + ["--model_dir", str(Path(tmp) / "md")])
    model = cli._build_model(args)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.AdjustChannels.bias.copy_(torch.tensor([0.0, 4.0, 0.0]))
    path = Path(tmp) / "gunet_spatial.pt"
    torch.save(model.state_dict(), path)
    return path


def recording(fn, outs):
    """``fn`` that appends each result to ``outs``."""
    def call(*a, **k):
        out = fn(*a, **k)
        outs.append(out)
        return out
    for attr in ("ret", "in_zscore", "sliding"):
        if hasattr(fn, attr):
            setattr(call, attr, getattr(fn, attr))
    return call


def spatial_sweep(group, tmp, weights):
    """25b on this process (a rank of ``group``, or one process with None):
    EvaluateVolume.run_g at the 002_gnet_sp.sh eval flags in float32 with
    the GuidedSweepPredictor of ``group`` on ``weights``: per-case metrics,
    results, launches, s/case, each case's merged volume and object count
    (recorded from run_g's own sweeps), and, timed between
    synchronizations over one case's sweep, the halo exchanges and
    all-reduces per forward and their ms."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.evaluators.volume import EvaluateVolume
    from boxsegliver_torch.interactive.device_sweep import \
        GuidedSweepPredictor

    dev = torch.device("cuda")
    args = cli.get_args(FLAGS + smoke_data(
        tmp, Path(tmp) / "spatial_md", "--ckpt_path", str(weights),
        *SPATIAL_SWEEP))
    ds = cli.resolve_dataset_dir(args)
    model = cli.build_model_from_args(args, dev)
    pred = GuidedSweepPredictor(model, args, num_classes=3, tumor_id=2,
                                device=dev, group=group)
    ev = EvaluateVolume(args, ds, ["Background"] + list(args.classes),
                        group=group)
    metas = cli._test_metas(args, ds)
    sweep, calls, outs = pred.sweep_case, [], []
    pred.sweep_case = recording(
        lambda *a: calls.append(a) or sweep(*a), outs)
    res, seconds, launches = counted_run(lambda: ev.run_g(pred, metas))
    out = {"results": res, "s": seconds / len(metas), "cases": len(metas),
           "launches": launches, "counts": [n for _, n in outs],
           "outs": [v for v, _ in outs],
           "per_case": {m: list(v) for m, v in ev._metric_values.items()}}
    spent = {"ms": 0.0, "all_reduces": 0, "halos": 0}
    if group is not None:
        plain_ar, plain_halo = group.all_reduce_, group.halo

        def timed_ar(t):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain_ar(t)
            torch.cuda.synchronize()
            spent["ms"] += (time.perf_counter() - t0) * 1e3
            spent["all_reduces"] += 1
            return t

        def counted_halo(x, dim, lo, hi, last_hi=None):
            # a 1x1 conv's halo of (0, 0) exchanges nothing
            spent["halos"] += bool(lo or hi)
            return plain_halo(x, dim, lo, hi, last_hi)

        group.all_reduce_, group.halo = timed_ar, counted_halo
    steps0 = pred.steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep(*calls[0])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    if group is not None:
        group.all_reduce_, group.halo = plain_ar, plain_halo
    steps = pred.steps - steps0
    out["per_forward"] = {
        "step_ms": wall / steps, "coll_ms": spent["ms"] / steps,
        "halos": spent["halos"] / steps,
        # the halos' own all-reduces are counted apart
        "all_reduces": (spent["all_reduces"] - spent["halos"]) / steps}
    return out


def spatial_3d(group, tmp):
    """25c on this process: EvaluateVolume3D.run of phase 21's best UNet3D
    (201_unet_v1.sh eval, whole volumes) in float32 through
    make_volume_predict with the depth sharded over ``group`` (None: one
    process), on the fast path ("pred": argmax and z-score on the card) and
    the prob path (the host-normalized volume): per-case metrics, results,
    launches, s/case and each case's output; then the fast path's
    probabilities ("prob_z", the same z-scored input) for the argmax
    agreement."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.evaluators.volume3d import (EvaluateVolume3D,
                                                       make_volume_predict)

    dev = torch.device("cuda")
    ds = Path(tmp) / "synthetic_nf"
    args = cli.get_args(nf3d_argv("eval", "chip_smoke_nf3d", tmp,
                                  Path(tmp) / "nf3d_md", *NF3D_EVAL,
                                  "--compute_dtype", "float32"))
    model = cli.build_model_from_args(args, dev)
    metas = cli._test_metas(args, ds)
    shards = 0 if group is None else group.size

    def evaluator():
        return EvaluateVolume3D(args, ds, ["Background"] + list(args.classes),
                                group=group)

    out = {}
    for form in ("pred", "prob"):
        outs = []
        predict = recording(make_volume_predict(
            model, dev, ret=form, in_zscore=form == "pred", group=group,
            z_axis_shards=shards), outs)
        ev = evaluator()
        res, seconds, launches = counted_run(lambda: ev.run(predict, metas))
        out[form] = {"results": res, "s": seconds / len(metas),
                     "cases": len(metas), "launches": launches, "outs": outs,
                     "per_case": {m: list(v) for m, v in
                                  ev._metric_values.items()}}
    outs = []
    predict = recording(make_volume_predict(
        model, dev, ret="prob", in_zscore=True, group=group,
        z_axis_shards=shards), outs)
    ev = evaluator()
    for m in metas:
        ev.predict_case(predict, np.load(ds / f"volume-{m['PID']}" /
                                         "volume.npy"))
    out["prob_z"] = {"outs": outs}
    return out


def _outs_spread(group, outs) -> float:
    """Largest difference between this rank's outputs and rank 0's."""
    worst = 0.0
    for o in outs:
        t = torch.from_numpy(np.ascontiguousarray(o)).cuda().float()
        worst = max(worst, float((t - group.broadcast_(t.clone())).abs()
                                 .max()))
    return worst


def argmax_agreement(got, ref_probs, margin=1e-4):
    """(voxels whose class differs, of them those where the reference's top
    two probabilities are further apart than ``margin``) of outputs ``got``
    (class maps, or probabilities whose argmax is taken) against the
    reference probabilities: float32 summation orders can flip only
    near-ties."""
    diff = far = 0
    for g, r in zip(got, ref_probs):
        g = g if g.dtype == np.uint8 else g.argmax(-1)
        r = np.asarray(r)
        bad = g != r.argmax(-1)
        top2 = np.sort(r[bad], axis=-1)[..., -2:]
        diff += int(bad.sum())
        far += int(((top2[..., 1] - top2[..., 0]) > margin).sum())
    return diff, far


def spatial_rank(group, tmp, weights, ref_path):
    """One rank of phase 25's gloo group (25b, 25c).  Rank 0 holds its
    outputs against one process's (``ref_path``): the largest probability
    error and the argmax agreement; every rank's outputs are held against
    rank 0's; the small results of every rank are gathered to rank 0."""
    from boxsegliver_torch import config as config_mod

    config_mod.resolve_device("cuda")                # TF32 off here too
    res = {"25b": spatial_sweep(group, tmp, weights),
           "25c": spatial_3d(group, tmp)}
    ref = torch.load(ref_path, weights_only=False) if group.chief else None
    parts = [("25b", res["25b"], "25b", "25b")] + [
        (f"25c {f}", res["25c"][f], f, "prob_z" if f == "pred" else f)
        for f in ("pred", "prob", "prob_z")]
    for _, r, key, probs_key in parts:
        outs = r.pop("outs")
        r["spread"] = _outs_spread(group, outs)
        if ref is not None:
            if outs[0].dtype != np.uint8:
                r["err"] = max(float(np.abs(o - w).max())
                               for o, w in zip(outs, ref[key]))
            r["flips"] = argmax_agreement(outs, ref[probs_key])
    return group.gather_to_chief(res)


def _metric_errs(got, ref):
    """Largest per-case metric and result differences of two runs."""
    if set(got["per_case"]) != set(ref["per_case"]) or \
            set(got["results"]) != set(ref["results"]):
        return math.inf, math.inf
    per_case = max((float(np.max(np.abs(np.asarray(got["per_case"][m])
                                        - np.asarray(v))))
                    for m, v in ref["per_case"].items()), default=0.0)
    totals = max((abs(got["results"][m] - v)
                  for m, v in ref["results"].items()), default=0.0)
    return per_case, totals


def spatial_check(what, got, ref, ranks_got):
    """Hold a sharded run (rank 0's ``got``) to one process's ``ref``:
    probabilities within 1e-4, every rank equal to rank 0, the class of
    every voxel equal except at near-ties (one process's top two within
    1e-4), and per-case metrics and totals within 1e-6 where no class
    flipped (a flipped tie may move a metric: the flips are printed).
    The other ranks score nothing."""
    per_case, totals = _metric_errs(got, ref)
    diff, far = got["flips"]
    spread = max(r["spread"] for r in ranks_got)
    err = (f"probabilities max abs err {got['err']:.2e}" if "err" in got
           else "class maps")
    print(f"  {what}: {err}, voxels of another class "
          f"{diff} ({far} outside near-ties), per-case metrics max abs err "
          f"{per_case:.1e}, totals {totals:.1e}, ranks' spread {spread:.1e}")
    if not (got.get("err", 0.0) <= 1e-4 and far == 0 and spread == 0.0
            and (diff or (per_case <= 1e-6 and totals <= 1e-6))
            and math.isfinite(per_case)
            and not any(r["results"] for r in ranks_got[1:])):
        raise AssertionError(f"{what}: the sharded run disagrees with one "
                             "process")


def spatial_phase(tmp, dev, seed):
    """Phase 25: (a) the split kernels B2s and B2y on the card; (b) run_g's
    height-sharded sweep and (c) the depth-sharded whole-volume 3-D eval,
    SPATIAL_RANKS gloo ranks sharing the card (spawned after the kernels
    were built) against one process run first; (d) the CLIs over NCCL
    where the machine has two cards.  Returns the split kernels' records
    and the launch counts per path (rank 0's)."""
    from boxsegliver_torch.cli import main as cli
    from boxsegliver_torch.parallel import launch

    recs = split_phase(dev)

    weights = spatial_margin_weights(tmp, seed)
    t0 = time.perf_counter()
    one = spatial_sweep(None, tmp, weights)
    if any(v is None for v in one["outs"]):
        raise AssertionError(f"25b: the sweep overflows: {one['counts']}")
    one3 = spatial_3d(None, tmp)
    ref_path = Path(tmp) / "spatial_ref.pt"
    torch.save({"25b": one.pop("outs"), **{
        f: one3[f].pop("outs") for f in ("pred", "prob", "prob_z")}},
        ref_path)
    t_one = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch(spatial_rank, SPATIAL_RANKS, "cuda:0", tmp, weights,
                   str(ref_path), backend="gloo")
    print(f"  {SPATIAL_RANKS} gloo ranks on cuda:0 (25b-c) in "
          f"{time.perf_counter() - t0:.1f} s with their start; one process "
          f"in {t_one:.1f} s; {smi()}")
    paths = {}

    r0 = ranks[0]["25b"]
    spatial_check(f"25b run_g, 002_gnet_sp.sh eval flags (GUNet.yml, 256^2 "
                  f"x 3, mirror TTA, --device_sweep on) in float32 on the "
                  f"seeded Liver-margin weights: {SPATIAL_RANKS} ranks (each "
                  f"{256 // SPATIAL_RANKS} rows of every image) vs one "
                  f"process over {one['cases']} cases, merged volumes",
                  r0, one, [r["25b"] for r in ranks])
    if any(r["25b"]["counts"] != one["counts"] for r in ranks):
        raise AssertionError(f"25b: objects {r0['counts']}, one process "
                             f"{one['counts']}")
    print(f"  25b objects a case {r0['counts']} on every rank (one process "
          f"{one['counts']})")
    # each of one process's B2-fwd launches (IIN_BLOCKS a GUNet.yml
    # forward) becomes one B2s and one B2y; the modulated blocks (one B3-fwd
    # each in one process) take B3's split form, its statistics from B2s
    # too (GUNET_MOD_BLOCKS a forward)
    fused = one["launches"]["in_relu_fwd_nhwc"]
    want = {**one["launches"], "in_relu_fwd_nhwc": 0,
            "modnorm_relu_fwd_nhwc": 0, "in_relu_fwd_partial": fused
            + GUNET_MOD_BLOCKS * fused // IIN_BLOCKS,
            "in_relu_fwd_apply": fused}
    for r in ranks:
        expect_launches("25b run_g (a rank of 2)", r["25b"]["launches"], want)
    pf, pf1 = r0["per_forward"], one["per_forward"]
    print(f"  25b launches a rank {r0['launches']} (one process "
          f"{one['launches']}: each B2-fwd became one B2s and one B2y, each "
          f"B3-fwd one B2s in B3's split form; B1 renders each whole guide "
          f"on every rank)")
    print(f"  25b, {SPATIAL_LABEL}: {r0['s']:.3f} s/case with "
          f"{SPATIAL_RANKS} ranks (one process {one['s']:.3f}); per forward "
          f"(a sweep step) {pf['halos']:.0f} halo exchanges and "
          f"{pf['all_reduces']:.0f} other all-reduces (statistics, the "
          f"probabilities' gather), {pf['coll_ms']:.3f} of {pf['step_ms']:.3f}"
          f" ms a step ({100 * pf['coll_ms'] / pf['step_ms']:.1f} %, each "
          f"between synchronizations); one process {pf1['step_ms']:.3f} ms a "
          f"step")
    paths["spatial run_g (rank 0 of 2)"] = r0["launches"]

    pz = ranks[0]["25c"]["prob_z"]
    print(f"  25c the fast path's probabilities (the same z-scored input, "
          f"ret prob): max abs err {pz['err']:.2e}, ranks' spread "
          f"{max(r['25c']['prob_z']['spread'] for r in ranks):.1e}")
    if not (pz["err"] <= 1e-4 and all(
            r["25c"]["prob_z"]["spread"] == 0.0 for r in ranks)):
        raise AssertionError("25c: the sharded probabilities disagree")
    for form in ("pred", "prob"):                          # 25c
        got, ref = ranks[0]["25c"][form], one3[form]
        spatial_check(f"25c 201_unet_v1.sh eval --z_shards {SPATIAL_RANKS} "
                      f"(ret {form}, float32) on phase 21's best, "
                      f"{ref['cases']} cases", got, ref,
                      [r["25c"][form] for r in ranks])
        print(f"  25c {form}: {got['s']:.3f} s/case with {SPATIAL_RANKS} "
              f"ranks (one process {ref['s']:.3f}); launches rank 0 "
              f"{got['launches']}, one process {ref['launches']}")
        blocks = ref["launches"]["in_relu_fwd"]
        for r in ranks:
            expect_launches(f"25c {form} (a rank of 2)",
                            r["25c"][form]["launches"],
                            {"in_relu_fwd_partial": blocks,
                             "in_relu_fwd_apply": blocks})
        paths[f"spatial UNet3D eval {form} (rank 0 of 2)"] = got["launches"]

    if torch.cuda.device_count() >= 2:                     # 25d
        for what, argv in (
                ("002_gnet_sp.sh eval 2", FLAGS + smoke_data(
                    tmp, Path(tmp) / "spatial_cli_md", "--ckpt_path",
                    str(weights), "--num_replicas", str(SPATIAL_RANKS))),
                ("201_unet_v1.sh eval --z_shards 2", nf3d_argv(
                    "eval", "chip_smoke_nf3d", tmp, Path(tmp) / "nf3d_md",
                    *NF3D_EVAL, "--z_shards", str(SPATIAL_RANKS)))):
            res, seconds, _ = counted_run(lambda: cli.main(argv))
            print(f"  25d {what} through the CLI over NCCL on "
                  f"{SPATIAL_RANKS} cards: {res} in {seconds:.1f} s")
            if not res or not all(math.isfinite(v) for v in res.values()):
                raise AssertionError(f"25d {what}: {res}")
    else:
        print(f"  25d not run: {torch.cuda.device_count()} card (the CLIs "
              f"over NCCL with --num_replicas / --z_shards need "
              f"{SPATIAL_RANKS})")
    for n in SPLIT_KERNELS:
        recs[n]["launches"] = r0["launches"][n]
    return recs, paths

def elapsed(t_start):
    """The script's wall time so far, printed before each phase."""
    print(f"  ({time.perf_counter() - t_start:.0f} s since the start)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--determinism", metavar="TMP",
                    help=argparse.SUPPRESS)   # the child of phase 16
    opts = ap.parse_args(argv)
    if opts.determinism:
        determinism_run(opts.determinism, opts.seed)
        return 0

    t_start = time.perf_counter()
    print("[1/25] device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    try:
        import boxsegliver_torch  # noqa: F401
    except ModuleNotFoundError:
        print("chip_smoke: the package boxsegliver_torch is missing: run "
              "chip_smoke.py from the root of a checkout of the repository",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    card = smi()
    print(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    from boxsegliver_torch import config as config_mod
    from boxsegliver_torch.csrc import build
    from boxsegliver_torch.data.synthetic import make_synthetic_dataset

    config_mod.resolve_device("cuda")            # TF32 off, stated there

    elapsed(t_start)
    print("[2/25] build")
    t0 = time.perf_counter()
    build.build_all()
    print(f"  built {list(build.SOURCES)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.BUILD_SECONDS})")
    for name in build.SOURCES:
        for line in build.ptxas_log(name).splitlines():
            if "ptxas info" in line and "Used" in line:
                print(f"  {name}: " + line.strip())

    elapsed(t_start)
    print("[3/25] kernel B1 vs plain")
    rec = kernel_phase(dev, opts.seed)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ds = Path(tmp) / "ds"
        t0 = time.perf_counter()
        make_synthetic_dataset(ds, n_cases=4, shape=(24, 256, 256),
                               k_split=2, seed=opts.seed)
        print(f"  synthetic dataset 4 x (24, 256, 256) in "
              f"{time.perf_counter() - t0:.1f} s")
        elapsed(t_start)
        print("[4/25] labeling vs scipy")
        labeling_phase(ds, dev)
        elapsed(t_start)
        print("[5/25] flagship guided eval (run_g) through the CLI")
        paths = {"run_g (device sweep)": slice_phase(tmp, ds, dev, opts.seed)}
        sweep_card_vs_cpu(ds, dev, opts.seed)
        elapsed(t_start)
        print("[6/25] profile of one case's sweep (steady state)")
        profile_sweep(tmp, ds)
        elapsed(t_start)
        print("[7/25] kernels B2 and B3 vs plain; their NHWC plans; cuDNN's "
              "transposes")
        b2 = b2_phase(dev)
        nf_b2 = b2_nf_levels(dev)
        b3 = b3_phase(dev)
        nhwc = nhwc_phase(dev)
        elapsed(t_start)
        print("[8/25] flagship G-Net training through the CLI")
        launches = paths["G-Net train"] = train_phase(tmp)
        train_card_vs_cpu(tmp, dev, opts.seed)
        elapsed(t_start)
        print("[9/25] profile of the flagship train step (steady state)")
        profile_train(tmp)
        elapsed(t_start)
        print("[10/25] UNet training (001_unet.sh train) through the CLI")
        unet_md = unet_train_phase(tmp)
        unet_train_card_vs_cpu(tmp, dev, opts.seed)
        elapsed(t_start)
        print("[11/25] UNet train step in steady state (batch 8, bench.py batch 128)")
        unet_bench_phase(tmp, opts.seed)
        elapsed(t_start)
        print("[12/25] UNet eval (001_unet.sh eval) through the CLI")
        unet_preds = unet_eval_phase(tmp, ds, dev, unet_md)
        elapsed(t_start)
        print("[13/25] run_g's host loop: overflow fallback, --device_sweep "
              "off, --save_sp_guide")
        paths["run_g host loop (overflow)"] = host_loop_phase(tmp, ds, dev,
                                                              opts.seed)
        elapsed(t_start)
        print("[14/25] --steps_per_dispatch 16: the train step as a CUDA "
              "graph (G-Net, UNet)")
        paths["G-Net train, K=16"] = dispatch_phase(tmp, dev)
        elapsed(t_start)
        print("[15/25] bench.py step: bf16 moments and K=16 (A/B knobs)")
        bench_knobs_phase(tmp)
        elapsed(t_start)
        print("[16/25] train step card vs CPU: boundary and proportion "
              "loss weights; --seed reproducibility in float32")
        weights_card_vs_cpu(tmp, dev, opts.seed)
        determinism_phase(tmp, opts.seed)
        elapsed(t_start)
        print("[17/25] serving: --mode export and the REST server on the "
              "card (GUNet, UNet)")
        paths["serve (GUNet export)"], unet_bundle = serve_phase(
            tmp, dev, opts.seed, unet_md)
        elapsed(t_start)
        print("[18/25] prepare -> annotate -> viewers on the card")
        lits = prepare_phase(tmp, opts.seed)
        paths["annotate (preview + Predict)"] = annotate_phase(
            tmp, dev, opts.seed, lits, ds, unet_preds, unet_bundle, unet_md)
        elapsed(t_start)
        print("[19/25] NF: 101_unet_v2.sh train and eval, prepare negcache, "
              "101_unetinter_v10.sh train and eval, run_sp")
        nf_paths, inter_md = nf_phase(tmp, dev, opts.seed)
        paths.update(nf_paths)
        elapsed(t_start)
        print("[20/25] click eval (interactive_eval --dim 2): kernel G1, "
              "host loop and device refiner, the new click models, the "
              "click export")
        g1, click_paths = click_eval_phase(tmp, dev, opts.seed, inter_md)
        paths.update(click_paths)
        elapsed(t_start)
        print("[21/25] the 3D tower (nf_3d, UNet3D.yml): B2 at 3-D planes, "
              "201_unet_v1.sh train and eval, the 3-D click eval, the "
              "cascade and hybrid eval, the UNet3D export served")
        b2_3d, nf3d_paths = nf3d_phase(tmp, dev, opts.seed, inter_md)
        paths.update(nf3d_paths)
        elapsed(t_start)
        print("[22/25] nf2 (004_gnet_iin.sh) train, eval, infer and export "
              "on the card")
        iin_paths, b1_err = iin_phase(tmp, dev, opts.seed)
        paths.update(iin_paths)
        rec["max_abs_err"] = max(rec["max_abs_err"], b1_err)
        elapsed(t_start)
        print("[23/25] DenseUNet (003_denseunet.sh) train, eval, sweep and "
              "export; GUNet --use_se and the VGG contexts on the card")
        paths.update(dense_phase(tmp, dev, opts.seed))
        elapsed(t_start)
        print("[24/25] data parallel (001_dist.sh) over a process group: "
              "gloo ranks sharing the card against one process (train, "
              "run, run_sp, the refiner), a 1-rank NCCL group's K = 16 "
              "graph")
        paths.update(dist_phase(tmp, dev, opts.seed, unet_md, inter_md))
        elapsed(t_start)
        print("[25/25] spatial sharding: the split B2 kernels (B2s, B2y), "
              "run_g's height-sharded sweep and the depth-sharded 3-D eval "
              "over gloo ranks sharing the card against one process")
        split_recs, spatial_paths = spatial_phase(tmp, dev, opts.seed)
        paths.update(spatial_paths)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "device_ms", "wrapper_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    recs = [rec] + [b2[n] for n in B2_KERNELS]
    for n in B2_KERNELS:             # UNet3D: per train step, eval level 0
        b2[n]["unet3d"] = {k: {m: v[n][m] for m in (
            "device_ms", "bound_ms", "plain_ms", "library_ms",
            "max_abs_err")} for k, v in b2_3d.items()}
        b2[n]["max_abs_err"] = max(b2[n]["max_abs_err"],
                                   nf_b2[n]["max_abs_err"],
                                   b2_3d["step"][n]["max_abs_err"],
                                   b2_3d["eval"][n]["max_abs_err"])
    # the whole backward per train step: chosen plans, the pair (splits =
    # 1) and B2f's bound, on the flagship, NF and UNet3D steps
    b2["in_relu_bwd"]["backward"] = {
        "flagship": b2["backward"], "NF": nf_b2["backward"],
        "UNet3D": b2_3d["step"]["backward"]}
    for r in recs:
        r["launches"] = launches[r["name"]]
    # B2's NCHW plans run where a model passes NCHW planes (G-Net's
    # activations are channels-last): UNet3D's train step takes B2-fwd, B2f
    # and, where a plane is too large to stage (level 0), B2a and B2b
    for n in B2_KERNELS:
        b2[n]["launches"] = paths["UNet3D train (201_unet_v1)"][n]
    # G1's main path is the device refiner with geodesic guides
    g1["launches"] = paths["click eval on geodesic"][g1["name"]]
    recs.append(g1)
    recs += [split_recs[n] for n in SPLIT_KERNELS]
    # B3's NCHW plans have no main path left (GUNet is channels-last, or
    # sharded on B3's split form): their launches are the card tests' alone
    for n in B3_KERNELS:
        b3[n]["launches"] = launches[n]
        recs.append(b3[n])
    # B2's and B3's NHWC plans and the conv biases' channel sums: the
    # flagship train step
    for n in NHWC_KERNELS + ("channel_sums_nhwc",):
        nhwc[n]["launches"] = launches[n]
        recs.append(nhwc[n])
    if not all(r["launches"] for r in recs if r["name"] not in B3_KERNELS):
        raise AssertionError("a kernel did not launch on its main path: "
                             + str({r["name"]: r["launches"] for r in recs}))
    for r in recs:
        # channel_sums_nhwc is counted on the flagship's train path alone
        r["launches_by_path"] = {p: c.get(r["name"], 0)
                                 for p, c in paths.items()
                                 if r["name"] in c
                                 or r["name"] != "channel_sums_nhwc"}
    keys += ("launches_by_path",)
    elapsed(t_start)
    print(json.dumps({"kernels": [{k: r[k] for k in keys + tuple(
        x for x in ("unet3d", "shapes", "backward") if x in r)}
        for r in recs]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
