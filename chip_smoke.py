#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mapanything_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --train-step-only    # phases 1, 2 and 7 alone
    python3 chip_smoke.py --train-step-only --compute-dtype float32  # phases 1, 2 and 17 alone
    python3 chip_smoke.py --forward-edges-only # phases 1, 2 and 3f alone
    python3 chip_smoke.py --backward-edges-only  # phases 1, 2 and 3g alone
    python3 chip_smoke.py --files-only         # phases 1, 2 and 19 alone
    python3 chip_smoke.py --trainer-only       # phases 1, 2 and 20 alone
    python3 chip_smoke.py --data-only          # phases 1, 2 and 21 alone
    python3 chip_smoke.py --rgb-only           # phases 1, 2, 3f's narrow cases, the D = 32 rows of 3 and 3b, 22-25
    python3 chip_smoke.py --dust3r-only        # phases 1, 2, the DUSt3R rows of 3, 26 and 27
    python3 chip_smoke.py --baselines-only     # phases 1, 2, the baselines' rows of 3, 28 and 29
    python3 chip_smoke.py --benchmarks-only    # phases 1, 2, the benchmarks' rows of 3, 34-37
    python3 chip_smoke.py --masked-only        # phases 1, 2, 3h, 41 and 42
    python3 chip_smoke.py --remat-only         # phases 1, 2, 3i, 43 and 44

Phases, each printing one JSON line:
  1. the card's name and power limit, as nvidia-smi reports them;
  2. build: nvcc compiles every kernel source from csrc/ into build/, one
     process per source, side by side; the line gives each kernel
     instance's registers, spills and shared memory (-Xptxas -v, and the
     wgmma instances' dynamic shared memory), and cuobjdump -sass of each
     library must show HGMMA (wgmma) and UTMALDG (TMA loads) in every
     forward and backward instance, bf16 and fp32 (fa_fwd_bf16, fa_fwd_f32,
     fa_bwd_dq_bf16, fa_bwd_dkv_bf16, fa_bwd_dq_f32, fa_bwd_dkv_f32, and at
     D = 32 the true-width fa_bwd_dq_f32_narrow and fa_bwd_dkv_f32_narrow), and
     HGMMA in the narrow fp32 forward's (fa_fwd_f32_narrow, D = 32 and 48,
     packed and streaming: it reads its rows with 16-byte loads); the masked
     kernels' library (fa_fwd_masked, fa_bwd_dq_masked, fa_bwd_dkv_masked) must
     hold every instance, HMMA (mma.sync) in each bf16 one;
  3f. the forward's edges, bf16 and fp32: both forms (lse-free and lse) at
     D = 64 and 128 (and 32 in fp32) against their plain versions under phase 3's rule (fp32
     also under the fp32 rule, below), at
     T = 1, 7, 64, 65, 127, 129 and 1370 and at Tq != Tk (129 against
     4000, 5476 against 1), and at 320 and 384 work tiles (every block of
     the persistent grid walks several), on contiguous tensors and on
     views of fused qkv (and kv) tensors with a non-default scale, the lse
     on every row; the narrow fp32 forward (D = 32, both forms, and 48) also
     at every Tq of 1, 7, 8, 9, 33, 64, 65 against every Tk of 1, 8, 13, 64,
     65, 512 on 3 x 5 sequences (NARROW_EDGE_CASES); then the canary cases
     (CANARY_CASES; at D = 32 and 48 also NARROW_CANARY_CASES and the
     tracker's shapes): the fp32 forward writing o and the lse inside buffers
     whose canary bytes before and after must survive bit for bit;
  3g. the backward's edges: dq and dk/dv, bf16 and fp32, at D = 64 and 128
     (and 32 in fp32, the true-width instances) against their plain versions under phase 3's rule (fp32 also under the
     fp32 rule, below) at phase 3f's shapes and layouts (dO a view of a wider
     tensor in the fused layout), fed the statistics of the plain forward (of
     a merged softmax where there is one key, and in one more case, as the
     ring feeds them); each kernel called twice, the outputs bitwise equal;
     then the canary cases: dq, dk and dv written inside canary buffers;
  3. inference kernel checks: the lse-free attention forward against its
     plain PyTorch version at the inference shapes (encoder, frame and
     global layers in bf16, and in fp32: phase 18's), with kernel, plain and
     torch-SDPA times and the bound; the fp32 rows also under the fp32 rule,
     with the kernel timed alone on one split pass's parts, the split pass
     (held bitwise to its plain version) and the whole call timed apart;
     and the narrow fp32 instance (one launch a call, no split pass) at the RGB
     models' MAE decoder, 8 x 1369 x 16 x 32 (8 launches a 1 x 8 x 518 forward,
     phase 22's), the tracker's shapes and D = 32 at 4000 keys, each also with
     its device time (20 calls replayed as a CUDA graph: the call's CUDA-event
     time there reads the host) and SDPA's; and the DUSt3R path's shapes in
     bf16 and fp32 (phase 27's): the encoder's 2 x 768 x 16 x 64, the decoder's self-
     and cross-attention at 1 x 768 x 12 x 64 (the cross-attention's q, k and v three
     tensors), and a 3-view context (1 x 768 queries against 1536 keys); and the
     baselines' shapes (phase 29's, BASELINE_SHAPES): VGGT's 8 x 1374 x 16 x 64 (its
     encoder and frame layers; Pi3's and AnyCalib's too), its global 1 x 10992 x 16 x 64
     and its camera trunk's 1 x 8 x 16 x 128 in bf16 and fp32, ViT-L without registers
     at 8 x 1370 x 16 x 64, MUSt3R's encoder, decoder self-attention and 768 queries
     against each of its memories' 1536 to 6144 keys, and Pow3R's encoder and decoder
     (769 tokens with the CLS token);
  3b. training kernel checks: the forward with lse, the dq and the dk/dv
     kernels against their plain versions at the 1 x 4 x 518 training
     shapes in bf16 (phase 7's) and in fp32 (phase 17's), with kernel, plain
     and library times (torch SDPA forward with autograd on; its backward
     alone, beside the whole flash_attention_bwd_lse: delta, the fp32 split
     pass, dq and dk/dv) and bounds. The fp32 o, lse, dq, dk and dv are also
     held to the fp32 rule: 4x the fp32 plain version's own error against
     fp64, or 1e-5 of the magnitude (phase 3's 1e-2 would pass a single bf16
     pass); the fp32 kernels are timed alone on split parts, and the split
     passes (the forward's of q, k, v and the backward's of q, k, v, dO) are
     held bitwise to their plain version and timed; and the fp32 D = 32
     instances at the MAE decoder's 4 x 1369 x 16 x 32 (8 each a 1 x 4 x 518
     step, phase 23's; the lse forward the narrow one, without a split pass);
  3h. the masked kernels (the masked sdpa; XLA's fused attention on the TPU):
     fa_fwd_masked at 8 x 1369 x 12 x 64 and 1 x 10953 x 12 x 64 in bf16 under a
     key-padding mask keeping ~80% of the keys (read with stride 0 over heads and
     queries) and at 4 x 1369 x 16 x 32 in fp32 under a dense (B, H, Tq, Tk) mask,
     the lse forward, dq and dk/dv at 4 x 1369 x 12 x 64 in bf16 and fp32, each
     against its plain version under phase 3's rule (fp32 also the fp32 rule),
     with kernel, plain, SDPA-with-a-boolean-mask (time only) and bound times (the
     mask's bytes counted); their edge cases (MASKED_EDGE_CASES under key-padding,
     dense, shared and all-true masks with fully masked rows, every dtype and head
     dim, D = 48's forward), JAX's semantics (a fully masked row's o the mean of V,
     its dq zero, a head masked whole zero dk; an all-true mask the unmasked
     kernel's o); then the masked path, ops.attention.sdpa(mask=) at each shape,
     its launches counted;
  4. slice check: MapAnythingConfig.small(), 2 views at 56 px in fp32, the same
     seeded weights on cuda and on cpu, every prediction compared;
  5. inference: the flagship MapAnythingConfig(compute_dtype="bfloat16")
     forward on 1 x 8 views at 518 px with seeded random weights, launch
     counts, output checks, views/s, ms per forward and peak memory;
  11. the infer slice check: the small fp32 ``infer`` on cuda against cpu,
     images only with the confidence mask, and with intrinsics, z-depth and
     4x4 poses (a geometric_inputs=True model): float fields within 1e-3 of
     their magnitude where both masks agree, masks equal on 99.9% of pixels;
     head_chunk_size=1 against unchunked on cuda within CHUNK_RTOL;
  12. the flagship bf16 ``infer`` on 1 x 8 x 518 (the user-facing path):
     48 lse-free launches, ms, views/s and peak memory under the default
     PostprocessConfig and with the confidence mask, the postprocess alone
     beside phase 5's forward, the output invariants, head_chunk_size=2
     against unchunked by mean difference per field (CHUNK_MEAN_DIFF_LIMITS),
     and again with TF32 off and on a model with the DPT pyramid in fp32
     (within CHUNK_RTOL of each field's magnitude);
  13. memory-efficient many-view inference: the flagship bf16 ``infer`` on
     1 x 64 x 518 with head_chunk_size=8 (bench.py:315-316): launches by key
     length (36 at 1369-1370 tokens, 12 at 87617), ms per scene, views/s,
     peak memory and the output invariants; then one unchunked infer, its
     time and peak memory, and the chunked outputs against it within
     CHUNK_MEAN_DIFF_LIMITS;
  6. train slice check: the small fp32 train step with every geometric
     input, fixed masks with depth sparsification, cuda against cpu: loss,
     loss details and every gradient (the worst leaf named, with its
     magnitude and the gap), then the parameters after two steps;
  7. the flagship bf16 train step on 1 x 4 views at 518 px (bench.py's
     LossBatch, GeometricInputConfig() masks), 2 warm-up and 5 timed steps,
     launch counts per step, finite loss and grad norm, finite gradients, a
     gradient and an update for every parameter, ms per step, views/s and
     peak memory;
  3c. the long kernels at the view-parallel paths' lengths: the lse-free
     forward at 1 x 21905 x 12 x 64 (K3's regime: the 16-view global layer),
     the lse forward at 1 x 21904 and 1 x 5476 (K7: ring steps at 16 and 4
     views), and dq and dk/dv at 1 x 5476 fed a merged lse (the kernel's own,
     merged with a 1-token extra block through _merge_lse, as the ring's
     backward feeds them); each against its plain version on a slice of
     query rows (the whole shape for the backward), with kernel, plain (over
     every row, in chunks), torch SDPA and bound times;
  3d. the kernels of phase 13's 64-view infer: K3 at 1 x 87617 x 12 x 64,
     its global layer, as in 3c (the plain version in chunks of 512 query
     rows), and K1 at 64 x 1370 x 16 x 64 and 64 x 1369 x 12 x 64, its
     encoder and frame layers, as in phase 3 (the plain versions in batch
     chunks of 8);
  8. view-parallel slice check on a process group of this process alone
     (NCCL, world size 1): MapAnythingConfig.small(), fp32, 1 x 4 x 112 (256
     grid tokens, so the ring's blocks reach the kernels), ring and
     allgather forwards and the ring train step against the unsharded ones
     on cuda;
  9. view-parallel inference, the main path of this slice: the flagship bf16
     forward on 1 x 16 views at 518 px, unsharded, ring and allgather, with
     launch counts, ring steps and collectives per forward, ms per forward,
     views/s, peak memory, the output invariants, and the largest and the
     mean difference of each output field between the three, the mean held
     to MEAN_DIFF_LIMITS;
  10. the view-parallel train step: phase 7 under the ring schedule, with
     ring steps per step and the loss of every step within LOSS_GAP_LIMIT of
     phase 7's.
  3e. K8, the D = 128 instances, at the shapes of flagship-h128 (the flagship
     with info_sharing_num_heads=6: trunk heads of 128): the lse-free forward
     at 8 x 1369 x 6 x 128 (frame) and 1 x 10953 x 6 x 128 (global); the lse
     forward, dq and dk/dv at 4 x 1369 x 6 x 128 and 1 x 5477 x 6 x 128; each
     kernel in fp32 at 1 x 5477 x 6 x 128 (the backward also under the fp32
     rule); each against its plain version under phase 3's rule, with
     kernel, plain, torch SDPA and bound times;
  14. phases 4 and 6 for MapAnythingConfig.small(info_sharing_num_heads=2)
     (trunk heads of 256 / 2 = 128): the fp32 forward and train step on cuda
     against cpu, which launch the fp32 D = 128 instances; the step's line
     names its worst gradient leaf with the leaf's magnitude and the gap;
  15. phase 5 for flagship-h128: the bf16 forward on 1 x 8 x 518, launches
     by key length and head dim (24 at D = 64; 12 at 1369 and 12 at 10953
     tokens at D = 128), ms, views/s, peak memory, output invariants;
  16. phase 7 for flagship-h128: the bf16 train step on 1 x 4 x 518, the
     lse forward, dq and dk/dv launched 24 times each at D = 64 and 24 at
     D = 128 a step (12 at 1369 and 12 at 5477 tokens);
  17. phase 7 at the config's default dtype: MapAnythingConfig() (fp32) on
     1 x 4 x 518, the fp32 lse forward, dq and dk/dv launched 48 times each a
     step (24 at 1370, 12 at 1369, 12 at 5477 tokens, D = 64) and the split
     pass 96 (48 in the forward, 48 in the backward), with the same checks,
     ms per step, views/s, peak memory and each fp32 kernel's time a step
     (phase 3b's per call x launches) and share of it;
  18. phase 5 at the config's default dtype: MapAnythingConfig() (fp32) on
     1 x 8 x 518 under torch.inference_mode(), the fp32 lse-free forward and
     its split pass launched 48 times each (24 at 1370, 12 at 1369, 12 at
     10953 tokens), ms per forward, views/s, peak memory, the output
     invariants and each fp32 kernel's time a forward (phase 3's per call x
     launches) and share of it;
  19. from files to a scene: eight seeded 1024 x 768 PNGs (rows under every
     scanline filter) and a reference-format checkpoint of the seeded
     multimodal flagship (``module.`` prefix, ``dense_head.0/.1`` names), then
     tools/demo_images_only_inference's path on the card in bf16: load_images
     (518 x 392), the checkpoint loaded strictly (its weights held bitwise),
     infer (48 lse-free launches, by key length), the four output files
     parsed; the resize held to the same call on the CPU (one grey level),
     the outputs' invariants; decode, resize, load, infer and export times and
     peak memory; the kernel first against its plain version at the demo's
     shapes, as in phase 3;
  20. the Trainer: the flagship multimodal bf16 at 1 x 4 x 518 (phase 7's
     model and batches as numpy), TrainLoopConfig(accum_iter=2): 4 train
     batches (2 optimizer steps) and 1 eval batch, checkpoints and
     checkpoint-best; then a second Trainer (epochs=2) on the directory
     resumes at epoch 1 with the first one's parameters and moments bitwise
     and trains it; launches per micro-batch and per eval forward, finite
     parameters, an update for every one, ms per optimizer step, save and
     restore times, the checkpoint's bytes, peak memory; the lse-free kernel
     first against its plain version at the eval shapes;
  21. from disk to a trained step: two synthetic WAI scenes of 24 frames of
     1024 x 768 written with the port's writers (PNG frames with 16-bit PNG
     depth; the committed JPEG fixtures of tests/data/jpeg with EXR depth),
     then tools/train.main on configs/train.yaml with the ETH3D train
     dataset's DSL (518_many_ar, 4 views, colorjitter+grayscale+gaublur,
     aug_crop 16), 1 x 4 views a batch, one epoch of 16 samples, the flagship
     in bf16, loader worker processes (host cores, at most 8): decode ms per
     view of each format, ms per sample in a worker, the loader alone, ms per
     optimizer step with each step's wait on the loader, launches per
     micro-batch by kernel and key length, finite parameters, peak memory;
     the training kernels first against their plain versions at the extreme
     aspect ratios' shapes (global 1 x 5477 and 1 x 1777, frame 4 x 1369 and
     4 x 444), as in phase 3b;
  22. the RGB models' flagships (configs/model/mapanything_{mae,moge}_rgb.yaml
     widths: bf16 trunk, fp32 head, raydirs+depth+rgb+pose) through ``infer``
     on 1 x 8 x 518: launches by key length and head dim (the MAE decoder's 8
     narrow fp32 D = 32 forwards, with no split pass, beside the 48 bf16 D = 64
     ones), ms, views/s, peak memory, the output invariants, colours in [0, 1];
  23. the MAE flagship's train step on 1 x 4 x 518 with a seeded target_rgb:
     launches by head dim (8 of each training kernel at D = 32, 8 split
     passes: the backward's), finite loss, RGB term, gradient norm and gradients, a nonzero
     gradient for every parameter, ms per step, views/s, peak memory;
  24. the RGB perception loss (VGG19 on seeded weights, 1 x 2 x 64), the
     disentangled loss and the DUSt3R loss on the card against the CPU, each
     value and gradient within 1e-4 of its magnitude (TF32 off);
  25. the Trainer on a one-rank data x view mesh (NCCL, after phase 10, in
     the same group): the small fp32 multimodal model on one batch
     against the Trainer without a mesh;
  26. the DUSt3R family's slice on the card, fp32 with TF32 off, each against the
     same model on the plain versions (within 1e-4 of each field's magnitude): the
     small ModularDUSt3R (the registry's depths, heads of 64) at 2 views with its
     decoder features, its CrossAttentionTransformer alone at 3 views (contexts of
     2 x 80 keys), and the small ablation MapAnything in the pointmap, raymap+depth,
     campointmap+pose and pointmap+raydirs+depth+pose scene representations, the
     linear head among them; launches by (Tk, D);
  27. ModularDUSt3R at DUSt3R_ViTLarge_BaseDecoder_512_dpt's widths on one 512 x 384
     pair, fp32 and bf16 (the same seeded weights): 72 launches at (768, 64) a
     forward, its CUDA-event time, pairs a second, peak memory, finite pts3d and
     features, conf >= 1, and the attention's share of the forward (phase 3's rows);
  28. the feed-forward baselines' slice on the card: each of the eight registry
     baselines (vggt, moge, moge_1, moge_2, pi3, anycalib, must3r, pow3r) at
     size="small" with heads of 64 (BASELINE_SMALL; VGGT's camera trunk at heads of
     128), fp32 with TF32 off, against the same model on the plain versions under phase
     26's rule; the invariants of the outputs (finite, unit rays and quaternions,
     positive depth, confidence >= 1 where the model has it, MoGe's positive focal);
  29. each baseline at its release's widths, seeded random weights: VGGT-1B on 1 x 8 x
     518 in fp32 and in bf16 (the fp32 model's weights), Pi3 on 1 x 8 x 518, MoGe-1,
     MoGe-2 and AnyCalib (ViT-L) on 8 views of 518, MUSt3R on 1 x 8 x 384 x 512 and
     Pow3R on one 384 x 512 pair with its three priors; one forward with the kernels
     (launches by (Tk, D) held to BASELINE_SHAPES' counts) against one with the plain
     versions (TF32 off: fp32 within BASELINE_FULL_RTOL of each field's magnitude, but
     AnyCalib's pinhole fit, a least-squares solution, reported beside its held FoV
     field; in bf16 VGGT's aggregator tokens within BASELINE_BF16_MEAN_RTOL on average,
     its pose encoding and outputs reported), the invariants, then one warm-up and 3
     CUDA-event-timed forwards: ms a forward, peak memory, launches by kernel and head
     dim; and the phase's whole time. Phase 3 holds the kernels at these paths' shapes
     first (BASELINE_SHAPES, bf16 and fp32, with the bounds, plain and SDPA times);
  30. phase 9 for flagship-h128 (trunk heads of 128): unsharded, ring and allgather
     on the one-rank group under phase 9's limits, the D = 128 launches counted;
  31. bundle adjustment on the flagship: tools/demo_colmap.py --use-ba (bf16, seeded on
     the card) over phase 19's eight PNGs at 518 x 392, tracks from the predictions
     (4096 x 8) and from the photometric tracker, 10 x 25 Gauss-Newton/CG: stage times,
     costs, rms px, the BA held to the port's CPU run on the same tracks, sparse/*.bin
     read back; then tools/demo_inference_on_colmap_outputs.py on the written model;
  32. the VGGSfM tracker at its release widths on the same frames, 512 queries x 3 query
     frames, coarse_iters=6, fine on: 144 launches of fa_fwd_f32_narrow<48> and 24
     of fa_fwd_f32_narrow<32> a query frame (TRACKER_SHAPES) and no split pass, tracks
     and visibility held to the same call on the plain versions;
  33. the optimisation baselines at their releases' widths on 4 views of 384 x 512:
     DUSt3R-BA (metric DUSt3R builds the same), Pow3R-BA with its priors, MASt3R-SGA
     (desc_dim 24, subsample 8): launches by (Tk, D), final loss, focals and poses held
     to the plain versions (OPTIM_RTOL; MASt3R-SGA's pair outputs and the share of its
     matches that agree instead, its alignment reported), ms a scene, peak memory. Phase 3 holds the
     kernels at the tracker's and these paths' shapes first (TRACKER_SHAPES, OPTIM_SHAPES),
     phase 3f the narrow forward at the edge shapes and the canary cases;
  34. the accuracy benchmarks on phase 21's synthetic scenes (written again, with a
     test-split list), the seeded flagship bf16: dense N-view and RMVD run_benchmark
     over 4 sets of 8 views at 518 x 392 (covisibility_thres 0.25, batch 1),
     calibration on single views; metrics finite and in range, ms a set, peak memory,
     launches a set by shape; the first set's predictions scored on the card and on
     the CPU (within 1e-5 but for what the counted edge pixels and pairs allow), the
     ground truth scored as the prediction (abs-rel 0, every inlier, AUC 100);
  35. tools/benchmark_many_views.py at its defaults (1 x 100 x 518, head_chunk_size
     10): views/s, s a scene, peak memory, launches by key length (K3 at 136901), phase
     5's and 13's invariants; K1 at its encoder and frame shapes and K3 at 1 x 136901
     on a slice of query rows against their plain versions;
  36. tools/inference_wai.py on scene_png, 8 views at 518 with the same model: the
     three files, launches by shape;
  37. tools/one_sample_finetune.py, the flagship fp32 on 2 views of 518, 30 steps at lr
     1e-4: ms a step, peak memory, launches by shape, the JAX test's criterion (the
     last printed loss under 0.9x the first); the fp32 training kernels at its shapes
     against their plain versions first;
  41. tools/diagnose_lr_nan.py at its defaults: the flagship bf16 train step on
     1 x 4 x 518 at lr 1e-4 from seeded random weights, rematerialised under
     save_attn_mlp_pre as the JAX script's, 10 steps, each after a forensic forward
     and backward: its lines, ms a step, 96 launches of dq and of dk/dv a step (192
     of the lse forward, its recompute included), the first non-finite step and the
     forensic quantities that grew most;
  42. the flagship fp32 train step with LossConfig(disentangled=True) through the
     view-sharded step at world size 1 (the one-rank NCCL group; on the CPU a gloo
     group of this process), 1 x 2 x 224 (the CPU step's cost), card against CPU
     with TF32 off: loss, terms and every gradient within 1e-3 of the magnitude, a
     leaf past it held to the same step in float64 (the card's gap to it at most
     twice the fp32 CPU run's);
  3i. the lse forward, dq and dk/dv at the shapes of phase 44's 24-view step against
     their plain versions under phase 3's rule: 24 x 1370 x 16 x 64 (encoder) and
     24 x 1369 x 12 x 64 (frame) as in phase 3b, and 1 x 32857 x 12 x 64 (the
     global layers: K7's forward and K5's backward on the TPU) with every row held,
     the plain versions a head at a time; kernel, plain, SDPA and bound times;
  43. the remat policy sweep: phase 7's flagship bf16 forward, loss and backward on
     1 x 4 x 518 without remat, under full remat and under each policy of
     models/blocks.py, then without remat again, on the same weights, batch and
     masks: ms a step, peak GiB, launches by (Tk, D) (the lse forward twice under
     remat), each policy's worst gradient leaf against the first step without
     remat (REMAT_GRAD_GAP_LIMIT); full remat must peak below the step without;
  44. the stage-2 recipe's step: the flagship bf16 train step on 1 x 24 x 518 with
     remat=True (full recompute), one warm and three timed steps: ms a step,
     views/s, peak GiB, launches by (Tk, D) (48 / 24 / 24 lse forwards at 1370,
     1369 and 32857 keys, 24 / 12 / 12 of dq and of dk/dv), finite losses.
On a machine with more than one card, phases 9 and 10 then run again over
NCCL with one rank a card (2 or 4 cards); rank 0 checks the gathered
outputs against the unsharded forward. A machine with one card skips this.
Phases 11-13 run after phase 5, before phase 6; phase 3e after 3d; phases
14-24 after phase 7, before phase 8 (the D = 32 rows with phases 3 and 3b);
phases 26-29 after phase 24, 31-33 after 29, 34-37 after 33, 38-41 after 37, 3i, 43 and 44 after 41;
phase 3h after 3e; phase 25
after phase 10, phase 42 after 25, phase 30 after phase 9. Then the
kernels' summary line and,
last, {"ok": true, "device": {...}}.
Phases 3f and 3g run right after the build. With --train-step-only, phase 7
(phase 17 with --compute-dtype float32) runs after the build (without the SASS
check) and the script stops after its line, printing neither the summary nor
the ok line; copied into another checkout's tree, it times that checkout's step
the same way. With --forward-edges-only, phase
3f runs after the build and the script stops there, the same way; with
--backward-edges-only, phase 3g; with --files-only, phase 19; with
--trainer-only, phase 20; with --data-only, phase 21; with --rgb-only, phase 3f's
narrow cases, the D = 32 rows of phases 3 and 3b, phases 22-24, and 25 on a one-rank
group of its own;
with --dust3r-only, the DUSt3R rows of phase 3, phases 26 and 27, and a kernels line
of their entries; with --baselines-only, the baselines' rows of phase 3, phases 28 and 29,
and a kernels line of their entries; with --ba-only, the SASS check, phase 3f's narrow
cases, the BA slice's rows of phase 3, phases 31-33, and a kernels line of their entries; with
--benchmarks-only, the benchmark slice's rows of phase 3 (phase 19's and the single
view's), phases 34-37, and a kernels line of their entries; with --masked-only, the SASS
check, phases 3h, 41 and 42 (on a one-rank group of its own), and a kernels line of the
masked kernels' entries; with --remat-only, phases 3i, 43 and 44 and a kernels line of
their entries.
Any failed check raises and the script exits non-zero. Without a CUDA device,
or without the port beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import inspect
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "mapanything_tpu_torch/csrc/flash_attention_fwd.cu"
BWD_KERNEL_SOURCE = "mapanything_tpu_torch/csrc/flash_attention_bwd.cu"

# Dense peak rates and memory bandwidth from NVIDIA's data sheets (no sparsity):
# (bf16 tensor-core flop/s, fp32 non-tensor flop/s, bytes/s).
PEAKS = {
    "H100 PCIe": (756e12, 51e12, 2.0e12),
    "H100": (989e12, 67e12, 3.35e12),  # SXM
}

# (name, shape B x T x H x D, dtype, launches per flagship forward of that dtype (phase 5
# in bf16, phase 18 in fp32), TPU kernel replaced: in fp32 the JAX dispatch takes the
# single-pass kernel up to 2048 padded keys, the augmented stream beyond)
ATTENTION_SHAPES = [
    ("encoder", (8, 1370, 16, 64), "bfloat16", 24, "mapanything_tpu/ops/flash_attention.py:395"),
    ("frame", (8, 1369, 12, 64), "bfloat16", 12, "mapanything_tpu/ops/flash_attention.py:395"),
    ("global", (1, 10953, 12, 64), "bfloat16", 12, "mapanything_tpu/ops/flash_attention.py:516"),
    ("fp32_encoder", (8, 1370, 16, 64), "float32", 24, "mapanything_tpu/ops/flash_attention.py:114"),
    ("fp32_frame", (8, 1369, 12, 64), "float32", 12, "mapanything_tpu/ops/flash_attention.py:114"),
    ("fp32_global", (1, 10953, 12, 64), "float32", 12, "mapanything_tpu/ops/flash_attention.py:164"),
]
# Phase 3d: K1 at the 64-view infer's encoder and frame layers (phase 13; its
# launches there are counted by key length).
MANY_VIEW_SHAPES = [
    ("encoder_64_views", (64, 1370, 16, 64), "bfloat16", 24, "mapanything_tpu/ops/flash_attention.py:395"),
    ("frame_64_views", (64, 1369, 12, 64), "bfloat16", 12, "mapanything_tpu/ops/flash_attention.py:395"),
]
# The plain versions run over batch chunks of at most this many (fp32 logits of
# 8 x 16 heads at 1370 tokens: 0.96 GB).
PLAIN_BATCH = 8

# flagship-h128: the flagship with 6 trunk heads of 128 (info_sharing_num_heads=6;
# no released checkpoint uses it). Every trunk layer then runs the D = 128 instances.
H128_TRUNK_HEADS = 6
FA = "mapanything_tpu/ops/flash_attention.py"
# Phase 3e, the lse-free rows: (name, shape, dtype, launches per flagship-h128
# forward, the TPU kernel the JAX dispatch picks there: K1 packed at the frame
# layers, K8 _fwd_kernel at the global layers and in fp32).
H128_SHAPES = [
    ("frame_h128", (8, 1369, 6, 128), "bfloat16", 12, f"{FA}:395"),
    ("global_h128", (1, 10953, 6, 128), "bfloat16", 12, f"{FA}:214"),
    ("fp32_global_h128", (1, 5477, 6, 128), "float32", 0, f"{FA}:214"),
]

# Phase 9: the largest mean |difference| of each output field allowed between
# the unsharded, ring and allgather forwards (bf16 through 24 layers). About
# 3.5x the largest reading of sound runs on an H100, at one rank and at four
# (recorded in PERF.md): 0.0059, 0.0050, 0.0041, 0.0077, 0.0022, 1.1e-4,
# 0.0064, 0.069, 0.010.
MEAN_DIFF_LIMITS = {
    "pts3d": 0.02, "pts3d_cam": 0.02, "ray_directions": 0.015, "depth_along_ray": 0.025,
    "cam_trans": 0.008, "cam_quats": 4e-4, "metric_scaling_factor": 0.025, "conf": 0.25,
    "non_ambiguous_mask_logits": 0.04,
}
# Phase 10: each step's loss against phase 7's at the same seeds, relative.
# Sound runs read up to 8.8e-4. At lr 1e-7 the weights barely move, so this
# holds the ring's forward, not its backward (phase 8 holds that).
LOSS_GAP_LIMIT = 4e-3


_STARTED = time.perf_counter()


def emit(obj) -> None:
    """Print ``obj`` as a line of JSON; a phase's line also gets ``t_s``, the seconds since
    this script was imported, so that a run's lines read as a timeline."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _STARTED}
    print(json.dumps(obj), flush=True)


def peaks_for(name: str):
    for key, value in PEAKS.items():
        if all(part in name for part in key.split()):
            return value
    raise RuntimeError(f"no peak rates known for {name!r}")


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn):
    """``fn``'s device time a call (tools/time_kernels.py ``device_ms``: 20 calls replayed as
    one CUDA graph), or None where the capture fails (not measured)."""
    from mapanything_tpu_torch.tools.time_kernels import device_ms

    try:
        return device_ms(fn)
    except RuntimeError:
        return None


def shape_counts(shapes: dict) -> dict:
    """``launch_shapes()`` as JSON: {kernel: {"<Tk>x<D>": launches}}."""
    return {name: {f"{tk}x{d}": n for (tk, d), n in by.items()} for name, by in shapes.items()}


def counts_match(counts: dict, want: dict) -> bool:
    """``launch_counts()`` against the wanted launches, a kernel that ``want`` leaves out
    wanted 0 times (an older checkout that this script times may lack a kernel's count)."""
    return all(n == want.get(k, 0) for k, n in counts.items())


def by_head_dim(shapes: dict) -> dict:
    """``launch_shapes()`` summed over key lengths: {kernel: {D: launches}}."""
    out = {}
    for name, by in shapes.items():
        out[name] = {}
        for (_, d), n in by.items():
            out[name][d] = out[name].get(d, 0) + n
    return out


def forward_bounds(card, b, tq, tk, h, d, dtype_name, with_lse: bool) -> dict:
    """The forward's bound: the larger of its bytes (q, k, v read, o and the lse written)
    over the memory rate and its 4·B·H·Tq·Tk·D flop over the tensor cores' bf16 rate, in
    fp32 six times that flop (the six bf16 passes of the split products: the split bound);
    beside it the exponentials' bound (one a score at 16 a clock per SM, 1/256 of the bf16
    flop rate) and, in fp32, the same flop at the fp32 FMA rate (the FFMA bound)."""
    from mapanything_tpu_torch.ops.flash_attention import attention_bytes, attention_flops

    bf16_peak, f32_peak, mem_bw = peaks_for(card["name"])
    fp32 = dtype_name == "float32"
    flops = attention_flops(b, tq, tk, h, d)
    t_bytes = (attention_bytes(b, tq, tk, h, d, 4 if fp32 else 2) + (4 * b * h * tq if with_lse else 0)) / mem_bw * 1e3
    t_ops = (6 if fp32 else 1) * flops / bf16_peak * 1e3
    out = {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "exp_bound_ms": b * h * tq * tk / (bf16_peak / 256) * 1e3}
    if fp32:
        out["ffma_bound_ms"] = max(flops / f32_peak * 1e3, t_bytes)
    return out


def split_bound_ms(card, n_elements: int) -> float:
    """The split pass's bound: each fp32 element read (4 bytes) and its three bf16 parts
    written (6), over the memory rate."""
    return n_elements * (4 + 3 * 2) / peaks_for(card["name"])[2] * 1e3


def plain_chunks(b: int, t: int, fp32: bool, tk: int = None) -> list:
    """(batch, query-row) slices over which the plain versions run: batch chunks of
    PLAIN_BATCH; in fp32 also query rows, PLAIN_SLAB // tk at a time (fp64 logits of
    12 heads at 10953 tokens would take 11.5 GB a copy); ``tk`` defaults to t."""
    rows = min(t, PLAIN_SLAB // (tk or t)) if fp32 else t
    return [(slice(i, i + PLAIN_BATCH), slice(r, r + rows)) for i in range(0, b, PLAIN_BATCH)
            for r in range(0, t, rows)]


def kernel_checks(card, shapes, phase_id: str):
    """Phases 3 and 3d: the kernel against its plain version under phase 3's rule (fp32
    also under the fp32 rule), with times and the bound; the plain versions over chunks
    (plain_chunks). The fp32 rows at D = 64 and 128 time the kernel alone on one split
    pass's parts (``ms``), the split pass (``split_ms``, held bitwise to its plain version)
    and the whole call (``call_ms``); the narrow ones (D = 32 and 48, one launch a call)
    the call (``ms``, host-paced CUDA events) and its device time (``device_ms``, 20 calls
    replayed as one CUDA graph), SDPA's too (``library_device_ms``). A row of six
    entries gives the key length last: its q (B, T, H, D) and its k and v (B, Tk, H, D) are
    three tensors, as a cross-attention's ``projq``, ``projk`` and ``projv`` make them; a
    row of five is a self-attention over views of one fused qkv tensor."""
    import torch
    import torch.nn.functional as F

    from mapanything_tpu_torch.ops import flash_attention as fa

    rows = []
    for name, (b, t, h, d), dtype_name, per_forward, replaces, *key_length in shapes:
        dtype = getattr(torch, dtype_name)
        fp32 = dtype == torch.float32
        gen = torch.Generator(device="cuda").manual_seed(1)
        tk = key_length[0] if key_length else t
        if key_length:  # q, k, v as CrossAttention makes them: three projections
            q, k, v = (torch.randn(b, n, h, d, device="cuda", dtype=torch.float32, generator=gen).to(dtype)
                       for n in (t, tk, tk))
            qkv = None
        else:  # q, k, v as Attention makes them: strided views of one fused qkv tensor
            qkv = torch.randn(b, t, 3, h, d, device="cuda", dtype=torch.float32, generator=gen).to(dtype)
            q, k, v = qkv.unbind(2)
        scale = d**-0.5
        out = fa.flash_attention(q, k, v, scale)
        torch.cuda.synchronize()
        chunks = plain_chunks(b, t, fp32, tk)
        exact_dtype = torch.float64 if fp32 else torch.float32
        err = plain_err = ref_max = 0.0
        for cb, cr in chunks:
            exact = fa.attention_reference(*(x.to(exact_dtype) for x in (q[cb, cr], k[cb], v[cb])), scale)
            plain = fa.attention_reference(q[cb, cr], k[cb], v[cb], scale)
            err = max(err, max_err(out[cb, cr], exact))
            plain_err = max(plain_err, max_err(plain, exact))
            ref_max = max(ref_max, exact.abs().max().item())
            del exact, plain
        tol = max(2.0 * plain_err, 1e-2 * ref_max)
        fp32_tol = max(4.0 * plain_err, 1e-5 * ref_max) if fp32 else None
        finite = bool(torch.isfinite(out).all())
        torch.cuda.empty_cache()

        narrow = fp32 and d in fa.NARROW_HEAD_DIMS
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale)  # noqa: E731
        if narrow:  # one launch a call, the split inside: the call, and its device time apart from the host's
            call = lambda: fa.flash_attention(q, k, v, scale)  # noqa: E731
            ms = cuda_time_ms(call, iters=20)
            extra = {"call_ms": ms, "device_ms": device_time_ms(call), "library_device_ms": device_time_ms(sdpa),
                     "plain_fp32_err": plain_err, "fp32_tol": fp32_tol}
        elif fp32:  # the kernel alone on one split's parts; the split and the whole call apart
            parts = fa.flash_attention_split_f32(q, k, v)
            split_bitwise = all(torch.equal(got, fa.split_bf16x3_reference(x, fa.part_cols(d)))
                                for got, x in zip(parts, (q, k, v)))
            ms = cuda_time_ms(lambda: fa._launch_fwd(q, k, v, scale, False, parts), iters=20)
            extra = {"split_ms": cuda_time_ms(lambda: fa.flash_attention_split_f32(q, k, v), iters=20),
                     "split_plain_ms": cuda_time_ms(
                         lambda: [fa.split_bf16x3_reference(x, fa.part_cols(d)) for x in (q, k, v)], iters=5, warmup=1),
                     "split_bound_ms": split_bound_ms(card, b * (t + 2 * tk) * h * d),
                     "split_bitwise": split_bitwise,
                     "call_ms": cuda_time_ms(lambda: fa.flash_attention(q, k, v, scale), iters=20),
                     "plain_fp32_err": plain_err, "fp32_tol": fp32_tol}
            del parts
        else:
            ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v, scale), iters=20)
            extra = {"plain_bf16_err": plain_err}
        plain_ms = cuda_time_ms(lambda: [fa.attention_reference(q[cb, cr], k[cb], v[cb], scale) for cb, cr in chunks],
                                iters=3, warmup=1)
        library_ms = cuda_time_ms(sdpa, iters=20)
        row = {
            "phase": "kernel_check",
            "phase_id": phase_id,
            "shape": name,
            "b_t_h_d": [b, t, h, d],
            **({"tk": tk} if key_length else {}),
            "dtype": dtype_name,
            "replaces": replaces,
            "max_abs_err": err,
            "tol": tol,
            "ms": ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms,
            **forward_bounds(card, b, t, tk, h, d, dtype_name, with_lse=False),
            "tflops": fa.attention_flops(b, t, tk, h, d) / ms / 1e9,
            **extra,
            "per_forward": per_forward,
            "card": card["name"],
            "power_limit": card["power_limit"],
        }
        emit(row)
        if not finite or err > tol or (fp32 and (err > fp32_tol or not extra.get("split_bitwise", True))):
            raise AssertionError(f"kernel disagrees with its plain version at {name}: {err} > {tol} "
                                 f"(fp32 rule {fp32_tol}; split bitwise {extra.get('split_bitwise')})")
        rows.append(row)
        del qkv, q, k, v, out
        torch.cuda.empty_cache()
    return rows


# (name, shape B x T x H x D, dtype, launches per flagship train step) at the shapes
# of the flagship 1 x 4 x 518 training step (phase 7, bf16).
TRAIN_SHAPES = [
    ("encoder", (4, 1370, 16, 64), "bfloat16", 24),
    ("frame", (4, 1369, 12, 64), "bfloat16", 12),
    ("global", (1, 5477, 12, 64), "bfloat16", 12),
]
# The same at the default-dtype (fp32) flagship step's shapes (phase 17); fp32_global is
# K7's regime for the lse forward.
FP32_TRAIN_SHAPES = [
    ("fp32_encoder", (4, 1370, 16, 64), "float32", 24),
    ("fp32_frame", (4, 1369, 12, 64), "float32", 12),
    ("fp32_global", (1, 5477, 12, 64), "float32", 12),
]
# The TPU kernels each port replaces, by the JAX package's regime at that shape (fp32
# never takes the head-pair kernels). The split pass of the fp32 backward is part of the
# port of the dq and dk/dv kernels it feeds (K5's at D = 64, K8's at D = 128).
TRAIN_REPLACES = {
    "flash_attention_fwd_lse": {"encoder": f"{FA}:118", "frame": f"{FA}:118", "global": f"{FA}:600",
                                "fp32_encoder": f"{FA}:118", "fp32_frame": f"{FA}:118", "fp32_global": f"{FA}:168"},
    "flash_attention_bwd_dq": {"encoder": f"{FA}:227", "frame": f"{FA}:227", "global": f"{FA}:715",
                               **dict.fromkeys(("fp32_encoder", "fp32_frame", "fp32_global"), f"{FA}:227")},
    "flash_attention_bwd_dkv": {"encoder": f"{FA}:262", "frame": f"{FA}:262", "global": f"{FA}:753",
                                **dict.fromkeys(("fp32_encoder", "fp32_frame", "fp32_global"), f"{FA}:262")},
    "flash_attention_split_f32": dict.fromkeys(("fp32_encoder", "fp32_frame", "fp32_global"), f"{FA}:227"),
}
# Phase 3e, the training rows at flagship-h128's 1 x 4 x 518 step (launches per step).
H128_TRAIN_SHAPES = [
    ("frame_h128", (4, 1369, 6, 128), "bfloat16", 12),
    ("global_h128", (1, 5477, 6, 128), "bfloat16", 12),
    ("fp32_global_h128", (1, 5477, 6, 128), "float32", 0),
]
H128_TRAIN_REPLACES = {  # K4 single-pass at the frame layers' lse forward, else K8
    "flash_attention_fwd_lse": {"frame_h128": f"{FA}:118", "global_h128": f"{FA}:218",
                                "fp32_global_h128": f"{FA}:218"},
    "flash_attention_bwd_dq": dict.fromkeys(("frame_h128", "global_h128", "fp32_global_h128"), f"{FA}:306"),
    "flash_attention_bwd_dkv": dict.fromkeys(("frame_h128", "global_h128", "fp32_global_h128"), f"{FA}:339"),
    "flash_attention_split_f32": {"fp32_global_h128": f"{FA}:306"},
}


def ptxas_report(log: str) -> dict:
    """Registers, spills and static shared memory of each kernel instance, from
    nvcc's -Xptxas -v output, by mangled name; and ptxas' warnings."""
    report, name, warnings = {}, None, []
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name = entry.group(1)
            report[name] = {}
        elif "warning" in line.lower() or "Performance Loss" in line:
            warnings.append(line.strip())
        elif name is not None:
            for key, pattern in (("registers", r"Used (\d+) registers"), ("spill_stores", r"(\d+) bytes spill stores"),
                                 ("spill_loads", r"(\d+) bytes spill loads"), ("static_smem", r"(\d+) bytes smem")):
                found = re.search(pattern, line)
                if found:
                    report[name][key] = int(found.group(1))
    return {"instances": report, "warnings": warnings}


# Phase 2: the instances whose SASS must hold HGMMA (wgmma) and UTMALDG (a TMA load): the
# forward's, bf16 and fp32, by (dtype, D, lse) in the forward library; the backward's by
# (kernel, dtype, D) in the backward library; with the index of each in its library's
# flash_attention_fwd_smem or flash_attention_bwd_smem.
def instance_dims(lse: bool = False) -> dict:
    """The head dims of each dtype's instances, as ``ops/flash_attention.py`` lists them: of
    the lse-free forward, or with ``lse`` of the lse forward and the backward."""
    import torch

    from mapanything_tpu_torch.ops import flash_attention as fa

    return {"bf16": fa.head_dims(torch.bfloat16, lse), "f32": fa.head_dims(torch.float32, lse)}


def fwd_instances() -> dict:
    """(dtype, D, lse, regime) -> the forward instance's name: regime "streaming" or
    "packed" for the narrow fp32 instances (fa_fwd_f32_narrow, D = 32 and 48), else None."""
    from mapanything_tpu_torch.ops import flash_attention as fa

    out = {}
    for lse in (False, True):
        for dtype, dims in instance_dims(lse).items():
            for d in dims:
                if dtype == "f32" and d in fa.NARROW_HEAD_DIMS:
                    for packed, regime in enumerate(("streaming", "packed")):
                        out[(dtype, d, lse, regime)] = f"fa_fwd_f32_narrowILi{d}ELb{int(lse)}ELb{packed}E"
                else:
                    out[(dtype, d, lse, None)] = f"fa_fwd_{dtype}ILi{d}ELb{int(lse)}E"
    return out


def bwd_instances() -> dict:
    """(kernel, dtype, D) -> the backward instance's name: the fp32 D = 32 instances are the
    true-width ones (fa_bwd_dq_f32_narrow, fa_bwd_dkv_f32_narrow)."""
    from mapanything_tpu_torch.ops import flash_attention as fa

    out = {}
    for kernel in ("dq", "dkv"):
        for dtype, dims in instance_dims(lse=True).items():
            for d in dims:
                narrow = "_narrow" if dtype == "f32" and d in fa.NARROW_HEAD_DIMS else ""
                out[(kernel, dtype, d)] = f"fa_bwd_{kernel}_{dtype}{narrow}ILi{d}E"
    return out


FWD_SMEM_INDEX = {("bf16", None): 0, ("f32", None): 1, ("f32", "streaming"): 2, ("f32", "packed"): 3}
BWD_SMEM_INDEX = {("dq", "bf16"): 0, ("dkv", "bf16"): 1, ("dq", "f32"): 2, ("dkv", "f32"): 3}
TENSOR_CORE_SASS = ("HGMMA", "UTMALDG")


def sass_check(lib: Path, instances: dict) -> dict:
    """Phase 2: cuobjdump -sass of one kernel library; every instance named in
    ``instances`` must contain HGMMA and UTMALDG, the narrow fp32 forward's HGMMA (it
    loads its fp32 rows with 16-byte loads, not TMA; the true-width D = 32 backward loads
    through TMA). Returns their counts by instance."""
    from mapanything_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    functions = {f.split("\n", 1)[0].strip(): f for f in sass.split("Function : ")[1:]}
    counts = {}
    for key in instances.values():
        bodies = [body for fname, body in functions.items() if key in fname]
        if len(bodies) != 1:
            raise AssertionError(f"cuobjdump shows {len(bodies)} functions named like {key}")
        counts[key] = {op: bodies[0].count(op) for op in TENSOR_CORE_SASS}
    missing = {key: c for key, c in counts.items() if not (c["HGMMA"] and (c["UTMALDG"] or "fwd_f32_narrow" in key))}
    if missing:
        raise AssertionError(f"instances without wgmma or TMA in their SASS: {missing}")
    return counts


def masked_sass_check(lib: Path) -> dict:
    """Phase 2 for the masked kernels' library: cuobjdump -sass; every bf16 instance must hold
    HMMA (mma.sync), the fp32 ones run FFMA. Returns both counts by instance."""
    from mapanything_tpu_torch.ops import _build
    from mapanything_tpu_torch.ops import flash_attention as fa

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    functions = {f.split("\n", 1)[0].strip(): f for f in sass.split("Function : ")[1:]}
    counts = {name: {op: body.count(op) for op in ("HMMA", "FFMA")} for name, body in functions.items()
              if "_masked" in name}
    missing = [name for name, c in counts.items() if "bfloat16" in name and not c["HMMA"]]
    trained = len(fa.HEAD_DIMS) + len(fa.F32_LSE_HEAD_DIMS)  # the instances with lse forward, dq and dk/dv
    if len(counts) != len(fa.HEAD_DIMS) + len(fa.F32_HEAD_DIMS) + 3 * trained or missing:
        raise AssertionError(f"the masked library holds {len(counts)} instances, bf16 ones without HMMA: {missing}")
    return counts


# Phase 3f: (Tq, Tk, B, H) of each case: square lengths and Tq != Tk pairs at B = 2,
# H = 3; then more than 2 x 132 work tiles of 128 query rows, so that every block of
# the persistent grid walks several, with one key tile each and with six.
EDGE_CASES = ([(t, t, 2, 3) for t in (1, 7, 64, 65, 127, 129, 1370)] + [(129, 4000, 2, 3), (5476, 1, 2, 3)]
              + [(65, 65, 16, 20), (400, 1000, 4, 24)])
EDGE_SCALE = 0.3  # the fused-layout cases' scale; the contiguous cases take D ** -0.5


# Phase 3f's cases of the narrow fp32 forward (D = 32 and 48) besides EDGE_CASES: every
# (Tq, Tk) of these lengths (the packed regime up to 64, the streaming one past it), at
# B x H = 3 x 5 sequences (a multiple of no packed tile's sequences but 1 and 5).
NARROW_EDGE_TQ = (1, 7, 8, 9, 33, 64, 65)
NARROW_EDGE_TK = (1, 8, 13, 64, 65, 512)
NARROW_EDGE_CASES = [(tq, tk, 3, 5) for tq in NARROW_EDGE_TQ for tk in NARROW_EDGE_TK]


def edge_case_rows(dtype, d, tq, tk, b, h, layout) -> list:
    """One phase-3f case: the lse-free forward (and, where D has one, the lse forward) at
    (Tq, Tk, B, H) on contiguous tensors (scale D ** -0.5) or views of fused qkv (or q and
    kv) tensors (EDGE_SCALE), against the plain version in fp32 (fp64 for fp32): a row
    for o (and o_lse and lse) with its error, phase 3's tolerance and in fp32 the fp32 rule."""
    import torch

    from mapanything_tpu_torch.ops import flash_attention as fa

    dname, fp32 = str(dtype).split(".")[-1], dtype == torch.float32
    gen = torch.Generator(device="cuda").manual_seed(tq * 7919 + tk + d)
    if layout == "contiguous":
        q, k, v = (torch.randn(b, t, h, d, device="cuda", generator=gen).to(dtype) for t in (tq, tk, tk))
        scale = d**-0.5
    elif tq == tk:  # views of one fused qkv tensor
        q, k, v = torch.randn(b, tq, 3, h, d, device="cuda", generator=gen).to(dtype).unbind(2)
        scale = EDGE_SCALE
    else:  # q from a fused qkv tensor, k and v from a fused kv tensor
        q = torch.randn(b, tq, 3, h, d, device="cuda", generator=gen).to(dtype)[:, :, 0]
        k, v = torch.randn(b, tk, 2, h, d, device="cuda", generator=gen).to(dtype).unbind(2)
        scale = EDGE_SCALE
    o_free = fa.flash_attention(q, k, v, scale)
    with_lse = d in fa.head_dims(dtype, lse=True)
    if with_lse:
        o_lse, lse = fa.flash_attention_lse(q, k, v, scale)
    torch.cuda.synchronize()
    exact_dtype = torch.float64 if fp32 else torch.float32
    o_exact, lse_exact = fa.attention_lse_reference(*(x.to(exact_dtype) for x in (q, k, v)), scale)
    o_plain, lse_plain = fa.attention_lse_reference(q, k, v, scale)
    forms = [("o", o_free, o_exact, o_plain)]
    if with_lse:
        forms += [("o_lse", o_lse, o_exact, o_plain), ("lse", lse, lse_exact, lse_plain)]
    rows = []
    for form, out, exact, plain in forms:
        plain_err = max_err(plain, exact)
        row = {"dtype": dname, "d": d, "tq": tq, "tk": tk, "b": b, "h": h, "layout": layout,
               "out": form, "err": max_err(out, exact), "tol": tolerance(plain_err, exact),
               "finite": bool(torch.isfinite(out).all())}
        if fp32:
            row["fp32_tol"] = fp32_tolerance(plain_err, exact)
        rows.append(row)
    return rows


def edge_report(card, phase: str, cases: list) -> list:
    """Phase 3f's line over ``cases``; raises if any case failed its rules or its canaries."""
    bad = [c for c in cases if not (c["finite"] and c["err"] <= c["tol"] and c["err"] <= c.get("fp32_tol", c["tol"])
                                    and c.get("canaries_intact", True))]
    worst = {dname: max((c for c in cases if c["dtype"] == dname),
                        key=lambda c: c["err"] / max(min(c["tol"], c.get("fp32_tol", c["tol"])), 1e-30))
             for dname in dict.fromkeys(c["dtype"] for c in cases)}
    emit({"phase": phase, "phase_id": "3f", "cases": len(cases), "worst": worst, "failed": bad,
          "canary_cases": sum("canaries_intact" in c for c in cases),
          "narrow_cases": sum(c["dtype"] == "float32" and c["d"] in (32, 48) for c in cases),
          "card": card["name"], "power_limit": card["power_limit"]})
    if bad:
        raise AssertionError(f"the forward disagrees with its plain version at {len(bad)} edge cases: {bad[:4]}")
    return cases


def forward_edge_checks(card) -> list:
    """Phase 3f: the forward, bf16 and fp32, lse-free and lse, at every instantiated head
    dim against its plain version under phase 3's rule (fp32 also under the fp32 rule), at
    the edge shapes in both layouts (edge_case_rows; fp32 D = 48, the VGGSfM tracker's: the
    lse-free o alone, its only instance), the narrow fp32 forward also at
    NARROW_EDGE_CASES, then the canary cases."""
    import torch

    from mapanything_tpu_torch.ops import flash_attention as fa

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for d in fa.head_dims(dtype):
            narrow = dtype == torch.float32 and d in fa.NARROW_HEAD_DIMS
            for tq, tk, b, h in EDGE_CASES + (NARROW_EDGE_CASES if narrow else []):
                for layout in ("contiguous", "fused"):
                    cases += edge_case_rows(dtype, d, tq, tk, b, h, layout)
    cases += forward_canary_checks()
    return edge_report(card, "forward_edge_check", cases)


# The canary cases of phases 3f and 3g: the fp32 kernels at every instantiated head dim
# write into tensors cut out of a larger buffer whose bytes before and after them hold a
# canary, which must survive bit for bit (a store past a row of D, or past the last row,
# would overwrite it). (Tq, Tk, B, H): lengths that no tile divides, H >= 3, q, k, v as
# views of a fused qkv (or q and kv) tensor.
CANARY_CASES = [(65, 65, 2, 3), (129, 4000, 2, 3), (1370, 1370, 1, 16), (1369, 1369, 3, 5)]
# The narrow fp32 forward's besides: packed tiles of 1, 16 and 2 sequences, the last work
# tile partly filled and more work tiles than blocks (577 x 8 and 301 x 3 sequences), a
# packed tile of 7 queries against 13 keys, 33 queries streaming 512 keys.
NARROW_CANARY_CASES = [(1, 1, 3, 5), (8, 8, 577, 8), (64, 64, 301, 3), (7, 13, 3, 5), (33, 512, 2, 3),
                       (65, 64, 3, 5)]
CANARY = 1234.5678
CANARY_PAD = 4096  # elements of canary before and after each output


def canary_buffer(shape, dtype=None):
    """A tensor of ``shape`` inside a buffer padded with CANARY_PAD canary elements on
    each side, and a check that returns whether the canaries survived."""
    import torch

    n = math.prod(shape)
    buf = torch.full((n + 2 * CANARY_PAD,), CANARY, dtype=dtype or torch.float32, device="cuda")
    inner = buf[CANARY_PAD:CANARY_PAD + n].view(shape)
    inner.fill_(float("nan"))
    return inner, lambda: bool((buf[:CANARY_PAD] == CANARY).all() and (buf[CANARY_PAD + n:] == CANARY).all())


def forward_canary_checks(dims=None) -> list:
    """Phase 3f's canary cases: the fp32 forward with lse into canary buffers (D = 48, which
    has no lse instance: the lse-free forward), at every fp32 head dim or at ``dims``; the
    narrow ones also at NARROW_CANARY_CASES and the VGGSfM tracker's shapes
    (TRACKER_CANARY_CASES)."""
    import torch

    from mapanything_tpu_torch.ops import flash_attention as fa

    cases = []
    for d in dims or fa.F32_HEAD_DIMS:
        narrow = d in fa.NARROW_HEAD_DIMS
        for tq, tk, b, h in CANARY_CASES + (NARROW_CANARY_CASES + TRACKER_CANARY_CASES if narrow else []):
            gen = torch.Generator(device="cuda").manual_seed(tq * 31 + tk + d)
            q, k, v, _, scale = backward_edge_inputs(d, tq, tk, b, h, "fused", gen, torch.float32)
            with_lse = d in fa.F32_LSE_HEAD_DIMS
            o, o_ok = canary_buffer((b, tq, h, d))
            lse, lse_ok = canary_buffer((b, h, tq)) if with_lse else (None, lambda: True)
            fa._launch_fwd(q, k, v, scale, with_lse, out=(o, lse))
            torch.cuda.synchronize()
            o_exact, lse_exact = fa.attention_lse_reference(*(x.double() for x in (q, k, v)), scale)
            o_plain, lse_plain = fa.attention_lse_reference(q, k, v, scale)
            intact = o_ok() and lse_ok()
            forms = [("o", o, o_exact, o_plain)] + ([("lse", lse, lse_exact, lse_plain)] if with_lse else [])
            for form, out, exact, plain in forms:
                plain_err = max_err(plain, exact)
                cases.append({"dtype": "float32", "d": d, "tq": tq, "tk": tk, "b": b, "h": h, "layout": "fused",
                              "out": form, "err": max_err(out, exact), "tol": tolerance(plain_err, exact),
                              "fp32_tol": fp32_tolerance(plain_err, exact),
                              "finite": bool(torch.isfinite(out).all()), "canaries_intact": intact})
    return cases


def backward_edge_inputs(d, tq, tk, b, h, layout, gen, dtype):
    """q, k, v, dO and the scale of one phase-3g case in ``dtype``: contiguous tensors, or
    views of fused qkv (or q and kv) tensors with dO a view of a wider tensor."""
    import torch

    if layout == "contiguous":
        q, k, v, do = (torch.randn(b, t, h, d, device="cuda", generator=gen).to(dtype) for t in (tq, tk, tk, tq))
        return q, k, v, do, d**-0.5
    if tq == tk:
        q, k, v = torch.randn(b, tq, 3, h, d, device="cuda", generator=gen).to(dtype).unbind(2)
    else:
        q = torch.randn(b, tq, 3, h, d, device="cuda", generator=gen).to(dtype)[:, :, 0]
        k, v = torch.randn(b, tk, 2, h, d, device="cuda", generator=gen).to(dtype).unbind(2)
    do = torch.randn(b, tq, 2, h, d, device="cuda", generator=gen).to(dtype)[:, :, 1]
    return q, k, v, do, EDGE_SCALE


def backward_edge_checks(card) -> list:
    """Phase 3g: the dq and dk/dv kernels, bf16 at D = 64 and 128 and fp32 at D = 32, 64
    and 128, against their plain versions under phase 3's rule (fp32 also under the fp32
    rule), at phase 3f's edge shapes, on contiguous and fused layouts, and once fed a merged
    lse as the ring feeds them; each kernel called twice, its outputs bitwise equal; then the
    fp32 canary cases at every fp32 head dim. Cases with one key take
    merged statistics too: against their own, P = 1 and dS = dP - delta = 0 exactly, so dq
    and dk are rounding noise that no rule relative to their magnitude can hold."""
    import torch

    from mapanything_tpu_torch.ops import flash_attention as fa
    from mapanything_tpu_torch.parallel.sharded_attention import _block_attn_lse, _merge_lse

    def statistics(q, k, v, do, scale, gen):
        """lse and delta of the softmax over these keys, or (``gen`` given) over these
        keys and a 1-token block of its own, merged through the lse as the ring does."""
        part = fa.attention_lse_reference(q.float(), k.float(), v.float(), scale)
        if gen is not None:
            ke, ve = torch.randn(2, q.shape[0], 1, q.shape[2], q.shape[3], device="cuda", generator=gen).to(q.dtype)
            part = _merge_lse([part, _block_attn_lse(q, ke, ve, scale)])
        o, lse = part
        return lse.contiguous(), fa.attention_bwd_delta(o, do).contiguous()

    cases = []

    def check(case, q, k, v, do, lse, delta, scale):
        got = {"dq": fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)}
        got["dk"], got["dv"] = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)
        again = {"dq": fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)}
        again["dk"], again["dv"] = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)
        torch.cuda.synchronize()
        fp32 = q.dtype == torch.float32
        exact_dtype = torch.float64 if fp32 else torch.float32
        xe = [x.to(exact_dtype) for x in (q, k, v, do, lse, delta)]
        exact = {"dq": fa.attention_bwd_dq_reference(*xe, scale)}
        exact["dk"], exact["dv"] = fa.attention_bwd_dkv_reference(*xe, scale)
        plain = {"dq": fa.attention_bwd_dq_reference(q, k, v, do, lse, delta, scale)}
        plain["dk"], plain["dv"] = fa.attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale)
        for out in got:
            plain_err = max_err(plain[out], exact[out])
            err, tol = max_err(got[out], exact[out]), tolerance(plain_err, exact[out])
            row = {**case, "out": out, "err": err, "tol": tol, "finite": bool(torch.isfinite(got[out]).all()),
                   "repeatable": bool(torch.equal(got[out], again[out]))}
            if fp32:
                row["fp32_tol"] = fp32_tolerance(plain_err, exact[out])
            cases.append(row)

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for d in fa.head_dims(dtype, lse=True):
            for tq, tk, b, h in EDGE_CASES:
                for layout in ("contiguous", "fused"):
                    gen = torch.Generator(device="cuda").manual_seed(tq * 7919 + tk + d + 1)
                    q, k, v, do, scale = backward_edge_inputs(d, tq, tk, b, h, layout, gen, dtype)
                    merged = tk == 1
                    lse, delta = statistics(q, k, v, do, scale, gen if merged else None)
                    check({"dtype": dname, "d": d, "tq": tq, "tk": tk, "b": b, "h": h, "layout": layout,
                           "merged_lse": merged}, q, k, v, do, lse, delta, scale)
            gen = torch.Generator(device="cuda").manual_seed(d)
            q, k, v, do = (torch.randn(1, 1370, 4, d, device="cuda", generator=gen).to(dtype) for _ in range(4))
            lse, delta = statistics(q, k, v, do, d**-0.5, gen)
            check({"dtype": dname, "d": d, "tq": 1370, "tk": 1370, "b": 1, "h": 4, "layout": "contiguous",
                   "merged_lse": True}, q, k, v, do, lse, delta, d**-0.5)
    for d in fa.F32_LSE_HEAD_DIMS:  # the canary cases (CANARY_CASES)
        for tq, tk, b, h in CANARY_CASES:
            gen = torch.Generator(device="cuda").manual_seed(tq * 31 + tk + d + 1)
            q, k, v, do, scale = backward_edge_inputs(d, tq, tk, b, h, "fused", gen, torch.float32)
            lse, delta = statistics(q, k, v, do, scale, None)
            parts = fa.flash_attention_split_f32(q, k, v, fa._check_bwd(q, k, v, do, lse, delta))
            (dq, dq_ok), (dk, dk_ok), (dv, dv_ok) = (canary_buffer(x.shape) for x in (q, k, v))
            fa._launch_bwd("dq", q, k, v, do, lse, delta, scale, (dq,), parts)
            fa._launch_bwd("dkv", q, k, v, do, lse, delta, scale, (dk, dv), parts)
            torch.cuda.synchronize()
            intact = dq_ok() and dk_ok() and dv_ok()
            xe = [x.double() for x in (q, k, v, do, lse, delta)]
            exact = {"dq": fa.attention_bwd_dq_reference(*xe, scale)}
            exact["dk"], exact["dv"] = fa.attention_bwd_dkv_reference(*xe, scale)
            plain = {"dq": fa.attention_bwd_dq_reference(q, k, v, do, lse, delta, scale)}
            plain["dk"], plain["dv"] = fa.attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale)
            for out, got in (("dq", dq), ("dk", dk), ("dv", dv)):
                plain_err = max_err(plain[out], exact[out])
                cases.append({"dtype": "float32", "d": d, "tq": tq, "tk": tk, "b": b, "h": h, "layout": "fused",
                              "merged_lse": False, "out": out, "err": max_err(got, exact[out]),
                              "tol": tolerance(plain_err, exact[out]), "fp32_tol": fp32_tolerance(plain_err, exact[out]),
                              "finite": bool(torch.isfinite(got).all()), "repeatable": True,
                              "canaries_intact": intact})
    bad = [c for c in cases if not (c["finite"] and c["repeatable"] and c["err"] <= c["tol"]
                                    and c["err"] <= c.get("fp32_tol", c["tol"]) and c.get("canaries_intact", True))]
    worst = {dname: max((c for c in cases if c["dtype"] == dname),
                        key=lambda c: c["err"] / max(min(c["tol"], c.get("fp32_tol", c["tol"])), 1e-30))
             for dname in ("bfloat16", "float32")}
    emit({"phase": "backward_edge_check", "phase_id": "3g", "cases": len(cases), "worst": worst, "failed": bad,
          "canary_cases": sum("canaries_intact" in c for c in cases),
          "card": card["name"], "power_limit": card["power_limit"]})
    if bad:
        raise AssertionError(f"the backward disagrees with its plain version or itself at {len(bad)} edge "
                             f"cases: {bad[:4]}")
    return cases


def tolerance(err_plain: float, ref) -> float:
    """Phase 3's rule: twice the plain version's own error, or 1e-2 of the reference's magnitude."""
    return max(2.0 * err_plain, 1e-2 * ref.abs().max().item())


def fp32_tolerance(err_plain: float, ref) -> float:
    """The fp32 rule, held beside phase 3's by the fp32 kernels (o, lse, dq, dk, dv): 4x the
    fp32 plain version's own error against fp64, or 1e-5 of the reference's magnitude.
    Phase 3's 1e-2 of the magnitude alone would pass a single bf16 pass (~2^-9 of it)."""
    return max(4.0 * err_plain, 1e-5 * ref.abs().max().item())


FP32_RULE_OUTPUTS = ("o", "lse", "dq", "dk", "dv")


def max_err(x, ref) -> float:
    return (x.double() - ref.double()).abs().max().item()


def train_kernel_checks(card, shapes=TRAIN_SHAPES, replaces=TRAIN_REPLACES, phase_id: str = "3b"):
    """Phases 3b and 3e: the lse forward, dq and dk/dv kernels against their plain versions;
    in fp32 also under the fp32 rule (o, lse, dq, dk, dv), each kernel timed alone on one
    split pass's parts, and the split passes (the forward's of q, k and v, the backward's of
    q, k, v and dO, a layer's two together) bitwise against their plain version. At D = 32
    the lse forward is the narrow one (no split pass; its device time beside its call's):
    the split passes are the backward's alone."""
    import torch
    import torch.nn.functional as F

    from mapanything_tpu_torch.ops import flash_attention as fa

    bf16_peak, f32_peak, mem_bw = peaks_for(card["name"])
    rows = []
    for name, (b, t, h, d), dtype_name, per_step in shapes:
        dtype = getattr(torch, dtype_name)
        exact_dtype = torch.float32 if dtype == torch.bfloat16 else torch.float64
        gen = torch.Generator(device="cuda").manual_seed(2)
        qkv = torch.randn(b, t, 3, h, d, device="cuda", generator=gen).to(dtype)
        q, k, v = qkv.unbind(2)
        do = torch.randn(b, t, h, d, device="cuda", generator=gen).to(dtype)
        scale = d**-0.5
        o, lse = fa.flash_attention_lse(q, k, v, scale)
        delta = fa.attention_bwd_delta(o, do).contiguous()
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)
        torch.cuda.synchronize()
        outs = {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}

        # Exact: the plain versions on the same inputs in fp32 (fp64 for the fp32 shape);
        # plain: the plain versions in the kernels' own dtype.
        xe = [x.to(exact_dtype) for x in (q, k, v, do)]
        o_e, lse_e = fa.attention_lse_reference(xe[0], xe[1], xe[2], scale)
        exact = dict(zip(("dq", "dk", "dv"), fa.attention_bwd_reference(*xe[:3], o_e, lse_e, xe[3], scale)))
        exact.update(o=o_e, lse=lse_e)
        o_p, lse_p = fa.attention_lse_reference(q, k, v, scale)
        plain = dict(zip(("dq", "dk", "dv"), fa.attention_bwd_reference(q, k, v, o_p, lse_p, do, scale)))
        plain.update(o=o_p, lse=lse_p)
        errs = {key: max_err(outs[key], exact[key]) for key in outs}
        plain_errs = {key: max_err(plain[key], exact[key]) for key in outs}
        tols = {key: tolerance(plain_errs[key], exact[key]) for key in outs}
        fp32 = dtype == torch.float32
        fp32_tols = {key: fp32_tolerance(plain_errs[key], exact[key]) for key in outs} if fp32 else {}
        finite = all(bool(torch.isfinite(x).all()) for x in outs.values())
        del exact, plain, xe, o_e, lse_e, o_p, lse_p
        torch.cuda.empty_cache()
        split_bitwise = None
        narrow = fp32 and d in fa.NARROW_HEAD_DIMS  # the lse forward splits in its kernel
        split_inputs = (q, k, v, do) if narrow else (q, k, v, do, q, k, v)
        if fp32:  # the split passes against their plain version, bitwise
            parts = fa.flash_attention_split_f32(q, k, v, do)
            fwd_parts = None if narrow else fa.flash_attention_split_f32(q, k, v)
            split_bitwise = all(torch.equal(got, fa.split_bf16x3_reference(x, fa.part_cols(d)))
                                for got, x in zip(parts + (fwd_parts or ()), split_inputs))

        plain_delta = fa.attention_bwd_delta(o, do)
        if fp32:  # the fp32 kernels alone, on one split pass's parts (the splits are timed apart)
            outs_dq, outs_dkv = (torch.empty_like(q),), (torch.empty_like(k), torch.empty_like(v))
            fwd_call = lambda: fa._launch_fwd(q, k, v, scale, True, fwd_parts)  # noqa: E731
            dq_call = lambda: fa._launch_bwd("dq", q, k, v, do, lse, delta, scale, outs_dq, parts)  # noqa: E731
            dkv_call = lambda: fa._launch_bwd("dkv", q, k, v, do, lse, delta, scale, outs_dkv, parts)  # noqa: E731
        else:
            fwd_call = lambda: fa.flash_attention_lse(q, k, v, scale)  # noqa: E731
            dq_call = lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)  # noqa: E731
            dkv_call = lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)  # noqa: E731
        times = {
            "flash_attention_fwd_lse": (
                cuda_time_ms(fwd_call, iters=20),
                cuda_time_ms(lambda: fa.attention_lse_reference(q, k, v, scale), iters=3, warmup=1),
            ),
            "flash_attention_bwd_dq": (
                cuda_time_ms(dq_call, iters=20),
                cuda_time_ms(lambda: fa.attention_bwd_dq_reference(q, k, v, do, lse, plain_delta, scale),
                             iters=3, warmup=1),
            ),
            "flash_attention_bwd_dkv": (
                cuda_time_ms(dkv_call, iters=20),
                cuda_time_ms(lambda: fa.attention_bwd_dkv_reference(q, k, v, do, lse, plain_delta, scale),
                             iters=3, warmup=1),
            ),
        }
        split_ms = {}
        if fp32:  # a layer's split passes: the forward's (q, k, v; none at D = 32) and the backward's (q, k, v, dO)
            if not narrow:
                split_ms["fwd_split_ms"] = cuda_time_ms(lambda: fa.flash_attention_split_f32(q, k, v), iters=20)
            split_ms["bwd_split_ms"] = cuda_time_ms(lambda: fa.flash_attention_split_f32(q, k, v, do), iters=20)
            times["flash_attention_split_f32"] = (
                sum(split_ms.values()),
                cuda_time_ms(lambda: [fa.split_bf16x3_reference(x, fa.part_cols(d)) for x in split_inputs],
                             iters=5,
                             warmup=1),
            )
        # The library yardstick: torch SDPA forward with autograd on, and its backward alone.
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
        dot = do.transpose(1, 2)
        library_fwd_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), iters=20)
        library_bwd_ms = cuda_time_ms(
            lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot, retain_graph=True), iters=20
        )
        del sdpa_out, qt, kt, vt
        # Like for like with SDPA's backward, which computes its own delta: the whole of ours.
        bwd_lse_ms = cuda_time_ms(lambda: fa.flash_attention_bwd_lse(q, k, v, o, lse, do, scale), iters=20)
        item = q.element_size()
        io_stats = 2 * 4 * b * h * t  # lse and delta, fp32
        # The backward's necessary work is five T²·D products, 10·B·H·T²·D flop,
        # whatever the kernels recompute: dq is given dS·K and half of S and dP (4),
        # dk/dv is given Pᵀ·dO, dSᵀ·Q and the other half (6), so that the two
        # bounds sum to the backward's.
        work = {  # (flop, bytes) each backward kernel's function needs
            "flash_attention_bwd_dq": (4 * b * h * t * t * d, 5 * b * t * h * d * item + io_stats),
            "flash_attention_bwd_dkv": (6 * b * h * t * t * d, 6 * b * t * h * d * item + io_stats),
        }
        # The fp32 backward runs its products as six bf16 passes on the tensor cores: its
        # bound is 6x their flop at the bf16 rate (the split bound), 4.1x under the same
        # flop at the fp32 FMA rate (the FFMA bound, kept beside it as ffma_bound_ms).
        passes = 6 if fp32 else 1
        bwd_bound_ms = max(passes * fa.attention_bwd_flops(b, t, t, h, d) / bf16_peak,
                           fa.attention_bwd_bytes(b, t, t, h, d, item) / mem_bw) * 1e3
        kernels = {}
        for kname, (ms, plain_ms) in times.items():
            entry = {"replaces": replaces[kname][name], "ms": ms, "plain_ms": plain_ms}
            if kname == "flash_attention_fwd_lse":
                entry.update(library_ms=library_fwd_ms, **forward_bounds(card, b, t, t, h, d, dtype_name, True),
                             tflops=fa.attention_flops(b, t, t, h, d) / ms / 1e9)
                if narrow:  # its device time, apart from the host's
                    entry["device_ms"] = device_time_ms(fwd_call)
            elif kname == "flash_attention_split_f32":  # q, k, v (and dO) read in fp32, three bf16 parts written
                n_elements = len(split_inputs) * b * t * h * d
                entry.update(library_ms=None, bound_ms=split_bound_ms(card, n_elements), bound_by="bytes",
                             gb_per_s=n_elements * 10 / ms / 1e6, **split_ms)
            else:
                flop, nbytes = work[kname]
                t_ops, t_bytes = flop * passes / bf16_peak * 1e3, nbytes / mem_bw * 1e3
                entry.update(library_ms=library_bwd_ms, bound_ms=max(t_ops, t_bytes),
                             bound_by="operations" if t_ops >= t_bytes else "bytes", tflops=flop / ms / 1e9)
                if fp32:
                    entry["ffma_bound_ms"] = max(flop / f32_peak * 1e3, t_bytes)
            kernels[kname] = entry
        row = {
            "phase": "train_kernel_check", "phase_id": phase_id, "shape": name, "b_t_h_d": [b, t, h, d],
            "dtype": dtype_name,
            "max_abs_err": errs, "plain_err": plain_errs, "tol": tols, "kernels": kernels,
            "backward_ms": (times["flash_attention_bwd_dq"][0] + times["flash_attention_bwd_dkv"][0]
                            + split_ms.get("bwd_split_ms", 0.0)),
            "backward_bound_ms": bwd_bound_ms, "library_bwd_ms": library_bwd_ms, "bwd_lse_ms": bwd_lse_ms,
            "per_step": per_step, "card": card["name"], "power_limit": card["power_limit"],
        }
        if fp32:
            row.update(fp32_tol=fp32_tols, split_bitwise=split_bitwise,
                       backward_ffma_bound_ms=max(fa.attention_bwd_flops(b, t, t, h, d) / f32_peak,
                                                  fa.attention_bwd_bytes(b, t, t, h, d, item) / mem_bw) * 1e3)
        emit(row)
        bad = {key: (errs[key], tols[key]) for key in outs if not errs[key] <= tols[key]}
        bad.update({f"{key} (fp32 rule)": (errs[key], fp32_tols[key]) for key in FP32_RULE_OUTPUTS
                    if fp32 and not errs[key] <= fp32_tols[key]})
        if split_bitwise is False:
            bad["split"] = "the split kernel's parts differ from its plain version's"
        if not finite or bad:
            raise AssertionError(f"training kernels disagree with their plain versions at {name}: {bad}")
        rows.append(row)
        del qkv, q, k, v, do, o, lse, delta, dq, dk, dv, outs
        if fp32:
            del parts, fwd_parts, outs_dq, outs_dkv
        torch.cuda.empty_cache()
    return rows


# Phases 3c and 3d: (phase, name, T, kernel, TPU kernel replaced, the count of
# launches its row stands for in the kernels line, or None: a per_shape entry of
# the row that has one). The 16-view global layer has 16·1369 + 1 = 21905 tokens;
# a ring step attends the 16 views' 21904 grid tokens (inference) or 4 views'
# 5476 (the train step), the scale token merged apart. Phase 3d: K3 at the
# 64-view global layer, 64·1369 + 1 = 87617 tokens (phase 13's launches by length).
LONG_SHAPES = [
    ("3c", "k3_global_16_views", 21905, "flash_attention_fwd", f"{FA}:164", "k3_per_forward"),
    ("3c", "k7_ring_16_views", 21904, "flash_attention_fwd_lse", f"{FA}:168", "k7_per_forward"),
    ("3c", "k7_ring_4_views", 5476, "flash_attention_fwd_lse", f"{FA}:168", None),
    ("3d", "k3_global_64_views", 87617, "flash_attention_fwd", f"{FA}:164", "by_length"),
]
ROW_SLICE = 2048  # query rows held to the plain version: the first and the last 1024
# Query rows × key tokens of one plain chunk: 2048 rows at 21905 tokens, 512 at
# 87617 (fp32 logits of 12 heads: 2.2 GB; 2048 rows there would be 8.6 GB).
PLAIN_SLAB = ROW_SLICE * 21905


def plain_by_rows(fn, q, *rest, rows: int = ROW_SLICE):
    """A plain attention function over every query row, ``rows`` at a time
    (attention is independent row by row; all rows at once need ~23 GB of
    fp32 logits at 21905 tokens)."""
    import torch

    outs = [fn(q[:, i:i + rows], *rest) for i in range(0, q.shape[1], rows)]
    if isinstance(outs[0], tuple):
        return torch.cat([o[0] for o in outs], 1), torch.cat([o[1] for o in outs], 2)
    return torch.cat(outs, 1)


def long_forward_check(card, phase_id, name, t, kname, replaces, launches_key, plain_iters: int = 2):
    """One forward row of phases 3c, 3d and 35: the kernel at 1 x t x 12 x 64 (bf16) against
    its plain version on ROW_SLICE query rows (the first and the last half); kernel, plain
    (over every row, in chunks), library and bound times."""
    import torch
    import torch.nn.functional as F

    from mapanything_tpu_torch.ops import flash_attention as fa

    bf16_peak, _, mem_bw = peaks_for(card["name"])
    b, h, d = 1, 12, 64
    scale = d**-0.5
    gen = torch.Generator(device="cuda").manual_seed(3)
    qkv = torch.randn(b, t, 3, h, d, device="cuda", generator=gen).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    sl = torch.cat([torch.arange(ROW_SLICE // 2), torch.arange(t - ROW_SLICE // 2, t)]).cuda()
    chunk = min(ROW_SLICE, PLAIN_SLAB // t)
    with_lse = kname.endswith("lse")
    if with_lse:
        o, lse = fa.flash_attention_lse(q, k, v, scale)
        o_e, lse_e = plain_by_rows(fa.attention_lse_reference, q[:, sl].float(), k.float(), v.float(), scale,
                                   rows=chunk)
        o_p, lse_p = plain_by_rows(fa.attention_lse_reference, q[:, sl], k, v, scale, rows=chunk)
        outs = {"o": (o[:, sl], o_e, o_p), "lse": (lse[:, :, sl], lse_e, lse_p)}
        fn, plain_fn = fa.flash_attention_lse, fa.attention_lse_reference
    else:
        o = fa.flash_attention(q, k, v, scale)
        exact = plain_by_rows(fa.attention_reference, q[:, sl].float(), k.float(), v.float(), scale, rows=chunk)
        outs = {"o": (o[:, sl], exact, plain_by_rows(fa.attention_reference, q[:, sl], k, v, scale, rows=chunk))}
        fn, plain_fn = fa.flash_attention, fa.attention_reference
    torch.cuda.synchronize()
    errs = {key: max_err(x, e) for key, (x, e, _) in outs.items()}
    plain_errs = {key: max_err(pl, e) for key, (_, e, pl) in outs.items()}
    tols = {key: tolerance(plain_errs[key], e) for key, (_, e, _) in outs.items()}
    finite = all(bool(torch.isfinite(x).all()) for x, _, _ in outs.values())
    del outs
    torch.cuda.empty_cache()
    ms = cuda_time_ms(lambda: fn(q, k, v, scale), iters=10)
    plain_ms = cuda_time_ms(lambda: plain_by_rows(plain_fn, q, k, v, scale, rows=chunk), iters=plain_iters, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), iters=10)
    flop = fa.attention_flops(b, t, t, h, d)
    nbytes = fa.attention_bytes(b, t, t, h, d, 2) + (4 * b * h * t if with_lse else 0)
    t_ops, t_bytes = flop / bf16_peak * 1e3, nbytes / mem_bw * 1e3
    row = {
        "phase": "long_kernel_check", "phase_id": phase_id, "shape": name, "launches_key": launches_key,
        "kernel": kname, "b_t_h_d": [b, t, h, d], "dtype": "bfloat16", "replaces": replaces,
        "rows_checked": ROW_SLICE, "plain_rows_per_chunk": chunk,
        "max_abs_err": errs, "plain_err": plain_errs, "tol": tols,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "tflops": flop / ms / 1e9, "card": card["name"], "power_limit": card["power_limit"],
    }
    emit(row)
    bad = {key: (errs[key], tols[key]) for key in errs if not errs[key] <= tols[key]}
    if not finite or bad:
        raise AssertionError(f"{kname} disagrees with its plain version at {name}: {bad}")
    del qkv, q, k, v, o
    torch.cuda.empty_cache()
    return row


def long_kernel_checks(card):
    """Phases 3c and 3d: the forward kernels at K3's and K7's lengths, dq and
    dk/dv against a merged lse; kernel, plain, library and bound times."""
    import torch
    import torch.nn.functional as F

    from mapanything_tpu_torch.ops import flash_attention as fa
    from mapanything_tpu_torch.parallel.sharded_attention import _block_attn_lse, _merge_lse

    bf16_peak, _, mem_bw = peaks_for(card["name"])
    b, h, d = 1, 12, 64
    scale = d**-0.5
    rows = [long_forward_check(card, *shape) for shape in LONG_SHAPES]

    # dq and dk/dv at the 4-view ring block, fed the lse of the ring's forward:
    # the kernel's own lse merged with a 1-token extra block (the scale token).
    t = 5476
    gen = torch.Generator(device="cuda").manual_seed(4)
    qkv = torch.randn(b, t, 3, h, d, device="cuda", generator=gen).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    ke, ve = torch.randn(2, b, 1, h, d, device="cuda", generator=gen).to(torch.bfloat16)
    do = torch.randn(b, t, h, d, device="cuda", generator=gen).to(torch.bfloat16)

    extra = _block_attn_lse(q, ke, ve, scale)  # the dense fp32 branch, as the ring runs it

    def merged(o_g, lse_g):  # the ring's forward output and its global lse
        o, lse = _merge_lse([(o_g.float(), lse_g), extra])
        return o.to(o_g.dtype), lse.contiguous()

    o, lse = merged(*fa.flash_attention_lse(q, k, v, scale))
    delta = fa.attention_bwd_delta(o, do).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    xf = [x.float() for x in (q, k, v, do)]
    o_x, lse_x = merged(*fa.attention_lse_reference(*xf[:3], scale))
    delta_x = fa.attention_bwd_delta(o_x, xf[3])
    exact = {"dq": fa.attention_bwd_dq_reference(*xf, lse_x, delta_x, scale)}
    exact["dk"], exact["dv"] = fa.attention_bwd_dkv_reference(*xf, lse_x, delta_x, scale)
    o_p, lse_p = merged(*fa.attention_lse_reference(q, k, v, scale))
    delta_p = fa.attention_bwd_delta(o_p, do)
    plain = {"dq": fa.attention_bwd_dq_reference(q, k, v, do, lse_p, delta_p, scale)}
    plain["dk"], plain["dv"] = fa.attention_bwd_dkv_reference(q, k, v, do, lse_p, delta_p, scale)
    got = {"dq": dq, "dk": dk, "dv": dv}
    errs = {key: max_err(got[key], exact[key]) for key in got}
    plain_errs = {key: max_err(plain[key], exact[key]) for key in got}
    tols = {key: tolerance(plain_errs[key], exact[key]) for key in got}
    finite = all(bool(torch.isfinite(x).all()) for x in got.values())
    del exact, plain, xf
    torch.cuda.empty_cache()
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
    library_bwd_ms = cuda_time_ms(
        lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), iters=10)
    del sdpa_out, qt, kt, vt
    bwd_lse_ms = cuda_time_ms(lambda: fa.flash_attention_bwd_lse(q, k, v, o, lse, do, scale), iters=10)
    io_stats = 2 * 4 * b * h * t
    kernels = {}
    for kname, fn, plain_fn, flop, nbytes in (
        ("flash_attention_bwd_dq", fa.flash_attention_bwd_dq, fa.attention_bwd_dq_reference,
         4 * b * h * t * t * d, 5 * b * t * h * d * 2 + io_stats),
        ("flash_attention_bwd_dkv", fa.flash_attention_bwd_dkv, fa.attention_bwd_dkv_reference,
         6 * b * h * t * t * d, 6 * b * t * h * d * 2 + io_stats),
    ):
        ms = cuda_time_ms(lambda: fn(q, k, v, do, lse, delta, scale), iters=10)
        plain_ms = cuda_time_ms(lambda: plain_fn(q, k, v, do, lse, delta, scale), iters=2, warmup=1)
        t_ops, t_bytes = flop / bf16_peak * 1e3, nbytes / mem_bw * 1e3
        kernels[kname] = {"replaces": TRAIN_REPLACES[kname]["encoder"], "ms": ms, "plain_ms": plain_ms,
                          "library_ms": library_bwd_ms, "bound_ms": max(t_ops, t_bytes),
                          "bound_by": "operations" if t_ops >= t_bytes else "bytes", "tflops": flop / ms / 1e9}
    row = {"phase": "long_kernel_check", "shape": "ring_bwd_4_views_merged_lse", "b_t_h_d": [b, t, h, d],
           "dtype": "bfloat16", "max_abs_err": errs, "plain_err": plain_errs, "tol": tols, "kernels": kernels,
           "library_bwd_ms": library_bwd_ms, "bwd_lse_ms": bwd_lse_ms, "card": card["name"],
           "power_limit": card["power_limit"]}
    emit(row)
    bad = {key: (errs[key], tols[key]) for key in errs if not errs[key] <= tols[key]}
    if not finite or bad:
        raise AssertionError(f"dq or dk/dv disagree with their plain versions against a merged lse: {bad}")
    del qkv, q, k, v, do, o, lse, delta, dq, dk, dv
    torch.cuda.empty_cache()
    return rows, row


PRED_FIELDS = ("pts3d", "pts3d_cam", "ray_directions", "depth_along_ray", "cam_trans",
               "cam_quats", "metric_scaling_factor", "conf", "non_ambiguous_mask_logits")


def small_config(trunk_heads=None):
    """MapAnythingConfig.small(), with ``trunk_heads`` trunk heads if given (phase 14)."""
    from mapanything_tpu_torch.models.mapanything import MapAnythingConfig

    return MapAnythingConfig.small(**({} if trunk_heads is None else {"info_sharing_num_heads": trunk_heads}))


def check_head_dim_launches(counts_by_d: dict, head_dim: int, kernels) -> None:
    """Phase 14: each of ``kernels`` launched its ``head_dim`` instance."""
    missing = [k for k in kernels if not counts_by_d[k].get(head_dim)]
    if missing:
        raise AssertionError(f"no D = {head_dim} launch of {missing}: {counts_by_d}")


def slice_check(trunk_heads=None):
    """Phase 4 (phase 14 with ``trunk_heads``): the small model in fp32, the same
    seeded weights on cuda and cpu."""
    import torch

    from mapanything_tpu_torch.models.mapanything import MapAnything, Views
    from mapanything_tpu_torch.ops.flash_attention import launch_shapes, reset_launch_counts

    cfg = small_config(trunk_heads)
    img = torch.from_numpy(np.random.RandomState(0).randn(1, 2, 56, 56, 3).astype(np.float32))
    # Full fp32 on the card for this comparison (cuDNN convolutions default to
    # TF32); the flagship phase then runs with PyTorch's defaults again.
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        reset_launch_counts()
        with torch.inference_mode():
            on_gpu = MapAnything(cfg, device="cuda", seed=0)(Views(img=img.cuda()))
        torch.cuda.synchronize()
        shapes = launch_shapes()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    with torch.inference_mode():
        on_cpu = MapAnything(cfg, device="cpu", seed=0)(Views(img=img))
    # fp32 on both; sums are taken in other orders on the card, so the
    # tolerance is relative to each field's magnitude.
    rtol = 1e-3
    errs = {}
    for field in PRED_FIELDS:
        a, b = getattr(on_gpu, field).cpu(), getattr(on_cpu, field)
        err = (a - b).abs().max().item()
        errs[field] = err
        if not err <= rtol * max(1.0, b.abs().max().item()):
            raise AssertionError(f"cuda and cpu disagree on {field}: {err}")
    agree = (on_gpu.non_ambiguous_mask.cpu() == on_cpu.non_ambiguous_mask).float().mean().item()
    if agree < 0.999:
        raise AssertionError(f"non_ambiguous_mask agrees on only {agree:.4f} of pixels")
    emit({"phase": "slice_check" if trunk_heads is None else "slice_check_h128",
          "config": f"small{'' if trunk_heads is None else f'(info_sharing_num_heads={trunk_heads})'} fp32 1x2x56x56",
          "rtol": rtol, "max_abs_err": errs, "mask_agreement": agree, "cuda_launches": shape_counts(shapes)})
    if trunk_heads is not None:
        check_head_dim_launches(by_head_dim(shapes), cfg.info_sharing_dim // trunk_heads, ["flash_attention_fwd"])


def check_invariants(preds, shape):
    """Phase 5's checks of a flagship forward's outputs."""
    import torch

    B, V, H, W = shape
    for f in PRED_FIELDS:
        if not bool(torch.isfinite(getattr(preds, f)).all()):
            raise AssertionError(f"non-finite {f}")
    if tuple(preds.pts3d.shape) != (B, V, H, W, 3) or tuple(preds.conf.shape) != (B, V, H, W):
        raise AssertionError(f"unexpected shapes {tuple(preds.pts3d.shape)}, {tuple(preds.conf.shape)}")
    ray_norm_err = (preds.ray_directions.norm(dim=-1) - 1).abs().max().item()
    if ray_norm_err > 1e-4:
        raise AssertionError(f"|ray_directions| deviates from 1 by {ray_norm_err}")
    if preds.conf.min().item() < 1.0:
        raise AssertionError("confidence below 1")
    if not torch.allclose(preds.pts3d_cam, preds.ray_directions * preds.depth_along_ray, rtol=1e-5, atol=1e-6):
        raise AssertionError("pts3d_cam != ray_directions * depth_along_ray")
    return ray_norm_err


def flagship_config(trunk_heads: int, compute_dtype: str = "bfloat16"):
    """The flagship config in bf16; with trunk_heads=6, flagship-h128 (768 / 6 = 128); with
    compute_dtype="float32", the config's default dtype (phase 17)."""
    from mapanything_tpu_torch.models.mapanything import MapAnythingConfig

    return MapAnythingConfig(compute_dtype=compute_dtype, info_sharing_num_heads=trunk_heads)


def flagship(card, trunk_heads: int = 12, compute_dtype: str = "bfloat16", kernel_rows=None):
    """Phase 5: the main path, the flagship bf16 forward on 1 x 8 x 518 x 518;
    phase 15 with trunk_heads=6: flagship-h128; phase 18 with compute_dtype="float32":
    the forward at the config's default dtype, which launches the fp32 forward and its
    split pass (their share of the forward from phase 3's ``kernel_rows``, where given).
    Returns the lse-free launches, ms per forward, the launches by head dim and every
    kernel's launch count of one forward."""
    import torch

    from mapanything_tpu_torch.models.mapanything import MapAnything, Views
    from mapanything_tpu_torch.ops.flash_attention import (
        flash_attention, launch_counts, launch_shapes, reset_launch_counts,
    )

    B, V, H, W = 1, 8, 518, 518
    warmup, iters = 3, 5
    fp32 = compute_dtype == "float32"
    t0 = time.perf_counter()
    cfg = flagship_config(trunk_heads, compute_dtype)
    d = cfg.info_sharing_dim // trunk_heads
    model = MapAnything(cfg, device="cuda", seed=0)
    setup_s = time.perf_counter() - t0
    img = torch.from_numpy(np.random.RandomState(0).randn(B, V, H, W, 3).astype(np.float32)).cuda()
    views = Views(img=img)

    reset_launch_counts()
    with torch.inference_mode():
        preds = model(views)
    torch.cuda.synchronize()
    counts, shapes = launch_counts(), launch_shapes()
    launches = counts["flash_attention_fwd"]
    # In fp32 a split pass before each forward launch.
    want = {"flash_attention_fwd": 48, "flash_attention_fwd_lse": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "flash_attention_split_f32": 48 if fp32 else 0}
    if not counts_match(counts, want):
        raise AssertionError(f"one flagship forward launched {counts}, not {want}")
    # The encoder's 24 layers at D = 64; the trunk's 12 frame and 12 global layers at D.
    want_shapes = {(1370, 64): 24, (1369, d): 12, (V * 1369 + 1, d): 12}
    for k in ("flash_attention_fwd", "flash_attention_split_f32") if fp32 else ("flash_attention_fwd",):
        if shapes[k] != want_shapes:
            raise AssertionError(f"one forward launched {k} {shapes[k]} times by (Tk, D), not {want_shapes}")
    with torch.inference_mode():
        for _ in range(warmup - 1):
            model(views)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = flash_attention.launches
        times = []
        for _ in range(iters):
            t = time.perf_counter()
            preds = model(views)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
    if flash_attention.launches - before != 48 * iters:
        raise AssertionError("the attention kernel did not run 48 times per forward")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    ray_norm_err = check_invariants(preds, (B, V, H, W))
    ms = 1e3 * sum(times) / iters
    line = {
        "phase": "flagship_fp32" if fp32 else "flagship" if trunk_heads == 12 else "flagship_h128",
        "config": f"MapAnythingConfig({'' if fp32 else 'compute_dtype=' + repr(compute_dtype)}"
                  f"{'' if trunk_heads == 12 else f', info_sharing_num_heads={trunk_heads}'}), 1x8x518x518, "
                  "seeded random weights",
        "setup_s": setup_s,
        "warmup": warmup,
        "iters": iters,
        "ms_per_forward": ms,
        "ms_each": [1e3 * t for t in times],
        "views_per_s": B * V / (ms / 1e3),
        "peak_mem_gib": peak_gib,
        "attention_launches_per_forward": launches,
        "launches_per_forward": counts,
        "launches_by_shape": shape_counts(shapes)["flash_attention_fwd"],
        "launches_by_head_dim": by_head_dim(shapes)["flash_attention_fwd"],
        "ray_norm_err": ray_norm_err,
        "card": card["name"],
        "power_limit": card["power_limit"],
    }
    if kernel_rows:  # each fp32 kernel's time a forward: phase 3's ms per call x launches
        rows = [r for r in kernel_rows if r["dtype"] == compute_dtype and r["per_forward"]]
        per_forward = {"flash_attention_fwd": sum(r["ms"] * r["per_forward"] for r in rows),
                       "flash_attention_split_f32": sum(r["split_ms"] * r["per_forward"] for r in rows)}
        line.update(kernel_ms_per_forward=per_forward,
                    kernel_share_of_forward={k: v / ms for k, v in per_forward.items()})
    emit(line)
    return launches, ms, by_head_dim(shapes)["flash_attention_fwd"], counts


# InferenceOutputs' float fields; the masked ones are zero wherever the mask is off.
INFER_FIELDS = ("pts3d", "pts3d_cam", "ray_directions", "depth_along_ray", "depth_z", "intrinsics",
                "camera_poses", "cam_trans", "cam_quats", "metric_scaling_factor", "img_no_norm", "conf")
MASKED_FIELDS = ("pts3d", "pts3d_cam", "depth_along_ray", "depth_z")
# Phase 11: head_chunk_size=1 against unchunked on cuda, of each field's magnitude,
# fp32 with TF32 off. An H100 read exactly 0 (the same convolution algorithms at
# batch 1 and 2); on the CPU, where oneDNN picks by batch size, the two differ by
# up to 2.9e-5 on unit ray directions (tests/test_torch_port_infer.py).
CHUNK_RTOL = 1e-5
# Phases 12 and 13: the largest mean |difference| of each field between the bf16
# infer with the dense head over chunks and unchunked (masks off). Twice the
# reading of phase 12 on an H100 (chunks of 2 of 8 views), which repeats to every
# digit between runs: 4.95e-3, 5.02e-3, 2.25e-3, 7.00e-3, 1.20e-2. The pose and
# scale heads run once over all views either way, so their outputs must not move.
CHUNK_MEAN_DIFF_LIMITS = {
    "pts3d": 0.011, "pts3d_cam": 0.011, "ray_directions": 0.005, "depth_along_ray": 0.015, "conf": 0.025,
    "cam_trans": 0.0, "cam_quats": 0.0, "metric_scaling_factor": 0.0,
}


def with_head_chunks(model, chunk):
    """The same model (and weights) with the dense head over chunks of ``chunk`` views."""
    model.config = dataclasses.replace(model.config, head_chunk_size=chunk)
    return model


def infer_slice_check():
    """Phase 11: the small fp32 infer on cuda against cpu, images only (with the
    confidence mask) and with intrinsics, z-depth and 4x4 poses; then
    head_chunk_size=1 against unchunked on cuda."""
    import torch

    from mapanything_tpu_torch.geometry.quaternion import quats_trans_to_pose_matrix
    from mapanything_tpu_torch.models.mapanything import MapAnything, MapAnythingConfig
    from mapanything_tpu_torch.utils.inference import PostprocessConfig, infer, preprocess_inputs_for_inference

    B, V, S = 1, 2, 56
    rng = np.random.RandomState(11)
    quats = rng.randn(B, V, 4)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    K = np.tile(np.float32([[60, 0, 27.5], [0, 64, 26.0], [0, 0, 1]]), (B, V, 1, 1))
    inputs = {
        "images_only": (dict(), PostprocessConfig(apply_confidence_mask=True)),
        "intrinsics_depth_poses": (dict(
            intrinsics=K,
            depth_z=rng.uniform(0.5, 4.0, (B, V, S, S)).astype(np.float32),
            camera_poses=quats_trans_to_pose_matrix(torch.from_numpy(quats).float(),
                                                    torch.from_numpy(rng.randn(B, V, 3)).float()).numpy(),
        ), PostprocessConfig()),
    }
    images = rng.uniform(0, 1, (B, V, S, S, 3)).astype(np.float32)
    models = {dev: MapAnything(MapAnythingConfig.small(), device=dev, seed=0, geometric_inputs=True)
              for dev in ("cuda", "cpu")}
    rtol = 1e-3  # phase 4's: fp32 on both, sums in other orders on the card
    line = {"phase": "infer_slice_check", "config": "small fp32 1x2x56x56", "rtol": rtol}
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for name, (modalities, post) in inputs.items():
            outs = {dev: infer(m, images, post, **modalities) for dev, m in models.items()}
            gpu, cpu = outs["cuda"], outs["cpu"]
            if gpu.pts3d.device.type != "cuda":
                raise AssertionError(f"infer on a cuda model returned {gpu.pts3d.device} tensors")
            both = (gpu.mask.cpu() == cpu.mask)
            agree = both.float().mean().item()
            errs = {}
            for f in INFER_FIELDS:
                a, b = getattr(gpu, f).cpu(), getattr(cpu, f)
                if f in MASKED_FIELDS:  # a threshold can flip a pixel: compare where both masks agree
                    a, b = a * both, b * both
                errs[f] = rel_err(a, b, 1.0)
            line[name] = {"max_err_over_magnitude": errs, "mask_agreement": agree,
                          "mask_kept": cpu.mask.float().mean().item()}
            bad = {f: e for f, e in errs.items() if not e <= rtol}
            if bad or agree < 0.999:
                raise AssertionError(f"infer {name}: cuda and cpu disagree: {bad}, masks agree on {agree:.5f}")
        gpu_model = models["cuda"]
        with torch.inference_mode():
            views = preprocess_inputs_for_inference(torch.from_numpy(images).cuda())
            whole = gpu_model(views)
            chunked = with_head_chunks(gpu_model, 1)(views)
            with_head_chunks(gpu_model, None)
        chunk_errs = {f: rel_err(getattr(chunked, f), getattr(whole, f), 1.0) for f in PRED_FIELDS}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    line.update(chunk_rtol=CHUNK_RTOL, chunk_1_vs_unchunked=chunk_errs)
    emit(line)
    bad = {f: e for f, e in chunk_errs.items() if not e <= CHUNK_RTOL}
    if bad:
        raise AssertionError(f"head_chunk_size=1 differs from the unchunked forward: {bad}")


def check_infer_outputs(out, shape):
    """Phases 12 and 13: finite outputs of the expected shapes, cam2world
    poses with a [0, 0, 0, 1] bottom row and orthonormal rotations, zeros
    wherever the mask is off, finite recovered intrinsics. Returns figures
    for the phase's line."""
    import torch

    B, V, H, W = shape
    for f in INFER_FIELDS:
        if not bool(torch.isfinite(getattr(out, f)).all()):
            raise AssertionError(f"non-finite {f}")
    want = {"pts3d": (B, V, H, W, 3), "depth_z": (B, V, H, W, 1), "intrinsics": (B, V, 3, 3),
            "camera_poses": (B, V, 4, 4), "img_no_norm": (B, V, H, W, 3), "conf": (B, V, H, W)}
    got = {f: tuple(getattr(out, f).shape) for f in want}
    if got != want:
        raise AssertionError(f"unexpected shapes {got}")
    bottom = out.camera_poses[..., 3, :]
    if not torch.equal(bottom, torch.tensor([0.0, 0.0, 0.0, 1.0], device=bottom.device).expand_as(bottom)):
        raise AssertionError("camera_poses' bottom row is not [0, 0, 0, 1]")
    rot = out.camera_poses[..., :3, :3].double()
    orth_err = (rot @ rot.transpose(-1, -2) - torch.eye(3, dtype=rot.dtype, device=rot.device)).abs().max().item()
    if orth_err > 1e-5:
        raise AssertionError(f"camera rotations deviate from orthonormal by {orth_err}")
    mask = out.mask
    if mask is None or mask.shape != (B, V, H, W, 1):
        raise AssertionError("no combined mask")
    for f in MASKED_FIELDS:
        if bool(((getattr(out, f) != 0) & ~mask).any()):
            raise AssertionError(f"{f} is not zero where the mask is off")
    return {"orthonormal_err": orth_err, "mask_kept": mask.float().mean().item()}


def time_infer(model, images, post, warmup: int, iters: int):
    """(outputs, ms per call, each call's ms, peak GiB) of ``infer``."""
    import torch

    from mapanything_tpu_torch.utils.inference import infer

    for _ in range(warmup):
        infer(model, images, post)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        out = infer(model, images, post)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return out, sum(times) / iters, times, torch.cuda.max_memory_allocated() / 2**30


def flagship_infer(card, forward_ms: float):
    """Phase 12: the flagship bf16 infer on 1 x 8 x 518 x 518 (images already on
    the card), under the default PostprocessConfig and with the confidence
    mask; the postprocess alone beside phase 5's bare forward; head_chunk_size=2
    against unchunked."""
    import torch

    from mapanything_tpu_torch.models.mapanything import MapAnything, MapAnythingConfig
    from mapanything_tpu_torch.ops.flash_attention import launch_counts, reset_launch_counts
    from mapanything_tpu_torch.utils.inference import (
        PostprocessConfig,
        infer,
        postprocess_model_outputs_for_inference,
        preprocess_inputs_for_inference,
    )

    B, V, H, W = 1, 8, 518, 518
    model = MapAnything(MapAnythingConfig(compute_dtype="bfloat16"), device="cuda", seed=0)
    images = torch.from_numpy(np.random.RandomState(12).uniform(0, 1, (B, V, H, W, 3)).astype(np.float32)).cuda()
    reset_launch_counts()
    infer(model, images)
    torch.cuda.synchronize()
    counts = launch_counts()
    if not counts_match(counts, {"flash_attention_fwd": 48}):
        raise AssertionError(f"one flagship infer launched {counts}, not the lse-free forward 48 times")
    line = {"phase": "flagship_infer",
            "config": "MapAnythingConfig(compute_dtype='bfloat16'), 1x8x518x518, seeded random weights",
            "launches_per_infer": counts, "phase5_forward_ms": forward_ms}
    for name, post in (("default", PostprocessConfig()), ("confidence_mask", PostprocessConfig(apply_confidence_mask=True))):
        out, ms, each, peak = time_infer(model, images, post, warmup=2, iters=5)
        line[name] = {"ms_per_infer": ms, "ms_each": each, "views_per_s": B * V / (ms / 1e3), "peak_mem_gib": peak,
                      **check_infer_outputs(out, (B, V, H, W))}
        with torch.inference_mode():
            views = preprocess_inputs_for_inference(images)
            preds = model(views)
            post_ms = cuda_time_ms(lambda: postprocess_model_outputs_for_inference(preds, views, post), iters=5)
        line[name].update(postprocess_ms=post_ms, postprocess_share=post_ms / ms)
        del out, views, preds
    # The dense head over chunks of 2 views against unchunked, masks off: as the
    # model runs (bf16 DPT pyramid, TF32 on), then with TF32 off, then on a model
    # of the same weights with the pyramid in fp32 (TF32 off), which must read ~0:
    # the difference is the head's convolutions rounding otherwise at another batch.
    diffs = {"bf16_pyramid": chunk_diffs(model, images, 2)}
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        diffs["bf16_pyramid_tf32_off"] = chunk_diffs(model, images, 2)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        fp32_pyramid = MapAnything(MapAnythingConfig(compute_dtype="bfloat16", dpt_fusion_dtype="float32"),
                                   device="cuda", seed=0)
        diffs["fp32_pyramid_tf32_off"] = chunk_diffs(fp32_pyramid, images, 2)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    line.update(chunk_2_vs_unchunked=diffs, chunk_mean_abs_diff_limits=CHUNK_MEAN_DIFF_LIMITS,
                fp32_pyramid_rtol=CHUNK_RTOL, card=card["name"], power_limit=card["power_limit"])
    emit(line)
    bad = {f: x for f, x in diffs["bf16_pyramid"]["mean_abs_diff"].items() if not x <= CHUNK_MEAN_DIFF_LIMITS[f]}
    if bad:
        raise AssertionError(f"head_chunk_size=2 differs from unchunked beyond CHUNK_MEAN_DIFF_LIMITS: {bad}")
    bad = {f: x for f, x in diffs["fp32_pyramid_tf32_off"]["max_err_over_magnitude"].items() if not x <= CHUNK_RTOL}
    if bad:
        raise AssertionError(f"with the DPT pyramid in fp32, head_chunk_size=2 differs from unchunked: {bad}")
    return line


def chunk_diffs(model, images, chunk, unchunked=None):
    """The bf16 infer (masks off) with the dense head over chunks of ``chunk``
    views against unchunked (or the given unchunked outputs): each field's mean
    |difference| and its largest over the field's magnitude. Leaves the model
    unchunked."""
    from mapanything_tpu_torch.utils.inference import PostprocessConfig, infer

    unmasked = PostprocessConfig(apply_mask=False)
    whole = infer(with_head_chunks(model, None), images, unmasked) if unchunked is None else unchunked
    chunked = infer(with_head_chunks(model, chunk), images, unmasked)
    with_head_chunks(model, None)
    return {"mean_abs_diff": {f: (getattr(chunked, f) - getattr(whole, f)).abs().mean().item()
                              for f in CHUNK_MEAN_DIFF_LIMITS},
            "max_err_over_magnitude": {f: rel_err(getattr(chunked, f), getattr(whole, f))
                                       for f in CHUNK_MEAN_DIFF_LIMITS}}


def many_view_infer(card):
    """Phase 13: memory-efficient many-view inference, the flagship bf16 infer
    on 1 x 64 x 518 x 518 with head_chunk_size=8 (bench.py:315-316); then the
    unchunked infer, its time and peak memory, the chunked outputs held to it."""
    import torch

    from mapanything_tpu_torch.models.mapanything import MapAnything, MapAnythingConfig
    from mapanything_tpu_torch.ops.flash_attention import launch_counts, launch_lengths, reset_launch_counts
    from mapanything_tpu_torch.utils.inference import PostprocessConfig, infer

    B, V, H, W = 1, 64, 518, 518
    t = V * 1369 + 1
    model = MapAnything(MapAnythingConfig(compute_dtype="bfloat16", head_chunk_size=8), device="cuda", seed=0)
    images = torch.from_numpy(np.random.RandomState(13).uniform(0, 1, (B, V, H, W, 3)).astype(np.float32)).cuda()
    reset_launch_counts()
    infer(model, images)
    torch.cuda.synchronize()
    counts, lengths = launch_counts(), launch_lengths()
    # The encoder's 24 at 1370 tokens and the frame layers' 12 at 1369 (K1's regime);
    # the global layers' 12 at 64 views' tokens (K3's).
    if counts["flash_attention_fwd"] != 48 or lengths != {1369: 12, 1370: 24, t: 12} or any(
            n for k, n in counts.items() if k != "flash_attention_fwd"):
        raise AssertionError(f"one 64-view infer launched {counts}, by length {lengths}")
    out, ms, each, peak = time_infer(model, images, PostprocessConfig(), warmup=1, iters=3)
    line = {"phase": "many_view_infer",
            "config": "MapAnythingConfig(compute_dtype='bfloat16', head_chunk_size=8), 1x64x518x518, "
                      "seeded random weights",
            "launches_per_infer": counts, "lse_free_launches_by_length": {str(k): n for k, n in lengths.items()},
            "ms_per_scene": ms, "ms_each": each, "views_per_s": B * V / (ms / 1e3), "peak_mem_gib": peak,
            **check_infer_outputs(out, (B, V, H, W))}
    del out
    # Unchunked, masks off: what the chunks save (a call after the one held to the
    # chunked outputs, which warms it), and the chunked outputs against it.
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    whole = infer(with_head_chunks(model, None), images, PostprocessConfig(apply_mask=False))
    torch.cuda.synchronize()
    start = time.perf_counter()
    infer(model, images, PostprocessConfig(apply_mask=False))
    torch.cuda.synchronize()
    line["unchunked"] = {"ms_per_scene": 1e3 * (time.perf_counter() - start),
                         "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    diffs = chunk_diffs(model, images, 8, unchunked=whole)
    line.update(chunk_8_vs_unchunked=diffs, chunk_mean_abs_diff_limits=CHUNK_MEAN_DIFF_LIMITS,
                card=card["name"], power_limit=card["power_limit"])
    emit(line)
    bad = {f: x for f, x in diffs["mean_abs_diff"].items() if not x <= CHUNK_MEAN_DIFF_LIMITS[f]}
    if bad:
        raise AssertionError(f"head_chunk_size=8 differs from unchunked at 64 views beyond the limits: {bad}")
    return line


# Phase 19: the kernel at the demo's shapes, 8 views of 4:3 images in the 1.321
# bucket, 518 x 392 (37 x 28 = 1036 patches): (name, shape, dtype, launches per
# forward, the TPU kernel the JAX dispatch picks there: K1 up to 2048 tokens, K2 above).
FILES_SHAPES = [
    ("demo_encoder", (8, 1037, 16, 64), "bfloat16", 24, f"{FA}:395"),
    ("demo_frame", (8, 1036, 12, 64), "bfloat16", 12, f"{FA}:395"),
    ("demo_global", (1, 8 * 1036 + 1, 12, 64), "bfloat16", 12, f"{FA}:516"),
]
# Phase 20: the lse-free kernel at the Trainer's eval shapes (1 x 4 x 518), per eval forward.
EVAL_SHAPES = [
    ("eval_encoder", (4, 1370, 16, 64), "bfloat16", 24, f"{FA}:395"),
    ("eval_frame", (4, 1369, 12, 64), "bfloat16", 12, f"{FA}:395"),
    ("eval_global", (1, 5477, 12, 64), "bfloat16", 12, f"{FA}:516"),
]
FILES_VIEWS, FILES_HW = 8, (768, 1024)  # eight 1024 x 768 photographs


def reference_format(state: dict) -> dict:
    """A state dict as the reference's DDP training writes it: ``module.`` before every
    key, the DPT heads under their ``dense_head.0/.1`` names."""
    out = {}
    for k, v in state.items():
        for name, alias in (("dpt_feature_head.", "dense_head.0."), ("dpt_regressor_head.", "dense_head.1.")):
            if k.startswith(name):
                k = alias + k[len(name):]
        out["module." + k] = v
    return out


def check_scene_files(out: Path, views: int) -> dict:
    """The demo's four outputs exist and parse: the PLY's vertex count against its body,
    the GLB's magic, the COLMAP model's image count, the viewer's title."""
    from mapanything_tpu_torch.utils.colmap import read_model

    ply = (out / "scene.ply").read_bytes()
    head = ply[:ply.index(b"end_header\n") + len(b"end_header\n")]
    n = int(head.split(b"element vertex ")[1].split(b"\n")[0])
    if n == 0 or len(ply) - len(head) != 15 * n:
        raise AssertionError(f"scene.ply: {n} vertices for a body of {len(ply) - len(head)} bytes")
    glb = (out / "scene.glb").read_bytes()
    if glb[:4] != b"glTF" or int.from_bytes(glb[8:12], "little") != len(glb):
        raise AssertionError("scene.glb is not a glTF binary of its own length")
    cameras, images, points = read_model(out / "sparse", ".bin")
    if len(images) != views or len(cameras) != views or not points:
        raise AssertionError(f"sparse/: {len(cameras)} cameras, {len(images)} images, {len(points)} points")
    if f"{views}-view reconstruction".encode() not in (out / "viewer.html").read_bytes():
        raise AssertionError("viewer.html lacks its title")
    return {"ply_vertices": n, "glb_bytes": len(glb), "colmap_images": len(images), "colmap_points": len(points),
            "viewer_bytes": (out / "viewer.html").stat().st_size}


def write_demo_pngs(folder: Path) -> None:
    """The demo's FILES_VIEWS seeded 1024 x 768 PNGs (smooth structure plus noise, a new
    phase a view) into a new ``folder`` (an old one is removed)."""
    from mapanything_tpu_torch.utils.image import write_png

    shutil.rmtree(folder.parent, ignore_errors=True)
    folder.mkdir(parents=True)
    rng = np.random.default_rng(19)
    h, w = FILES_HW
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(FILES_VIEWS):
        base = 128 + 70 * np.sin(x / 37 + i)[..., None] * np.cos(y / 23 - i)[..., None]
        img = np.clip(base + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)
        write_png(folder / f"view_{i:02d}.png", img, filters=(0, 1, 2, 3, 4))


def files_to_scene(card):
    """Phase 19: from files to a scene, the flagship bf16 at full width. Eight seeded
    1024 x 768 PNGs (rows under every scanline filter) and a reference-format
    checkpoint of the seeded multimodal flagship (``module.`` prefix, ``dense_head``
    aliases), then the demo's path on the card: load_images (the 1.321 bucket,
    518 x 392), the checkpoint loaded strictly, infer, and scene.glb, scene.ply,
    sparse/ and viewer.html. Returns the kernel rows at its shapes and the lse-free
    launches by shape."""
    import torch

    from mapanything_tpu_torch.data.cropping import crop_resize_if_necessary
    from mapanything_tpu_torch.models.mapanything import MapAnything, Views
    from mapanything_tpu_torch.ops.flash_attention import launch_counts, launch_shapes, reset_launch_counts
    from mapanything_tpu_torch.tools import demo_images_only_inference as demo
    from mapanything_tpu_torch.utils.checkpoint import (
        canonical_keys, load_reference_checkpoint, load_reference_state_dict,
    )
    from mapanything_tpu_torch.utils.image import _fake_K, load_images, read_png
    from mapanything_tpu_torch.utils.inference import PostprocessConfig

    rows = kernel_checks(card, FILES_SHAPES, "19")
    work = ROOT / "build" / "files_to_scene"
    h, w = FILES_HW
    t0 = time.perf_counter()
    write_demo_pngs(work / "images")
    write_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    model = MapAnything(flagship_config(12), device="cpu", seed=0, geometric_inputs=True)
    saved = reference_format(model.state_dict())
    torch.save(saved, work / "flagship.pth")
    del model
    save_s = time.perf_counter() - t0
    ckpt_bytes = (work / "flagship.pth").stat().st_size

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = demo.parse_args(["--images", str(work / "images"), "--out", str(work / "out"),
                            "--checkpoint", str(work / "flagship.pth"), "--device", "cuda"])
    reset_launch_counts()
    result = demo.run(args)
    torch.cuda.synchronize()
    counts, shapes = launch_counts(), launch_shapes()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = {"flash_attention_fwd": 48, "flash_attention_fwd_lse": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "flash_attention_split_f32": 0}
    t = FILES_VIEWS * 1036 + 1
    want_shapes = {(1037, 64): 24, (1036, 64): 12, (t, 64): 12}
    if not counts_match(counts, want) or shapes["flash_attention_fwd"] != want_shapes:
        raise AssertionError(f"the demo launched {counts}, by (Tk, D) {shapes['flash_attention_fwd']}, "
                             f"not {want} and {want_shapes}")

    model, loaded, outputs = result["model"], result["loaded"], result["outputs"]
    shape = (1, FILES_VIEWS, 392, 518)
    if tuple(loaded["images"].shape) != shape[1:] + (3,) or loaded["true_shape"].tolist() != [[h, w]] * FILES_VIEWS:
        raise AssertionError(f"load_images gave {tuple(loaded['images'].shape)}, {loaded['true_shape'].tolist()}")
    # The weights are the file's, bitwise.
    own = model.state_dict()
    want_sd = canonical_keys(saved)
    if sorted(own) != sorted(want_sd) or not all(torch.equal(own[k].cpu(), want_sd[k]) for k in want_sd):
        raise AssertionError("the demo's model does not hold the checkpoint's weights bitwise")
    # The resize on the card against the same call on the CPU.
    on_cpu = load_images(str(work / "images"), device="cpu")
    levels = int(((loaded["images_no_norm"].cpu() - on_cpu["images_no_norm"]).abs() * 255).round().max())
    if levels > 1:
        raise AssertionError(f"the resize on the card is {levels} grey levels from the CPU's")
    infer_checks = check_infer_outputs(outputs, shape)
    files = check_scene_files(result["out"], FILES_VIEWS)
    with torch.inference_mode():  # the raw forward's invariants (not counted: read above)
        ray_norm_err = check_invariants(model(Views(img=loaded["images"][None])), shape)

    # Stage times, each on its own.
    paths = sorted((work / "images").iterdir())
    t0 = time.perf_counter()
    decoded = [read_png(p) for p in paths]
    decode_ms = 1e3 * (time.perf_counter() - t0) / len(paths)
    resize = lambda: [crop_resize_if_necessary(torch.from_numpy(d).cuda(), (518, 392), None, _fake_K(h, w))  # noqa
                      for d in decoded]
    resize()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resize()
    torch.cuda.synchronize()
    resize_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    load_reference_checkpoint(model, load_reference_state_dict(work / "flagship.pth"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    _, infer_ms, infer_each, _ = time_infer(model, loaded["images_no_norm"][None],
                                            PostprocessConfig(), warmup=1, iters=3)
    emit({
        "phase": "files_to_scene",
        "config": "MapAnythingConfig(compute_dtype='bfloat16'), geometric_inputs=True checkpoint (563.3M "
                  "parameters, reference format), 8 PNGs of 1024x768 -> 518x392, demo_images_only_inference",
        "write_pngs_s": write_s, "save_checkpoint_s": save_s, "checkpoint_bytes": ckpt_bytes,
        "decode_ms_per_view": decode_ms, "resize_ms_8_views": resize_ms, "checkpoint_load_s": load_s,
        "demo_stage_s": result["seconds"], "infer_ms": infer_ms, "infer_ms_each": infer_each,
        "export_ms": 1e3 * result["seconds"]["export"], "peak_mem_gib": peak_gib,
        "launches": counts, "launches_by_shape": shape_counts(shapes)["flash_attention_fwd"],
        "resize_card_vs_cpu_grey_levels": levels, "ray_norm_err": ray_norm_err, **infer_checks, **files,
        "card": card["name"], "power_limit": card["power_limit"],
    })
    del model, result, loaded, outputs, own, saved, want_sd
    shutil.rmtree(work, ignore_errors=True)
    by_shape = shapes["flash_attention_fwd"]
    return rows, {r["shape"]: by_shape[(r["b_t_h_d"][1], 64)] for r in rows}


def numpy_batch(B, V, H, W, seed) -> dict:
    """Phase 7's batch (bench.py's LossBatch and images) as a collated numpy batch."""
    from mapanything_tpu_torch.train.losses import synthetic_loss_batch

    b = synthetic_loss_batch(B, V, H, W, seed=seed)
    names = {"ray_directions": "ray_directions_cam"}
    out = {names.get(f.name, f.name): getattr(b, f.name).numpy() for f in dataclasses.fields(b)
           if getattr(b, f.name) is not None}
    out["img"] = np.random.RandomState(seed).randn(B, V, H, W, 3).astype(np.float32)
    return out


def trainer_run(trainer):
    """``trainer.train()`` with the launch counts and each accumulation group's and
    each save's time; returns the counts, the counts by shape and the times."""
    import torch

    from mapanything_tpu_torch.ops.flash_attention import launch_counts, launch_shapes, reset_launch_counts

    times = {"group": [], "save": []}

    def timed(fn, key):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            times[key].append(time.perf_counter() - t)
            return out
        return run

    trainer._run_accum_group = timed(trainer._run_accum_group, "group")
    trainer.ckpt.save = timed(trainer.ckpt.save, "save")
    trainer.ckpt_best.save = timed(trainer.ckpt_best.save, "save")
    reset_launch_counts()
    trainer.train()
    torch.cuda.synchronize()
    return launch_counts(), launch_shapes(), times


def trainer_phase(card):
    """Phase 20: the Trainer on the flagship multimodal bf16 at 1 x 4 x 518 (phase 7's
    model and batch recipe as collated numpy batches): one epoch of 4 train batches
    under accum_iter=2 (2 optimizer steps) and 1 eval batch, then a second Trainer on
    the same directory with epochs=2 that resumes at epoch 1, bitwise, and trains it.
    Returns the training launches, the micro-batches, the eval rows and launches."""
    import torch

    from mapanything_tpu_torch.models.mapanything import GeometricInputConfig, MapAnything
    from mapanything_tpu_torch.train.loop import Trainer, TrainLoopConfig

    eval_rows = kernel_checks(card, EVAL_SHAPES, "20")
    B, V, H, W = 1, 4, 518, 518
    out = ROOT / "build" / "trainer"
    shutil.rmtree(out, ignore_errors=True)
    train = [numpy_batch(B, V, H, W, seed) for seed in range(4)]
    test = [numpy_batch(B, V, H, W, 100)]
    # lr as phase 7's (a random init diverges at the production lr); seed 2 draws masks
    # that reach every geometric encoder within the epoch's 4 micro-batches.
    loop = dict(output_dir=str(out), accum_iter=2, lr=1e-7, min_lr=1e-8, warmup_epochs=0.0, print_freq=100, seed=2)
    geo = GeometricInputConfig()
    model = MapAnything(flagship_config(12), device="cuda", seed=0, geometric_inputs=True)
    names = [n for n, _ in model.named_parameters()]
    torch.cuda.reset_peak_memory_stats()
    first = Trainer(model, train, TrainLoopConfig(epochs=1, **loop), test_loader=test, geo_cfg=geo)
    counts1, shapes1, times1 = trainer_run(first)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # Per micro-batch: 48 of each training kernel (24 at 1370 tokens, 12 at 1369, 12 at
    # 4 * 1369 + 1); per eval forward: 48 lse-free at the same lengths.
    micro = len(train)
    lengths = {(1370, 64): 24, (1369, 64): 12, (5477, 64): 12}
    want = {"flash_attention_fwd": 48 * len(test), "flash_attention_fwd_lse": 48 * micro,
            "flash_attention_bwd_dq": 48 * micro, "flash_attention_bwd_dkv": 48 * micro,
            "flash_attention_split_f32": 0}
    want_shapes = {k: {s: n * want[k] // 48 for s, n in lengths.items()} for k in want if want[k]}

    def check_counts(counts, shapes, run):
        if not counts_match(counts, want) or any(shapes[k] != v for k, v in want_shapes.items()):
            raise AssertionError(f"Trainer run {run} launched {counts}, by shape {shape_counts(shapes)}, "
                                 f"not {want}")

    check_counts(counts1, shapes1, 1)
    state = first.state
    if state.step != 2 or state.opt_state.count != 2:
        raise AssertionError(f"one epoch of 4 batches under accum_iter=2 took {state.step} steps")
    norms = torch.stack(torch._foreach_norm([state.params[n].detach() for n in names]))
    if not bool(torch.isfinite(norms).all()):
        raise AssertionError("non-finite parameters after the first epoch")
    no_update = [n for n in names if not bool(state.opt_state.mu[n].any())]
    if no_update:  # the update before the add is lr·mu_hat/(sqrt(nu_hat)+eps): nonzero where mu is
        raise AssertionError(f"parameters without an update: {no_update}")
    if first.ckpt.all_steps() != [0] or first.ckpt_best.all_steps() != [0]:
        raise AssertionError(f"checkpoints {first.ckpt.all_steps()}, best {first.ckpt_best.all_steps()}")
    ckpt_bytes = (out / "checkpoints" / "0.pt").stat().st_size
    end = {"params": {n: state.params[n].detach().cpu() for n in names},
           "mu": {n: state.opt_state.mu[n].cpu() for n in names},
           "nu": {n: state.opt_state.nu[n].cpu() for n in names}}
    del first, state, model
    gc.collect()
    torch.cuda.empty_cache()

    # A fresh model (other seed) and Trainer on the same directory: it resumes.
    model = MapAnything(flagship_config(12), device="cuda", seed=1, geometric_inputs=True)
    t0 = time.perf_counter()
    second = Trainer(model, train, TrainLoopConfig(epochs=2, **loop), test_loader=test, geo_cfg=geo)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    s = second.state
    same = (second.start_epoch == 1 and s.opt_state.count == 2 and s.step == 2
            and all(torch.equal(s.params[n].detach().cpu(), end["params"][n]) for n in names)
            and all(torch.equal(s.opt_state.mu[n].cpu(), end["mu"][n]) for n in names)
            and all(torch.equal(s.opt_state.nu[n].cpu(), end["nu"][n]) for n in names))
    if not same:
        raise AssertionError(f"the resumed Trainer (start epoch {second.start_epoch}, count {s.opt_state.count}) "
                             "does not hold the first one's end state bitwise")
    del s, end
    gc.collect()
    counts2, shapes2, times2 = trainer_run(second)
    check_counts(counts2, shapes2, 2)
    if second.state.step != 4 or second.ckpt.all_steps() != [0, 1]:
        raise AssertionError(f"the resumed epoch took the Trainer to step {second.state.step}, "
                             f"checkpoints {second.ckpt.all_steps()}")
    log = [json.loads(x) for x in (out / "log.txt").read_text().splitlines()]
    if [x["epoch"] for x in log] != [0, 1] or not all(np.isfinite(x["train_loss"]) for x in log):
        raise AssertionError(f"log.txt: {log}")
    groups = times1["group"] + times2["group"]
    emit({
        "phase": "trainer",
        "config": "MapAnythingConfig(compute_dtype='bfloat16'), geometric_inputs=True, 1x4x518x518 bench.py "
                  "batches as numpy, TrainLoopConfig(accum_iter=2, lr 1e-7), 4 train + 1 eval batch an epoch; "
                  "epoch 0, then a resumed Trainer for epoch 1",
        "ms_per_optimizer_step": 1e3 * sum(groups[1:]) / len(groups[1:]),
        "ms_each_optimizer_step": [1e3 * t for t in groups],
        "save_s": times1["save"] + times2["save"], "resume_trainer_init_s": restore_s,
        "checkpoint_bytes": ckpt_bytes, "peak_mem_gib": peak_gib,
        "launches_run_1": counts1, "launches_run_2": counts2,
        "launches_by_shape_run_1": shape_counts(shapes1), "log": log,
        "card": card["name"], "power_limit": card["power_limit"],
    })
    launches = {k: counts1[k] + counts2[k] for k in counts1}
    eval_launches = {r["shape"]: sum(sh["flash_attention_fwd"][(r["b_t_h_d"][1], 64)] for sh in (shapes1, shapes2))
                     for r in eval_rows}
    del second, model
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(out, ignore_errors=True)
    return {"launches": launches, "micro_batches": 2 * micro, "eval_rows": eval_rows, "eval_launches": eval_launches}


# Phase 21: from disk to a trained step. The training kernels at the two extreme aspect
# ratios of 518_many_ar at 4 views (518 x 518 and 518 x 168: global 1 x 5477 and 1 x 1777,
# frame 4 x 1369 and 4 x 444); launches per micro-batch at each come from the run.
DATA_SHAPES = [
    ("data_global_5477", (1, 5477, 12, 64), "bfloat16", 0),
    ("data_global_1777", (1, 1777, 12, 64), "bfloat16", 0),
    ("data_frame_1369", (4, 1369, 12, 64), "bfloat16", 0),
    ("data_frame_444", (4, 444, 12, 64), "bfloat16", 0),
]
PAIR_MAX_TK = 12288  # the JAX dispatch's head-pair regime: 2048 < pad512(Tk) <= 12288 at D = 64 (bf16)


def jax_regime(t: int) -> str:
    """The TPU kernels the JAX dispatch takes for a bf16 D = 64 training layer of ``t`` keys."""
    return "pair" if 2048 < -(-t // 512) * 512 <= PAIR_MAX_TK else "single"


REGIME_REPLACES = {"pair": {"flash_attention_fwd_lse": f"{FA}:600", "flash_attention_bwd_dq": f"{FA}:715",
                            "flash_attention_bwd_dkv": f"{FA}:753"},
                   "single": {"flash_attention_fwd_lse": f"{FA}:118", "flash_attention_bwd_dq": f"{FA}:227",
                              "flash_attention_bwd_dkv": f"{FA}:262"}}
DATA_REPLACES = {name: {s[0]: REGIME_REPLACES[jax_regime(s[1][1])][name] for s in DATA_SHAPES}
                 for name in REGIME_REPLACES["pair"]}
DATA_FRAMES, DATA_HW, DATA_SAMPLES = 24, (768, 1024), 16
JPEG_FIXTURES = ROOT / "tests" / "data" / "jpeg"  # 1024 x 768, written by cv2 (the card's machine has none)


def write_wai_scenes(root: Path) -> dict:
    """Two synthetic ETH3D scenes of DATA_FRAMES 1024 x 768 frames with the port's writers:
    "scene_png" (PNG frames, 16-bit millimetre PNG depth) and "scene_jpg" (the committed
    JPEG fixtures, EXR depth); covisibility, scene_meta.json and the scene lists of the
    train and test splits. Returns
    a frame path of each format, for the decode timings."""
    from mapanything_tpu_torch.utils.exr import write_depth_exr
    from mapanything_tpu_torch.utils.image import write_png

    fixtures = sorted(JPEG_FIXTURES.glob("*.jpg"))
    if not fixtures:
        raise FileNotFoundError(f"no JPEG fixtures under {JPEG_FIXTURES}")
    rng = np.random.default_rng(21)
    h, w = DATA_HW
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    samples = {}
    for name, image_ext, depth_ext in (("scene_png", "png", "png"), ("scene_jpg", "jpg", "exr")):
        scene = root / "eth3d" / name
        for sub in ("images", "depth", "covisibility/v0"):
            (scene / sub).mkdir(parents=True)
        frames = []
        for i in range(DATA_FRAMES):
            image, depth_path = f"images/{i:04d}.{image_ext}", f"depth/{i:04d}.{depth_ext}"
            if image_ext == "png":
                base = 128 + 70 * np.sin(x / 37 + i)[..., None] * np.cos(y / 23 - i)[..., None]
                write_png(scene / image, np.clip(base + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8))
            else:
                shutil.copyfile(fixtures[i % len(fixtures)], scene / image)
            depth = (2.5 + 0.8 * np.sin(x / 90 + 0.3 * i) * np.cos(y / 70) + 0.002 * y).astype(np.float32)
            if depth_ext == "png":
                write_png(scene / depth_path, np.round(depth * 1000).astype(np.uint16))
            else:
                write_depth_exr(scene / depth_path, depth)
            pose = np.eye(4)
            angle = 0.03 * i
            pose[:3, :3] = [[np.cos(angle), 0, np.sin(angle)], [0, 1, 0], [-np.sin(angle), 0, np.cos(angle)]]
            pose[:3, 3] = [0.05 * i, 0.0, 0.01 * i]
            frames.append(dict(frame_name=f"{i:04d}", image=image, depth=depth_path, transform_matrix=pose.tolist()))
        meta = dict(frames=frames, fl_x=0.8 * w, fl_y=0.8 * w, cx=w / 2 - 0.5, cy=h / 2 - 0.5)
        (scene / "scene_meta.json").write_text(json.dumps(meta))
        covis = np.zeros((DATA_FRAMES, DATA_FRAMES), np.float32)
        for i in range(DATA_FRAMES):
            for j in range(max(0, i - 4), min(DATA_FRAMES, i + 5)):
                covis[i, j] = 1.0 if i == j else 1.0 - 0.15 * abs(i - j)
        np.save(scene / "covisibility" / "v0" / "pairwise.npy", covis)
        samples[image_ext] = [scene / f["image"] for f in frames[:4]]
        samples[depth_ext + "_depth"] = [scene / f["depth"] for f in frames[:4]]
    for split in ("train", "test"):  # phase 21 reads the train list, phase 34 the test list (ETH3D's default)
        (root / "meta" / split).mkdir(parents=True)
        np.save(root / "meta" / split / f"eth3d_scene_list_{split}.npy", np.array(["scene_png", "scene_jpg"]))
    return samples


def host_stage_ms(samples: dict) -> dict:
    """A view's host stages after its decode, on one intra-op thread as in a loader
    worker, on a PNG frame and its depth: the crop/resize to 518 x 518 (aug_crop's
    largest draw), the colour augmentation with each op applied, the pointmaps and
    rays; ms, the mean of 3 after one warm-up."""
    import torch

    from mapanything_tpu_torch.data import transforms
    from mapanything_tpu_torch.data.base_dataset import BaseDataset, pointmaps_and_rays_from_depth
    from mapanything_tpu_torch.utils.image import read_png

    img, depth = read_png(samples["png"][0]), read_png(samples["png_depth"][0], unchanged=True) / 1000.0
    h, w = DATA_HW
    K = np.array([[0.8 * w, 0, w / 2 - 0.5], [0, 0.8 * w, h / 2 - 0.5], [0, 0, 1]], np.float32)
    ds = BaseDataset.__new__(BaseDataset)
    ds.principal_point_centered, ds.aug_crop = False, 0
    rgb = np.asarray(img, np.float32) / 255.0
    stages = {
        "crop_resize": lambda: ds._crop_resize_if_necessary(img, (518 + 15, 518 + 15), depth.astype(np.float32), K),
        "colour_jitter_all_ops": lambda: transforms.color_jitter(rgb[:518, :518], np.random.default_rng(0),
                                                                 0.3, 0.4, 0.2, 0.1),
        "pointmaps_and_rays": lambda: pointmaps_and_rays_from_depth(depth[:518, :518].astype(np.float32), K,
                                                                    np.eye(4, dtype=np.float32)),
    }
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for name, fn in stages.items():
            fn()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            out[name] = 1e3 * (time.perf_counter() - t0) / 3
    finally:
        torch.set_num_threads(threads)
    return out


def data_path_phase(card):
    """Phase 21: from disk to a trained step. Two WAI scenes written to a temporary
    directory (write_wai_scenes), then tools/train.main on configs/train.yaml with the
    ETH3D train dataset of configs/dataset/eth3d_wai/train/default.yaml: 518_many_ar,
    4 views, colorjitter+grayscale+gaublur and aug_crop 16 as configured, 1 x 4 views a
    batch, one epoch of 16 samples, the flagship in bf16, host cores (at most 8) loader
    workers. Decode times by format, ms per sample in a worker, the loader alone, the
    Trainer's ms per optimizer step with its wait on the loader, launches per micro-batch
    by kernel and key length. The training kernels first against their plain versions at
    the extreme aspect ratios' shapes. Returns the rows and the run's launches by shape."""
    import os

    import torch

    from mapanything_tpu_torch.data import loader as loader_mod
    from mapanything_tpu_torch.ops.flash_attention import launch_counts, launch_shapes, reset_launch_counts
    from mapanything_tpu_torch.tools import train as train_tool
    from mapanything_tpu_torch.train.loop import Trainer
    from mapanything_tpu_torch.utils.config import load_config
    from mapanything_tpu_torch.utils.exr import read_depth_exr
    from mapanything_tpu_torch.utils.image import read_png
    from mapanything_tpu_torch.utils.jpeg import read_jpeg

    rows = train_kernel_checks(card, DATA_SHAPES, DATA_REPLACES, "21")
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="data_path_", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        samples = write_wai_scenes(work)
        write_s = time.perf_counter() - t0
        decoders = {"png_rgb": (read_png, samples["png"]), "jpeg": (read_jpeg, samples["jpg"]),
                    "png_16bit_depth": (lambda p: read_png(p, unchanged=True), samples["png_depth"]),
                    "exr_depth": (read_depth_exr, samples["exr_depth"])}
        decode_ms = {}
        for fmt, (read, paths) in decoders.items():
            times = []
            for path in paths:
                t0 = time.perf_counter()
                out = read(path)
                times.append(1e3 * (time.perf_counter() - t0))
                if out.shape[:2] != DATA_HW or not np.isfinite(out.astype(np.float32)).all():
                    raise AssertionError(f"{fmt}: {path} decoded to {out.shape} {out.dtype}")
            decode_ms[fmt] = times
        stage_ms = host_stage_ms(samples)

        workers = min(os.cpu_count() or 1, 8)
        overrides = [f"machine.root_data_dir={work}", f"machine.mapanything_dataset_metadata_dir={work / 'meta'}",
                     f"machine.root_experiments_dir={work / 'experiments'}",
                     "dataset.resolution_train=${dataset.resolution_options.518_many_ar}", "dataset.num_views=4",
                     "dataset.train.variable_num_views=false",
                     f"dataset.train_dataset={DATA_SAMPLES} @ ${{dataset.eth3d_wai.train.dataset_str}}",
                     "images_per_batch=4", f"num_workers={workers}", "model.compute_dtype=bfloat16",
                     "train_params.epochs=1", "train_params.warmup_epochs=0", "train_params.lr=1e-7",
                     "train_params.min_lr=1e-8"]  # phase 20's lr: a random init diverges at the production lr
        argv = ["--config", str(ROOT / "configs" / "train.yaml"), "--device", "cuda"]
        for o in overrides:
            argv += ["--override", o]
        cfg = load_config(ROOT / "configs" / "train.yaml", overrides=overrides)
        dsl = cfg["dataset"]["train_dataset"]
        if not dsl.startswith(f"{DATA_SAMPLES} @ ETH3DWAI(") or "transform='colorjitter+grayscale+gaublur'" not in dsl:
            raise AssertionError(f"the composed dataset DSL: {dsl}")

        # The loader alone, its workers timing each sample they load.
        timing = work / "worker_ms"
        timing.mkdir()
        get_item = loader_mod._Items.__getitem__

        def timed_item(self, tup):
            t = time.perf_counter()
            out = get_item(self, tup)
            with open(timing / f"{os.getpid()}.txt", "a") as f:
                f.write(f"{1e3 * (time.perf_counter() - t)}\n")
            return out

        loader = loader_mod.MultiViewDataLoader(train_tool.build_dataset(dsl), images_per_batch=4,
                                                num_workers=workers)
        loader.set_epoch(0)
        loader_mod._Items.__getitem__ = timed_item
        try:
            t0 = time.perf_counter()
            shapes_seen, first_s = [], None
            for batch in loader:
                first_s = first_s if first_s is not None else time.perf_counter() - t0
                shapes_seen.append(list(batch["img"].shape))
            loader_s = time.perf_counter() - t0
        finally:
            loader_mod._Items.__getitem__ = get_item
        sample_ms = [float(v) for f in timing.glob("*.txt") for v in f.read_text().split()]
        if len(shapes_seen) != DATA_SAMPLES or any(s[:2] != [1, 4] for s in shapes_seen) or len(sample_ms) != DATA_SAMPLES:
            raise AssertionError(f"the loader gave batches {shapes_seen}, {len(sample_ms)} timed samples")

        # The Trainer through the tool: each optimizer step and each wait on the loader timed.
        waits, steps = [], []
        run_group, loader_iter = Trainer._run_accum_group, loader_mod.MultiViewDataLoader.__iter__

        def timed_group(self, group):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = run_group(self, group)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t)
            return out

        def timed_iter(self):
            it = loader_iter(self)
            while True:
                t = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                waits.append(time.perf_counter() - t)
                yield batch

        Trainer._run_accum_group, loader_mod.MultiViewDataLoader.__iter__ = timed_group, timed_iter
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        try:
            t0 = time.perf_counter()
            trainer = train_tool.main(argv)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        finally:
            Trainer._run_accum_group, loader_mod.MultiViewDataLoader.__iter__ = run_group, loader_iter
        counts, shapes = launch_counts(), launch_shapes()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30

        state = trainer.state
        micro = DATA_SAMPLES
        if state.step != micro or len(steps) != micro:
            raise AssertionError(f"one epoch of {micro} batches took {state.step} optimizer steps")
        params = [p.detach() for p in state.params.values()]
        finite = bool(torch.isfinite(torch.stack(torch._foreach_norm(params))).all())
        if not finite:
            raise AssertionError("non-finite parameters after the epoch")
        want = {"flash_attention_fwd": 0, "flash_attention_fwd_lse": 48 * micro, "flash_attention_bwd_dq": 48 * micro,
                "flash_attention_bwd_dkv": 48 * micro, "flash_attention_split_f32": 0}
        if not counts_match(counts, want):
            raise AssertionError(f"the epoch launched {counts}, not {want}")
        by_length = {name: {f"{t}": n / micro for (t, d), n in sorted(per.items())} for name, per in shapes.items()}
        for r in rows:  # the checked shapes' launches in this run, per micro-batch
            b, t = r["b_t_h_d"][:2]
            r["per_step"] = shapes["flash_attention_fwd_lse"].get((t, 64), 0) / micro
            if not r["per_step"]:
                raise AssertionError(f"the epoch launched nothing at {r['shape']}")
        log = [json.loads(x) for x in (work / "experiments" / "train" / "log.txt").read_text().splitlines()]
        if [x["epoch"] for x in log] != [0] or not np.isfinite(log[0]["train_loss"]):
            raise AssertionError(f"log.txt: {log}")
        emit({
            "phase": "data_path",
            "config": "configs/train.yaml via tools/train.main: the flagship (configs/model/mapanything.yaml) in "
                      f"bf16, {DATA_SAMPLES} @ ETH3DWAI (configs/dataset/eth3d_wai/train/default.yaml): 518_many_ar, "
                      "4 views, colorjitter+grayscale+gaublur, aug_crop 16, 1 x 4 views a batch, lr 1e-7",
            "scenes": f"2 x {DATA_FRAMES} frames of {DATA_HW[1]} x {DATA_HW[0]}: PNG + 16-bit PNG depth, "
                      "JPEG + EXR depth",
            "write_scenes_s": write_s, "decode_ms_per_view": {k: float(np.mean(v)) for k, v in decode_ms.items()},
            "decode_ms_each": decode_ms, "host_ms_per_view_by_stage": stage_ms, "loader_workers": workers,
            "worker_ms_per_sample": float(np.mean(sample_ms)), "worker_ms_each_sample": sample_ms,
            "loader_alone_s": loader_s, "loader_alone_batches_per_s": DATA_SAMPLES / loader_s,
            "loader_alone_first_batch_s": first_s, "batch_shapes": shapes_seen,
            "train_main_s": train_s, "ms_per_optimizer_step": 1e3 * float(np.mean(steps[1:])),
            "ms_each_optimizer_step": [1e3 * x for x in steps], "loader_wait_ms_each_step": [1e3 * x for x in waits],
            "loader_wait_ms_mean_after_first": 1e3 * float(np.mean(waits[1:])),
            "launches": counts, "launches_per_micro_batch_by_key_length": by_length,
            "finite_parameters": finite, "peak_mem_gib": peak_gib, "log": log,
            "card": card["name"], "power_limit": card["power_limit"],
        })
        del trainer, state, params
        gc.collect()
        torch.cuda.empty_cache()
        return {"rows": rows, "launches": counts, "shapes": shapes, "micro_batches": micro}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def data_path_entries(data) -> list:
    """Phase 21 in the kernels line: each training kernel on the data path's epoch, one
    entry per TPU kernel the JAX dispatch takes at those lengths (the head-pair kernels
    above 2048 padded keys, the single-pass ones below): the run's launches in that
    regime, and times per micro-batch at the checked shapes (each shape's per-call times
    by its launches per micro-batch in the run)."""
    entries = []
    for name in TRAIN_KERNELS:
        for regime, replaces in ((r, REGIME_REPLACES[r][name]) for r in ("pair", "single")):
            regime_rows = [r for r in data["rows"] if jax_regime(r["b_t_h_d"][1]) == regime]
            launches = sum(n for (t, _), n in data["shapes"][name].items() if jax_regime(t) == regime)
            entries.append(train_entry(name, regime_rows, replaces, launches, data["micro_batches"],
                                       path="data path: tools/train.main, 16 micro-batches of 1x4 views over "
                                            "518_many_ar (phase 21); times per micro-batch at the checked shapes"))
    return entries


def rel_err(a, b, floor: float = 1e-12) -> float:
    """max |a - b| over b's magnitude max(|b|), floored at ``floor``."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return (a - b).abs().max().item() / max(b.abs().max().item(), floor)


def train_slice_check(trunk_heads=None):
    """Phase 6 (phase 14 with ``trunk_heads``): the small fp32 train step, the same
    seeded weights and masks on cuda and cpu."""
    import torch

    from mapanything_tpu_torch.models.mapanything import GeometricInputConfig, MapAnything, sample_modality_masks
    from mapanything_tpu_torch.ops.flash_attention import launch_counts, launch_shapes, reset_launch_counts
    from mapanything_tpu_torch.train.losses import synthetic_loss_batch
    from mapanything_tpu_torch.train.optim import OptimConfig, build_optimizer
    from mapanything_tpu_torch.train.step import init_train_state, make_loss_fn, make_train_step

    cfg = small_config(trunk_heads)
    B, V, HW = 1, 2, 56
    img = torch.from_numpy(np.random.RandomState(0).randn(B, V, HW, HW, 3).astype(np.float32))
    batch = synthetic_loss_batch(B, V, HW, HW, seed=1)
    geo = GeometricInputConfig(ray_dirs_prob=1.0, depth_prob=1.0, cam_prob=1.0, sparse_depth_prob=1.0)
    masks = sample_modality_masks(torch.Generator().manual_seed(0), B, V, (HW, HW), geo)
    if masks.depth_sparsification_keep is None or bool(masks.depth_sparsification_keep.all()):
        raise AssertionError("phase 6 must run with a depth sparsification mask")
    opt_cfg = OptimConfig(lr=1e-4, min_lr=1e-6)
    rtol = 1e-3
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        runs = {}
        for device in ("cuda", "cpu"):
            model = MapAnything(cfg, device=device, seed=0, geometric_inputs=True)
            reset_launch_counts()
            loss, details = make_loss_fn(model)(batch.to(device), img.to(device), masks)
            loss.backward()
            if device == "cuda":
                torch.cuda.synchronize()
            counts, shapes = launch_counts(), launch_shapes()
            grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
            opt = build_optimizer(opt_cfg, model)
            state = init_train_state(model, opt)
            step = make_train_step(model, opt, geo_cfg=geo)
            gen = torch.Generator().manual_seed(3)
            for _ in range(2):
                state, _ = step(state, img.to(device), batch.to(device), gen)
            runs[device] = dict(loss=loss.detach(), details={k: v.detach() for k, v in details.items()},
                                grads=grads, counts=counts, shapes=shapes,
                                params={n: p.detach().clone() for n, p in model.named_parameters()})
            del model, opt, state
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    gpu, cpu = runs["cuda"], runs["cpu"]
    errs = {"loss": rel_err(gpu["loss"], cpu["loss"])}
    errs.update({f"details.{k}": rel_err(gpu["details"][k], v) for k, v in cpu["details"].items()})
    grad_errs = {n: rel_err(gpu["grads"][n], g) for n, g in cpu["grads"].items()}
    # Parameters against max(1, magnitude), as phase 4 holds the predictions: Adam's
    # steps are ~lr·sign(g), so zero-initialised biases hold nothing but steps, and
    # a gradient element at rounding level may take either sign on either device.
    param_errs = {n: rel_err(gpu["params"][n], p, floor=1.0) for n, p in cpu["params"].items()}
    worst = lambda d: max(d.items(), key=lambda kv: kv[1])  # noqa: E731
    # The worst gradient leaf: its name, its magnitude max|g| on the cpu and the gap
    # max|g_cuda - g_cpu|, whose ratio is the relative error held to rtol.
    leaf = worst(grad_errs)[0]
    g_cpu, g_cuda = cpu["grads"][leaf].double(), gpu["grads"][leaf].detach().double().cpu()
    worst_leaf = {"name": leaf, "magnitude": g_cpu.abs().max().item(), "gap": (g_cuda - g_cpu).abs().max().item(),
                  "rel_err": grad_errs[leaf]}
    emit({"phase": "train_slice_check" if trunk_heads is None else "train_slice_check_h128",
          "config": f"small{'' if trunk_heads is None else f'(info_sharing_num_heads={trunk_heads})'} fp32 1x2x56x56, "
                    "all geometric inputs",
          "rtol": rtol, "errors": errs, "worst_grad": worst(grad_errs), "worst_grad_leaf": worst_leaf,
          "worst_param_after_2_steps": worst(param_errs),
          "cuda_launches": gpu["counts"], "cuda_launches_by_shape": shape_counts(gpu["shapes"])})
    if trunk_heads is not None:
        check_head_dim_launches(by_head_dim(gpu["shapes"]), cfg.info_sharing_dim // trunk_heads,
                                ["flash_attention_fwd_lse", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"])
    if any(gpu["counts"][k] == 0 for k in ("flash_attention_fwd_lse", "flash_attention_bwd_dq",
                                            "flash_attention_bwd_dkv", "flash_attention_split_f32")) \
            or gpu["counts"]["flash_attention_fwd"] != 0:
        raise AssertionError(f"the cuda step did not run the training kernels: {gpu['counts']}")
    bad = {k: v for d in (errs, grad_errs, param_errs) for k, v in d.items() if not v <= rtol}
    if bad:
        raise AssertionError(f"cuda and cpu disagree beyond {rtol} of the magnitude: {bad}")


def flagship_train(card, group=None, unsharded_loss=None, trunk_heads: int = 12, compute_dtype: str = "bfloat16",
                   kernel_rows=None):
    """Phase 7, the flagship bf16 train step on 1 x 4 x 518; with a view
    ``group``, phase 10: the same step view-parallel under the ring, each
    rank on its block of the views, beside phase 7's loss; with trunk_heads=6,
    phase 16: flagship-h128's step; with compute_dtype="float32", phase 17: the
    step at the config's default dtype, which launches the fp32 kernels (their
    share of the step from phase 3b's ``kernel_rows``, where given)."""
    import torch

    from mapanything_tpu_torch.models.mapanything import GeometricInputConfig, MapAnything
    from mapanything_tpu_torch.ops.flash_attention import launch_counts, launch_shapes, reset_launch_counts
    from mapanything_tpu_torch.parallel import sharded_attention as sa
    from mapanything_tpu_torch.parallel.mesh import shard_views_pytree, view_slice
    from mapanything_tpu_torch.train.losses import LossConfig, synthetic_loss_batch
    from mapanything_tpu_torch.train.optim import OptimConfig, build_optimizer
    from mapanything_tpu_torch.train.step import init_train_state, make_train_step

    B, V, H, W = 1, 4, 518, 518
    warmup, iters = 2, 5  # seven steps: the masks of some step give every geometric encoder a gradient
    t0 = time.perf_counter()
    cfg = flagship_config(trunk_heads, compute_dtype)
    fp32 = compute_dtype == "float32"
    d = cfg.info_sharing_dim // trunk_heads
    model = MapAnything(cfg, device="cuda", seed=0, geometric_inputs=True)
    # bench.py:229-231: a random init diverges at the production lr.
    opt = build_optimizer(OptimConfig(lr=1e-7, min_lr=1e-8, epoch_len=100, total_epochs=1.0), model)
    state = init_train_state(model, opt)
    step = make_train_step(model, opt, LossConfig(), GeometricInputConfig(), view_group=group)
    batch = synthetic_loss_batch(B, V, H, W, seed=0).to("cuda")  # bench.py:128-153
    img = torch.from_numpy(np.random.RandomState(0).randn(B, V, H, W, 3).astype(np.float32)).cuda()
    n_ranks = 1
    if group is not None:  # this rank's views; the masks are drawn for all views
        n_ranks = group.size
        batch, img = shard_views_pytree(batch, group), img[:, view_slice(group, V)]
    gen = torch.Generator().manual_seed(0)
    before = {n: p.detach().clone() for n, p in state.params.items()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # Per step: the encoder's 24 (D = 64) and the frame layers' 12 of each kernel, and
    # the 12 global layers' (under the ring, n_ranks ring steps each), at the trunk's D;
    # in fp32 a split pass before each lse forward and before each dq and dk/dv pair (twice
    # the others' counts). Unsharded, by (key length, D): 24 at 1370 tokens, 12 at 1369 and
    # 12 at 4 * 1369 + 1 = 5477.
    per_kernel = 36 + 12 * n_ranks
    want = {"flash_attention_fwd": 0, "flash_attention_fwd_lse": per_kernel,
            "flash_attention_bwd_dq": per_kernel, "flash_attention_bwd_dkv": per_kernel,
            "flash_attention_split_f32": 2 * per_kernel if fp32 else 0}
    want_by_d = {64: 24}
    want_by_d[d] = want_by_d.get(d, 0) + 12 + 12 * n_ranks
    want_by_shape = {(1370, 64): 24, (1369, d): 12, (5477, d): 12}
    times_of = lambda k: 2 if k == "flash_attention_split_f32" else 1  # noqa: E731
    training = [k for k in want if want[k]]
    totals = dict.fromkeys(want, 0)
    totals_by_d = {k: {} for k in training}
    names = list(state.params)
    ever_nonzero = torch.zeros(len(names), dtype=torch.bool, device="cuda")
    times, metrics = [], []
    torch.cuda.reset_peak_memory_stats()
    want_ring = {"ring_steps": 12 * n_ranks, "ring_bwd_steps": 12 * n_ranks} if group is not None else {}
    for i in range(warmup + iters):
        reset_launch_counts()
        sa.reset_counts()
        t = time.perf_counter()
        state, m = step(state, img, batch, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts, shapes = launch_counts(), launch_shapes()
        ring = sa.counts()
        # (An older checkout that this script is copied into to time its step may lack the split's count.)
        if not counts_match(counts, want) or any(ring[k] != v for k, v in want_ring.items()):
            raise AssertionError(f"train step {i} launched {counts} with {ring}, not {want} and {want_ring}")
        for k, by_d in by_head_dim(shapes).items():
            want_d = {dim: n * times_of(k) for dim, n in want_by_d.items()}
            want_s = {s: n * times_of(k) for s, n in want_by_shape.items()}
            if k in totals_by_d and by_d != want_d:
                raise AssertionError(f"train step {i} launched {k} {by_d} times by head dim, not {want_d}")
            if k in totals_by_d and group is None and shapes[k] != want_s:
                raise AssertionError(f"train step {i} launched {k} {shapes[k]} times by (Tk, D), not {want_s}")
            for dim, n in by_d.items():
                if k in totals_by_d:
                    totals_by_d[k][dim] = totals_by_d[k].get(dim, 0) + n
        for k in counts:
            totals[k] = totals.get(k, 0) + counts[k]
        m = {k: v.item() for k, v in m.items()}
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
            raise AssertionError(f"train step {i}: loss {m['loss']}, grad_norm {m['grad_norm']}")
        # Every gradient leaf is finite; a leaf may be zero in a step whose
        # modality masks leave its encoder out, but not in every step.
        if any(state.params[n].grad is None for n in names):
            raise AssertionError(f"train step {i} left parameters without a gradient")
        norms = torch.stack(torch._foreach_norm([state.params[n].grad for n in names]))
        if not bool(torch.isfinite(norms).all()):
            raise AssertionError(f"train step {i}: non-finite gradients in "
                                 f"{[n for n, x in zip(names, norms.tolist()) if not np.isfinite(x)]}")
        ever_nonzero |= norms > 0
        metrics.append(m)
        if i >= warmup:
            times.append(dt)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    never = [n for n, x in zip(names, ever_nonzero.tolist()) if not x]
    if never:
        raise AssertionError(f"no gradient reached {never} in {warmup + iters} steps")
    # Each update before the add is lr · mu_hat / (sqrt(nu_hat) + eps): nonzero
    # wherever Adam's first moment is. (Whether the add then changes a value is
    # fp32 rounding: an update below 3e-8 rounds away on a value of 1.)
    no_update = [n for n in names if not bool(state.opt_state.mu[n].any())]
    if no_update:
        raise AssertionError(f"parameters with a gradient but a zero update: {no_update}")
    unchanged = [n for n in names if torch.equal(before[n], state.params[n])]
    ms = 1e3 * sum(times) / iters
    dtype_arg = "" if fp32 else "compute_dtype='bfloat16'"
    line = {
        "phase": ("flagship_fp32_train" if fp32 else "flagship_train" if trunk_heads == 12 else "flagship_h128_train")
                 + ("" if group is None else "_view_parallel"),
        "config": f"MapAnythingConfig({dtype_arg}"
                  f"{'' if trunk_heads == 12 else f', info_sharing_num_heads={trunk_heads}'}), 1x4x518x518 train "
                  "step, seeded random weights, bench.py LossBatch, GeometricInputConfig() masks, lr 1e-7"
                  + ("" if group is None else f"; view-parallel, ring, {n_ranks} rank(s) (NCCL)"),
        "setup_s": setup_s, "warmup": warmup, "iters": iters,
        "ms_per_step": ms, "ms_each": [1e3 * t for t in times],
        "views_per_s": B * V / (ms / 1e3), "peak_mem_gib": peak_gib,
        "launches_per_step": counts, "launches_per_step_by_shape": shape_counts(shapes),
        "ring_per_step": ring, "launches_total": totals, "launches_total_by_head_dim": totals_by_d,
        "loss": [m["loss"] for m in metrics], "grad_norm": [m["grad_norm"] for m in metrics],
        "param_tensors_changed": [len(names) - len(unchanged), len(names)],
        "unchanged": {n: {"min": before[n].min().item(), "max": before[n].max().item(),
                          "max_abs_mu": state.opt_state.mu[n].abs().max().item()} for n in unchanged},
        "card": card["name"], "power_limit": card["power_limit"],
    }
    if kernel_rows:  # each training kernel's time a step: phase 3b's ms per call x launches
        per_step = {k: sum(r["kernels"][k]["ms"] * r["per_step"] for r in kernel_rows) for k in training}
        line.update(kernel_ms_per_step=per_step, kernel_share_of_step={k: v / ms for k, v in per_step.items()})
    if unsharded_loss is not None:  # phase 7's, the same seeds
        gap = max(abs(a - b) / abs(b) for a, b in zip(line["loss"], unsharded_loss))
        line.update(unsharded_loss=unsharded_loss, loss_gap=gap, loss_gap_limit=LOSS_GAP_LIMIT)
    if group is None or group.rank == 0:
        emit(line)
    if unsharded_loss is not None and not gap <= LOSS_GAP_LIMIT:
        raise AssertionError(f"the view-parallel step's loss is {gap:.3g} from phase 7's, over {LOSS_GAP_LIMIT}")
    return totals, warmup + iters, line


def view_parallel_slice_check(group):
    """Phase 8: the small fp32 model view-sharded over a group of one rank
    (NCCL), ring and allgather forwards and the ring train step, against the
    unsharded ones on cuda."""
    import torch

    from mapanything_tpu_torch.models.mapanything import (
        GeometricInputConfig, MapAnything, MapAnythingConfig, Views,
    )
    from mapanything_tpu_torch.ops.flash_attention import launch_counts, reset_launch_counts
    from mapanything_tpu_torch.parallel import sharded_attention as sa
    from mapanything_tpu_torch.parallel.context import gather_predictions, infer_view_sharded
    from mapanything_tpu_torch.train.losses import synthetic_loss_batch
    from mapanything_tpu_torch.train.optim import OptimConfig, build_optimizer
    from mapanything_tpu_torch.train.step import init_train_state, make_train_step

    cfg = MapAnythingConfig.small()
    B, V, HW = 1, 4, 112
    img = torch.from_numpy(np.random.RandomState(0).randn(B, V, HW, HW, 3).astype(np.float32)).cuda()
    rtol = 1e-4
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        model = MapAnything(cfg, device="cuda", seed=0)
        with torch.inference_mode():
            want = model(Views(img=img))
        fwd = {}
        for schedule in ("ring", "allgather"):
            reset_launch_counts()
            sa.reset_counts()
            got = gather_predictions(infer_view_sharded(model, Views(img=img), group, schedule), group)
            torch.cuda.synchronize()
            errs = {f: rel_err(getattr(got, f), getattr(want, f), floor=1.0) for f in PRED_FIELDS}
            fwd[schedule] = {"errors": errs, "launches": launch_counts(), "ring": sa.counts()}
            bad = {f: e for f, e in errs.items() if not e <= rtol}
            if bad:
                raise AssertionError(f"the {schedule} forward disagrees with the unsharded one: {bad}")
        if fwd["ring"]["launches"]["flash_attention_fwd_lse"] != 2 or fwd["ring"]["ring"]["ring_steps"] != 2:
            raise AssertionError(f"the ring forward did not take two ring steps through the lse kernel: {fwd['ring']}")
        del model

        # The train step: loss and details, every gradient after step 1, parameters after step 2.
        batch = synthetic_loss_batch(B, V, HW, HW, seed=1).to("cuda")
        geo = GeometricInputConfig(ray_dirs_prob=1.0, depth_prob=1.0, cam_prob=1.0, sparse_depth_prob=1.0)
        runs = {}
        for mode in ("unsharded", "ring"):
            model = MapAnything(cfg, device="cuda", seed=0, geometric_inputs=True)
            opt = build_optimizer(OptimConfig(lr=1e-4, min_lr=1e-6), model)
            state = init_train_state(model, opt)
            step = make_train_step(model, opt, geo_cfg=geo, view_group=None if mode == "unsharded" else group)
            gen = torch.Generator().manual_seed(3)
            reset_launch_counts()
            sa.reset_counts()
            state, m = step(state, img, batch, gen)
            torch.cuda.synchronize()
            run = {"metrics": {k: v.detach() for k, v in m.items() if k != "grad_norm"},
                   "grads": {n: p.grad.detach().clone() for n, p in state.params.items()},
                   "launches": launch_counts(), "ring": sa.counts()}
            state, _ = step(state, img, batch, gen)
            run["params"] = {n: p.detach().clone() for n, p in state.params.items()}
            runs[mode] = run
            del model, opt, state
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    ring, ref = runs["ring"], runs["unsharded"]
    train_rtol = 1e-3  # phase 6's tolerance
    errs = {k: rel_err(ring["metrics"][k], v) for k, v in ref["metrics"].items()}
    grad_errs = {n: rel_err(ring["grads"][n], g) for n, g in ref["grads"].items()}
    param_errs = {n: rel_err(ring["params"][n], p, floor=1.0) for n, p in ref["params"].items()}
    worst = lambda d: max(d.items(), key=lambda kv: kv[1])  # noqa: E731
    emit({"phase": "view_parallel_slice_check", "config": "small fp32 1x4x112x112, view-parallel, "
          "one rank (NCCL)", "forward_rtol": rtol, "forward": fwd, "train_rtol": train_rtol,
          "train_errors": errs, "worst_grad": worst(grad_errs), "worst_param_after_2_steps": worst(param_errs),
          "train_launches": ring["launches"], "train_ring": ring["ring"]})
    if ring["ring"]["ring_steps"] != 2 or ring["ring"]["ring_bwd_steps"] != 2 \
            or ring["launches"]["flash_attention_bwd_dq"] != ref["launches"]["flash_attention_bwd_dq"]:
        raise AssertionError(f"the ring step did not run the ring's kernels: {ring['launches']}, {ring['ring']}")
    bad = {k: v for d in (errs, grad_errs, param_errs) for k, v in d.items() if not v <= train_rtol}
    if bad:
        raise AssertionError(f"the ring train step disagrees with the unsharded one: {bad}")


def flagship_view_parallel(card, group, trunk_heads: int = 12):
    """Phase 9: the flagship bf16 forward on 1 x 16 x 518 unsharded, under the
    ring and under allgather, over ``group`` (one rank on one card, or one
    rank a card). Every rank runs the view-parallel forwards; the first also
    runs the unsharded one and compares the gathered outputs. Phase 30 with
    trunk_heads=6: flagship-h128, whose trunk layers then launch the D = 128
    instances (the ring's lse forwards among them)."""
    import torch

    from mapanything_tpu_torch.models.mapanything import MapAnything, Views
    from mapanything_tpu_torch.ops.flash_attention import launch_counts, launch_shapes, reset_launch_counts
    from mapanything_tpu_torch.parallel import sharded_attention as sa
    from mapanything_tpu_torch.parallel.context import gather_predictions, infer_view_sharded

    B, V, H, W = 1, 16, 518, 518
    warmup, iters = 2, 3
    n, lead = group.size, group.rank == 0
    model = MapAnything(flagship_config(trunk_heads), device="cuda", seed=0)
    img = torch.from_numpy(np.random.RandomState(0).randn(B, V, H, W, 3).astype(np.float32)).cuda()
    views = Views(img=img)
    trunk_d = model.config.info_sharing_dim // trunk_heads
    forwards = {"ring": lambda: infer_view_sharded(model, views, group, "ring"),
                "allgather": lambda: infer_view_sharded(model, views, group, "allgather")}
    if lead:
        forwards = {"unsharded": lambda: model(views), **forwards}
    # Launches per forward on each rank: the encoder's 24 and the frame layers'
    # 12 lse-free; the global layers' 12 lse-free, or 12 lse ring steps each of n steps.
    want = {"unsharded": {"flash_attention_fwd": 48, "flash_attention_fwd_lse": 0},
            "ring": {"flash_attention_fwd": 36, "flash_attention_fwd_lse": 12 * n},
            "allgather": {"flash_attention_fwd": 48, "flash_attention_fwd_lse": 0}}
    lines, outs = {}, {}
    for mode, fwd in forwards.items():
        with torch.inference_mode():
            reset_launch_counts()
            sa.reset_counts()
            preds = fwd()
            torch.cuda.synchronize()
            counts, ring, by_d = launch_counts(), sa.counts(), by_head_dim(launch_shapes())
            expect = {**want[mode], "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                      "flash_attention_split_f32": 0}
            if not counts_match(counts, expect) or ring["ring_steps"] != (12 * n if mode == "ring" else 0):
                raise AssertionError(f"one {mode} forward launched {counts} with {ring}, not {expect}")
            # The trunk's 24 layers at its head dim (12 frame, 12 global or 12 n ring steps),
            # beside the encoder's 24 at D = 64.
            trunk = (by_d["flash_attention_fwd"].get(trunk_d, 0) + by_d["flash_attention_fwd_lse"].get(trunk_d, 0)
                     - (24 if trunk_d == 64 else 0))
            if trunk != (12 + 12 * n if mode == "ring" else 24):
                raise AssertionError(f"one {mode} forward launched {by_d} at the trunk's D = {trunk_d}")
            for _ in range(warmup - 1):
                fwd()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(iters):
                t = time.perf_counter()
                preds = fwd()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if mode != "unsharded":
            preds = gather_predictions(preds, group)
        if lead:
            ray_norm_err = check_invariants(preds, (B, V, H, W))
            outs[mode] = {f: getattr(preds, f).float() for f in PRED_FIELDS}
        ms = 1e3 * sum(times) / iters
        lines[mode] = {"launches_per_forward": counts, "launches_by_head_dim": by_d,
                       "ring_steps_per_forward": ring["ring_steps"],
                       "collectives_per_forward": ring["collectives"], "ms_per_forward": ms,
                       "ms_each": [1e3 * t for t in times], "views_per_s": B * V / (ms / 1e3),
                       "peak_mem_gib": peak}
        if lead:
            lines[mode]["ray_norm_err"] = ray_norm_err
        del preds
        torch.cuda.empty_cache()
    if not lead:
        return None
    pairs = (("ring", "unsharded"), ("allgather", "unsharded"), ("ring", "allgather"))
    diffs = {f"{a}_vs_{b}": {f: (outs[a][f] - outs[b][f]).abs().max().item() for f in PRED_FIELDS} for a, b in pairs}
    mean_diffs = {f"{a}_vs_{b}": {f: (outs[a][f] - outs[b][f]).abs().mean().item() for f in PRED_FIELDS}
                  for a, b in pairs}
    line = {"phase": "flagship_view_parallel", "phase_id": "9" if trunk_heads == 12 else "30",
            "config": f"MapAnythingConfig(compute_dtype='bfloat16', info_sharing_num_heads={trunk_heads}), "
                      f"1x{V}x518x518, seeded random weights, {n} rank(s) (NCCL)",
            "world_size": n, "warmup": warmup, "iters": iters, **lines, "max_abs_diff": diffs,
            "mean_abs_diff": mean_diffs, "mean_abs_diff_limits": MEAN_DIFF_LIMITS,
            "card": card["name"], "power_limit": card["power_limit"]}
    emit(line)
    bad = {pair: {f: x for f, x in d.items() if not x <= MEAN_DIFF_LIMITS[f]} for pair, d in mean_diffs.items()}
    bad = {pair: d for pair, d in bad.items() if d}
    if bad:
        raise AssertionError(f"the forwards differ on average beyond MEAN_DIFF_LIMITS: {bad}")
    return line


# Phases 3 and 3b at the RGB models' MAE decoder (8 ViT blocks of 16 heads of 32, fp32
# whatever the model's dtype; 1369 tokens a view at 518 px): (name, shape, dtype,
# launches per MAE flagship forward, the TPU kernel: at 1369 keys the JAX dispatch takes
# one key block of 1536, the single-pass kernel, fp32 and d % 128 != 0).
RGB_SHAPES = [("mae_decoder", (8, 1369, 16, 32), "float32", 8, f"{FA}:114")]
RGB_TRAIN_SHAPES = [("mae_decoder", (4, 1369, 16, 32), "float32", 8)]
RGB_TRAIN_REPLACES = {"flash_attention_fwd_lse": {"mae_decoder": f"{FA}:118"},
                      "flash_attention_bwd_dq": {"mae_decoder": f"{FA}:227"},
                      "flash_attention_bwd_dkv": {"mae_decoder": f"{FA}:262"},
                      "flash_attention_split_f32": {"mae_decoder": f"{FA}:227"}}
RGB_HEADS = ("mae", "moge")


def rgb_config(head: str, compute_dtype: str = "bfloat16"):
    """The flagship widths of configs/model/mapanything_{mae,moge}_rgb.yaml: the DINOv2
    large encoder and the 24-layer trunk in ``compute_dtype``, the ``head`` dense head
    (fp32 whatever the dtype) with the ``raydirs+depth+rgb+pose`` scene representation."""
    from mapanything_tpu_torch.models.heads.adaptors import DenseAdaptorConfig
    from mapanything_tpu_torch.models.mapanything import MapAnythingConfig

    return MapAnythingConfig(
        compute_dtype=compute_dtype, dense_head_type=head, scene_rep_type="raydirs+depth+rgb+pose",
        dense_adaptor=DenseAdaptorConfig(components=("ray_directions", "depth", "rgb"), with_confidence=True,
                                         with_mask=True))


def rgb_flagship_infer(card) -> dict:
    """Phase 22: the RGB models' flagship, bf16 trunk and fp32 MAE or MoGe head, through
    ``infer`` on 1 x 8 x 518: launches by head dim and key length (the MAE decoder's 8
    narrow fp32 D = 32 forwards, no split pass, beside the 48 bf16 D = 64 ones), ms
    per infer, views/s, peak memory, the output invariants and predicted colours in
    [0, 1]. Returns {head: line}."""
    import torch

    from mapanything_tpu_torch.models.mapanything import MapAnything
    from mapanything_tpu_torch.ops.flash_attention import launch_counts, launch_shapes, reset_launch_counts
    from mapanything_tpu_torch.utils.inference import PostprocessConfig, infer

    B, V, H, W = 1, 8, 518, 518
    images = torch.from_numpy(np.random.RandomState(22).uniform(0, 1, (B, V, H, W, 3)).astype(np.float32)).cuda()
    lines = {}
    for head in RGB_HEADS:
        t0 = time.perf_counter()
        model = MapAnything(rgb_config(head), device="cuda", seed=0)
        setup_s = time.perf_counter() - t0
        reset_launch_counts()
        out = infer(model, images)
        torch.cuda.synchronize()
        counts, shapes = launch_counts(), launch_shapes()
        mae = head == "mae"
        want = {"flash_attention_fwd": 56 if mae else 48, "flash_attention_fwd_lse": 0, "flash_attention_bwd_dq": 0,
                "flash_attention_bwd_dkv": 0, "flash_attention_split_f32": 0}
        want_shapes = {(1370, 64): 24, (1369, 64): 12, (V * 1369 + 1, 64): 12, **({(1369, 32): 8} if mae else {})}
        if not counts_match(counts, want) or shapes["flash_attention_fwd"] != want_shapes:
            raise AssertionError(f"one {head} infer launched {counts} ({shapes['flash_attention_fwd']}), not {want} "
                                 f"({want_shapes})")
        checks = check_infer_outputs(out, (B, V, H, W))
        rgb = out.img_no_norm
        if not (0.0 <= rgb.min().item() and rgb.max().item() <= 1.0):
            raise AssertionError(f"{head}: predicted colours outside [0, 1]")
        out, ms, each, peak = time_infer(model, images, PostprocessConfig(), warmup=2, iters=3)
        lines[head] = {
            "phase": "rgb_flagship_infer", "phase_id": "22", "head": head,
            "config": f"configs/model/mapanything_{head}_rgb.yaml widths: MapAnythingConfig(compute_dtype='bfloat16', "
                      f"dense_head_type={head!r}, scene_rep_type='raydirs+depth+rgb+pose'), fp32 head, 1x8x518x518, "
                      "seeded random weights",
            "setup_s": setup_s, "ms_per_infer": ms, "ms_each": each, "views_per_s": B * V / (ms / 1e3),
            "peak_mem_gib": peak, "launches_per_infer": counts,
            "launches_by_shape": shape_counts(shapes), "launches_by_head_dim": by_head_dim(shapes),
            "rgb_range": [rgb.min().item(), rgb.max().item()], **checks,
            "card": card["name"], "power_limit": card["power_limit"],
        }
        emit(lines[head])
        del model, out
        gc.collect()
        torch.cuda.empty_cache()
    return lines


def rgb_flagship_train(card) -> dict:
    """Phase 23: the MAE flagship's train step (bf16 trunk, fp32 MAE head) on 1 x 4 x 518
    with bench.py's LossBatch and a seeded target_rgb (the RGB L1 term on): 2 warm-up and
    5 timed steps, launches per step by head dim (the MAE decoder's 8 fp32 D = 32 lse
    forwards, dq and dk/dv, and the backward's 8 split passes, beside 48 bf16 D = 64 ones),
    finite loss,
    gradient norm and gradients, a nonzero gradient reaching every parameter, the RGB
    term in every step's loss, ms per step, views/s and peak memory."""
    import torch

    from mapanything_tpu_torch.models.mapanything import GeometricInputConfig, MapAnything
    from mapanything_tpu_torch.ops.flash_attention import launch_counts, launch_shapes, reset_launch_counts
    from mapanything_tpu_torch.train.losses import LossConfig, synthetic_loss_batch
    from mapanything_tpu_torch.train.optim import OptimConfig, build_optimizer
    from mapanything_tpu_torch.train.step import init_train_state, make_train_step

    B, V, H, W = 1, 4, 518, 518
    warmup, iters = 2, 5
    t0 = time.perf_counter()
    model = MapAnything(rgb_config("mae"), device="cuda", seed=0, geometric_inputs=True)
    opt = build_optimizer(OptimConfig(lr=1e-7, min_lr=1e-8, epoch_len=100, total_epochs=1.0), model)
    state = init_train_state(model, opt)
    step = make_train_step(model, opt, LossConfig(), GeometricInputConfig())
    batch = dataclasses.replace(
        synthetic_loss_batch(B, V, H, W, seed=0),
        target_rgb=torch.from_numpy(np.random.RandomState(23).uniform(0, 1, (B, V, H, W, 3)).astype(np.float32)),
    ).to("cuda")
    img = torch.from_numpy(np.random.RandomState(0).randn(B, V, H, W, 3).astype(np.float32)).cuda()
    gen = torch.Generator().manual_seed(0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    training = ("flash_attention_fwd_lse", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    want = {"flash_attention_fwd": 0, **dict.fromkeys(training, 56), "flash_attention_split_f32": 8}
    want_by_d = {**{k: {64: 48, 32: 8} for k in training}, "flash_attention_split_f32": {32: 8}}
    totals_by_d = {k: {} for k in want_by_d}
    names = list(state.params)
    ever_nonzero = torch.zeros(len(names), dtype=torch.bool, device="cuda")
    times, metrics = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(warmup + iters):
        reset_launch_counts()
        t = time.perf_counter()
        state, m = step(state, img, batch, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts, by_d = launch_counts(), by_head_dim(launch_shapes())
        if not counts_match(counts, want) or any(by_d[k] != v for k, v in want_by_d.items()):
            raise AssertionError(f"MAE train step {i} launched {counts} ({by_d}), not {want} ({want_by_d})")
        for k in want_by_d:
            for dim, n in by_d[k].items():
                totals_by_d[k][dim] = totals_by_d[k].get(dim, 0) + n
        m = {k: v.item() for k, v in m.items()}
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and m.get("rgb_loss", 0.0) > 0):
            raise AssertionError(f"MAE train step {i}: {m}")
        if any(state.params[n].grad is None for n in names):
            raise AssertionError(f"MAE train step {i} left parameters without a gradient")
        norms = torch.stack(torch._foreach_norm([state.params[n].grad for n in names]))
        if not bool(torch.isfinite(norms).all()):
            raise AssertionError(f"MAE train step {i}: non-finite gradients")
        ever_nonzero |= norms > 0
        metrics.append(m)
        if i >= warmup:
            times.append(dt)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    never = [n for n, x in zip(names, ever_nonzero.tolist()) if not x]
    if never:
        raise AssertionError(f"no gradient reached {never} in {warmup + iters} steps")
    ms = 1e3 * sum(times) / iters
    line = {
        "phase": "rgb_flagship_train", "phase_id": "23",
        "config": "configs/model/mapanything_mae_rgb.yaml widths, bf16 trunk, fp32 MAE head, 1x4x518x518 train step, "
                  "seeded random weights, bench.py LossBatch + seeded target_rgb, GeometricInputConfig() masks, lr 1e-7",
        "setup_s": setup_s, "warmup": warmup, "iters": iters, "ms_per_step": ms, "ms_each": [1e3 * t for t in times],
        "views_per_s": B * V / (ms / 1e3), "peak_mem_gib": peak_gib, "launches_per_step": counts,
        "launches_total_by_head_dim": totals_by_d, "steps": warmup + iters,
        "loss": [m["loss"] for m in metrics], "rgb_loss": [m["rgb_loss"] for m in metrics],
        "grad_norm": [m["grad_norm"] for m in metrics],
        "params_with_gradient": [int(ever_nonzero.sum().item()), len(names)],
        "card": card["name"], "power_limit": card["power_limit"],
    }
    emit(line)
    return line


def losses_phase(card) -> dict:
    """Phase 24: the RGB perception loss (the VGG19 tower on seeded weights, 1 x 2 x 64 x
    64), the disentangled loss and the DUSt3R loss on seeded inputs (2 x 2 x 32 x 40), on
    the card against the CPU: each loss and its gradients with respect to the
    predictions, fp32 with TF32 off, within 1e-4 of their magnitude."""
    import torch

    from mapanything_tpu_torch.models.mapanything import Predictions
    from mapanything_tpu_torch.models.perceptual import VGG19Features
    from mapanything_tpu_torch.train import losses as L

    rtol = 1e-4
    rng = np.random.RandomState(24)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    unit = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)  # noqa: E731

    def run(device):
        """Each loss and its gradients on ``device``, from the same numpy inputs."""
        t = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
        out = {}
        vgg = VGG19Features(device=device, seed=0)
        pred = t(inputs["pred_rgb"]).requires_grad_()
        loss, _ = L.rgb_perception_loss(vgg, pred, t(inputs["gt_rgb"]), t(inputs["rgb_valid"]))
        out["rgb_perception"] = (loss.item(), torch.autograd.grad(loss, pred)[0].cpu())
        preds = {k: t(v).requires_grad_() for k, v in inputs["preds"].items()}
        batch = L.LossBatch(**{k: t(v) for k, v in inputs["batch"].items()})
        loss, _ = L.factored_geometry_scale_loss(batch, Predictions(**preds), L.LossConfig(disentangled=True))
        grads = torch.autograd.grad(loss, [preds[k] for k in ("depth_along_ray", "ray_directions", "cam_quats")])
        out["disentangled"] = (loss.item(), torch.cat([g.flatten() for g in grads]).cpu())
        p, c = t(inputs["preds"]["pts3d"]).requires_grad_(), t(inputs["preds"]["conf"]).requires_grad_()
        loss, _ = L.dust3r_regr3d_conf_loss(batch.pts3d, batch.valid_mask,
                                            (batch.camera_pose_quats[:, 0], batch.camera_pose_trans[:, 0]), p, c)
        grads = torch.autograd.grad(loss, (p, c))
        out["dust3r_regr3d_conf"] = (loss.item(), torch.cat([g.flatten() for g in grads]).cpu())
        return out

    B, V, H, W = 2, 2, 32, 40
    inputs = {
        "pred_rgb": rng.uniform(0, 1, (1, 2, 64, 64, 3)).astype(np.float32),
        "gt_rgb": rng.uniform(0, 1, (1, 2, 64, 64, 3)).astype(np.float32),
        "rgb_valid": rng.uniform(size=(1, 2, 64, 64)) < 0.7,
        "preds": dict(pts3d=f32(B, V, H, W, 3), pts3d_cam=f32(B, V, H, W, 3), ray_directions=unit(f32(B, V, H, W, 3)),
                      depth_along_ray=rng.uniform(0.5, 4, (B, V, H, W, 1)).astype(np.float32), cam_trans=f32(B, V, 3),
                      cam_quats=unit(f32(B, V, 4)), metric_scaling_factor=rng.uniform(0.5, 2, (B,)).astype(np.float32),
                      conf=rng.uniform(1, 3, (B, V, H, W)).astype(np.float32),
                      non_ambiguous_mask_logits=f32(B, V, H, W)),
        "batch": dict(pts3d=f32(B, V, H, W, 3), pts3d_cam=f32(B, V, H, W, 3),
                      depth_along_ray=rng.uniform(1, 5, (B, V, H, W, 1)).astype(np.float32),
                      ray_directions=unit(f32(B, V, H, W, 3)), camera_pose_quats=unit(f32(B, V, 4)),
                      camera_pose_trans=f32(B, V, 3), valid_mask=rng.uniform(size=(B, V, H, W)) < 0.8,
                      non_ambiguous_mask=rng.uniform(size=(B, V, H, W)) < 0.7,
                      valid_non_ambiguous_mask=rng.uniform(size=(B, V, H, W)) < 0.7,
                      is_metric_scale=np.array([True, False]), is_synthetic=np.array([True, False])),
    }
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        gpu, cpu = run("cuda"), run("cpu")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    errs = {}
    for name, (loss, grad) in cpu.items():
        g_loss, g_grad = gpu[name]
        errs[name] = {"loss": abs(g_loss - loss) / max(abs(loss), 1e-12),
                      "grad": (g_grad - grad).abs().max().item() / max(grad.abs().max().item(), 1e-12),
                      "value": loss}
    line = {"phase": "losses_check", "phase_id": "24", "rel_err": errs, "rtol": rtol,
            "card": card["name"], "power_limit": card["power_limit"]}
    emit(line)
    bad = {k: e for k, e in errs.items() if not (e["loss"] <= rtol and e["grad"] <= rtol)}
    if bad:
        raise AssertionError(f"the losses on the card disagree with the CPU beyond {rtol}: {bad}")
    return line


def mesh_trainer_phase(card) -> dict:
    """Phase 25: the Trainer on the data x view mesh of this process alone (NCCL, world
    size 1: one data rank, one view rank; the view axis under the ring): the small fp32
    multimodal model, one epoch of one 1 x 2 x 56 batch, against the Trainer without a
    mesh on the same batch, TF32 off: the logged loss and gradient norm within 1e-5 of
    their magnitude, each gradient leaf within ``rel_err`` 2e-5 (the ring at one rank
    against the unsharded attention; 3.4e-6 and 4.5e-6 on an H100 80GB HBM3). At world size 1 every
    data-group sum is the identity: this phase checks the mesh's NCCL plumbing, and the
    data axis's parity rests on the 2 x 2 gloo tests. Adam's first step moves a
    parameter by lr·sign(g), so the parameters after differ where a tiny gradient's
    sign does (and a second step's gradients with them): their gap is reported."""
    import torch

    from mapanything_tpu_torch.models.mapanything import MapAnything
    from mapanything_tpu_torch.parallel.mesh import make_mesh
    from mapanything_tpu_torch.train.loop import Trainer, TrainLoopConfig

    mesh = make_mesh(view_parallelism=1)
    batches = [numpy_batch(1, 2, 56, 56, 25)]
    rtol, grad_rtol = 1e-5, 2e-5
    runs = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    try:
        for name, m in (("unsharded", None), ("mesh", mesh)):
            model = MapAnything(small_config(), device="cuda", seed=0, geometric_inputs=True)
            cfg = TrainLoopConfig(output_dir=str(out / name), epochs=1, warmup_epochs=0.5, lr=1e-4, min_lr=1e-4,
                                  print_freq=100, seed=2)
            trainer = Trainer(model, batches, cfg, mesh=m)
            t = time.perf_counter()
            stats = trainer.train_one_epoch(0)
            torch.cuda.synchronize()
            runs[name] = dict(stats=stats, s=time.perf_counter() - t,
                              grads=[p.grad.clone() for p in model.parameters()],
                              params=torch.cat([p.detach().flatten() for p in model.parameters()]))
            del trainer, model
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        shutil.rmtree(out, ignore_errors=True)
    a, b = runs["unsharded"], runs["mesh"]
    gaps = {k: abs(b["stats"][k] - a["stats"][k]) / abs(a["stats"][k]) for k in ("train_loss", "train_grad_norm")}
    grad_gap = max(rel_err(gb, ga) for ga, gb in zip(a["grads"], b["grads"]))
    param_gap = (b["params"] - a["params"]).abs().max().item() / a["params"].abs().max().item()
    line = {"phase": "mesh_trainer", "phase_id": "25", "mesh": {"data": mesh.data.size, "view": mesh.view.size},
            "backend": str(torch.distributed.get_backend()), "stats": {k: r["stats"] for k, r in runs.items()},
            "seconds": {k: r["s"] for k, r in runs.items()}, "rel_gap": gaps, "rtol": rtol,
            "grad_rel_err": grad_gap, "grad_rtol": grad_rtol, "param_gap_over_magnitude": param_gap,
            "card": card["name"], "power_limit": card["power_limit"]}
    emit(line)
    if not (all(g <= rtol for g in gaps.values()) and grad_gap <= grad_rtol):
        raise AssertionError(f"the one-rank mesh Trainer departs from the Trainer without one: {gaps}, "
                             f"gradients {grad_gap}")
    return line


# The DUSt3R path (phases 26-27): ModularDUSt3R at DUSt3R_ViTLarge_BaseDecoder_512_dpt's widths
# (ModularDUSt3RConfig's defaults) on one 512 x 384 pair, 32 x 24 = 768 patches a view. The
# JAX package's sdpa sends fewer than 1024 queries to XLA's attention
# (mapanything_tpu/ops/attention.py:73, jax.nn.dot_product_attention): no Pallas kernel ran
# there on the TPU, and the rows name that dispatch as what the kernel replaces.
DUST3R_REPLACES = "mapanything_tpu/ops/attention.py:73"
DUST3R_HW = (384, 512)
# (name, B x Tq x H x D, dtype, launches per 2-view forward, replaced[, Tk: q, k, v three
# tensors]): the encoder's 24 layers over both views at once, the decoder's 12 layers of
# self- and cross-attention per view; the 3-view context (Tk = 2 x 768) is off the 2-view
# path (phase 26 runs the decoder at 3 views at a small width).
DUST3R_SHAPES = [
    row for dtype in ("bfloat16", "float32") for row in (
        ("dust3r_encoder", (2, 768, 16, 64), dtype, 24, DUST3R_REPLACES),
        ("dust3r_decoder_self", (1, 768, 12, 64), dtype, 24, DUST3R_REPLACES),
        ("dust3r_decoder_cross", (1, 768, 12, 64), dtype, 24, DUST3R_REPLACES, 768),
        ("dust3r_cross_3_views", (1, 768, 12, 64), dtype, 0, DUST3R_REPLACES, 1536),
    )
]
# Phase 26: kernels against the plain versions on the card, fp32 with TF32 off, of each
# field's magnitude.
DUST3R_SLICE_RTOL = 1e-4
# Phase 26's small ablation models: (scene representation, dense head, factored global pointmap).
FAMILIES = [("pointmap", "dpt", True), ("raymap+depth", "linear", True), ("campointmap+pose", "dpt", True),
            ("pointmap+raydirs+depth+pose", "dpt", True), ("pointmap+raydirs+depth+pose", "linear", False)]


def against_plain(run, fields) -> tuple:
    """``run()`` with the kernels and with the plain versions (fp32, TF32 off): each
    field's largest difference over its magnitude, and the kernels' launches by shape."""
    import torch

    from mapanything_tpu_torch.ops.attention import plain_attention
    from mapanything_tpu_torch.ops.flash_attention import launch_shapes, reset_launch_counts

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        reset_launch_counts()
        with torch.inference_mode():
            kern = run()
        torch.cuda.synchronize()
        shapes = launch_shapes()
        with plain_attention(), torch.inference_mode():
            plain = run()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    for name in fields:
        if kern[name].dtype != torch.bool and not bool(torch.isfinite(kern[name]).all()):
            raise AssertionError(f"non-finite {name}")
    errs = compare_outputs({k: kern[k] for k in fields}, plain, fields, limit=DUST3R_SLICE_RTOL)
    return errs, shapes


def dust3r_slice_check(card) -> dict:
    """Phase 26: on the card, fp32 with TF32 off, each held to the same model on the plain
    versions: the small ModularDUSt3R (the registry's depths, heads of 64: the preset's
    heads of 16 have no kernel instance) at 2 views with its decoder features; its
    CrossAttentionTransformer alone at 3 views (contexts of 2 x 80 keys); and the small
    ablation MapAnything in the four other scene representations and with the linear head."""
    import torch

    from mapanything_tpu_torch.models.heads.adaptors import DenseAdaptorConfig, dense_components_for_scene_rep
    from mapanything_tpu_torch.models.info_sharing.cross_attention import CrossAttentionTransformer
    from mapanything_tpu_torch.models.mapanything import MapAnything, MapAnythingConfig, Views
    from mapanything_tpu_torch.models.modular_dust3r import ModularDUSt3R, small_config

    rng = np.random.RandomState(26)
    line = {"phase": "dust3r_slice", "phase_id": "26", "rtol": DUST3R_SLICE_RTOL}
    # The model at 2 views: 8 x 10 patches a view.
    cfg = small_config(enc_embed_dim=128, enc_num_heads=2, dec_embed_dim=128, dec_num_heads=2)
    model = ModularDUSt3R(cfg, device="cuda", seed=26)
    img = torch.from_numpy(rng.randn(1, 2, 128, 160, 3).astype(np.float32)).cuda()

    def dust3r():
        preds, feats = model(img, return_features=True)
        return {"pts3d": preds.pts3d, "conf": preds.conf, "features": feats}

    errs, shapes = against_plain(dust3r, ("pts3d", "conf", "features"))
    want = {(80, 64): 10}  # 2 encoder layers over both views, 2 decoder layers x 2 views x 2
    for name in ("flash_attention_fwd", "flash_attention_split_f32"):
        if shapes[name] != want:
            raise AssertionError(f"the small ModularDUSt3R launched {name} {shapes[name]}, not {want}")
    line["modular_dust3r"] = {"config": f"{cfg}, 1x2x128x160, seeded", "err_over_magnitude": errs,
                              "launches_by_shape": shape_counts(shapes)}
    # The decoder alone at 3 views: each view's context is the other two's 160 tokens.
    decoder = CrossAttentionTransformer(128, depth=2, dim=128, num_heads=2, indices=(0,)).cuda()
    feats = torch.from_numpy(rng.randn(1, 3, 8, 10, 128).astype(np.float32)).cuda()

    def three_views():
        out, inters = decoder(feats)
        return {"out": out, "tap": inters[0]}

    errs, shapes = against_plain(three_views, ("out", "tap"))
    want = {(80, 64): 6, (160, 64): 6}
    if shapes["flash_attention_fwd"] != want:
        raise AssertionError(f"the 3-view decoder launched {shapes['flash_attention_fwd']}, not {want}")
    line["cross_attention_3_views"] = {"config": "CrossAttentionTransformer(128, depth=2, dim=128, num_heads=2), "
                                                 "1x3x8x10", "err_over_magnitude": errs,
                                       "launches_by_shape": shape_counts(shapes)}
    # The small ablation model in the other scene representations and with the linear head.
    img = torch.from_numpy(rng.randn(1, 2, 56, 56, 3).astype(np.float32)).cuda()
    line["scene_representations"] = []
    for rep, head, factored in FAMILIES:
        cfg = MapAnythingConfig.small(
            scene_rep_type=rep, dense_head_type=head, use_factored_predictions_for_global_pointmaps=factored,
            dense_adaptor=DenseAdaptorConfig(components=dense_components_for_scene_rep(rep), with_confidence=True,
                                             with_mask=True))
        ablation_model = MapAnything(cfg, device="cuda", seed=26)

        def ablation():
            preds = ablation_model(Views(img=img))
            return {k: v for k, v in vars(preds).items() if v is not None}

        with torch.inference_mode():
            fields = tuple(ablation())
        errs, shapes = against_plain(ablation, fields)
        if not shapes["flash_attention_fwd"]:
            raise AssertionError(f"{rep} with the {head} head launched no attention kernel")
        line["scene_representations"].append({"scene_rep_type": rep, "dense_head_type": head,
                                              "use_factored_predictions_for_global_pointmaps": factored,
                                              "err_over_magnitude": errs,
                                              "launches_by_shape": shape_counts(shapes)["flash_attention_fwd"]})
    line.update(card=card["name"], power_limit=card["power_limit"])
    emit(line)
    return line


def dust3r_flagship(card, compute_dtype: str, kernel_rows, weights=None) -> dict:
    """Phase 27: ModularDUSt3R at the published widths (DUSt3R_ViTLarge_BaseDecoder_512_dpt) on
    one 512 x 384 pair in ``compute_dtype``, seeded weights (those of ``weights``, a state dict,
    where given): launches by (Tk, D) (72 at (768, 64), each after a split pass in fp32),
    the forward's CUDA-event time, pairs a second, peak memory, finite pts3d and features,
    conf >= 1; and the attention's share of the forward from phase 3's DUSt3R rows (the
    rest is the encoder's and decoder's products, RoPE, the norms and the DPT heads)."""
    import torch

    from mapanything_tpu_torch.models.modular_dust3r import ModularDUSt3R, ModularDUSt3RConfig
    from mapanything_tpu_torch.ops.flash_attention import launch_counts, launch_shapes, reset_launch_counts

    B, (H, W) = 1, DUST3R_HW
    fp32 = compute_dtype == "float32"
    cfg = ModularDUSt3RConfig(compute_dtype=compute_dtype)
    t0 = time.perf_counter()
    if weights is None:
        model = ModularDUSt3R(cfg, device="cuda", seed=0)
    else:  # the same weights without a second seeded initialisation
        with torch.device("meta"):
            model = ModularDUSt3R(cfg, device="meta")
        model.to_empty(device="cuda")
        model.load_state_dict(weights, strict=True)
    setup_s = time.perf_counter() - t0
    img = torch.from_numpy(np.random.RandomState(27).randn(B, 2, H, W, 3).astype(np.float32)).cuda()
    reset_launch_counts()
    with torch.inference_mode():
        model(img)
    torch.cuda.synchronize()
    counts, shapes = launch_counts(), launch_shapes()
    want = {"flash_attention_fwd": 72, "flash_attention_fwd_lse": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "flash_attention_split_f32": 72 if fp32 else 0}
    if not counts_match(counts, want) or shapes["flash_attention_fwd"] != {(768, 64): 72}:
        raise AssertionError(f"one DUSt3R forward launched {counts} ({shapes['flash_attention_fwd']}), not {want}")
    warmup, iters = 2, 5
    with torch.inference_mode():
        for _ in range(warmup):
            model(img)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        each = []
        for _ in range(iters):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            preds, feats = model(img, return_features=True)
            end.record()
            torch.cuda.synchronize()
            each.append(start.elapsed_time(end))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if tuple(preds.pts3d.shape) != (B, 2, H, W, 3) or tuple(preds.conf.shape) != (B, 2, H, W):
        raise AssertionError(f"unexpected shapes {tuple(preds.pts3d.shape)}, {tuple(preds.conf.shape)}")
    if not (bool(torch.isfinite(preds.pts3d).all()) and bool(torch.isfinite(preds.conf).all())
            and bool(torch.isfinite(feats).all())):
        raise AssertionError("non-finite DUSt3R outputs")
    if preds.conf.min().item() < 1.0:
        raise AssertionError("confidence below 1")
    ms = sum(each) / iters
    rows = [r for r in kernel_rows if r["dtype"] == compute_dtype and r["per_forward"]]
    attention_ms = sum((r["call_ms"] if fp32 else r["ms"]) * r["per_forward"] for r in rows)
    line = {
        "phase": "dust3r_flagship", "phase_id": "27",
        "config": f"ModularDUSt3RConfig(compute_dtype={compute_dtype!r}) (DUSt3R_ViTLarge_BaseDecoder_512_dpt "
                  f"widths), 1x2x{H}x{W}, seeded random weights",
        "setup_s": setup_s, "warmup": warmup, "iters": iters, "ms_per_forward": ms, "ms_each": each,
        "pairs_per_s": B / (ms / 1e3), "peak_mem_gib": peak_gib,
        "launches_per_forward": counts, "launches_by_shape": shape_counts(shapes),
        "attention_ms_per_forward": attention_ms, "share_outside_attention": 1.0 - attention_ms / ms,
        "pts3d_abs_max": preds.pts3d.abs().max().item(), "conf_min": preds.conf.min().item(),
        "card": card["name"], "power_limit": card["power_limit"],
    }
    emit(line)
    return {"line": line, "model": model}


def dust3r_phases(card, rows=None) -> dict:
    """The DUSt3R path: (without ``rows``) its rows of phase 3, then phase 26 and phase 27
    in fp32 and bf16 (the bf16 model holding the fp32 model's weights)."""
    import torch

    out = {"rows": kernel_checks(card, DUST3R_SHAPES, "3") if rows is None else rows}
    out["slice"] = dust3r_slice_check(card)
    gc.collect()
    torch.cuda.empty_cache()
    fp32 = dust3r_flagship(card, "float32", out["rows"])
    # The weights on the host, the card's memory freed: the bf16 run starts from an
    # empty caching allocator, as in a process of its own.
    weights = {k: v.cpu() for k, v in fp32.pop("model").state_dict().items()}
    gc.collect()
    torch.cuda.empty_cache()
    bf16 = dust3r_flagship(card, "bfloat16", out["rows"], weights)
    del bf16["model"], weights
    out["flagship"] = {"float32": fp32["line"], "bfloat16": bf16["line"]}
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dust3r_entries(dust3r) -> list:
    """Phases 26-27 in the kernels line: the forward (and, in fp32, its split pass) on the
    DUSt3R flagship's forward in each dtype, times per forward, with that run's launches;
    the 3-view context row under per_shape."""
    entries = []
    for dtype, line in dust3r["flagship"].items():
        rows = [r for r in dust3r["rows"] if r["dtype"] == dtype]
        main, also = [r for r in rows if r["per_forward"]], [r for r in rows if not r["per_forward"]]
        launches = {r["shape"]: r["per_forward"] for r in main}
        kinds = [("flash_attention_fwd", main, also, KERNEL_SOURCE)]
        if dtype == "float32":
            kinds.append(("flash_attention_split_f32", split_rows(main), split_rows(also), BWD_KERNEL_SOURCE))
        for name, entry_rows, also_rows, source in kinds:
            entries.append(path_entry(name, DUST3R_REPLACES, entry_rows, launches, also=also_rows, source=source,
                                      dtype=dtype, path=f"ModularDUSt3R 1x2x{DUST3R_HW[0]}x{DUST3R_HW[1]} "
                                                        f"(phase 27); times per forward"))
            entries[-1]["launches"] = line["launches_per_forward"][name]
    return entries


# The feed-forward baselines (phases 28-29) at their releases' widths: VGGT-1B and Pi3 on
# 1 x 8 x 518 (8 x 1374 tokens: a camera token or a register more than the ViT's 1 + 4 + 1369),
# MoGe-1, MoGe-2 and AnyCalib with ViT-L on 8 views of 518 (1370 tokens without registers),
# MUSt3R on 1 x 8 x 384 x 512 and Pow3R on one 384 x 512 pair with its three priors (768
# patches a view; Pow3R's decoder adds a CLS token). VGGT's camera trunk attends over the 8
# views' camera tokens at heads of 128. At fewer than 1024 queries the JAX sdpa takes XLA's
# attention (DUST3R_REPLACES); elsewhere the Pallas kernel of the JAX dispatch.
BASELINE_HW = (518, 518)
BASELINE_PAIR_HW = (384, 512)
# (name, B x Tq x H x D, dtype, {path: launches per forward}, replaced[, Tk: q, k, v three
# tensors]). MUSt3R's memory: the first two views decode together (keys 2 x 768), then view v
# of 2..7 against the v earlier views' tokens and its own ((v + 1) x 768 keys).
BASELINE_SHAPES = [
    ("vggt_1374", (8, 1374, 16, 64), "bfloat16", {"vggt": 48}, f"{FA}:395"),
    ("vggt_global", (1, 10992, 16, 64), "bfloat16", {"vggt": 24}, f"{FA}:516"),
    ("vggt_camera", (1, 8, 16, 128), "bfloat16", {"vggt": 16}, DUST3R_REPLACES),
    ("fp32_1374", (8, 1374, 16, 64), "float32", {"vggt": 48, "pi3": 57, "anycalib": 24}, f"{FA}:114"),
    ("fp32_global_10992", (1, 10992, 16, 64), "float32", {"vggt": 24, "pi3": 18}, f"{FA}:164"),
    ("fp32_vggt_camera", (1, 8, 16, 128), "float32", {"vggt": 16}, DUST3R_REPLACES),
    ("fp32_1370", (8, 1370, 16, 64), "float32", {"moge_1": 24, "moge_2": 24}, f"{FA}:114"),
    ("must3r_encoder", (8, 768, 16, 64), "float32", {"must3r": 24}, DUST3R_REPLACES),
    ("must3r_self_pair", (2, 768, 12, 64), "float32", {"must3r": 12}, DUST3R_REPLACES),
    ("must3r_self", (1, 768, 12, 64), "float32", {"must3r": 72}, DUST3R_REPLACES),
    ("must3r_cross_1536", (2, 768, 12, 64), "float32", {"must3r": 12}, DUST3R_REPLACES, 1536),
    *[(f"must3r_cross_{768 * (v + 1)}", (1, 768, 12, 64), "float32", {"must3r": 12}, DUST3R_REPLACES, 768 * (v + 1))
      for v in range(2, 8)],
    ("pow3r_encoder", (2, 768, 16, 64), "float32", {"pow3r": 24}, DUST3R_REPLACES),
    ("pow3r_decoder_self", (1, 769, 12, 64), "float32", {"pow3r": 24}, DUST3R_REPLACES),
    ("pow3r_decoder_cross", (1, 769, 12, 64), "float32", {"pow3r": 24}, DUST3R_REPLACES, 769),
]
# Phase 28: the registry's small presets with heads of 64 (the presets' heads of 16 have no
# kernel instance; VGGT's camera trunk then has heads of 128), on the card against the same
# models on the plain versions under against_plain's rule.
BASELINE_SMALL = {
    "vggt": dict(embed_dim=128, num_heads=2),
    "pi3": dict(dec_embed_dim=128, dec_num_heads=2, head_dec_embed_dim=128, head_num_heads=2),
    "moge": dict(backbone_size="small"),
    "moge_1": dict(backbone_size="small"),
    "moge_2": dict(encoder_size="small"),
    "anycalib": dict(patch_embed="vit", patch_embed_vit_size="small"),
    "must3r": dict(enc_embed_dim=128, enc_num_heads=2, dec_embed_dim=128, dec_num_heads=2),
    "pow3r": dict(enc_embed_dim=128, enc_num_heads=2, dec_embed_dim=128, dec_num_heads=2),
}
# Phase 29: each path's fp32 outputs against the same model on the plain versions (TF32
# off), of each field's magnitude (phase29_fields says which are held). In bf16 the aggregator's tokens at the DPT's hooks are held, by their mean
# |difference| over their mean magnitude: VGGT's depth and confidence are exp of a bf16
# number that seeded weights put near ±64, where one bf16 step (0.5) is a factor of e^0.5,
# and its camera head refines a bf16 estimate four times, so the outputs and the pose
# encoding are reported, not held.
BASELINE_FULL_RTOL = 1e-3
BASELINE_BF16_MEAN_RTOL = 2e-2


def baseline_inputs(name: str, shape, seed: int) -> dict:
    """Seeded inputs of a baseline wrapper on the card: images in [0, 1] (DUSt3R-normalised
    N(0, 1) for MUSt3R and Pow3R), and Pow3R's priors (a pinhole, depth with a hole, a
    relative pose)."""
    import torch

    rng = np.random.RandomState(seed)
    if name in ("must3r", "pow3r"):
        images = rng.randn(*shape, 3).astype(np.float32)
    else:
        images = rng.rand(*shape, 3).astype(np.float32)
    out = {"images": torch.from_numpy(images).cuda()}
    if name == "pow3r":
        B, _, H, W = shape
        K = np.tile(np.asarray([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]], np.float32), (B, 2, 1, 1))
        depth = (1.0 + rng.rand(B, 2, H, W)).astype(np.float32)
        depth[:, :, : H // 8, : W // 8] = 0.0
        poses = np.tile(np.eye(4, dtype=np.float32), (B, 2, 1, 1))
        c, s = np.cos(0.3), np.sin(0.3)
        poses[:, 1, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        poses[:, 1, :3, 3] = [0.5, -0.1, 0.2]
        out.update(intrinsics=torch.from_numpy(K).cuda(), depthmaps=torch.from_numpy(depth).cuda(),
                   camera_poses=torch.from_numpy(poses).cuda())
    return out


def flat_views(views) -> dict:
    """A wrapper's per-view dicts as one dict of tensors: ``field[v]``."""
    return {f"{k}[{v}]": x for v, d in enumerate(views) for k, x in d.items()}


def baseline_invariants(name: str, out: dict) -> dict:
    """The outputs' invariants: finite; unit rays and quaternions (orthonormal rotations);
    positive depth along the rays; confidence >= 1 where the model has the exp
    confidence (VGGT, MUSt3R, Pow3R; Pi3's confidence is a logit); MoGe's positive focal
    (clipped to [0.1, 20] of the half-diagonal; AnyCalib's least-squares focal of a
    random-weight field may take either sign). Returns the largest deviations."""
    import torch

    dev = {"ray_norm": 0.0, "quat_norm": 0.0}
    for key, x in out.items():
        field = key.split("[")[0]
        if x.dtype == torch.bool:
            continue
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name}: non-finite {key}")
        if field == "ray_directions":
            dev["ray_norm"] = max(dev["ray_norm"], (x.norm(dim=-1) - 1).abs().max().item())
        elif field == "cam_quats":
            dev["quat_norm"] = max(dev["quat_norm"], (x.norm(dim=-1) - 1).abs().max().item())
        elif field == "depth_along_ray" and not x.min().item() > 0:
            raise AssertionError(f"{name}: depth along the rays not positive in {key}")
        elif field == "conf" and name in ("vggt", "must3r", "pow3r") and x.min().item() < 1.0:
            raise AssertionError(f"{name}: confidence below 1 in {key}")
        elif field == "intrinsics" and name.startswith("moge") and not x[..., [0, 1], [0, 1]].min().item() > 0:
            raise AssertionError(f"{name}: focal not positive in {key}")
    if dev["ray_norm"] > 1e-4 or dev["quat_norm"] > 1e-4:
        raise AssertionError(f"{name}: rays or quaternions off the unit sphere: {dev}")
    return dev


def baseline_slice_check(card) -> dict:
    """Phase 28: each of the eight registry baselines at size="small" with heads of 64
    (BASELINE_SMALL), on the card, fp32 with TF32 off, against the same model on the plain
    versions (against_plain); the outputs' invariants; launches by (Tk, D)."""
    import torch

    from mapanything_tpu_torch.models.registry import init_model

    shapes_of = {"vggt": (1, 2, 56, 70), "pi3": (1, 2, 56, 70), "moge": (2, 56, 70), "moge_1": (2, 56, 70),
                 "moge_2": (1, 2, 56, 70), "anycalib": (2, 56, 70), "must3r": (1, 3, 64, 80),
                 "pow3r": (1, 2, 64, 80)}
    line = {"phase": "baseline_slice", "phase_id": "28", "rtol": DUST3R_SLICE_RTOL, "models": {}}
    for name, overrides in BASELINE_SMALL.items():
        model = init_model(name, size="small", device="cuda", seed=28, **overrides)
        inputs = baseline_inputs(name, shapes_of[name], 28)

        def run():
            return flat_views(model(**inputs))

        with torch.inference_mode():
            fields = tuple(run())
        errs, shapes = against_plain(run, fields)
        if not shapes["flash_attention_fwd"] or shapes["flash_attention_split_f32"] != shapes["flash_attention_fwd"]:
            raise AssertionError(f"{name} launched {shapes}")
        with torch.inference_mode():
            dev = baseline_invariants(name, run())
        line["models"][name] = {"config": f"{type(model.config).__name__}.small(**{overrides}), "
                                          f"{'x'.join(map(str, shapes_of[name]))}",
                                "err_over_magnitude_max": max(v for k, v in errs.items()
                                                              if not k.endswith("_agreement")),
                                "agreement_min": min((v for k, v in errs.items() if k.endswith("_agreement")),
                                                     default=None),
                                "invariants": dev, "launches_by_shape": shape_counts(shapes)["flash_attention_fwd"]}
        del model
        torch.cuda.empty_cache()
    line.update(card=card["name"], power_limit=card["power_limit"])
    emit(line)
    return line


# Phase 29's paths: (path, registry name, compute dtype, input shape), and each one's
# lse-free launches a forward by (Tk, D) (in fp32 as many split passes).
BASELINE_FULL = [
    ("vggt", "vggt", "float32", (1, 8) + BASELINE_HW),
    ("vggt_bf16", "vggt", "bfloat16", (1, 8) + BASELINE_HW),
    ("pi3", "pi3", "float32", (1, 8) + BASELINE_HW),
    ("moge_1", "moge_1", "float32", (8,) + BASELINE_HW),
    ("moge_2", "moge_2", "float32", (1, 8) + BASELINE_HW),
    ("anycalib", "anycalib", "float32", (8,) + BASELINE_HW),
    ("must3r", "must3r", "float32", (1, 8) + BASELINE_PAIR_HW),
    ("pow3r", "pow3r", "float32", (1, 2) + BASELINE_PAIR_HW),
]


def expected_baseline_launches(path: str) -> dict:
    """{(Tk, D): launches} of one forward of ``path``, from BASELINE_SHAPES."""
    dtype = "bfloat16" if path.endswith("_bf16") else "float32"
    model = path.replace("_bf16", "")
    out = {}
    for name, (b, t, h, d), row_dtype, per_forward, _, *key_length in BASELINE_SHAPES:
        if row_dtype == dtype and model in per_forward:
            key = (key_length[0] if key_length else t, d)
            out[key] = out.get(key, 0) + per_forward[model]
    return out


def compare_outputs(kern: dict, plain: dict, held, mean: bool = False, limit: float = None) -> dict:
    """A run with the kernels against one with the plain versions (phases 26, 28, 29):
    each field's largest |difference| over its magnitude (with ``mean``: its mean
    |difference| over its mean magnitude), masks by agreement (>= 0.999); the fields
    named in ``held`` within ``limit`` (by default BASELINE_FULL_RTOL,
    BASELINE_BF16_MEAN_RTOL with ``mean``), the others reported."""
    import torch

    errs = {}
    for key, a in kern.items():
        b = plain[key]
        if a.dtype == torch.bool:
            errs[key + "_agreement"] = (a == b).float().mean().item()
            continue
        a, b = a.float(), b.float()
        diff = (a - b).abs()
        if mean:
            errs[key] = diff.mean().item() / max(1e-12, b.abs().mean().item())
        else:
            errs[key] = diff.max().item() / max(1.0, b.abs().max().item())
    if limit is None:
        limit = BASELINE_BF16_MEAN_RTOL if mean else BASELINE_FULL_RTOL
    bad = {k: v for k, v in errs.items()
           if (v < 0.999 if k.endswith("_agreement") else k in held and not v <= limit)}
    if bad:
        raise AssertionError(f"the kernels and the plain versions disagree: {bad} (limit {limit})")
    return errs


def vggt_trunk_fields(model, images) -> dict:
    """VGGT's aggregator tokens at the DPT's hooks and its pose encoding."""
    inters, _ = model.aggregator(images)
    out = {f"aggregator_{i}": t for i, t in enumerate(inters)}
    out["pose_enc"] = model.camera_head(inters[-1][:, :, 0])
    return out


def phase29_fields(path: str, model, inputs) -> tuple:
    """One forward of ``path``'s wrapper as flat fields, the fields that phase 29 adds
    beside them, and the names it holds to the plain versions: every output, but in bf16
    VGGT's aggregator tokens (its outputs and pose encoding reported), and for AnyCalib
    the network's FoV field with the outputs except the pinhole fit and the rays drawn
    from it (a least-squares fit whose conditioning a seeded random field sets:
    reported)."""
    out = flat_views(model(**inputs))
    if path == "vggt_bf16":
        out.update(vggt_trunk_fields(model, inputs["images"]))
        return out, [k for k in out if k.startswith("aggregator_")]
    if path == "anycalib":
        out["fov_field"] = model.predict(inputs["images"])["fov_field"]
        return out, [k for k in out if not k.startswith(("intrinsics", "ray_directions"))]
    return out, list(out)


def baseline_flagship(card, path: str, name: str, compute_dtype: str, shape, weights=None) -> dict:
    """Phase 29, one path: the baseline at its release's widths in ``compute_dtype``, built on
    the meta device, its weights seeded on the card by ``init_params`` with a CUDA generator
    (those of ``weights``, a state dict, where given).
    One forward with the kernels then one with the plain versions (TF32 off; the launch
    counts of the first held to the path's), then, warmed once, ``iters`` CUDA-event-timed
    forwards: ms each, peak memory, the invariants of the outputs."""
    import torch

    from mapanything_tpu_torch.models.blocks import init_params
    from mapanything_tpu_torch.models.registry import MODEL_REGISTRY
    from mapanything_tpu_torch.ops.attention import plain_attention
    from mapanything_tpu_torch.ops.flash_attention import launch_counts, launch_shapes, reset_launch_counts

    fp32 = compute_dtype == "float32"
    t0 = time.perf_counter()
    with torch.device("meta"):
        model = MODEL_REGISTRY[name](device="meta", compute_dtype=compute_dtype)
    model.to_empty(device="cuda")
    if weights is None:  # seeded on the card: a billion parameters take the host ~18 s
        init_params(model, torch.Generator(device="cuda").manual_seed(0))
    else:
        model.load_state_dict(weights, strict=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    inputs = baseline_inputs(name, shape, 29)
    want = expected_baseline_launches(path)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        reset_launch_counts()
        with torch.inference_mode():
            model(**inputs)
            torch.cuda.synchronize()
            counts, shapes = launch_counts(), launch_shapes()
            kern, held = phase29_fields(path, model, inputs)
        with plain_attention(), torch.inference_mode():
            plain, _ = phase29_fields(path, model, inputs)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    n = sum(want.values())
    expect = {"flash_attention_fwd": n, "flash_attention_fwd_lse": 0, "flash_attention_bwd_dq": 0,
              "flash_attention_bwd_dkv": 0, "flash_attention_split_f32": n if fp32 else 0}
    if not counts_match(counts, expect) or shapes["flash_attention_fwd"] != want:
        raise AssertionError(f"one {path} forward launched {counts} ({shapes['flash_attention_fwd']}), not {expect} "
                             f"({want})")
    errs = compare_outputs(kern, plain, held, mean=not fp32)
    dev = baseline_invariants(name, {k: v for k, v in kern.items() if "[" in k})
    del kern, plain
    gc.collect()
    torch.cuda.empty_cache()
    warmup, iters = 1, 3
    with torch.inference_mode():
        for _ in range(warmup):
            model(**inputs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        each = []
        for _ in range(iters):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = model(**inputs)
            end.record()
            torch.cuda.synchronize()
            each.append(start.elapsed_time(end))
            del out
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ms = sum(each) / iters
    n_params = sum(p.numel() for p in model.parameters())
    line = {
        "phase": "baseline_flagship", "phase_id": "29", "path": path,
        "config": f"{type(model.config).__name__}(compute_dtype={compute_dtype!r}) (the release's widths), "
                  f"{'x'.join(map(str, shape))}, seeded random weights",
        "parameters": n_params, "setup_s": setup_s, "warmup": warmup, "iters": iters, "ms_per_forward": ms,
        "ms_each": each, "peak_mem_gib": peak_gib, "launches_per_forward": counts,
        "launches_by_shape": shape_counts(shapes), "launches_by_head_dim": by_head_dim(shapes),
        "err_vs_plain_held": max(errs[k] for k in held if k in errs), "err_rule": "max |diff| / max(1, max |plain|)" if fp32
        else "mean |diff| / mean |plain|", "err_by_field": errs,
        "agreement_min": min((v for k, v in errs.items() if k.endswith("_agreement")), default=None),
        "invariants": dev, "card": card["name"], "power_limit": card["power_limit"],
    }
    emit(line)
    return {"line": line, "model": model}


def baseline_phases(card, rows=None) -> dict:
    """The baselines: (without ``rows``) their rows of phase 3, then phase 28, then phase 29
    path by path (the bf16 VGGT on the fp32 VGGT's weights), the memory freed between them."""
    import torch

    out = {"rows": kernel_checks(card, BASELINE_SHAPES, "3") if rows is None else rows}
    out["slice"] = baseline_slice_check(card)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["flagship"], vggt_weights = {}, None
    for path, name, dtype, shape in BASELINE_FULL:
        res = baseline_flagship(card, path, name, dtype, shape, vggt_weights if path == "vggt_bf16" else None)
        model = res.pop("model")
        if path == "vggt":  # the weights on the host: the bf16 run starts from an empty allocator
            vggt_weights = {k: v.cpu() for k, v in model.state_dict().items()}
        del model
        out["flagship"][path] = res["line"]
        gc.collect()
        torch.cuda.empty_cache()
    out["phase_29_s"] = time.perf_counter() - t0
    emit({"phase": "baseline_flagships_total", "phase_id": "29", "seconds": out["phase_29_s"],
          "card": card["name"], "power_limit": card["power_limit"]})
    return out


BASELINE_PATHS = {"vggt": "VGGT-1B fp32", "vggt_bf16": "VGGT-1B bf16", "pi3": "Pi3 fp32", "moge_1": "MoGe-1 fp32",
                  "moge_2": "MoGe-2 fp32", "anycalib": "AnyCalib fp32", "must3r": "MUSt3R fp32",
                  "pow3r": "Pow3R fp32"}


def baseline_entries(bl) -> list:
    """Phases 28-29 in the kernels line: on each baseline path (phase 29), the lse-free
    forward (and in fp32 its split pass), one entry per TPU kernel replaced, with the
    phase-3 rows of that path (times per forward) and the run's launches at their shapes."""
    entries = []
    for path, line in bl["flagship"].items():
        model = path.replace("_bf16", "")
        dtype = "bfloat16" if path.endswith("_bf16") else "float32"
        rows = [r for r in bl["rows"] if r["dtype"] == dtype and model in r["per_forward"]]
        run = line["launches_by_shape"]["flash_attention_fwd"]
        kinds = [("flash_attention_fwd", KERNEL_SOURCE)]
        if dtype == "float32":
            kinds.append(("flash_attention_split_f32", BWD_KERNEL_SOURCE))
        for replaces in dict.fromkeys(r["replaces"] for r in rows):
            group = [r for r in rows if r["replaces"] == replaces]
            keys = {f"{r.get('tk', r['b_t_h_d'][1])}x{r['b_t_h_d'][3]}" for r in group}
            launches = {r["shape"]: r["per_forward"][model] for r in group}
            for name, source in kinds:
                entry_rows = group if name == "flash_attention_fwd" else split_rows(group)
                entries.append(path_entry(name, replaces, entry_rows, launches, source=source, dtype=dtype,
                                          path=f"{BASELINE_PATHS[path]} {line['config'].split(', ')[1]} (phase 29); "
                                               "times per forward"))
                entries[-1]["launches"] = sum(run[k] for k in keys)
    return entries


def worst_err(row) -> float:
    err = row["max_abs_err"]
    return max(err.values()) if isinstance(err, dict) else err


def path_entry(name, replaces, rows, launches, also=(), source=KERNEL_SOURCE, **extra):
    """One kernel on one path in the kernels line: each shape's times, bound
    and max error, and their sums over the path (times × ``launches[shape]``;
    null where a shape has none). The rows of ``also`` (shapes off the path) are
    listed under per_shape only."""
    def total(key):
        if any(r[key] is None for r in rows):
            return None
        return sum(r[key] * launches[r["shape"]] for r in rows)

    shape = lambda r: {k: r[k] for k in ("shape", "b_t_h_d", "tk", "dtype", "replaces", "max_abs_err", "ms",  # noqa: E731
                                         "plain_ms", "bound_ms", "library_ms", "exp_bound_ms", "ffma_bound_ms",
                                         "split_ms", "call_ms", "device_ms", "library_device_ms") if k in r}
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": sum(launches[r["shape"]] for r in rows),
        "max_abs_err": max(worst_err(r) for r in rows),
        **{key: total(key) for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in rows) else "bytes",
        "per_shape": [shape(r) | {"launches": launches[r["shape"]]} for r in rows] + [shape(r) for r in also],
        **extra,
    }


TRAIN_OUTPUTS = {"flash_attention_fwd_lse": ("o", "lse"), "flash_attention_bwd_dq": ("dq",),
                 "flash_attention_bwd_dkv": ("dk", "dv"), "flash_attention_split_f32": ()}
TRAIN_KERNELS = ("flash_attention_fwd_lse", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")  # every dtype's


def train_entry(name, train_rows, replaces, launches, steps, **extra):
    """One training kernel on one train step's path in the kernels line: each
    shape's times, bound and max error, and their sums per step."""
    outs = TRAIN_OUTPUTS[name]  # none for the split pass, held bitwise (max_abs_err 0)
    train_rows = [r for r in train_rows if name in r["kernels"]]
    main_train = [r for r in train_rows if r["per_step"]]
    per_step = lambda key: sum(r["kernels"][name][key] * r["per_step"] for r in main_train)  # noqa: E731
    return {
        "name": name,
        "route": "cuda",
        "source": KERNEL_SOURCE if name.endswith("lse") else BWD_KERNEL_SOURCE,
        "replaces": replaces,
        "launches": launches,
        "launches_per_step": launches // steps,
        "max_abs_err": max((r["max_abs_err"][o] for r in main_train for o in outs), default=0.0),
        "ms": per_step("ms"),
        "plain_ms": per_step("plain_ms"),
        "bound_ms": per_step("bound_ms"),
        "bound_by": "operations" if all(r["kernels"][name]["bound_by"] == "operations"
                                         for r in main_train) else "bytes",
        "library_ms": (None if any(r["kernels"][name]["library_ms"] is None for r in main_train)
                       else per_step("library_ms")),
        "per_shape": [dict(shape=r["shape"], dtype=r["dtype"], per_step=r["per_step"],
                           max_abs_err={o: r["max_abs_err"][o] for o in outs}, **r["kernels"][name])
                      for r in train_rows],
        **extra,
    }


def split_rows(rows) -> list:
    """The fp32 forward rows of phase 3 as rows of their split pass (held bitwise: error 0)."""
    return [{"shape": r["shape"], "b_t_h_d": r["b_t_h_d"], "dtype": r["dtype"], "replaces": r["replaces"],
             "max_abs_err": 0.0, "ms": r["split_ms"], "plain_ms": r["split_plain_ms"], "bound_ms": r["split_bound_ms"],
             "library_ms": None, "bound_by": "bytes"} for r in rows]


def summary_line(rows, train_rows, long_rows, many_view_rows, ring_bwd_row, inference_launches, train_launches,
                 train_steps, vp_launches, many_view_line, h128, fp32_train, fp32_forward, files, trainer, data, rgb,
                 dust3r, baseline, ba, bench, proc, masked, remat):
    """The kernels line: each kernel, what it replaces, its launches on its path
    (one forward; all train steps, and per step), its max error and its times
    per forward (inference) or per train step. The phase-3c rows are the
    forward kernel at the view-parallel paths' lengths: times per forward of
    phase 9 (12 launches each: the unsharded global layers, the ring steps).
    The phase-3d rows are the 64-view infer's (phase 13), K1 at its encoder
    and frame layers and K3 at its global layers, each with that run's
    launches at its key length; times per scene. The phase-3e rows are K8,
    the D = 128 instances, on flagship-h128's forward (phase 15) and train
    step (phase 16), with those runs' D = 128 launches (``h128``). The fp32 rows
    of phase 3b are the default-dtype train step's (phase 17: ``fp32_train``), the
    split pass among them (a layer's forward and backward splits); the fp32 rows of
    phase 3 the default-dtype forward's (phase 18: ``fp32_forward``, that run's counts),
    its split pass beside it. The phase-19 rows are the demo's forward (``files``: its rows and
    that run's launches by shape), times per scene; the Trainer's (phase 20, ``trainer``) are
    phase 3b's bf16 rows (the same shapes as phase 7's step), times per micro-batch, and its eval
    forward's rows, times per eval forward, each with that run's launches. The phase-21 rows
    are the data path's training kernels (``data``) by the TPU kernels that the JAX dispatch
    takes at its lengths, with that epoch's launches; times per micro-batch. The RGB rows
    of phases 3 and 3b (``rgb``) are the fp32 D = 32 instances on the MAE flagship's infer
    (phase 22) and train step (phase 23), with those runs' D = 32 launches. The DUSt3R rows
    of phase 3 (``dust3r``) are the forward on the DUSt3R flagship's forward in each dtype
    (phase 27), with that run's launches; the baselines' rows (``baseline``) the forward (and
    its split pass) on each baseline's forward at its release's widths (phase 29), with that
    run's launches; the BA slice's (``ba``) those of ``ba_entries`` (phases 31-33); the
    benchmark slice's (``bench``) those of ``benchmark_entries`` (phases 34-37); the processing
    slice's (``proc``) those of ``processing_entries`` (phases 38-40); the masked kernels
    (``masked``) those of ``masked_entries`` (phase 3h); the 24-view remat step's (``remat``)
    those of ``remat_entries`` (phases 3i and 44)."""
    main_rows = [r for r in rows if r["per_forward"] and r["dtype"] == "bfloat16"]
    kernels = [path_entry("flash_attention_fwd", "mapanything_tpu/ops/flash_attention.py:395", main_rows,
                          {r["shape"]: r["per_forward"] for r in main_rows},
                          also=[r for r in rows if not r["per_forward"]])]
    kernels[0]["launches"] = inference_launches  # the count of phase 5's run
    for name in TRAIN_KERNELS:
        kernels.append(train_entry(name, train_rows, TRAIN_REPLACES[name]["encoder"], train_launches[name],
                                   train_steps))
        if name != "flash_attention_fwd_lse":  # the ring's block against a merged lse (phase 10)
            kernels[-1]["per_shape"].append(dict(
                shape=ring_bwd_row["shape"], dtype="bfloat16", per_step=vp_launches["k7_per_step"],
                max_abs_err={o: ring_bwd_row["max_abs_err"][o] for o in TRAIN_OUTPUTS[name]},
                **ring_bwd_row["kernels"][name]))
    # Phase 3c: each row with a launch count stands for its kernel on phase 9's path;
    # the others of the same kernel ride along under per_shape.
    view_parallel = [r for r in long_rows if r["phase_id"] == "3c"]
    for r in view_parallel:
        if r["launches_key"] is None:
            continue
        others = [x for x in view_parallel if x["kernel"] == r["kernel"] and x is not r]
        kernels.append(path_entry(r["kernel"], r["replaces"], [r], {r["shape"]: vp_launches[r["launches_key"]]},
                                  also=others))
        if r["kernel"] == "flash_attention_fwd_lse":
            kernels[-1]["launches_per_train_step"] = vp_launches["k7_per_step"]
    # Phase 3d: the 64-view infer, one entry per TPU kernel replaced.
    by_length = many_view_line["lse_free_launches_by_length"]
    many = many_view_rows + [r for r in long_rows if r["phase_id"] == "3d"]
    for replaces in dict.fromkeys(r["replaces"] for r in many):
        group = [r for r in many if r["replaces"] == replaces]
        kernels.append(path_entry("flash_attention_fwd", replaces, group,
                                  {r["shape"]: by_length[str(r["b_t_h_d"][1])] for r in group},
                                  path="infer 1x64x518, head_chunk_size=8 (phase 13); times per scene"))
    # Phase 3e: K8, the D = 128 instances, on flagship-h128's paths.
    h_rows = [r for r in h128["rows"] if r["per_forward"]]
    kernels.append(path_entry("flash_attention_fwd", f"{FA}:214", h_rows, {r["shape"]: r["per_forward"] for r in h_rows},
                              also=[r for r in h128["rows"] if not r["per_forward"]], head_dim=128,
                              path="flagship-h128 forward 1x8x518 (phase 15); times per forward"))
    kernels[-1]["launches"] = h128["forward_launches"][128]  # phase 15's D = 128 launches
    for name in TRAIN_KERNELS:
        kernels.append(train_entry(name, h128["train_rows"], H128_TRAIN_REPLACES[name]["global_h128"],
                                   h128["train_launches"][name][128], h128["train_steps"], head_dim=128,
                                   path="flagship-h128 train step 1x4x518 (phase 16); times per step"))
    # Phase 17: the fp32 lse forward, the split passes, dq and dk/dv on the default-dtype step.
    for name in TRAIN_OUTPUTS:
        kernels.append(train_entry(name, fp32_train["rows"], TRAIN_REPLACES[name]["fp32_global"],
                                   fp32_train["launches"][name], fp32_train["steps"], dtype="float32",
                                   path="flagship fp32 train step 1x4x518 (phase 17); times per step"))
    # Phase 18: the fp32 lse-free forward and its split pass on the default-dtype forward.
    f_rows = [r for r in rows if r["per_forward"] and r["dtype"] == "float32"]
    f_launches = {r["shape"]: r["per_forward"] for r in f_rows}
    for name, entry_rows, source in (("flash_attention_fwd", f_rows, KERNEL_SOURCE),
                                     ("flash_attention_split_f32", split_rows(f_rows), BWD_KERNEL_SOURCE)):
        kernels.append(path_entry(name, f"{FA}:114", entry_rows, f_launches, source=source, dtype="float32",
                                  path="flagship fp32 forward 1x8x518 (phase 18); times per forward"))
        kernels[-1]["launches"] = fp32_forward[name]  # the count of phase 18's run
    kernels += files_trainer_entries(train_rows, files, trainer)
    kernels += data_path_entries(data)
    kernels += rgb_entries(rgb)
    kernels += dust3r_entries(dust3r)
    kernels += baseline_entries(baseline)
    kernels += ba_entries(ba)
    kernels += benchmark_entries(bench)
    kernels += processing_entries(proc)
    kernels += masked_entries(masked)
    kernels += remat_entries(remat)
    emit({"kernels": kernels})


def rgb_entries(rgb) -> list:
    """Phases 22-23 in the kernels line: the narrow fp32 D = 32 forward on the MAE
    flagship's infer (times per forward; no split pass), the training kernels and the
    backward's split pass on its train step (times per step), each with that run's D = 32
    launches."""
    r_rows = rgb["rows"]
    d32 = rgb["infer"]["mae"]["launches_by_head_dim"]
    entries = [path_entry("flash_attention_fwd", f"{FA}:114", r_rows, {r["shape"]: r["per_forward"] for r in r_rows},
                          dtype="float32", head_dim=32, path="MAE flagship infer 1x8x518 (phase 22); times per forward")]
    entries[-1]["launches"] = d32["flash_attention_fwd"][32]
    train = rgb["train"]
    for name in TRAIN_OUTPUTS:
        entries.append(train_entry(name, rgb["train_rows"], RGB_TRAIN_REPLACES[name]["mae_decoder"],
                                   train["launches_total_by_head_dim"][name][32], train["steps"], dtype="float32",
                                   head_dim=32, path="MAE flagship train step 1x4x518 (phase 23); times per step"))
    return entries


def files_trainer_entries(train_rows, files, trainer) -> list:
    """Phases 19-20 in the kernels line: the demo's forward and the Trainer's eval
    forward, one entry per TPU kernel replaced (times per forward, launches of the run),
    and the Trainer's training kernels (phase 3b's rows; times per micro-batch)."""
    entries = []
    for path, (path_rows, run_launches) in (
            ("demo 8x1024x768 PNGs -> 518x392 (phase 19); times per scene", files),
            ("Trainer eval 1x4x518, 2 eval forwards (phase 20); times per forward",
             (trainer["eval_rows"], trainer["eval_launches"]))):
        for replaces in dict.fromkeys(r["replaces"] for r in path_rows):
            group = [r for r in path_rows if r["replaces"] == replaces]
            entries.append(path_entry("flash_attention_fwd", replaces, group,
                                      {r["shape"]: r["per_forward"] for r in group}, path=path))
            entries[-1]["launches"] = sum(run_launches[r["shape"]] for r in group)
    for name in TRAIN_KERNELS:
        entries.append(train_entry(name, train_rows, TRAIN_REPLACES[name]["encoder"], trainer["launches"][name],
                                   trainer["micro_batches"],
                                   path="Trainer 1x4x518, accum_iter=2 (phase 20); times per micro-batch"))
    return entries


def multi_card_rank(rank: int, world_size: int, card: dict, unsharded_loss) -> None:
    """Phases 9 and 10 on one rank of ``world_size``, one card a rank (NCCL)."""
    import torch

    from mapanything_tpu_torch.parallel.mesh import make_view_group

    group = make_view_group()
    flagship_view_parallel(card, group)
    gc.collect()
    torch.cuda.empty_cache()
    flagship_train(card, group, unsharded_loss)


def multi_card(card, rendezvous: Path, unsharded_loss) -> None:
    """Phases 9 and 10 over 4 cards (2 where there are 2 or 3), one rank a card."""
    import torch

    from mapanything_tpu_torch.parallel.distributed import run_ranks

    cards = torch.cuda.device_count()
    run_ranks(multi_card_rank, 4 if cards >= 4 else 2, "cuda", rendezvous / "cards", card, unsharded_loss)


def rgb_phases(card, kernel_rows: bool = True) -> dict:
    """The RGB models' phases: (with ``kernel_rows``) the D = 32 rows of phases 3 and 3b,
    then phases 22, 23 and 24, with the memory freed between them."""
    import torch

    out = {}
    if kernel_rows:
        out["rows"] = kernel_checks(card, RGB_SHAPES, "3")
        out["train_rows"] = train_kernel_checks(card, RGB_TRAIN_SHAPES, RGB_TRAIN_REPLACES)
    for key, phase in (("infer", rgb_flagship_infer), ("train", rgb_flagship_train), ("losses", losses_phase)):
        out[key] = phase(card)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def one_rank_group(fn, card):
    """``fn(card)`` inside a process group of this process alone (NCCL, world size 1)."""
    import torch

    from mapanything_tpu_torch.parallel.distributed import init_distributed_mode

    rendezvous = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        init_distributed_mode("cuda", f"file://{rendezvous / 'one_rank'}", 0, 1)
        try:
            return fn(card)
        finally:
            torch.distributed.destroy_process_group()
    finally:
        shutil.rmtree(rendezvous, ignore_errors=True)


# ---- Bundle adjustment, the trackers and the optimisation baselines (phases 31-33) ----

# Phase 31: the COLMAP demo with bundle adjustment on the flagship (bf16) over phase 19's
# eight PNGs (518 x 392): tracks from the predictions (512 seeds a view: 4096 tracks x 8
# cameras) and from the photometric tracker (512 corners x 3 query frames), 10 Gauss-Newton
# iterations of 25 CG steps each (the JAX demo's). The card's BA is held to the port's CPU
# run: on the demo's tracks its first system in float64 (ba_against_cpu), on a well-posed
# synthetic problem of the same size the whole solve in fp32, the cost history within
# BA_COST_RTOL of its magnitude, the refined poses within BA_POSE_ATOL of theirs (fp32 sums
# in another order through a system that the 1e12 gauge prior makes stiff).
BA_COST_RTOL = 1e-3
BA_POSE_ATOL = 1e-3
BA_SYSTEM_RTOL = 1e-9  # the demo tracks' first system in float64, card against CPU (3e-16 read on an H100)
BA_TRACKERS = ("dense", "photometric")
# Phase 32: the VGGSfM tracker at its release widths over the same eight frames, 512
# queries from each of 3 query frames, coarse_iters=6, fine on. The coarse transformer
# (width 384, 8 heads of 48) runs 4 attentions a block, 6 blocks, 6 iterations: 144
# launches of fa_fwd_f32<48> a query frame; the fine one (width 256, heads of 32) 4 blocks
# x 6 iterations: 24 of fa_fwd_f32<32>. (name, B x Tq x H x D, dtype, launches a query
# frame, replaced, Tk): q, k and v are the packed in-projection's three outputs. At fewer
# than 1024 queries the JAX sdpa takes XLA's attention (DUST3R_REPLACES); the
# point-to-virtual attention takes _fwd_kernel_single (:114) from 1024 queries on.
TRACKER_QUERIES, TRACKER_QUERY_FRAMES, TRACKER_ITERS = 512, 3, 6
TRACKER_SHAPES = [
    ("tracker_time", (576, 8, 8, 48), "float32", 36, DUST3R_REPLACES, 8),
    ("tracker_virtual2point", (8, 64, 8, 48), "float32", 36, DUST3R_REPLACES, 512),
    ("tracker_virtual", (8, 64, 8, 48), "float32", 36, DUST3R_REPLACES, 64),
    ("tracker_point2virtual", (8, 512, 8, 48), "float32", 36, DUST3R_REPLACES, 64),
    ("tracker_fine_time", (512, 8, 8, 32), "float32", 24, DUST3R_REPLACES, 8),
]
# Phase 3's fp32 D = 32 row at phase 3f's 129 x 4000 keys, where the JAX dispatch took
# _fwd_stream_aug (:164): no path runs it (the MAE decoder attends within a view).
D32_LONG_SHAPES = [("fp32_d32_129x4000", (2, 129, 3, 32), "float32", 0, f"{FA}:164", 4000)]
# Phase 3f's narrow canary cases at the tracker's five shapes, (Tq, Tk, B, H).
TRACKER_CANARY_CASES = [(8, 8, 576, 8), (64, 512, 8, 8), (64, 64, 8, 8), (512, 64, 8, 8), (8, 8, 512, 8)]
# The tracker's flow heads scaled by this (both runs): steps of a pixel or so an iteration,
# as trained weights take; seeded weights take tens of pixels, send tracks out of the frame
# and turn fp32 rounding into whole-pixel shifts of the fine tracker's patches (its floor).
TRACKER_FLOW_SCALE = 0.01
TRACKER_PX_ATOL = 0.05  # tracks, kernels against plain versions
TRACKER_VIS_ATOL = 1e-2  # visibility scores (sigmoids: 9.7e-4 read on an H100 in the first run)
# Phase 33: the optimisation baselines on 4 views of 384 x 512 (12 ordered pairs) at their
# releases' widths, fp32, seeded on the card; each against the same run on the plain
# versions (TF32 off), the tolerance beside each held quantity (the Adam steps of a global
# alignment amplify the kernels' rounding of the pair pointmaps). MASt3R-SGA's alignment
# follows its reciprocal matches, which argmax near-ties flip: its pairs and matches are
# held (mast3r_pairs_against_plain), its loss, focals and poses reported. The alignments
# run a third of their releases' Adam steps (300, and 300 + 300 for MASt3R-SGA's two
# stages): the steps are host-paced, and the whole script has to stay well inside its
# time limit.
OPTIM_VIEWS, OPTIM_HW = 4, (384, 512)
OPTIM_RTOL = {"loss": 1e-2, "focals": 1e-2, "cam2world": 1e-2}
OPTIM_PATHS = [("dust3r_ba", {"global_optim_niter": 100}), ("pow3r_ba", {"global_optim_niter": 100}),
               ("mast3r_sga", {"desc_dim": 24, "matching_subsample": 8, "sparse_ga_niter1": 100,
                               "sparse_ga_niter2": 100})]
# Phase 3's rows of the optimisation paths: (name, B x Tq x H x D, dtype, {path: launches a
# scene}, replaced[, Tk]). DUSt3R-BA and Pow3R-BA run the 12 pairs as one batch (24 views in
# the encoder), MASt3R-SGA a pair a forward.
OPTIM_SHAPES = [
    ("ba_encoder_24_views", (24, 768, 16, 64), "float32", {"dust3r_ba": 24, "pow3r_ba": 24}, DUST3R_REPLACES),
    ("ba_dust3r_decoder_self", (12, 768, 12, 64), "float32", {"dust3r_ba": 24}, DUST3R_REPLACES),
    ("ba_dust3r_decoder_cross", (12, 768, 12, 64), "float32", {"dust3r_ba": 24}, DUST3R_REPLACES, 768),
    ("ba_pow3r_decoder_self", (12, 769, 12, 64), "float32", {"pow3r_ba": 24}, DUST3R_REPLACES),
    ("ba_pow3r_decoder_cross", (12, 769, 12, 64), "float32", {"pow3r_ba": 24}, DUST3R_REPLACES, 769),
    ("mast3r_encoder", (2, 768, 16, 64), "float32", {"mast3r_sga": 288}, DUST3R_REPLACES),
    ("mast3r_decoder_self", (1, 768, 12, 64), "float32", {"mast3r_sga": 288}, DUST3R_REPLACES),
    ("mast3r_decoder_cross", (1, 768, 12, 64), "float32", {"mast3r_sga": 288}, DUST3R_REPLACES, 768),
]


def flagship_on_card(compute_dtype: str = "bfloat16", geometric_inputs: bool = False, seed: int = 0):
    """The flagship built on the meta device and seeded on the card (``init_params`` with a
    CUDA generator)."""
    import torch

    from mapanything_tpu_torch.models.blocks import init_params
    from mapanything_tpu_torch.models.mapanything import MapAnything

    with torch.device("meta"):
        model = MapAnything(flagship_config(12, compute_dtype), device="meta", geometric_inputs=geometric_inputs)
    model.to_empty(device="cuda")
    init_params(model, torch.Generator(device="cuda").manual_seed(seed))
    return model


def _tracks_on(tracks, device, dtype):
    """``tracks`` on ``device``, its float fields in ``dtype``."""
    import dataclasses as dc

    import torch

    return type(tracks)(**{f.name: getattr(tracks, f.name).to(device, dtype if getattr(tracks, f.name).is_floating_point()
                                                               else None) for f in dc.fields(tracks)})


def ba_against_cpu(tracks) -> dict:
    """The card's BA on the demo's tracks against the port's CPU run on the same tracks.
    Held: the first iteration's Huber-weighted residuals and Jacobian blocks
    (``_build_system`` at the initial state) in float64, each entry within BA_SYSTEM_RTOL
    of max(1, its magnitude). Reported: the same in fp32, and the whole 10 x 25 solve's
    gaps in fp32 and float64. Seeded weights put the tracks' points at random depths (up
    to ~4e7 from the cameras in the first runs): in fp32, R X + t then cancels to noise for
    points near a camera plane, on the card and on the CPU alike, and the stiff system
    (1e12 gauge prior) takes the LM loop to other steps in either dtype (phase 31 holds the
    whole fp32 solve on the synthetic problem instead, synthetic_ba_check)."""
    import torch

    from mapanything_tpu_torch.ba.solver import BAState, _build_system, ba_solve, refined_camera_poses

    def system(device, dtype):
        t = _tracks_on(tracks, device, dtype)
        return _build_system(t, BAState(t.cam_from_world_rot, t.cam_from_world_trans, t.points3d), 2.0)

    gaps = {}
    for dtype, name in ((torch.float64, "float64"), (torch.float32, "float32")):
        gaps[name] = {k: ((got.cpu() - want).abs() / torch.clamp(want.abs(), min=1.0)).max().item()
                      for k, got, want in zip(("r", "Jc", "Jp"), system("cuda", dtype), system("cpu", dtype))}
    if not all(v <= BA_SYSTEM_RTOL for v in gaps["float64"].values()):
        raise AssertionError(f"the card's float64 BA system on the demo's tracks is {gaps['float64']} from the CPU's "
                             f"(limit {BA_SYSTEM_RTOL})")
    out = {"system_err_vs_cpu": gaps, "points_abs_max": tracks.points3d.abs().max().item()}
    for dtype, name in ((torch.float32, "float32"), (torch.float64, "float64")):
        (pose_c, cost_c), (pose_h, cost_h) = (
            (refined_camera_poses(st).cpu().double(), c.cpu().double())
            for st, c in (ba_solve(_tracks_on(tracks, device, dtype), 10, 25) for device in ("cuda", "cpu")))
        out[f"solve_{name}_vs_cpu"] = {
            "cost": (cost_c - cost_h).abs().max().item() / max(1.0, cost_h.abs().max().item()),
            "pose": (pose_c - pose_h).abs().max().item() / max(1.0, pose_h.abs().max().item())}
    return out


def synthetic_ba_check(card) -> dict:
    """Phase 31's fp32 hold on a well-posed problem of the demo's size: 4096 tracks of a
    point cloud seen by 8 cameras on an arc, 0.5 px noise, 5% outliers, a tenth of the
    observations invalid, poses and points perturbed; the card's fp32 BA (10 x 25) against
    the CPU's fp32 run within BA_COST_RTOL (costs) and BA_POSE_ATOL (poses), the rms
    reprojection error before and after, and ``ba_solve_sharded`` on a one-rank group."""
    import torch

    from mapanything_tpu_torch.ba.solver import BAState, _total_cost, ba_solve, ba_solve_sharded, refined_camera_poses
    from mapanything_tpu_torch.ba.tracks import Tracks

    rng = np.random.RandomState(31)
    N, M = 4096, FILES_VIEWS
    points = rng.uniform(-1, 1, (N, 3))
    points[:, 2] += 6.0
    K = np.array([[400.0, 0, 259.0], [0, 400.0, 196.0], [0, 0, 1]])
    rots, transs, uvs = [], [], []
    for m in range(M):
        a = (m - M / 2) * 0.1
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]).T
        t = -R @ np.array([np.sin(a) * 6.0, 0.0, 6.0 - np.cos(a) * 6.0])
        uv = (points @ R.T + t) @ K.T
        uvs.append(uv[:, :2] / uv[:, 2:3] + rng.randn(N, 2) * 0.5)
        w = rng.randn(3) * 0.01
        th = np.linalg.norm(w)
        k = w / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        rots.append((np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx) @ R)
        transs.append(t + rng.randn(3) * 0.05)
    uv = np.stack(uvs, 1)
    uv[rng.rand(N, M) < 0.05] += 20.0
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).cuda()  # noqa: E731
    tracks = Tracks(points3d=f32(points + rng.randn(N, 3) * 0.01), observations_uv=f32(uv),
                    valid=torch.from_numpy(rng.rand(N, M) > 0.1).cuda(), intrinsics=f32(np.stack([K] * M)),
                    cam_from_world_rot=f32(np.stack(rots)), cam_from_world_trans=f32(np.stack(transs)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, costs = ba_solve(tracks, 10, 25)
    torch.cuda.synchronize()
    ba_ms = 1e3 * (time.perf_counter() - t0)
    cpu_state, cpu_costs = ba_solve(_tracks_on(tracks, "cpu", torch.float32), 10, 25)
    cost_err = (costs.cpu() - cpu_costs).abs().max().item() / max(1.0, cpu_costs.abs().max().item())
    poses, cpu_poses = refined_camera_poses(state).cpu(), refined_camera_poses(cpu_state)
    pose_err = (poses - cpu_poses).abs().max().item() / max(1.0, cpu_poses.abs().max().item())
    n_obs = int(tracks.valid.sum())
    initial = BAState(tracks.cam_from_world_rot, tracks.cam_from_world_trans, tracks.points3d)
    rms = [float(np.sqrt(float(_total_cost(tracks, s, 2.0)) / n_obs)) for s in (initial, state)]
    if not (cost_err <= BA_COST_RTOL and pose_err <= BA_POSE_ATOL and rms[1] < rms[0]):
        raise AssertionError(f"fp32 BA on the synthetic problem: card vs CPU costs {cost_err}, poses {pose_err}; rms "
                             f"{rms}")
    # The track-sharded solve on a process group of this process alone (NCCL at world size
    # 1: every all_reduce and the points' all_gather pass values through): bitwise ba_solve's.
    sh_state, sh_costs = one_rank_group(lambda _: ba_solve_sharded(tracks, None, 10, 25), card)
    sharded_equal = (torch.equal(sh_costs, costs) and torch.equal(sh_state.rot, state.rot)
                     and torch.equal(sh_state.trans, state.trans) and torch.equal(sh_state.points, state.points))
    if not sharded_equal:
        raise AssertionError("ba_solve_sharded on one rank differs from ba_solve")
    return {"tracks": N, "cameras": M, "observations": n_obs, "ba_ms": ba_ms, "costs": costs.tolist(),
            "rms_px_before": rms[0], "rms_px_after": rms[1], "cost_err_vs_cpu": cost_err, "pose_err_vs_cpu": pose_err,
            "sharded_one_rank_bitwise": sharded_equal}


def ba_colmap_phase(card) -> dict:
    """Phase 31: ``tools/demo_colmap.py`` with ``--use-ba`` on the flagship (bf16, seeded on the
    card), once per track source: the stage times, the lse-free launches of its infer (held
    to phase 19's), the costs before and after and the rms reprojection error, the BA held
    to the CPU's (ba_against_cpu; synthetic_ba_check in fp32), the written ``sparse/*.bin`` read back (8 cameras and
    images, poses equal to the refined ones, points). Then
    ``tools/demo_inference_on_colmap_outputs.py`` on the written model (the multimodal
    flagship with the model's calibration and poses): its launches, finite outputs."""
    import torch

    from mapanything_tpu_torch.tools import demo_colmap
    from mapanything_tpu_torch.tools import demo_inference_on_colmap_outputs as demo_inf
    from mapanything_tpu_torch.utils.colmap import colmap_qt_to_c2w, read_model
    from mapanything_tpu_torch.ops.flash_attention import launch_counts, launch_shapes, reset_launch_counts

    work = ROOT / "build" / "ba_colmap"
    write_demo_pngs(work / "images")
    t0 = time.perf_counter()
    model = flagship_on_card()
    setup_s = time.perf_counter() - t0
    t = FILES_VIEWS * 1036 + 1
    want_shapes = {(1037, 64): 24, (1036, 64): 12, (t, 64): 12}
    line = {"phase": "ba_colmap", "phase_id": "31", "setup_s": setup_s,
            "config": "MapAnythingConfig(compute_dtype='bfloat16') seeded on the card, 8 PNGs of 1024x768 -> "
                      "518x392, demo_colmap --use-ba, 10 GN iterations x 25 CG steps",
            "runs": {}}
    launches = {}
    for tracker in BA_TRACKERS:
        args = demo_colmap.parse_args(["--images", str(work / "images"), "--out", str(work), "--use-ba",
                                       "--tracker", tracker, "--device", "cuda"])
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        res = demo_colmap.run(args, model=model)
        torch.cuda.synchronize()
        counts, shapes = launch_counts(), launch_shapes()
        if counts["flash_attention_fwd"] != 48 or shapes["flash_attention_fwd"] != want_shapes or any(
                n for k, n in counts.items() if k != "flash_attention_fwd"):
            raise AssertionError(f"the BA demo ({tracker}) launched {counts} ({shapes['flash_attention_fwd']})")
        launches[tracker] = dict(shapes["flash_attention_fwd"])
        tracks, costs = res["tracks"], res["costs"]
        if not bool(torch.isfinite(costs).all()) or not bool(torch.isfinite(res["state"].points).all()):
            raise AssertionError(f"non-finite BA state or costs ({tracker})")
        if res["final_cost"] > res["initial_cost"] * (1 + 1e-6):  # the history holds refused steps too
            raise AssertionError(f"BA raised the cost ({tracker}): {res['initial_cost']} -> {res['final_cost']}")
        held = ba_against_cpu(tracks)
        cameras, images, points = read_model(work / "sparse", ".bin")
        poses = {im.name: colmap_qt_to_c2w(im.qvec, im.tvec) for im in images.values()}
        names = [Path(p).name for p in res["paths"]]
        read_err = max(np.abs(poses[n] - res["poses"][i]).max() / max(1.0, np.abs(res["poses"][i]).max())
                       for i, n in enumerate(names))
        if len(cameras) != FILES_VIEWS or len(images) != FILES_VIEWS or not points or read_err > 1e-5:
            raise AssertionError(f"sparse/ read back {len(cameras)} cameras, {len(images)} images, {len(points)} "
                                 f"points, poses {read_err} (of their magnitude) from the refined ones")
        n_obs = res["n_obs"]
        line["runs"][tracker] = {
            "ms": {k: 1e3 * v for k, v in res["seconds"].items()}, "tracks": int(tracks.valid.shape[0]),
            "cameras": int(tracks.valid.shape[1]), "observations": int(tracks.valid.sum()),
            "initial_cost": res["initial_cost"], "final_cost": res["final_cost"], "costs": costs.tolist(),
            "rms_px_before": float(np.sqrt(res["initial_cost"] / n_obs)),
            "rms_px_after": float(np.sqrt(res["final_cost"] / n_obs)), **held,
            "sparse_read_back": {"cameras": len(cameras), "images": len(images), "points": len(points),
                                 "pose_err": float(read_err)},
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        del res, tracks
    del model
    gc.collect()
    torch.cuda.empty_cache()
    line["synthetic_fp32"] = synthetic_ba_check(card)

    # The written model into the inference demo: the multimodal flagship, calibration and poses.
    t0 = time.perf_counter()
    model = flagship_on_card(geometric_inputs=True)
    args = demo_inf.parse_args(["--data", str(work), "--out", str(work / "inference"), "--device", "cuda"])
    reset_launch_counts()
    res = demo_inf.run(args, model=model)
    torch.cuda.synchronize()
    counts, shapes = launch_counts(), launch_shapes()
    if counts["flash_attention_fwd"] != 48 or shapes["flash_attention_fwd"] != want_shapes:
        raise AssertionError(f"the inference demo launched {counts} ({shapes['flash_attention_fwd']})")
    out = res["outputs"]
    check_infer_outputs(out, (1, FILES_VIEWS, 392, 518))
    written = sorted(p.name for p in (work / "inference").iterdir())
    if written != ["points.ply", "predictions.npz", "scene.glb"] or res["intrinsics"].shape != (1, 8, 3, 3):
        raise AssertionError(f"the inference demo wrote {written}, calibration {res['intrinsics'].shape}")
    line["inference_on_colmap"] = {"ms": {k: 1e3 * v for k, v in res["seconds"].items()},
                                   "total_s": time.perf_counter() - t0, "outputs": written,
                                   "launches_by_shape": shape_counts(shapes)["flash_attention_fwd"]}
    line.update(launches_by_shape={k: {f"{tk}x{d}": n for (tk, d), n in v.items()} for k, v in launches.items()},
                card=card["name"], power_limit=card["power_limit"])
    emit(line)
    del model, res, out
    shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return line


def tracker_phase(card) -> dict:
    """Phase 32: the VGGSfM tracker (the registry's ``vggsfm_tracker``, seeded; flow heads
    scaled by TRACKER_FLOW_SCALE) through ``ba.tracker.predict_tracks_learned`` on the demo's
    eight frames: launches by (Tk, D) held to TRACKER_SHAPES' (a query frame's, times 3; no
    split pass), the
    tracks and visibility held to the same call under ``plain_attention()`` (TF32 off), the
    CUDA-event time a query frame, peak memory."""
    import torch

    from mapanything_tpu_torch.ba.tracker import predict_tracks_learned
    from mapanything_tpu_torch.models.registry import init_model
    from mapanything_tpu_torch.ops.attention import plain_attention
    from mapanything_tpu_torch.ops.flash_attention import launch_counts, launch_shapes, reset_launch_counts
    from mapanything_tpu_torch.utils.image import load_images

    work = ROOT / "build" / "tracker"
    write_demo_pngs(work / "images")
    frames = load_images(str(work / "images"), device="cuda")["images_no_norm"]
    t0 = time.perf_counter()
    model = init_model("vggsfm_tracker", device="cuda", seed=32)
    with torch.no_grad():
        for pred in (model.coarse_predictor, model.fine_predictor):
            pred.updateformer.flow_head.weight.mul_(TRACKER_FLOW_SCALE)
    setup_s = time.perf_counter() - t0
    kw = dict(max_query_pts=TRACKER_QUERIES, query_frame_num=TRACKER_QUERY_FRAMES, coarse_iters=TRACKER_ITERS)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        kern = predict_tracks_learned(frames, model, **kw)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        counts, shapes = launch_counts(), launch_shapes()
        with plain_attention():
            plain = predict_tracks_learned(frames, model, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    q = TRACKER_QUERY_FRAMES
    want = {}
    for _, (b, t, h, d), _, per_frame, _, tk in TRACKER_SHAPES:
        want[(tk, d)] = want.get((tk, d), 0) + q * per_frame
    n = sum(want.values())
    expect = {"flash_attention_fwd": n, "flash_attention_fwd_lse": 0, "flash_attention_bwd_dq": 0,
              "flash_attention_bwd_dkv": 0, "flash_attention_split_f32": 0}  # the narrow forward splits in-kernel
    if not counts_match(counts, expect) or shapes["flash_attention_fwd"] != want:
        raise AssertionError(f"the tracker launched {counts} ({shapes['flash_attention_fwd']}), not {expect} ({want})")
    tracks, vis, scores = kern
    if not (np.isfinite(tracks).all() and np.isfinite(scores).all()) or tracks.shape[0] != FILES_VIEWS:
        raise AssertionError(f"non-finite or misshapen tracks {tracks.shape}")
    px_err = float(np.abs(tracks - plain[0]).max())
    vis_err = float(np.abs(scores - plain[2]).max())
    agree = float((vis == plain[1]).mean())
    if px_err > TRACKER_PX_ATOL or vis_err > TRACKER_VIS_ATOL:
        raise AssertionError(f"the tracker's kernels and plain versions differ by {px_err} px, {vis_err} in "
                             f"visibility (limits {TRACKER_PX_ATOL}, {TRACKER_VIS_ATOL})")
    # One query frame's forward, CUDA-event timed (warm).
    order = list(range(FILES_VIEWS))
    uv = torch.rand(1, TRACKER_QUERIES, 2, device="cuda", generator=torch.Generator(device="cuda").manual_seed(32))
    uv = uv * torch.tensor([517.0, 391.0], device="cuda")
    each = []
    with torch.inference_mode():
        model(frames[order][None], uv, coarse_iters=TRACKER_ITERS)
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            model(frames[order][None], uv, coarse_iters=TRACKER_ITERS)
            end.record()
            torch.cuda.synchronize()
            each.append(start.elapsed_time(end))
    line = {"phase": "vggsfm_tracker", "phase_id": "32",
            "config": f"VGGSfMTracker (coarse 384 / 8 heads / depth 6, fine 256 / depth 4), seeded, flow heads x"
                      f"{TRACKER_FLOW_SCALE}; 8 frames of 518x392, {TRACKER_QUERIES} queries x {q} query frames, "
                      f"coarse_iters={TRACKER_ITERS}, fine on",
            "parameters": sum(p.numel() for p in model.parameters()), "setup_s": setup_s,
            "predict_tracks_learned_s": call_s, "ms_per_query_frame": sum(each) / len(each), "ms_each": each,
            "peak_mem_gib": peak_gib, "tracks": list(tracks.shape), "visible_share": float(vis.mean()),
            "launches": counts, "launches_by_shape": shape_counts(shapes)["flash_attention_fwd"],
            "launches_per_query_frame": {k: v // q for k, v in shape_counts(shapes)["flash_attention_fwd"].items()},
            "px_err_vs_plain": px_err, "vis_err_vs_plain": vis_err, "vis_agreement": agree,
            "card": card["name"], "power_limit": card["power_limit"]}
    emit(line)
    del model
    shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return line


def optim_inputs(name: str) -> dict:
    """Phase 33's inputs: 4 seeded views (N(0, 1), DUSt3R-normalised), and Pow3R's priors."""
    import torch

    rng = np.random.RandomState(33)
    H, W = OPTIM_HW
    V = OPTIM_VIEWS
    out = {"images": torch.from_numpy(rng.randn(1, V, H, W, 3).astype(np.float32)).cuda()}
    if name == "pow3r_ba":
        K = np.tile(np.asarray([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]], np.float32), (1, V, 1, 1))
        depth = (1.0 + rng.rand(1, V, H, W)).astype(np.float32)
        depth[:, :, : H // 8, : W // 8] = 0.0
        poses = np.tile(np.eye(4, dtype=np.float32), (1, V, 1, 1))
        for v in range(1, V):
            a = 0.1 * v
            poses[0, v, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
            poses[0, v, :3, 3] = [0.2 * v, -0.05, 0.1]
        out.update(intrinsics=torch.from_numpy(K).cuda(), depthmaps=torch.from_numpy(depth).cuda(),
                   camera_poses=torch.from_numpy(poses).cuda())
    return out


def optim_scene(model, name: str, inputs) -> dict:
    """One scene through a wrapper: its final loss, focals and cam2world poses (finite views)."""
    import torch

    views = model(**inputs)
    for v in views:
        for key, x in v.items():
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"{name}: non-finite {key}")
    scene = model.scene
    return {"loss": scene.loss, "focals": torch.from_numpy(scene.focals).double(),
            "cam2world": torch.from_numpy(scene.cam2world).double()}


MAST3R_AGREE_MIN = 0.99  # reciprocal matches of the kernels' run that the plain versions' run also finds


def mast3r_pairs_against_plain(model, images) -> dict:
    """MASt3R-SGA's pair forwards on the kernels against the plain versions (TF32 off): each
    output within BASELINE_FULL_RTOL of its magnitude (as phase 29's fp32 baselines), and
    the share of reciprocal matches (pixel pairs and validity) that both runs find, at least
    MAST3R_AGREE_MIN. An argmax over 196608 similarities flips where two are within the
    descriptors' rounding, and a flipped match moves the sparse alignment, whose result
    (OPTIM_PATHS' Adam steps on seeded weights) phase 33 reports beside it."""
    import torch

    from mapanything_tpu_torch.models.external.mast3r import reciprocal_matches
    from mapanything_tpu_torch.ops.attention import plain_attention

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        edges, kern = model.pair_outputs(images)
        with plain_attention():
            _, plain = model.pair_outputs(images)
        errs, agree, total = {}, 0, 0
        for e, (k, p) in enumerate(zip(kern, plain)):
            for key in k:
                errs[key] = max(errs.get(key, 0.0), (k[key] - p[key]).abs().max().item()
                                / max(1.0, p[key].abs().max().item()))
            mk = reciprocal_matches(k["desc"][0, 0], k["desc"][0, 1], model.subsample)
            mp = reciprocal_matches(p["desc"][0, 0], p["desc"][0, 1], model.subsample)
            same = (mk[1] == mp[1]).all(-1) & (mk[2] == mp[2])
            agree += int(same.sum())
            total += same.numel()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    share = agree / total
    bad = {k: v for k, v in errs.items() if not v <= BASELINE_FULL_RTOL}
    if bad or share < MAST3R_AGREE_MIN:
        raise AssertionError(f"MASt3R's pairs on the kernels and the plain versions: {bad} (limit {BASELINE_FULL_RTOL}), "
                             f"matches agreeing {share} (at least {MAST3R_AGREE_MIN})")
    return {"pair_err_vs_plain": errs, "matches": total, "match_agreement": share}


def optim_phase(card) -> dict:
    """Phase 33: DUSt3R-BA (and metric DUSt3R, the same registry entry and model), Pow3R-BA with
    its three priors and MASt3R-SGA at their releases' widths, fp32, built on the meta
    device and seeded on the card, on 4 views of 384 x 512: launches by (Tk, D), the final
    loss, focals and poses held to the same scene on the plain versions (TF32 off; limits in
    OPTIM_RTOL; for MASt3R-SGA its pair outputs and matches instead, the alignment reported),
    ms a scene (CUDA events; the alignment's Adam loop included: the first scene, then a
    warm one and its pair forwards alone), peak memory."""
    import torch

    from mapanything_tpu_torch.models.blocks import init_params
    from mapanything_tpu_torch.models.registry import MODEL_REGISTRY
    from mapanything_tpu_torch.ops.attention import plain_attention
    from mapanything_tpu_torch.ops.flash_attention import launch_counts, launch_shapes, reset_launch_counts

    line = {"phase": "optim_baselines", "phase_id": "33", "views": OPTIM_VIEWS, "hw": list(OPTIM_HW),
            "rtol": OPTIM_RTOL, "paths": {}}
    with torch.device("meta"):
        metric = MODEL_REGISTRY["metric_dust3r"](device="meta")
        same = MODEL_REGISTRY["dust3r_ba"](device="meta")
    if type(metric) is not type(same) or metric.config != same.config:
        raise AssertionError("metric_dust3r does not build DUSt3R-BA's model")
    line["metric_dust3r"] = f"{type(metric).__name__}({type(metric.config).__name__}()): dust3r_ba's path"
    del metric, same
    for name, kw in OPTIM_PATHS:
        t0 = time.perf_counter()
        with torch.device("meta"):
            model = MODEL_REGISTRY[name](device="meta", **kw)
        model.to_empty(device="cuda")
        init_params(model, torch.Generator(device="cuda").manual_seed(33))
        setup_s = time.perf_counter() - t0
        inputs = optim_inputs(name)
        want = {}
        for _, (b, t, h, d), _, per_scene, _, *tk in OPTIM_SHAPES:
            if name in per_scene:
                key = (tk[0] if tk else t, d)
                want[key] = want.get(key, 0) + per_scene[name]
        n = sum(want.values())
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            kern = optim_scene(model, name, inputs)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            counts, shapes = launch_counts(), launch_shapes()
            with plain_attention():
                plain = optim_scene(model, name, inputs)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        expect = {"flash_attention_fwd": n, "flash_attention_fwd_lse": 0, "flash_attention_bwd_dq": 0,
                  "flash_attention_bwd_dkv": 0, "flash_attention_split_f32": n}
        if not counts_match(counts, expect) or shapes["flash_attention_fwd"] != want:
            raise AssertionError(f"{name} launched {counts} ({shapes['flash_attention_fwd']}), not {expect} ({want})")
        # A second scene, warm, and the pair forwards alone (the rest of a scene is the
        # alignment, its init on the host and its Adam steps at the host's pace).
        pairs = model.pair_outputs if name == "mast3r_sga" else model.pair_predictions
        timed = {}
        for key, fn in (("warm_ms_per_scene", lambda: model(**inputs)), ("pair_forwards_ms", lambda: pairs(**inputs))):
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            timed[key] = start.elapsed_time(end)
        errs = {"loss": abs(kern["loss"] - plain["loss"]) / max(1e-12, abs(plain["loss"])),
                "focals": ((kern["focals"] - plain["focals"]).abs() / plain["focals"].abs()).max().item(),
                "cam2world": (kern["cam2world"] - plain["cam2world"]).abs().max().item()
                / max(1.0, plain["cam2world"].abs().max().item())}
        extra = {}
        if name == "mast3r_sga":  # the matches decide the alignment: hold them, report the alignment
            extra = mast3r_pairs_against_plain(model, inputs["images"])
            held = {}
        else:
            held = {k: v for k, v in errs.items() if not v <= OPTIM_RTOL[k]}
        if held:
            raise AssertionError(f"{name}: the kernels and the plain versions disagree: {held} (limits {OPTIM_RTOL})")
        line["paths"][name] = {**extra, "alignment_held": name != "mast3r_sga",
            "config": f"{type(model).__name__}({type(getattr(model, 'mast3r_config', model.config)).__name__}(), "
                      f"{kw}) (the release's widths), 1x{OPTIM_VIEWS}x{OPTIM_HW[0]}x{OPTIM_HW[1]}, seeded",
            "parameters": sum(p.numel() for p in model.parameters()), "setup_s": setup_s, "ms_per_scene": ms,
            **timed, "alignment_ms": timed["warm_ms_per_scene"] - timed["pair_forwards_ms"],
            "peak_mem_gib": peak_gib, "launches": counts, "launches_by_shape": shape_counts(shapes)["flash_attention_fwd"],
            "loss": kern["loss"], "focals": kern["focals"].tolist(), "err_vs_plain": errs}
        del model, kern, plain
        gc.collect()
        torch.cuda.empty_cache()
    line.update(card=card["name"], power_limit=card["power_limit"])
    emit(line)
    return line


def narrow_edge_checks(card) -> list:
    """Phase 3f's narrow fp32 cases alone (``--ba-only``, ``--rgb-only``): the forward at
    D = 32 (both forms) and 48 (lse-free) against its plain version at EDGE_CASES and
    NARROW_EDGE_CASES in both layouts, then their canary cases."""
    import torch

    from mapanything_tpu_torch.ops import flash_attention as fa

    cases = []
    for d in fa.NARROW_HEAD_DIMS:
        for tq, tk, b, h in EDGE_CASES + NARROW_EDGE_CASES:
            for layout in ("contiguous", "fused"):
                cases += edge_case_rows(torch.float32, d, tq, tk, b, h, layout)
    cases += forward_canary_checks(fa.NARROW_HEAD_DIMS)
    return edge_report(card, "forward_edge_check_narrow", cases)


def ba_phases(card, rows=None) -> dict:
    """The BA slice: (without ``rows``) its rows of phase 3 (the flagship demo's, the
    tracker's, the optimisation paths', and fp32 D = 32 at 4000 keys), then phases 31, 32
    and 33."""
    import torch

    if rows is None:
        rows = {"files": kernel_checks(card, FILES_SHAPES, "3"), "tracker": kernel_checks(card, TRACKER_SHAPES, "3"),
                "optim": kernel_checks(card, OPTIM_SHAPES, "3"), "d32_long": kernel_checks(card, D32_LONG_SHAPES, "3")}
    out = {"rows": rows}
    for key, phase in (("colmap", ba_colmap_phase), ("tracker", tracker_phase), ("optim", optim_phase)):
        t0 = time.perf_counter()
        out[key] = phase(card)
        out[key]["phase_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "ba_phases_total", "phase_id": "31-33",
          "seconds": {k: out[k]["phase_s"] for k in ("colmap", "tracker", "optim")},
          "card": card["name"], "power_limit": card["power_limit"]})
    return out


def ba_entries(ba) -> list:
    """Phases 31-33 in the kernels line: the bf16 forward on the BA demo's infer (phase 31,
    both track sources' runs), the narrow fp32 forward at D = 48 and D = 32 on the tracker
    (phase 32; times per scene of 3 query frames; no split pass), and the fp32 forward and its
    split pass on each optimisation path (phase 33; times per scene), each with that run's
    launches."""
    entries = []
    runs = ba["colmap"]["launches_by_shape"]
    rows = ba["rows"]["files"]
    launches = {r["shape"]: sum(run[f"{r['b_t_h_d'][1]}x64"] for run in runs.values()) for r in rows}
    for replaces in dict.fromkeys(r["replaces"] for r in rows):
        group = [r for r in rows if r["replaces"] == replaces]
        entries.append(path_entry("flash_attention_fwd", replaces, group, launches,
                                  path=f"demo_colmap --use-ba, flagship bf16 8x518x392, {len(runs)} runs (phase 31); "
                                       "times per run"))
    run = ba["tracker"]["launches_by_shape"]
    for d in (48, 32):
        group = [r for r in ba["rows"]["tracker"] if r["b_t_h_d"][3] == d]
        launches = {r["shape"]: r["per_forward"] * TRACKER_QUERY_FRAMES for r in group}
        entries.append(path_entry("flash_attention_fwd", DUST3R_REPLACES, group, launches, dtype="float32",
                                  head_dim=d, path=f"VGGSfM tracker 8x518x392, {TRACKER_QUERIES} queries x "
                                                   f"{TRACKER_QUERY_FRAMES} query frames (phase 32); times per scene"))
        entries[-1]["launches"] = sum(n for k, n in run.items() if k.endswith(f"x{d}"))
    for path, line in ba["optim"]["paths"].items():
        group = [r for r in ba["rows"]["optim"] if path in r["per_forward"]]
        launches = {r["shape"]: r["per_forward"][path] for r in group}
        for name, entry_rows, source in (("flash_attention_fwd", group, KERNEL_SOURCE),
                                         ("flash_attention_split_f32", split_rows(group), BWD_KERNEL_SOURCE)):
            entries.append(path_entry(name, DUST3R_REPLACES, entry_rows, launches, source=source, dtype="float32",
                                      path=f"{path} 1x{OPTIM_VIEWS}x{OPTIM_HW[0]}x{OPTIM_HW[1]} (phase 33); "
                                           "times per scene"))
            entries[-1]["launches"] = line["launches"][name]
    return entries


# Phases 34-37: the accuracy benchmarks on phase 21's synthetic WAI scenes, the 100-view
# tool at its defaults, tools/inference_wai.py and the one-sample finetune.
BENCH_VIEWS, BENCH_RES = 8, (518, 392)  # the 4:3 frames' bucket at 518: 37 x 28 patches
BENCH_SETS = 4  # sets a run, two a scene (``4 @``: each scene twice, each visit a new view set)
# The scenes' covisibility is 1 - 0.15 |i - j| within four frames (write_wai_scenes): at
# 0.25 every neighbour within four frames counts, so a walk draws 8 distinct views.
BENCH_COVIS = 0.25
BENCH_CPU_RTOL = 1e-5  # set metrics of the same predictions, normalised on the card and on the CPU
# Ground truth fed back as the prediction: abs-rel exactly 0 (the same arithmetic on both
# sides), every pixel an inlier, every pair in the first 1-degree bin, ATE under this.
GT_ATE_LIMIT = 1e-4
# Calibration: single views, each layer at 1 x 1037 (the encoder, and the global layers
# over 1036 patch tokens and the scale token) or 1 x 1036 (the frame layers).
CALIB_SHAPES = [
    ("calib_encoder", (1, 1037, 16, 64), "bfloat16", 24, f"{FA}:395"),
    ("calib_frame", (1, 1036, 12, 64), "bfloat16", 12, f"{FA}:395"),
    ("calib_global", (1, 1037, 12, 64), "bfloat16", 12, f"{FA}:395"),
]
# Phase 35: tools/benchmark_many_views.py at its defaults, 1 x 100 views of 518 x 518.
MANY_VIEWS = 100
MANY_VIEW_T = MANY_VIEWS * 1369 + 1  # the global layers' tokens: 136901 (K3's regime on the TPU)
MANY_VIEW_100_SHAPES = [
    ("encoder_100_views", (MANY_VIEWS, 1370, 16, 64), "bfloat16", 24, f"{FA}:395"),
    ("frame_100_views", (MANY_VIEWS, 1369, 12, 64), "bfloat16", 12, f"{FA}:395"),
]
MANY_VIEW_LONG = ("35", "k3_global_100_views", MANY_VIEW_T, "flash_attention_fwd", f"{FA}:164", "by_length")
# Phase 37: tools/one_sample_finetune.py, the flagship at its default dtype (fp32), 2 views
# of 518 x 518; FINETUNE_STEPS steps at FINETUNE_LR.
FINETUNE_STEPS, FINETUNE_LR = 30, 1e-4
FINETUNE_SHAPES = [
    ("ft_encoder", (2, 1370, 16, 64), "float32", 24),
    ("ft_frame", (2, 1369, 12, 64), "float32", 12),
    ("ft_global", (1, 2739, 12, 64), "float32", 12),
]
FINETUNE_REPLACES = {  # fp32: the single pass up to 2048 padded keys, the augmented stream (K7) beyond
    "flash_attention_fwd_lse": {"ft_encoder": f"{FA}:118", "ft_frame": f"{FA}:118", "ft_global": f"{FA}:168"},
    "flash_attention_bwd_dq": dict.fromkeys(("ft_encoder", "ft_frame", "ft_global"), f"{FA}:227"),
    "flash_attention_bwd_dkv": dict.fromkeys(("ft_encoder", "ft_frame", "ft_global"), f"{FA}:262"),
    "flash_attention_split_f32": dict.fromkeys(("ft_encoder", "ft_frame", "ft_global"), f"{FA}:227"),
}


def shape_key(counts: dict) -> dict:
    """{(Tk, D): n} as {"<Tk>x<D>": n}."""
    return {f"{tk}x{d}": n for (tk, d), n in sorted(counts.items())}


def bench_expr(root: Path, views: int) -> str:
    return (f"{BENCH_SETS} @ ETH3DWAI(ROOT={str(root / 'eth3d')!r}, dataset_metadata_dir={str(root / 'meta')!r}, "
            f"split='test', num_views={views}, resolution={BENCH_RES}, covisibility_thres={BENCH_COVIS}, seed=0)")


class TimedModel:
    """A model whose every forward is timed on the host clock between two synchronises,
    with its lse-free launches by (Tk, D) counted a forward."""

    def __init__(self, model):
        self.model, self.ms, self.shapes = model, [], []

    @property
    def device(self):
        return self.model.device

    def __call__(self, views):
        import torch

        from mapanything_tpu_torch.ops.flash_attention import launch_shapes, reset_launch_counts

        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = self.model(views)
        torch.cuda.synchronize()
        self.ms.append(1e3 * (time.perf_counter() - t0))
        self.shapes.append(launch_shapes()["flash_attention_fwd"])
        return out


def check_launches_per_forward(path: str, shapes: list, want: dict) -> dict:
    """Every forward of ``path`` launched the lse-free forward ``want`` = {(Tk, D): n} times."""
    bad = [s for s in shapes if dict(s) != want]
    if bad or not shapes:
        raise AssertionError(f"{path}: forwards launched {[shape_key(s) for s in bad] or 'nothing'}, "
                             f"not {shape_key(want)} each")
    return shape_key(want)


def predictions_on(preds, device):
    """Predictions with every tensor field on ``device``."""
    return dataclasses.replace(preds, **{f.name: getattr(preds, f.name).to(device)
                                         for f in dataclasses.fields(preds) if getattr(preds, f.name) is not None})


def ground_truth_predictions(batch):
    """The batch's ground truth as predictions: world points, poses, rays, depths, unit scale."""
    import torch

    from mapanything_tpu_torch.models.mapanything import Predictions

    B, V, H, W = batch.valid_mask.shape
    return Predictions(pts3d=batch.pts3d, pts3d_cam=batch.pts3d_cam, ray_directions=batch.ray_directions,
                       depth_along_ray=batch.depth_along_ray, cam_trans=batch.camera_pose_trans,
                       cam_quats=batch.camera_pose_quats, metric_scaling_factor=torch.ones(B, device=batch.pts3d.device),
                       conf=torch.ones((B, V, H, W), device=batch.pts3d.device))


def check_set_metrics(name: str, m: dict) -> None:
    """Finite metrics in their ranges: abs-rel, ATE and errors >= 0, inlier shares in [0, 1],
    pose_auc_5 in [0, 100], ray errors in [0, 180] degrees."""
    bad = {k: v for k, v in m.items() if not np.isfinite(v) or v < 0}
    bad.update({k: m[k] for k in ("pointmaps_inlier_thres_103", "z_depth_inlier_thres_103") if not m[k] <= 1})
    bad.update({k: m[k] for k, top in (("pose_auc_5", 100), ("ray_dirs_err_deg", 180)) if not m[k] <= top})
    if bad:
        raise AssertionError(f"{name}: metrics out of range: {bad}")


def benchmarks_phase(card, work: Path, model) -> dict:
    """Phase 34: dense N-view, RMVD and calibration run_benchmark with ``model`` (the
    flagship bf16, seeded) over test-split ETH3D loaders of the scenes under ``work``
    (BENCH_SETS sets of BENCH_VIEWS views at 518 x 392, batch 1, covisibility_thres
    BENCH_COVIS; calibration one view a sample). The first dense set's predictions (held
    on the card) scored on the card and on the CPU, within BENCH_CPU_RTOL but for what
    the counted edges allow; the ground truth scored as the prediction on the card."""
    import os

    import torch

    from mapanything_tpu_torch.benchmarking import calibration, dense_n_view, rmvd_mvs
    from mapanything_tpu_torch.data.loader import get_test_data_loader
    from mapanything_tpu_torch.tools.train import build_dataset

    workers = min(os.cpu_count() or 1, 8)

    def loader(views):
        out = get_test_data_loader(build_dataset(bench_expr(work, views)), 1, num_workers=workers)
        out.set_epoch(0)
        return out

    line = {"phase": "benchmarks", "phase_id": "34",
            "config": f"MapAnythingConfig(compute_dtype='bfloat16'), seeded; {BENCH_SETS} @ ETH3DWAI test split, "
                      f"{BENCH_VIEWS} views at {BENCH_RES[0]}x{BENCH_RES[1]}, covisibility_thres={BENCH_COVIS}, "
                      "batch 1", "loader_workers": workers}
    per_set = {(1037, 64): 24, (1036, 64): 12, (BENCH_VIEWS * 1036 + 1, 64): 12}
    kept, runs = {}, {}

    def keep_first(i, batch, preds, set_metrics):
        if i == 0:
            kept.update(batch=batch, preds=preds, card_metrics=set_metrics)

    for name, run, views, want in (
            ("dense_n_view", lambda m, ld: dense_n_view.run_benchmark(m, ld, on_batch=keep_first), BENCH_VIEWS,
             per_set),
            ("rmvd", rmvd_mvs.run_benchmark, BENCH_VIEWS, per_set),
            ("calibration", calibration.run_benchmark, 1, {(1037, 64): 36, (1036, 64): 12})):
        timed = TimedModel(model)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        summary = run(timed, loader(views))
        run_s = time.perf_counter() - t0
        runs[name] = {"summary": summary, "sets": len(timed.ms), "forward_ms_per_set": float(np.mean(timed.ms)),
                      "forward_ms_after_first": float(np.mean(timed.ms[1:])), "forward_ms_each": timed.ms, "s_per_set_with_loader_and_metrics": run_s / len(timed.ms),
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "launches_per_set": check_launches_per_forward(name, timed.shapes, want),
                      "launches": {k: n * len(timed.ms) for k, n in shape_key(want).items()}}
        if len(timed.ms) != BENCH_SETS:
            raise AssertionError(f"{name}: {len(timed.ms)} sets, not {BENCH_SETS}")
    dense, rmvd, calib = (runs[k]["summary"] for k in ("dense_n_view", "rmvd", "calibration"))
    if set(dense) != {"scene_png", "scene_jpg", "overall"} or set(calib) != set(dense):
        raise AssertionError(f"scenes: {sorted(dense)}, {sorted(calib)}")
    for scene, m in dense.items():
        check_set_metrics(f"dense_n_view {scene}", m)
    if not (np.isfinite(rmvd["absrel"]) and rmvd["absrel"] >= 0 and 0 <= rmvd["inlier103"] <= 100
            and rmvd["num_samples"] == BENCH_SETS):
        raise AssertionError(f"rmvd: {rmvd}")
    if not all(np.isfinite(v) and 0 <= v <= 180 for v in calib.values()):
        raise AssertionError(f"calibration: {calib}")

    # The same predictions scored on the CPU; the allowance of each discontinuous metric
    # from the counted pixels and pairs near an edge.
    batch, preds = kept["batch"], kept["preds"]
    edges = dense_n_view.metric_edges(batch, preds)[0]
    cpu = dense_n_view.compute_set_metrics(batch.to("cpu"), predictions_on(preds, "cpu"))[0]
    gpu = kept["card_metrics"][0]
    gaps = {k: abs(cpu[k] - gpu[k]) for k in gpu}
    limits = {k: BENCH_CPU_RTOL * abs(cpu[k]) + 1e-7 + edges.get(k, 0.0) for k in gpu}
    line["card_vs_cpu"] = {"gaps": gaps, "limits": limits, "edges": edges}
    bad = {k: (gaps[k], limits[k]) for k in gaps if not gaps[k] <= limits[k]}
    if bad:
        raise AssertionError(f"set metrics on the card and on the CPU disagree: {bad}")

    # The ground truth fed back as the prediction, scored on the card.
    gt = dense_n_view.compute_set_metrics(batch, ground_truth_predictions(batch))[0]
    line["ground_truth_as_prediction"] = gt
    if not (gt["pointmaps_abs_rel"] == 0 and gt["z_depth_abs_rel"] == 0 and gt["pointmaps_inlier_thres_103"] == 1
            and gt["z_depth_inlier_thres_103"] == 1 and gt["pose_auc_5"] == 100
            and gt["pose_ate_rmse"] < GT_ATE_LIMIT):
        raise AssertionError(f"the ground truth as the prediction scores {gt}")
    line.update(runs=runs, card=card["name"], power_limit=card["power_limit"])
    emit(line)
    return line


def many_view_phase(card) -> dict:
    """Phase 35: tools/benchmark_many_views.py in this process at its defaults (100 views of
    518 x 518, head_chunk_size 10, 2 timed iterations after one warm-up): views/s, s a
    scene, peak memory, launches a forward by key length (36 K1-regime and 12 K3-regime
    lse-free launches); the last forward's outputs under phase 5's and, postprocessed,
    phase 13's invariants. Then the kernel at its shapes: K1 at the encoder and frame
    layers, K3 at 1 x 136901 on a slice of query rows."""
    import torch

    from mapanything_tpu_torch.models.mapanything import Views
    from mapanything_tpu_torch.ops.flash_attention import launch_counts, launch_lengths, reset_launch_counts
    from mapanything_tpu_torch.tools import benchmark_many_views
    from mapanything_tpu_torch.utils.inference import PostprocessConfig, postprocess_model_outputs_for_inference

    args = benchmark_many_views.parse_args([])
    reset_launch_counts()
    t0 = time.perf_counter()
    run = benchmark_many_views.run(args)
    tool_s = time.perf_counter() - t0
    counts, lengths = launch_counts(), launch_lengths()
    forwards = 1 + args.iters
    want = {1370: 24 * forwards, 1369: 12 * forwards, MANY_VIEW_T: 12 * forwards}
    if counts["flash_attention_fwd"] != 48 * forwards or lengths != want or any(
            n for k, n in counts.items() if k != "flash_attention_fwd"):
        raise AssertionError(f"{forwards} forwards at 100 views launched {counts}, by length {lengths}")
    shape = (1, args.views, args.res, args.res)
    ray_norm_err = check_invariants(run["preds"], shape)
    with torch.inference_mode():
        out = postprocess_model_outputs_for_inference(run["preds"], Views(img=run["images"]), PostprocessConfig())
    line = {"phase": "many_view_tool", "phase_id": "35",
            "config": "tools/benchmark_many_views.py defaults: MapAnythingConfig(compute_dtype='bfloat16', "
                      f"head_chunk_size={run['line']['head_chunk_size']}), 1x{args.views}x{args.res}x{args.res}, "
                      f"seeded random weights, {args.iters} timed forwards",
            **run["line"], "tool_s": tool_s, "forwards": forwards, "launches": counts,
            "lse_free_launches_per_forward_by_length": {str(k): n // forwards for k, n in lengths.items()},
            "ray_norm_err": ray_norm_err, **check_infer_outputs(out, shape)}
    del run, out
    gc.collect()
    torch.cuda.empty_cache()
    line["rows"] = kernel_checks(card, MANY_VIEW_100_SHAPES, "35")
    line["long_row"] = long_forward_check(card, *MANY_VIEW_LONG, plain_iters=1)
    line.update(card=card["name"], power_limit=card["power_limit"])
    emit({k: v for k, v in line.items() if k not in ("rows", "long_row")})
    return line


def inference_wai_phase(card, work: Path, model) -> dict:
    """Phase 36: tools/inference_wai.py on phase 21's scene_png, 8 views at 518 (the
    518 x 392 bucket), with ``model`` (the flagship bf16, seeded): the three files written,
    infer's launches by shape."""
    import torch

    from mapanything_tpu_torch.ops.flash_attention import launch_counts, launch_shapes, reset_launch_counts
    from mapanything_tpu_torch.tools import inference_wai

    out_dir = work / "inference_wai"
    args = inference_wai.parse_args(["--scene", str(work / "eth3d" / "scene_png"), "--out", str(out_dir)])
    reset_launch_counts()
    t0 = time.perf_counter()
    run = inference_wai.run(args, model=model)
    torch.cuda.synchronize()
    tool_s = time.perf_counter() - t0
    counts, shapes = launch_counts(), launch_shapes()
    want = {(1037, 64): 24, (1036, 64): 12, (BENCH_VIEWS * 1036 + 1, 64): 12}
    if shapes.get("flash_attention_fwd") != want or any(n for k, n in counts.items() if k != "flash_attention_fwd"):
        raise AssertionError(f"inference_wai launched {counts}, by shape {shape_key(shapes['flash_attention_fwd'])}")
    sizes = {name: (out_dir / name).stat().st_size for name in inference_wai.OUTPUTS}
    if not all(sizes.values()):
        raise AssertionError(f"inference_wai wrote {sizes}")
    line = {"phase": "inference_wai", "phase_id": "36", "views": list(run["views"]["images"].shape[1:4]),
            "tool_s": tool_s, "file_bytes": sizes, "launches": counts,
            "launches_by_shape": shape_key(shapes["flash_attention_fwd"]),
            **check_infer_outputs(run["outputs"], (1, BENCH_VIEWS, BENCH_RES[1], BENCH_RES[0])),
            "card": card["name"], "power_limit": card["power_limit"]}
    emit(line)
    return line


def finetune_phase(card) -> dict:
    """Phase 37: tools/one_sample_finetune.py in this process, the flagship at its default
    dtype (fp32) with the geometric encoders, 2 views of 518 x 518, FINETUNE_STEPS steps at
    lr FINETUNE_LR: ms a step, peak memory, launches a step by kernel and shape, finite
    losses and gradient norms, and the JAX test's criterion (the last printed loss under
    0.9x the first). The training kernels first against their plain versions at its shapes."""
    import torch

    from mapanything_tpu_torch.ops.flash_attention import launch_counts, launch_shapes, reset_launch_counts
    from mapanything_tpu_torch.tools import one_sample_finetune

    rows = train_kernel_checks(card, FINETUNE_SHAPES, FINETUNE_REPLACES, "37")
    args = one_sample_finetune.parse_args(["--views", "2", "--resolution", "518", "--steps", str(FINETUNE_STEPS),
                                           "--lr", str(FINETUNE_LR)])
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    run = one_sample_finetune.run(args)
    counts, shapes = launch_counts(), launch_shapes()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [loss for _, loss, _ in run["printed"]]
    norms = [g for _, _, g in run["printed"]]
    n = FINETUNE_STEPS
    want = {"flash_attention_fwd": 0, "flash_attention_fwd_lse": 48 * n, "flash_attention_bwd_dq": 48 * n,
            "flash_attention_bwd_dkv": 48 * n, "flash_attention_split_f32": 96 * n}
    per_step = {(1370, 64): 24 * n, (1369, 64): 12 * n, (2739, 64): 12 * n}
    bad = [k for k in ("flash_attention_fwd_lse", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
           if shapes.get(k) != per_step]
    if not counts_match(counts, want) or bad:
        raise AssertionError(f"{n} finetune steps launched {counts}, by shape "
                             f"{ {k: shape_key(v) for k, v in shapes.items()} }")
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise AssertionError(f"non-finite finetune losses or gradient norms: {run['printed']}")
    met = losses[-1] < losses[0] * 0.9
    line = {"phase": "one_sample_finetune", "phase_id": "37",
            "config": f"tools/one_sample_finetune.py --views 2 --resolution 518 --steps {n} --lr {FINETUNE_LR}: "
                      "MapAnythingConfig() (fp32) with the geometric encoders, seeded",
            "printed": run["printed"], "criterion_last_under_0.9_first": met,
            "ms_per_step": 1e3 * float(np.mean(run["seconds"][1:])), "ms_each_step": [1e3 * s for s in run["seconds"]],
            "peak_mem_gib": peak, "launches": counts,
            "launches_per_step_by_shape": {k: {key: c // n for key, c in shape_key(v).items()}
                                           for k, v in shapes.items() if v},
            "card": card["name"], "power_limit": card["power_limit"]}
    emit(line)
    if not met:
        raise AssertionError(f"the finetune's last printed loss {losses[-1]} is not under 0.9x the first {losses[0]}")
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return {"line": line, "rows": rows, "launches": counts, "steps": n}


def benchmark_phases(card, files_rows=None) -> dict:
    """Phases 34-37 on one set of phase 21's scenes (written to a temporary directory under
    build/) and one seeded flagship bf16 for 34 and 36; ``files_rows``: phase 19's kernel
    rows (the 518 x 392 shapes), checked here when not given; the calibration's rows."""
    import torch

    if files_rows is None:
        files_rows = kernel_checks(card, FILES_SHAPES, "3")
    out = {"files_rows": files_rows, "calib_rows": kernel_checks(card, CALIB_SHAPES, "3")}
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="benchmarks_", dir=ROOT / "build"))
    seconds = {}
    try:
        t0 = time.perf_counter()
        write_wai_scenes(work)
        seconds["write_scenes"] = time.perf_counter() - t0
        model = flagship_on_card()
        for key, phase in (("benchmarks", lambda: benchmarks_phase(card, work, model)),
                           ("inference_wai", lambda: inference_wai_phase(card, work, model))):
            t0 = time.perf_counter()
            out[key] = phase()
            seconds[key] = time.perf_counter() - t0
        del model
        gc.collect()
        torch.cuda.empty_cache()
        for key, phase in (("many_view", many_view_phase), ("finetune", finetune_phase)):
            t0 = time.perf_counter()
            out[key] = phase(card)
            seconds[key] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "benchmark_phases_total", "phase_id": "34-37", "seconds": seconds,
          "card": card["name"], "power_limit": card["power_limit"]})
    return out


def benchmark_entries(bench) -> list:
    """Phases 34-37 in the kernels line: the lse-free forward on each benchmark's path
    (dense N-view and RMVD at 8 x 518 x 392, calibration on single views: times per set;
    inference_wai: times per scene), one entry per TPU kernel replaced, with that run's
    launches; on the 100-view tool (K1 at the encoder and frame layers, K3 at the global
    layers: times per scene, the run's launches); and the fp32 training kernels and their
    split pass on the one-sample finetune (times per step, the run's launches)."""
    entries = []
    files, calib = bench["files_rows"], bench["calib_rows"]
    # Each forward's launches at each row's shape were checked equal to the row's per_forward.
    for path, rows, runs, what in (("dense_n_view (phase 34), 1x8x518x392", files, BENCH_SETS, "times per set"),
                                   ("rmvd (phase 34), 1x8x518x392", files, BENCH_SETS, "times per set"),
                                   ("calibration (phase 34), 1x1x518x392", calib, BENCH_SETS, "times per set"),
                                   ("inference_wai (phase 36), 1x8x518x392", files, 1, "times per scene")):
        for replaces in dict.fromkeys(r["replaces"] for r in rows):
            group = [r for r in rows if r["replaces"] == replaces]
            entries.append(path_entry("flash_attention_fwd", replaces, group,
                                      {r["shape"]: r["per_forward"] for r in group}, path=f"{path}; {what}"))
            entries[-1]["launches"] = sum(r["per_forward"] for r in group) * runs
    many = bench["many_view"]
    by_length, forwards = many["lse_free_launches_per_forward_by_length"], many["forwards"]
    for replaces, group in ((f"{FA}:395", many["rows"]), (f"{FA}:164", [many["long_row"]])):
        entries.append(path_entry("flash_attention_fwd", replaces, group,
                                  {r["shape"]: by_length[str(r["b_t_h_d"][1])] for r in group},
                                  path="tools/benchmark_many_views.py defaults, 1x100x518 (phase 35); "
                                       "times per scene"))
        entries[-1]["launches"] = sum(by_length[str(r["b_t_h_d"][1])] * forwards for r in group)
    ft = bench["finetune"]
    for name in TRAIN_OUTPUTS:
        entries.append(train_entry(name, ft["rows"], FINETUNE_REPLACES[name]["ft_global"], ft["launches"][name],
                                   ft["steps"], dtype="float32",
                                   path="tools/one_sample_finetune.py, flagship fp32 1x2x518 (phase 37); "
                                        "times per step"))
    return entries


# ---------------------------------------------------------------- phases 38-40


PROC_CUT = 4  # the CPU comparisons' cut: the first 4 frames at a quarter of each side (192 x 256)
PROC_STAGE_FRAMES = 4  # frames of the render and undistort scene copies
MOGE_BATCH = 4
COVIS_ATOL, CONF_AGREEMENT, SWEEP_AGREEMENT, SWEEP_EPS = 2e-3, 0.999, 0.995, 3e-5
RENDER_RTOL, FACE_TIES, MOGE_RTOL = 1e-5, 1e-3, 1e-3
LIVE_REQUESTS = 3


def cam_txt(w2c, K) -> str:
    """A BlendedMVS cams/<frame>_cam.txt: "extrinsic", the 4 x 4 world2cam, "intrinsic", K."""
    rows = ["extrinsic", *(" ".join(map(str, r)) for r in w2c), "", "intrinsic", *(" ".join(map(str, r)) for r in K)]
    return "\n".join(rows) + "\n"


def frame_pose(i: int) -> np.ndarray:
    """Phase 21's camera path: a turn of 0.03 rad about y and a step of (0.05, 0, 0.01) a frame."""
    pose = np.eye(4)
    a = 0.03 * i
    pose[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    pose[:3, 3] = [0.05 * i, 0.0, 0.01 * i]
    return pose


def write_blendedmvs_raw(root: Path) -> None:
    """A raw BlendedMVS scene of DATA_FRAMES 1024 x 768 frames: the JPEG fixtures as
    blended_images, PFM depth (phase 21's surface) and cams files."""
    fixtures = sorted(JPEG_FIXTURES.glob("*.jpg"))
    h, w = DATA_HW
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    K = np.array([[0.8 * w, 0, w / 2 - 0.5], [0, 0.8 * w, h / 2 - 0.5], [0, 0, 1]])
    scene = root / "5a3ca9cb270f0c1234567890"
    for sub in ("cams", "rendered_depth_maps", "blended_images"):
        (scene / sub).mkdir(parents=True)
    for i in range(DATA_FRAMES):
        n = f"{i:08d}"
        shutil.copyfile(fixtures[i % len(fixtures)], scene / "blended_images" / f"{n}.jpg")
        depth = (2.5 + 0.8 * np.sin(x / 90 + 0.3 * i) * np.cos(y / 70) + 0.002 * y).astype("<f4")
        (scene / "rendered_depth_maps" / f"{n}.pfm").write_bytes(b"Pf\n%d %d\n-1.0\n" % (w, h) + depth[::-1].tobytes())
        (scene / "cams" / f"{n}_cam.txt").write_text(cam_txt(np.linalg.inv(frame_pose(i)), K))


def cut(depths=None, Ks=None, images=None, step: int = 4, n: int = PROC_CUT):
    """The first ``n`` frames, every ``step``-th pixel, the intrinsics scaled to match."""
    out = []
    if depths is not None:
        out.append(np.ascontiguousarray(depths[:n, ::step, ::step]))
    if Ks is not None:
        K = np.array(Ks[:n], np.float32)
        K[:, :2] /= step
        out.append(K)
    if images is not None:
        out.append(np.ascontiguousarray(images[:n, ::step, ::step]))
    return out


def scene_arrays(scene: Path, mods=("depth", "intrinsics", "pose"), frames: int = PROC_CUT) -> dict:
    """The first ``frames`` frames' ``mods`` of a WAI scene, stacked."""
    from mapanything_tpu_torch.data import wai as wai_io

    meta = wai_io.load_scene_meta(scene)
    frames = [wai_io.load_frame(scene, fr["frame_name"], list(mods), meta=meta) for fr in meta["frames"][:frames]]
    return {m: np.stack([f[m] for f in frames]) for m in mods}


def covisibility_cut_check(depths, Ks, poses) -> dict:
    """Covisibility on the card against the CPU on the cut: off the diagonal within
    COVIS_ATOL; on it (a view against itself, whose border reprojects exactly onto its
    border) within one border row and column of pixels."""
    from mapanything_tpu_torch.data_processing.covisibility import compute_pairwise_covisibility

    d, K = cut(depths, Ks)
    card = compute_pairwise_covisibility(d, K, poses[:PROC_CUT], device="cuda")
    cpu = compute_pairwise_covisibility(d, K, poses[:PROC_CUT], device="cpu")
    off = ~np.eye(len(card), dtype=bool)
    h, w = d.shape[1:]
    diag_tol = max(COVIS_ATOL, (h + w) / (h * w))
    out = {"cut": list(d.shape), "off_diagonal_max_abs_diff": float(np.abs(card - cpu)[off].max()),
           "diagonal_max_abs_diff": float(np.abs(np.diag(card) - np.diag(cpu)).max()), "tol": COVIS_ATOL,
           "diagonal_tol": diag_tol, "entries_differing": int((card != cpu).sum()), "card": card.round(6).tolist()}
    if out["off_diagonal_max_abs_diff"] > COVIS_ATOL or out["diagonal_max_abs_diff"] > diag_tol:
        raise AssertionError(f"covisibility on the card is off the CPU's: {out}")
    return out


def timed_stage(fn):
    """(result, seconds, peak GiB) of ``fn`` on the card."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30


def convert_phase(card, work: Path) -> dict:
    """Phase 38: a raw BlendedMVS scene of 24 frames of 1024 x 768 through
    tools/convert_wai.py (conversion, covisibility on the card, aggregation); the
    covisibility held to the CPU's on the cut."""
    from mapanything_tpu_torch.tools import convert_wai

    raw, wai, md = work / "raw_blendedmvs", work / "wai_blendedmvs", work / "meta_blendedmvs"
    t0 = time.perf_counter()
    write_blendedmvs_raw(raw)
    write_s = time.perf_counter() - t0
    args = convert_wai.parse_args(["--dataset", "blendedmvs", "--raw-root", str(raw), "--out-root", str(wai),
                                   "--metadata-dir", str(md), "--covisibility", "--aggregate", "--device", "cuda"])
    result, total_s, peak = timed_stage(lambda: convert_wai.run(args))
    (scene,) = result["scenes"]
    covis = np.load(wai / scene / "covisibility" / "v0" / "pairwise_covisibility.npy")
    if covis.shape != (DATA_FRAMES, DATA_FRAMES) or not np.isfinite(covis).all() or not (0 <= covis).all() \
            or not (covis <= 1).all() or np.diag(covis).min() < 0.9:
        raise AssertionError(f"the scene's covisibility is not a covisibility matrix: {covis}")
    lists = sorted(str(p.relative_to(md)) for p in md.rglob("*.npy"))
    if not lists:
        raise AssertionError("the aggregation wrote no scene list")
    arrays = scene_arrays(wai / scene)
    line = {"phase": "convert", "phase_id": "38", "frames": DATA_FRAMES, "hw": list(DATA_HW),
            "write_raw_s": write_s, "stage_s": result["seconds"], "total_s": total_s,
            "covisibility_peak_gib": peak, "scene_lists": lists,
            "covisibility_neighbour_mean": float(np.diag(covis, 1).mean()),
            "cut_check": covisibility_cut_check(arrays["depth"], arrays["intrinsics"], arrays["pose"]),
            "card": card["name"], "power_limit": card["power_limit"]}
    emit(line)
    return line


def processing_scene(work: Path) -> Path:
    """Phase 21's scene_png (24 PNG frames of 1024 x 768, 16-bit millimetre depth, a
    covisibility) with the camera fields the stages read: the size, a PINHOLE model,
    shared intrinsics, the frame modalities."""
    write_wai_scenes(work)
    root = work / "eth3d"
    meta_path = root / "scene_png" / "scene_meta.json"
    meta = json.loads(meta_path.read_text())
    h, w = DATA_HW
    meta.update(h=h, w=w, camera_model="PINHOLE", shared_intrinsics=True, scene_name="scene_png",
                frame_modalities={"image": {"frame_key": "image", "format": "image"},
                                  "depth": {"frame_key": "depth", "format": "depth"}})
    meta_path.write_text(json.dumps(meta))
    return root


def scene_copy(root: Path, name: str, frames: int, **camera) -> Path:
    """The first ``frames`` frames of scene_png as scene ``name``, its camera fields updated."""
    src, dst = root / "scene_png", root / name
    meta = json.loads((src / "scene_meta.json").read_text())
    meta["frames"] = meta["frames"][:frames]
    for fr in meta["frames"]:
        for key in ("image", "depth"):
            (dst / fr[key]).parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(src / fr[key], dst / fr[key])
    meta.update(scene_name=name, **camera)
    (dst / "scene_meta.json").write_text(json.dumps(meta))
    return dst


def height_field_mesh(n: int = 256, seed: int = 39):
    """A (n + 1)^2-vertex height field (2 n^2 triangles) with vertex colours, in front of
    the scene's cameras (z about 2.5, the depth of phase 21's surface)."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.linspace(-2.0, 2.5, n + 1), np.linspace(-1.6, 1.6, n + 1))
    zs = 2.5 + 0.3 * np.sin(2.1 * xs) * np.cos(1.7 * ys) + 0.01 * rng.standard_normal(xs.shape)
    verts = np.stack([xs, ys, zs], -1).reshape(-1, 3).astype(np.float32)
    idx = np.arange((n + 1) ** 2).reshape(n + 1, n + 1)
    a, b, c, d = idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1], idx[1:, 1:]
    faces = np.concatenate([np.stack([a, b, d], -1).reshape(-1, 3), np.stack([a, d, c], -1).reshape(-1, 3)])
    return verts, faces.astype(np.int32), rng.random((len(verts), 3)).astype(np.float32)


def moge_release_on_card(seed: int = 0):
    """MoGe-1 at the release's widths (ViT-L/14), built on the meta device and seeded on the card."""
    import torch

    from mapanything_tpu_torch.models.blocks import init_params
    from mapanything_tpu_torch.models.external.moge import MoGeConfig, MoGeWrapper

    with torch.device("meta"):
        model = MoGeWrapper(MoGeConfig(), device="meta")
    model.to_empty(device="cuda")
    init_params(model, torch.Generator(device="cuda").manual_seed(seed))
    return model


def moge_cut_check(model, images) -> dict:
    """The release-width MoGe's raw outputs (points, mask logits) on one cut frame
    (168 x 224) on the card (TF32 off) against the same weights on the CPU."""
    import torch

    from mapanything_tpu_torch.models.external.moge import MoGeConfig, MoGeWrapper

    frame = np.ascontiguousarray(images[0, :168, :224])[None]
    with torch.device("meta"):
        cpu = MoGeWrapper(MoGeConfig(), device="meta")
    cpu.to_empty(device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            card_out = [x.float().cpu() for x in model.predict(torch.from_numpy(frame))]
            cpu_out = [x.float() for x in cpu.predict(torch.from_numpy(frame))]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    out = {"cut": list(frame.shape), "tol_over_magnitude": MOGE_RTOL}
    for name, a, b in (("points", card_out[0], cpu_out[0]), ("mask_logits", card_out[1], cpu_out[1])):
        scale = max(1.0, float(b.abs().max()))
        out[f"{name}_err_over_magnitude"] = float((a - b).abs().max()) / scale
    if not all(out[f"{n}_err_over_magnitude"] <= MOGE_RTOL for n in ("points", "mask_logits")):
        raise AssertionError(f"MoGe on the card is off the CPU's: {out}")
    return out


def check_frame_files(scene: Path, key: str, frames: int, lo: float = 0.0, hi: float = np.inf) -> dict:
    """Every frame has ``key``'s file, finite and within [lo, hi]; its share of nonzero pixels."""
    from mapanything_tpu_torch.utils.exr import read_depth_exr

    meta = json.loads((scene / "scene_meta.json").read_text())
    if len(meta["frames"]) != frames:
        raise AssertionError(f"{scene.name}: {len(meta['frames'])} frames, not {frames}")
    nonzero = []
    for fr in meta["frames"]:
        values = read_depth_exr(scene / fr[key])
        if not np.isfinite(values).all() or values.min() < lo or values.max() > hi:
            raise AssertionError(f"{scene.name}/{fr[key]}: values outside [{lo}, {hi}]")
        nonzero.append(float((values > 0).mean()))
    return {"frames": len(nonzero), "nonzero_share_min": min(nonzero), "nonzero_share_mean": float(np.mean(nonzero))}


def run_process_stage(argv, model=None) -> None:
    from mapanything_tpu_torch.tools import process_wai

    if process_wai.main(argv, model=model) != 0:
        raise AssertionError(f"process_wai {argv} failed")


def process_phase(card, work: Path) -> dict:
    """Phase 39: tools/process_wai.py stage by stage on the card over phase 21's scene_png
    (24 frames of 1024 x 768): confidence, mvs (64 planes, 4 neighbours), moge (MoGe-1 at
    release width, seeded, batch 4), render (a 131072-triangle height field with vertex
    colours, on a 4-frame copy) and undistort (4-frame copies with an OPENCV and an
    OPENCV_FISHEYE camera). Each stage's seconds and peak memory; each held to the CPU's
    result at a cut; the MoGe stage's attention launches by shape."""
    import torch

    from mapanything_tpu_torch.data_processing import depth_confidence, pseudo_depth, rendering, undistort
    from mapanything_tpu_torch.ops.flash_attention import launch_counts, launch_shapes, reset_launch_counts

    t0 = time.perf_counter()
    root = processing_scene(work)
    scene = root / "scene_png"
    setup_s = time.perf_counter() - t0
    arrays = scene_arrays(scene, ("image", "depth", "intrinsics", "pose"))
    stages = {}

    def stage(name, argv, check, model=None):
        _, seconds, peak = timed_stage(lambda: run_process_stage([name, "--root", str(root), *argv], model))
        stages[name] = {"seconds": seconds, "peak_gib": peak, **check()}
        emit({"phase": f"process_{name}", "phase_id": "39", **stages[name],
              "card": card["name"], "power_limit": card["power_limit"]})

    # confidence
    def conf_check():
        d, K = cut(arrays["depth"], arrays["intrinsics"])
        card_conf, cpu_conf = (depth_confidence.compute_depth_consistency_confidence(d, K, arrays["pose"][:PROC_CUT],
                                                                                     device=device)
                               for device in ("cuda", "cpu"))
        agree = float((card_conf == cpu_conf).mean())
        if agree < CONF_AGREEMENT:
            raise AssertionError(f"confidence on the card equals the CPU's at {agree} of the pixels")
        files = check_frame_files(scene, "gt_depth_depth_confidence", DATA_FRAMES, 0.0, 1.0)
        return {**files, "cut_equal_share": agree, "cut_tol": CONF_AGREEMENT, "cut": list(d.shape)}

    stage("confidence", ["--scenes", "scene_png", "--device", "cuda"], conf_check)

    # mvs
    def mvs_check():
        (imgs,) = cut(images=arrays["image"])
        (K,) = cut(Ks=arrays["intrinsics"])
        c2w = arrays["pose"].astype(np.float64)
        w2c = np.linalg.inv(c2w)
        inputs = (imgs[0], imgs[[1, 2]], K[0], K[[1, 2]], (w2c[[1, 2]] @ c2w[0]).astype(np.float32), 0.25, 12.5)
        card_d = pseudo_depth.plane_sweep_depth(*inputs, num_planes=64, device="cuda")
        cpu_d = pseudo_depth.plane_sweep_depth(*inputs, num_planes=64, device="cpu")
        with torch.inference_mode():
            on_card = [torch.as_tensor(np.asarray(x), dtype=torch.float32, device="cuda") for x in inputs]
            scores, inv_d = pseudo_depth.plane_scores(*on_card, num_planes=64)
        agreement = pseudo_depth.sweep_agreement(card_d[0], cpu_d[0], scores.cpu().numpy(), inv_d.cpu().numpy(),
                                                 eps=SWEEP_EPS)
        conf_diff = float(np.abs(card_d[1] - cpu_d[1]).max())
        if agreement["within_rtol_or_sensitive"] < SWEEP_AGREEMENT or agreement["beyond_one_plane_off_ties"] \
                or conf_diff > 1e-3:
            raise AssertionError(f"the plane sweep on the card is off the CPU's: {agreement}, confidence {conf_diff}")
        files = check_frame_files(scene, "mvs_depth", DATA_FRAMES)
        return {**files, "cut_agreement": agreement, "cut_confidence_max_abs_diff": conf_diff,
                "cut_tol": {"rtol": 1e-4, "share": SWEEP_AGREEMENT, "score_eps": SWEEP_EPS, "confidence": 1e-3}}

    stage("mvs", ["--scenes", "scene_png", "--num-planes", "64", "--num-neighbors", "4", "--device", "cuda"], mvs_check)

    # moge
    model = moge_release_on_card()
    moge_run = {}

    def moge_check():
        files = check_frame_files(scene, "moge_depth", DATA_FRAMES)
        return {**files, **moge_run, "cut_check": moge_cut_check(model, arrays["image"])}

    reset_launch_counts()
    _, seconds, peak = timed_stage(lambda: run_process_stage(["moge", "--root", str(root), "--scenes", "scene_png",
                                                              "--batch-size", str(MOGE_BATCH), "--device", "cuda"],
                                                             model))
    counts, shapes = launch_counts(), launch_shapes()
    batches = -(-DATA_FRAMES // MOGE_BATCH)
    fwd_shapes = shapes["flash_attention_fwd"]
    if len(fwd_shapes) != 1 or counts["flash_attention_fwd"] != 24 * batches \
            or counts["flash_attention_split_f32"] != 24 * batches:
        raise AssertionError(f"the MoGe stage launched {counts}, by (Tk, D) {fwd_shapes}")
    ((tokens, head_dim),) = fwd_shapes
    moge_run.update(launches=counts, launches_by_shape={f"{k[0]}x{k[1]}": v for k, v in fwd_shapes.items()},
                    batches=batches, tokens=tokens)
    stages["moge"] = {"seconds": seconds, "peak_gib": peak, **moge_check()}
    emit({"phase": "process_moge", "phase_id": "39", **stages["moge"], "card": card["name"],
          "power_limit": card["power_limit"]})
    del model
    moge_rows = kernel_checks(card, [(f"moge_{DATA_HW[0]}x{DATA_HW[1]}", (MOGE_BATCH, tokens, 16, head_dim), "float32",
                                      {"moge_stage": 24}, f"{FA}:164")], "39")

    # render: the height field in a 4-frame copy
    render_scene = scene_copy(root, "scene_render", PROC_STAGE_FRAMES)
    verts, faces, colors = height_field_mesh()
    rendering.write_ply_mesh(render_scene / "mesh.ply", verts, faces, colors)
    meta = json.loads((render_scene / "scene_meta.json").read_text())
    meta["scene_modalities"] = {"mesh": {"scene_key": "mesh.ply", "format": "mesh"}}
    (render_scene / "scene_meta.json").write_text(json.dumps(meta))

    def render_check():
        files = check_frame_files(render_scene, "rendered_depth", PROC_STAGE_FRAMES)
        if files["nonzero_share_min"] < 0.5:
            raise AssertionError(f"the mesh covers too little of the frames: {files}")
        (K,) = cut(Ks=arrays["intrinsics"])
        c2w = arrays["pose"][0]
        h, w = DATA_HW[0] // 4, DATA_HW[1] // 4
        a = rendering.render_mesh(verts, faces, K[0], c2w, h, w, vertex_colors=colors, device="cuda")
        b = rendering.render_mesh(verts, faces, K[0], c2w, h, w, vertex_colors=colors, device="cpu")
        hit = (a[0] > 0) & (b[0] > 0)
        depth_rel = float((np.abs(a[0] - b[0])[hit] / b[0][hit]).max())
        faces_differ = float((a[1] != b[1]).mean())
        same = a[1] == b[1]
        color_diff = float(np.abs(a[2] - b[2])[same].max())
        out = {**files, "faces": len(faces), "cut": [h, w], "cut_depth_max_rel_diff": depth_rel,
               "cut_hit_mismatch": int(((a[0] > 0) != (b[0] > 0)).sum()), "cut_faces_differing_share": faces_differ,
               "cut_color_max_abs_diff": color_diff,
               "cut_tol": {"depth_rel": RENDER_RTOL, "faces_share": FACE_TIES, "color": 1e-5}}
        if (depth_rel > RENDER_RTOL or faces_differ > FACE_TIES or color_diff > 1e-5
                or out["cut_hit_mismatch"] > FACE_TIES * h * w):
            raise AssertionError(f"rendering on the card is off the CPU's: {out}")
        return out

    stage("render", ["--scenes", "scene_render", "--device", "cuda", "--modalities", "rendered_depth",
                     "rendered_mesh_faces", "rendered_image"], render_check)

    # undistort: OPENCV and OPENCV_FISHEYE copies
    cams = {"scene_opencv": dict(camera_model="OPENCV", k1=-0.12, k2=0.03, p1=0.0007, p2=-0.0005),
            "scene_fisheye": dict(camera_model="OPENCV_FISHEYE", k1=0.05, k2=-0.01, k3=0.002, k4=-0.0005)}
    for name, camera in cams.items():
        copy = scene_copy(root, name, PROC_STAGE_FRAMES, **camera)
        meta = json.loads((copy / "scene_meta.json").read_text())
        for fr in meta["frames"]:
            fr["image_distorted"], fr["depth_distorted"] = fr.pop("image"), fr.pop("depth")
        (copy / "scene_meta.json").write_text(json.dumps(meta))

    def undistort_check():
        from mapanything_tpu_torch.data import wai as wai_io
        from mapanything_tpu_torch.data_processing.conversion.adapters import _image_size
        from mapanything_tpu_torch.utils.jpeg import read_jpeg

        out = {}
        for name, camera in cams.items():
            meta = wai_io.load_scene_meta(root / name)
            new_w, new_h = meta["w"], meta["h"]
            sizes = {_image_size(root / name / fr["image"]) for fr in meta["frames"]}
            first = read_jpeg(root / name / meta["frames"][0]["image"])
            if sizes != {(new_h, new_w)} or first.shape != (new_h, new_w, 3):
                raise AssertionError(f"{name}: JPEG sizes {sizes}, not {new_h} x {new_w}")
            check_frame_files(root / name, "depth", PROC_STAGE_FRAMES)
            src = dict(fl_x=float(arrays["intrinsics"][0, 0, 0]), fl_y=float(arrays["intrinsics"][0, 1, 1]),
                       cx=float(arrays["intrinsics"][0, 0, 2]), cy=float(arrays["intrinsics"][0, 1, 2]),
                       w=DATA_HW[1], h=DATA_HW[0], **camera)
            _, _, _, maps, roi = undistort.undistort_precompute(src)
            img = (arrays["image"][0] * 255).round().astype(np.uint8)
            mask = np.full(DATA_HW, 255, np.uint8)
            mask[:40, :60] = 0
            pairs = {kind: (fn(x, maps, roi, device="cuda"), fn(x, maps, roi, device="cpu"))
                     for kind, fn, x in (("image", undistort.undistort_image, img),
                                         ("depth", undistort.undistort_depth, arrays["depth"][0]),
                                         ("mask", undistort.undistort_mask, mask))}
            res = {"new_hw": [new_h, new_w], "roi": roi,
                   "image_max_levels": int(np.abs(pairs["image"][0].astype(int) - pairs["image"][1]).max()),
                   "depth_pixels_differing": int((pairs["depth"][0] != pairs["depth"][1]).sum()),
                   "mask_pixels_differing": int((pairs["mask"][0] != pairs["mask"][1]).sum())}
            if res["image_max_levels"] > 1 or res["depth_pixels_differing"] or res["mask_pixels_differing"]:
                raise AssertionError(f"{name}: undistortion on the card is off the CPU's: {res}")
            out[name] = res
        return {"scenes": out, "frames": PROC_STAGE_FRAMES,
                "cut_tol": {"image_levels": 1, "depth_pixels": 0, "mask_pixels": 0}}

    stage("undistort", ["--scenes", *cams, "--device", "cuda"], undistort_check)
    line = {"phase": "process", "phase_id": "39", "setup_s": setup_s,
            "seconds": {k: v["seconds"] for k, v in stages.items()},
            "peak_gib": {k: v["peak_gib"] for k, v in stages.items()},
            "card": card["name"], "power_limit": card["power_limit"]}
    emit(line)
    return {"line": line, "stages": stages, "moge_rows": moge_rows}


def live_demo_phase(card) -> dict:
    """Phase 40: the port's live server on 127.0.0.1 at an ephemeral port, around the
    flagship bf16 with seeded weights: 8 fixture JPEGs POSTed, the viewer page checked
    (its point count is the masked points of the same inference called directly, or the
    viewer's sample of them),
    LIVE_REQUESTS requests timed after one warm-up with their K1 and K2 launches, the
    server shut down."""
    import base64
    import threading
    import urllib.request

    import torch

    from mapanything_tpu_torch.ops.flash_attention import launch_counts, launch_shapes, reset_launch_counts
    from mapanything_tpu_torch.tools import live_demo
    from mapanything_tpu_torch.utils.live_server import decode_image, make_model_infer_fn
    from mapanything_tpu_torch.utils.viewer import export_viewer_html

    fixtures = sorted(JPEG_FIXTURES.glob("*.jpg"))
    uploads = [fixtures[i % len(fixtures)].read_bytes() for i in range(FILES_VIEWS)]
    model = flagship_on_card()
    masked = int(make_model_infer_fn(model)([decode_image(b) for b in uploads])["mask"].sum())
    expected = min(masked, inspect.signature(export_viewer_html).parameters["max_points"].default)  # its sample
    srv = live_demo.build_server(live_demo.parse_args(["--port", "0", "--host", "127.0.0.1"]), model=model)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    body = json.dumps({"images": [base64.b64encode(b).decode() for b in uploads]}).encode()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def post() -> str:
        req = urllib.request.Request(url + "/infer", data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            if r.status != 200:
                raise AssertionError(f"the live server answered {r.status}")
            return r.read().decode()

    try:
        with urllib.request.urlopen(url + "/", timeout=60) as r:
            if r.status != 200 or "Reconstruct" not in r.read().decode():
                raise AssertionError("the live server's upload page is missing")
        page = post()  # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        request_ms = []
        for _ in range(LIVE_REQUESTS):
            t0 = time.perf_counter()
            page = post()
            request_ms.append((time.perf_counter() - t0) * 1e3)
        counts, shapes = launch_counts(), launch_shapes()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("the live server did not stop")
    if f"const N = {expected};" not in page or f"live reconstruction ({FILES_VIEWS} views)" not in page:
        raise AssertionError(f"the viewer page lacks the {expected} points of {FILES_VIEWS} views")
    per_request = {f"{k[0]}x{k[1]}": v / LIVE_REQUESTS for k, v in shapes["flash_attention_fwd"].items()}
    want = {"1037x64": 24, "1036x64": 12, f"{FILES_VIEWS * 1036 + 1}x64": 12}
    other = {k: v for k, v in counts.items() if k != "flash_attention_fwd" and v}
    if per_request != want or other:
        raise AssertionError(f"a request launched {per_request} (and {other}), not {want}")
    line = {"phase": "live_demo", "phase_id": "40", "views": FILES_VIEWS, "masked_points": masked,
            "page_points": expected,
            "page_bytes": len(page), "request_ms": request_ms, "launches_per_request": per_request,
            "launches": {f"{k[0]}x{k[1]}": v for k, v in shapes["flash_attention_fwd"].items()},
            "card": card["name"], "power_limit": card["power_limit"]}
    emit(line)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return line


def processing_phases(card, files_rows=None) -> dict:
    """Phases 38-40 in a temporary directory under build/; ``files_rows``: phase 19's kernel
    rows (the live demo's shapes), checked here when not given."""
    import torch

    if files_rows is None:
        files_rows = kernel_checks(card, FILES_SHAPES, "3")
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="processing_", dir=ROOT / "build"))
    out = {"files_rows": files_rows}
    seconds = {}
    try:
        for key, phase in (("convert", lambda: convert_phase(card, work / "convert")),
                           ("process", lambda: process_phase(card, work / "process")),
                           ("live", lambda: live_demo_phase(card))):
            t0 = time.perf_counter()
            out[key] = phase()
            seconds[key] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "processing_phases_total", "phase_id": "38-40", "seconds": seconds,
          "card": card["name"], "power_limit": card["power_limit"]})
    return out


def processing_entries(proc) -> list:
    """Phases 38-40 in the kernels line: the MoGe stage's fp32 lse-free forward and its
    split pass (phase 39's row at the stage's shape, times per batch, the run's launches),
    and the live demo's lse-free forward at the upload bucket's shapes (phase 19's rows,
    times per request, the three requests' launches)."""
    moge = proc["process"]["stages"]["moge"]
    rows = proc["process"]["moge_rows"]
    path = (f"tools/process_wai.py moge, MoGe-1 ViT-L fp32, {DATA_FRAMES} frames of {DATA_HW[1]}x{DATA_HW[0]} "
            f"in batches of {MOGE_BATCH} (phase 39); times per batch")
    entries = []
    for name, source, entry_rows in (("flash_attention_fwd", KERNEL_SOURCE, rows),
                                     ("flash_attention_split_f32", BWD_KERNEL_SOURCE, split_rows(rows))):
        entries.append(path_entry(name, f"{FA}:164", entry_rows, {rows[0]["shape"]: 24}, source=source,
                                  dtype="float32", path=path))
        entries[-1]["launches"] = moge["launches"][name]
    live = proc["live"]
    for replaces in dict.fromkeys(r["replaces"] for r in proc["files_rows"]):
        group = [r for r in proc["files_rows"] if r["replaces"] == replaces]
        entries.append(path_entry("flash_attention_fwd", replaces, group, {r["shape"]: r["per_forward"] for r in group},
                                  path=f"live demo, {FILES_VIEWS} uploads of 1024x768 -> 518x392, {LIVE_REQUESTS} "
                                       "requests (phase 40); times per request"))
        keys = {f"{r.get('tk', r['b_t_h_d'][1])}x{r['b_t_h_d'][3]}" for r in group}
        entries[-1]["launches"] = int(sum(live["launches"][k] for k in keys))
    return entries


# ---------------------------------------------------------------- phases 3h, 41 and 42

MASKED_SOURCE = "mapanything_tpu_torch/csrc/flash_attention_masked.cu"
# On the TPU every masked sdpa call went to XLA's fused attention (jax.nn.dot_product_attention).
MASKED_REPLACES = "mapanything_tpu/ops/attention.py:77"
# Phase 3h's rows: (name, B x T x H x D, dtype, mask): the forward in bf16 at the frame and
# global layers' shapes with a key-padding mask keeping ~80% of the keys, in fp32 at the MAE
# decoder's with a dense (B, H, Tq, Tk) mask; the lse forward, dq and dk/dv at the training
# frame shape in bf16 and fp32.
MASKED_SHAPES = [
    ("frame_key_padding", (8, 1369, 12, 64), "bfloat16", "key_padding"),
    ("global_key_padding", (1, 10953, 12, 64), "bfloat16", "key_padding"),
    ("fp32_dense", (4, 1369, 16, 32), "float32", "dense"),
]
MASKED_TRAIN_SHAPES = [
    ("train_key_padding", (4, 1369, 12, 64), "bfloat16", "key_padding"),
    ("fp32_train_key_padding", (4, 1369, 12, 64), "float32", "key_padding"),
]
# Phase 3h's edge cases: (Tq, Tk, B, H), lengths on and off the 64-row tiles, Tq != Tk both
# ways; each under every mask kind, in each dtype at each head dim with an instance.
MASKED_EDGE_CASES = [(1, 1, 2, 3), (7, 7, 2, 3), (64, 64, 2, 3), (65, 65, 2, 3), (129, 129, 2, 3), (129, 4000, 2, 3),
                     (1370, 77, 1, 2), (5476, 1, 1, 2)]
MASK_KINDS = ("key_padding", "dense", "shared", "all")
MASKED_TRAIN_NAMES = ("flash_attention_masked_fwd_lse", "flash_attention_masked_bwd_dq", "flash_attention_masked_bwd_dkv")


def make_mask(kind: str, b: int, h: int, tq: int, tk: int, gen, fully_masked: bool = False):
    """A boolean mask on the card: "key_padding" (B, 1, 1, Tk) keeping ~80% of the keys,
    "dense" (B, H, Tq, Tk) keeping ~50%, "shared" (1, 1, Tq, Tk) keeping ~30%, "all" one
    True broadcast everywhere. With ``fully_masked``, some rows (or, key padding, the last
    sample's every key) masked whole."""
    import torch

    shape = {"key_padding": (b, 1, 1, tk), "dense": (b, h, tq, tk), "shared": (1, 1, tq, tk), "all": (1, 1, 1, 1)}[kind]
    keep = {"key_padding": 0.8, "dense": 0.5, "shared": 0.3, "all": 1.1}[kind]
    mask = torch.rand(shape, device="cuda", generator=gen) < keep
    if fully_masked and kind == "key_padding" and b > 1:
        mask[-1] = False
    elif fully_masked and kind in ("dense", "shared"):
        mask[0, 0, : min(3, tq)] = False
    return mask


def masked_bounds(card, kernel: str, b, tq, tk, h, d, dtype_name, mask_bytes: int) -> dict:
    """A masked kernel's bound: the larger of its bytes (inputs read once, outputs written
    once, the mask's stored bytes read once) over the memory rate and its flop (forward
    4·B·H·Tq·Tk·D, dq 4·, dk/dv 6·; in fp32 six times that at the bf16 rate, the split
    bound, with the FFMA bound beside it) over the tensor cores' rate."""
    bf16_peak, f32_peak, mem_bw = peaks_for(card["name"])
    fp32 = dtype_name == "float32"
    item = 4 if fp32 else 2
    unit = b * h * tq * tk * d
    stats = 4 * b * h * tq
    flop, nbytes = {
        "fwd": (4 * unit, (2 * tq + 2 * tk) * b * h * d * item),
        "fwd_lse": (4 * unit, (2 * tq + 2 * tk) * b * h * d * item + stats),
        "dq": (4 * unit, (3 * tq + 2 * tk) * b * h * d * item + 2 * stats),
        "dkv": (6 * unit, (2 * tq + 4 * tk) * b * h * d * item + 2 * stats),
    }[kernel]
    t_ops = (6 if fp32 else 1) * flop / bf16_peak * 1e3
    t_bytes = (nbytes + mask_bytes) / mem_bw * 1e3
    out = {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flop": flop, "mask_bytes": mask_bytes}
    if fp32:
        out["ffma_bound_ms"] = max(flop / f32_peak * 1e3, t_bytes)
    return out


def sdpa_ms(q, k, v, mask, scale, backward_of=None):
    """The library yardstick: torch SDPA with a boolean attn_mask (True = attend), its forward
    or, given a cotangent ``backward_of``, its backward alone; None where SDPA refuses the
    call (not measured). Time only: on a fully masked row SDPA gives NaN or zero, not JAX's
    mean of V."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(backward_of is not None) for x in (q, k, v))
    try:
        if backward_of is None:
            return cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale), 10)
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale)
        dot = backward_of.transpose(1, 2)
        return cuda_time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), 10)
    except RuntimeError:
        return None


def masked_errors(outs: dict, exact: dict, plain: dict, fp32: bool) -> tuple:
    """Each output's error against the exact version beside the plain version's, under phase
    3's rule and in fp32 the fp32 rule; the lse on the rows with a key left (a fully masked
    row's lse is the masked logit, c + log(Tk) rounded: those rows must agree as such).
    Returns (errors, plain errors, tolerances, failures)."""
    import torch

    from mapanything_tpu_torch.ops import flash_attention as fa

    errs, plain_errs, tols, bad = {}, {}, {}, {}
    for key, got in outs.items():
        e, p = exact[key], plain[key]
        if key == "lse":
            full = fa.fully_masked_rows(e)
            if not bool((fa.fully_masked_rows(got) == full).all()):
                bad["lse_fully_masked_rows"] = "the kernel's fully masked rows differ from the exact version's"
            keep = ~full
            got, e, p = got[keep], e[keep], p[keep]
            if not got.numel():
                continue
        errs[key], plain_errs[key] = max_err(got, e), max_err(p, e)
        tols[key] = tolerance(plain_errs[key], e)
        if fp32:
            tols[key] = min(tols[key], fp32_tolerance(plain_errs[key], e))
        if not bool(torch.isfinite(got).all()) or not errs[key] <= tols[key]:
            bad[key] = (errs[key], tols[key])
    return errs, plain_errs, tols, bad


def masked_run(q, k, v, mask, scale, do=None, rows=None):
    """The masked kernels on the card and their plain versions: the kernels' outputs (the
    lse-free forward's o; with ``do`` also the lse forward's o and lse, and dq and dk/dv fed
    that lse and delta = rowsum(dO·o)), the exact versions' (fp32 for bf16, fp64 for fp32)
    and the plain versions' in the inputs' dtype, each on query rows ``rows`` (all when
    None); the backward's versions are fed the kernels' statistics. With one key the
    backward is fed the statistics of a softmax merged over another block (phase 3g's merged
    statistics): the lse raised by 0.5 and delta halved. Against its own, P = 1, o = v and
    dS = dP - delta = 0 exactly, so dq and dk would be rounding noise that no rule relative to
    their magnitude can hold. A fully masked row's lse stays the masked logit."""
    import torch

    from mapanything_tpu_torch.ops import flash_attention as fa

    b, tq, h, _ = q.shape
    tk = k.shape[1]
    mv = fa.masked_view(mask, b, h, tq, tk)
    exact_dtype = torch.float64 if q.dtype == torch.float32 else torch.float32
    sl = slice(None) if rows is None else rows
    outs = {"o": fa.flash_attention_masked(q, k, v, mask, scale)[:, sl]}
    xe = [x.to(exact_dtype) for x in (q, k, v)]
    exact = {"o": fa.attention_masked_reference(xe[0][:, sl], xe[1], xe[2], mv[:, :, sl], scale)}
    plain = {"o": fa.attention_masked_reference(q[:, sl], k, v, mv[:, :, sl], scale)}
    if do is not None:  # the training kernels (on every row)
        o, lse = fa.flash_attention_masked_lse(q, k, v, mv, scale)
        delta = fa.attention_bwd_delta(o, do).contiguous()
        fed, delta = (lse + 0.5, 0.5 * delta) if tk == 1 else (lse, delta)
        dq = fa.flash_attention_masked_bwd_dq(q, k, v, do, mv, fed, delta, scale)
        dk, dv = fa.flash_attention_masked_bwd_dkv(q, k, v, do, mv, fed, delta, scale)
        outs.update(o_lse=o, lse=lse, dq=dq, dk=dk, dv=dv)
        for target, args, acc in ((exact, xe + [do.to(exact_dtype)], exact_dtype), (plain, [q, k, v, do], torch.float32)):
            o_r, lse_r = fa.attention_masked_lse_reference(*args[:3], mv, scale)
            stats = (fed.to(acc), delta.to(acc))
            target.update(o_lse=o_r, lse=lse_r, dq=fa.attention_masked_bwd_dq_reference(*args, mv, *stats, scale))
            target["dk"], target["dv"] = fa.attention_masked_bwd_dkv_reference(*args, mv, *stats, scale)
    torch.cuda.synchronize()
    return outs, exact, plain


def masked_inputs(b, tq, tk, h, d, dtype, gen, fused: bool):
    """q, k, v (fused: strided views of one qkv tensor, else three tensors) and dO."""
    import torch

    if fused:
        q, k, v = torch.randn(b, tq, 3, h, d, device="cuda", generator=gen).to(dtype).unbind(2)
    else:
        q, k, v = (torch.randn(b, n, h, d, device="cuda", generator=gen).to(dtype) for n in (tq, tk, tk))
    return q, k, v, torch.randn(b, tq, h, d, device="cuda", generator=gen).to(dtype)


def masked_kernel_checks(card) -> dict:
    """Phase 3h: the masked kernels against their plain versions under phase 3's rule (fp32
    also under the fp32 rule) at MASKED_SHAPES (forward) and MASKED_TRAIN_SHAPES (lse
    forward, dq, dk/dv), with kernel, plain, SDPA-with-mask and bound times; the edge cases
    (masked_edge_checks); then the masked path: ``ops.attention.sdpa(q, k, v, mask=)`` once
    at each forward shape without gradients and once at each training shape under autograd,
    its launches counted from 0 by kernel."""
    import torch

    from mapanything_tpu_torch.ops import attention
    from mapanything_tpu_torch.ops import flash_attention as fa

    rows, train_rows = [], []
    for name, (b, t, h, d), dtype_name, kind in MASKED_SHAPES:
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator(device="cuda").manual_seed(31)
        q, k, v, _ = masked_inputs(b, t, t, h, d, dtype, gen, fused=True)
        mask = make_mask(kind, b, h, t, t, gen)
        mv = fa.masked_view(mask, b, h, t, t)
        scale = d**-0.5
        sl = (torch.cat([torch.arange(ROW_SLICE // 2), torch.arange(t - ROW_SLICE // 2, t)]).cuda()
              if t > ROW_SLICE else None)
        outs, exact, plain = masked_run(q, k, v, mask, scale, rows=sl)
        errs, plain_errs, tols, bad = masked_errors(outs, exact, plain, dtype == torch.float32)
        del outs, exact, plain
        torch.cuda.empty_cache()
        chunk = min(t, PLAIN_SLAB // t)
        plain_call = lambda: [fa.attention_masked_reference(q[:, i:i + chunk], k, v, mv[:, :, i:i + chunk], scale)  # noqa: E731
                              for i in range(0, t, chunk)]
        row = {"phase": "masked_kernel_check", "phase_id": "3h", "shape": name, "b_t_h_d": [b, t, h, d],
               "dtype": dtype_name, "mask": kind, "mask_shape": list(mask.shape), "replaces": MASKED_REPLACES,
               "rows_checked": t if sl is None else ROW_SLICE, "max_abs_err": errs["o"], "plain_err": plain_errs["o"],
               "tol": tols["o"], "ms": cuda_time_ms(lambda: fa.flash_attention_masked(q, k, v, mask, scale), 10),
               "plain_ms": cuda_time_ms(plain_call, iters=2, warmup=1), "library_ms": sdpa_ms(q, k, v, mv, scale),
               **masked_bounds(card, "fwd", b, t, t, h, d, dtype_name, mask.numel()),
               "card": card["name"], "power_limit": card["power_limit"]}
        row["tflops"] = 4 * b * h * t * t * d / row["ms"] / 1e9
        emit(row)
        if bad:
            raise AssertionError(f"fa_fwd_masked disagrees with its plain version at {name}: {bad}")
        rows.append(row)
        del q, k, v, mask, mv
        torch.cuda.empty_cache()
    for name, (b, t, h, d), dtype_name, kind in MASKED_TRAIN_SHAPES:
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator(device="cuda").manual_seed(32)
        q, k, v, do = masked_inputs(b, t, t, h, d, dtype, gen, fused=True)
        mask = make_mask(kind, b, h, t, t, gen)
        mv = fa.masked_view(mask, b, h, t, t)
        scale = d**-0.5
        outs, exact, plain = masked_run(q, k, v, mask, scale, do)
        errs, plain_errs, tols, bad = masked_errors(outs, exact, plain, dtype == torch.float32)
        del outs, exact, plain
        o, lse = fa.flash_attention_masked_lse(q, k, v, mv, scale)
        delta = fa.attention_bwd_delta(o, do).contiguous()
        calls = {
            "flash_attention_masked_fwd_lse": ("fwd_lse", lambda: fa.flash_attention_masked_lse(q, k, v, mv, scale),
                                               lambda: fa.attention_masked_lse_reference(q, k, v, mv, scale),
                                               sdpa_ms(q, k, v, mv, scale)),
            "flash_attention_masked_bwd_dq": (
                "dq", lambda: fa.flash_attention_masked_bwd_dq(q, k, v, do, mv, lse, delta, scale),
                lambda: fa.attention_masked_bwd_dq_reference(q, k, v, do, mv, lse, delta, scale),
                sdpa_ms(q, k, v, mv, scale, backward_of=do)),
            "flash_attention_masked_bwd_dkv": (
                "dkv", lambda: fa.flash_attention_masked_bwd_dkv(q, k, v, do, mv, lse, delta, scale),
                lambda: fa.attention_masked_bwd_dkv_reference(q, k, v, do, mv, lse, delta, scale), None),
        }
        kernels = {}
        sdpa_bwd = calls["flash_attention_masked_bwd_dq"][3]
        calls["flash_attention_masked_bwd_dkv"] = calls["flash_attention_masked_bwd_dkv"][:3] + (sdpa_bwd,)
        for kname, (kind_key, call, plain_call, library) in calls.items():
            kernels[kname] = {"replaces": MASKED_REPLACES, "ms": cuda_time_ms(call, 10),
                              "plain_ms": cuda_time_ms(plain_call, iters=2, warmup=1), "library_ms": library,
                              **masked_bounds(card, kind_key, b, t, t, h, d, dtype_name, mask.numel())}
        # SDPA's backward computes dq, dk and dv together: it stands beside each backward kernel.
        row = {"phase": "masked_train_kernel_check", "phase_id": "3h", "shape": name, "b_t_h_d": [b, t, h, d],
               "dtype": dtype_name, "mask": kind, "mask_shape": list(mask.shape), "max_abs_err": errs,
               "plain_err": plain_errs, "tol": tols, "kernels": kernels,
               "card": card["name"], "power_limit": card["power_limit"]}
        emit(row)
        if bad:
            raise AssertionError(f"the masked training kernels disagree with their plain versions at {name}: {bad}")
        train_rows.append(row)
        del q, k, v, do, o, lse, delta, mask, mv
        torch.cuda.empty_cache()
    edges = masked_edge_checks(card)

    # The masked path: sdpa(mask=) at each shape, the counts from 0.
    fa.reset_launch_counts()
    for name, (b, t, h, d), dtype_name, kind in MASKED_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(31)
        q, k, v, _ = masked_inputs(b, t, t, h, d, getattr(torch, dtype_name), gen, fused=True)
        with torch.no_grad():
            attention.sdpa(q, k, v, mask=make_mask(kind, b, h, t, t, gen))
    for name, (b, t, h, d), dtype_name, kind in MASKED_TRAIN_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(32)
        q, k, v, do = masked_inputs(b, t, t, h, d, getattr(torch, dtype_name), gen, fused=False)
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        attention.sdpa(q, k, v, mask=make_mask(kind, b, h, t, t, gen)).backward(do)
    torch.cuda.synchronize()
    counts = fa.launch_counts()
    want = {"flash_attention_masked_fwd": len(MASKED_SHAPES),
            **{k: len(MASKED_TRAIN_SHAPES) for k in MASKED_TRAIN_NAMES}}
    emit({"phase": "masked_path", "phase_id": "3h", "launches": counts})
    if not counts_match(counts, want):
        raise AssertionError(f"the masked path launched {counts}, not {want}")
    del q, k, v, do
    torch.cuda.empty_cache()
    return {"rows": rows, "train_rows": train_rows, "edges": edges, "launches": counts}


def masked_edge_checks(card) -> dict:
    """Phase 3h's edge cases. Every (Tq, Tk, B, H) of MASKED_EDGE_CASES under each mask kind
    (key padding, dense, shared with stride-0 dimensions; all true), fully masked rows in
    each but the all-true kind, in bf16 at D = 64 and 128 and fp32 at 32, 64 and 128: the
    lse-free forward, the lse forward, dq and dk/dv against their plain versions under phase
    3's rule (fp32 also under the fp32 rule), q, k and v views of a fused qkv tensor where
    Tq = Tk; the fp32 D = 48 forward likewise (lse-free). Then JAX's semantics on the card:
    a fully masked row's o is the mean of V and its dq row zero, a head masked whole gets
    zero dk and dv = sum(dO) / Tk; an all-true mask gives the unmasked kernel's o."""
    import torch

    from mapanything_tpu_torch.ops import flash_attention as fa

    cases, failures = 0, []
    worst = 0.0
    combos = [(torch.bfloat16, d) for d in fa.HEAD_DIMS] + [(torch.float32, d) for d in fa.F32_HEAD_DIMS]
    for dtype, d in combos:
        lse_served = d in fa.head_dims(dtype, lse=True)
        for tq, tk, b, h in MASKED_EDGE_CASES:
            for kind in MASK_KINDS:
                gen = torch.Generator(device="cuda").manual_seed(cases)
                q, k, v, do = masked_inputs(b, tq, tk, h, d, dtype, gen, fused=tq == tk)
                mask = make_mask(kind, b, h, tq, tk, gen, fully_masked=True)
                outs, exact, plain = masked_run(q, k, v, mask, EDGE_SCALE, do if lse_served else None)
                errs, _, tols, bad = masked_errors(outs, exact, plain, dtype == torch.float32)
                cases += 1
                worst = max([worst] + [errs[key] / tols[key] for key in errs if tols[key] > 0])
                if bad:
                    failures.append({"dtype": str(dtype), "d": d, "tq_tk_b_h": [tq, tk, b, h], "mask": kind,
                                     "bad": str(bad)})
    semantics = {}
    for dtype, d in [(torch.bfloat16, 64), (torch.float32, 64), (torch.float32, 32)]:
        gen = torch.Generator(device="cuda").manual_seed(7)
        b, t, h = 2, 200, 3
        q, k, v, do = masked_inputs(b, t, t, h, d, dtype, gen, fused=False)
        mask = torch.rand(b, h, t, t, device="cuda", generator=gen) < 0.5
        mask[0, 0] = False  # batch 0, head 0: masked whole
        mask[1, 2, 5:9] = False  # four fully masked rows
        qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
        o = fa.flash_attention_masked(qs, ks, vs, mask, 0.2)
        dq, dk, dv = torch.autograd.grad(o, (qs, ks, vs), do)
        mean_v = v[0, :, 0].float().mean(0)
        tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
        checks = {
            "o_is_mean_of_v": (o[0, :, 0].float() - mean_v).abs().max().item() <= tol * mean_v.abs().max().item(),
            "o_rows_are_mean_of_v": (o[1, 5:9, 2].float() - v[1, :, 2].float().mean(0)).abs().max().item()
                                    <= tol * v[1, :, 2].float().abs().max().item(),
            "dq_zero_on_fully_masked_rows": not dq[0, :, 0].any().item() and not dq[1, 5:9, 2].any().item(),
            "dk_zero_on_a_head_masked_whole": not dk[0, :, 0].any().item(),
            "dv_is_sum_of_do_over_tk": (dv[0, :, 0].float() - do[0, :, 0].float().sum(0) / t).abs().max().item()
                                       <= tol * (do[0, :, 0].float().sum(0) / t).abs().max().item() + 1e-6,
        }
        ones = torch.ones(1, 1, 1, 1, dtype=torch.bool, device="cuda")
        with torch.no_grad():
            masked_o = fa.flash_attention_masked(q, k, v, ones, 0.2)
            plain_o = fa.flash_attention(q, k, v, 0.2)
            exact_o = fa.attention_reference(*(x.double() for x in (q, k, v)), 0.2)
        rule = tolerance(max_err(fa.attention_reference(q, k, v, 0.2), exact_o), exact_o)
        checks["all_true_is_unmasked"] = max_err(masked_o, plain_o) <= 2 * rule
        semantics[f"{str(dtype).split('.')[-1]}_d{d}"] = checks
        failures += [{"dtype": str(dtype), "d": d, "semantics": key} for key, ok in checks.items() if not ok]
    line = {"phase": "masked_edges", "phase_id": "3h", "cases": cases, "worst_err_over_tol": worst,
            "semantics": semantics, "failures": failures[:20], "card": card["name"],
            "power_limit": card["power_limit"]}
    emit(line)
    if failures:
        raise AssertionError(f"{len(failures)} masked edge cases failed: {failures[:5]}")
    return line


def masked_entries(masked) -> list:
    """Phase 3h in the kernels line: the four masked kernels on the masked path (sdpa(mask=)
    once at each of phase 3h's shapes: without gradients at MASKED_SHAPES, under autograd at
    MASKED_TRAIN_SHAPES), each with that run's launches; times are the sums of each shape's
    per-call times."""
    launches = masked["launches"]
    path = "ops.attention.sdpa(q, k, v, mask=) once at each of phase 3h's shapes; times summed over them"
    rows = masked["rows"]
    entries = [path_entry("flash_attention_masked_fwd", MASKED_REPLACES, rows, {r["shape"]: 1 for r in rows},
                          source=MASKED_SOURCE, path=path)]
    entries[-1]["launches"] = launches["flash_attention_masked_fwd"]
    outputs = {"flash_attention_masked_fwd_lse": ("o_lse", "lse"), "flash_attention_masked_bwd_dq": ("dq",),
               "flash_attention_masked_bwd_dkv": ("dk", "dv")}
    for name in MASKED_TRAIN_NAMES:
        rows = [{"shape": r["shape"], "b_t_h_d": r["b_t_h_d"], "dtype": r["dtype"],
                 "max_abs_err": max(r["max_abs_err"][o] for o in outputs[name]), **r["kernels"][name]}
                for r in masked["train_rows"]]
        entries.append(path_entry(name, MASKED_REPLACES, rows, {r["shape"]: 1 for r in rows}, source=MASKED_SOURCE,
                                  path=path))
        entries[-1]["launches"] = launches[name]
    return entries


def diagnose_phase(card) -> dict:
    """Phase 41: tools/diagnose_lr_nan.py at its defaults on the card: the flagship bf16 train
    step on 1 x 4 x 518 at lr 1e-4 from seeded random weights, 10 steps (fewer if the loss
    goes non-finite), each after a forensic forward and backward; its lines, ms a step, the
    launches a step (dq and dk/dv 96 each: 48 in the forensic pass, 48 in the step; the lse
    forward 192, the tool's model being rematerialised as the JAX script's, save_attn_mlp_pre),
    the first non-finite step and, at the last step, the forensic quantities that grew most."""
    import contextlib
    import io

    import torch

    from mapanything_tpu_torch.ops.flash_attention import launch_counts, reset_launch_counts
    from mapanything_tpu_torch.tools import diagnose_lr_nan

    printed = io.StringIO()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        records = diagnose_lr_nan.run(diagnose_lr_nan.parse_args([]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    n = len(records)
    want = {k: (192 if k == "flash_attention_fwd_lse" else 96) * n for k in TRAIN_KERNELS}
    first_bad = next((r["step"] for r in records if not math.isfinite(r["metrics"]["loss"])), None)
    f0, fl = records[0]["forensic"], records[-1]["forensic"]
    growth = {k: fl[k] / f0[k] for k in f0 if k in fl and f0[k] and math.isfinite(fl[k])}
    line = {"phase": "diagnose_lr_nan", "phase_id": "41", "steps_run": n, "first_nonfinite_step": first_bad,
            "nonfinite_forensic_at_last_step": sorted(k for k, x in fl.items() if not math.isfinite(x)),
            "largest_growth_step0_to_last": dict(sorted(growth.items(), key=lambda kv: -kv[1])[:8]),
            "loss_by_step": [r["metrics"]["loss"] for r in records],
            "grad_norm_by_step": [r["metrics"]["grad_norm"] for r in records],
            "ms_by_step": [r["ms"] for r in records], "launches_per_step": {k: v / n for k, v in counts.items() if v},
            "seconds": seconds, "lines": printed.getvalue().splitlines(),
            "card": card["name"], "power_limit": card["power_limit"]}
    emit(line)
    if not counts_match(counts, want):
        raise AssertionError(f"{n} diagnose steps launched {counts}, not {want}")
    return line


def disentangled_flagship_phase(card, group) -> dict:
    """Phase 42: the flagship fp32 train step (MapAnythingConfig(), the geometric encoders)
    with LossConfig(disentangled=True) through the view-sharded step (``make_train_step(...,
    view_group=)``, the ring) at world size 1 on the card (NCCL, ``group``), against the same
    step's loss and gradients on the CPU in fp32 (``make_loss_fn`` over a gloo group of this
    process), 1 x 2 views of 224 x 224 (the CPU step's cost), TF32 off: the loss, its terms,
    the gradient norm and every gradient within 1e-3 of their magnitude, phase 6's gate. A
    gradient leaf past it is arbitrated by the same step on the CPU in float64
    (``step_gradient_probe.float64_mode``): it passes if the card's gap to float64 is at most
    twice the fp32 CPU's own (phase 3's rule, the fp32 CPU run as the plain version): an fp32
    run puts a few ReLU inputs on the other side of zero, on either device (PERF.md)."""
    import torch
    import torch.distributed as dist

    from mapanything_tpu_torch.models.mapanything import (
        GeometricInputConfig, MapAnything, MapAnythingConfig, sample_modality_masks,
    )
    from mapanything_tpu_torch.ops.flash_attention import launch_counts, reset_launch_counts
    from mapanything_tpu_torch.parallel.mesh import make_view_group, shard_views_pytree
    from mapanything_tpu_torch.tools.step_gradient_probe import float64_mode
    from mapanything_tpu_torch.train.losses import LossConfig, synthetic_loss_batch
    from mapanything_tpu_torch.train.optim import OptimConfig, build_optimizer
    from mapanything_tpu_torch.train.step import init_train_state, make_loss_fn, make_train_step

    rtol = 1e-3
    B, V, HW = 1, 2, 224
    cfg = MapAnythingConfig()
    img = torch.from_numpy(np.random.RandomState(42).randn(B, V, HW, HW, 3).astype(np.float32))
    batch = synthetic_loss_batch(B, V, HW, HW, seed=42)
    geo = GeometricInputConfig(ray_dirs_prob=1.0, depth_prob=1.0, cam_prob=1.0)
    masks = sample_modality_masks(torch.Generator().manual_seed(42), B, V, (HW, HW), geo)
    loss_cfg = LossConfig(disentangled=True)
    t0 = time.perf_counter()
    cuda_model = MapAnything(cfg, device="cuda", seed=0, geometric_inputs=True)
    with torch.device("meta"):
        cpu_model = MapAnything(cfg, device="meta", geometric_inputs=True)
    cpu_model.to_empty(device="cpu")
    cpu_model.load_state_dict(cuda_model.state_dict())
    setup_s = time.perf_counter() - t0

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        opt = build_optimizer(OptimConfig(lr=1e-4, min_lr=1e-6), cuda_model)
        step = make_train_step(cuda_model, opt, loss_cfg, geo, view_group=group)
        reset_launch_counts()
        t = time.perf_counter()
        state, metrics = step(init_train_state(cuda_model, opt), img.cuda(), batch.to("cuda"),
                              torch.Generator().manual_seed(0), masks=masks)
        torch.cuda.synchronize()
        cuda_s, counts = time.perf_counter() - t, launch_counts()
        gpu = {k: v.detach().cpu() for k, v in metrics.items()}
        gpu_grads = {n: p.grad.detach().cpu() for n, p in state.params.items()}
        del opt, step, state, cuda_model
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    gloo = dist.new_group([0], backend="gloo")
    vg = make_view_group(gloo)

    def cpu_step(float64: bool):
        """The step's loss, terms, gradient norm and gradients on the CPU, and its seconds."""
        t = time.perf_counter()
        for p in cpu_model.parameters():
            p.grad = None
        with float64_mode() if float64 else contextlib.nullcontext():
            if float64:
                cpu_model.double()
            cast = (lambda x: x.double()) if float64 else (lambda x: x)  # noqa: E731
            b = type(batch)(**{k: cast(v) if isinstance(v, torch.Tensor) and v.is_floating_point() else v
                               for k, v in vars(batch).items()})
            loss, details = make_loss_fn(cpu_model, loss_cfg, view_group=vg)(b, cast(img), shard_views_pytree(masks, vg))
            loss.backward()
        out = {k: v.detach() for k, v in details.items()}
        out["loss"] = loss.detach()
        grads = {n: p.grad.detach() for n, p in cpu_model.named_parameters()}
        out["grad_norm"] = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
        return out, grads, time.perf_counter() - t

    try:
        ref, ref_grads, cpu_s = cpu_step(float64=False)
        errs = {k: rel_err(gpu[k], v) for k, v in ref.items()}
        grad_errs = {n: rel_err(gpu_grads[n], g) for n, g in ref_grads.items()}
        past = [n for n, e in grad_errs.items() if not e <= rtol]
        arbitrated, f64_s = {}, None
        if past:
            _, f64_grads, f64_s = cpu_step(float64=True)
            arbitrated = {n: {"card_to_float64": rel_err(gpu_grads[n], f64_grads[n]),
                              "cpu_fp32_to_float64": rel_err(ref_grads[n], f64_grads[n]),
                              "card_to_cpu_fp32": grad_errs[n]} for n in past}
    finally:
        dist.destroy_process_group(gloo)
    held = {n: e for n, e in grad_errs.items() if n not in arbitrated}
    worst = max(held.items(), key=lambda kv: kv[1])
    line = {"phase": "disentangled_flagship_step", "phase_id": "42",
            "config": f"MapAnythingConfig() fp32, geometric inputs, {B}x{V}x{HW}x{HW}, LossConfig(disentangled=True), "
                      "make_train_step(view_group=) at world size 1",
            "rtol": rtol, "loss": float(ref["loss"]), "errors": errs, "worst_grad": worst,
            "arbitrated_by_float64": arbitrated, "terms": {k: float(v) for k, v in gpu.items()},
            "cuda_launches": counts, "cuda_step_s": cuda_s, "cpu_step_s": cpu_s, "cpu_float64_s": f64_s,
            "setup_s": setup_s, "card": card["name"], "power_limit": card["power_limit"]}
    emit(line)
    if any(counts[k] == 0 for k in TRAIN_KERNELS + ("flash_attention_split_f32",)):
        raise AssertionError(f"the card's step did not run the fp32 training kernels: {counts}")
    bad = {k: v for d in (errs, held) for k, v in d.items() if not v <= rtol}
    bad.update({n: a for n, a in arbitrated.items() if not a["card_to_float64"] <= 2 * a["cpu_fp32_to_float64"]})
    if bad:
        raise AssertionError(f"the disentangled step on the card and on the CPU disagree beyond {rtol}: {bad}")
    del cpu_model
    return line


# ---------------------------------------------------------------- phases 3i, 43 and 44

# Phase 43's gates: each gradient leaf of a step against the same leaf of the first step
# without remat on the same weights, batch and masks, max |difference| over the leaf's max
# |value|; the worst leaf and the median leaf. The card's backward is not bitwise repeatable
# in bf16 (two steps without remat differ in 720 of 721 leaves, by one or two bf16 ulps of
# a leaf's magnitude): about 3.5x the largest readings of sound runs on an H100 (PERF.md),
# worst 0.0105 and median 0.0029, steps without remat and under every policy alike.
REMAT_GRAD_GAP_LIMIT = 0.04
REMAT_GRAD_MEDIAN_LIMIT = 0.01
# Phases 3i and 44: the stage-2 recipe's sets of 24 views (configs/dataset/
# megatrain_13d_518_many_ar_24v_48ipg_64g.yaml) at 518 x 518; the global layers attend over
# 24·1369 + 1 = 32857 tokens. Launches per step with every block rematerialised: the lse
# forward twice (the forward and its recompute in the backward), dq and dk/dv once.
STAGE2_VIEWS = 24
STAGE2_SHAPES = [
    ("encoder_24_views", (24, 1370, 16, 64), "bfloat16", 24),
    ("frame_24_views", (24, 1369, 12, 64), "bfloat16", 12),
]
STAGE2_GLOBAL = ("global_24_views", (1, 24 * 1369 + 1, 12, 64), "bfloat16", 12)
STAGE2_REPLACES = {  # K4/K5 at the encoder and frame layers, K7/K5 (the long regime) at the global layers
    "flash_attention_fwd_lse": {"encoder_24_views": f"{FA}:118", "frame_24_views": f"{FA}:118",
                                "global_24_views": f"{FA}:168"},
    "flash_attention_bwd_dq": dict.fromkeys(("encoder_24_views", "frame_24_views", "global_24_views"), f"{FA}:227"),
    "flash_attention_bwd_dkv": dict.fromkeys(("encoder_24_views", "frame_24_views", "global_24_views"),
                                             f"{FA}:262"),
}


def remat_launches(t_global: int, recomputed: bool) -> dict:
    """Launches of each training kernel a flagship step by (Tk, D): the encoder's 24 layers at
    1370 keys, the frame layers' 12 at 1369 and the global layers' 12 at ``t_global``; with
    ``recomputed`` the lse forward twice."""
    per = {(1370, 64): 24, (1369, 64): 12, (t_global, 64): 12}
    fwd = {s: 2 * n for s, n in per.items()} if recomputed else per
    return {"flash_attention_fwd_lse": fwd, "flash_attention_bwd_dq": per, "flash_attention_bwd_dkv": per}


def check_remat_launches(label: str, want: dict) -> None:
    from mapanything_tpu_torch.ops.flash_attention import launch_counts, launch_shapes

    counts, shapes = launch_counts(), launch_shapes()
    totals = {k: sum(v.values()) for k, v in want.items()}
    if not counts_match(counts, totals) or any(shapes.get(k) != v for k, v in want.items()):
        raise AssertionError(f"{label} launched {shape_counts(shapes)}, not {shape_counts(want)}")


def stage2_global_check(card) -> dict:
    """Phase 3i at the global layers: the lse forward, dq and dk/dv at 1 x 32857 x 12 x 64
    against their plain versions under phase 3's rule, every row held, the plain versions
    one head at a time (P alone is 32857² x 4 B = 4.3 GB a head); kernel, plain (by heads),
    SDPA and bound times."""
    import torch
    import torch.nn.functional as F

    from mapanything_tpu_torch.ops import flash_attention as fa

    name, (b, t, h, d), dtype_name, per_step = STAGE2_GLOBAL
    bf16_peak, _, mem_bw = peaks_for(card["name"])
    scale = d**-0.5
    gen = torch.Generator(device="cuda").manual_seed(5)
    qkv = torch.randn(b, t, 3, h, d, device="cuda", generator=gen).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = torch.randn(b, t, h, d, device="cuda", generator=gen).to(torch.bfloat16)
    o, lse = fa.flash_attention_lse(q, k, v, scale)
    delta = fa.attention_bwd_delta(o, do).contiguous()
    got = {"o": o, "lse": lse, "dq": fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)}
    got["dk"], got["dv"] = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()

    def head(x, i):
        return x[:, :, i:i + 1] if x.dim() == 4 else x[:, i:i + 1]

    def reference(xs):  # the plain forward and backward of one head
        o_r, lse_r = fa.attention_lse_reference(*xs[:3], scale)
        grads = fa.attention_bwd_reference(*xs[:3], o_r, lse_r, xs[3], scale)
        return dict(zip(("o", "lse", "dq", "dk", "dv"), (o_r, lse_r) + tuple(grads)))

    errs = dict.fromkeys(got, 0.0)
    plain_errs, scales = dict(errs), dict(errs)
    for i in range(h):  # exact: fp32 inputs; plain: the kernels' bf16 inputs
        xs = [head(x, i) for x in (q, k, v, do)]
        exact = reference([x.float() for x in xs])
        plain = reference(xs)
        for key in got:
            errs[key] = max(errs[key], max_err(head(got[key], i), exact[key]))
            plain_errs[key] = max(plain_errs[key], max_err(plain[key], exact[key]))
            scales[key] = max(scales[key], exact[key].abs().max().item())
        del exact, plain
        torch.cuda.empty_cache()
    tols = {key: tolerance(plain_errs[key], torch.tensor(scales[key])) for key in got}
    finite = all(bool(torch.isfinite(x).all()) for x in got.values())
    plain_delta = fa.attention_bwd_delta(o, do)

    def by_heads(fn, *xs):
        return [fn(*(head(x, i) for x in xs), scale) for i in range(h)]

    times = {
        "flash_attention_fwd_lse": (cuda_time_ms(lambda: fa.flash_attention_lse(q, k, v, scale), iters=10),
                                    cuda_time_ms(lambda: by_heads(fa.attention_lse_reference, q, k, v), iters=2,
                                                 warmup=1)),
        "flash_attention_bwd_dq": (
            cuda_time_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale), iters=10),
            cuda_time_ms(lambda: by_heads(fa.attention_bwd_dq_reference, q, k, v, do, lse, plain_delta), iters=2,
                         warmup=1)),
        "flash_attention_bwd_dkv": (
            cuda_time_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale), iters=10),
            cuda_time_ms(lambda: by_heads(fa.attention_bwd_dkv_reference, q, k, v, do, lse, plain_delta), iters=2,
                         warmup=1)),
    }
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    library_fwd_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), iters=10)
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
    library_bwd_ms = cuda_time_ms(
        lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), iters=10)
    del sdpa_out, qt, kt, vt
    io_stats = 2 * 4 * b * h * t
    work = {"flash_attention_bwd_dq": (4 * b * h * t * t * d, 5 * b * t * h * d * 2 + io_stats),
            "flash_attention_bwd_dkv": (6 * b * h * t * t * d, 6 * b * t * h * d * 2 + io_stats)}
    kernels = {}
    for kname, (ms, plain_ms) in times.items():
        entry = {"replaces": STAGE2_REPLACES[kname][name], "ms": ms, "plain_ms": plain_ms}
        if kname == "flash_attention_fwd_lse":
            entry.update(library_ms=library_fwd_ms, **forward_bounds(card, b, t, t, h, d, dtype_name, True),
                         tflops=fa.attention_flops(b, t, t, h, d) / ms / 1e9)
        else:
            flop, nbytes = work[kname]
            t_ops, t_bytes = flop / bf16_peak * 1e3, nbytes / mem_bw * 1e3
            entry.update(library_ms=library_bwd_ms, bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes else "bytes", tflops=flop / ms / 1e9)
        kernels[kname] = entry
    row = {"phase": "train_kernel_check", "phase_id": "3i", "shape": name, "b_t_h_d": [b, t, h, d],
           "dtype": dtype_name, "max_abs_err": errs, "plain_err": plain_errs, "tol": tols, "kernels": kernels,
           "plain_by": "head", "library_bwd_ms": library_bwd_ms, "per_step": per_step,
           "card": card["name"], "power_limit": card["power_limit"]}
    emit(row)
    bad = {key: (errs[key], tols[key]) for key in got if not errs[key] <= tols[key]}
    if not finite or bad:
        raise AssertionError(f"training kernels disagree with their plain versions at {name}: {bad}")
    del qkv, q, k, v, do, o, lse, delta, got
    torch.cuda.empty_cache()
    return row


def remat_sweep_runs() -> list:
    """Phase 43's remat runs: (label, True, policy name) for each distinct policy of
    models/blocks.py's REMAT_POLICIES (the JAX resolve_remat_policy's names), run once under
    the first of the names that resolve to it; the label joins them all with "=" (None and
    "nothing" are one full recompute, "dots" and "dots_saveable" one policy)."""
    from mapanything_tpu_torch.models.blocks import REMAT_POLICIES

    names = {}
    for name, policy in REMAT_POLICIES.items():
        names.setdefault((policy.saved, policy.offloaded), []).append(name)
    return [("remat_" + "=".join(map(str, group)), True, group[0]) for group in names.values()]


def remat_sweep(card) -> dict:
    """Phase 43: the flagship bf16 step (phase 7's model, batch and masks; forward, loss and
    backward, no update) on 1 x 4 x 518 without remat, under full remat and under each
    distinct policy (remat_sweep_runs), on the same weights, batch and masks, then without remat again: ms a step (two
    after a warm one), peak GiB, launches by (Tk, D), and each gradient leaf's gap to the
    first step without remat (the worst leaves, the median; REMAT_GRAD_GAP_LIMIT). The
    second step without remat reads the card's own spread, held to the same limits. Full
    remat must peak below the step without."""
    import torch

    from mapanything_tpu_torch.models.mapanything import GeometricInputConfig, MapAnything
    from mapanything_tpu_torch.ops.flash_attention import launch_shapes, reset_launch_counts
    from mapanything_tpu_torch.train.losses import LossConfig, synthetic_loss_batch
    from mapanything_tpu_torch.train.step import draw_step_inputs, make_loss_fn

    B, V, H, W = 1, 4, 518, 518
    model = MapAnything(flagship_config(12), device="cuda", seed=0, geometric_inputs=True)
    batch = synthetic_loss_batch(B, V, H, W, seed=0).to("cuda")
    img = torch.from_numpy(np.random.RandomState(0).randn(B, V, H, W, 3).astype(np.float32)).cuda()
    masks, pe = draw_step_inputs(model, GeometricInputConfig(), torch.Generator().manual_seed(0), (B, V, H, W))
    loss_fn = make_loss_fn(model, LossConfig())
    names, params = zip(*model.named_parameters())

    def step():
        for p in params:
            p.grad = None
        loss, _ = loss_fn(batch, img, masks, pe)
        loss.backward()
        return loss

    runs = [("no_remat", False, None)] + remat_sweep_runs() + [("no_remat_again", False, None)]
    base, lines = None, {}
    for label, remat, policy in runs:
        model.configure_remat(remat=remat, remat_policy=policy)
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(2):
            reset_launch_counts()
            t = time.perf_counter()
            loss = step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check_remat_launches(f"phase 43 ({label})", remat_launches(4 * 1369 + 1, remat))
        shapes = launch_shapes()
        grads = [p.grad.float() for p in params]
        if not all(bool(torch.isfinite(g).all()) for g in grads) or not np.isfinite(loss.item()):
            raise AssertionError(f"phase 43 ({label}): a non-finite loss or gradient")
        if base is None:
            base = [g.cpu() for g in grads]
            gaps = [0.0] * len(grads)
        else:
            ref = [g.to("cuda", non_blocking=True) for g in base]
            diff = torch.stack(torch._foreach_norm(torch._foreach_sub(grads, ref), float("inf")))
            size = torch.stack(torch._foreach_norm(ref, float("inf"))).clamp_min(1e-30)
            gaps = (diff / size).tolist()
            del ref, diff
        top = np.argsort(gaps)[::-1][:3]
        lines[label] = {"ms_per_step": 1e3 * sum(times) / len(times), "ms_each": [1e3 * t for t in times],
                        "peak_mem_gib": peak, "loss": loss.item(),
                        "launches_per_step_by_shape": {k: v for k, v in shape_counts(shapes).items() if v},
                        "worst_grad_gap": gaps[top[0]], "median_grad_gap": float(np.median(gaps)),
                        "worst_grad_leaves": {names[i]: gaps[i] for i in top},
                        "leaves_differing": sum(g > 0 for g in gaps)}
        del grads
    model.configure_remat(remat=False)
    line = {"phase": "remat_sweep", "phase_id": "43",
            "config": "MapAnythingConfig(compute_dtype='bfloat16'), geometric inputs, 1x4x518x518 forward, loss and "
                      "backward (no update), seeded random weights, bench.py LossBatch, GeometricInputConfig() masks "
                      "(seed 0)",
            "runs": lines, "grad_gap_limit": REMAT_GRAD_GAP_LIMIT, "grad_median_limit": REMAT_GRAD_MEDIAN_LIMIT,
            "card": card["name"], "power_limit": card["power_limit"]}
    emit(line)
    plain_peak, full_peak = lines["no_remat"]["peak_mem_gib"], lines["remat_None=nothing"]["peak_mem_gib"]
    if not full_peak < plain_peak:
        raise AssertionError(f"phase 43: full remat peaks at {full_peak:.2f} GiB, not below {plain_peak:.2f} GiB")
    over = {k: (v["worst_grad_gap"], v["median_grad_gap"]) for k, v in lines.items()
            if not (v["worst_grad_gap"] <= REMAT_GRAD_GAP_LIMIT and v["median_grad_gap"] <= REMAT_GRAD_MEDIAN_LIMIT)}
    if over:
        raise AssertionError(f"phase 43: gradients (worst, median leaf) of {over} over the limits "
                             f"{REMAT_GRAD_GAP_LIMIT}, {REMAT_GRAD_MEDIAN_LIMIT}")
    del model, base
    return line


def stage2_remat_step(card) -> dict:
    """Phase 44: the stage-2 recipe's step, the flagship bf16 train step on 1 x 24 x 518 with
    every encoder and trunk block rematerialised (full recompute: the JAX ``--override
    model.remat=true``), phase 7's batch recipe, masks and lr: one warm step, then three
    timed. ms a step, views a second, peak GiB, launches by (Tk, D) (the forward's include
    the recompute's), finite losses and gradients."""
    import torch

    from mapanything_tpu_torch.models.mapanything import GeometricInputConfig, MapAnything
    from mapanything_tpu_torch.ops.flash_attention import launch_shapes, reset_launch_counts
    from mapanything_tpu_torch.train.losses import LossConfig, synthetic_loss_batch
    from mapanything_tpu_torch.train.optim import OptimConfig, build_optimizer
    from mapanything_tpu_torch.train.step import init_train_state, make_train_step

    B, V, H, W = 1, STAGE2_VIEWS, 518, 518
    warmup, iters = 1, 3
    t0 = time.perf_counter()
    cfg = dataclasses.replace(flagship_config(12), remat=True)
    model = MapAnything(cfg, device="cuda", seed=0, geometric_inputs=True)
    opt = build_optimizer(OptimConfig(lr=1e-7, min_lr=1e-8, epoch_len=100, total_epochs=1.0), model)
    state = init_train_state(model, opt)
    step = make_train_step(model, opt, LossConfig(), GeometricInputConfig())
    batch = synthetic_loss_batch(B, V, H, W, seed=0).to("cuda")
    img = torch.from_numpy(np.random.RandomState(0).randn(B, V, H, W, 3).astype(np.float32)).cuda()
    gen = torch.Generator().manual_seed(0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    want = remat_launches(STAGE2_GLOBAL[1][1], True)
    torch.cuda.reset_peak_memory_stats()
    times, metrics = [], []
    for i in range(warmup + iters):
        reset_launch_counts()
        t = time.perf_counter()
        state, m = step(state, img, batch, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        check_remat_launches(f"phase 44 step {i}", want)
        m = {k: v.item() for k, v in m.items()}
        grads_finite = all(bool(torch.isfinite(p.grad).all()) for p in state.params.values() if p.grad is not None)
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and grads_finite):
            raise AssertionError(f"phase 44 step {i}: loss {m['loss']}, grad_norm {m['grad_norm']}")
        metrics.append(m)
        if i >= warmup:
            times.append(dt)
    ms = 1e3 * sum(times) / iters
    line = {"phase": "stage2_remat_train", "phase_id": "44",
            "config": f"MapAnythingConfig(compute_dtype='bfloat16', remat=True), 1x{V}x518x518 train step, seeded "
                      "random weights, bench.py LossBatch, GeometricInputConfig() masks, lr 1e-7",
            "setup_s": setup_s, "warmup": warmup, "iters": iters, "ms_per_step": ms,
            "ms_each": [1e3 * t for t in times],
            "views_per_s": B * V / (ms / 1e3), "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches_per_step_by_shape": shape_counts(launch_shapes()),
            "launches_total": {k: sum(v.values()) * (warmup + iters) for k, v in want.items()},
            "steps": warmup + iters,
            "loss": [m["loss"] for m in metrics], "grad_norm": [m["grad_norm"] for m in metrics],
            "card": card["name"], "power_limit": card["power_limit"]}
    emit(line)
    del state, step, model, opt
    return line


def remat_phases(card) -> dict:
    """Phases 3i, 43 and 44: the training kernels at the 24-view step's shapes, the policy
    sweep at 1 x 4 x 518, the 24-view step under remat."""
    import torch

    rows = train_kernel_checks(card, STAGE2_SHAPES, STAGE2_REPLACES, "3i") + [stage2_global_check(card)]
    gc.collect()
    torch.cuda.empty_cache()
    sweep = remat_sweep(card)
    gc.collect()
    torch.cuda.empty_cache()
    step = stage2_remat_step(card)
    gc.collect()
    torch.cuda.empty_cache()
    return {"rows": rows, "sweep": sweep, "step": step}


def remat_entries(remat) -> list:
    """Phases 3i and 44 in the kernels line: each training kernel on the 24-view remat step,
    one entry per TPU kernel replaced (the lse forward: K4 at the encoder and frame layers,
    K7 at the global layers), that run's launches, and times per step at phase 3i's shapes
    (each shape's per-call time by its launches a step, the recompute's included)."""
    step, rows = remat["step"], remat["rows"]
    per_step = remat_launches(STAGE2_GLOBAL[1][1], True)
    t_of = {r["shape"]: r["b_t_h_d"][1] for r in rows}
    entries = []
    for name in TRAIN_KERNELS:
        outs = TRAIN_OUTPUTS[name]
        for replaces in dict.fromkeys(STAGE2_REPLACES[name].values()):
            group = [r for r in rows if STAGE2_REPLACES[name][r["shape"]] == replaces]
            n_of = {r["shape"]: per_step[name][(t_of[r["shape"]], 64)] for r in group}
            total = lambda key: sum(r["kernels"][name][key] * n_of[r["shape"]] for r in group)  # noqa: E731
            entries.append({
                "name": name, "route": "cuda",
                "source": KERNEL_SOURCE if name.endswith("lse") else BWD_KERNEL_SOURCE,
                "replaces": replaces,
                "launches": sum(n_of.values()) * step["steps"],
                "launches_per_step": sum(n_of.values()),
                "max_abs_err": max(r["max_abs_err"][o] for r in group for o in outs),
                "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
                "bound_by": "operations" if all(r["kernels"][name]["bound_by"] == "operations" for r in group)
                            else "bytes",
                "library_ms": total("library_ms"),
                "per_shape": [dict(shape=r["shape"], b_t_h_d=r["b_t_h_d"], dtype=r["dtype"], per_step=n_of[r["shape"]],
                                   max_abs_err={o: r["max_abs_err"][o] for o in outs}, **r["kernels"][name])
                              for r in group],
                "path": "flagship bf16 train step 1x24x518, remat=True (phase 44); times per step",
            })
    return entries


def main() -> int:
    parser = argparse.ArgumentParser(description="Smoke test of the PyTorch port on one NVIDIA GPU.")
    parser.add_argument("--train-step-only", action="store_true",
                        help="build the kernels, then run phase 7 (or 17) alone and stop after its line")
    parser.add_argument("--compute-dtype", choices=("bfloat16", "float32"), default="bfloat16",
                        help="with --train-step-only: the step's dtype, bfloat16 (phase 7) or float32 (phase 17)")
    parser.add_argument("--forward-edges-only", action="store_true",
                        help="build the kernels, then run phase 3f alone and stop after its line")
    parser.add_argument("--backward-edges-only", action="store_true",
                        help="build the kernels, then run phase 3g alone and stop after its line")
    parser.add_argument("--files-only", action="store_true",
                        help="build the kernels, then run phase 19 (files to a scene) alone and stop after its line")
    parser.add_argument("--trainer-only", action="store_true",
                        help="build the kernels, then run phase 20 (the Trainer) alone and stop after its line")
    parser.add_argument("--data-only", action="store_true",
                        help="build the kernels, then run phase 21 (from disk to a trained step) alone and stop "
                             "after its line")
    parser.add_argument("--dust3r-only", action="store_true",
                        help="build the kernels, then run the DUSt3R path alone (its rows of phase 3, phases 26 and "
                             "27) and stop after their lines and their kernels line")
    parser.add_argument("--baselines-only", action="store_true",
                        help="build the kernels, then run the feed-forward baselines alone (their rows of phase 3, "
                             "phases 28 and 29) and stop after their lines and their kernels line")
    parser.add_argument("--ba-only", action="store_true",
                        help="build the kernels, check their SASS, then run the bundle-adjustment slice alone (the "
                             "D = 48 forward's edge cases and canaries, its rows of phase 3, phases 31-33) and stop "
                             "after their lines and their kernels line")
    parser.add_argument("--benchmarks-only", action="store_true",
                        help="build the kernels, then run the benchmark slice alone (the kernel rows at its shapes, "
                             "phases 34-37) and stop after their lines and their kernels line")
    parser.add_argument("--processing-only", action="store_true",
                        help="build the kernels, then run the data-processing slice alone (phases 38-40: convert, "
                             "process, the live demo, with their kernel rows) and stop after their lines and their "
                             "kernels line")
    parser.add_argument("--masked-only", action="store_true",
                        help="build the kernels, check their SASS, then run phase 3h (the masked kernels), 41 (the "
                             "diagnose tool) and 42 (the disentangled flagship step, on its one-rank group) and stop "
                             "after their lines and their kernels line")
    parser.add_argument("--remat-only", action="store_true",
                        help="build the kernels, then run phases 3i (the training kernels at the 24-view step's "
                             "shapes), 43 (the remat policy sweep) and 44 (the 24-view remat step) alone and stop "
                             "after their lines and their kernels line")
    parser.add_argument("--rgb-only", action="store_true",
                        help="build the kernels, then run the RGB models' phases alone (the D = 32 rows of phases 3 "
                             "and 3b, phases 22-24, and 25 on its one-rank group) and stop after their lines")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "mapanything_tpu_torch").is_dir():
        print("chip_smoke: the mapanything_tpu_torch package is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    # 1. The card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = {"name": torch.cuda.get_device_name(0), "power_limit": smi.split(",")[-1].strip()}

    # 2. Build every kernel of the main path, one nvcc per source, side by side.
    from mapanything_tpu_torch.ops import _build
    from mapanything_tpu_torch.ops.flash_attention import KERNEL_STEMS

    t0 = time.perf_counter()
    libs = _build.build(*KERNEL_STEMS)
    build_s = time.perf_counter() - t0
    instances, warnings = {}, []
    for lib in libs:
        log = lib.with_suffix(".log").read_text() if lib.with_suffix(".log").exists() else ""
        report = ptxas_report(log)
        instances.update(report["instances"])
        warnings += report["warnings"]
    build = {"phase": "build", "kernels": list(KERNEL_STEMS), "seconds": build_s, "instances": instances,
             "ptxas_warnings": warnings}
    if args.train_step_only:  # the build and the step alone (also when this script times another checkout)
        emit(build)
        flagship_train(card, compute_dtype=args.compute_dtype)
        return 0
    if args.dust3r_only:
        emit(build)
        emit({"kernels": dust3r_entries(dust3r_phases(card))})
        return 0
    if args.baselines_only:
        emit(build)
        emit({"kernels": baseline_entries(baseline_phases(card))})
        return 0
    if args.benchmarks_only:
        emit(build)
        emit({"kernels": benchmark_entries(benchmark_phases(card))})
        return 0
    if args.processing_only:
        emit(build)
        emit({"kernels": processing_entries(processing_phases(card))})
        return 0
    if args.remat_only:
        emit(build)
        emit({"kernels": remat_entries(remat_phases(card))})
        return 0
    if args.rgb_only:
        emit(build)
        narrow_edge_checks(card)
        rgb_phases(card)
        one_rank_group(mesh_trainer_phase, card)
        return 0
    if args.files_only or args.trainer_only or args.data_only:
        emit(build)
        if args.files_only:
            files_to_scene(card)
        elif args.trainer_only:
            trainer_phase(card)
        else:
            data_path_phase(card)
        return 0
    fwd_smem = _build.load(KERNEL_STEMS[0]).flash_attention_fwd_smem
    bwd_smem = _build.load(KERNEL_STEMS[1]).flash_attention_bwd_smem
    fwd, bwd = fwd_instances(), bwd_instances()
    dynamic = {key: fwd_smem(FWD_SMEM_INDEX[dtype, regime], d) for (dtype, d, _, regime), key in fwd.items()}
    dynamic.update({key: bwd_smem(BWD_SMEM_INDEX[kernel, dtype], d) for (kernel, dtype, d), key in bwd.items()})
    masked_smem = _build.load(KERNEL_STEMS[2]).flash_attention_masked_smem
    for index, kernel in enumerate(("fwd", "bwd_dq", "bwd_dkv")):
        for fp32, dtype in ((0, "13__nv_bfloat16"), (1, "f")):
            for d in (32, 48, 64, 128):
                dynamic[f"fa_{kernel}_maskedI{dtype}Li{d}E"] = masked_smem(index, fp32, d)
    for key, nbytes in dynamic.items():
        for name, report in instances.items():
            if key in name:
                report["dynamic_smem"] = nbytes
    emit({**build, "fwd_sass": sass_check(libs[0], fwd), "bwd_sass": sass_check(libs[1], bwd),
          "masked_sass": masked_sass_check(libs[2])})
    if args.ba_only:
        narrow_edge_checks(card)
        emit({"kernels": ba_entries(ba_phases(card))})
        return 0
    if args.masked_only:
        masked = masked_kernel_checks(card)
        gc.collect()
        torch.cuda.empty_cache()
        diagnose_phase(card)
        gc.collect()
        torch.cuda.empty_cache()
        from mapanything_tpu_torch.parallel.mesh import make_view_group

        one_rank_group(lambda c: disentangled_flagship_phase(c, make_view_group()), card)
        emit({"kernels": masked_entries(masked)})
        return 0
    if not args.backward_edges_only:
        forward_edge_checks(card)
    if args.forward_edges_only:
        return 0
    backward_edge_checks(card)
    if args.backward_edges_only:
        return 0
    rows = kernel_checks(card, ATTENTION_SHAPES, "3")
    rgb = {"rows": kernel_checks(card, RGB_SHAPES, "3")}
    dust3r_rows = kernel_checks(card, DUST3R_SHAPES, "3")
    baseline_rows = kernel_checks(card, BASELINE_SHAPES, "3")
    tracker_rows = kernel_checks(card, TRACKER_SHAPES, "3")
    optim_rows = kernel_checks(card, OPTIM_SHAPES, "3")
    train_rows = train_kernel_checks(card)
    rgb["train_rows"] = train_kernel_checks(card, RGB_TRAIN_SHAPES, RGB_TRAIN_REPLACES)
    fp32_train_rows = train_kernel_checks(card, FP32_TRAIN_SHAPES)
    long_rows, ring_bwd_row = long_kernel_checks(card)
    many_view_rows = kernel_checks(card, MANY_VIEW_SHAPES, "3d")
    h128 = {"rows": kernel_checks(card, H128_SHAPES, "3e"),
            "train_rows": train_kernel_checks(card, H128_TRAIN_SHAPES, H128_TRAIN_REPLACES, "3e")}
    masked = masked_kernel_checks(card)  # 3h
    gc.collect()
    torch.cuda.empty_cache()
    slice_check()
    inference_launches, forward_ms, _, _ = flagship(card)
    torch.cuda.empty_cache()
    infer_slice_check()
    gc.collect()
    torch.cuda.empty_cache()
    flagship_infer(card, forward_ms)
    gc.collect()
    torch.cuda.empty_cache()
    many_view_line = many_view_infer(card)
    gc.collect()
    torch.cuda.empty_cache()
    train_slice_check()
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, train_steps, train_line = flagship_train(card)
    gc.collect()
    torch.cuda.empty_cache()

    # 14-16. flagship-h128 and the small model with 128-wide trunk heads.
    slice_check(trunk_heads=2)
    train_slice_check(trunk_heads=2)
    gc.collect()
    torch.cuda.empty_cache()
    _, _, h128["forward_launches"], _ = flagship(card, trunk_heads=H128_TRUNK_HEADS)
    gc.collect()
    torch.cuda.empty_cache()
    _, h128["train_steps"], h128_train = flagship_train(card, trunk_heads=H128_TRUNK_HEADS)
    h128["train_launches"] = h128_train["launches_total_by_head_dim"]
    gc.collect()
    torch.cuda.empty_cache()

    # 17-18. The default-dtype (fp32) flagship train step and forward.
    fp32_launches, fp32_steps, _ = flagship_train(card, compute_dtype="float32", kernel_rows=fp32_train_rows)
    gc.collect()
    torch.cuda.empty_cache()
    _, _, _, fp32_forward = flagship(card, compute_dtype="float32", kernel_rows=rows)
    gc.collect()
    torch.cuda.empty_cache()

    # 19-20. From files to a scene (the demo), from batches to checkpoints (the Trainer).
    files = files_to_scene(card)
    gc.collect()
    torch.cuda.empty_cache()
    trainer = trainer_phase(card)
    gc.collect()
    torch.cuda.empty_cache()

    # 21. From disk to a trained step: the data path into the Trainer through the train tool.
    data = data_path_phase(card)
    gc.collect()
    torch.cuda.empty_cache()

    # 22-24. The RGB models: the MAE and MoGe flagships' infer, the MAE train step, the losses.
    rgb.update(rgb_phases(card, kernel_rows=False))

    # 26-27. The DUSt3R path: the small models against the plain versions, the flagship forward.
    dust3r = dust3r_phases(card, dust3r_rows)

    # 28-29. The feed-forward baselines: the small models against the plain versions, each at
    # its release's widths.
    baseline = baseline_phases(card, baseline_rows)

    # 31-33. Bundle adjustment on the flagship (the COLMAP demos), the VGGSfM tracker, the
    # optimisation baselines.
    ba = ba_phases(card, {"files": files[0], "tracker": tracker_rows, "optim": optim_rows,
                          "d32_long": kernel_checks(card, D32_LONG_SHAPES, "3")})

    # 34-37. The accuracy benchmarks, the 100-view tool, inference on a WAI scene, the
    # one-sample finetune.
    bench = benchmark_phases(card, files[0])

    # 38-40. The WAI data-processing pipeline (convert, process stage by stage) and the live demo.
    proc = processing_phases(card, files[0])

    # 41. tools/diagnose_lr_nan.py: the flagship bf16 step at lr 1e-4 from random init, 10 steps.
    diagnose_phase(card)
    gc.collect()
    torch.cuda.empty_cache()

    # 3i, 43-44. Activation rematerialisation: the training kernels at the 24-view step's shapes,
    # the policy sweep at 1 x 4 x 518, the stage-2 recipe's 24-view step.
    remat = remat_phases(card)

    # 8-10. View parallelism on a process group of this process alone: NCCL at world size 1.
    from mapanything_tpu_torch.parallel.distributed import init_distributed_mode
    from mapanything_tpu_torch.parallel.mesh import make_view_group

    rendezvous = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        init_distributed_mode("cuda", f"file://{rendezvous / 'one_rank'}", 0, 1)
        try:
            group = make_view_group()
            view_parallel_slice_check(group)
            gc.collect()
            torch.cuda.empty_cache()
            vp_line = flagship_view_parallel(card, group)
            gc.collect()
            torch.cuda.empty_cache()
            flagship_view_parallel(card, group, trunk_heads=H128_TRUNK_HEADS)  # 30
            gc.collect()
            torch.cuda.empty_cache()
            _, _, vp_train = flagship_train(card, group, train_line["loss"])
            gc.collect()
            torch.cuda.empty_cache()
            mesh_trainer_phase(card)  # 25
            gc.collect()
            torch.cuda.empty_cache()
            disentangled_flagship_phase(card, group)  # 42
        finally:
            torch.distributed.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
        # More than one card: phases 9 and 10 again, one rank a card.
        if torch.cuda.device_count() > 1:
            multi_card(card, rendezvous, train_line["loss"])
    finally:
        shutil.rmtree(rendezvous, ignore_errors=True)
    vp_launches = {
        "k3_per_forward": vp_line["unsharded"]["launches_per_forward"]["flash_attention_fwd"] - 36,
        "k7_per_forward": vp_line["ring"]["ring_steps_per_forward"],
        "k7_per_step": vp_train["ring_per_step"]["ring_steps"],
    }
    summary_line(rows, train_rows, long_rows, many_view_rows, ring_bwd_row, inference_launches, train_launches,
                 train_steps, vp_launches, many_view_line, h128,
                 {"rows": fp32_train_rows, "launches": fp32_launches, "steps": fp32_steps}, fp32_forward, files,
                 trainer, data, rgb, dust3r, baseline, ba, bench, proc, masked, remat)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
