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

Phases, each printing one JSON line:
  1. the card's name and power limit, as nvidia-smi reports them;
  2. build: nvcc compiles every kernel source from csrc/ into build/, one
     process per source, side by side; the line gives each kernel
     instance's registers, spills and shared memory (-Xptxas -v, and the
     wgmma instances' dynamic shared memory), and cuobjdump -sass of each
     library must show HGMMA (wgmma) and UTMALDG (TMA loads) in every
     forward and backward instance, bf16 and fp32 (fa_fwd_bf16, fa_fwd_f32,
     fa_bwd_dq_bf16, fa_bwd_dkv_bf16, fa_bwd_dq_f32, fa_bwd_dkv_f32);
  3f. the forward's edges, bf16 and fp32: both forms (lse-free and lse) at
     D = 64 and 128 against their plain versions under phase 3's rule (fp32
     also under the fp32 rule, below), at
     T = 1, 7, 64, 65, 127, 129 and 1370 and at Tq != Tk (129 against
     4000, 5476 against 1), and at 320 and 384 work tiles (every block of
     the persistent grid walks several), on contiguous tensors and on
     views of fused qkv (and kv) tensors with a non-default scale, the lse
     on every row;
  3g. the backward's edges: dq and dk/dv, bf16 and fp32, at D = 64 and 128
     against their plain versions under phase 3's rule (fp32 also under the
     fp32 rule, below) at phase 3f's shapes and layouts (dO a view of a wider
     tensor in the fused layout), fed the statistics of the plain forward (of
     a merged softmax where there is one key, and in one more case, as the
     ring feeds them); each kernel called twice, the outputs bitwise equal;
  3. inference kernel checks: the lse-free attention forward against its
     plain PyTorch version at the inference shapes (encoder, frame and
     global layers in bf16, and in fp32: phase 18's), with kernel, plain and
     torch-SDPA times and the bound; the fp32 rows also under the fp32 rule,
     with the kernel timed alone on one split pass's parts, the split pass
     (held bitwise to its plain version) and the whole call timed apart;
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
     held bitwise to their plain version and timed;
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
     4 x 444), as in phase 3b.
On a machine with more than one card, phases 9 and 10 then run again over
NCCL with one rank a card (2 or 4 cards); rank 0 checks the gathered
outputs against the unsharded forward. A machine with one card skips this.
Phases 11-13 run after phase 5, before phase 6; phase 3e after 3d; phases
14-21 after phase 7, before phase 8. Then the kernels' summary line and,
last, {"ok": true, "device": {...}}.
Phases 3f and 3g run right after the build. With --train-step-only, phase 7
(phase 17 with --compute-dtype float32) runs after the build (without the SASS
check) and the script stops after its line, printing neither the summary nor
the ok line; copied into another checkout's tree, it times that checkout's step
the same way. With --forward-edges-only, phase
3f runs after the build and the script stops there, the same way; with
--backward-edges-only, phase 3g; with --files-only, phase 19; with
--trainer-only, phase 20; with --data-only, phase 21.
Any failed check raises and the script exits non-zero. Without a CUDA device,
or without the port beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
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


def emit(obj) -> None:
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


def shape_counts(shapes: dict) -> dict:
    """``launch_shapes()`` as JSON: {kernel: {"<Tk>x<D>": launches}}."""
    return {name: {f"{tk}x{d}": n for (tk, d), n in by.items()} for name, by in shapes.items()}


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


def plain_chunks(b: int, t: int, fp32: bool) -> list:
    """(batch, query-row) slices over which the plain versions run: batch chunks of
    PLAIN_BATCH; in fp32 also query rows, PLAIN_SLAB // t at a time (fp64 logits of
    12 heads at 10953 tokens would take 11.5 GB a copy)."""
    rows = min(t, PLAIN_SLAB // t) if fp32 else t
    return [(slice(i, i + PLAIN_BATCH), slice(r, r + rows)) for i in range(0, b, PLAIN_BATCH)
            for r in range(0, t, rows)]


def kernel_checks(card, shapes, phase_id: str):
    """Phases 3 and 3d: the kernel against its plain version under phase 3's rule (fp32
    also under the fp32 rule), with times and the bound; the plain versions over chunks
    (plain_chunks). The fp32 rows time the kernel alone on one split pass's parts
    (``ms``), the split pass (``split_ms``, held bitwise to its plain version) and the
    whole call (``call_ms``)."""
    import torch
    import torch.nn.functional as F

    from mapanything_tpu_torch.ops import flash_attention as fa

    rows = []
    for name, (b, t, h, d), dtype_name, per_forward, replaces in shapes:
        dtype = getattr(torch, dtype_name)
        fp32 = dtype == torch.float32
        gen = torch.Generator(device="cuda").manual_seed(1)
        # q, k, v as Attention makes them: strided views of one fused qkv tensor.
        qkv = torch.randn(b, t, 3, h, d, device="cuda", dtype=torch.float32, generator=gen).to(dtype)
        q, k, v = qkv.unbind(2)
        scale = d**-0.5
        out = fa.flash_attention(q, k, v, scale)
        torch.cuda.synchronize()
        chunks = plain_chunks(b, t, fp32)
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

        if fp32:  # the kernel alone on one split's parts; the split and the whole call apart
            parts = fa.flash_attention_split_f32(q, k, v)
            split_bitwise = all(torch.equal(got, fa.split_bf16x3_reference(x)) for got, x in zip(parts, (q, k, v)))
            ms = cuda_time_ms(lambda: fa._launch_fwd(q, k, v, scale, False, parts), iters=20)
            extra = {"split_ms": cuda_time_ms(lambda: fa.flash_attention_split_f32(q, k, v), iters=20),
                     "split_plain_ms": cuda_time_ms(lambda: [fa.split_bf16x3_reference(x) for x in (q, k, v)],
                                                    iters=5, warmup=1),
                     "split_bound_ms": split_bound_ms(card, 3 * b * t * h * d),
                     "split_bitwise": split_bitwise,
                     "call_ms": cuda_time_ms(lambda: fa.flash_attention(q, k, v, scale), iters=20),
                     "plain_fp32_err": plain_err, "fp32_tol": fp32_tol}
            del parts
        else:
            ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v, scale), iters=20)
            extra = {"plain_bf16_err": plain_err}
        plain_ms = cuda_time_ms(lambda: [fa.attention_reference(q[cb, cr], k[cb], v[cb], scale) for cb, cr in chunks],
                                iters=3, warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), iters=20)
        row = {
            "phase": "kernel_check",
            "phase_id": phase_id,
            "shape": name,
            "b_t_h_d": [b, t, h, d],
            "dtype": dtype_name,
            "replaces": replaces,
            "max_abs_err": err,
            "tol": tol,
            "ms": ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms,
            **forward_bounds(card, b, t, t, h, d, dtype_name, with_lse=False),
            "tflops": fa.attention_flops(b, t, t, h, d) / ms / 1e9,
            **extra,
            "per_forward": per_forward,
            "card": card["name"],
            "power_limit": card["power_limit"],
        }
        emit(row)
        if not finite or err > tol or (fp32 and (err > fp32_tol or not split_bitwise)):
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
FWD_INSTANCES = {(dtype, d, lse): f"fa_fwd_{dtype}ILi{d}ELb{int(lse)}E"
                 for dtype in ("bf16", "f32") for d in (64, 128) for lse in (False, True)}
FWD_SMEM_INDEX = {"bf16": 0, "f32": 1}
BWD_INSTANCES = {(kernel, dtype, d): f"fa_bwd_{kernel}_{dtype}ILi{d}E"
                 for kernel in ("dq", "dkv") for dtype in ("bf16", "f32") for d in (64, 128)}
BWD_SMEM_INDEX = {("dq", "bf16"): 0, ("dkv", "bf16"): 1, ("dq", "f32"): 2, ("dkv", "f32"): 3}
TENSOR_CORE_SASS = ("HGMMA", "UTMALDG")


def sass_check(lib: Path, instances: dict) -> dict:
    """Phase 2: cuobjdump -sass of one kernel library; every instance named in
    ``instances`` must contain HGMMA and UTMALDG. Returns their counts by instance."""
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
    missing = {key: c for key, c in counts.items() if not all(c.values())}
    if missing:
        raise AssertionError(f"instances without wgmma or TMA in their SASS: {missing}")
    return counts


# Phase 3f: (Tq, Tk, B, H) of each case: square lengths and Tq != Tk pairs at B = 2,
# H = 3; then more than 2 x 132 work tiles of 128 query rows, so that every block of
# the persistent grid walks several, with one key tile each and with six.
EDGE_CASES = ([(t, t, 2, 3) for t in (1, 7, 64, 65, 127, 129, 1370)] + [(129, 4000, 2, 3), (5476, 1, 2, 3)]
              + [(65, 65, 16, 20), (400, 1000, 4, 24)])
EDGE_SCALE = 0.3  # the fused-layout cases' scale; the contiguous cases take D ** -0.5


def forward_edge_checks(card) -> list:
    """Phase 3f: the forward, bf16 and fp32, lse-free and lse, at D = 64 and 128 against
    its plain version under phase 3's rule (fp32 also under the fp32 rule), at the edge
    shapes; o and the lse of every row."""
    import torch

    from mapanything_tpu_torch.ops import flash_attention as fa

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        dname, fp32 = str(dtype).split(".")[-1], dtype == torch.float32
        for d in fa.HEAD_DIMS:
            for tq, tk, b, h in EDGE_CASES:
                for layout in ("contiguous", "fused"):
                    gen = torch.Generator(device="cuda").manual_seed(tq * 7919 + tk + d)
                    if layout == "contiguous":
                        q, k, v = (torch.randn(b, t, h, d, device="cuda", generator=gen).to(dtype)
                                   for t in (tq, tk, tk))
                        scale = d**-0.5
                    elif tq == tk:  # views of one fused qkv tensor
                        q, k, v = torch.randn(b, tq, 3, h, d, device="cuda", generator=gen).to(dtype).unbind(2)
                        scale = EDGE_SCALE
                    else:  # q from a fused qkv tensor, k and v from a fused kv tensor
                        q = torch.randn(b, tq, 3, h, d, device="cuda", generator=gen).to(dtype)[:, :, 0]
                        k, v = torch.randn(b, tk, 2, h, d, device="cuda", generator=gen).to(dtype).unbind(2)
                        scale = EDGE_SCALE
                    o_free = fa.flash_attention(q, k, v, scale)
                    o_lse, lse = fa.flash_attention_lse(q, k, v, scale)
                    torch.cuda.synchronize()
                    exact_dtype = torch.float64 if fp32 else torch.float32
                    o_exact, lse_exact = fa.attention_lse_reference(*(x.to(exact_dtype) for x in (q, k, v)), scale)
                    o_plain, lse_plain = fa.attention_lse_reference(q, k, v, scale)
                    for form, out, exact, plain in (("o", o_free, o_exact, o_plain),
                                                    ("o_lse", o_lse, o_exact, o_plain),
                                                    ("lse", lse, lse_exact, lse_plain)):
                        plain_err = max_err(plain, exact)
                        row = {"dtype": dname, "d": d, "tq": tq, "tk": tk, "b": b, "h": h, "layout": layout,
                               "out": form, "err": max_err(out, exact), "tol": tolerance(plain_err, exact),
                               "finite": bool(torch.isfinite(out).all())}
                        if fp32:
                            row["fp32_tol"] = fp32_tolerance(plain_err, exact)
                        cases.append(row)
    bad = [c for c in cases if not (c["finite"] and c["err"] <= c["tol"] and c["err"] <= c.get("fp32_tol", c["tol"]))]
    worst = {dname: max((c for c in cases if c["dtype"] == dname),
                        key=lambda c: c["err"] / max(min(c["tol"], c.get("fp32_tol", c["tol"])), 1e-30))
             for dname in ("bfloat16", "float32")}
    emit({"phase": "forward_edge_check", "phase_id": "3f", "cases": len(cases), "worst": worst, "failed": bad,
          "card": card["name"], "power_limit": card["power_limit"]})
    if bad:
        raise AssertionError(f"the forward disagrees with its plain version at {len(bad)} edge cases: {bad[:4]}")
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
    """Phase 3g: the dq and dk/dv kernels, bf16 and fp32, at D = 64 and 128 against their
    plain versions under phase 3's rule (fp32 also under the fp32 rule), at phase 3f's edge
    shapes, on contiguous and fused layouts, and once fed a merged lse as the ring feeds
    them; each kernel called twice, its outputs bitwise equal. Cases with one key take
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
        for d in fa.HEAD_DIMS:
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
    bad = [c for c in cases if not (c["finite"] and c["repeatable"] and c["err"] <= c["tol"]
                                    and c["err"] <= c.get("fp32_tol", c["tol"]))]
    worst = {dname: max((c for c in cases if c["dtype"] == dname),
                        key=lambda c: c["err"] / max(min(c["tol"], c.get("fp32_tol", c["tol"])), 1e-30))
             for dname in ("bfloat16", "float32")}
    emit({"phase": "backward_edge_check", "phase_id": "3g", "cases": len(cases), "worst": worst, "failed": bad,
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
    q, k, v and dO, a layer's two together) bitwise against their plain version."""
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
        if fp32:  # the split passes against their plain version, bitwise
            parts, fwd_parts = fa.flash_attention_split_f32(q, k, v, do), fa.flash_attention_split_f32(q, k, v)
            split_bitwise = all(torch.equal(got, fa.split_bf16x3_reference(x))
                                for got, x in zip(parts + fwd_parts, (q, k, v, do, q, k, v)))

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
        if fp32:  # a layer's two split passes: the forward's (q, k, v) and the backward's (q, k, v, dO)
            split_ms = {"fwd_split_ms": cuda_time_ms(lambda: fa.flash_attention_split_f32(q, k, v), iters=20),
                        "bwd_split_ms": cuda_time_ms(lambda: fa.flash_attention_split_f32(q, k, v, do), iters=20)}
            times["flash_attention_split_f32"] = (
                split_ms["fwd_split_ms"] + split_ms["bwd_split_ms"],
                cuda_time_ms(lambda: [fa.split_bf16x3_reference(x) for x in (q, k, v, do, q, k, v)], iters=5,
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
            elif kname == "flash_attention_split_f32":  # q, k, v (and dO) read in fp32, three bf16 parts written
                n_elements = 7 * b * t * h * d
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
    rows = []
    for phase_id, name, t, kname, replaces, launches_key in LONG_SHAPES:
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
        plain_ms = cuda_time_ms(lambda: plain_by_rows(plain_fn, q, k, v, scale, rows=chunk), iters=2, warmup=1)
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
        rows.append(row)
        del qkv, q, k, v, o
        torch.cuda.empty_cache()

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
    if counts != {k: want[k] for k in counts}:
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
    if counts != {"flash_attention_fwd": 48, "flash_attention_fwd_lse": 0, "flash_attention_bwd_dq": 0,
                  "flash_attention_bwd_dkv": 0, "flash_attention_split_f32": 0}:
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
    from mapanything_tpu_torch.utils.image import _fake_K, load_images, read_png, write_png
    from mapanything_tpu_torch.utils.inference import PostprocessConfig

    rows = kernel_checks(card, FILES_SHAPES, "19")
    work = ROOT / "build" / "files_to_scene"
    shutil.rmtree(work, ignore_errors=True)
    (work / "images").mkdir(parents=True)
    rng = np.random.default_rng(19)
    h, w = FILES_HW
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    t0 = time.perf_counter()
    for i in range(FILES_VIEWS):  # smooth structure plus noise, a new phase a view
        base = 128 + 70 * np.sin(x / 37 + i)[..., None] * np.cos(y / 23 - i)[..., None]
        img = np.clip(base + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)
        write_png(work / "images" / f"view_{i:02d}.png", img, filters=(0, 1, 2, 3, 4))
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
    if counts != {k: want[k] for k in counts} or shapes["flash_attention_fwd"] != want_shapes:
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
    out = {names.get(f.name, f.name): getattr(b, f.name).numpy() for f in dataclasses.fields(b)}
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
        if counts != {k: want[k] for k in counts} or any(shapes[k] != v for k, v in want_shapes.items()):
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
    JPEG fixtures, EXR depth); covisibility, scene_meta.json and the scene list. Returns
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
    (root / "meta" / "train").mkdir(parents=True)
    np.save(root / "meta" / "train" / "eth3d_scene_list_train.npy", np.array(["scene_png", "scene_jpg"]))
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
        if counts != {k: want[k] for k in counts}:
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
        if counts != {k: want[k] for k in counts} or any(ring[k] != v for k, v in want_ring.items()):
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
            totals[k] += counts[k]
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


def flagship_view_parallel(card, group):
    """Phase 9: the flagship bf16 forward on 1 x 16 x 518 unsharded, under the
    ring and under allgather, over ``group`` (one rank on one card, or one
    rank a card). Every rank runs the view-parallel forwards; the first also
    runs the unsharded one and compares the gathered outputs."""
    import torch

    from mapanything_tpu_torch.models.mapanything import MapAnything, MapAnythingConfig, Views
    from mapanything_tpu_torch.ops.flash_attention import launch_counts, reset_launch_counts
    from mapanything_tpu_torch.parallel import sharded_attention as sa
    from mapanything_tpu_torch.parallel.context import gather_predictions, infer_view_sharded

    B, V, H, W = 1, 16, 518, 518
    warmup, iters = 2, 3
    n, lead = group.size, group.rank == 0
    model = MapAnything(MapAnythingConfig(compute_dtype="bfloat16"), device="cuda", seed=0)
    img = torch.from_numpy(np.random.RandomState(0).randn(B, V, H, W, 3).astype(np.float32)).cuda()
    views = Views(img=img)
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
            counts, ring = launch_counts(), sa.counts()
            expect = {**want[mode], "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                      "flash_attention_split_f32": 0}
            if counts != expect or ring["ring_steps"] != (12 * n if mode == "ring" else 0):
                raise AssertionError(f"one {mode} forward launched {counts} with {ring}, not {expect}")
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
        lines[mode] = {"launches_per_forward": counts, "ring_steps_per_forward": ring["ring_steps"],
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
    line = {"phase": "flagship_view_parallel",
            "config": "MapAnythingConfig(compute_dtype='bfloat16'), "
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

    shape = lambda r: {k: r[k] for k in ("shape", "b_t_h_d", "dtype", "replaces", "max_abs_err", "ms",  # noqa: E731
                                         "plain_ms", "bound_ms", "library_ms", "exp_bound_ms", "ffma_bound_ms",
                                         "split_ms", "call_ms") if k in r}
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
                 train_steps, vp_launches, many_view_line, h128, fp32_train, fp32_forward, files, trainer, data):
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
    takes at its lengths, with that epoch's launches; times per micro-batch."""
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
    emit({"kernels": kernels})


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
    dynamic = {key: fwd_smem(FWD_SMEM_INDEX[dtype], d) for (dtype, d, _), key in FWD_INSTANCES.items()}
    dynamic.update({key: bwd_smem(BWD_SMEM_INDEX[kernel, dtype], d)
                    for (kernel, dtype, d), key in BWD_INSTANCES.items()})
    for key, nbytes in dynamic.items():
        for name, report in instances.items():
            if key in name:
                report["dynamic_smem"] = nbytes
    emit({**build, "fwd_sass": sass_check(libs[0], FWD_INSTANCES),
          "bwd_sass": sass_check(libs[1], BWD_INSTANCES)})
    if not args.backward_edges_only:
        forward_edge_checks(card)
    if args.forward_edges_only:
        return 0
    backward_edge_checks(card)
    if args.backward_edges_only:
        return 0
    rows = kernel_checks(card, ATTENTION_SHAPES, "3")
    train_rows = train_kernel_checks(card)
    fp32_train_rows = train_kernel_checks(card, FP32_TRAIN_SHAPES)
    long_rows, ring_bwd_row = long_kernel_checks(card)
    many_view_rows = kernel_checks(card, MANY_VIEW_SHAPES, "3d")
    h128 = {"rows": kernel_checks(card, H128_SHAPES, "3e"),
            "train_rows": train_kernel_checks(card, H128_TRAIN_SHAPES, H128_TRAIN_REPLACES, "3e")}
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
            _, _, vp_train = flagship_train(card, group, train_line["loss"])
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
                 trainer, data)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
