#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mapanything_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. the card's name and power limit, as nvidia-smi reports them;
  2. build: nvcc compiles every kernel of the main path from csrc/ into build/;
  3. kernel checks: the attention kernel against its plain PyTorch version at
     the main path's shapes (encoder, frame and global layers in bf16) and at
     one fp32 shape, with kernel, plain and torch-SDPA times and the bound;
  4. slice check: MapAnythingConfig.small(), 2 views at 56 px in fp32, the same
     seeded weights on cuda and on cpu, every prediction compared;
  5. the main path: the flagship MapAnythingConfig(compute_dtype="bfloat16")
     on 1 x 8 views at 518 px with seeded random weights, launch counts,
     output checks, views/s, ms per forward and peak memory.
Then the kernels' summary line and, last, {"ok": true, "device": {...}}.
Any failed check raises and the script exits non-zero. Without a CUDA device,
or without the port beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "mapanything_tpu_torch/csrc/flash_attention_fwd.cu"

# Dense peak rates and memory bandwidth from NVIDIA's data sheets (no sparsity):
# (bf16 tensor-core flop/s, fp32 non-tensor flop/s, bytes/s).
PEAKS = {
    "H100 PCIe": (756e12, 51e12, 2.0e12),
    "H100": (989e12, 67e12, 3.35e12),  # SXM
}

# (name, shape B x T x H x D, dtype, launches per flagship forward, TPU kernel replaced)
ATTENTION_SHAPES = [
    ("encoder", (8, 1370, 16, 64), "bfloat16", 24, "mapanything_tpu/ops/flash_attention.py:395"),
    ("frame", (8, 1369, 12, 64), "bfloat16", 12, "mapanything_tpu/ops/flash_attention.py:395"),
    ("global", (1, 10953, 12, 64), "bfloat16", 12, "mapanything_tpu/ops/flash_attention.py:516"),
    ("fp32_frame", (8, 1369, 12, 64), "float32", 0, "mapanything_tpu/ops/flash_attention.py:164"),
]


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


def kernel_checks(card):
    """Phase 3: the kernel against its plain version, with times and the bound."""
    import torch
    import torch.nn.functional as F

    from mapanything_tpu_torch.ops.flash_attention import (
        attention_bytes,
        attention_flops,
        attention_reference,
        flash_attention,
    )

    bf16_peak, f32_peak, mem_bw = peaks_for(card["name"])
    rows = []
    for name, (b, t, h, d), dtype_name, per_forward, replaces in ATTENTION_SHAPES:
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator(device="cuda").manual_seed(1)
        # q, k, v as Attention makes them: strided views of one fused qkv tensor.
        qkv = torch.randn(b, t, 3, h, d, device="cuda", dtype=torch.float32, generator=gen).to(dtype)
        q, k, v = qkv.unbind(2)
        scale = d**-0.5
        out = flash_attention(q, k, v, scale)
        torch.cuda.synchronize()
        if dtype == torch.bfloat16:
            exact = attention_reference(q.float(), k.float(), v.float(), scale)
        else:
            exact = attention_reference(q.double(), k.double(), v.double(), scale).float()
        plain = attention_reference(q, k, v, scale)
        err = (out.float() - exact).abs().max().item()
        plain_err = (plain.float() - exact).abs().max().item()
        tol = max(2.0 * plain_err, 1e-2 * exact.abs().max().item())
        finite = bool(torch.isfinite(out).all())
        del exact, plain
        torch.cuda.empty_cache()

        ms = cuda_time_ms(lambda: flash_attention(q, k, v, scale), iters=20)
        plain_ms = cuda_time_ms(lambda: attention_reference(q, k, v, scale), iters=3, warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), iters=20)
        flops = attention_flops(b, t, t, h, d)
        nbytes = attention_bytes(b, t, t, h, d, q.element_size())
        t_ops = flops / (bf16_peak if dtype == torch.bfloat16 else f32_peak) * 1e3
        t_bytes = nbytes / mem_bw * 1e3
        row = {
            "phase": "kernel_check",
            "shape": name,
            "b_t_h_d": [b, t, h, d],
            "dtype": dtype_name,
            "replaces": replaces,
            "max_abs_err": err,
            "plain_bf16_err" if dtype == torch.bfloat16 else "plain_fp32_err": plain_err,
            "tol": tol,
            "ms": ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "tflops": flops / ms / 1e9,
            "per_forward": per_forward,
            "card": card["name"],
            "power_limit": card["power_limit"],
        }
        emit(row)
        if not finite or err > tol:
            raise AssertionError(f"kernel disagrees with its plain version at {name}: {err} > {tol}")
        rows.append(row)
        del qkv, q, k, v, out
        torch.cuda.empty_cache()
    return rows


def slice_check():
    """Phase 4: the small model in fp32, the same seeded weights on cuda and cpu."""
    import torch

    from mapanything_tpu_torch.models.mapanything import MapAnything, MapAnythingConfig, Views

    cfg = MapAnythingConfig.small()
    img = torch.from_numpy(np.random.RandomState(0).randn(1, 2, 56, 56, 3).astype(np.float32))
    # Full fp32 on the card for this comparison (cuDNN convolutions default to
    # TF32); the flagship phase then runs with PyTorch's defaults again.
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        on_gpu = MapAnything(cfg, device="cuda", seed=0)(Views(img=img.cuda()))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    on_cpu = MapAnything(cfg, device="cpu", seed=0)(Views(img=img))
    # fp32 on both; sums are taken in other orders on the card, so the
    # tolerance is relative to each field's magnitude.
    rtol = 1e-3
    errs = {}
    for field in (
        "pts3d", "pts3d_cam", "ray_directions", "depth_along_ray", "cam_trans",
        "cam_quats", "metric_scaling_factor", "conf", "non_ambiguous_mask_logits",
    ):
        a, b = getattr(on_gpu, field).cpu(), getattr(on_cpu, field)
        err = (a - b).abs().max().item()
        errs[field] = err
        if not err <= rtol * max(1.0, b.abs().max().item()):
            raise AssertionError(f"cuda and cpu disagree on {field}: {err}")
    agree = (on_gpu.non_ambiguous_mask.cpu() == on_cpu.non_ambiguous_mask).float().mean().item()
    if agree < 0.999:
        raise AssertionError(f"non_ambiguous_mask agrees on only {agree:.4f} of pixels")
    emit({"phase": "slice_check", "config": "small fp32 1x2x56x56", "rtol": rtol,
          "max_abs_err": errs, "mask_agreement": agree})


def flagship(card):
    """Phase 5: the main path, the flagship bf16 forward on 1 x 8 x 518 x 518."""
    import torch

    from mapanything_tpu_torch.models.mapanything import MapAnything, MapAnythingConfig, Views
    from mapanything_tpu_torch.ops.flash_attention import flash_attention

    B, V, H, W = 1, 8, 518, 518
    warmup, iters = 3, 5
    t0 = time.perf_counter()
    model = MapAnything(MapAnythingConfig(compute_dtype="bfloat16"), device="cuda", seed=0)
    setup_s = time.perf_counter() - t0
    img = torch.from_numpy(np.random.RandomState(0).randn(B, V, H, W, 3).astype(np.float32)).cuda()
    views = Views(img=img)

    flash_attention.launches = 0
    preds = model(views)
    torch.cuda.synchronize()
    launches = flash_attention.launches
    if launches != 48:
        raise AssertionError(f"one flagship forward launched the attention kernel {launches} times, not 48")
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

    fields = {f: getattr(preds, f) for f in (
        "pts3d", "pts3d_cam", "ray_directions", "depth_along_ray", "cam_trans",
        "cam_quats", "metric_scaling_factor", "conf", "non_ambiguous_mask_logits")}
    for f, x in fields.items():
        if not bool(torch.isfinite(x).all()):
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
    ms = 1e3 * sum(times) / iters
    emit({
        "phase": "flagship",
        "config": "MapAnythingConfig(compute_dtype='bfloat16'), 1x8x518x518, seeded random weights",
        "setup_s": setup_s,
        "warmup": warmup,
        "iters": iters,
        "ms_per_forward": ms,
        "ms_each": [1e3 * t for t in times],
        "views_per_s": B * V / (ms / 1e3),
        "peak_mem_gib": peak_gib,
        "attention_launches_per_forward": launches,
        "ray_norm_err": ray_norm_err,
        "card": card["name"],
        "power_limit": card["power_limit"],
    })
    return launches


def main() -> int:
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

    # 2. Build every kernel of the main path.
    from mapanything_tpu_torch.ops import _build
    from mapanything_tpu_torch.ops.flash_attention import KERNEL_STEM

    t0 = time.perf_counter()
    lib = _build.build(KERNEL_STEM)
    build_s = time.perf_counter() - t0
    log = lib.with_suffix(".log").read_text() if lib.with_suffix(".log").exists() else ""
    emit({"phase": "build", "kernel": KERNEL_STEM, "seconds": build_s,
          "ptxas": [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]})

    rows = kernel_checks(card)
    slice_check()
    launches = flagship(card)

    main_rows = [r for r in rows if r["per_forward"]]
    per_forward = lambda key: sum(r[key] * r["per_forward"] for r in main_rows)  # noqa: E731
    emit({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": "mapanything_tpu/ops/flash_attention.py:395",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in main_rows),
        "ms": per_forward("ms"),
        "plain_ms": per_forward("plain_ms"),
        "bound_ms": per_forward("bound_ms"),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in main_rows) else "bytes",
        "library_ms": per_forward("library_ms"),
        "per_shape": [{k: r[k] for k in ("shape", "dtype", "replaces", "per_forward", "max_abs_err",
                                         "ms", "plain_ms", "bound_ms", "library_ms")} for r in rows],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
