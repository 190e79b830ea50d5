"""Where the time of the flagship forward, or train step, goes on the card, by kernel family.

    python3 -m mapanything_tpu_torch.tools.profile_forward [--train [--views V] [--remat POLICY]] [--ring] [--out DIR]
    python3 -m mapanything_tpu_torch.tools.profile_forward --dust3r {float32,bfloat16} [--out DIR]

Builds MapAnythingConfig(compute_dtype="bfloat16") with seeded random
weights. Without ``--train``: the images-only forward on 1 x 8 views at
518 px, under ``torch.inference_mode()``. With ``--train``: the train step
(forward, backward and optimizer) on 1 x 4 views at 518 px, with the
bench.py LossBatch and GeometricInputConfig() masks, as ``chip_smoke.py``
phase 7 runs it; ``--views`` sets the views (24: phase 44's stage-2 step),
``--remat POLICY`` rematerialises the encoder's and trunk's blocks under a
``models/blocks.py`` policy ("nothing": full recompute). With ``--ring``: the
same, view-parallel under the ring schedule on a process group of this
process alone (NCCL at world size 1), as ``chip_smoke.py`` phases 9 and 10 run
it. With ``--dust3r DTYPE``: the ModularDUSt3R forward at its published widths
on one 512 x 384 pair in DTYPE, under ``torch.inference_mode()``, as
``chip_smoke.py`` phase 27 runs it.
Warms up three iterations, printing a line for each as it ends (its ms and the
peak GiB allocated so far: a step that runs out of memory later leaves the
readings before it), then traces three iterations with torch.profiler
(CPU and CUDA activities). The Chrome trace is parsed directly: every
"kernel" event is summed by name and by family (the port's attention
kernels, GEMMs, convolutions, casts and copies, normalisation, resizes,
other elementwise, the optimizer's multi-tensor kernels). Prints one JSON
summary line: device busy time per iteration, the host wall time per
iteration traced and, timed just before the trace in the same process,
untraced, the device's idle share over the traced window, an estimate of
the idle share without the profiler (one minus busy time over untraced
wall time), the peak GiB allocated, and the families in order. The per-kernel
table goes to ``<out>/profile_forward.json`` (``profile_train.json`` with
``--train``; ``_ring`` added with ``--ring``;
``profile_dust3r_<DTYPE>.json`` with ``--dust3r``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

PX, ITERS = 518, 3  # image size; iterations traced

# Ordered: the first family whose pattern occurs in a kernel's name takes it.
# cuDNN runs convolutions as implicit GEMMs, so "fprop"/"dgrad" come before "gemm";
# "gpu_kernel_impl_nocast" names plain arithmetic, so casts match on "copy" only.
FAMILIES = (
    ("attention (port kernels)", ("fa_fwd", "fa_bwd")),
    ("optimizer (multi-tensor)", ("multi_tensor_apply",)),
    ("convolution", ("fprop", "dgrad", "cudnn", "nhwcAddPadding", "conv2d")),
    ("gemm", ("gemm", "nvjet", "cutlass", "cublas")),
    ("layer_norm", ("layer_norm",)),
    ("resize", ("upsample",)),
    ("cast/copy", ("copy", "CatArray")),
    ("gelu", ("Gelu",)),
    ("relu/clamp", ("clamp",)),
    ("add/mul", ("CUDAFunctor_add", "MulFunctor", "BinaryFunctor")),
    ("reduce", ("reduce",)),
    ("sort", ("sort", "Sort", "radix")),
)


def family(name: str) -> str:
    for fam, patterns in FAMILIES:
        if any(p in name for p in patterns):
            return fam
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def forward_runner(group=None):
    """The images-only forward on 1 x 8 x 518, under inference mode; with a
    view group, view-parallel under the ring."""
    from mapanything_tpu_torch.models.mapanything import MapAnything, MapAnythingConfig, Views
    from mapanything_tpu_torch.parallel.context import infer_view_sharded

    model = MapAnything(MapAnythingConfig(compute_dtype="bfloat16"), device="cuda", seed=0)
    img = np.random.RandomState(0).randn(1, 8, PX, PX, 3).astype(np.float32)
    views = Views(img=torch.from_numpy(img).cuda())

    def run():
        if group is not None:
            infer_view_sharded(model, views, group, "ring")
            return
        with torch.inference_mode():
            model(views)

    return run, "MapAnythingConfig(compute_dtype='bfloat16'), 1x8x518x518 forward" + (", ring" if group else "")


def train_runner(group=None, views: int = 4, remat=None):
    """The train step on 1 x ``views`` x 518, as chip_smoke.py phase 7 runs it at 4 views
    (phase 44 at 24 under remat); with a view group, as phase 10 does (the ring); with
    ``remat`` a policy name, the encoder's and trunk's blocks rematerialised under it."""
    from mapanything_tpu_torch.models.mapanything import GeometricInputConfig, MapAnything, MapAnythingConfig
    from mapanything_tpu_torch.train.losses import LossConfig, synthetic_loss_batch
    from mapanything_tpu_torch.train.optim import OptimConfig, build_optimizer
    from mapanything_tpu_torch.train.step import init_train_state, make_train_step

    B, V = 1, views
    cfg = MapAnythingConfig(compute_dtype="bfloat16", remat=remat is not None, remat_policy=remat)
    model = MapAnything(cfg, device="cuda", seed=0, geometric_inputs=True)
    opt = build_optimizer(OptimConfig(lr=1e-7, min_lr=1e-8, epoch_len=100, total_epochs=1.0), model)
    step = make_train_step(model, opt, LossConfig(), GeometricInputConfig(), view_group=group)
    batch = synthetic_loss_batch(B, V, PX, PX, seed=0).to("cuda")  # bench.py:128-153
    img = torch.from_numpy(np.random.RandomState(0).randn(B, V, PX, PX, 3).astype(np.float32)).cuda()
    gen = torch.Generator().manual_seed(0)
    box = [init_train_state(model, opt)]

    def run():
        box[0], _ = step(box[0], img, batch, gen)

    rematted = "" if remat is None else f", remat=True, remat_policy={remat!r}"
    return run, (f"MapAnythingConfig(compute_dtype='bfloat16'{rematted}), 1x{V}x518x518 train step (forward, "
                 "backward, AdamW)" + (", ring" if group else ""))


def dust3r_runner(compute_dtype: str):
    """The ModularDUSt3R forward on one 512 x 384 pair, under inference mode (phase 27)."""
    from mapanything_tpu_torch.models.modular_dust3r import ModularDUSt3R, ModularDUSt3RConfig

    model = ModularDUSt3R(ModularDUSt3RConfig(compute_dtype=compute_dtype), device="cuda", seed=0)
    img = torch.from_numpy(np.random.RandomState(0).randn(1, 2, 384, 512, 3).astype(np.float32)).cuda()

    def run():
        with torch.inference_mode():
            model(img)

    return run, f"ModularDUSt3RConfig(compute_dtype={compute_dtype!r}), 1x2x384x512 forward"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--train", action="store_true", help="profile the train step instead of the forward")
    ap.add_argument("--views", type=int, default=4, help="with --train: the views of the step")
    ap.add_argument("--remat", metavar="POLICY",
                    help="with --train: rematerialise the encoder's and trunk's blocks under POLICY (nothing: all)")
    ap.add_argument("--ring", action="store_true", help="view-parallel under the ring, on a group of one rank")
    ap.add_argument("--dust3r", choices=("float32", "bfloat16"),
                    help="profile the ModularDUSt3R forward in this dtype instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: no CUDA device")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    group = None
    if args.ring:
        from mapanything_tpu_torch.parallel.distributed import init_distributed_mode
        from mapanything_tpu_torch.parallel.mesh import make_view_group

        init_distributed_mode("cuda", f"file://{tempfile.mkdtemp()}/rendezvous", 0, 1)
        group = make_view_group()
    if args.dust3r:
        run, config = dust3r_runner(args.dust3r)
    else:
        run, config = train_runner(group, args.views, args.remat) if args.train else forward_runner(group)
    for i in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        print(json.dumps({"warm_iteration": i, "ms": 1e3 * (time.perf_counter() - t0),
                          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        run()
    torch.cuda.synchronize()
    untraced_s = time.perf_counter() - t0

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    trace = out_dir / "profile_forward_trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        raise SystemExit("profile_forward: the trace holds no kernel events")

    by_name = defaultdict(lambda: [0.0, 0])
    by_family = defaultdict(float)
    for e in kernels:
        by_name[e["name"]][0] += e["dur"]
        by_name[e["name"]][1] += 1
        by_family[family(e["name"])] += e["dur"]
    n = ITERS
    span_us = max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)
    busy = busy_us([(e["ts"], e["ts"] + e["dur"]) for e in kernels])
    table = sorted(
        ({"name": k, "family": family(k), "ms_per_iteration": v[0] / n / 1e3, "calls_per_iteration": v[1] / n}
         for k, v in by_name.items()),
        key=lambda r: -r["ms_per_iteration"],
    )
    name = ("profile_train" if args.train else "profile_forward") + ("_ring" if args.ring else "")
    if args.dust3r:
        name = f"profile_dust3r_{args.dust3r}"
    (out_dir / f"{name}.json").write_text(json.dumps({"card": smi, "config": config, "kernels": table}, indent=1))
    trace.unlink()  # large; the per-kernel table above keeps what it says
    print(json.dumps({
        "tool": name,
        "config": config,
        "card": smi,
        "iterations": n,
        "wall_ms_per_iteration": 1e3 * wall_s / n,
        "untraced_wall_ms_per_iteration": 1e3 * untraced_s / n,
        "device_busy_ms_per_iteration": busy / n / 1e3,
        "idle_share_of_kernel_span": 1.0 - busy / span_us,
        "idle_share_untraced_estimate": 1.0 - busy / 1e6 / untraced_s,
        "kernel_launches_per_iteration": len(kernels) / n,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "families_ms_per_iteration": dict(sorted(
            ((k, v / n / 1e3) for k, v in by_family.items()), key=lambda kv: -kv[1])),
        "top_kernels": table[:12],
    }), flush=True)
    if group is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
