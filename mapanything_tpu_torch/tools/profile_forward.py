"""Where the time of the flagship forward goes on the card, by kernel family.

    python3 -m mapanything_tpu_torch.tools.profile_forward [--out DIR]

Builds MapAnythingConfig(compute_dtype="bfloat16") with seeded random
weights on 1 x 8 views at 518 px, warms up, then traces three forwards with torch.profiler (CPU and
CUDA activities). The Chrome trace is parsed directly: every "kernel" event
is summed by name and by family (the port's attention kernel, GEMMs,
convolutions, casts and copies, normalisation, resizes, other elementwise).
Prints one JSON summary line: device busy time per forward, the host wall
time per forward, the device's idle share over the traced window, and the
families in order. The per-kernel table goes to ``<out>/profile_forward.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from mapanything_tpu_torch.models.mapanything import MapAnything, MapAnythingConfig, Views

VIEWS, PX, ITERS = 8, 518, 3  # the main path's shape; forwards traced

# Ordered: the first family whose pattern occurs in a kernel's name takes it.
# cuDNN runs convolutions as implicit GEMMs, so "fprop"/"dgrad" come before "gemm";
# "gpu_kernel_impl_nocast" names plain arithmetic, so casts match on "copy" only.
FAMILIES = (
    ("attention (fa_fwd_bf16)", ("fa_fwd",)),
    ("convolution", ("fprop", "dgrad", "cudnn", "nhwcAddPadding", "conv2d")),
    ("gemm", ("gemm", "nvjet", "cutlass", "cublas")),
    ("layer_norm", ("layer_norm",)),
    ("resize", ("upsample",)),
    ("cast/copy", ("copy", "CatArray")),
    ("gelu", ("Gelu",)),
    ("relu/clamp", ("clamp",)),
    ("add/mul", ("CUDAFunctor_add", "MulFunctor", "BinaryFunctor")),
    ("reduce", ("reduce",)),
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: no CUDA device")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    model = MapAnything(MapAnythingConfig(compute_dtype="bfloat16"), device="cuda", seed=0)
    img = np.random.RandomState(0).randn(1, VIEWS, PX, PX, 3).astype(np.float32)
    views = Views(img=torch.from_numpy(img).cuda())
    for _ in range(3):
        model(views)
    torch.cuda.synchronize()

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            model(views)
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
        ({"name": k, "family": family(k), "ms_per_forward": v[0] / n / 1e3, "calls_per_forward": v[1] / n}
         for k, v in by_name.items()),
        key=lambda r: -r["ms_per_forward"],
    )
    (out_dir / "profile_forward.json").write_text(json.dumps({"card": smi, "kernels": table}, indent=1))
    trace.unlink()  # large; the per-kernel table above keeps what it says
    print(json.dumps({
        "tool": "profile_forward",
        "config": f"MapAnythingConfig(compute_dtype='bfloat16'), 1x{VIEWS}x{PX}x{PX}",
        "card": smi,
        "forwards": n,
        "wall_ms_per_forward": 1e3 * wall_s / n,
        "device_busy_ms_per_forward": busy / n / 1e3,
        "idle_share_of_kernel_span": 1.0 - busy / span_us,
        "kernel_launches_per_forward": len(kernels) / n,
        "families_ms_per_forward": dict(sorted(
            ((k, v / n / 1e3) for k, v in by_family.items()), key=lambda kv: -kv[1])),
        "top_kernels": table[:12],
    }), flush=True)


if __name__ == "__main__":
    main()
