"""Many-view memory-efficient inference benchmark: views/s and seconds a scene.

    python3 -m mapanything_tpu_torch.tools.benchmark_many_views [--views 100] [--res 518]
        [--head-chunk 10] [--iters 2] [--small] [--device cuda]

The port of ``scripts/benchmark_many_views.py``: the flagship bf16 MapAnything
(seeded random weights) images-only on 1 x V views of res x res (numpy seed 0),
with the dense head over chunks of views (``head_chunk_size``: the largest
divisor of B·V that is ``--head-chunk`` or less), under
``torch.inference_mode()``. One warm-up forward, then ``--iters`` forwards, each
on the images shifted by (i + 1)·1e-3 as the JAX script does; every forward's
points must be finite. Prints one JSON line: the views a second, the seconds a
scene (host clock around the timed forwards, read after a synchronise) and the
peak device memory of the timed forwards. Runs on the card unless ``--device``
names another.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from mapanything_tpu_torch.models.mapanything import MapAnything, MapAnythingConfig, Views, resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--views", type=int, default=100)
    ap.add_argument("--res", type=int, default=518)
    ap.add_argument("--head-chunk", type=int, default=10)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--small", action="store_true", help="the small config (MapAnythingConfig.small())")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace) -> dict:
    """The benchmark; returns its JSON line's numbers, the model, the last forward's
    images and predictions."""
    device = resolve_device(args.device)
    B, V, H, W = 1, args.views, args.res, args.res
    chunk = max(d for d in range(1, args.head_chunk + 1) if (B * V) % d == 0)
    make = MapAnythingConfig.small if args.small else MapAnythingConfig
    model = MapAnything(make(compute_dtype="bfloat16", head_chunk_size=chunk), device=device, seed=0)
    img = torch.from_numpy(np.random.RandomState(0).randn(B, V, H, W, 3).astype(np.float32)).to(device)

    def forward(images):
        with torch.inference_mode():
            preds = model(Views(img=images))
            finite = bool(torch.isfinite(preds.pts3d).all()) and bool(torch.isfinite(preds.pts3d.float().sum()))
        if not finite:
            raise AssertionError("non-finite points")
        return preds

    forward(img)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for i in range(args.iters):
        images = img + np.float32((i + 1) * 1e-3)
        preds = forward(images)
    _sync(device)
    dt = (time.perf_counter() - t0) / args.iters
    line = {
        "metric": f"{V}-view {args.res}px memory-efficient inference",
        "value": V / dt,
        "unit": "views/s/card",
        "seconds_per_scene": dt,
        "head_chunk_size": chunk,
        "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None,
    }
    print(json.dumps(line), flush=True)
    return dict(line=line, model=model, images=images, preds=preds)


def main(argv=None) -> dict:
    return run(parse_args(argv))["line"]


if __name__ == "__main__":
    main()
