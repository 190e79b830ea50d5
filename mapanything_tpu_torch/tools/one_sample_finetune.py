"""One-sample finetuning: overfit a single synthetic multi-view sample.

    python3 -m mapanything_tpu_torch.tools.one_sample_finetune [--steps 200] [--lr 3e-4] [--small]
        [--views 2] [--resolution 56] [--device cuda]

The port of ``scripts/one_sample_finetune.py`` (a convergence smoke test and a
single-scene adaptation harness): one plane-like sample from ``RandomState(0)``
(``synthetic_sample``: uniform depths in [2, 4], the rays, points and depth along
the rays of a pinhole camera at the identity pose, every pixel valid, random
images), the model at the config's default dtype (fp32; ``--small`` for the small
config) with the geometric encoders and seeded random weights, ``build_optimizer``
(warm-up over 5% of ``--steps``, cosine to the end) and ``make_train_step`` with no
geometric input (``GeometricInputConfig(overall_prob=0.0, dropout_prob=1.0,
sparse_depth_prob=0.0)``), the same sample every step. Prints ``step i: loss ...
grad_norm ...`` every 10 steps and at the last, then the final loss. Runs on the
card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from mapanything_tpu_torch.models.mapanything import (
    GeometricInputConfig,
    MapAnything,
    MapAnythingConfig,
    resolve_device,
)
from mapanything_tpu_torch.train.losses import LossBatch
from mapanything_tpu_torch.train.optim import OptimConfig, build_optimizer
from mapanything_tpu_torch.train.step import init_train_state, make_train_step

NO_GEOMETRIC_INPUTS = GeometricInputConfig(overall_prob=0.0, dropout_prob=1.0, sparse_depth_prob=0.0)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--small", action="store_true", help="the small config (MapAnythingConfig.small())")
    ap.add_argument("--views", type=int, default=2)
    ap.add_argument("--resolution", type=int, default=56)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def synthetic_sample(views: int, resolution: int, batch: int = 1) -> dict:
    """The JAX script's sample from ``RandomState(0)``, as numpy float32 arrays:
    ``pts3d`` (= ``pts3d_cam``), ``depth_along_ray``, ``ray_directions`` and ``img``."""
    B, V, H, W = batch, views, resolution, resolution
    rng = np.random.RandomState(0)
    K = np.array([[H, 0, W / 2 - 0.5], [0, H, H / 2 - 0.5], [0, 0, 1]], np.float32)
    depth = rng.uniform(2, 4, (B, V, H, W)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    x_cam = (xx - K[0, 2]) * depth / K[0, 0]
    y_cam = (yy - K[1, 2]) * depth / K[1, 1]
    pts_cam = np.stack([x_cam, y_cam, depth], -1)
    dirs = pts_cam / np.linalg.norm(pts_cam, axis=-1, keepdims=True)
    d_along = np.linalg.norm(pts_cam, axis=-1, keepdims=True)
    img = rng.randn(B, V, H, W, 3).astype(np.float32)
    return dict(pts3d=pts_cam, depth_along_ray=d_along, ray_directions=dirs, img=img)


def loss_batch(sample: dict, device) -> LossBatch:
    """The sample as a ``LossBatch`` on ``device``: identity poses, every pixel valid,
    metric and synthetic."""
    B, V, H, W = sample["img"].shape[:4]
    t = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    ones = torch.ones((B, V, H, W), dtype=torch.bool, device=device)
    return LossBatch(
        pts3d=t(sample["pts3d"]), pts3d_cam=t(sample["pts3d"]), depth_along_ray=t(sample["depth_along_ray"]),
        ray_directions=t(sample["ray_directions"]),
        camera_pose_quats=torch.tensor([0.0, 0, 0, 1], device=device).expand(B, V, 4),
        camera_pose_trans=torch.zeros((B, V, 3), device=device),
        valid_mask=ones, non_ambiguous_mask=ones, valid_non_ambiguous_mask=ones,
        is_metric_scale=torch.ones((B,), dtype=torch.bool, device=device),
        is_synthetic=torch.ones((B,), dtype=torch.bool, device=device),
    )


def run(args: argparse.Namespace) -> dict:
    """The finetune; returns each printed step's (step, loss, grad_norm), the
    seconds of each step (read after a synchronise), the final loss and the model."""
    device = resolve_device(args.device)
    sample = synthetic_sample(args.views, args.resolution)
    batch, img = loss_batch(sample, device), torch.from_numpy(sample["img"]).to(device)
    cfg = MapAnythingConfig.small() if args.small else MapAnythingConfig()
    model = MapAnything(cfg, device=device, seed=0, geometric_inputs=True)
    opt = build_optimizer(OptimConfig(lr=args.lr, warmup_epochs=0.05, total_epochs=1.0, epoch_len=args.steps), model)
    state = init_train_state(model, opt)
    step = make_train_step(model, opt, geo_cfg=NO_GEOMETRIC_INPUTS)

    generator = torch.Generator().manual_seed(1)
    printed, seconds = [], []
    for i in range(args.steps):
        t0 = time.perf_counter()
        state, metrics = step(state, img, batch, generator)
        loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])  # reads synchronise
        seconds.append(time.perf_counter() - t0)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {loss:.4f} grad_norm {grad_norm:.3f}", flush=True)
            printed.append((i, loss, grad_norm))
    print("final loss:", loss)
    return dict(printed=printed, seconds=seconds, final_loss=loss, model=model)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
