"""Which loss term or gradient leads when the flagship train step goes non-finite at lr 1e-4.

    python3 -m mapanything_tpu_torch.tools.diagnose_lr_nan [--lr 1e-4] [--steps 10] [--views 4]
        [--res 518] [--warmup 0] [--small] [--device cuda]

The port of ``scripts/diagnose_lr_nan.py``: the flagship ``MapAnythingConfig(compute_dtype=
"bfloat16")`` with the geometric encoders (``--small``: ``MapAnythingConfig.small()`` on
1 x 2 x 56) and seeded random weights, trained by ``train.step.make_train_step`` from random
init at ``--lr`` (constant: ``min_lr`` lr / 10 over a 100-step epoch of one epoch, a linear
warm-up over ``--warmup`` steps), Adam's first moment in bf16 (fp32 with ``--small``), on the
JAX script's inputs from ``RandomState(0)`` (``make_inputs``), the images moved by 1e-4 a
step. Before each update a forensic pass runs the same forward with the same modality masks
(drawn from the step's generator, ``torch.Generator().manual_seed(i)``) and prints: max
|dL/d pred| of depth_along_ray, conf, metric_scaling_factor, pts3d_cam, pts3d and cam_trans
(the production loss alone, taken against the predictions detached to leaves), the
gradient norm of each top-level submodule, and the predictions' largest magnitudes. Then
the step, and a line of every loss term, the loss, the gradient norm, the parameters' norm
and largest magnitude and the step's milliseconds. Stops at the first non-finite loss. The
model is rematerialised as the JAX script's (:60-66): full recompute with ``--small``, else
``remat_policy="save_attn_mlp_pre"``. Runs on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from mapanything_tpu_torch.models.mapanything import (
    GeometricInputConfig,
    MapAnything,
    MapAnythingConfig,
    ModalityMasks,
    resolve_device,
)
from mapanything_tpu_torch.train.losses import LossBatch, LossConfig, factored_geometry_scale_loss
from mapanything_tpu_torch.train.optim import OptimConfig, build_optimizer
from mapanything_tpu_torch.train.step import (
    draw_step_inputs,
    init_train_state,
    make_train_step,
    views_from_loss_batch,
)

DPRED_FIELDS = ("depth_along_ray", "conf", "metric_scaling_factor", "pts3d_cam", "pts3d", "cam_trans")
PRED_MAX_FIELDS = ("depth_along_ray", "conf", "metric_scaling_factor", "pts3d_cam", "cam_trans")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--res", type=int, default=518)
    ap.add_argument("--warmup", type=int, default=0,
                    help="linear-warmup steps (0 = constant lr, the regime that NaNs; the reference warms up)")
    ap.add_argument("--small", action="store_true", help="the small config on 1 x 2 x 56 (a CPU smoke run)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def make_inputs(B: int, V: int, H: int, W: int) -> Dict[str, np.ndarray]:
    """The JAX script's ``LossBatch`` fields and ``img`` from ``RandomState(0)``, in its
    order of draws, as numpy arrays."""
    rng = np.random.RandomState(0)
    dirs = rng.randn(B, V, H, W, 3).astype(np.float32)
    dirs[..., 2] = np.abs(dirs[..., 2]) + 0.5
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    quats = rng.randn(B, V, 4).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    ones = np.ones((B, V, H, W), bool)
    return dict(
        pts3d=rng.randn(B, V, H, W, 3).astype(np.float32),
        pts3d_cam=rng.randn(B, V, H, W, 3).astype(np.float32),
        depth_along_ray=rng.uniform(1, 5, (B, V, H, W, 1)).astype(np.float32),
        ray_directions=dirs,
        camera_pose_quats=quats,
        camera_pose_trans=rng.randn(B, V, 3).astype(np.float32),
        valid_mask=ones, non_ambiguous_mask=ones, valid_non_ambiguous_mask=ones,
        is_metric_scale=np.ones((B,), bool),
        is_synthetic=np.zeros((B,), bool),
        img=rng.rand(B, V, H, W, 3).astype(np.float32),
    )


def build(args: argparse.Namespace) -> tuple:
    """(model config, (B, V, H, W), optimizer config) of the run."""
    if args.small:
        return MapAnythingConfig.small(remat=True), (1, 2, 56, 56), OptimConfig(
            lr=args.lr, min_lr=args.lr * 0.1, warmup_epochs=args.warmup / 100.0, epoch_len=100, total_epochs=1.0)
    cfg = MapAnythingConfig(compute_dtype="bfloat16", remat=True, remat_policy="save_attn_mlp_pre")
    return cfg, (1, args.views, args.res, args.res), OptimConfig(
        lr=args.lr, min_lr=args.lr * 0.1, warmup_epochs=args.warmup / 100.0, epoch_len=100, total_epochs=1.0,
        mu_dtype="bfloat16")


def _max_abs(x: torch.Tensor) -> float:
    return float(x.detach().float().abs().max())


def forensic(model: MapAnything, batch: LossBatch, img: torch.Tensor, masks: ModalityMasks,
             pe_indices, loss_cfg: LossConfig) -> Dict[str, float]:
    """The forensic line of one step, before its update: the loss's cotangents of the
    predictions, each top-level submodule's gradient norm, the predictions' maxima."""
    V = batch.valid_mask.shape[1]
    for p in model.parameters():
        p.grad = None
    preds = model(views_from_loss_batch(batch, img), masks, deterministic=True, non_ref_view_pe_indices=pe_indices)
    loss, _ = factored_geometry_scale_loss(batch, preds, loss_cfg)
    (loss * 2.0 / V).backward()
    out: Dict[str, float] = {}
    leaves = {name: getattr(preds, name).detach().float().requires_grad_() for name in DPRED_FIELDS
              if getattr(preds, name) is not None}
    detached = {f.name: getattr(preds, f.name) for f in dataclasses.fields(preds)}
    detached = {k: leaves.get(k, None if x is None else x.detach()) for k, x in detached.items()}
    loss2, _ = factored_geometry_scale_loss(batch, dataclasses.replace(preds, **detached), loss_cfg)
    grads = torch.autograd.grad(loss2 * 2.0 / V, list(leaves.values()), allow_unused=True)
    for name, g in zip(leaves, grads):
        out[f"dL/d{name}"] = 0.0 if g is None else _max_abs(g)
    squares: Dict[str, torch.Tensor] = {}
    for name, p in model.named_parameters():
        if p.grad is not None:
            top = name.split(".")[0]
            squares[top] = squares.get(top, 0.0) + p.grad.float().square().sum()
    out.update({f"g/{top}": float(torch.sqrt(sq)) for top, sq in sorted(squares.items())})
    for name in PRED_MAX_FIELDS:
        if getattr(preds, name) is not None:
            out[f"max|{name}|"] = _max_abs(getattr(preds, name))
    for p in model.parameters():
        p.grad = None
    return out


def run(args: argparse.Namespace, model: Optional[MapAnything] = None,
        masks_for_step: Optional[Callable[[int], ModalityMasks]] = None) -> List[dict]:
    """The run; returns one record a step: ``metrics`` (every loss term, ``loss``,
    ``grad_norm``), ``param_norm``, ``param_max``, ``forensic`` and ``ms`` (the step's
    update, read after a synchronise). ``model``: a built model of ``build``'s config (else
    one is seeded on the device); ``masks_for_step(i)``: step i's modality masks (else drawn
    from the step's generator)."""
    device = resolve_device(args.device)
    cfg, (B, V, H, W), opt_cfg = build(args)
    if model is None:
        model = MapAnything(cfg, device=device, seed=0, geometric_inputs=True)
    arrays = make_inputs(B, V, H, W)
    img0 = torch.from_numpy(arrays.pop("img")).to(device)
    batch = LossBatch(**{k: torch.from_numpy(v).to(device) for k, v in arrays.items()})
    optimizer = build_optimizer(opt_cfg, model)
    state = init_train_state(model, optimizer)
    geo_cfg, loss_cfg = GeometricInputConfig(), LossConfig()
    step = make_train_step(model, optimizer, loss_cfg, geo_cfg)
    records, term_keys = [], None
    for i in range(args.steps):
        img = img0 + i * 1e-4
        given = None if masks_for_step is None else masks_for_step(i).to(device)
        masks, pe_indices = draw_step_inputs(model, geo_cfg, torch.Generator().manual_seed(i), (B, V, H, W), given)
        fz = forensic(model, batch, img, masks, pe_indices, loss_cfg)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, img, batch, torch.Generator().manual_seed(i), masks=given)
        m = {k: float(v) for k, v in metrics.items()}  # reads synchronise
        ms = (time.perf_counter() - t0) * 1e3
        with torch.no_grad():
            params = [p.detach().float() for p in state.params.values()]
            pn = float(torch.sqrt(sum(p.square().sum() for p in params)))
            pmax = max(float(p.abs().max()) for p in params)
        if term_keys is None:
            term_keys = sorted(m)
            print("step  " + "  ".join(f"{k:>16}" for k in term_keys)
                  + f"  {'param_norm':>12}  {'param_max':>10}  {'ms':>9}", flush=True)
        print(f"{i:4d}  " + "  ".join(f"{m.get(k, float('nan')):16.4e}" for k in term_keys)
              + f"  {pn:12.4e}  {pmax:10.4e}  {ms:9.2f}", flush=True)
        print("      forensic: " + "  ".join(f"{k}={v:.3e}" for k, v in sorted(fz.items())), flush=True)
        records.append(dict(step=i, metrics=m, param_norm=pn, param_max=pmax, forensic=fz, ms=ms))
        if not math.isfinite(m.get("loss", float("nan"))):
            print(f"loss went non-finite at step {i}", flush=True)
            break
    return records


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
