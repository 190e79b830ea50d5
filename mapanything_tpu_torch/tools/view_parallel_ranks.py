"""Rank bodies that drive the view-parallel paths and return numpy results.

``parallel.distributed.run_ranks`` starts each rank with ``spawn``, which
imports the body's module by name; these bodies live in the port, which
imports no JAX, so a rank process holds torch, numpy and the port only. The
parity tests run them over gloo on the CPU and hold rank 0's results to the
JAX package.

Every body is ``fn(rank, world_size, *args)`` inside a joined process group
and returns rank 0's gathered results (the other ranks return None, or
their own results where the test compares the ranks).
"""

from __future__ import annotations

import sys
from dataclasses import fields, replace

import numpy as np
import torch

from mapanything_tpu_torch.models.mapanything import MapAnything, MapAnythingConfig, ModalityMasks, Predictions, Views
from mapanything_tpu_torch.parallel import sharded_attention as sa
from mapanything_tpu_torch.parallel.context import gather_predictions, infer_view_sharded
from mapanything_tpu_torch.parallel.mesh import (
    all_gather, all_reduce, make_mesh, make_view_group, sample_slice, shard_batch_pytree, shard_views_pytree,
    view_slice,
)
from mapanything_tpu_torch.train.losses import LossBatch, LossConfig, factored_geometry_scale_loss
from mapanything_tpu_torch.train.optim import OptimConfig, build_optimizer
from mapanything_tpu_torch.train.step import init_train_state, make_train_step
from mapanything_tpu_torch.utils.jax_params import load_jax_params


def loaded_modules(rank: int, world_size: int) -> list:
    """The top-level modules this rank process has imported."""
    del rank, world_size
    return sorted({name.split(".")[0] for name in sys.modules})


def attention_cases(rank: int, world_size: int, cases: list) -> list:
    """Each case: {"fn": "ring_attention" | "allgather_kv_attention" |
    "global_attention_cp", "schedule", "scale", "q", "k", "v" (B, T, H, D),
    optional "qe", "ke", "ve" (B, E, H, D), "wg", "we"}. The grid tensors are
    split into token blocks over the ranks. Each rank differentiates its part
    of sum(og·wg) + sum(oe·we), the extra term on rank 0 only. Returns, on
    rank 0, og and oe and the gradients of every input (grid ones gathered,
    extra ones summed over ranks)."""
    group = make_view_group()
    results = []
    for case in cases:
        t = lambda name: torch.from_numpy(case[name])  # noqa: E731
        sl = view_slice(group, case["q"].shape[1])
        grid = {name: t(name)[:, sl].clone().requires_grad_() for name in ("q", "k", "v")}
        has_extra = case.get("qe") is not None
        extra = {name: t(name).requires_grad_() for name in ("qe", "ke", "ve")} if has_extra else {}
        if case["fn"] == "ring_attention":
            og, oe = sa.ring_attention(grid["q"], grid["k"], grid["v"], group, case["scale"]), None
        elif case["fn"] == "allgather_kv_attention":
            og, oe = sa.allgather_kv_attention(grid["q"], grid["k"], grid["v"], group, case["scale"]), None
        else:
            og, oe = sa.global_attention_cp(
                grid["q"], grid["k"], grid["v"], extra.get("qe"), extra.get("ke"), extra.get("ve"),
                group, case["scale"], case["schedule"])
        loss = (og * t("wg")[:, sl]).sum()
        if oe is not None and rank == 0:
            loss = loss + (oe * t("we")).sum()
        loss.backward()
        out = {"og": all_gather(og.detach(), group)}
        out.update({f"d{name}": all_gather(x.grad, group) for name, x in grid.items()})
        if has_extra:
            out["oe"] = oe.detach()
            # A rank whose loss leaves oe out has no gradient for qe.
            out.update({f"d{name}": all_reduce(torch.zeros_like(x) if x.grad is None else x.grad, group)
                        for name, x in extra.items()})
        results.append({k: v.numpy() for k, v in out.items()})
    return results if rank == 0 else None


def _small_model(config_kw: dict, params, geometric_inputs: bool) -> MapAnything:
    """The small model holding ``params``, built on the meta device (no seeded init)."""
    cfg = MapAnythingConfig.small(**config_kw)
    with torch.device("meta"):
        model = MapAnything(cfg, device="meta", geometric_inputs=geometric_inputs)
    return load_jax_params(model.to_empty(device="cpu"), params)


def _predictions_np(preds) -> dict:
    return {f.name: getattr(preds, f.name).numpy() for f in fields(preds)
            if getattr(preds, f.name) is not None}


def cp_forwards(rank: int, world_size: int, models: list, schedules) -> list:
    """For each (config_kw, params, views) of ``models``: the small model
    (``MapAnythingConfig.small(**config_kw)`` with ``params``, a JAX parameter tree) on ``views`` (numpy arrays of all
    views), view-sharded under each schedule. Returns, on rank 0, a
    {schedule: predictions of all views} for each model."""
    group = make_view_group()
    results = []
    for config_kw, params, views in models:
        geometric = any(k not in ("img", "is_metric_scale") for k in views)
        model = _small_model(config_kw, params, geometric)
        tv = Views(**{k: torch.from_numpy(v) for k, v in views.items()})
        results.append({schedule: _predictions_np(gather_predictions(infer_view_sharded(model, tv, group, schedule),
                                                                     group))
                        for schedule in schedules})
    return results if rank == 0 else None


def cp_train_step(rank: int, world_size: int, config_kw: dict, params, img, batch: dict, masks: dict,
                  opt_kw: dict) -> dict:
    """One view-parallel train step (the ring schedule) of the small model
    with every geometric input, given masks of all views. Returns the loss,
    the details, the (summed) gradients and the parameters after the update,
    by port name, and the ring's counts, on every rank (the test checks that
    the ranks agree)."""
    group = make_view_group()
    model = _small_model(config_kw, params, True)
    sl = view_slice(group, img.shape[1])
    lb = shard_views_pytree(LossBatch(**{k: torch.from_numpy(np.array(v)) for k, v in batch.items()}), group)
    mk = ModalityMasks(**{k: None if v is None else torch.from_numpy(v) for k, v in masks.items()})
    opt = build_optimizer(OptimConfig(**opt_kw), model)
    state = init_train_state(model, opt)
    step = make_train_step(model, opt, view_group=group)
    sa.reset_counts()
    state, metrics = step(state, torch.from_numpy(img[:, sl]), lb, torch.Generator().manual_seed(0), masks=mk)
    return {
        "metrics": {k: v.item() for k, v in metrics.items()},
        "grads": {n: p.grad.numpy() for n, p in state.params.items()},
        "params": {n: p.detach().numpy() for n, p in state.params.items()},
        "counts": sa.counts(),
    }


def cp_remat_steps(rank: int, world_size: int, config_kw: dict, params, img, batch: dict, masks: dict,
                   opt_kw: dict) -> dict:
    """The view-parallel step (ring) of the small model with every geometric input from the
    same weights, once with the trunk rematerialised (``trunk_remat=True``: the ring's
    collectives are replayed inside the backward) and once without; on the first rank also
    the unsharded step with the trunk rematerialised. Returns, on every rank, the names of
    the leaves whose gradients differ between the two ring steps (summed over the group),
    each leaf's largest gradient gap of the remat ring step to the unsharded one over the
    leaf's largest magnitude (first rank only), the losses, and each step's ring counts."""
    group = make_view_group()
    model = _small_model(config_kw, params, True)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    sl = view_slice(group, img.shape[1])
    full = LossBatch(**{k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    mk = ModalityMasks(**{k: None if v is None else torch.from_numpy(v) for k, v in masks.items()})
    opt = build_optimizer(OptimConfig(**opt_kw), model)
    runs = [("ring_remat", True, group), ("ring", False, group)] + ([("unsharded_remat", True, None)] if rank == 0
                                                                      else [])
    grads, losses, counts = {}, {}, {}
    for name, remat, g in runs:
        model.load_state_dict(start)
        model.configure_remat(trunk_remat=remat)
        state = init_train_state(model, opt)
        step = make_train_step(model, opt, view_group=g)
        lb, im = (full, img) if g is None else (shard_views_pytree(full, g), img[:, sl])
        sa.reset_counts()
        state, metrics = step(state, torch.from_numpy(im), lb, torch.Generator().manual_seed(0), masks=mk)
        grads[name] = {n: p.grad.clone() for n, p in state.params.items()}
        losses[name], counts[name] = metrics["loss"].item(), sa.counts()
    out = {"differ": [n for n, g in grads["ring_remat"].items() if not torch.equal(g, grads["ring"][n])],
           "losses": losses, "counts": counts}
    if rank == 0:
        out["gap_to_unsharded"] = {
            n: float((g - grads["unsharded_remat"][n]).abs().max() / (grads["unsharded_remat"][n].abs().max() + 1e-12))
            for n, g in grads["ring_remat"].items()}
    return out


def loss_parts(rank: int, world_size: int, view_parallelism: int, data_axis: bool, cfg_kw: dict, batch: dict,
               preds: dict) -> dict:
    """The training loss (``LossConfig(**cfg_kw)``) on this rank's (data, view) block of
    ``batch`` and ``preds`` (numpy arrays of the global batch) over ``make_mesh(
    view_parallelism)``: the view group always, the data group where ``data_axis``. Returns,
    on every rank, its part of the loss and of each detail, the gradients of its part with
    respect to its block of the predictions, and the block's sample and view slices."""
    del rank, world_size
    mesh = make_mesh(view_parallelism)
    lb = shard_batch_pytree(LossBatch(**{k: torch.from_numpy(np.array(v)) for k, v in batch.items()}), mesh)
    pr = shard_batch_pytree(Predictions(**{k: torch.from_numpy(v) for k, v in preds.items()}), mesh)
    leaves = {k: getattr(pr, k).clone().requires_grad_() for k in preds}
    total, details = factored_geometry_scale_loss(lb, replace(pr, **leaves), LossConfig(**cfg_kw), mesh.view,
                                                  mesh.data if data_axis else None)
    grads = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)
    samples = sample_slice(mesh.data, next(iter(preds.values())).shape[0])
    views = view_slice(mesh.view, batch["valid_mask"].shape[1])
    return {
        "loss": total.item(),
        "details": {k: v.item() for k, v in details.items()},
        "grads": {k: np.zeros(x.shape, np.float32) if g is None else g.numpy() for (k, x), g in zip(leaves.items(), grads)},
        "samples": (samples.start, samples.stop),
        "views": (views.start, views.stop),
    }


def mesh_trainer(rank: int, world_size: int, view_parallelism: int, config_kw: dict, state: dict, batch_np: dict,
                 loop_kw: dict, out_root: str, resume: bool = False) -> dict:
    """One epoch of one batch of the ``Trainer`` on the data x view mesh of every rank
    (``make_mesh(view_parallelism)``), the small model with every geometric input.
    Each rank starts from weights of its own seed; the first rank's are ``state`` (port
    names, numpy), which the Trainer replicates. Each rank writes under its own
    ``out_root/rank{r}``. With ``resume``, a second Trainer of fresh weights (each rank's
    own seed again) and two epochs then resumes in the same directories, where only
    the first rank has a checkpoint, and trains the second epoch. Each rank lists what
    it wrote and deletes it. Returns, on every rank, the digest of its parameters after
    the last update, its file list, the epoch its last Trainer started from and its
    step; on rank 0 also the log and the summed gradients of the last step."""
    import hashlib
    import shutil
    from pathlib import Path

    from mapanything_tpu_torch.parallel.mesh import make_mesh
    from mapanything_tpu_torch.train.loop import Trainer, TrainLoopConfig

    mesh = make_mesh(view_parallelism=view_parallelism)
    model = MapAnything(MapAnythingConfig.small(**config_kw), device="cpu", seed=rank + 1, geometric_inputs=True)
    if rank == 0:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    out = Path(out_root) / f"rank{rank}"
    trainer = Trainer(model, [batch_np], TrainLoopConfig(output_dir=str(out), epochs=1, **loop_kw), mesh=mesh)
    trainer.train()
    if resume:
        model = MapAnything(MapAnythingConfig.small(**config_kw), device="cpu", seed=rank + 11,
                            geometric_inputs=True)
        trainer = Trainer(model, [batch_np], TrainLoopConfig(output_dir=str(out), epochs=2, **loop_kw), mesh=mesh)
        trainer.train()
    files = sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file())
    log = (out / "log.txt").read_text() if rank == 0 else None
    shutil.rmtree(out)
    h = hashlib.blake2b(digest_size=16)
    for p in model.parameters():
        h.update(p.detach().contiguous().numpy().tobytes())
    result = {"files": files, "digest": h.hexdigest(), "mesh": (mesh.data.rank, mesh.view.rank),
              "start_epoch": trainer.start_epoch, "step": trainer.state.step}
    if rank == 0:
        result.update(log=log, grads={n: p.grad.numpy() for n, p in model.named_parameters()})
    return result


def train_tool_mesh(rank: int, world_size: int, mesh_cfg: dict):
    """The train tool's mesh for a config's ``distributed.mesh`` inside this group:
    (data size, view size, data rank, view rank), or the error it raises."""
    from mapanything_tpu_torch.tools.train import build_mesh

    try:
        mesh = build_mesh({"distributed": {"mesh": mesh_cfg}}, "cpu")
    except ValueError as err:
        return str(err)
    return mesh.data.size, mesh.view.size, mesh.data.rank, mesh.view.rank


def batch_digest(batch: dict) -> str:
    """A digest of a collated batch's images, valid masks and points."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for key in ("img", "valid_mask", "pts3d"):
        h.update(np.ascontiguousarray(batch[key]).tobytes())
    return h.hexdigest()


def train_tool_run(rank: int, world_size: int, argv: list) -> dict:
    """``tools.train.main(argv)`` inside this group, then the digest of every batch its
    loader yields in epoch 0 (``batch_digest``), the step taken and the digest of the
    parameters; rank 0 adds its log."""
    import hashlib
    from pathlib import Path

    from mapanything_tpu_torch.tools.train import main

    trainer = main(argv)
    trainer.train_loader.set_epoch(0)
    h = hashlib.blake2b(digest_size=16)
    for p in trainer.model.parameters():
        h.update(p.detach().contiguous().numpy().tobytes())
    result = {"batches": [batch_digest(b) for b in trainer.train_loader], "step": trainer.state.step,
              "digest": h.hexdigest()}
    if rank == 0:
        result["log"] = (Path(trainer.cfg.output_dir) / "log.txt").read_text()
    return result


def ba_sharded(rank: int, world_size: int, arrays: dict, solve_kw: dict):
    """``ba.solver.ba_solve_sharded`` on the tracks of ``arrays`` (numpy, every rank the
    same); every rank returns its (rot, trans, points, costs) as numpy."""
    from mapanything_tpu_torch.ba.solver import ba_solve_sharded
    from mapanything_tpu_torch.ba.tracks import Tracks

    del rank, world_size
    state, costs = ba_solve_sharded(Tracks(**{k: torch.from_numpy(v) for k, v in arrays.items()}), **solve_kw)
    return tuple(x.numpy() for x in (state.rot, state.trans, state.points, costs))
