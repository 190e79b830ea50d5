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
from dataclasses import fields

import numpy as np
import torch

from mapanything_tpu_torch.models.mapanything import MapAnything, MapAnythingConfig, ModalityMasks, Views
from mapanything_tpu_torch.parallel import sharded_attention as sa
from mapanything_tpu_torch.parallel.context import gather_predictions, infer_view_sharded
from mapanything_tpu_torch.parallel.mesh import (
    all_gather, all_reduce, make_view_group, shard_views_pytree, view_slice,
)
from mapanything_tpu_torch.train.losses import LossBatch
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
    cfg = MapAnythingConfig.small(**config_kw)
    return load_jax_params(MapAnything(cfg, device="cpu", geometric_inputs=geometric_inputs), params)


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
