"""Config-driven training: a composed config, the dataset DSL, the loader, the Trainer.

    python3 -m mapanything_tpu_torch.tools.train [--config configs/train.yaml]
        [--override train_params.lr=5e-5 ...] [--dataset-expr "<DSL>"] [--device cuda]

The port of ``scripts/train.py`` (:1-157): compose ``--config`` with its
``defaults`` and the overrides (``utils/config.py``), evaluate the dataset
expression (``--dataset-expr``, else the config's ``dataset.train_dataset``)
against the WAI dataset classes with no builtins, e.g.

    "1000 @ ETH3DWAI(ROOT=..., dataset_metadata_dir=..., num_views=4,
                     resolution=(518, 392), covisibility_thres=0.25)"

then build ``MapAnythingConfig``, ``GeometricInputConfig``, ``LossConfig``,
``TrainLoopConfig`` and the ``MultiViewDataLoader`` from the config, as the JAX
script does, and run the ``Trainer`` on the card (``--device`` names another).
The model gets the port's seeded initialisation (``seed``), with the geometric
encoders, as the JAX script's ``model.init`` on the train views gives them.

A mesh (``distributed.mesh.view_parallelism`` or ``data_parallelism`` above 1,
as the JAX script reads them, :102-110) runs one process a rank: launch the tool
under ``torchrun`` (its ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
and ``MASTER_PORT``), e.g. 2 (data) x 2 (view) on four cards:

    torchrun --nproc_per_node 4 -m mapanything_tpu_torch.tools.train \
        --override distributed.mesh.view_parallelism=2

or call ``main`` inside a joined process group (``parallel.distributed.run_ranks``).
The tool joins the group (``init_distributed_mode``), builds the data x view
``Mesh`` over every rank (view fastest; ``data_parallelism`` -1 takes the ranks
that are left) and gives it to the ``Trainer``; every rank's loader yields the
same global batches, of which each rank takes its block. Activation
rematerialisation is read as the JAX script reads it (:75-84): ``model.remat``
(else ``train_params.grad_checkpointing``), ``model.remat_policy`` (else
``train_params.remat_policy``) and the per-part ``model.encoder_remat``,
``model.trunk_remat``, ``model.encoder_remat_policy`` and
``model.trunk_remat_policy``, e.g. ``--override model.remat=true
model.remat_policy=save_attn_mlp_pre``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from mapanything_tpu_torch.data.datasets.wai_datasets import ALL_WAI_DATASETS
from mapanything_tpu_torch.data.loader import MultiViewDataLoader
from mapanything_tpu_torch.models.mapanything import GeometricInputConfig, MapAnything, MapAnythingConfig
from mapanything_tpu_torch.parallel.distributed import init_distributed_mode
from mapanything_tpu_torch.parallel.mesh import make_mesh
from mapanything_tpu_torch.train.loop import Trainer, TrainLoopConfig
from mapanything_tpu_torch.train.losses import LossConfig
from mapanything_tpu_torch.utils.config import load_config



def build_dataset(expr: str):
    """Evaluate a dataset DSL expression over the WAI dataset classes, no builtins."""
    namespace = {f"{name}WAI": cls for name, cls in ALL_WAI_DATASETS.items()}
    namespace.update({name: cls for name, cls in ALL_WAI_DATASETS.items()})
    return eval(expr, {"__builtins__": {}}, namespace)  # noqa: S307 — the config's DSL


def model_config(cfg: dict) -> MapAnythingConfig:
    """The model config of the composed ``cfg``, field by field as the JAX script reads it."""
    mcfg, tp = cfg["model"], cfg["train_params"]
    return MapAnythingConfig(
        encoder_size=mcfg["encoder"]["size"],
        patch_size=mcfg["encoder"]["patch_size"],
        info_sharing_depth=mcfg["info_sharing"]["depth"],
        info_sharing_dim=mcfg["info_sharing"]["dim"],
        info_sharing_num_heads=mcfg["info_sharing"]["num_heads"],
        info_sharing_indices=tuple(mcfg["info_sharing"]["indices"]),
        use_entropy_scaling=mcfg["info_sharing"].get("use_entropy_scaling", False),
        dpt_feature_dim=mcfg["pred_head"]["dpt_feature_dim"],
        dpt_hooks=tuple(mcfg["pred_head"]["dpt_hooks"]),
        dpt_layer_dims=tuple(mcfg["pred_head"]["dpt_layer_dims"]),
        scene_rep_type=mcfg["pred_head"]["scene_rep_type"],
        compute_dtype=mcfg.get("compute_dtype", "bfloat16"),
        remat=bool(mcfg.get("remat", tp.get("grad_checkpointing", False))),
        remat_policy=mcfg.get("remat_policy", tp.get("remat_policy")),
        encoder_remat=mcfg.get("encoder_remat"),
        trunk_remat=mcfg.get("trunk_remat"),
        encoder_remat_policy=mcfg.get("encoder_remat_policy"),
        trunk_remat_policy=mcfg.get("trunk_remat_policy"),
    )


def loop_config(cfg: dict) -> TrainLoopConfig:
    tp, dist = cfg["train_params"], cfg.get("distributed", {})
    return TrainLoopConfig(
        output_dir=cfg.get("output_dir", "outputs/train"),
        epochs=tp["epochs"],
        warmup_epochs=tp["warmup_epochs"],
        lr=tp["lr"],
        min_lr=tp["min_lr"],
        weight_decay=tp["weight_decay"],
        grad_clip_norm=tp["grad_clip_norm"],
        save_freq=tp["save_freq"],
        keep_freq=tp["keep_freq"],
        print_freq=tp["print_freq"],
        seed=cfg.get("seed", tp.get("seed", 0)),
        submodule_configs=tp.get("submodule_configs", {}) or {},
        accum_iter=int(dist.get("accum_iter", 1)),
    )


def build_mesh(cfg: dict, device: str):
    """The data x view ``Mesh`` that ``distributed.mesh`` asks for, over the process
    group (joined here when it is not yet), or None for one process."""
    mesh_cfg = cfg.get("distributed", {}).get("mesh", {}) or {}
    view_par = int(mesh_cfg.get("view_parallelism", 1) or 1)
    data_par = mesh_cfg.get("data_parallelism", -1)
    if not (view_par > 1 or (isinstance(data_par, int) and data_par > 1)):
        return None
    init_distributed_mode(device)
    if not torch.distributed.is_initialized():
        raise RuntimeError(f"a mesh (view_parallelism={view_par}, data_parallelism={data_par}) needs a process "
                           "group of its ranks: launch the tool under torchrun (or call main inside run_ranks)")
    mesh = make_mesh(view_parallelism=view_par, data_parallelism=data_par if isinstance(data_par, int) else None)
    print(f"training on mesh {{'data': {mesh.data.size}, 'view': {mesh.view.size}}}")
    return mesh


def build(args: argparse.Namespace):
    """Everything the run needs, built from the composed config: (the model, the
    loader, the loop, loss and geometric-input configs, the mesh or None)."""
    cfg = load_config(args.config, overrides=args.override)
    mcfg = cfg["model"]
    mesh = build_mesh(cfg, args.device)
    model_cfg = model_config(cfg)
    geo_cfg = GeometricInputConfig(**{k: v for k, v in mcfg["task"].items()
                                      if k in GeometricInputConfig.__dataclass_fields__})
    loss_cfg = LossConfig(**{k: v for k, v in cfg["loss"].items() if k in LossConfig.__dataclass_fields__})

    dataset_expr = args.dataset_expr or cfg.get("dataset", {}).get("train_dataset")
    if not dataset_expr or dataset_expr == "???":
        raise ValueError("no dataset: pass --dataset-expr or compose a configs/dataset group")
    dist = cfg.get("distributed", {})
    # The global batches on every rank (world size 1): under a mesh each rank takes its
    # block of each one, so the loader must not deal batches out by rank.
    loader = MultiViewDataLoader(
        build_dataset(dataset_expr),
        images_per_batch=cfg.get("images_per_batch", dist.get("max_num_of_imgs_per_chip", 8)),
        num_workers=cfg.get("num_workers", cfg.get("dataset", {}).get("num_workers", 8)),
        world_size=1,
        rank=0,
    )
    loop_cfg = loop_config(cfg)
    model = MapAnything(model_cfg, device=args.device, seed=loop_cfg.seed, geometric_inputs=True)
    return model, loader, loop_cfg, loss_cfg, geo_cfg, mesh


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/train.yaml")
    ap.add_argument("--override", action="append", default=[])
    ap.add_argument("--dataset-expr", default=None, help="dataset DSL string")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Trainer:
    """Build the run from ``argv`` and train; returns the Trainer."""
    model, loader, loop_cfg, loss_cfg, geo_cfg, mesh = build(parse_args(argv))
    trainer = Trainer(model, loader, loop_cfg, loss_cfg=loss_cfg, geo_cfg=geo_cfg, mesh=mesh)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
