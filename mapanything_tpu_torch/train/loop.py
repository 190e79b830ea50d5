"""The training runtime: epochs, eval, checkpoints, resume, NaN forensics.

Counterpart of ``mapanything_tpu/train/loop.py`` (:45-357), itself after the
reference's ``training.py`` (train :44, train_one_epoch :387, test_one_epoch
:584): the warm-up-cosine schedule per step, the loss scaled by 2 / V (in the
step), clipping (in the optimizer), the epoch loop {train, test, save,
checkpoint-best}, auto-resume from the latest checkpoint, the loss-explosion
forensic dump, gradient accumulation and JSON-lines epoch logs.

The ``Trainer`` takes any iterable of collated numpy batches with a length
(``set_epoch(epoch)`` is called where the loader has it) and runs on the
model's device. It keeps two quirks of the JAX package: a checkpoint's step
is the epoch, and the random stream (masks, PE indices) restarts from
``cfg.seed`` on resume, since it is not checkpointed.

The data axis (the JAX ``Trainer``'s ``mesh``, :139-145, :195-260): with a
``parallel.mesh.Mesh`` (data × view) every rank runs a ``Trainer`` over the same
loader, which yields the global batches; the train state starts replicated (the
first rank's, which alone restores on resume) and stays so, each rank takes its (data, view) block of every
batch (``shard_batch_pytree``), the steps sum the gradients and the metrics
over the mesh (``train.step``), and the first rank alone writes checkpoints and
logs.
"""

from __future__ import annotations

import dataclasses
import pickle
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from mapanything_tpu_torch.models.mapanything import GeometricInputConfig, MapAnything, resolve_device
from mapanything_tpu_torch.parallel.mesh import Mesh, sample_slice, shard_batch_pytree, view_slice
from mapanything_tpu_torch.train.checkpointing import CheckpointManager
from mapanything_tpu_torch.train.losses import LossBatch, LossConfig
from mapanything_tpu_torch.train.optim import OptimConfig, SubmoduleOptimConfig, build_optimizer
from mapanything_tpu_torch.train.step import (
    init_train_state,
    make_accum_train_step,
    make_eval_step,
)
from mapanything_tpu_torch.utils.logging import JsonlLogger, MetricLogger, all_reduce_mean, print_main


@dataclass
class TrainLoopConfig:
    output_dir: str = "outputs/run"
    epochs: int = 10
    warmup_epochs: float = 1.0
    lr: float = 1e-4
    min_lr: float = 1e-6
    weight_decay: float = 0.05
    grad_clip_norm: float = 1.0
    save_freq: int = 1  # epochs between checkpoint-last saves
    keep_freq: int = 0  # keep every N epochs permanently
    print_freq: int = 20
    seed: int = 0
    max_loss_explosion: float = 1e4  # NaN/explosion abort threshold
    resume: bool = True
    # Per-submodule optimizer overrides, {name: {"lr_scale": f, "frozen": bool,
    # "weight_decay": f}} (configs/train_params/*.yaml); as in the JAX package,
    # a submodule's weight_decay is read nowhere.
    submodule_configs: dict = dataclasses.field(default_factory=dict)
    # Gradient accumulation: one optimizer step per accum_iter loader batches
    # (1: a step a batch). A group flushes when it is full, when the batch shape
    # changes (another aspect-ratio or view-count bucket) and at the end of the epoch.
    accum_iter: int = 1


def loss_batch_from_numpy(batch_np: Dict[str, np.ndarray], device: Union[str, torch.device, None] = None) -> LossBatch:
    """A collated numpy batch as a ``LossBatch`` on ``device`` (CUDA unless
    given); floats as fp32."""
    device = resolve_device(device)

    def t(x):
        x = torch.as_tensor(np.asarray(x))
        return (x.float() if x.is_floating_point() else x).to(device)

    return LossBatch(
        pts3d=t(batch_np["pts3d"]),
        pts3d_cam=t(batch_np["pts3d_cam"]),
        depth_along_ray=t(batch_np["depth_along_ray"]),
        ray_directions=t(batch_np["ray_directions_cam"]),
        camera_pose_quats=t(batch_np["camera_pose_quats"]),
        camera_pose_trans=t(batch_np["camera_pose_trans"]),
        valid_mask=t(batch_np["valid_mask"]),
        non_ambiguous_mask=t(batch_np["non_ambiguous_mask"]),
        valid_non_ambiguous_mask=t(batch_np.get("valid_non_ambiguous_mask", batch_np["non_ambiguous_mask"])),
        is_metric_scale=t(batch_np["is_metric_scale"]),
        is_synthetic=t(batch_np["is_synthetic"]),
    )


def _images(batch_np, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(batch_np["img"]), dtype=torch.float32).to(device)



class Trainer:
    """Epoch-driven trainer of ``model`` (which holds its parameters, on its
    device) over ``train_loader``; ``test_loader`` feeds the eval step and
    checkpoint-best. ``mesh``: the data × view mesh of every rank (see the
    module's docstring), or None for one process."""

    def __init__(
        self,
        model: MapAnything,
        train_loader,
        cfg: TrainLoopConfig,
        test_loader=None,
        loss_cfg: LossConfig = LossConfig(),
        geo_cfg: GeometricInputConfig = GeometricInputConfig(),
        mesh: Optional[Mesh] = None,
    ):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), not {type(mesh).__name__}")
        self.model = model
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        self.device = model.device
        self.train_loader = train_loader
        self.test_loader = test_loader
        self.cfg = cfg
        self.loss_cfg = loss_cfg
        self.geo_cfg = geo_cfg

        submods = {
            name: SubmoduleOptimConfig(lr_scale=0.0 if sub.get("frozen") else sub.get("lr_scale", 1.0))
            for name, sub in (cfg.submodule_configs or {}).items()
        }
        self.opt_cfg = OptimConfig(
            lr=cfg.lr,
            min_lr=cfg.min_lr,
            weight_decay=cfg.weight_decay,
            grad_clip_norm=cfg.grad_clip_norm,
            warmup_epochs=cfg.warmup_epochs,
            total_epochs=cfg.epochs,
            epoch_len=max(len(train_loader), 1),
            submodules=submods,
        )
        self.optimizer = build_optimizer(self.opt_cfg, model)
        self.state = init_train_state(model, self.optimizer)
        self._accum_steps: Dict[int, object] = {}
        self.eval_step = make_eval_step(model, loss_cfg, mesh)

        self.ckpt = CheckpointManager(str(Path(cfg.output_dir) / "checkpoints"), keep_freq=cfg.keep_freq)
        # checkpoint-best: saved whenever the test loss improves (training.py:237-287).
        self.ckpt_best = CheckpointManager(str(Path(cfg.output_dir) / "checkpoints-best"), max_to_keep=1)
        self.jsonl = JsonlLogger(cfg.output_dir, enabled=self.is_main)
        self.start_epoch = 0
        self.best_loss = float("inf")
        # Not checkpointed: a resumed run draws from the seed again, as the JAX Trainer does.
        self.generator = torch.Generator().manual_seed(cfg.seed)

        # Under a mesh the first rank alone reads its checkpoints, then replicates.
        if cfg.resume and self.is_main and self.ckpt.latest_step() is not None:
            restored = self.ckpt.restore(self.state)
            if restored is not None:
                self.state = restored
                meta = self.ckpt.load_metadata() or {}
                self.start_epoch = int(meta.get("epoch", 0)) + 1
                best_meta = self.ckpt_best.load_metadata() or {}
                self.best_loss = float(best_meta.get("best_loss", float("inf")))
                print_main(f"Resumed from checkpoint at epoch {self.start_epoch - 1}")
        if mesh is not None:
            self._replicate_first_rank()

    def _replicate_first_rank(self):
        """Every rank takes the first rank's train state (parameters, Adam moments,
        counts), epoch to start from and best test loss: its initial weights, or
        what it restored."""
        src, group = self.mesh.world.ranks[0], self.mesh.world.group
        o = self.state.opt_state
        norm = None if o.grad_norm is None else o.grad_norm.cpu()
        meta = [(self.start_epoch, self.best_loss, self.state.step, o.count, norm)]
        dist.broadcast_object_list(meta, src=src, group=group, device=self.device)
        self.start_epoch, self.best_loss, step, count, norm = meta[0]
        with torch.no_grad():
            for tensors in (self.state.params, o.mu, o.nu):
                for t in tensors.values():
                    dist.broadcast(t.data, src=src, group=group)
        opt_state = dataclasses.replace(o, count=count, grad_norm=None if norm is None else norm.to(self.device))
        self.state = dataclasses.replace(self.state, opt_state=opt_state, step=step)

    # ------------------------------------------------------------------
    def _dump_forensics(self, batch_np, loss, epoch, it):
        """Loss explosion: pickle the batch, save a debug checkpoint at the
        optimizer step, raise (training.py:481-510)."""
        out = Path(self.cfg.output_dir) / "debug"
        if self.is_main:
            out.mkdir(parents=True, exist_ok=True)
            with open(out / f"bad_batch_e{epoch}_i{it}.pkl", "wb") as f:
                pickle.dump(batch_np, f)
            self.ckpt.save(int(self.state.step), self.state, {"debug": True, "epoch": epoch})
            self.ckpt.wait()
        raise FloatingPointError(
            f"loss explosion/NaN at epoch {epoch} iter {it}: {loss}; batch + checkpoint dumped to {out}"
        )

    def _check_loss(self, loss: float, batch_np, epoch: int, it: int) -> None:
        if not np.isfinite(loss) or loss > self.cfg.max_loss_explosion:
            self._dump_forensics(batch_np, loss, epoch, it)

    def _accum_step_for(self, n: int):
        if n not in self._accum_steps:
            self._accum_steps[n] = make_accum_train_step(self.model, self.optimizer, n, self.loss_cfg, self.geo_cfg,
                                                         self.mesh)
        return self._accum_steps[n]

    def _inputs(self, batch_np):
        """(img, LossBatch) of a collated batch on the device: this rank's block under a mesh."""
        img, batch = _images(batch_np, self.device), loss_batch_from_numpy(batch_np, self.device)
        if self.mesh is None:
            return img, batch
        img = img[sample_slice(self.mesh.data, img.shape[0])][:, view_slice(self.mesh.view, img.shape[1])]
        return img, shard_batch_pytree(batch, self.mesh)

    def _run_accum_group(self, group):
        imgs, batches = zip(*(self._inputs(b) for b in group))
        return self._accum_step_for(len(group))(self.state, list(imgs), list(batches), self.generator)

    def train_one_epoch(self, epoch: int) -> Dict[str, float]:
        """One pass over the train loader in accumulation groups of up to
        ``accum_iter`` batches, one optimizer step each. With ``accum_iter=1``
        every group is one batch, and its step is the JAX package's plain one:
        the same draws (masks, then PE indices) and the mean of one gradient."""
        logger = MetricLogger(print_fn=print_main)
        if hasattr(self.train_loader, "set_epoch"):
            self.train_loader.set_epoch(epoch)
        group, shape, it = [], None, 0

        def flush():
            """Run the pending group; every flush (full group, bucket change,
            trailing partial group) gets the forensic check."""
            nonlocal group, shape
            if not group:
                return
            last_batch = group[-1]
            self.state, metrics = self._run_accum_group(group)
            group, shape = [], None
            loss = float(metrics["loss"])
            self._check_loss(loss, last_batch, epoch, it)
            logger.update(loss=loss, grad_norm=float(metrics["grad_norm"]))

        for it, batch_np in enumerate(logger.log_every(self.train_loader, self.cfg.print_freq, f"Epoch [{epoch}]")):
            b_shape = np.shape(batch_np["img"])
            if shape is not None and b_shape != shape:
                flush()
            group.append(batch_np)
            shape = b_shape
            if len(group) == self.cfg.accum_iter:
                flush()
        flush()
        stats = logger.global_avg_dict("train_")
        stats["train_loss_synced"] = all_reduce_mean(stats.get("train_loss", 0.0))
        return stats

    def test_one_epoch(self, epoch: int) -> Dict[str, float]:
        if self.test_loader is None:
            return {}
        logger = MetricLogger(print_fn=print_main)
        if hasattr(self.test_loader, "set_epoch"):
            self.test_loader.set_epoch(epoch)
        for batch_np in logger.log_every(self.test_loader, self.cfg.print_freq, f"Test [{epoch}]"):
            metrics = self.eval_step(*self._inputs(batch_np))
            logger.update(loss=float(metrics["loss"]))
        return logger.global_avg_dict("test_")

    def train(self):
        for epoch in range(self.start_epoch, self.cfg.epochs):
            t0 = time.time()
            train_stats = self.train_one_epoch(epoch)
            test_stats = self.test_one_epoch(epoch)
            self.jsonl.write({"epoch": epoch, **train_stats, **test_stats, "epoch_time_s": time.time() - t0})
            if self.is_main and (epoch % self.cfg.save_freq == 0 or epoch == self.cfg.epochs - 1):
                self.ckpt.save(epoch, self.state, {"epoch": epoch})  # the step is the epoch, as in the JAX Trainer
            test_loss = test_stats.get("test_loss")
            if test_loss is not None and test_loss < self.best_loss:
                self.best_loss = test_loss
                if self.is_main:
                    self.ckpt_best.save(epoch, self.state, {"epoch": epoch, "best_loss": test_loss})
        self.ckpt.wait()
        self.ckpt_best.wait()
        return self.state
