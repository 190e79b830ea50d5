"""AdamW of the port, with the JAX package's parameter rules and schedule.

Counterpart of ``mapanything_tpu/train/optim.py`` (:22-197):
``SubmoduleOptimConfig``, ``OptimConfig``, ``warmup_cosine_schedule``,
``make_weight_decay_mask``, ``make_lr_scale_tree``, ``scale_by_adam_dtypes``
and ``build_optimizer``. The optax chain is written out over tensors:

    clip by global norm -> Adam (moments stored in mu_dtype / nu_dtype)
    -> masked decoupled weight decay -> per-submodule lr scales -> -schedule

``torch.optim.AdamW`` cannot store bf16 moments for fp32 parameters, hence
the port's own. Parameters, gradients and updates are dicts by the port's
parameter names. The weight-decay mask and the lr scales follow the JAX
rules on the JAX leaves (rank ≥ 2 and not a bias; path prefixes), read
through ``utils.jax_params.param_map``, not from the torch shapes.
The moments are updated in place, to hold one copy of them on the card and
to pass over them once; with bf16 storage an fp32 copy is made per step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mapanything_tpu_torch.utils.jax_params import jax_leaf_rank, param_map


@dataclass(frozen=True)
class SubmoduleOptimConfig:
    """Per-submodule override. (The JAX config's ``weight_decay`` field is
    read nowhere there, so the port leaves it out.)"""

    lr_scale: float = 1.0  # multiplier on the base schedule (0 freezes)


@dataclass(frozen=True)
class OptimConfig:
    """The production recipe (training.py:161-163; configs/train_params)."""

    lr: float = 1e-4
    min_lr: float = 1e-6
    weight_decay: float = 0.05
    betas: tuple = (0.9, 0.95)
    grad_clip_norm: float = 1.0
    warmup_epochs: float = 0.0
    total_epochs: float = 100.0
    epoch_len: int = 1000  # steps per epoch (schedule granularity)
    submodules: Dict[str, SubmoduleOptimConfig] = field(default_factory=dict)
    mu_dtype: Optional[str] = None  # storage dtype of Adam's first moment (None = fp32)
    nu_dtype: Optional[str] = None  # storage dtype of the second moment (None = fp32)


def warmup_cosine_schedule(cfg: OptimConfig):
    """Linear warm-up then a half-cycle cosine decay, continuous in epochs."""

    def schedule(step: int) -> float:
        epoch = step / cfg.epoch_len
        if epoch < cfg.warmup_epochs:
            return cfg.lr * epoch / max(cfg.warmup_epochs, 1e-8)
        denom = max(cfg.total_epochs - cfg.warmup_epochs, 1e-8)
        return cfg.min_lr + (cfg.lr - cfg.min_lr) * 0.5 * (
            1.0 + math.cos(math.pi * (epoch - cfg.warmup_epochs) / denom)
        )

    return schedule


def make_weight_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """True for the parameters that receive weight decay: those whose JAX leaf
    has rank ≥ 2 and is not a bias (train_tools.py:833-838)."""
    params = dict(model.named_parameters())
    return {
        name: jax_leaf_rank(layout, params[name]) >= 2 and not path.rsplit("/", 1)[-1].endswith("bias")
        for name, (path, layout) in param_map(model).items()
    }


def make_lr_scale_tree(model: nn.Module, submodules: Dict[str, SubmoduleOptimConfig]) -> Dict[str, float]:
    """Per-parameter lr multiplier: the first submodule whose key prefixes the
    JAX path ("a/b/c"), or equals one of its components, sets it."""
    scales = {}
    for name, (path, _) in param_map(model).items():
        scales[name] = 1.0
        for prefix, sub in submodules.items():
            if path.startswith(prefix) or prefix in path.split("/"):
                scales[name] = sub.lr_scale
                break
    return scales


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, in fp32."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([t.float() for t in tensors])))


@dataclass
class OptState:
    count: int  # updates taken
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    grad_norm: Optional[torch.Tensor] = None  # global norm of the last update's gradients, before clipping


class AdamW:
    """The optax chain of ``build_optimizer``: ``init(params)`` and
    ``update(grads, state, params) -> (updates, state)``; ``apply_updates``
    adds the updates to the parameters in place."""

    def __init__(self, cfg: OptimConfig, decay_mask: Dict[str, bool], lr_scales: Optional[Dict[str, float]] = None):
        self.cfg = cfg
        self.decay_mask = decay_mask
        self.lr_scales = lr_scales
        self.schedule = warmup_cosine_schedule(cfg)
        self.mu_dtype = getattr(torch, cfg.mu_dtype) if cfg.mu_dtype else None
        self.nu_dtype = getattr(torch, cfg.nu_dtype) if cfg.nu_dtype else None

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        return OptState(
            count=0,
            mu={n: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for n, p in params.items()},
            nu={n: torch.zeros_like(p, dtype=self.nu_dtype or p.dtype) for n, p in params.items()},
        )

    @torch.no_grad()
    def update(
        self, grads: Dict[str, Optional[torch.Tensor]], state: OptState, params: Dict[str, torch.Tensor]
    ) -> Tuple[Dict[str, torch.Tensor], OptState]:
        cfg = self.cfg
        b1, b2 = cfg.betas
        names = list(params)
        g = [torch.zeros_like(params[n]) if grads.get(n) is None else grads[n].float() for n in names]

        # Clip by the global norm: t / norm * max_norm when the norm exceeds max_norm.
        g_norm = global_norm(g)
        clip = torch.where(g_norm < cfg.grad_clip_norm, torch.ones_like(g_norm), cfg.grad_clip_norm / g_norm)
        g = torch._foreach_mul(g, clip)

        # Adam: mu = b1·mu + (1 - b1)·g, nu = b2·nu + (1 - b2)·g², then
        # (mu / bc1) / (sqrt(nu / bc2) + eps), all in fp32.
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        stored_fp32 = self.mu_dtype is None and self.nu_dtype is None
        if stored_fp32:  # the moments are updated in place
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
            mu32, nu32 = mu, nu
        else:
            # The JAX package's default path (nu_dtype None: optax's own
            # scale_by_adam) multiplies the stored mu by b1 in mu's storage
            # dtype, with b1 itself rounded to that dtype (a weakly typed
            # Python scalar); scale_by_adam_dtypes (nu_dtype set) does every
            # product in fp32.
            b1_mu = b1
            if self.nu_dtype is not None:
                mu, nu = [m.float() for m in mu], [v.float() for v in nu]
            else:
                b1_mu = torch.tensor(b1, dtype=self.mu_dtype).item()
            mu32 = torch._foreach_add(torch._foreach_mul(g, 1.0 - b1), [m.float() for m in torch._foreach_mul(mu, b1_mu)])
            nu32 = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2), torch._foreach_mul(nu, b2))
        count = state.count + 1
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.int32(count))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.int32(count))
        den = torch._foreach_div(nu32, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, 1e-8)
        upd = torch._foreach_div(mu32, bc1)
        torch._foreach_div_(upd, den)
        del den
        if not stored_fp32:
            for n, m, v in zip(names, mu32, nu32):
                state.mu[n].copy_(m)
                state.nu[n].copy_(v)

        # Decoupled weight decay on the masked parameters, lr scales, -lr.
        decayed = [i for i, n in enumerate(names) if self.decay_mask[n]]
        if decayed and cfg.weight_decay:
            torch._foreach_add_([upd[i] for i in decayed], [params[names[i]] for i in decayed], alpha=cfg.weight_decay)
        if self.lr_scales is not None:
            torch._foreach_mul_(upd, [self.lr_scales[n] for n in names])
        torch._foreach_mul_(upd, -float(np.float32(self.schedule(state.count))))
        return dict(zip(names, upd)), OptState(count=count, mu=state.mu, nu=state.nu, grad_norm=g_norm)


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor], updates: Dict[str, torch.Tensor]) -> None:
    """params += updates, in place."""
    names = list(updates)
    torch._foreach_add_([params[n] for n in names], [updates[n].to(params[n].dtype) for n in names])


def build_optimizer(cfg: OptimConfig, model: nn.Module) -> AdamW:
    """AdamW with clipping, the warm-up-cosine schedule and per-submodule lr scales."""
    lr_scales = make_lr_scale_tree(model, cfg.submodules) if cfg.submodules else None
    return AdamW(cfg, make_weight_decay_mask(model), lr_scales)
