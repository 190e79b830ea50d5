"""Train-state checkpoints on ``torch.save``, with the JAX package's retention.

Counterpart of ``mapanything_tpu/train/checkpointing.py`` (:20-70), which
wraps orbax. A checkpoint is one file a step, ``<directory>/<step>.pt``, that
holds the parameters, the AdamW state (the moments in their configured dtypes,
the update count and the last gradient norm) and the step; it is written to a
temporary name and then renamed, so a crash leaves no half-written step. The
newest ``max_to_keep`` steps are kept, and every step with
``step % keep_freq == 0`` too. ``train_meta.json`` beside them holds the last
metadata given (``{"step": step, **metadata}``), also written then renamed.
Saving is synchronous: ``wait`` and ``close`` do nothing.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, Optional

import torch

from mapanything_tpu_torch.train.optim import OptState
from mapanything_tpu_torch.train.step import TrainState


def _state_dict(state: TrainState) -> dict:
    o = state.opt_state
    return {
        "params": {n: p.detach() for n, p in state.params.items()},
        "opt_state": {"count": o.count, "mu": o.mu, "nu": o.nu, "grad_norm": o.grad_norm},
        "step": int(state.step),
    }


def _copy_into(name: str, saved: torch.Tensor, target: torch.Tensor) -> None:
    if saved.shape != target.shape or saved.dtype != target.dtype:
        raise ValueError(f"checkpoint {name}: {saved.dtype} {tuple(saved.shape)}, "
                         f"the template holds {target.dtype} {tuple(target.shape)}")
    target.copy_(saved)


def _restore_dict(saved: dict, target: dict, what: str) -> None:
    if set(saved) != set(target):
        raise KeyError(f"checkpoint {what}: missing {sorted(set(target) - set(saved))}, "
                       f"not in the template {sorted(set(saved) - set(target))}")
    for name, tensor in target.items():
        _copy_into(f"{what}/{name}", saved[name], tensor)


class CheckpointManager:
    """Last / keep-every-N checkpoints of a ``TrainState`` in one directory."""

    def __init__(self, directory: str, keep_freq: int = 0, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep_freq = keep_freq
        self.max_to_keep = max_to_keep
        self._meta_path = self.directory / "train_meta.json"

    def _path(self, step: int) -> Path:
        return self.directory / f"{step}.pt"

    def all_steps(self) -> List[int]:
        return sorted(int(p.stem) for p in self.directory.glob("*.pt") if p.stem.isdigit())

    def save(self, step: int, state: TrainState, metadata: Optional[dict] = None) -> None:
        """Save the train state at ``step`` (and the host metadata), then drop the
        steps that the retention no longer keeps."""
        path = self._path(step)
        tmp = path.with_name(path.name + ".tmp")
        torch.save(_state_dict(state), tmp)
        os.replace(tmp, path)
        if metadata is not None:
            tmp = self._meta_path.with_suffix(".tmp")
            with open(tmp, "w") as f:
                json.dump({"step": step, **metadata}, f)
            os.replace(tmp, self._meta_path)
        steps = self.all_steps()
        for old in steps[:-self.max_to_keep] if self.max_to_keep else []:
            if not (self.keep_freq > 0 and old % self.keep_freq == 0):
                self._path(old).unlink()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_template: TrainState, step: Optional[int] = None) -> Optional[TrainState]:
        """Copy a saved step (the latest by default) into the template's tensors,
        on their devices, and return the template's state with the saved count,
        gradient norm and step; None when there is no checkpoint. Names, shapes
        and dtypes must match."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        saved = torch.load(self._path(step), map_location="cpu", mmap=True, weights_only=True)
        o = state_template.opt_state
        with torch.no_grad():
            _restore_dict(saved["params"], state_template.params, "params")
            _restore_dict(saved["opt_state"]["mu"], o.mu, "mu")
            _restore_dict(saved["opt_state"]["nu"], o.nu, "nu")
        norm = saved["opt_state"]["grad_norm"]
        device = next(iter(state_template.params.values())).device
        opt_state = OptState(count=saved["opt_state"]["count"], mu=o.mu, nu=o.nu,
                             grad_norm=None if norm is None else norm.to(device))
        return TrainState(params=state_template.params, opt_state=opt_state, step=saved["step"])

    def load_metadata(self) -> Optional[dict]:
        if self._meta_path.exists():
            with open(self._meta_path) as f:
                return json.load(f)
        return None

    def wait(self) -> None:
        """Saving is synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open."""
