"""Save and load a model in a hub-style local directory.

Counterpart of ``mapanything_tpu/utils/hub.py``: ``save_pretrained`` (:24) and
``from_pretrained`` (:39). ``config.json`` has the JAX package's schema,
``{"model_type": "mapanything", "config": asdict(config)}``, so a directory
the JAX package wrote builds the same
``MapAnythingConfig`` here. The weights are a torch state dict under the
reference's names in ``model.pt``, in place of orbax's directory.

The port's config is a subset of the JAX one. It reads and writes the six remat
fields (``remat``, ``encoder_remat``, ``trunk_remat`` and their policies). Of the JAX
fields it lacks, those that only say how JAX executes (``scan_layers``, the
context-parallel switch) are ignored; the others must hold the JAX default, since the
port builds only that.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Union

import torch

from mapanything_tpu_torch.models.heads.adaptors import (
    ConfidenceConfig,
    DenseAdaptorConfig,
    PoseAdaptorConfig,
    QuatsConfig,
    RangeConfig,
    RayDirsConfig,
    ScaleAdaptorConfig,
)
from mapanything_tpu_torch.models.mapanything import MapAnything, MapAnythingConfig
from mapanything_tpu_torch.utils.checkpoint import model_from_reference

WEIGHTS_NAME = "model.pt"
# JAX fields with no effect on what the model computes.
_EXECUTION_ONLY = ("context_parallel_trunk", "scan_layers")
# JAX fields the port does not have, with the only value it builds.
_FIXED = {"with_confidence": True, "with_mask": True}


def save_pretrained(model: MapAnything, directory) -> Path:
    """Write ``config.json`` and ``model.pt`` (the state dict on the CPU)."""
    directory = Path(directory).absolute()
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / "config.json", "w") as f:
        json.dump({"model_type": "mapanything", "config": dataclasses.asdict(model.config)}, f, indent=2, default=str)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, directory / WEIGHTS_NAME)
    return directory


def _num(x) -> float:
    return float("inf") if x == "inf" else (-float("inf") if x == "-inf" else float(x))


def _range(d) -> RangeConfig:
    return RangeConfig(d["mode"], _num(d["vmin"]), _num(d["vmax"]))


def _with_nums(cls, d, keys):
    return cls(**{k: (_num(v) if k in keys else v) for k, v in d.items()})


def config_from_dict(raw: dict) -> MapAnythingConfig:
    """``MapAnythingConfig`` from the ``"config"`` entry of a ``config.json``."""
    own = {f.name for f in dataclasses.fields(MapAnythingConfig)}
    for key, value in raw.items():
        if key in own or key in _EXECUTION_ONLY:
            continue
        if key not in _FIXED:
            raise ValueError(f"config.json: unknown field {key!r}")
        if value != _FIXED[key]:
            raise NotImplementedError(f"config.json: {key}={value!r} is not ported (only {_FIXED[key]!r})")
    d = raw["dense_adaptor"]
    dense = DenseAdaptorConfig(
        components=tuple(d["components"]),
        with_confidence=d["with_confidence"],
        with_mask=d["with_mask"],
        ray_dirs=_with_nums(RayDirsConfig, d["ray_dirs"], ("vmin", "vmax", "z_dir_min")),
        depth=_range(d["depth"]),
        pointmap=_range(d["pointmap"]),
        cam_translation=_range(d["cam_translation"]),
        quaternions=_with_nums(QuatsConfig, d["quaternions"], ("vmin", "vmax")),
        confidence=ConfidenceConfig(d["confidence"]["confidence_type"], _num(d["confidence"]["vmin"]),
                                    _num(d["confidence"]["vmax"])),
    )
    p, s = raw["pose_adaptor"], raw["scale_adaptor"]
    return MapAnythingConfig(
        **{k: (tuple(v) if isinstance(v, list) else v) for k, v in raw.items()
           if k in own and k not in ("dense_adaptor", "pose_adaptor", "scale_adaptor")},
        dense_adaptor=dense,
        pose_adaptor=PoseAdaptorConfig(cam_translation=_range(p["cam_translation"]),
                                       quaternions=_with_nums(QuatsConfig, p["quaternions"], ("vmin", "vmax"))),
        scale_adaptor=ScaleAdaptorConfig(s["mode"], _num(s["vmin"]), _num(s["vmax"])),
    )


def read_config(directory) -> MapAnythingConfig:
    with open(Path(directory) / "config.json") as f:
        return config_from_dict(json.load(f)["config"])


def from_pretrained(directory, device: Union[str, torch.device, None] = None, **overrides) -> MapAnything:
    """The model of a ``save_pretrained`` directory on ``device`` (CUDA unless
    given), its weights loaded strictly. ``overrides`` replace config fields
    (e.g. ``compute_dtype="bfloat16"``). The model holds its weights, so this
    returns the model alone (the JAX function returns a parameter tree beside it)."""
    cfg = dataclasses.replace(read_config(directory), **overrides)
    state = torch.load(Path(directory) / WEIGHTS_NAME, map_location="cpu", weights_only=True)
    return model_from_reference(cfg, state, device)
