"""Reference-format checkpoints into the port's model.

Counterpart of ``load_torch_state_dict`` (``mapanything_tpu/utils/torch_convert.py:233-242``)
and of the key handling at the head of ``convert_mapanything`` (:461-517). The
port keeps the reference's parameter names, so a reference state dict loads
with no tensor converted: ``module.`` (DDP) prefixes are stripped and the
``dense_head.0.`` / ``dense_head.1.`` aliases become ``dpt_feature_head.`` /
``dpt_regressor_head.``; then every key must match, strictly.
"""

from __future__ import annotations

import pickle
from os import PathLike
from typing import Dict, Mapping, Union

import torch
from torch import nn

from mapanything_tpu_torch.models.mapanything import MapAnything, MapAnythingConfig, resolve_device

_ALIASES = (("dense_head.0.", "dpt_feature_head."), ("dense_head.1.", "dpt_regressor_head."))
GEOMETRIC_ENCODERS = ("ray_dirs_encoder", "depth_encoder", "depth_scale_encoder", "cam_rot_encoder",
                      "cam_trans_encoder", "cam_trans_scale_encoder")


def load_reference_state_dict(path: Union[str, PathLike], trusted: bool = False) -> Dict[str, torch.Tensor]:
    """Read a ``.pth``/``.pt`` checkpoint to a state dict on the CPU, unwrapping a
    ``"model"`` entry and a pickled module. The file is read with
    ``weights_only=True``, which takes a released state dict (or one under a
    ``"model"`` entry) and runs no code. A file that holds other objects (a
    pickled module, a training checkpoint's extras) is unpickled in full only
    with ``trusted=True``, since unpickling can run arbitrary code."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        if not trusted:
            raise pickle.UnpicklingError(
                f"{path} holds more than tensors, and loading it in full can run arbitrary code; pass "
                "trusted=True (--trusted-checkpoint on the command line) only for a file you trust") from e
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    if hasattr(ckpt, "state_dict"):
        ckpt = ckpt.state_dict()
    return dict(ckpt)


def canonical_keys(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The state dict under the port's names: no ``module.`` prefix, no ``dense_head`` alias."""
    out = {}
    for key, value in state.items():
        if key.startswith("module."):
            key = key[len("module."):]
        for alias, name in _ALIASES:
            if key.startswith(alias):
                key = name + key[len(alias):]
        out[key] = value
    return out


def has_geometric_encoders(state: Mapping[str, torch.Tensor]) -> bool:
    """Whether a (canonical) state dict holds the six geometric input encoders:
    a model for it is built with ``geometric_inputs=True``."""
    return any(k.split(".", 1)[0] in GEOMETRIC_ENCODERS for k in state)


def model_from_reference(
    config: MapAnythingConfig,
    state: Mapping[str, torch.Tensor],
    device: Union[str, torch.device, None] = None,
) -> MapAnything:
    """The model of ``config`` holding a reference state dict, on ``device``
    (CUDA unless given), with the geometric encoders where the state dict has
    them. It is built on the meta device (no seeded initialisation, which the
    weights would overwrite), its storage allocated on ``device`` and every
    tensor of its state dict copied in by the strict loader."""
    state = canonical_keys(state)
    with torch.device("meta"):
        model = MapAnything(config, device="meta", geometric_inputs=has_geometric_encoders(state))
    covered = set(model.state_dict())
    if any(n not in covered for n, _ in [*model.named_parameters(), *model.named_buffers()]):
        raise RuntimeError("the model holds tensors outside its state dict; build it with MapAnything(...)")
    model.to_empty(device=resolve_device(device))
    return load_reference_checkpoint(model, state)


def load_reference_checkpoint(
    model: nn.Module, path_or_state: Union[str, PathLike, Mapping[str, torch.Tensor]], trusted: bool = False
) -> nn.Module:
    """Load a reference checkpoint (a file, read as ``load_reference_state_dict``
    reads it, or a state dict) into ``model`` in place, strictly: a missing or
    an extra key raises ``KeyError`` naming the keys, a shape mismatch raises
    ``ValueError`` naming the key. Values are cast to the model's dtypes and
    copied to its device."""
    state = (path_or_state if isinstance(path_or_state, Mapping)
             else load_reference_state_dict(path_or_state, trusted))
    state = canonical_keys(state)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"the checkpoint does not match the model: missing {missing}, not used {extra}")
    for key, target in own.items():
        if tuple(state[key].shape) != tuple(target.shape):
            raise ValueError(f"{key}: shape {tuple(state[key].shape)} in the checkpoint, {tuple(target.shape)} "
                             "in the model")
    with torch.no_grad():
        for key, target in own.items():
            target.copy_(state[key].to(target.dtype))
    return model
