"""Load a JAX MapAnything parameter tree into the port's modules.

The inverse of ``mapanything_tpu/utils/torch_convert.py`` for the modules of
the images-only slice. ``params`` is the ``["params"]`` tree of the JAX
package's ``init`` as nested mappings of arrays (numpy arrays, or anything
``np.asarray`` takes); nothing of JAX is imported here.

Rules: Dense kernels (in, out) are transposed to ``Linear`` weights
(out, in); conv kernels go from HWIO to OIHW; the ``StridedConvTranspose``
kernel (k, k, out, in) goes to ``ConvTranspose2d``'s (in, out, k, k) — the
same axis permutation; LayerNorm ``scale`` becomes ``weight``. Loading is
strict: a JAX leaf that no port parameter takes, or a port parameter that
no JAX leaf fills, raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import numpy as np
import torch
from torch import nn

from mapanything_tpu_torch.models.blocks import SelfAttentionBlock
from mapanything_tpu_torch.models.encoders.vit import ViTEncoder
from mapanything_tpu_torch.models.heads.dpt import (
    DPTFeature,
    DPTRegressionProcessor,
    StridedConvTranspose,
)
from mapanything_tpu_torch.models.heads.pose import MLPHead, PoseHead
from mapanything_tpu_torch.models.info_sharing.alternating import (
    AlternatingAttentionTransformer,
)
from mapanything_tpu_torch.models.mapanything import MapAnything


class _Leaves:
    """The JAX tree flattened to {"a/b/c": array}; ``take`` consumes a leaf."""

    def __init__(self, tree: Mapping):
        self.flat: Dict[str, np.ndarray] = {}
        self._flatten(tree, "")

    def _flatten(self, node, prefix):
        for key, value in node.items():
            path = f"{prefix}{key}"
            if isinstance(value, Mapping):
                self._flatten(value, path + "/")
            else:
                self.flat[path] = np.asarray(value, dtype=np.float32)

    def has(self, path: str) -> bool:
        return path in self.flat

    def take(self, path: str) -> np.ndarray:
        if path not in self.flat:
            raise KeyError(f"JAX parameter {path!r} is missing")
        return self.flat.pop(path)


def _join(prefix: str, name: str) -> str:
    return f"{prefix}/{name}" if prefix else name


def _dense(P: _Leaves, out: dict, jp: str, tp: str) -> None:
    out[tp + "weight"] = P.take(_join(jp, "kernel")).T
    if P.has(_join(jp, "bias")):
        out[tp + "bias"] = P.take(_join(jp, "bias"))


def _conv(P: _Leaves, out: dict, jp: str, tp: str) -> None:
    # HWIO -> OIHW; for the transposed conv (k, k, out, in) -> (in, out, k, k).
    out[tp + "weight"] = P.take(_join(jp, "kernel")).transpose(3, 2, 0, 1)
    if P.has(_join(jp, "bias")):
        out[tp + "bias"] = P.take(_join(jp, "bias"))


def _norm(P: _Leaves, out: dict, jp: str, tp: str) -> None:
    out[tp + "weight"] = P.take(_join(jp, "scale"))
    out[tp + "bias"] = P.take(_join(jp, "bias"))


def _block(P, out, jp, tp):
    j = lambda n: _join(jp, n)  # noqa: E731
    _norm(P, out, j("norm1"), tp + "norm1.")
    _dense(P, out, j("attn/qkv"), tp + "attn.qkv.")
    _dense(P, out, j("attn/proj"), tp + "attn.proj.")
    _norm(P, out, j("norm2"), tp + "norm2.")
    _dense(P, out, j("mlp/fc1"), tp + "mlp.fc1.")
    _dense(P, out, j("mlp/fc2"), tp + "mlp.fc2.")
    for ls in ("ls1", "ls2"):
        if P.has(j(f"{ls}/gamma")):
            out[tp + f"{ls}.gamma"] = P.take(j(f"{ls}/gamma"))


def _vit(P, out, jp, tp):
    j = lambda n: _join(jp, n)  # noqa: E731
    _conv(P, out, j("patch_embed"), tp + "patch_embed.proj.")
    out[tp + "cls_token"] = P.take(j("cls_token"))
    out[tp + "pos_embed"] = P.take(j("pos_embed"))
    i = 0
    while P.has(j(f"block_{i}/norm1/scale")):
        _block(P, out, j(f"block_{i}"), tp + f"blocks.{i}.")
        i += 1
    _norm(P, out, j("norm"), tp + "norm.")


def _trunk(P, out, jp, tp):
    j = lambda n: _join(jp, n)  # noqa: E731
    if P.has(j("proj_embed/kernel")):
        _dense(P, out, j("proj_embed"), tp + "proj_embed.")
    i = 0
    while P.has(j(f"block_{i}/norm1/scale")):
        _block(P, out, j(f"block_{i}"), tp + f"self_attention_blocks.{i}.")
        i += 1
    _norm(P, out, j("norm"), tp + "norm.")


_DPT_RESAMPLE = {0: "act_0_up4", 1: "act_1_up2", 3: "act_3_down2"}


def _dpt_feature(P, out, jp, tp):
    j = lambda n: _join(jp, n)  # noqa: E731
    for i in range(4):
        _conv(P, out, j(f"act_{i}_proj"), tp + f"input_process.{i}.0.0.")
        if i in _DPT_RESAMPLE:
            _conv(P, out, j(_DPT_RESAMPLE[i]), tp + f"input_process.{i}.0.1.")
        _conv(P, out, j(f"layer_{i}_rn"), tp + f"input_process.{i}.1.")
    for k in range(1, 5):
        rp = tp + f"scratch.refinenet{k}."
        _conv(P, out, j(f"refinenet{k}/out_conv"), rp + "out_conv.")
        for jax_unit, torch_unit in (("res_conf_unit1", "resConfUnit1"), ("res_conf_unit2", "resConfUnit2")):
            if P.has(j(f"refinenet{k}/{jax_unit}/conv1/kernel")):
                for conv in ("conv1", "conv2"):
                    _conv(P, out, j(f"refinenet{k}/{jax_unit}/{conv}"), rp + f"{torch_unit}.{conv}.")


def _dpt_regressor(P, out, jp, tp):
    j = lambda n: _join(jp, n)  # noqa: E731
    _conv(P, out, j("conv1"), tp + "conv1.")
    _conv(P, out, j("conv2_0"), tp + "conv2.0.")
    _conv(P, out, j("conv2_1"), tp + "conv2.2.")


def _pose_head(P, out, jp, tp):
    j = lambda n: _join(jp, n)  # noqa: E731
    _conv(P, out, j("proj"), tp + "proj.")
    i = 0
    while P.has(j(f"res_conv_{i}/res_conv1/kernel")):
        for name in ("head_skip", "res_conv1", "res_conv2", "res_conv3"):
            if P.has(j(f"res_conv_{i}/{name}/kernel")):
                _conv(P, out, j(f"res_conv_{i}/{name}"), tp + f"res_conv.{i}.{name}.")
        i += 1
    _dense(P, out, j("mlp_0"), tp + "more_mlps.0.")
    _dense(P, out, j("mlp_1"), tp + "more_mlps.2.")
    _dense(P, out, j("fc_t"), tp + "fc_t.")
    _dense(P, out, j("fc_rot"), tp + "fc_rot.")


def _mlp_head(P, out, jp, tp):
    j = lambda n: _join(jp, n)  # noqa: E731
    _dense(P, out, j("proj"), tp + "proj.")
    i = 0
    while P.has(j(f"mlp_{i}/kernel")):
        _dense(P, out, j(f"mlp_{i}"), tp + f"mlp.{i}.0.")
        i += 1
    _dense(P, out, j("output_proj"), tp + "output_proj.")


def _mapanything(P, out, jp, tp):
    out["scale_token"] = P.take("scale_token")
    _norm(P, out, "fusion_norm", "fusion_norm_layer.")
    _vit(P, out, "encoder", "encoder.model.")
    _trunk(P, out, "info_sharing", "info_sharing.")
    _dpt_feature(P, out, "dpt_feature_head", "dpt_feature_head.")
    _dpt_regressor(P, out, "dpt_regressor_head", "dpt_regressor_head.")
    _pose_head(P, out, "pose_head", "pose_head.")
    _mlp_head(P, out, "scale_head", "scale_head.")


_CONVERTERS: Dict[type, Callable] = {
    MapAnything: _mapanything,
    ViTEncoder: _vit,
    AlternatingAttentionTransformer: _trunk,
    SelfAttentionBlock: _block,
    DPTFeature: _dpt_feature,
    DPTRegressionProcessor: _dpt_regressor,
    StridedConvTranspose: _conv,
    PoseHead: _pose_head,
    MLPHead: _mlp_head,
}


def jax_params_to_state_dict(module: nn.Module, params: Mapping) -> Dict[str, torch.Tensor]:
    """The port state dict (fp32 CPU tensors) that a JAX tree maps to."""
    convert = _CONVERTERS.get(type(module))
    if convert is None:
        raise TypeError(f"no JAX parameter mapping for {type(module).__name__}")
    leaves = _Leaves(params)
    out: Dict[str, np.ndarray] = {}
    convert(leaves, out, "", "")
    if leaves.flat:
        raise KeyError(f"JAX parameters not used by {type(module).__name__}: {sorted(leaves.flat)}")
    return {k: torch.tensor(v) for k, v in out.items()}


def load_jax_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Fill ``module``'s parameters from a JAX tree, strictly; returns ``module``."""
    state = jax_params_to_state_dict(module, params)
    module.load_state_dict(state, strict=True)
    return module
