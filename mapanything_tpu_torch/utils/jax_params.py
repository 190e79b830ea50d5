"""Map a JAX MapAnything parameter tree onto the port's modules, and back.

The inverse of ``mapanything_tpu/utils/torch_convert.py``. ``param_map``
walks a port module and names, for each of its parameters, the JAX leaf
that holds it ("a/b/kernel") and how the layout differs; it needs no JAX
tree, so the optimizer reads the JAX rules (weight-decay mask, lr scales by
path) from it. ``jax_params_to_state_dict`` applies the map to a tree of
arrays: the ``["params"]`` tree of the JAX package's ``init``, or a gradient
tree of the same structure. Nothing of JAX is imported here.

Rules: Dense kernels (in, out) are transposed to ``Linear`` weights
(out, in); conv kernels go from HWIO to OIHW; the ``StridedConvTranspose``
kernel (k, k, out, in) goes to ``ConvTranspose2d``'s (in, out, k, k) — the
same axis permutation, as does the MoGe head's ``ConvTranspose`` with
``transpose_kernel=True``; LayerNorm and GroupNorm ``scale`` become ``weight``;
every other leaf keeps its shape. Loading is strict: a JAX leaf that no port
parameter takes, or a port parameter that no JAX leaf fills, raises.

The RGB-prediction heads (``mae_head``, ``moge_head``) and the linear head
(``linear_head``) have no torch converter in the JAX package, so no reference
torch names exist for them: the port names their parameters after the JAX
modules, and the map is one to one.

The DUSt3R family (``ModularDUSt3R``, ``CroCoEncoder``,
``CrossAttentionTransformer``) keeps the DUSt3R release's names, those that
``convert_croco_encoder`` and ``convert_modular_dust3r`` read: ``patch_embed.proj``
(JAX ``encoder/patch_embed``), ``enc_blocks.N`` (``encoder/block_N``), ``enc_norm``
(``encoder/norm``), ``decoder_embed`` (``decoder/proj_embed``), ``dec_blocks.N``
(``decoder/ref_block_N``), ``dec_blocks2.N`` (``decoder/nonref_block_N``), each
block's ``norm_y`` (``norm_mem``), ``dec_norm`` (``decoder/norm``). The converter
leaves the release's DPT heads unconverted, so ``ModularDUSt3R``'s heads keep the
JAX names, ``dpt_head_{0,1}`` and ``dpt_reg_{0,1}``. The RADIO ViT sits under the
torch-hub ``model.`` (JAX ``backbone``); the Cosmos encoder takes the tokenizer
release's names that ``convert_cosmos_encoder`` reads. The differential
attentions' RMS norm scale is ``subln.weight`` (JAX ``subln/scale``). The VGG19
perceptual tower keeps torchvision's ``features.{i}`` names, the indices that
``convert_vgg19_features`` reads, so a torchvision ``vgg19`` state dict loads
into it as it is.

The feed-forward baselines (``models/external``) take the release's names where a
``convert_*`` reads them, the JAX names elsewhere (each module's docstring lists
them). Two layouts serve them: "pointwise", a JAX 1x1 conv kernel (1, 1, in, out)
held by a release's Linear weight (out, in) (Pi3's and MUSt3R's ``proj`` heads), and
"lead_axis", a JAX token set held with the release's leading axis of one (VGGT's
camera and register tokens, Pi3's register tokens).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from mapanything_tpu_torch.models.blocks import (
    Attention,
    CrossAttention,
    CrossAttentionBlock,
    DiffAttention,
    DiffCrossAttention,
    SelfAttentionBlock,
)
from mapanything_tpu_torch.models.encoders.cosmos import CosmosEncoder
from mapanything_tpu_torch.models.encoders.croco import CroCoEncoder, PatchEmbedder
from mapanything_tpu_torch.models.encoders.dense_rep import (
    DenseRepresentationEncoder,
    GlobalRepresentationEncoder,
)
from mapanything_tpu_torch.models.encoders.radio import RADIOEncoder
from mapanything_tpu_torch.models.encoders.vit import ViTEncoder
from mapanything_tpu_torch.models.external import (
    VGGT,
    AnyCalibNet,
    AnyCalibWrapper,
    DUSt3RBAWrapper,
    MASt3RModel,
    MASt3RSGAWrapper,
    MoGe2Model,
    MoGe2Wrapper,
    MoGeModel,
    MoGeWrapper,
    MUSt3RModel,
    MUSt3RWrapper,
    Pi3,
    Pi3Wrapper,
    Pow3RBAWrapper,
    Pow3RModel,
    Pow3RWrapper,
    VGGSfMTracker,
    VGGTWrapper,
)
from mapanything_tpu_torch.models.heads.dpt import (
    DPTFeature,
    DPTRegressionProcessor,
    DPTSegmentationProcessor,
    StridedConvTranspose,
)
from mapanything_tpu_torch.models.heads.mae import MAEGeneralDecoder
from mapanything_tpu_torch.models.heads.moge_conv import MoGeConvFeature
from mapanything_tpu_torch.models.heads.pose import LinearFeature, MLPFeature, MLPHead, PoseHead
from mapanything_tpu_torch.models.info_sharing.alternating import (
    AlternatingAttentionTransformer,
)
from mapanything_tpu_torch.models.info_sharing.cross_attention import CrossAttentionTransformer
from mapanything_tpu_torch.models.info_sharing.global_attention import GlobalAttentionTransformer
from mapanything_tpu_torch.models.mapanything import MapAnything
from mapanything_tpu_torch.models.modular_dust3r import ModularDUSt3R
from mapanything_tpu_torch.models.perceptual import VGG19_CONV_INDICES, VGG19Features

# How a JAX leaf becomes the port's tensor, and the JAX leaf's rank where it
# differs from the port's ("copy" keeps the shape).
_LAYOUTS: Dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "dense": lambda x: x.T,
    "conv": lambda x: x.transpose(3, 2, 0, 1),
    "pointwise": lambda x: x[0, 0].T,  # a 1x1 conv kernel (1, 1, in, out) -> a Linear weight (out, in)
    "lead_axis": lambda x: x[None],  # a token set (n, ..., C) -> the release's (1, n, ..., C)
    "copy": lambda x: x,
}
_JAX_RANK = {"dense": 2, "conv": 4, "pointwise": 4}


class _Map:
    """The walk's state: the module's parameter names and the map built so far."""

    def __init__(self, module: nn.Module):
        self.order = [name for name, _ in module.named_parameters()]
        self.names = set(self.order)
        self.entries: Dict[str, Tuple[str, str]] = {}

    def has(self, torch_name: str) -> bool:
        return torch_name in self.names

    def add(self, torch_name: str, jax_path: str, layout: str = "copy") -> None:
        self.entries[torch_name] = (jax_path, layout)


def _join(prefix: str, name: str) -> str:
    return f"{prefix}/{name}" if prefix else name


def _dense(M: _Map, jp: str, tp: str, layout: str = "dense") -> None:
    M.add(tp + "weight", _join(jp, "kernel"), layout)
    if M.has(tp + "bias"):
        M.add(tp + "bias", _join(jp, "bias"))


def _conv(M: _Map, jp: str, tp: str) -> None:
    # HWIO -> OIHW; for the transposed conv (k, k, out, in) -> (in, out, k, k).
    _dense(M, jp, tp, "conv")


def _norm(M: _Map, jp: str, tp: str) -> None:
    M.add(tp + "weight", _join(jp, "scale"))
    M.add(tp + "bias", _join(jp, "bias"))


_LAMBDAS = ("lambda_q1", "lambda_k1", "lambda_q2", "lambda_k2")


def _attention(M, jp, tp, projections):
    """An attention's projections, its head-dim LayerNorms and, for the
    differential ones, the lambda vectors and the RMS norm ``subln``."""
    j = lambda n: _join(jp, n)  # noqa: E731
    for name in projections + ("proj",):
        _dense(M, j(name), tp + f"{name}.")
    for name in ("q_norm", "k_norm"):
        if M.has(tp + f"{name}.weight"):
            _norm(M, j(name), tp + f"{name}.")
    if M.has(tp + "subln.weight"):
        for name in _LAMBDAS:
            M.add(tp + name, j(name))
        M.add(tp + "subln.weight", j("subln/scale"))


def _block(M, jp, tp):
    j = lambda n: _join(jp, n)  # noqa: E731
    _norm(M, j("norm1"), tp + "norm1.")
    _attention(M, j("attn"), tp + "attn.", ("qkv",))
    _norm(M, j("norm2"), tp + "norm2.")
    _dense(M, j("mlp/fc1"), tp + "mlp.fc1.")
    _dense(M, j("mlp/fc2"), tp + "mlp.fc2.")
    for ls in ("ls1", "ls2"):
        if M.has(tp + f"{ls}.gamma"):
            M.add(tp + f"{ls}.gamma", j(f"{ls}/gamma"))


def _cross_block(M, jp, tp):
    """A ``CrossAttentionBlock``; the context's norm is JAX ``norm_mem``, CroCo's ``norm_y``."""
    j = lambda n: _join(jp, n)  # noqa: E731
    _norm(M, j("norm1"), tp + "norm1.")
    _attention(M, j("attn"), tp + "attn.", ("qkv",))
    if M.has(tp + "norm_y.weight"):
        _norm(M, j("norm_mem"), tp + "norm_y.")
    _norm(M, j("norm2"), tp + "norm2.")
    _attention(M, j("cross_attn"), tp + "cross_attn.", ("projq", "projk", "projv"))
    _norm(M, j("norm3"), tp + "norm3.")
    _dense(M, j("mlp/fc1"), tp + "mlp.fc1.")
    _dense(M, j("mlp/fc2"), tp + "mlp.fc2.")
    for ls in ("ls1", "ls2", "ls3"):
        if M.has(tp + f"{ls}.gamma"):
            M.add(tp + f"{ls}.gamma", j(f"{ls}/gamma"))


def _croco(M, jp, tp):
    j = lambda n: _join(jp, n)  # noqa: E731
    _conv(M, j("patch_embed"), tp + "patch_embed.proj.")
    i = 0
    while M.has(tp + f"enc_blocks.{i}.norm1.weight"):
        _block(M, j(f"block_{i}"), tp + f"enc_blocks.{i}.")
        i += 1
    _norm(M, j("norm"), tp + "enc_norm.")


def _patch_embedder(M, jp, tp):
    _conv(M, _join(jp, "proj"), tp + "proj.")
    _norm(M, _join(jp, "norm"), tp + "norm.")


def _cross_trunk(M, jp, tp):
    """``CrossAttentionTransformer``: CroCo's ``decoder_embed``, ``dec_blocks``
    (JAX ``ref_block_N``), ``dec_blocks2`` (``nonref_block_N``), ``dec_norm``."""
    j = lambda n: _join(jp, n)  # noqa: E731
    if M.has(tp + "decoder_embed.weight"):
        _dense(M, j("proj_embed"), tp + "decoder_embed.")
    for branch, jax_name in (("dec_blocks", "ref_block"), ("dec_blocks2", "nonref_block")):
        i = 0
        while M.has(tp + f"{branch}.{i}.norm1.weight"):
            _cross_block(M, j(f"{jax_name}_{i}"), tp + f"{branch}.{i}.")
            i += 1
    _norm(M, j("norm"), tp + "dec_norm.")


def _modular_dust3r(M, jp, tp):
    _croco(M, "encoder", "")
    _cross_trunk(M, "decoder", "")
    for b in range(2):
        _dpt_feature(M, f"dpt_head_{b}", f"dpt_head_{b}.")
        _dpt_regressor(M, f"dpt_reg_{b}", f"dpt_reg_{b}.")


def _mast3r(M, jp, tp):
    """MASt3R: ``ModularDUSt3R``'s names under the JAX ``trunk``, and the release's
    descriptor MLP ``downstream_head1.head_local_features`` (JAX ``desc_mlp1`` and the 1x1
    convolution ``desc_head/linear``)."""
    _croco(M, "trunk/encoder", "")
    _cross_trunk(M, "trunk/decoder", "")
    for b in range(2):
        _dpt_feature(M, f"trunk/dpt_head_{b}", f"dpt_head_{b}.")
        _dpt_regressor(M, f"trunk/dpt_reg_{b}", f"dpt_reg_{b}.")
    mlp = "downstream_head1.head_local_features."
    _dense(M, "desc_mlp1", mlp + "fc1.")
    _pointwise(M, "desc_head", mlp + "fc2.")


def _vit(M, jp, tp):
    j = lambda n: _join(jp, n)  # noqa: E731
    _conv(M, j("patch_embed"), tp + "patch_embed.proj.")
    M.add(tp + "cls_token", j("cls_token"))
    if M.has(tp + "register_tokens"):
        M.add(tp + "register_tokens", j("register_tokens"))
    M.add(tp + "pos_embed", j("pos_embed"))
    i = 0
    while M.has(tp + f"blocks.{i}.norm1.weight"):
        _block(M, j(f"block_{i}"), tp + f"blocks.{i}.")
        i += 1
    _norm(M, j("norm"), tp + "norm.")


def _trunk(M, jp, tp):
    j = lambda n: _join(jp, n)  # noqa: E731
    if M.has(tp + "proj_embed.weight"):
        _dense(M, j("proj_embed"), tp + "proj_embed.")
    i = 0
    while M.has(tp + f"self_attention_blocks.{i}.norm1.weight"):
        _block(M, j(f"block_{i}"), tp + f"self_attention_blocks.{i}.")
        i += 1
    _norm(M, j("norm"), tp + "norm.")


_DPT_RESAMPLE = {0: "act_0_up4", 1: "act_1_up2", 3: "act_3_down2"}


def _dpt_feature(M, jp, tp):
    j = lambda n: _join(jp, n)  # noqa: E731
    for i in range(4):
        _conv(M, j(f"act_{i}_proj"), tp + f"input_process.{i}.0.0.")
        if i in _DPT_RESAMPLE:
            _conv(M, j(_DPT_RESAMPLE[i]), tp + f"input_process.{i}.0.1.")
        _conv(M, j(f"layer_{i}_rn"), tp + f"input_process.{i}.1.")
    for k in range(1, 5):
        rp = tp + f"scratch.refinenet{k}."
        _conv(M, j(f"refinenet{k}/out_conv"), rp + "out_conv.")
        for jax_unit, torch_unit in (("res_conf_unit1", "resConfUnit1"), ("res_conf_unit2", "resConfUnit2")):
            if M.has(rp + f"{torch_unit}.conv1.weight"):
                for conv in ("conv1", "conv2"):
                    _conv(M, j(f"refinenet{k}/{jax_unit}/{conv}"), rp + f"{torch_unit}.{conv}.")


def _dpt_regressor(M, jp, tp):
    j = lambda n: _join(jp, n)  # noqa: E731
    _conv(M, j("conv1"), tp + "conv1.")
    _conv(M, j("conv2_0"), tp + "conv2.0.")
    _conv(M, j("conv2_1"), tp + "conv2.2.")


def _dpt_segmentation(M, jp, tp):
    _conv(M, _join(jp, "conv1"), tp + "conv1.")
    _conv(M, _join(jp, "conv2"), tp + "conv2.")


def _pose_head(M, jp, tp):
    j = lambda n: _join(jp, n)  # noqa: E731
    _conv(M, j("proj"), tp + "proj.")
    i = 0
    while M.has(tp + f"res_conv.{i}.res_conv1.weight"):
        for name in ("head_skip", "res_conv1", "res_conv2", "res_conv3"):
            if M.has(tp + f"res_conv.{i}.{name}.weight"):
                _conv(M, j(f"res_conv_{i}/{name}"), tp + f"res_conv.{i}.{name}.")
        i += 1
    _dense(M, j("mlp_0"), tp + "more_mlps.0.")
    _dense(M, j("mlp_1"), tp + "more_mlps.2.")
    _dense(M, j("fc_t"), tp + "fc_t.")
    _dense(M, j("fc_rot"), tp + "fc_rot.")


def _mlp_head(M, jp, tp):
    j = lambda n: _join(jp, n)  # noqa: E731
    _dense(M, j("proj"), tp + "proj.")
    i = 0
    while M.has(tp + f"mlp.{i}.0.weight"):
        _dense(M, j(f"mlp_{i}"), tp + f"mlp.{i}.0.")
        i += 1
    _dense(M, j("output_proj"), tp + "output_proj.")


def _dense_rep(M, jp, tp):
    j = lambda n: _join(jp, n)  # noqa: E731
    _conv(M, j("conv_in"), tp + "conv_in.")
    i = 0
    while M.has(tp + f"encoder.{i}.conv1.weight"):
        for conv in ("conv1", "conv2", "shortcut"):
            if M.has(tp + f"encoder.{i}.{conv}.weight"):
                _conv(M, j(f"res_{i}/{conv}"), tp + f"encoder.{i}.{conv}.")
        i += 1
    _conv(M, j("proj"), tp + f"encoder.{i}.")
    _norm(M, j("norm"), tp + "norm_layer.")
    if M.has(tp + "post_pe_norm.weight"):
        _norm(M, j("post_pe_norm"), tp + "post_pe_norm.")


def _global_rep(M, jp, tp):
    # The linears in registration order are fc_0 .. fc_{n-2}, then fc_out.
    linears = [n[: -len("weight")] for n in M.order if n.startswith(tp + "encoder.") and n.endswith(".weight")]
    for i, name in enumerate(linears):
        _dense(M, _join(jp, "fc_out" if i == len(linears) - 1 else f"fc_{i}"), name)
    _norm(M, _join(jp, "norm"), tp + "norm_layer.")


def _mae(M, jp, tp):
    j = lambda n: _join(jp, n)  # noqa: E731
    i = 0
    while M.has(tp + f"embed_{i}.weight"):
        _dense(M, j(f"embed_{i}"), tp + f"embed_{i}.")
        i += 1
    i = 0
    while M.has(tp + f"decoder_block_{i}.norm1.weight"):
        _block(M, j(f"decoder_block_{i}"), tp + f"decoder_block_{i}.")
        i += 1
    _norm(M, j("decoder_norm"), tp + "decoder_norm.")
    _dense(M, j("decoder_pred"), tp + "decoder_pred.")


def _moge(M, jp, tp):
    j = lambda n: _join(jp, n)  # noqa: E731
    i = 0
    while M.has(tp + f"project_{i}.weight"):
        _conv(M, j(f"project_{i}"), tp + f"project_{i}.")
        i += 1
    i = 0
    while M.has(tp + f"upsample_{i}_conv.weight"):
        _conv(M, j(f"upsample_{i}_deconv"), tp + f"upsample_{i}_deconv.")  # (k, k, out, in) -> (in, out, k, k)
        _conv(M, j(f"upsample_{i}_conv"), tp + f"upsample_{i}_conv.")
        k = 0
        while M.has(tp + f"res_{i}_{k}.conv1.weight"):
            rp, rj = tp + f"res_{i}_{k}.", f"res_{i}_{k}"
            _norm(M, j(f"{rj}/GroupNorm_0"), rp + "norm.")
            _conv(M, j(f"{rj}/conv1"), rp + "conv1.")
            _conv(M, j(f"{rj}/conv2"), rp + "conv2.")
            k += 1
        i += 1
    _conv(M, j("last_conv"), tp + "last_conv.")
    _conv(M, j("out_proj"), tp + "out_proj.")


def _linear_feature(M, jp, tp):
    _conv(M, _join(jp, "linear"), tp + "linear.")


def _mlp_feature(M, jp, tp):
    _dense(M, _join(jp, "mlp/fc1"), tp + "mlp.fc1.")
    _dense(M, _join(jp, "mlp/fc2"), tp + "mlp.fc2.")
    _linear_feature(M, _join(jp, "out"), tp + "out.")


def _radio(M, jp, tp):
    _vit(M, _join(jp, "backbone"), tp + "model.")


def _cosmos(M, jp, tp):
    """The tokenizer release's names (``encoder.down.L.block.j.*``, ...) against the
    JAX modules' (``res_L_j/GroupNorm_0``, ...), as ``convert_cosmos_encoder`` maps them."""
    j = lambda n: _join(jp, n)  # noqa: E731
    e = tp + "encoder."

    def res(jax_name, torch_prefix):
        for k, (norm, conv) in enumerate((("norm1", "conv1"), ("norm2", "conv2"))):
            _norm(M, j(f"{jax_name}/GroupNorm_{k}"), torch_prefix + f"{norm}.")
            _conv(M, j(f"{jax_name}/Conv_{k}"), torch_prefix + f"{conv}.")
        if M.has(torch_prefix + "nin_shortcut.weight"):
            _conv(M, j(f"{jax_name}/Conv_2"), torch_prefix + "nin_shortcut.")

    _conv(M, j("conv_in"), e + "conv_in.")
    level = 0
    while M.has(e + f"down.{level}.block.0.conv1.weight"):
        i = 0
        while M.has(e + f"down.{level}.block.{i}.conv1.weight"):
            res(f"res_{level}_{i}", e + f"down.{level}.block.{i}.")
            i += 1
        if M.has(e + f"down.{level}.downsample.conv.weight"):
            _conv(M, j(f"down_{level}"), e + f"down.{level}.downsample.conv.")
        level += 1
    res("mid_res1", e + "mid.block_1.")
    res("mid_res2", e + "mid.block_2.")
    _norm(M, j("mid_attn/GroupNorm_0"), e + "mid.attn_1.norm.")
    for name in ("q", "k", "v", "proj_out"):
        _conv(M, j(f"mid_attn/{name}"), e + f"mid.attn_1.{name}.")
    _norm(M, j("GroupNorm_0"), e + "norm_out.")
    _conv(M, j("conv_out"), e + "conv_out.")
    _conv(M, j("quant_conv"), tp + "quant_conv.")


def _vgg19(M, jp, tp):
    for i in VGG19_CONV_INDICES:
        _conv(M, _join(jp, f"conv{i}"), tp + f"features.{i}.")


def _pointwise(M, jp, tp):
    """A JAX ``LinearFeature``'s 1x1 conv (``linear``) held by the release's Linear ``proj``."""
    M.add(tp + "weight", _join(jp, "linear/kernel"), "pointwise")
    M.add(tp + "bias", _join(jp, "linear/bias"))


def _patch_embed(M, jp, tp):
    """A ViT backbone (DINOv2 names) or, with ``patch_embed="conv"``, its ``proj`` alone."""
    if M.has(tp + "proj.weight"):
        _conv(M, jp, tp + "proj.")
    else:
        _vit(M, jp, tp)


def _blocks(M, jp_fmt, tp_fmt, fn=None):
    i = 0
    while M.has(tp_fmt.format(i) + "norm1.weight"):
        (fn or _block)(M, jp_fmt.format(i), tp_fmt.format(i))
        i += 1


def _vggt(M, jp, tp):
    """VGGT: the release's names for the aggregator and the camera head, the JAX names
    (``depth_dpt``, ``depth_proc``) for the depth head."""
    _patch_embed(M, "aggregator/patch_embed", "aggregator.patch_embed.")
    if M.has("aggregator.patch_proj.weight"):
        _dense(M, "aggregator/patch_proj", "aggregator.patch_proj.")
    for name in ("camera_token", "register_token"):
        M.add(f"aggregator.{name}", f"aggregator/{name}", "lead_axis")
    for kind in ("frame", "global"):
        _blocks(M, f"aggregator/{kind}_block_{{}}", f"aggregator.{kind}_blocks.{{}}.")
    c = "camera_head"
    _norm(M, f"{c}/token_norm", f"{c}.token_norm.")
    _norm(M, f"{c}/trunk_norm", f"{c}.trunk_norm.")
    M.add(f"{c}.empty_pose_tokens", f"{c}/empty_pose_tokens")
    _dense(M, f"{c}/embed_pose", f"{c}.embed_pose.")
    _dense(M, f"{c}/poseLN_modulation", f"{c}.poseLN_modulation.1.")
    _blocks(M, f"{c}/trunk_{{}}", f"{c}.trunk.{{}}.")
    _dense(M, f"{c}/pose_branch/fc1", f"{c}.pose_branch.fc1.")
    _dense(M, f"{c}/pose_branch/fc2", f"{c}.pose_branch.fc2.")
    _dpt_feature(M, "depth_dpt", "depth_dpt.")
    _dpt_regressor(M, "depth_proc", "depth_proc.")


def _pi3(M, jp, tp):
    _patch_embed(M, "encoder", "encoder.")
    if M.has("patch_proj.weight"):
        _dense(M, "patch_proj", "patch_proj.")
    M.add("register_token", "register_token", "lead_axis")
    _blocks(M, "decoder_{}", "decoder.{}.")
    for head in ("point", "conf", "camera"):
        _dense(M, f"{head}_decoder/project", f"{head}_decoder.projects.")
        _blocks(M, f"{head}_decoder/block_{{}}", f"{head}_decoder.blocks.{{}}.")
        _dense(M, f"{head}_decoder/linear_out", f"{head}_decoder.linear_out.")
    _pointwise(M, "point_head", "point_head.proj.")
    _pointwise(M, "conf_head", "conf_head.proj.")
    i = 0
    while M.has(f"camera_head.res_conv.{i}.res_conv1.weight"):
        for k in (1, 2, 3):
            _dense(M, f"camera_head/res{i}_{k}", f"camera_head.res_conv.{i}.res_conv{k}.")
        i += 1
    _dense(M, "camera_head/mlp1", "camera_head.more_mlps.0.")
    _dense(M, "camera_head/mlp2", "camera_head.more_mlps.2.")
    _dense(M, "camera_head/fc_t", "camera_head.fc_t.")
    _dense(M, "camera_head/fc_rot", "camera_head.fc_rot.")


def _moge_1(M, jp, tp):
    """MoGe-1: the release's ``head.*`` names against the JAX ``head/*`` modules."""
    _vit(M, "backbone", "backbone.")
    i = 0
    while M.has(f"head.projects.{i}.weight"):
        _conv(M, f"head/project_{i}", f"head.projects.{i}.")
        i += 1
    i = 0
    while M.has(f"head.upsample_blocks.{i}.0.0.weight"):
        up = f"head.upsample_blocks.{i}."
        _conv(M, f"head/upsample_{i}", up + "0.0.")  # (k, k, out, in) -> (in, out, k, k)
        _conv(M, f"head/up_conv_{i}", up + "0.1.")
        for jax_name, index in (("gn1", 0), ("conv1", 2), ("gn2", 3), ("conv2", 5)):
            (_norm if jax_name.startswith("gn") else _conv)(M, f"head/up_res_{i}/{jax_name}", up + f"1.layers.{index}.")
        i += 1
    j = 0
    while M.has(f"head.output_block.{j}.0.weight"):
        _conv(M, f"head/out_conv_{j}", f"head.output_block.{j}.0.")
        _conv(M, f"head/out_proj_{j}", f"head.output_block.{j}.2.")
        j += 1


def _conv_stack(M, jp, tp):
    j = lambda n: _join(jp, n)  # noqa: E731
    i = 0
    while M.has(tp + f"in_{i}.weight"):
        _conv(M, j(f"in_{i}"), tp + f"in_{i}.")
        k = 0
        while M.has(tp + f"res_{i}_{k}.conv1.weight"):
            for name in ("gn_in", "conv1", "gn_hidden", "conv2"):
                (_norm if name.startswith("gn") else _conv)(M, j(f"res_{i}_{k}/{name}"), tp + f"res_{i}_{k}.{name}.")
            k += 1
        if M.has(tp + f"resample_{i}.weight"):
            _conv(M, j(f"resample_{i}"), tp + f"resample_{i}.")
        i += 1
    if M.has(tp + "out.weight"):
        _conv(M, j("out"), tp + "out.")


def _moge_2(M, jp, tp):
    _vit(M, "backbone", "backbone.")
    for name in ("neck", "points_head", "normal_head", "mask_head"):
        if M.has(f"{name}.in_0.weight"):
            _conv_stack(M, name, f"{name}.")
    for name in ("scale_hidden", "scale_head"):
        if M.has(f"{name}.weight"):
            _dense(M, name, f"{name}.")


def _anycalib(M, jp, tp):
    _patch_embed(M, "backbone", "backbone.")
    for name in ("dec_in", "up0", "up1", "dec_out"):
        _conv(M, name, f"{name}.")


def _must3r(M, jp, tp):
    """MUSt3R: the release's flat names against the JAX ``encoder``, ``decoder_embed``,
    ``decoder/dec_block_N``, ``decoder/dec_norm`` and ``head``."""
    _croco(M, "encoder", "")
    _dense(M, "decoder_embed", "decoder_embed.")
    _blocks(M, "decoder/dec_block_{}", "dec_blocks.{}.", _cross_block)
    _norm(M, "decoder/dec_norm", "dec_norm.")
    _pointwise(M, "head", "downstream_head.proj.")


def _pow3r(M, jp, tp):
    _conv(M, "patch_embed", "patch_embed.proj.")
    for name in ("patch_embed_rays", "patch_embed_depth"):
        _conv(M, name, f"{name}.")
    for name in ("patch_ln", "enc_norm", "dec1_pre_ln", "dec2_pre_ln", "dec_norm1", "dec_norm2"):
        _norm(M, name, f"{name}.")
    _blocks(M, "enc_block_{}", "enc_blocks.{}.")
    _dense(M, "decoder_embed", "decoder_embed.")
    M.add("cls_tokens", "cls_tokens")
    _dense(M, "pose_embed_hidden", "pose_embed.0.")
    _dense(M, "pose_embed_out", "pose_embed.2.")
    _blocks(M, "dec1_block_{}", "dec_blocks.{}.", _cross_block)
    _blocks(M, "dec2_block_{}", "dec_blocks2.{}.", _cross_block)
    _linear_feature(M, "head1", "head1.")
    _linear_feature(M, "head2", "head2.")


def _tracker_res_block(M, jp, tp):
    _conv(M, _join(jp, "conv1"), tp + "conv1.")
    _conv(M, _join(jp, "conv2"), tp + "conv2.")
    if M.has(tp + "downsample.0.weight"):
        _conv(M, _join(jp, "downsample"), tp + "downsample.0.")


def _tracker_mha(M, jp, tp):
    M.add(tp + "in_proj_weight", _join(jp, "in_proj_kernel"), "dense")
    M.add(tp + "in_proj_bias", _join(jp, "in_proj_bias"))
    _dense(M, _join(jp, "out_proj"), tp + "out_proj.")


def _tracker_block(M, jp, tp):
    """A tracker ``AttnBlock`` or ``CrossAttnBlock`` (its norms are non-affine but the
    context's)."""
    j = lambda n: _join(jp, n)  # noqa: E731
    if M.has(tp + "norm_context.weight"):
        _norm(M, j("norm_context"), tp + "norm_context.")
        _tracker_mha(M, j("cross_attn"), tp + "cross_attn.")
    else:
        _tracker_mha(M, j("attn"), tp + "attn.")
    _dense(M, j("mlp/fc1"), tp + "mlp.fc1.")
    _dense(M, j("mlp/fc2"), tp + "mlp.fc2.")


def _tracker_predictor(M, jp, tp):
    j = lambda n: _join(jp, n)  # noqa: E731
    u, tu = j("updateformer"), tp + "updateformer."
    _dense(M, _join(u, "input_transform"), tu + "input_transform.")
    _dense(M, _join(u, "flow_head"), tu + "flow_head.")
    if M.has(tu + "virual_tracks"):
        M.add(tu + "virual_tracks", _join(u, "virual_tracks"))
    for kind in ("time_blocks", "space_virtual_blocks", "space_point2virtual_blocks", "space_virtual2point_blocks"):
        i = 0
        while M.has(tu + f"{kind}.{i}.mlp.fc1.weight"):
            _tracker_block(M, _join(u, f"{kind}_{i}"), tu + f"{kind}.{i}.")
            i += 1
    _norm(M, j("norm"), tp + "norm.")
    _dense(M, j("ffeat_updater"), tp + "ffeat_updater.0.")
    if M.has(tp + "vis_predictor.0.weight"):
        _dense(M, j("vis_predictor"), tp + "vis_predictor.0.")


def _vggsfm_tracker(M, jp, tp):
    """The VGGSfM tracker: the reference ``TrackerPredictor``'s names against the JAX
    ``coarse_fnet/layer{i}_{j}``, ``fine_fnet/layer{i}``, ``*/time_blocks_{i}`` and the
    rest that ``convert_vggsfm_tracker`` writes."""
    _conv(M, "coarse_fnet/conv1", "coarse_fnet.conv1.")
    for li in range(1, 5):
        for bi in range(2):
            _tracker_res_block(M, f"coarse_fnet/layer{li}_{bi}", f"coarse_fnet.layer{li}.{bi}.")
    for name in ("conv2", "conv3"):
        _conv(M, f"coarse_fnet/{name}", f"coarse_fnet.{name}.")
    _conv(M, "fine_fnet/conv1", "fine_fnet.conv1.")
    for name in ("layer1", "layer2"):
        _tracker_res_block(M, f"fine_fnet/{name}", f"fine_fnet.{name}.")
    _conv(M, "fine_fnet/conv2", "fine_fnet.conv2.")
    _tracker_predictor(M, "coarse_predictor", "coarse_predictor.")
    _tracker_predictor(M, "fine_predictor", "fine_predictor.")


_DENSE_REP_ENCODERS = ("ray_dirs_encoder", "depth_encoder")
_GLOBAL_REP_ENCODERS = ("depth_scale_encoder", "cam_rot_encoder", "cam_trans_encoder", "cam_trans_scale_encoder")


def _mapanything(M, jp, tp):
    M.add("scale_token", "scale_token")
    _norm(M, "fusion_norm", "fusion_norm_layer.")
    _vit(M, "encoder", "encoder.model.")
    _trunk(M, "info_sharing", "info_sharing.")
    if M.has("mae_head.decoder_pred.weight"):
        _mae(M, "mae_head", "mae_head.")
    elif M.has("linear_head.linear.weight"):
        _linear_feature(M, "linear_head", "linear_head.")
    elif M.has("moge_head.out_proj.weight"):
        _moge(M, "moge_head", "moge_head.")
    else:
        _dpt_feature(M, "dpt_feature_head", "dpt_feature_head.")
        _dpt_regressor(M, "dpt_regressor_head", "dpt_regressor_head.")
    _pose_head(M, "pose_head", "pose_head.")
    _mlp_head(M, "scale_head", "scale_head.")
    for name in _DENSE_REP_ENCODERS:
        if M.has(f"{name}.conv_in.weight"):
            _dense_rep(M, name, f"{name}.")
    for name in _GLOBAL_REP_ENCODERS:
        if M.has(f"{name}.norm_layer.weight"):
            _global_rep(M, name, f"{name}.")


_CONVERTERS: Dict[type, Callable] = {
    MapAnything: _mapanything,
    ModularDUSt3R: _modular_dust3r,
    DUSt3RBAWrapper: _modular_dust3r,
    MASt3RModel: _mast3r,
    MASt3RSGAWrapper: _mast3r,
    ViTEncoder: _vit,
    CroCoEncoder: _croco,
    PatchEmbedder: _patch_embedder,
    RADIOEncoder: _radio,
    CosmosEncoder: _cosmos,
    AlternatingAttentionTransformer: _trunk,
    GlobalAttentionTransformer: _trunk,
    CrossAttentionTransformer: _cross_trunk,
    SelfAttentionBlock: _block,
    CrossAttentionBlock: _cross_block,
    Attention: lambda M, jp, tp: _attention(M, jp, tp, ("qkv",)),
    DiffAttention: lambda M, jp, tp: _attention(M, jp, tp, ("qkv",)),
    CrossAttention: lambda M, jp, tp: _attention(M, jp, tp, ("projq", "projk", "projv")),
    DiffCrossAttention: lambda M, jp, tp: _attention(M, jp, tp, ("projq", "projk", "projv")),
    LinearFeature: _linear_feature,
    MLPFeature: _mlp_feature,
    DPTFeature: _dpt_feature,
    DPTRegressionProcessor: _dpt_regressor,
    DPTSegmentationProcessor: _dpt_segmentation,
    MAEGeneralDecoder: _mae,
    MoGeConvFeature: _moge,
    VGG19Features: _vgg19,
    StridedConvTranspose: _conv,
    PoseHead: _pose_head,
    MLPHead: _mlp_head,
    DenseRepresentationEncoder: _dense_rep,
    GlobalRepresentationEncoder: _global_rep,
    VGGT: _vggt,
    VGGTWrapper: _vggt,
    Pi3: _pi3,
    Pi3Wrapper: _pi3,
    MoGeModel: _moge_1,
    MoGeWrapper: _moge_1,
    MoGe2Model: _moge_2,
    MoGe2Wrapper: _moge_2,
    AnyCalibNet: _anycalib,
    AnyCalibWrapper: _anycalib,
    MUSt3RModel: _must3r,
    MUSt3RWrapper: _must3r,
    Pow3RModel: _pow3r,
    Pow3RWrapper: _pow3r,
    Pow3RBAWrapper: _pow3r,
    VGGSfMTracker: _vggsfm_tracker,
}


def param_map(module: nn.Module) -> Dict[str, Tuple[str, str]]:
    """{port parameter name: (JAX leaf path "a/b/c", layout)} for every
    parameter of ``module``; layout is "dense", "conv" or "copy"."""
    convert = _CONVERTERS.get(type(module))
    if convert is None:
        raise TypeError(f"no JAX parameter mapping for {type(module).__name__}")
    M = _Map(module)
    convert(M, "", "")
    unmapped = M.names - set(M.entries)
    if unmapped:
        raise KeyError(f"port parameters without a JAX leaf: {sorted(unmapped)}")
    return {name: M.entries[name] for name in M.order}


def jax_leaf_rank(layout: str, port_param: torch.Tensor) -> int:
    """The rank of the JAX leaf behind a port parameter of this layout."""
    if layout == "lead_axis":
        return port_param.dim() - 1
    return _JAX_RANK.get(layout, port_param.dim())


def _flatten(tree: Mapping, prefix: str = "", out=None) -> Dict[str, np.ndarray]:
    out = {} if out is None else out
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            _flatten(value, path + "/", out)
        else:
            out[path] = np.asarray(value, dtype=np.float32)
    return out


def jax_params_to_state_dict(module: nn.Module, params: Mapping) -> Dict[str, torch.Tensor]:
    """The port state dict (fp32 CPU tensors) that a JAX tree maps to. The
    tree may be a parameter tree or a gradient tree of the same structure."""
    leaves = _flatten(params)
    out = {}
    for name, (path, layout) in param_map(module).items():
        if path not in leaves:
            raise KeyError(f"JAX parameter {path!r} is missing")
        out[name] = torch.tensor(np.ascontiguousarray(_LAYOUTS[layout](leaves.pop(path))))
    if leaves:
        raise KeyError(f"JAX parameters not used by {type(module).__name__}: {sorted(leaves)}")
    return out


def load_jax_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Fill ``module``'s parameters from a JAX tree, strictly; returns ``module``."""
    state = jax_params_to_state_dict(module, params)
    module.load_state_dict(state, strict=True)
    return module
