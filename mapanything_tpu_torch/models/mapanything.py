"""MapAnything of the port: images-only N-view metric reconstruction.

Counterpart of ``mapanything_tpu/models/mapanything.py``: ``Views`` (:70),
``Predictions`` (:218), ``MapAnythingConfig`` with ``.small()`` (:244-358),
the images-only path of ``MapAnything.__call__`` (:372-685) and
``assemble_scene_representation`` (:688), for the DPT head and the
``raydirs+depth+pose`` scene representation.

Stages: the DINOv2 ViT encoder and the alternating trunk run in
``compute_dtype``; the DPT fusion pyramid follows ``dpt_fusion_dtype`` (or
``compute_dtype``); the regression decode, pose and scale heads and the
adaptors run in ``head_dtype`` (fp32 by default). Tensors are channel-last
(B, V, H, W, C) at the public boundary, as in the JAX package.

Top-level parameter names are the reference's (``encoder.model.*``,
``fusion_norm_layer``, ``scale_token``, ``info_sharing.*``,
``dpt_feature_head.*``, ``dpt_regressor_head.*``, ``pose_head.*``,
``scale_head.*``), so ``mapanything_tpu.utils.torch_convert`` reads them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple, Union

import torch
from torch import nn

from mapanything_tpu_torch.geometry.camera import pointmap_from_rays_depth_pose
from mapanything_tpu_torch.models.blocks import LayerNorm, init_params
from mapanything_tpu_torch.models.encoders.vit import ViTEncoder
from mapanything_tpu_torch.models.heads.adaptors import (
    DenseAdaptorConfig,
    PoseAdaptorConfig,
    ScaleAdaptorConfig,
    apply_dense_adaptor,
    apply_pose_adaptor,
    apply_scale_adaptor,
    dense_components_for_scene_rep,
)
from mapanything_tpu_torch.models.heads.dpt import DPTFeature, DPTRegressionProcessor
from mapanything_tpu_torch.models.heads.pose import MLPHead, PoseHead
from mapanything_tpu_torch.models.info_sharing.alternating import (
    AlternatingAttentionTransformer,
)


@dataclass
class Views:
    """Batched multi-view input, (B, V, ...) tensors.

    This slice takes images only; the geometric inputs exist so that a
    caller learns at once that they are not supported yet.
    """

    img: torch.Tensor  # (B, V, H, W, 3) normalised images
    ray_directions: Optional[torch.Tensor] = None  # (B, V, H, W, 3)
    depth_along_ray: Optional[torch.Tensor] = None  # (B, V, H, W, 1)
    camera_pose_quats: Optional[torch.Tensor] = None  # (B, V, 4) XYZW
    camera_pose_trans: Optional[torch.Tensor] = None  # (B, V, 3)


@dataclass
class Predictions:
    """Model outputs for all views, metric-scaled.

    Dense maps are (B, V, H, W, C); poses (B, V, 3|4); the scale (B,).
    """

    pts3d: torch.Tensor  # world frame (view 0), metric
    pts3d_cam: Optional[torch.Tensor] = None
    ray_directions: Optional[torch.Tensor] = None  # unit, camera frame
    depth_along_ray: Optional[torch.Tensor] = None  # metric
    cam_trans: Optional[torch.Tensor] = None  # metric, view-0 frame
    cam_quats: Optional[torch.Tensor] = None
    metric_scaling_factor: Optional[torch.Tensor] = None  # (B,)
    conf: Optional[torch.Tensor] = None  # (B, V, H, W)
    non_ambiguous_mask: Optional[torch.Tensor] = None  # (B, V, H, W) bool
    non_ambiguous_mask_logits: Optional[torch.Tensor] = None


@dataclass(frozen=True)
class MapAnythingConfig:
    """Static architecture config (the images-only subset of the JAX config)."""

    # encoder
    encoder_size: str = "large"
    patch_size: int = 14
    # info sharing
    info_sharing_depth: int = 24
    info_sharing_dim: int = 768
    info_sharing_num_heads: int = 12
    info_sharing_indices: Tuple[int, ...] = (11, 17)
    distinguish_ref_and_non_ref_views: bool = True
    use_pe_for_non_reference_views: bool = False
    max_num_views_for_pe: int = 1000
    use_scalable_softmax: bool = False
    use_entropy_scaling: bool = False
    # heads
    dense_head_type: str = "dpt"
    dpt_feature_dim: int = 256
    dpt_layer_dims: Tuple[int, ...] = (96, 192, 384, 768)
    dpt_hooks: Tuple[int, ...] = (0, 1, 2, 3)
    pose_head_num_resconv: int = 2
    scene_rep_type: str = "raydirs+depth+pose"
    # adaptors
    dense_adaptor: DenseAdaptorConfig = field(default_factory=DenseAdaptorConfig)
    pose_adaptor: PoseAdaptorConfig = field(default_factory=PoseAdaptorConfig)
    scale_adaptor: ScaleAdaptorConfig = field(default_factory=ScaleAdaptorConfig)
    # execution
    compute_dtype: str = "float32"
    head_dtype: str = "float32"
    dpt_fusion_dtype: Optional[str] = None  # None follows compute_dtype

    @property
    def dense_components(self) -> Tuple[str, ...]:
        return dense_components_for_scene_rep(self.scene_rep_type)

    @staticmethod
    def small(**kw) -> "MapAnythingConfig":
        """A small config for tests and CPU runs."""
        base = dict(
            encoder_size="small",
            patch_size=14,
            info_sharing_depth=4,
            info_sharing_dim=256,
            info_sharing_num_heads=4,
            info_sharing_indices=(1, 2),
            dpt_feature_dim=64,
            dpt_layer_dims=(32, 48, 64, 96),
        )
        base.update(kw)
        return MapAnythingConfig(**base)


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    Raises when CUDA is asked for (or implied) and there is none.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the port on the CPU")
    return device


class _ImageEncoder(nn.Module):
    """Holds the ViT as ``.model``, the reference wrapper's parameter prefix."""

    def __init__(self, model: ViTEncoder):
        super().__init__()
        self.model = model


class MapAnything(nn.Module):
    """Images -> encoder -> fusion norm + scale token -> trunk -> heads -> scene rep.

    ``MapAnything(config, device=None, seed=0)`` builds the model with seeded
    random weights (``init_params`` with a ``torch.Generator``) on ``device``:
    CUDA unless ``device`` says otherwise. ``load_jax_params`` in
    ``mapanything_tpu_torch.utils.jax_params`` replaces those weights with a
    JAX parameter tree.
    """

    def __init__(
        self,
        config: MapAnythingConfig,
        device: Union[str, torch.device, None] = None,
        seed: int = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        cfg = config
        if cfg.dense_head_type != "dpt":
            raise NotImplementedError(f"dense_head_type={cfg.dense_head_type!r}: only 'dpt' is ported")
        if cfg.scene_rep_type != "raydirs+depth+pose":
            raise NotImplementedError(
                f"scene_rep_type={cfg.scene_rep_type!r}: only 'raydirs+depth+pose' is ported"
            )
        if cfg.dense_adaptor.components != cfg.dense_components:
            raise ValueError("dense_adaptor.components must match scene_rep_type")
        self.config = cfg
        dtype = getattr(torch, cfg.compute_dtype)
        hdt = getattr(torch, cfg.head_dtype)
        fdt = getattr(torch, cfg.dpt_fusion_dtype or cfg.compute_dtype)

        vit = ViTEncoder(cfg.encoder_size, cfg.patch_size, dtype=dtype)
        embed_dim = vit.embed_dim
        self.encoder = _ImageEncoder(vit)
        self.fusion_norm_layer = LayerNorm(embed_dim)
        self.scale_token = nn.Parameter(torch.zeros(embed_dim))
        self.info_sharing = AlternatingAttentionTransformer(
            input_embed_dim=embed_dim,
            depth=cfg.info_sharing_depth,
            dim=cfg.info_sharing_dim,
            num_heads=cfg.info_sharing_num_heads,
            indices=cfg.info_sharing_indices,
            distinguish_ref_and_non_ref_views=cfg.distinguish_ref_and_non_ref_views,
            use_pe_for_non_reference_views=cfg.use_pe_for_non_reference_views,
            max_num_views_for_pe=cfg.max_num_views_for_pe,
            use_scalable_softmax=cfg.use_scalable_softmax,
            use_entropy_scaling=cfg.use_entropy_scaling,
            dtype=dtype,
        )
        self.dpt_feature_head = DPTFeature(
            hooks=cfg.dpt_hooks,
            input_feature_dims=(embed_dim,) + (cfg.info_sharing_dim,) * 3,
            layer_dims=cfg.dpt_layer_dims,
            feature_dim=cfg.dpt_feature_dim,
            dtype=fdt,
        )
        self.dpt_regressor_head = DPTRegressionProcessor(
            cfg.dpt_feature_dim, cfg.dense_adaptor.num_channels, dtype=hdt, feature_dtype=fdt
        )
        self.pose_head = PoseHead(
            cfg.info_sharing_dim, cfg.patch_size, cfg.pose_head_num_resconv, dtype=hdt
        )
        self.scale_head = MLPHead(cfg.info_sharing_dim, output_dim=1, dtype=hdt)
        init_params(self, torch.Generator().manual_seed(seed))
        self.to(device)
        self.eval()

    def init_tokens(self, generator: torch.Generator) -> None:
        nn.init.trunc_normal_(self.scale_token, 0.0, 0.02, -0.04, 0.04, generator=generator)

    @property
    def device(self) -> torch.device:
        return self.scale_token.device

    @torch.no_grad()
    def forward(
        self, views: Views, non_ref_view_pe_indices: Optional[torch.Tensor] = None
    ) -> Predictions:
        cfg = self.config
        for name in ("ray_directions", "depth_along_ray", "camera_pose_quats", "camera_pose_trans"):
            if getattr(views, name) is not None:
                raise NotImplementedError(f"Views.{name}: geometric inputs wait for the multimodal slice")
        img = views.img.to(self.device, torch.float32)
        B, V, H, W, _ = img.shape
        h, w = H // cfg.patch_size, W // cfg.patch_size
        vit = self.encoder.model
        dtype = vit.dtype

        # 1. Image encoding; the fusion runs in fp32.
        enc_feats = vit(img.reshape(B * V, H, W, 3)).reshape(B, V, h, w, vit.embed_dim)
        feats = self.fusion_norm_layer(enc_feats.float())
        scale_tokens = self.scale_token.expand(B, 1, vit.embed_dim)

        # 2. Info sharing.
        final_feats, intermediates, token_feats = self.info_sharing(
            feats.to(dtype), scale_tokens, non_ref_view_pe_indices
        )

        # 3. Heads. Hook 0 takes the fused post-norm features (the trunk input).
        fdt = self.dpt_feature_head.dtype
        dense_inputs = [
            x.to(fdt).reshape(B * V, h, w, x.shape[-1])
            for x in (feats, intermediates[0], intermediates[1], final_feats)
        ]
        dense_raw = self.dpt_regressor_head(self.dpt_feature_head(dense_inputs), (H, W))
        pose_raw = self.pose_head(dense_inputs[3])
        scale_raw = self.scale_head(token_feats)

        # 4. Adaptors and scene-representation assembly, in fp32.
        dense_out = apply_dense_adaptor(dense_raw.float(), cfg.dense_adaptor)
        pose_out = apply_pose_adaptor(pose_raw.float(), cfg.pose_adaptor)
        scale = apply_scale_adaptor(scale_raw.float(), cfg.scale_adaptor).reshape(B)
        return assemble_scene_representation(cfg, dense_out, pose_out, scale, B, V, H, W)


def assemble_scene_representation(
    cfg: MapAnythingConfig, dense_out, pose_out, scale, B, V, H, W
) -> Predictions:
    """Decode adapted channels into the factored metric scene representation.

    Metric scaling applies to points, depths and translations, not to
    directions or quaternions.
    """
    if cfg.scene_rep_type != "raydirs+depth+pose":
        raise NotImplementedError(f"scene_rep_type={cfg.scene_rep_type!r}")
    slices = cfg.dense_adaptor.component_slices()
    value = dense_out.value.reshape(B, V, H, W, -1)
    s_bv = scale[:, None, None, None, None]
    s_bv3 = scale[:, None, None]

    def comp(name):
        a, b = slices[name]
        return value[..., a:b]

    cam_trans = pose_out[..., :3].reshape(B, V, 3)
    cam_quats = pose_out[..., 3:7].reshape(B, V, 4)
    dirs = comp("ray_directions")
    depth = comp("depth")
    pts3d = pointmap_from_rays_depth_pose(dirs, depth, cam_trans, cam_quats)
    preds = Predictions(
        pts3d=pts3d * s_bv,
        pts3d_cam=dirs * depth * s_bv,
        ray_directions=dirs,
        depth_along_ray=depth * s_bv,
        cam_trans=cam_trans * s_bv3,
        cam_quats=cam_quats,
        metric_scaling_factor=scale,
    )
    if dense_out.confidence is not None:
        preds.conf = dense_out.confidence.reshape(B, V, H, W)
    if dense_out.mask is not None:
        preds.non_ambiguous_mask = dense_out.mask.reshape(B, V, H, W) > 0.5
        preds.non_ambiguous_mask_logits = dense_out.logits.reshape(B, V, H, W)
    return preds
