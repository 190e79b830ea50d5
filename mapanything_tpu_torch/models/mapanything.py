"""MapAnything of the port: multimodal N-view metric reconstruction.

Counterpart of ``mapanything_tpu/models/mapanything.py``: ``Views`` (:70),
``ModalityMasks``, ``full_modality_masks``, ``GeometricInputConfig`` and
``sample_modality_masks`` (:100-214), ``Predictions`` (:218),
``MapAnythingConfig`` with ``.small()`` (:244-358), ``MapAnything.__call__``
(:372-685) with its geometric branches (pose canonicalisation, ray and depth
encoders, depth sparsification, metric-scale tokens; :416-533), and
``assemble_scene_representation`` (:688-776), for every scene representation
(``SCENE_REPS``): ``pointmap``, ``raymap+depth``, ``raydirs+depth+pose``,
``raydirs+depth+rgb+pose``, ``campointmap+pose`` and
``pointmap+raydirs+depth+pose`` (whose global pointmap comes from the factored
rays, depth and pose under ``use_factored_predictions_for_global_pointmaps``).
The dense head is DPT (``dense_head_type="dpt"``), the linear unpatchify head
on the trunk's output (``"linear"``, JAX :640-648, ``heads/pose.LinearFeature``)
or one of the RGB-prediction models' list-consuming heads (JAX :622-638): the
MAE decoder (``"mae"``, ``heads/mae.py``) or the MoGe convolutional decoder
(``"moge"``, ``heads/moge_conv.py``), which alone accept
``use_raw_encoder_features_for_dpt`` (JAX :277, :589-594): the raw image-encoder
features in front of the four levels.
``MapAnythingConfig.head_chunk_size`` runs the dense head over consecutive
chunks of the B·V views (JAX :653-668), which bounds the head's activations
when many views are reconstructed at once.
The remat fields (JAX :312-329, :402-406, :562-566) rematerialise the encoder's
and the trunk's blocks (``blocks.set_remat``): the backward recomputes what a
policy does not keep, which bounds a train step's activations at many views;
``configure_remat`` switches them on a built model.

View parallelism (JAX :291, :560): inside a ``parallel.cp`` context the
views given are this rank's block of the group's views. The JAX package runs the whole batch as one SPMD
program, where the cross-view steps need no code; here they are collectives
that autograd differentiates: view 0's pose comes from the first rank by
broadcast, and the mean translation norm is an all-reduce.

Stages: the DINOv2 ViT encoder and the alternating trunk run in
``compute_dtype``; the DPT fusion pyramid follows ``dpt_fusion_dtype`` (or
``compute_dtype``); the regression decode, pose and scale heads and the
adaptors run in ``head_dtype`` (fp32 by default). Tensors are channel-last
(B, V, H, W, C) at the public boundary, as in the JAX package.

Top-level parameter names are the reference's (``encoder.model.*``,
``fusion_norm_layer``, ``scale_token``, ``info_sharing.*``,
``dpt_feature_head.*``, ``dpt_regressor_head.*``, ``pose_head.*``,
``scale_head.*``), so ``mapanything_tpu.utils.torch_convert`` reads them. The MAE,
MoGe and linear heads (``mae_head.*``, ``moge_head.*``, ``linear_head.*``), which
no converter reads, take the JAX modules' names.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, replace
from typing import Optional, Tuple, Union

import torch
from torch import nn

from mapanything_tpu_torch.geometry.camera import pointmap_from_rays_depth_pose
from mapanything_tpu_torch.geometry.normalization import (
    apply_log_to_norm,
    normalize_depth_using_non_zero_pixels,
    normalize_pose_translations,
    safe_norm,
)
from mapanything_tpu_torch.geometry.quaternion import relative_pose_quats_trans
from mapanything_tpu_torch.models.blocks import LayerNorm, init_params, set_remat
from mapanything_tpu_torch.models.encoders.dense_rep import (
    DenseRepresentationEncoder,
    GlobalRepresentationEncoder,
)
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
from mapanything_tpu_torch.models.heads.mae import MAEGeneralDecoder
from mapanything_tpu_torch.models.heads.moge_conv import MoGeConvFeature
from mapanything_tpu_torch.models.heads.pose import LinearFeature, MLPHead, PoseHead
from mapanything_tpu_torch.models.info_sharing.alternating import (
    AlternatingAttentionTransformer,
)
from mapanything_tpu_torch.parallel.cp import current_cp
from mapanything_tpu_torch.parallel.mesh import broadcast_from_first


GEOMETRIC_INPUTS = ("ray_directions", "depth_along_ray", "camera_pose_quats", "camera_pose_trans")


@dataclass
class Views:
    """Batched multi-view input, (B, V, ...) tensors; geometric inputs are optional.

    Poses are OpenCV-RDF cam2world with XYZW quaternions, in any world frame
    (the model re-expresses them in view 0's frame).
    """

    img: torch.Tensor  # (B, V, H, W, 3) normalised images
    ray_directions: Optional[torch.Tensor] = None  # (B, V, H, W, 3) unit, camera frame
    depth_along_ray: Optional[torch.Tensor] = None  # (B, V, H, W, 1)
    camera_pose_quats: Optional[torch.Tensor] = None  # (B, V, 4) XYZW
    camera_pose_trans: Optional[torch.Tensor] = None  # (B, V, 3)
    is_metric_scale: Optional[torch.Tensor] = None  # (B, V) bool


@dataclass
class ModalityMasks:
    """Per-(batch, view) input-modality decisions, each (B, V) bool.

    ``depth_scale_norm_all`` and ``pose_scale_norm_all`` hide the metric
    scale (True = hide); ``depth_sparsification_keep`` is an optional
    per-pixel keep mask (B, V, H, W, 1).
    """

    rgb: torch.Tensor
    ray_dirs: torch.Tensor
    depth: torch.Tensor
    cam: torch.Tensor
    depth_scale_norm_all: torch.Tensor
    pose_scale_norm_all: torch.Tensor
    depth_sparsification_keep: Optional[torch.Tensor] = None

    def to(self, device) -> "ModalityMasks":
        return ModalityMasks(**{
            f.name: None if getattr(self, f.name) is None else getattr(self, f.name).to(device)
            for f in fields(self)
        })


def full_modality_masks(
    batch: int,
    num_views: int,
    use_ray_dirs: bool = False,
    use_depth: bool = False,
    use_cam: bool = False,
    device: Union[str, torch.device, None] = "cpu",
) -> ModalityMasks:
    """Deterministic all-or-nothing masks, as inference sets them."""
    ones = torch.ones((batch, num_views), dtype=torch.bool, device=device)
    zeros = torch.zeros((batch, num_views), dtype=torch.bool, device=device)
    return ModalityMasks(
        rgb=ones,
        ray_dirs=ones if use_ray_dirs else zeros,
        depth=ones if use_depth else zeros,
        cam=ones if use_cam else zeros,
        depth_scale_norm_all=zeros,
        pose_scale_norm_all=zeros,
    )


@dataclass(frozen=True)
class GeometricInputConfig:
    """Modality-dropout probabilities (configs/model/task/*.yaml)."""

    overall_prob: float = 0.9
    dropout_prob: float = 0.05
    ray_dirs_prob: float = 0.5
    depth_prob: float = 0.5
    cam_prob: float = 0.5
    sparse_depth_prob: float = 0.5
    sparsification_removal_percent: float = 0.9
    depth_scale_norm_all_prob: float = 0.05
    pose_scale_norm_all_prob: float = 0.05
    rgb_dropout_prob: float = 0.0


def sample_modality_masks(
    generator: torch.Generator,
    batch: int,
    num_views: int,
    image_hw: Tuple[int, int],
    cfg: GeometricInputConfig,
    device: Union[str, torch.device, None] = "cpu",
) -> ModalityMasks:
    """Sample the train-time Bernoulli modality masks.

    Overall, ray, depth and camera probabilities are drawn per batch element
    and shared across views; dropout per (batch, view); views without RGB get
    rays and camera. Sparse depth is an iid keep mask, applied to the whole
    batch with probability ``sparse_depth_prob``. As in the JAX package, the
    depth- and pose-scale kill switches are drawn from one and the same
    uniform sample. The draws run on the CPU from ``generator`` and the masks
    then move to ``device``, so every device samples the same masks.
    """
    u = lambda *shape: torch.rand(shape, generator=generator)  # noqa: E731
    geo = (u(batch, 1) < cfg.overall_prob) & (u(batch, num_views) < 1.0 - cfg.dropout_prob)
    ray = (u(batch, 1) < cfg.ray_dirs_prob) & geo
    depth = (u(batch, 1) < cfg.depth_prob) & geo
    cam = (u(batch, 1) < cfg.cam_prob) & geo
    if cfg.rgb_dropout_prob > 0:
        rgb = u(batch, num_views) > cfg.rgb_dropout_prob
        rgb[:, 0] = True  # the reference view always has RGB
    else:
        rgb = torch.ones((batch, num_views), dtype=torch.bool)
    ray, cam = ray | ~rgb, cam | ~rgb
    scale_u = u(batch, num_views)
    keep = None
    if cfg.sparse_depth_prob > 0:
        use_sparse = bool(u() < cfg.sparse_depth_prob)
        keep_pix = u(batch, num_views, *image_hw, 1) > cfg.sparsification_removal_percent
        keep = keep_pix if use_sparse else torch.ones_like(keep_pix)
    return ModalityMasks(
        rgb=rgb,
        ray_dirs=ray,
        depth=depth,
        cam=cam,
        depth_scale_norm_all=scale_u < cfg.depth_scale_norm_all_prob,
        pose_scale_norm_all=scale_u < cfg.pose_scale_norm_all_prob,
        depth_sparsification_keep=keep,
    ).to(device)


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
    rgb: Optional[torch.Tensor] = None  # (B, V, H, W, 3) in [0, 1], rgb scene rep only
    ray_origins: Optional[torch.Tensor] = None  # metric, raymap+depth only


SCENE_REPS = ("pointmap", "raymap+depth", "raydirs+depth+pose", "raydirs+depth+rgb+pose", "campointmap+pose",
              "pointmap+raydirs+depth+pose")
DENSE_HEADS = ("dpt", "linear", "mae", "moge")
REMAT_FIELDS = ("remat", "encoder_remat", "trunk_remat", "remat_policy", "encoder_remat_policy", "trunk_remat_policy")
LIST_HEADS = ("mae", "moge")  # the heads that take the raw encoder features too


@dataclass(frozen=True)
class MapAnythingConfig:
    """Static architecture config (the ported subset of the JAX config)."""

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
    use_rand_idx_pe_for_non_reference_views: bool = True
    use_scalable_softmax: bool = False
    use_entropy_scaling: bool = False
    # heads
    dense_head_type: str = "dpt"
    dpt_feature_dim: int = 256
    dpt_layer_dims: Tuple[int, ...] = (96, 192, 384, 768)
    dpt_hooks: Tuple[int, ...] = (0, 1, 2, 3)
    pose_head_num_resconv: int = 2
    scene_rep_type: str = "raydirs+depth+pose"
    # pointmap+raydirs+depth+pose: the global pointmap from the factored rays, depth
    # and pose (True) or the predicted pointmap channels (False).
    use_factored_predictions_for_global_pointmaps: bool = True
    # The raw image-encoder output in front of the dense head's feature levels (the
    # feature-returner encoder preset); the list-consuming heads (mae, moge) only.
    use_raw_encoder_features_for_dpt: bool = False
    # adaptors
    dense_adaptor: DenseAdaptorConfig = field(default_factory=DenseAdaptorConfig)
    pose_adaptor: PoseAdaptorConfig = field(default_factory=PoseAdaptorConfig)
    scale_adaptor: ScaleAdaptorConfig = field(default_factory=ScaleAdaptorConfig)
    # execution (JAX's context_parallel_trunk has no counterpart: an active
    # parallel.cp context alone routes the trunk's global layers)
    compute_dtype: str = "float32"
    head_dtype: str = "float32"
    dpt_fusion_dtype: Optional[str] = None  # None follows compute_dtype
    # Views per chunk of the dense head (DPT feature head and regression
    # processor, or the MAE or MoGe head) over the B·V views; None, 0 or >= B·V
    # runs them at once.
    head_chunk_size: Optional[int] = None
    # Activation rematerialisation of the encoder's and the trunk's blocks (JAX
    # :312-329): ``remat`` for both, ``encoder_remat``/``trunk_remat`` per part (None
    # follows ``remat``); the policy (``blocks.resolve_remat_policy``: None recomputes
    # everything) likewise, per part.
    remat: bool = False
    encoder_remat: Optional[bool] = None
    trunk_remat: Optional[bool] = None
    remat_policy: Optional[str] = None
    encoder_remat_policy: Optional[str] = None
    trunk_remat_policy: Optional[str] = None

    def part_remat(self, part: str) -> Tuple[bool, Optional[str]]:
        """(remat, policy) of ``part``, "encoder" or "trunk": its own fields, else the
        model's (JAX :402-406, :562-566)."""
        remat, policy = getattr(self, f"{part}_remat"), getattr(self, f"{part}_remat_policy")
        return (self.remat if remat is None else remat), (self.remat_policy if policy is None else policy)

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
    """Images (+ rays, depth, poses) -> encoders -> fusion norm + scale token
    -> trunk -> heads -> scene rep.

    ``MapAnything(config, device=None, seed=0, geometric_inputs=False)``
    builds the model with seeded random weights (``init_params`` with a
    ``torch.Generator``) on ``device``: CUDA unless ``device`` says otherwise.
    ``geometric_inputs=True`` adds the six geometric encoders, as the JAX
    package creates them when it is initialised with geometric views; they
    are registered last, so the other weights do not depend on the flag.
    ``load_jax_params`` in ``mapanything_tpu_torch.utils.jax_params``
    replaces the weights with a JAX parameter tree.
    """

    def __init__(
        self,
        config: MapAnythingConfig,
        device: Union[str, torch.device, None] = None,
        seed: int = 0,
        geometric_inputs: bool = False,
    ):
        super().__init__()
        device = resolve_device(device)
        cfg = config
        if cfg.dense_head_type not in DENSE_HEADS:
            raise ValueError(f"invalid dense_head_type: {cfg.dense_head_type!r} (one of {DENSE_HEADS})")
        if cfg.use_raw_encoder_features_for_dpt and cfg.dense_head_type not in LIST_HEADS:
            raise ValueError(f"raw encoder features need a list-consuming head {LIST_HEADS}, "
                             f"not {cfg.dense_head_type!r}")
        if cfg.scene_rep_type not in SCENE_REPS:
            raise ValueError(f"invalid scene_rep_type: {cfg.scene_rep_type!r} (one of {SCENE_REPS})")
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
        self.fusion_dtype = fdt  # the dense head's inputs
        level_dims = (embed_dim,) + (cfg.info_sharing_dim,) * 3
        n_dense = cfg.dense_adaptor.num_channels
        if cfg.dense_head_type == "dpt":
            self.dpt_feature_head = DPTFeature(
                hooks=cfg.dpt_hooks,
                input_feature_dims=level_dims,
                layer_dims=cfg.dpt_layer_dims,
                feature_dim=cfg.dpt_feature_dim,
                dtype=fdt,
            )
            self.dpt_regressor_head = DPTRegressionProcessor(cfg.dpt_feature_dim, n_dense, dtype=hdt, feature_dtype=fdt)
        elif cfg.dense_head_type == "linear":  # fp32, on the trunk's output
            self.linear_head = LinearFeature(cfg.info_sharing_dim, n_dense, cfg.patch_size)
        else:  # fp32 whatever the model's dtype, as the JAX model builds them
            if cfg.use_raw_encoder_features_for_dpt:
                level_dims = (embed_dim,) + level_dims
            if cfg.dense_head_type == "mae":
                self.mae_head = MAEGeneralDecoder(level_dims, n_dense, patch_size=cfg.patch_size)
            else:
                self.moge_head = MoGeConvFeature(level_dims, n_dense)
        self.pose_head = PoseHead(
            cfg.info_sharing_dim, cfg.patch_size, cfg.pose_head_num_resconv, dtype=hdt
        )
        self.scale_head = MLPHead(cfg.info_sharing_dim, output_dim=1, dtype=hdt)
        self.geometric_inputs = geometric_inputs
        if geometric_inputs:
            P = cfg.patch_size
            # apply_pe=False: configs/model/task/default.yaml
            self.ray_dirs_encoder = DenseRepresentationEncoder(3, embed_dim, P, apply_pe=False)
            self.depth_encoder = DenseRepresentationEncoder(1, embed_dim, P, apply_pe=False)
            self.depth_scale_encoder = GlobalRepresentationEncoder(1, embed_dim)
            self.cam_rot_encoder = GlobalRepresentationEncoder(4, embed_dim)
            self.cam_trans_encoder = GlobalRepresentationEncoder(3, embed_dim)
            self.cam_trans_scale_encoder = GlobalRepresentationEncoder(1, embed_dim)
        self.configure_remat()
        init_params(self, torch.Generator().manual_seed(seed))
        self.to(device)

    def configure_remat(self, **fields) -> None:
        """Replace the config's remat fields (``remat``, ``encoder_remat``, ...) by
        ``fields`` and rematerialise the encoder's and the trunk's blocks as the config
        then says; the weights stay."""
        unknown = set(fields) - set(REMAT_FIELDS)
        if unknown:
            raise ValueError(f"not a remat field: {sorted(unknown)}")
        self.config = replace(self.config, **fields)
        set_remat(self.encoder.model.blocks, *self.config.part_remat("encoder"))
        set_remat(self.info_sharing.self_attention_blocks, *self.config.part_remat("trunk"))

    def init_tokens(self, generator: torch.Generator) -> None:
        nn.init.trunc_normal_(self.scale_token, 0.0, 0.02, -0.04, 0.04, generator=generator)

    @property
    def device(self) -> torch.device:
        return self.scale_token.device

    def forward(
        self,
        views: Views,
        masks: Optional[ModalityMasks] = None,
        deterministic: bool = True,
        non_ref_view_pe_indices: Optional[torch.Tensor] = None,
    ) -> Predictions:
        """The differentiable forward. ``masks`` None means every given
        modality is used (``full_modality_masks``). The model has no
        stochastic layer (drop-path rate 0), so ``deterministic`` changes
        nothing; it is kept for the JAX signature. Inference callers run it
        under ``torch.inference_mode()``. Inside a ``parallel.cp`` context
        the views and masks are this rank's block of the group's views,
        ``non_ref_view_pe_indices`` covers all of the group's views, and the
        predictions are those of this rank's views."""
        del deterministic
        cfg = self.config
        cp = current_cp()
        group = None if cp is None else cp.group
        dev = self.device
        given = [name for name in GEOMETRIC_INPUTS if getattr(views, name) is not None]
        if given and not self.geometric_inputs:
            raise ValueError(f"Views.{given[0]} given to a model built without geometric_inputs=True")
        img = views.img.to(dev, torch.float32)
        B, V, H, W, _ = img.shape
        h, w = H // cfg.patch_size, W // cfg.patch_size
        vit = self.encoder.model
        dtype = vit.dtype
        E = vit.embed_dim
        if masks is None:
            masks = full_modality_masks(
                B, V,
                use_ray_dirs=views.ray_directions is not None,
                use_depth=views.depth_along_ray is not None,
                use_cam=views.camera_pose_quats is not None,
                device=dev,
            )
        else:
            masks = masks.to(dev)
        per_view = lambda m: m[..., None, None, None]  # noqa: E731  (B, V) -> (B, V, 1, 1, 1)
        f32 = lambda x: x.to(dev, torch.float32)  # noqa: E731

        # 1. Image encoding; geometric encoding and the fusion run in fp32.
        rgb = masks.rgb
        enc_feats = vit((img * per_view(rgb)).reshape(B * V, H, W, 3)).reshape(B, V, h, w, E)
        feats = (enc_feats * per_view(rgb)).float()

        # 2. Poses re-expressed in view 0's frame.
        cam_mask = masks.cam
        pose_quats = f32(torch.tensor([0.0, 0.0, 0.0, 1.0])).expand(B, V, 4)
        pose_trans = torch.zeros((B, V, 3), device=dev)
        if views.camera_pose_quats is not None:
            q_all, t_all = f32(views.camera_pose_quats), f32(views.camera_pose_trans)
            q0, t0 = q_all[:, :1], t_all[:, :1]
            if group is not None:  # view 0 lives on the first rank
                q0, t0 = broadcast_from_first(q0, group), broadcast_from_first(t0, group)
            q_rel, t_rel = relative_pose_quats_trans(q0.expand_as(q_all), t0.expand_as(t_all), q_all, t_all)
            pose_quats = torch.where(cam_mask[..., None], q_rel, pose_quats)
            pose_trans = torch.where(cam_mask[..., None], t_rel, pose_trans)
        is_metric = (
            views.is_metric_scale.to(dev)
            if views.is_metric_scale is not None
            else torch.zeros((B, V), dtype=torch.bool, device=dev)
        )

        # 3. Ray directions.
        ray_mask = masks.ray_dirs
        if views.ray_directions is not None:
            rays = f32(views.ray_directions) * per_view(ray_mask)
            ray_feats = self.ray_dirs_encoder(rays.reshape(B * V, H, W, 3)).reshape(B, V, h, w, E)
            feats = feats + ray_feats * per_view(ray_mask)

        # 4. Depth: sparsified, normalised per view, log-compressed; plus the
        #    metric depth-scale token of metric samples.
        depth_mask = masks.depth
        if views.depth_along_ray is not None:
            depth = f32(views.depth_along_ray) * per_view(depth_mask)
            if masks.depth_sparsification_keep is not None:
                depth = depth * masks.depth_sparsification_keep
            depth_norm, depth_factor = normalize_depth_using_non_zero_pixels(
                depth.reshape(B * V, H, W, 1), return_norm_factor=True
            )
            depth_feats = self.depth_encoder(apply_log_to_norm(depth_norm)).reshape(B, V, h, w, E)
            feats = feats + depth_feats * per_view(depth_mask)
            metric_depth = is_metric & ~masks.depth_scale_norm_all & depth_mask
            log_factor = torch.log(depth_factor + 1e-8).reshape(B * V, 1)
            scale_feats = self.depth_scale_encoder(log_factor).reshape(B, V, E)
            scale_feats = scale_feats * depth_mask[..., None] * metric_depth[..., None]
            feats = feats + scale_feats[:, :, None, None, :]

        # 5. Camera rotation, translation and (metric samples) translation-scale tokens.
        if views.camera_pose_quats is not None:
            quat_feats = self.cam_rot_encoder(pose_quats.reshape(B * V, 4)).reshape(B, V, E)
            quat_feats = quat_feats * cam_mask[..., None]
            trans_scaled, trans_factor = normalize_pose_translations(pose_trans, True, group)
            trans_feats = self.cam_trans_encoder(trans_scaled.reshape(B * V, 3)).reshape(B, V, E)
            trans_feats = trans_feats * cam_mask[..., None]
            metric_pose = is_metric & ~masks.pose_scale_norm_all
            log_tf = torch.log(trans_factor + 1e-8)[:, None, None].expand(B, V, 1).reshape(B * V, 1)
            ts_feats = self.cam_trans_scale_encoder(log_tf).reshape(B, V, E)
            ts_feats = ts_feats * cam_mask[..., None] * metric_pose[..., None]
            feats = feats + (quat_feats + trans_feats + ts_feats)[:, :, None, None, :]

        feats = self.fusion_norm_layer(feats)
        scale_tokens = self.scale_token.expand(B, 1, E)

        # 6. Info sharing.
        final_feats, intermediates, token_feats = self.info_sharing(
            feats.to(dtype), scale_tokens, non_ref_view_pe_indices
        )

        # 7. Heads. Hook 0 takes the fused post-norm features (the trunk input); the
        #    raw encoder features, where the config asks, go in front of the levels. As
        #    in the JAX model, the pose head takes the fourth entry of the list, which
        #    is then the second intermediate of the trunk, not its output.
        levels = [feats, intermediates[0], intermediates[1], final_feats]
        if cfg.use_raw_encoder_features_for_dpt:
            levels = [enc_feats * per_view(rgb)] + levels
        dense_inputs = [x.to(self.fusion_dtype).reshape(B * V, h, w, x.shape[-1]) for x in levels]
        dense_raw = self._dense_head(dense_inputs, (H, W))
        pose_raw = self.pose_head(dense_inputs[3])
        scale_raw = self.scale_head(token_feats)

        # 8. Adaptors and scene-representation assembly, in fp32.
        dense_out = apply_dense_adaptor(dense_raw.float(), cfg.dense_adaptor)
        pose_out = apply_pose_adaptor(pose_raw.float(), cfg.pose_adaptor)
        scale = apply_scale_adaptor(scale_raw.float(), cfg.scale_adaptor).reshape(B)
        return assemble_scene_representation(cfg, dense_out, pose_out, scale, B, V, H, W)

    def _dense_head(self, dense_inputs, hw: Tuple[int, int]) -> torch.Tensor:
        """The dense head (the DPT feature head and regression processor, or the
        MAE or MoGe head) over all B·V views, or over consecutive chunks of
        ``head_chunk_size`` views, concatenated."""
        n, c = dense_inputs[0].shape[0], self.config.head_chunk_size
        kind = self.config.dense_head_type
        if kind == "dpt":
            run = lambda xs: self.dpt_regressor_head(self.dpt_feature_head(xs), hw)  # noqa: E731
        elif kind == "linear":
            run = lambda xs: self.linear_head(xs[-1])  # noqa: E731
        else:
            head = self.mae_head if kind == "mae" else self.moge_head
            run = lambda xs: head(xs, hw)  # noqa: E731
        if not c or c >= n:
            return run(dense_inputs)
        if c < 0 or n % c:
            raise ValueError(f"head_chunk_size={c} must divide B*V={n}")
        return torch.cat([run([x[i:i + c] for x in dense_inputs]) for i in range(0, n, c)])


def assemble_scene_representation(
    cfg: MapAnythingConfig, dense_out, pose_out, scale, B, V, H, W
) -> Predictions:
    """Decode adapted channels into the scene representation ``cfg.scene_rep_type``.

    Metric scaling applies to points, origins, depths and translations, not to
    directions, quaternions or colours.
    """
    rep = cfg.scene_rep_type
    if rep not in SCENE_REPS:
        raise ValueError(f"invalid scene_rep_type: {rep!r}")
    slices = cfg.dense_adaptor.component_slices()
    value = dense_out.value.reshape(B, V, H, W, -1)
    s_bv = scale[:, None, None, None, None]
    s_bv3 = scale[:, None, None]

    def comp(name):
        a, b = slices[name]
        return value[..., a:b]

    cam_trans = pose_out[..., :3].reshape(B, V, 3)
    cam_quats = pose_out[..., 3:7].reshape(B, V, 4)
    if rep == "pointmap":
        preds = Predictions(pts3d=comp("pointmap") * s_bv, metric_scaling_factor=scale)
    elif rep == "raymap+depth":
        origins, dirs, depth = comp("ray_origins"), comp("ray_directions"), comp("depth")
        preds = Predictions(
            pts3d=(origins + dirs * depth) * s_bv,
            ray_origins=origins * s_bv,
            ray_directions=dirs,
            depth_along_ray=depth * s_bv,
            metric_scaling_factor=scale,
        )
    else:
        if rep == "campointmap+pose":
            pts3d_cam = comp("pointmap")
            depth = safe_norm(pts3d_cam, dim=-1, keepdim=True)
            dirs = pts3d_cam / torch.clamp(depth, min=1e-12)
        else:
            dirs, depth = comp("ray_directions"), comp("depth")
            pts3d_cam = dirs * depth
        if rep == "pointmap+raydirs+depth+pose" and not cfg.use_factored_predictions_for_global_pointmaps:
            pts3d = comp("pointmap")
        else:
            pts3d = pointmap_from_rays_depth_pose(dirs, depth, cam_trans, cam_quats)
        preds = Predictions(
            pts3d=pts3d * s_bv,
            pts3d_cam=pts3d_cam * s_bv,
            ray_directions=dirs,
            depth_along_ray=depth * s_bv,
            cam_trans=cam_trans * s_bv3,
            cam_quats=cam_quats,
            metric_scaling_factor=scale,
            rgb=comp("rgb") if "rgb" in slices else None,
        )
    if dense_out.confidence is not None:
        preds.conf = dense_out.confidence.reshape(B, V, H, W)
    if dense_out.mask is not None:
        preds.non_ambiguous_mask = dense_out.mask.reshape(B, V, H, W) > 0.5
        preds.non_ambiguous_mask_logits = dense_out.logits.reshape(B, V, H, W)
    return preds
