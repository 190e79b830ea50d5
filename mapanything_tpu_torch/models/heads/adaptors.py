"""Output adaptors of the port: raw head channels -> geometric quantities.

Counterpart of ``mapanything_tpu/models/heads/adaptors.py``: the configs,
``apply_dense_adaptor`` (:229), ``apply_pose_adaptor`` (:279),
``apply_scale_adaptor`` (:293) and ``dense_components_for_scene_rep``
(:308). Pure functions on channel-last tensors; run them in fp32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from mapanything_tpu_torch.geometry.normalization import safe_norm

INF = float("inf")


def _clip(x, vmin, vmax):
    if vmin == -INF and vmax == INF:
        return x
    return torch.clamp(x, vmin, vmax)


def _unit(x, eps=1e-8):
    return x / torch.clamp(safe_norm(x, dim=-1, keepdim=True), min=eps)


def _scale_distance(x, mode):
    """Keep the direction of (..., 3) vectors; map their length d to d² or exp(d) - 1."""
    d = safe_norm(x, dim=-1, keepdim=True)
    return _unit(x) * (torch.square(d) if mode == "square" else torch.expm1(d))


@dataclass(frozen=True)
class RangeConfig:
    mode: str = "linear"  # linear | square | exp | z_exp
    vmin: float = -INF
    vmax: float = INF


def adapt_scale(x, cfg: RangeConfig):
    """Linear, square or exp, then clip."""
    if cfg.mode == "linear":
        out = x
    elif cfg.mode == "square":
        out = torch.square(x)
    elif cfg.mode == "exp":
        out = torch.exp(x)
    else:
        raise ValueError(cfg.mode)
    return _clip(out, cfg.vmin, cfg.vmax)


adapt_depth = adapt_scale


def adapt_pointmap(x, cfg: RangeConfig):
    """Distance-space scaling of (..., 3) points."""
    if cfg.mode == "linear":
        out = x
    elif cfg.mode in ("square", "exp"):
        out = _scale_distance(x, cfg.mode)
    elif cfg.mode == "z_exp":
        z = torch.exp(x[..., 2:3])
        out = torch.cat([x[..., :2] * z, z], dim=-1)
    else:
        raise ValueError(cfg.mode)
    return _clip(out, cfg.vmin, cfg.vmax)


def adapt_cam_translation(x, cfg: RangeConfig):
    """Camera translation or ray origins: linear, or distance-space square/exp."""
    if cfg.mode == "linear":
        out = x
    elif cfg.mode in ("square", "exp"):
        out = _scale_distance(x, cfg.mode)
    else:
        raise ValueError(cfg.mode)
    return _clip(out, cfg.vmin, cfg.vmax)


@dataclass(frozen=True)
class RayDirsConfig:
    mode: str = "linear"
    normalize_to_unit_sphere: bool = True
    normalize_to_unit_image_plane: bool = False
    vmin: float = -INF
    vmax: float = INF
    clamp_min_of_z_dir: bool = False
    z_dir_min: float = 1.0


def adapt_ray_directions(x, cfg: RayDirsConfig):
    assert cfg.mode == "linear"
    out = _clip(x, cfg.vmin, cfg.vmax)
    if cfg.clamp_min_of_z_dir:
        out = torch.cat([out[..., :2], torch.clamp(out[..., 2:3], min=cfg.z_dir_min)], dim=-1)
    if cfg.normalize_to_unit_sphere:
        out = _unit(out)
    elif cfg.normalize_to_unit_image_plane:
        out = out / out[..., 2:3]
    return out


@dataclass(frozen=True)
class QuatsConfig:
    mode: str = "linear"
    normalize: bool = True
    vmin: float = -INF
    vmax: float = INF


def adapt_quaternions(x, cfg: QuatsConfig):
    """Clip, then normalise to unit length."""
    assert cfg.mode == "linear"
    out = _clip(x, cfg.vmin, cfg.vmax)
    return _unit(out) if cfg.normalize else out


@dataclass(frozen=True)
class ConfidenceConfig:
    confidence_type: str = "exp"
    vmin: float = 1.0
    vmax: float = INF


def adapt_confidence(x, cfg: ConfidenceConfig):
    """exp: vmin + exp(x), capped at vmax - vmin; sigmoid: vmin + sigmoid(x) (vmax - vmin)."""
    if cfg.confidence_type == "exp":
        e = torch.exp(x)
        if math.isfinite(cfg.vmax):
            e = torch.clamp(e, max=cfg.vmax - cfg.vmin)
        return cfg.vmin + e
    if cfg.confidence_type == "sigmoid":
        return torch.reciprocal(1 + torch.exp(-x)) * (cfg.vmax - cfg.vmin) + cfg.vmin
    raise ValueError(cfg.confidence_type)


def adapt_rgb(x):
    return (torch.tanh(x) + 1.0) * 0.5


def adapt_mask(x):
    """(sigmoid probabilities, raw logits)."""
    return torch.reciprocal(1 + torch.exp(-x)), x


@dataclass
class DenseAdaptorOutput:
    value: torch.Tensor  # (..., sum of component channels)
    confidence: Optional[torch.Tensor] = None  # (..., 1)
    mask: Optional[torch.Tensor] = None  # (..., 1) sigmoid probabilities
    logits: Optional[torch.Tensor] = None  # (..., 1) raw mask logits


@dataclass(frozen=True)
class DenseAdaptorConfig:
    """Ordered value components, then optional confidence and mask channels."""

    components: Tuple[str, ...] = ("ray_directions", "depth")
    with_confidence: bool = True
    with_mask: bool = True
    ray_dirs: RayDirsConfig = field(default_factory=RayDirsConfig)
    depth: RangeConfig = field(default_factory=lambda: RangeConfig("exp", 0.0, INF))
    pointmap: RangeConfig = field(default_factory=lambda: RangeConfig("linear"))
    cam_translation: RangeConfig = field(default_factory=lambda: RangeConfig("linear"))
    quaternions: QuatsConfig = field(default_factory=QuatsConfig)
    confidence: ConfidenceConfig = field(default_factory=ConfidenceConfig)

    _CHANNELS = {
        "pointmap": 3,
        "ray_origins": 3,
        "ray_directions": 3,
        "depth": 1,
        "rgb": 3,
        "cam_translation": 3,
        "quaternions": 4,
    }

    @property
    def num_value_channels(self) -> int:
        return sum(self._CHANNELS[c] for c in self.components)

    @property
    def num_channels(self) -> int:
        return self.num_value_channels + int(self.with_confidence) + int(self.with_mask)

    def component_slices(self):
        out, start = {}, 0
        for c in self.components:
            n = self._CHANNELS[c]
            out[c] = (start, start + n)
            start += n
        return out


def apply_dense_adaptor(x: torch.Tensor, cfg: DenseAdaptorConfig) -> DenseAdaptorOutput:
    """Per-component activations over raw channels: values, confidence, mask."""
    assert x.shape[-1] == cfg.num_channels, f"expected {cfg.num_channels} channels, got {x.shape[-1]}"
    values = []
    start = 0
    for comp in cfg.components:
        n = cfg._CHANNELS[comp]
        xi = x[..., start : start + n]
        start += n
        if comp == "pointmap":
            values.append(adapt_pointmap(xi, cfg.pointmap))
        elif comp in ("ray_origins", "cam_translation"):
            values.append(adapt_cam_translation(xi, cfg.cam_translation))
        elif comp == "ray_directions":
            values.append(adapt_ray_directions(xi, cfg.ray_dirs))
        elif comp == "depth":
            values.append(adapt_depth(xi, cfg.depth))
        elif comp == "rgb":
            values.append(adapt_rgb(xi))
        elif comp == "quaternions":
            values.append(adapt_quaternions(xi, cfg.quaternions))
        else:
            raise ValueError(comp)
    out = DenseAdaptorOutput(value=torch.cat(values, dim=-1))
    if cfg.with_confidence:
        out.confidence = adapt_confidence(x[..., start : start + 1], cfg.confidence)
        start += 1
    if cfg.with_mask:
        out.mask, out.logits = adapt_mask(x[..., start : start + 1])
    return out


@dataclass(frozen=True)
class PoseAdaptorConfig:
    cam_translation: RangeConfig = field(default_factory=lambda: RangeConfig("linear"))
    quaternions: QuatsConfig = field(default_factory=QuatsConfig)


def apply_pose_adaptor(x: torch.Tensor, cfg: PoseAdaptorConfig) -> torch.Tensor:
    """(..., 7) raw [trans, quats] -> [trans, unit quats]."""
    trans = adapt_cam_translation(x[..., :3], cfg.cam_translation)
    quats = adapt_quaternions(x[..., 3:7], cfg.quaternions)
    return torch.cat([trans, quats], dim=-1)


@dataclass(frozen=True)
class ScaleAdaptorConfig:
    mode: str = "exp"
    vmin: float = 1e-8
    vmax: float = INF


def apply_scale_adaptor(x: torch.Tensor, cfg: ScaleAdaptorConfig) -> torch.Tensor:
    return adapt_scale(x, RangeConfig(cfg.mode, cfg.vmin, cfg.vmax))


_COMPONENTS_BY_SCENE_REP = {
    "pointmap": ("pointmap",),
    "raymap+depth": ("ray_origins", "ray_directions", "depth"),
    "raydirs+depth": ("ray_directions", "depth"),
    "raydirs+depth+pose": ("ray_directions", "depth"),
    "raydirs+depth+rgb+pose": ("ray_directions", "depth", "rgb"),
    "campointmap+pose": ("pointmap",),
    "pointmap+raydirs+depth+pose": ("pointmap", "ray_directions", "depth"),
}


def dense_components_for_scene_rep(scene_rep_type: str) -> Tuple[str, ...]:
    return _COMPONENTS_BY_SCENE_REP[scene_rep_type]
