"""Model registry of the port: a model name -> its builder.

Counterpart of ``mapanything_tpu/models/registry.py`` (``register_model``,
``init_model`` and the builders of :28-244). ``init_model(name, device=None,
seed=0, **config)`` builds the model on ``device`` (CUDA unless it says
otherwise) with seeded random weights; the other keywords are config fields.
``mapanything``, ``mapanything_ablations`` (a scene representation's preset of
``MapAnythingConfig``) and ``modular_dust3r`` are ported. The baselines and the
models that wrap a bundle adjustment (``vggt``, ``moge``, ``moge_1``,
``moge_2``, ``pi3``, ``anycalib``, ``pow3r``, ``pow3r_ba``, ``must3r``,
``dust3r_ba``, ``metric_dust3r``, ``mast3r_sga``, ``vggsfm_tracker``) keep
their slots, which raise ``NotImplementedError`` until the port has them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from mapanything_tpu_torch.models.heads.adaptors import DenseAdaptorConfig, dense_components_for_scene_rep
from mapanything_tpu_torch.models.mapanything import MapAnything, MapAnythingConfig
from mapanything_tpu_torch.models.modular_dust3r import ModularDUSt3R, ModularDUSt3RConfig

MODEL_REGISTRY: Dict[str, Callable[..., Any]] = {}

# The ROADMAP queue items that bring the unported slots.
NOT_PORTED = "not ported yet: the baselines and bundle adjustment are ROADMAP.md section 1, items 3-4"


def register_model(name: str):
    def deco(fn):
        MODEL_REGISTRY[name] = fn
        return fn

    return deco


@register_model("mapanything")
def _build_mapanything(device=None, seed: int = 0, geometric_inputs: bool = False, **overrides):
    return MapAnything(MapAnythingConfig(**overrides), device=device, seed=seed, geometric_inputs=geometric_inputs)


@register_model("mapanything_ablations")
def _build_mapanything_ablations(scene_rep_type: str = "pointmap", device=None, seed: int = 0,
                                 geometric_inputs: bool = False, **overrides):
    """MapAnything with ``scene_rep_type`` and the dense adaptor's components for it."""
    cfg = MapAnythingConfig(
        scene_rep_type=scene_rep_type,
        dense_adaptor=DenseAdaptorConfig(
            components=dense_components_for_scene_rep(scene_rep_type),
            with_confidence=overrides.pop("with_confidence", True),
            with_mask=overrides.pop("with_mask", True),
        ),
        **overrides,
    )
    return MapAnything(cfg, device=device, seed=seed, geometric_inputs=geometric_inputs)


@register_model("modular_dust3r")
def _build_modular_dust3r(device=None, seed: int = 0, **overrides):
    return ModularDUSt3R(ModularDUSt3RConfig(**overrides), device=device, seed=seed)


def _not_ported(name: str):
    def build(**_):
        raise NotImplementedError(f"model {name!r} is {NOT_PORTED}")

    return build


for _name in ("vggt", "moge", "moge_1", "moge_2", "pi3", "anycalib", "pow3r", "pow3r_ba", "must3r", "dust3r_ba",
              "metric_dust3r", "mast3r_sga", "vggsfm_tracker"):
    register_model(_name)(_not_ported(_name))


def init_model(model_str: str, **model_config):
    """Build a model by registry name; ``KeyError`` for an unknown name."""
    if model_str not in MODEL_REGISTRY:
        raise KeyError(f"unknown model '{model_str}'; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[model_str](**model_config)
