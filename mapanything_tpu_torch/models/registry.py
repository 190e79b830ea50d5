"""Model registry of the port: a model name -> its builder.

Counterpart of ``mapanything_tpu/models/registry.py`` (``register_model``,
``init_model`` and the builders of :28-244). ``init_model(name, device=None,
seed=0, **config)`` builds the model on ``device`` (CUDA unless it says
otherwise) with seeded random weights; the other keywords are config fields.
``mapanything``, ``mapanything_ablations`` (a scene representation's preset of
``MapAnythingConfig``) and ``modular_dust3r`` are ported, and so are the
feed-forward baselines ``vggt``, ``moge`` (= ``moge_1``), ``moge_2``, ``pi3``,
``anycalib``, ``must3r`` and ``pow3r``: each takes ``size="full"`` (the release's
widths) or ``"small"`` (the JAX package's test preset), and returns the model's
view-dict wrapper. The optimisation-based baselines and the tracker
(``dust3r_ba``, ``metric_dust3r``, ``pow3r_ba``, ``mast3r_sga``,
``vggsfm_tracker``) keep their slots, which raise ``NotImplementedError`` until
bundle adjustment is ported.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from mapanything_tpu_torch.models import external
from mapanything_tpu_torch.models.heads.adaptors import DenseAdaptorConfig, dense_components_for_scene_rep
from mapanything_tpu_torch.models.mapanything import MapAnything, MapAnythingConfig
from mapanything_tpu_torch.models.modular_dust3r import ModularDUSt3R, ModularDUSt3RConfig

MODEL_REGISTRY: Dict[str, Callable[..., Any]] = {}

# The ROADMAP queue item that brings the unported slots.
NOT_PORTED = "not ported yet: it comes with bundle adjustment, ROADMAP.md section 1, item 4"


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


def _baseline(config_cls, wrapper_cls):
    """A baseline's builder: ``size="small"`` takes the config's test preset."""

    def build(size: str = "full", device=None, seed: int = 0, **overrides):
        if size not in ("full", "small"):
            raise ValueError(f"size must be 'full' or 'small', got {size!r}")
        cfg = config_cls.small(**overrides) if size == "small" else config_cls(**overrides)
        return wrapper_cls(cfg, device=device, seed=seed)

    return build


for _names, _config, _wrapper in (
    (("vggt",), external.VGGTConfig, external.VGGTWrapper),
    (("moge", "moge_1"), external.MoGeConfig, external.MoGeWrapper),
    (("moge_2",), external.MoGe2Config, external.MoGe2Wrapper),
    (("pi3",), external.Pi3Config, external.Pi3Wrapper),
    (("anycalib",), external.AnyCalibConfig, external.AnyCalibWrapper),
    (("must3r",), external.MUSt3RConfig, external.MUSt3RWrapper),
    (("pow3r",), external.Pow3RConfig, external.Pow3RWrapper),
):
    for _name in _names:
        register_model(_name)(_baseline(_config, _wrapper))


def _not_ported(name: str):
    def build(**_):
        raise NotImplementedError(f"model {name!r} is {NOT_PORTED}")

    return build


for _name in ("pow3r_ba", "dust3r_ba", "metric_dust3r", "mast3r_sga", "vggsfm_tracker"):
    register_model(_name)(_not_ported(_name))


def init_model(model_str: str, **model_config):
    """Build a model by registry name; ``KeyError`` for an unknown name."""
    if model_str not in MODEL_REGISTRY:
        raise KeyError(f"unknown model '{model_str}'; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[model_str](**model_config)
