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
view-dict wrapper. So are the optimisation-based baselines ``dust3r_ba`` (=
``metric_dust3r``), ``pow3r_ba`` and ``mast3r_sga`` (pairwise models with global
alignment), which also take their wrapper's options as keywords, and the learned
point tracker ``vggsfm_tracker``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from mapanything_tpu_torch.models import external
from mapanything_tpu_torch.models.heads.adaptors import DenseAdaptorConfig, dense_components_for_scene_rep
from mapanything_tpu_torch.models.mapanything import MapAnything, MapAnythingConfig
from mapanything_tpu_torch.models.modular_dust3r import ModularDUSt3R, ModularDUSt3RConfig
from mapanything_tpu_torch.models.modular_dust3r import small_config as small_dust3r_config

MODEL_REGISTRY: Dict[str, Callable[..., Any]] = {}


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


def _check_size(size: str) -> None:
    if size not in ("full", "small"):
        raise ValueError(f"size must be 'full' or 'small', got {size!r}")


def _baseline(config_cls, wrapper_cls):
    """A baseline's builder: ``size="small"`` takes the config's test preset."""

    def build(size: str = "full", device=None, seed: int = 0, **overrides):
        _check_size(size)
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


@register_model("vggsfm_tracker")
def _build_vggsfm_tracker(device=None, seed: int = 0):
    return external.VGGSfMTracker(device=device, seed=seed)


def _split(cls, kwargs: dict):
    """``kwargs`` split into the fields of the dataclass ``cls`` and the rest."""
    fields = {k: v for k, v in kwargs.items() if k in cls.__dataclass_fields__}
    return fields, {k: v for k, v in kwargs.items() if k not in fields}


@register_model("dust3r_ba")
def _build_dust3r_ba(size: str = "full", device=None, seed: int = 0, **kwargs):
    """DUSt3R with global alignment; config fields and the wrapper's options as keywords."""
    _check_size(size)
    cfg_kw, wrap_kw = _split(ModularDUSt3RConfig, kwargs)
    cfg = small_dust3r_config(**cfg_kw) if size == "small" else ModularDUSt3RConfig(**cfg_kw)
    return external.DUSt3RBAWrapper(cfg, device=device, seed=seed, **wrap_kw)


@register_model("metric_dust3r")
def _build_metric_dust3r(size: str = "full", device=None, seed: int = 0, **kwargs):
    """Metric DUSt3R: the same model and aligner (upstream differs in the checkpoint and
    the unbounded ``exp`` depth, ``ModularDUSt3RConfig``'s default)."""
    return _build_dust3r_ba(size=size, device=device, seed=seed, **kwargs)


@register_model("pow3r_ba")
def _build_pow3r_ba(size: str = "full", device=None, seed: int = 0, **kwargs):
    _check_size(size)
    cfg_kw, wrap_kw = _split(external.Pow3RConfig, kwargs)
    cfg = external.Pow3RConfig.small(**cfg_kw) if size == "small" else external.Pow3RConfig(**cfg_kw)
    return external.Pow3RBAWrapper(cfg, device=device, seed=seed, **wrap_kw)


@register_model("mast3r_sga")
def _build_mast3r_sga(size: str = "full", device=None, seed: int = 0, **kwargs):
    """MASt3R with sparse global alignment: the trunk's config fields, ``desc_dim`` and the
    wrapper's options as keywords."""
    _check_size(size)
    trunk_kw, rest = _split(ModularDUSt3RConfig, kwargs)
    cfg_kw, wrap_kw = _split(external.MASt3RConfig, rest)
    if size == "small":
        cfg = external.MASt3RConfig.small(**trunk_kw, **cfg_kw)
    else:
        cfg = external.MASt3RConfig(trunk=ModularDUSt3RConfig(**trunk_kw), **cfg_kw)
    return external.MASt3RSGAWrapper(cfg, device=device, seed=seed, **wrap_kw)


def init_model(model_str: str, **model_config):
    """Build a model by registry name; ``KeyError`` for an unknown name."""
    if model_str not in MODEL_REGISTRY:
        raise KeyError(f"unknown model '{model_str}'; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[model_str](**model_config)
