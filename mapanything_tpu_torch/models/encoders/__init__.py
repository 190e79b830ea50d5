"""Encoder registry of the port: a family name -> its encoder class.

Counterpart of ``mapanything_tpu/models/encoders/__init__.py``
(``ENCODER_REGISTRY``, ``encoder_factory``): the seven families of the
reference's factory (croco, dinov2, radio, cosmos, patch_embedder,
dense_rep_encoder, global_rep_encoder) and "vit". Each class takes the
keyword arguments of its constructor.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from mapanything_tpu_torch.models.encoders.cosmos import CosmosEncoder
from mapanything_tpu_torch.models.encoders.croco import CroCoEncoder, PatchEmbedder
from mapanything_tpu_torch.models.encoders.dense_rep import (
    DenseRepresentationEncoder,
    GlobalRepresentationEncoder,
)
from mapanything_tpu_torch.models.encoders.radio import RADIOEncoder
from mapanything_tpu_torch.models.encoders.vit import ViTEncoder

ENCODER_REGISTRY: Dict[str, Callable[..., Any]] = {
    "vit": ViTEncoder,
    "dinov2": ViTEncoder,
    "croco": CroCoEncoder,
    "radio": RADIOEncoder,
    "cosmos": CosmosEncoder,
    "patch_embedder": PatchEmbedder,
    "dense_rep_encoder": DenseRepresentationEncoder,
    "global_rep_encoder": GlobalRepresentationEncoder,
}


def encoder_factory(encoder_str: str, **kwargs):
    """The encoder module of family ``encoder_str``; ``KeyError`` for an unknown name."""
    if encoder_str not in ENCODER_REGISTRY:
        raise KeyError(f"unknown encoder '{encoder_str}'; available: {sorted(ENCODER_REGISTRY)}")
    return ENCODER_REGISTRY[encoder_str](**kwargs)
