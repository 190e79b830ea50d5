"""RADIO image encoder of the port: CLIP input conditioning over the ViT.

Counterpart of ``mapanything_tpu/models/encoders/radio.py`` (``RADIOEncoder``,
:40-75). The version picks the ViT's size (``RADIO_EMBED_DIMS``; "huge", which
``VIT_SIZES`` lacks, builds "giant", as the JAX module does) and its patch (16;
14 for v2.5-g); images in [0, 1] are normalised with CLIP's statistics and pass
the ViT, whose position table is ``pos_embed_grid`` a side. The ViT sits under
``model.*``, the prefix of RADIO's torch-hub checkpoints that
``convert_radio_encoder`` strips.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mapanything_tpu_torch.models.encoders.vit import ViTEncoder

RADIO_EMBED_DIMS = {
    "radio_v2.5-b": "base",
    "radio_v2.5-l": "large",
    "radio_v2.5-h": "huge",
    "radio_v2.5-g": "giant",
    "e-radio_v2": "base",
}
_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class RADIOEncoder(nn.Module):
    """images (B, H, W, 3) in [0, 1] -> (B, h, w, C) spatial features (and the
    intermediates before them with ``return_layers``)."""

    def __init__(
        self,
        model_version: str = "radio_v2.5-l",
        patch_size: int = 16,
        pos_embed_grid: int = 37,
        return_layers: Optional[Sequence[int]] = None,
        size_override: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if model_version == "radio_v2.5-g" and patch_size != 14:
            raise ValueError("radio_v2.5-g uses patch 14")
        size = size_override or RADIO_EMBED_DIMS[model_version]
        if size == "huge":
            size = "giant"
        self.dtype = dtype
        self.model = ViTEncoder(size, patch_size, pos_embed_grid=pos_embed_grid, return_layers=return_layers,
                                dtype=dtype)

    def forward(self, images: torch.Tensor):
        mean = torch.tensor(_CLIP_MEAN, dtype=self.dtype, device=images.device)
        std = torch.tensor(_CLIP_STD, dtype=self.dtype, device=images.device)
        return self.model((images.to(self.dtype) - mean) / std)
