"""MAE-style transformer decoder head of the port (the RGB-prediction models).

Counterpart of ``mapanything_tpu/models/heads/mae.py``: ``sincos_2d_pos_embed``
(:22) and ``MAEGeneralDecoder`` (:38). Per-level linear embeddings of the
multi-level patch features, summed; the fixed 2D sin-cos position embedding;
``decoder_depth`` ViT blocks of ``decoder_embed_dim`` (16 heads of 32 at the
defaults: the fp32 D = 32 attention instances); the final norm and linear
prediction; the unpatchify to full resolution; an align-corners resize where
h·p differs from the image size. Channel-last (B, h, w, C) in, (B, H, W, C) out.

The head computes in ``dtype``, fp32 by default, whatever the model's dtype: the
JAX model builds it without a dtype. The torch converter of the JAX package has
no converter for this head, so its parameter names follow the JAX modules
(``embed_{i}``, ``decoder_block_{i}``, ``decoder_norm``, ``decoder_pred``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mapanything_tpu_torch.models.blocks import LayerNorm, Linear, SelfAttentionBlock
from mapanything_tpu_torch.models.heads.dpt import _resize_bilinear_align_corners


def sincos_2d_pos_embed(embed_dim: int, h: int, w: int) -> np.ndarray:
    """Fixed 2D sin-cos position embedding (h·w, embed_dim), MAE style, computed in
    float64 and returned as float32 (the y half, then the x half)."""
    if embed_dim % 4:
        raise ValueError(f"embed_dim {embed_dim} is not a multiple of 4")
    quarter = embed_dim // 4
    omega = 1.0 / (10000 ** (np.arange(quarter, dtype=np.float64) / quarter))
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")

    def enc(pos):
        out = np.einsum("n,d->nd", pos.reshape(-1).astype(np.float64), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    return np.concatenate([enc(gy), enc(gx)], axis=1).astype(np.float32)


class MAEGeneralDecoder(nn.Module):
    """Multi-level patch features -> per-pixel channels through a ViT decoder.

    ``input_dims`` are the channel counts of the feature levels, in the order the
    forward receives them; the forward takes a list of (B, h, w, C_i) and returns
    (B, H, W, output_dim) at ``output_shape_hw``.
    """

    def __init__(
        self,
        input_dims: Sequence[int],
        output_dim: int,
        patch_size: int = 14,
        decoder_embed_dim: int = 512,
        decoder_depth: int = 8,
        decoder_num_heads: int = 16,
        mlp_ratio: float = 4.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.input_dims = tuple(input_dims)
        self.output_dim = output_dim
        self.patch_size = patch_size
        self.decoder_embed_dim = decoder_embed_dim
        self.decoder_depth = decoder_depth
        self.dtype = dtype
        for i, c in enumerate(self.input_dims):
            setattr(self, f"embed_{i}", Linear(c, decoder_embed_dim, dtype=dtype))
        for i in range(decoder_depth):
            setattr(self, f"decoder_block_{i}", SelfAttentionBlock(
                decoder_embed_dim, decoder_num_heads, mlp_ratio=mlp_ratio, qkv_bias=True, dtype=dtype))
        self.decoder_norm = LayerNorm(decoder_embed_dim, eps=1e-6, dtype=dtype)
        self.decoder_pred = Linear(decoder_embed_dim, output_dim * patch_size * patch_size, dtype=dtype)
        self._pos_embed = {}  # (h, w, device) -> the fixed embedding, made once

    def pos_embed(self, h: int, w: int, device) -> torch.Tensor:
        key = (h, w, str(device))
        if key not in self._pos_embed:
            pe = torch.from_numpy(sincos_2d_pos_embed(self.decoder_embed_dim, h, w))
            self._pos_embed[key] = pe.to(device=device, dtype=self.dtype)
        return self._pos_embed[key]

    def forward(self, list_features: Sequence[torch.Tensor], output_shape_hw: Tuple[int, int]) -> torch.Tensor:
        if len(list_features) != len(self.input_dims):
            raise ValueError(f"{len(list_features)} feature levels given to a head of {len(self.input_dims)}")
        b, h, w, _ = list_features[0].shape
        x = sum(getattr(self, f"embed_{i}")(f.to(self.dtype)).reshape(b, h * w, self.decoder_embed_dim)
                for i, f in enumerate(list_features))
        x = x + self.pos_embed(h, w, x.device)
        for i in range(self.decoder_depth):
            x = getattr(self, f"decoder_block_{i}")(x)
        x = self.decoder_pred(self.decoder_norm(x))
        p, c = self.patch_size, self.output_dim
        # Unpatchify: (B, h·w, p·p·c) -> (B, h·p, w·p, c).
        x = x.reshape(b, h, w, p, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h * p, w * p, c)
        if (h * p, w * p) != tuple(output_shape_hw):
            x = _resize_bilinear_align_corners(x.permute(0, 3, 1, 2), output_shape_hw).permute(0, 2, 3, 1)
        return x
