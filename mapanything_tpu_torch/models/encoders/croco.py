"""CroCo ViT encoder with RoPE2D, and the plain patch embedder, of the port.

Counterpart of ``mapanything_tpu/models/encoders/croco.py``: ``CroCoEncoder``
(:24-77) and ``PatchEmbedder`` (:80-99). The JAX ``remat`` field (:35, :58-59:
every block rematerialised, full recompute) is ``blocks.set_remat(enc_blocks,
True)`` here. CroCo (the DUSt3R and MASt3R encoder) has no learned position
embedding: every block rotates q and k with RoPE2D (``ops.rope``) at the patch
grid's (y, x) positions. Parameter names are the DUSt3R release's, the ones
``convert_croco_encoder`` reads: ``patch_embed.proj``, ``enc_blocks.N.*`` and
``enc_norm``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mapanything_tpu_torch.models.blocks import Conv2d, LayerNorm, SelfAttentionBlock
from mapanything_tpu_torch.models.encoders.vit import PatchEmbed
from mapanything_tpu_torch.ops.rope import make_rope2d, patch_position_grid

MAX_ROPE_POSITION = 512  # the RoPE table's length: grids up to 512 patches a side


class CroCoEncoder(nn.Module):
    """RoPE2D ViT: images (B, H, W, 3) -> patch features (B, h, w, C) in ``dtype``,
    after the final LayerNorm; with ``return_layers``, (the listed blocks' outputs,
    each (B, h, w, C) before the norm, then the features)."""

    def __init__(
        self,
        patch_size: int = 16,
        embed_dim: int = 1024,
        depth: int = 24,
        num_heads: int = 16,
        mlp_ratio: float = 4.0,
        rope_freq: float = 100.0,
        dtype: torch.dtype = torch.float32,
        return_layers: Optional[Sequence[int]] = None,
    ):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.return_layers = None if return_layers is None else tuple(return_layers)
        rope = make_rope2d(rope_freq, MAX_ROPE_POSITION)
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype=dtype)
        self.enc_blocks = nn.ModuleList(
            SelfAttentionBlock(embed_dim, num_heads, mlp_ratio, qkv_bias=True, rope=rope, dtype=dtype)
            for _ in range(depth)
        )
        self.enc_norm = LayerNorm(embed_dim, dtype=dtype)

    def forward(self, images: torch.Tensor):
        B, H, W, _ = images.shape
        P = self.patch_size
        if H % P or W % P:
            raise ValueError(f"image {H}x{W} is not a multiple of the patch size {P}")
        h, w = H // P, W // P
        if max(h, w) > MAX_ROPE_POSITION:
            raise ValueError(f"a {h}x{w} patch grid exceeds the RoPE table of {MAX_ROPE_POSITION} positions")
        x = self.patch_embed(images.to(self.dtype))
        positions = patch_position_grid(B, h, w, device=x.device)
        take = set(self.return_layers or ())
        intermediates = []
        for i, block in enumerate(self.enc_blocks):
            x = block(x, positions)
            if i in take:
                intermediates.append(x.reshape(B, h, w, self.embed_dim))
        out = self.enc_norm(x).reshape(B, h, w, self.embed_dim)
        if self.return_layers is not None:
            return intermediates, out
        return out


class PatchEmbedder(nn.Module):
    """Plain conv patch embedding and LayerNorm (``proj``, ``norm``): images
    (B, H, W, 3) -> (B, h, w, C) in ``dtype``."""

    def __init__(self, patch_size: int = 14, embed_dim: int = 1024, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.proj = Conv2d(3, embed_dim, patch_size, stride=patch_size, dtype=dtype)
        self.norm = LayerNorm(embed_dim, dtype=dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = images.shape
        h, w = H // self.patch_size, W // self.patch_size
        x = self.proj(images.to(self.proj.compute_dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.norm(x).reshape(B, h, w, self.embed_dim)
