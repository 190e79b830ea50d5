"""DINOv2-style ViT image encoder of the port.

Counterpart of ``mapanything_tpu/models/encoders/vit.py``: ``VIT_SIZES``,
``interpolate_pos_embed`` (:110) and ``ViTEncoder`` (:142), with its register
tokens (:154-156, :206-216), ``return_layers`` (the intermediate-feature
variant, :218-283). The blocks' rematerialisation (``remat``, ``remat_policy``:
:157-158, :255-262) is ``blocks.set_remat(blocks, ...)``, which
``MapAnything.configure_remat`` calls; the ``scan_blocks`` branch is not ported.
Parameter names are those of the DINOv2 torch-hub model
(``patch_embed.proj``, ``cls_token``, ``register_tokens``, ``pos_embed``,
``blocks.N.*``, ``norm``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mapanything_tpu_torch.models.blocks import Conv2d, LayerNorm, SelfAttentionBlock

VIT_SIZES = {
    # name: (embed_dim, depth, num_heads)
    "test": (64, 4, 4),
    "small": (384, 12, 6),
    "base": (768, 12, 12),
    "large": (1024, 24, 16),
    "giant": (1536, 40, 24),
}


def interpolate_pos_embed(
    pos_embed: torch.Tensor, h: int, w: int, interpolate_offset: float = 0.1
) -> torch.Tensor:
    """Bicubic-resize a (1, N0, C) grid pos-embed to (1, h*w, C).

    DINOv2's ``interpolate_pos_encoding``: torch bicubic (A = -0.75, no
    antialias) with ``scale_factor = (n + 0.1) / g0``, which both sets the
    output size and maps the sample points.
    """
    n0 = pos_embed.shape[1]
    g0 = int(round(n0**0.5))
    if g0 * g0 != n0:
        raise ValueError(f"pos_embed length {n0} is not a square grid")
    if (g0, g0) == (h, w):
        return pos_embed
    c = pos_embed.shape[-1]
    grid = pos_embed.reshape(1, g0, g0, c).permute(0, 3, 1, 2)
    out = F.interpolate(
        grid,
        scale_factor=((h + interpolate_offset) / g0, (w + interpolate_offset) / g0),
        mode="bicubic",
        align_corners=False,
    )
    assert out.shape[-2:] == (h, w), out.shape
    return out.permute(0, 2, 3, 1).reshape(1, h * w, c)


class PatchEmbed(nn.Module):
    """Strided-conv patch embedding (DINOv2 ``patch_embed.proj``)."""

    def __init__(self, patch_size, embed_dim, dtype=torch.float32):
        super().__init__()
        self.proj = Conv2d(3, embed_dim, patch_size, stride=patch_size, dtype=dtype)

    def forward(self, images):  # (B, H, W, 3) -> (B, h*w, C)
        x = self.proj(images.permute(0, 3, 1, 2))
        return x.flatten(2).transpose(1, 2)


class ViTEncoder(nn.Module):
    """Plain ViT feature extractor with cls token, optional register tokens and
    learned pos embed.

    ``forward(images (B, H, W, 3))`` returns the normalised patch tokens as
    (B, H/P, W/P, C) in ``dtype``; with ``return_layers``, (the listed blocks'
    patch tokens, each (B, H/P, W/P, C) before the norm, then those).
    """

    def __init__(
        self,
        size: str = "large",
        patch_size: int = 14,
        pos_embed_grid: int = 37,
        init_values: float = 1e-5,
        num_register_tokens: int = 0,
        return_layers=None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        embed_dim, depth, num_heads = VIT_SIZES[size]
        self.embed_dim = embed_dim
        self.patch_size = patch_size
        self.dtype = dtype
        self.return_layers = None if return_layers is None else tuple(return_layers)
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        if num_register_tokens:
            self.register_tokens = nn.Parameter(torch.zeros(1, num_register_tokens, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_embed_grid * pos_embed_grid + 1, embed_dim))
        self.blocks = nn.ModuleList(
            SelfAttentionBlock(embed_dim, num_heads, 4.0, qkv_bias=True, init_values=init_values, dtype=dtype)
            for _ in range(depth)
        )
        self.norm = LayerNorm(embed_dim, dtype=dtype)

    def init_tokens(self, generator: torch.Generator) -> None:
        for p in (self.cls_token, self.pos_embed, getattr(self, "register_tokens", None)):
            if p is not None:
                nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04, generator=generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = images.shape
        P = self.patch_size
        assert H % P == 0 and W % P == 0, (H, W, P)
        h, w = H // P, W // P
        x = self.patch_embed(images)
        cls_pe, patch_pe = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        x = x + interpolate_pos_embed(patch_pe, h, w).to(self.dtype)
        tokens = [(self.cls_token + cls_pe).expand(B, 1, self.embed_dim).to(self.dtype)]
        if hasattr(self, "register_tokens"):
            tokens.append(self.register_tokens.expand(B, -1, -1).to(self.dtype))
        x = torch.cat(tokens + [x], dim=1)
        n_prefix = x.shape[1] - h * w
        take = set(self.return_layers or ())
        intermediates = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in take:
                intermediates.append(x[:, n_prefix:].reshape(B, h, w, self.embed_dim))
        x = self.norm(x)
        out = x[:, n_prefix:].reshape(B, h, w, self.embed_dim)
        if self.return_layers is not None:
            return intermediates, out
        return out
