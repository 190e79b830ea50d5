"""Multi-view cross-attention transformer (DUSt3R's decoder) of the port.

Counterpart of ``mapanything_tpu/models/info_sharing/cross_attention.py``
(``CrossAttentionTransformer``, :28-103). Each layer has a reference branch
(view 0) and a non-reference branch (every other view); each view's tokens
self-attend, then cross-attend over the other views' tokens concatenated (so
at V > 2 a view's context holds (V - 1)·P tokens), then pass the MLP. The taps
at ``indices`` and the output share the final LayerNorm. With
``differential=True`` the branches cross-attend through ``DiffCrossAttention``
at half the heads (the same per-head width) and the lambda schedule of their
layer.

Parameter names are the DUSt3R release's, the ones ``convert_modular_dust3r``
reads: ``decoder_embed`` (JAX ``proj_embed``), ``dec_blocks.N`` (the reference
branch, JAX ``ref_block_N``), ``dec_blocks2.N`` (the other views' branch, JAX
``nonref_block_N``) and ``dec_norm`` (JAX ``norm``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from mapanything_tpu_torch.models.blocks import CrossAttentionBlock, LayerNorm, Linear


class CrossAttentionTransformer(nn.Module):
    """(B, V, h, w, Cin) view features -> ((B, V, h, w, dim) normalised output, the
    normalised (or, without ``norm_intermediate``, raw) taps at ``indices``)."""

    def __init__(
        self,
        input_embed_dim: int,
        depth: int = 12,
        dim: int = 768,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        indices: Optional[Sequence[int]] = None,
        norm_intermediate: bool = True,
        differential: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if differential and num_heads % 2:
            raise ValueError("differential cross-attention needs an even num_heads")
        heads = num_heads // 2 if differential else num_heads
        self.dim = dim
        self.dtype = dtype
        self.indices = tuple(indices or ())
        self.norm_intermediate = norm_intermediate
        if input_embed_dim != dim:
            self.decoder_embed = Linear(input_embed_dim, dim, dtype=dtype, init="xavier")

        def branch():
            return nn.ModuleList(
                CrossAttentionBlock(dim, heads, mlp_ratio, qkv_bias=qkv_bias, differential=differential,
                                    layer_depth=layer, dtype=dtype)
                for layer in range(depth)
            )

        self.dec_blocks = branch()
        self.dec_blocks2 = branch()
        self.dec_norm = LayerNorm(dim, dtype=dtype)

    def forward(self, features: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        B, V, h, w, _ = features.shape
        P = h * w
        x = features.reshape(B, V, P, -1)
        if hasattr(self, "decoder_embed"):
            x = self.decoder_embed(x)
        views = list(x.to(self.dtype).unbind(1))
        intermediates = []
        for layer, (ref_block, other_block) in enumerate(zip(self.dec_blocks, self.dec_blocks2)):
            new_views = []
            for v in range(V):
                context = torch.cat([views[u] for u in range(V) if u != v], dim=1) if V > 1 else views[v]
                block = ref_block if v == 0 or V == 1 else other_block
                new_views.append(block(views[v], context))
            views = new_views
            if layer in self.indices:
                tap = torch.stack(views, dim=1)
                tap = self.dec_norm(tap) if self.norm_intermediate else tap
                intermediates.append(tap.reshape(B, V, h, w, self.dim))
        out = self.dec_norm(torch.stack(views, dim=1))
        return out.reshape(B, V, h, w, self.dim), intermediates
