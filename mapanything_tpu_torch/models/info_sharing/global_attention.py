"""Multi-view global-attention transformer (the VGGT-style ablation trunk) of the port.

Counterpart of ``mapanything_tpu/models/info_sharing/global_attention.py``
(``GlobalAttentionTransformer``, :20-94); its ``remat`` (:33, :74-75: every
block rematerialised, full recompute) is ``blocks.set_remat(self_attention_blocks,
True)`` here. Every layer attends over all views'
tokens and the additional tokens; each view's tokens first get a row of a
``max_num_views_for_pe``-row sinusoid table (row 0 for view 0, the rows
``non_ref_view_pe_indices`` or 1..V-1 for the others). Parameter names follow
the reference (``proj_embed``, ``self_attention_blocks.N.*``, ``norm``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from mapanything_tpu_torch.models.blocks import LayerNorm, Linear, SelfAttentionBlock
from mapanything_tpu_torch.models.encoders.dense_rep import sinusoid_encoding_table


class GlobalAttentionTransformer(nn.Module):
    """(B, V, h, w, Cin) features and optional (B, T, Cin) tokens -> ((B, V, h, w, dim),
    the taps at ``indices``, the tokens' (B, T, dim) features or None)."""

    def __init__(
        self,
        input_embed_dim: int,
        depth: int = 24,
        dim: int = 768,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        max_num_views_for_pe: int = 1000,
        use_scalable_softmax: bool = False,
        use_entropy_scaling: bool = False,
        indices: Optional[Sequence[int]] = None,
        norm_intermediate: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dim = dim
        self.dtype = dtype
        self.max_num_views_for_pe = max_num_views_for_pe
        self.indices = tuple(indices or ())
        self.norm_intermediate = norm_intermediate
        if input_embed_dim != dim:
            self.proj_embed = Linear(input_embed_dim, dim, dtype=dtype, init="xavier")
        self.self_attention_blocks = nn.ModuleList(
            SelfAttentionBlock(dim, num_heads, mlp_ratio, qkv_bias=qkv_bias, use_scalable_softmax=use_scalable_softmax,
                               use_entropy_scaling=use_entropy_scaling, dtype=dtype)
            for _ in range(depth)
        )
        self.norm = LayerNorm(dim, dtype=dtype)

    def forward(
        self,
        features: torch.Tensor,
        additional_tokens: Optional[torch.Tensor] = None,
        non_ref_view_pe_indices: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, List[torch.Tensor], Optional[torch.Tensor]]:
        B, V, h, w, Cin = features.shape
        P = h * w
        T = 0 if additional_tokens is None else additional_tokens.shape[1]
        x = features.reshape(B, V * P, Cin)
        if additional_tokens is not None:
            x = torch.cat([x, additional_tokens.to(x.dtype)], dim=1)
        if hasattr(self, "proj_embed"):
            x = self.proj_embed(x)
        x = x.to(self.dtype)
        table = torch.from_numpy(sinusoid_encoding_table(self.max_num_views_for_pe, self.dim, 10000.0))
        if non_ref_view_pe_indices is None:
            non_ref_view_pe_indices = torch.arange(1, V)
        rows = torch.cat([torch.zeros(1, dtype=torch.int64), non_ref_view_pe_indices.to("cpu", torch.int64)])
        pe = table[rows].to(device=x.device, dtype=self.dtype).repeat_interleave(P, dim=0)
        x = torch.cat([x[:, : V * P] + pe, x[:, V * P:]], dim=1)
        intermediates = []
        for i, block in enumerate(self.self_attention_blocks):
            x = block(x)
            if i in self.indices:
                inter = self.norm(x) if self.norm_intermediate else x
                intermediates.append(inter[:, : V * P].reshape(B, V, h, w, self.dim))
        x = self.norm(x)
        view_features = x[:, : V * P].reshape(B, V, h, w, self.dim)
        return view_features, intermediates, (x[:, V * P:] if T else None)
