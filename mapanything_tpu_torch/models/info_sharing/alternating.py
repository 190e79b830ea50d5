"""Multi-view alternating-attention transformer of the port (the trunk).

Counterpart of ``AlternatingAttentionTransformer`` in
``mapanything_tpu/models/info_sharing/alternating.py`` (:115, unrolled
branch :255-303). Even layers attend over all views' tokens plus the
additional tokens (the scale token); odd layers attend within each view,
and the additional tokens skip them. Parameter names follow the reference
(``proj_embed``, ``self_attention_blocks.N.*``, ``norm``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from mapanything_tpu_torch.models.blocks import LayerNorm, Linear, SelfAttentionBlock
from mapanything_tpu_torch.models.encoders.dense_rep import sinusoid_encoding_table


class AlternatingAttentionTransformer(nn.Module):
    """Alternating global/frame attention over multi-view token grids."""

    def __init__(
        self,
        input_embed_dim: int,
        depth: int = 24,
        dim: int = 768,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        init_values: Optional[float] = None,
        distinguish_ref_and_non_ref_views: bool = True,
        use_pe_for_non_reference_views: bool = False,
        max_num_views_for_pe: int = 1000,
        use_scalable_softmax: bool = False,
        use_entropy_scaling: bool = False,
        base_token_count_for_entropy_scaling: int = 444,
        entropy_scaling_growth_factor: float = 1.4,
        indices: Optional[Sequence[int]] = None,
        norm_intermediate: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dim = dim
        self.dtype = dtype
        self.indices = tuple(indices or ())
        self.norm_intermediate = norm_intermediate
        self.distinguish_ref_and_non_ref_views = distinguish_ref_and_non_ref_views
        self.use_pe_for_non_reference_views = use_pe_for_non_reference_views
        self.max_num_views_for_pe = max_num_views_for_pe
        if input_embed_dim != dim:
            self.proj_embed = Linear(input_embed_dim, dim, dtype=dtype, init="xavier")
        self.self_attention_blocks = nn.ModuleList(
            SelfAttentionBlock(
                dim,
                num_heads,
                mlp_ratio,
                qkv_bias=qkv_bias,
                init_values=init_values,
                use_scalable_softmax=use_scalable_softmax,
                use_entropy_scaling=use_entropy_scaling,
                base_token_count_for_entropy_scaling=base_token_count_for_entropy_scaling,
                entropy_scaling_growth_factor=entropy_scaling_growth_factor,
                dtype=dtype,
            )
            for _ in range(depth)
        )
        self.norm = LayerNorm(dim, dtype=dtype)

    def _add_view_pe(self, x, V, P, non_ref_view_pe_indices):
        """Reference-view PE on view 0 (and optional PE on the other views)."""
        n_rows = self.max_num_views_for_pe if self.use_pe_for_non_reference_views else 1
        table = torch.from_numpy(sinusoid_encoding_table(n_rows, self.dim, 10000.0))
        table = table.to(device=x.device, dtype=self.dtype)
        parts = [x[:, :P] + table[0]]
        if self.use_pe_for_non_reference_views and V > 1:
            if non_ref_view_pe_indices is None:
                non_ref_view_pe_indices = torch.arange(1, V)
            pe = table[non_ref_view_pe_indices.to(x.device)].repeat_interleave(P, dim=0)
            parts.append(x[:, P : V * P] + pe)
            parts.append(x[:, V * P :])
        else:
            parts.append(x[:, P:])
        return torch.cat(parts, dim=1)

    def forward(
        self,
        features: torch.Tensor,
        additional_tokens: Optional[torch.Tensor] = None,
        non_ref_view_pe_indices: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, List[torch.Tensor], Optional[torch.Tensor]]:
        """
        Args:
            features: (B, V, h, w, Cin) fused per-view patch features.
            additional_tokens: optional (B, T, Cin) extra tokens (the scale token).
            non_ref_view_pe_indices: optional (V-1,) PE table rows for views 1..V-1.

        Returns:
            final (B, V, h, w, dim), the intermediates at ``indices`` (each
            (B, V, h, w, dim)), and the additional tokens' features (B, T, dim)
            or None.
        """
        B, V, h, w, Cin = features.shape
        P = h * w
        T = 0 if additional_tokens is None else additional_tokens.shape[1]
        x = features.reshape(B, V * P, Cin)
        if additional_tokens is not None:
            x = torch.cat([x, additional_tokens.to(x.dtype)], dim=1)
        if hasattr(self, "proj_embed"):
            x = self.proj_embed(x)
        x = x.to(self.dtype)
        if self.distinguish_ref_and_non_ref_views:
            x = self._add_view_pe(x, V, P, non_ref_view_pe_indices)

        intermediates = []
        for depth_idx, block in enumerate(self.self_attention_blocks):
            if depth_idx % 2 == 0:
                x = block(x)
            else:
                view_tok = block(x[:, : V * P].reshape(B * V, P, self.dim))
                view_tok = view_tok.reshape(B, V * P, self.dim)
                x = torch.cat([view_tok, x[:, V * P :]], dim=1) if T else view_tok
            if depth_idx in self.indices:
                inter = self.norm(x) if self.norm_intermediate else x
                intermediates.append(inter[:, : V * P].reshape(B, V, h, w, self.dim))

        x = self.norm(x)
        view_features = x[:, : V * P].reshape(B, V, h, w, self.dim)
        additional_features = x[:, V * P :] if T else None
        return view_features, intermediates, additional_features
