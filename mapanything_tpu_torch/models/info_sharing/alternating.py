"""Multi-view alternating-attention transformer of the port (the trunk).

Counterpart of ``AlternatingAttentionTransformer`` in
``mapanything_tpu/models/info_sharing/alternating.py`` (:115, unrolled
branch :255-303). Its blocks' rematerialisation (``remat``, ``remat_policy``:
:140-141, :206-210, :256-262) is ``blocks.set_remat(self_attention_blocks, ...)``,
which ``MapAnything.configure_remat`` calls; the ``scan_pairs`` branch is not
ported. Even layers attend over all views' tokens plus the
additional tokens (the scale token); odd layers attend within each view,
and the additional tokens skip them. Parameter names follow the reference
(``proj_embed``, ``self_attention_blocks.N.*``, ``norm``).

While a ``parallel.cp`` context is active (JAX's ``context_parallel``,
:136-139, :275-276), the views given are this rank's block of the group's
views: the even layers attend across ranks (``global_attention_cp``), the
odd layers stay local, and the view positional encodings go by global view
index (the reference-view PE on global view 0 only).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from mapanything_tpu_torch.models.blocks import LayerNorm, Linear, SelfAttentionBlock
from mapanything_tpu_torch.models.encoders.dense_rep import sinusoid_encoding_table
from mapanything_tpu_torch.parallel.cp import current_cp


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
                cp_global=depth_idx % 2 == 0,
                dtype=dtype,
            )
            for depth_idx in range(depth)
        )
        self.norm = LayerNorm(dim, dtype=dtype)

    def _add_view_pe(self, x, V, P, non_ref_view_pe_indices, first_view=0, total_views=None):
        """Reference-view PE on global view 0 (and optional PE on the other
        views). The V views given are global views [first_view, first_view + V)
        of ``total_views``; ``non_ref_view_pe_indices`` (total_views - 1,) are
        the PE rows of global views 1, 2, ... (default: their own indices)."""
        total_views = V if total_views is None else total_views
        n_rows = self.max_num_views_for_pe if self.use_pe_for_non_reference_views else 1
        table = torch.from_numpy(sinusoid_encoding_table(n_rows, self.dim, 10000.0))
        table = table.to(device=x.device, dtype=self.dtype)
        local = 0  # the first local view that is not the reference view
        parts = []
        if first_view == 0:
            parts.append(x[:, :P] + table[0])
            local = 1
        if self.use_pe_for_non_reference_views and local < V:
            if non_ref_view_pe_indices is None:
                non_ref_view_pe_indices = torch.arange(1, total_views)
            rows = non_ref_view_pe_indices[first_view + local - 1 : first_view + V - 1]
            pe = table[rows.to(x.device)].repeat_interleave(P, dim=0)
            parts.append(x[:, local * P : V * P] + pe)
            parts.append(x[:, V * P :])
        else:
            parts.append(x[:, local * P :])
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
            non_ref_view_pe_indices: optional (V-1,) PE table rows for views
                1..V-1 (under context parallelism, of all ranks' views).

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
        cp = current_cp()
        n_ranks, rank = (1, 0) if cp is None else (cp.group.size, cp.group.rank)
        if self.distinguish_ref_and_non_ref_views:
            x = self._add_view_pe(x, V, P, non_ref_view_pe_indices, rank * V, n_ranks * V)

        intermediates = []
        for depth_idx, block in enumerate(self.self_attention_blocks):
            if depth_idx % 2 == 0:
                x = block(x, cp_extra_tokens=T)
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
