"""Transformer primitives of the port: dtype-aware layers, MLP, attention, blocks.

Counterpart of ``mapanything_tpu/models/blocks.py`` for the images-only
slice: ``gelu_matched`` (:43), ``Mlp`` (:55), ``LayerScale`` (:108),
``DropPath`` (:122), ``Attention`` (:140) with its context-parallel routing
(:159-165, :215-237) and ``SelfAttentionBlock`` (:313).
Parameter names are the reference's torch names (DINOv2 / UniCeption), so
``mapanything_tpu.utils.torch_convert`` reads a port state dict unchanged.

Dtype policy, as in Flax. Parameters stay fp32. ``Linear``, ``Conv2d`` and
``ConvTranspose2d`` take a ``dtype`` and cast input, weight and bias to it at
every call, which is what ``flax.linen.Dense(dtype=...)`` does; with
``dtype=torch.float32`` the casts are no-ops. ``LayerNorm`` normalises in
fp32 and returns ``dtype`` (or fp32 when ``dtype`` is None), as Flax's
LayerNorm does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mapanything_tpu_torch.ops.attention import (
    apply_entropy_scaling,
    apply_scalable_softmax,
    sdpa,
)
from mapanything_tpu_torch.parallel.cp import current_cp
from mapanything_tpu_torch.parallel.sharded_attention import global_attention_cp


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``dtype``; ``init`` names its Flax initializer."""

    def __init__(self, in_features, out_features, bias=True, dtype=torch.float32, init="lecun"):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        self.init = init

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype`` (NCHW)."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0, bias=True, dtype=torch.float32):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride, padding=padding, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``dtype`` (NCHW)."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, dtype=torch.float32):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics; returns ``dtype``, or fp32 when it is None."""

    def __init__(self, dim, eps=1e-6, dtype: Optional[torch.dtype] = None):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        out_dtype = self.compute_dtype or torch.promote_types(x.dtype, torch.float32)
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(out_dtype)


def gelu_matched(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU in fp32; the tanh approximation in bf16/fp16."""
    return F.gelu(x, approximate="none" if x.dtype == torch.float32 else "tanh")


class Mlp(nn.Module):
    """Two-layer MLP with the dtype-matched GELU."""

    def __init__(self, in_features, hidden_features, out_features, dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features, dtype=dtype, init="xavier")
        self.fc2 = Linear(hidden_features, out_features, dtype=dtype, init="xavier")

    def forward(self, x):
        return self.fc2(gelu_matched(self.fc1(x)))


class LayerScale(nn.Module):
    """Per-channel learnable residual scaling."""

    def __init__(self, dim, init_values=1e-5):
        super().__init__()
        self.init_values = init_values
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class DropPath(nn.Module):
    """Stochastic depth per sample; identity at rate 0 or in eval mode."""

    def __init__(self, rate=0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), device=x.device) < keep
        return x / keep * mask.to(x.dtype)


class Attention(nn.Module):
    """Multi-head self-attention over (B, N, C) through ``sdpa``.

    q, k and v are strided views of the fused ``qkv`` projection, (B, N, H, D)
    each; the attention kernel reads them in place.

    Context-parallel routing (the trunk's global layers): with ``cp_global``
    set and a ``parallel.cp`` context active, the last ``cp_extra_tokens``
    tokens are the replicated extra tokens (the scale token) and the rest
    are this rank's view-sharded grid tokens; attention then runs through
    ``global_attention_cp`` with the context's schedule, and the token count
    N of the softmax scalings is the global V·P + E.
    """

    def __init__(
        self,
        dim,
        num_heads=8,
        qkv_bias=False,
        use_scalable_softmax=False,
        use_entropy_scaling=False,
        base_token_count_for_entropy_scaling=444,
        entropy_scaling_growth_factor=1.4,
        cp_global=False,
        dtype=torch.float32,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.cp_global = cp_global
        self.use_scalable_softmax = use_scalable_softmax
        self.use_entropy_scaling = use_entropy_scaling
        self.base_token_count_for_entropy_scaling = base_token_count_for_entropy_scaling
        self.entropy_scaling_growth_factor = entropy_scaling_growth_factor
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias, dtype=dtype, init="xavier")
        self.proj = Linear(dim, dim, dtype=dtype, init="xavier")

    def forward(self, x, cp_extra_tokens: int = 0):
        B, N, C = x.shape
        head_dim = C // self.num_heads
        q, k, v = self.qkv(x).reshape(B, N, 3, self.num_heads, head_dim).unbind(2)
        cp = current_cp() if self.cp_global else None
        E = cp_extra_tokens
        n_tokens = N if cp is None else (N - E) * cp.group.size + E
        if self.use_scalable_softmax:
            q = apply_scalable_softmax(q, n_tokens)
        if self.use_entropy_scaling:
            q = apply_entropy_scaling(
                q, n_tokens, self.base_token_count_for_entropy_scaling, self.entropy_scaling_growth_factor
            )
        if cp is None:
            out = sdpa(q, k, v, scale=head_dim**-0.5)
        else:
            g = N - E
            og, oe = global_attention_cp(
                q[:, :g], k[:, :g], v[:, :g],
                q[:, g:] if E else None, k[:, g:] if E else None, v[:, g:] if E else None,
                cp.group, head_dim**-0.5, cp.schedule,
            )
            out = torch.cat([og, oe.to(og.dtype)], dim=1) if E else og
        return self.proj(out.reshape(B, N, C))


class SelfAttentionBlock(nn.Module):
    """Pre-norm self-attention transformer block (DINOv2 ``Block`` names)."""

    def __init__(
        self,
        dim,
        num_heads,
        mlp_ratio=4.0,
        qkv_bias=True,
        init_values: Optional[float] = None,
        drop_path=0.0,
        use_scalable_softmax=False,
        use_entropy_scaling=False,
        base_token_count_for_entropy_scaling=444,
        entropy_scaling_growth_factor=1.4,
        cp_global=False,
        dtype=torch.float32,
    ):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = Attention(
            dim,
            num_heads,
            qkv_bias=qkv_bias,
            use_scalable_softmax=use_scalable_softmax,
            use_entropy_scaling=use_entropy_scaling,
            base_token_count_for_entropy_scaling=base_token_count_for_entropy_scaling,
            entropy_scaling_growth_factor=entropy_scaling_growth_factor,
            cp_global=cp_global,
            dtype=dtype,
        )
        self.ls1 = LayerScale(dim, init_values) if init_values is not None else nn.Identity()
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype)
        self.ls2 = LayerScale(dim, init_values) if init_values is not None else nn.Identity()
        self.drop_path = DropPath(drop_path)

    def forward(self, x, cp_extra_tokens: int = 0):
        x = x + self.drop_path(self.ls1(self.attn(self.norm1(x), cp_extra_tokens)))
        return x + self.drop_path(self.ls2(self.mlp(self.norm2(x))))


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    # flax.linen.initializers.lecun_normal: a normal truncated at two standard
    # deviations, rescaled so that the variance is 1 / fan_in.
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation with the distributions of the Flax modules.

    Dense kernels: Xavier-uniform in the transformer blocks and the trunk's
    input projection, LeCun-normal elsewhere; convolutions LeCun-normal;
    biases zero; LayerNorm one and zero; LayerScale its ``init_values``.
    Token and position parameters (``nn.Parameter``s held directly by a
    module) are set by the module that owns them through ``init_tokens``.
    """
    for m in module.modules():
        if isinstance(m, Linear):
            if m.init == "xavier":
                nn.init.xavier_uniform_(m.weight, generator=generator)
            else:
                _lecun_normal_(m.weight, m.in_features, generator)
        elif isinstance(m, nn.ConvTranspose2d):
            # Flax's kernel is (k, k, out, in) and its fan-in axis is `out`.
            kh, kw = m.kernel_size
            _lecun_normal_(m.weight, m.out_channels * kh * kw, generator)
        elif isinstance(m, nn.Conv2d):
            kh, kw = m.kernel_size
            _lecun_normal_(m.weight, m.in_channels * kh * kw, generator)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
        elif isinstance(m, LayerScale):
            m.gamma.fill_(m.init_values)
        else:
            if hasattr(m, "init_tokens"):
                m.init_tokens(generator)
            continue
        if getattr(m, "bias", None) is not None:
            nn.init.zeros_(m.bias)
