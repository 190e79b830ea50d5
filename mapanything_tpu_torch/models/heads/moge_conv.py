"""MoGe-style residual convolutional decoder head of the port (the RGB-prediction models).

Counterpart of ``mapanything_tpu/models/heads/moge_conv.py``: ``_uv_grid`` (:17),
``ResidualConvBlock`` (:27) and ``MoGeConvFeature`` (:44). Per-level 1x1
projections of the multi-level patch features, summed; three levels of a 2x
transposed convolution, a 3x3 convolution and residual blocks, each level fed
the normalised UV coordinates as two extra channels after the features; an
output block (UV again, a 3x3 convolution, ReLU, a 1x1 projection); and an
align-corners resize from 8·h x 8·w to the image size, always. Channel-last
(B, h, w, C) in, (B, H, W, C) out; the convolutions run on NCHW views.

Flax conventions kept: GroupNorm's epsilon is 1e-6 (torch's default is 1e-5),
with min(32, channels) groups; the transposed convolution is Flax's
``ConvTranspose(transpose_kernel=True)``, whose kernel (k, k, out, in) maps to
``ConvTranspose2d``'s (in, out, k, k) as the DPT head's does; the UV channels
are ``linspace(-1, 1)`` in the activations' dtype. The torch converter of the
JAX package has no converter for this head, so its parameter names follow the
JAX modules (``project_{i}``, ``upsample_{i}_deconv``, ``upsample_{i}_conv``,
``res_{i}_{j}.{norm,conv1,conv2}``, ``last_conv``, ``out_proj``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mapanything_tpu_torch.models.blocks import Conv2d, ConvTranspose2d
from mapanything_tpu_torch.models.heads.dpt import _resize_bilinear_align_corners

GROUP_NORM_EPS = 1e-6  # flax.linen.GroupNorm's default


def _uv_grid(b: int, h: int, w: int, dtype: torch.dtype, device) -> torch.Tensor:
    """Normalised UV coordinate channels (B, 2, H, W) in [-1, 1]: u along W, then v along H."""
    v = torch.linspace(-1.0, 1.0, h, dtype=dtype, device=device)[:, None].expand(h, w)
    u = torch.linspace(-1.0, 1.0, w, dtype=dtype, device=device)[None, :].expand(h, w)
    return torch.stack([u, v])[None].expand(b, 2, h, w)


def _with_uv(x: torch.Tensor) -> torch.Tensor:
    b, _, h, w = x.shape
    return torch.cat([x, _uv_grid(b, h, w, x.dtype, x.device)], dim=1)


class ResidualConvBlock(nn.Module):
    """GroupNorm, ReLU, 3x3 conv to ``hidden``, ReLU, 3x3 conv back, plus the input (NCHW)."""

    def __init__(self, channels: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.GroupNorm(min(32, channels), channels, eps=GROUP_NORM_EPS)
        self.conv1 = Conv2d(channels, hidden, 3, padding=1, dtype=dtype)
        self.conv2 = Conv2d(hidden, channels, 3, padding=1, dtype=dtype)

    def forward(self, x):
        n = self.norm
        y = F.group_norm(x.to(self.dtype), n.num_groups, n.weight.to(self.dtype), n.bias.to(self.dtype), n.eps)
        return x + self.conv2(F.relu(self.conv1(F.relu(y))))


class MoGeConvFeature(nn.Module):
    """Multi-level patch features -> full-resolution channels, MoGe's decoder.

    ``input_dims`` are the channel counts of the feature levels, in the order the
    forward receives them; the forward takes a list of (B, h, w, C_i) and returns
    (B, H, W, output_dim) at ``output_shape_hw``.
    """

    def __init__(
        self,
        input_dims: Sequence[int],
        output_dim: int,
        dim_proj: int = 512,
        dim_upsample: Sequence[int] = (256, 128, 64),
        num_res_blocks: int = 2,
        dim_times_res_block_hidden: int = 2,
        last_conv_channels: int = 32,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.input_dims = tuple(input_dims)
        self.dim_upsample = tuple(dim_upsample)
        self.num_res_blocks = num_res_blocks
        self.dtype = dtype
        for i, c in enumerate(self.input_dims):
            setattr(self, f"project_{i}", Conv2d(c, dim_proj, 1, dtype=dtype))
        ch = dim_proj
        for i, out_ch in enumerate(self.dim_upsample):
            setattr(self, f"upsample_{i}_deconv", ConvTranspose2d(ch + 2, out_ch, 2, stride=2, dtype=dtype))
            setattr(self, f"upsample_{i}_conv", Conv2d(out_ch, out_ch, 3, padding=1, dtype=dtype))
            for j in range(num_res_blocks):
                setattr(self, f"res_{i}_{j}", ResidualConvBlock(out_ch, dim_times_res_block_hidden * out_ch, dtype))
            ch = out_ch
        self.last_conv = Conv2d(ch + 2, last_conv_channels, 3, padding=1, dtype=dtype)
        self.out_proj = Conv2d(last_conv_channels, output_dim, 1, dtype=dtype)

    def forward(self, list_features: Sequence[torch.Tensor], output_shape_hw: Tuple[int, int]) -> torch.Tensor:
        if len(list_features) != len(self.input_dims):
            raise ValueError(f"{len(list_features)} feature levels given to a head of {len(self.input_dims)}")
        x = sum(getattr(self, f"project_{i}")(f.to(self.dtype).permute(0, 3, 1, 2))
                for i, f in enumerate(list_features))
        for i in range(len(self.dim_upsample)):
            x = getattr(self, f"upsample_{i}_deconv")(_with_uv(x))
            x = getattr(self, f"upsample_{i}_conv")(x)
            for j in range(self.num_res_blocks):
                x = getattr(self, f"res_{i}_{j}")(x)
        x = self.out_proj(F.relu(self.last_conv(_with_uv(x))))
        return _resize_bilinear_align_corners(x, output_shape_hw).permute(0, 2, 3, 1)
