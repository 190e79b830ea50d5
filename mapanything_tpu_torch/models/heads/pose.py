"""Pose and scale-MLP heads of the port.

Counterpart of ``ResConvBlock`` (:13), ``PoseHead`` (:33), ``MLPHead``
(:59), ``LinearFeature`` (:78) and ``MLPFeature`` (:103) in
``mapanything_tpu/models/heads/pose.py``. Channel-last at the boundary;
parameter names follow the reference (``proj``, ``res_conv.i.*``,
``more_mlps.*``, ``fc_t``, ``fc_rot``; ``proj``, ``mlp.i.0``, ``output_proj``;
``linear``; ``mlp.fc1``, ``mlp.fc2``, ``out.linear``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mapanything_tpu_torch.models.blocks import Conv2d, Linear, Mlp


class ResConvBlock(nn.Module):
    """1x1-conv residual block (NCHW)."""

    def __init__(self, in_channels, out_channels, dtype=torch.float32):
        super().__init__()
        if in_channels != out_channels:
            self.head_skip = Conv2d(in_channels, out_channels, 1, dtype=dtype)
        self.res_conv1 = Conv2d(in_channels, out_channels, 1, dtype=dtype)
        self.res_conv2 = Conv2d(out_channels, out_channels, 1, dtype=dtype)
        self.res_conv3 = Conv2d(out_channels, out_channels, 1, dtype=dtype)

    def forward(self, x):
        skip = self.head_skip(x) if hasattr(self, "head_skip") else x
        y = F.relu(self.res_conv1(x))
        y = F.relu(self.res_conv2(y))
        y = F.relu(self.res_conv3(y))
        return skip + y


class PoseHead(nn.Module):
    """Patch features (B, h, w, C) -> (B, 3 + rot_dim): [translation, quaternion]."""

    def __init__(
        self,
        input_feature_dim: int,
        patch_size: int = 14,
        num_resconv_block: int = 2,
        rot_representation_dim: int = 4,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        hidden = 4 * patch_size**2
        self.dtype = dtype
        self.proj = Conv2d(input_feature_dim, hidden, 1, dtype=dtype)
        self.res_conv = nn.ModuleList(
            ResConvBlock(hidden, hidden, dtype=dtype) for _ in range(num_resconv_block)
        )
        self.more_mlps = nn.Sequential(
            Linear(hidden, hidden, dtype=dtype), nn.ReLU(), Linear(hidden, hidden, dtype=dtype), nn.ReLU()
        )
        self.fc_t = Linear(hidden, 3, dtype=dtype)
        self.fc_rot = Linear(hidden, rot_representation_dim, dtype=dtype)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        x = self.proj(feat.to(self.dtype).permute(0, 3, 1, 2))
        for block in self.res_conv:
            x = block(x)
        x = self.more_mlps(x.mean(dim=(-2, -1)))
        return torch.cat([self.fc_t(x), self.fc_rot(x)], dim=-1)


class MLPHead(nn.Module):
    """Token MLP head: (B, T, C) -> (B, T, output_dim). Used on the scale token."""

    def __init__(
        self,
        input_dim: int,
        output_dim: int = 1,
        num_mlp_layers: int = 2,
        hidden_dim: int = 196,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.proj = Linear(input_dim, hidden_dim, dtype=dtype)
        self.mlp = nn.ModuleList(
            nn.Sequential(Linear(hidden_dim, hidden_dim, dtype=dtype), nn.ReLU())
            for _ in range(num_mlp_layers)
        )
        self.output_proj = Linear(hidden_dim, output_dim, dtype=dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.proj(tokens.to(self.dtype))
        for layer in self.mlp:
            x = layer(x)
        return self.output_proj(x)


class LinearFeature(nn.Module):
    """Linear unpatchify head: (B, h, w, C) -> a 1x1 conv to output_dim·P² channels
    -> pixel shuffle (torch's channel order) -> (B, h·P, w·P, output_dim)."""

    def __init__(self, input_feature_dim: int, output_dim: int, patch_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.patch_size = patch_size
        self.linear = Conv2d(input_feature_dim, output_dim * patch_size**2, 1, dtype=dtype)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        x = self.linear(feat.to(self.dtype).permute(0, 3, 1, 2))
        return F.pixel_shuffle(x, self.patch_size).permute(0, 2, 3, 1)


class MLPFeature(nn.Module):
    """``LinearFeature`` after a (C -> mlp_ratio·C -> C) MLP on each token."""

    def __init__(self, input_feature_dim: int, output_dim: int, patch_size: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        c = input_feature_dim
        self.mlp = Mlp(c, int(mlp_ratio * c), c, dtype=dtype)
        self.out = LinearFeature(c, output_dim, patch_size, dtype=dtype)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        return self.out(self.mlp(feat.to(self.dtype)))
