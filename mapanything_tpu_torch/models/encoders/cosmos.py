"""Cosmos tokenizer image encoder of the port (the continuous-image latent).

Counterpart of ``mapanything_tpu/models/encoders/cosmos.py``:
``haar_downsample`` (:24), ``Patcher2D`` (:41), ``_ResBlock`` (:63),
``_ConvAttn`` (:80) and ``CosmosEncoder`` (:99). Haar-wavelet patching, a 3x3
conv in, levels of residual blocks (GroupNorm, SiLU, 3x3 conv, twice) with a
stride-2 conv between them down to the asked compression, a middle of residual
block, single-head conv attention and residual block, then GroupNorm, SiLU, a
3x3 conv out and a 1x1 quant conv to the latent. The attention is an explicit
product of a (H·W)² map in plain PyTorch, as the JAX module's einsum is (no TPU
kernel computes it). Flax conventions kept: GroupNorm of min(32, C) groups
with epsilon 1e-6; the downsampling conv pads one row and column at the
bottom and right only.

Parameter names are the tokenizer release's, the ones ``convert_cosmos_encoder``
reads: ``encoder.conv_in``, ``encoder.down.L.block.j.{norm1,conv1,norm2,conv2,
nin_shortcut}``, ``encoder.down.L.downsample.conv``, ``encoder.mid.{block_1,
attn_1,block_2}`` (``attn_1.{norm,q,k,v,proj_out}``), ``encoder.norm_out``,
``encoder.conv_out`` and ``quant_conv``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from mapanything_tpu_torch.models.blocks import Conv2d, GroupNorm

GROUP_NORM_EPS = 1e-6  # flax.linen.GroupNorm's default


def haar_downsample(x: torch.Tensor) -> torch.Tensor:
    """One 2D Haar level of (B, H, W, C) -> (B, H/2, W/2, 4C): channels [LL, LH, HL,
    HH], each scaled by g²/2 (so LL is the 2x2 mean)."""
    g2 = 0.7071067811865476**2 / 2.0
    a, b = x[:, 0::2, 0::2], x[:, 0::2, 1::2]
    c, d = x[:, 1::2, 0::2], x[:, 1::2, 1::2]
    return torch.cat([a + b + c + d, a + b - c - d, a - b + c - d, a - b - c + d], dim=-1) * g2


class Patcher2D(nn.Module):
    """Haar-wavelet (log2(patch) levels) or rearrange patching, channel-last."""

    def __init__(self, patch_size: int = 4, method: str = "haar"):
        super().__init__()
        if 2 ** int(math.log2(patch_size)) != patch_size:
            raise ValueError("patch_size must be a power of 2")
        if method not in ("haar", "rearrange"):
            raise ValueError(f"unknown patch method {method}")
        self.patch_size = patch_size
        self.method = method

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.method == "haar":
            for _ in range(int(math.log2(self.patch_size))):
                x = haar_downsample(x)
            return x
        B, H, W, C = x.shape
        p = self.patch_size
        x = x.reshape(B, H // p, p, W // p, p, C)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // p, W // p, p * p * C)


def _group_norm(channels: int, dtype: torch.dtype) -> GroupNorm:
    """Flax's GroupNorm of min(32, C) groups on NCHW tensors, returning ``dtype``."""
    return GroupNorm(min(32, channels), channels, eps=GROUP_NORM_EPS, dtype=dtype)


class _ResBlock(nn.Module):
    """GroupNorm, SiLU, 3x3 conv, GroupNorm, SiLU, 3x3 conv, plus the input
    (through a 1x1 ``nin_shortcut`` where the width changes); NCHW."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = _group_norm(in_channels, dtype)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1, dtype=dtype)
        self.norm2 = _group_norm(out_channels, dtype)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1, dtype=dtype)
        if in_channels != out_channels:
            self.nin_shortcut = Conv2d(in_channels, out_channels, 1, dtype=dtype)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (self.nin_shortcut(x) if hasattr(self, "nin_shortcut") else x) + h


class _ConvAttn(nn.Module):
    """Single-head attention over the H·W positions with 1x1-conv q, k, v and
    ``proj_out``, plus the input; NCHW."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = _group_norm(channels, dtype)
        self.q = Conv2d(channels, channels, 1, dtype=dtype)
        self.k = Conv2d(channels, channels, 1, dtype=dtype)
        self.v = Conv2d(channels, channels, 1, dtype=dtype)
        self.proj_out = Conv2d(channels, channels, 1, dtype=dtype)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x)
        q, k, v = (conv(h).flatten(2).transpose(1, 2) for conv in (self.q, self.k, self.v))  # (B, HW, C)
        attn = torch.einsum("bqc,bkc->bqk", q, k) * C**-0.5
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        out = torch.einsum("bqk,bkc->bqc", attn, v).transpose(1, 2).reshape(B, C, H, W)
        return x + self.proj_out(out)


class _Downsample(nn.Module):
    """Stride-2 3x3 conv after one zero row and column at the bottom and right."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, dtype=dtype)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _Mid(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.block_1 = _ResBlock(channels, channels, dtype)
        self.attn_1 = _ConvAttn(channels, dtype)
        self.block_2 = _ResBlock(channels, channels, dtype)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class _Level(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_res_blocks: int, downsample: bool, dtype):
        super().__init__()
        self.block = nn.ModuleList(
            _ResBlock(in_channels if i == 0 else out_channels, out_channels, dtype) for i in range(num_res_blocks)
        )
        if downsample:
            self.downsample = _Downsample(out_channels, dtype)

    def forward(self, x):
        for block in self.block:
            x = block(x)
        return self.downsample(x) if hasattr(self, "downsample") else x


class _Encoder(nn.Module):
    def __init__(self, in_channels, channels, channels_mult, num_res_blocks, num_downsamples, z_channels, dtype):
        super().__init__()
        self.conv_in = Conv2d(in_channels, channels, 3, padding=1, dtype=dtype)
        widths = [channels] + [channels * m for m in channels_mult]
        self.down = nn.ModuleList(
            _Level(widths[i], widths[i + 1], num_res_blocks, i < num_downsamples, dtype)
            for i in range(len(channels_mult))
        )
        self.mid = _Mid(widths[-1], dtype)
        self.norm_out = _group_norm(widths[-1], dtype)
        self.conv_out = Conv2d(widths[-1], z_channels, 3, padding=1, dtype=dtype)

    def forward(self, x):
        x = self.conv_in(x)
        for level in self.down:
            x = level(x)
        return self.conv_out(F.silu(self.norm_out(self.mid(x))))


class CosmosEncoder(nn.Module):
    """images (B, H, W, 3) -> continuous latent features (B, H/ps, W/ps, latent_channels)."""

    def __init__(
        self,
        patch_size: int = 8,
        patcher_size: int = 4,
        patch_method: str = "haar",
        channels: int = 128,
        channels_mult: tuple = (2, 4, 4),
        num_res_blocks: int = 2,
        z_channels: int = 16,
        latent_channels: int = 16,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if patch_size % patcher_size:
            raise ValueError("patch_size must be a multiple of patcher_size")
        num_downsamples = int(math.log2(patch_size // patcher_size))
        if 2**num_downsamples != patch_size // patcher_size:
            raise ValueError("patch_size / patcher_size must be a power of 2")
        self.dtype = dtype
        self.patcher = Patcher2D(patcher_size, patch_method)
        self.encoder = _Encoder(3 * patcher_size**2, channels, channels_mult, num_res_blocks, num_downsamples,
                                z_channels, dtype)
        self.quant_conv = Conv2d(z_channels, latent_channels, 1, dtype=dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.patcher(images.to(self.dtype)).permute(0, 3, 1, 2)
        return self.quant_conv(self.encoder(x)).permute(0, 2, 3, 1)
