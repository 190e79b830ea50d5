"""Encoders of the geometric inputs, and the sinusoid table, for the port.

Counterparts of ``mapanything_tpu/models/encoders/dense_rep.py``:
``sinusoid_encoding_table`` (:22), ``pixel_unshuffle`` (:32),
``ResidualBlock`` (:44), ``DenseRepresentationEncoder`` (:64, ray directions
and log-depth) and ``GlobalRepresentationEncoder`` (:106, pose and scale
vectors). Parameter names are the reference's torch names, which
``mapanything_tpu.utils.torch_convert`` reads (``convert_dense_rep_encoder``
:274, ``convert_global_rep_encoder`` :317). The dense encoder's positional
encoding (``apply_pe``, on by default as in the JAX module) adds the sinusoid
table of the ``input_size_for_pe`` grid, resized to the token grid as
``jax.image.resize(..., "bicubic")`` resizes it (``resize_weights``), then
``post_pe_norm``; the model builds its encoders with ``apply_pe=False``
(configs/model/task/default.yaml).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mapanything_tpu_torch.models.blocks import Conv2d, LayerNorm, Linear


def sinusoid_encoding_table(n_position: int, d_hid: int, base: float) -> np.ndarray:
    """(n_position, d_hid) fp32 table: sin on even channels, cos on odd ones."""
    position = np.arange(n_position)[:, None]
    div = np.power(base, 2 * (np.arange(d_hid) // 2) / d_hid)[None, :]
    table = position / div
    table[:, 0::2] = np.sin(table[:, 0::2])
    table[:, 1::2] = np.cos(table[:, 1::2])
    return table.astype(np.float32)


def pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/f, W/f, C·f·f), channels ordered as torch's
    ``pixel_unshuffle`` orders them on NCHW (channel, then row, then column)."""
    return F.pixel_unshuffle(x.permute(0, 3, 1, 2), factor).permute(0, 2, 3, 1)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel with a = -0.5 at distances ``x`` >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float64 weights of ``jax.image.resize``'s bicubic along one
    axis: scale-and-translate with Keys' cubic (a = -0.5), the kernel widened by
    1 / scale when it shrinks (antialiasing), each output's weights normalised to sum
    1, zero for an output whose sample falls outside the input."""
    inv_scale = in_size / out_size
    sample = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    weights = _keys_cubic(np.abs(sample[:, None] - np.arange(in_size)[None, :]) / max(inv_scale, 1.0))
    total = weights.sum(axis=1, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, weights / np.where(total != 0, total, 1), 0)
    return np.where(((sample >= -0.5) & (sample <= in_size - 0.5))[:, None], weights, 0.0)


@lru_cache(maxsize=16)
def positional_encoding(grid: int, out_hw: Tuple[int, int], dim: int, base: float) -> np.ndarray:
    """(h, w, dim) fp32: the sinusoid table of a ``grid`` x ``grid`` token grid, resized
    to ``out_hw`` as ``jax.image.resize(..., method="bicubic")`` resizes it (an axis
    whose size does not change is left as it is), the two axes' weights applied as two
    products in float64."""
    pe = sinusoid_encoding_table(grid * grid, dim, base).reshape(grid, grid, dim).astype(np.float64)
    h, w = out_hw
    if h != grid:
        pe = np.einsum("hi,iwc->hwc", resize_weights(grid, h), pe)
    if w != grid:
        pe = np.einsum("wj,hjc->hwc", resize_weights(grid, w), pe)
    return pe.astype(np.float32)


class ResidualBlock(nn.Module):
    """Two 3x3 convolutions with exact GELU and a (1x1 when widths differ) shortcut; NCHW."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.shortcut = Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        identity = self.shortcut(x) if hasattr(self, "shortcut") else x
        out = self.conv2(F.gelu(self.conv1(x)))
        return F.gelu(out + identity)


class DenseRepresentationEncoder(nn.Module):
    """Patchify a dense (B, H, W, Cin) map into (B, H/P, W/P, embed) tokens, in fp32.

    pixel-unshuffle, ``conv_in``, residual blocks and a 1x1 projection
    (``encoder``), then ``norm_layer``; with ``apply_pe``, plus the positional
    encoding of the ``input_size_for_pe`` grid (``positional_encoding``), then
    ``post_pe_norm``.
    """

    def __init__(
        self,
        in_chans: int = 3,
        enc_embed_dim: int = 1024,
        patch_size: int = 14,
        intermediate_dims: Sequence[int] = (588, 768, 1024),
        apply_pe: bool = True,
        input_size_for_pe: int = 518,
        pe_base: float = 70007.0,
    ):
        super().__init__()
        self.in_chans = in_chans
        self.patch_size = patch_size
        self.apply_pe = apply_pe
        self.input_size_for_pe = input_size_for_pe
        self.pe_base = pe_base
        dims = tuple(intermediate_dims)
        self.conv_in = Conv2d(in_chans * patch_size * patch_size, dims[0], 3, padding=1)
        layers = [ResidualBlock(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]
        layers.append(Conv2d(dims[-1], enc_embed_dim, 1))
        self.encoder = nn.Sequential(*layers)
        self.norm_layer = LayerNorm(enc_embed_dim)
        if apply_pe:
            self.post_pe_norm = LayerNorm(enc_embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.in_chans:
            raise ValueError(f"expected {self.in_chans} channels, got {x.shape[-1]}")
        x = F.pixel_unshuffle(x.float().permute(0, 3, 1, 2), self.patch_size)
        x = self.norm_layer(self.encoder(self.conv_in(x)).permute(0, 2, 3, 1))
        if not self.apply_pe:
            return x
        grid = self.input_size_for_pe // self.patch_size
        pe = positional_encoding(grid, tuple(x.shape[1:3]), x.shape[-1], self.pe_base)
        return self.post_pe_norm(x + torch.from_numpy(pe).to(x.device))


class GlobalRepresentationEncoder(nn.Module):
    """MLP-encode a global vector (B, Cin) to (B, embed), in fp32.

    The linears sit in the reference's nested ``Sequential`` layout
    (``encoder.0.0.0.0`` … ``encoder.1``), then ``norm_layer``.
    """

    def __init__(
        self,
        in_chans: int = 3,
        enc_embed_dim: int = 1024,
        intermediate_dims: Sequence[int] = (128, 256, 512),
    ):
        super().__init__()
        self.in_chans = in_chans
        dims = tuple(intermediate_dims)
        enc = nn.Sequential(Linear(in_chans, dims[0]), nn.GELU())
        for i in range(1, len(dims)):
            enc = nn.Sequential(enc, Linear(dims[i - 1], dims[i]), nn.GELU())
        self.encoder = nn.Sequential(enc, Linear(dims[-1], enc_embed_dim))
        self.norm_layer = LayerNorm(enc_embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.in_chans:
            raise ValueError(f"expected {self.in_chans} channels, got {x.shape[-1]}")
        return self.norm_layer(self.encoder(x.float()))
