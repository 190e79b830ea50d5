"""2D rotary position embedding (RoPE2D) of the port, in plain PyTorch.

Counterpart of ``mapanything_tpu/ops/rope.py``: ``_cos_sin_table`` (:25),
``rope_2d`` (:46), ``make_rope2d`` (:76) and ``patch_position_grid`` (:85).
No TPU kernel computes RoPE (the JAX module is plain JAX too): it is a few
elementwise products on q and k before the attention kernel.

The head dim splits in halves: the first half is rotated by the token's y
position, the second by its x position, each with the "rotate half"
formulation and its frequencies repeated over both quarters. The cos and sin
tables are computed on the host in float64, rounded to fp32 and then cast to
the tokens' dtype before the products, as the JAX module does (in bf16 that
cast decides the result).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _cos_sin_table(d_half: int, max_pos: int, base: float):
    """The host tables, each (max_pos, d_half) fp32 numpy."""
    inv_freq = 1.0 / (base ** (np.arange(0, d_half, 2, dtype=np.float64) / d_half))
    t = np.arange(max_pos, dtype=np.float64)
    freqs = np.outer(t, inv_freq)
    freqs = np.concatenate([freqs, freqs], axis=-1)
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _device_table(d_half: int, max_pos: int, base: float, device: torch.device):
    """The host tables as fp32 tensors on ``device``, copied there once."""
    return tuple(torch.from_numpy(t).to(device) for t in _cos_sin_table(d_half, max_pos, base))


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _apply_rope1d(tokens, pos1d, cos, sin):
    """tokens (B, N, H, Dh); pos1d (B, N) integer; cos and sin (P, Dh)."""
    c = cos[pos1d][:, :, None, :].to(tokens.dtype)
    s = sin[pos1d][:, :, None, :].to(tokens.dtype)
    return tokens * c + _rotate_half(tokens) * s


def rope_2d(tokens: torch.Tensor, positions: torch.Tensor, base: float = 100.0, max_pos: int = 512) -> torch.Tensor:
    """RoPE2D on q or k ``tokens`` (B, N, H, D), D divisible by 4, at integer
    (y, x) ``positions`` (B, N, 2), each below ``max_pos`` (a position past the
    table fails the table's indexing; the JAX gather would give NaN). Returns a
    new tensor of the tokens' shape and dtype."""
    d = tokens.shape[-1]
    if d % 4:
        raise ValueError(f"head dim {d} must be divisible by 4 for RoPE2D")
    cos, sin = _device_table(d // 2, max_pos, float(base), tokens.device)
    positions = positions.to(tokens.device)
    y, x = tokens.chunk(2, dim=-1)
    y = _apply_rope1d(y, positions[..., 0], cos, sin)
    x = _apply_rope1d(x, positions[..., 1], cos, sin)
    return torch.cat([y, x], dim=-1)


def make_rope2d(base: float = 100.0, max_pos: int = 512) -> Callable:
    """``rope(tokens, positions)``: ``rope_2d`` at this base and table length, the
    hook that ``Attention`` and ``CrossAttention`` take (a partial, so a module
    holding it pickles)."""
    return functools.partial(rope_2d, base=base, max_pos=max_pos)


def patch_position_grid(batch: int, h: int, w: int, device=None) -> torch.Tensor:
    """(B, h·w, 2) integer (y, x) positions of an h × w patch grid, row-major."""
    y = torch.arange(h, dtype=torch.int64, device=device)
    x = torch.arange(w, dtype=torch.int64, device=device)
    grid = torch.stack(torch.meshgrid(y, x, indexing="ij"), dim=-1).reshape(-1, 2)
    return grid.expand(batch, h * w, 2)
