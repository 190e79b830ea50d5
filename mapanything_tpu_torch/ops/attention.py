"""Scaled dot-product attention entry point of the port.

Counterpart of ``mapanything_tpu/ops/attention.py`` (:30-81). Every call
goes to ``flash_attention``: the Hopper kernel for CUDA tensors at any
length, the plain version for CPU tensors. The TPU's 1024-token threshold
and its library route do not carry over, and the masked form waits for a
later slice.
"""

from __future__ import annotations

import contextlib
import math
import sys
from typing import Iterator, Optional

import torch

from mapanything_tpu_torch.ops.flash_attention import attention_reference, flash_attention


def apply_scalable_softmax(q: torch.Tensor, num_tokens: int) -> torch.Tensor:
    """Scalable-Softmax (SSMax, arXiv:2501.19399): scale q by log(N)."""
    return q * math.log(num_tokens)


def apply_entropy_scaling(
    q: torch.Tensor,
    num_tokens: int,
    base_token_count: int = 444,
    growth_factor: float = 1.4,
) -> torch.Tensor:
    """Entropy-invariant scaling (arXiv:2502.07785): q *= sqrt(g*logN / logN0)."""
    return q * math.sqrt(growth_factor * math.log(num_tokens) / math.log(base_token_count))


def sdpa(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """Non-causal attention over q (B, Tq, H, D) and k, v (B, Tk, H, D)."""
    return flash_attention(q, k, v, scale)


@contextlib.contextmanager
def plain_attention() -> Iterator[None]:
    """Inside: every ``sdpa`` call runs the kernels' plain version (differentiable
    by autograd), on CUDA tensors too, and no kernel's launch count moves. The
    yardstick of a model run with the kernels against the same run without them."""
    module = sys.modules[__name__]
    kernels = module.flash_attention
    module.flash_attention = lambda q, k, v, scale=None: attention_reference(q, k, v, scale)
    try:
        yield
    finally:
        module.flash_attention = kernels
