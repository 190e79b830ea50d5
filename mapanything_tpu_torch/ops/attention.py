"""Scaled dot-product attention entry point of the port.

Counterpart of ``mapanything_tpu/ops/attention.py`` (:30-81). Every call
goes to ``flash_attention``, or with a mask to ``flash_attention_masked``: the
Hopper kernels for CUDA tensors at any length, the plain versions for CPU
tensors. The TPU's 1024-token threshold and its library route (XLA's fused
attention, which also took every masked call there) do not carry over.
"""

from __future__ import annotations

import contextlib
import math
import sys
from typing import Iterator, Optional

import torch

from mapanything_tpu_torch.ops.flash_attention import (
    attention_masked_reference,
    attention_reference,
    flash_attention,
    flash_attention_masked,
    masked_view,
)


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
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Non-causal attention over q (B, Tq, H, D) and k, v (B, Tk, H, D); ``mask``, an
    optional boolean (B, 1|H, Tq, Tk) (True = attend; a dimension of size 1 broadcasts),
    replaces each masked logit by -0.7 * FLT_MAX as ``jax.nn.dot_product_attention`` does."""
    if mask is None:
        return flash_attention(q, k, v, scale)
    return flash_attention_masked(q, k, v, mask, scale)


@contextlib.contextmanager
def plain_attention() -> Iterator[None]:
    """Inside: every ``sdpa`` call, masked or not, runs the kernels' plain version
    (differentiable by autograd), on CUDA tensors too, and no kernel's launch count
    moves. The yardstick of a model run with the kernels against the same run without
    them."""
    module = sys.modules[__name__]
    kernels = module.flash_attention, module.flash_attention_masked
    module.flash_attention = lambda q, k, v, scale=None: attention_reference(q, k, v, scale)
    module.flash_attention_masked = lambda q, k, v, mask, scale=None: attention_masked_reference(
        q, k, v, masked_view(mask, q.shape[0], q.shape[2], q.shape[1], k.shape[1]), scale)
    try:
        yield
    finally:
        module.flash_attention, module.flash_attention_masked = kernels
