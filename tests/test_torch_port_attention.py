"""The port's attention against the JAX package's, on the CPU.

On the CPU the port's ``flash_attention`` runs its plain version; the JAX
side runs its Pallas kernels in interpret mode, in each regime that the
main path reaches on the TPU (K1 packed, K2 head-pair streaming, K3/K4 3D).
All inputs are made with numpy from fixed seeds; fp32 throughout. Logits
stay inside the (-83, +110)-nat range where the TPU kernels' constant-shift
softmax equals the max-stabilised one.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapanything_tpu.ops import attention as jax_attention
from mapanything_tpu.ops.flash_attention import _use_packed, _use_pair
from mapanything_tpu.ops.flash_attention import flash_attention as jax_flash
from mapanything_tpu_torch.ops import attention as port_attention
from mapanything_tpu_torch.ops.flash_attention import (
    _check,
    attention_bytes,
    attention_flops,
    attention_reference,
    flash_attention,
)

ATOL = 2e-5  # as tests/test_flash_attention.py holds the Pallas kernels to XLA


def make_qkv(b, tq, tk, h, d, seed):
    rng = np.random.RandomState(seed)
    return tuple(
        rng.randn(b, t, h, d).astype(np.float32) for t in (tq, tk, tk)
    )


def run_port(q, k, v, scale):
    out = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), scale)
    return out.numpy()


@pytest.mark.parametrize(
    "regime,b,t,h,jax_kwargs",
    [
        ("K1 packed", 2, 40, 4, {}),
        ("K1 packed, ragged", 1, 77, 2, {}),
        ("K2 head-pair stream", 1, 2100, 4, {}),
        ("K3 3D streamed", 1, 300, 2, {"block_q": 128, "block_k": 128}),
        ("K4 3D one K pass", 1, 100, 2, {"block_q": 128, "block_k": 128}),
    ],
)
def test_flash_attention_matches_jax_regimes(regime, b, t, h, jax_kwargs):
    q, k, v = make_qkv(b, t, t, h, 64, seed=t)
    scale = 0.125
    jq = jnp.asarray(q)
    if regime.startswith("K1"):
        assert _use_packed(jq, jq, interpret=True)
    elif regime.startswith("K2"):
        assert _use_pair(jq, jq, interpret=True)
    ref = np.asarray(
        jax_flash(jq, jnp.asarray(k), jnp.asarray(v), scale, interpret=True, **jax_kwargs)
    )
    np.testing.assert_allclose(run_port(q, k, v, scale), ref, atol=ATOL)


def test_flash_attention_cross_lengths_and_default_scale():
    q, k, v = make_qkv(2, 33, 70, 2, 64, seed=7)
    ref = np.asarray(jax_flash(*(jnp.asarray(x) for x in (q, k, v)), interpret=True))
    np.testing.assert_allclose(run_port(q, k, v, None), ref, atol=ATOL)


def test_flash_attention_reads_fused_qkv_views():
    # Attention hands the kernel strided views of the fused qkv projection.
    rng = np.random.RandomState(3)
    qkv = torch.from_numpy(rng.randn(2, 50, 3, 4, 64).astype(np.float32))
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    before = flash_attention.launches
    out = flash_attention(q, k, v, 0.125)
    expected = attention_reference(q.contiguous(), k.contiguous(), v.contiguous(), 0.125)
    torch.testing.assert_close(out, expected, rtol=0, atol=1e-6)
    assert flash_attention.launches == before  # the plain version launches nothing


def test_attention_reference_is_max_stabilised():
    # Logits far beyond fp32 exp's range stay finite and exact.
    q = torch.full((1, 3, 1, 64), 30.0)
    k = torch.full((1, 5, 1, 64), 30.0)
    v = torch.arange(5, dtype=torch.float32).reshape(1, 5, 1, 1).expand(1, 5, 1, 64)
    out = attention_reference(q, k, v, 1.0)
    torch.testing.assert_close(out, torch.full((1, 3, 1, 64), 2.0))


@pytest.mark.parametrize(
    "shapes,dtype,message",
    [
        (((1, 8, 2, 32),) * 3, torch.bfloat16, "head dim 32"),
        (((1, 8, 2, 64),) * 3, torch.float16, "bf16 or fp32"),
        (((1, 8, 2, 64), (1, 9, 2, 64), (1, 8, 2, 64)), torch.bfloat16, "shape mismatch"),
    ],
)
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(shapes, dtype, message):
    q, k, v = (torch.zeros(s, dtype=dtype) for s in shapes)
    with pytest.raises((ValueError, TypeError), match=message):
        _check(q, k, v)


def test_kernel_wrapper_rejects_unit_stride_violations():
    x = torch.zeros(1, 8, 2, 128)[..., ::2]  # head-dim stride 2
    with pytest.raises(ValueError, match="head-dim stride"):
        _check(x, x, x)


def test_flop_and_byte_counts():
    # Flagship global layer: 1 x 10953 tokens x 12 heads x 64.
    assert attention_flops(1, 10953, 10953, 12, 64) == 4 * 12 * 10953**2 * 64
    assert attention_bytes(1, 10953, 10953, 12, 64, 2) == 4 * 10953 * 12 * 64 * 2


def test_sdpa_matches_jax():
    q, k, v = make_qkv(2, 24, 24, 2, 64, seed=11)
    ref = np.asarray(
        jax_attention.sdpa(*(jnp.asarray(x) for x in (q, k, v)), scale=0.2, implementation="xla")
    )
    out = port_attention.sdpa(*(torch.from_numpy(x) for x in (q, k, v)), scale=0.2)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("num_tokens", [17, 1370, 10953])
def test_query_scalings_match_jax(num_tokens):
    q = np.random.RandomState(num_tokens).randn(1, 4, 2, 64).astype(np.float32)
    tq = torch.from_numpy(q)
    np.testing.assert_allclose(
        port_attention.apply_scalable_softmax(tq, num_tokens).numpy(),
        np.asarray(jax_attention.apply_scalable_softmax(jnp.asarray(q), num_tokens)),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        port_attention.apply_entropy_scaling(tq, num_tokens, 444, 1.4).numpy(),
        np.asarray(jax_attention.apply_entropy_scaling(jnp.asarray(q), num_tokens, 444, 1.4)),
        rtol=1e-6,
    )
    assert math.isclose(
        port_attention.apply_scalable_softmax(torch.ones(1), num_tokens).item(),
        math.log(num_tokens),
        rel_tol=1e-6,
    )
