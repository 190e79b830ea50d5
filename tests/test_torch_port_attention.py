"""The port's attention against the JAX package's, on the CPU.

On the CPU the port's ``flash_attention`` runs its plain versions; the JAX
side runs its Pallas kernels in interpret mode, in each regime that the
main path reaches on the TPU (K1 packed, K2 head-pair streaming, K3/K4 3D;
under differentiation K4 with K5, and K6).
All inputs are made with numpy from fixed seeds; fp32 throughout. Logits
stay inside the (-83, +110)-nat range where the TPU kernels' constant-shift
softmax equals the max-stabilised one.
"""

import math
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapanything_tpu.ops import attention as jax_attention
from mapanything_tpu.ops.flash_attention import _use_packed, _use_pair
from mapanything_tpu.ops.flash_attention import flash_attention as jax_flash
from mapanything_tpu.ops.flash_attention import flash_attention_bwd_lse as jax_bwd_lse
from mapanything_tpu.ops.flash_attention import flash_attention_lse as jax_flash_lse
from mapanything_tpu_torch.ops import attention as port_attention
from mapanything_tpu_torch.ops.flash_attention import (
    BWD_TILES,
    _bwd_tensor_maps,
    _check,
    _check_bwd,
    attention_bwd_bytes,
    attention_bwd_flops,
    attention_bytes,
    attention_flops,
    attention_reference,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_lse,
    flash_attention_lse,
    launch_counts,
    reset_launch_counts,
    tensor_map,
)
from mapanything_tpu_torch.utils import threads

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

ATOL = 2e-5  # as tests/test_flash_attention.py holds the Pallas kernels to XLA
GRAD_ATOL = 2e-4  # its tolerance for gradients


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


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize(
    "make,rows,want",
    [
        # contiguous (B, T, H, D): byte strides of T, H, B are H·D·2, D·2, T·H·D·2
        (lambda: _bf16(2, 50, 4, 64), 128, ((64, 50, 4, 2), (512, 128, 25600), (64, 128, 1, 1))),
        (lambda: _bf16(2, 50, 4, 128), 128, ((128, 50, 4, 2), (1024, 256, 51200), (64, 128, 1, 1))),
        # q of a fused qkv (B, T, 3, H, D): T-stride 3·H·D, H-stride D, not monotonic
        (lambda: _bf16(2, 50, 3, 4, 64).unbind(2)[0], 128, ((64, 50, 4, 2), (1536, 128, 76800), (64, 128, 1, 1))),
        (lambda: _bf16(1, 9, 3, 6, 128).unbind(2)[2], 128, ((128, 9, 6, 1), (4608, 256, 41472), (64, 128, 1, 1))),
        # one token
        (lambda: _bf16(1, 1, 6, 128), 128, ((128, 1, 6, 1), (1536, 256, 1536), (64, 128, 1, 1))),
        # a misaligned base (2 bytes in) and a misaligned token stride (68 columns)
        (lambda: _bf16(1 + 5 * 2 * 64)[1:].view(1, 5, 2, 64), 128, "16-byte aligned"),
        (lambda: _bf16(1, 5, 2, 68)[..., :64], 128, "16-byte aligned"),
        (lambda: _bf16(1, 5, 2, 128)[..., ::2], 128, "head-dim stride"),
        # the backward's boxes (BWD_TILES): dq's key tiles, dk/dv's query stages
        (lambda: _bf16(2, 50, 4, 64), BWD_TILES[64]["dq"][1],
         ((64, 50, 4, 2), (512, 128, 25600), (64, BWD_TILES[64]["dq"][1], 1, 1))),
        (lambda: _bf16(2, 50, 4, 128), BWD_TILES[128]["dq"][1],
         ((128, 50, 4, 2), (1024, 256, 51200), (64, BWD_TILES[128]["dq"][1], 1, 1))),
        (lambda: _bf16(2, 50, 3, 4, 64).unbind(2)[1], BWD_TILES[64]["dkv"][1],
         ((64, 50, 4, 2), (1536, 128, 76800), (64, BWD_TILES[64]["dkv"][1], 1, 1))),
        # dO as a view of a wider (B, T, 2, H, D) tensor: T-stride 2·H·D
        (lambda: _bf16(1, 9, 2, 6, 128)[:, :, 1], BWD_TILES[128]["dkv"][1],
         ((128, 9, 6, 1), (3072, 256, 27648), (64, BWD_TILES[128]["dkv"][1], 1, 1))),
        (lambda: _bf16(1 + 5 * 2 * 128)[1:].view(1, 5, 2, 128), BWD_TILES[128]["dkv"][1], "16-byte aligned"),
        (lambda: _bf16(1, 5, 1, 68)[..., :64], BWD_TILES[64]["dkv"][1], "16-byte aligned"),  # T-stride 136 bytes
    ],
)
def test_tensor_map_layout(make, rows, want):
    # The bf16 kernels' TMA maps: dims (D, T, H, B), byte strides of T, H, B, box (64, rows, 1, 1).
    x = make()
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            tensor_map(x, rows)
    else:
        assert tensor_map(x, rows) == want


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("fused", [False, True])
def test_backward_tensor_maps_follow_the_tile_plan(kernel, d, fused):
    # q, k, v and dO in that order, q and dO boxed by query rows, k and v by keys: the
    # dq kernel owns query rows and streams keys, the dk/dv kernel the other way round.
    if fused:
        q, k, v = _bf16(2, 37, 3, 3, d).unbind(2)
        do = _bf16(2, 37, 2, 3, d)[:, :, 0]
    else:
        q, do = _bf16(2, 37, 3, d), _bf16(2, 37, 3, d)
        k, v = _bf16(2, 90, 3, d), _bf16(2, 90, 3, d)
    own, streamed = BWD_TILES[d][kernel]
    rows_q, rows_kv = (own, streamed) if kernel == "dq" else (streamed, own)
    packed = struct.unpack(f"{4 * 11}q", _bwd_tensor_maps(kernel, q, k, v, do))
    for i, (x, rows) in enumerate(((q, rows_q), (k, rows_kv), (v, rows_kv), (do, rows_q))):
        assert packed[11 * i:11 * (i + 1)] == tuple(n for part in tensor_map(x, rows) for n in part)


@pytest.mark.parametrize(
    "make_do,in_place",
    [
        (lambda: _bf16(1, 1, 1, 1).expand(2, 9, 3, 64), False),  # the cotangent of a sum: every stride 0
        (lambda: torch.randn(2, 9, 1, 64).bfloat16().expand(2, 9, 3, 64), False),  # broadcast over heads
        (lambda: torch.randn(2, 9, 3, 128).bfloat16()[..., ::2], False),  # head-dim stride 2
        (lambda: torch.randn(2 * 9 * 3 * 64 + 1).bfloat16()[1:].view(2, 9, 3, 64), False),  # base 2 bytes off
        (lambda: torch.randn(2, 9, 3, 64), False),  # fp32 against bf16 q: converted
        (lambda: torch.randn(2, 3, 9, 64).bfloat16().transpose(1, 2), True),  # (B, H, T, D) storage: TMA reads it
    ],
)
def test_backward_wrapper_hands_the_kernel_an_aligned_cotangent(make_do, in_place):
    # dO as autograd may hand it: the wrapper passes on what TMA can read in place and
    # copies the rest, values untouched.
    q = _bf16(2, 9, 3, 64)
    stats = torch.zeros(2, 3, 9)
    do = make_do()
    got = _check_bwd(q, q, q, do, stats, stats)
    assert got.dtype == torch.bfloat16
    tensor_map(got, BWD_TILES[64]["dkv"][1])  # raises unless TMA can read it
    assert all(s > 0 for s in got.stride())
    assert (got.data_ptr() == do.data_ptr()) == in_place
    torch.testing.assert_close(got, do.to(torch.bfloat16), rtol=0, atol=0)


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


# ---------------------------------------------------------------- under differentiation


def max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def test_lse_forward_matches_jax_k4_one_pass(record_property):
    q, k, v = make_qkv(1, 100, 100, 2, 64, seed=21)
    o_ref, lse_ref = jax_flash_lse(*(jnp.asarray(x) for x in (q, k, v)), 0.17, interpret=True)
    o, lse = flash_attention_lse(*(torch.from_numpy(x) for x in (q, k, v)), 0.17)
    assert lse.shape == (1, 2, 100) and lse.dtype == torch.float32
    record_property("max_abs_err", {"o": max_abs(o, o_ref), "lse": max_abs(lse, lse_ref)})
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=ATOL)


@pytest.mark.parametrize("regime,t", [("K4 forward + K5 backward", 300), ("K6 head-pair", 2100)])
def test_gradients_match_jax(regime, t, record_property):
    q, k, v = make_qkv(1, t, t, 2, 64, seed=t + 1)
    do = np.random.RandomState(t + 2).randn(1, t, 2, 64).astype(np.float32)
    scale = 0.125
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    assert _use_pair(jq, jk, interpret=True) == regime.startswith("K6")

    def loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, scale, interpret=True) * jdo)

    ref = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, scale)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    record_property("max_abs_err", {f"d{n}": max_abs(g, r) for n, g, r in zip("qkv", grads, ref)})
    for name, g, r in zip("qkv", grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL, err_msg=f"d{name}")


def test_bwd_lse_on_kv_blocks_matches_jax(record_property):
    # One global softmax, its backward taken block by block over the keys
    # (ring attention's building block), as tests/test_flash_attention.py does.
    b, tq, tk, h, d = 1, 160, 384, 2, 64
    scale = d**-0.5
    q, k, v = make_qkv(b, tq, tk, h, d, seed=5)
    do = np.random.RandomState(6).randn(b, tq, h, d).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o, lse = jax_flash_lse(jq, jk, jv, scale, 128, 128, interpret=True)
    to, tlse, tdo = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse)), torch.from_numpy(do)
    dq_total = np.zeros_like(q)
    errs = {}
    for j in range(3):
        sl = slice(j * 128, (j + 1) * 128)
        ref = jax_bwd_lse(jq, jk[:, sl], jv[:, sl], o, lse, jdo, scale=scale, block_q=128, block_k=128,
                          interpret=True)
        got = flash_attention_bwd_lse(
            torch.from_numpy(q), torch.from_numpy(k[:, sl].copy()), torch.from_numpy(v[:, sl].copy()),
            to, tlse, tdo, scale,
        )
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            errs[name] = max(errs.get(name, 0.0), max_abs(g, r))
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL, err_msg=f"{name}, block {j}")
        dq_total += got[0].numpy()
    # the blocks' dq parts sum to the dense gradient
    tq_, tk_, tv_ = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(attention_reference(tq_, tk_, tv_, scale), tq_, tdo)[0]
    np.testing.assert_allclose(dq_total, want.numpy(), atol=GRAD_ATOL)
    record_property("max_abs_err", errs)


def test_plain_backward_passes_gradcheck_in_fp64():
    # The full Jacobian in fp64, Tq != Tk and two heads. Thousands of tiny ops:
    # one intra-op thread keeps them from waiting on a pool shared with other
    # busy processes.
    rng = np.random.RandomState(8)
    q = torch.from_numpy(rng.randn(1, 3, 2, 64)).requires_grad_()
    k, v = (torch.from_numpy(rng.randn(1, 4, 2, 64)).requires_grad_() for _ in range(2))
    with threads.single_thread():
        assert torch.autograd.gradcheck(lambda a, b, c: flash_attention(a, b, c, 0.3), (q, k, v))


def test_split_backward_wrappers_agree_with_the_whole():
    q, k, v = (torch.from_numpy(x) for x in make_qkv(1, 40, 56, 2, 64, seed=9))
    do = torch.from_numpy(np.random.RandomState(10).randn(1, 40, 2, 64).astype(np.float32))
    o, lse = flash_attention_lse(q, k, v, 0.2)
    dq, dk, dv = flash_attention_bwd_lse(q, k, v, o, lse, do, 0.2)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    torch.testing.assert_close(flash_attention_bwd_dq(q, k, v, do, lse, delta, 0.2), dq, rtol=0, atol=0)
    for got, want in zip(flash_attention_bwd_dkv(q, k, v, do, lse, delta, 0.2), (dk, dv)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_routing_inference_and_training_and_counts():
    q, k, v = (torch.from_numpy(x) for x in make_qkv(1, 24, 24, 2, 64, seed=12))
    reset_launch_counts()
    with torch.no_grad():
        assert flash_attention(q.requires_grad_(), k, v).grad_fn is None  # lse-free forward
    assert flash_attention(q, k, v).grad_fn is not None  # the autograd Function
    with torch.inference_mode():
        assert flash_attention(q.detach(), k, v).grad_fn is None
    # CPU tensors run the plain versions and launch no kernel
    assert launch_counts() == {
        "flash_attention_fwd": 0, "flash_attention_fwd_lse": 0,
        "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0, "flash_attention_split_f32": 0,
        "flash_attention_masked_fwd": 0, "flash_attention_masked_fwd_lse": 0,
        "flash_attention_masked_bwd_dq": 0, "flash_attention_masked_bwd_dkv": 0,
    }


def test_backward_wrapper_rejects_bad_statistics():
    q = torch.zeros(1, 8, 2, 64)
    ok = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="do not fit"):
        _check_bwd(q, q, q, q, torch.zeros(1, 2, 9), ok)
    with pytest.raises(ValueError, match="contiguous fp32"):
        _check_bwd(q, q, q, q, ok.double(), ok)


def test_backward_flop_and_byte_counts():
    # Flagship training global layer: 1 x 5477 tokens x 12 heads x 64.
    assert attention_bwd_flops(1, 5477, 5477, 12, 64) == 10 * 12 * 5477**2 * 64
    assert attention_bwd_bytes(1, 5477, 5477, 12, 64, 2) == 8 * 5477 * 12 * 64 * 2 + 4 * 12 * 5477
