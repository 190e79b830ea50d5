"""The fp32 attention forward's split arithmetic on the CPU, against the JAX package.

The port's fp32 forward kernel (``fa_fwd_f32`` in ``csrc/flash_attention_fwd.cu``)
runs on the tensor cores: a split pass writes q, k and v as three bf16 parts
each (hi, mid, lo), and both products, S = Q Kᵀ and P V, become six bf16
products of the parts summed in fp32. It streams key tiles of
``FWD_F32_TILES``' width with a base-2 online softmax: S of each tile in one
fp32 sum of six passes, P split into three parts in registers, the tile's P V
into a fresh accumulator, then O = alpha O + P V in fp32. A CUDA kernel cannot
run here, so that arithmetic is emulated tile by tile. The emulated o and lse
are held to the JAX package's fp32 ``flash_attention`` and
``flash_attention_lse`` (its Pallas kernels in interpret mode:
``_fwd_kernel_single(_lse)`` at one key block, ``_fwd_stream_aug(_lse)`` at
several with D = 64, ``_fwd_kernel(_lse)`` at D = 128) and to 4x the fp32 plain
version's own error against fp64; one bf16 pass misses that bound. The fp32
forward's tensor maps are checked against its tile plan, and the three-tensor
split against its plain version. Inputs are made with numpy from fixed seeds.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapanything_tpu.ops import flash_attention as jax_fa
from mapanything_tpu_torch.ops import flash_attention as port_fa
from mapanything_tpu_torch.utils import threads
from test_torch_port_fp32_backward import ONE_PASS, PLAIN_FACTOR, SIX_PASSES, max_abs, split_product
from test_torch_port_headdim128 import pallas_kernels

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

FWD_ATOL = 2e-4  # the fp32 parity tests' tolerance against the JAX package
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# (name, B, Tq, Tk, H, D, the JAX kernels that run: lse-free, then lse). The JAX dispatch
# takes key blocks of at least 512 (_pick_blocks): one block up to 512 keys, two at 600.
# Tq != Tk; at 600 keys the kernel's key tiles (96 keys at D = 64, 32 at D = 128) leave a
# last tile that is mostly masked.
CASES = [
    ("single_d64", 2, 90, 70, 2, 64, ["_fwd_kernel_single", "_fwd_kernel_single_lse"]),
    ("stream_d64", 1, 150, 600, 2, 64, ["_fwd_stream_aug", "_fwd_stream_aug_lse"]),
    ("k8_d128", 1, 130, 600, 2, 128, ["_fwd_kernel", "_fwd_kernel_lse"]),
]


def merged_product(eq: str, p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """P V as the narrow forward computes it (kMergedPV): P_hi [V_hi V_mid V_lo], P_mid
    [V_hi V_mid] and P_lo V_hi, each product of bf16 parts exact in fp32, summed into three
    column blocks, then (hi·lo + (hi·mid + mid·mid)) + (hi·hi + mid·hi + lo·hi)."""
    pp, pv = port_fa.split_bf16x3_reference(p).float(), port_fa.split_bf16x3_reference(v).float()
    block = lambda i, j: torch.einsum(eq, pp[i], pv[j])  # noqa: E731
    c0 = block(0, 0) + block(1, 0) + block(2, 0)
    c1 = block(0, 1) + block(1, 1)
    return (block(0, 2) + c1) + c0


def split_forward(q, k, v, scale, passes=SIX_PASSES, block_n=None):
    """o (B, Tq, H, D) and lse (B, H, Tq) of the fp32 forward kernel's arithmetic, over
    key tiles of ``block_n`` keys (by default ``FWD_F32_TILES``' width, at D = 32 and 48
    the narrow forward's streaming tiles): S as a split product, the base-2 online
    softmax in fp32, P split into its parts, each tile's P V as a split product into a
    fresh sum (at D = 32 and 48 with six passes, the narrow forward's merged products),
    and O rescaled and added to in fp32."""
    b, tq, h, d = q.shape
    narrow = d in port_fa.NARROW_HEAD_DIMS
    if block_n is None:
        block_n = port_fa.NARROW_STREAM_KEYS[d] if narrow else port_fa.FWD_F32_TILES[d][1]
    scale_log2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    m = torch.full((b, h, tq), -torch.inf)
    l = torch.zeros(b, h, tq)
    o = torch.zeros(b, h, tq, d)
    for j0 in range(0, k.shape[1], block_n):
        kj, vj = k[:, j0:j0 + block_n], v[:, j0:j0 + block_n]
        s = split_product("bqhd,bkhd->bhqk", q, kj, passes)
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = (merged_product("bhqk,bkhd->bhqd", p, vj) if narrow and passes == SIX_PASSES
              else split_product("bhqk,bkhd->bhqd", p, vj, passes))
        o = o * alpha[..., None] + pv
        m = m_new
    return (o / l[..., None]).transpose(1, 2), (m + torch.log2(l)) * LN2


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    """One case's inputs, the JAX package's fp32 o (lse-free) and (o, lse) in interpret
    mode with the Pallas kernels each ran, and the port's plain (o, lse) in fp32 and fp64."""
    name, b, tq, tk, h, d, kernels = request.param
    rng = np.random.RandomState(tq * 1000 + tk + d)
    q = rng.randn(b, tq, h, d).astype(np.float32)
    k, v = (rng.randn(b, tk, h, d).astype(np.float32) for _ in range(2))
    scale = d**-0.5
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    kw = dict(block_q=128, block_k=128, interpret=True)
    o_free, free_ran = pallas_kernels(lambda: jax_fa.flash_attention(jq, jk, jv, scale, **kw))
    (o, lse), lse_ran = pallas_kernels(lambda: jax_fa.flash_attention_lse(jq, jk, jv, scale, **kw))
    inputs = tuple(torch.from_numpy(x) for x in (q, k, v))
    return dict(name=name, kernels=kernels, ran=free_ran + lse_ran, inputs=inputs, scale=scale,
                jax=dict(o_free=np.asarray(o_free), o=np.asarray(o), lse=np.asarray(lse)),
                plain=dict(zip(("o", "lse"), port_fa.attention_lse_reference(*inputs, scale))),
                exact=dict(zip(("o", "lse"), port_fa.attention_lse_reference(*(x.double() for x in inputs), scale))))


def test_jax_dispatch_reaches_the_fp32_forward_kernels(case):
    # fp32 never takes the packed or head-pair kernels: one key block runs
    # _fwd_kernel_single, several K3/K7's augmented stream at d % 128 != 0, K8's at 128.
    assert case["ran"] == case["kernels"]


@pytest.mark.parametrize("out", ["o", "lse"])
def test_six_pass_split_forward_matches_jax_and_fp32(case, out, record_property):
    got = dict(zip(("o", "lse"), split_forward(*case["inputs"], case["scale"])))[out]
    err_jax = max_abs(got, case["jax"][out])
    if out == "o":  # the lse-free JAX kernel too
        err_jax = max(err_jax, max_abs(got, case["jax"]["o_free"]))
    err = max_abs(got, case["exact"][out])
    plain_err = max_abs(case["plain"][out], case["exact"][out])
    record_property("max_abs_err", {"jax": err_jax, "fp64": err, "plain_fp32_vs_fp64": plain_err})
    assert err_jax <= FWD_ATOL, f"{out}: {err_jax} from the JAX package"
    assert err <= PLAIN_FACTOR * plain_err, f"{out}: {err} from fp64, plain fp32 {plain_err}"


@pytest.mark.parametrize("out", ["o", "lse"])
def test_one_bf16_pass_misses_the_fp32_bound(case, out, record_property):
    # The reason for six passes: the hi parts alone carry 8 significand bits.
    got = dict(zip(("o", "lse"), split_forward(*case["inputs"], case["scale"], ONE_PASS)))[out]
    err = max_abs(got, case["exact"][out])
    plain_err = max_abs(case["plain"][out], case["exact"][out])
    record_property("max_abs_err", {"fp64": err, "plain_fp32_vs_fp64": plain_err})
    assert err > PLAIN_FACTOR * plain_err * 10, f"{out}: one pass {err}, plain fp32 {plain_err}"


@pytest.mark.parametrize("d", [64, 128])
def test_fp32_forward_tensor_maps_follow_the_tile_plan(d):
    # Each (3, B, T, H, D) part tensor of q, k and v is one (3B, T, H, D) map, part p of
    # batch b at p·B + b: q boxed by the work tile's query rows, k and v by the key tile.
    b, tq, tk, h = 2, 37, 90, 3
    parts = [torch.zeros(3, b, t, h, d, dtype=torch.bfloat16) for t in (tq, tk, tk)]
    rows_q, rows_kv = port_fa.FWD_F32_TILES[d]
    packed = struct.unpack(f"{3 * 11}q", port_fa._fwd_f32_tensor_maps(*parts))
    for i, (t, rows) in enumerate(zip((tq, tk, tk), (rows_q, rows_kv, rows_kv))):
        item = 2
        assert packed[11 * i:11 * (i + 1)] == (d, t, h, 3 * b, h * d * item, d * item, t * h * d * item,
                                               64, rows, 1, 1)


def test_forward_split_reads_fused_qkv_views():
    # The forward's split takes q, k and v alone, as the views Attention cuts from its
    # fused qkv projection, and writes three contiguous (3, B, T, H, D) parts; on CPU
    # tensors the wrappers run the plain versions and launch nothing.
    rng = np.random.RandomState(2)
    qkv = torch.from_numpy(rng.randn(2, 9, 3, 2, 64).astype(np.float32))
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    port_fa.reset_launch_counts()
    parts = port_fa.flash_attention_split_f32(q, k, v)
    o = port_fa.flash_attention(q, k, v)
    o_lse, lse = port_fa.flash_attention_lse(q, k, v)
    assert all(n == 0 for n in port_fa.launch_counts().values())
    assert len(parts) == 3
    for x, p in zip((q, k, v), parts):
        assert p.shape == (3, *x.shape) and p.is_contiguous() and p.dtype == torch.bfloat16
        assert torch.equal(p, port_fa.split_bf16x3_reference(x.contiguous()))
    want_o, want_lse = port_fa.attention_lse_reference(q, k, v)
    assert torch.equal(o, port_fa.attention_reference(q, k, v))
    assert torch.equal(o_lse, want_o) and torch.equal(lse, want_lse)
