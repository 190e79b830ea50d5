"""The fp32 attention backward's split arithmetic on the CPU, against the JAX package.

The port's fp32 dq and dk/dv kernels (``csrc/flash_attention_bwd.cu``) run on
the tensor cores: a split pass writes each fp32 operand x as three bf16 parts,
hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), and every product
A·B becomes six bf16 products of the parts (lo·hi, mid·mid, hi·lo, mid·hi,
hi·mid, hi·hi) summed in fp32. A CUDA kernel cannot run here, so its
arithmetic is emulated: the parts upcast to fp32 and the six products summed.
The emulated dq, dk and dv are held to the JAX package's fp32
``flash_attention_bwd_lse`` (its Pallas kernels in interpret mode: K5's
``_dq_aug_kernel`` and ``_dkv_aug_kernel`` at D = 64, K8's ``_dq_kernel`` and
``_dkv_kernel`` at D = 128) and to 4x the fp32 plain version's own error
against fp64; one bf16 pass misses that bound. The split's plain version
(``split_bf16x3_reference``, which the card holds the split kernel to
bitwise) is checked against its definition, and the fp32 kernels' tensor maps
against their tile plan. Inputs are made with numpy from fixed seeds.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapanything_tpu.ops import flash_attention as jax_fa
from mapanything_tpu_torch.ops import flash_attention as port_fa
from mapanything_tpu_torch.utils import threads
from test_torch_port_headdim128 import pallas_kernels

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

GRAD_ATOL = 2e-4  # the fp32 gradient parity tests' tolerance (tests/test_torch_port_attention.py)
PLAIN_FACTOR = 4.0  # the split arithmetic's error against fp64, in units of the fp32 plain version's
LOG2E = 1.4426950408889634
# The six passes of a split product, (part of A, part of B), 0 = hi, 1 = mid, 2 = lo, in
# the kernels' order (pass_a, pass_b in the CUDA source).
SIX_PASSES = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))
ONE_PASS = ((0, 0),)
# (name, B, Tq, Tk, H, D, the JAX kernels that run: the lse forward, then the backward):
# Tq != Tk, lengths off every block.
CASES = [
    ("d64", 1, 150, 97, 2, 64, ["_fwd_kernel_single_lse", "_dq_aug_kernel", "_dkv_aug_kernel"]),
    ("d128", 1, 70, 130, 2, 128, ["_fwd_kernel_single_lse", "_dq_kernel", "_dkv_kernel"]),
]


def split_product(eq: str, a: torch.Tensor, b: torch.Tensor, passes=SIX_PASSES) -> torch.Tensor:
    """einsum(eq, a, b) of fp32 a and b as the kernels compute it: the products of the
    bf16 parts named by ``passes``, each exact in fp32, summed in fp32 in that order."""
    pa, pb = port_fa.split_bf16x3_reference(a).float(), port_fa.split_bf16x3_reference(b).float()
    out = torch.einsum(eq, pa[passes[0][0]], pb[passes[0][1]])
    for i, j in passes[1:]:
        out = out + torch.einsum(eq, pa[i], pb[j])
    return out


def split_backward(q, k, v, do, lse, delta, scale, passes=SIX_PASSES):
    """dq, dk and dv of the fp32 kernels' arithmetic: S and dP as split products, P and
    dS formed in fp32 (base 2, as the kernels do), then dQ = dS K scale, dK = dSᵀ Q scale
    and dV = Pᵀ dO as split products."""
    s = split_product("bqhd,bkhd->bhqk", q, k, passes)
    dp = split_product("bqhd,bkhd->bhqk", do, v, passes)
    scale_log2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    p = torch.exp2(s * scale_log2 - (lse * LOG2E)[..., None])
    ds = p * (dp - delta[..., None])
    dq = split_product("bhqk,bkhd->bqhd", ds, k, passes) * scale
    dk = split_product("bhqk,bqhd->bkhd", ds, q, passes) * scale
    dv = split_product("bhqk,bqhd->bkhd", p, do, passes)
    return dq, dk, dv


def max_abs(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    """One case's inputs, the JAX package's (o, lse) and fp32 backward in interpret mode
    with the Pallas kernels it ran, and the port's plain backward in fp32 and fp64."""
    name, b, tq, tk, h, d, kernels = request.param
    rng = np.random.RandomState(tq * 1000 + tk)
    q, do = (rng.randn(b, tq, h, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, tk, h, d).astype(np.float32) for _ in range(2))
    scale = d**-0.5
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    kw = dict(block_q=128, block_k=128, interpret=True)
    (o, lse), fwd_ran = pallas_kernels(lambda: jax_fa.flash_attention_lse(jq, jk, jv, scale, **kw))
    grads, bwd_ran = pallas_kernels(lambda: jax_fa.flash_attention_bwd_lse(jq, jk, jv, o, lse, jdo, scale, **kw))
    tq_, tk_, tv_, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    to, tlse = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse))
    delta = port_fa.attention_bwd_delta(to, tdo).contiguous()
    plain = dict(zip(("dq", "dk", "dv"), (
        port_fa.attention_bwd_dq_reference(tq_, tk_, tv_, tdo, tlse, delta, scale),
        *port_fa.attention_bwd_dkv_reference(tq_, tk_, tv_, tdo, tlse, delta, scale))))
    x64 = [x.double() for x in (tq_, tk_, tv_, tdo, tlse, delta)]
    exact = dict(zip(("dq", "dk", "dv"), (
        port_fa.attention_bwd_dq_reference(*x64, scale),
        *port_fa.attention_bwd_dkv_reference(*x64, scale))))
    return dict(name=name, kernels=kernels, ran=fwd_ran + bwd_ran, inputs=(tq_, tk_, tv_, tdo, tlse, delta),
                scale=scale, jax=dict(zip(("dq", "dk", "dv"), (np.asarray(g) for g in grads))), plain=plain,
                exact=exact)


def test_jax_dispatch_reaches_the_fp32_backward_kernels(case):
    # fp32 never takes the head-pair kernels (_use_pair refuses it): K5 at d % 128 != 0,
    # K8 at d % 128 == 0.
    assert case["ran"] == case["kernels"]


@pytest.mark.parametrize("out", ["dq", "dk", "dv"])
def test_six_pass_split_backward_matches_jax_and_fp32(case, out, record_property):
    got = dict(zip(("dq", "dk", "dv"), split_backward(*case["inputs"], case["scale"])))[out]
    err_jax = max_abs(got, case["jax"][out])
    err = max_abs(got, case["exact"][out])
    plain_err = max_abs(case["plain"][out], case["exact"][out])
    record_property("max_abs_err", {"jax": err_jax, "fp64": err, "plain_fp32_vs_fp64": plain_err})
    assert err_jax <= GRAD_ATOL, f"{out}: {err_jax} from the JAX package"
    assert err <= PLAIN_FACTOR * plain_err, f"{out}: {err} from fp64, plain fp32 {plain_err}"


@pytest.mark.parametrize("out", ["dq", "dk", "dv"])
def test_one_bf16_pass_misses_the_fp32_bound(case, out, record_property):
    # The reason for six passes: the hi parts alone carry 8 significand bits.
    got = dict(zip(("dq", "dk", "dv"), split_backward(*case["inputs"], case["scale"], ONE_PASS)))[out]
    err = max_abs(got, case["exact"][out])
    plain_err = max_abs(case["plain"][out], case["exact"][out])
    record_property("max_abs_err", {"fp64": err, "plain_fp32_vs_fp64": plain_err})
    assert err > PLAIN_FACTOR * plain_err * 10, f"{out}: one pass {err}, plain fp32 {plain_err}"


def split_inputs():
    """fp32 values of |x| spread over [2^-100, 2^100], both signs, and ±0."""
    rng = np.random.RandomState(0)
    mag = np.exp2(rng.uniform(-100, 100, 4094)) * rng.choice([-1.0, 1.0], 4094)
    x = np.concatenate([mag, [0.0, -0.0]]).astype(np.float32)
    return torch.from_numpy(x)


def test_split_parts_carry_every_bit():
    x = split_inputs()
    hi, mid, lo = port_fa.split_bf16x3_reference(x)
    assert (hi.dtype, mid.dtype, lo.dtype) == (torch.bfloat16,) * 3
    x64 = x.double()
    # Both differences are exact in fp32, and the parts sum to x within 2^-24 |x|.
    r1 = x - hi.float()
    assert torch.equal(r1.double(), x64 - hi.double())
    assert torch.equal((r1 - mid.float()).double(), r1.double() - mid.double())
    assert torch.equal(mid, r1.bfloat16()) and torch.equal(lo, (r1 - mid.float()).bfloat16())
    gap = (hi.double() + mid.double() + lo.double() - x64).abs()
    assert bool((gap <= 2.0**-24 * x64.abs()).all()), float((gap / x64.abs().clamp_min(1e-300)).max())
    # ±0: hi keeps the sign bit, mid and lo are 0.
    zeros = x == 0
    assert torch.equal(torch.signbit(hi[zeros]), torch.signbit(x[zeros]))
    assert not bool(mid[zeros].float().any()) and not bool(lo[zeros].float().any())


def test_split_reads_fused_qkv_views():
    # The split reads q, k, v as the views Attention cuts from its fused qkv projection,
    # and writes contiguous (3, B, T, H, D) parts; the CPU wrapper runs the plain version
    # and launches nothing.
    rng = np.random.RandomState(1)
    qkv = torch.from_numpy(rng.randn(2, 9, 3, 2, 64).astype(np.float32))
    q, k, v = qkv.unbind(2)
    do = torch.from_numpy(rng.randn(2, 9, 2, 2, 64).astype(np.float32))[:, :, 1]
    assert not q.is_contiguous() and not do.is_contiguous()
    port_fa.reset_launch_counts()
    parts = port_fa.flash_attention_split_f32(q, k, v, do)
    assert port_fa.launch_counts()["flash_attention_split_f32"] == 0
    for x, p in zip((q, k, v, do), parts):
        assert p.shape == (3, *x.shape) and p.is_contiguous() and p.dtype == torch.bfloat16
        assert torch.equal(p, port_fa.split_bf16x3_reference(x.contiguous()))


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("d", [64, 128])
def test_fp32_tensor_maps_follow_the_tile_plan(kernel, d):
    # Each (3, B, T, H, D) part tensor is one (3B, T, H, D) map, part p of batch b at
    # p·B + b: q and dO boxed by query rows, k and v by keys, as BWD_F32_TILES says.
    b, tq, tk, h = 2, 37, 90, 3
    parts = [torch.zeros(3, b, t, h, d, dtype=torch.bfloat16) for t in (tq, tk, tk, tq)]
    own, streamed = port_fa.BWD_F32_TILES[d][kernel]
    rows_q, rows_kv = (own, streamed) if kernel == "dq" else (streamed, own)
    packed = struct.unpack(f"{4 * 11}q", port_fa._bwd_f32_tensor_maps(kernel, *parts))
    for i, (x, t, rows) in enumerate(zip(parts, (tq, tk, tk, tq), (rows_q, rows_kv, rows_kv, rows_q))):
        item = 2
        assert packed[11 * i:11 * (i + 1)] == (d, t, h, 3 * b, h * d * item, d * item, t * h * d * item,
                                               64, rows, 1, 1)
