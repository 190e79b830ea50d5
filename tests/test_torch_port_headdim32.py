"""The port at head dim 32 against the JAX package, on the CPU.

D = 32 is the RGB models' MAE decoder (16 heads of 32 at width 512), which runs
in fp32 whatever the model's dtype. There the JAX package's Pallas kernels are
``_fwd_kernel_single(_lse)`` at one key block and ``_fwd_stream_aug(_lse)`` at
several (d % 128 != 0), with ``_dq_aug_kernel`` and ``_dkv_aug_kernel`` in the
backward. Here they run in interpret mode at a length that takes the single
pass (70 keys) and one that takes the stream (600 keys, two blocks of 512), and
the port's plain versions (what its fp32 D = 32 Hopper instances are held to on
the card) are held to them: the forward, the lse and the gradients. The six-pass
split arithmetic of the fp32 kernels is emulated at D = 32 as the fp32 tests do
at 64 and 128: the forward's over the narrow forward's streamed key tiles (its
packed tiles: ``tests/test_torch_port_narrow_f32.py``), the backward's as the
true-width kernels compute it (``fa_bwd_dq_f32_narrow``, ``fa_bwd_dkv_f32_narrow``):
parts 32 columns wide, each key tile's (query stage's) merged products in a fresh
sum, at the plan's tile sizes. Then the split's true-width parts, the backward's
tensor maps of 16-column boxes, the plans' coverage of every row and key, and the
head dims each dtype has. fp32 throughout; inputs from numpy seeds.
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mapanything_tpu.ops import flash_attention as jax_fa
from mapanything_tpu_torch.ops import flash_attention as port_fa
from mapanything_tpu_torch.utils import threads
from test_torch_port_fp32_backward import LOG2E, PLAIN_FACTOR, split_inputs, split_product
from test_torch_port_fp32_forward import merged_product, split_forward
from test_torch_port_headdim128 import pallas_kernels

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

ATOL = 2e-5  # the plain forward and lse against the JAX kernels (as at D = 64 and 128)
GRAD_ATOL = 2e-4
SPLIT_ATOL = 2e-4  # the emulated split arithmetic against the JAX kernels (the fp32 tests')
D = 32
# (name, B, Tq, Tk, H, the JAX kernels that run: the lse-free forward, the lse forward,
# then the gradient's lse forward, dq and dk/dv). Key blocks are at least 512 keys.
CASES = [
    ("single", 2, 90, 70, 3, ["_fwd_kernel_single"], ["_fwd_kernel_single_lse"],
     ["_fwd_kernel_single_lse", "_dq_aug_kernel", "_dkv_aug_kernel"]),
    ("stream", 1, 150, 600, 3, ["_fwd_stream_aug"], ["_fwd_stream_aug_lse"],
     ["_fwd_stream_aug_lse", "_dq_aug_kernel", "_dkv_aug_kernel"]),
]


def max_abs(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    """One case: the JAX kernels in interpret mode (lse-free o, (o, lse), and the
    gradients of sum(o * do)) with the Pallas kernels each ran, and the inputs."""
    name, b, tq, tk, h, *kernels = request.param
    rng = np.random.RandomState(tq * 1000 + tk)
    q, do = (rng.randn(b, tq, h, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, tk, h, D).astype(np.float32) for _ in range(2))
    scale = D**-0.5
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    kw = dict(block_q=128, block_k=128, interpret=True)
    o, fwd_ran = pallas_kernels(lambda: jax_fa.flash_attention(jq, jk, jv, scale, **kw))
    (o_lse, lse), lse_ran = pallas_kernels(lambda: jax_fa.flash_attention_lse(jq, jk, jv, scale, **kw))

    def loss(q, k, v):
        return jnp.sum(jax_fa.flash_attention(q, k, v, scale, **kw) * jdo)

    grads, grad_ran = pallas_kernels(lambda: jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv))
    return dict(kernels=kernels, ran=[fwd_ran, lse_ran, grad_ran], inputs=(q, k, v, do), scale=scale,
                o=np.asarray(o), o_lse=np.asarray(o_lse), lse=np.asarray(lse), grads=[np.asarray(g) for g in grads])


def test_jax_dispatch_reaches_the_d32_kernels(case):
    assert case["ran"] == case["kernels"]


def test_forward_matches_jax(case, record_property):
    q, k, v, _ = (torch.from_numpy(x) for x in case["inputs"])
    out = port_fa.flash_attention(q, k, v, case["scale"])
    o, lse = port_fa.flash_attention_lse(q, k, v, case["scale"])
    errs = {"o": max_abs(out, case["o"]), "o_lse": max_abs(o, case["o_lse"]), "lse": max_abs(lse, case["lse"])}
    record_property("max_abs_err", errs)
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1]) and lse.dtype == torch.float32
    assert max(errs.values()) <= ATOL, errs


def test_gradients_match_jax(case, record_property):
    q, k, v, do = case["inputs"]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = port_fa.flash_attention(tq, tk, tv, case["scale"])
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    record_property("max_abs_err", {f"d{n}": max_abs(g, r) for n, g, r in zip("qkv", grads, case["grads"])})
    for name, g, r in zip("qkv", grads, case["grads"]):
        np.testing.assert_allclose(g.numpy(), r, atol=GRAD_ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("out", ["o", "lse"])
def test_six_pass_split_forward_at_d32(case, out, record_property):
    inputs = tuple(torch.from_numpy(x) for x in case["inputs"][:3])
    got = dict(zip(("o", "lse"), split_forward(*inputs, case["scale"])))[out]
    exact = dict(zip(("o", "lse"), port_fa.attention_lse_reference(*(x.double() for x in inputs), case["scale"])))
    plain = dict(zip(("o", "lse"), port_fa.attention_lse_reference(*inputs, case["scale"])))
    err_jax = max_abs(got, case["o_lse" if out == "o" else "lse"])
    err, plain_err = max_abs(got, exact[out]), max_abs(plain[out], exact[out])
    record_property("max_abs_err", {"jax": err_jax, "fp64": err, "plain_fp32_vs_fp64": plain_err})
    assert err_jax <= SPLIT_ATOL and err <= PLAIN_FACTOR * plain_err, (err_jax, err, plain_err)


def true_width_backward(q, k, v, do, lse, delta, scale):
    """dq, dk and dv of the true-width D = 32 kernels' arithmetic: S and dP as split
    products of the 32-column parts, P and dS formed in fp32 (base 2); then, key tile by key
    tile of the dq plan (query stage by query stage of the dk/dv plan), dS K, Pᵀ dO and dSᵀ Q
    as the merged products (P_hi [B_hi B_mid B_lo], P_mid [B_hi B_mid], P_lo B_hi) into a
    fresh sum, added to the running sum in fp32."""
    block_n, block_m = port_fa.BWD_F32_TILES[D]["dq"][1], port_fa.BWD_F32_TILES[D]["dkv"][1]
    s = split_product("bqhd,bkhd->bhqk", q, k)
    dp = split_product("bqhd,bkhd->bhqk", do, v)
    scale_log2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    p = torch.exp2(s * scale_log2 - (lse * LOG2E)[..., None])
    ds = p * (dp - delta[..., None])
    dq = torch.zeros(q.shape)
    for j in range(0, k.shape[1], block_n):
        dq = dq + merged_product("bhqk,bkhd->bqhd", ds[..., j:j + block_n], k[:, j:j + block_n])
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for i in range(0, q.shape[1], block_m):
        dv = dv + merged_product("bhqk,bqhd->bkhd", p[:, :, i:i + block_m], do[:, i:i + block_m])
        dk = dk + merged_product("bhqk,bqhd->bkhd", ds[:, :, i:i + block_m], q[:, i:i + block_m])
    return dq * scale, dk * scale, dv


def test_six_pass_split_backward_at_d32(case, record_property):
    q, k, v, do = (torch.from_numpy(x) for x in case["inputs"])
    o, lse = torch.from_numpy(np.array(case["o_lse"])), torch.from_numpy(np.array(case["lse"]))
    delta = port_fa.attention_bwd_delta(o, do).contiguous()
    got = true_width_backward(q, k, v, do, lse, delta, case["scale"])
    errs = {}
    for name, g, r in zip(("dq", "dk", "dv"), got, case["grads"]):
        errs[name] = max_abs(g, r)
        np.testing.assert_allclose(g.numpy(), r, atol=SPLIT_ATOL, err_msg=name)
    record_property("max_abs_err", errs)


# ---------------------------------------------------------------- the true-width parts, maps and plans


def test_split_writes_d32_parts_at_the_true_width():
    """The split pass's parts at D = 32 are 32 columns wide, no column padded, and carry
    every bit: hi + mid + lo is within 2^-24 |x| of x, as at D = 64 and 128."""
    x = split_inputs().reshape(2, 8, 8, D)
    port_fa.reset_launch_counts()
    parts = port_fa.flash_attention_split_f32(x, x, x, x)
    assert all(n == 0 for n in port_fa.launch_counts().values())  # CPU tensors: the plain version
    assert port_fa.part_cols(32) == 32 and port_fa.part_cols(64) == 64 and port_fa.part_cols(128) == 128
    for p in parts:
        assert p.shape == (3, 2, 8, 8, D) and p.is_contiguous() and p.dtype == torch.bfloat16
        assert torch.equal(p, port_fa.split_bf16x3_reference(x))
    x64 = x.double()
    gap = (parts[0].double().sum(0) - x64).abs()
    assert bool((gap <= 2.0**-24 * x64.abs()).all())


def test_split_reads_the_mae_decoders_fused_qkv_views():
    """q, k and v as the MAE decoder's Attention cuts them from its fused qkv projection
    (T-stride 3·H·D), dO a view of a wider tensor: contiguous 32-column parts of each."""
    rng = np.random.RandomState(3)
    q, k, v = torch.from_numpy(rng.randn(2, 9, 3, 4, D).astype(np.float32)).unbind(2)
    do = torch.from_numpy(rng.randn(2, 9, 2, 4, D).astype(np.float32))[:, :, 1]
    assert not q.is_contiguous() and not do.is_contiguous()
    parts = port_fa.flash_attention_split_f32(q, k, v, do)
    for x, p in zip((q, k, v, do), parts):
        assert p.shape == (3, *x.shape) and p.is_contiguous()
        assert torch.equal(p, port_fa.split_bf16x3_reference(x.contiguous()))


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_d32_tensor_maps_follow_the_true_width_plan(kernel):
    """Each (3, B, T, H, 32) part tensor is one (3B, T, H, 32) map in 16-column boxes (one
    32-byte swizzle row: two boxes a row), boxed by BWD_F32_TILES[32]'s rows: q and dO by
    query rows, k and v by keys. (The forward at D = 32 reads q, k and v in place.)"""
    b, tq, tk, h = 2, 37, 90, 3
    parts = [torch.zeros(3, b, t, h, D, dtype=torch.bfloat16) for t in (tq, tk, tk, tq)]
    own, streamed = port_fa.BWD_F32_TILES[D][kernel]
    rows_q, rows_kv = (own, streamed) if kernel == "dq" else (streamed, own)
    packed = struct.unpack(f"{4 * 11}q", port_fa._bwd_f32_tensor_maps(kernel, *parts))
    for i, (t, rows) in enumerate(zip((tq, tk, tk, tq), (rows_q, rows_kv, rows_kv, rows_q))):
        assert packed[11 * i:11 * (i + 1)] == (D, t, h, 3 * b, h * D * 2, D * 2, t * h * D * 2,
                                               port_fa.NARROW_BOX_COLS, rows, 1, 1)
    assert port_fa.NARROW_BOX_COLS == 16


def check_plan_coverage(kernel: str, b: int, tq: int, tk: int, h: int) -> None:
    """The work tiles of the D = 32 dq (dk/dv) kernel as it maps them: tile w takes block w %
    blocks of its own rows (keys) of head (w // blocks) % H of batch w // (blocks·H), and
    streams the other axis in steps of BWD_F32_TILES[32]'s width, masked at its length. Every
    (batch, head, query row) (key) is computed by exactly one tile, each tile visits every key
    (query row) exactly once, and no step is wholly past the end."""
    own, streamed = port_fa.BWD_F32_TILES[D][kernel]
    t_own, t_other = (tq, tk) if kernel == "dq" else (tk, tq)
    blocks = -(-t_own // own)
    hits = np.zeros((b, h, t_own), dtype=np.int64)
    for w in range(blocks * h * b):
        first = (w % blocks) * own
        hits[w // (blocks * h), (w // blocks) % h, first:min(first + own, t_own)] += 1
    assert (hits == 1).all(), "a row (key) computed more than once or never"
    steps = -(-t_other // streamed)
    visited = np.arange(steps * streamed)
    assert np.array_equal(visited[visited < t_other], np.arange(t_other)) and (steps - 1) * streamed < t_other


EDGE_LENGTHS = [(t, t, 2, 3) for t in (1, 7, 64, 65, 127, 129, 1370)] + [(129, 4000, 2, 3), (5476, 1, 2, 3),
                                                                          (65, 65, 16, 20), (400, 1000, 4, 24)]


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_d32_plans_cover_the_mae_decoder_and_the_edge_lengths(kernel):
    """The MAE decoder's train shape (4 x 1369 x 16) and phase 3f's and 3g's edge lengths."""
    assert port_fa.BWD_F32_TILES[D] == {"dq": (128, 64), "dkv": (128, 64)}
    check_plan_coverage(kernel, 4, 1369, 1369, 16)
    for tq, tk, b, h in EDGE_LENGTHS:
        check_plan_coverage(kernel, b, tq, tk, h)


@settings(max_examples=40, deadline=None)
@given(b=st.integers(1, 4), h=st.integers(1, 5), tq=st.integers(1, 700), tk=st.integers(1, 700),
       kernel=st.sampled_from(["dq", "dkv"]))
def test_d32_plans_cover_every_row_and_key_once(b, h, tq, tk, kernel):
    check_plan_coverage(kernel, b, tq, tk, h)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 32), (torch.float32, 48), (torch.float32, 80),
                                     (torch.bfloat16, 32), (torch.bfloat16, 48)])
def test_head_dims_without_an_instance_raise(dtype, d):
    """fp32 has D = 32, 64 and 128, and its lse-free forward also D = 48 (the VGGSfM
    tracker, inference only); bf16 64 and 128 (no path runs bf16 at 32 or 48: the RGB
    heads and the tracker are fp32). Any other D raises before a launch."""
    x = torch.zeros(1, 8, 2, d, dtype=dtype)
    for lse in (False, True):
        if d in port_fa.head_dims(dtype, lse):
            port_fa._check(x, x, x, lse)
        else:
            with pytest.raises(ValueError, match=f"head dim {d}"):
                port_fa._check(x, x, x, lse)
    assert port_fa.head_dims(torch.float32) == (32, 48, 64, 128) and port_fa.head_dims(torch.bfloat16) == (64, 128)
    assert port_fa.head_dims(torch.float32, lse=True) == (32, 64, 128)
