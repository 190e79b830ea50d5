"""The narrow fp32 forward (head dims 32 and 48) on the CPU: its plan, its arithmetic and its
operand layouts, against the JAX package.

``fa_fwd_f32_narrow`` (``csrc/flash_attention_fwd.cu``) serves the fp32 forward at D = 32
(the MAE decoder, the VGGSfM tracker's fine transformer) and D = 48 (the tracker's coarse
transformer). It reads q, k and v in place, splits them into three bf16 parts in shared
memory and runs S = Q Kᵀ and P V as six bf16 products of the parts at the true width.
``fwd_f32_narrow_plan`` picks its regime: where Tq and Tk are at most 64 a work tile packs
128 / max(Tq, Tk) sequences (lengths rounded up to powers of two) and their keys into one
128-key tile under a block-diagonal mask; other shapes stream key tiles over 128-row query
tiles. A CUDA kernel cannot run here, so:

- the plan is checked for coverage: every (batch, head, query row) is computed by exactly
  one tile row, sees every key of its own sequence and no other, and the rows a tile
  computes are at least half the rows it stages where the regime promises it (the tracker's
  five shapes; a hypothesis test over lengths);
- the kernel's arithmetic is emulated: the packed tiles with their masks, or the streamed
  key tiles, S and P V as split products of the parts, the base-2 softmax in fp32; the
  emulation is held to the JAX package within ``SPLIT_ATOL`` and to 4x the fp32 plain
  version's own error against fp64, and the plain version (what the card holds the kernel
  to) within ``ATOL``: D = 48 at scaled tracker shapes against ``jax.nn.dot_product_attention``
  (what the JAX ``sdpa`` runs below 1024 queries, ``mapanything_tpu/ops/attention.py:73``),
  D = 32 against the Pallas kernels ``_fwd_kernel_single(_lse)`` and ``_fwd_stream_aug(_lse)``
  in interpret mode;
- the operand layouts the kernel reads (``narrow_layout``) for contiguous tensors and
  views of a fused qkv tensor, and that misaligned ones raise.

Inputs from numpy seeds, fp32.
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
from test_torch_port_fp32_backward import PLAIN_FACTOR, SIX_PASSES, max_abs, split_product
from test_torch_port_fp32_forward import merged_product, split_forward
from test_torch_port_headdim128 import pallas_kernels

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

ATOL = 2e-5  # the plain versions against the JAX package
SPLIT_ATOL = 2e-4  # the emulated split arithmetic against the JAX package
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
ROWS = port_fa.NARROW_TILE_ROWS

# The VGGSfM tracker's five shapes (B, Tq, Tk, H, D), and the share of the rows a tile
# stages that it computes at each.
TRACKER = {
    "time": ((576, 8, 8, 8, 48), 1.0),
    "virtual2point": ((8, 64, 512, 8, 48), 0.5),
    "virtual": ((8, 64, 64, 8, 48), 1.0),
    "point2virtual": ((8, 512, 64, 8, 48), 1.0),
    "fine_time": ((512, 8, 8, 8, 32), 1.0),
}


def tile_rows(plan: dict, n_seq: int, tq: int, w: int):
    """Work tile ``w``'s rows as the kernel maps them: (sequence, token, computed) arrays
    over its 128 rows (a row computes where it lies in a sequence and before Tq)."""
    r = np.arange(ROWS)
    if plan["regime"] == "packed":
        rows, g = plan["rows_per_seq"], plan["seqs_per_tile"]
        seq, tok = w * g + r // rows, r % rows
        return seq, tok, (r // rows < g) & (seq < n_seq) & (tok < tq)
    m_blocks = -(-tq // ROWS)
    seq, tok = np.full(ROWS, w // m_blocks), (w % m_blocks) * ROWS + r
    return seq, tok, tok < tq


def visible_keys(plan: dict, n_seq: int, tk: int, w: int, row: int) -> set:
    """The (sequence, token) keys that row ``row`` of packed work tile ``w`` attends: key c
    of the tile where c // keys is the row's sequence and c % keys < Tk."""
    keys, g = plan["keys_per_seq"], plan["seqs_per_tile"]
    c = np.arange(plan["keys_per_tile"])
    ok = (c // keys == min(row // plan["rows_per_seq"], g - 1)) & (c % keys < tk)
    return set(zip((w * g + c[ok] // keys).tolist(), (c[ok] % keys).tolist()))


def check_plan(b, tq, tk, h, d) -> float:
    """Every (sequence, query token) is computed by exactly one tile row, each such row sees
    exactly its own sequence's Tk keys; returns the share of staged rows computed."""
    plan = port_fa.fwd_f32_narrow_plan(b, tq, tk, h, d)
    n_seq = b * h
    hits = np.zeros((n_seq, tq), dtype=np.int64)
    computed = 0
    for w in range(plan["work_tiles"]):
        seq, tok, ok = tile_rows(plan, n_seq, tq, w)
        np.add.at(hits, (seq[ok], tok[ok]), 1)
        computed += int(ok.sum())
        if plan["regime"] == "packed":
            for row in np.flatnonzero(ok)[:: max(1, plan["rows_per_seq"] // 2)]:
                assert visible_keys(plan, n_seq, tk, w, int(row)) == {(int(seq[row]), t) for t in range(tk)}
        else:  # key tiles j of keys_per_tile keys, masked at Tk: every key of the sequence
            n_tiles = -(-tk // plan["keys_per_tile"])
            seen = {j * plan["keys_per_tile"] + c for j in range(n_tiles) for c in range(plan["keys_per_tile"])}
            assert {t for t in seen if t < tk} == set(range(tk))
    assert (hits == 1).all(), "a query row computed more than once or never"
    if plan["regime"] == "packed":
        assert plan["keys_per_seq"] * plan["seqs_per_tile"] <= plan["keys_per_tile"]
        assert plan["rows_per_seq"] * plan["seqs_per_tile"] <= ROWS
    return computed / (plan["work_tiles"] * ROWS)


# ---------------------------------------------------------------- (a) the plan


@pytest.mark.parametrize("name", list(TRACKER))
def test_plan_packs_the_tracker_shapes(name):
    (b, tq, tk, h, d), share = TRACKER[name]
    plan = port_fa.fwd_f32_narrow_plan(b, tq, tk, h, d)
    want = {"time": ("packed", 16, 288), "virtual2point": ("streaming", 1, 64), "virtual": ("packed", 2, 32),
            "point2virtual": ("streaming", 1, 256), "fine_time": ("packed", 16, 256)}[name]
    assert (plan["regime"], plan["seqs_per_tile"], plan["work_tiles"]) == want
    assert check_plan(b, tq, tk, h, d) == share >= 0.5


@pytest.mark.parametrize("b,tq,tk,h,lse", [(8, 1369, 1369, 16, False), (4, 1369, 1369, 16, True), (2, 129, 4000, 3, False)])
def test_plan_streams_the_mae_decoder_and_long_keys(b, tq, tk, h, lse):
    plan = port_fa.fwd_f32_narrow_plan(b, tq, tk, h, 32)
    assert plan == {"regime": "streaming", "seqs_per_tile": 1, "rows_per_seq": 128, "keys_per_seq": tk,
                    "keys_per_tile": port_fa.NARROW_STREAM_KEYS[32], "work_tiles": -(-tq // 128) * b * h}
    assert check_plan(min(b, 2), tq, tk, min(h, 2), 32) > 0.5


@pytest.mark.parametrize("tq", [1, 7, 8, 9, 33, 64, 65])
@pytest.mark.parametrize("tk", [1, 8, 13, 64, 65, 512])
def test_plan_covers_the_edge_shapes(tq, tk):
    for d in port_fa.NARROW_HEAD_DIMS:
        plan = port_fa.fwd_f32_narrow_plan(3, tq, tk, 5, d)
        assert plan["regime"] == ("packed" if tq <= 64 and tk <= 64 else "streaming")
        check_plan(3, tq, tk, 5, d)


@settings(max_examples=60, deadline=None)
@given(b=st.integers(1, 5), h=st.integers(1, 6), tq=st.integers(1, 300), tk=st.integers(1, 300),
       d=st.sampled_from(port_fa.NARROW_HEAD_DIMS))
def test_plan_covers_every_row_once(b, h, tq, tk, d):
    share = check_plan(b, tq, tk, h, d)
    plan = port_fa.fwd_f32_narrow_plan(b, tq, tk, h, d)
    # Promised: a packed tile whose keys take no more room than its rows, its sequences all
    # present; a streaming sequence of whole 128-row tiles.
    if plan["regime"] == "packed" and plan["keys_per_seq"] <= plan["rows_per_seq"] \
            and (b * h) % plan["seqs_per_tile"] == 0:
        assert share > 0.5
    if plan["regime"] == "streaming" and tq % ROWS == 0:
        assert share == 1.0


def test_plan_takes_the_narrow_head_dims_alone():
    for d in (16, 64, 80, 128):
        with pytest.raises(ValueError, match=f"head dim {d}"):
            port_fa.fwd_f32_narrow_plan(1, 8, 8, 1, d)
    with pytest.raises(ValueError, match="head dim 48"):
        port_fa.part_cols(48)  # D = 48 has no split pass: the narrow forward splits in the kernel


# ---------------------------------------------------------------- (b) the arithmetic


def narrow_forward(q, k, v, scale, passes=SIX_PASSES):
    """o (B, Tq, H, D) and lse (B, H, Tq) of fa_fwd_f32_narrow's arithmetic. Packed: each
    work tile's 128 query rows and 128 keys gathered as the plan maps them (zeros past a
    sequence's length or the last sequence), S = Q Kᵀ as a split product at the true width,
    the block-diagonal mask, the base-2 softmax in fp32, P split into its parts and P V as
    the kernel's merged products (merged_product) straight into O. Streaming:
    split_forward's online softmax over key tiles of the plan's width, each tile's P V into
    a fresh sum."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    plan = port_fa.fwd_f32_narrow_plan(b, tq, tk, h, d)
    if plan["regime"] == "streaming":
        return split_forward(q, k, v, scale, passes, block_n=plan["keys_per_tile"])
    n_seq, g = b * h, plan["seqs_per_tile"]
    rows, keys, width = plan["rows_per_seq"], plan["keys_per_seq"], plan["keys_per_tile"]
    seqs = [x.permute(0, 2, 1, 3).reshape(n_seq, -1, d) for x in (q, k, v)]  # sequence s: batch s // H, head s % H

    def gather(x, per, n, length):  # (tiles, n rows) of x's rows as the tiles stage them
        out = torch.zeros(plan["work_tiles"], n, d)
        for w in range(plan["work_tiles"]):
            for i in range(min(g, n_seq - w * g)):
                out[w, i * per:i * per + length] = x[w * g + i]
        return out

    qt = gather(seqs[0], rows, ROWS, tq)
    kt, vt = (gather(x, keys, width, tk) for x in seqs[1:])
    r, c = np.arange(ROWS)[:, None], np.arange(width)[None, :]
    mask = torch.from_numpy((c // keys == np.minimum(r // rows, g - 1)) & (c % keys < tk))
    scale_log2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    s = split_product("wrd,wcd->wrc", qt, kt, passes)
    m = torch.where(mask, s, -torch.inf).amax(-1) * scale_log2
    p = torch.where(mask, torch.exp2(s * scale_log2 - m[..., None]), 0.0)
    l = p.sum(-1)
    pv = merged_product("wrc,wcd->wrd", p, vt) if passes == SIX_PASSES else split_product("wrc,wcd->wrd", p, vt, passes)
    o_t = pv / l[..., None]
    lse_t = (m + torch.log2(l)) * LN2
    o, lse = torch.empty(n_seq, tq, d), torch.empty(n_seq, tq)
    for w in range(plan["work_tiles"]):
        seq, tok, ok = tile_rows(plan, n_seq, tq, w)
        o[seq[ok], tok[ok]] = o_t[w, ok]
        lse[seq[ok], tok[ok]] = lse_t[w, ok]
    return o.reshape(b, h, tq, d).transpose(1, 2), lse.reshape(b, h, tq)


# (name, B, Tq, Tk, H): D = 48 at the tracker's shapes scaled down (fewer batches and heads;
# the regimes, tile shapes and partly filled last tiles kept).
D48_CASES = [
    ("time", 12, 8, 8, 8), ("virtual2point", 2, 64, 512, 4), ("virtual", 3, 64, 64, 3),
    ("point2virtual", 2, 512, 64, 2), ("packed_7x13", 3, 7, 13, 5),
]
# D = 32 and the JAX kernels that run there (lse-free, lse): packed tiles (the tracker's fine
# time attention, 8 x 8, and 7 x 13), one streamed key tile (90 x 70) and several (150 x 600:
# key blocks of 512 take the augmented stream).
D32_CASES = [
    ("fine_time", 5, 8, 8, 4, ["_fwd_kernel_single", "_fwd_kernel_single_lse"]),
    ("packed_7x13", 3, 7, 13, 5, ["_fwd_kernel_single", "_fwd_kernel_single_lse"]),
    ("stream_one_tile", 2, 90, 70, 3, ["_fwd_kernel_single", "_fwd_kernel_single_lse"]),
    ("stream_600", 1, 150, 600, 3, ["_fwd_stream_aug", "_fwd_stream_aug_lse"]),
]


def inputs(b, tq, tk, h, d):
    rng = np.random.RandomState(tq * 1000 + tk + d)
    q = rng.randn(b, tq, h, d).astype(np.float32)
    k, v = (rng.randn(b, tk, h, d).astype(np.float32) for _ in range(2))
    return q, k, v, d**-0.5


def held(got, jax_out, exact, plain, record_property):
    """The emulation within SPLIT_ATOL of JAX and 4x the plain version's error of fp64."""
    err_jax, err, plain_err = max_abs(got, jax_out), max_abs(got, exact), max_abs(plain, exact)
    record_property("max_abs_err", {"jax": err_jax, "fp64": err, "plain_fp32_vs_fp64": plain_err})
    assert err_jax <= SPLIT_ATOL and err <= PLAIN_FACTOR * plain_err, (err_jax, err, plain_err)


@pytest.fixture(scope="module", params=D48_CASES, ids=[c[0] for c in D48_CASES])
def d48(request):
    _, b, tq, tk, h = request.param
    q, k, v, scale = inputs(b, tq, tk, h, 48)
    o = jax.nn.dot_product_attention(*(jnp.asarray(x) for x in (q, k, v)), scale=scale)
    return dict(inputs=tuple(torch.from_numpy(x) for x in (q, k, v)), scale=scale, o=np.asarray(o))


def test_d48_plain_version_matches_jax_sdpa(d48, record_property):
    got = port_fa.flash_attention(*d48["inputs"], d48["scale"])  # CPU tensors: the plain version
    record_property("max_abs_err", max_abs(got, d48["o"]))
    assert max_abs(got, d48["o"]) <= ATOL


def test_d48_narrow_arithmetic_matches_jax_sdpa(d48, record_property):
    q, k, v = d48["inputs"]
    got, _ = narrow_forward(q, k, v, d48["scale"])
    exact = port_fa.attention_reference(q.double(), k.double(), v.double(), d48["scale"])
    held(got, d48["o"], exact, port_fa.attention_reference(q, k, v, d48["scale"]), record_property)


@pytest.fixture(scope="module", params=D32_CASES, ids=[c[0] for c in D32_CASES])
def d32(request):
    _, b, tq, tk, h, kernels = request.param
    q, k, v, scale = inputs(b, tq, tk, h, 32)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    kw = dict(block_q=128, block_k=128, interpret=True)
    o_free, free_ran = pallas_kernels(lambda: jax_fa.flash_attention(jq, jk, jv, scale, **kw))
    (o, lse), lse_ran = pallas_kernels(lambda: jax_fa.flash_attention_lse(jq, jk, jv, scale, **kw))
    inputs_t = tuple(torch.from_numpy(x) for x in (q, k, v))
    return dict(inputs=inputs_t, scale=scale, kernels=kernels, ran=free_ran + lse_ran,
                jax=dict(o_free=np.asarray(o_free), o=np.asarray(o), lse=np.asarray(lse)),
                exact=dict(zip(("o", "lse"), port_fa.attention_lse_reference(*(x.double() for x in inputs_t), scale))),
                plain=dict(zip(("o", "lse"), port_fa.attention_lse_reference(*inputs_t, scale))))


def test_d32_jax_dispatch_reaches_the_single_and_stream_kernels(d32):
    assert d32["ran"] == d32["kernels"]


def test_d32_plain_versions_match_jax(d32, record_property):
    q, k, v = d32["inputs"]
    free = port_fa.flash_attention(q, k, v, d32["scale"])
    o, lse = port_fa.flash_attention_lse(q, k, v, d32["scale"])
    errs = {"o": max_abs(free, d32["jax"]["o_free"]), "o_lse": max_abs(o, d32["jax"]["o"]),
            "lse": max_abs(lse, d32["jax"]["lse"])}
    record_property("max_abs_err", errs)
    assert max(errs.values()) <= ATOL, errs


@pytest.mark.parametrize("out", ["o", "lse"])
def test_d32_narrow_arithmetic_matches_jax(d32, out, record_property):
    got = dict(zip(("o", "lse"), narrow_forward(*d32["inputs"], d32["scale"])))[out]
    jax_out = d32["jax"][out]
    if out == "o":  # the lse-free JAX kernel's o too
        assert max_abs(got, d32["jax"]["o_free"]) <= SPLIT_ATOL
    held(got, jax_out, d32["exact"][out], d32["plain"][out], record_property)


def test_packed_tiles_see_only_their_own_keys():
    # Sequences with keys far apart: a tile row that saw another sequence's keys would
    # take its values. Each packed sequence's output stays its own softmax's.
    b, tq, tk, h, d = 2, 8, 8, 9, 48  # 18 sequences: one full tile of 16 and one of 2
    rng = np.random.RandomState(5)
    q = torch.from_numpy(rng.randn(b, tq, h, d).astype(np.float32))
    k = torch.from_numpy(rng.randn(b, tk, h, d).astype(np.float32))
    v = torch.from_numpy((rng.randn(b, tk, h, d) + 100.0 * np.arange(h)[None, None, :, None]).astype(np.float32))
    got, _ = narrow_forward(q, k, v, d**-0.5)
    want = port_fa.attention_reference(q.double(), k.double(), v.double(), d**-0.5)
    assert max_abs(got, want) <= 1e-3


# ---------------------------------------------------------------- (c) the operand layouts


def test_narrow_layout_of_contiguous_tensors():
    for d in port_fa.NARROW_HEAD_DIMS:
        x = torch.zeros(3, 37, 5, d)
        assert port_fa.narrow_layout(x) == ((d, 37, 5, 3), (5 * d * 4, d * 4, 37 * 5 * d * 4))


def test_narrow_layout_of_fused_qkv_views():
    # The MAE decoder's Attention unbinds a fused (B, T, 3, H, D) projection: the T-stride
    # is 3·H·D, the H-stride D, the batch stride 3·T·H·D, and the three views' bases D·H
    # elements apart. Their layouts and the plan pack into the C entry point's arguments.
    b, t, h, d = 2, 9, 4, 32
    q, k, v = torch.zeros(b, t, 3, h, d).unbind(2)
    want_strides = (3 * h * d * 4, d * 4, t * 3 * h * d * 4)
    for x in (q, k, v):
        assert not x.is_contiguous()
        assert port_fa.narrow_layout(x) == ((d, t, h, b), want_strides)
    layouts, plan = port_fa._narrow_args(q, k, v)
    assert struct.unpack("21q", layouts) == 3 * ((d, t, h, b) + want_strides)
    p = port_fa.fwd_f32_narrow_plan(b, t, t, h, d)
    assert struct.unpack("6i", plan) == (1, p["seqs_per_tile"], p["rows_per_seq"], p["keys_per_seq"],
                                         p["keys_per_tile"], p["work_tiles"]) == (1, 8, 16, 16, 128, 1)


def test_narrow_layout_of_a_kv_view_against_longer_keys():
    # q from a fused qkv tensor, k and v from a fused kv tensor (cross-attention layouts).
    q = torch.zeros(2, 7, 3, 3, 48)[:, :, 0]
    k, v = torch.zeros(2, 13, 2, 3, 48).unbind(2)
    assert port_fa.narrow_layout(q)[1] == (3 * 3 * 48 * 4, 48 * 4, 7 * 3 * 3 * 48 * 4)
    assert port_fa.narrow_layout(k)[1] == (2 * 3 * 48 * 4, 48 * 4, 13 * 2 * 3 * 48 * 4)
    layouts, plan = port_fa._narrow_args(q, k, v)
    assert struct.unpack("6i", plan)[:4] == (1, 8, 8, 16)


@pytest.mark.parametrize("bad", ["head_stride", "base", "token_stride", "dtype"])
def test_narrow_layout_refuses_what_16_byte_loads_cannot_read(bad):
    if bad == "head_stride":  # head dim not innermost
        x = torch.zeros(2, 8, 32, 3).transpose(2, 3)
    elif bad == "base":  # one element past a 16-byte boundary
        x = torch.zeros(2 * 8 * 3 * 32 + 1)[1:].view(2, 8, 3, 32)
    elif bad == "token_stride":  # rows 33 floats apart
        x = torch.zeros(2, 8, 3, 33)[..., :32]
    else:
        x = torch.zeros(2, 8, 3, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        port_fa.narrow_layout(x)


def test_cpu_tensors_run_the_plain_versions_and_launch_nothing():
    # At D = 32 and 48 a CPU call runs the plain version: no split pass, no kernel launch.
    rng = np.random.RandomState(9)
    port_fa.reset_launch_counts()
    for d in port_fa.NARROW_HEAD_DIMS:
        q, k, v = (torch.from_numpy(x) for x in inputs(2, 8, 8, 3, d)[:3])
        assert torch.equal(port_fa.flash_attention(q, k, v), port_fa.attention_reference(q, k, v))
    q, k, v = (torch.from_numpy(rng.randn(1, 9, 2, 32).astype(np.float32)) for _ in range(3))
    o, lse = port_fa.flash_attention_lse(q, k, v)
    assert all(n == 0 for n in port_fa.launch_counts().values())
    with pytest.raises(ValueError, match="head dim 48"):
        port_fa._check(*(torch.zeros(1, 8, 2, 48),) * 3, lse=True)
