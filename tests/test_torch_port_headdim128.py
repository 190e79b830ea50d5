"""The port at head dim 128 against the JAX package, on the CPU.

D = 128 is the JAX package's K8 regime (``d % 128 == 0``): the streaming
``_fwd_kernel`` and ``_fwd_kernel_lse`` forward and the ``_dq_kernel`` and
``_dkv_kernel`` backward. Here they run in interpret mode at 1 x 600 x 2 x 128
with 128-row blocks, where ``_pick_blocks`` gives K blocks of 512 and two K
steps, and the port's plain versions (what its D = 128 Hopper instances are
held to on the card) are held to them. Then the small model with 128-wide
trunk heads (``info_sharing_num_heads=2`` of a 256-wide trunk): its forward
against the JAX package with the same weights (its train step is in
tests/test_torch_port_train.py). fp32 throughout; inputs made with numpy
from fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mapanything_tpu.ops import flash_attention as jax_fa
from mapanything_tpu_torch.models import blocks as port_blocks
from mapanything_tpu_torch.ops import attention as port_attention
from mapanything_tpu_torch.ops import flash_attention as port_fa
from mapanything_tpu_torch.utils import threads
from test_torch_port_model import assert_forward_matches, jax_small_slice

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

ATOL = 2e-5  # the D = 64 tests' tolerances (tests/test_torch_port_attention.py)
GRAD_ATOL = 2e-4
B, T, H, D = 1, 600, 2, 128
BLOCK = 128  # block_q = block_k = 128: the 3D streaming path, not the packed one
SCALE = D**-0.5


def make(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def pallas_kernels(fn, *args):
    """``fn(*args)`` and the names of the Pallas kernels it launched."""
    seen = []
    launch = pl.pallas_call

    def spy(kernel, *a, **kw):
        seen.append(getattr(kernel, "__name__", type(kernel).__name__))
        return launch(kernel, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", spy)
        out = fn(*args)
    return out, seen


@pytest.fixture(scope="module")
def k8():
    """The JAX K8 kernels in interpret mode on one set of inputs: the lse-free
    forward, (o, lse), and the gradients of sum(o * do)."""
    q, k, v, do = (make(seed, B, T, H, D) for seed in (1, 2, 3, 4))
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    kw = dict(block_q=BLOCK, block_k=BLOCK, interpret=True)
    o, fwd_kernels = pallas_kernels(lambda: jax_fa.flash_attention(jq, jk, jv, SCALE, **kw))
    o_lse, lse_kernels = pallas_kernels(lambda: jax_fa.flash_attention_lse(jq, jk, jv, SCALE, **kw))

    def loss(q, k, v):
        return jnp.sum(jax_fa.flash_attention(q, k, v, SCALE, **kw) * jdo)

    grads, grad_kernels = pallas_kernels(lambda: jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv))
    return dict(inputs=(q, k, v, do), o=o, o_lse=o_lse, grads=grads,
                kernels={"fwd": fwd_kernels, "lse": lse_kernels, "grad": grad_kernels})


def test_jax_dispatch_reaches_k8(k8):
    # Two K steps of 512 (not one pass: K4), d % 128 == 0 (not augmented: K3, K5, K7),
    # d != 64 (never paired: K2, K6), blocks not the defaults (the packed K1 is
    # consulted only with the default blocks).
    assert jax_fa._pick_blocks(T, T, BLOCK, BLOCK) == (128, 512)
    jq = jnp.zeros((B, T, H, D))
    assert not jax_fa._use_pair(jq, jq, interpret=True)
    assert (BLOCK, BLOCK) != (jax_fa.DEFAULT_BLOCK_Q, jax_fa.DEFAULT_BLOCK_K)
    assert k8["kernels"] == {
        "fwd": ["_fwd_kernel"],
        "lse": ["_fwd_kernel_lse"],
        "grad": ["_fwd_kernel_lse", "_dq_kernel", "_dkv_kernel"],
    }


def test_forward_matches_jax_fwd_kernel(k8, record_property):
    q, k, v, _ = (torch.from_numpy(x) for x in k8["inputs"])
    out = port_fa.flash_attention(q, k, v, SCALE)
    record_property("max_abs_err", max_abs(out, k8["o"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(k8["o"]), atol=ATOL)


def test_lse_forward_matches_jax_fwd_kernel_lse(k8, record_property):
    q, k, v, _ = (torch.from_numpy(x) for x in k8["inputs"])
    o, lse = port_fa.flash_attention_lse(q, k, v, SCALE)
    o_ref, lse_ref = k8["o_lse"]
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    record_property("max_abs_err", {"o": max_abs(o, o_ref), "lse": max_abs(lse, lse_ref)})
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=ATOL)


def test_gradients_match_jax_dq_and_dkv_kernels(k8, record_property):
    q, k, v, do = k8["inputs"]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = port_fa.flash_attention(tq, tk, tv, SCALE)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    record_property("max_abs_err", {f"d{n}": max_abs(g, r) for n, g, r in zip("qkv", grads, k8["grads"])})
    for name, g, r in zip("qkv", grads, k8["grads"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL, err_msg=f"d{name}")


def test_bwd_lse_on_kv_blocks_matches_jax_k8(record_property):
    # As test_bwd_lse_on_kv_blocks_matches_jax at D = 64: one global softmax, its
    # backward block by block over the keys, each block through K8's dq and dk/dv.
    b, tq, tk, h = 1, 160, 384, 2
    q, k, v = make(5, b, tq, h, D), make(6, b, tk, h, D), make(7, b, tk, h, D)
    do = make(8, b, tq, h, D)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o, lse = jax_fa.flash_attention_lse(jq, jk, jv, SCALE, BLOCK, BLOCK, interpret=True)
    to, tlse, tdo = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse)), torch.from_numpy(do)
    dq_total = np.zeros_like(q)
    errs = {}
    for j in range(3):
        sl = slice(j * 128, (j + 1) * 128)
        ref, kernels = pallas_kernels(
            lambda: jax_fa.flash_attention_bwd_lse(jq, jk[:, sl], jv[:, sl], o, lse, jdo, scale=SCALE,
                                                   block_q=BLOCK, block_k=BLOCK, interpret=True))
        assert kernels == ["_dq_kernel", "_dkv_kernel"]
        got = port_fa.flash_attention_bwd_lse(
            torch.from_numpy(q), torch.from_numpy(k[:, sl].copy()), torch.from_numpy(v[:, sl].copy()),
            to, tlse, tdo, SCALE,
        )
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            errs[name] = max(errs.get(name, 0.0), max_abs(g, r))
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL, err_msg=f"{name}, block {j}")
        dq_total += got[0].numpy()
    tq_, tk_, tv_ = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(port_fa.attention_reference(tq_, tk_, tv_, SCALE), tq_, tdo)[0]
    np.testing.assert_allclose(dq_total, want.numpy(), atol=GRAD_ATOL)
    record_property("max_abs_err", errs)


# ---------------------------------------------------------------- the wrapper


@pytest.mark.parametrize("d", [32, 64, 96, 128])
def test_kernel_wrapper_takes_the_instantiated_head_dims(d):
    q = torch.zeros(1, 8, 2, d, dtype=torch.bfloat16)
    if d in port_fa.HEAD_DIMS:
        port_fa._check(q, q, q)
    else:
        with pytest.raises(ValueError, match=f"head dim {d}"):
            port_fa._check(q, q, q)


@pytest.mark.parametrize("d", port_fa.HEAD_DIMS)
def test_flop_and_byte_counts_per_head_dim(d):
    # The trunk's global layer at H·D = 768 costs the same at 12 x 64 and 6 x 128.
    h = 768 // d
    assert port_fa.attention_flops(1, 10953, 10953, h, d) == 4 * 10953**2 * 768
    assert port_fa.attention_bytes(1, 10953, 10953, h, d, 2) == 4 * 10953 * 768 * 2
    assert port_fa.attention_bwd_flops(1, 5477, 5477, h, d) == 10 * 5477**2 * 768
    assert port_fa.attention_bwd_bytes(1, 5477, 5477, h, d, 2) == 8 * 5477 * 768 * 2 + 4 * h * 5477


def test_launches_are_counted_by_key_length_and_head_dim():
    port_fa.reset_launch_counts()
    for tk, d in ((1369, 64), (1369, 128), (10953, 128), (1369, 128)):
        port_fa._count(port_fa.flash_attention, torch.zeros(1, tk, 1, d))
    port_fa._count(port_fa.flash_attention_bwd_dq, torch.zeros(1, 5477, 1, 128))
    assert port_fa.launch_counts()["flash_attention_fwd"] == 4
    assert port_fa.launch_lengths() == {1369: 3, 10953: 1}
    shapes = port_fa.launch_shapes()
    assert shapes["flash_attention_fwd"] == {(1369, 64): 1, (1369, 128): 2, (10953, 128): 1}
    assert shapes["flash_attention_bwd_dq"] == {(5477, 128): 1}
    assert shapes["flash_attention_fwd_lse"] == shapes["flash_attention_bwd_dkv"] == {}
    port_fa.reset_launch_counts()
    assert port_fa.launch_shapes()["flash_attention_fwd"] == {} and port_fa.launch_lengths() == {}


# ---------------------------------------------------------------- the small model with 128-wide trunk heads


def head_dims_seen(monkeypatch):
    """The head dims of every call that reaches the port's flash attention, from now on."""
    seen = set()
    attend = port_attention.flash_attention

    def spy(q, k, v, scale=None):
        seen.add(q.shape[-1])
        return attend(q, k, v, scale)

    monkeypatch.setattr(port_attention, "flash_attention", spy)
    return seen


def trunk_head_dims(port):
    """The head dims of the trunk's attention layers."""
    return {m.qkv.weight.shape[1] // m.num_heads for name, m in port.named_modules()
            if name.startswith("info_sharing.") and isinstance(m, port_blocks.Attention)}


@pytest.fixture(scope="module")
def small_slice_h128():
    return jax_small_slice(info_sharing_num_heads=2)


def test_small_h128_forward_matches_jax(small_slice_h128, monkeypatch):
    assert trunk_head_dims(small_slice_h128[3]) == {128}
    seen = head_dims_seen(monkeypatch)
    assert_forward_matches(small_slice_h128)
    assert seen == {64, 128}  # the encoder's heads of 64, the trunk's of 128

