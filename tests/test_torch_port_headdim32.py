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
packed tiles: ``tests/test_torch_port_narrow_f32.py``), the backward's on parts
that the backward's split pads to the D = 64 plans, whose zero columns add
nothing. Then the padded split, the backward's tensor maps, and the head dims each
dtype has. fp32 throughout; inputs from numpy seeds.
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapanything_tpu.ops import flash_attention as jax_fa
from mapanything_tpu_torch.ops import flash_attention as port_fa
from mapanything_tpu_torch.utils import threads
from test_torch_port_fp32_backward import PLAIN_FACTOR, split_backward
from test_torch_port_fp32_forward import split_forward
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


def test_six_pass_split_backward_at_d32(case, record_property):
    q, k, v, do = (torch.from_numpy(x) for x in case["inputs"])
    o, lse = torch.from_numpy(np.array(case["o_lse"])), torch.from_numpy(np.array(case["lse"]))
    delta = port_fa.attention_bwd_delta(o, do).contiguous()
    got = split_backward(q, k, v, do, lse, delta, case["scale"])
    errs = {}
    for name, g, r in zip(("dq", "dk", "dv"), got, case["grads"]):
        errs[name] = max_abs(g, r)
        np.testing.assert_allclose(g.numpy(), r, atol=GRAD_ATOL, err_msg=name)
    record_property("max_abs_err", errs)


# ---------------------------------------------------------------- the padded parts and the instances


def test_split_pads_d32_parts_to_one_box():
    """The split pass's parts at D = 32 are 64 columns wide: the plain split in the
    first 32, zeros after; D = 64 and 128 keep their width."""
    rng = np.random.RandomState(3)
    qkv = torch.from_numpy(rng.randn(2, 9, 3, 4, D).astype(np.float32))
    q, k, v = qkv.unbind(2)  # views of a fused qkv tensor, as the MAE decoder's Attention cuts them
    do = torch.from_numpy(rng.randn(2, 9, 4, D).astype(np.float32))
    port_fa.reset_launch_counts()
    parts = port_fa.flash_attention_split_f32(q, k, v, do)
    assert all(n == 0 for n in port_fa.launch_counts().values())  # CPU tensors: the plain version
    assert port_fa.part_cols(32) == 64 and port_fa.part_cols(64) == 64 and port_fa.part_cols(128) == 128
    for x, p in zip((q, k, v, do), parts):
        assert p.shape == (3, *x.shape[:-1], 64) and p.is_contiguous() and p.dtype == torch.bfloat16
        assert torch.equal(p[..., :D], port_fa.split_bf16x3_reference(x.contiguous()))
        assert not p[..., D:].any()
    wide = torch.from_numpy(rng.randn(1, 5, 2, 64).astype(np.float32))
    assert port_fa.flash_attention_split_f32(wide, wide, wide)[0].shape == (3, 1, 5, 2, 64)


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_d32_tensor_maps_read_the_padded_parts_with_the_d64_plans(kernel):
    # The backward's: the forward at D = 32 reads q, k and v in place (narrow_layout).
    b, tq, tk, h = 2, 37, 90, 3
    parts = [torch.zeros(3, b, t, h, 64, dtype=torch.bfloat16) for t in (tq, tk, tk, tq)]
    own, streamed = port_fa.BWD_F32_TILES[64][kernel]
    rows_q, rows_kv = (own, streamed) if kernel == "dq" else (streamed, own)
    packed = struct.unpack(f"{4 * 11}q", port_fa._bwd_f32_tensor_maps(kernel, *parts))
    boxes = (rows_q, rows_kv, rows_kv, rows_q)
    for i, (t, rows) in enumerate(zip((tq, tk, tk, tq), boxes)):
        assert packed[11 * i:11 * (i + 1)] == (64, t, h, 3 * b, h * 64 * 2, 64 * 2, t * h * 64 * 2, 64, rows, 1, 1)


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
