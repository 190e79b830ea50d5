"""The port's masked attention against ``jax.nn.dot_product_attention(..., mask=)``, on the CPU.

The JAX package sends every masked ``sdpa`` call to XLA's fused attention
(``mapanything_tpu/ops/attention.py:77``); the port's ``sdpa(q, k, v, mask=)`` goes to
``flash_attention_masked``, whose CPU path is the plain versions (the forward and, under
autograd, the lse forward with the dq and dk/dv formulas the kernels compute). Masks: key
padding (B, 1, 1, Tk), dense per head (B, H, Tq, Tk) and shared (1, 1, Tq, Tk), each with
fully masked rows, Tq != Tk; an all-true mask equals the unmasked path. The kernels'
arithmetic is emulated too: the forward's online softmax over 64-key tiles in the natural-log
domain with the masked logit substituted, and the backward's rule for fully masked rows (read
from their lse). Inputs come from numpy seeds. Tolerances: in fp32 the attention file's (ATOL
for outputs, GRAD_ATOL for gradients). In bf16 both sides round at other places (JAX rounds
dP = dO V^T to bf16 before the softmax backward; the port, as the kernels, takes
delta = rowsum(dO.O) from the bf16 o), so each bf16 result is held to JAX's fp32 result on the
same bf16 inputs under chip_smoke.py's phase-3 rule: its largest error there may be twice that
of JAX's own bf16 result or 1e-2 of the result's magnitude, whichever is larger (read here: up
to 0.7% of the magnitude for dq and dk, where delta's rounding shows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapanything_tpu_torch.ops import attention as port_attention
from mapanything_tpu_torch.ops import flash_attention as fa
from mapanything_tpu_torch.utils import threads

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

ATOL = 2e-5  # tests/test_torch_port_attention.py
GRAD_ATOL = 2e-4


def make_mask(kind, b, h, tq, tk, seed):
    """A boolean mask of the kind with some fully masked rows (and all-false key sets)."""
    rng = np.random.RandomState(seed)
    if kind == "key_padding":  # the first sample keeps ~80% of its keys, the last keeps none
        m = rng.rand(b, 1, 1, tk) < 0.8
        m[-1] = False
    elif kind == "dense":
        m = rng.rand(b, h, tq, tk) < 0.5
        m[0, 0, :3] = False  # fully masked rows of one head
        m[-1, -1, -1] = False
    elif kind == "shared":
        m = rng.rand(1, 1, tq, tk) < 0.3
        m[0, 0, 1] = False
    else:
        m = np.ones((b, 1, tq, tk), bool)
    return m


def inputs(b, tq, tk, h, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(np.float32) for t in (tq, tk, tk)] + [rng.randn(b, tq, h, d).astype(np.float32)]


def jax_attention(q, k, v, do, mask, scale, dtype):
    """JAX's forward and the gradients of sum(o * do) in ``dtype``, as fp32 numpy."""
    cast = lambda x: jnp.asarray(x, dtype)  # noqa: E731
    fn = lambda q_, k_, v_: jax.nn.dot_product_attention(q_, k_, v_, scale=scale, mask=jnp.asarray(mask))  # noqa: E731
    o, vjp = jax.vjp(fn, cast(q), cast(k), cast(v))
    grads = vjp(cast(do))
    return [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)]


def port_attention_grads(q, k, v, do, mask, scale, dtype, fn):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    o = fn(*ts, torch.from_numpy(mask), scale)
    o.backward(torch.from_numpy(do).to(dtype))
    return [x.detach().float().numpy() for x in (o, *(t.grad for t in ts))]


def assert_close(got, want, atol, name, exact=None):
    """fp32: ``got`` within ``atol`` of JAX's ``want``. bf16 (``exact``, JAX's fp32 result on
    the same bf16 inputs): got's largest error against ``exact`` at most twice that of JAX's
    bf16 ``want`` or 1e-2 of ``exact``'s magnitude (phase 3's rule)."""
    if exact is None:
        err = np.abs(got - want).max()
        assert err <= atol, f"{name}: {err} > {atol}"
        return
    err, jax_err = np.abs(got - exact).max(), np.abs(want - exact).max()
    tol = max(2 * jax_err, 1e-2 * np.abs(exact).max())
    assert err <= tol, f"{name}: {err} against JAX's fp32 > {tol} (JAX's bf16 {jax_err})"


def bf16_rounded(*xs):
    return [np.asarray(torch.from_numpy(x).to(torch.bfloat16).float()) for x in xs]


SHAPES = [(2, 37, 70, 3, 64), (2, 70, 37, 2, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["key_padding", "dense", "shared"])
@pytest.mark.parametrize("b,tq,tk,h,d", SHAPES)
def test_masked_sdpa_matches_jax(kind, dtype, b, tq, tk, h, d):
    q, k, v, do = inputs(b, tq, tk, h, d, seed=tq + tk)
    mask = make_mask(kind, b, h, tq, tk, seed=d)
    scale = 0.3
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_attention(q, k, v, do, mask, scale, jdtype)
    exact = jax_attention(*bf16_rounded(q, k, v, do), mask, scale, jnp.float32) if jdtype == jnp.bfloat16 \
        else [None] * 4
    sdpa = lambda q_, k_, v_, m, s: port_attention.sdpa(q_, k_, v_, s, mask=m)  # noqa: E731
    plain = lambda q_, k_, v_, m, s: fa.attention_masked_reference(q_, k_, v_, m, s)  # noqa: E731
    for name, fn in (("sdpa", sdpa), ("plain under autograd", plain)):
        got = port_attention_grads(q, k, v, do, mask, scale, dtype, fn)
        for field, g, w, e, atol in zip(("o", "dq", "dk", "dv"), got, want, exact, (ATOL,) + (GRAD_ATOL,) * 3):
            assert_close(g, w, atol, f"{name} {field}", e)
    with torch.no_grad():  # the lse-free path
        o = port_attention.sdpa(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)), scale,
                                mask=torch.from_numpy(mask))
    assert_close(o.float().numpy(), want[0], ATOL, "sdpa without grad", exact[0])


def test_fully_masked_rows_take_the_mean_of_v_and_pass_no_gradient_to_q_and_k():
    q, k, v, do = (torch.from_numpy(x) for x in inputs(1, 5, 9, 2, 64, seed=4))
    mask = torch.ones(1, 2, 5, 9, dtype=torch.bool)
    mask[0, 1, 2] = False  # row 2 of head 1 attends nothing
    ts = [x.clone().requires_grad_() for x in (q, k, v)]
    o = port_attention.sdpa(*ts, 0.125, mask=mask)
    torch.testing.assert_close(o[0, 2, 1], v[0, :, 1].mean(0), rtol=0, atol=1e-6)
    g = torch.zeros_like(o)
    g[0, 2, 1] = do[0, 2, 1]  # only the fully masked row's cotangent
    dq, dk, dv = torch.autograd.grad(o, ts, g)
    assert not dq.any() and not dk.any()
    torch.testing.assert_close(dv[0, :, 1], do[0, 2, 1].expand(9, 64) / 9, rtol=0, atol=1e-7)
    _, lse = fa.flash_attention_masked_lse(q, k, v, fa.masked_view(mask, 1, 2, 5, 9), 0.125)
    assert lse[0, 1, 2].item() == np.float32(fa.MASKED_LOGIT) and fa.fully_masked_rows(lse).sum() == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_an_all_true_mask_is_the_unmasked_attention(dtype):
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in inputs(2, 33, 40, 2, 64, seed=9))
    mask = torch.ones(1, 1, 1, 40, dtype=torch.bool)
    with torch.no_grad():
        got = port_attention.sdpa(q, k, v, 0.2, mask=mask)
        want = port_attention.sdpa(q, k, v, 0.2)
    # bf16: the masked path rounds P to bf16 before P.V (as JAX does), the unmasked one does not
    tol = ATOL if dtype == torch.float32 else 2.0**-8 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol


def emulate_kernel_forward(q, k, v, mask, scale, tile=fa.MASKED_TILES[1]):
    """fa_fwd_masked's arithmetic in fp32: key tiles of ``tile``, each logit q.k * scale or
    the masked logit, a running max and sum in the natural-log domain, P (rounded to the
    inputs' dtype) times V added into the rescaled output; lse = max + log(sum)."""
    b, tq, h, _ = q.shape
    tk = k.shape[1]
    qf, kf, vf = (x.float() for x in (q, k, v))
    m_run = torch.full((b, h, tq), -torch.inf)
    l_run = torch.zeros(b, h, tq)
    acc = torch.zeros(b, h, tq, q.shape[3])
    for k0 in range(0, tk, tile):
        ks = slice(k0, min(k0 + tile, tk))
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, ks]) * scale
        s = torch.where(mask[..., ks], s, torch.tensor(fa.MASKED_LOGIT))
        mx = torch.maximum(m_run, s.amax(-1))
        alpha = torch.exp(m_run - mx)
        p = torch.exp(s - mx[..., None])
        l_run = l_run * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype).float(), vf[:, ks])
        m_run = mx
    o = (acc / l_run[..., None]).permute(0, 2, 1, 3).to(q.dtype)
    return o, m_run + torch.log(l_run)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["key_padding", "dense"])
def test_the_kernels_arithmetic_matches_jax(kind, dtype):
    """The forward's tile loop and the backward's formulas (P from the lse, 1/Tk on a fully
    masked row, dS zero where masked) against JAX, over several key tiles."""
    b, tq, tk, h, d = 2, 20, 150, 2, 64
    q, k, v, do = inputs(b, tq, tk, h, d, seed=5)
    mask = make_mask(kind, b, h, tq, tk, seed=6)
    scale = 0.25
    bf16 = dtype == torch.bfloat16
    want = jax_attention(q, k, v, do, mask, scale, jnp.bfloat16 if bf16 else jnp.float32)
    exact = jax_attention(*bf16_rounded(q, k, v, do), mask, scale, jnp.float32) if bf16 else [None] * 4
    tq_, tk_, tv_, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    view = fa.masked_view(torch.from_numpy(mask), b, h, tq, tk)
    o, lse = emulate_kernel_forward(tq_, tk_, tv_, view, scale)
    _, lse_plain = fa.attention_masked_lse_reference(tq_, tk_, tv_, view, scale)
    assert torch.equal(fa.fully_masked_rows(lse), fa.fully_masked_rows(lse_plain))
    assert fa.fully_masked_rows(lse).any()
    delta = fa.attention_bwd_delta(o, tdo).contiguous()
    dq = fa.attention_masked_bwd_dq_reference(tq_, tk_, tv_, tdo, view, lse, delta, scale)
    dk, dv = fa.attention_masked_bwd_dkv_reference(tq_, tk_, tv_, tdo, view, lse, delta, scale)
    for field, g, w, e, atol in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv), want, exact, (ATOL,) + (GRAD_ATOL,) * 3):
        assert_close(g.float().numpy(), w, atol, field, e)


def test_the_mask_is_read_in_place_through_four_strides():
    padding = torch.ones(3, 1, 1, 50, dtype=torch.bool)
    view = fa.masked_view(padding, 3, 4, 20, 50)
    assert view.shape == (3, 4, 20, 50) and view.data_ptr() == padding.data_ptr()
    q = torch.zeros(3, 20, 4, 64)
    k = torch.zeros(3, 50, 4, 64)
    strides = list(fa._masked_strides(q, k, k, None, view))
    assert strides[9:12] == [0, 0, 0]  # no dO
    assert strides[12:] == [50, 0, 0, 1]  # bytes: the head and query dimensions broadcast
    shared = fa.masked_view(torch.ones(1, 1, 20, 50, dtype=torch.bool), 3, 4, 20, 50)
    assert shared.stride() == (0, 0, 50, 1)


def test_masks_the_kernels_do_not_take_raise():
    with pytest.raises(TypeError, match="boolean"):
        fa.masked_view(torch.ones(1, 1, 4, 4), 1, 1, 4, 4)
    with pytest.raises(ValueError, match="does not broadcast"):
        fa.masked_view(torch.ones(2, 1, 4, 4, dtype=torch.bool), 3, 1, 4, 4)
    with pytest.raises(ValueError, match=r"\(B, 1\|H, Tq, Tk\)"):
        fa.masked_view(torch.ones(4, 4, dtype=torch.bool), 1, 1, 4, 4)


@pytest.mark.parametrize("dtype,d,kernel", [(torch.bfloat16, 32, "fwd"), (torch.bfloat16, 48, "dq"),
                                            (torch.float32, 48, "dkv"), (torch.float32, 80, "fwd")])
def test_head_dims_without_an_instance_raise_before_launching(dtype, d, kernel):
    q = torch.zeros(1, 8, 2, d, dtype=dtype)
    mask = fa.masked_view(torch.ones(1, 1, 1, 8, dtype=torch.bool), 1, 2, 8, 8)
    with pytest.raises(ValueError, match=f"head dim {d}"):
        fa._launch_masked(kernel, q, q, q, mask, 0.1)


def test_cpu_tensors_launch_no_masked_kernel_and_the_counts_name_them():
    q, k, v, _ = (torch.from_numpy(x) for x in inputs(1, 6, 6, 1, 64, seed=1))
    fa.reset_launch_counts()
    mask = torch.ones(1, 1, 6, 6, dtype=torch.bool)
    port_attention.sdpa(q.requires_grad_(), k, v, mask=mask).sum().backward()
    with torch.no_grad():
        port_attention.sdpa(q, k, v, mask=mask)
    counts = fa.launch_counts()
    masked = {name for name in counts if "masked" in name}
    assert masked == {"flash_attention_masked_fwd", "flash_attention_masked_fwd_lse",
                      "flash_attention_masked_bwd_dq", "flash_attention_masked_bwd_dkv"}
    assert not any(counts.values()) and set(fa.launch_shapes()) == set(counts)


def test_plain_attention_context_covers_the_masked_form():
    q, k, v, _ = (torch.from_numpy(x) for x in inputs(1, 6, 7, 2, 64, seed=2))
    mask = torch.from_numpy(make_mask("dense", 1, 2, 6, 7, seed=3))
    with port_attention.plain_attention():
        got = port_attention.sdpa(q, k, v, 0.3, mask=mask)
    assert port_attention.flash_attention_masked is fa.flash_attention_masked
    torch.testing.assert_close(got, fa.attention_masked_reference(q, k, v, mask, 0.3), rtol=0, atol=0)
