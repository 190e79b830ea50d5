"""Context-parallel attention over the view axis.

Counterpart of ``mapanything_tpu/parallel/sharded_attention.py``. The trunk's
global-attention layers attend over the tokens of all V views (plus the
replicated extra tokens: the scale token) while each rank holds the grid
tokens of its V/n views. Two schedules:

- ``allgather``: each rank all-gathers K and V and attends its own queries
  to the whole sequence through ``sdpa`` (the lse-free kernel, or the
  autograd Function when a gradient is needed). One collective a layer;
  O(T) K/V memory a rank. Differentiable: the backward of the all-gather is
  a reduce-scatter (``mesh.all_gather_views``).
- ``ring``: the K/V shards travel around the ring of ranks. Each step runs
  the forward kernel with lse (``flash_attention_lse``) on the current
  shard, and the partials merge exactly through their log-sum-exp;
  O(T/n) memory a rank. Its backward is ring-level (``_ring_bwd_pass``):
  K/V travel again, each step runs the dq and dk/dv kernels
  (``flash_attention_bwd_dq``/``_dkv``) against the saved global lse, and
  the dk/dv accumulators travel with their shards back home.

Blocks under 128 tokens (the extra tokens) go through the plain fp32
formulas, as the JAX package sends them to an einsum (:82-83). The functions
take and return this rank's shards. On a group of one rank the ring rotates
nothing: its one step attends the rank's own shard.

``counts()`` reports the ring steps run (forward and backward) and the
collectives issued, so a run can show which schedule it took.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional, Tuple

import torch

from mapanything_tpu_torch.ops import flash_attention as fa
from mapanything_tpu_torch.ops.attention import sdpa
from mapanything_tpu_torch.parallel import mesh
from mapanything_tpu_torch.parallel.mesh import ViewGroup

DENSE_BELOW = 128  # token groups this small skip the kernels (the kernel's blocks would be mostly padding)

_RING = Counter()


def reset_counts() -> None:
    """Set the ring-step and collective counts to 0."""
    _RING.clear()
    mesh.COLLECTIVES.clear()


def counts() -> dict:
    """Ring steps (forward and backward) and collectives by kind, since the last reset."""
    return {"ring_steps": _RING["fwd"], "ring_bwd_steps": _RING["bwd"],
            "collectives": dict(mesh.COLLECTIVES)}


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in xs)


def _lse_cols(lse: torch.Tensor) -> torch.Tensor:
    return lse.transpose(1, 2)[..., None]  # (B, H, Tq) -> (B, Tq, H, 1)


def _merge(o_acc, lse_acc, o_blk, lse_blk):
    """Two partial attentions over disjoint KV sets merged through their lse."""
    lse = torch.logaddexp(lse_acc, lse_blk)
    return o_acc * _lse_cols(torch.exp(lse_acc - lse)) + o_blk * _lse_cols(torch.exp(lse_blk - lse)), lse


def _merge_lse(parts: List[Tuple[torch.Tensor, torch.Tensor]]):
    """Exactly merge [(o fp32, lse), ...] partial attentions over disjoint KV
    sets via their log-sum-exp. Returns (o fp32, lse)."""
    o, lse = parts[0]
    for o_blk, lse_blk in parts[1:]:
        o, lse = _merge(o, lse, o_blk, lse_blk)
    return o, lse


def _block_attn_lse(q, k, v, scale):
    """(o fp32 (B, Tq, H, D), lse fp32 (B, H, Tq)) of q attending one KV block."""
    if q.shape[1] < DENSE_BELOW or k.shape[1] < DENSE_BELOW:
        return fa.attention_lse_reference(q.float(), k.float(), v.float(), scale)
    o, lse = fa.flash_attention_lse(q, k, v, scale)
    return o.float(), lse


def _block_bwd(q, k, v, do, lse, delta, scale):
    """One block of the FlashAttention-2 backward against the global lse:
    (dq part, dk, dv) of this KV block, fp32."""
    if q.shape[1] < DENSE_BELOW or k.shape[1] < DENSE_BELOW:
        f = [x.float() for x in (q, k, v, do)]
        return (fa.attention_bwd_dq_reference(*f, lse, delta, scale),
                *fa.attention_bwd_dkv_reference(*f, lse, delta, scale))
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)
    return dq.float(), dk.float(), dv.float()


def _ring_fwd_pass(q, k, v, scale, group: ViewGroup):
    """The ring: per step the lse kernel on the current KV shard, an exact
    merge, then the shard moves on. Returns (o fp32, lse), both global."""
    o = lse = None
    k_cur, v_cur = k, v
    for step in range(group.size):
        o_blk, lse_blk = _block_attn_lse(q, k_cur, v_cur, scale)
        _RING["fwd"] += 1
        o, lse = (o_blk, lse_blk) if o is None else _merge(o, lse, o_blk, lse_blk)
        if step + 1 < group.size:
            k_cur, v_cur = mesh.ring_shift([k_cur, v_cur], group)
    return o, lse


def _ring_bwd_pass(q, k, v, lse, do, delta, scale, group: ViewGroup):
    """The ring backward: K/V travel again with their dk/dv accumulators;
    after the last step each accumulator takes one more hop, which brings it
    home. Returns (dq, dk, dv) fp32 of this rank's shards."""
    do = do.to(q.dtype)
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    k_cur, v_cur = k, v
    for step in range(group.size):
        dq_b, dk_b, dv_b = _block_bwd(q, k_cur, v_cur, do, lse, delta, scale)
        _RING["bwd"] += 1
        if step == 0:
            dq, dk, dv = dq_b, dk_b, dv_b
        else:
            dq, dk, dv = dq + dq_b, dk + dk_b, dv + dv_b
        if step + 1 < group.size:
            k_cur, v_cur, dk, dv = mesh.ring_shift([k_cur, v_cur, dk, dv], group)
    if group.size > 1:
        dk, dv = mesh.ring_shift([dk, dv], group)
    return dq, dk, dv


class _Ring(torch.autograd.Function):
    """Ring attention without extra tokens (JAX ``_ring_shard``, :119-227)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, group):
        o, lse = _ring_fwd_pass(q, k, v, scale, group)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.group = scale, group
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = fa.attention_bwd_delta(o, do)
        dq, dk, dv = _ring_bwd_pass(q, k, v, lse, do, delta, ctx.scale, ctx.group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_attention(q, k, v, group: ViewGroup, scale: Optional[float] = None) -> torch.Tensor:
    """Attention of this rank's queries (B, T/n, H, D) to every rank's keys and
    values, the shards travelling around the ring. Differentiable."""
    scale = float(q.shape[-1] ** -0.5 if scale is None else scale)
    if _needs_grad(q, k, v):
        return _Ring.apply(q, k, v, scale, group)
    return _ring_fwd_pass(q, k, v, scale, group)[0].to(q.dtype)


def _ring_extra_fwd_pass(qg, kg, vg, qe, ke, ve, scale, group: ViewGroup):
    """The ring schedule with extra tokens. Grid queries ring over the grid KV
    and merge the extra-KV block; extra queries merge every rank's grid
    partial (one all-gather) and the extra block. Returns (og, lse_g, oe,
    lse_e), fp32 outputs with global lse's (grid and extra KV together)."""
    og, lse_grid = _ring_fwd_pass(qg, kg, vg, scale, group)
    og, lse_g = _merge(og, lse_grid, *_block_attn_lse(qg, ke, ve, scale))
    o_eg, lse_eg = _block_attn_lse(qe, kg, vg, scale)
    b, e, h, d = o_eg.shape
    packed = torch.cat([o_eg.reshape(b, -1), lse_eg.reshape(b, -1)], dim=1)
    gathered = mesh.all_gather(packed[None], group, dim=0)  # (n, B, E·H·D + H·E), rank order
    parts = [(g[:, : e * h * d].reshape(b, e, h, d), g[:, e * h * d:].reshape(b, h, e)) for g in gathered]
    parts.append(_block_attn_lse(qe, ke, ve, scale))
    oe, lse_e = _merge_lse(parts)
    return og, lse_g, oe, lse_e


class _RingExtra(torch.autograd.Function):
    """Ring attention with replicated extra tokens (JAX ``_ring_extra_shard``,
    :310-418).

    Every rank holds a copy of the extra tokens and of their output ``oe``,
    and each copy's cotangent is that rank's part: their sum is the whole.
    The backward all-reduces the parts before they meet the local grid shard.
    The gradients returned for the extra inputs are again parts, which the
    step's all-reduce of parameter gradients sums: the terms of this rank's
    grid tokens at full weight, the extra-against-extra term (the same on
    every rank) at 1/n.
    """

    @staticmethod
    def forward(ctx, qg, kg, vg, qe, ke, ve, scale, group):
        og, lse_g, oe, lse_e = _ring_extra_fwd_pass(qg, kg, vg, qe, ke, ve, scale, group)
        og, oe = og.to(qg.dtype), oe.to(qe.dtype)
        ctx.save_for_backward(qg, kg, vg, qe, ke, ve, og, lse_g, oe, lse_e)
        ctx.scale, ctx.group = scale, group
        return og, oe

    @staticmethod
    def backward(ctx, dog, doe):
        qg, kg, vg, qe, ke, ve, og, lse_g, oe, lse_e = ctx.saved_tensors
        scale, group = ctx.scale, ctx.group
        dogf = dog.float()
        doef = mesh.all_reduce(doe.float(), group)  # the whole cotangent of the replicated oe
        delta_g = fa.attention_bwd_delta(og, dogf)
        delta_e = fa.attention_bwd_delta(oe, doef)
        # 1) grid queries against grid KV: the kernel-backed ring.
        dqg, dkg, dvg = _ring_bwd_pass(qg, kg, vg, lse_g, dog, delta_g, scale, group)
        qgf, kgf, vgf, qef, kef, vef = (x.float() for x in (qg, kg, vg, qe, ke, ve))
        # 2) grid queries against the extra KV (dense, Tq/n x E): this rank's part.
        dqg = dqg + fa.attention_bwd_dq_reference(qgf, kef, vef, dogf, lse_g, delta_g, scale)
        dke, dve = fa.attention_bwd_dkv_reference(qgf, kef, vef, dogf, lse_g, delta_g, scale)
        # 3) extra queries against this rank's grid shard (dense, E x Tk/n).
        dqe = fa.attention_bwd_dq_reference(qef, kgf, vgf, doef, lse_e, delta_e, scale)
        dk_eg, dv_eg = fa.attention_bwd_dkv_reference(qef, kgf, vgf, doef, lse_e, delta_e, scale)
        dkg, dvg = dkg + dk_eg, dvg + dv_eg
        # 4) extra queries against extra KV: the same on every rank, 1/n each.
        inv_n = 1.0 / group.size
        dqe = dqe + fa.attention_bwd_dq_reference(qef, kef, vef, doef, lse_e, delta_e, scale) * inv_n
        dk_ee, dv_ee = fa.attention_bwd_dkv_reference(qef, kef, vef, doef, lse_e, delta_e, scale)
        dke, dve = dke + dk_ee * inv_n, dve + dv_ee * inv_n
        return (dqg.to(qg.dtype), dkg.to(kg.dtype), dvg.to(vg.dtype),
                dqe.to(qe.dtype), dke.to(ke.dtype), dve.to(ve.dtype), None, None)


def global_attention_cp(
    qg: torch.Tensor,
    kg: torch.Tensor,
    vg: torch.Tensor,
    qe: Optional[torch.Tensor],
    ke: Optional[torch.Tensor],
    ve: Optional[torch.Tensor],
    group: ViewGroup,
    scale: Optional[float] = None,
    schedule: str = "allgather",
):
    """Global attention of the trunk's even layers under view sharding.

    Grid tokens (B, V·P/n, H, D) are this rank's shard; the extra tokens
    (B, E, H, D), or None, are replicated. Every query attends the union of
    all ranks' grid KV and the extra KV, exactly. Returns (og, oe), oe None
    without extra tokens. Differentiable under both schedules.
    """
    scale = float(qg.shape[-1] ** -0.5 if scale is None else scale)
    has_extra = qe is not None
    if schedule == "allgather":
        kv = mesh.all_gather_views(torch.stack([kg, vg], dim=2), group, dim=1)  # (B, n·T, 2, H, D)
        if has_extra:
            kv = torch.cat([kv, torch.stack([ke, ve], dim=2).to(kv.dtype)], dim=1)
        k_full, v_full = kv.unbind(2)
        og = sdpa(qg, k_full, v_full, scale)
        # The E extra queries: tiny, plain, the same on every rank.
        oe = fa.attention_reference(qe, k_full, v_full, scale) if has_extra else None
        return og, oe
    if schedule != "ring":
        raise ValueError(f"unknown schedule: {schedule}")
    if not has_extra:
        return ring_attention(qg, kg, vg, group, scale), None
    if _needs_grad(qg, kg, vg, qe, ke, ve):
        return _RingExtra.apply(qg, kg, vg, qe, ke, ve, scale, group)
    og, _, oe, _ = _ring_extra_fwd_pass(qg, kg, vg, qe, ke, ve, scale, group)
    return og.to(qg.dtype), oe.to(qe.dtype)


def allgather_kv_attention(q, k, v, group: ViewGroup, scale: Optional[float] = None) -> torch.Tensor:
    """Attention of this rank's queries to the all-gathered keys and values."""
    return global_attention_cp(q, k, v, None, None, None, group, scale, "allgather")[0]
