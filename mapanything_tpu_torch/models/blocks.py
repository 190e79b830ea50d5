"""Transformer primitives of the port: dtype-aware layers, MLP, attention, blocks.

Counterpart of ``mapanything_tpu/models/blocks.py``: ``gelu_matched`` (:43),
``Mlp`` (:55), ``LayerScale`` (:108), ``DropPath`` (:122), ``Attention`` (:140)
with its qk-norm (:192-194), rope hook (:196-199) and context-parallel routing
(:159-165, :215-237), ``CrossAttention`` (:248), ``SelfAttentionBlock`` (:313),
``CrossAttentionBlock`` (:400), ``RMSNorm`` (:498), ``DiffAttention`` (:513) and
``DiffCrossAttention`` (:582), and the activation rematerialisation of the
blocks: ``resolve_remat_policy`` (:656-713), the checkpoint tags of ``Mlp``
(:65-94) and ``Attention`` (:166-238) as the stage boundaries of
``SelfAttentionBlock``, and ``set_remat`` for the modules that wrap their blocks
in ``nn.remat``. Every tag is a stage boundary whatever the policy, so the JAX
``_EXTRA_TAG_SETS`` (:716-727), which says which tags a policy needs emitted,
has no counterpart.
Parameter names are the reference's torch names (DINOv2 / UniCeption), so
``mapanything_tpu.utils.torch_convert`` reads a port state dict unchanged.

Dtype policy, as in Flax. Parameters stay fp32. ``Linear``, ``Conv2d`` and
``ConvTranspose2d`` take a ``dtype`` and cast input, weight and bias to it at
every call, which is what ``flax.linen.Dense(dtype=...)`` does; with
``dtype=torch.float32`` the casts are no-ops. ``LayerNorm`` normalises in
fp32 and returns ``dtype`` (or fp32 when ``dtype`` is None), as Flax's
LayerNorm does; ``GroupNorm`` the same, over NCHW, with Flax's epsilon.
"""

from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass
from typing import Callable, FrozenSet, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mapanything_tpu_torch.ops.attention import (
    apply_entropy_scaling,
    apply_scalable_softmax,
    sdpa,
)
from mapanything_tpu_torch.parallel.cp import current_cp
from mapanything_tpu_torch.parallel.sharded_attention import global_attention_cp


def _product_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.dtype:
    """The dtype a layer's product runs in: float64 for an fp32 product on the CPU
    (rounded once to fp32 after it), else ``dtype``. MKL's GEMM and oneDNN's
    convolution split a product's sum over threads at some shapes, so their fp32
    result depends on torch's thread count; in float64 that rounding vanishes
    from the fp32 result."""
    return torch.float64 if dtype == torch.float32 and x.device.type == "cpu" else dtype


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``dtype``; ``init`` names its Flax initializer."""

    def __init__(self, in_features, out_features, bias=True, dtype=torch.float32, init="lecun"):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        self.init = init

    def forward(self, x):
        dt = self.compute_dtype
        pt = _product_dtype(x, dt)
        bias = None if self.bias is None else self.bias.to(pt)
        return F.linear(x.to(pt), self.weight.to(pt), bias).to(dt)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype`` (NCHW)."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0, bias=True, dtype=torch.float32):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride, padding=padding, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        pt = _product_dtype(x, dt)
        bias = None if self.bias is None else self.bias.to(pt)
        return self._conv_forward(x.to(pt), self.weight.to(pt), bias).to(dt)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``dtype`` (NCHW)."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, dtype=torch.float32):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        pt = _product_dtype(x, dt)
        return F.conv_transpose2d(x.to(pt), self.weight.to(pt), self.bias.to(pt), self.stride).to(dt)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics; returns ``dtype``, or fp32 when it is None."""

    def __init__(self, dim, eps=1e-6, dtype: Optional[torch.dtype] = None):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        out_dtype = self.compute_dtype or torch.promote_types(x.dtype, torch.float32)
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(out_dtype)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over NCHW with Flax's epsilon (1e-6); statistics in fp32. It returns
    ``dtype``, or (when that is None) the input's dtype promoted with fp32, as Flax's
    GroupNorm does without a dtype."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6, dtype: Optional[torch.dtype] = None):
        super().__init__(num_groups, num_channels, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        out_dtype = self.compute_dtype or torch.promote_types(x.dtype, torch.float32)
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps).to(out_dtype)


def gelu_matched(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU in fp32; the tanh approximation in bf16/fp16."""
    return F.gelu(x, approximate="none" if x.dtype == torch.float32 else "tanh")


class Mlp(nn.Module):
    """Two-layer MLP with the dtype-matched GELU."""

    def __init__(self, in_features, hidden_features, out_features, dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features, dtype=dtype, init="xavier")
        self.fc2 = Linear(hidden_features, out_features, dtype=dtype, init="xavier")

    def forward(self, x):
        return self.fc2(gelu_matched(self.fc1(x)))


class LayerScale(nn.Module):
    """Per-channel learnable residual scaling."""

    def __init__(self, dim, init_values=1e-5):
        super().__init__()
        self.init_values = init_values
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class DropPath(nn.Module):
    """Stochastic depth per sample; identity at rate 0 or in eval mode."""

    def __init__(self, rate=0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), device=x.device) < keep
        return x / keep * mask.to(x.dtype)


class Attention(nn.Module):
    """Multi-head self-attention over (B, N, C) through ``sdpa``.

    q, k and v are strided views of the fused ``qkv`` projection, (B, N, H, D)
    each; the attention kernel reads them in place. With ``qk_norm`` q and k
    pass a LayerNorm over the head dim (``q_norm``, ``k_norm``); with a ``rope``
    hook (``ops.rope.make_rope2d``) q and k are rotated at the token positions
    ``xpos`` (B, N, 2) given to ``forward``.

    Context-parallel routing (the trunk's global layers): with ``cp_global``
    set and a ``parallel.cp`` context active, the last ``cp_extra_tokens``
    tokens are the replicated extra tokens (the scale token) and the rest
    are this rank's view-sharded grid tokens; attention then runs through
    ``global_attention_cp`` with the context's schedule, and the token count
    N of the softmax scalings is the global V·P + E.
    """

    def __init__(
        self,
        dim,
        num_heads=8,
        qkv_bias=False,
        qk_norm=False,
        rope: Optional[Callable] = None,
        use_scalable_softmax=False,
        use_entropy_scaling=False,
        base_token_count_for_entropy_scaling=444,
        entropy_scaling_growth_factor=1.4,
        cp_global=False,
        dtype=torch.float32,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.rope = rope
        self.cp_global = cp_global
        self.use_scalable_softmax = use_scalable_softmax
        self.use_entropy_scaling = use_entropy_scaling
        self.base_token_count_for_entropy_scaling = base_token_count_for_entropy_scaling
        self.entropy_scaling_growth_factor = entropy_scaling_growth_factor
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias, dtype=dtype, init="xavier")
        if qk_norm:
            self.q_norm = LayerNorm(dim // num_heads, dtype=dtype)
            self.k_norm = LayerNorm(dim // num_heads, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype, init="xavier")

    def forward(self, x, xpos: Optional[torch.Tensor] = None, cp_extra_tokens: int = 0):
        B, N, C = x.shape
        return self.proj(self.attend(self.qkv(x), xpos, cp_extra_tokens, self.cp_context()).reshape(B, N, C))

    def cp_context(self):
        """The active ``parallel.cp`` context where this attention routes through it, else None."""
        return current_cp() if self.cp_global else None

    def attend(self, qkv: torch.Tensor, xpos: Optional[torch.Tensor], cp_extra_tokens: int, cp):
        """The attention output (B, N, H, D) of the fused projection ``qkv`` (B, N, 3C):
        the heads, their norms, rope and scalings, then ``sdpa``, or the route of ``cp``
        (``cp_context()`` read at the forward: a rematerialised block recomputes this in
        the backward, after the context has closed)."""
        B, N, C3 = qkv.shape
        head_dim = C3 // (3 * self.num_heads)
        q, k, v = qkv.reshape(B, N, 3, self.num_heads, head_dim).unbind(2)
        if hasattr(self, "q_norm"):
            q, k = self.q_norm(q), self.k_norm(k)
        if self.rope is not None:
            if xpos is None:
                raise ValueError("an attention with a rope hook needs the token positions xpos")
            q, k = self.rope(q, xpos), self.rope(k, xpos)
        E = cp_extra_tokens
        n_tokens = N if cp is None else (N - E) * cp.group.size + E
        q = _scale_queries(self, q, n_tokens)
        if cp is None:
            out = sdpa(q, k, v, scale=head_dim**-0.5)
        else:
            g = N - E
            og, oe = global_attention_cp(
                q[:, :g], k[:, :g], v[:, :g],
                q[:, g:] if E else None, k[:, g:] if E else None, v[:, g:] if E else None,
                cp.group, head_dim**-0.5, cp.schedule,
            )
            out = torch.cat([og, oe.to(og.dtype)], dim=1) if E else og
        return out


def _scale_queries(attn: nn.Module, q: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """The length-extrapolation multipliers of q that ``attn`` asks for, at
    ``n_tokens`` keys."""
    if attn.use_scalable_softmax:
        q = apply_scalable_softmax(q, n_tokens)
    if attn.use_entropy_scaling:
        q = apply_entropy_scaling(
            q, n_tokens, attn.base_token_count_for_entropy_scaling, attn.entropy_scaling_growth_factor
        )
    return q


class CrossAttention(nn.Module):
    """Multi-head attention of (B, Nq, C) queries over (B, Nk, C) keys and values,
    through ``sdpa``: separate ``projq``, ``projk`` and ``projv`` projections (CroCo's
    names), the optional head-dim LayerNorms and rope hook on q and k at their own
    positions, and the softmax scalings at the key count Nk."""

    def __init__(
        self,
        dim,
        num_heads=8,
        qkv_bias=False,
        qk_norm=False,
        rope: Optional[Callable] = None,
        use_scalable_softmax=False,
        use_entropy_scaling=False,
        base_token_count_for_entropy_scaling=444,
        entropy_scaling_growth_factor=1.4,
        dtype=torch.float32,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.rope = rope
        self.use_scalable_softmax = use_scalable_softmax
        self.use_entropy_scaling = use_entropy_scaling
        self.base_token_count_for_entropy_scaling = base_token_count_for_entropy_scaling
        self.entropy_scaling_growth_factor = entropy_scaling_growth_factor
        self.projq = Linear(dim, dim, bias=qkv_bias, dtype=dtype, init="xavier")
        self.projk = Linear(dim, dim, bias=qkv_bias, dtype=dtype, init="xavier")
        self.projv = Linear(dim, dim, bias=qkv_bias, dtype=dtype, init="xavier")
        if qk_norm:
            self.q_norm = LayerNorm(dim // num_heads, dtype=dtype)
            self.k_norm = LayerNorm(dim // num_heads, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype, init="xavier")

    def forward(self, query, key, value, qpos=None, kpos=None):
        B, Nq, C = query.shape
        Nk = key.shape[1]
        H, D = self.num_heads, C // self.num_heads
        q = self.projq(query).reshape(B, Nq, H, D)
        k = self.projk(key).reshape(B, Nk, H, D)
        v = self.projv(value).reshape(B, Nk, H, D)
        if hasattr(self, "q_norm"):
            q, k = self.q_norm(q), self.k_norm(k)
        if self.rope is not None:
            if qpos is not None:
                q = self.rope(q, qpos)
            if kpos is not None:
                k = self.rope(k, kpos)
        q = _scale_queries(self, q, Nk)
        out = sdpa(q, k, v, scale=D**-0.5)
        return self.proj(out.reshape(B, Nq, C))


class SelfAttentionBlock(nn.Module):
    """Pre-norm self-attention transformer block (DINOv2 ``Block`` names).

    With ``differential=True`` the attention is ``DiffAttention`` at the lambda
    schedule of ``layer_depth``; with a ``rope`` hook ``forward`` takes the token
    positions ``xpos``.
    """

    def __init__(
        self,
        dim,
        num_heads,
        mlp_ratio=4.0,
        qkv_bias=True,
        qk_norm=False,
        init_values: Optional[float] = None,
        drop_path=0.0,
        rope: Optional[Callable] = None,
        use_scalable_softmax=False,
        use_entropy_scaling=False,
        base_token_count_for_entropy_scaling=444,
        entropy_scaling_growth_factor=1.4,
        differential=False,
        layer_depth=0,
        cp_global=False,
        dtype=torch.float32,
    ):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype=dtype)
        if differential:
            self.attn = DiffAttention(dim, layer_depth, num_heads, qkv_bias=qkv_bias, rope=rope, dtype=dtype)
        else:
            self.attn = Attention(
                dim,
                num_heads,
                qkv_bias=qkv_bias,
                qk_norm=qk_norm,
                rope=rope,
                use_scalable_softmax=use_scalable_softmax,
                use_entropy_scaling=use_entropy_scaling,
                base_token_count_for_entropy_scaling=base_token_count_for_entropy_scaling,
                entropy_scaling_growth_factor=entropy_scaling_growth_factor,
                cp_global=cp_global,
                dtype=dtype,
            )
        self.ls1 = LayerScale(dim, init_values) if init_values is not None else nn.Identity()
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype)
        self.ls2 = LayerScale(dim, init_values) if init_values is not None else nn.Identity()
        self.drop_path = DropPath(drop_path)
        self.remat: Optional[RematPolicy] = None  # set_remat; None: autograd keeps what it saves

    def _stages(self, xpos, cp_extra_tokens):
        """The block as (tag, fn) stages in forward order, each fn(x, cur) -> cur: the tag
        names the stage's output. The stage tagged "mlp_in" returns (norm2(x1), x1), x1 the
        residual stream after the attention; the last stage (tag None) returns the MLP
        branch, which the caller adds to x1."""
        attn, mlp = self.attn, self.mlp
        cp = attn.cp_context()

        def residual(x, p):
            x1 = x + self.drop_path(self.ls1(p))
            return self.norm2(x1), x1

        return (
            ("qkv_out", lambda x, h: attn.qkv(self.norm1(h))),
            ("attn_out", lambda x, qkv: attn.attend(qkv, xpos, cp_extra_tokens, cp)),
            ("proj_out", lambda x, o: attn.proj(o.flatten(2))),
            ("mlp_in", residual),
            ("mlp_pre", lambda x, m: mlp.fc1(m)),
            ("mlp_hidden", lambda x, pre: gelu_matched(pre)),
            ("mlp_out", lambda x, hid: mlp.fc2(hid)),
            (None, lambda x, y: self.drop_path(self.ls2(y))),
        )

    def forward(self, x, xpos: Optional[torch.Tensor] = None, cp_extra_tokens: int = 0):
        if isinstance(self.attn, DiffAttention):
            x = x + self.drop_path(self.ls1(self.attn(self.norm1(x), xpos)))
            return x + self.drop_path(self.ls2(self.mlp(self.norm2(x))))
        stages = self._stages(xpos, cp_extra_tokens)
        if self.remat is None or not torch.is_grad_enabled():
            y, x1 = _run_segment(stages, x, x)
            return x1 + y
        return _remat_segments(stages, self.remat, x)


# ---------------------------------------------------------------- rematerialisation


@dataclass(frozen=True)
class RematPolicy:
    """What a rematerialised ``SelfAttentionBlock`` keeps across the backward besides its
    input: the tensors of the stages in ``saved`` on the device, those in ``offloaded`` in
    host memory; everything else the backward recomputes from them. The tags are the JAX
    package's ``checkpoint_name`` tags (``qkv_out``, ``attn_out``, ``mlp_in``, ``mlp_pre``,
    ``mlp_hidden``) and the outputs of the two Dense layers that carry no tag there
    (``proj_out``, ``mlp_out``), which only the dot policies keep."""

    name: Optional[str]
    saved: FrozenSet[str] = frozenset()
    offloaded: FrozenSet[str] = frozenset()


def _policy(name, saved=(), offloaded=()):
    return RematPolicy(name, frozenset(saved), frozenset(offloaded))


# The JAX ``resolve_remat_policy`` (blocks.py:656-713), name by name. The attention is one
# kernel here, as the Pallas kernel is on the TPU: no product of it is a dot of XLA's, so
# "dots" (dots_with_no_batch_dims_saveable) and "dots_saveable" keep the same four Dense
# outputs.
_DOTS = ("qkv_out", "proj_out", "mlp_pre", "mlp_out")
REMAT_POLICIES = {
    None: _policy(None),
    "nothing": _policy("nothing"),
    "dots": _policy("dots", _DOTS),
    "dots_saveable": _policy("dots_saveable", _DOTS),
    "save_attn": _policy("save_attn", ("attn_out",)),
    "save_attn_mlp": _policy("save_attn_mlp", ("attn_out", "mlp_hidden")),
    "save_attn_mlp_pre": _policy("save_attn_mlp_pre", ("attn_out", "mlp_pre")),
    "save_qkv_attn_mlp": _policy("save_qkv_attn_mlp", ("qkv_out", "attn_out", "mlp_in", "mlp_pre")),
    "save_attn_mlp_pre_offload_qkv": _policy("save_attn_mlp_pre_offload_qkv", ("attn_out", "mlp_pre"), ("qkv_out",)),
    "save_qkv_attn_mlp_offload": _policy("save_qkv_attn_mlp_offload", ("qkv_out", "attn_out", "mlp_in"),
                                         ("mlp_pre",)),
}


def resolve_remat_policy(name: Optional[str]) -> RematPolicy:
    """The policy of a config string: None or "nothing" recompute everything. An unknown
    name raises ``KeyError``, as the JAX dict lookup does."""
    return REMAT_POLICIES[name]


def set_remat(blocks, remat: bool, policy: Optional[str] = None) -> None:
    """Rematerialise each ``SelfAttentionBlock`` of ``blocks`` under ``policy`` (JAX's
    ``nn.remat(SelfAttentionBlock, policy=resolve_remat_policy(policy))``), or, with
    ``remat`` False, let autograd keep what it saves; the policy is then not read, as in
    the JAX package. A block with ``DiffAttention`` has no stages and raises."""
    resolved = resolve_remat_policy(policy) if remat else None
    for block in blocks:
        if remat and isinstance(block.attn, DiffAttention):
            raise ValueError("a differential-attention block is not rematerialised")
        block.remat = resolved


def _run_segment(stages, cur, x=None):
    """``stages`` run from ``cur``: their output, and x1 where they pass "mlp_in"."""
    x1 = None
    for tag, fn in stages:
        cur = fn(x, cur)
        if tag == "mlp_in":
            cur, x1 = cur
    return cur if x1 is None else (cur, x1)


def _remat_segments(stages, policy: RematPolicy, x: torch.Tensor) -> torch.Tensor:
    """A block's forward as checkpointed segments that end at the tensors ``policy`` keeps.

    Each segment runs under non-reentrant ``torch.utils.checkpoint``, whose only saved
    tensors are its inputs: the block input ``x`` and the kept tensor the segment starts
    from. Autograd's own saved tensors inside a segment are recomputed from those when
    the backward first needs one, and the recompute stops once the last of them is back,
    so a kept tensor's producing product does not run again. Every segment restores the
    RNG state it started with before recomputing (``DropPath``). The residual adds run
    outside the segments: an add saves nothing, so the stream after the attention is
    kept by no segment and recomputed where ``norm2`` needs it. A tensor in
    ``policy.offloaded`` is the next segment's input, saved through ``_HostOffload``."""
    kept = policy.saved | policy.offloaded
    segments, current = [], []
    for tag, fn in stages:
        current.append((tag, fn))
        if tag is None or tag in kept:
            segments.append((tag, tuple(current)))
            current = []
    cur, x1, to_host = x, None, False
    for end, segment in segments:
        args = (cur, x) if any(tag == "mlp_in" for tag, _ in segment) else (cur,)
        with _HostOffload(cur) if to_host else contextlib.nullcontext():
            out = checkpoint(functools.partial(_run_segment, segment), *args, use_reentrant=False)
        cur, x1 = out if isinstance(out, tuple) else (out, x1)
        to_host = end in policy.offloaded
    return x1 + cur


class _HostCopy:
    """A tensor's copy in host memory, made on a side stream from a CUDA tensor (pinned);
    ``back()`` returns it to the tensor's device once the copy is done. A CPU tensor's copy
    is a clone."""

    def __init__(self, t: torch.Tensor):
        self.device, self.done = t.device, None
        if t.device.type != "cuda":
            self.host = t.clone()
            return
        self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        stream = torch.cuda.Stream(t.device)
        stream.wait_stream(torch.cuda.current_stream(t.device))
        with torch.cuda.stream(stream):
            self.host.copy_(t, non_blocking=True)
        t.record_stream(stream)  # its memory is not reused before the copy has read it
        self.done = stream.record_event()

    def back(self) -> torch.Tensor:
        if self.done is None:
            return self.host
        torch.cuda.current_stream(self.device).wait_event(self.done)
        return self.host.to(self.device, non_blocking=True)


class _HostOffload(torch.autograd.graph.saved_tensors_hooks):
    """Saved-tensor hooks that keep ``target`` in host memory across the backward (JAX's
    ``save_and_offload_only_these_names`` to pinned_host); other saved tensors pass."""

    def __init__(self, target: torch.Tensor):
        key = (target.data_ptr(), target.shape, target.stride())

        def pack(t):
            return _HostCopy(t) if (t.data_ptr(), t.shape, t.stride()) == key else t

        def unpack(saved):
            return saved.back() if isinstance(saved, _HostCopy) else saved

        super().__init__(pack, unpack)


class CrossAttentionBlock(nn.Module):
    """CroCo's decoder block: self-attention, then cross-attention of the tokens over
    the (normalised) context, then the MLP, each pre-norm with a residual. Names:
    ``norm1``/``attn``, ``norm_y`` (the context's norm: JAX ``norm_mem``),
    ``norm2``/``cross_attn`` (``projq``, ``projk``, ``projv``, ``proj``), ``norm3``/
    ``mlp``, and ``ls1``..``ls3`` with ``init_values``. With ``differential=True``
    the cross-attention is ``DiffCrossAttention``; the self-attention stays standard."""

    def __init__(
        self,
        dim,
        num_heads,
        mlp_ratio=4.0,
        qkv_bias=True,
        qk_norm=False,
        init_values: Optional[float] = None,
        drop_path=0.0,
        norm_mem=True,
        rope: Optional[Callable] = None,
        use_scalable_softmax=False,
        use_entropy_scaling=False,
        differential=False,
        layer_depth=0,
        dtype=torch.float32,
    ):
        super().__init__()
        layer_scale = lambda: LayerScale(dim, init_values) if init_values is not None else nn.Identity()  # noqa: E731
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = Attention(
            dim, num_heads, qkv_bias=qkv_bias, qk_norm=qk_norm, rope=rope,
            use_scalable_softmax=use_scalable_softmax, use_entropy_scaling=use_entropy_scaling, dtype=dtype,
        )
        self.ls1 = layer_scale()
        if norm_mem:
            self.norm_y = LayerNorm(dim, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        if differential:
            self.cross_attn = DiffCrossAttention(
                dim, layer_depth, num_heads, qkv_bias=qkv_bias, qk_norm=qk_norm, rope=rope, dtype=dtype
            )
        else:
            self.cross_attn = CrossAttention(
                dim, num_heads, qkv_bias=qkv_bias, qk_norm=qk_norm, rope=rope,
                use_scalable_softmax=use_scalable_softmax, use_entropy_scaling=use_entropy_scaling, dtype=dtype,
            )
        self.ls2 = layer_scale()
        self.norm3 = LayerNorm(dim, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype)
        self.ls3 = layer_scale()
        self.drop_path = DropPath(drop_path)

    def forward(self, x, context, xpos=None, cpos=None):
        x = x + self.drop_path(self.ls1(self.attn(self.norm1(x), xpos)))
        mem = self.norm_y(context) if hasattr(self, "norm_y") else context
        x = x + self.drop_path(self.ls2(self.cross_attn(self.norm2(x), mem, mem, xpos, cpos)))
        return x + self.drop_path(self.ls3(self.mlp(self.norm3(x))))


def _lambda_init(depth: int) -> float:
    """The Differential Transformer's lambda schedule."""
    return 0.8 - 0.6 * math.exp(-0.3 * depth)


class RMSNorm(nn.Module):
    """Root-mean-square norm over the last axis: the mean square in fp32, the
    product in the input's dtype; its scale is ``weight``."""

    def __init__(self, dim, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        var = x.float().square().mean(dim=-1, keepdim=True)
        y = x * torch.rsqrt(var + self.eps).to(x.dtype)
        return y * self.weight.to(x.dtype)


class _DiffAttend(nn.Module):
    """The shared part of ``DiffAttention`` and ``DiffCrossAttention``: two softmax
    maps over head groups, subtracted with the learned lambda, RMS-normalised per
    head (``subln``) and scaled by (1 - lambda_init).

    The value head dim (2·Dh) differs from the q/k head dim (Dh), so this is no
    flash-attention call: the maps are explicit products, in plain PyTorch, as in
    the JAX module (no TPU kernel computes them either)."""

    def _init_lambdas(self, head_dim: int, depth: int) -> None:
        self.lambda_init = _lambda_init(depth)
        for name in ("lambda_q1", "lambda_k1", "lambda_q2", "lambda_k2"):
            setattr(self, name, nn.Parameter(torch.zeros(head_dim)))
        self.subln = RMSNorm(2 * head_dim)

    def init_tokens(self, generator: torch.Generator) -> None:
        for name in ("lambda_q1", "lambda_k1", "lambda_q2", "lambda_k2"):
            nn.init.normal_(getattr(self, name), 0.0, 0.1, generator=generator)

    def _attend(self, q, k, v, n_heads: int, head_dim: int):
        """q, k (B, N, 2H, Dh) and v (B, Nk, H, 2Dh) -> (B, Nq, H·2Dh)."""
        scale = head_dim**-0.5

        def attend(qh, kh):
            logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
            w = torch.softmax(logits.float(), dim=-1).to(v.dtype)
            return torch.einsum("bhqk,bkhd->bqhd", w, v)

        attn1 = attend(q[:, :, :n_heads], k[:, :, :n_heads])
        attn2 = attend(q[:, :, n_heads:], k[:, :, n_heads:])
        lam_1 = torch.exp(torch.sum(self.lambda_q1 * self.lambda_k1))
        lam_2 = torch.exp(torch.sum(self.lambda_q2 * self.lambda_k2))
        lam = (lam_1 - lam_2 + self.lambda_init).to(attn1.dtype)
        attn = self.subln(attn1 - lam * attn2) * (1 - self.lambda_init)
        return attn.reshape(attn.shape[0], attn.shape[1], n_heads * 2 * head_dim)


class DiffAttention(_DiffAttend):
    """Differential self-attention (arXiv:2410.05258): ``qkv``, the four lambda
    vectors, ``subln`` and ``proj``; ``num_heads`` heads of 2·Dh values over
    2·``num_heads`` q/k heads of Dh = dim / num_heads / 2."""

    def __init__(self, dim, depth, num_heads=8, qkv_bias=False, rope: Optional[Callable] = None,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.rope = rope
        self.head_dim = dim // num_heads // 2
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias, dtype=dtype, init="xavier")
        self._init_lambdas(self.head_dim, depth)
        self.proj = Linear(dim, dim, dtype=dtype, init="xavier")

    def forward(self, x, xpos=None):
        B, N, _ = x.shape
        H, Dh = self.num_heads, self.head_dim
        q, k, v = self.qkv(x).reshape(B, N, 3, H, 2 * Dh).unbind(2)
        q, k = q.reshape(B, N, 2 * H, Dh), k.reshape(B, N, 2 * H, Dh)
        if self.rope is not None:
            q, k = self.rope(q, xpos), self.rope(k, xpos)
        return self.proj(self._attend(q, k, v, H, Dh))


class DiffCrossAttention(_DiffAttend):
    """Differential cross-attention: ``DiffAttention``'s maps over separate
    ``projq``, ``projk`` and ``projv`` projections of queries and context, with the
    optional head-dim LayerNorms and rope hook on q and k."""

    def __init__(self, dim, depth, num_heads=8, qkv_bias=False, qk_norm=False, rope: Optional[Callable] = None,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.rope = rope
        self.head_dim = dim // num_heads // 2
        self.projq = Linear(dim, dim, bias=qkv_bias, dtype=dtype, init="xavier")
        self.projk = Linear(dim, dim, bias=qkv_bias, dtype=dtype, init="xavier")
        self.projv = Linear(dim, dim, bias=qkv_bias, dtype=dtype, init="xavier")
        if qk_norm:
            self.q_norm = LayerNorm(self.head_dim, dtype=dtype)
            self.k_norm = LayerNorm(self.head_dim, dtype=dtype)
        self._init_lambdas(self.head_dim, depth)
        self.proj = Linear(dim, dim, dtype=dtype, init="xavier")

    def forward(self, query, key, value, qpos=None, kpos=None):
        B, Nq, _ = query.shape
        Nk = key.shape[1]
        H, Dh = self.num_heads, self.head_dim
        q = self.projq(query).reshape(B, Nq, 2 * H, Dh)
        k = self.projk(key).reshape(B, Nk, 2 * H, Dh)
        v = self.projv(value).reshape(B, Nk, H, 2 * Dh)
        if hasattr(self, "q_norm"):
            q, k = self.q_norm(q), self.k_norm(k)
        if self.rope is not None:
            if qpos is not None:
                q = self.rope(q, qpos)
            if kpos is not None:
                k = self.rope(k, kpos)
        return self.proj(self._attend(q, k, v, H, Dh))


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    # flax.linen.initializers.lecun_normal: a normal truncated at two standard
    # deviations, rescaled so that the variance is 1 / fan_in.
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation with the distributions of the Flax modules.

    Dense kernels: Xavier-uniform in the transformer blocks and the trunk's
    input projection, LeCun-normal elsewhere; convolutions LeCun-normal;
    biases zero; LayerNorm and GroupNorm one and zero; LayerScale its ``init_values``.
    Token and position parameters (``nn.Parameter``s held directly by a
    module) are set by the module that owns them through ``init_tokens``.
    """
    for m in module.modules():
        if isinstance(m, Linear):
            if m.init == "xavier":
                nn.init.xavier_uniform_(m.weight, generator=generator)
            else:
                _lecun_normal_(m.weight, m.in_features, generator)
        elif isinstance(m, nn.ConvTranspose2d):
            # Flax's kernel is (k, k, out, in) and its fan-in axis is `out`.
            kh, kw = m.kernel_size
            _lecun_normal_(m.weight, m.out_channels * kh * kw, generator)
        elif isinstance(m, nn.Conv2d):
            kh, kw = m.kernel_size
            _lecun_normal_(m.weight, m.in_channels * kh * kw, generator)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            nn.init.ones_(m.weight)
        elif isinstance(m, LayerScale):
            m.gamma.fill_(m.init_values)
        elif isinstance(m, RMSNorm):
            nn.init.ones_(m.weight)
            continue
        else:
            if hasattr(m, "init_tokens"):
                m.init_tokens(generator)
            continue
        if getattr(m, "bias", None) is not None:
            nn.init.zeros_(m.bias)
