"""Non-causal flash attention over (B, T, H, D) tensors, forward and backward.

The port's counterpart of ``mapanything_tpu/ops/flash_attention.py``:
``flash_attention`` (:1304) with its custom vjp (``_flash`` :1255,
``_flash_fwd_rule`` :1268, ``_flash_bwd_rule`` :1285), ``flash_attention_lse``
(:1323) and ``flash_attention_bwd_lse`` (:1357). On the TPU these reach the
Pallas kernels K1-K8 of PERF.md; here two hand-written Hopper sources serve
them: ``csrc/flash_attention_fwd.cu`` (the forward, with or without the lse
residual) and ``csrc/flash_attention_bwd.cu`` (the dq kernel and the dk/dv
kernel), each instantiated for head dims 64 and 128 in bf16 (``HEAD_DIMS``) and
32, 64 and 128 in fp32 (``F32_LSE_HEAD_DIMS``), with the fp32 lse-free forward also
at 48 (``F32_HEAD_DIMS``); any other head dim raises. D = 128
is K8's regime on the TPU (``d % 128 == 0``: ``_fwd_kernel``,
``_fwd_kernel_lse``, ``_dq_kernel``, ``_dkv_kernel``). D = 32 is the RGB
models' MAE decoder, which runs in fp32 whatever the model's dtype, and the
VGGSfM tracker's fine transformer; on the TPU its attention took
``_fwd_kernel_single(_lse)``, ``_fwd_stream_aug(_lse)``, ``_dq_aug_kernel`` and
``_dkv_aug_kernel``. D = 48 is the tracker's coarse transformer (inference only,
fp32), whose point-to-virtual attention took ``_fwd_kernel_single`` on the TPU.
The fp32 forward at those two (``NARROW_HEAD_DIMS``) has its own design
(``fa_fwd_f32_narrow``): products at the true width, short sequences packed
several to a tile (``fwd_f32_narrow_plan``), and q, k and v read in place and
split in the kernel's shared memory. The fp32 backward at D = 32 has one too
(``fa_bwd_dq_f32_narrow``, ``fa_bwd_dkv_f32_narrow``): the split pass writes the
parts 32 columns wide (``part_cols``), and the kernels read them through tensor
maps of 16-column boxes (``NARROW_BOX_COLS``) and run every product at the true
width. The plain versions below take any head dim: they are the plain version of
K8 as they are of K1-K7.

The bf16 kernels are Hopper's own design (wgmma, TMA, a producer warpgroup and
two consumer warpgroups on a persistent grid): they read q, k, v (and the
backward's dO) in place through 4-D TMA tensor maps, whose layout (dims, byte
strides, box) ``tensor_map`` computes from each tensor at each call; the C entry
points encode them with the driver's ``cuTensorMapEncodeTiled``, found through
the runtime. Their tile plans (``FWD_TILES``, ``BWD_TILES``) are the kernels',
which refuse maps of another box. The fp32 kernels are the same design on
split operands: a split pass (``flash_attention_split_f32``, one launch a
forward for q, k and v at D = 64 and 128, one a backward for q, k, v and dO)
writes each as three bf16 parts (hi, mid, lo: ``split_bf16x3_reference``), and
the forward, dq and dk/dv kernels compute every product as six bf16 products of
the parts, read through tensor maps of the parts (``FWD_F32_TILES``,
``BWD_F32_TILES``; 64-column boxes, at D = 32 16-column ones). The narrow
forward (D = 32 and 48) takes no split pass and no tensor map: it reads fp32 q,
k and v by 16-byte loads in the layouts ``narrow_layout`` gives, and its
launcher refuses a plan other than its own.

The masked form (``flash_attention_masked``: a boolean mask (B, 1|H, Tq, Tk), True =
attend, any dimension of size 1 broadcast) has a third source,
``csrc/flash_attention_masked.cu``: ``fa_fwd_masked`` (with or without lse),
``fa_bwd_dq_masked`` and ``fa_bwd_dkv_masked``, at the unmasked kernels' dtypes and head
dims. On the TPU XLA served it (``mapanything_tpu/ops/attention.py:77``). Its semantics
are JAX's: a masked logit is replaced by ``MASKED_LOGIT``, so a fully masked row takes the
mean of V over every key, its lse rounds to ``MASKED_LOGIT`` (the backward reads such a
row from its lse, ``fully_masked_rows``, and gives it P = 1/Tk), and no gradient reaches a
masked logit. Its plain versions are ``attention_masked_reference``,
``attention_masked_lse_reference`` and ``attention_masked_bwd_{dq,dkv}_reference``.

Routing. ``flash_attention`` runs the lse-free forward when no input needs a
gradient (inference is unchanged); otherwise an autograd Function runs the
forward with lse, saves q, k, v, o and lse, and its backward launches the dq
and dk/dv kernels. Dispatch is by the device of the inputs and by nothing
else: a CPU tensor goes to the plain PyTorch version beside each kernel; a
CUDA tensor launches the kernel or raises. Each kernel has its own launch
count (``flash_attention.launches``, ``flash_attention_lse.launches``,
``flash_attention_bwd_dq.launches``, ``flash_attention_bwd_dkv.launches`` and the
fp32 kernels' ``flash_attention_split_f32.launches``), so a run can show which
kernels it went through, and counts its launches by (key length,
head dim) in ``launches_by_shape``: ``launch_lengths`` gives the lse-free
forward's by key length, which tells its regimes apart, and ``launch_shapes``
every kernel's by key length and head dim, which tells the D = 64 and D = 128
instances apart.
"""

from __future__ import annotations

import ctypes
import struct
from collections import Counter
from typing import Optional, Tuple

import torch

from mapanything_tpu_torch.ops import _build

KERNEL_STEM = "flash_attention_fwd"
BWD_KERNEL_STEM = "flash_attention_bwd"
MASKED_KERNEL_STEM = "flash_attention_masked"
KERNEL_STEMS = (KERNEL_STEM, BWD_KERNEL_STEM, MASKED_KERNEL_STEM)
HEAD_DIMS = (64, 128)  # head dims the bf16 kernels are instantiated for
F32_HEAD_DIMS = (32, 48, 64, 128)  # and the fp32 lse-free forward (at 32 and 48 the narrow one)
F32_LSE_HEAD_DIMS = (32, 64, 128)  # the fp32 lse forward, dq and dk/dv (D = 48 runs inference alone)
# The kernels' instances: bf16 (wgmma) and fp32 (wgmma over split bf16 parts).
_DTYPES = (torch.bfloat16, torch.float32)
# The bf16 forward's tile plan by head dim, (query rows, key rows) a block: FwdPlan in
# csrc/flash_attention_fwd.cu, which refuses maps whose boxes differ.
FWD_TILES = {64: (128, 176), 128: (128, 176)}
# The fp32 forward's at D = 64 and 128, the same pair: FwdF32Plan, whose tiles hold three
# bf16 parts each.
FWD_F32_TILES = {64: (128, 96), 128: (128, 32)}
# The narrow fp32 forward (fa_fwd_f32_narrow, FwdF32NarrowPlan): 128 query rows a work tile;
# packed, one key tile of 128 keys; streaming, key tiles of these many keys by head dim.
NARROW_HEAD_DIMS = (32, 48)
NARROW_TILE_ROWS = 128
NARROW_PACKED_KEYS = 128
NARROW_STREAM_KEYS = {32: 96, 48: 64}
NARROW_MAX_PACKED = 64  # the longest Tq and Tk that the packed regime takes
# The bf16 backward's plans by head dim: the dq kernel's (query rows a work tile, keys a
# K or V tile) and the dk/dv kernel's (keys a work tile, query rows a stage): DqPlan and
# DkvPlan in csrc/flash_attention_bwd.cu.
BWD_TILES = {64: {"dq": (128, 128), "dkv": (128, 96)}, 128: {"dq": (128, 64), "dkv": (128, 32)}}
# The fp32 backward's plans, the same pairs, by head dim: DqF32Plan and DkvF32Plan at 64 and
# 128, DqF32NarrowPlan and DkvF32NarrowPlan at 32.
BWD_F32_TILES = {32: {"dq": (128, 64), "dkv": (128, 64)}, 64: {"dq": (128, 64), "dkv": (128, 64)},
                 128: {"dq": (64, 32), "dkv": (64, 32)}}
# The masked kernels' tiles (csrc/flash_attention_masked.cu kQT, kKT): query rows a block of
# the forward and dq kernels, keys a block of the dk/dv kernel.
MASKED_TILES = (64, 64)
# The logit a False mask entry puts in place of q.k * scale: -0.7 * FLT_MAX in fp32, as
# jax.nn.dot_product_attention's _get_large_negative (bits 0xff333332).
MASKED_LOGIT = -0.7 * float(torch.finfo(torch.float32).max)
TMA_BOX_COLS = 64  # a box is one 128-byte swizzle row of bf16 wide
NARROW_BOX_COLS = 16  # the fp32 D = 32 backward's boxes: one 32-byte swizzle row, a 16-column panel


def head_dims(dtype: torch.dtype, lse: bool = False) -> Tuple[int, ...]:
    """The head dims with a kernel instance in ``dtype``: of the lse-free forward, or with
    ``lse`` of the lse forward and the backward kernels."""
    if dtype != torch.float32:
        return HEAD_DIMS
    return F32_LSE_HEAD_DIMS if lse else F32_HEAD_DIMS


def part_cols(d: int) -> int:
    """The columns of the fp32 split parts of head dim ``d`` (32, 64 or 128: the split
    pass's dims, the backward's and the forward's at 64 and 128): ``d`` itself, no column
    padded. Raises for a head dim without a split pass."""
    if d not in F32_LSE_HEAD_DIMS:
        raise ValueError(f"head dim {d} has no split pass (built: {F32_LSE_HEAD_DIMS})")
    return d


def fwd_f32_narrow_plan(b: int, tq: int, tk: int, h: int, d: int) -> dict:
    """The narrow fp32 forward's plan at D = 32 or 48 (narrow_plan in
    csrc/flash_attention_fwd.cu, which refuses any other): ``regime`` "packed" where Tq
    and Tk are at most 64, else "streaming"; ``seqs_per_tile``, the (batch, head)
    sequences a work tile holds; ``rows_per_seq`` and ``keys_per_seq``, the query rows and
    keys a sequence takes in a tile (packed: Tq and Tk rounded up to powers of two; a
    streaming tile takes 128 query rows of its sequence against all Tk keys);
    ``keys_per_tile``; ``work_tiles``. A packed tile holds 128 / max(rows, keys)
    sequences: row r is token r % rows of sequence r // rows, key c token c % keys of
    sequence c // keys, and row r attends key c where both sequences agree and the token
    is < Tk. Sequence s is batch s // H, head s % H; tile w takes sequences
    w * seqs_per_tile onwards (packed) or query rows 128 (w % ceil(Tq / 128)) onwards of
    sequence w // ceil(Tq / 128) (streaming)."""
    if d not in NARROW_HEAD_DIMS:
        raise ValueError(f"head dim {d} has no narrow fp32 forward (built: {NARROW_HEAD_DIMS})")
    if tq <= NARROW_MAX_PACKED and tk <= NARROW_MAX_PACKED:
        rows, keys = 1 << (tq - 1).bit_length(), 1 << (tk - 1).bit_length()
        g = NARROW_TILE_ROWS // max(rows, keys)
        return {"regime": "packed", "seqs_per_tile": g, "rows_per_seq": rows, "keys_per_seq": keys,
                "keys_per_tile": NARROW_PACKED_KEYS, "work_tiles": -(-b * h // g)}
    return {"regime": "streaming", "seqs_per_tile": 1, "rows_per_seq": NARROW_TILE_ROWS, "keys_per_seq": tk,
            "keys_per_tile": NARROW_STREAM_KEYS[d], "work_tiles": -(-tq // NARROW_TILE_ROWS) * b * h}


def narrow_layout(x: torch.Tensor) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The layout in which the narrow fp32 forward reads a (B, T, H, D) fp32 tensor in
    place: dims (D, T, H, B), innermost first, and the byte strides of T, H and B (a view
    of a fused qkv tensor has T-stride 3·H·D·4 and H-stride D·4). Its 16-byte loads need
    a unit head-dim stride, a 16-byte-aligned base and strides that are multiples of 16
    bytes; anything else raises ValueError."""
    if x.dtype != torch.float32 or x.dim() != 4:
        raise ValueError(f"the narrow forward reads fp32 (B, T, H, D) tensors, got {x.dtype} {tuple(x.shape)}")
    b, t, h, d = x.shape
    sb, st, sh, sd = x.stride()
    if sd != 1:
        raise ValueError(f"the head-dim stride must be 1, got {x.stride()}")
    strides = (st * 4, sh * 4, sb * 4)
    if x.data_ptr() % 16 or (strides[0] | strides[1] | strides[2]) % 16:
        raise ValueError(f"base and strides must be 16-byte aligned, got {x.stride()} at {x.data_ptr():#x}")
    return (d, t, h, b), strides


def _narrow_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Tuple[bytes, bytes]:
    """The narrow forward's packed layouts (7 int64 each: dims[4], byte strides[3]) and
    plan (6 int32: packed, seqs_per_tile, rows_per_seq, keys_per_seq, keys_per_tile,
    work_tiles)."""
    values = [n for x in (q, k, v) for part in narrow_layout(x) for n in part]
    b, tq, h, d = q.shape
    plan = fwd_f32_narrow_plan(b, tq, k.shape[1], h, d)
    return (struct.pack("21q", *values),
            struct.pack("6i", plan["regime"] == "packed", *(plan[key] for key in list(plan)[1:])))


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """Plain softmax(q kᵀ scale) v in fp32 (fp64 for fp64 inputs), cast back
    to the input dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    acc = _acc_dtype(q.dtype)
    qf, kf, vf = q.to(acc), k.to(acc), v.to(acc)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    logits = logits - logits.amax(dim=-1, keepdim=True)
    w = torch.exp(logits)
    w = w / w.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", w, vf).to(q.dtype)


def attention_lse_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain (o, lse): o as ``attention_reference``, lse (B, H, Tq) the natural
    log of the softmax normaliser of the scaled logits, fp32 (fp64 for fp64)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    acc = _acc_dtype(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    lse = torch.logsumexp(logits, dim=-1)
    w = torch.exp(logits - lse[..., None])
    return torch.einsum("bhqk,bkhd->bqhd", w, v.to(acc)).to(q.dtype), lse


def attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The FlashAttention-2 backward formulas written out in fp32 (fp64 for fp64).

    P = exp(q kᵀ scale − lse), delta = rowsum(dO·O), dV = Pᵀ dO,
    dS = P ∘ (dO Vᵀ − delta), dQ = dS K scale, dK = dSᵀ Q scale.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    delta = attention_bwd_delta(o, do)
    return (
        attention_bwd_dq_reference(q, k, v, do, lse, delta, scale),
        *attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale),
    )


def attention_bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO·O), (B, H, Tq), in fp32 (fp64 for fp64)."""
    acc = _acc_dtype(o.dtype)
    return (do.to(acc) * o.to(acc)).sum(-1).transpose(1, 2)


def _plain_p_ds(q, k, v, do, lse, delta, scale):
    acc = _acc_dtype(q.dtype)
    qf, kf, vf, dof = (x.to(acc) for x in (q, k, v, do))
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse.to(acc)[..., None])
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta.to(acc)[..., None])
    return qf, kf, dof, p, ds


def attention_bwd_dq_reference(q, k, v, do, lse, delta, scale):
    """Plain version of the dq kernel: dQ = dS K scale."""
    _, kf, _, _, ds = _plain_p_ds(q, k, v, do, lse, delta, scale)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale).to(q.dtype)


def attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale):
    """Plain version of the dk/dv kernel: dK = dSᵀ Q scale, dV = Pᵀ dO."""
    qf, _, dof, p, ds = _plain_p_ds(q, k, v, do, lse, delta, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dk.to(k.dtype), dv.to(v.dtype)


def split_bf16x3_reference(x: torch.Tensor, cols: Optional[int] = None) -> torch.Tensor:
    """x (fp32) as its three bf16 parts stacked on a new leading axis, a contiguous
    (3, *x.shape) tensor: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid),
    rounded to nearest even. Both differences are exact in fp32, and hi + mid + lo is
    within 2^-24 |x| of x. With ``cols``, the last axis is zero-padded to ``cols``. The
    plain version of the split kernel."""
    hi = x.to(torch.bfloat16)
    rest = x - hi.float()
    mid = rest.to(torch.bfloat16)
    parts = torch.stack((hi, mid, (rest - mid.float()).to(torch.bfloat16)))
    if cols is not None and cols > x.shape[-1]:
        parts = torch.nn.functional.pad(parts, (0, cols - x.shape[-1]))
    return parts


_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _bind(stem: str, name: str, n_ptrs: int, n_ints: int, n_strides: int, scale: bool = True):
    fn = getattr(_build.load(stem), name)
    if fn.argtypes is None:
        fn.argtypes = ([_PTR] * n_ptrs + [_I32] * n_ints + [_I64] * n_strides
                       + ([ctypes.c_float] if scale else []) + [_PTR])
        fn.restype = ctypes.c_int
    return fn


def tensor_map(
    x: torch.Tensor, box_rows: int, box_cols: int = TMA_BOX_COLS
) -> Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]:
    """The layout of the 4-D TMA tensor map through which a bf16 kernel reads a
    (B, T, H, D) tensor in place: (dims, byte strides, box).

    dims are (D, T, H, B), innermost first; the strides are those of T, H and B in
    bytes (they need not grow: a view of a fused qkv tensor has T-stride 3·H·D and
    H-stride D); the box is (``box_cols``, ``box_rows``, 1, 1): 64 columns, one
    128-byte swizzle row, so a row of D = 128 is two boxes; or 16 (``NARROW_BOX_COLS``),
    one 32-byte swizzle row, two boxes a row of the D = 32 parts. TMA demands a
    16-byte-aligned base, strides that are multiples of 16 bytes and a unit head-dim
    stride; anything else raises ValueError.
    """
    b, t, h, d = x.shape
    sb, st, sh, sd = x.stride()
    if sd != 1:
        raise ValueError(f"the head-dim stride must be 1, got {x.stride()}")
    if d % box_cols:
        raise ValueError(f"head dim {d} is not a multiple of the {box_cols}-column box")
    item = x.element_size()
    strides = (st * item, sh * item, sb * item)
    if x.data_ptr() % 16 or (strides[0] | strides[1] | strides[2]) % 16:
        raise ValueError(f"base and strides must be 16-byte aligned, got {x.stride()} at {x.data_ptr():#x}")
    return (d, t, h, b), strides, (box_cols, box_rows, 1, 1)


def _pack_maps(*maps: Tuple[torch.Tensor, int], box_cols: int = TMA_BOX_COLS) -> bytes:
    """The tensor maps of (tensor, box rows) pairs, boxes ``box_cols`` wide, packed for
    a C entry point (11 int64 each: dims[4], strides[3], box[4])."""
    values = [n for x, rows in maps for part in tensor_map(x, rows, box_cols) for n in part]
    return struct.pack(f"{len(values)}q", *values)


def _tensor_maps(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tiles: dict = FWD_TILES) -> bytes:
    """q's, k's and v's tensor maps for the forward of the plan ``tiles``."""
    rows_q, rows_kv = tiles[q.shape[3]]
    return _pack_maps((q, rows_q), (k, rows_kv), (v, rows_kv))


def _fwd_f32_tensor_maps(*parts: torch.Tensor) -> bytes:
    """The tensor maps of the fp32 forward at D = 64 and 128: each (3, B, T, H, D) part
    tensor of q, k and v as one (3B, T, H, D) map (part p of batch b at p·B + b), boxed by
    ``FWD_F32_TILES``."""
    return _tensor_maps(*(x.flatten(0, 1) for x in parts), tiles=FWD_F32_TILES)


def _bwd_tensor_maps(kernel: str, q, k, v, do, tiles: dict = BWD_TILES, box_cols: int = TMA_BOX_COLS) -> bytes:
    """q's, k's, v's and dO's tensor maps for the dq (``kernel`` "dq") or dk/dv ("dkv")
    kernel of the plan ``tiles``: q and dO in boxes of query rows, k and v in boxes of keys."""
    own, streamed = tiles[q.shape[3]][kernel]
    rows_q, rows_kv = (own, streamed) if kernel == "dq" else (streamed, own)
    return _pack_maps((q, rows_q), (k, rows_kv), (v, rows_kv), (do, rows_q), box_cols=box_cols)


def _bwd_f32_tensor_maps(kernel: str, *parts: torch.Tensor) -> bytes:
    """The tensor maps of the fp32 dq or dk/dv kernel: each (3, B, T, H, D) part tensor of
    q, k, v and dO as one (3B, T, H, D) map (part p of batch b at p·B + b), boxed by
    ``BWD_F32_TILES``: 64 columns wide, at D = 32 ``NARROW_BOX_COLS``."""
    box_cols = NARROW_BOX_COLS if parts[0].shape[-1] in NARROW_HEAD_DIMS else TMA_BOX_COLS
    return _bwd_tensor_maps(kernel, *(x.flatten(0, 1) for x in parts), tiles=BWD_F32_TILES, box_cols=box_cols)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: bool = False) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention expects (B, T, H, D) tensors")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes bf16 or fp32, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in head_dims(q.dtype, lse):
        raise ValueError(f"head dim {d} has no {q.dtype} {'lse or backward' if lse else 'forward'} kernel instance "
                         f"(built: {head_dims(q.dtype, lse)})")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    align = 16 // q.element_size()  # 16-byte vector loads (and TMA boxes) of each row
    for name, x in (("q", q), ("k", k), ("v", v)):
        sb, st, sh, sd = x.stride()
        if sd != 1:
            raise ValueError(f"{name}: the head-dim stride must be 1, got {x.stride()}")
        if x.data_ptr() % 16 or (sb | st | sh) % align:
            raise ValueError(f"{name}: base and strides must be 16-byte aligned, got {x.stride()}")


def _strides(*xs: torch.Tensor) -> list:
    return [st for x in xs for st in x.stride()[:3]]


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` if the kernels can read it in place (through a TMA map in bf16), else a
    contiguous copy in a new allocation: a head-dim stride other than 1, a base or a
    stride off 16 bytes, or a broadcast (zero) stride, as autograd may hand a cotangent.
    (``contiguous()`` would hand back a contiguous tensor at a misaligned base as it is.)"""
    align = 16 // x.element_size()
    strides = x.stride()[:3]
    if (x.stride(3) == 1 and x.data_ptr() % 16 == 0 and not any(s % align for s in strides)
            and all(s > 0 or n == 1 for s, n in zip(strides, x.shape))):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _launch_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, with_lse: bool, parts=None, out=None
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The forward kernel on CUDA tensors; in fp32 at D = 64 and 128 on ``parts``, the
    split pass's parts of q, k and v (one split pass first when not given), at D = 32 and
    48 on q, k and v themselves (the narrow forward; ``parts`` must be None). ``out``:
    (o, lse or None), contiguous tensors to write into (new ones when not given)."""
    _check(q, k, v, with_lse)
    b, tq, h, d = q.shape
    narrow = q.dtype == torch.float32 and d in NARROW_HEAD_DIMS
    if narrow and parts is not None:
        raise ValueError(f"the fp32 forward at D = {d} splits in the kernel: it takes no parts")
    if q.dtype == torch.bfloat16:
        name, inputs, maps = "flash_attention_fwd_bf16", (q, k, v), (_tensor_maps(q, k, v),)
    elif narrow:  # the operands' layouts and the plan
        name, inputs, maps = "flash_attention_fwd_f32_narrow", (q, k, v), _narrow_args(q, k, v)
    else:
        parts = flash_attention_split_f32(q, k, v) if parts is None else parts
        name, inputs, maps = "flash_attention_fwd_f32", parts, (_fwd_f32_tensor_maps(*parts),)
    if out is None:
        o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device) if with_lse else None
    else:
        o, lse = out
        if o.shape != q.shape or not o.is_contiguous() or (lse is not None) != with_lse:
            raise ValueError("out must hold a contiguous o of q's shape and an lse exactly when with_lse")
    ptrs = [x.data_ptr() for x in (*inputs, o)] + [None if lse is None else lse.data_ptr()] + list(maps)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bind(KERNEL_STEM, name, len(ptrs), 5, 0)(*ptrs, b, tq, k.shape[1], h, d, float(scale), stream)
    _raise_on(err, name)
    return o, lse


def _check_bwd(q, k, v, do, lse, delta) -> torch.Tensor:
    _check(q, k, v, lse=True)
    b, tq, h, _ = q.shape
    if do.shape != q.shape or lse.shape != (b, h, tq) or delta.shape != (b, h, tq):
        raise ValueError(f"do {tuple(do.shape)}, lse {tuple(lse.shape)} and delta "
                         f"{tuple(delta.shape)} do not fit q {tuple(q.shape)}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 (B, H, Tq) tensor")
    return _aligned(do.to(q.dtype))


def flash_attention_split_f32(q, k, v, do=None) -> Tuple[torch.Tensor, ...]:
    """The split pass of the fp32 kernels that read split parts (the forward at D = 64 and
    128, the backward at 32, 64 and 128): each of q, k, v and, where given (the backward),
    dO (fp32 (B, T, H, D)) as its three bf16 parts, a contiguous (3, B, T, H, D) tensor each
    (hi, mid, lo of ``split_bf16x3_reference``; no column padded). One launch of the split
    kernel (in the backward's source) for the three or four on CUDA tensors; the plain
    version on CPU tensors."""
    xs = (q, k, v) if do is None else (q, k, v, do)
    cols = part_cols(q.shape[-1])
    if _device_of(q) == "cpu":
        return tuple(split_bf16x3_reference(x, cols) for x in xs)
    _check(q, k, v)
    if q.dtype != torch.float32 or any(x.dtype != torch.float32 or x.shape != q.shape for x in xs[3:]):
        raise TypeError(f"the split takes fp32 q, k, v and a dO of q's shape, got "
                        f"{[(x.dtype, tuple(x.shape)) for x in xs]}")
    xs = (q, k, v, *(_aligned(x) for x in xs[3:]))
    parts = tuple(torch.empty((3, *x.shape[:-1], cols), dtype=torch.bfloat16, device=q.device) for x in xs)
    b, tq, h, d = q.shape
    absent = [None] * (4 - len(xs))  # no dO: null pointers, strides not read
    ptrs = [x.data_ptr() for x in xs] + absent + [x.data_ptr() for x in parts] + absent
    strides = _strides(*xs) + [0] * (3 * len(absent))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bind(BWD_KERNEL_STEM, "flash_attention_split_f32", 8, 5, 12, scale=False)(
            *ptrs, b, tq, k.shape[1], h, d, *strides, stream)
    _raise_on(err, "flash_attention_split_f32")
    _count(flash_attention_split_f32, k)
    return parts


def _launch_bwd(kernel: str, q, k, v, do, lse, delta, scale, outs, parts=None) -> None:
    """Launch the dq (``kernel`` "dq") or dk/dv ("dkv") kernel into ``outs``; in fp32 on
    ``parts``, the split pass's parts of q, k, v and dO."""
    b, tq, h, d = q.shape
    if q.dtype == torch.bfloat16:
        name, inputs, maps = f"flash_attention_bwd_{kernel}_bf16", (q, k, v, do), _bwd_tensor_maps(kernel, q, k, v, do)
    else:
        name, inputs, maps = f"flash_attention_bwd_{kernel}_f32", parts, _bwd_f32_tensor_maps(kernel, *parts)
    ptrs = [x.data_ptr() for x in (*inputs, lse, delta, *outs)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bind(BWD_KERNEL_STEM, name, len(ptrs) + 1, 5, 0)(*ptrs, maps, b, tq, k.shape[1], h, d, float(scale),
                                                               stream)
    _raise_on(err, name)


def _launch_bwd_kernels(kernels: Tuple[str, ...], q, k, v, do, lse, delta, scale) -> dict:
    """The dq ("dq") and/or dk/dv ("dkv") kernels on CUDA tensors, after one split pass
    in fp32: {"dq": dq, "dk": dk, "dv": dv} of those launched."""
    do = _check_bwd(q, k, v, do, lse, delta)
    parts = flash_attention_split_f32(q, k, v, do) if q.dtype == torch.float32 else None
    out = {}
    if "dq" in kernels:
        out["dq"] = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        _launch_bwd("dq", q, k, v, do, lse, delta, scale, (out["dq"],), parts)
        _count(flash_attention_bwd_dq, k)
    if "dkv" in kernels:
        out["dk"] = torch.empty(k.shape, dtype=q.dtype, device=q.device)
        out["dv"] = torch.empty_like(out["dk"])
        _launch_bwd("dkv", q, k, v, do, lse, delta, scale, (out["dk"], out["dv"]), parts)
        _count(flash_attention_bwd_dkv, k)
    return out


def flash_attention_bwd_dq(q, k, v, do, lse, delta, scale):
    """dq of the backward from lse and delta (each (B, H, Tq) fp32): the dq kernel
    on CUDA tensors (in fp32 after its split pass), its plain version on CPU tensors."""
    if _device_of(q) == "cpu":
        return attention_bwd_dq_reference(q, k, v, do, lse, delta, scale)
    return _launch_bwd_kernels(("dq",), q, k, v, do, lse, delta, scale)["dq"]


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale):
    """(dk, dv) of the backward from lse and delta: the dk/dv kernel on CUDA
    tensors (in fp32 after its split pass), its plain version on CPU tensors."""
    if _device_of(q) == "cpu":
        return attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale)
    out = _launch_bwd_kernels(("dkv",), q, k, v, do, lse, delta, scale)
    return out["dk"], out["dv"]


def _device_of(q: torch.Tensor) -> str:
    if q.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return q.device.type


def flash_attention_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): o as ``flash_attention``; lse (B, H, Tq) fp32, the natural log
    of sum_j exp(s_ij) of the scaled logits s = q·k·scale. Not differentiable:
    callers own the backward (``flash_attention_bwd_lse``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _device_of(q) == "cpu":
        return attention_lse_reference(q, k, v, scale)
    out = _launch_fwd(q, k, v, scale, with_lse=True)
    _count(flash_attention_lse, k)
    return out


def flash_attention_bwd_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FlashAttention-2 backward of the KV set (k, v) against a given softmax.

    ``o`` (B, Tq, H, D) and ``lse`` (B, H, Tq, natural log) describe the
    softmax over the whole KV set, of which (k, v) may be one block, as in
    ring attention; ``do`` is the output cotangent. Returns (dq, dk, dv):
    this block's part of dq (the sum over blocks is the whole) and dk, dv
    of this block, each in the inputs' dtype.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _device_of(q) == "cpu":
        return attention_bwd_reference(q, k, v, o, lse, do, scale)
    if o.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} does not fit q {tuple(q.shape)}")
    # delta = rowsum(dO·O) in fp32, outside the kernels as in the JAX package (:1048).
    delta = attention_bwd_delta(o, do).contiguous()
    out = _launch_bwd_kernels(("dq", "dkv"), q, k, v, do, lse.float().contiguous(), delta, scale)
    return out["dq"], out["dk"], out["dv"]


class _FlashAttention(torch.autograd.Function):
    """The custom vjp: forward with lse, backward through the dq and dk/dv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_attention_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_lse(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """softmax(q kᵀ scale) v over q (B, Tq, H, D) and k, v (B, Tk, H, D).

    CUDA tensors run the Hopper kernels (bf16 at D = 64 or 128, fp32 at D = 32, 64 or
    128, and without gradients also at 48) and come back
    as a contiguous (B, Tq, H, D) tensor; CPU tensors run the plain versions.
    The result is differentiable when an input requires grad.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    device = _device_of(q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, float(scale))
    if device == "cpu":
        return attention_reference(q, k, v, scale)
    o, _ = _launch_fwd(q, k, v, scale, with_lse=False)
    _count(flash_attention, k)
    return o


# ---------------------------------------------------------------- the masked form


def masked_view(mask: torch.Tensor, b: int, h: int, tq: int, tk: int) -> torch.Tensor:
    """The boolean ``mask`` (B|1, H|1, Tq|1, Tk|1) as a (B, H, Tq, Tk) view: each dimension
    of size 1 broadcast with stride 0, nothing copied. Raises for another dtype or a shape
    that does not broadcast."""
    if mask.dtype != torch.bool:
        raise TypeError(f"the mask must be boolean (True = attend), got {mask.dtype}")
    if mask.dim() != 4:
        raise ValueError(f"the mask must be (B, 1|H, Tq, Tk), got {tuple(mask.shape)}")
    try:
        return mask.expand(b, h, tq, tk)
    except RuntimeError as err:
        raise ValueError(f"the mask {tuple(mask.shape)} does not broadcast to {(b, h, tq, tk)}") from err


def _masked_logits(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, H, Tq, Tk) logits q.k * scale in fp32 (fp64 for fp64), ``MASKED_LOGIT`` where the
    mask is False."""
    acc = _acc_dtype(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    return torch.where(mask, logits, torch.full((), MASKED_LOGIT, dtype=acc, device=logits.device))


def _softmax_v(logits: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(logits) v, the probabilities rounded to v's dtype before the product."""
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype).to(w.dtype), v.to(w.dtype)).to(v.dtype)


def attention_masked_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """Plain ``jax.nn.dot_product_attention(q, k, v, scale=scale, mask=mask)``: the masked
    logits in fp32, their softmax in fp32, the probabilities rounded to the inputs' dtype
    before P.V. Differentiable by autograd."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _softmax_v(_masked_logits(q, k, mask, scale), v)


def attention_masked_lse_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain (o, lse): o as ``attention_masked_reference``, lse (B, H, Tq) the natural log of
    the softmax normaliser of the masked logits (``MASKED_LOGIT`` on a fully masked row)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = _masked_logits(q, k, mask, scale)
    return _softmax_v(logits, v), torch.logsumexp(logits, dim=-1)


def fully_masked_rows(lse: torch.Tensor) -> torch.Tensor:
    """The rows whose every key is masked, read from their lse: it rounds to
    ``MASKED_LOGIT``, and a row with a key left has an lse of at least its largest logit."""
    return lse <= 0.5 * MASKED_LOGIT


def _masked_p_ds(q, k, v, do, mask, lse, delta, scale):
    acc = _acc_dtype(q.dtype)
    logits = _masked_logits(q, k, mask, scale)
    lse = lse.to(acc)[..., None]
    full = fully_masked_rows(lse)
    p = torch.where(full, torch.full((), 1.0 / k.shape[1], dtype=acc, device=q.device), torch.exp(logits - lse))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(acc), v.to(acc))
    ds = torch.where(mask & ~full, p * (dp - delta.to(acc)[..., None]), torch.zeros((), dtype=acc, device=q.device))
    return p, ds


def attention_masked_bwd_dq_reference(q, k, v, do, mask, lse, delta, scale):
    """Plain version of the masked dq kernel: dQ = dS K scale, dS zero at every masked
    position and on every fully masked row."""
    _, ds = _masked_p_ds(q, k, v, do, mask, lse, delta, scale)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.to(ds.dtype)) * scale).to(q.dtype)


def attention_masked_bwd_dkv_reference(q, k, v, do, mask, lse, delta, scale):
    """Plain version of the masked dk/dv kernel: dK = dSᵀ Q scale, dV = Pᵀ dO with P rounded
    to the inputs' dtype and 1/Tk on a fully masked row."""
    p, ds = _masked_p_ds(q, k, v, do, mask, lse, delta, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(ds.dtype)) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).to(p.dtype), do.to(p.dtype))
    return dk.to(k.dtype), dv.to(v.dtype)


def _masked_strides(q, k, v, do, mask) -> ctypes.Array:
    """The 16 int64 strides of a masked kernel: q's, k's, v's and dO's (batch, token, head)
    in elements (zeros without dO), then the (B, H, Tq, Tk) mask view's in bytes."""
    rows = [x.stride()[:3] if x is not None else (0, 0, 0) for x in (q, k, v, do)]
    return (ctypes.c_longlong * 16)(*[n for row in rows for n in row], *mask.stride())


def _launch_masked(kernel: str, q, k, v, mask, scale, do=None, lse=None, delta=None, with_lse=False):
    """One masked kernel on CUDA tensors: "fwd" returns (o, lse or None), "dq" dq, "dkv"
    (dk, dv). ``mask`` is the (B, H, Tq, Tk) view of ``masked_view``."""
    _check(q, k, v, lse=with_lse or kernel != "fwd")
    if mask.device != q.device:
        raise ValueError("the mask must be on q's device")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    new = lambda shape, dtype=q.dtype: torch.empty(shape, dtype=dtype, device=q.device)  # noqa: E731
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    if kernel == "fwd":
        outs = (new((b, tq, h, d)), new((b, h, tq), torch.float32) if with_lse else None)
        args = [ptr(x) for x in (q, k, v, mask, *outs)]
    else:
        do = _check_bwd(q, k, v, do, lse, delta)
        outs = (new((b, tq, h, d)),) if kernel == "dq" else (new((b, tk, h, d)), new((b, tk, h, d)))
        args = [ptr(x) for x in (q, k, v, do, mask, lse, delta, *outs)]
    name = f"flash_attention_masked_{'fwd' if kernel == 'fwd' else 'bwd_' + kernel}"
    fn = getattr(_build.load(MASKED_KERNEL_STEM), name)
    if fn.argtypes is None:
        fn.argtypes = [_PTR] * len(args) + [_I32] * 6 + [_PTR, ctypes.c_float, _PTR]
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, int(q.dtype == torch.float32), b, tq, tk, h, d, _masked_strides(q, k, v, do, mask),
                 float(scale), stream)
    _raise_on(err, name)
    return outs


def flash_attention_masked_lse(q, k, v, mask, scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of the masked form, ``mask`` a (B, H, Tq, Tk) view (``masked_view``): the
    lse forward ``fa_fwd_masked`` on CUDA tensors, its plain version on CPU tensors. Not
    differentiable: ``_FlashAttentionMasked`` owns the backward."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _device_of(q) == "cpu":
        return attention_masked_lse_reference(q, k, v, mask, scale)
    out = _launch_masked("fwd", q, k, v, mask, scale, with_lse=True)
    _count(flash_attention_masked_lse, k)
    return out


def flash_attention_masked_bwd_dq(q, k, v, do, mask, lse, delta, scale):
    """dq of the masked backward from lse and delta: ``fa_bwd_dq_masked`` on CUDA tensors,
    its plain version on CPU tensors."""
    if _device_of(q) == "cpu":
        return attention_masked_bwd_dq_reference(q, k, v, do, mask, lse, delta, scale)
    (dq,) = _launch_masked("dq", q, k, v, mask, scale, do, lse, delta)
    _count(flash_attention_masked_bwd_dq, k)
    return dq


def flash_attention_masked_bwd_dkv(q, k, v, do, mask, lse, delta, scale):
    """(dk, dv) of the masked backward: ``fa_bwd_dkv_masked`` on CUDA tensors, its plain
    version on CPU tensors."""
    if _device_of(q) == "cpu":
        return attention_masked_bwd_dkv_reference(q, k, v, do, mask, lse, delta, scale)
    out = _launch_masked("dkv", q, k, v, mask, scale, do, lse, delta)
    _count(flash_attention_masked_bwd_dkv, k)
    return out


class _FlashAttentionMasked(torch.autograd.Function):
    """The masked form's vjp: forward with lse, backward through the masked dq and dk/dv
    kernels (delta = rowsum(dO·O) outside them, as in the unmasked backward)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale):
        o, lse = flash_attention_masked_lse(q, k, v, mask, scale)
        ctx.save_for_backward(q, k, v, o, lse, mask)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, mask = ctx.saved_tensors
        delta = attention_bwd_delta(o, do).contiguous()
        lse = lse.float().contiguous()
        dq = flash_attention_masked_bwd_dq(q, k, v, do, mask, lse, delta, ctx.scale)
        dk, dv = flash_attention_masked_bwd_dkv(q, k, v, do, mask, lse, delta, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_masked(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """softmax(where(mask, q kᵀ scale, MASKED_LOGIT)) v over q (B, Tq, H, D) and k, v (B, Tk,
    H, D), ``mask`` boolean (B, 1|H, Tq, Tk), True = attend (read in place, broadcast
    dimensions with stride 0). CUDA tensors run ``fa_fwd_masked`` (with an input that
    requires grad, the lse form and the masked backward kernels) at the unmasked kernels'
    dtypes and head dims; CPU tensors run the plain versions."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    device = _device_of(q)
    mask = masked_view(mask, q.shape[0], q.shape[2], q.shape[1], k.shape[1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttentionMasked.apply(q, k, v, mask, float(scale))
    if device == "cpu":
        return attention_masked_reference(q, k, v, mask, scale)
    o, _ = _launch_masked("fwd", q, k, v, mask, scale)
    _count(flash_attention_masked, k)
    return o


_KERNELS = {
    "flash_attention_fwd": flash_attention,
    "flash_attention_fwd_lse": flash_attention_lse,
    "flash_attention_bwd_dq": flash_attention_bwd_dq,
    "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
    "flash_attention_split_f32": flash_attention_split_f32,
    "flash_attention_masked_fwd": flash_attention_masked,
    "flash_attention_masked_fwd_lse": flash_attention_masked_lse,
    "flash_attention_masked_bwd_dq": flash_attention_masked_bwd_dq,
    "flash_attention_masked_bwd_dkv": flash_attention_masked_bwd_dkv,
}


def _count(fn, k: torch.Tensor) -> None:
    """One launch of ``fn``'s kernel over keys ``k`` (B, Tk, H, D)."""
    fn.launches += 1
    fn.launches_by_shape[(k.shape[1], k.shape[3])] += 1


def reset_launch_counts() -> None:
    """Set every kernel's launch counts to 0."""
    for fn in _KERNELS.values():
        fn.launches = 0
        fn.launches_by_shape = Counter()


reset_launch_counts()


def launch_counts() -> dict:
    """Launches of each kernel since the last reset, by kernel."""
    return {name: fn.launches for name, fn in _KERNELS.items()}


def launch_lengths() -> dict:
    """Launches of the lse-free forward since the last reset, by key length Tk."""
    by_length = Counter()
    for (tk, _), n in flash_attention.launches_by_shape.items():
        by_length[tk] += n
    return dict(sorted(by_length.items()))


def launch_shapes() -> dict:
    """Launches of each kernel since the last reset, by (key length Tk, head dim D)."""
    return {name: dict(sorted(fn.launches_by_shape.items())) for name, fn in _KERNELS.items()}


def attention_flops(b: int, tq: int, tk: int, h: int, d: int) -> int:
    """Multiply-adds of QKᵀ and PV, counted as 2 flop each: 4·B·H·Tq·Tk·D."""
    return 4 * b * h * tq * tk * d


def attention_bytes(b: int, tq: int, tk: int, h: int, d: int, itemsize: int) -> int:
    """Bytes that must move: q, k, v read once and o written once."""
    return (2 * b * tq * h * d + 2 * b * tk * h * d) * itemsize


def attention_bwd_flops(b: int, tq: int, tk: int, h: int, d: int) -> int:
    """The backward's necessary work, five Tq·Tk·D products: 10·B·H·Tq·Tk·D."""
    return 10 * b * h * tq * tk * d


def attention_bwd_bytes(b: int, tq: int, tk: int, h: int, d: int, itemsize: int) -> int:
    """Bytes that must move: q, k, v, o, dO and the fp32 lse read; dq, dk, dv written."""
    return 4 * b * h * d * (tq + tk) * itemsize + 4 * b * h * tq
