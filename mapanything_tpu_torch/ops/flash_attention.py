"""Non-causal flash-attention forward over (B, T, H, D) tensors.

The port's counterpart of ``mapanything_tpu/ops/flash_attention.py``
(``flash_attention`` :1304, primal ``_flash`` :1255-1265). On the TPU that
primal reaches three Pallas kernels by sequence length (K1
``_packed_single_kernel``, K2 ``_pair_stream_kernel``, K3
``_fwd_stream_aug``); here one hand-written Hopper kernel,
``csrc/flash_attention_fwd.cu``, serves all of them.

Dispatch is by the device of the inputs, and by nothing else: a CPU tensor
goes to ``attention_reference``, the plain PyTorch version; a CUDA tensor
launches the kernel or raises. ``flash_attention.launches`` counts kernel
launches, so a run can show that its attention went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mapanything_tpu_torch.ops import _build

KERNEL_STEM = "flash_attention_fwd"
HEAD_DIMS = (64,)  # head dims the kernel is instantiated for
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """Plain softmax(q kᵀ scale) v in fp32 (fp64 for fp64 inputs), cast back
    to the input dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf = q.to(acc), k.to(acc), v.to(acc)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    logits = logits - logits.amax(dim=-1, keepdim=True)
    w = torch.exp(logits)
    w = w / w.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", w, vf).to(q.dtype)


def _bind() -> ctypes.CDLL:
    lib = _build.load(KERNEL_STEM)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32] + [i64] * 9 + [
            ctypes.c_float,
            ptr,
        ]
        fn.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention expects (B, T, H, D) tensors")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} has no kernel instance (built: {HEAD_DIMS})")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes bf16 or fp32, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    align = 16 // q.element_size()  # 16-byte vector loads of each row
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name}: the head-dim stride must be 1, got {x.stride()}")
        if x.data_ptr() % 16 or any(s % align for s in x.stride()[:3]):
            raise ValueError(f"{name}: base and strides must be 16-byte aligned, got {x.stride()}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    _check(q, k, v)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    fn = _bind().flash_attention_fwd
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPE_CODES[q.dtype], b, tq, tk, h, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return o


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """softmax(q kᵀ scale) v over q (B, Tq, H, D) and k, v (B, Tk, H, D).

    CUDA tensors run the Hopper kernel (bf16 or fp32, D = 64) and come back
    as a contiguous (B, Tq, H, D) tensor; CPU tensors run the plain version.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        return _launch(q, k, v, scale)
    if q.device.type != "cpu":
        raise RuntimeError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return attention_reference(q, k, v, scale)


flash_attention.launches = 0


def attention_flops(b: int, tq: int, tk: int, h: int, d: int) -> int:
    """Multiply-adds of QKᵀ and PV, counted as 2 flop each: 4·B·H·Tq·Tk·D."""
    return 4 * b * h * tq * tk * d


def attention_bytes(b: int, tq: int, tk: int, h: int, d: int, itemsize: int) -> int:
    """Bytes that must move: q, k, v read once and o written once."""
    return (2 * b * tq * h * d + 2 * b * tk * h * d) * itemsize

