"""Time the port's attention kernels at the main path's shapes, for an A/B between commits.

    python3 mapanything_tpu_torch/tools/time_kernels.py [--root DIR] [--head-dims 64 128]

Imports ``mapanything_tpu_torch`` from ``--root`` (default: the checkout this
file is in), builds its kernels there and times each kernel with CUDA events:
the lse-free forward at the flagship forward's encoder, frame and global
shapes in bf16 and fp32 (``chip_smoke.py`` phases 3 and 18; in fp32 the whole
call, its split pass included); the lse forward, dq,
dk/dv and the whole ``flash_attention_bwd_lse`` (delta, dq and dk/dv; in fp32
its split pass too, and the split pass alone as ``split/<shape>``), with torch
SDPA's backward beside them, at the 1 x 4 x 518 train step's shapes in bf16
(phase 7) and fp32 (phase 17) (chip_smoke.py phase 3b); the same backward rows at the ring's
block, 1 x 5476 x 12 x 64 fed a merged lse (phase 3c); the long bf16 forwards
of phases 3c and 3d (K3's lse-free 1 x 21905 and
1 x 87617, K7's lse 1 x 21904, all x 12 x 64); with 128 in ``--head-dims``,
the same at flagship-h128's trunk shapes (phase 3e). To time another commit,
unpack it with ``git archive`` into a directory that .gitignore lists and pass
that as ``--root`` (this file need not exist there). Compare two commits only within one call on one card, in
turns: parent, change, change, parent. Prints one JSON line: the card, the
root and ms per call of each kernel at each shape (``host_us/bwd/...``: the
host's microseconds to enqueue one whole backward, in bf16). With ``--errors``,
also, at each fp32 training shape, the lse forward's o and lse and the
backward's dq, dk and dv (from the kernel's o and lse): each one's max |error|
against the same formulas in fp64 on the same inputs, beside the fp32 plain
version's and 1e-5 of the reference's magnitude (``chip_smoke.py``'s fp32 rule).

With ``--narrow``, only the fp32 forward at the narrow head dims (D = 48 and 32) at
``NARROW_SHAPES`` (chip_smoke.py phase 3's tracker, MAE decoder and D = 32 long rows),
each two ways: the device time of a call (``device_ms``: 20 calls replayed as one CUDA
graph) and the call's host-paced CUDA-event time (``ms``); torch SDPA on the same inputs
beside them. Rows under ~0.1 ms read the host in ``ms``, not in the device time.

With ``--narrow-bwd``, only the fp32 backward at D = 32 at ``NARROW_BWD_SHAPES`` (the MAE
decoder's train step, chip_smoke.py phases 3b and 23): the dq and dk/dv kernels alone on
one split pass's parts, the split pass, the whole ``flash_attention_bwd_lse`` (delta, the
split pass, dq and dk/dv) and torch SDPA's backward, each as ``device_ms`` and host-paced
``ms``; with ``--errors`` also each output's error against fp64, as above.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

# name -> (B, T, H, D, dtype): forward (phase 3) and training (phase 3b) shapes by head dim.
FORWARD_SHAPES = {
    64: {"encoder": (8, 1370, 16, 64, "bfloat16"), "frame": (8, 1369, 12, 64, "bfloat16"),
         "global": (1, 10953, 12, 64, "bfloat16"), "fp32_encoder": (8, 1370, 16, 64, "float32"),
         "fp32_frame": (8, 1369, 12, 64, "float32"), "fp32_global": (1, 10953, 12, 64, "float32")},
    128: {"frame_h128": (8, 1369, 6, 128, "bfloat16"), "global_h128": (1, 10953, 6, 128, "bfloat16"),
          "fp32_global_h128": (1, 5477, 6, 128, "float32")},
}
# name -> (B, T, H, D, with lse): the long bf16 forwards (phases 3c and 3d), D = 64 only.
LONG_SHAPES = {
    "k3_global_16_views": (1, 21905, 12, 64, False),
    "k3_global_64_views": (1, 87617, 12, 64, False),
    "k7_ring_16_views": (1, 21904, 12, 64, True),
}
# name -> (B, Tq, Tk, H, D, with lse, layout): the fp32 forward at the narrow head dims.
# "three": q, k and v three tensors (the tracker's in-projection); "fused": views of one
# fused qkv tensor (the MAE decoder's Attention).
NARROW_SHAPES = {
    "tracker_time": (576, 8, 8, 8, 48, False, "three"),
    "tracker_virtual2point": (8, 64, 512, 8, 48, False, "three"),
    "tracker_virtual": (8, 64, 64, 8, 48, False, "three"),
    "tracker_point2virtual": (8, 512, 64, 8, 48, False, "three"),
    "tracker_fine_time": (512, 8, 8, 8, 32, False, "three"),
    "mae_decoder": (8, 1369, 1369, 16, 32, False, "fused"),
    "mae_decoder_lse": (4, 1369, 1369, 16, 32, True, "fused"),
    "fp32_d32_129x4000": (2, 129, 4000, 3, 32, False, "three"),
}
# name -> (B, T, H, D): the fp32 backward at D = 32, on views of one fused qkv tensor.
NARROW_BWD_SHAPES = {"mae_decoder": (4, 1369, 16, 32)}
TRAIN_SHAPES = {
    64: {"encoder": (4, 1370, 16, 64, "bfloat16"), "frame": (4, 1369, 12, 64, "bfloat16"),
         "global": (1, 5477, 12, 64, "bfloat16"), "fp32_encoder": (4, 1370, 16, 64, "float32"),
         "fp32_frame": (4, 1369, 12, 64, "float32"), "fp32_global": (1, 5477, 12, 64, "float32")},
    128: {"frame_h128": (4, 1369, 6, 128, "bfloat16"), "global_h128": (1, 5477, 6, 128, "bfloat16"),
          "fp32_global_h128": (1, 5477, 6, 128, "float32")},
}


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """The card's time a call of ``fn`` takes, apart from the host's: ``iters`` calls
    captured into one CUDA graph, replayed once between CUDA events (no host work between
    the kernels). A host-paced loop of calls times the host wherever a call's enqueue
    outlasts its kernels. (Not torch.profiler: after a profiler session the process's
    later launches took up to 2x the host time.)"""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def narrow_inputs(b, tq, tk, h, d, layout, gen):
    """q, k and v of a ``NARROW_SHAPES`` row in fp32: three tensors, or views of a fused
    qkv tensor."""
    import torch

    if layout == "fused":
        return torch.randn(b, tq, 3, h, d, device="cuda", generator=gen).unbind(2)
    return tuple(torch.randn(b, t, h, d, device="cuda", generator=gen) for t in (tq, tk, tk))


def narrow_times(fa, gen) -> dict:
    """``--narrow``: each ``NARROW_SHAPES`` row's device time (``device_ms``) and host-paced
    call time, and torch SDPA's, at the same inputs."""
    import torch.nn.functional as F

    rows = {}
    for name, (b, tq, tk, h, d, with_lse, layout) in NARROW_SHAPES.items():
        q, k, v = narrow_inputs(b, tq, tk, h, d, layout, gen)
        scale = d**-0.5
        call = (lambda: fa.flash_attention_lse(q, k, v, scale)) if with_lse else (
            lambda: fa.flash_attention(q, k, v, scale))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale)  # noqa: E731
        rows[name] = {"b_tq_tk_h_d": [b, tq, tk, h, d], "lse": with_lse, "device_ms": device_ms(call),
                      "ms": cuda_time_ms(call, 30), "host_us": host_us(call),
                      "sdpa_device_ms": device_ms(sdpa), "sdpa_ms": cuda_time_ms(sdpa, 30)}
    return rows


def narrow_bwd_times(fa, gen, errors: bool) -> dict:
    """``--narrow-bwd``: each ``NARROW_BWD_SHAPES`` row's dq, dk/dv (alone on one split
    pass's parts), split pass, whole backward and SDPA backward, device and host-paced."""
    import torch

    rows = {}
    for name, (b, t, h, d) in NARROW_BWD_SHAPES.items():
        q, k, v = torch.randn(b, t, 3, h, d, device="cuda", generator=gen).unbind(2)
        do = torch.randn(b, t, h, d, device="cuda", generator=gen)
        scale = d**-0.5
        o, lse = fa.flash_attention_lse(q, k, v, scale)
        delta = fa.attention_bwd_delta(o, do).contiguous()
        parts = fa.flash_attention_split_f32(q, k, v, do)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, scale=scale)
        calls = {
            "dq": lambda: fa._launch_bwd("dq", q, k, v, do, lse, delta, scale, (dq,), parts),
            "dkv": lambda: fa._launch_bwd("dkv", q, k, v, do, lse, delta, scale, (dk, dv), parts),
            "split": lambda: fa.flash_attention_split_f32(q, k, v, do),
            "bwd": lambda: fa.flash_attention_bwd_lse(q, k, v, o, lse, do, scale),
            "sdpa_bwd": lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True),
        }
        row = {"b_t_h_d": [b, t, h, d]}
        for key, call in calls.items():
            try:
                row[f"{key}_device_ms"] = device_ms(call)
            except RuntimeError:  # a capture the graph refuses: not measured
                row[f"{key}_device_ms"] = None
            row[f"{key}_ms"] = cuda_time_ms(call, 30)
        row["bwd_host_us"] = host_us(calls["bwd"])
        if errors:
            row["fp32_errors"] = fp32_errors(fa, q, k, v, o, lse, do, scale)
        rows[name] = row
        del sdpa_out, parts
        torch.cuda.empty_cache()
    return rows


def host_us(fn, iters: int = 30) -> float:
    """Host microseconds a call takes to enqueue its work (no synchronisation inside the
    loop): where it reaches a kernel's ms, the CUDA-event time reads the host, not the card."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return elapsed / iters * 1e6


def sdpa_bwd_ms(q, k, v, do, scale, iters: int) -> float:
    """torch SDPA's backward alone (its forward run once, with autograd on)."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
    return cuda_time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), iters)


def ring_block_times(fa, gen) -> dict:
    """dq, dk/dv, the whole backward and SDPA's backward at the ring's block of the train
    step, 1 x 5476 x 12 x 64, fed the lse of its forward merged with a 1-token block
    (the scale token), as the ring's backward feeds them (chip_smoke.py phase 3c)."""
    import torch

    from mapanything_tpu_torch.parallel.sharded_attention import _block_attn_lse, _merge_lse

    b, t, h, d = 1, 5476, 12, 64
    scale = d**-0.5
    q, k, v = torch.randn(b, t, 3, h, d, device="cuda", generator=gen).bfloat16().unbind(2)
    ke, ve = torch.randn(2, b, 1, h, d, device="cuda", generator=gen).bfloat16()
    do = torch.randn(b, t, h, d, device="cuda", generator=gen).bfloat16()
    o_g, lse_g = fa.flash_attention_lse(q, k, v, scale)
    o, lse = _merge_lse([(o_g.float(), lse_g), _block_attn_lse(q, ke, ve, scale)])
    o, lse = o.bfloat16(), lse.contiguous()
    delta = fa.attention_bwd_delta(o, do).contiguous()
    return {
        "dq/ring_block": cuda_time_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale), 30),
        "dkv/ring_block": cuda_time_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale), 30),
        "bwd/ring_block": cuda_time_ms(lambda: fa.flash_attention_bwd_lse(q, k, v, o, lse, do, scale), 30),
        "sdpa_bwd/ring_block": sdpa_bwd_ms(q, k, v, do, scale, 30),
    }


def fp32_errors(fa, q, k, v, o, lse, do, scale) -> dict:
    """{output: [the kernel's max |error| against fp64, the fp32 plain version's,
    1e-5 max |fp64|]} for the lse forward's o and lse (``o``, ``lse``) and the
    backward's dq, dk and dv (from the kernel's o and lse)."""
    names = ("o", "lse", "dq", "dk", "dv")
    got = (o, lse, *fa.flash_attention_bwd_lse(q, k, v, o, lse, do, scale))
    x64 = [x.double() for x in (q, k, v)]
    exact = (*fa.attention_lse_reference(*x64, scale),
             *fa.attention_bwd_reference(*x64, o.double(), lse.double(), do.double(), scale))
    plain = (*fa.attention_lse_reference(q, k, v, scale), *fa.attention_bwd_reference(q, k, v, o, lse, do, scale))
    return {name: [(g.double() - e).abs().max().item(), (p.double() - e).abs().max().item(),
                   1e-5 * e.abs().max().item()] for name, g, e, p in zip(names, got, exact, plain)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2],
                        help="the checkout whose mapanything_tpu_torch is timed")
    parser.add_argument("--head-dims", type=int, nargs="+", default=[64], choices=sorted(FORWARD_SHAPES))
    parser.add_argument("--errors", action="store_true", help="also the fp32 backward's errors against fp64")
    parser.add_argument("--narrow", action="store_true",
                        help="time only the fp32 forward at the narrow head dims (NARROW_SHAPES), device and call")
    parser.add_argument("--narrow-bwd", action="store_true",
                        help="time only the fp32 backward at D = 32 (NARROW_BWD_SHAPES), device and call")
    parser.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"], choices=["bfloat16", "float32"],
                        help="time the shapes of these dtypes only (the long and ring rows are bf16)")
    args = parser.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 1
    from mapanything_tpu_torch.ops import _build
    from mapanything_tpu_torch.ops import flash_attention as fa

    _build.build(*fa.KERNEL_STEMS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.narrow:
        print(json.dumps({"card": torch.cuda.get_device_name(0), "root": str(args.root),
                          "narrow": narrow_times(fa, gen)}), flush=True)
        return 0
    if args.narrow_bwd:
        print(json.dumps({"card": torch.cuda.get_device_name(0), "root": str(args.root),
                          "narrow_bwd": narrow_bwd_times(fa, gen, args.errors)}), flush=True)
        return 0
    times, errors = {}, {}
    for d in args.head_dims:
        for name, (b, t, h, hd, dtype) in FORWARD_SHAPES[d].items():
            if dtype not in args.dtypes:
                continue
            q, k, v = torch.randn(b, t, 3, h, hd, device="cuda", generator=gen).to(getattr(torch, dtype)).unbind(2)
            times[f"fwd/{name}"] = cuda_time_ms(lambda: fa.flash_attention(q, k, v, hd**-0.5), iters=30)
        for name, (b, t, h, hd, dtype) in TRAIN_SHAPES[d].items():
            if dtype not in args.dtypes:
                continue
            dt = getattr(torch, dtype)
            q, k, v = torch.randn(b, t, 3, h, hd, device="cuda", generator=gen).to(dt).unbind(2)
            do = torch.randn(b, t, h, hd, device="cuda", generator=gen).to(dt)
            scale = hd**-0.5
            o, lse = fa.flash_attention_lse(q, k, v, scale)
            delta = fa.attention_bwd_delta(o, do).contiguous()
            iters = 10 if dt == torch.float32 else 30
            times[f"lse/{name}"] = cuda_time_ms(lambda: fa.flash_attention_lse(q, k, v, scale), iters)
            times[f"dq/{name}"] = cuda_time_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale), iters)
            times[f"dkv/{name}"] = cuda_time_ms(
                lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale), iters)
            times[f"bwd/{name}"] = cuda_time_ms(lambda: fa.flash_attention_bwd_lse(q, k, v, o, lse, do, scale), iters)
            times[f"sdpa_bwd/{name}"] = sdpa_bwd_ms(q, k, v, do, scale, iters)
            if dt == torch.bfloat16:
                times[f"host_us/bwd/{name}"] = host_us(lambda: fa.flash_attention_bwd_lse(q, k, v, o, lse, do, scale))
            else:
                if hasattr(fa, "flash_attention_split_f32"):
                    times[f"split/{name}"] = cuda_time_ms(lambda: fa.flash_attention_split_f32(q, k, v, do), iters)
                if args.errors:
                    errors[name] = fp32_errors(fa, q, k, v, o, lse, do, scale)
                    torch.cuda.empty_cache()
        if d == 64 and "bfloat16" in args.dtypes:
            times.update(ring_block_times(fa, gen))
            for name, (b, t, h, hd, with_lse) in LONG_SHAPES.items():
                q, k, v = torch.randn(b, t, 3, h, hd, device="cuda", generator=gen).bfloat16().unbind(2)
                fwd = fa.flash_attention_lse if with_lse else fa.flash_attention
                iters = 3 if t > 50000 else 10
                times[f"{'lse' if with_lse else 'fwd'}/{name}"] = cuda_time_ms(
                    lambda: fwd(q, k, v, hd**-0.5), iters, warmup=1)
    line = {"card": torch.cuda.get_device_name(0), "root": str(args.root), "ms": times}
    if args.errors:
        line["fp32_errors"] = errors
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
