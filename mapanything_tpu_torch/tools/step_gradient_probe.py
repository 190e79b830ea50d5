"""Whether the attention kernels cause a cuda-against-cpu gradient gap of the small train step.

    python3 -m mapanything_tpu_torch.tools.step_gradient_probe [--trunk-heads N]

Runs the loss and backward of ``chip_smoke.py`` phase 6 (phase 14 with
``--trunk-heads 2``: MapAnythingConfig.small, 1 x 2 views at 56 px, every
geometric input, seeded weights and masks, fp32, TF32 off) three times: on
cuda with the attention kernels, on cuda with their plain PyTorch versions in
their place, and on cpu. Prints one JSON line: for each pair, the worst
gradient difference over its leaf's largest magnitude, and which leaf. The
kernels are the cause only where "kernels_vs_plain_cuda" is of the size of
"kernels_vs_cpu".
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from mapanything_tpu_torch.models.mapanything import (
    GeometricInputConfig, MapAnything, MapAnythingConfig, sample_modality_masks,
)
from mapanything_tpu_torch.ops import attention
from mapanything_tpu_torch.ops.flash_attention import attention_reference
from mapanything_tpu_torch.train.losses import synthetic_loss_batch
from mapanything_tpu_torch.train.step import make_loss_fn


def gradients(cfg, device: str, plain: bool) -> dict:
    """Every parameter's gradient of phase 6's loss, in fp64 on the cpu."""
    B, V, HW = 1, 2, 56
    img = torch.from_numpy(np.random.RandomState(0).randn(B, V, HW, HW, 3).astype(np.float32))
    batch = synthetic_loss_batch(B, V, HW, HW, seed=1)
    geo = GeometricInputConfig(ray_dirs_prob=1.0, depth_prob=1.0, cam_prob=1.0, sparse_depth_prob=1.0)
    masks = sample_modality_masks(torch.Generator().manual_seed(0), B, V, (HW, HW), geo)
    kernels = attention.flash_attention
    if plain:  # the plain version, differentiable by autograd, in the kernels' place
        attention.flash_attention = lambda q, k, v, scale=None: attention_reference(q, k, v, scale)
    try:
        model = MapAnything(cfg, device=device, seed=0, geometric_inputs=True)
        loss, _ = make_loss_fn(model)(batch.to(device), img.to(device), masks)
        loss.backward()
    finally:
        attention.flash_attention = kernels
    return {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()}


def worst(a: dict, b: dict):
    """The leaf with the largest max |a - b| over max |b|, and that ratio."""
    errs = {n: ((a[n] - b[n]).abs().max() / max(b[n].abs().max().item(), 1e-12)).item() for n in b}
    name = max(errs, key=errs.get)
    return [name, errs[name]]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trunk-heads", type=int, default=None, help="info_sharing_num_heads of the small model")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("step_gradient_probe: no CUDA device", file=sys.stderr)
        return 1
    cfg = MapAnythingConfig.small(**({} if args.trunk_heads is None else {"info_sharing_num_heads": args.trunk_heads}))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    kernels, plain, cpu = gradients(cfg, "cuda", False), gradients(cfg, "cuda", True), gradients(cfg, "cpu", False)
    print(json.dumps({
        "config": f"small(info_sharing_num_heads={cfg.info_sharing_num_heads}) fp32 1x2x56x56, all geometric inputs",
        "card": torch.cuda.get_device_name(0),
        "kernels_vs_cpu": worst(kernels, cpu),
        "plain_cuda_vs_cpu": worst(plain, cpu),
        "kernels_vs_plain_cuda": worst(kernels, plain),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
