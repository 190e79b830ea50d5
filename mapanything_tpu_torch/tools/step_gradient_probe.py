"""Whether the attention kernels cause a cuda-against-cpu gradient gap of the small train step.

    python3 -m mapanything_tpu_torch.tools.step_gradient_probe [--trunk-heads N] [--perturb SCALE]

Runs the loss and backward of ``chip_smoke.py`` phase 6 (phase 14 with
``--trunk-heads 2``: MapAnythingConfig.small, 1 x 2 views at 56 px, every
geometric input, seeded weights and masks, fp32, TF32 off) three times: on
cuda with the attention kernels, on cuda with their plain PyTorch versions in
their place, and on cpu. Prints one JSON line: for each pair, the worst
gradient difference over its leaf's largest magnitude, and which leaf. The
kernels are the cause only where "kernels_vs_plain_cuda" is of the size of
"kernels_vs_cpu".

With ``--perturb SCALE`` it also runs the step on cpu with every weight moved by
SCALE·N(0, 1) (seeded) and prints, beside each other for the leaves of DPT hook
0 (``dpt_feature_head.input_process.0.``), each leaf's card gap (kernels against
cpu) and its gap under that perturbation on the cpu, and the rank correlation of
the two over every leaf. If the card's gap comes from the ReLU kinks of the heads
(a forward difference of an ulp switching a unit on or off), the leaves that move
most under a tiny perturbation are the leaves the card moves most.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

from mapanything_tpu_torch.models.mapanything import (
    GeometricInputConfig, MapAnything, MapAnythingConfig, sample_modality_masks,
)
from mapanything_tpu_torch.ops import attention
from mapanything_tpu_torch.train.losses import synthetic_loss_batch
from mapanything_tpu_torch.train.step import make_loss_fn


def gradients(cfg, device: str, plain: bool, perturb: float = 0.0) -> dict:
    """Every parameter's gradient of phase 6's loss, in fp64 on the cpu; with
    ``perturb``, each weight first moved by perturb·N(0, 1) from a seeded generator."""
    B, V, HW = 1, 2, 56
    img = torch.from_numpy(np.random.RandomState(0).randn(B, V, HW, HW, 3).astype(np.float32))
    batch = synthetic_loss_batch(B, V, HW, HW, seed=1)
    geo = GeometricInputConfig(ray_dirs_prob=1.0, depth_prob=1.0, cam_prob=1.0, sparse_depth_prob=1.0)
    masks = sample_modality_masks(torch.Generator().manual_seed(0), B, V, (HW, HW), geo)
    with attention.plain_attention() if plain else contextlib.nullcontext():
        model = MapAnything(cfg, device=device, seed=0, geometric_inputs=True)
        if perturb:
            gen = torch.Generator().manual_seed(1)
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(perturb * torch.randn(p.shape, generator=gen).to(p.device))
        loss, _ = make_loss_fn(model)(batch.to(device), img.to(device), masks)
        loss.backward()
    return {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()}


def leaf_gaps(a: dict, b: dict) -> dict:
    """Each leaf's max |a - b| over max |b|."""
    return {n: ((a[n] - b[n]).abs().max() / max(b[n].abs().max().item(), 1e-12)).item() for n in b}


def worst(a: dict, b: dict):
    """The leaf with the largest max |a - b| over max |b|, and that ratio."""
    errs = leaf_gaps(a, b)
    name = max(errs, key=errs.get)
    return [name, errs[name]]


def rank_correlation(x: list, y: list) -> float:
    """Spearman's rank correlation (no ties expected among float gaps)."""
    rx, ry = np.argsort(np.argsort(x)), np.argsort(np.argsort(y))
    return float(np.corrcoef(rx, ry)[0, 1])


HOOK0 = "dpt_feature_head.input_process.0."


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trunk-heads", type=int, default=None, help="info_sharing_num_heads of the small model")
    parser.add_argument("--perturb", type=float, default=0.0,
                        help="also the cpu step with every weight moved by this times N(0, 1), beside the card's gap")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("step_gradient_probe: no CUDA device", file=sys.stderr)
        return 1
    cfg = MapAnythingConfig.small(**({} if args.trunk_heads is None else {"info_sharing_num_heads": args.trunk_heads}))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    kernels, plain, cpu = gradients(cfg, "cuda", False), gradients(cfg, "cuda", True), gradients(cfg, "cpu", False)
    line = {
        "config": f"small(info_sharing_num_heads={cfg.info_sharing_num_heads}) fp32 1x2x56x56, all geometric inputs",
        "card": torch.cuda.get_device_name(0),
        "kernels_vs_cpu": worst(kernels, cpu),
        "plain_cuda_vs_cpu": worst(plain, cpu),
        "kernels_vs_plain_cuda": worst(kernels, plain),
    }
    if args.perturb:
        card_gap = leaf_gaps(kernels, cpu)
        moved_gap = leaf_gaps(gradients(cfg, "cpu", False, args.perturb), cpu)
        names = sorted(n for n in card_gap if card_gap[n] > 0 or moved_gap[n] > 0)
        line.update({
            "perturb": args.perturb,
            "hook0_leaves": {n: {"card_vs_cpu": card_gap[n], "cpu_perturbed_vs_cpu": moved_gap[n]}
                             for n in sorted(card_gap) if n.startswith(HOOK0)},
            "worst_perturbed_leaf": max(moved_gap.items(), key=lambda kv: kv[1]),
            "rank_correlation_over_leaves": rank_correlation([card_gap[n] for n in names],
                                                             [moved_gap[n] for n in names]),
            "leaves": len(names),
        })
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
