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

With ``--float64`` it also runs the step on cpu in float64 throughout (the
parameters, the inputs, and every cast the port makes to fp32 kept in float64:
``float64_mode``) and prints, ReLU by ReLU of the forward (every ``F.relu`` input,
in call order), the units whose input the card and the fp32 cpu put on two sides
of the kink, with float64's value there: the side float64 takes is the right one.
Beside it, the worst leaf of each fp32 run against float64 (float64 may cross
other kinks than either, so these gaps alone do not tell the sides apart).

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
import torch.nn.functional as F

from mapanything_tpu_torch.models.mapanything import (
    GeometricInputConfig, MapAnything, MapAnythingConfig, sample_modality_masks,
)
from mapanything_tpu_torch.ops import attention
from mapanything_tpu_torch.train.losses import synthetic_loss_batch
from mapanything_tpu_torch.train.step import make_loss_fn


@contextlib.contextmanager
def float64_mode():
    """Inside: ``Tensor.float()`` and ``Tensor.to`` keep a float64 tensor float64 where
    they would round it to fp32, so a model whose parameters and inputs are float64 runs
    in float64 throughout (tensors the code creates in fp32 meet float64 ones and are
    promoted)."""
    to, to_float = torch.Tensor.to, torch.Tensor.float

    def keep_to(self, *args, **kwargs):
        out = to(self, *args, **kwargs)
        return to(self, out.device) if self.dtype == torch.float64 and out.dtype == torch.float32 else out

    torch.Tensor.to = keep_to
    torch.Tensor.float = lambda self, *a, **k: self if self.dtype == torch.float64 else to_float(self, *a, **k)
    try:
        yield
    finally:
        torch.Tensor.to, torch.Tensor.float = to, to_float


@contextlib.contextmanager
def recording_relu(store: list):
    """Inside: every ``F.relu`` appends its input (float64, on the cpu) to ``store``."""
    relu = F.relu

    def recording(x, inplace=False):
        store.append(x.detach().double().cpu())
        return relu(x, inplace=inplace)

    F.relu = recording
    try:
        yield
    finally:
        F.relu = relu


def gradients(cfg, device: str, plain: bool, perturb: float = 0.0, float64: bool = False, relu_store=None) -> dict:
    """Every parameter's gradient of phase 6's loss, in fp64 on the cpu; with
    ``perturb``, each weight first moved by perturb·N(0, 1) from a seeded generator;
    with ``float64`` (cpu only) the step in float64 throughout (``float64_mode``); with
    ``relu_store`` (a list) every ReLU input of the forward recorded there."""
    B, V, HW = 1, 2, 56
    img = torch.from_numpy(np.random.RandomState(0).randn(B, V, HW, HW, 3).astype(np.float32))
    batch = synthetic_loss_batch(B, V, HW, HW, seed=1)
    geo = GeometricInputConfig(ray_dirs_prob=1.0, depth_prob=1.0, cam_prob=1.0, sparse_depth_prob=1.0)
    masks = sample_modality_masks(torch.Generator().manual_seed(0), B, V, (HW, HW), geo)
    if float64:
        img = img.double()
        batch = type(batch)(**{k: v.double() if isinstance(v, torch.Tensor) and v.is_floating_point() else v
                               for k, v in vars(batch).items()})
    with attention.plain_attention() if plain else contextlib.nullcontext(), \
            float64_mode() if float64 else contextlib.nullcontext(), \
            recording_relu(relu_store) if relu_store is not None else contextlib.nullcontext():
        model = MapAnything(cfg, device=device, seed=0, geometric_inputs=True)
        if float64:
            model.double()
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


def relu_kinks(relus: dict, keep: int = 20) -> dict:
    """ReLU by ReLU (the three runs' inputs in call order): the units that the card and
    the fp32 cpu put on two sides of zero, each with float64's input there and the side
    it takes; and how many units float64 puts apart from both."""
    card, cpu, f64 = relus["card"], relus["cpu"], relus["float64"]
    if not len(card) == len(cpu) == len(f64):
        raise RuntimeError(f"the runs made {len(card)}, {len(cpu)} and {len(f64)} ReLU calls")
    flips, f64_alone, units = [], 0, 0
    for call, (a, b, c) in enumerate(zip(card, cpu, f64)):
        pa, pb, pc = a > 0, b > 0, c > 0
        units += a.numel()
        f64_alone += int(((pa == pb) & (pc != pa)).sum())
        for idx in torch.nonzero(pa != pb).tolist():
            i = tuple(idx)
            flips.append({"call": call, "shape": list(a.shape), "index": idx, "card": a[i].item(),
                          "cpu_fp32": b[i].item(), "float64": c[i].item(),
                          "float64_side": "card" if bool(pc[i]) == bool(pa[i]) else "cpu"})
    return {"relu_calls": len(card), "units": units, "card_vs_cpu_flips": len(flips),
            "float64_with_card": sum(f["float64_side"] == "card" for f in flips),
            "float64_with_cpu": sum(f["float64_side"] == "cpu" for f in flips),
            "float64_apart_from_both": f64_alone, "flips": flips[:keep]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trunk-heads", type=int, default=None, help="info_sharing_num_heads of the small model")
    parser.add_argument("--float64", action="store_true",
                        help="also the cpu step in float64 throughout, against which the card and the fp32 cpu are held")
    parser.add_argument("--perturb", type=float, default=0.0,
                        help="also the cpu step with every weight moved by this times N(0, 1), beside the card's gap")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("step_gradient_probe: no CUDA device", file=sys.stderr)
        return 1
    cfg = MapAnythingConfig.small(**({} if args.trunk_heads is None else {"info_sharing_num_heads": args.trunk_heads}))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    relus = {"card": [], "cpu": [], "float64": []}
    kernels = gradients(cfg, "cuda", False, relu_store=relus["card"])
    plain = gradients(cfg, "cuda", True)
    cpu = gradients(cfg, "cpu", False, relu_store=relus["cpu"])
    line = {
        "config": f"small(info_sharing_num_heads={cfg.info_sharing_num_heads}) fp32 1x2x56x56, all geometric inputs",
        "card": torch.cuda.get_device_name(0),
        "kernels_vs_cpu": worst(kernels, cpu),
        "plain_cuda_vs_cpu": worst(plain, cpu),
        "kernels_vs_plain_cuda": worst(kernels, plain),
    }
    if args.float64:
        f64 = gradients(cfg, "cpu", False, float64=True, relu_store=relus["float64"])
        line["float64"] = {"relu_kinks": relu_kinks(relus), "worst_card_vs_float64": worst(kernels, f64),
                           "worst_cpu_fp32_vs_float64": worst(cpu, f64)}
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
