"""Dense up-to-N-view benchmark: per-scene and overall metrics as JSON.

    python3 -m mapanything_tpu_torch.tools.benchmark_dense_n_view --dataset-expr "<DSL>"
        [--checkpoint <hub dir | .pth | .pt>] [--trusted-checkpoint] [--batch-size 2] [--max-batches N]
        [--small] [--model mapanything] [--task images_only] [--num-workers 4]
        [--out outputs/dense_n_view_results.json] [--device cuda]

The port of ``scripts/benchmark_dense_n_view.py``: evaluate the dataset expression
(``tools.train.build_dataset``), e.g.

    "ETH3DWAI(ROOT=..., dataset_metadata_dir=..., split='test', num_views=8,
              resolution=(518, 336), covisibility_thres=0.025, seed=0)"

build the fixed-batch test loader, read which ground-truth modalities feed the
model from the task preset (``configs/model/task/<task>.yaml``: ray directions,
depth, poses where their probability is above 0), build the model in bf16
(``--model``: a registry name, ``models.registry.init_model``, seeded random
weights; ``--checkpoint``: the MapAnything of a hub directory or reference
checkpoint through ``tools.load_model``, or a reference checkpoint loaded into the
registry model), run ``benchmarking.dense_n_view.run_benchmark`` and write the
per-scene and overall metrics to ``--out``. Runs on the card unless ``--device``
names another. The calibration and RMVD tools share this one's model and loader
helpers.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

from mapanything_tpu_torch.benchmarking.dense_n_view import run_benchmark
from mapanything_tpu_torch.data.loader import get_test_data_loader
from mapanything_tpu_torch.models.mapanything import MapAnythingConfig, resolve_device
from mapanything_tpu_torch.models.registry import init_model
from mapanything_tpu_torch.tools.load_model import load_model
from mapanything_tpu_torch.tools.train import build_dataset
from mapanything_tpu_torch.utils.checkpoint import load_reference_checkpoint
from mapanything_tpu_torch.utils.config import load_config

TASKS = Path(__file__).resolve().parents[2] / "configs" / "model" / "task"


def add_common_args(ap: argparse.ArgumentParser, batch_size: int, out: str) -> None:
    """The flags every benchmark tool takes."""
    ap.add_argument("--dataset-expr", required=True, help="dataset DSL string")
    ap.add_argument("--checkpoint", default=None, help="hub directory, or a .pth/.pt reference checkpoint")
    ap.add_argument("--trusted-checkpoint", action="store_true",
                    help="unpickle a checkpoint that holds more than tensors (can run code: trusted files only)")
    ap.add_argument("--batch-size", type=int, default=batch_size)
    ap.add_argument("--max-batches", type=int, default=None)
    ap.add_argument("--small", action="store_true", help="the small config (MapAnythingConfig.small())")
    ap.add_argument("--num-workers", type=int, default=4, help="loader worker processes (0: in this process)")
    ap.add_argument("--out", default=out)
    ap.add_argument("--device", default="cuda")


def small_overrides() -> dict:
    """The fields in which MapAnythingConfig.small() differs from the flagship config."""
    small, full = MapAnythingConfig.small(), MapAnythingConfig()
    return {f.name: getattr(small, f.name) for f in dataclasses.fields(MapAnythingConfig)
            if getattr(small, f.name) != getattr(full, f.name)}


def build_model(args: argparse.Namespace, model_name: str = "mapanything", geometric_inputs: bool = False):
    """The bf16 model the flags ask for, on ``args.device`` (CUDA unless it names another)."""
    device = resolve_device(args.device)
    if model_name == "mapanything" and args.checkpoint:
        return load_model(args.checkpoint, args.small, device, trusted=args.trusted_checkpoint,
                          compute_dtype="bfloat16")[0]
    model = init_model(model_name, device=device, geometric_inputs=geometric_inputs, compute_dtype="bfloat16",
                       **(small_overrides() if args.small else {}))
    if args.checkpoint:
        load_reference_checkpoint(model, args.checkpoint, trusted=args.trusted_checkpoint)
    return model


def build_loader(args: argparse.Namespace):
    resolve_device(args.device)  # refuse before reading any data
    loader = get_test_data_loader(build_dataset(args.dataset_expr), args.batch_size, num_workers=args.num_workers)
    loader.set_epoch(0)
    return loader


def write_results(results: dict, out) -> Path:
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2))
    return out


def task_inputs(task: str) -> dict:
    """Which ground-truth modalities the task preset feeds the model."""
    cfg = load_config(str(TASKS / f"{task}.yaml"))
    return {"keep_rays": float(cfg.get("ray_dirs_prob", 0)) > 0, "keep_depth": float(cfg.get("depth_prob", 0)) > 0,
            "keep_cam": float(cfg.get("cam_prob", 0)) > 0}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap, batch_size=2, out="outputs/dense_n_view_results.json")
    ap.add_argument("--model", default="mapanything", help="registry name (mapanything / mapanything_ablations)")
    ap.add_argument("--task", default="images_only",
                    help="configs/model/task preset deciding which ground-truth modalities feed the model")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the benchmark of ``argv``; returns the per-scene and overall metrics."""
    args = parse_args(argv)
    keep = task_inputs(args.task)
    loader = build_loader(args)
    model = build_model(args, args.model, geometric_inputs=any(keep.values()))
    results = run_benchmark(model, loader, max_batches=args.max_batches, **keep)
    out = write_results(results, args.out)
    print(json.dumps(results["overall"], indent=2))
    print(f"wrote {out}")
    return results


if __name__ == "__main__":
    main()
