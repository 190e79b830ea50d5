"""RobustMVD-style MVS depth benchmark: keyframe z-depth Absrel and inlier@1.03.

    python3 -m mapanything_tpu_torch.tools.benchmark_rmvd --dataset-expr "<DSL>"
        [--checkpoint <hub dir | .pth | .pt>] [--trusted-checkpoint] [--batch-size 2] [--max-batches N]
        [--small] [--num-workers 4] [--out outputs/rmvd_results.json] [--device cuda]

The port of ``scripts/benchmark_rmvd.py``: evaluate the dataset expression, e.g.
"ETH3DWAI(ROOT=..., dataset_metadata_dir=..., split='test', num_views=4,
resolution=(518, 336))", build the bf16 MapAnything (seeded random weights, or
``--checkpoint``), run ``benchmarking.rmvd_mvs.run_benchmark`` (view 0's
z-depth, median-scale aligned) and write the results to ``--out``. Runs on the
card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import json

from mapanything_tpu_torch.benchmarking.rmvd_mvs import run_benchmark
from mapanything_tpu_torch.tools.benchmark_dense_n_view import (
    add_common_args,
    build_loader,
    build_model,
    write_results,
)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap, batch_size=2, out="outputs/rmvd_results.json")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the benchmark of ``argv``; returns the mean Absrel, inlier ratio and sample count."""
    args = parse_args(argv)
    loader = build_loader(args)
    results = run_benchmark(build_model(args), loader, max_batches=args.max_batches)
    out = write_results(results, args.out)
    print(json.dumps(results, indent=2))
    print(f"wrote {out}")
    return results


if __name__ == "__main__":
    main()
