"""Single-view calibration benchmark: ray-direction angular error (degrees) by scene.

    python3 -m mapanything_tpu_torch.tools.benchmark_calibration --dataset-expr "<DSL>"
        [--checkpoint <hub dir | .pth | .pt>] [--trusted-checkpoint] [--batch-size 8] [--max-batches N]
        [--small] [--num-workers 4] [--out outputs/calibration_results.json] [--device cuda]

The port of ``scripts/benchmark_calibration.py``: evaluate the dataset expression,
e.g. "ETH3DWAI(ROOT=..., dataset_metadata_dir=..., split='test', num_views=1,
resolution=(518, 336))", build the bf16 MapAnything (seeded random weights, or
``--checkpoint``), run ``benchmarking.calibration.run_benchmark`` on each sample's
first view and write the per-scene and overall errors to ``--out``. Runs on the
card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse

from mapanything_tpu_torch.benchmarking.calibration import run_benchmark
from mapanything_tpu_torch.tools.benchmark_dense_n_view import (
    add_common_args,
    build_loader,
    build_model,
    write_results,
)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap, batch_size=8, out="outputs/calibration_results.json")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the benchmark of ``argv``; returns the per-scene and overall errors."""
    args = parse_args(argv)
    loader = build_loader(args)
    results = run_benchmark(build_model(args), loader, max_batches=args.max_batches)
    out = write_results(results, args.out)
    print(f"overall ray angular error: {results['overall']:.3f} deg")
    print(f"wrote {out}")
    return results


if __name__ == "__main__":
    main()
