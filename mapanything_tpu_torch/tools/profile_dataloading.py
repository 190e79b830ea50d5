"""Data-loading throughput: images a second and the loader's latency a batch.

    python3 -m mapanything_tpu_torch.tools.profile_dataloading --dataset-expr "<DSL>"
        [--images-per-batch 8] [--num-workers 8] [--max-batches 50]

The port of ``scripts/profile_dataloading.py``, a host tool: the dataset
expression (``tools.train.build_dataset``) through the training loader
(``data.loader.MultiViewDataLoader``), no model and no device. A ``BlockTimer``
times each wait for the next batch.
"""

from __future__ import annotations

import argparse
import time

from mapanything_tpu_torch.data.loader import MultiViewDataLoader
from mapanything_tpu_torch.tools.train import build_dataset
from mapanything_tpu_torch.utils.timing import BlockTimer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset-expr", required=True)
    ap.add_argument("--images-per-batch", type=int, default=8)
    ap.add_argument("--num-workers", type=int, default=8)
    ap.add_argument("--max-batches", type=int, default=50)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Load up to ``--max-batches`` batches; returns the images, seconds, images a
    second and the mean ms a batch."""
    args = parse_args(argv)
    loader = MultiViewDataLoader(build_dataset(args.dataset_expr), images_per_batch=args.images_per_batch,
                                 num_workers=args.num_workers)
    loader.set_epoch(0)
    timer = BlockTimer("batch")
    n_images = 0
    t_start = time.perf_counter()
    batches = iter(loader)
    for _ in range(args.max_batches):
        with timer:
            batch = next(batches, None)
        if batch is None:
            break
        b, v = batch["img"].shape[:2]
        n_images += b * v
    elapsed = time.perf_counter() - t_start
    print(f"{n_images} images in {elapsed:.2f}s = {n_images / elapsed:.1f} images/s; "
          f"avg batch latency {timer.global_avg * 1e3:.1f} ms")
    return {"images": n_images, "seconds": elapsed, "images_per_s": n_images / elapsed,
            "ms_per_batch": timer.global_avg * 1e3}


if __name__ == "__main__":
    main()
