"""Dataloader visual check for WAI datasets: an image grid and a point-cloud viewer a set.

    python3 -m mapanything_tpu_torch.tools.viz_dataset --dataset eth3d --root <wai root>
        --metadata <metadata dir> [--split test] [--out outputs/viz_dataset] [--num-views 4]
        [--num-sets 2] [--resolution 518 392] [--covis-thres 0.25] [--seed 0]

The port of ``scripts/viz_dataset.py``, a host tool: load multi-view sets through
the whole dataset pipeline (covisibility random walk, crop and resize, the views'
ground-truth geometry) and write what the model would see: ``set<i>_views.png``,
the images side by side, and ``set<i>_scene.html``, the valid ground-truth points
of every view with the cameras (``utils.viewer``). ``--dataset`` names a WAI
dataset by its name or its metadata prefix, case and underscores aside (eth3d,
scannetpp or scannetppv2, tartanairv2wb or tav2_wb, ...).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from mapanything_tpu_torch.data.datasets.wai_datasets import ALL_WAI_DATASETS
from mapanything_tpu_torch.utils.viewer import export_viewer_html
from mapanything_tpu_torch.utils.viz import save_views_as_image


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", required=True, help="dataset name or metadata prefix, e.g. eth3d, tav2_wb")
    ap.add_argument("--root", required=True, help="WAI dataset root")
    ap.add_argument("--metadata", required=True, help="scene-list .npy directory")
    ap.add_argument("--split", default=None)
    ap.add_argument("--out", default="outputs/viz_dataset")
    ap.add_argument("--num-views", type=int, default=4)
    ap.add_argument("--num-sets", type=int, default=2)
    ap.add_argument("--resolution", type=int, nargs=2, default=(518, 392))
    ap.add_argument("--covis-thres", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def dataset_class(key: str):
    """The WAI dataset class of ``key``; ``SystemExit`` naming the choices for another."""
    norm = lambda s: s.lower().replace("_", "")  # noqa: E731
    for cls in ALL_WAI_DATASETS.values():
        if norm(key).removesuffix("wai") in (norm(cls.dataset_name), norm(cls.metadata_prefix)):
            return cls
    raise SystemExit(f"unknown dataset '{key}'; available: {sorted(c.metadata_prefix for c in ALL_WAI_DATASETS.values())}")


def main(argv=None) -> list:
    """Write each set's files; returns their paths."""
    args = parse_args(argv)
    cls = dataset_class(args.dataset)
    ds = cls(num_views=args.num_views, split=args.split, covisibility_thres=args.covis_thres,
             resolution=tuple(args.resolution), seed=args.seed, ROOT=args.root, dataset_metadata_dir=args.metadata)
    print(f"{type(ds).__name__}: {len(ds)} sets")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for s in range(args.num_sets):
        views = ds[s]
        save_views_as_image(np.stack([v["img_no_norm"] for v in views]), out / f"set{s}_views.png")
        masks = [np.asarray(v["valid_mask"], bool) for v in views]
        points = np.concatenate([np.asarray(v["pts3d"])[m] for v, m in zip(views, masks)])
        colors = np.concatenate([np.asarray(v["img_no_norm"])[m] for v, m in zip(views, masks)])
        export_viewer_html(out / f"set{s}_scene.html", points, colors, camera_poses=[v["camera_pose"] for v in views],
                           title=f"{type(ds).__name__} set {s}")
        written += [out / f"set{s}_views.png", out / f"set{s}_scene.html"]
        print(f"set {s}: {len(points)} points, {len(views)} views -> set{s}_scene.html")
    return written


if __name__ == "__main__":
    main()
