"""Convert a raw dataset to WAI, compute covisibility, aggregate the metadata.

    python3 -m mapanything_tpu_torch.tools.convert_wai --dataset blendedmvs \\
        --raw-root /data/raw/blendedmvs --out-root /data/wai/blendedmvs \\
        --metadata-dir /data/wai_metadata/blendedmvs --covisibility --aggregate [--device cuda]

The port of ``scripts/convert_wai.py``. Stages (each skippable):
  1. conversion: raw -> WAI scenes (images / EXR depth / scene_meta.json)
     through ``data_processing.conversion``;
  2. covisibility: the pairwise reprojection of each scene with depth
     (``data_processing.covisibility``), on ``--device`` (CUDA unless it names
     another);
  3. aggregate: split scene lists (+ adjacency) for the train datasets.
Each stage's seconds are printed after it (``run`` returns them).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Dict

import numpy as np

from mapanything_tpu_torch.data import wai as wai_io
from mapanything_tpu_torch.data_processing.aggregate import aggregate_dataset_metadata
from mapanything_tpu_torch.data_processing.conversion import ADAPTERS, convert_scenes, get_adapter
from mapanything_tpu_torch.data_processing.covisibility import compute_pairwise_covisibility, write_covisibility


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", required=True, help="adapter name")
    ap.add_argument("--raw-root", required=True)
    ap.add_argument("--out-root", required=True)
    ap.add_argument("--metadata-dir", default=None)
    ap.add_argument("--scenes", nargs="*", default=None)
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--copy", action="store_true", help="copy instead of symlink")
    ap.add_argument("--covisibility", action="store_true")
    ap.add_argument("--aggregate", action="store_true")
    ap.add_argument("--adjacency", action="store_true")
    ap.add_argument("--covis-threshold", type=float, default=0.25)
    ap.add_argument("--list-datasets", action="store_true")
    ap.add_argument("--device", default="cuda", help="where the covisibility runs")
    return ap.parse_args(argv)


def scene_covisibility(scene_root: Path, device) -> np.ndarray:
    """The (V, V) covisibility of one WAI scene from its depth, intrinsics and poses."""
    meta = wai_io.load_scene_meta(scene_root)
    depths, Ks, poses = [], [], []
    for fr in meta["frames"]:
        data = wai_io.load_frame(scene_root, fr["frame_name"], ["depth", "intrinsics", "pose"], meta=meta)
        depths.append(data["depth"])
        Ks.append(data["intrinsics"])
        poses.append(data["pose"])
    return compute_pairwise_covisibility(np.stack(depths), np.stack(Ks), np.stack(poses), device=device)


def run(args: argparse.Namespace) -> Dict:
    """The stages the flags ask for: the converted scenes and each stage's seconds."""
    seconds = {}
    t0 = time.perf_counter()
    adapter = get_adapter(args.dataset)
    done = convert_scenes(adapter, args.raw_root, args.out_root, scenes=args.scenes, overwrite=args.overwrite,
                          link_files=not args.copy)
    seconds["conversion"] = time.perf_counter() - t0
    print(f"converted {len(done)} scenes of {args.dataset} ({seconds['conversion']:.3f} s)")

    if args.covisibility:
        t0 = time.perf_counter()
        for scene in done:
            scene_root = Path(args.out_root) / scene
            frames = wai_io.load_scene_meta(scene_root)["frames"]
            if not any("depth" in fr for fr in frames):
                continue
            write_covisibility(scene_root, scene_covisibility(scene_root, args.device))
            print(f"covisibility: {scene} ({len(frames)} frames)")
        seconds["covisibility"] = time.perf_counter() - t0
        print(f"covisibility: {seconds['covisibility']:.3f} s")

    if args.aggregate:
        if not args.metadata_dir:
            raise SystemExit("--metadata-dir required with --aggregate")
        t0 = time.perf_counter()
        splits = aggregate_dataset_metadata(args.dataset, args.out_root, args.metadata_dir,
                                            threshold=args.covis_threshold, with_adjacency=args.adjacency)
        seconds["aggregate"] = time.perf_counter() - t0
        for split, names in splits.items():
            print(f"{split}: {len(names)} scenes")
        print(f"aggregate: {seconds['aggregate']:.3f} s")
    return {"scenes": done, "seconds": seconds}


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.list_datasets:
        print("\n".join(sorted(ADAPTERS)))
        return 0
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
