"""Offline WAI processing stages beyond conversion: undistortion,
depth-consistency confidence, pseudo-depth (MoGe / plane-sweep MVS) and
mesh rendering, on the card.

    python3 -m mapanything_tpu_torch.tools.process_wai undistort  --root /data/wai/ase [--device cuda]
    python3 -m mapanything_tpu_torch.tools.process_wai confidence --root /data/wai/eth3d
    python3 -m mapanything_tpu_torch.tools.process_wai moge       --root /data/wai/megadepth [--moge-checkpoint moge.pt]
    python3 -m mapanything_tpu_torch.tools.process_wai mvs        --root /data/wai/dl3dv
    python3 -m mapanything_tpu_torch.tools.process_wai render     --root /data/wai/scannetpp

The port of ``scripts/process_wai.py``, after the reference's per-stage
scripts (``data_processing/wai_processing/scripts/{undistort,
depth_consistency_confidence,run_moge,run_mvsanywhere,run_rendering}.py``).
Scenes are subdirectories of --root holding scene_meta.json; a failure is
printed and the scene skipped. Every stage runs on ``--device`` (CUDA unless
it names another). ``moge`` runs the MoGe-1 release config
(``MoGeConfig()``, ViT-L) with ``--moge-checkpoint``, a state dict in the
release's names read by ``utils/checkpoint.py``; without one, the JAX
script's test-scale ``MoGeConfig.small()`` with seeded weights.
"""

from __future__ import annotations

import argparse
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

from mapanything_tpu_torch.data import wai as wai_io
from mapanything_tpu_torch.data_processing.depth_confidence import (
    compute_depth_consistency_confidence,
    write_depth_confidence,
)
from mapanything_tpu_torch.data_processing.pseudo_depth import run_moge_on_scene, run_mvs_on_scene
from mapanything_tpu_torch.data_processing.rendering import render_scene_frames
from mapanything_tpu_torch.data_processing.undistort import undistort_scene
from mapanything_tpu_torch.models.external.moge import MoGeConfig, MoGeWrapper
from mapanything_tpu_torch.models.mapanything import resolve_device
from mapanything_tpu_torch.utils.checkpoint import load_reference_checkpoint

STAGES = ("undistort", "confidence", "moge", "mvs", "render")


def iter_scenes(root: Path, scenes):
    if scenes:
        return [root / s for s in scenes]
    return sorted(p.parent for p in root.glob("*/scene_meta.json"))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stage", choices=STAGES)
    ap.add_argument("--root", required=True, help="WAI dataset root")
    ap.add_argument("--scenes", nargs="*", help="scene names (default: all)")
    ap.add_argument("--num-planes", type=int, default=64)
    ap.add_argument("--num-neighbors", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--mesh-name", default="mesh")
    ap.add_argument("--modalities", nargs="*", default=None,
                    help="undistort: '*_distorted' keys; render: rendered_* keys")
    ap.add_argument("--moge-checkpoint", help="a MoGe-1 release state dict (.pt/.pth)")
    ap.add_argument("--trusted-checkpoint", action="store_true",
                    help="unpickle a checkpoint that holds more than tensors (can run code: trusted files only)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def scene_confidence(scene_root: Path, device) -> None:
    """The depth-consistency confidence of one scene, written beside its covisibility."""
    meta = wai_io.load_scene_meta(scene_root)
    names, depths, Ks, poses = [], [], [], []
    for fr in meta["frames"]:
        data = wai_io.load_frame(scene_root, fr["frame_name"], ["depth", "intrinsics", "pose"], meta=meta)
        names.append(fr["frame_name"])
        depths.append(data["depth"])
        Ks.append(data["intrinsics"])
        poses.append(data["pose"])
    conf = compute_depth_consistency_confidence(np.stack(depths), np.stack(Ks), np.stack(poses), device=device)
    write_depth_confidence(scene_root, names, conf)


def moge_model(checkpoint, device, trusted: bool = False) -> MoGeWrapper:
    """MoGe-1 at the release's widths holding ``checkpoint``, or the small
    config with seeded weights without one."""
    if not checkpoint:
        return MoGeWrapper(MoGeConfig.small(), device=device)
    with torch.device("meta"):  # no seeded initialisation: the checkpoint sets every tensor
        model = MoGeWrapper(MoGeConfig(), device="meta")
    model.to_empty(device=device)
    return load_reference_checkpoint(model, checkpoint, trusted)


def run_stage(args: argparse.Namespace, scene_root: Path, model=None) -> None:
    """One stage on one scene; ``model``: the MoGe model of the ``moge`` stage."""
    if args.stage == "undistort":
        undistort_scene(scene_root, modalities=tuple(args.modalities or ("image_distorted", "depth_distorted")),
                        device=args.device)
    elif args.stage == "confidence":
        scene_confidence(scene_root, args.device)
    elif args.stage == "moge":
        run_moge_on_scene(scene_root, model=model, batch_size=args.batch_size)
    elif args.stage == "mvs":
        run_mvs_on_scene(scene_root, num_neighbors=args.num_neighbors, num_planes=args.num_planes,
                         device=args.device)
    else:
        render_scene_frames(scene_root, mesh_name=args.mesh_name,
                            modalities=tuple(args.modalities or ("rendered_depth",)), device=args.device)


def main(argv=None, model=None) -> int:
    """Run the stage on every scene; ``model``: a built MoGe model for ``moge``
    (else one is built from ``--moge-checkpoint``)."""
    args = parse_args(argv)
    args.device = resolve_device(args.device)
    if args.stage == "moge" and model is None:
        model = moge_model(args.moge_checkpoint, args.device, args.trusted_checkpoint)
    ok, failed = 0, 0
    for scene_root in iter_scenes(Path(args.root), args.scenes):
        try:
            run_stage(args, scene_root, model)
            ok += 1
            print(f"[{args.stage}] {scene_root.name}: ok")
        except Exception:
            failed += 1
            print(f"[{args.stage}] {scene_root.name}: FAILED", file=sys.stderr)
            traceback.print_exc()
    print(f"{args.stage}: {ok} scenes processed, {failed} failed")
    return 1 if failed and not ok else 0


if __name__ == "__main__":
    raise SystemExit(main())
