"""COLMAP export with optional bundle adjustment: a folder of images to a sparse model.

    python3 -m mapanything_tpu_torch.tools.demo_colmap --images DIR --out DIR [--use-ba]
        [--checkpoint <hub dir | .pth | .pt>] [--trusted-checkpoint] [--small]
        [--points-per-view 512] [--ba-iters 10] [--tracker dense|photometric] [--device cuda]

The port of ``scripts/demo_colmap.py`` (:23-113): load the images, build the model in
bf16 (from ``--checkpoint`` through ``tools.load_model``, or with seeded random
weights), run ``infer``; with ``--use-ba`` build tracks (from the dense predictions,
``--points-per-view`` seeds a view, or from the photometric keypoint tracker) and refine
the cameras by ``ba.solver.ba_solve`` (``--ba-iters`` Gauss-Newton iterations of 25 CG
steps); then write ``sparse/`` (a COLMAP model, ``.bin``) and ``points.ply`` into
``--out``. Runs on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

BA_CG_ITERS = 25


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", required=True)
    ap.add_argument("--out", default="outputs/colmap")
    ap.add_argument("--use-ba", action="store_true")
    ap.add_argument("--checkpoint", default=None, help="hub directory, or a .pth/.pt reference checkpoint")
    ap.add_argument("--trusted-checkpoint", action="store_true",
                    help="unpickle a checkpoint that holds more than tensors (can run code: trusted files only)")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--points-per-view", type=int, default=512)
    ap.add_argument("--ba-iters", type=int, default=10)
    ap.add_argument("--tracker", default="dense", choices=["dense", "photometric"],
                    help="track source: dense predictions or the keypoint tracker")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace, model=None) -> dict:
    """The demo; returns the outputs of each stage (the tracks, the BA state and costs,
    the poses written) and the seconds each took. ``model`` skips the build."""
    from mapanything_tpu_torch.ba.solver import BAState, _total_cost, ba_solve, refined_camera_poses
    from mapanything_tpu_torch.ba.tracks import extract_tracks_from_predictions, tracks_from_photometric_tracker
    from mapanything_tpu_torch.tools.load_model import load_model
    from mapanything_tpu_torch.utils.colmap import predictions_to_colmap, write_model
    from mapanything_tpu_torch.utils.image import load_images
    from mapanything_tpu_torch.utils.inference import infer
    from mapanything_tpu_torch.utils.viz import write_ply_pointcloud

    seconds, res = {}, {}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    loaded = load_images(args.images, device=args.device)
    device = loaded["images"].device
    imgs01 = loaded["images_no_norm"][None]
    print(f"{imgs01.shape[1]} views at {imgs01.shape[2]}x{imgs01.shape[3]}")
    if model is None:
        model, source = load_model(args.checkpoint, args.small, device, trusted=args.trusted_checkpoint,
                                   compute_dtype="bfloat16")
        if source == "random":
            print("WARNING: random weights (no --checkpoint given)")

    t = time.perf_counter()
    outputs = infer(model, imgs01)
    _sync(device)
    seconds["infer"] = time.perf_counter() - t
    pts3d = outputs.pts3d[0].float()
    depth_z = outputs.depth_z[0, ..., 0].float()
    K = outputs.intrinsics[0].float()
    poses = outputs.camera_poses[0].float()
    conf = outputs.conf[0].float()
    mask = (outputs.mask[0, ..., 0].bool() if outputs.mask is not None
            else torch.ones(depth_z.shape, dtype=torch.bool, device=device))
    colors = outputs.img_no_norm[0].float()

    if args.use_ba:
        print("running bundle adjustment (Schur-CG)...")
        t = time.perf_counter()
        if args.tracker == "photometric":
            tracks = tracks_from_photometric_tracker(colors, depth_z, K, poses, max_query_pts=args.points_per_view)
        else:
            tracks = extract_tracks_from_predictions(pts3d, depth_z, K, poses, conf, mask,
                                                     points_per_view=args.points_per_view)
        _sync(device)
        seconds["tracks"] = time.perf_counter() - t
        t = time.perf_counter()
        state, costs = ba_solve(tracks, args.ba_iters, BA_CG_ITERS)
        poses = refined_camera_poses(state)
        _sync(device)
        seconds["ba"] = time.perf_counter() - t
        # The history holds each iteration's proposed step (refused ones too, as in the JAX
        # package); the state keeps only the steps that lowered the cost.
        initial = BAState(tracks.cam_from_world_rot, tracks.cam_from_world_trans, tracks.points3d)
        n_obs = max(int(tracks.valid.sum()), 1)
        res.update(tracks=tracks, state=state, costs=costs, n_obs=n_obs,
                   initial_cost=float(_total_cost(tracks, initial, 2.0)), final_cost=float(_total_cost(tracks, state, 2.0)))
        print(f"BA cost: {float(costs[0]):.1f} -> {float(costs[-1]):.1f} "
              f"(rms {np.sqrt(float(costs[-1]) / n_obs):.2f} px)")

    t = time.perf_counter()
    as_np = lambda x: x.cpu().numpy()  # noqa: E731
    pts_np, colors_np, mask_np, poses_np = as_np(pts3d), as_np(colors), as_np(mask), as_np(poses)
    cams, ims, p3d = predictions_to_colmap(pts_np, colors_np, as_np(K), poses_np, masks=mask_np,
                                           image_names=[Path(p).name for p in loaded["paths"]])
    write_model(cams, ims, p3d, out / "sparse", ".bin")
    write_ply_pointcloud(out / "points.ply", pts_np[mask_np], colors_np[mask_np])
    seconds["export"] = time.perf_counter() - t
    print(f"wrote {out}/sparse (COLMAP) and points.ply")
    res.update(model=model, outputs=outputs, poses=poses_np, out=out, seconds=seconds, paths=loaded["paths"])
    return res


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
