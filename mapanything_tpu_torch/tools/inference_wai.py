"""MapAnything inference on a WAI-format scene, with optional calibration, pose and depth priors.

    python3 -m mapanything_tpu_torch.tools.inference_wai --scene <wai scene dir> [--out outputs/wai_demo]
        [--num-views 8] [--stride 1] [--resolution 518|512] [--checkpoint <hub dir | .pth | .pt>]
        [--trusted-checkpoint] [--small] [--use-calib] [--use-poses] [--use-depth] [--device cuda]

The port of ``scripts/inference_wai.py``: load every ``--stride``-th frame of the
scene (up to ``--num-views``) with ``data.wai.load_frame``, crop and resize each
to the aspect-ratio bucket of the first (``data.cropping``; a centred default
camera where the scene has no intrinsics), build the bf16 model (seeded random
weights, with the geometric encoders where a prior is given, or ``--checkpoint``
through ``tools.load_model``), run ``utils.inference.infer`` with the priors the
flags ask for (``--use-calib``: the intrinsics; ``--use-poses``: the cam2world
poses; ``--use-depth``: the z-depth and the intrinsics) and write ``points.ply``
(the masked points, coloured by the images), ``scene.glb`` and
``predictions.npz`` into ``--out``. Runs on the card unless ``--device`` names
another.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from mapanything_tpu_torch.data.cropping import crop_resize_if_necessary
from mapanything_tpu_torch.data.wai import load_frame, load_scene_meta
from mapanything_tpu_torch.models.mapanything import MapAnything, MapAnythingConfig, resolve_device
from mapanything_tpu_torch.tools.load_model import load_model
from mapanything_tpu_torch.utils.image import find_closest_aspect_ratio
from mapanything_tpu_torch.utils.inference import PostprocessConfig, infer
from mapanything_tpu_torch.utils.viz import predictions_to_glb, write_ply_pointcloud

OUTPUTS = ("points.ply", "scene.glb", "predictions.npz")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", required=True, help="WAI scene directory")
    ap.add_argument("--out", default="outputs/wai_demo")
    ap.add_argument("--num-views", type=int, default=8)
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--resolution", type=int, default=518, choices=[518, 512])
    ap.add_argument("--checkpoint", default=None, help="hub directory, or a .pth/.pt reference checkpoint")
    ap.add_argument("--trusted-checkpoint", action="store_true",
                    help="unpickle a checkpoint that holds more than tensors (can run code: trusted files only)")
    ap.add_argument("--small", action="store_true", help="the small config (MapAnythingConfig.small())")
    ap.add_argument("--use-calib", action="store_true", help="feed the WAI intrinsics (calibrated preset)")
    ap.add_argument("--use-poses", action="store_true", help="feed the WAI poses (posed preset)")
    ap.add_argument("--use-depth", action="store_true", help="feed the WAI depth (depth-completion preset)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def load_views(args: argparse.Namespace) -> dict:
    """The scene's frames, cropped and resized: images (V, H, W, 3) in [0, 1], the
    intrinsics, poses and z-depths the flags ask for, and the frame names."""
    meta = load_scene_meta(args.scene)
    names = [f["frame_name"] for f in meta["frames"]][:: args.stride][: args.num_views]
    mods = ["image"]
    if args.use_calib or args.use_depth:
        mods.append("intrinsics")
    if args.use_poses:
        mods.append("pose")
    if args.use_depth:
        mods.append("depth")

    imgs, Ks, poses, depths = [], [], [], []
    target = None
    for name in names:
        fr = load_frame(args.scene, name, mods, meta=meta)
        h0, w0 = fr["image"].shape[:2]
        if target is None:
            target = find_closest_aspect_ratio(w0 / h0, args.resolution)
        # A centred default camera keeps the crop intrinsics-aware without a calibration.
        K = fr.get("intrinsics", np.array([[max(h0, w0), 0, w0 / 2], [0, max(h0, w0), h0 / 2], [0, 0, 1]], np.float32))
        depth = fr.get("depth")
        img, depth, K, _ = crop_resize_if_necessary(
            torch.from_numpy(np.ascontiguousarray(fr["image"], np.float32)), target,
            depthmap=None if depth is None else torch.from_numpy(np.ascontiguousarray(depth, np.float32)),
            intrinsics=K,
        )
        imgs.append(img.numpy())
        Ks.append(K)
        if depth is not None:
            depths.append(depth.numpy())
        if "pose" in fr:
            poses.append(fr["pose"])
    priors = {}
    if args.use_calib or args.use_depth:
        priors["intrinsics"] = np.stack(Ks).astype(np.float32)[None]
    if args.use_poses:
        priors["camera_poses"] = np.stack(poses).astype(np.float32)[None]
    if args.use_depth:
        priors["depth_z"] = np.stack(depths).astype(np.float32)[None]
    return dict(images=np.stack(imgs).astype(np.float32)[None], priors=priors, names=names)


def run(args: argparse.Namespace, model=None) -> dict:
    """The tool (with ``model`` in place of the one the flags build, where given);
    returns the loaded views, the model, the outputs (on the model's device) and the
    output directory."""
    device = resolve_device(args.device if model is None else model.device)
    views = load_views(args)
    images, priors = views["images"], views["priors"]
    V, H, W = images.shape[1:4]
    print(f"loaded {V} WAI frames at {H}x{W} (priors: {sorted(priors)})")

    if model is None and args.checkpoint:
        model, _ = load_model(args.checkpoint, args.small, device, trusted=args.trusted_checkpoint,
                              compute_dtype="bfloat16")
    elif model is None:
        make = MapAnythingConfig.small if args.small else MapAnythingConfig
        model = MapAnything(make(compute_dtype="bfloat16"), device=device, seed=0, geometric_inputs=bool(priors))
    outputs = infer(model, images, postprocess_cfg=PostprocessConfig(), **priors)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    numpy = lambda x: x[0].float().cpu().numpy()  # noqa: E731
    pts, mask = numpy(outputs.pts3d), numpy(outputs.mask)[..., 0].astype(bool)
    write_ply_pointcloud(out / "points.ply", pts[mask], images[0][mask])
    predictions_to_glb(out / "scene.glb", pts, images[0], mask=mask)
    np.savez(out / "predictions.npz", depth_z=numpy(outputs.depth_z), intrinsics=numpy(outputs.intrinsics),
             camera_poses=numpy(outputs.camera_poses), conf=numpy(outputs.conf), names=views["names"])
    print(f"wrote {out}/points.ply, scene.glb, predictions.npz")
    return dict(views=views, model=model, outputs=outputs, out=out)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
