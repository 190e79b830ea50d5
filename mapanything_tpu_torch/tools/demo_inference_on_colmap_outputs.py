"""MapAnything inference on a COLMAP reconstruction: its images, calibration and poses.

    python3 -m mapanything_tpu_torch.tools.demo_inference_on_colmap_outputs --data DIR
        [--out DIR] [--ext .bin] [--stride 1] [--resolution 518|512]
        [--checkpoint <hub dir | .pth | .pt>] [--trusted-checkpoint] [--small]
        [--no-calib] [--no-poses] [--device cuda]

The port of ``scripts/demo_inference_on_colmap_outputs.py`` (:43-157). ``--data`` holds
``images/`` and ``sparse/`` (``cameras.bin``, ``images.bin``, ``points3D.bin``, read by
``utils.colmap.read_model``). The images, sorted by name and strided, are loaded at the
resolution's bucket; each camera's pinhole (distortion ignored, rescaled to the bucket)
and each image's pose go to the model as geometric inputs unless ``--no-calib`` or
``--no-poses``; ``infer`` runs the model (bf16, from ``--checkpoint`` or seeded random
weights, with the geometric encoders) and the tool writes ``points.ply``, ``scene.glb``
and ``predictions.npz`` into ``--out``. Runs on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch


def camera_to_K(cam) -> np.ndarray:
    """A COLMAP camera's 3x3 pinhole K (distortion parameters ignored)."""
    p = np.asarray(cam.params, np.float64)
    if cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
        fx = fy = p[0]
        cx, cy = p[1], p[2]
    elif cam.model in ("PINHOLE", "OPENCV", "FULL_OPENCV", "OPENCV_FISHEYE"):
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    else:
        raise ValueError(f"unsupported COLMAP camera model {cam.model}")
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", required=True, help="folder with images/ + sparse/")
    ap.add_argument("--out", default="outputs/colmap_demo")
    ap.add_argument("--ext", default=".bin", choices=[".bin", ".txt"])
    ap.add_argument("--stride", type=int, default=1, help="use every nth image")
    ap.add_argument("--resolution", type=int, default=518, choices=[518, 512])
    ap.add_argument("--checkpoint", default=None, help="hub directory, or a .pth/.pt reference checkpoint")
    ap.add_argument("--trusted-checkpoint", action="store_true",
                    help="unpickle a checkpoint that holds more than tensors (can run code: trusted files only)")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--no-calib", action="store_true", help="ignore COLMAP intrinsics")
    ap.add_argument("--no-poses", action="store_true", help="ignore COLMAP poses")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build_model(args, device):
    """The bf16 model with the geometric encoders: from ``--checkpoint`` or seeded."""
    from mapanything_tpu_torch.models.mapanything import MapAnything, MapAnythingConfig
    from mapanything_tpu_torch.tools.load_model import load_model

    if args.checkpoint is not None:
        return load_model(args.checkpoint, args.small, device, trusted=args.trusted_checkpoint,
                          compute_dtype="bfloat16")[0]
    cfg = (MapAnythingConfig.small(compute_dtype="bfloat16") if args.small
           else MapAnythingConfig(compute_dtype="bfloat16"))
    return MapAnything(cfg, device=device, geometric_inputs=True)


def run(args: argparse.Namespace, model=None) -> dict:
    """The demo; returns the inputs read, the outputs and the seconds of each stage.
    ``model`` skips the build."""
    from mapanything_tpu_torch.utils.colmap import colmap_qt_to_c2w, read_model
    from mapanything_tpu_torch.utils.image import load_images
    from mapanything_tpu_torch.utils.inference import PostprocessConfig, infer
    from mapanything_tpu_torch.utils.viz import predictions_to_glb, write_ply_pointcloud

    data, out = Path(args.data), Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    seconds = {}
    cameras, images, _points = read_model(data / "sparse", ext=args.ext)
    entries = sorted(images.values(), key=lambda im: im.name)[:: args.stride]
    paths = [data / "images" / im.name for im in entries]
    missing = [p for p in paths if not p.exists()]
    if missing:
        raise FileNotFoundError(f"missing images: {missing[:3]} ...")

    loaded = load_images(paths, resolution_set=args.resolution, device=args.device)
    device = loaded["images"].device
    imgs = loaded["images_no_norm"][None]
    true_shape = loaded["true_shape"].cpu().numpy()
    V, H, W = imgs.shape[1:4]
    print(f"loaded {V} views at {H}x{W} from COLMAP model with {len(cameras)} cameras")

    intrinsics = None
    if not args.no_calib:
        Ks = []
        for im, (h0, w0) in zip(entries, true_shape):
            K = camera_to_K(cameras[im.camera_id])
            Ks.append(K * np.array([[W / w0, 1, W / w0], [1, H / h0, H / h0], [1, 1, 1]], np.float32))
        intrinsics = np.stack(Ks)[None]
    camera_poses = None
    if not args.no_poses:
        camera_poses = np.stack([colmap_qt_to_c2w(im.qvec, im.tvec) for im in entries]).astype(np.float32)[None]

    if model is None:
        model = build_model(args, device)
    t = time.perf_counter()
    outputs = infer(model, imgs, postprocess_cfg=PostprocessConfig(), intrinsics=intrinsics,
                    camera_poses=camera_poses)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds["infer"] = time.perf_counter() - t

    t = time.perf_counter()
    as_np = lambda x: x[0].float().cpu().numpy()  # noqa: E731
    imgs_np = imgs[0].float().cpu().numpy()
    pts = as_np(outputs.pts3d)
    mask = as_np(outputs.mask).astype(bool)
    cols = (imgs_np.reshape(-1, 3) * 255).astype(np.uint8)
    keep = mask.reshape(-1)
    write_ply_pointcloud(out / "points.ply", pts.reshape(-1, 3)[keep], cols[keep])
    predictions_to_glb(out / "scene.glb", pts, imgs_np, mask=mask)
    np.savez(out / "predictions.npz", depth_z=as_np(outputs.depth_z), intrinsics=as_np(outputs.intrinsics),
             camera_poses=as_np(outputs.camera_poses), conf=as_np(outputs.conf), names=[im.name for im in entries])
    seconds["export"] = time.perf_counter() - t
    print(f"wrote {out}/points.ply, scene.glb, predictions.npz")
    return dict(model=model, outputs=outputs, intrinsics=intrinsics, camera_poses=camera_poses,
                names=[im.name for im in entries], out=out, seconds=seconds)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
