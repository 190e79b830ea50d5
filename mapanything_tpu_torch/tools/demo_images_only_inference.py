"""Images-only metric 3D reconstruction: a folder of images to a scene.

    python3 -m mapanything_tpu_torch.tools.demo_images_only_inference --images DIR --out DIR
        [--checkpoint <hub dir | .pth | .pt>] [--trusted-checkpoint] [--resolution 518|512] [--small]
        [--conf-mask] [--device cuda]

The port of ``scripts/demo_images_only_inference.py`` (:21-103): load the
images (``utils.image.load_images``: every view takes the first one's
aspect-ratio bucket), build the model in bf16 (``compute_dtype="bfloat16"``, as
the JAX demo) from ``--checkpoint`` or with seeded random weights, run
``infer``, and write ``scene.glb``, ``scene.ply``, ``sparse/`` (a COLMAP model,
``.bin``) and ``viewer.html`` into ``--out``. Runs on the card unless
``--device`` names another.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from mapanything_tpu_torch.tools.load_model import load_model
from mapanything_tpu_torch.utils.colmap import predictions_to_colmap, write_model
from mapanything_tpu_torch.utils.image import load_images
from mapanything_tpu_torch.utils.inference import PostprocessConfig, infer
from mapanything_tpu_torch.utils.viewer import export_viewer_html
from mapanything_tpu_torch.utils.viz import predictions_to_glb, write_ply_pointcloud

OUTPUTS = ("scene.glb", "scene.ply", "sparse", "viewer.html")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", required=True, help="folder of input images")
    ap.add_argument("--out", default="outputs/demo")
    ap.add_argument("--checkpoint", default=None, help="hub directory, or a .pth/.pt reference checkpoint")
    ap.add_argument("--trusted-checkpoint", action="store_true",
                    help="unpickle a checkpoint that holds more than tensors (can run code: trusted files only)")
    ap.add_argument("--resolution", type=int, default=518, choices=[518, 512])
    ap.add_argument("--small", action="store_true", help="use the small config")
    ap.add_argument("--conf-mask", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace) -> dict:
    """The demo; returns the model, the loaded images, the outputs (on the
    model's device), the output directory and the seconds of each stage."""
    seconds = {}

    t = time.perf_counter()
    loaded = load_images(args.images, resolution_set=args.resolution, device=args.device)
    device = loaded["images"].device
    _sync(device)
    seconds["load_images"] = time.perf_counter() - t
    v, h, w = loaded["images"].shape[:3]
    print(f"loaded {v} views at {h}x{w}")

    t = time.perf_counter()
    model, source = load_model(args.checkpoint, args.small, device, trusted=args.trusted_checkpoint,
                               compute_dtype="bfloat16")
    _sync(device)
    seconds["model"] = time.perf_counter() - t
    if source == "random":
        print("WARNING: random weights (no --checkpoint given); geometry will be meaningless but the "
              "pipeline runs end to end")
    else:
        print(f"restored {source} weights from {args.checkpoint}")

    t = time.perf_counter()
    outputs = infer(model, loaded["images_no_norm"][None], postprocess_cfg=PostprocessConfig(
        apply_confidence_mask=args.conf_mask))
    _sync(device)
    seconds["infer"] = time.perf_counter() - t

    t = time.perf_counter()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    pts = outputs.pts3d[0].float().cpu().numpy()
    colors = outputs.img_no_norm[0].float().cpu().numpy()
    mask = outputs.mask[0, ..., 0].cpu().numpy() if outputs.mask is not None else None
    intrinsics = outputs.intrinsics[0].float().cpu().numpy()
    poses = outputs.camera_poses[0].float().cpu().numpy()
    keep = None if mask is None else mask.astype(bool)
    predictions_to_glb(out / "scene.glb", pts, colors, mask)
    write_ply_pointcloud(
        out / "scene.ply",
        pts.reshape(-1, 3) if keep is None else pts[keep],
        colors.reshape(-1, 3) if keep is None else colors[keep],
    )
    cams, ims, p3d = predictions_to_colmap(pts, colors, intrinsics, poses, masks=mask,
                                           image_names=[Path(p).name for p in loaded["paths"]])
    write_model(cams, ims, p3d, out / "sparse", ".bin")
    export_viewer_html(out / "viewer.html", pts, colors, camera_poses=poses, intrinsics=intrinsics, mask=mask,
                       title=f"{pts.shape[0]}-view reconstruction")
    seconds["export"] = time.perf_counter() - t
    print(f"wrote {out}/scene.glb, scene.ply, sparse/ (COLMAP), viewer.html")
    return dict(model=model, source=source, loaded=loaded, outputs=outputs, out=out, seconds=seconds)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
