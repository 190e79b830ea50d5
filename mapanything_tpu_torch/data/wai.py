"""WAI-format scene IO: scene_meta.json, images, depth, covisibility mmaps.

Counterpart of ``mapanything_tpu/data/wai.py`` (:1-145), after the reference's
``mapanything/utils/wai/core.py`` (load_data :32, load_frame :357,
get_intrinsics/extrinsics :120) and ``io.py`` (EXR depth :255, mmap :797).
The JAX package decodes with cv2; the port with its own readers:

- images: PNG (``utils/image.read_png``) and JPEG (``utils/jpeg.read_jpeg``),
  as ``cv2.imread(IMREAD_COLOR)`` + BGR -> RGB;
- depth: 16-bit PNG in millimetres (``read_png(..., unchanged=True)``, divided
  by 1000), other PNGs as stored, EXR (``utils/exr.read_depth_exr``) and npy;
- covisibility: numpy memmaps.

A WAI scene directory looks like:
    scene_root/
      scene_meta.json          # frames list, modality paths, camera params
      images/<frame>.jpg
      depth/<frame>.exr
      covisibility/<version>/<chunk>.npy   (mmap, N x N)
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from mapanything_tpu_torch.utils.exr import read_depth_exr
from mapanything_tpu_torch.utils.image import read_png
from mapanything_tpu_torch.utils.jpeg import read_jpeg


def load_scene_meta(scene_root) -> Dict:
    """Read and lightly validate scene_meta.json."""
    with open(Path(scene_root) / "scene_meta.json") as f:
        meta = json.load(f)
    assert "frames" in meta, f"invalid scene_meta in {scene_root}"
    return meta


def frame_index(meta: Dict) -> Dict[str, int]:
    """frame_name -> index map."""
    return {fr["frame_name"]: i for i, fr in enumerate(meta["frames"])}


def load_image(path, as_float: bool = True) -> np.ndarray:
    """RGB image (H, W, 3) from a PNG or JPEG file; float32 in [0, 1] by default."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(path)
    suffix = path.suffix.lower()
    if suffix == ".png":
        img = read_png(path)
    elif suffix in (".jpg", ".jpeg"):
        img = read_jpeg(path)
    else:
        raise ValueError(f"{path}: the port reads PNG and JPEG frames, not {suffix}")
    if as_float:
        img = img.astype(np.float32) / 255.0
    return img


def load_depth(path) -> np.ndarray:
    """Depth map (H, W) float32 from EXR / PNG (mm) / NPY."""
    path = str(path)
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if path.endswith(".exr"):
        return read_depth_exr(path)
    # 16-bit png in millimeters (common WAI export)
    if not Path(path).is_file():
        raise FileNotFoundError(path)
    d = read_png(path, unchanged=True)
    if d.dtype == np.uint16:
        return d.astype(np.float32) / 1000.0
    return d.astype(np.float32)


def load_mmap(path) -> np.ndarray:
    """Open an .npy matrix as a read-only memmap (io.py:797)."""
    return np.load(str(path), mmap_mode="r")


def get_intrinsics(meta: Dict, frame: Dict) -> np.ndarray:
    """3x3 pinhole K from shared or per-frame parameters (core.py:120)."""
    src = frame if "fl_x" in frame else meta
    K = np.array(
        [
            [src["fl_x"], 0.0, src["cx"]],
            [0.0, src["fl_y"], src["cy"]],
            [0.0, 0.0, 1.0],
        ],
        np.float32,
    )
    return K


def get_extrinsics(frame: Dict) -> np.ndarray:
    """4x4 OpenCV cam2world pose from the frame's transform_matrix."""
    pose = np.asarray(frame["transform_matrix"], np.float32).reshape(4, 4)
    return pose


def load_frame(
    scene_root,
    frame_name: str,
    modalities: List[str],
    meta: Optional[Dict] = None,
) -> Dict:
    """Load the requested modalities for one frame (core.py:357).

    Supported modalities: "image", "depth", "pose", "intrinsics".
    """
    scene_root = Path(scene_root)
    if meta is None:
        meta = load_scene_meta(scene_root)
    idx = frame_index(meta)[frame_name]
    frame = meta["frames"][idx]

    out: Dict = {"frame_name": frame_name, "frame_idx": idx}
    for mod in modalities:
        if mod == "image":
            rel = frame.get("image", frame.get("file_path"))
            out["image"] = load_image(scene_root / rel)
        elif mod == "depth":
            rel = frame.get("depth", frame.get("depth_path"))
            out["depth"] = load_depth(scene_root / rel)
        elif mod == "pose":
            out["pose"] = get_extrinsics(frame)
        elif mod == "intrinsics":
            out["intrinsics"] = get_intrinsics(meta, frame)
        else:
            raise ValueError(f"unknown modality {mod}")
    return out


def load_covisibility(scene_root, version: str = "v0") -> np.ndarray:
    """Memmap the scene's pairwise covisibility matrix."""
    scene_root = Path(scene_root)
    cov_dir = scene_root / "covisibility"
    if (cov_dir / version).is_dir():
        files = sorted((cov_dir / version).glob("*.npy"))
    else:
        files = sorted(cov_dir.glob("*.npy"))
    if not files:
        raise FileNotFoundError(f"no covisibility data under {cov_dir}")
    return load_mmap(files[0])
