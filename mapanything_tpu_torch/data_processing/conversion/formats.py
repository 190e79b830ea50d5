"""Loaders for the raw formats the source datasets ship in.

Counterpart of ``mapanything_tpu/data_processing/conversion/formats.py``
(:1-236), after the per-format helpers of the reference's
``data_processing/wai_processing/scripts/conversion/*.py``:
- PFM depth (blendedmvs.py:27),
- float16-in-uint16 PNG depth (dynamicreplica.py load_16bit_png_depth,
  co3d.py:69), read with the port's ``utils/image.read_png(unchanged=True)``
  where the JAX package uses cv2,
- Spring .dsp5 HDF5 disparity (spring.py readDsp5Disp/load_spring_depth),
  ``h5py`` imported only when such a file is read,
- GTA NDC depth + projection-inverse (sailvos3d.py:27-98),
- OpenGL->OpenCV pose conversion (mapanything/utils/wai/ops.py gl2cv),
- nerfstudio transforms.json cameras (dl3dv.py, scannetppv2.py).
Host code, numpy only.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# depth / disparity formats


def read_pfm(path) -> np.ndarray:
    """Portable Float Map (BlendedMVS depth). Returns (H, W[, 3]) float32."""
    with open(path, "rb") as f:
        header = f.readline().decode().strip()
        if header not in ("PF", "Pf"):
            raise ValueError(f"{path}: not a PFM file")
        color = header == "PF"
        dims = re.match(r"^(\d+)\s+(\d+)\s*$", f.readline().decode())
        if not dims:
            raise ValueError(f"{path}: bad PFM dimensions")
        w, h = map(int, dims.groups())
        scale = float(f.readline().decode().strip())
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(), dtype)
    data = data.reshape((h, w, 3) if color else (h, w)).astype(np.float32)
    return data[::-1].copy()  # PFM scanlines are bottom-up


def read_float16_png_depth(path) -> np.ndarray:
    """uint16 PNG whose bits are raw float16 depth (DynamicReplica/CO3D)."""
    from mapanything_tpu_torch.utils.image import read_png

    if not Path(path).is_file():
        raise FileNotFoundError(path)
    raw = read_png(path, unchanged=True)
    assert raw.dtype == np.uint16, f"{path}: expected uint16 png"
    return raw.view(np.float16).astype(np.float32).reshape(raw.shape)


def read_dsp5_disparity(path) -> np.ndarray:
    """Spring .dsp5 disparity (HDF5 with a 'disparity' dataset)."""
    import h5py

    with h5py.File(path, "r") as f:
        if "disparity" not in f:
            raise IOError(f"{path}: no 'disparity' dataset")
        return np.asarray(f["disparity"])


def disparity_to_depth(
    disparity: np.ndarray, focal_px: float, baseline_m: float,
    max_depth: float = np.inf,
) -> np.ndarray:
    """Stereo disparity -> metric z-depth; invalid/overflow set to 0."""
    with np.errstate(divide="ignore", invalid="ignore"):
        depth = focal_px * baseline_m / disparity
    valid = (disparity > 0) & np.isfinite(depth) & (depth < max_depth)
    return np.where(valid, depth, 0.0).astype(np.float32)


def gta_ndc_depth_to_camera(
    ndc_depth: np.ndarray, proj_inverse: np.ndarray
) -> np.ndarray:
    """GTA-V (SAIL-VOS 3D) NDC depth buffer -> camera-space z-depth.

    Reference sailvos3d.py:27-98: rescale the hardware depth buffer,
    unproject every pixel's NDC coordinate through P^-1, and take the
    -z of the dehomogenised camera point.
    """
    H, W = ndc_depth.shape
    zs = ndc_depth / 6.0 - 4e-5
    xx, yy = np.meshgrid(np.arange(W), np.arange(H))
    x_ndc = (2.0 / W) * xx - 1.0
    y_ndc = (-2.0 / H) * yy + 1.0
    ndc = np.stack(
        [x_ndc.ravel(), y_ndc.ravel(), zs.ravel(), np.ones(H * W)], axis=1
    )
    cam = ndc @ np.asarray(proj_inverse, np.float64)
    cam = cam / cam[:, 3:4]
    return (-cam[:, 2]).reshape(H, W).astype(np.float32)


# ---------------------------------------------------------------------------
# pose conventions


# OpenGL camera (RUB: +x right, +y up, -z forward) -> OpenCV (RDF).
GL2CV = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float64)
# Left-handed RUF (e.g. GTA/MVS-Synth world) -> RDF: flip the y axis.
FLIP_Y = np.diag([1.0, -1.0, 1.0, 1.0]).astype(np.float64)
# LFU (left-forward-up, Parallel Domain) world axes permuted to RDF.
LFU_TO_RDF = np.array(
    [[0, 0, 1, 0], [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float64
)


def gl2cv_pose(cam2world_gl: np.ndarray) -> np.ndarray:
    """OpenGL cam2world -> OpenCV cam2world (column-flip of the basis)."""
    return np.asarray(cam2world_gl, np.float64) @ GL2CV


def w2c_to_c2w(w2c: np.ndarray) -> np.ndarray:
    """Invert a rigid world2cam matrix analytically."""
    w2c = np.asarray(w2c, np.float64)
    R, t = w2c[:3, :3], w2c[:3, 3]
    out = np.eye(4)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


def quat_xyzw_to_matrix(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (x, y, z, w) -> 3x3 rotation matrix."""
    x, y, z, w = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def quat_wxyz_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = np.asarray(q, np.float64)
    return quat_xyzw_to_matrix(np.array([x, y, z, w]))


def axis_angle_to_matrix(axis_angle: np.ndarray) -> np.ndarray:
    """Rodrigues rotation vector -> 3x3 matrix (OpenSfM / MPSD poses)."""
    v = np.asarray(axis_angle, np.float64)
    theta = np.linalg.norm(v)
    if theta < 1e-12:
        return np.eye(3)
    k = v / theta
    K = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], np.float64
    )
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def pytorch3d_ndc_camera_to_opencv(
    viewpoint: Dict, image_wh: Tuple[int, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """PyTorch3D NDC viewpoint dict -> (K pixels, OpenCV cam2world).

    Reference dynamicreplica.py get_intrinsics_matrix /
    get_extrinsics_matrix (same convention in CO3D annotations):
    isotropic NDC focal/principal scaled by min(half-size); PyTorch3D's
    row-vector (R, T) with +x left / +y up flipped into OpenCV RDF.
    """
    W, H = image_wh
    f_ndc = np.asarray(viewpoint["focal_length"], np.float64)
    c_ndc = np.asarray(viewpoint["principal_point"], np.float64)
    half = np.array([W, H], np.float64) / 2.0
    rescale = half.min()
    f_px = f_ndc * rescale
    c_px = half - c_ndc * rescale
    K = np.array(
        [[f_px[0], 0, c_px[0]], [0, f_px[1], c_px[1]], [0, 0, 1]], np.float64
    )

    R = np.asarray(viewpoint["R"], np.float64).copy()
    T = np.asarray(viewpoint["T"], np.float64).copy()
    R[:, :2] *= -1
    T[:2] *= -1
    c2w = np.eye(4)
    c2w[:3, :3] = R
    c2w[:3, 3] = -R @ T
    return K, c2w


# ---------------------------------------------------------------------------
# nerfstudio transforms.json (DL3DV, ScanNet++ v2)


def read_nerfstudio_transforms(path) -> Dict:
    """Parse transforms.json into shared K + per-frame OpenCV poses.

    Returns dict with: ``intrinsics`` (3, 3) from fl_x/fl_y/cx/cy,
    ``wh``, ``distortion`` (k1 k2 p1 p2), and ``frames`` list of
    {file_path, cam2world (OpenCV), name}. nerfstudio poses are OpenGL
    cam2world.
    """
    with open(path) as f:
        meta = json.load(f)

    def K_of(src):
        return np.array(
            [
                [src["fl_x"], 0, src["cx"]],
                [0, src["fl_y"], src["cy"]],
                [0, 0, 1],
            ],
            np.float64,
        )

    shared = "fl_x" in meta
    out_frames = []
    for fr in meta["frames"]:
        pose_gl = np.asarray(fr["transform_matrix"], np.float64)
        rec = {
            "file_path": fr["file_path"],
            "name": Path(fr["file_path"]).stem,
            "cam2world": gl2cv_pose(pose_gl),
        }
        if not shared:
            rec["intrinsics"] = K_of(fr)
            rec["wh"] = (int(fr["w"]), int(fr["h"]))
        out_frames.append(rec)

    out = {"frames": out_frames}
    if shared:
        out["intrinsics"] = K_of(meta)
        out["wh"] = (int(meta["w"]), int(meta["h"]))
        out["distortion"] = np.array(
            [meta.get(k, 0.0) for k in ("k1", "k2", "p1", "p2")], np.float64
        )
    return out
