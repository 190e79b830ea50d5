"""COLMAP sparse-model reader and writer of the port (binary and text).

A copy of ``mapanything_tpu/utils/colmap.py`` (:67-314): cameras, images and
points3D in COLMAP's binary and text layouts, and ``predictions_to_colmap``,
which builds a model from ``InferenceOutputs`` fields given as numpy arrays.
The pose conversions use numpy alone: Markley's rotation-to-quaternion
method (the one SciPy's ``Rotation.from_matrix`` applies to a rotation) and
the quaternion's rotation matrix.

Conventions: COLMAP stores world2cam with WXYZ quaternions; the port's poses
are cam2world with XYZW quaternions.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

CAMERA_MODELS = {
    "SIMPLE_PINHOLE": (0, 3),
    "PINHOLE": (1, 4),
    "SIMPLE_RADIAL": (2, 4),
    "RADIAL": (3, 5),
    "OPENCV": (4, 8),
}
CAMERA_MODEL_IDS = {v[0]: (k, v[1]) for k, v in CAMERA_MODELS.items()}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # model-dependent


@dataclass
class Image:
    id: int
    qvec: np.ndarray  # WXYZ world2cam
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    point3D_ids: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int64))


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray  # uint8 (3,)
    error: float = 0.0
    image_ids: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int64))
    point2D_idxs: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int64))


# --------------------------------------------------------------------------
# Pose conversions (our cam2world XYZW <-> COLMAP world2cam WXYZ)
# --------------------------------------------------------------------------


def _rotmat_to_quat_xyzw(rot: np.ndarray) -> np.ndarray:
    """A rotation matrix (3, 3) to its unit XYZW quaternion (Markley 2008):
    built from the largest of the diagonal and the trace, then normalised."""
    decision = np.array([rot[0, 0], rot[1, 1], rot[2, 2], np.trace(rot)])
    choice = int(np.argmax(decision))
    quat = np.empty(4)
    if choice != 3:
        i, j, k = choice, (choice + 1) % 3, (choice + 2) % 3
        quat[i] = 1 - decision[3] + 2 * rot[i, i]
        quat[j] = rot[j, i] + rot[i, j]
        quat[k] = rot[k, i] + rot[i, k]
        quat[3] = rot[k, j] - rot[j, k]
    else:
        quat[0] = rot[2, 1] - rot[1, 2]
        quat[1] = rot[0, 2] - rot[2, 0]
        quat[2] = rot[1, 0] - rot[0, 1]
        quat[3] = 1 + decision[3]
    return quat / np.linalg.norm(quat)


def _quat_xyzw_to_rotmat(quat) -> np.ndarray:
    x, y, z, w = np.asarray(quat, np.float64) / np.linalg.norm(quat)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def c2w_to_colmap_qt(pose_c2w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """4x4 cam2world -> (qvec WXYZ, tvec) of the world2cam transform."""
    r_w2c = pose_c2w[:3, :3].T
    t_w2c = -r_w2c @ pose_c2w[:3, 3]
    q_xyzw = _rotmat_to_quat_xyzw(r_w2c)
    return np.array([q_xyzw[3], q_xyzw[0], q_xyzw[1], q_xyzw[2]]), t_w2c


def colmap_qt_to_c2w(qvec: np.ndarray, tvec: np.ndarray) -> np.ndarray:
    """(qvec WXYZ, tvec) of a world2cam transform -> 4x4 cam2world."""
    r_w2c = _quat_xyzw_to_rotmat([qvec[1], qvec[2], qvec[3], qvec[0]])
    pose = np.eye(4)
    pose[:3, :3] = r_w2c.T
    pose[:3, 3] = -r_w2c.T @ np.asarray(tvec)
    return pose


# --------------------------------------------------------------------------
# Binary IO
# --------------------------------------------------------------------------


def _w(f, fmt, *vals):
    f.write(struct.pack("<" + fmt, *vals))


def _r(f, fmt):
    size = struct.calcsize("<" + fmt)
    return struct.unpack("<" + fmt, f.read(size))


def write_cameras_binary(cameras: Dict[int, Camera], path):
    with open(path, "wb") as f:
        _w(f, "Q", len(cameras))
        for cam in cameras.values():
            model_id, n_params = CAMERA_MODELS[cam.model]
            _w(f, "iiQQ", cam.id, model_id, cam.width, cam.height)
            assert len(cam.params) == n_params, cam
            _w(f, "d" * n_params, *[float(p) for p in cam.params])


def read_cameras_binary(path) -> Dict[int, Camera]:
    cameras = {}
    with open(path, "rb") as f:
        (n,) = _r(f, "Q")
        for _ in range(n):
            cid, model_id, width, height = _r(f, "iiQQ")
            name, n_params = CAMERA_MODEL_IDS[model_id]
            params = np.array(_r(f, "d" * n_params))
            cameras[cid] = Camera(cid, name, width, height, params)
    return cameras


def write_images_binary(images: Dict[int, Image], path):
    with open(path, "wb") as f:
        _w(f, "Q", len(images))
        for im in images.values():
            _w(f, "i", im.id)
            _w(f, "dddd", *[float(v) for v in im.qvec])
            _w(f, "ddd", *[float(v) for v in im.tvec])
            _w(f, "i", im.camera_id)
            f.write(im.name.encode() + b"\x00")
            _w(f, "Q", len(im.xys))
            for xy, pid in zip(im.xys, im.point3D_ids):
                _w(f, "ddq", float(xy[0]), float(xy[1]), int(pid))


def read_images_binary(path) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _r(f, "Q")
        for _ in range(n):
            (iid,) = _r(f, "i")
            qvec = np.array(_r(f, "dddd"))
            tvec = np.array(_r(f, "ddd"))
            (cam_id,) = _r(f, "i")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _r(f, "Q")
            xys = np.zeros((n_pts, 2))
            pids = np.zeros((n_pts,), np.int64)
            for i in range(n_pts):
                x, y, pid = _r(f, "ddq")
                xys[i] = (x, y)
                pids[i] = pid
            images[iid] = Image(iid, qvec, tvec, cam_id, name.decode(), xys, pids)
    return images


def write_points3D_binary(points3D: Dict[int, Point3D], path):
    with open(path, "wb") as f:
        _w(f, "Q", len(points3D))
        for pt in points3D.values():
            _w(f, "q", pt.id)
            _w(f, "ddd", *[float(v) for v in pt.xyz])
            _w(f, "BBB", *[int(v) for v in pt.rgb])
            _w(f, "d", float(pt.error))
            _w(f, "Q", len(pt.image_ids))
            for iid, p2d in zip(pt.image_ids, pt.point2D_idxs):
                _w(f, "ii", int(iid), int(p2d))


def read_points3D_binary(path) -> Dict[int, Point3D]:
    points = {}
    with open(path, "rb") as f:
        (n,) = _r(f, "Q")
        for _ in range(n):
            (pid,) = _r(f, "q")
            xyz = np.array(_r(f, "ddd"))
            rgb = np.array(_r(f, "BBB"), np.uint8)
            (err,) = _r(f, "d")
            (track_len,) = _r(f, "Q")
            iids = np.zeros((track_len,), np.int64)
            p2ds = np.zeros((track_len,), np.int64)
            for i in range(track_len):
                iids[i], p2ds[i] = _r(f, "ii")
            points[pid] = Point3D(pid, xyz, rgb, err, iids, p2ds)
    return points


# --------------------------------------------------------------------------
# Text IO
# --------------------------------------------------------------------------


def write_cameras_text(cameras: Dict[int, Camera], path):
    with open(path, "w") as f:
        f.write("# Camera list: CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cam in cameras.values():
            params = " ".join(f"{p:.12g}" for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def write_images_text(images: Dict[int, Image], path):
    with open(path, "w") as f:
        f.write("# Image list: IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        for im in images.values():
            q = " ".join(f"{v:.12g}" for v in im.qvec)
            t = " ".join(f"{v:.12g}" for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            obs = " ".join(
                f"{xy[0]:.6g} {xy[1]:.6g} {int(pid)}"
                for xy, pid in zip(im.xys, im.point3D_ids)
            )
            f.write(obs + "\n")


def write_points3D_text(points3D: Dict[int, Point3D], path):
    with open(path, "w") as f:
        f.write("# 3D point list: POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[]\n")
        for pt in points3D.values():
            xyz = " ".join(f"{v:.12g}" for v in pt.xyz)
            rgb = " ".join(str(int(v)) for v in pt.rgb)
            track = " ".join(
                f"{int(i)} {int(p)}" for i, p in zip(pt.image_ids, pt.point2D_idxs)
            )
            f.write(f"{pt.id} {xyz} {rgb} {pt.error:.6g} {track}\n")


def write_model(cameras, images, points3D, path, ext: str = ".bin"):
    """Write a sparse model directory (reference colmap.py:481)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    if ext == ".bin":
        write_cameras_binary(cameras, path / "cameras.bin")
        write_images_binary(images, path / "images.bin")
        write_points3D_binary(points3D, path / "points3D.bin")
    elif ext == ".txt":
        write_cameras_text(cameras, path / "cameras.txt")
        write_images_text(images, path / "images.txt")
        write_points3D_text(points3D, path / "points3D.txt")
    else:
        raise ValueError(ext)


def read_model(path, ext: str = ".bin"):
    """Read a sparse model directory (reference colmap.py:469)."""
    path = Path(path)
    if ext == ".bin":
        return (
            read_cameras_binary(path / "cameras.bin"),
            read_images_binary(path / "images.bin"),
            read_points3D_binary(path / "points3D.bin"),
        )
    raise ValueError(ext)


# --------------------------------------------------------------------------
# Predictions -> COLMAP model
# --------------------------------------------------------------------------


def predictions_to_colmap(
    pts3d: np.ndarray,
    colors: np.ndarray,
    intrinsics: np.ndarray,
    camera_poses: np.ndarray,
    masks: np.ndarray = None,
    image_names: List[str] = None,
    max_points: int = 200_000,
    shared_camera: bool = False,
):
    """Build a COLMAP model from dense predictions (demo_colmap.py:534
    batch_np_matrix_to_pycolmap_wo_track equivalent — unprojected depth
    points, subsampled, no tracks).

    Args:
        pts3d: (V, H, W, 3) world-frame points.
        colors: (V, H, W, 3) RGB in [0, 1].
        intrinsics: (V, 3, 3); camera_poses: (V, 4, 4) cam2world.
        masks: optional (V, H, W) bool validity.
    """
    v, h, w, _ = pts3d.shape
    cameras, images = {}, {}
    for i in range(v):
        K = intrinsics[i]
        cam_id = 1 if shared_camera else i + 1
        if cam_id not in cameras:
            cameras[cam_id] = Camera(
                cam_id, "PINHOLE", w, h,
                np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]),
            )
        qvec, tvec = c2w_to_colmap_qt(camera_poses[i])
        name = image_names[i] if image_names else f"view_{i:05d}.png"
        images[i + 1] = Image(i + 1, qvec, tvec, cam_id, name)

    if masks is None:
        masks = np.ones(pts3d.shape[:-1], bool)
    pts_flat = pts3d[masks]
    col_flat = (np.clip(colors[masks], 0, 1) * 255).astype(np.uint8)
    if len(pts_flat) > max_points:
        sel = np.random.default_rng(0).choice(
            len(pts_flat), max_points, replace=False
        )
        pts_flat, col_flat = pts_flat[sel], col_flat[sel]

    points3D = {
        j + 1: Point3D(j + 1, pts_flat[j], col_flat[j]) for j in range(len(pts_flat))
    }
    return cameras, images, points3D
