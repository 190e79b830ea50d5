"""Undistortion of WAI scenes (fisheye / radial-tangential -> PINHOLE), without cv2.

Counterpart of ``mapanything_tpu/data_processing/undistort.py`` (:1-283),
after the reference's ``data_processing/wai_processing/scripts/undistort.py``
(:28-279): scenes carrying ``*_distorted`` modalities with an OPENCV_FISHEYE
(k1..k4) or OPENCV (k1, k2, p1, p2[, k3]) camera model are remapped to an
ideal pinhole camera — images bilinearly, depth nearest-neighbour with -1
border (then clamped invalid to 0), masks with a 255-border + threshold —
and scene_meta is rewritten with the new PINHOLE intrinsics and the
distortion parameters removed. After the OPENCV model's ROI crop the
principal point is shifted by the crop offset, as in the JAX package.

The JAX package calls cv2; the port computes what cv2 (5.0) computes there:

- the camera algebra in float64 on the host: the fisheye new camera
  (``estimateNewCameraMatrixForUndistortRectify`` at balance 0: the four edge
  midpoints, at integer half sizes, undistorted by Newton's method on
  theta), the OPENCV model's ``getOptimalNewCameraMatrix(alpha=1)`` (a 9x9
  grid over the image undistorted by cv2's five fixed-point iterations, the
  inscribed and circumscribed rectangles, the inner one rounded to the
  integer ROI), and ``initUndistortRectifyMap`` for both models;
- the maps: the fisheye one as float32 coordinates (``CV_32FC1``), the OPENCV
  one as ``CV_16SC2`` does, each coordinate rounded to 1/32 pixel;
- ``remap`` on ``device`` (CUDA unless the caller names another): bilinear on
  uint8 images, from a 1/32 map with cv2's 15-bit fixed-point weights, from
  a float map in float32 as cv2 5 interpolates it, the border reflected (101)
  or constant; nearest on depth, border -1, as cv2 5 reads either map.

Undistorted images are written as baseline JPEG by the port's own encoder
(``utils/jpeg.encode_jpeg``, quality 95, 4:2:0, as ``cv2.imwrite``), depth as
EXR, masks as PNG. The OPENCV model's new camera matches cv2's where the
distortion is invertible over the image (the fixed-point iteration does not
fold); strongly folding barrel distortion can leave cv2's ROI elsewhere.
"""

from __future__ import annotations

import json
import math
from copy import deepcopy
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mapanything_tpu_torch.data import wai as wai_io
from mapanything_tpu_torch.models.mapanything import resolve_device
from mapanything_tpu_torch.utils.exr import write_depth_exr
from mapanything_tpu_torch.utils.image import read_png, write_png
from mapanything_tpu_torch.utils.jpeg import encode_jpeg

DISTORTION_PARAM_KEYS = ["k1", "k2", "k3", "k4", "p1", "p2"]
INTER_BITS = 5
INTER_TAB_SIZE = 1 << INTER_BITS  # 1/32-pixel positions
COEF_BITS = 15  # fixed-point bilinear weights


class UndistortMaps(NamedTuple):
    """Where each output pixel reads the source: ``xy`` (h, w, 2) float32
    coordinates (a ``CV_32FC1`` pair) or int16 integer parts with ``frac``
    (h, w) 1/32-pixel indices (a ``CV_16SC2`` map)."""

    xy: np.ndarray
    frac: Optional[np.ndarray] = None


# ---------------------------------------------------------------------------
# Camera algebra (host, float64)
# ---------------------------------------------------------------------------


def _fisheye_undistort_points(pts: np.ndarray, K: np.ndarray, D: np.ndarray) -> np.ndarray:
    """cv2.fisheye.undistortPoints (no R, no P): normalised coordinates; a
    point whose Newton iteration does not converge (10 steps, 1e-8) or flips
    sign goes to -1e6."""
    f, c = (K[0, 0], K[1, 1]), (K[0, 2], K[1, 2])
    out = np.empty((len(pts), 2))
    for i, (u, v) in enumerate(pts):
        pw = ((u - c[0]) / f[0], (v - c[1]) / f[1])
        theta_d = min(max(-math.pi / 2, math.hypot(*pw)), math.pi / 2)
        theta, converged, scale = theta_d, True, 0.0
        if abs(theta_d) > 1e-8:
            converged = False
            for _ in range(10):
                t2 = theta * theta
                t4, t6, t8 = t2 * t2, t2 * t2 * t2, t2 * t2 * t2 * t2
                k0, k1, k2, k3 = D[0] * t2, D[1] * t4, D[2] * t6, D[3] * t8
                fix = (theta * (1 + k0 + k1 + k2 + k3) - theta_d) / (1 + 3 * k0 + 5 * k1 + 7 * k2 + 9 * k3)
                theta -= fix
                if abs(fix) < 1e-8:
                    converged = True
                    break
            scale = math.tan(theta) / theta_d
        flipped = (theta_d < 0 < theta) or (theta < 0 < theta_d)
        out[i] = (pw[0] * scale, pw[1] * scale) if converged and not flipped else (-1e6, -1e6)
    return out


def compute_undistort_intrinsic(
    K: np.ndarray,
    width: int,
    height: int,
    distortion_params: np.ndarray,
    center_principal_point: bool = True,
) -> np.ndarray:
    """New pinhole K for fisheye undistortion (reference :27-63): cv2's
    ``fisheye.estimateNewCameraMatrixForUndistortRectify`` at balance 0."""
    assert distortion_params.shape == (4,), "OPENCV_FISHEYE expects k1..k4"
    K = np.asarray(K, np.float64)
    D = np.asarray(distortion_params, np.float64)
    W, H = int(width), int(height)
    w, h = float(W), float(H)
    p = _fisheye_undistort_points([(W // 2, 0), (W, H // 2), (W // 2, H), (0, H // 2)], K, D)
    cn = p.mean(0)
    ar = K[0, 0] / K[1, 1]
    cn[1] *= ar
    p[:, 1] *= ar
    f = max(w * 0.5 / (cn[0] - p[:, 0].min()), w * 0.5 / (p[:, 0].max() - cn[0]),
            h * 0.5 * ar / (cn[1] - p[:, 1].min()), h * 0.5 * ar / (p[:, 1].max() - cn[1]))
    new_K = np.array([[f, 0.0, -cn[0] * f + w * 0.5], [0.0, f / ar, (-cn[1] * f + h * ar * 0.5) / ar], [0, 0, 1]])
    if center_principal_point:
        new_K[0, 2] = width / 2.0
        new_K[1, 2] = height / 2.0
    return new_K.astype(np.float32)


def _undistort_points(pts: np.ndarray, K: np.ndarray, dist: np.ndarray, P: Optional[np.ndarray] = None) -> np.ndarray:
    """cv2.undistortPoints for the OPENCV model with its default five
    fixed-point iterations; through ``P`` (3x3) when given."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    k1, k2, p1, p2, k3 = dist
    x = (pts[:, 0] - cx) * (1.0 / fx)
    y = (pts[:, 1] - cy) * (1.0 / fy)
    x0, y0 = x.copy(), y.copy()
    live = np.ones(len(pts), bool)
    for _ in range(5):
        r2 = x * x + y * y
        icdist = 1.0 / (1 + ((k3 * r2 + k2) * r2 + k1) * r2)
        live &= icdist >= 0  # cv2 stops such a point at its start
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = np.where(live, (x0 - dx) * icdist, x0)
        y = np.where(live, (y0 - dy) * icdist, y0)
    if P is None:
        return np.stack([x, y], -1)
    ww = 1.0 / (P[2, 0] * x + P[2, 1] * y + P[2, 2])
    return np.stack([(P[0, 0] * x + P[0, 1] * y + P[0, 2]) * ww, (P[1, 0] * x + P[1, 1] * y + P[1, 2]) * ww], -1)


def _undistort_rectangles(K, dist, size, P=None):
    """The inscribed and circumscribed rectangles (x, y, w, h) of the
    undistorted image border, from a 9x9 grid over (0..W-1, 0..H-1)."""
    W, H = size
    n = 9
    gy, gx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    pts = np.stack([gx * (W - 1) / (n - 1), gy * (H - 1) / (n - 1)], -1).reshape(-1, 2).astype(np.float64)
    p = _undistort_points(pts, K, dist, P).reshape(n, n, 2)
    ix0, ix1 = p[:, 0, 0].max(), p[:, -1, 0].min()
    iy0, iy1 = p[0, :, 1].max(), p[-1, :, 1].min()
    ox0, ox1, oy0, oy1 = p[..., 0].min(), p[..., 0].max(), p[..., 1].min(), p[..., 1].max()
    return (ix0, iy0, ix1 - ix0, iy1 - iy0), (ox0, oy0, ox1 - ox0, oy1 - oy0)


def optimal_new_camera_matrix(K: np.ndarray, dist: np.ndarray, size: Tuple[int, int]):
    """cv2.getOptimalNewCameraMatrix(K, dist, size, alpha=1, size): the new
    camera (float64) and the valid-pixel ROI (x, y, w, h)."""
    K = np.asarray(K, np.float64)
    dist = np.asarray(dist, np.float64)
    W, H = size
    _, outer = _undistort_rectangles(K, dist, size)
    fx, fy = (W - 1) / outer[2], (H - 1) / outer[3]
    M = np.array([[fx, 0.0, -fx * outer[0]], [0.0, fy, -fy * outer[1]], [0, 0, 1]])
    inner, _ = _undistort_rectangles(K, dist, size, M)
    x, y, w, h = (int(np.rint(v)) for v in inner)
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, W), min(y + h, H)
    roi = (x0, y0, max(x1 - x0, 0), max(y1 - y0, 0)) if x1 > x0 and y1 > y0 else (0, 0, 0, 0)
    return M, roi


def _pixel_rays(new_K: np.ndarray, w: int, h: int):
    """The normalised coordinates (x, y) of every output pixel through the
    inverse of ``new_K`` (no rectification)."""
    iK = np.linalg.inv(np.asarray(new_K, np.float64))
    j = np.arange(w, dtype=np.float64)[None, :]
    i = np.arange(h, dtype=np.float64)[:, None]
    _x = j * iK[0, 0] + (i * iK[0, 1] + iK[0, 2])
    _y = j * iK[1, 0] + (i * iK[1, 1] + iK[1, 2])
    _w = j * iK[2, 0] + (i * iK[2, 1] + iK[2, 2])
    return _x / _w, _y / _w


def fisheye_undistort_maps(K, D, new_K, size) -> UndistortMaps:
    """cv2.fisheye.initUndistortRectifyMap(K, D, I, new_K, size, CV_32FC1)."""
    K, D = np.asarray(K, np.float64), np.asarray(D, np.float64)
    x, y = _pixel_rays(new_K, *size)
    r = np.sqrt(x * x + y * y)
    theta = np.arctan(r)
    t2 = theta * theta
    t4 = t2 * t2
    theta_d = theta * (1 + D[0] * t2 + D[1] * t4 + D[2] * t4 * t2 + D[3] * t4 * t4)
    scale = np.where(r == 0, 1.0, theta_d / np.where(r == 0, 1.0, r))
    u = K[0, 0] * x * scale + K[0, 2]
    v = K[1, 1] * y * scale + K[1, 2]
    return UndistortMaps(np.stack([u, v], -1).astype(np.float32))


def _fixed_point(u: np.ndarray, v: np.ndarray) -> UndistortMaps:
    """Coordinates rounded to 1/32 pixel, split as CV_16SC2 + CV_16UC1."""
    iu = np.rint(np.clip(u * INTER_TAB_SIZE, -2**31, 2**31 - 1)).astype(np.int64)
    iv = np.rint(np.clip(v * INTER_TAB_SIZE, -2**31, 2**31 - 1)).astype(np.int64)
    xy = np.clip(np.stack([iu >> INTER_BITS, iv >> INTER_BITS], -1), -32768, 32767).astype(np.int16)
    frac = ((iv & (INTER_TAB_SIZE - 1)) * INTER_TAB_SIZE + (iu & (INTER_TAB_SIZE - 1))).astype(np.uint16)
    return UndistortMaps(xy, frac)


def opencv_undistort_maps(K, dist, new_K, size) -> UndistortMaps:
    """cv2.initUndistortRectifyMap(K, dist, None, new_K, size, CV_16SC2)."""
    K = np.asarray(K, np.float64)
    k1, k2, p1, p2, k3 = np.asarray(dist, np.float64)
    x, y = _pixel_rays(new_K, *size)
    x2, y2 = x * x, y * y
    r2, _2xy = x2 + y2, 2 * x * y
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    u = K[0, 0] * (x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)) + K[0, 2]
    v = K[1, 1] * (y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy) + K[1, 2]
    return _fixed_point(u, v)


def update_camera_meta(cam_meta: Dict, new_K: np.ndarray, new_width: int, new_height: int) -> Dict:
    """PINHOLE camera dict with distortion keys dropped (reference :66-98)."""
    new_meta = deepcopy(cam_meta)
    new_meta["w"] = int(new_width)
    new_meta["h"] = int(new_height)
    new_meta["fl_x"] = float(new_K[0, 0])
    new_meta["fl_y"] = float(new_K[1, 1])
    new_meta["cx"] = float(new_K[0, 2])
    new_meta["cy"] = float(new_K[1, 2])
    new_meta["camera_model"] = "PINHOLE"
    for key in DISTORTION_PARAM_KEYS:
        new_meta.pop(key, None)
    return new_meta


def undistort_precompute(cam_meta: Dict, center_principal_point: bool = True):
    """Remap tables + new intrinsics for one camera (reference :101-149).

    Returns (new_K, new_w, new_h, maps, roi); roi is None for fisheye (no
    crop) and (x, y, w, h) for the OPENCV model.
    """
    K = np.array([[cam_meta["fl_x"], 0, cam_meta["cx"]], [0, cam_meta["fl_y"], cam_meta["cy"]], [0, 0, 1]],
                 np.float32)
    w, h = int(cam_meta["w"]), int(cam_meta["h"])
    model = cam_meta.get("camera_model", "PINHOLE")

    if model == "OPENCV_FISHEYE":
        dist = np.array([cam_meta.get(c, 0.0) for c in ["k1", "k2", "k3", "k4"]], np.float32)
        new_K = compute_undistort_intrinsic(K, w, h, dist, center_principal_point=center_principal_point)
        return new_K, w, h, fisheye_undistort_maps(K, dist, new_K, (w, h)), None
    if model == "OPENCV":
        dist = np.array([cam_meta.get(c, 0.0) for c in ["k1", "k2", "p1", "p2", "k3"]], np.float32)
        new_K, roi = optimal_new_camera_matrix(K, dist, (w, h))
        maps = opencv_undistort_maps(K, dist, new_K, (w, h))
        x, y, new_w, new_h = roi
        # Shift the principal point into the cropped frame.
        new_K = new_K.astype(np.float32).copy()
        new_K[0, 2] -= x
        new_K[1, 2] -= y
        return new_K, new_w, new_h, maps, roi
    raise NotImplementedError(f"camera model not supported: {model}")


# ---------------------------------------------------------------------------
# remap (on the device)
# ---------------------------------------------------------------------------


def bilinear_weight_table() -> np.ndarray:
    """cv2's (1024, 4) int32 bilinear weights of the 1/32-pixel positions
    (ty * 32 + tx), in 15-bit fixed point (``initInterTab2D``): the float
    products (1 - x)(1 - y) ... are multiples of 2^-10, so they round exactly
    and each row sums to 32768."""
    t = np.arange(INTER_TAB_SIZE, dtype=np.int64)
    lin = np.stack([INTER_TAB_SIZE - t, t], -1)  # (32, 2): weights in 1/32
    w = lin[:, None, :, None] * lin[None, :, None, :]  # (ty, tx, ky, kx) in 1/1024
    return (w.reshape(-1, 4) << (COEF_BITS - 2 * INTER_BITS)).astype(np.int32)


def _reflect101(p: torch.Tensor, n: int) -> torch.Tensor:
    """cv2.borderInterpolate(BORDER_REFLECT_101) of int64 positions."""
    if n == 1:
        return torch.zeros_like(p)
    period = 2 * n - 2
    p = torch.remainder(p, period)
    return torch.where(p >= n, period - p, p)


def _taps(src: torch.Tensor, x: torch.Tensor, y: torch.Tensor, border: str, border_value: int) -> torch.Tensor:
    """src (H, W, C) at integer positions (h, w): reflected (101) or, outside
    the image, cv2's scalar border (``border_value`` in channel 0, 0 in the
    others)."""
    H, W, C = src.shape
    flat = src.reshape(H * W, C)
    if border == "reflect101":
        return flat[_reflect101(y, H) * W + _reflect101(x, W)]
    inside = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    vals = flat[torch.where(inside, y * W + x, torch.zeros_like(x))]
    fill = torch.zeros(C, dtype=src.dtype, device=src.device)
    fill[0] = border_value
    return torch.where(inside[..., None], vals, fill)


def remap_bilinear(img: np.ndarray, maps: UndistortMaps, border: str = "reflect101", border_value: int = 0,
                   device: Union[str, torch.device, None] = None) -> np.ndarray:
    """cv2.remap(img, maps, INTER_LINEAR) of a uint8 (H, W[, C]) image with
    BORDER_REFLECT_101 (``border="reflect101"``) or BORDER_CONSTANT. A 1/32
    map takes cv2's 15-bit fixed-point weights; a float map is interpolated in
    float32 (two lerps along x, one along y, rounded half to even), as cv2 5
    does."""
    device = resolve_device(device)
    with torch.inference_mode():
        src = torch.from_numpy(np.ascontiguousarray(img)).to(device)
        squeeze = src.ndim == 2
        if squeeze:
            src = src[..., None]
        if maps.frac is None:
            xy = torch.from_numpy(maps.xy).to(device)
            x0f, y0f = torch.floor(xy[..., 0]), torch.floor(xy[..., 1])
            a, b = (xy[..., 0] - x0f)[..., None], (xy[..., 1] - y0f)[..., None]
            x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
            p = [_taps(src, x0 + dx, y0 + dy, border, border_value).to(torch.float32)
                 for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1))]
            v0 = p[0] + a * (p[1] - p[0])
            v1 = p[2] + a * (p[3] - p[2])
            out = torch.clamp(torch.round(v0 + b * (v1 - v0)), 0, 255)
        else:
            xy = torch.from_numpy(maps.xy.astype(np.int64)).to(device)
            frac = torch.from_numpy(maps.frac.astype(np.int64)).to(device)
            wts = torch.from_numpy(bilinear_weight_table()).to(device)[frac]  # (h, w, 4)
            acc = 0
            for k, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
                vals = _taps(src, xy[..., 0] + dx, xy[..., 1] + dy, border, border_value).to(torch.int32)
                acc = acc + vals * wts[..., k, None]
            out = torch.clamp((acc + (1 << (COEF_BITS - 1))) >> COEF_BITS, 0, 255)
        out = out.to(torch.uint8).cpu().numpy()
    return out[..., 0] if squeeze else out


def remap_nearest(values: np.ndarray, maps: UndistortMaps, border_value: float = -1.0,
                  device: Union[str, torch.device, None] = None) -> np.ndarray:
    """cv2.remap(values, maps, INTER_NEAREST, BORDER_CONSTANT) of a float32
    (H, W) map. A float map is rounded (half to even); a 1/32 map reads its
    integer part plus one on each axis whose fraction is below one half (what
    cv2 5's ``NNDeltaTab`` gives)."""
    device = resolve_device(device)
    with torch.inference_mode():
        src = torch.from_numpy(np.ascontiguousarray(values, np.float32)).to(device)
        H, W = src.shape
        if maps.frac is None:
            xy = torch.from_numpy(maps.xy).to(device)
            xy = torch.clamp(torch.round(xy), -32768, 32767).to(torch.int64)
            x, y = xy[..., 0], xy[..., 1]
        else:
            xy = torch.from_numpy(maps.xy.astype(np.int64)).to(device)
            frac = torch.from_numpy(maps.frac.astype(np.int64)).to(device)
            x = xy[..., 0] + ((frac & (INTER_TAB_SIZE - 1)) < INTER_TAB_SIZE // 2).to(torch.int64)
            y = xy[..., 1] + ((frac >> INTER_BITS) < INTER_TAB_SIZE // 2).to(torch.int64)
        inside = (x >= 0) & (x < W) & (y >= 0) & (y < H)
        out = src.reshape(-1)[torch.where(inside, y * W + x, torch.zeros_like(x))]
        return torch.where(inside, out, torch.full_like(out, float(border_value))).cpu().numpy()


def _crop(out: np.ndarray, roi) -> np.ndarray:
    if roi is None:
        return out
    x, y, w, h = roi
    return out[y:y + h, x:x + w]


def undistort_image(img: np.ndarray, maps: UndistortMaps, roi: Optional[Tuple[int, int, int, int]],
                    device: Union[str, torch.device, None] = None) -> np.ndarray:
    """Bilinear remap with reflect border + optional ROI crop."""
    return _crop(remap_bilinear(img, maps, "reflect101", device=device), roi)


def undistort_depth(depth: np.ndarray, maps: UndistortMaps, roi: Optional[Tuple[int, int, int, int]],
                    device: Union[str, torch.device, None] = None) -> np.ndarray:
    """Nearest remap; out-of-source pixels become 0 (invalid depth)."""
    out = remap_nearest(depth, maps, -1.0, device=device)
    out[out < 0] = 0.0
    return _crop(out, roi)


def undistort_mask(mask: np.ndarray, maps: UndistortMaps, roi: Optional[Tuple[int, int, int, int]],
                   device: Union[str, torch.device, None] = None) -> np.ndarray:
    """Binary-mask remap (reference :200-215): all-valid shortcut, else
    bilinear with a 255 border and any interpolated pixel < 255 -> 0."""
    if np.all(mask > 0):
        out = np.full(maps.xy.shape[:2], 255, np.uint8)
    else:
        out = remap_bilinear(mask.astype(np.uint8), maps, "constant", 255, device=device)
        out[out < 255] = 0
    return _crop(out, roi)


def undistort_scene(
    scene_root,
    modalities: Sequence[str] = ("image_distorted", "depth_distorted"),
    center_principal_point: bool = True,
    device: Union[str, torch.device, None] = None,
) -> List[str]:
    """Undistort every ``*_distorted`` modality of a WAI scene in place.

    Each ``foo_distorted`` frame entry is replaced by ``foo`` pointing at
    the undistorted file (images as .jpg, depth as .exr), and the camera
    parameters (shared or per-frame) become PINHOLE. Returns the list of
    processed frame names. The remaps run on ``device``, CUDA unless given.
    """
    device = resolve_device(device)
    scene_root = Path(scene_root)
    meta = wai_io.load_scene_meta(scene_root)
    shared = bool(meta.get("shared_intrinsics", "fl_x" in meta))

    for m in modalities:
        if not m.endswith("_distorted"):
            raise ValueError(f"only '*_distorted' modalities supported: {m}")

    cam_keys = ("w", "h", "fl_x", "fl_y", "cx", "cy", "camera_model")
    if shared:
        tables = undistort_precompute(meta, center_principal_point)
        for key in DISTORTION_PARAM_KEYS:
            meta.pop(key, None)
        new_cam = update_camera_meta(meta, *tables[:3])
        meta.update({k: new_cam[k] for k in cam_keys})

    done = []
    for frame in meta["frames"]:
        if not shared:
            cam = dict(frame)
            cam.setdefault("camera_model", meta.get("camera_model", "PINHOLE"))
            tables = undistort_precompute(cam, center_principal_point)
            new_cam = update_camera_meta(cam, *tables[:3])
            for key in DISTORTION_PARAM_KEYS:
                frame.pop(key, None)
            frame.update({k: new_cam[k] for k in cam_keys})
        maps, roi = tables[3], tables[4]

        for mod in modalities:
            if mod not in frame:
                continue
            src = scene_root / frame[mod]
            base = mod.replace("_distorted", "")
            if base == "image":
                out = undistort_image(wai_io.load_image(src, as_float=False), maps, roi, device)
                dst_rel = str(Path(frame[mod].replace("_distorted", "")).with_suffix(".jpg"))
                dst = scene_root / dst_rel
                dst.parent.mkdir(parents=True, exist_ok=True)
                dst.write_bytes(encode_jpeg(out))
            elif "mask" in base:
                out = undistort_mask(read_png(src, unchanged=True), maps, roi, device)
                dst_rel = frame[mod].replace("_distorted", "")
                dst = scene_root / dst_rel
                dst.parent.mkdir(parents=True, exist_ok=True)
                write_png(dst, out)
            else:  # depth and other float maps
                out = undistort_depth(wai_io.load_depth(src), maps, roi, device)
                dst_rel = str(Path(frame[mod].replace("_distorted", "")).with_suffix(".exr"))
                dst = scene_root / dst_rel
                dst.parent.mkdir(parents=True, exist_ok=True)
                write_depth_exr(dst, out)
            frame[base] = dst_rel
            del frame[mod]
        done.append(frame["frame_name"])

    fm = meta.get("frame_modalities", {})
    for mod in modalities:
        base = mod.replace("_distorted", "")
        if mod in fm:
            entry = fm.pop(mod)
            if isinstance(entry, dict) and "frame_key" in entry:
                entry["frame_key"] = base
            fm[base] = entry
        elif base not in fm:
            fm[base] = {"frame_key": base, "format": "image" if base == "image" else "depth"}
    meta["frame_modalities"] = fm

    with open(scene_root / "scene_meta.json", "w") as f:
        json.dump(meta, f, indent=2)
    return done
