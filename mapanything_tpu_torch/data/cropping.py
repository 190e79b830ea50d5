"""Image crop and rescale with intrinsics bookkeeping, on the caller's device.

Counterpart of ``mapanything_tpu/data/cropping.py`` (:17-155), which resizes
with cv2. The port computes cv2's resize itself: each axis gets a weight matrix
(output pixels by input pixels, built in float64 on the host), and the image is
two products with them on the image's device, in float64: TF32, where it is
switched on for fp32 products, cannot touch them, and the card gives the CPU's
result.

- ``INTER_LANCZOS4`` (down-scaling): the 8 source pixels around each output
  pixel's centre, weighted by the a = 4 Lanczos window of their distance in
  source pixels, not widened by the scale (cv2 does not antialias), each row
  of weights normalised to sum 1.
- ``INTER_CUBIC`` (scale >= 1): Keys' cubic with A = -0.75.
- Both take the centre of output pixel x from (x + 0.5) · in / out - 0.5,
  rounded to float32 as cv2 does, and repeat the border pixel for taps outside
  the image.
- uint8 images round and clamp once after the products; cv2 rounds its
  fixed-point sums instead, so a grey level may differ by one.
- ``INTER_NEAREST`` (depth and the extras) reads src = floor(dst · in / out),
  with no half-pixel offset, exactly as cv2 does.
- The matrices and indices depend on the sizes alone, so each is built once
  for each (input size, output size, interpolation, device) and kept: the
  views of one folder share them.

Sizes are Python floats and ints as in the JAX package (``round`` is
half-to-even). The intrinsics stay numpy arrays on the host and go through
the JAX package's own numpy operations in the caller's dtype: the crop box
rounds differences of them, so doing this in fp32 on the device could move
a crop by a pixel.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

INTER_NEAREST, INTER_CUBIC, INTER_LANCZOS4 = "nearest", "cubic", "lanczos4"


def opencv_to_colmap_intrinsics(K: np.ndarray) -> np.ndarray:
    K = K.copy()
    K[:2, 2] += 0.5
    return K


def colmap_to_opencv_intrinsics(K: np.ndarray) -> np.ndarray:
    K = K.copy()
    K[:2, 2] -= 0.5
    return K


def resize_weights(n_in: int, n_out: int, interpolation: str) -> np.ndarray:
    """The (n_out, n_in) float64 matrix of one axis of cv2's resize."""
    scale = 1.0 / (n_out / n_in)  # cv2: 1 / inv_scale, in double
    centre = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    first = np.floor(centre)
    fx = (centre - first).astype(np.float64)  # cv2's fractional offset, a float32
    if interpolation == INTER_LANCZOS4:
        offsets = np.arange(-3, 5)
        d = fx[:, None] - offsets[None, :]
        w = np.sinc(d) * np.sinc(d / 4.0)
        w /= w.sum(axis=1, keepdims=True)
    elif interpolation == INTER_CUBIC:
        a, x = -0.75, fx
        w0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
        w1 = ((a + 2) * x - (a + 3)) * x * x + 1
        w2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
        w = np.stack([w0, w1, w2, 1.0 - w0 - w1 - w2], axis=1)
        offsets = np.arange(-1, 3)
    else:
        raise ValueError(interpolation)
    index = np.clip(first.astype(np.int64)[:, None] + offsets[None, :], 0, n_in - 1)  # the border repeats
    out = np.zeros((n_out, n_in), np.float64)
    np.add.at(out, (np.repeat(np.arange(n_out), len(offsets)), index.ravel()), w.ravel())
    return out


def nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """cv2's INTER_NEAREST source index of each output pixel of one axis."""
    ifx = 1.0 / (n_out / n_in)
    return np.minimum(np.floor(np.arange(n_out) * ifx).astype(np.int64), n_in - 1)


@functools.lru_cache(maxsize=64)
def _axis_operator(n_in: int, n_out: int, interpolation: str, device: torch.device) -> torch.Tensor:
    """One axis' weight matrix (or, for nearest, its source index) on ``device``,
    built once for each key. The tensors are shared: nothing writes to them."""
    if interpolation == INTER_NEAREST:
        return torch.from_numpy(nearest_index(n_in, n_out)).to(device)
    return torch.from_numpy(resize_weights(n_in, n_out, interpolation)).to(device)


def resize(image: torch.Tensor, size: Tuple[int, int], interpolation: str) -> torch.Tensor:
    """cv2.resize of an (H, W) or (H, W, C) tensor to ``size`` = (width, height),
    on the tensor's device, computed in float64 and returned in the tensor's dtype
    (uint8 rounded and clamped)."""
    new_w, new_h = int(size[0]), int(size[1])
    h, w = image.shape[:2]
    wy = _axis_operator(h, new_h, interpolation, image.device)
    wx = _axis_operator(w, new_w, interpolation, image.device)
    if interpolation == INTER_NEAREST:
        return image.index_select(0, wy).index_select(1, wx)
    flat = image.to(torch.float64).reshape(h, w, -1)
    out = torch.einsum("oh,hwc->owc", wy, flat)
    out = torch.einsum("pw,owc->opc", wx, out).reshape((new_h, new_w) + tuple(image.shape[2:]))
    if image.dtype == torch.uint8:
        return out.round_().clamp_(0, 255).to(torch.uint8)
    return out.to(image.dtype)


def rescale_image_and_info(
    image: torch.Tensor,
    output_resolution: Tuple[int, int],
    depthmap: Optional[torch.Tensor] = None,
    intrinsics: Optional[np.ndarray] = None,
    nearest_extras: Optional[Dict[str, torch.Tensor]] = None,
    force: bool = True,
):
    """Scale so the image just covers ``output_resolution`` (width, height):
    scale = max(out_w / w, out_h / h) (1 when it would upscale, unless
    ``force``), Lanczos down, cubic up, nearest for depth and the extras (cast
    to float32 and back), intrinsics scaled in the COLMAP convention."""
    h, w = image.shape[:2]
    out_w, out_h = int(output_resolution[0]), int(output_resolution[1])
    scale = max(out_w / w, out_h / h)
    if scale >= 1.0 and not force:
        scale = 1.0
    new_w, new_h = round(w * scale), round(h * scale)

    image = resize(image, (new_w, new_h), INTER_LANCZOS4 if scale < 1.0 else INTER_CUBIC)
    if depthmap is not None:
        depthmap = resize(depthmap, (new_w, new_h), INTER_NEAREST)
    if nearest_extras is not None:
        nearest_extras = {
            k: resize(v.to(torch.float32), (new_w, new_h), INTER_NEAREST).to(v.dtype) for k, v in nearest_extras.items()
        }
    if intrinsics is not None:
        K = opencv_to_colmap_intrinsics(intrinsics)
        K[0, :] *= new_w / w
        K[1, :] *= new_h / h
        intrinsics = colmap_to_opencv_intrinsics(K)
    return image, depthmap, intrinsics, nearest_extras


def camera_matrix_of_crop(
    input_camera_matrix: np.ndarray,
    input_resolution,
    output_resolution,
    offset_factor: float = 0.5,
) -> np.ndarray:
    """Intrinsics of a centred crop (the reference's cropping.py:283)."""
    margins = np.asarray(input_resolution, np.float64) - np.asarray(output_resolution)
    assert np.all(margins >= 0.0), (input_resolution, output_resolution)
    offset = offset_factor * margins
    K = opencv_to_colmap_intrinsics(input_camera_matrix)
    K[:2, 2] -= offset
    return colmap_to_opencv_intrinsics(K)


def bbox_from_intrinsics_in_out(
    input_camera_matrix, output_camera_matrix, output_resolution
) -> Tuple[int, int, int, int]:
    """The crop box that the change of intrinsics implies (cropping.py:363)."""
    out_w, out_h = output_resolution
    l = int(round(input_camera_matrix[0, 2] - output_camera_matrix[0, 2]))  # noqa: E741
    t = int(round(input_camera_matrix[1, 2] - output_camera_matrix[1, 2]))
    return (l, t, l + out_w, t + out_h)


def crop_image_and_info(
    image: torch.Tensor,
    crop_bbox: Tuple[int, int, int, int],
    depthmap: Optional[torch.Tensor] = None,
    intrinsics: Optional[np.ndarray] = None,
    nearest_extras: Optional[Dict[str, torch.Tensor]] = None,
):
    """Crop the image, depth and extras, and shift the principal point (cropping.py:320)."""
    l, t, r, b = crop_bbox  # noqa: E741
    image = image[t:b, l:r]
    if depthmap is not None:
        depthmap = depthmap[t:b, l:r]
    if nearest_extras is not None:
        nearest_extras = {k: v[t:b, l:r] for k, v in nearest_extras.items()}
    if intrinsics is not None:
        K = intrinsics.copy()
        K[0, 2] -= l
        K[1, 2] -= t
        intrinsics = K
    return image, depthmap, intrinsics, nearest_extras


def crop_resize_if_necessary(
    image: torch.Tensor,
    resolution: Tuple[int, int],
    depthmap: Optional[torch.Tensor] = None,
    intrinsics: Optional[np.ndarray] = None,
    nearest_extras: Optional[Dict[str, torch.Tensor]] = None,
    principal_point_centered: bool = False,
    rng: Optional[np.random.Generator] = None,
    aug_crop: int = 0,
):
    """The whole crop/resize (the reference's BaseDataset._crop_resize_if_necessary):
    an optional crop centred on the principal point, the rescale (larger by a
    draw from ``rng`` below ``aug_crop`` when given), then the final crop with
    its intrinsics. Images, depth and extras are tensors and stay on their
    device; the intrinsics are numpy."""
    h, w = image.shape[:2]
    if principal_point_centered and intrinsics is not None:
        cx, cy = int(round(intrinsics[0, 2])), int(round(intrinsics[1, 2]))
        if 0 <= cx < w and 0 <= cy < h:
            mx, my = min(cx, w - cx), min(cy, h - cy)
            if 2 * mx > resolution[0] and 2 * my > resolution[1]:
                image, depthmap, intrinsics, nearest_extras = crop_image_and_info(
                    image, (cx - mx, cy - my, cx + mx, cy + my), depthmap, intrinsics, nearest_extras,
                )

    target = np.asarray(resolution)
    if aug_crop > 1 and rng is not None:
        target = target + rng.integers(0, aug_crop)
    image, depthmap, intrinsics, nearest_extras = rescale_image_and_info(
        image, target, depthmap, intrinsics, nearest_extras
    )

    new_K = camera_matrix_of_crop(intrinsics, (image.shape[1], image.shape[0]), resolution)
    bbox = bbox_from_intrinsics_in_out(intrinsics, new_K, resolution)
    image, depthmap, _, nearest_extras = crop_image_and_info(image, bbox, depthmap, None, nearest_extras)
    return image, depthmap, new_K, nearest_extras
