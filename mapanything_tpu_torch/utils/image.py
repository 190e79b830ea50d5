"""Image loading with aspect-ratio bucketing, and the port's PNG reader.

Counterpart of ``mapanything_tpu/utils/image.py`` (:20-193):
``RESOLUTION_MAPPINGS``, ``find_closest_aspect_ratio``, ``rgb``, ``_fake_K``
and ``load_images`` with its three resize modes and ``stride``. The images are
decoded on the host, then cropped and resized (``data.cropping``) and
normalised on ``device``: CUDA unless the caller passes another.

The JAX package decodes with cv2. The port reads PNG itself, with ``zlib`` and
numpy (``read_png``), and JPEG with ``utils/jpeg.py``, and gives what
``cv2.imread(path, IMREAD_COLOR)`` then BGR -> RGB gives: alpha dropped (not
composited), 16-bit samples cut to their high byte, grey and palette images
expanded to three channels. ``read_png(path, unchanged=True)`` keeps the
samples as stored (16-bit grey depth maps as uint16), as ``IMREAD_UNCHANGED``.
The formats left (BMP, WebP, TIFF, Bayer captures, HEIF) import cv2 (HEIF:
pillow-heif) only when such a file is given, and raise ``ImportError``
without it; ``load_images`` also takes decoded uint8 (H, W, 3) arrays.
``write_png`` writes the files that the tests and the smoke script read,
8-bit, or 16-bit grey.
"""

from __future__ import annotations

import importlib.util
import struct
import zlib
from pathlib import Path
from typing import Sequence, Union

import numpy as np
import torch

from mapanything_tpu_torch.data.cropping import crop_resize_if_necessary
from mapanything_tpu_torch.models.encoders.normalizations import IMAGE_NORMALIZATION_DICT
from mapanything_tpu_torch.models.mapanything import resolve_device
from mapanything_tpu_torch.utils.jpeg import read_jpeg

RESOLUTION_MAPPINGS = {
    518: {
        1.000: (518, 518),
        1.321: (518, 392),
        1.542: (518, 336),
        1.762: (518, 294),
        2.056: (518, 252),
        3.083: (518, 168),
        0.757: (392, 518),
        0.649: (336, 518),
        0.567: (294, 518),
        0.486: (252, 518),
    },
    512: {
        1.000: (512, 512),
        1.333: (512, 384),
        1.524: (512, 336),
        1.778: (512, 288),
        2.000: (512, 256),
        3.200: (512, 160),
        0.750: (384, 512),
        0.656: (336, 512),
        0.562: (288, 512),
        0.500: (256, 512),
    },
}

IMG_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif", ".tiff"}
HEIF_EXTENSIONS = {".heic", ".heif"}


def find_closest_aspect_ratio(aspect_ratio: float, resolution_set: int = 518):
    """The bucket (width, height) closest to an aspect ratio."""
    mapping = RESOLUTION_MAPPINGS[resolution_set]
    key = min(mapping.keys(), key=lambda x: abs(x - aspect_ratio))
    return mapping[key]


def rgb(img, norm_type: str = "dinov2", true_shape=None) -> torch.Tensor:
    """Denormalise an image (tensor or array, (..., H, W, 3)) to [0, 1] RGB, as a tensor."""
    img = torch.as_tensor(img)
    if true_shape is not None:
        h, w = true_shape
        img = img[..., :h, :w, :]
    if img.dtype == torch.uint8:
        return img.float() / 255.0
    if norm_type in IMAGE_NORMALIZATION_DICT:
        norm = IMAGE_NORMALIZATION_DICT[norm_type]
        img = img * img.new_tensor(norm.std) + img.new_tensor(norm.mean)
    return img.clamp(0.0, 1.0)


# --------------------------------------------------------------------------
# PNG
# --------------------------------------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # grey, RGB, palette, grey + alpha, RGBA


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(types: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the scanline filters: ``rows`` (H, row bytes) filtered, ``bpp`` bytes a
    pixel (at least 1). Rows of None, Sub and Up are undone a row at a time, each
    whole. Average and Paeth need every pixel's left neighbour undone first, so an
    image with them is undone along anti-diagonals of pixels, each diagonal at once:
    a pixel depends only on its left, upper and upper-left neighbours. The pixels are
    stored skewed, a diagonal a row, so that a diagonal and its neighbours are slices."""
    h, n = rows.shape
    if np.any(types > 4):
        raise ValueError(f"PNG: unknown filter type {int(types.max())}")
    if np.all(types <= 2):
        out = np.empty_like(rows)
        prior = np.zeros(n, np.uint8)
        for r in range(h):
            row = rows[r]
            if types[r] == 1:
                row = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
            elif types[r] == 2:
                row = row + prior
            out[r] = prior = row
        return out
    w = n // bpp
    r_idx, c_idx = np.mgrid[0:h, 0:w]
    # x[r + c + 2, r + 1] holds pixel (r, c); every other slot stays zero, so the
    # neighbours of the first row and column (outside the image) read zero.
    f = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    f[r_idx + c_idx + 2, r_idx + 1] = rows.reshape(h, w, bpp)
    x = np.zeros_like(f)
    kind = np.zeros(h + 1, np.int16)
    kind[1:] = types
    onehot = np.stack([kind == k for k in range(5)], 1)[:, :, None].astype(np.int16)  # (H + 1, 5, 1)
    for d in range(2, h + w + 1):
        lo, hi = max(1, d - w), min(h, d - 1) + 1  # rows r + 1 of the diagonal
        a, b, c = x[d - 1, lo:hi], x[d - 1, lo - 1:hi - 1], x[d - 2, lo - 1:hi - 1]  # left, up, up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        k = onehot[lo:hi]
        x[d, lo:hi] = (f[d, lo:hi] + k[:, 1] * a + k[:, 2] * b + k[:, 3] * ((a + b) >> 1) + k[:, 4] * paeth) & 255
    return x[r_idx + c_idx + 2, r_idx + 1].astype(np.uint8).reshape(h, n)


def read_png(path, unchanged: bool = False) -> np.ndarray:
    """A PNG file as uint8 (H, W, 3) RGB, as cv2.imread(IMREAD_COLOR) + BGR2RGB
    gives it: 1-16 bit grey, grey + alpha, RGB, RGBA and palette images, every
    scanline filter; interlaced files raise.

    ``unchanged``: the samples as stored, as cv2.imread(IMREAD_UNCHANGED) keeps
    them: grey as (H, W) uint8 or uint16 (1, 2 and 4-bit grey scaled to 8 bits),
    other colour types as (H, W, C) uint8 or uint16, the channels in the file's
    RGB(A) order (cv2 gives BGR(A)), palette images expanded to RGB."""
    data = Path(path).read_bytes()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, palette, header = 8, [], None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC in the {kind!r} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNG files are not supported")
    if color not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"{path}: colour type {color} at bit depth {depth} is not a PNG format")
    channels = _CHANNELS[color]
    bits = channels * depth
    row_bytes = (width * bits + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (row_bytes + 1):
        raise ValueError(f"{path}: truncated image data")
    raw = raw[:height * (row_bytes + 1)].reshape(height, row_bytes + 1)
    rows = _unfilter(raw[:, 0], raw[:, 1:], max(1, bits // 8))

    if depth == 16 and unchanged:
        samples = rows.view(">u2").astype(np.uint16)
    elif depth == 16:  # cv2 (libpng's strip_16) keeps the high byte
        samples = rows[:, 0::2]
    elif depth < 8:
        samples = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
        samples = (samples * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1, dtype=np.uint8)
    else:
        samples = rows
    samples = samples[:, :width * channels].reshape(height, width, channels)
    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without a PLTE chunk")
        return palette[samples[..., 0]]
    if color in (0, 4):
        grey = samples[..., 0]
        if depth < 8:  # libpng scales 1, 2 and 4-bit grey to 8 bits
            grey = grey * np.uint8(255 // ((1 << depth) - 1))
        if unchanged:
            return np.ascontiguousarray(grey) if color == 0 else np.stack([grey, samples[..., 1]], axis=-1)
        return np.repeat(grey[..., None], 3, axis=-1)
    return np.ascontiguousarray(samples if unchanged else samples[..., :3])


def write_png(path, image: np.ndarray, filters: Sequence[int] = (0, 1, 2, 3, 4), level: int = 6) -> Path:
    """Write uint8 (H, W), (H, W, 3) or (H, W, 4) as an 8-bit PNG, or uint16 (H, W)
    as 16-bit grey (depth in millimetres, as WAI stores it); row r takes scanline
    filter ``filters[r % len(filters)]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    image = np.asarray(image)
    if image.dtype == np.uint16:
        if image.ndim != 2:
            raise ValueError(f"16-bit PNG: expected (H, W) grey, got {image.shape}")
        img, depth, color = np.ascontiguousarray(image, ">u2").view(np.uint8), 16, 0  # (H, 2W) big-endian bytes
        bpp = 2
    else:
        img, depth = np.ascontiguousarray(image, np.uint8), 8
        color = {2: 0, 3: {1: 0, 3: 2, 4: 6}[img.shape[-1]] if img.ndim == 3 else 0}[img.ndim]
        bpp = 1 if img.ndim == 2 else img.shape[2]
    h, w = image.shape[:2]
    x = img.reshape(h, w * bpp).astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    up_left = np.zeros_like(x)
    up_left[1:, bpp:] = x[:-1, :-bpp]
    preds = [np.zeros_like(x), left, up, (left + up) >> 1, _paeth(left, up, up_left)]
    kinds = np.asarray([filters[r % len(filters)] for r in range(h)], np.uint8)
    out = np.empty((h, w * bpp + 1), np.uint8)
    out[:, 0] = kinds
    for k in np.unique(kinds):
        sel = kinds == k
        out[sel, 1:] = ((x[sel] - preds[k][sel]) & 255).astype(np.uint8)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    path = Path(path)
    path.write_bytes(_PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(out.tobytes(), level)) + chunk(b"IEND", b""))
    return path


# --------------------------------------------------------------------------
# Other formats, through optional packages
# --------------------------------------------------------------------------


def _needs(module: str, what: str):
    """Import an optional decoder, or raise naming the format."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"{what} needs the {module!r} package, which is not installed here; the port reads PNG "
            "and JPEG itself, not BMP, WebP, TIFF, Bayer captures or HEIF: convert the images to PNG, "
            "or decode them elsewhere and pass the uint8 (H, W, 3) arrays to load_images"
        ) from e


def _read_image(path, bayer_format: bool = False) -> np.ndarray:
    """One image file as RGB uint8 (H, W, 3), as the JAX package reads it."""
    path = str(path)
    suffix = Path(path).suffix.lower()
    if suffix in HEIF_EXTENSIONS:
        pillow_heif = _needs("pillow_heif", f"{path}: HEIF")
        pillow_heif.register_heif_opener()
        from PIL import Image, ImageOps

        return np.asarray(ImageOps.exif_transpose(Image.open(path)).convert("RGB"))
    if suffix == ".png" and not bayer_format:
        return read_png(path)
    if suffix in (".jpg", ".jpeg") and not bayer_format:
        return read_jpeg(path)
    cv2 = _needs("cv2", f"{path}: {'a Bayer capture' if bayer_format else suffix.lstrip('.').upper()}")
    if bayer_format:
        raw = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if raw is None:
            raise FileNotFoundError(path)
        # As the reference (and the JAX package): BAYER_RG2BGR's output is taken as RGB.
        return cv2.cvtColor(raw, cv2.COLOR_BAYER_RG2BGR)
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _heif_support() -> bool:
    return importlib.util.find_spec("pillow_heif") is not None


def load_images(
    folder_or_list: Union[str, Path, Sequence],
    resolution_set: int = 518,
    norm_type: str = "dinov2",
    resize_mode: str = "fixed_mapping",
    size: int = None,
    bayer_format: bool = False,
    stride: int = 1,
    device: Union[str, torch.device, None] = None,
) -> dict:
    """Load a folder (or a list of files or uint8 (H, W, 3) arrays) and resize
    every view to the bucket of the first one.

    Resize modes: "fixed_mapping" (the closest aspect-ratio bucket of
    ``resolution_set``), "longest_side" (the long side to ``size``, both sides
    multiples of 14) and "square" (``size`` x ``size``, centre crop).
    ``stride`` keeps every n-th image.

    Returns a dict: ``images`` (V, H, W, 3) float32 normalised and
    ``images_no_norm`` in [0, 1], both on ``device``; ``true_shape`` (V, 2)
    int32 on ``device``, each image's shape before resizing; ``paths`` (for an
    array, ``"array_<i>"``) and ``data_norm_type``.
    """
    device = resolve_device(device)
    extensions = IMG_EXTENSIONS | (HEIF_EXTENSIONS if _heif_support() else set())
    if isinstance(folder_or_list, (str, Path)):
        items = sorted(p for p in Path(folder_or_list).iterdir() if p.suffix.lower() in extensions)
    else:
        items = [x if isinstance(x, np.ndarray) else Path(x) for x in folder_or_list]
    items = items[::max(stride, 1)]
    if not items:
        raise ValueError(f"no images found in {folder_or_list}")

    norm = IMAGE_NORMALIZATION_DICT[norm_type]
    mean = torch.tensor(norm.mean, dtype=torch.float32, device=device)
    std = torch.tensor(norm.std, dtype=torch.float32, device=device)
    raw, shapes, paths = [], [], []
    target = None
    for i, item in enumerate(items):
        if isinstance(item, np.ndarray):
            if item.dtype != np.uint8 or item.ndim != 3 or item.shape[2] != 3:
                raise ValueError(f"array {i}: expected uint8 (H, W, 3), got {item.dtype} {item.shape}")
            img, name = item, f"array_{i}"
        else:
            img, name = _read_image(item, bayer_format=bayer_format), str(item)
        h, w = img.shape[:2]
        shapes.append((h, w))
        paths.append(name)
        if target is None:
            target = _target_size(w, h, resize_mode, resolution_set, size)
        out, _, _, _ = crop_resize_if_necessary(torch.from_numpy(np.ascontiguousarray(img)).to(device), target,
                                                None, _fake_K(h, w))
        raw.append(out.to(torch.float32) / 255.0)
    images_no_norm = torch.stack(raw)
    return dict(
        images=(images_no_norm - mean) / std,
        images_no_norm=images_no_norm,
        true_shape=torch.tensor(shapes, dtype=torch.int32, device=device),
        paths=paths,
        data_norm_type=norm_type,
    )


def _target_size(w: int, h: int, resize_mode: str, resolution_set: int, size):
    """The (width, height) every view is resized to, from the first view's size."""
    if resize_mode == "fixed_mapping":
        return find_closest_aspect_ratio(w / h, resolution_set)
    if resize_mode == "longest_side":
        assert size is not None
        scale = size / max(h, w)
        return (int(round(w * scale / 14) * 14), int(round(h * scale / 14) * 14))
    if resize_mode == "square":
        assert size is not None
        return (size, size)
    raise ValueError(resize_mode)


def _fake_K(h: int, w: int) -> np.ndarray:
    """Placeholder intrinsics, so that the crop's bookkeeping works for plain images."""
    return np.array(
        [[max(h, w), 0, w / 2 - 0.5], [0, max(h, w), h / 2 - 0.5], [0, 0, 1]],
        np.float32,
    )

