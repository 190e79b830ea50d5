"""Train-time colour augmentation, host-side numpy.

A copy of ``mapanything_tpu/data/transforms.py`` (:1-136), after the
reference's torchvision stack (``mapanything/datasets/base/base_dataset.py:70-131``):

  - "imgnorm": no colour augmentation (eval/val path);
  - "colorjitter": ColorJitter(0.5, 0.5, 0.5, 0.1);
  - "colorjitter+grayscale+gaublur": RandomApply(ColorJitter(0.3, 0.4,
    0.2, 0.1), p=0.75) + RandomGrayscale(p=0.05) +
    RandomApply(GaussianBlur(5, sigma in (0.1, 1.0)), p=0.05).

On float [0, 1] HWC numpy images with an explicit ``np.random.Generator``
(the dataset's per-item generator), drawn from in the JAX package's order,
so both packages give the same image for the same seed. Loader workers run it.
"""

from __future__ import annotations

import numpy as np

_GRAY_W = np.asarray([0.299, 0.587, 0.114], np.float32)


def _blend(a, b, t):
    return np.clip(a * t + b * (1.0 - t), 0.0, 1.0)


def adjust_brightness(img, factor):
    return np.clip(img * factor, 0.0, 1.0)


def adjust_contrast(img, factor):
    mean = (img @ _GRAY_W).mean(dtype=np.float32)
    return _blend(img, np.full_like(img, mean), factor)


def adjust_saturation(img, factor):
    gray = (img @ _GRAY_W)[..., None].astype(img.dtype)
    return _blend(img, np.broadcast_to(gray, img.shape), factor)


def adjust_hue(img, delta):
    """Shift hue by ``delta`` (in turns, torchvision convention [-0.5, 0.5])."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.max(-1)
    minc = img.min(-1)
    v = maxc
    span = maxc - minc
    s = np.where(maxc > 0, span / np.maximum(maxc, 1e-12), 0.0)
    safe = np.maximum(span, 1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = np.where(
        maxc == r, bc - gc, np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc)
    )
    h = (h / 6.0) % 1.0
    h = (h + delta) % 1.0

    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    out = np.empty_like(img)
    for idx, comps in enumerate(
        [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    ):
        m = i == idx
        for c in range(3):
            out[..., c][m] = comps[c][m]
    return np.where(span[..., None] < 1e-12, img, out)


def color_jitter(img, rng, brightness, contrast, saturation, hue):
    """torchvision ColorJitter: each op applied with a uniform random factor,
    in a random order."""
    ops = []
    if brightness > 0:
        f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda x: adjust_brightness(x, f))
    if contrast > 0:
        f = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(lambda x: adjust_contrast(x, f))
    if saturation > 0:
        f = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
        ops.append(lambda x: adjust_saturation(x, f))
    if hue > 0:
        d = rng.uniform(-hue, hue)
        ops.append(lambda x: adjust_hue(x, d))
    for i in rng.permutation(len(ops)):
        img = ops[i](img)
    return img


def to_grayscale(img):
    gray = (img @ _GRAY_W)[..., None].astype(img.dtype)
    return np.broadcast_to(gray, img.shape).copy()


def gaussian_blur(img, sigma, ksize=5):
    half = ksize // 2
    x = np.arange(-half, half + 1, dtype=np.float32)
    kern = np.exp(-0.5 * (x / sigma) ** 2)
    kern /= kern.sum()
    pad = np.pad(img, ((half, half), (0, 0), (0, 0)), mode="reflect")
    out = np.zeros_like(img)
    for i in range(ksize):
        out += kern[i] * pad[i : i + img.shape[0]]
    pad = np.pad(out, ((0, 0), (half, half), (0, 0)), mode="reflect")
    out = np.zeros_like(img)
    for i in range(ksize):
        out += kern[i] * pad[:, i : i + img.shape[1]]
    return out


def apply_color_transform(
    img: np.ndarray, spec: str, rng: np.random.Generator
) -> np.ndarray:
    """Apply the named augmentation spec to a float [0, 1] HWC image."""
    if spec in (None, "", "imgnorm"):
        return img
    img = np.asarray(img, np.float32)
    if spec == "colorjitter":
        return color_jitter(img, rng, 0.5, 0.5, 0.5, 0.1)
    if spec == "colorjitter+grayscale+gaublur":
        if rng.uniform() < 0.75:
            img = color_jitter(img, rng, 0.3, 0.4, 0.2, 0.1)
        if rng.uniform() < 0.05:
            img = to_grayscale(img)
        if rng.uniform() < 0.05:
            img = gaussian_blur(img, sigma=rng.uniform(0.1, 1.0))
        return img
    raise ValueError(
        f"Unknown transform {spec!r}; options: 'imgnorm', 'colorjitter', "
        "'colorjitter+grayscale+gaublur'"
    )
