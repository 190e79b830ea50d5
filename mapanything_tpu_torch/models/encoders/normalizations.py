"""Per-encoder image normalisation registry of the port.

A copy of ``mapanything_tpu/models/encoders/normalizations.py`` (:13-36):
plain numpy values, so preprocessing can read them anywhere.
"""

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ImageNormalization:
    mean: tuple
    std: tuple

    def apply(self, img: np.ndarray) -> np.ndarray:
        """Normalize an image array (..., 3) in [0, 1] channel-last."""
        mean = np.asarray(self.mean, np.float32)
        std = np.asarray(self.std, np.float32)
        return (img - mean) / std

    def unapply(self, img: np.ndarray) -> np.ndarray:
        mean = np.asarray(self.mean, np.float32)
        std = np.asarray(self.std, np.float32)
        return img * std + mean


IMAGE_NORMALIZATION_DICT = {
    "dummy": ImageNormalization((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
    "croco": ImageNormalization((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "dust3r": ImageNormalization((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
    "dinov2": ImageNormalization((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "identity": ImageNormalization((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
    "patch_embedder": ImageNormalization((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
}
