"""The VGG19 perceptual feature extractor of the RGB perception loss.

Counterpart of ``mapanything_tpu/models/perceptual.py`` (after the reference's
``PerceptualLoss``): a VGG19 with every max-pool replaced by a 2x2 average pool,
cut into five blocks at torchvision ``features`` indices [0, 4, 9, 14, 23, 32]
(the relu1_2, relu2_2, relu3_2, relu4_2 and relu5_2 outputs), compared with
fixed per-level L1 weights. Inputs are RGB in [0, 1], preprocessed Caffe-style
to ``x * 255 - mean`` (no division by a std, RGB order kept). Plain torch
convolutions: the JAX package runs them in XLA, not in a kernel of its own.

``VGG19Features`` keeps torchvision's layout and names (``features.{i}``), so a
torchvision ``vgg19`` state dict (its ``features.*`` entries up to index 30)
loads into it as it is; ImageNet weights are not in the repository, and the
module is built with seeded weights, frozen.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch
from torch import nn

from mapanything_tpu_torch.models.blocks import Conv2d, init_params
from mapanything_tpu_torch.models.mapanything import resolve_device

# torchvision VGG19 ``features``: conv widths, "M" the pooling positions (configuration "E").
VGG19_LAYOUT = (
    64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
    512, 512, 512, 512, "M", 512, 512, 512, 512, "M",
)
# The torchvision ``features`` indices where each perceptual tap ends (exclusive).
FEATURE_TAPS = (4, 9, 14, 23, 32)
# Caffe-style preprocessing mean, RGB order.
VGG_MEAN_RGB = (123.680, 116.779, 103.939)
# The reference's per-level weights e0..e5: the pixel term and five feature terms, then / 255.
PERCEPTUAL_LEVEL_WEIGHTS = (1.0, 1.0 / 2.6, 1.0 / 4.8, 1.0 / 3.7, 1.0 / 5.6, 10.0 / 1.5)


def _layers() -> list:
    """(torchvision index, kind, channels) of ``features`` up to the last tap: a conv
    takes two slots (the conv, its ReLU), a pool one."""
    out, i, in_ch = [], 0, 3
    for entry in VGG19_LAYOUT:
        if i >= FEATURE_TAPS[-1]:
            break
        if entry == "M":
            out.append((i, "pool", in_ch))
            i += 1
        else:
            out += [(i, "conv", (in_ch, entry)), (i + 1, "relu", entry)]
            in_ch, i = entry, i + 2
    return out


VGG19_CONV_INDICES = tuple(i for i, kind, _ in _layers() if kind == "conv")


class VGG19Features(nn.Module):
    """The VGG19 tower (average-pool variant) returning the preprocessed pixels and the
    five taps, each channel-last (B, H, W, C).

    ``VGG19Features(compute_dtype="float32", device=None, seed=0)``: seeded weights on
    ``device`` (CUDA unless given), frozen. The first element of the returned list is the
    preprocessed image in fp32 (the reference's e0 term); the convolutions and pools run
    in ``compute_dtype``.
    """

    def __init__(self, compute_dtype: str = "float32", device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        super().__init__()
        self.dtype = getattr(torch, compute_dtype)
        layers = []
        for _, kind, ch in _layers():
            if kind == "conv":
                layers.append(Conv2d(ch[0], ch[1], 3, padding=1, dtype=self.dtype))
            elif kind == "relu":
                layers.append(nn.ReLU())
            else:
                layers.append(nn.AvgPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        init_params(self, torch.Generator().manual_seed(seed))
        self.requires_grad_(False)
        self.to(resolve_device(device))

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        mean = torch.tensor(VGG_MEAN_RGB, dtype=torch.float32, device=images.device)
        x = images.float() * 255.0 - mean
        taps = [x]
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i + 1 in FEATURE_TAPS:
                taps.append(x.permute(0, 2, 3, 1))
        return taps


def perceptual_distance(taps_a, taps_b) -> torch.Tensor:
    """Per-sample perceptual distance of two tap lists, (B,) fp32: the weighted sum of
    each level's mean |difference|, divided by 255."""
    total: Optional[torch.Tensor] = None
    for w, a, b in zip(PERCEPTUAL_LEVEL_WEIGHTS, taps_a, taps_b):
        e = (a.float() - b.float()).abs().mean(dim=(-3, -2, -1)) * w
        total = e if total is None else total + e
    return total / 255.0
