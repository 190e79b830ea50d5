"""DPT dense prediction head of the port: reassemble, fuse, regress.

Counterpart of ``mapanything_tpu/models/heads/dpt.py``:
``_resize_bilinear_align_corners`` (:39), ``StridedConvTranspose`` (:77),
``ResidualConvUnit`` (:109), ``FeatureFusionBlock`` (:124), ``DPTFeature``
(:149), ``DPTRegressionProcessor`` (:212) and ``DPTSegmentationProcessor``
(:243). The public functions take and
return channel-last (B, H, W, C) tensors; the convolutions run on NCHW
views of them. Parameter names follow the reference's torch DPT
(``input_process.i.*``, ``scratch.refinenetK.*``, ``conv1``, ``conv2.*``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mapanything_tpu_torch.models.blocks import Conv2d, ConvTranspose2d


# CUDA's bilinear resize of a channels-last tensor indexes its output with int32:
# it refuses an output of INT_MAX elements or more (64 views of 128 channels at
# 518 x 518 are 2.2e9).
MAX_RESIZE_ELEMENTS = 2**31 - 1


def _resize_bilinear_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor with torch's align_corners=True, over
    batch pieces whose output stays under MAX_RESIZE_ELEMENTS (each item is
    resized on its own, so the pieces change no value)."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    resize = lambda t: F.interpolate(t, size=tuple(out_hw), mode="bilinear", align_corners=True)  # noqa: E731
    step = max(1, (MAX_RESIZE_ELEMENTS - 1) // (x.shape[1] * out_hw[0] * out_hw[1]))
    if x.shape[0] <= step:
        return resize(x)
    return torch.cat([resize(x[i:i + step]) for i in range(0, x.shape[0], step)])


class StridedConvTranspose(ConvTranspose2d):
    """ConvTranspose2d with stride == kernel size: weight (in, out, k, k)."""

    def __init__(self, in_ch, out_ch, kernel_size, dtype=torch.float32):
        super().__init__(in_ch, out_ch, kernel_size, stride=kernel_size, dtype=dtype)


class ResidualConvUnit(nn.Module):
    """Pre-activation residual conv unit."""

    def __init__(self, features, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, padding=1, dtype=dtype)
        self.conv2 = Conv2d(features, features, 3, padding=1, dtype=dtype)

    def forward(self, x):
        out = self.conv2(F.relu(self.conv1(F.relu(x))))
        return out + x


class FeatureFusionBlock(nn.Module):
    """Optional skip merge, refine, 2x bilinear upsample, 1x1 out conv.

    ``has_skip=False`` mirrors refinenet4, which has no ``resConfUnit1``.
    """

    def __init__(self, features, has_skip=True, dtype=torch.float32):
        super().__init__()
        if has_skip:
            self.resConfUnit1 = ResidualConvUnit(features, dtype)
        self.resConfUnit2 = ResidualConvUnit(features, dtype)
        self.out_conv = Conv2d(features, features, 1, dtype=dtype)

    def forward(self, x, skip=None):
        out = x
        if skip is not None:
            out = out + self.resConfUnit1(skip)
        out = self.resConfUnit2(out)
        out = _resize_bilinear_align_corners(out, (out.shape[-2] * 2, out.shape[-1] * 2))
        return self.out_conv(out)


class _Scratch(nn.Module):
    def __init__(self, feature_dim, dtype):
        super().__init__()
        self.refinenet1 = FeatureFusionBlock(feature_dim, dtype=dtype)
        self.refinenet2 = FeatureFusionBlock(feature_dim, dtype=dtype)
        self.refinenet3 = FeatureFusionBlock(feature_dim, dtype=dtype)
        self.refinenet4 = FeatureFusionBlock(feature_dim, has_skip=False, dtype=dtype)


class DPTFeature(nn.Module):
    """Four hooked (B, h, w, C_i) maps -> one (B, 8h, 8w, feature_dim) map."""

    def __init__(
        self,
        hooks: Sequence[int] = (0, 1, 2, 3),
        input_feature_dims: Sequence[int] = (1024, 768, 768, 768),
        layer_dims: Sequence[int] = (96, 192, 384, 768),
        feature_dim: int = 256,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.hooks = tuple(hooks)
        self.dtype = dtype
        stages = []
        for idx in range(4):
            proj = [Conv2d(input_feature_dims[idx], layer_dims[idx], 1, dtype=dtype)]
            if idx == 0:
                proj.append(StridedConvTranspose(layer_dims[0], layer_dims[0], 4, dtype=dtype))
            elif idx == 1:
                proj.append(StridedConvTranspose(layer_dims[1], layer_dims[1], 2, dtype=dtype))
            elif idx == 3:
                proj.append(Conv2d(layer_dims[3], layer_dims[3], 3, stride=2, padding=1, dtype=dtype))
            layer_rn = Conv2d(layer_dims[idx], feature_dim, 3, padding=1, bias=False, dtype=dtype)
            stages.append(nn.Sequential(nn.Sequential(*proj), layer_rn))
        self.input_process = nn.ModuleList(stages)
        self.scratch = _Scratch(feature_dim, dtype)

    def forward(self, list_features: Sequence[torch.Tensor]) -> torch.Tensor:
        layers = [list_features[h] for h in self.hooks]
        assert len(layers) == 4
        processed = [
            stage(feat.to(self.dtype).permute(0, 3, 1, 2))
            for stage, feat in zip(self.input_process, layers)
        ]
        s = self.scratch
        path_4 = s.refinenet4(processed[3])
        path_4 = path_4[..., : processed[2].shape[-2], : processed[2].shape[-1]]
        path_3 = s.refinenet3(path_4, processed[2])
        path_2 = s.refinenet2(path_3, processed[1])
        path_1 = s.refinenet1(path_2, processed[0])
        return path_1.permute(0, 2, 3, 1)


class DPTRegressionProcessor(nn.Module):
    """Decode the 8x feature map to ``output_dim`` channels at full resolution.

    conv1 -> bilinear (align_corners=True) to the image size -> conv2.0 ->
    ReLU -> conv2.2. The feature convs run in ``feature_dtype``; the final
    1x1 value decode runs in ``dtype``.
    """

    def __init__(
        self,
        input_feature_dim: int,
        output_dim: int,
        hidden_dims: Optional[Sequence[int]] = None,
        dtype: torch.dtype = torch.float32,
        feature_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        fdt = feature_dtype or dtype
        c = input_feature_dim
        hidden = tuple(hidden_dims) if hidden_dims else (c // 2, c // 2)
        self.conv1 = Conv2d(c, hidden[0], 3, padding=1, dtype=fdt)
        self.conv2 = nn.Sequential(
            Conv2d(hidden[0], hidden[1], 3, padding=1, dtype=fdt),
            nn.ReLU(),
            Conv2d(hidden[1], output_dim, 1, dtype=dtype),
        )

    def forward(self, features: torch.Tensor, output_shape_hw) -> torch.Tensor:
        x = self.conv1(features.permute(0, 3, 1, 2))
        x = _resize_bilinear_align_corners(x, output_shape_hw)
        return self.conv2(x).permute(0, 2, 3, 1)


class DPTSegmentationProcessor(nn.Module):
    """Decode the 8x feature map to ``output_dim`` channels at the target size.

    conv1 (3x3, no bias) -> ReLU -> conv2 (1x1) -> bilinear (align_corners=True)
    to ``output_shape_hw``, all in ``dtype``. Parameter names are the JAX
    module's (``conv1``, ``conv2``).
    """

    def __init__(
        self,
        input_feature_dim: int,
        output_dim: int,
        hidden_dim: Optional[int] = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        hidden = hidden_dim or input_feature_dim
        self.conv1 = Conv2d(input_feature_dim, hidden, 3, padding=1, bias=False, dtype=dtype)
        self.conv2 = Conv2d(hidden, output_dim, 1, dtype=dtype)

    def forward(self, features: torch.Tensor, output_shape_hw) -> torch.Tensor:
        x = self.conv2(F.relu(self.conv1(features.permute(0, 3, 1, 2))))
        return _resize_bilinear_align_corners(x, output_shape_hw).permute(0, 2, 3, 1)
