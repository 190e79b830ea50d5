"""ModularDUSt3R of the port: the two-view DUSt3R on the framework's parts.

Counterpart of ``mapanything_tpu/models/modular_dust3r.py``:
``ModularDUSt3RConfig`` (:32-46), ``DUSt3RPredictions`` (:49) and
``ModularDUSt3R`` (:54-129). Both images of a pair pass the shared CroCo
encoder in one batch; the cross-attention decoder runs a branch for view 0 and
one for view 1; a DPT feature head and regression processor per branch read
[encoder output, decoder taps 0 and 1, decoder output] in fp32 and give three
pointmap channels and a confidence channel at full resolution; the ``exp``
pointmap and the confidence adaptors finish. The encoder and decoder run in
``compute_dtype``; attention goes through ``ops.attention.sdpa``, so on the
card it launches the flash-attention kernels.

Parameter names. The encoder's and decoder's are the DUSt3R release's, the ones
``convert_croco_encoder`` and ``convert_modular_dust3r`` read, at the top level
as in the release: ``patch_embed.proj``, ``enc_blocks.N``, ``enc_norm``,
``decoder_embed``, ``dec_blocks.N``, ``dec_blocks2.N``, ``dec_norm``. The
converter leaves the release's DPT heads (``downstream_head1``/``2``, a fused
adapter of another layout) unconverted, so the heads here take the JAX modules'
names: ``dpt_head_{0,1}.*`` and ``dpt_reg_{0,1}.*``, each with the port's DPT
names inside (``input_process.i.*``, ``scratch.refinenetK.*``, ``conv1``,
``conv2.*``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple, Union

import torch
from torch import nn

from mapanything_tpu_torch.models.blocks import init_params
from mapanything_tpu_torch.models.encoders.croco import CroCoEncoder
from mapanything_tpu_torch.models.heads.adaptors import (
    ConfidenceConfig,
    RangeConfig,
    adapt_confidence,
    adapt_pointmap,
)
from mapanything_tpu_torch.models.heads.dpt import DPTFeature, DPTRegressionProcessor
from mapanything_tpu_torch.models.info_sharing.cross_attention import CrossAttentionTransformer
from mapanything_tpu_torch.models.mapanything import resolve_device


@dataclass(frozen=True)
class ModularDUSt3RConfig:
    """The defaults are DUSt3R_ViTLarge_BaseDecoder_512_dpt's widths."""

    patch_size: int = 16
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 12
    dec_num_heads: int = 12
    dpt_hooks: Tuple[int, ...] = (0, 1, 2, 3)
    dpt_feature_dim: int = 256
    dpt_layer_dims: Tuple[int, ...] = (96, 192, 384, 768)
    indices: Tuple[int, ...] = (2, 5, 8)  # the decoder taps
    pointmap: RangeConfig = field(default_factory=lambda: RangeConfig("exp"))
    confidence: ConfidenceConfig = field(default_factory=ConfidenceConfig)
    compute_dtype: str = "float32"


@dataclass
class DUSt3RPredictions:
    pts3d: torch.Tensor  # (B, 2, H, W, 3) in view 0's frame
    conf: torch.Tensor  # (B, 2, H, W)


class ModularDUSt3R(nn.Module):
    """``ModularDUSt3R(config, device=None, seed=0)``: seeded random weights
    (``init_params``) on ``device``, CUDA unless it says otherwise.

    ``forward(views_img (B, 2, H, W, 3), return_features=False)`` gives
    ``DUSt3RPredictions``; with ``return_features`` also the decoder's output
    tokens (B, 2, h, w, dec_embed_dim), for heads stacked on top.
    """

    def __init__(
        self,
        config: ModularDUSt3RConfig = ModularDUSt3RConfig(),
        device: Union[str, torch.device, None] = None,
        seed: int = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        cfg = config
        self.config = cfg
        dtype = getattr(torch, cfg.compute_dtype)
        encoder = CroCoEncoder(cfg.patch_size, cfg.enc_embed_dim, cfg.enc_depth, cfg.enc_num_heads, dtype=dtype)
        decoder = CrossAttentionTransformer(
            cfg.enc_embed_dim, cfg.dec_depth, cfg.dec_embed_dim, cfg.dec_num_heads, indices=cfg.indices, dtype=dtype
        )
        # The release's flat names: the encoder's and decoder's parts are this
        # module's own children; the two modules are kept, unregistered, to run them.
        for part in (encoder, decoder):
            for name, child in part.named_children():
                self.add_module(name, child)
        object.__setattr__(self, "encoder", encoder)
        object.__setattr__(self, "decoder", decoder)
        for branch in range(2):
            self.add_module(f"dpt_head_{branch}", DPTFeature(
                hooks=cfg.dpt_hooks,
                input_feature_dims=(cfg.enc_embed_dim,) + (cfg.dec_embed_dim,) * 3,
                layer_dims=cfg.dpt_layer_dims,
                feature_dim=cfg.dpt_feature_dim,
            ))
            self.add_module(f"dpt_reg_{branch}", DPTRegressionProcessor(cfg.dpt_feature_dim, 4))
        init_params(self, torch.Generator().manual_seed(seed))
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.enc_norm.weight.device

    def forward(self, views_img: torch.Tensor, return_features: bool = False):
        cfg = self.config
        views_img = views_img.to(self.device, torch.float32)
        B, V, H, W, _ = views_img.shape
        if V != 2:
            raise ValueError(f"ModularDUSt3R is a two-view model, got {V} views")
        h, w = H // cfg.patch_size, W // cfg.patch_size
        enc_feats = self.encoder(views_img.reshape(B * 2, H, W, 3)).reshape(B, 2, h, w, cfg.enc_embed_dim)
        dec_final, dec_inters = self.decoder(enc_feats)
        outputs = []
        for branch in range(2):
            feats = [x[:, branch].float() for x in (enc_feats, dec_inters[0], dec_inters[1], dec_final)]
            dpt = getattr(self, f"dpt_head_{branch}")
            reg = getattr(self, f"dpt_reg_{branch}")
            outputs.append(reg(dpt(feats), (H, W)))
        raw = torch.stack(outputs, dim=1).float()  # (B, 2, H, W, 4)
        preds = DUSt3RPredictions(
            pts3d=adapt_pointmap(raw[..., :3], cfg.pointmap),
            conf=adapt_confidence(raw[..., 3:4], cfg.confidence)[..., 0],
        )
        if return_features:
            return preds, dec_final
        return preds


def small_config(**kw) -> ModularDUSt3RConfig:
    """The registry's small DUSt3R (``dust3r_ba(size="small")``): 2-layer encoder
    and decoder of 64 with 4 heads of 16, a DPT of 32 features."""
    base = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=4, dec_embed_dim=64, dec_depth=2, dec_num_heads=4,
                dpt_feature_dim=32, dpt_layer_dims=(16, 32, 48, 64), indices=(0, 0, 1))
    base.update(kw)
    return ModularDUSt3RConfig(**base)

