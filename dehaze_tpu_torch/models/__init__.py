"""The models: the Uformer, FFA-Net and the conv UNet (counterpart of
`dehaze_tpu/models/`)."""

from __future__ import annotations

import torch

from dehaze_tpu_torch.config import ModelConfig


def get_arch(cfg: ModelConfig, device=None) -> torch.nn.Module:
    """The model of cfg.arch: 'uformer' | 'ffa' | 'unet' (counterpart of
    `dehaze_tpu/models/__init__.py:get_arch`), on `device`. The Uformer
    refuses the option combinations the JAX package refuses
    (`models.uformer.check_config`); FFA-Net and the UNet ignore the
    Uformer's options, as there."""
    if cfg.arch == "uformer":
        from dehaze_tpu_torch.models.uformer import Uformer

        return Uformer(cfg, device=device)
    if cfg.arch == "ffa":
        from dehaze_tpu_torch.models.ffa import FFA

        return FFA(gps=cfg.ffa_gps, blocks=cfg.ffa_blocks, dim=cfg.ffa_dim,
                   dtype=cfg.dtype, device=device)
    if cfg.arch == "unet":
        from dehaze_tpu_torch.models.unet import UNet

        return UNet(dim=cfg.embed_dim, dtype=cfg.dtype, device=device)
    raise ValueError(f"unknown arch: {cfg.arch}")
