"""Typed configuration (counterpart of `dehaze_tpu/config.py`).

Same field names and defaults as the JAX dataclasses, so the CLIs share
flag names; dtypes are torch dtypes. The JAX flags `use_pallas`/
`use_pallas_leff` have no counterpart: the tensor's device decides whether
the kernels run. `band_axis` has none either: a banded forward takes its
band as an argument (`Uformer.forward(..., bands=)`, `FFA.forward(...,
bands=)`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model config; defaults are the flagship Uformer-32 (embed 32, nine
    stages of 2 LeWin blocks, heads 1→16→2, 8×8 windows, LeFF ×4,
    ProbSparse attention, bf16 activations). `arch` picks the model
    (`models.get_arch`): 'uformer', 'ffa' (FFA-Net, the `ffa_*` fields) or
    'unet' (the residual conv UNet, `embed_dim` wide)."""

    arch: str = "uformer"
    img_size: int = 128
    in_chans: int = 3
    embed_dim: int = 32
    depths: Tuple[int, ...] = (2, 2, 2, 2, 2, 2, 2, 2, 2)
    num_heads: Tuple[int, ...] = (1, 2, 4, 8, 16, 16, 8, 4, 2)
    win_size: int = 8
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.1
    token_projection: str = "linear"
    token_mlp: str = "leff"
    se_layer: bool = False
    attention: str = "probsparse"
    probsparse_factor: int = 5
    use_rel_pos_bias: bool = True
    use_shift: bool = True
    # Activation dtype. Parameters stay float32; activations run in this.
    dtype: torch.dtype = torch.bfloat16
    # tanh-approximate GELU in LeFF (exact erf by default).
    fast_gelu: bool = False
    # Round-trip the LeWin blocks' activations through 8-bit storage at
    # inference ('fp8' or 'int8'; ops/actstore.py); never in training.
    act_store: Optional[str] = None
    # Recompute each LeWin block's activations in the backward pass
    # (torch.utils.checkpoint): peak training memory holds one block's
    # activations instead of every block's, for one more forward per block.
    remat: bool = False
    # FFA-Net (arch='ffa'): residual groups (the reference asserts 3),
    # blocks per group, conv width.
    ffa_gps: int = 3
    ffa_blocks: int = 19
    ffa_dim: int = 64

    @property
    def num_enc_layers(self) -> int:
        return len(self.depths) // 2


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss recipe: Charbonnier plus the VGG19 contrastive (CR) loss."""

    w_charbonnier: float = 1.0
    w_contrast: float = 1.0
    charbonnier_eps: float = 1e-3
    # CR ablation: drop the negative term (`--is_ab`).
    contrast_ablation: bool = False
    # VGG19 feature weights of the CR loss.
    contrast_weights: Tuple[float, ...] = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0)
    # Converted torchvision VGG19 weights (.npz); without them the CR loss
    # runs on a fixed-seed random VGG19 and warns.
    vgg_weights: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Paired gt/hazy folders, crops and MixUp."""

    train_dir: str = ""
    val_dir: str = ""
    train_ps: int = 128  # random crop size at load time
    batch_size: int = 32
    num_workers: int = 8
    mixup_after_epoch: int = 5  # MixUp for epoch > 5
    mixup_beta: float = 1.2  # lambda ~ Beta(1.2, 1.2)
    # Batches leave the pipeline as uint8 and are divided by 255 on the
    # device (4x fewer host-to-device bytes than float32).
    u8_transfer: bool = True
    # Upload the whole patch set to the device once and crop and dihedral
    # there (pipeline.load_all_pairs + Trainer.train_step_data): no decode
    # and no image copy per step; the batches equal the streaming
    # pipeline's. Needs images of one size and a set that fits on the card.
    device_data: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training recipe: AdamW, warmup + cosine (or StepLR), eval 4x/epoch."""

    nepoch: int = 270
    optimizer: str = "adamw"
    lr_initial: float = 2e-4
    weight_decay: float = 0.02
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    warmup: bool = True
    warmup_epochs: int = 3
    cosine_eta_min: float = 1e-6
    # StepLR when warmup is off.
    step_size: int = 50
    step_gamma: float = 0.5
    seed: int = 1234
    evals_per_epoch: int = 4
    save_dir: str = "./log"
    env: str = "_"
    resume: bool = False
    pretrain_weights: str = ""
    # Microbatches per optimizer update; batch_size must divide evenly.
    accum_steps: int = 1
    # Keep only the newest N per-epoch checkpoints (0 = keep all);
    # model_best is never pruned.
    keep_ckpts: int = 0
    # Stop after this many epochs in this process (0 = run to nepoch);
    # continue with --resume.
    exit_after: int = 0
    # Data-parallel training over this many processes, one per GPU, started
    # by torchrun (DDP; train.loop.fit checks the count); None: one process
    # without a process group.
    data_axis: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def replace(cfg, **kw):
    """`dataclasses.replace` passthrough for terse config edits."""
    return dataclasses.replace(cfg, **kw)
