"""Epoch learning-rate schedules (counterpart of `dehaze_tpu/train/schedule.py`).

The reference's timeline, stepped at epoch end (FFA-Net's trainer steps its
own cosine every update, `ffa_cosine_lr`):
- warmup + cosine: linear from 0 (epoch 1 trains at lr 0, a faithful quirk)
  to the base lr over W epochs, then a cosine over nepoch - W epochs down to
  eta_min;
- StepLR when warmup is off: ×gamma every step_size epochs;
- resume: a fresh cosine over the remaining epochs from the resumed lr.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

from dehaze_tpu_torch.config import TrainConfig


def make_epoch_lr(cfg: TrainConfig) -> Callable[[int], float]:
    """epoch (0-based) -> lr."""
    base = cfg.lr_initial
    if cfg.warmup:
        w = cfg.warmup_epochs
        t_max = max(cfg.nepoch - w, 1)
        eta = cfg.cosine_eta_min

        def lr(epoch: int) -> float:
            if epoch <= w:
                return base * epoch / w
            t = min(epoch - w - 1, t_max)
            return eta + (base - eta) * (1 + math.cos(math.pi * t / t_max)) / 2

        return lr

    def lr_step(epoch: int) -> float:
        return base * (cfg.step_gamma ** (epoch // cfg.step_size))

    return lr_step


def resume_cosine_lr(cfg: TrainConfig, start_epoch: int, resumed_lr: float):
    """After a resume: a cosine over nepoch - start_epoch + 1 epochs from the
    checkpointed lr."""
    t_max = cfg.nepoch - start_epoch + 1
    eta = cfg.cosine_eta_min

    def lr(epoch: int) -> float:
        t = min(epoch - start_epoch, t_max)
        return eta + (resumed_lr - eta) * (1 + math.cos(math.pi * t / t_max)) / 2

    return lr


def epoch_lr_table(epoch_lr: Callable[[int], float], max_epochs: int = 4096
                   ) -> np.ndarray:
    """An epoch-lr function tabulated as [max_epochs] float32."""
    return np.array([epoch_lr(e) for e in range(max_epochs)],
                    dtype=np.float32)


def lr_schedule_from_epoch_fn(epoch_lr: Callable[[int], float],
                              steps_per_epoch: int
                              ) -> Callable[[int], float]:
    """step → the lr of its epoch, read from `epoch_lr` tabulated as
    float32 over 4,096 epochs (the last one past the table), as the JAX
    package's optax schedule reads its table."""
    table = epoch_lr_table(epoch_lr)

    def schedule(step: int) -> float:
        return float(table[min(step // steps_per_epoch, len(table) - 1)])

    return schedule


def ffa_cosine_lr(base_lr: float, total_steps: int) -> Callable[[int], float]:
    """FFA-Net's per-step cosine: 0.5 · (1 + cos(π · step / total)) · lr,
    for the update that follows `step` earlier ones (counterpart of
    `dehaze_tpu/train/schedule.py:ffa_cosine_lr`)."""

    def lr(step: int) -> float:
        return 0.5 * (1 + math.cos(math.pi * step / total_steps)) * base_lr

    return lr
