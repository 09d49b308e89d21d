"""The training step: MixUp, clamp, Charbonnier + CR loss, AdamW, lr table.

Counterpart of `dehaze_tpu/train/trainer.py`. The recipe is the
reference's: AdamW (lr 2e-4, wd 0.02, β 0.9/0.999, eps 1e-8), Charbonnier
(eps 1e-3) plus the VGG19 contrastive loss, the restored image clamped to
[0, 1] before the losses, MixUp after epoch 5, bf16 activations over
float32 parameters and optimizer state (bf16 keeps float32's exponent, so
no loss scaling).

The learning rate is read every step from a table indexed by the absolute
epoch `step // steps_per_epoch` and written into the optimizer's param
group before `opt.step()`: the same update as the JAX step's unit schedule
times lr, and the same timeline across resumes.

Random sources are explicit generators, seeded from `TrainConfig.seed`:
ProbSparse sampling (advancing from step to step), DropPath, dropout and
MixUp. Evaluation samples from a generator seeded 0 for every batch.
"""

from __future__ import annotations

import warnings
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from dehaze_tpu_torch.config import Config
from dehaze_tpu_torch.data.augment import (dihedral_index_maps,
                                           gather_crops, mixup)
from dehaze_tpu_torch.models import vgg as vgg_mod
from dehaze_tpu_torch.models.uformer import Uformer
from dehaze_tpu_torch.ops import losses as L
from dehaze_tpu_torch.ops import metrics as M
from dehaze_tpu_torch.train.schedule import epoch_lr_table, make_epoch_lr
from dehaze_tpu_torch.utils.transfer import to_device


def u8_norm(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 / 255 on the tensor's device (floats pass)."""
    return x.float() / 255.0 if x.dtype == torch.uint8 else x


def make_optimizer(cfg: Config, params) -> torch.optim.Optimizer:
    """AdamW (or Adam) with the recipe's betas, eps and weight decay; the
    lr is set per step by `Trainer.train_step`."""
    t = cfg.train
    kw = dict(lr=t.lr_initial, betas=(t.beta1, t.beta2), eps=t.eps)
    if t.optimizer.lower() == "adam":
        return torch.optim.Adam(params, **kw)
    return torch.optim.AdamW(params, weight_decay=t.weight_decay, **kw)


def build_model(cfg: Config, device) -> Uformer:
    """The Uformer with its reference init drawn from `cfg.train.seed` (on
    the CPU, so every device gets the same weights), moved to `device`.
    torch's global RNG is left as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.train.seed)
        model = Uformer(cfg.model)
    return model.to(device)


class Trainer:
    """Owns the model, the VGG19 of the CR loss, the optimizer, the lr table
    and the generators; `train_step` (a batch from the host) and
    `train_step_data` (a batch gathered from a device-resident dataset)
    each run one optimizer update."""

    def __init__(self, cfg: Config, steps_per_epoch: int, epoch_lr=None,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = build_model(cfg, self.device)
        self.opt = make_optimizer(cfg, self.model.parameters())
        self._spe = steps_per_epoch
        self.lr_table = epoch_lr_table(epoch_lr or make_epoch_lr(cfg.train))
        self.step = 0  # optimizer updates applied (absolute across resumes)
        seed = cfg.train.seed
        self.sample_gen = torch.Generator().manual_seed(seed)
        self.droppath_gen = torch.Generator().manual_seed(seed + 1)
        self.dropout_gen = torch.Generator().manual_seed(seed + 2)
        self.mixup_gen = torch.Generator().manual_seed(seed + 3)
        self._dihedral_maps = None  # train_step_data's, built at first use

        self.use_cr = cfg.loss.w_contrast > 0
        self.vgg = None
        if self.use_cr:
            self.vgg = vgg_mod.make_cr_vgg(dtype=cfg.model.dtype)
            if cfg.loss.vgg_weights:
                vgg_mod.load_params_npz(self.vgg, cfg.loss.vgg_weights)
            else:
                vgg_mod.warn_random_vgg("Trainer CR loss")
                vgg_mod.init_vgg_params(self.vgg, seed=0)
            self.vgg.to(self.device)

    def _loss(self, clean: torch.Tensor, hazy: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        restored = self.model(hazy, generator=self.sample_gen,
                              droppath=self.droppath_gen,
                              dropout_gen=self.dropout_gen)
        restored = torch.clamp(restored, 0.0, 1.0)
        l_char = L.charbonnier_loss(restored, clean, cfg.loss.charbonnier_eps)
        zero = torch.zeros((), device=clean.device)
        l_cr, all_ap, all_an = zero, zero, zero
        if self.use_cr:
            with torch.no_grad():  # positives and negatives are detached
                p, n = self.vgg(clean), self.vgg(hazy)
            l_cr, all_ap, all_an = L.contrast_loss_from_features(
                self.vgg(restored), p, n, weights=cfg.loss.contrast_weights,
                ablation=cfg.loss.contrast_ablation)
        loss = cfg.loss.w_charbonnier * l_char + cfg.loss.w_contrast * l_cr
        return loss, {"loss": loss, "charbonnier": l_char, "contrast": l_cr,
                      "all_ap": all_ap, "all_an": all_an}

    def train_step(self, clean, hazy, use_mixup: bool, accum_steps: int = 1
                   ) -> Dict[str, torch.Tensor]:
        """One optimizer update on a (clean, hazy) batch (uint8 or float,
        NHWC, NumPy or tensors). Returns the step's metrics as detached
        device scalars (no host sync); the gradients stay in `.grad`."""
        return self._step(to_device(torch.as_tensor(clean), self.device),
                          to_device(torch.as_tensor(hazy), self.device),
                          use_mixup, accum_steps)

    def train_step_data(self, data_c: torch.Tensor, data_n: torch.Tensor,
                        sched, use_mixup: bool) -> Dict[str, torch.Tensor]:
        """`train_step` on the batch that `sched` [B, 4] of (item, row, col,
        k) (`pipeline.epoch_schedule_arrays`) cuts from the device-resident
        images `data_c` and `data_n` [N, H, W, 3]: crop and dihedral are one
        gather on the device, and only `sched` (16 bytes a row) crosses
        from the host. One microbatch: `fit` refuses --accum_steps here."""
        if self._dihedral_maps is None:
            self._dihedral_maps = dihedral_index_maps(self.cfg.data.train_ps,
                                                      data_c.device)
        sched = to_device(torch.as_tensor(sched), data_c.device)
        return self._step(gather_crops(data_c, sched, self._dihedral_maps),
                          gather_crops(data_n, sched, self._dihedral_maps),
                          use_mixup, accum_steps=1)

    def _step(self, clean: torch.Tensor, hazy: torch.Tensor, use_mixup: bool,
              accum_steps: int) -> Dict[str, torch.Tensor]:
        """The update on a batch already on the device."""
        cfg = self.cfg
        self.model.train()
        clean, hazy = u8_norm(clean), u8_norm(hazy)
        if use_mixup:
            # one λ draw over the full batch, before any microbatch split
            clean, hazy = mixup(self.mixup_gen, clean, hazy,
                                cfg.data.mixup_beta)
        self.opt.zero_grad(set_to_none=True)
        b = clean.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by accum_steps "
                             f"{accum_steps}")
        if accum_steps > 1 and self.use_cr and not getattr(
                self, "_warned_accum_cr", False):
            warnings.warn(
                "gradient accumulation with the CR loss averages per-"
                "microbatch contrast RATIOS (mean-of-ratios != the full-"
                "batch ratio-of-means) — the accumulated objective differs "
                "slightly from the single-step recipe; Charbonnier "
                "accumulates exactly", stacklevel=2)
            self._warned_accum_cr = True
        mb = b // accum_steps
        # every microbatch reuses the step's sampling tables
        sample_state = self.sample_gen.get_state()
        sums: Dict[str, torch.Tensor] = {}
        for j in range(accum_steps):
            self.sample_gen.set_state(sample_state)
            sl = slice(j * mb, (j + 1) * mb)
            loss, metrics = self._loss(clean[sl], hazy[sl])
            (loss / accum_steps).backward()
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0) + v.detach() / accum_steps
        lr = float(self.lr_table[min(self.step // self._spe,
                                     len(self.lr_table) - 1)])
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.step += 1
        return sums

    @torch.no_grad()
    def eval_step(self, clean, hazy):
        """(psnr [B], ssim [B], restored) of the model in eval mode; the
        sampling generator is seeded 0 for every batch."""
        self.model.eval()
        clean = u8_norm(to_device(torch.as_tensor(clean), self.device))
        hazy = u8_norm(to_device(torch.as_tensor(hazy), self.device))
        restored = self.model(hazy, generator=torch.Generator().manual_seed(0))
        restored = torch.clamp(restored, 0.0, 1.0)
        return M.batch_psnr(restored, clean), M.batch_ssim(restored, clean), \
            restored

    def evaluate(self, batches: Iterable, n_valid: Optional[int] = None
                 ) -> Tuple[float, float]:
        """Mean PSNR/SSIM over (clean, hazy) batches; `n_valid` drops the
        wrap-padded tail rows. One host sync at the end."""
        psnrs, ssims = [], []
        for clean, hazy in batches:
            p, s, _ = self.eval_step(clean, hazy)
            psnrs.append(p)
            ssims.append(s)
        p_all = torch.cat(psnrs)[:n_valid].cpu().numpy()
        s_all = torch.cat(ssims)[:n_valid].cpu().numpy()
        return float(np.mean(p_all)), float(np.mean(s_all))
