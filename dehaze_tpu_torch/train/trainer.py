"""The training step: MixUp, clamp, Charbonnier + CR loss, AdamW, lr table.

Counterpart of `dehaze_tpu/train/trainer.py`. It trains any arch of
`models.get_arch` (`--arch uformer|ffa|unet`, as the JAX trainer does;
FFA-Net's own recipe is `train.ffa_trainer`). The recipe is the
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

Data-parallel (`data_parallel=True`, one process per GPU, the process
group up; `--data_axis`): the model runs under `DistributedDataParallel`,
each rank on its rows of the global batch (`pipeline.train_batches`'
process slice), and the step is the one-process step on the global batch,
not a mean of per-rank steps: MixUp mixes the gathered global batch with
one draw and keeps the rank's rows; DropPath and dropout masks are drawn
for the global batch (`models.layers.RowShare`); the CR loss takes its
ratios of the global batch means (`parallel.dist.mean_over_ranks`); the
sample tables, the lr table and AdamW are the same on every rank, and the
metrics are the global ones. With --accum_steps, microbatch j joins every
rank's j-th share of its rows: another split of the global batch than one
process's accumulation.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dehaze_tpu_torch.config import Config
from dehaze_tpu_torch.data.augment import (dihedral_index_maps,
                                           gather_crops, mixup)
from dehaze_tpu_torch.infer.sharded import frame_share
from dehaze_tpu_torch.models import vgg as vgg_mod
from dehaze_tpu_torch.models import get_arch
from dehaze_tpu_torch.models.layers import RowShare
from dehaze_tpu_torch.ops import losses as L
from dehaze_tpu_torch.ops import metrics as M
from dehaze_tpu_torch.parallel import dist
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


def build_model(cfg: Config, device) -> torch.nn.Module:
    """cfg.model.arch's model (`models.get_arch`: the Uformer, FFA-Net or
    the UNet) with its reference init drawn from `cfg.train.seed` (on the
    CPU, so every device gets the same weights), moved to `device`.
    torch's global RNG is left as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.train.seed)
        model = get_arch(cfg.model)
    return model.to(device)


class Trainer:
    """Owns the model, the VGG19 of the CR loss, the optimizer, the lr table
    and the generators; `train_step` (a batch from the host) and
    `train_step_data` (a batch gathered from a device-resident dataset)
    each run one optimizer update."""

    def __init__(self, cfg: Config, steps_per_epoch: int, epoch_lr=None,
                 device="cuda", data_parallel: bool = False):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = build_model(cfg, self.device)
        self.uformer = cfg.model.arch == "uformer"
        # the DDP wrapper runs the training forward; `model` (its module,
        # rank 0's weights after the wrapper's broadcast) is what evaluation
        # runs and checkpoints save
        self.ddp = None
        if data_parallel:
            self.ddp = torch.nn.parallel.DistributedDataParallel(
                self.model, device_ids=(
                    [self.device] if self.device.type == "cuda" else None))
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
        """(the loss to back-propagate, the step's metrics). Data-parallel,
        the first is this rank's share, whose gradient DDP averages into
        the global one (`parallel.dist.mean_over_ranks` says why), and the
        metrics are the global batch's."""
        cfg = self.cfg
        droppath, dropout_gen = self.droppath_gen, self.dropout_gen
        if self.ddp is not None:  # masks of the global batch, our rows
            b, p = clean.shape[0], dist.world()
            droppath = RowShare(droppath, dist.rank() * b, p * b)
            dropout_gen = RowShare(dropout_gen, dist.rank() * b, p * b)
        # FFA-Net and the UNet draw nothing: no sampling, DropPath or
        # dropout
        restored = (self.ddp or self.model)(hazy, **(dict(
            generator=self.sample_gen, droppath=droppath,
            dropout_gen=dropout_gen) if self.uformer else {}))
        restored = torch.clamp(restored, 0.0, 1.0)
        l_char = L.charbonnier_loss(restored, clean, cfg.loss.charbonnier_eps)
        zero = torch.zeros((), device=clean.device)
        l_cr, all_ap, all_an = zero, zero, zero
        if self.use_cr:
            with torch.no_grad():  # positives and negatives are detached
                p, n = self.vgg(clean), self.vgg(hazy)
            l_cr, all_ap, all_an = L.contrast_loss_from_features(
                self.vgg(restored), p, n, weights=cfg.loss.contrast_weights,
                ablation=cfg.loss.contrast_ablation,
                reduce=dist.mean_over_ranks if self.ddp is not None else None)
        w_char, w_cr = cfg.loss.w_charbonnier, cfg.loss.w_contrast
        loss = w_char * l_char + w_cr * l_cr
        if self.ddp is not None:  # the global batch's Charbonnier
            l_char = dist.mean_over_ranks(l_char.detach())
            return loss, {"loss": w_char * l_char + w_cr * l_cr.detach(),
                          "charbonnier": l_char, "contrast": l_cr,
                          "all_ap": all_ap, "all_an": all_an}
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
        if use_mixup:
            # one λ draw over the full (global) batch, before any
            # microbatch split: data-parallel, the ranks' rows are
            # gathered, mixed with a draw that is the same on every rank,
            # and each rank keeps its own rows
            b, lo = clean.shape[0], 0
            if self.ddp is not None:
                lo = dist.rank() * b
                clean, hazy = dist.gather_rows(clean), dist.gather_rows(hazy)
            clean, hazy = mixup(self.mixup_gen, u8_norm(clean),
                                u8_norm(hazy), cfg.data.mixup_beta)
            clean, hazy = clean[lo:lo + b], hazy[lo:lo + b]
        clean, hazy = u8_norm(clean), u8_norm(hazy)
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
            # DDP averages the gradients once, in the last backward
            defer = self.ddp is not None and j < accum_steps - 1
            with self.ddp.no_sync() if defer else contextlib.nullcontext():
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
        restored = self.model(hazy, **(dict(
            generator=torch.Generator().manual_seed(0)) if self.uformer
            else {}))
        restored = torch.clamp(restored, 0.0, 1.0)
        return M.batch_psnr(restored, clean), M.batch_ssim(restored, clean), \
            restored

    def evaluate(self, batches: Sequence, n_valid: Optional[int] = None
                 ) -> Tuple[float, float]:
        """Mean PSNR/SSIM over (clean, hazy) batches; `n_valid` drops the
        wrap-padded tail rows. The host waits once, after every batch is
        queued. Under a process group each rank scores its share of the
        batches (`infer.sharded.frame_share`) and every rank gets the means
        over all of them."""
        share = frame_share(len(batches))
        scores = [self.eval_step(*batches[i])[:2] for i in share]
        merged = {}
        for part in dist.gather_objects({
                i: (p.cpu().numpy(), s.cpu().numpy())
                for i, (p, s) in zip(share, scores)}):
            merged.update(part)
        p_all = np.concatenate([merged[i][0] for i in range(len(batches))])
        s_all = np.concatenate([merged[i][1] for i in range(len(batches))])
        return (float(np.mean(p_all[:n_valid])),
                float(np.mean(s_all[:n_valid])))
