"""FFA-Net's step-based trainer (counterpart of
`dehaze_tpu/train/ffa_trainer.py`).

The reference FFA recipe: Adam (β 0.9/0.999, eps 1e-8) at the per-step
cosine `0.5 · (1 + cos(π t / T)) · lr` (`train.schedule.ffa_cosine_lr`,
the lr of update t + 1 after t updates), L1 loss plus, with `perceptual`,
0.04 × the VGG16 perceptual loss, float32 throughout. The FFA data path
normalizes the hazy input only (`normalize_hazy`, from `infer.tiled`);
the residual of the model is added to that normalized input, as in the
reference.

Evaluation clamps the restored image to [0, 1] and averages
`batch_psnr`/`batch_ssim` over the first `n_valid` rows (the validation
batches wrap their last rows).

Data-parallel (`data_parallel=True`, one process per GPU, the process
group up; `cli.ffa_train --data_axis`): the model runs under
`DistributedDataParallel`, each rank on its rows of the global batch.
Both losses are means over equal shares of the rows, so DDP's average of
the ranks' gradients is the global batch's gradient; the returned loss is
the global batch's, and evaluation spreads the batches over the ranks.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dehaze_tpu_torch.infer.sharded import frame_share
# the protocol's normalization of the hazy input, shared with inference
from dehaze_tpu_torch.infer.tiled import (FFA_MEAN, FFA_STD,  # noqa: F401
                                          normalize_hazy)
from dehaze_tpu_torch.models import vgg as vgg_mod
from dehaze_tpu_torch.models.ffa import FFA
from dehaze_tpu_torch.ops import losses as L
from dehaze_tpu_torch.ops import metrics as M
from dehaze_tpu_torch.parallel import dist
from dehaze_tpu_torch.train.schedule import ffa_cosine_lr
from dehaze_tpu_torch.utils.transfer import to_device


def _u8_norm(x: torch.Tensor) -> torch.Tensor:
    return x.float() / 255.0 if x.dtype == torch.uint8 else x


class FFATrainer:
    """Owns FFA-Net (width 64, float32; its init drawn from `seed` on the
    CPU), the Adam optimizer, the step count and the VGG16 of the
    perceptual loss; `train_step` runs one update on a (clean, hazy)
    batch."""

    def __init__(self, *, gps: int = 3, blocks: int = 19, lr: float = 1e-4,
                 total_steps: int = 100_000, perceptual: bool = False,
                 normalize: bool = True, vgg_weights: Optional[str] = None,
                 seed: int = 1234, device="cuda",
                 data_parallel: bool = False):
        self.device = torch.device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = FFA(gps=gps, blocks=blocks)
        self.model = model.to(self.device)
        self.ddp = None
        if data_parallel:
            self.ddp = torch.nn.parallel.DistributedDataParallel(
                self.model, device_ids=(
                    [self.device] if self.device.type == "cuda" else None))
        self.opt = torch.optim.Adam(self.model.parameters(), lr=lr,
                                    betas=(0.9, 0.999), eps=1e-8)
        self.lr = ffa_cosine_lr(lr, total_steps)
        self.step = 0  # updates applied
        self.normalize = normalize
        self.vgg = None
        if perceptual:
            self.vgg = vgg_mod.make_perceptual_vgg()
            if vgg_weights:
                vgg_mod.load_params_npz(self.vgg, vgg_weights)
            else:
                vgg_mod.warn_random_vgg("FFA perceptual loss")
                vgg_mod.init_vgg_params(self.vgg, seed=0)
            self.vgg.to(self.device)

    def _input(self, hazy: torch.Tensor) -> torch.Tensor:
        return normalize_hazy(hazy) if self.normalize else hazy

    def _batch(self, clean, hazy):
        return tuple(_u8_norm(to_device(torch.as_tensor(a), self.device))
                     for a in (clean, hazy))

    def train_step(self, clean, hazy) -> torch.Tensor:
        """One Adam update on a batch (uint8 or float NHWC, NumPy or
        tensors; this rank's rows under DDP). Returns the global batch's
        loss as a detached device scalar (no host sync)."""
        clean, hazy = self._batch(clean, hazy)
        self.model.train()
        out = (self.ddp or self.model)(self._input(hazy))
        loss = L.l1(out, clean)
        if self.vgg is not None:
            with torch.no_grad():
                target = self.vgg(clean)
            loss = loss + 0.04 * L.perceptual_loss_from_features(
                self.vgg(out), target)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        for group in self.opt.param_groups:
            group["lr"] = self.lr(self.step)
        self.opt.step()
        self.step += 1
        loss = loss.detach()
        return dist.mean_over_ranks(loss) if self.ddp is not None else loss

    @torch.no_grad()
    def eval_step(self, clean, hazy) -> Tuple[torch.Tensor, torch.Tensor]:
        """(psnr [B], ssim [B]) of the clamped restored batch."""
        clean, hazy = self._batch(clean, hazy)
        self.model.eval()
        out = torch.clamp(self.model(self._input(hazy)), 0.0, 1.0)
        return M.batch_psnr(out, clean), M.batch_ssim(out, clean)

    def evaluate(self, batches: Sequence, n_valid: Optional[int] = None
                 ) -> Tuple[float, float]:
        """Mean PSNR/SSIM over (clean, hazy) batches, the first `n_valid`
        rows; under a process group each rank scores its share of the
        batches and every rank gets the means over all of them."""
        share = frame_share(len(batches))
        scores = [self.eval_step(*batches[i]) for i in share]
        merged = {}
        for part in dist.gather_objects({
                i: (p.cpu().numpy(), s.cpu().numpy())
                for i, (p, s) in zip(share, scores)}):
            merged.update(part)
        p_all = np.concatenate([merged[i][0] for i in range(len(batches))])
        s_all = np.concatenate([merged[i][1] for i in range(len(batches))])
        return (float(np.mean(p_all[:n_valid])),
                float(np.mean(s_all[:n_valid])))
