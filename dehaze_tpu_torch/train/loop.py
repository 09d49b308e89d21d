"""The training loop: epochs, eval 4×/epoch, best and per-epoch checkpoints,
resume, MixUp gating, logging (counterpart of `dehaze_tpu/train/loop.py`).

    fit(cfg, device="cuda") -> (best_psnr, path of model_best.pth)

Per epoch: `train_batches` feeds `Trainer.train_step` (with
`--device_data`, the whole set is decoded and uploaded once, and each
epoch's `epoch_schedule_arrays` rows feed `Trainer.train_step_data`); every
`steps_per_epoch // evals_per_epoch` steps the model is evaluated on the
center-cropped validation set. An improvement is snapshotted to host memory
at once and written to `model_best.pth` at the epoch's end (and, if the run
dies first, in the `finally` block, with a logged failure if that write
fails). `epoch_model_{e}.pth` carries the optimizer for resume. Resume
follows the reference: restore model and optimizer, restart at the
checkpoint's epoch + 1 with a fresh cosine from the lr reached there, and
seed the best tracker from `model_best.pth`'s extra.

The epoch line reports steady training img/s: after step 0, excluding the
evals, with the device synchronised at both ends.

With `TrainConfig.data_axis` (`--data_axis N`, one process per GPU under
`torchrun --nproc_per_node N`, the process group already up) the trainer
runs under DDP on each rank's slice of every global batch
(`train_batches(process_index=, process_count=)`), evaluation spreads the
validation batches over the ranks and gives the one-process PSNR, resume
loads on every rank, and only rank 0 logs and writes checkpoints (the
module's keys, no `module.` prefix). `--device_data` is refused with it,
as in the JAX package.
"""

from __future__ import annotations

import glob
import os
import re
import time
from typing import Optional, Tuple

import numpy as np
import torch

from dehaze_tpu_torch.config import Config
from dehaze_tpu_torch.data.pipeline import (PairedFolder, _val_batches,
                                            epoch_schedule_arrays,
                                            load_all_pairs, train_batches)
from dehaze_tpu_torch.ops import metrics as M
from dehaze_tpu_torch.parallel import dist
from dehaze_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from dehaze_tpu_torch.train.schedule import make_epoch_lr, resume_cosine_lr
from dehaze_tpu_torch.train.trainer import Trainer, u8_norm
from dehaze_tpu_torch.utils.logging import RunLogger


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _prune_epoch_ckpts(model_dir: str, keep: int, current_epoch: int) -> None:
    """Unlink all but the newest `keep` epoch_model_*.pth files (epochs up
    to the current one; model_best is another name and never touched)."""
    found = []
    for f in glob.glob(os.path.join(model_dir, "epoch_model_*.pth")):
        m = re.fullmatch(r"epoch_model_(\d+)\.pth", os.path.basename(f))
        if m and int(m.group(1)) <= current_epoch:
            found.append((int(m.group(1)), f))
    for _, f in sorted(found)[:-keep]:
        try:
            os.unlink(f)
        except OSError:
            pass


class _Silent:
    """The logger of the ranks other than 0."""

    def text(self, msg: str) -> None:
        pass

    def event(self, kind: str, **fields) -> None:
        pass


def fit(cfg: Config, log_dir: Optional[str] = None, device="cuda"
        ) -> Tuple[float, str]:
    """Train per cfg on `device` (this rank's, data-parallel); returns
    (best_psnr, best_ckpt_path)."""
    t, d = cfg.train, cfg.data
    if t.resume and t.pretrain_weights.endswith(".msgpack"):
        raise SystemExit(
            f"--resume cannot continue {t.pretrain_weights}: a JAX "
            "checkpoint holds optax's optimizer state, which no torch "
            "optimizer takes; resume from an epoch_model_{e}.pth of the "
            "port (its weights alone load through --weights)")
    device = torch.device(device)
    data_parallel = t.data_axis is not None
    if data_parallel and d.device_data:
        raise NotImplementedError(
            "--device_data with --data_axis is not supported (each rank "
            "would need its share of the device-resident set); use the "
            "streaming pipeline for data-parallel runs")
    if data_parallel and (not dist.is_on() or dist.world() != t.data_axis):
        raise SystemExit(f"{dist.launch_hint('--data_axis', t.data_axis)}; "
                         f"the process group has {dist.world()} rank(s)"
                         + ("" if dist.is_on() else " (none is up)"))
    lead = dist.rank() == 0  # logs and writes the checkpoints
    n_proc = t.data_axis or 1
    log_dir = log_dir or os.path.join(t.save_dir, cfg.model.arch + t.env)
    model_dir = os.path.join(log_dir, "models")
    if lead:
        os.makedirs(model_dir, exist_ok=True)
    logger = RunLogger(log_dir) if lead else _Silent()
    logger.text(str(cfg))

    if d.device_data and t.accum_steps > 1:
        # the JAX data step runs one microbatch whatever --accum_steps says
        raise ValueError(f"--device_data with --accum_steps {t.accum_steps}"
                         " is not supported: the device-resident step runs "
                         "one microbatch")
    train_folder = PairedFolder(d.train_dir)
    val_folder = PairedFolder(d.val_dir)
    steps_per_epoch = max(1, -(-len(train_folder) // d.batch_size))

    epoch_lr = None
    start_epoch = 1
    resume_payload = None
    if t.resume and t.pretrain_weights:
        resume_payload = load_checkpoint(t.pretrain_weights)
        start_epoch = int(resume_payload["epoch"]) + 1
        resumed_lr = make_epoch_lr(t)(start_epoch - 1)
        base_lr = resume_cosine_lr(t, start_epoch, resumed_lr)
        epoch_lr = lambda e0: base_lr(e0 + 1)  # e0: 0-based absolute epoch

    trainer = Trainer(cfg, steps_per_epoch, epoch_lr=epoch_lr, device=device,
                      data_parallel=data_parallel)
    if resume_payload is not None:
        trainer.model.load_state_dict(resume_payload["state_dict"])
        if "optimizer" in resume_payload:
            trainer.opt.load_state_dict(resume_payload["optimizer"])
        trainer.step = (start_epoch - 1) * steps_per_epoch
        del resume_payload
        logger.text(f"==> Resuming from epoch {start_epoch}")

    val_np, n_val = _val_batches(val_folder, d.train_ps, d.batch_size,
                                 u8=d.u8_transfer)
    val = [(torch.from_numpy(c).to(device), torch.from_numpy(n).to(device))
           for c, n in val_np]
    data_c = data_n = None
    if d.device_data:
        hc, hn = load_all_pairs(train_folder, u8=d.u8_transfer,
                                num_workers=d.num_workers)
        data_c, data_n = (torch.from_numpy(a).to(device) for a in (hc, hn))
        del hc, hn
        logger.text(f"==> device-resident dataset: {tuple(data_c.shape)} ×2 "
                    f"{data_c.dtype} on {device}")
    # the hazy input against GT, no model involved
    p0 = torch.cat([M.batch_psnr(u8_norm(n), u8_norm(c)) for c, n in val])
    s0 = torch.cat([M.batch_ssim(u8_norm(n), u8_norm(c)) for c, n in val])
    logger.text(f"Input & GT  PSNR {float(p0[:n_val].mean()):.4f} dB | "
                f"SSIM {float(s0[:n_val].mean()):.4f}")

    best_psnr, best_epoch, best_iter = 0.0, 0, 0
    best_path = os.path.join(model_dir, "model_best.pth")
    if start_epoch > 1 and os.path.exists(best_path):
        # a resumed run must not overwrite a better best of an earlier run
        try:
            bex = load_checkpoint(best_path).get("extra") or {}
            best_psnr = float(bex.get("psnr", 0.0))
            best_epoch = int(bex.get("epoch", 0))
            best_iter = int(bex.get("iter", 0))
            if best_psnr > 0.0:
                logger.text(f"==> model_best carries PSNR {best_psnr:.4f} "
                            f"(Ep {best_epoch} it {best_iter}) — preserved "
                            "unless beaten")
        except Exception as e:  # a corrupt best must not kill the run
            logger.text(f"==> model_best unreadable ({e!r}) — tracker reset")
    eval_every = max(1, steps_per_epoch // t.evals_per_epoch)

    best_pending = None  # (epoch, host state_dict, extra) of an unsaved best
    try:
        for epoch in range(start_epoch, t.nepoch + 1):
            t0 = time.time()
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            step_losses = []
            eval_seconds = 0.0
            steady_t0 = None  # set after step 0
            steady_images = 0
            use_mixup = epoch > d.mixup_after_epoch
            if d.device_data:
                it = epoch_schedule_arrays(
                    len(train_folder), tuple(data_c.shape[1:3]),
                    d.batch_size, d.train_ps, t.seed, epoch)
            else:
                it = train_batches(train_folder, batch_size=d.batch_size,
                                   patch_size=d.train_ps, seed=t.seed,
                                   epoch=epoch, num_workers=d.num_workers,
                                   u8=d.u8_transfer,
                                   process_index=dist.rank(),
                                   process_count=n_proc)
            for i, item in enumerate(it):
                if d.device_data:
                    metrics = trainer.train_step_data(
                        data_c, data_n, item, use_mixup=use_mixup)
                    n_rows = len(item)
                else:
                    clean, hazy = item
                    metrics = trainer.train_step(
                        clean, hazy, use_mixup=use_mixup,
                        accum_steps=t.accum_steps)
                    n_rows = len(clean) * n_proc  # the global batch
                step_losses.append(metrics["loss"])
                if steady_t0 is None:
                    _sync(device)
                    steady_t0 = time.time()
                else:
                    steady_images += n_rows

                if (i + 1) % eval_every == 0:
                    _sync(device)
                    te = time.time()
                    psnr, ssim = trainer.evaluate(val, n_valid=n_val)
                    if psnr > best_psnr:
                        best_psnr, best_epoch, best_iter = psnr, epoch, i
                        if lead:  # written at the epoch's end
                            best_pending = (
                                epoch,
                                {k: v.detach().cpu().clone() for k, v in
                                 trainer.model.state_dict().items()},
                                {"psnr": psnr, "ssim": ssim, "epoch": epoch,
                                 "iter": i})
                    logger.text(
                        f"[Ep {epoch} it {i}] PSNR {psnr:.4f} | SSIM "
                        f"{ssim:.4f} ---- [best Ep {best_epoch} it "
                        f"{best_iter} PSNR {best_psnr:.4f}]")
                    logger.event("eval", epoch=epoch, iter=i, psnr=psnr,
                                 ssim=ssim)
                    eval_seconds += time.time() - te

            losses = (torch.stack(step_losses).cpu().numpy().tolist()
                      if step_losses else [])
            epoch_loss = float(np.sum(losses))
            _sync(device)
            steady_s = max(time.time() - (steady_t0 or t0) - eval_seconds,
                           1e-9)
            img_per_s = steady_images / steady_s if steady_images else 0.0
            mem = {}
            if device.type == "cuda":
                mem["peak_mem_gib"] = (torch.cuda.max_memory_allocated(device)
                                       / 2**30)
            logger.text(
                f"Epoch {epoch}  time {time.time() - t0:.1f}s  loss "
                f"{epoch_loss:.4f}  steady {img_per_s:.1f} img/s"
                + "".join(f"  peak device memory {v:.2f} GiB"
                          for v in mem.values()))
            if best_pending is not None:
                be, bp, bx = best_pending
                save_checkpoint(best_path, be, bp, extra=bx)
                best_pending = None
            logger.event("epoch", epoch=epoch, loss=epoch_loss,
                         step_losses=losses, seconds=time.time() - t0,
                         img_per_s=img_per_s, **mem)
            if lead:
                save_checkpoint(
                    os.path.join(model_dir, f"epoch_model_{epoch}.pth"),
                    epoch, trainer.model.state_dict(),
                    trainer.opt.state_dict())
            if t.keep_ckpts > 0 and lead:
                _prune_epoch_ckpts(model_dir, t.keep_ckpts, epoch)
            if t.exit_after and (epoch - start_epoch + 1) >= t.exit_after \
                    and epoch < t.nepoch:
                logger.text(
                    f"==> --exit_after {t.exit_after}: stopping at epoch "
                    f"{epoch}/{t.nepoch}; resume with --resume "
                    f"--pretrain_weights "
                    f"{os.path.join(model_dir, f'epoch_model_{epoch}.pth')}")
                break
    finally:
        # a run that dies mid-epoch still writes its pending best
        if best_pending is not None:
            be, bp, bx = best_pending
            try:
                save_checkpoint(best_path, be, bp, extra=bx)
            except Exception as fe:
                logger.text(f"==> best-checkpoint flush FAILED ({fe!r}) — "
                            f"Ep {be} pending best not persisted")
    return best_psnr, best_path
