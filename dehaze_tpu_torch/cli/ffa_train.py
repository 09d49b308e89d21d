"""Train FFA-Net, the CNN baseline (counterpart of
`dehaze_tpu/cli/ffa_train.py`).

    python -m dehaze_tpu_torch.cli.ffa_train --train_dir .../train_patches \\
        --val_dir .../test_patches --steps 100000 --eval_step 5000 \\
        --blocks 19 --gps 3 --bs 2 --crop_size 240 [--perloss] \\
        [--device cpu]
    torchrun --nproc_per_node N -m dehaze_tpu_torch.cli.ffa_train ... \\
        --data_axis N

Steps through shuffled epochs of random crops (`train.ffa_trainer`), prints
the previous step's loss as it goes and the validation PSNR/SSIM every
--eval_step steps. Each improvement is written to `ffa_best.pk` in the
reference FFA checkpoint layout, `{step, max_psnr, max_ssim, ssims, psnrs,
losses, model}` (the model's state_dict with the reference's key names),
which the JAX package's `load_reference_ffa_checkpoint` and the port's
`--arch ffa --weights` read; the history goes to `ffa_history.json` at
every evaluation. The last lines give the best PSNR/SSIM and the steady
training rate (img/s after the first step, evaluations excluded).

--data_axis N trains data-parallel over N processes, one per GPU, started
by torchrun (DDP; --bs stays the global batch); rank 0 prints and writes.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time

import torch

from dehaze_tpu_torch.cli.common import start_group
from dehaze_tpu_torch.data.pipeline import (PairedFolder, _val_batches,
                                            train_batches)
from dehaze_tpu_torch.parallel import dist
from dehaze_tpu_torch.train.ffa_trainer import FFATrainer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="train FFA-Net (PyTorch/CUDA "
                                "port)")
    p.add_argument("--train_dir", required=True)
    p.add_argument("--val_dir", required=True)
    p.add_argument("--steps", type=int, default=100000)
    p.add_argument("--eval_step", type=int, default=5000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--gps", type=int, default=3)
    p.add_argument("--blocks", type=int, default=19)
    p.add_argument("--bs", type=int, default=2)
    p.add_argument("--crop_size", type=int, default=240)
    p.add_argument("--perloss", action="store_true")
    p.add_argument("--vgg_weights", default=None,
                   help="converted VGG16 .npz for --perloss (see "
                        "cli.convert_vgg); random-init VGG otherwise")
    p.add_argument("--no_normalize", action="store_true")
    p.add_argument("--data_axis", type=int, default=None,
                   help="data parallelism over N processes, one per GPU, "
                        "under torchrun --nproc_per_node N (DDP)")
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="process group backend with --data_axis (default: "
                        "nccl on CUDA, gloo on the CPU)")
    p.add_argument("--model_dir", default="./FFA_pretrain_weight")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", default="cuda",
                   help="torch device (a missing GPU is an error, not a "
                        "fallback)")
    return p


def save_ffa_checkpoint(path: str, step: int, history: dict,
                        state_dict) -> None:
    """`ffa_best.pk` in the reference layout, written to a temporary file
    that is renamed into place."""
    payload = {"step": step, "max_psnr": history["max_psnr"],
               "max_ssim": history["max_ssim"],
               "ssims": list(history["ssims"]),
               "psnrs": list(history["psnrs"]),
               "losses": list(history["losses"]),
               "model": {k: v.detach().cpu() for k, v in state_dict.items()}}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    a = build_parser().parse_args(argv)
    group = start_group(a)
    n_proc = a.data_axis or 1
    if a.bs % n_proc:
        raise SystemExit(f"--bs {a.bs} not divisible by --data_axis "
                         f"{a.data_axis}")
    lead = dist.rank() == 0
    trainer = FFATrainer(gps=a.gps, blocks=a.blocks, lr=a.lr,
                         total_steps=a.steps, perceptual=a.perloss,
                         normalize=not a.no_normalize,
                         vgg_weights=a.vgg_weights, seed=a.seed,
                         device=a.device, data_parallel=group is not None)
    folder = PairedFolder(a.train_dir)
    val, n_val = _val_batches(PairedFolder(a.val_dir), a.crop_size, a.bs,
                              u8=True)

    def infinite_batches():
        for epoch in itertools.count():
            yield from train_batches(
                folder, batch_size=a.bs, patch_size=a.crop_size, seed=a.seed,
                epoch=epoch, num_workers=8, u8=True,
                process_index=dist.rank(), process_count=n_proc)

    if lead:
        os.makedirs(a.model_dir, exist_ok=True)
    history = {"losses": [], "psnrs": [], "ssims": [], "max_psnr": 0.0,
               "max_ssim": 0.0}
    losses = []  # device scalars, fetched at each evaluation
    steady_t0, eval_s = None, 0.0
    for step, (clean, hazy) in enumerate(infinite_batches(), start=1):
        if step > a.steps:
            break
        losses.append(trainer.train_step(clean, hazy))
        if step == 1:
            _sync(trainer.device)
            steady_t0 = time.perf_counter()
        # the previous step's loss: already computed, so the print does not
        # wait for the step just queued
        if len(losses) >= 2 and lead:
            print(f"\rtrain loss: {float(losses[-2]):.5f} "
                  f"| step {step}/{a.steps}", end="", flush=True)
        if step % a.eval_step == 0:
            t0 = time.perf_counter()
            history["losses"].extend(float(x) for x in losses)
            losses = []
            psnr, ssim = trainer.evaluate(val, n_valid=n_val)
            history["psnrs"].append(psnr)
            history["ssims"].append(ssim)
            if lead:
                print(f"\nstep {step}: PSNR {psnr:.4f} SSIM {ssim:.4f}",
                      flush=True)
            if psnr > history["max_psnr"]:
                history["max_psnr"], history["max_ssim"] = psnr, ssim
                if lead:
                    save_ffa_checkpoint(
                        os.path.join(a.model_dir, "ffa_best.pk"), step,
                        history, trainer.model.state_dict())
            if lead:
                with open(os.path.join(a.model_dir, "ffa_history.json"),
                          "w") as f:
                    json.dump(history, f)
            eval_s += time.perf_counter() - t0
    history["losses"].extend(float(x) for x in losses)
    _sync(trainer.device)
    secs = time.perf_counter() - (steady_t0 or time.perf_counter()) - eval_s
    img_s = (a.steps - 1) * a.bs / secs if a.steps > 1 and secs > 0 else 0.0
    if lead:
        print(f"\nbest PSNR {history['max_psnr']:.4f} SSIM "
              f"{history['max_ssim']:.4f}")
        print(f"{a.steps} steps at batch {a.bs} x {a.crop_size}²: steady "
              f"{img_s:.2f} img/s", flush=True)
    return {**history, "img_s": img_s}


if __name__ == "__main__":
    main()
    dist.shutdown()
