"""Shared argparse → config mapping and model loading for the port's CLIs.

Counterpart of `dehaze_tpu/cli/common.py` for the flags the serving,
training and evaluation paths use; flag names are the same. `config_from_args`
returns a `Config`; the serving and evaluation CLIs read its `model`.
`--weights` takes a `.pth`, `.pt` or `.pk` checkpoint (the reference's
formats or a bare state_dict) or a `.msgpack` the JAX package wrote;
`--exported` a `cli.export` artifact, in
place of `--weights` (`resolve_forward`). `--attention full` selects the
W-MSA Uformer, with `--token_projection`, `--token_mlp` and `--se_layer`;
`--arch ffa` FFA-Net (`--ffa_gps`, `--ffa_blocks`, `--ffa_dim`) and
`--arch unet` the conv UNet (`--embed_dim` wide), built by
`models.get_arch`, which refuses the combinations the JAX package refuses.
`--data_axis N` (data-parallel training, frame-parallel evaluation and
streaming) and `--bands N` (one frame's rows over N processes) run one
process per GPU under `torchrun --nproc_per_node N` (`start_group`).
"""

from __future__ import annotations

import argparse
import os
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from dehaze_tpu_torch.config import (Config, DataConfig, LossConfig,
                                     ModelConfig, TrainConfig)
from dehaze_tpu_torch.data.images import load_img, save_img
from dehaze_tpu_torch.data.pipeline import PairedFolder
from dehaze_tpu_torch.infer.sharded import map_frames
from dehaze_tpu_torch.models import get_arch
from dehaze_tpu_torch.ops import metrics as M
from dehaze_tpu_torch.parallel import dist
from dehaze_tpu_torch.utils.convert import load_weights

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def add_common_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--arch", default="uformer",
                   choices=["uformer", "ffa", "unet"],
                   help="the Uformer, FFA-Net (--ffa_*) or the conv UNet "
                        "(--embed_dim wide)")
    p.add_argument("--embed_dim", type=int, default=32)
    p.add_argument("--win_size", type=int, default=8)
    p.add_argument("--token_projection", default="linear",
                   choices=["linear", "conv", "linear_concat"])
    p.add_argument("--token_mlp", default="leff", choices=["leff", "ffn"])
    p.add_argument("--se_layer", action="store_true",
                   help="squeeze-excite after the attention projection "
                        "(attention='full' only)")
    p.add_argument("--attention", default="probsparse",
                   choices=["probsparse", "full"],
                   help="'full': the W-MSA Uformer (one softmax per window)")
    p.add_argument("--no_rel_pos_bias", action="store_true",
                   help="ablation: disable relative position bias")
    p.add_argument("--dtype", default="bfloat16", choices=sorted(_DTYPES))
    p.add_argument("--fast_gelu", action="store_true",
                   help="tanh-approximate GELU in LeFF")
    p.add_argument("--ffa_gps", type=int, default=3)
    p.add_argument("--ffa_blocks", type=int, default=19)
    p.add_argument("--ffa_dim", type=int, default=64,
                   help="FFA conv width (the reference's default 64)")
    p.add_argument("--train_ps", type=int, default=128,
                   help="training patch size: the configured resolution "
                        "and the canvas multiple of whole-image inference")
    p.add_argument("--seed", type=int, default=1234,
                   help="training: seed of the init, the data order and "
                        "the random layers; serving: seed of the "
                        "ProbSparse sampling, re-seeded at every forward")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (a missing GPU is an "
                        "error, not a fallback)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each LeWin block's activations in the "
                        "backward pass (less memory, one more forward); "
                        "the Uformer only: FFA-Net and the UNet ignore it, "
                        "as in the JAX package")
    p.add_argument("--act_store", default=None, choices=["fp8", "int8"],
                   help="quantized activation storage on the INFERENCE "
                        "path (ops/actstore.py): the LeWin blocks' "
                        "activations round-trip through fp8 or int8, "
                        "inside K2 for LeFF's; matmuls stay bf16. The "
                        "Uformer only: FFA-Net and the UNet ignore it")
    # loss
    p.add_argument("--is_ab", action="store_true",
                   help="CR ablation: drop the negative term")
    p.add_argument("--w_loss_vgg7", type=float, default=1.0)
    p.add_argument("--w_loss_CharbonnierLoss", type=float, default=1.0)
    p.add_argument("--vgg_weights", default=None,
                   help="converted torchvision VGG19 weights (.npz)")
    # data
    p.add_argument("--train_dir", default="")
    p.add_argument("--val_dir", default="")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--train_workers", type=int, default=8)
    p.add_argument("--u8_transfer", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="ship batches to the device as uint8 and /255 there")
    p.add_argument("--device_data", action="store_true",
                   help="upload the whole (uniform-size) training set to the "
                        "device once; crop and dihedral run there")
    # train
    p.add_argument("--nepoch", type=int, default=270)
    p.add_argument("--optimizer", default="adamw")
    p.add_argument("--lr_initial", type=float, default=2e-4)
    p.add_argument("--weight_decay", type=float, default=0.02)
    p.add_argument("--warmup", action="store_true", default=False)
    p.add_argument("--warmup_epochs", type=int, default=3)
    p.add_argument("--save_dir", default="./log")
    p.add_argument("--env", default="_")
    p.add_argument("--resume", action="store_true", default=False)
    p.add_argument("--pretrain_weights", default="")
    p.add_argument("--data_axis", type=int, default=None,
                   help="data parallelism over N processes, one per GPU, "
                        "under torchrun --nproc_per_node N: DDP training, "
                        "frames spread over the ranks in evaluation and "
                        "streaming")
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="process group backend with --data_axis/--bands "
                        "(default: nccl on CUDA, gloo on the CPU; two ranks "
                        "on one GPU need gloo)")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="microbatches per optimizer update")
    p.add_argument("--keep_ckpts", type=int, default=0,
                   help="keep only the newest N per-epoch checkpoints "
                        "(0 = all); model_best is never pruned")
    p.add_argument("--exit_after", type=int, default=0,
                   help="stop after N epochs in this process (0 = run to "
                        "--nepoch); continue with --resume")
    return p


def add_eval_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The flags `cli.test_long` and `cli.test_anyres` share."""
    p.add_argument("--input_dir", required=True,
                   help="folder with gt/ and hazy/ PNG pairs")
    p.add_argument("--weights", default=None,
                   help=".pth, .pt, .pk or JAX .msgpack checkpoint")
    p.add_argument("--result_dir", default="./results/long")
    p.add_argument("--save_images",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="--no-save_images skips PNG encoding (metrics only)")
    p.add_argument("--ssim_data_range", type=float, default=2.0,
                   help="2.0 replicates skimage's float default used for the "
                        "published numbers; 1.0 is physically correct")
    p.add_argument("--bands", type=int, default=0,
                   help="split each frame's canvas rows over N processes, "
                        "one per GPU, with halo exchange "
                        "(infer.halo_sharded), under torchrun "
                        "--nproc_per_node N; 0 = one process")
    return p


def start_group(args) -> Optional[str]:
    """`--bands N` or `--data_axis N`: check that torchrun started N
    processes, join them (`parallel.dist.init`, --dist_backend) and point
    args.device at this rank's device. Returns the flag given, or None for
    one process (which must not have been started as several)."""
    bands = getattr(args, "bands", 0) or 0
    axis = getattr(args, "data_axis", None)
    if bands and axis is not None:
        raise SystemExit("--bands and --data_axis are mutually exclusive "
                         "(rows of one frame vs frames per process)")
    if not bands and axis is None:
        if dist.env_world() > 1:
            raise SystemExit(f"{dist.env_world()} processes were launched "
                             "but neither --data_axis nor --bands says how "
                             "to use them")
        return None
    flag, n = ("--bands", bands) if bands else ("--data_axis", axis)
    dist.check_world(flag, n)
    args.device = str(dist.init(args.device, args.dist_backend))
    return flag


def one_process(args, cli: str) -> None:
    """Refuse --data_axis and --bands in a CLI that runs one process."""
    if getattr(args, "data_axis", None) is not None or \
            getattr(args, "bands", 0):
        raise SystemExit(f"{cli} runs in one process: drop --data_axis "
                         "and --bands")


def config_from_args(a: argparse.Namespace) -> Config:
    return Config(
        model=ModelConfig(arch=a.arch, img_size=a.train_ps,
                          embed_dim=a.embed_dim, win_size=a.win_size,
                          token_projection=a.token_projection,
                          token_mlp=a.token_mlp, se_layer=a.se_layer,
                          attention=a.attention,
                          use_rel_pos_bias=not a.no_rel_pos_bias,
                          dtype=_DTYPES[a.dtype], fast_gelu=a.fast_gelu,
                          remat=a.remat, act_store=a.act_store,
                          ffa_gps=a.ffa_gps,
                          ffa_blocks=a.ffa_blocks, ffa_dim=a.ffa_dim),
        loss=LossConfig(w_charbonnier=a.w_loss_CharbonnierLoss,
                        w_contrast=a.w_loss_vgg7, contrast_ablation=a.is_ab,
                        vgg_weights=a.vgg_weights),
        data=DataConfig(train_dir=a.train_dir, val_dir=a.val_dir,
                        train_ps=a.train_ps, batch_size=a.batch_size,
                        num_workers=a.train_workers,
                        u8_transfer=a.u8_transfer,
                        device_data=a.device_data),
        train=TrainConfig(nepoch=a.nepoch, optimizer=a.optimizer,
                          lr_initial=a.lr_initial,
                          weight_decay=a.weight_decay, warmup=a.warmup,
                          warmup_epochs=a.warmup_epochs, seed=a.seed,
                          save_dir=a.save_dir, env=a.env, resume=a.resume,
                          pretrain_weights=a.pretrain_weights,
                          accum_steps=a.accum_steps,
                          keep_ckpts=a.keep_ckpts,
                          exit_after=a.exit_after, data_axis=a.data_axis),
    )


def build_model_and_params(cfg: ModelConfig, weights: str, device
                           ) -> torch.nn.Module:
    """Build cfg.arch's model on `device` (`models.get_arch`), load
    `weights` strictly (`utils.convert.load_weights` reads the arch's
    checkpoint format), eval mode."""
    model = get_arch(cfg, device=device)
    model.load_state_dict(load_weights(weights, cfg.arch), strict=True)
    return model.eval()


def resolve_forward(args, cfg: ModelConfig, ffa_normalize: bool = True
                    ) -> SimpleNamespace:
    """--weights / --exported scaffolding for the serving and evaluation
    CLIs (`cli.export` uses the weights leg only). Exactly one of
    args.weights / args.exported must be set (SystemExit otherwise).
    Returns a namespace:
      mode      'weights' | 'exported'
      is_ffa    FFA-Net, whose protocol is the native resolution (no
                canvas): from cfg.arch, or the artifact's meta
      device    the torch device the forward runs on
      apply_fn  [B, H, W, 3] float on the device (and, for the Uformer, an
                optional padding mask) → [B, H, W, 3] float32 (weights
                mode); the ProbSparse generator is re-seeded from
                args.seed at every forward, so a request's output is
                deterministic; FFA-Net's input is normalized first
                (`infer.tiled.normalize_hazy`) unless
                `ffa_normalize` is False
      model     the built model (weights mode)
      base_fn, meta, baked_hw  the loaded artifact's callable, its meta
                and the (H, W) it bakes (exported mode)"""
    weights = getattr(args, "weights", None)
    exported = getattr(args, "exported", None)
    if bool(weights) == bool(exported):
        raise SystemExit("pass exactly one of --weights / --exported")
    device = torch.device(getattr(args, "device", "cuda"))
    if exported:
        from dehaze_tpu_torch.infer.export import load_exported

        base_fn, meta = load_exported(exported, device)
        return SimpleNamespace(mode="exported", is_ffa=meta["arch"] == "ffa",
                               apply_fn=None, model=None, base_fn=base_fn,
                               meta=meta,
                               baked_hw=(meta["height"], meta["width"]),
                               device=device)
    model = build_model_and_params(cfg, weights, device)
    seed = getattr(args, "seed", 1234)
    is_ffa = cfg.arch == "ffa"

    if cfg.arch == "uformer":
        def apply_fn(x: torch.Tensor, pad_mask=None) -> torch.Tensor:
            return model(x, generator=torch.Generator().manual_seed(seed),
                         pad_mask=pad_mask)
    elif is_ffa and ffa_normalize:
        from dehaze_tpu_torch.infer.tiled import normalize_hazy

        def apply_fn(x: torch.Tensor) -> torch.Tensor:
            return model(normalize_hazy(x))
    else:
        apply_fn = model

    return SimpleNamespace(mode="weights", is_ffa=is_ffa, apply_fn=apply_fn,
                           model=model, base_fn=None, meta=None,
                           baked_hw=None, device=device)


def evaluate(args, make_run, spread: bool = False) -> dict:
    """The evaluation loop of `cli.test_long` and `cli.test_anyres`: every
    gt/hazy pair of `args.input_dir`, in sorted order, through
    `make_run(h, w)` (one function per geometry); a `name: PSNR p SSIM s`
    line per image and the mean line, in the JAX CLIs' format; the outputs
    as PNGs under `args.result_dir` unless --no-save_images. Returns the
    per-image names, PSNRs, SSIMs and wall seconds (forward and metrics;
    the first frame of a geometry includes the kernel builds).

    Under a process group only rank 0 prints. With `spread` (--data_axis)
    frame i is decoded, run, scored and saved on rank i % P, and rank 0
    prints every line in input order once all are in; without it
    (--bands) every rank runs every frame together and rank 0 saves."""
    folder = PairedFolder(args.input_dir)
    lead = dist.rank() == 0
    if args.save_images and (lead or spread):
        os.makedirs(args.result_dir, exist_ok=True)
    runs = {}

    def line(row):
        print(f"{row[0]}: PSNR {row[1]:.4f} SSIM {row[2]:.4f}", flush=True)

    def one(i):
        clean, hazy = (load_img(folder.clean_files[i]),
                       load_img(folder.noisy_files[i]))
        name = os.path.basename(folder.clean_files[i])
        h, w = hazy.shape[:2]
        if (h, w) not in runs:  # one at a time, as the geometry changes
            runs.clear()
            runs[(h, w)] = make_run(h, w)
        t0 = time.perf_counter()
        out = runs[(h, w)](hazy[None])[0]
        ref = torch.from_numpy(clean).to(out.device)
        psnr = float(M.psnr(out, ref))
        ssim = float(M.ssim(out, ref, data_range=args.ssim_data_range))
        row = (name, psnr, ssim, time.perf_counter() - t0)
        if args.save_images and (lead or spread):
            save_img(os.path.join(args.result_dir, name), out.cpu().numpy())
        return row

    if spread:
        rows = map_frames(one, len(folder))
        for row in rows if lead else ():
            line(row)
    else:
        rows = []
        for i in range(len(folder)):
            rows.append(one(i))
            if lead:
                line(rows[-1])
    res = {key: [r[j] for r in rows]
           for j, key in enumerate(("names", "psnr", "ssim", "secs"))}
    # each rank's first frame holds its kernel builds
    secs, first = res["secs"], dist.world() if spread else 1
    if lead:
        print(f"PSNR: {np.mean(res['psnr']):.6f}, "
              f"SSIM: {np.mean(res['ssim']):.6f}")
        print(f"{len(secs)} frames: {np.mean(secs[first:] or secs):.4f} "
              f"s/frame after the first ({np.mean(secs[:first]):.3f} s, "
              "kernel builds included)", flush=True)
    return res
