"""Loss-landscape sweep on the port (counterpart of
`dehaze_tpu/cli/landscape.py`; ≙ `My_losslandscape.py` /
`FFA_losslandscape.py`).

    python -m dehaze_tpu_torch.cli.landscape --weights model_best.pth \\
        --train_dir DS/train --n 21 --out_csv landscape.csv
    torchrun --nproc_per_node N -m dehaze_tpu_torch.cli.landscape \\
        --weights model_best.pth --train_dir DS/train \\
        --points_per_batch P --data_axis N

The loss of a grid point is the model's eval forward on the training set
(`data.pipeline.train_batches` at epoch 0 and --seed, at most
--max_batches batches), through K1 and K2 on the card: Charbonnier +
w_contrast × CR on VGG19 for the Uformer and the UNet; for FFA-Net, L1
(plus 0.04 × the VGG16 perceptual loss with --perloss) on its normalized
hazy input (--no_normalize: raw). Every point sees the same eval stream:
each pass over the set starts a generator at 1, and each batch's MixUp
and ProbSparse sample tables are drawn from it once and shared by every
point evaluated on that batch.

--points_per_batch P evaluates P grid points per loaded batch, each
through `torch.func.functional_call` with its perturbed parameters (the
JAX package vmaps the P points instead). --data_axis N runs one process
per GPU under torchrun: each rank evaluates P / N points of every chunk,
and rank 0 gathers the rows and alone writes the CSV and the figure.
--shard i/n sweeps every n-th point (offset i) and --merge GLOB unions
such CSVs. --out_plot '' skips the figure (which needs matplotlib); the
CSV is complete before any figure is drawn.
"""

from __future__ import annotations

import argparse
from typing import List

import torch
from torch.func import functional_call

from dehaze_tpu_torch.cli.common import (add_common_args,
                                         build_model_and_params,
                                         config_from_args, start_group)
from dehaze_tpu_torch.data.augment import mixup
from dehaze_tpu_torch.data.pipeline import PairedFolder, train_batches
from dehaze_tpu_torch.infer.tiled import normalize_hazy, u8_norm
from dehaze_tpu_torch.models import vgg as vgg_mod
from dehaze_tpu_torch.models.uformer import draw_sample_tables
from dehaze_tpu_torch.ops import landscape as LS
from dehaze_tpu_torch.ops import losses as L
from dehaze_tpu_torch.parallel import dist
from dehaze_tpu_torch.utils.transfer import to_device


def build_parser() -> argparse.ArgumentParser:
    p = add_common_args(argparse.ArgumentParser(
        description="loss landscape (PyTorch/CUDA port)"))
    p.add_argument("--weights", required=True,
                   help=".pth, .pt, .pk or JAX .msgpack checkpoint of "
                        "--arch")
    p.add_argument("--n", type=int, default=21)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--out_csv", default="losslandscape.csv")
    p.add_argument("--out_plot", default="losslandscape.jpg",
                   help="the surface figure ('' for none; needs "
                        "matplotlib)")
    p.add_argument("--max_batches", type=int, default=0,
                   help="cap eval batches per point (0 = full train set, "
                        "matching the reference's 441 full-set evals)")
    p.add_argument("--use_mixup", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="the reference sweeps apply MixUp during the loss "
                        "eval (My_losslandscape.py:193); --no-use_mixup "
                        "disables it for a transform-free sweep")
    p.add_argument("--perloss", action="store_true",
                   help="FFA only: add 0.04×VGG16-perceptual to the L1 "
                        "landscape loss (FFA_.../ops/My_tests.py:86-89)")
    p.add_argument("--no_normalize", action="store_true",
                   help="FFA only: skip the hazy-input Normalize(mean,std) "
                        "the reference's FFA loader applies "
                        "(FFA_model/data_utils.py:79); same flag as "
                        "ffa_train")
    p.add_argument("--points_per_batch", type=int, default=1,
                   help="evaluate P grid points per loaded batch, each "
                        "through functional_call with its perturbed "
                        "parameters; P parameter sets on the device")
    p.add_argument("--shard", default=None,
                   help="'i/n': process every n-th grid point with offset i "
                        "(points are independent; run n processes/hosts and "
                        "merge with --merge)")
    p.add_argument("--merge", default=None, metavar="GLOB",
                   help="skip the sweep: union shard CSVs matching GLOB "
                        "(e.g. 'landscape_*.csv') and plot them "
                        "(≙ the reference crash-merge tool, text.py:18-40)")
    return p


def _plot(rows, out_plot: str) -> None:
    try:
        LS.plot_landscape(rows, out_plot)
    except ImportError as e:
        raise SystemExit(str(e)) from e


def make_landscape_loss(cfg, args, model: torch.nn.Module,
                        device: torch.device):
    """The per-batch loss of the sweep: (prepare, point_loss).
    prepare(clean, hazy, gen) takes one batch (uint8 or float NHWC on the
    device) and the pass's generator, and returns what every point shares
    on it: the MixUp'd (or plain) clean and model input, the sample tables
    and the VGG features of the clean and hazy images. point_loss(params,
    shared) is the scalar loss of the model at `params` on that batch."""
    arch = cfg.model.arch
    is_ffa = arch == "ffa"
    use_cr = cfg.loss.w_contrast > 0 and not is_ffa
    vgg = None
    if use_cr:
        vgg = vgg_mod.make_cr_vgg(dtype=cfg.model.dtype)
    elif is_ffa and args.perloss:
        vgg = vgg_mod.make_perceptual_vgg(dtype=cfg.model.dtype)
    if vgg is not None:
        if cfg.loss.vgg_weights:
            vgg_mod.load_params_npz(vgg, cfg.loss.vgg_weights)
        else:
            vgg_mod.warn_random_vgg("landscape loss")
            vgg_mod.init_vgg_params(vgg, seed=0)
        vgg = vgg.to(device).eval()

    def prepare(clean, hazy, gen: torch.Generator) -> dict:
        clean, hazy = u8_norm(clean), u8_norm(hazy)
        if args.use_mixup:
            clean, hazy = mixup(gen, clean, hazy, cfg.data.mixup_beta)
        tables = (draw_sample_tables(model, gen, device)
                  if arch == "uformer" else None)
        x = normalize_hazy(hazy) if is_ffa and not args.no_normalize \
            else hazy
        feats = None
        if use_cr:
            feats = (vgg(clean), vgg(hazy))
        elif vgg is not None:
            feats = (vgg(clean), None)
        return {"clean": clean, "x": x, "tables": tables, "feats": feats}

    def point_loss(params, shared: dict) -> torch.Tensor:
        kw = ({} if shared["tables"] is None
              else {"sample_tables": shared["tables"]})
        restored = functional_call(model, params, (shared["x"],), kw)
        restored = torch.clamp(restored, 0.0, 1.0)
        clean, feats = shared["clean"], shared["feats"]
        if is_ffa:
            loss = L.l1(restored, clean)
            if vgg is not None:
                loss = loss + 0.04 * L.perceptual_loss_from_features(
                    vgg(restored), feats[0])
            return loss
        loss = cfg.loss.w_charbonnier * L.charbonnier_loss(
            restored, clean, cfg.loss.charbonnier_eps)
        if use_cr:
            l_cr, _, _ = L.contrast_loss_from_features(
                vgg(restored), feats[0], feats[1],
                weights=cfg.loss.contrast_weights,
                ablation=cfg.loss.contrast_ablation)
            loss = loss + cfg.loss.w_contrast * l_cr
        return loss

    return prepare, point_loss


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)

    if args.merge:
        rows = LS.merge_landscape_csvs(args.merge)
        if args.out_plot:
            _plot(rows, args.out_plot)
        print(f"merged {args.merge} -> {len(rows)} points -> "
              f"{args.out_plot or '(no figure)'}")
        return 0

    if args.data_axis and args.data_axis > 1:
        if args.points_per_batch <= 1:
            raise SystemExit("--data_axis needs --points_per_batch > 1")
        if args.points_per_batch % args.data_axis:
            raise SystemExit(
                f"--points_per_batch {args.points_per_batch} not divisible "
                f"by --data_axis {args.data_axis}")
    grouped = start_group(args) is not None
    device = torch.device(args.device)
    lead = dist.rank() == 0
    model = build_model_and_params(cfg.model, args.weights, device)
    params = LS.model_params(model)
    prepare, point_loss = make_landscape_loss(cfg, args, model, device)
    folder = PairedFolder(cfg.data.train_dir)
    rank, world = dist.rank(), dist.world()

    def loss_on_dataset(points: List[LS.Params]) -> List[float]:
        # a process group's rank evaluates its share of the points; the
        # batches, the MixUp and the tables are the same on every rank
        k = len(points) // world
        mine = points[rank * k:(rank + 1) * k]
        gen = torch.Generator().manual_seed(1)
        per_point: List[list] = [[] for _ in mine]
        it = train_batches(folder, batch_size=cfg.data.batch_size,
                           patch_size=cfg.data.train_ps, seed=cfg.train.seed,
                           epoch=0, num_workers=cfg.data.num_workers,
                           u8=cfg.data.u8_transfer)
        for i, (clean, hazy) in enumerate(it):
            if args.max_batches and i >= args.max_batches:
                break
            shared = prepare(to_device(torch.from_numpy(clean), device),
                             to_device(torch.from_numpy(hazy), device), gen)
            for acc, p in zip(per_point, mine):
                acc.append(point_loss(p, shared))
        if not per_point or not per_point[0]:
            raise SystemExit(
                f"no eval batches from --train_dir {cfg.data.train_dir!r} "
                f"(empty dataset, or batch_size {cfg.data.batch_size} > "
                f"image count)")
        losses = [float(torch.stack(acc).mean()) for acc in per_point]
        if grouped:
            losses = [v for part in dist.gather_objects(losses)
                      for v in part]
        return losses

    point_filter = None
    if args.shard:
        i, nshards = (int(s) for s in args.shard.split("/"))
        point_filter = lambda idx: idx % nshards == i  # noqa: E731

    with torch.no_grad():
        rows = LS.get_loss_landscape(
            params, loss_on_dataset, kws=LS.DEFAULT_KWS,
            dims=LS.filter_dims(model), n=args.n, scale=args.scale,
            seed=cfg.train.seed,
            csv_path=args.out_csv if lead else None, verbose=lead,
            point_filter=point_filter,
            points_per_batch=args.points_per_batch,
            agree=(lambda pending: dist.gather_objects(pending)[0])
            if grouped else None)
    if lead:
        all_rows = (LS.load_landscape_csv(args.out_csv) if args.out_csv
                    else rows)
        if args.out_plot:
            _plot(all_rows, args.out_plot)
        print(f"{len(all_rows)} points -> {args.out_csv}, "
              f"{args.out_plot or '(no figure)'}")
    return 0


if __name__ == "__main__":
    try:
        main()
    finally:
        dist.shutdown()
