"""Export a serving artifact (counterpart of `dehaze_tpu/cli/export.py`).

Builds the fixed-geometry whole-image forward of a checkpoint, with the
weights and the ProbSparse sample tables of `--seed` folded in, traces it
with `torch.export` and writes one self-contained file that
`cli.test_long`, `cli.stream` and `cli.serve` take as `--exported` (or any
torch program, through `infer.export.load_exported`), without the model
code or the checkpoint:

    python -m dehaze_tpu_torch.cli.export --weights model_best.pth \\
        --height 1200 --width 1600 --out nh_dehaze.dhz [--square] \\
        [--device cpu]

An artifact traced on the CPU (`--device cpu`) serves on the card too: the
loader moves it there. K1's forward and K2 stay in it as the port's
operators, which launch the CUDA kernels on the card. With --arch ffa the
artifact is FFA-Net's native-resolution forward (`canvas: "native"`, the
hazy-input normalization folded in, --height × --width baked); the UNet
exports on the canvas, as the Uformer does.
"""

from __future__ import annotations

import argparse
import os
import time

import torch
from torch._export.serde.schema import SCHEMA_VERSION

from dehaze_tpu_torch.cli.common import (add_common_args, config_from_args,
                                         one_process, resolve_forward)
from dehaze_tpu_torch.infer.export import (Native, WholeImage,
                                           export_whole_image_bytes,
                                           save_exported)
from dehaze_tpu_torch.models.uformer import draw_sample_tables


def build_parser() -> argparse.ArgumentParser:
    p = add_common_args(argparse.ArgumentParser(
        description="export a serving artifact (PyTorch/CUDA port)"))
    p.add_argument("--weights", required=True,
                   help=".pth, .pt or .pk checkpoint")
    p.add_argument("--height", type=int, default=1200)
    p.add_argument("--width", type=int, default=1600)
    p.add_argument("--out", required=True, help="output artifact path")
    p.add_argument("--square", action="store_true",
                   help="reference square-canvas protocol (default: rect)")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    one_process(args, "cli.export")
    cfg = config_from_args(args).model
    fwd = resolve_forward(args, cfg)
    if fwd.is_ffa:
        # the protocol's normalization folds in, so serving needs no
        # protocol knowledge
        run, canvas = Native(fwd.model), "native"
    else:
        # the tables a --weights forward with this seed draws, on the
        # device (the UNet draws none)
        tables = (draw_sample_tables(fwd.model, torch.Generator().manual_seed(
            args.seed), device=fwd.device) if cfg.arch == "uformer" else None)
        run = WholeImage(fwd.model, tables, args.height, args.width,
                         args.train_ps, args.square)
        canvas = "square" if args.square else "rect"
    t0 = time.perf_counter()
    blob = export_whole_image_bytes(run, args.height, args.width, fwd.device)
    secs = time.perf_counter() - t0
    meta = {
        "arch": cfg.arch,
        "height": args.height,
        "width": args.width,
        "train_ps": args.train_ps,
        "canvas": canvas,
        "embed_dim": cfg.embed_dim,
        "dtype": args.dtype,
        "act_store": cfg.act_store,
        "weights": os.path.basename(args.weights),
        "seed": args.seed,
        # provenance: the tracing device and torch, and the version of the
        # serialized program's schema (loading under another torch is not
        # promised)
        "trace_device": str(fwd.device),
        "torch_version": torch.__version__,
        "export_schema": ".".join(map(str, SCHEMA_VERSION)),
    }
    save_exported(args.out, blob, meta)
    mb = os.path.getsize(args.out) / 1e6
    print(f"exported {canvas}-canvas {args.height}x{args.width} "
          f"{cfg.arch} forward -> {args.out} ({mb:.1f} MB, traced on "
          f"{fwd.device} in {secs:.1f}s)", flush=True)
    return {"meta": meta, "mb": mb, "export_s": secs}


if __name__ == "__main__":
    main()
