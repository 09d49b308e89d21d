"""Sustained-throughput folder dehazing, serving mode (counterpart of
`dehaze_tpu/cli/stream.py`).

Pipelines image decode → whole-image forward → PNG encode
(`infer.stream`), unlike the reference's strictly serial loop, where the
card idles during host IO.

    python -m dehaze_tpu_torch.cli.stream --input_dir .../test/hazy \\
        --weights model_best.pth --result_dir ./out [--square]
    python -m dehaze_tpu_torch.cli.stream --input_dir .../test/hazy \\
        --exported model.dhz --result_dir ./out
    torchrun --nproc_per_node N -m dehaze_tpu_torch.cli.stream \\
        --input_dir .../test/hazy --weights model_best.pth --data_axis N

Reads PNG, JPEG and BMP frames and writes each result as a PNG of the
input's name; FFA-Net (--arch ffa) runs each frame at its own resolution,
with no canvas. Prints one summary line with the sustained Mpix/s (decode,
forward and encode together). With --data_axis N each of the N processes
decodes, runs and encodes its share of the folder on its own GPU, and
rank 0 prints the time split summed over them and the rate of all frames.
"""

from __future__ import annotations

import argparse
import os
from functools import partial

from dehaze_tpu_torch.cli.common import (add_common_args, config_from_args,
                                         resolve_forward, start_group)
from dehaze_tpu_torch.data.images import load_img
from dehaze_tpu_torch.infer.stream import stream_dehaze
from dehaze_tpu_torch.parallel import dist


def build_parser() -> argparse.ArgumentParser:
    p = add_common_args(argparse.ArgumentParser(
        description="streaming dehaze (PyTorch/CUDA port)"))
    p.add_argument("--input_dir", required=True,
                   help="directory of hazy images (flat, or a HAZY/ subdir)")
    p.add_argument("--weights", default=None,
                   help=".pth, .pt or .pk checkpoint")
    p.add_argument("--exported", default=None,
                   help="serve a cli.export artifact instead of --weights "
                        "(no model rebuild; fixed geometry)")
    p.add_argument("--result_dir", default="./results/stream")
    p.add_argument("--square", action="store_true",
                   help="use the reference's square canvas protocol "
                        "(default: rectangular wrap-pad, same crop, faster)")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.exported and args.data_axis is not None:
        raise SystemExit("--exported serves single-device; drop "
                         "--data_axis or serve from --weights")
    group = start_group(args)
    fwd = resolve_forward(args, config_from_args(args).model)

    src = args.input_dir
    sub = os.path.join(src, "HAZY")
    if os.path.isdir(sub):
        src = sub
    names = sorted(
        f for f in os.listdir(src)
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")))
    if not names:
        raise SystemExit(f"no images found in {src}")
    os.makedirs(args.result_dir, exist_ok=True)  # every rank writes
    # outputs are PNG whatever the input's format (the port encodes PNG
    # only), named after the input
    frames = [(os.path.join(src, n), os.path.join(
        args.result_dir, os.path.splitext(n)[0] + ".png")) for n in names]

    # live weights decode straight to uint8 and normalize on the device (4x
    # fewer bytes to the card per frame); an artifact bakes a float32 input
    load_fn = (partial(load_img, u8=True)
               if fwd.mode == "weights" and args.u8_transfer else load_img)
    stats = stream_dehaze(fwd.apply_fn, frames, ps=args.train_ps,
                          square=args.square, load_fn=load_fn,
                          base_fn=fwd.base_fn, base_hw=fwd.baked_hw,
                          device=fwd.device, native=fwd.is_ffa,
                          data_parallel=group == "--data_axis")
    canvas = ("exported" if fwd.mode == "exported"
              else "native" if fwd.is_ffa
              else "square" if args.square else "rect")
    if dist.rank() > 0:
        return stats
    chips = f", {args.data_axis} processes" if group else ""
    print("time split, s summed over the frames: " + ", ".join(
        f"{k} {stats[k]:.3f}" for k in ("decode", "queue", "wait_card",
                                         "wait_decode", "encode")),
          flush=True)
    print(f"{stats['frames']} frames in {stats['sec']:.2f}s = "
          f"{stats['mpix_s']:.3f} Mpix/s sustained ({canvas} canvas"
          f"{chips})",
          flush=True)
    return stats


if __name__ == "__main__":
    main()
    dist.shutdown()
