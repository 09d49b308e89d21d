"""Whole-image evaluation, the published-number protocol (counterpart of
`dehaze_tpu/cli/test_long.py`): each frame wrap-padded onto the square
L×L canvas (or, with --rect_canvas, each side to the next multiple of
--train_ps), one forward, cropped back; per-image PSNR/SSIM and their means.
With --arch ffa, FFA-Net's protocol instead: each frame at its own
resolution, no canvas, its hazy input normalized (--no-ffa_normalize for a
net trained without it); the UNet runs on the canvas.

    python -m dehaze_tpu_torch.cli.test_long --input_dir DS/test \\
        --weights model_best.pth [--rect_canvas] [--device cpu]
    python -m dehaze_tpu_torch.cli.test_long --input_dir DS/test \\
        --exported model.dhz
    torchrun --nproc_per_node N -m dehaze_tpu_torch.cli.test_long \\
        --input_dir DS/test --weights model_best.pth --bands N
    torchrun --nproc_per_node N -m dehaze_tpu_torch.cli.test_long \\
        --input_dir DS/test --weights model_best.pth --data_axis N

--bands N splits each frame's canvas rows (FFA-Net: the frame's own rows,
which must divide by N) over the N processes with halo exchange
(`infer.halo_sharded`; the UNet has no banded forward); --data_axis N
spreads the frames over them, one whole frame per process at a time
(`infer.sharded`; the square canvas, as in the JAX package). Rank 0 prints
the lines of the one-process run, in its order.

With --exported it evaluates a `cli.export` artifact instead (validate
before deploy): its canvas and geometry are baked in, so every frame must
have its geometry, and --rect_canvas, --bands and --data_axis are refused.
"""

from __future__ import annotations

import argparse

from dehaze_tpu_torch.cli.common import (add_common_args, add_eval_args,
                                         config_from_args, evaluate,
                                         resolve_forward, start_group)
from dehaze_tpu_torch.infer.halo_sharded import (make_halo_sharded_frame_fn,
                                                 make_halo_sharded_native_fn)
from dehaze_tpu_torch.infer.tiled import (_as_tensor, make_native_image_fn,
                                          make_whole_image_fn, normalize_hazy,
                                          u8_norm)
from dehaze_tpu_torch.models.uformer import check_config
from dehaze_tpu_torch.parallel import dist


def build_parser() -> argparse.ArgumentParser:
    p = add_eval_args(add_common_args(argparse.ArgumentParser(
        description="whole-image eval (PyTorch/CUDA port)")))
    p.add_argument("--exported", default=None,
                   help="evaluate a cli.export artifact instead of "
                        "--weights (fixed geometry, canvas baked in)")
    p.add_argument("--rect_canvas", action="store_true",
                   help="pad H and W independently instead of the square "
                        "LxL canvas: same crop semantics, -23%% compute on "
                        "1200x1600 (default: square, the reference protocol)")
    p.add_argument("--ffa_normalize", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="--arch ffa only: normalize the hazy input with the "
                        "FFA mean/std (the reference's test protocol and "
                        "the FFA trainer's default); --no-ffa_normalize for "
                        "nets trained with ffa_train --no_normalize")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.exported and (args.bands or args.data_axis is not None
                          or args.rect_canvas):
        raise SystemExit("--exported bakes its canvas and serves "
                         "single-device; drop --bands/--data_axis/"
                         "--rect_canvas")
    if args.data_axis is not None and args.rect_canvas:
        raise SystemExit("--data_axis uses the square published-protocol "
                         "canvas (infer.sharded); drop --rect_canvas")
    cfg = config_from_args(args).model
    if not args.exported and cfg.arch == "uformer":
        check_config(cfg)
    if args.bands and cfg.arch == "unet":
        raise SystemExit("--bands: halo-banded inference exists for the "
                         "Uformer (row-band hooks in the model) and FFA "
                         "(halo convs + rank-averaged pools)")
    group = start_group(args)
    fwd = resolve_forward(args, cfg, ffa_normalize=args.ffa_normalize)
    banded_native = None
    if group == "--bands" and fwd.is_ffa:
        banded_native = make_halo_sharded_native_fn(fwd.model,
                                                    device=fwd.device)

    def make_run(h, w):
        if fwd.mode == "exported":
            if (h, w) != fwd.baked_hw:
                raise SystemExit(
                    f"a frame is {h}x{w} but the artifact bakes "
                    f"{fwd.baked_hw[0]}x{fwd.baked_hw[1]}; re-export for "
                    "this geometry")
            return fwd.base_fn
        if banded_native is not None:
            # the banded runner owns the model's call: normalize here
            def run(x):
                x = u8_norm(_as_tensor(x, fwd.device))
                if args.ffa_normalize:
                    x = normalize_hazy(x)
                return banded_native(x)

            return run
        if fwd.is_ffa:
            return make_native_image_fn(fwd.apply_fn, device=fwd.device)
        if group == "--bands":
            return make_halo_sharded_frame_fn(
                fwd.model, h, w, args.train_ps, square=not args.rect_canvas,
                seed=args.seed, device=fwd.device)
        return make_whole_image_fn(fwd.apply_fn, h, w, args.train_ps,
                                   square=not args.rect_canvas,
                                   device=fwd.device)

    return evaluate(args, make_run, spread=group == "--data_axis")


if __name__ == "__main__":
    main()
    dist.shutdown()
