"""Whole-image evaluation, the published-number protocol (counterpart of
`dehaze_tpu/cli/test_long.py`): each frame wrap-padded onto the square
L×L canvas (or, with --rect_canvas, each side to the next multiple of
--train_ps), one forward, cropped back; per-image PSNR/SSIM and their means.

    python -m dehaze_tpu_torch.cli.test_long --input_dir DS/test \\
        --weights model_best.pth [--rect_canvas] [--device cpu]
"""

from __future__ import annotations

import argparse

from dehaze_tpu_torch.cli.common import (add_common_args, add_eval_args,
                                         config_from_args, evaluate,
                                         resolve_forward)
from dehaze_tpu_torch.infer.tiled import make_whole_image_fn
from dehaze_tpu_torch.models.uformer import check_config


def build_parser() -> argparse.ArgumentParser:
    p = add_eval_args(add_common_args(argparse.ArgumentParser(
        description="whole-image eval (PyTorch/CUDA port)")))
    p.add_argument("--rect_canvas", action="store_true",
                   help="pad H and W independently instead of the square "
                        "LxL canvas: same crop semantics, -23%% compute on "
                        "1200x1600 (default: square, the reference protocol)")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args).model
    check_config(cfg)
    fwd = resolve_forward(args, cfg)

    def make_run(h, w):
        return make_whole_image_fn(fwd.apply_fn, h, w, args.train_ps,
                                   square=not args.rect_canvas,
                                   device=fwd.device)

    return evaluate(args, make_run)


if __name__ == "__main__":
    main()
