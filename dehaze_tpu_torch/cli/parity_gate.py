"""One-command check of a published checkpoint's PSNR (counterpart of
`dehaze_tpu/cli/parity_gate.py`): the reference's trained `.pth` and a
paired gt/hazy test folder go through the whole-image square protocol, and
the mean PSNR must lie within --tol of --expected_psnr. Exit code 0 when
it does, 1 when it does not.

    python -m dehaze_tpu_torch.cli.parity_gate \\
        --ref_ckpt model_bestPSNR_21.1591_SSIM_0.7765.pth \\
        --input_dir NH-HAZE/test --expected_psnr 21.1591 --tol 0.05

Prints a `name: PSNR p SSIM s` line per image, the mean and the s/frame
lines of the port's eval CLIs, and last the verdict line of the JAX gate.
The ProbSparse sampling generator is seeded 0 for every frame. The model
flags are the common ones: `--attention full` (with `--token_projection`,
`--token_mlp`, `--se_layer`) checks a W-MSA checkpoint.
"""

from __future__ import annotations

import argparse
import sys
from types import SimpleNamespace

import numpy as np
import torch

from dehaze_tpu_torch.cli.common import (add_common_args,
                                         build_model_and_params,
                                         config_from_args, evaluate,
                                         one_process)
from dehaze_tpu_torch.infer.tiled import make_whole_image_fn


def build_parser() -> argparse.ArgumentParser:
    p = add_common_args(argparse.ArgumentParser(description="parity gate"))
    p.add_argument("--ref_ckpt", required=True,
                   help="reference PyTorch .pth ({'state_dict': ...})")
    p.add_argument("--input_dir", required=True,
                   help="folder with gt/ and hazy/ pairs")
    p.add_argument("--expected_psnr", type=float, default=21.1591,
                   help="published NH-HAZE whole-image PSNR")
    p.add_argument("--tol", type=float, default=0.05)
    p.add_argument("--ssim_data_range", type=float, default=2.0)
    return p


def evaluate_checkpoint(cfg, ref_ckpt: str, input_dir: str, train_ps: int,
                        ssim_data_range: float = 2.0, device="cuda"):
    """Mean (PSNR, SSIM) over a paired folder, whole-image square
    protocol, sampling seeded 0 for every frame."""
    device = torch.device(device)
    model = build_model_and_params(cfg, ref_ckpt, device)

    def apply_fn(x):
        return model(x, generator=torch.Generator().manual_seed(0))

    def make_run(h, w):
        return make_whole_image_fn(apply_fn, h, w, train_ps, square=True,
                                   device=device)

    res = evaluate(SimpleNamespace(input_dir=input_dir, save_images=False,
                                   result_dir=None,
                                   ssim_data_range=ssim_data_range), make_run)
    return float(np.mean(res["psnr"])), float(np.mean(res["ssim"]))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    one_process(args, "cli.parity_gate")
    cfg = config_from_args(args).model
    if cfg.arch != "uformer":
        raise SystemExit("cli.parity_gate checks a reference Uformer .pth "
                         "(the JAX gate converts Uformer keys only); "
                         f"--arch {cfg.arch} has no gate")
    psnr, ssim = evaluate_checkpoint(cfg, args.ref_ckpt, args.input_dir,
                                     args.train_ps, args.ssim_data_range,
                                     args.device)
    ok = abs(psnr - args.expected_psnr) <= args.tol
    print(f"PSNR {psnr:.4f} (expected {args.expected_psnr:.4f} ± {args.tol})"
          f"  SSIM {ssim:.4f}  ->  {'PARITY OK' if ok else 'PARITY FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
