"""Arbitrary-resolution evaluation (counterpart of
`dehaze_tpu/cli/test_anyres.py`): each frame centred on a zero square
canvas whose side is a multiple of win_size·16, with a padding mask for the
attention; per-image PSNR/SSIM and their means.

    python -m dehaze_tpu_torch.cli.test_anyres --input_dir DS/test \\
        --weights model_best.pth [--device cpu]
    torchrun --nproc_per_node N -m dehaze_tpu_torch.cli.test_anyres \\
        --input_dir DS/test --weights model_best.pth --bands N

--bands N splits each canvas's rows over the N processes with halo
exchange (`infer.halo_sharded.make_halo_sharded_anyres_fn`); rank 0 prints.
The JAX CLI has no --data_axis: it is refused here too, as are --arch
ffa|unet (the padding mask exists only in the Uformer).
"""

from __future__ import annotations

import argparse

from dehaze_tpu_torch.cli.common import (add_common_args, add_eval_args,
                                         config_from_args, evaluate,
                                         resolve_forward, start_group)
from dehaze_tpu_torch.infer.anyres import make_anyres_fn
from dehaze_tpu_torch.infer.halo_sharded import make_halo_sharded_anyres_fn
from dehaze_tpu_torch.models.uformer import check_config
from dehaze_tpu_torch.parallel import dist


def build_parser() -> argparse.ArgumentParser:
    p = add_eval_args(add_common_args(argparse.ArgumentParser(
        description="any-resolution eval (PyTorch/CUDA port)")))
    p.set_defaults(result_dir="./results/anyres")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.data_axis is not None:
        raise SystemExit("test_anyres has no --data_axis (nor has the JAX "
                         "CLI); use --bands N")
    cfg = config_from_args(args).model
    if cfg.arch != "uformer":
        raise SystemExit("test_anyres is Uformer-only: the pad-mask input "
                         "path exists only in the Uformer")
    check_config(cfg)
    group = start_group(args)
    fwd = resolve_forward(args, cfg)
    factor = cfg.win_size * 16

    def make_run(h, w):
        if group == "--bands":
            return make_halo_sharded_anyres_fn(
                fwd.model, h, w, factor, seed=args.seed, device=fwd.device)
        return make_anyres_fn(fwd.apply_fn, h, w, factor, device=fwd.device)

    return evaluate(args, make_run)


if __name__ == "__main__":
    main()
    dist.shutdown()
