"""Train the dehazing model on the port (counterpart of
`dehaze_tpu/cli/train.py`).

    python -m dehaze_tpu_torch.cli.train --train_dir DS/train \
        --val_dir DS/val --nepoch 270 --batch_size 32 --train_ps 128 \
        --embed_dim 32 --warmup [--device cpu]
"""

import argparse

from dehaze_tpu_torch.cli.common import add_common_args, config_from_args
from dehaze_tpu_torch.train.loop import fit


def main(argv=None):
    p = add_common_args(argparse.ArgumentParser(description="remove the haze"))
    args = p.parse_args(argv)
    best_psnr, ckpt = fit(config_from_args(args), device=args.device)
    print(f"best PSNR {best_psnr:.4f} | checkpoint {ckpt}")


if __name__ == "__main__":
    main()
