"""Train the dehazing model on the port (counterpart of
`dehaze_tpu/cli/train.py`).

    python -m dehaze_tpu_torch.cli.train --train_dir DS/train \
        --val_dir DS/val --nepoch 270 --batch_size 32 --train_ps 128 \
        --embed_dim 32 --warmup [--device cpu]
    torchrun --nproc_per_node N -m dehaze_tpu_torch.cli.train ... \
        --data_axis N

--data_axis N trains data-parallel over N processes, one per GPU
(`train.loop.fit`): --batch_size stays the global batch. --arch ffa|unet
trains FFA-Net or the UNet under this recipe (Charbonnier + CR, AdamW,
the epoch lr table), as the JAX trainer does; FFA-Net's own recipe is
`cli.ffa_train`.
"""

import argparse

from dehaze_tpu_torch.cli.common import (add_common_args, config_from_args,
                                         start_group)
from dehaze_tpu_torch.parallel import dist
from dehaze_tpu_torch.train.loop import fit


def main(argv=None):
    p = add_common_args(argparse.ArgumentParser(description="remove the haze"))
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    start_group(args)
    best_psnr, ckpt = fit(cfg, device=args.device)
    if dist.rank() == 0:
        print(f"best PSNR {best_psnr:.4f} | checkpoint {ckpt}")


if __name__ == "__main__":
    main()
    dist.shutdown()
