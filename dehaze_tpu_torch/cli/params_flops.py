"""Parameter and FLOP report on the port (counterpart of
`dehaze_tpu/cli/params_flops.py`; ≙ `Number_of_calculated_parameters.py`
and the reference's per-module flops() methods): one eval forward of
--arch at --train_ps² on --device, counted by `utils.flops.model_report`.

    python -m dehaze_tpu_torch.cli.params_flops --arch uformer \\
        --embed_dim 32 --train_ps 128
"""

import argparse

import torch

from dehaze_tpu_torch.cli.common import add_common_args, config_from_args
from dehaze_tpu_torch.models import get_arch
from dehaze_tpu_torch.utils.flops import model_report


def main(argv=None) -> dict:
    p = add_common_args(argparse.ArgumentParser(description="params/flops"))
    args = p.parse_args(argv)
    cfg = config_from_args(args).model
    device = torch.device(args.device)
    model = get_arch(cfg, device=device)  # the counts need no trained weights
    x = torch.zeros((1, args.train_ps, args.train_ps, 3), device=device)
    kw = ({"generator": torch.Generator().manual_seed(0)}
          if cfg.arch == "uformer" else {})
    rep = model_report(model, x, **kw)
    print(f"arch={args.arch} input={args.train_ps}²")
    print(f"Total params: {rep['params']:,}")
    print(f"GFLOPs (FlopCounterMode, 1 forward; K1 and K2 by their "
          f"formulas): {rep['gflops']:.2f}")
    print(f"Bytes moved at least (parameters, input and output once "
          f"each): {rep['bytes']:,.0f}")
    return rep


if __name__ == "__main__":
    main()
