"""Optimization-trajectory polar plot on the port (counterpart of
`dehaze_tpu/cli/trajectory.py`; ≙ `My_Trajectories in polar
coordinates.py`): every `epoch_model_{e}.pth` of --ckpt_dir (as
`cli.train` or `cli.archive_params` writes them) in epoch order, every
--stride-th, against --best. A directory of the JAX package's run, with
no `.pth`, gives its `epoch_model_{e}.msgpack` files; --best may be
either kind.

    python -m dehaze_tpu_torch.cli.trajectory --ckpt_dir LOG/models \\
        --best LOG/models/model_best.pth --out trajectory.png

The checkpoints' tensors are the named parameters of --arch's model; the
norms run on --device. --out '' prints the points without the figure
(which needs matplotlib).
"""

import argparse
import glob
import os
import re

import torch

from dehaze_tpu_torch.cli.common import add_common_args, config_from_args
from dehaze_tpu_torch.models import get_arch
from dehaze_tpu_torch.ops.trajectory import plot_trajectory, trajectory
from dehaze_tpu_torch.utils.convert import load_weights


def main(argv=None) -> int:
    p = add_common_args(argparse.ArgumentParser(description="trajectory plot"))
    p.add_argument("--ckpt_dir", required=True,
                   help="dir of epoch_model_{e}.pth (or, with none, the "
                        "JAX package's .msgpack) checkpoints")
    p.add_argument("--best", required=True)
    p.add_argument("--out", default="trajectory.png",
                   help="the polar figure ('' for none; needs matplotlib)")
    p.add_argument("--stride", type=int, default=1,
                   help="take every k-th epoch")
    args = p.parse_args(argv)
    cfg = config_from_args(args).model
    device = torch.device(args.device)
    # the parameter names of the arch, from a model that allocates nothing
    names = [k for k, _ in get_arch(cfg, device="meta").named_parameters()]

    def load(path):
        sd = load_weights(path, cfg.arch)
        missing = [k for k in names if k not in sd]
        if missing:
            raise SystemExit(f"{path} lacks {len(missing)} parameters of "
                             f"--arch {cfg.arch}, e.g. {missing[0]}")
        return {k: sd[k].to(device) for k in names}

    paths = (glob.glob(os.path.join(args.ckpt_dir, "epoch_model_*.pth"))
             or glob.glob(os.path.join(args.ckpt_dir,
                                       "epoch_model_*.msgpack")))
    paths.sort(key=lambda s: int(re.search(r"epoch_model_(\d+)",
                                           s).group(1)))
    paths = paths[::args.stride]
    if not paths:
        raise SystemExit(f"no epoch_model_*.pth or .msgpack under "
                         f"{args.ckpt_dir}")
    ckpts = [load(p_) for p_ in paths]
    pts = trajectory(ckpts, load(args.best))
    if args.out:
        try:
            plot_trajectory(pts, args.out)
        except ImportError as e:
            raise SystemExit(str(e)) from e
    print(f"{len(pts)} checkpoints -> {args.out or '(no figure)'}")
    for path, (theta, r) in zip(paths, pts):
        print(f"{os.path.basename(path)}: theta={theta:.4f} r={r:.4f}")
    return 0


if __name__ == "__main__":
    main()
