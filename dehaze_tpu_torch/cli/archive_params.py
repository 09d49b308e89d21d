"""Params-only checkpoint archive (counterpart of
`dehaze_tpu/cli/archive_params.py`): trajectory feedstock under bounded
disk.

`cli.train --keep_ckpts N` keeps only the newest N full epoch checkpoints
(weights and AdamW state, whose two moments triple the bytes). This tool
shadows each `epoch_model_{e}.pth` into a params-only copy of the same
name, the payload without its "optimizer" (as `model_best.pth` is
written, `train.checkpoint.save_checkpoint`), before the trainer prunes
it, so `cli.trajectory` still sees every epoch; `utils.convert.
load_weights` reads the copies.

    python -m dehaze_tpu_torch.cli.archive_params --models_dir LOG/models \\
        --out_dir LOG/traj [--watch 60]

One-shot by default; --watch N polls every N seconds until interrupted.
No device and no model code; safe beside a live trainer (epoch files
appear by atomic rename, and so do the copies); a copy that exists is
left as it is.
"""

import argparse
import glob
import os
import re
import time

import torch

from dehaze_tpu_torch.train.checkpoint import load_checkpoint


def archive_once(models_dir: str, out_dir: str) -> int:
    """Shadow new epoch_model_*.pth files as params-only; return count."""
    os.makedirs(out_dir, exist_ok=True)
    new = 0
    for path in sorted(glob.glob(os.path.join(models_dir,
                                              "epoch_model_*.pth"))):
        name = os.path.basename(path)
        if not re.fullmatch(r"epoch_model_\d+\.pth", name):
            continue
        dst = os.path.join(out_dir, name)
        if os.path.exists(dst):
            continue
        payload = load_checkpoint(path)
        slim = {k: v for k, v in payload.items() if k != "optimizer"}
        tmp = dst + ".tmp"
        torch.save(slim, tmp)
        os.replace(tmp, dst)
        new += 1
    return new


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="params-only checkpoint archive")
    p.add_argument("--models_dir", required=True,
                   help="trainer output dir holding epoch_model_{e}.pth")
    p.add_argument("--out_dir", required=True,
                   help="archive dir (params-only copies, same filenames)")
    p.add_argument("--watch", type=int, default=0,
                   help="poll every N seconds (0 = one-shot)")
    args = p.parse_args(argv)

    while True:
        n = archive_once(args.models_dir, args.out_dir)
        total = len(glob.glob(os.path.join(args.out_dir,
                                           "epoch_model_*.pth")))
        print(f"archived {n} new ({total} total)", flush=True)
        if not args.watch:
            return 0
        time.sleep(args.watch)


if __name__ == "__main__":
    main()
