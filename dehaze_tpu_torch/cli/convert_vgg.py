"""Convert torchvision VGG weights (a `features` `.pth` state_dict) to the
`.npz` that `models.vgg.load_params_npz` reads and `--vgg_weights` takes
(counterpart of `dehaze_tpu/cli/convert_vgg.py`). Keys gain a `features.`
prefix where they lack one; the arrays are written as they are.

    # where torchvision and its weights are at hand:
    python -c "import torch, torchvision; torch.save(torchvision.models.\\
vgg19(weights='DEFAULT').features.state_dict(), 'vgg19_features.pth')"
    # then:
    python -m dehaze_tpu_torch.cli.convert_vgg --pth vgg19_features.pth \\
        --out vgg19.npz
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def convert(pth_path: str, out_path: str) -> int:
    """Write `pth_path`'s tensors to `out_path`; returns how many."""
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    arrays = {(k if k.startswith("features.") else f"features.{k}"):
              v.numpy() for k, v in sd.items()}
    np.savez(out_path, **arrays)
    return len(arrays)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="torchvision VGG -> npz")
    p.add_argument("--pth", required=True)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    n = convert(a.pth, a.out)
    print(f"wrote {n} arrays -> {a.out}")


if __name__ == "__main__":
    main()
