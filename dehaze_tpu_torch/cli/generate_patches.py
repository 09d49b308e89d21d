"""Offline patch cropper on the port (counterpart of
`dehaze_tpu/cli/generate_patches.py`; ≙ `generate_patches_SIDD.py`).

    python -m dehaze_tpu_torch.cli.generate_patches --src_dir DS/train \\
        --tar_dir DS/train_patches --ps 256 --num_patches 500
"""

import argparse

from dehaze_tpu_torch.data.patches import generate_patches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="generate training patches")
    p.add_argument("--src_dir", required=True)
    p.add_argument("--tar_dir", required=True)
    p.add_argument("--ps", type=int, default=256)
    p.add_argument("--num_patches", type=int, default=500)
    p.add_argument("--num_cores", type=int, default=10)
    p.add_argument("--seed", type=int, default=1234)
    a = p.parse_args(argv)
    n = generate_patches(a.src_dir, a.tar_dir, ps=a.ps,
                         num_patches=a.num_patches, num_workers=a.num_cores,
                         seed=a.seed)
    print(f"processed {n} image pairs -> {a.tar_dir}")
    return 0


if __name__ == "__main__":
    main()
