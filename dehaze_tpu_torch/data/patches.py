"""Offline patch generator (counterpart of `dehaze_tpu/data/patches.py`;
the reference's `Uformer_ProbSparse/generate_patches_SIDD.py`).

For each gt/hazy pair i, cut `num_patches` random `ps`² crops and write
`tar/{gt,hazy}/{i+1}_{j+1}.png`: the crops of the JAX package (the same
`np.random.default_rng((seed, i))` draws), encoded by the port's codec
(`data.images`). Parallel over pairs in a pool of spawned processes (a
forked child of a process that holds a CUDA context and thread pools can
deadlock); the target dir is recreated (the reference `rm -r`s it,
`:40-41`).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import shutil
from functools import partial
from typing import Optional

import numpy as np

from dehaze_tpu_torch.data.images import load_img, save_img


def _process_pair(args, *, tar_dir: str, ps: int, num_patches: int,
                  seed: int) -> int:
    i, (clean_path, noisy_path) = args
    rng = np.random.default_rng((seed, i))
    clean = load_img(clean_path, u8=True)
    noisy = load_img(noisy_path, u8=True)
    H, W = clean.shape[:2]
    for j in range(num_patches):
        r = 0 if H == ps else int(rng.integers(0, H - ps))
        c = 0 if W == ps else int(rng.integers(0, W - ps))
        save_img(os.path.join(tar_dir, "gt", f"{i + 1}_{j + 1}.png"),
                 clean[r:r + ps, c:c + ps])
        save_img(os.path.join(tar_dir, "hazy", f"{i + 1}_{j + 1}.png"),
                 noisy[r:r + ps, c:c + ps])
    return i


def generate_patches(src_dir: str, tar_dir: str, *, ps: int = 256,
                     num_patches: int = 500,
                     num_workers: Optional[int] = None,
                     seed: int = 1234) -> int:
    """Crop num_patches random ps² patches per pair; returns #pairs
    processed."""
    if os.path.exists(tar_dir):
        shutil.rmtree(tar_dir)
    os.makedirs(os.path.join(tar_dir, "gt"))
    os.makedirs(os.path.join(tar_dir, "hazy"))

    # imported here: a spawned worker imports this module, and the
    # pipeline's torch import would cost it seconds
    from dehaze_tpu_torch.data.pipeline import PairedFolder

    folder = PairedFolder(src_dir)
    pairs = list(enumerate(zip(folder.clean_files, folder.noisy_files)))
    fn = partial(_process_pair, tar_dir=tar_dir, ps=ps,
                 num_patches=num_patches, seed=seed)
    workers = min(num_workers or 10, os.cpu_count() or 1, len(pairs) or 1)
    if workers <= 1:
        for p in pairs:
            fn(p)
    else:
        with mp.get_context("spawn").Pool(workers) as pool:
            pool.map(fn, pairs)
    return len(pairs)
