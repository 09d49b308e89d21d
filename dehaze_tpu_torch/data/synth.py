"""Synthetic haze pairs (counterpart of `dehaze_tpu/data/synth.py`).

Stand-in data for smoke tests and benchmarks where no dataset exists:

    J = clean scene (smooth random colour fields plus sharp rectangles)
    t = exp(-beta * d), d a smooth random depth map
    I = J * t + A * (1 - t)        (the atmospheric scattering model)

A seed fixes the dataset. Same generator and draw order as the JAX
package, so one seed gives the same pairs in both.

    python -m dehaze_tpu_torch.data.synth --out DIR --n 256 --size 256
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from dehaze_tpu_torch.data.images import save_img


def _smooth_field(rng: np.random.Generator, shape: Tuple[int, int], grid: int,
                  channels: int = 1) -> np.ndarray:
    """[h, w, channels] in [0, 1]: a bilinearly upsampled random grid."""
    h, w = shape
    coarse = rng.uniform(size=(grid, grid, channels)).astype(np.float32)

    def axis_interp(arr, axis_len, axis):
        idx = np.linspace(0, grid - 1, axis_len)
        i0 = np.clip(np.floor(idx).astype(int), 0, grid - 2)
        f = (idx - i0).astype(np.float32)
        lo = np.take(arr, i0, axis=axis)
        hi = np.take(arr, i0 + 1, axis=axis)
        fshape = [1, 1, 1]
        fshape[axis] = axis_len
        f = f.reshape(fshape)
        return lo * (1 - f) + hi * f

    rows = axis_interp(coarse, h, axis=0)
    return axis_interp(rows, w, axis=1)


def make_scene(rng: np.random.Generator, size
               ) -> Tuple[np.ndarray, np.ndarray]:
    """One (clean, hazy) pair, float32 [h, w, 3] in [0, 1]; `size` is an int
    (square) or an (h, w) tuple."""
    h, w = (size, size) if isinstance(size, int) else size
    clean = 0.15 + 0.7 * _smooth_field(rng, (h, w), grid=6, channels=3)
    for _ in range(6):  # sharp rectangles: edges to restore
        h0 = int(rng.integers(0, h - 8))
        w0 = int(rng.integers(0, w - 8))
        h1 = h0 + int(rng.integers(4, max(5, h // 3)))
        w1 = w0 + int(rng.integers(4, max(5, w // 3)))
        clean[h0:h1, w0:w1] = rng.uniform(0.05, 0.95, size=3).astype(
            np.float32)
    depth = _smooth_field(rng, (h, w), grid=4)[..., 0]
    beta = rng.uniform(1.0, 3.0)
    t = np.exp(-beta * depth)[..., None].astype(np.float32)
    airlight = rng.uniform(0.7, 1.0)
    hazy = clean * t + airlight * (1.0 - t)
    return np.clip(clean, 0, 1), np.clip(hazy, 0, 1).astype(np.float32)


def write_dataset(root: str, n: int, size, seed: int = 0) -> None:
    """Write n (gt, hazy) PNG pairs under root/gt and root/hazy."""
    gt_dir = os.path.join(root, "gt")
    hz_dir = os.path.join(root, "hazy")
    os.makedirs(gt_dir, exist_ok=True)
    os.makedirs(hz_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        clean, hazy = make_scene(rng, size)
        save_img(os.path.join(gt_dir, f"{i:05d}.png"), clean)
        save_img(os.path.join(hz_dir, f"{i:05d}.png"), hazy)


def main():
    import argparse

    p = argparse.ArgumentParser(description="synthetic haze dataset")
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--size", type=int, default=128,
                   help="square size; overridden by --height/--width")
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args()
    size = (a.height, a.width) if a.height and a.width else a.size
    write_dataset(a.out, a.n, size, a.seed)
    geom = f"{size[0]}x{size[1]}" if isinstance(size, tuple) \
        else f"{size}x{size}"
    print(f"{a.n} pairs of {geom} -> {a.out}")


if __name__ == "__main__":
    main()
