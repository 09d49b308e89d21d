"""Augmentations (counterpart of `dehaze_tpu/data/augment.py`).

- Host side: the 8-way dihedral (identity, 3 rot90s, and the 4 flipped
  rotations) on HWC NumPy arrays, the aligned random crop, and the plan of
  both draws for an item seed.
- Device side: crop and dihedral of a device-resident dataset as one
  gather through index maps (the counterpart of `dihedral_dev`); MixUp
  with λ ~ Beta(β, β) per sample and one permutation, the same for gt and
  hazy. Its draws come from an explicit generator through the
  module-level `mixup_draw`, which tests can pin.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def dihedral(img: np.ndarray, k: int) -> np.ndarray:
    """Dihedral transform k ∈ [0, 8) of an HWC array: rot90 by k % 4 in the
    (W, H) plane (axes (1, 0), as torch.rot90(dims=[-1, -2]) on CHW), then
    for k ≥ 4 a flip of H."""
    out = np.rot90(img, k % 4, axes=(1, 0))
    if k >= 4:
        out = out[::-1, :, :]
    return np.ascontiguousarray(out)


def crop_augment_plan(seed: int, h: int, w: int, ps: int):
    """(row, col, k) that `pipeline._load_train_item` draws for item seed
    `seed`: the two crop draws, then the dihedral draw."""
    rng = np.random.default_rng(seed)
    r = 0 if h == ps else int(rng.integers(0, h - ps))
    c = 0 if w == ps else int(rng.integers(0, w - ps))
    k = int(rng.integers(0, 8))
    return r, c, k


def dihedral_index_maps(ps: int, device=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rmap, cmap), two [8, ps, ps] int64 maps on `device`: the square
    patch `dihedral(patch, k)` is `patch[rmap[k], cmap[k]]`. Made by
    `dihedral` itself from the patch's coordinates, so each k transforms
    as the host pipeline does."""
    coords = np.stack(np.meshgrid(np.arange(ps), np.arange(ps),
                                  indexing="ij"), axis=-1)
    maps = np.stack([dihedral(coords, k) for k in range(8)])
    maps = torch.from_numpy(maps.astype(np.int64)).to(device)
    return maps[..., 0], maps[..., 1]


def gather_crops(data: torch.Tensor, sched: torch.Tensor,
                 maps: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """The batch [B, ps, ps, C] that `sched` [B, 4] of (item, row, col, k)
    cuts from the stacked images `data` [N, H, W, C], each crop turned by
    its dihedral k: one indexing op on the data's device."""
    rmap, cmap = maps
    s = sched.to(torch.int64)
    item, r, c = (s[:, i, None, None] for i in range(3))
    k = s[:, 3]
    return data[item, r + rmap[k], c + cmap[k]]


def random_crop_pair(rng: np.random.Generator, clean: np.ndarray,
                     noisy: np.ndarray, ps: int):
    """Aligned random ps² crop of a (clean, noisy) pair."""
    H, W = clean.shape[0], clean.shape[1]
    r = 0 if H == ps else int(rng.integers(0, H - ps))
    c = 0 if W == ps else int(rng.integers(0, W - ps))
    return clean[r:r + ps, c:c + ps], noisy[r:r + ps, c:c + ps]


def mixup_draw(b: int, beta: float, generator: Optional[torch.Generator]
               ) -> Tuple[np.ndarray, np.ndarray]:
    """MixUp's random draws for a batch of b: (λ [b] float32 ~ Beta(β, β),
    permutation [b]). Both come from `generator` (the Beta draw through a
    NumPy generator seeded from it: torch's Beta takes no generator)."""
    perm = torch.randperm(b, generator=generator).numpy()
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    lam = np.random.default_rng(seed).beta(beta, beta, size=b)
    return lam.astype(np.float32), perm


def mixup(generator: Optional[torch.Generator], gt: torch.Tensor,
          hazy: torch.Tensor, beta: float = 1.2):
    """MixUp on the batch's device: a shuffled convex mix with per-sample
    λ, the same λ and permutation for gt and hazy [B, H, W, C]."""
    lam, perm = mixup_draw(gt.shape[0], beta, generator)
    lam = torch.from_numpy(lam).to(gt.device, gt.dtype).reshape(-1, 1, 1, 1)
    idx = torch.from_numpy(perm).to(gt.device)
    return (lam * gt + (1 - lam) * gt[idx],
            lam * hazy + (1 - lam) * hazy[idx])
