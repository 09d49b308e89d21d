"""Host-side input pipeline: paired gt/hazy folders → fixed-shape batches.

Counterpart of `dehaze_tpu/data/pipeline.py` (`val_images` for evaluation;
under data-parallel training each process decodes only its rows of every
global batch) and of the validation batches of
`dehaze_tpu/train/loop.py`. A thread pool decodes PNGs
with the port's codec, random-crops ps² patches and applies the 8-way
dihedral on host NumPy; batches are NHWC uint8 (or float32) NumPy arrays
that the trainer moves to the device. The random draws are the JAX
package's, in the same order, so one seed gives the same batches.

The device-resident mode decodes every pair once (`load_all_pairs`) and
states each epoch's batches as (item, row, col, k) rows
(`epoch_schedule_arrays`) that the trainer gathers on the device.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from collections import deque
from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np

from dehaze_tpu_torch.data.augment import (crop_augment_plan, dihedral,
                                           random_crop_pair)
from dehaze_tpu_torch.data.images import is_png_file, load_img


@dataclass
class PairedFolder:
    """Aligned gt/ and hazy/ PNG pairs under a root."""

    root: str
    gt_dir: str = "gt"
    hazy_dir: str = "hazy"

    def __post_init__(self):
        gt = sorted(os.listdir(os.path.join(self.root, self.gt_dir)))
        hz = sorted(os.listdir(os.path.join(self.root, self.hazy_dir)))
        self.clean_files = [os.path.join(self.root, self.gt_dir, f)
                            for f in gt if is_png_file(f)]
        self.noisy_files = [os.path.join(self.root, self.hazy_dir, f)
                            for f in hz if is_png_file(f)]
        if len(self.clean_files) != len(self.noisy_files):
            raise ValueError(
                f"gt/hazy count mismatch: {len(self.clean_files)} vs "
                f"{len(self.noisy_files)} under {self.root}")

    def __len__(self) -> int:
        return len(self.clean_files)


def _load_train_item(pair: Tuple[str, str], ps: int, seed: int,
                     u8: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    clean = load_img(pair[0], u8=u8)
    noisy = load_img(pair[1], u8=u8)
    clean, noisy = random_crop_pair(rng, clean, noisy, ps)
    k = int(rng.integers(0, 8))
    return dihedral(clean, k), dihedral(noisy, k)


def _epoch_schedule(n: int, batch_size: int, seed: int, epoch: int,
                    drop_last: bool) -> List[List[Tuple[int, int]]]:
    """Deterministic per-epoch plan: a list of batches, each a list of
    (folder_index, item_seed). A short last batch wrap-pads with its own
    leading items, so every batch has exactly `batch_size` rows."""
    rng = np.random.default_rng((seed, epoch))
    order = rng.permutation(n)
    item_seeds = rng.integers(0, 2**63 - 1, size=n)
    items = [(int(order[i]), int(item_seeds[i])) for i in range(n)]
    batches = [items[i:i + batch_size] for i in range(0, n, batch_size)]
    if batches and len(batches[-1]) < batch_size:
        if drop_last:
            batches.pop()
        else:
            last, orig = batches[-1], len(batches[-1])
            while len(last) < batch_size:
                last.append(last[len(last) % orig])
    return batches


def train_batches(folder: PairedFolder, *, batch_size: int, patch_size: int,
                  seed: int, epoch: int, num_workers: int = 8,
                  drop_last: bool = False, u8: bool = False,
                  process_index: int = 0, process_count: int = 1
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One epoch of shuffled (clean, noisy) NHWC batches, float32 in [0, 1]
    or, with `u8=True`, uint8. Deterministic given (seed, epoch). Decoding
    runs `num_workers` items ahead of the consumer.

    `batch_size` is the GLOBAL batch. Process p of P (the ranks of a
    data-parallel run) decodes only rows [p·B/P, (p+1)·B/P) of every
    global batch and yields those, so the P processes' batches stacked in
    rank order are the one-process batches."""
    if batch_size % process_count:
        raise ValueError(
            f"global batch_size {batch_size} must divide evenly across "
            f"{process_count} processes")
    local_bs = batch_size // process_count
    lo = process_index * local_bs
    plan = _epoch_schedule(len(folder), batch_size, seed, epoch, drop_last)
    args = [((folder.clean_files[i], folder.noisy_files[i]), patch_size, s,
             u8) for batch in plan for (i, s) in batch[lo:lo + local_bs]]
    with cf.ThreadPoolExecutor(max_workers=num_workers) as ex:
        lookahead = num_workers + 2
        futs = deque(ex.submit(_load_train_item, *a)
                     for a in args[:lookahead])
        next_submit = lookahead
        buf_c: List[np.ndarray] = []
        buf_n: List[np.ndarray] = []
        for _ in range(len(args)):
            f = futs.popleft()
            if next_submit < len(args):
                futs.append(ex.submit(_load_train_item, *args[next_submit]))
                next_submit += 1
            c, x = f.result()
            buf_c.append(c)
            buf_n.append(x)
            if len(buf_c) == local_bs:
                yield np.stack(buf_c), np.stack(buf_n)
                buf_c, buf_n = [], []


def load_all_pairs(folder: PairedFolder, *, u8: bool = True,
                   num_workers: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Every gt/hazy pair decoded into two stacked [N, H, W, 3] arrays,
    uint8 (or float32 in [0, 1] with `u8=False`), for the device-resident
    dataset. The images must all have one size (patch folders do)."""
    def dec(path):
        return load_img(path, u8=u8)

    with cf.ThreadPoolExecutor(max_workers=num_workers) as ex:
        cleans = list(ex.map(dec, folder.clean_files))
        noisys = list(ex.map(dec, folder.noisy_files))
    shapes = {a.shape for a in cleans} | {a.shape for a in noisys}
    if len(shapes) != 1:
        raise ValueError(
            f"device-resident dataset needs uniform image sizes, got {shapes}"
            f" under {folder.root} — use the streaming pipeline instead")
    return np.stack(cleans), np.stack(noisys)


def epoch_schedule_arrays(n: int, hw: Tuple[int, int], batch_size: int,
                          patch_size: int, seed: int, epoch: int
                          ) -> np.ndarray:
    """[n_batches, B, 4] int32 rows of (item, row, col, dihedral k) for one
    epoch: the plan of `train_batches` (`_epoch_schedule`, the wrap-padded
    short last batch included, and each item's `crop_augment_plan`) as
    indices into `load_all_pairs`' arrays of images of size `hw`."""
    h, w = hw
    plan = _epoch_schedule(n, batch_size, seed, epoch, drop_last=False)
    out = np.empty((len(plan), batch_size, 4), np.int32)
    for bi, batch in enumerate(plan):
        for ri, (i, s) in enumerate(batch):
            out[bi, ri] = (i,) + crop_augment_plan(s, h, w, patch_size)
    return out


def _val_batches(folder: PairedFolder, ps: int, batch_size: int,
                 u8: bool = False):
    """Validation batches: each image center-cropped to ps² (unless it is
    ps² already). Returns (batches, n_images); a short last batch wraps to
    index 0, so pass n_images as `Trainer.evaluate(n_valid=)`."""
    items_c, items_n = [], []
    for c, n in zip(folder.clean_files, folder.noisy_files):
        ci, ni = load_img(c, u8=u8), load_img(n, u8=u8)
        h, w = ci.shape[:2]
        if (h, w) != (ps, ps):
            r = max((h - ps) // 2, 0)
            s = max((w - ps) // 2, 0)
            ci, ni = ci[r:r + ps, s:s + ps], ni[r:r + ps, s:s + ps]
        items_c.append(ci)
        items_n.append(ni)
    n_images = len(items_c)
    batches = []
    for i in range(0, n_images, batch_size):
        idx = [(i + j) % n_images for j in range(batch_size)]
        batches.append((np.stack([items_c[j] for j in idx]),
                        np.stack([items_n[j] for j in idx])))
    return batches, n_images


def val_images(folder: PairedFolder
               ) -> Iterator[Tuple[np.ndarray, np.ndarray, str]]:
    """Whole (clean, hazy, file name) images, float32 [0, 1], unshuffled, in
    the folder's sorted order; the name is the clean file's."""
    for c, x in zip(folder.clean_files, folder.noisy_files):
        yield load_img(c), load_img(x), os.path.basename(c)



def test_images(rgb_dir: str, subdir: str = "HAZY"
                ) -> Iterator[Tuple[np.ndarray, str]]:
    """Hazy-only (image, file name) pairs, float32 [0, 1], in sorted order,
    from `rgb_dir/subdir`, or from `rgb_dir` itself with subdir='' (the
    reference's DataLoaderTest and DataLoaderTestSR)."""
    root = os.path.join(rgb_dir, subdir) if subdir else rgb_dir
    for f in sorted(os.listdir(root)):
        if is_png_file(f):
            yield load_img(os.path.join(root, f)), f


def gaussian_train_batches(clean_dir: str, *, batch_size: int,
                           patch_size: int, seed: int, epoch: int,
                           noise_level: float = 5.0, num_workers: int = 8
                           ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """The denoising variant (counterpart of `dehaze_tpu/data/pipeline.py:
    gaussian_train_batches`, ≙ the reference's DataLoaderTrain_Gaussian):
    one epoch of the PNGs under `clean_dir` in the order of
    `default_rng((seed, epoch, 7))`, each item with noisy = clean +
    N(0, level)/255 clipped to [0, 1] from its own seed, then the crop and
    dihedral draws; a short last batch wrap-pads with its own items. The
    same bytes as the JAX package's."""
    files = sorted(os.path.join(clean_dir, f) for f in os.listdir(clean_dir)
                   if is_png_file(f))
    rng = np.random.default_rng((seed, epoch, 7))
    order = rng.permutation(len(files))
    item_seeds = rng.integers(0, 2**63 - 1, size=len(files))

    def load(i, s):
        r = np.random.default_rng(int(s))
        clean = load_img(files[i])
        noisy = np.clip(clean + r.normal(0, noise_level, clean.shape)
                        .astype(np.float32) / 255.0, 0.0, 1.0)
        clean, noisy = random_crop_pair(r, clean, noisy, patch_size)
        k = int(r.integers(0, 8))
        return dihedral(clean, k), dihedral(noisy, k)

    with cf.ThreadPoolExecutor(max_workers=num_workers) as ex:
        futs = [ex.submit(load, int(i), int(s))
                for i, s in zip(order, item_seeds)]
        buf_c: List[np.ndarray] = []
        buf_n: List[np.ndarray] = []
        for f in futs:
            c, x = f.result()
            buf_c.append(c)
            buf_n.append(x)
            if len(buf_c) == batch_size:
                yield np.stack(buf_c), np.stack(buf_n)
                buf_c, buf_n = [], []
        if buf_c:
            orig = len(buf_c)
            while len(buf_c) < batch_size:
                buf_c.append(buf_c[len(buf_c) % orig])
                buf_n.append(buf_n[len(buf_n) % orig])
            yield np.stack(buf_c), np.stack(buf_n)
