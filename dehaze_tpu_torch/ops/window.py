"""Window partition / reverse, relative-position index, shift masks.

Counterpart of `dehaze_tpu/ops/window.py`. NHWC throughout; the relative
position index and the SW-MSA region ids are NumPy constants built once per
geometry (lru_cache) and moved to the device by the caller
(`device_constant_cache`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def window_partition(x: torch.Tensor, win: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nWh*nWw, win*win, C] (contiguous)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // win, win, W // win, win, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, C)


def window_reverse(windows: torch.Tensor, win: int, H: int, W: int
                   ) -> torch.Tensor:
    """[B*nWh*nWw, win*win, C] -> [B, H, W, C]; inverse of window_partition."""
    C = windows.shape[-1]
    B = windows.shape[0] // ((H // win) * (W // win))
    x = windows.reshape(B, H // win, W // win, win, win, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


@functools.lru_cache(maxsize=None)
def relative_position_index(win_h: int, win_w: int) -> np.ndarray:
    """Pairwise relative-position index, [N, N] int32 (N = win_h*win_w),
    indexing a [(2*win_h-1)*(2*win_w-1), nH] bias table."""
    coords = np.stack(np.meshgrid(np.arange(win_h), np.arange(win_w),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[:, :, 0] += win_h - 1
    rel[:, :, 1] += win_w - 1
    rel[:, :, 0] *= 2 * win_w - 1
    return rel.sum(-1).astype(np.int32)


def device_constant_cache(fn):
    """`functools.lru_cache(maxsize=64)` for a function that makes a constant
    tensor on a device, bypassed while `torch.export` traces: a tensor made
    during a trace is fake and must not outlive it (a cached one would
    reach the next eager forward)."""
    cached = functools.lru_cache(maxsize=64)(fn)

    @functools.wraps(fn)
    def get(*args):
        if torch.compiler.is_exporting():
            return fn(*args)
        return cached(*args)

    return get


@device_constant_cache
def _relative_position_index_on(win_h: int, win_w: int,
                                device: torch.device) -> torch.Tensor:
    """relative_position_index flattened, as an int64 tensor on `device`
    (copied once per device, not per call). Made outside inference mode, so
    a training forward's index backward may save it."""
    with torch.inference_mode(False):
        return torch.from_numpy(relative_position_index(
            win_h, win_w).reshape(-1).astype(np.int64)).to(device)


def gather_rel_pos_bias(table: torch.Tensor, win_h: int, win_w: int
                        ) -> torch.Tensor:
    """Bias table [(2h-1)*(2w-1), nH] -> per-pair bias [nH, N, N]."""
    n = win_h * win_w
    bias = table[_relative_position_index_on(win_h, win_w, table.device)]
    return bias.reshape(n, n, -1).permute(2, 0, 1)


@functools.lru_cache(maxsize=None)
def shift_region_ids(H: int, W: int, win: int, shift: int) -> np.ndarray:
    """Per-token region ids for the SW-MSA mask, [nW, N] int32: the mask is
    -100 exactly where two tokens of a window carry different ids."""
    if shift == 0:
        raise ValueError("shift_region_ids is only defined for shift > 0")
    img = np.zeros((H, W), dtype=np.int32)
    slices = (slice(0, -win), slice(-win, -shift), slice(-shift, None))
    cnt = 0
    for h in slices:
        for w in slices:
            img[h, w] = cnt
            cnt += 1
    img = img.reshape(H // win, win, W // win, win)
    return np.ascontiguousarray(img.transpose(0, 2, 1, 3).reshape(-1, win * win))


@functools.lru_cache(maxsize=None)
def shift_attn_mask(H: int, W: int, win: int, shift: int) -> np.ndarray:
    """The full [nW, N, N] float32 {0, -100} SW-MSA mask (the reference's
    layout), for tests and tools; the model builds it from
    `shift_region_ids` with `region_mask` instead."""
    region = shift_region_ids(H, W, win, shift)
    diff = region[:, None, :] - region[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def region_mask(region: torch.Tensor) -> torch.Tensor:
    """[..., N] region ids -> [..., N, N] additive {0, -100} float32 mask."""
    diff = region[..., None, :] != region[..., :, None]
    return torch.where(diff, -100.0, 0.0).to(torch.float32)


def cyclic_shift(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Roll H and W of [B, H, W, C] by -shift."""
    return torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))


def cyclic_unshift(x: torch.Tensor, shift: int) -> torch.Tensor:
    return torch.roll(x, shifts=(shift, shift), dims=(1, 2))
