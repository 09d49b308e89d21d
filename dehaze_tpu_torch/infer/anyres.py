"""Arbitrary-resolution inference: centre-pad to a square plus a padding
mask (counterpart of `dehaze_tpu/infer/anyres.py`).

The frame is placed at the centre of a zero X×X canvas, X = ceil(max(h, w) /
factor)·factor (factor = win_size · 2⁴ = 128 for the flagship); the model
gets a mask that is 1 on the padding, which the attention turns into −100
between padded tokens; the output is cropped back to h×w and clipped to
[0, 1].
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from dehaze_tpu_torch.infer.tiled import _as_tensor, u8_norm


def expand2square(img: torch.Tensor, factor: int = 128
                  ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, int]]:
    """[B, H, W, C] -> (canvas [B, X, X, C], pad_mask [1, X, X, 1] float32,
    (r0, c0)), both on img's device; pad_mask is 1 on PADDING."""
    B, h, w, C = img.shape
    X = int(math.ceil(max(h, w) / float(factor)) * factor)
    r0, c0 = (X - h) // 2, (X - w) // 2
    canvas = img.new_zeros((B, X, X, C))
    canvas[:, r0:r0 + h, c0:c0 + w] = img
    pad = torch.ones((1, X, X, 1), dtype=torch.float32, device=img.device)
    pad[:, r0:r0 + h, c0:c0 + w] = 0.0
    return canvas, pad, (r0, c0)


def make_anyres_fn(apply_fn: Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor],
                   h: int, w: int, factor: int = 128, device="cuda"
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """[B, h, w, C] (float in [0, 1] or raw uint8, tensor or ndarray) ->
    restored float32 [B, h, w, C] on `device` (the card unless the caller
    asks for the CPU). apply_fn(canvas, pad_mask) runs the model."""

    @torch.inference_mode()
    def run(img):
        canvas, pad, (r0, c0) = expand2square(
            u8_norm(_as_tensor(img, device)), factor)
        out = apply_fn(canvas, pad)
        return torch.clamp(out[:, r0:r0 + h, c0:c0 + w], 0.0, 1.0)

    return run
