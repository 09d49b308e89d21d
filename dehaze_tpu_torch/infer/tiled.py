"""Whole-image inference: wrap-pad onto a canvas, one forward, crop.

Counterpart of `dehaze_tpu/infer/tiled.py`. The published protocol places an
H×W frame on a canvas whose sides are the NEXT multiple of `ps` (even when
already divisible), fills the margins by wrapping, runs one forward, crops
back to H×W and clamps to [0, 1]. The wrap keeps the reference's quirk: the
bottom rows are copied from the already right-padded canvas, so the
bottom-right corner holds the top-left strip. FFA-Net's protocol has no
canvas: the frame at its own resolution (`make_native_image_fn`).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from dehaze_tpu_torch.utils.transfer import to_device


def canvas_size(h: int, w: int, ps: int) -> int:
    """Square canvas side L = (max(H, W) // ps + 1) * ps."""
    return (max(h, w) // ps + 1) * ps


def rect_canvas_size(h: int, w: int, ps: int):
    """(L, Lw): each axis bumped to the NEXT multiple of ps."""
    return (h // ps + 1) * ps, (w // ps + 1) * ps


def u8_norm(x: torch.Tensor) -> torch.Tensor:
    """uint8 → float32 / 255 on the tensor's device; floats pass through."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    return x


def wrap_pad_canvas(img: torch.Tensor, L: int, Lw: Optional[int] = None
                    ) -> torch.Tensor:
    """[B, H, W, C] → [B, L, Lw, C] with the reference's wrap padding."""
    B, H, W, C = img.shape
    Lw = L if Lw is None else Lw
    l_w, l_h = Lw - W, L - H
    canvas = img.new_zeros((B, L, Lw, C))
    canvas[:, :H, :W] = img
    if l_w > 0:
        canvas[:, :H, W:W + l_w] = img[:, :, :l_w]
    if l_h > 0:
        canvas[:, H:H + l_h] = canvas[:, :l_h].clone()
    return canvas


def _as_tensor(img, device) -> torch.Tensor:
    """`img` (tensor or ndarray) on `device`; a host frame bound for the
    card goes through pinned memory, so the copy does not wait for the
    work already queued there (`utils.transfer.to_device`)."""
    if isinstance(img, np.ndarray):
        img = torch.from_numpy(np.ascontiguousarray(img))
    return to_device(img, device)


def canvas_of(h: int, w: int, ps: int, square: bool):
    """(L, Lw) of an h×w frame: the square L×L canvas, or with
    square=False each side padded on its own (1280×1664 instead of 1664²
    for a 1200×1600 frame)."""
    if square:
        L = canvas_size(h, w, ps)
        return L, L
    return rect_canvas_size(h, w, ps)


def whole_image(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                img: torch.Tensor, L: int, Lw: int) -> torch.Tensor:
    """[B, h, w, C] float → wrap-padded onto the L×Lw canvas, `apply_fn`,
    cropped back to h×w and clamped to [0, 1]. The body of
    `make_whole_image_fn`, and of the exported artifact (`infer.export`)."""
    h, w = img.shape[1:3]
    out = apply_fn(wrap_pad_canvas(img, L, Lw))
    return torch.clamp(out[:, :h, :w, :], 0.0, 1.0)


def make_whole_image_fn(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    h: int,
    w: int,
    ps: int = 128,
    square: bool = True,
    device="cuda",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """[B, H, W, C] (float in [0, 1] or raw uint8, tensor or ndarray) →
    restored float32 [B, H, W, C] on `device` (the card unless the caller
    asks for the CPU), for a fixed geometry (`canvas_of` says which
    canvas)."""
    L, Lw = canvas_of(h, w, ps, square)

    @torch.inference_mode()
    def run(img):
        return whole_image(apply_fn, u8_norm(_as_tensor(img, device)), L, Lw)

    return run


def dehaze_whole_image(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                       img: np.ndarray, ps: int = 128, device="cuda"
                       ) -> np.ndarray:
    """One [H, W, C] float image in [0, 1] through the square-canvas
    protocol (`make_whole_image_fn`) on `device`: the same, restored, as a
    numpy array."""
    h, w = img.shape[0], img.shape[1]
    run = make_whole_image_fn(apply_fn, h, w, ps, device=device)
    return run(img[None])[0].cpu().numpy()


# FFA-Net's protocol normalizes the hazy input only, per channel (the
# reference's FFA data path); `train.ffa_trainer` trains on the same.
FFA_MEAN = np.array([0.64, 0.60, 0.58], np.float32)
FFA_STD = np.array([0.14, 0.15, 0.152], np.float32)


def normalize_hazy(hazy: torch.Tensor) -> torch.Tensor:
    """(hazy - FFA_MEAN) / FFA_STD per channel, NHWC float in [0, 1]."""
    mean = torch.as_tensor(FFA_MEAN, device=hazy.device)
    std = torch.as_tensor(FFA_STD, device=hazy.device)
    return (hazy - mean) / std


def make_native_image_fn(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    device="cuda",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The FFA-Net protocol: [B, H, W, C] (float in [0, 1] or raw uint8,
    tensor or ndarray) → `apply_fn` at the frame's own resolution, no
    canvas, clamped to [0, 1]: float32 [B, H, W, C] on `device`. Any
    geometry (the net is fully convolutional)."""

    @torch.inference_mode()
    def run(img):
        return torch.clamp(apply_fn(u8_norm(_as_tensor(img, device))), 0.0,
                           1.0)

    return run


def quantize_u8(base: Callable[[torch.Tensor], torch.Tensor]
                ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Wrap a float forward to clip and quantize to uint8 on the device,
    with `data.images.encode_img`'s rounding: floor(y * 255 + 0.5)."""

    @torch.inference_mode()
    def run(x):
        y = torch.clamp(base(x), 0.0, 1.0)
        return torch.clamp(y * 255.0 + 0.5, 0, 255).to(torch.uint8)

    return run
