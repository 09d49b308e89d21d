"""PSNR / SSIM with skimage semantics (counterpart of `dehaze_tpu/ops/metrics.py`).

- `psnr`: MSE over all pixels, data_range² / MSE (skimage infers
  data_range 1.0 for non-negative float images).
- `ssim`: skimage `structural_similarity` defaults with channel_axis=-1: a
  7×7 uniform filter over valid windows, unbiased covariance N/(N-1),
  per-channel SSIM averaged. (skimage's default data_range for floats is
  2.0; pass it to replicate numbers produced that way.)
- `ssim_gaussian`: the reference's own SSIM, an 11×11 Gaussian window
  (σ 1.5) with SAME zero padding (or VALID), biased covariance, inputs
  clamped to [0, 1], the mean over the whole map.

All run on the tensors' device, in float32, batched over [B, H, W, C].
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """PSNR over one image (any shape)."""
    err = (pred.float() - target.float()).square().mean()
    return 10.0 * torch.log10((data_range * data_range) / err)


def batch_psnr(pred: torch.Tensor, target: torch.Tensor,
               data_range: float = 1.0) -> torch.Tensor:
    """Per-image PSNR over a batch [B, ...] -> [B]."""
    b = pred.shape[0]
    err = (pred.float() - target.float()).reshape(b, -1).square().mean(1)
    return 10.0 * torch.log10((data_range * data_range) / err)


def batch_ssim(pred: torch.Tensor, target: torch.Tensor,
               data_range: float = 1.0, win_size: int = 7) -> torch.Tensor:
    """Per-image SSIM over NHWC batches -> [B]."""
    k1, k2 = 0.01, 0.03
    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1)
    x = pred.float().permute(0, 3, 1, 2)
    y = target.float().permute(0, 3, 1, 2)

    def filt(t):  # mean over valid win×win windows, per channel
        return F.avg_pool2d(t, win_size, stride=1)

    ux, uy = filt(x), filt(y)
    vx = cov_norm * (filt(x * x) - ux * ux)
    vy = cov_norm * (filt(y * y) - uy * uy)
    vxy = cov_norm * (filt(x * y) - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux * ux + uy * uy + c1) * (vx + vy + c2))
    return s.mean(dim=(1, 2, 3))


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
         win_size: int = 7) -> torch.Tensor:
    """SSIM of one [H, W, C] image."""
    return batch_ssim(pred[None], target[None], data_range, win_size)[0]


@functools.lru_cache(maxsize=None)
def _gaussian_kernel(win: int, sigma: float) -> np.ndarray:
    g = np.exp(-((np.arange(win) - win // 2) ** 2) / (2.0 * sigma * sigma))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim_gaussian(pred: torch.Tensor, target: torch.Tensor,
                  win_size: int = 11, sigma: float = 1.5,
                  padding: str = "SAME") -> torch.Tensor:
    """The reference's SSIM (counterpart of `dehaze_tpu/ops/metrics.py:
    ssim_gaussian`) of [H, W, C] or [B, H, W, C] images: a depthwise
    win×win Gaussian filter, SAME (zero padding) or VALID (interior
    windows only, Wang et al.'s formulation), the mean of the SSIM map
    over every pixel, channel and image."""
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"padding must be 'SAME' or 'VALID', not "
                         f"{padding!r}")
    if pred.ndim == 3:
        pred, target = pred[None], target[None]
    p = torch.clamp(pred.float(), 0.0, 1.0).permute(0, 3, 1, 2)
    t = torch.clamp(target.float(), 0.0, 1.0).permute(0, 3, 1, 2)
    c = p.shape[1]
    kern = torch.from_numpy(_gaussian_kernel(win_size, sigma)).to(p.device)
    kern = kern.expand(c, 1, win_size, win_size)
    pad = (win_size - 1) // 2 if padding == "SAME" else 0

    def filt(x):
        if padding == "SAME" and win_size % 2 == 0:  # XLA's SAME split
            x = F.pad(x, (pad, pad + 1, pad, pad + 1))
            return F.conv2d(x, kern, groups=c)
        return F.conv2d(x, kern, padding=pad, groups=c)

    mu1, mu2 = filt(p), filt(t)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = filt(p * p) - mu1_sq
    s2 = filt(t * t) - mu2_sq
    s12 = filt(p * t) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    smap = ((2 * mu12 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return smap.mean()
