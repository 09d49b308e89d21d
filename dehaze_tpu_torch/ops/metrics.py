"""PSNR / SSIM with skimage semantics (counterpart of `dehaze_tpu/ops/metrics.py`).

- `psnr`: MSE over all pixels, data_range² / MSE (skimage infers
  data_range 1.0 for non-negative float images).
- `ssim`: skimage `structural_similarity` defaults with channel_axis=-1: a
  7×7 uniform filter over valid windows, unbiased covariance N/(N-1),
  per-channel SSIM averaged. (skimage's default data_range for floats is
  2.0; pass it to replicate numbers produced that way.)

All run on the tensors' device, in float32, batched over [B, H, W, C].
"""

from __future__ import annotations

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
