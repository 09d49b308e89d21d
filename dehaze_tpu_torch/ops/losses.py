"""Losses: Charbonnier, TV, and the contrastive (CR) loss.

Counterpart of `dehaze_tpu/ops/losses.py`. Every loss computes in float32
from inputs of any float dtype. The VGG feature extractor that feeds the CR
and perceptual losses lives in `dehaze_tpu_torch.models.vgg`.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def charbonnier_loss(x: torch.Tensor, y: torch.Tensor,
                     eps: float = 1e-3) -> torch.Tensor:
    """mean(sqrt((x - y)² + eps²))."""
    diff = x.float() - y.float()
    return torch.sqrt(diff * diff + eps * eps).mean()


def tv_loss(x: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Total-variation loss over NHWC images."""
    b, h, w, c = x.shape
    x = x.float()
    h_tv = (x[:, 1:] - x[:, :h - 1]).square().sum()
    w_tv = (x[:, :, 1:] - x[:, :, :w - 1]).square().sum()
    return weight * 2.0 * (h_tv / ((h - 1) * w * c)
                           + w_tv / (h * (w - 1) * c)) / b


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() - b.float()).abs().mean()


def contrast_loss_from_features(
    a_feats: Sequence[torch.Tensor],
    p_feats: Sequence[torch.Tensor],
    n_feats: Sequence[torch.Tensor],
    weights: Sequence[float] = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0),
    ablation: bool = False,
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Contrastive regularization over precomputed VGG features:

    loss = Σᵢ wᵢ · d(aᵢ, pᵢ) / (d(aᵢ, nᵢ) + 1e-7), d = mean L1, with the
    positive and negative features detached. `ablation=True` drops the
    negative term. `reduce` maps the stacked batch means [d_ap…, d_an…]
    to the means over a larger batch before the ratios are taken (a
    data-parallel step passes `parallel.dist.mean_over_ranks`: the loss is
    a ratio of batch means, which per-rank ratios would not give). Returns
    (loss, Σ d_ap, Σ d_an)."""
    d_ap = [l1(af, pf.detach()) for af, pf in zip(a_feats, p_feats)]
    d_an = ([] if ablation else
            [l1(af, nf.detach()) for af, nf in zip(a_feats, n_feats)])
    if reduce is not None:
        ds = reduce(torch.stack(d_ap + d_an)).unbind()
        d_ap, d_an = list(ds[:len(d_ap)]), list(ds[len(d_ap):])
    dev = a_feats[0].device
    loss = torch.zeros((), device=dev)
    all_ap = torch.zeros((), device=dev)
    all_an = torch.zeros((), device=dev)
    for i, w in enumerate(weights[:len(d_ap)]):
        all_ap = all_ap + d_ap[i]
        if ablation:
            contrastive = d_ap[i]
        else:
            all_an = all_an + d_an[i]
            contrastive = d_ap[i] / (d_an[i] + 1e-7)
        loss = loss + w * contrastive
    return loss, all_ap, all_an


def perceptual_loss_from_features(x_feats: Sequence[torch.Tensor],
                                  y_feats: Sequence[torch.Tensor]
                                  ) -> torch.Tensor:
    """Mean of the per-slice MSEs over VGG16 features."""
    losses = [(xf.float() - yf.float()).square().mean()
              for xf, yf in zip(x_feats, y_feats)]
    return sum(losses) / len(losses)
