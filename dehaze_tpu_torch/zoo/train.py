"""The zoo's training losses (counterpart of `dehaze_tpu/zoo/train.py`).

Only the soft-target cross-entropy is here so far: the attacks of
`zoo/adversarial` differentiate it. The trainer (`make_schedule`,
`get_optimizer`, `ZooTrainer`, data-parallel training) is not ported yet.
"""

from __future__ import annotations

import torch


def soft_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Soft-target CE == timm SoftTargetCrossEntropy: float32 log_softmax,
    the sum over classes, the mean over the batch; with one-hot (smoothed)
    targets it is (LabelSmoothing)CrossEntropyLoss (`trains.py:137-143`)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.sum(targets * logp, dim=-1))
