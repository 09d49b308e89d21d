"""Host-to-device copies that do not stall the host."""

from __future__ import annotations

import torch


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """`t` on `device`. A CPU tensor bound for a CUDA device goes through
    pinned memory with a non-blocking copy: a copy from pageable memory
    waits until the stream has drained, so the host could never queue work
    ahead of the card. PyTorch's pinned-memory pool keeps the staging block
    until the copy has run."""
    device = torch.device(device)
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
