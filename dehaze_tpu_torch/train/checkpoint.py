"""Checkpoints in the reference's `.pth` format (counterpart of
`dehaze_tpu/train/checkpoint.py`).

A file holds `{epoch, state_dict, optimizer, extra}`: the model's state_dict
with the reference's key names, the optimizer's state_dict (absent from
`model_best`), and a dict of metrics. `dehaze_tpu.utils.convert_torch.
load_reference_checkpoint` and the port's `utils.convert.load_weights` read
it. Writes go to a temporary file that is renamed into place, so a kill
during a write leaves the previous file whole.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import torch


def save_checkpoint(path: str, epoch: int, state_dict: Mapping[str, Any],
                    optimizer: Optional[Mapping[str, Any]] = None,
                    extra: Optional[Dict] = None) -> None:
    payload = {"epoch": epoch, "state_dict": dict(state_dict),
               "extra": dict(extra or {})}
    if optimizer is not None:
        payload["optimizer"] = optimizer
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload of a checkpoint, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_start_epoch(path: str) -> int:
    """The epoch stored in a checkpoint."""
    return int(load_checkpoint(path)["epoch"])
