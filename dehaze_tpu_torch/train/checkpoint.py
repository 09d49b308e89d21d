"""Checkpoints in the reference's `.pth` format (counterpart of
`dehaze_tpu/train/checkpoint.py`).

A file holds `{epoch, state_dict, optimizer, extra}`: the model's state_dict
with the reference's key names, the optimizer's state_dict (absent from
`model_best`), and a dict of metrics. `dehaze_tpu.utils.convert_torch.
load_reference_checkpoint` and the port's `utils.convert.load_weights` read
it. Writes go to a temporary file that is renamed into place, so a kill
during a write leaves the previous file whole.

`load_jax_checkpoint` reads the JAX package's own `.msgpack` files (the
read side of `dehaze_tpu/train/checkpoint.py`) with the port's pure-Python
decoder (`utils.msgpack`), so neither flax nor msgpack is needed.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional

import torch

from dehaze_tpu_torch.utils import msgpack


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


def load_jax_checkpoint(path: str) -> Dict[str, Any]:
    """A JAX package checkpoint, `msgpack_serialize({"epoch", "params":
    to_bytes(params), "opt_state": to_bytes(opt_state), "extra":
    json.dumps(extra)})`: {"epoch": int, "params": the params tree as
    nested dicts of numpy arrays (bfloat16 leaves as torch.bfloat16
    tensors), "extra": dict}. The optimizer state (optax's, which no torch
    optimizer can take) is stepped over unread."""
    with open(path, "rb") as f:
        data = f.read()
    payload = msgpack.read_map(data, skip=("opt_state",))
    params = payload.get("params")
    if not isinstance(params, bytes):
        raise ValueError(f"{path}: not a JAX package checkpoint (no params "
                         "bytes)")
    return {"epoch": int(payload.get("epoch", 0)),
            "params": msgpack.unpackb(params),
            "extra": json.loads(payload.get("extra") or "{}")}
