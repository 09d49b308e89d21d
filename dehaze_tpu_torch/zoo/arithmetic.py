"""Weight-space arithmetic over state_dicts (counterpart of
`dehaze_tpu/zoo/arithmetic.py`, ≙ the reference's `ops/arithmetic.py`).

Each function takes `{name: tensor}` dicts; two dicts must have the same
names (a mismatch raises KeyError, as the reference's does). Reductions
run in float32 on the tensors' device and return 0-d tensors. `cos` adds
1e-7 to its denominator and `sin` is 0 where cos ≥ 1, as in the
reference.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

StateDict = Mapping[str, torch.Tensor]


def _pairs(ws1: StateDict, ws2: StateDict):
    if set(ws1) != set(ws2):
        raise KeyError(f"state_dicts differ in names: "
                       f"{sorted(set(ws1) ^ set(ws2))[:5]}")
    return ((k, ws1[k], ws2[k]) for k in ws1)


def add(ws1: StateDict, ws2: StateDict) -> Dict[str, torch.Tensor]:
    return {k: a + b for k, a, b in _pairs(ws1, ws2)}


def mul(ws: StateDict, c) -> Dict[str, torch.Tensor]:
    return {k: w * c for k, w in ws.items()}


def diff(ws1: StateDict, ws2: StateDict) -> Dict[str, torch.Tensor]:
    return add(ws1, mul(ws2, -1))


def inner(ws1: StateDict, ws2: StateDict) -> torch.Tensor:
    """Σ over every tensor of Σ(w1·w2), in float32."""
    terms = [torch.sum(a.float() * b.float()) for _, a, b in _pairs(ws1, ws2)]
    if not terms:
        return torch.zeros(())
    return torch.stack(terms).sum()


def norm(ws: StateDict) -> torch.Tensor:
    return torch.sqrt(inner(ws, ws))


def rad(ws1: StateDict, ws2: StateDict) -> torch.Tensor:
    """‖ws1 − ws2‖."""
    return norm(diff(ws1, ws2))


def cos(ws1: StateDict, ws2: StateDict) -> torch.Tensor:
    return inner(ws1, ws2) / (norm(ws1) * norm(ws2) + 1e-7)


def sin(ws1: StateDict, ws2: StateDict) -> torch.Tensor:
    """sqrt((1 + cos)(1 − cos + 1e-7)), 0 where cos ≥ 1."""
    c = cos(ws1, ws2)
    val = torch.sqrt(torch.clamp((1.0 + c) * (1.0 - c + 1e-7), min=0.0))
    return torch.where(c < 1.0, val, torch.zeros_like(val))
