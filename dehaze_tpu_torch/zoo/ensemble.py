"""Deep-ensemble prediction (counterpart of `dehaze_tpu/zoo/ensemble.py`,
≙ `how-do-vits-work-transformer/models/ensemble.py`: stack the members'
logits, log-softmax each, `logsumexp` over the members, i.e. log Σ_m
p_m(y|x)).

- `combine_logits` is that rule on stacked `[M, ..., C]` logits, through
  `zoo.transformers.ensemble_logits`;
- `Ensemble` holds heterogeneous members (each an `nn.Module` with its own
  weights), with the reference's `<registry_name>_ensemble` name;
- `stack_state_dicts` holds M weight sets of one architecture as one
  state_dict with a leading member axis; `Ensemble.stacked` builds the M
  members from it (copies of one module, each loaded with its slice). The
  JAX package vmaps one compiled forward over that axis; here the members
  run one after another, as every `Ensemble` does.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from dehaze_tpu_torch.zoo.transformers import ensemble_logits


def combine_logits(member_logits: torch.Tensor) -> torch.Tensor:
    """Stacked member logits `[M, ..., C]` → ensemble scores `[..., C]`
    (`models/ensemble.py:18-22`)."""
    return ensemble_logits(member_logits.unbind(0))


def _default_name(model) -> str:
    """`<registry_name>_ensemble`, as the reference names an ensemble
    after its first member (`ensemble.py:12-15`)."""
    base = (getattr(model, "registry_name", None)
            or type(model).__name__.lower())
    return f"{base}_ensemble"


def stack_state_dicts(state_dicts: Sequence[Dict[str, torch.Tensor]]
                      ) -> Dict[str, torch.Tensor]:
    """M state_dicts of one architecture → one, each tensor stacked along
    a new leading member axis. Raises when their names differ."""
    if not state_dicts:
        raise ValueError("stack_state_dicts needs at least one state_dict")
    names = list(state_dicts[0])
    for i, sd in enumerate(state_dicts[1:], 1):
        if set(sd) != set(names):
            raise ValueError(
                f"state_dict {i} differs from state_dict 0 in "
                f"{sorted(set(sd) ^ set(names))[:5]}")
    return {k: torch.stack([sd[k] for sd in state_dicts]) for k in names}


class Ensemble(nn.Module):
    """Callable ensemble of zoo classifiers: `forward(x, **kwargs)` calls
    every member with the same arguments (`generators=...`) and combines
    their logits.

    `Ensemble([model_a, model_b], name=...)` mirrors the reference's
    heterogeneous construction (members may be different architectures);
    `Ensemble.stacked(model, stack_state_dicts([...]))` makes one member
    of `model`'s architecture for each slice of the stacked weights."""

    def __init__(self, members: Sequence[nn.Module],
                 name: Optional[str] = None):
        super().__init__()
        if not members:
            raise ValueError("Ensemble needs at least one member model")
        self.members = nn.ModuleList(members)
        self.num_members = len(self.members)
        self.name = name if name is not None else _default_name(members[0])

    @classmethod
    def stacked(cls, model: nn.Module,
                stacked_state: Dict[str, torch.Tensor],
                name: Optional[str] = None) -> "Ensemble":
        """The homogeneous ensemble of `stack_state_dicts` output: member m
        is a copy of `model` holding slice m of every tensor."""
        leading = {int(t.shape[0]) for t in stacked_state.values()}
        if len(leading) != 1:
            raise ValueError(
                f"stacked state has inconsistent leading axes {leading}")
        members = []
        for m in range(leading.pop()):
            member = copy.deepcopy(model)
            member.load_state_dict({k: v[m] for k, v in
                                    stacked_state.items()})
            members.append(member)
        return cls(members, name=name)

    def member_logits(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        """Stacked raw logits `[M, B, C]` from every member."""
        return torch.stack([m(x, **kwargs) for m in self.members])

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return combine_logits(self.member_logits(x, **kwargs))
