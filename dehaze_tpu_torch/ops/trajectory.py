"""Optimization-trajectory polar analysis (counterpart of
`dehaze_tpu/ops/trajectory.py`; the reference's `My_Trajectories in polar
coordinates.py:123-231`).

For each per-epoch checkpoint w_t and the best checkpoint w*, per tensor
Δw_t = w_t − w*, then r = ‖Δw_t‖ / ‖Δw_init‖ and θ = acos(Δw_t·Δw_init /
(‖Δw_t‖‖Δw_init‖)), averaged over the tensors; plotted as (θ, r) in polar
coordinates. A checkpoint is an ordered dict name → tensor; the tensors
are the JAX package's leaves (`ops.landscape.tensor_groups`: a W-MSA
'linear' projection's `to_q` and `to_kv` count as its one fused `qkv`),
so both packages average over the same tensors. Norms and dot products
run in float32 on the tensors' device.
"""

from __future__ import annotations

import math
from typing import List, Mapping, Sequence, Tuple

import numpy as np
import torch

from dehaze_tpu_torch.ops.landscape import tensor_groups
from dehaze_tpu_torch.utils.plot import pyplot


def _flat(params: Mapping[str, torch.Tensor], groups) -> List[torch.Tensor]:
    return [torch.cat([params[k].reshape(-1).float() for k in g])
            for g in groups]


def trajectory_point(w_t, w_init, w_best) -> Tuple[float, float]:
    """(theta, r) for one checkpoint, averaged over parameter tensors; a
    tensor with a zero Δ on either side is skipped, and (0, 0) is returned
    when every tensor is (w_t == w_best: the converged point)."""
    groups = tensor_groups(w_best)
    dt = [a - b for a, b in zip(_flat(w_t, groups), _flat(w_best, groups))]
    d0 = [a - b for a, b in zip(_flat(w_init, groups),
                                _flat(w_best, groups))]
    rs, thetas = [], []
    for a, b in zip(dt, d0):
        na = float(torch.linalg.vector_norm(a))
        nb = float(torch.linalg.vector_norm(b))
        if na == 0.0 or nb == 0.0:
            continue
        rs.append(na / nb)
        cos = float(torch.dot(a, b)) / (na * nb)
        thetas.append(math.acos(min(1.0, max(-1.0, cos))))
    if not rs:
        return 0.0, 0.0
    return float(np.mean(thetas)), float(np.mean(rs))


def trajectory(checkpoints: Sequence[Mapping[str, torch.Tensor]],
               best: Mapping[str, torch.Tensor]
               ) -> List[Tuple[float, float]]:
    """Polar (theta, r) per checkpoint; checkpoints[0] is the init point."""
    init = checkpoints[0]
    return [trajectory_point(w, init, best) for w in checkpoints]


def plot_trajectory(points: Sequence[Tuple[float, float]], out_path: str,
                    title: str = "optimization trajectory") -> None:
    plt = pyplot(f"the trajectory figure {out_path}")
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="polar")
    ax.plot([p[0] for p in points], [p[1] for p in points], "o-", ms=3)
    ax.set_title(title)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
