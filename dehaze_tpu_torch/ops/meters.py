"""Running meters (counterpart of `dehaze_tpu/ops/meters.py`; the
reference's `*/ops/meters.py:5-45` AverageMeter)."""

from __future__ import annotations

import math

import numpy as np


class AverageMeter:
    """Tracks count/sum/mean and (population) std of scalar updates."""

    def __init__(self, name: str = "", fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.count = 0
        self.sum = 0.0
        self.sq_sum = 0.0

    def update(self, value, n: int = 1):
        """Scalar: weighted by n. Array (NumPy, a tensor, a list): every
        element counts once, as the reference meter sums xs and counts
        xs.size."""
        arr = np.asarray(value.detach().cpu() if hasattr(value, "detach")
                         else value, dtype=np.float64)
        if arr.size != 1:
            self.count += arr.size
            self.sum += float(arr.sum())
            self.sq_sum += float(np.square(arr).sum())
            return
        v = float(arr.reshape(()))
        self.count += n
        self.sum += v * n
        self.sq_sum += v ** 2 * n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    @property
    def std(self) -> float:
        if self.count == 0:
            return 0.0
        var = self.sq_sum / self.count - self.avg ** 2
        return math.sqrt(max(var, 0.0))

    def __str__(self):
        return f"{self.name} {self.avg:.6f} (n={self.count})"
