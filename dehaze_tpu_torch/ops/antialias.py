"""Antialiased (blur-pool) downsampling (counterpart of
`dehaze_tpu/ops/antialias.py`; the reference's
`Uformer_ProbSparse/utils/antialias.py`, Adobe antialiased-cnns'
`Downsample`, which no dehazing flow calls). A stateless op in plain
torch: no TPU kernel computes it, so the port has no kernel for it.

Semantics, as the reference's:
- the binomial filter row a = Pascal(filt_size) (`antialias.py:31-44`),
  its outer product a⊗a normalized to sum 1 (`:46-47`);
- the asymmetric pad [(f-1)//2, ceil((f-1)/2)] per spatial axis, plus
  pad_off (`:24-26`), in reflect, replicate or zero mode (`:62-75`);
- a depthwise stride-s conv (`:60`), run as two separable 1-D depthwise
  passes (rows with stride (s, 1), then columns with (1, s)) over NHWC;
  filt_size == 1 is strided slicing, padded only when pad_off != 0
  (`:54-58`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_PAD_MODES = {
    "reflect": "reflect",
    "refl": "reflect",
    "replicate": "replicate",
    "repl": "replicate",
    "zero": "constant",
}


def _binomial(n: int) -> torch.Tensor:
    return torch.tensor([math.comb(n - 1, k) for k in range(n)],
                        dtype=torch.float32)


def blur_downsample(x: torch.Tensor, filt_size: int = 3, stride: int = 2,
                    pad_type: str = "reflect", pad_off: int = 0
                    ) -> torch.Tensor:
    """Blur-pool an NHWC tensor (≙ the reference `Downsample.forward`)."""
    if x.ndim != 4:
        raise ValueError(f"expected NHWC, got shape {tuple(x.shape)}")
    if pad_type not in _PAD_MODES:
        raise ValueError(f"pad_type must be one of {sorted(_PAD_MODES)}")
    lo = (filt_size - 1) // 2 + pad_off
    hi = math.ceil((filt_size - 1) / 2) + pad_off
    mode = _PAD_MODES[pad_type]
    y = x.permute(0, 3, 1, 2)
    if filt_size > 1 or pad_off:
        y = F.pad(y, (lo, hi, lo, hi), mode=mode)
    if filt_size == 1:
        return y[:, :, ::stride, ::stride].permute(0, 2, 3, 1)
    a = _binomial(filt_size)
    a = (a / a.sum()).to(device=x.device, dtype=x.dtype)
    c = x.shape[-1]
    y = F.conv2d(y, a.reshape(1, 1, filt_size, 1).expand(c, 1, filt_size, 1),
                 stride=(stride, 1), groups=c)
    y = F.conv2d(y, a.reshape(1, 1, 1, filt_size).expand(c, 1, 1, filt_size),
                 stride=(1, stride), groups=c)
    return y.permute(0, 2, 3, 1)
