"""Parameter and FLOP counts (counterpart of `dehaze_tpu/utils/flops.py`).

The JAX package asks XLA's cost analysis of the compiled forward. The port
counts one eval forward with `torch.utils.flop_counter.FlopCounterMode`,
which knows PyTorch's matmuls and convolutions (2 FLOPs a multiply-add;
a transposed conv by its input's positions) but not the port's own
operators, so their formulas are registered here:

- K1, `dehaze_tpu_torch::window_attention_fwd` (q [B_, N, C], C = H·D):
  per window-head 2·N·N·D for Q·Kᵀ plus 2·u·N·D for the u selected rows'
  P·V (u = `probsparse_u(N, factor)`);
- K2, `dehaze_tpu_torch::leff_fused` (x [B, H, W, C], hidden Ch): its two
  Dense layers, 2·B·H·W·C·Ch each, and the 3×3 depthwise conv,
  2·B·H·W·Ch·9.

Elementwise work, softmax and norms are not counted (XLA counts them: the
JAX package's number is larger).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch.utils import flop_counter

from dehaze_tpu_torch.ops.kernels import leff as _leff  # noqa: F401
from dehaze_tpu_torch.ops.kernels import (  # noqa: F401
    window_attention as _wa)
from dehaze_tpu_torch.ops.probsparse import probsparse_u


def k1_flops(q_shape, num_heads: int, factor: int) -> int:
    """K1's forward FLOPs for q [B_, N, C]."""
    b, n, c = q_shape
    return b * (2 * n * n * c + 2 * probsparse_u(n, factor) * n * c)


def k2_flops(x_shape, hidden: int) -> int:
    """K2's FLOPs for x [B, H, W, C] and hidden width `hidden`."""
    tokens = math.prod(x_shape[:-1])
    c = x_shape[-1]
    return 2 * tokens * (c * hidden + 9 * hidden + hidden * c)


def _k1_formula(q_shape, k_shape, v_shape, cnt_shape, bias_shape,
                region_shape, pad_shape, num_heads, num_windows, factor,
                scale, numerics, out_shape=None, **kw):
    return k1_flops(q_shape, num_heads, factor)


def _k2_formula(x_shape, ln_scale, ln_bias, w1_shape, *args,
                out_shape=None, **kw):
    return k2_flops(x_shape, w1_shape[1])


_OPS = {torch.ops.dehaze_tpu_torch.window_attention_fwd: _k1_formula,
        torch.ops.dehaze_tpu_torch.leff_fused: _k2_formula}
for _op, _formula in _OPS.items():
    if _op not in flop_counter.flop_registry:  # a module reload
        flop_counter.register_flop_formula(_op)(_formula)


def count_params(model: torch.nn.Module) -> int:
    """The number of the model's named parameters' elements (the JAX
    package's count of its params tree, for every arch)."""
    return int(sum(p.numel() for p in model.parameters()))


def model_report(model: torch.nn.Module, x: torch.Tensor,
                 **forward_kwargs) -> Dict[str, float]:
    """{'params': N, 'gflops': F, 'bytes': B} for one eval forward of
    `model(x, **forward_kwargs)` under no_grad: F from FlopCounterMode with
    the formulas above; B the bytes that the forward must move at least,
    its parameters (as stored), its input and its output each once (not a
    measured traffic)."""
    model.eval()
    counter = flop_counter.FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        y = model(x, **forward_kwargs)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    nbytes += x.numel() * x.element_size() + y.numel() * y.element_size()
    return {"params": count_params(model),
            "gflops": counter.get_total_flops() / 1e9,
            "bytes": float(nbytes)}
