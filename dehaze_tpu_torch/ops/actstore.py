"""Quantized activation round trips on the inference path (counterpart of
`dehaze_tpu/ops/actstore.py`, `--act_store`).

`compress(x, mode)` returns x as it reads back after being stored in 8
bits: "fp8" (e4m3) or "int8" (symmetric, one scale per token over the last
axis). The LeWin block applies it at its six sites when not training
(`models/uformer.py`); the four that fall inside LeFF run inside kernel K2
on the card (`ops/kernels/leff.py`, `csrc/leff.cu`).

The JAX package's `optimization_barrier`, which pins the stored 8-bit
tensor in HBM on the TPU, has no counterpart: eager torch stores what it
computes. The values are the JAX package's bit for bit, on the CPU:
- fp8: JAX's cast gives NaN for |x| > 464 (the midpoint between 448, the
  largest e4m3fn value, and 480), for ±inf and for NaN, where torch's
  `.to(torch.float8_e4m3fn)` saturates to ±448. Inside that range the two
  round alike (to nearest, ties to even).
- int8: scale = max(amax, 1e-8) / 127 in x's dtype, q = clip(round(x /
  scale), -127, 127) (ties to even), then q · scale in x's dtype. A row
  whose scale is inf or NaN reads back as NaN (JAX casts a NaN to int8 as
  0). The divisions are tensor by tensor: CUDA turns a division by a
  Python scalar into a product with its reciprocal, which can move the
  scale by an ulp.
"""

from __future__ import annotations

from typing import Optional

import torch

MODES = (None, "fp8", "int8")
# the integer code of each mode in K2's operator and kernel
MODE_CODES = {None: 0, "fp8": 1, "int8": 2}
FP8_NAN_ABOVE = 464.0  # |x| beyond this casts to NaN in e4m3fn


def mode_code(mode: Optional[str]) -> int:
    """The integer code of `mode` (`MODE_CODES`); ValueError otherwise."""
    if mode not in MODE_CODES:
        raise ValueError(f"unknown act_store mode {mode!r}; one of {MODES}")
    return MODE_CODES[mode]


def mode_of(code: int) -> Optional[str]:
    """The mode of an integer code; ValueError for another integer."""
    for mode, c in MODE_CODES.items():
        if c == code:
            return mode
    raise ValueError(f"unknown act_store code {code}; one of "
                     f"{sorted(MODE_CODES.values())}")


def compress(x: torch.Tensor, mode: Optional[str]) -> torch.Tensor:
    """x round-tripped through its 8-bit storage (module doc); x itself
    when mode is None. The output has x's dtype and shape."""
    if mode is None:
        return x
    if mode == "fp8":
        cast = x.to(torch.float8_e4m3fn).to(x.dtype)
        return torch.where(x.abs() <= FP8_NAN_ABOVE, cast,
                           torch.full_like(x, float("nan")))
    if mode == "int8":
        amax = x.abs().amax(dim=-1, keepdim=True)
        scale = torch.clamp_min(amax, 1e-8) / torch.full_like(amax, 127.0)
        q = torch.clamp(torch.round(x / scale), -127, 127)
        q = torch.nan_to_num(q, nan=0.0).to(torch.int8)
        return q.to(x.dtype) * scale
    raise ValueError(f"unknown act_store mode {mode!r}; one of {MODES}")
