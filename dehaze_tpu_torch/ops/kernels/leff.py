"""K2: fused LayerNorm + LeFF, forward (inference).

Replaces `leff_fused` / `_kernel` of `dehaze_tpu/ops/pallas/leff.py`:
LN (norm2 of the LeWin block) -> Dense(C -> Ch) -> GELU -> depthwise 3×3
(SAME, zero padding) -> GELU -> Dense(Ch -> C). The residual add stays with
the caller. `leff_fused` calls the operator
`torch.ops.dehaze_tpu_torch.leff_fused`, which `torch.export` keeps as a
node of its graph: on a CUDA tensor it launches `csrc/leff.cu`, on a CPU
tensor it runs the plain twin `leff_reference`. There is no other path. In
bf16 the kernel runs both Dense layers on the tensor cores with their
weights staged in shared memory, tiled per C (for int8 per C and Ch) by
`plan_tile`; in float32 it stays on the CUDA cores (csrc/leff.cu says
why).

Public layouts are the JAX kernel's: x [B, H, W, C]; w1 [C, Ch]; dw_kernel
[3, 3, 1, Ch] (HWIO); w2 [Ch, C]. All parameters are cast to x.dtype, as the
JAX kernel does.

`act_store` ('fp8', 'int8' or None; `ops/actstore.py`) round-trips the
four tensors of the LeWin block's `--act_store` sites that fall inside
LeFF: the LN output, the hidden after each GELU and the output. The JAX
package compresses them between its unfused layers
(`dehaze_tpu/models/uformer.py:383,393`, `models/layers.py:154,158`); here
the kernel does it in registers and shared memory, and the twin at its
rounding points. The operator takes the mode as an int
(`actstore.MODE_CODES`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from dehaze_tpu_torch.ops import actstore
from dehaze_tpu_torch.ops.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "leff_fwd": [_I] + [_P] * 10 + [_I] * 7 + [ctypes.c_float, _I, _I, _P],
    "leff_fp8_trip": [_I, _P, _P, ctypes.c_longlong, _P],
    "leff_i8_trip": [_P, _P, _P, ctypes.c_longlong, _P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on Hopper
_F32_SMEM_BUDGET = 200 * 1024  # the float32 path's planning budget
_F32_CHUNK = 32  # hidden channels per chunk of the float32 path
# bf16 tile classes of csrc/leff.cu (Tile32 ... Tile512), by the largest C
# each takes: (largest C, tile width TW, hidden chunk KC). Every class has 8
# tile rows and holds `largest C` output channels in registers.
_MMA_CLASSES = ((32, 32, 32), (64, 32, 64), (128, 32, 64), (256, 16, 64),
                (512, 8, 32))
# int8's own bf16 classes (I8Tile32 ... I8Tile256), tried in this order:
# (largest C, TW, KC, sweeps of dense1: 1 with the whole hidden tile
# resident, 2 with the output pixels' hidden resident). Where none fits
# (C, Ch), int8 runs three sweeps in the class of C above.
_I8_CLASSES = ((32, 32, 32, 1), (64, 16, 64, 1), (128, 16, 32, 2),
               (256, 8, 32, 2))


class TilePlan(NamedTuple):
    """K2's output tile for one (C, Ch, dtype, act_store): th x tw pixels
    per CTA, the bytes of shared memory the kernel allocates, and how many
    times the kernel runs dense1 over the hidden width (1 but for int8: 1,
    2 or 3 by what fits)."""
    th: int
    tw: int
    smem: int
    sweeps: int = 1

    @property
    def halo_ratio(self) -> float:
        """Haloed pixels per output pixel: how often dense1 is computed."""
        return (self.th + 2) * (self.tw + 2) / (self.th * self.tw)


def _f32_smem_bytes(C: int, TH: int, TW: int) -> int:
    HP, TP = (TH + 2) * (TW + 2), TH * TW
    return ((TP * C + HP * _F32_CHUNK + TP * _F32_CHUNK + HP * C) * 4
            + (HP + TP) * 4 + HP)


def _mma_smem_bytes(C: int, Ch: int, tw: int, nc: int, kc: int,
                    sweeps: int = 0) -> int:
    """csrc/leff.cu Tile<...>::smem_bytes. The classes of every mode
    (sweeps 0): bf16 LN tile [HPP][Kp+8], the W1 chunk [Kp][KC+8], the W2
    chunk [KC][NC+8], two buffers of the chunk's 11 parameter rows
    [11][KC], hidden [HPP][KC+8] and dense2's A [TP][KC+8]. int8's own
    (sweeps 1 or 2; ChP = Ch padded to KC): the LN tile or two W2 chunks,
    whichever is larger, the W1 chunk, the parameters ([11][ChP] for one
    sweep, two chunks' for two), hidden1 ([HPP][ChP+8] for one sweep, a
    chunk for two) and hidden2 [TP][ChP+8]. Then the int8 amaxes of the
    haloed and the output pixels (an int each; int8's own classes also the
    reciprocals of their scales, a float each) and a byte per haloed
    pixel."""
    hp = 10 * (tw + 2)
    hpp = -(-hp // 16) * 16
    kp = -(-C // 16) * 16
    hs, ns, tp = kc + 8, nc + 8, 8 * tw
    if sweeps == 0:
        return (2 * (hpp * (kp + 8) + kp * hs + kc * ns + 2 * 11 * kc
                     + hpp * hs + tp * hs) + 4 * (hpp + tp) + hpp)
    hsw = -(-Ch // kc) * kc + 8
    par = 11 * (hsw - 8) if sweeps == 1 else 2 * 11 * kc
    hid = hpp * (hsw if sweeps == 1 else hs)
    return (2 * (max(hpp * (kp + 8), 2 * kc * ns) + kp * hs + par + hid
                 + tp * hsw) + 8 * (hpp + tp) + hpp)


def _f32_tile_rows(C: int) -> int:
    """Rows of the float32 path's 8-wide tile (the plan K2 had for both
    types before its bf16 path moved onto tensor cores)."""
    for th in (8, 4, 2, 1):
        if _f32_smem_bytes(C, th, 8) <= _F32_SMEM_BUDGET:
            return th
    raise ValueError(f"K2 cannot tile C={C} within {_F32_SMEM_BUDGET} bytes "
                     "of shared memory")


def plan_tile(C: int, dtype: torch.dtype, act_store: Optional[str] = None,
              Ch: Optional[int] = None) -> TilePlan:
    """The tile csrc/leff.cu runs for channel width C, hidden width Ch (4C,
    LeFF's ratio, by default) and `act_store` in `dtype`. bf16: the
    tensor-core class of C (8 rows; 32, 16 or 8 columns as C grows, the
    widest whose LN tile, weight buffers and register accumulator fit);
    for int8 the first of its own classes whose resident hidden fits
    (`_I8_CLASSES`), else three sweeps in the class of C. float32: 8
    columns, rows by `_f32_tile_rows` (int8 in three sweeps)."""
    actstore.mode_code(act_store)  # an unknown mode raises
    Ch = 4 * C if Ch is None else Ch
    int8 = act_store == "int8"
    if dtype == torch.bfloat16:
        if int8:
            for cmax, tw, kc, sweeps in _I8_CLASSES:
                smem = _mma_smem_bytes(C, Ch, tw, cmax, kc, sweeps)
                if C <= cmax and smem <= SMEM_LIMIT:
                    return TilePlan(8, tw, smem, sweeps)
        for cmax, tw, kc in _MMA_CLASSES:
            if C <= cmax:
                return TilePlan(8, tw, _mma_smem_bytes(C, Ch, tw, cmax, kc),
                                3 if int8 else 1)
        raise ValueError(f"K2 takes C <= {_MMA_CLASSES[-1][0]} in bfloat16, "
                         f"got {C}")
    th = _f32_tile_rows(C)
    return TilePlan(th, 8, _f32_smem_bytes(C, th, 8), 3 if int8 else 1)


def i8_trip_reference(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x read back from int8 at `scale` as K2's kernels compute it, in plain
    torch on x's device: `actstore.compress`'s int8 steps at that scale
    (round(x / scale) ties to even, clipped to ±127, NaN to 0, times the
    scale, each in x's dtype), with q kept in floating point, so that a
    quotient that rounds to zero keeps its sign (compress's int8 cast
    gives +0 there; the values are equal)."""
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return torch.nan_to_num(q, nan=0.0) * scale


def i8_trip(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x read back from int8 at `scale` (same shape, bf16) as K2's bf16
    kernels read back each value: `csrc/leff.cu`'s `leff_i8_trip` (the
    division as a product and a remainder step) on a CUDA tensor,
    `i8_trip_reference` on a CPU tensor. It exists to hold the device
    function to the division on the card."""
    if x.dtype != torch.bfloat16 or scale.dtype != torch.bfloat16:
        raise TypeError("i8_trip takes bfloat16 values and scales")
    if x.shape != scale.shape:
        raise ValueError(f"i8_trip: x {tuple(x.shape)} and scale "
                         f"{tuple(scale.shape)} differ")
    if x.device.type == "cpu":
        return i8_trip_reference(x, scale)
    if x.device.type != "cuda":
        raise ValueError(f"i8_trip takes a CPU or CUDA tensor, got "
                         f"{x.device}")
    x, scale = x.contiguous(), scale.contiguous()
    out = torch.empty_like(x)
    lib = _build.load_library("leff", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.leff_i8_trip(x.data_ptr(), scale.data_ptr(),
                               out.data_ptr(), x.numel(), stream)
    _build.check(lib, err, "leff_i8_trip")
    return out


def leff_reference(x, *, ln_scale, ln_bias, w1, b1, dw_kernel, dw_bias, w2,
                   b2, eps: float = 1e-5, fast_gelu: bool = False,
                   act_store: Optional[str] = None):
    """Plain torch LN + LeFF with the kernel's interface and roundings.

    Parameters are rounded to x.dtype; every stage (LN, Dense + bias, GELU,
    dwconv + bias, GELU, Dense + bias) computes in float32 from its rounded
    inputs and rounds its output once to x.dtype, as the kernel does. (A
    bf16 Dense followed by a separate bias add would round twice.) On CUDA,
    the float32 matmul and conv must not use TF32 for this to hold.
    `act_store` round-trips the LN output, both GELU outputs and the output
    through `actstore.compress` (looked up at call time), each after its
    rounding to x.dtype."""
    dt = x.dtype
    C = x.shape[-1]
    Ch = w1.shape[1]

    def cast(t):  # the parameter as the kernel sees it, in float32
        return t.to(device=x.device, dtype=dt).float()

    def gelu(t):
        return F.gelu(t.float(), approximate="tanh" if fast_gelu else "none"
                      ).to(dt)

    def store(t):
        return actstore.compress(t, act_store)

    xn = store(F.layer_norm(x.float(), (C,), cast(ln_scale), cast(ln_bias),
                            eps).to(dt))
    h = store(gelu(F.linear(xn.float(), cast(w1).t(), cast(b1)).to(dt)))
    dw = cast(dw_kernel).reshape(3, 3, Ch).permute(2, 0, 1)[:, None]
    h = F.conv2d(h.float().permute(0, 3, 1, 2), dw, cast(dw_bias), padding=1,
                 groups=Ch).permute(0, 2, 3, 1).to(dt)
    h = store(gelu(h))
    return store(F.linear(h.float(), cast(w2).t(), cast(b2)).to(dt))


def kernel_smem_bytes(C: int, dtype: torch.dtype,
                      act_store: Optional[str] = None,
                      Ch: Optional[int] = None) -> int:
    """The bytes of shared memory csrc/leff.cu allocates for
    plan_tile(C, dtype, act_store, Ch), as the compiled kernel counts them
    (builds it; needs nvcc)."""
    Ch = 4 * C if Ch is None else Ch
    plan = plan_tile(C, dtype, act_store, Ch)
    lib = _build.load_library("leff", _SIGNATURES)
    fn = lib.leff_smem_bytes
    fn.argtypes, fn.restype = [_I] * 6, ctypes.c_long
    return fn(_DTYPES[dtype], C, Ch, plan.th, plan.tw,
              actstore.mode_code(act_store))


def fp8_trip(x: torch.Tensor) -> torch.Tensor:
    """x read back from its e4m3 storage as K2 reads it at each of its fp8
    sites: `csrc/leff.cu`'s device function (`leff_fp8_trip`) on a CUDA
    tensor, `actstore.compress(x, "fp8")` on a CPU tensor. It exists to
    hold that device function to `compress` on the card."""
    if x.device.type == "cpu":
        return actstore.compress(x, "fp8")
    if x.device.type != "cuda":
        raise ValueError(f"fp8_trip takes a CPU or CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fp8_trip takes float32 or bfloat16, got {x.dtype}")
    x = x.contiguous()
    out = torch.empty_like(x)
    lib = _build.load_library("leff", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.leff_fp8_trip(_DTYPES[x.dtype], x.data_ptr(),
                                out.data_ptr(), x.numel(), stream)
    _build.check(lib, err, "leff_fp8_trip")
    return out


def leff_fused(x, *, ln_scale, ln_bias, w1, b1, dw_kernel, dw_bias, w2, b2,
               eps: float = 1e-5, fast_gelu: bool = False,
               act_store: Optional[str] = None) -> torch.Tensor:
    """LeFF(LN(x)) for x [B, H, W, C], any H and W, through the operator
    `torch.ops.dehaze_tpu_torch.leff_fused` (`leff_fused_op`, below): the
    kernel on a CUDA tensor, `leff_reference` on a CPU tensor, with the
    `act_store` round trips inside. Forward only on CUDA: a CUDA x that
    requires grad raises."""
    if (x.device.type == "cuda" and torch.is_grad_enabled()
            and x.requires_grad):
        raise NotImplementedError("K2 is forward only (inference)")
    return leff_fused_op(x, ln_scale, ln_bias, w1, b1, dw_kernel, dw_bias,
                         w2, b2, float(eps), bool(fast_gelu),
                         actstore.mode_code(act_store))


# K2 as one operator, `torch.ops.dehaze_tpu_torch.leff_fused`, which
# `torch.export` keeps as a node of its graph. Its CPU kernel is the plain
# twin `leff_reference`; its CUDA kernel launches csrc/leff.cu and counts the
# launch in `leff_fused.launches`; any other device raises. (Registered
# through `torch.library.Library`, as K1's forward: `torch.library.custom_op`
# imports torch._dynamo at an operator's first call.) `act_store` is the
# mode's code and trails with a default, so artifacts exported before it
# existed still load.
_LIB = torch.library.Library("dehaze_tpu_torch", "FRAGMENT")
_LIB.define("leff_fused(Tensor x, Tensor ln_scale, Tensor ln_bias, "
            "Tensor w1, Tensor b1, Tensor dw_kernel, Tensor dw_bias, "
            "Tensor w2, Tensor b2, float eps, bool fast_gelu, "
            "int act_store=0) -> Tensor")


def _leff_fused_cpu(x, ln_scale, ln_bias, w1, b1, dw_kernel, dw_bias, w2, b2,
                    eps, fast_gelu, act_store=0):
    return leff_reference(x, ln_scale=ln_scale, ln_bias=ln_bias, w1=w1,
                          b1=b1, dw_kernel=dw_kernel, dw_bias=dw_bias, w2=w2,
                          b2=b2, eps=eps, fast_gelu=fast_gelu,
                          act_store=actstore.mode_of(act_store))


def _leff_fused_cuda(x, ln_scale, ln_bias, w1, b1, dw_kernel, dw_bias, w2,
                     b2, eps, fast_gelu, act_store=0):
    actstore.mode_of(act_store)  # an unknown code raises
    if x.dtype not in _DTYPES:
        raise TypeError(f"K2 takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    B, H, W, C = x.shape
    Ch = w1.shape[1]
    kw = dict(ln_scale=ln_scale, ln_bias=ln_bias, w1=w1, b1=b1,
              dw_kernel=dw_kernel, dw_bias=dw_bias, w2=w2, b2=b2)
    shapes = {"ln_scale": (C,), "ln_bias": (C,), "w1": (C, Ch), "b1": (Ch,),
              "dw_kernel": (3, 3, 1, Ch), "dw_bias": (Ch,), "w2": (Ch, C),
              "b2": (C,)}
    for name, shape in shapes.items():
        if tuple(kw[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(kw[name].shape)}")
    p = {name: kw[name].to(device=x.device, dtype=x.dtype).contiguous()
         for name in shapes}
    dw = p["dw_kernel"].reshape(9, Ch)
    plan = plan_tile(C, x.dtype, actstore.mode_of(act_store), Ch)
    out = torch.empty_like(x)
    lib = _build.load_library("leff", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.leff_fwd(
            _DTYPES[x.dtype], x.data_ptr(), p["ln_scale"].data_ptr(),
            p["ln_bias"].data_ptr(), p["w1"].data_ptr(), p["b1"].data_ptr(),
            dw.data_ptr(), p["dw_bias"].data_ptr(), p["w2"].data_ptr(),
            p["b2"].data_ptr(), out.data_ptr(), B, H, W, C, Ch, plan.th,
            plan.tw, float(eps), int(fast_gelu), int(act_store), stream)
    _build.check(lib, err, "leff_fwd")
    leff_fused.launches += 1
    return out


def _leff_fused_fake(x, ln_scale, ln_bias, w1, b1, dw_kernel, dw_bias, w2,
                     b2, eps, fast_gelu, act_store=0):
    return torch.empty_like(x)


_LIB.impl("leff_fused", _leff_fused_cpu, "CPU")
_LIB.impl("leff_fused", _leff_fused_cuda, "CUDA")
torch.library.register_fake("dehaze_tpu_torch::leff_fused", _leff_fused_fake,
                            lib=_LIB)
leff_fused_op = torch.ops.dehaze_tpu_torch.leff_fused


leff_fused.launches = 0
