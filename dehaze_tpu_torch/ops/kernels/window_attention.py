"""K1: fused ProbSparse window attention, forward and backward.

Replaces `fused_window_attention` (version 4: `_prep_v4`, the custom VJP
`_fused_attn_v4` with `_fused_attn_v4_fwd` / `_kernel_v4` and
`_fused_attn_v4_bwd` / `_kernel_v4_bwd`) of
`dehaze_tpu/ops/pallas/window_attention.py`. `fused_window_attention` is a
`torch.autograd.Function`: on CUDA tensors its forward and backward launch
the hand-written kernels in `csrc/window_attention.cu`; on CPU tensors they
run the plain twins `ops.probsparse.probsparse_attention_bnc` and
`probsparse_attention_bnc_bwd`. There is no other path: a failed build or
launch raises. Gradients go to q, k, v and `rel_pos_bias`; the backward
reuses the forward's `sample_idx`, so the selection is never redrawn.

The kernels cover any head count, N = win² ≤ 64 (win ≤ 8), head dim ≤ 64,
shifted (region ids) and unshifted windows, float32 and bfloat16.
`pad_flag` (any-resolution inputs) is not ported yet and raises on every
device.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dehaze_tpu_torch.ops import probsparse as ps_ops
from dehaze_tpu_torch.ops.kernels import _build
from dehaze_tpu_torch.utils.transfer import to_device

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "window_attention_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _F, _P],
    "window_attention_bwd": [_I] + [_P] * 12 + [_I] * 6 + [_F, _I, _P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_N = 64
MAX_HEAD_DIM = 64
# Backward CTAs per head count share the windows, each writing one dbias
# partial: 4 per SM (two are resident at N=64, D=32).
BWD_CTAS_PER_SM = 4


def _check(q, k, v, num_heads, rel_pos_bias, sw_region, num_windows):
    """Validate a CUDA call; returns the kernel's bias (float32 [H, N, N]
    or None), region ids (int32 [nW, N] or None) and nW."""
    B, N, C = q.shape
    H = num_heads
    if q.dtype not in _DTYPES:
        raise TypeError(f"K1 takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype, device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if C % H or C // H > MAX_HEAD_DIM or N > MAX_N:
        raise ValueError(f"K1 needs C % heads == 0, head dim <= "
                         f"{MAX_HEAD_DIM} and N <= {MAX_N}; got C={C}, "
                         f"heads={H}, N={N}")
    dev = q.device
    bias = None
    if rel_pos_bias is not None:
        if tuple(rel_pos_bias.shape) != (H, N, N):
            raise ValueError(f"rel_pos_bias must be [{H}, {N}, {N}]")
        bias = rel_pos_bias.detach().to(device=dev,
                                        dtype=torch.float32).contiguous()
    region = None
    nW = 1
    if sw_region is not None:
        nW = sw_region.shape[0]
        if nW != num_windows or B % nW or sw_region.shape[1] != N:
            raise ValueError("sw_region must be [num_windows, N] with B_ a "
                             "multiple of num_windows")
        region = sw_region.to(device=dev, dtype=torch.int32).contiguous()
    return bias, region, nW


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def count_matrix(sample_idx: torch.Tensor, n: int,
                 device: torch.device) -> torch.Tensor:
    """The kernels' int32 [n, n] sample counts on `device`, built where
    sample_idx lies and copied without stalling the host."""
    return to_device(ps_ops.sample_count_matrix(sample_idx, n).to(
        torch.int32), device)


def window_attention_fwd(q, k, v, *, num_heads, sample_idx, rel_pos_bias=None,
                         sw_region=None, num_windows=1, factor=5, scale=None,
                         cnt=None):
    """The forward alone, no autograd: the K1 kernel on CUDA, the twin on
    the CPU. `cnt` is `count_matrix(sample_idx, ...)` when the caller has
    it already. Counts its kernel launches in `.launches`."""
    kw = dict(num_heads=num_heads, sample_idx=sample_idx,
              rel_pos_bias=rel_pos_bias, sw_region=sw_region, factor=factor,
              scale=scale)
    if q.device.type == "cpu":
        return ps_ops.probsparse_attention_bnc(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    bias, region, nW = _check(q, k, v, num_heads, rel_pos_bias, sw_region,
                              num_windows)
    B, N, C = q.shape
    dev = q.device
    scale = ps_ops._scale(q, num_heads, scale)
    if cnt is None:
        cnt = count_matrix(sample_idx, N, dev)
    out = torch.empty_like(q)
    lib = _build.load_library("window_attention", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.window_attention_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            cnt.data_ptr(), _ptr(bias), _ptr(region), out.data_ptr(), B, N, C,
            num_heads, nW, ps_ops.probsparse_u(N, factor), float(scale),
            stream)
    _build.check(lib, err, "window_attention_fwd")
    window_attention_fwd.launches += 1
    return out


def window_attention_bwd(q, k, v, g, *, num_heads, sample_idx,
                         rel_pos_bias=None, sw_region=None, num_windows=1,
                         factor=5, scale=None, cnt=None):
    """(dq, dk, dv, dbias) for the output gradient g: the K1 backward kernel
    on CUDA, `probsparse_attention_bnc_bwd` on the CPU. dbias is float32
    [H, N, N], summed over windows, or None without a bias. `cnt` as for
    the forward. Counts its calls on CUDA in `.launches`: each call
    launches the backward kernel and, with a bias, the dbias reduction
    kernel after it."""
    kw = dict(num_heads=num_heads, sample_idx=sample_idx,
              rel_pos_bias=rel_pos_bias, sw_region=sw_region, factor=factor,
              scale=scale)
    if q.device.type == "cpu":
        return ps_ops.probsparse_attention_bnc_bwd(q, k, v, g, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    bias, region, nW = _check(q, k, v, num_heads, rel_pos_bias, sw_region,
                              num_windows)
    B, N, C = q.shape
    H = num_heads
    dev = q.device
    if g.shape != q.shape or g.device != dev:
        raise ValueError("g must match q in shape and device")
    g = g.to(q.dtype).contiguous()
    scale = ps_ops._scale(q, num_heads, scale)
    if cnt is None:
        cnt = count_matrix(sample_idx, N, dev)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_blocks = max(1, min(B, BWD_CTAS_PER_SM * sms // H))
    db_part = dbias = None
    if bias is not None:
        db_part = torch.empty(n_blocks, H, N, N, device=dev,
                              dtype=torch.float32)
        dbias = torch.empty(H, N, N, device=dev, dtype=torch.float32)
    lib = _build.load_library("window_attention", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.window_attention_bwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            g.data_ptr(), cnt.data_ptr(), _ptr(bias), _ptr(region),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(db_part),
            _ptr(dbias), B, N, C, H, nW, ps_ops.probsparse_u(N, factor),
            float(scale), n_blocks, stream)
    _build.check(lib, err, "window_attention_bwd")
    window_attention_bwd.launches += 1
    return dq, dk, dv, dbias


window_attention_fwd.launches = 0
window_attention_bwd.launches = 0


class _FusedWindowAttention(torch.autograd.Function):
    """The custom VJP `_fused_attn_v4`: forward through K1, backward through
    the K1 backward, both recomputing from the same saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, rel_pos_bias, sample_idx, sw_region, kw):
        # built once per forward and reused by the backward
        cnt = (count_matrix(sample_idx, q.shape[1], q.device)
               if q.device.type == "cuda" else None)
        out = window_attention_fwd(q, k, v, rel_pos_bias=rel_pos_bias,
                                   sample_idx=sample_idx, sw_region=sw_region,
                                   cnt=cnt, **kw)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(q, k, v, rel_pos_bias)
            # constants, not differentiable: kept as they are (they may be
            # cached tensors made under inference mode)
            ctx.consts = dict(sample_idx=sample_idx, sw_region=sw_region,
                              cnt=cnt, **kw)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, rel_pos_bias = ctx.saved_tensors
        dq, dk, dv, dbias = window_attention_bwd(
            q, k, v, g, rel_pos_bias=rel_pos_bias, **ctx.consts)
        if dbias is not None:
            dbias = dbias.to(rel_pos_bias.dtype)
        return dq, dk, dv, dbias, None, None, None


def fused_window_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    num_heads: int,
    sample_idx: torch.Tensor,
    rel_pos_bias: Optional[torch.Tensor] = None,
    sw_region: Optional[torch.Tensor] = None,
    num_windows: int = 1,
    factor: int = 5,
    scale: Optional[float] = None,
    pad_flag: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """ProbSparse window attention over q/k/v [B_, N, C] (heads as channel
    slices) -> context [B_, N, C], differentiable in q, k, v and
    rel_pos_bias. sample_idx [N, U_part]; rel_pos_bias [H, N, N] or None;
    sw_region [num_windows, N] region ids or None."""
    if pad_flag is not None:
        raise NotImplementedError("pad_flag (any-resolution inference) is "
                                  "not ported yet")
    kw = dict(num_heads=num_heads, num_windows=num_windows, factor=factor,
              scale=scale)
    return _FusedWindowAttention.apply(q, k, v, rel_pos_bias, sample_idx,
                                       sw_region, kw)
