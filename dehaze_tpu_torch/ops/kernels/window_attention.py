"""K1 and K3: fused ProbSparse window attention, forward and backward.

K1 replaces `fused_window_attention` (version 4: `_prep_v4`, the custom VJP
`_fused_attn_v4` with `_fused_attn_v4_fwd` / `_kernel_v4` and
`_fused_attn_v4_bwd` / `_kernel_v4_bwd`) of
`dehaze_tpu/ops/pallas/window_attention.py`. `fused_window_attention` is a
`torch.autograd.Function`: on CUDA tensors its forward and backward launch
hand-written kernels; on CPU tensors they run the plain twins
`ops.probsparse.probsparse_attention_bnc` and `probsparse_attention_bnc_bwd`.
There is no other path: a failed build or launch raises. Gradients go to
q, k, v and `rel_pos_bias`; the backward reuses the forward's
`sample_idx`, so the selection is never redrawn. The token-major forward
(K1 and K3-v3) is the torch custom operator
`torch.ops.dehaze_tpu_torch.window_attention_fwd`
(`window_attention_fwd_op`; torch dispatches it by device), so a
`torch.export` graph keeps it as one node and an exported artifact
launches the kernel on the card.

Three forward kernels, chosen by shape, dtype, numerics and layout alone
(`fwd_kernel_for`):
- "tc", `csrc/window_attention_tc.cu`: bf16, N <= 64, head dim 16, 32, 48
  or 64 — every shape of the model's default configuration — in K1's
  numerics (token-major), K3-v3's (token-major) and K3-v2's and v1's
  (head-major). QK^T on the float64 tensor cores, PV on the bf16 ones, a
  warp per window-head; counted in `.launches_tc` of its entry point
  (`window_attention_fwd`, `window_attention_v3_fwd`,
  `probsparse_window_attention_v1`, `probsparse_window_attention_v2`);
- "f32", `window_attention_f32_fwd_kernel` of `csrc/window_attention.cu`:
  K1 in float32 at the same shapes (token-major), register-blocked on the
  CUDA cores with S computed exactly as the backward recomputes it;
  counted in `window_attention_fwd.launches_f32`;
- "cuda_core", `window_attention_fwd_kernel` of `csrc/window_attention.cu`:
  everything else (larger windows or heads, K3 in float32); counted in
  `.launches` of its entry point.
All select exactly the rows the twin selects (see the sources' notes).
Two backward kernels, chosen the same way (`bwd_kernel_for`):
- "tc", `window_attention_tc_bwd_kernel` of `csrc/window_attention_tc.cu`:
  the forward's shapes with u <= 32 kept rows (every shape of the default
  configuration); it runs the forward's selection code, then only the kept
  rows' products on the bf16 tensor cores; counted in `.launches_tc` of
  `window_attention_bwd` and `window_attention_v3_bwd`;
- "cuda_core", `window_attention_bwd_kernel` of `csrc/window_attention.cu`:
  everything else, float32 included; counted in `.launches`.

K3 are the older TPU kernels of the same chain, which round at other points
(see `ops.probsparse`); the same CUDA kernels run them with another
numerics argument ("v23" on the tensor-core kernels as well):
- `fused_window_attention(version=3)`: `_fused_attn_v3_fwd` / `_kernel_v3`
  and `_fused_attn_v3_bwd` / `_kernel_v3_bwd` (`window_attention.py:618`,
  `:639`), forward and backward;
- `probsparse_window_attention_v1` and `_v2`: the forward-only
  `probsparse_window_attention_pallas` (`:317`) and `..._pallas_v2`
  (`:220`), on head-major q/k/v [B, H, N, D]. Their window tiling, padding
  and packing transposes are TPU layout work and have no counterpart.

The kernels cover any head count, any N = win² and head dim, shifted
(region ids) and unshifted windows, padding flags (`pad_flag`,
any-resolution inputs: −100 where both tokens are padding), float32 and
bfloat16. Where the CUDA-core kernels' tiles do not fit in shared memory
(N = 256 for 16×16 windows, wide heads) they live in a workspace the
wrapper allocates (`_workspace`). Each public entry counts its kernel
launches in `.launches`.
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
    "window_attention_fwd": ([_I, _I, _I] + [_P] * 8 + [_I] * 6
                             + [_F, _P, _I, _P]),
    "window_attention_bwd": ([_I, _I] + [_P] * 13 + [_I] * 6
                             + [_F, _I, _P, _P]),
    "window_attention_ws_bytes": [_I] * 3,
    "window_attention_f32_fwd": [_P] * 8 + [_I] * 6 + [_F, _P],
}
_TC_SIGNATURES = {
    "window_attention_tc_fwd": [_P] * 8 + [_I] * 6 + [_F, _I, _I, _P],
    "window_attention_tc_bwd": [_P] * 13 + [_I] * 6 + [_F, _I, _I, _P],
    "window_attention_tc_bwd_slots": [_I] * 5,
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NUMERICS = {"v4": 0, "v1": 1, "v23": 2}
# What the tensor-core kernels take (csrc/window_attention_tc.cu); the
# backward also needs u <= TC_BWD_MAX_KEPT.
TC_MAX_N = 64
TC_HEAD_DIMS = (16, 32, 48, 64)
TC_NUMERICS = ("v4", "v1", "v23")
# the layouts (head-major or not) each numerics has on the tensor cores:
# K1 token-major, K3-v1 head-major, K3-v3 token-major and K3-v2 head-major
TC_LAYOUTS = {"v4": (False,), "v1": (True,), "v23": (False, True)}
TC_BWD_MAX_KEPT = 32
# Backward CTAs per head count share the windows, each writing one dbias
# partial: 4 per SM (two are resident at N=64, D=32). A CUDA-core forward
# whose tiles live in a workspace has as many CTAs walking its windows.
BWD_CTAS_PER_SM = 4


def fwd_kernel_for(dtype: torch.dtype, numerics: str, n: int,
                   head_dim: int, head_major: bool = False) -> str:
    """Which forward kernel a CUDA call launches: "tc" (the tensor-core
    kernel: bf16, N <= 64, head dim 16, 32, 48 or 64, K1's or K3-v3's
    numerics token-major [B_, N, C], K3-v2's or v1's head-major [B, H, N,
    D]), "f32" (K1's float32 kernel: float32, K1's numerics token-major,
    the same N and head dims) or "cuda_core" (everything else)."""
    if n > TC_MAX_N or head_dim not in TC_HEAD_DIMS:
        return "cuda_core"
    if (dtype == torch.bfloat16 and numerics in TC_NUMERICS
            and head_major in TC_LAYOUTS[numerics]):
        return "tc"
    if dtype == torch.float32 and numerics == "v4" and not head_major:
        return "f32"
    return "cuda_core"


def bwd_kernel_for(dtype: torch.dtype, numerics: str, n: int,
                   head_dim: int, factor: int = 5) -> str:
    """Which backward kernel a CUDA call launches: "tc" (the tensor-core
    kernel: the forward's shapes and numerics, with u = probsparse_u(n,
    factor) <= 32 kept rows) or "cuda_core" (everything else)."""
    if (fwd_kernel_for(dtype, numerics, n, head_dim) == "tc"
            and ps_ops.probsparse_u(n, factor) <= TC_BWD_MAX_KEPT):
        return "tc"
    return "cuda_core"


def _check_masks(B, N, sw_region, pad_flag, num_windows):
    """Region ids and pad flags must be [num_windows, N], B_ a multiple of
    num_windows; returns nW (1 without either)."""
    nW = 1
    for name, t in (("sw_region", sw_region), ("pad_flag", pad_flag)):
        if t is None:
            continue
        if (t.dim() != 2 or tuple(t.shape) != (num_windows, N)
                or B % num_windows):
            raise ValueError(f"{name} must be [num_windows, N] = "
                             f"[{num_windows}, {N}] with B_ a multiple of "
                             f"num_windows; got {list(t.shape)}, B_={B}")
        nW = num_windows
    return nW


def _check(q, k, v, num_heads, rel_pos_bias, sw_region, pad_flag,
           num_windows, head_major):
    """Validate a CUDA call; returns the kernel's bias (float32 [H, N, N]
    or None), region ids and pad flags (int32 [nW, N] or None) and nW."""
    if head_major:
        B, H, N, D = q.shape
    else:
        B, N, C = q.shape
        H = num_heads
        D = C // H if C % H == 0 else 0
    if q.dtype not in _DTYPES:
        raise TypeError(f"K1 takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype, device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if D <= 0:
        raise ValueError(f"K1 needs C % heads == 0; got shape "
                         f"{list(q.shape)}, heads={H}")
    nW = _check_masks(B, N, sw_region, pad_flag, num_windows)
    dev = q.device
    bias = None
    if rel_pos_bias is not None:
        if tuple(rel_pos_bias.shape) != (H, N, N):
            raise ValueError(f"rel_pos_bias must be [{H}, {N}, {N}]")
        bias = rel_pos_bias.detach().to(device=dev,
                                        dtype=torch.float32).contiguous()
    region = pad = None
    if sw_region is not None:
        region = sw_region.to(device=dev, dtype=torch.int32).contiguous()
    if pad_flag is not None:
        pad = (pad_flag.to(dev) != 0).to(torch.int32).contiguous()
    return bias, region, pad, nW


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def count_matrix(sample_idx: torch.Tensor, n: int,
                 device: torch.device) -> torch.Tensor:
    """The kernels' int32 [n, n] sample counts on `device`, built where
    sample_idx lies and copied without stalling the host."""
    return to_device(ps_ops.sample_count_matrix(sample_idx, n).to(
        torch.int32), device)


def _workspace(lib, bwd, N, D, ctas, dev):
    """The float32 workspace of `ctas` CTAs of a CUDA-core kernel, or None
    when its tiles fit in shared memory."""
    nbytes = lib.window_attention_ws_bytes(int(bwd), N, D)
    if nbytes <= 0:
        return None
    return torch.empty(ctas * nbytes // 4, device=dev, dtype=torch.float32)


def _launch_fwd(entry, numerics, head_major, q, k, v, *, num_heads,
                sample_idx, rel_pos_bias, sw_region, pad_flag, num_windows,
                factor, scale, cnt):
    """Launch the forward kernel that `fwd_kernel_for` names on CUDA
    tensors and count it on `entry` (`.launches_tc` for the tensor-core
    kernel, `.launches_f32` for K1's float32 one, `.launches` for the
    CUDA-core one)."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    bias, region, pad, nW = _check(q, k, v, num_heads, rel_pos_bias,
                                   sw_region, pad_flag, num_windows,
                                   head_major)
    B, N = q.shape[0], q.shape[-2]
    C = q.shape[1] * q.shape[3] if head_major else q.shape[2]
    H = q.shape[1] if head_major else num_heads
    dev = q.device
    scale = ps_ops._scale(q, 1 if head_major else num_heads, scale)
    u = ps_ops.probsparse_u(N, factor)
    if cnt is None:
        cnt = count_matrix(sample_idx, N, dev)
    out = torch.empty_like(q)
    route = fwd_kernel_for(q.dtype, numerics, N, C // H, head_major)
    if route == "f32":
        lib = _build.load_library("window_attention", _SIGNATURES)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.window_attention_f32_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), cnt.data_ptr(),
                _ptr(bias), _ptr(region), _ptr(pad), out.data_ptr(), B, N, C,
                H, nW, u, float(scale), stream)
        _build.check(lib, err, "window_attention_f32_fwd")
        entry.launches_f32 += 1
        return out
    if route == "tc":
        lib = _build.load_library("window_attention_tc", _TC_SIGNATURES)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.window_attention_tc_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), cnt.data_ptr(),
                _ptr(bias), _ptr(region), _ptr(pad), out.data_ptr(), B, N, C,
                H, nW, u, float(scale), _NUMERICS[numerics], int(head_major),
                stream)
        _build.check(lib, err, f"window_attention_tc_fwd ({numerics})")
        entry.launches_tc += 1
        return out
    lib = _build.load_library("window_attention", _SIGNATURES)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ws_blocks = max(1, min(B, BWD_CTAS_PER_SM * sms // H))
    ws = _workspace(lib, False, N, C // H, ws_blocks * H, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.window_attention_fwd(
            _DTYPES[q.dtype], _NUMERICS[numerics], int(head_major),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cnt.data_ptr(),
            _ptr(bias), _ptr(region), _ptr(pad), out.data_ptr(), B, N, C, H,
            nW, u, float(scale), _ptr(ws), ws_blocks, stream)
    _build.check(lib, err, f"window_attention_fwd ({numerics})")
    entry.launches += 1
    return out


# K1's (numerics "v4") and K3-v3's ("v23") token-major forward as one
# operator, `torch.ops.dehaze_tpu_torch.window_attention_fwd`, which
# `torch.export` keeps as a node of its graph. cnt is the int32 [N, N] count
# matrix (`count_matrix`), scale a number. Its CPU kernel runs the plain twin
# `ps_ops.probsparse_attention_bnc`; its CUDA kernel launches the kernel
# `fwd_kernel_for` names and counts it on `window_attention_fwd` ("v4") or
# `window_attention_v3_fwd` ("v23"); any other device raises. (Registered
# through `torch.library.Library`: `torch.library.custom_op` imports
# torch._dynamo at an operator's first call, seconds of every process's
# first frame.)
_LIB = torch.library.Library("dehaze_tpu_torch", "FRAGMENT")
_LIB.define("window_attention_fwd(Tensor q, Tensor k, Tensor v, Tensor cnt, "
            "Tensor? rel_pos_bias, Tensor? sw_region, Tensor? pad_flag, "
            "int num_heads, int num_windows, int factor, float scale, "
            "str numerics) -> Tensor")


def _window_attention_fwd_cpu(q, k, v, cnt, rel_pos_bias, sw_region,
                              pad_flag, num_heads, num_windows, factor,
                              scale, numerics):
    _check_masks(q.shape[0], q.shape[1], sw_region, pad_flag, num_windows)
    return ps_ops.probsparse_attention_bnc(
        q, k, v, num_heads=num_heads, cnt=cnt, rel_pos_bias=rel_pos_bias,
        sw_region=sw_region, pad_flag=pad_flag, factor=factor, scale=scale,
        numerics=numerics)


def _window_attention_fwd_cuda(q, k, v, cnt, rel_pos_bias, sw_region,
                               pad_flag, num_heads, num_windows, factor,
                               scale, numerics):
    if numerics not in _FWD_ENTRIES:
        raise ValueError(f"the token-major forward takes numerics "
                         f"{sorted(_FWD_ENTRIES)}, got {numerics!r}")
    n = q.shape[1]
    if (cnt.dtype != torch.int32 or tuple(cnt.shape) != (n, n)
            or cnt.device != q.device):
        raise ValueError(f"cnt must be int32 [{n}, {n}] on {q.device}, got "
                         f"{cnt.dtype} {list(cnt.shape)} on {cnt.device}")
    return _launch_fwd(_FWD_ENTRIES[numerics], numerics, False, q, k, v,
                       num_heads=num_heads, sample_idx=None,
                       rel_pos_bias=rel_pos_bias, sw_region=sw_region,
                       pad_flag=pad_flag, num_windows=num_windows,
                       factor=factor, scale=scale, cnt=cnt.contiguous())


def _window_attention_fwd_fake(q, k, v, cnt, rel_pos_bias, sw_region,
                               pad_flag, num_heads, num_windows, factor,
                               scale, numerics):
    return torch.empty_like(q)


_LIB.impl("window_attention_fwd", _window_attention_fwd_cpu, "CPU")
_LIB.impl("window_attention_fwd", _window_attention_fwd_cuda, "CUDA")
torch.library.register_fake("dehaze_tpu_torch::window_attention_fwd",
                            _window_attention_fwd_fake, lib=_LIB)
window_attention_fwd_op = torch.ops.dehaze_tpu_torch.window_attention_fwd


def _attention_fwd(numerics, q, k, v, *, num_heads, sample_idx=None,
                   rel_pos_bias=None, sw_region=None, pad_flag=None,
                   num_windows=1, factor=5, scale=None, cnt=None):
    if cnt is None:
        cnt = count_matrix(sample_idx, q.shape[1], q.device)
    return window_attention_fwd_op(
        q, k, v, cnt, rel_pos_bias, sw_region, pad_flag, num_heads,
        num_windows, factor, float(ps_ops._scale(q, num_heads, scale)),
        numerics)


def _attention_bwd(entry, numerics, q, k, v, g, *, num_heads, sample_idx,
                   rel_pos_bias=None, sw_region=None, pad_flag=None,
                   num_windows=1, factor=5, scale=None, cnt=None):
    kw = dict(num_heads=num_heads, sample_idx=sample_idx,
              rel_pos_bias=rel_pos_bias, sw_region=sw_region,
              pad_flag=pad_flag, factor=factor, scale=scale)
    if q.device.type == "cpu":
        _check_masks(q.shape[0], q.shape[1], sw_region, pad_flag,
                     num_windows)
        return ps_ops.probsparse_attention_bnc_bwd(q, k, v, g,
                                                   numerics=numerics, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    bias, region, pad, nW = _check(q, k, v, num_heads, rel_pos_bias,
                                   sw_region, pad_flag, num_windows, False)
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
    u = ps_ops.probsparse_u(N, factor)
    if bwd_kernel_for(q.dtype, numerics, N, C // H, factor) == "tc":
        lib = _build.load_library("window_attention_tc", _TC_SIGNATURES)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            # the dbias partials the kernel fills; minus a CUDA error
            slots = lib.window_attention_tc_bwd_slots(B, N, C, H,
                                                      _NUMERICS[numerics])
            _build.check(lib, max(0, -slots), "window_attention_tc_bwd_slots")
            db_part = dbias = None
            if bias is not None:
                db_part = torch.empty(slots, H, N, N, device=dev,
                                      dtype=torch.float32)
                dbias = torch.empty(H, N, N, device=dev, dtype=torch.float32)
            err = lib.window_attention_tc_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                cnt.data_ptr(), _ptr(bias), _ptr(region), _ptr(pad),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(db_part),
                _ptr(dbias), B, N, C, H, nW, u, float(scale), slots,
                _NUMERICS[numerics], stream)
        _build.check(lib, err, f"window_attention_tc_bwd ({numerics})")
        entry.launches_tc += 1
        return dq, dk, dv, dbias
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_blocks = max(1, min(B, BWD_CTAS_PER_SM * sms // H))
    db_part = dbias = None
    if bias is not None:
        db_part = torch.empty(n_blocks, H, N, N, device=dev,
                              dtype=torch.float32)
        dbias = torch.empty(H, N, N, device=dev, dtype=torch.float32)
    lib = _build.load_library("window_attention", _SIGNATURES)
    ws = _workspace(lib, True, N, C // H, n_blocks * H, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.window_attention_bwd(
            _DTYPES[q.dtype], _NUMERICS[numerics], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), g.data_ptr(), cnt.data_ptr(),
            _ptr(bias), _ptr(region), _ptr(pad), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _ptr(db_part), _ptr(dbias), B, N,
            C, H, nW, u, float(scale), n_blocks, _ptr(ws), stream)
    _build.check(lib, err, f"window_attention_bwd ({numerics})")
    entry.launches += 1
    return dq, dk, dv, dbias


def window_attention_fwd(q, k, v, **kw):
    """The K1 forward alone, no autograd, through `window_attention_fwd_op`:
    a kernel on CUDA, the twin on the CPU. Keywords as
    `fused_window_attention`'s, plus `cnt`, `count_matrix(sample_idx,
    ...)` when the caller has it already. Counts
    the tensor-core kernel's launches in `.launches_tc`, the float32
    kernel's in `.launches_f32` and the CUDA-core kernel's in `.launches`
    (`fwd_kernel_for` says which runs)."""
    return _attention_fwd("v4", q, k, v, **kw)


def window_attention_bwd(q, k, v, g, **kw):
    """(dq, dk, dv, dbias) of K1 for the output gradient g: a K1 backward
    kernel on CUDA, `probsparse_attention_bnc_bwd` on the CPU. dbias is
    float32 [H, N, N], summed over windows, or None without a bias. `cnt`
    as for the forward. Counts its calls on CUDA, the tensor-core kernel's
    in `.launches_tc` and the CUDA-core kernel's in `.launches`
    (`bwd_kernel_for` says which runs): each call launches the backward
    kernel and, with a bias, the dbias reduction kernel after it."""
    return _attention_bwd(window_attention_bwd, "v4", q, k, v, g, **kw)


def window_attention_v3_fwd(q, k, v, **kw):
    """K3-v3 forward (`_fused_attn_v3_fwd`, "v23" numerics), as
    `window_attention_fwd`: the tensor-core kernel's launches in
    `.launches_tc`, the CUDA-core kernel's in `.launches`."""
    return _attention_fwd("v23", q, k, v, **kw)


def window_attention_v3_bwd(q, k, v, g, **kw):
    """K3-v3 backward (`_fused_attn_v3_bwd`, "v23" numerics: dk from the
    rounded q·scale), as `window_attention_bwd`, counted the same way."""
    return _attention_bwd(window_attention_v3_bwd, "v23", q, k, v, g, **kw)


def _head_major_fwd(entry, numerics, twin, q, k, v, sample_idx,
                     rel_pos_bias, sw_region, num_windows, factor, scale):
    if q.device.type == "cpu":
        _check_masks(q.shape[0], q.shape[2], sw_region, None, num_windows)
        return twin(q, k, v, sample_idx=sample_idx,
                    rel_pos_bias=rel_pos_bias, sw_region=sw_region,
                    factor=factor, scale=scale)
    return _launch_fwd(entry, numerics, True, q, k, v,
                       num_heads=q.shape[1], sample_idx=sample_idx,
                       rel_pos_bias=rel_pos_bias, sw_region=sw_region,
                       pad_flag=None, num_windows=num_windows, factor=factor,
                       scale=scale, cnt=None)


def probsparse_window_attention_v1(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    sample_idx: torch.Tensor, rel_pos_bias: Optional[torch.Tensor] = None,
    sw_region: Optional[torch.Tensor] = None, num_windows: int = 1,
    factor: int = 5, scale: Optional[float] = None,
) -> torch.Tensor:
    """K3-v1, the counterpart of `probsparse_window_attention_pallas`
    (`dehaze_tpu/ops/pallas/window_attention.py:317`): ProbSparse window
    attention over q/k/v [B, H, N, D] (B = nB·nW window-major) -> [B, H, N,
    D], forward only, with nothing rounded inside the chain ("v1"
    numerics). The kernel on CUDA, `ops.probsparse.probsparse_attention_v1`
    on the CPU. Counts the tensor-core kernel's launches in `.launches_tc`
    and the CUDA-core kernel's in `.launches` (`fwd_kernel_for(...,
    head_major=True)` says which runs)."""
    return _head_major_fwd(probsparse_window_attention_v1, "v1",
                            ps_ops.probsparse_attention_v1, q, k, v,
                            sample_idx, rel_pos_bias, sw_region, num_windows,
                            factor, scale)


def probsparse_window_attention_v2(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    sample_idx: torch.Tensor, rel_pos_bias: Optional[torch.Tensor] = None,
    sw_region: Optional[torch.Tensor] = None, num_windows: int = 1,
    factor: int = 5, scale: Optional[float] = None,
) -> torch.Tensor:
    """K3-v2, the counterpart of `probsparse_window_attention_pallas_v2`
    (`dehaze_tpu/ops/pallas/window_attention.py:220`): as
    `probsparse_window_attention_v1` with "v23" numerics (q·scale rounded,
    S and a1 not rounded, a2 rounded before PV). The kernel on CUDA,
    `ops.probsparse.probsparse_attention_v2` on the CPU, counted as v1."""
    return _head_major_fwd(probsparse_window_attention_v2, "v23",
                            ps_ops.probsparse_attention_v2, q, k, v,
                            sample_idx, rel_pos_bias, sw_region, num_windows,
                            factor, scale)


for _entry in (window_attention_fwd, window_attention_bwd,
               window_attention_v3_fwd, window_attention_v3_bwd,
               probsparse_window_attention_v1,
               probsparse_window_attention_v2):
    _entry.launches = 0
    _entry.launches_tc = 0
    _entry.launches_f32 = 0

_FWD_ENTRIES = {"v4": window_attention_fwd, "v23": window_attention_v3_fwd}
_VERSIONS = {4: (window_attention_fwd, window_attention_bwd),
             3: (window_attention_v3_fwd, window_attention_v3_bwd)}


class _FusedWindowAttention(torch.autograd.Function):
    """The custom VJPs `_fused_attn_v4` and `_fused_attn_v3`: forward and
    backward through the kernels of one version, both recomputing from the
    same saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, rel_pos_bias, sample_idx, sw_region, pad_flag,
                version, kw):
        fwd, _ = _VERSIONS[version]
        # built once per forward, on every device (a traced graph then does
        # not depend on the device it was traced on), and reused by the
        # backward
        cnt = count_matrix(sample_idx, q.shape[1], q.device)
        out = fwd(q, k, v, rel_pos_bias=rel_pos_bias, sample_idx=sample_idx,
                  sw_region=sw_region, pad_flag=pad_flag, cnt=cnt, **kw)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(q, k, v, rel_pos_bias)
            # constants, not differentiable: kept as they are (they may be
            # cached tensors made under inference mode)
            ctx.version = version
            ctx.consts = dict(sample_idx=sample_idx, sw_region=sw_region,
                              pad_flag=pad_flag, cnt=cnt, **kw)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, rel_pos_bias = ctx.saved_tensors
        _, bwd = _VERSIONS[ctx.version]
        dq, dk, dv, dbias = bwd(q, k, v, g, rel_pos_bias=rel_pos_bias,
                                **ctx.consts)
        if dbias is not None:
            dbias = dbias.to(rel_pos_bias.dtype)
        return dq, dk, dv, dbias, None, None, None, None, None


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
    version: int = 4,
) -> torch.Tensor:
    """ProbSparse window attention over q/k/v [B_, N, C] (heads as channel
    slices) -> context [B_, N, C], differentiable in q, k, v and
    rel_pos_bias. sample_idx [N, U_part]; rel_pos_bias [H, N, N] or None;
    sw_region and pad_flag [num_windows, N] region ids and padding flags
    (nonzero on padding), or None. version 4 is K1; version 3 runs the
    K3-v3 kernels, which round as `_kernel_v3` does."""
    if version not in _VERSIONS:
        raise ValueError(f"version must be 3 or 4, got {version!r}")
    kw = dict(num_heads=num_heads, num_windows=num_windows, factor=factor,
              scale=scale)
    return _FusedWindowAttention.apply(q, k, v, rel_pos_bias, sample_idx,
                                       sw_region, pad_flag, version, kw)
