"""The port's CUDA kernels (K1's tensor-core and CUDA-core forwards and
backwards, with and without padding flags, at every window size and head
width; the K3 variants v1, v2 and v3; K2 at any stage height and with each
--act_store mode) against their
plain twins, on an NVIDIA GPU.

Every test here needs the card and skips without one (the kernels have no
CPU mode). The file imports neither jax nor the JAX package, so it runs on
the GPU host, which has neither; there, without the repo's conftest (which
imports jax):

    PYTHONPATH=. python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances are chip_smoke.py's: K1 f32 1e-4 on every row, bf16 1.6e-2 on
all but 0.1% of rows; K1 backward, per gradient tensor, every element
within tol·max|ref| with tol 1e-5 (f32) and 2^-7 (bf16, one ulp at the
tensor's largest magnitude); K2 |Δ| <= tol·(1 + |ref|) with tol 1e-4 (f32)
and 1e-2 (bf16). In bf16 each K1 and K3 kernel is also held to its own
rounding points (nearer its own twin than the other numerics' twins). The
tensor-core K1 forward and backward select exactly the twin's rows: 0
flipped rows.
"""

import math

import numpy as np
import pytest
import torch

from dehaze_tpu_torch.config import ModelConfig
from dehaze_tpu_torch.models.uformer import Uformer
from dehaze_tpu_torch.ops import probsparse as TPS
from dehaze_tpu_torch.ops import window as TW
from dehaze_tpu_torch.ops.kernels.leff import (kernel_smem_bytes, leff_fused,
                                               leff_reference, plan_tile)
from dehaze_tpu_torch.ops.kernels.window_attention import (
    bwd_kernel_for, fused_window_attention, fwd_kernel_for,
    probsparse_window_attention_v1, probsparse_window_attention_v2,
    window_attention_bwd, window_attention_fwd, window_attention_v3_bwd,
    window_attention_v3_fwd)

K1_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1.6e-2, 1e-3)}
K1B_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
K2_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rng(seed):
    return np.random.default_rng(seed)


def _pad_flags(rng, nW, N):
    """[nW, N] flags: whole windows of padding, partly padded ones and
    clean ones."""
    flags = (rng.uniform(size=(nW, N)) < 0.5).astype(np.float32)
    flags[0] = 1.0
    if nW > 2:
        flags[1] = 0.0
    return torch.from_numpy(flags)


def _attn_inputs(dev, heads, win, D, shifted, dtype, seed, bias=True,
                 pad=False):
    N = win * win
    rng = _rng(seed)
    nW = 8 if shifted or pad else 1
    region = None
    if shifted:
        region = torch.from_numpy(TW.shift_region_ids(4 * win, 2 * win, win,
                                                      win // 2))
        assert region.shape[0] == nW
    B = 2 * nW
    q, k, v = (torch.from_numpy(rng.normal(size=(B, N, heads * D)).astype(
        np.float32) * 0.5).to(dev, dtype) for _ in range(3))
    kw = dict(num_heads=heads,
              sample_idx=torch.from_numpy(rng.integers(
                  0, N, size=(N, TPS.probsparse_u(N))).astype(np.int32)),
              rel_pos_bias=torch.from_numpy(rng.normal(
                  size=(heads, N, N)).astype(np.float32) * 0.1).to(dev)
              if bias else None,
              sw_region=None if region is None else region.to(dev))
    if pad:
        kw["pad_flag"] = _pad_flags(rng, nW, N).to(dev)
    return q, k, v, kw, nW


def _fwd_count(dtype, N, D):
    """The launch counter of the forward kernel that a K1 call takes."""
    attr = ("launches_tc" if fwd_kernel_for(dtype, "v4", N, D) == "tc"
            else "launches")
    return lambda: getattr(window_attention_fwd, attr)


def _bwd_count(dtype, N, D):
    """The launch counter of the backward kernel that a K1 call takes."""
    attr = ("launches_tc" if bwd_kernel_for(dtype, "v4", N, D) == "tc"
            else "launches")
    return lambda: getattr(window_attention_bwd, attr)


def _flipped_rows(got, q, k, v, kw, numerics="v4"):
    """Rows where the kernel's choice between a2 @ V and mean(V) differs
    from the twin's selection (K1's, or K3-v3's with numerics "v23"). The
    kernels' mean(V) is the float32 sum over tokens in token order, divided
    by N and rounded: a row is the kernel's mean(V) row iff it equals that
    bit for bit."""
    heads = kw["num_heads"]
    B, N, C = q.shape
    mask = TPS.attention_mask(kw.get("sw_region"), kw.get("pad_flag"))
    row_mask = TPS._chain_bhnd(
        TPS._heads(q, heads), TPS._heads(k, heads), TPS._heads(v, heads),
        kw["sample_idx"], kw.get("rel_pos_bias"), mask, 5,
        TPS._scale(q, heads, None), numerics)[3]              # [B, H, N]
    s = torch.zeros(B, C, device=v.device)
    for j in range(N):
        s = s + v[:, j].float()
    mean = (s / N).to(v.dtype)                                # [B, C]
    is_mean = (TPS._heads(got, heads) == TPS._heads(mean[:, None], heads)
               ).all(-1)                                      # [B, H, N]
    return int((is_mean == row_mask).sum())


def _assert_rows_close(got, want, heads, D, dtype):
    """K1_TOL on every row of D values (all but `share` of them)."""
    tol, share = K1_TOL[dtype]
    rows = (got.float() - want.float()).abs().reshape(-1, D).amax(-1)
    assert int((rows > tol).sum()) <= share * rows.numel()


def _assert_grads_close(got, want, dtype, shape, bias):
    tol = K1B_TOL[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        assert a.dtype == dtype and a.shape == shape, name
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), name
    if not bias:
        assert got[3] is None and want[3] is None
        return
    assert got[3].dtype == torch.float32
    err = float((got[3] - want[3]).abs().max())
    assert err <= tol * float(want[3].abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("heads,win,D,shifted,dtype,bias", [
    (1, 8, 32, True, torch.float32, True),
    (2, 8, 32, False, torch.bfloat16, True),
    (16, 8, 32, False, torch.float32, True),
    (3, 6, 64, True, torch.float32, True),   # N=36, >48 KB shared memory
    (4, 4, 32, False, torch.bfloat16, True),
    (8, 2, 32, False, torch.float32, True),
    (2, 8, 32, True, torch.float32, False),  # rel-pos-bias ablation
    # the tensor-core kernel at N off the MMA tiles and every head dim
    (3, 6, 64, True, torch.bfloat16, True),  # N=36
    (8, 2, 32, False, torch.bfloat16, True),  # N=4
    (2, 8, 16, True, torch.bfloat16, True),
    (1, 8, 48, True, torch.bfloat16, True),
    (2, 7, 32, False, torch.bfloat16, False),  # N=49, odd
    # the CUDA-core kernel from its workspace: 16x16 windows, wide heads
    (1, 16, 32, True, torch.float32, True),
    (2, 16, 32, False, torch.bfloat16, True),
    (1, 8, 96, True, torch.float32, True),
    (1, 8, 128, False, torch.bfloat16, True),
])
def test_k1_matches_twin(cuda, heads, win, D, shifted, dtype, bias):
    q, k, v, kw, nW = _attn_inputs(cuda, heads, win, D, shifted, dtype,
                                   seed=heads * 10 + win, bias=bias)
    count = _fwd_count(dtype, win * win, D)
    before = count()
    got = fused_window_attention(q, k, v, num_windows=nW, **kw)
    assert count() == before + 1
    want = TPS.probsparse_attention_bnc(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    tol, share = K1_TOL[dtype]
    rows = (got.float() - want.float()).abs().reshape(
        q.shape[0], q.shape[1], heads, D).amax(-1)
    assert int((rows > tol).sum()) <= share * rows.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("std", [0.5, 2.0])
@pytest.mark.parametrize("heads,win,shifted,pad", [
    (1, 8, True, False), (2, 8, False, True), (16, 8, True, True),
    (4, 4, True, False), (3, 6, False, True), (8, 2, False, False)])
def test_k1_tc_selects_the_twins_rows(cuda, heads, win, shifted, pad, std):
    """The tensor-core forward (bf16) keeps exactly the twin's rows, q and
    k at std 0.5 and 2, over 64 windows: its S and M are exact in float64
    (csrc/window_attention_tc.cu)."""
    q, k, v, kw, nW = _attn_inputs(cuda, heads, win, 32, shifted,
                                   torch.bfloat16, seed=80 + heads + win,
                                   pad=pad)
    q, k, v = (t.repeat(8, 1, 1) for t in (q, k, v))
    q = (q.float() * (std / 0.5) + torch.randn_like(q.float()) * 0.01
         ).bfloat16()
    k = (k.float() * (std / 0.5)).bfloat16()
    assert fwd_kernel_for(torch.bfloat16, "v4", win * win, 32) == "tc"
    got = window_attention_fwd(q, k, v, num_windows=nW, **kw)
    want = TPS.probsparse_attention_bnc(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _flipped_rows(got, q, k, v, kw) == 0
    _assert_rows_close(got, want, heads, 32, torch.bfloat16)


@pytest.mark.cuda
def test_k1_refuses_what_it_does_not_take(cuda):
    q, k, v, kw, nW = _attn_inputs(cuda, 2, 8, 32, False, torch.float32, 1)
    with pytest.raises(ValueError, match="pad_flag"):
        fused_window_attention(q, k, v, pad_flag=torch.zeros(2, 64), **kw)
    with pytest.raises(ValueError, match="version"):
        fused_window_attention(q, k, v, version=1, **kw)
    with pytest.raises(ValueError):
        fused_window_attention(q.transpose(0, 1).contiguous().transpose(
            0, 1), k, v, **kw)
    with pytest.raises(TypeError):
        fused_window_attention(q.half(), k.half(), v.half(), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [1, 2, 16])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_backward_matches_twin(cuda, heads, shifted, bias, dtype):
    q, k, v, kw, nW = _attn_inputs(cuda, heads, 8, 32, shifted, dtype,
                                   seed=heads + 7 * shifted + 3 * bias,
                                   bias=bias)
    g = torch.from_numpy(_rng(heads).normal(size=q.shape).astype(
        np.float32)).to(cuda, dtype)
    count = _bwd_count(dtype, 64, 32)
    before = count()
    got = window_attention_bwd(q, k, v, g, num_windows=nW, **kw)
    assert count() == before + 1
    want = TPS.probsparse_attention_bnc_bwd(q, k, v, g, **kw)
    torch.cuda.synchronize()
    tol = K1B_TOL[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        assert a.dtype == dtype and a.shape == q.shape, name
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), name
    if not bias:
        assert got[3] is None and want[3] is None
        return
    assert got[3].dtype == torch.float32
    err = float((got[3] - want[3]).abs().max())
    assert err <= tol * float(want[3].abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("heads,win,D,shifted,dtype", [
    (1, 16, 32, True, torch.float32), (1, 16, 32, True, torch.bfloat16),
    (2, 16, 32, False, torch.float32), (1, 8, 96, True, torch.float32),
    (1, 8, 128, False, torch.bfloat16)])
def test_k1_backward_matches_twin_at_large_shapes(cuda, heads, win, D,
                                                  shifted, dtype):
    """16x16 windows (N = 256) and head dims 96 and 128: the backward's
    tiles and its dbias partials in the workspace."""
    q, k, v, kw, nW = _attn_inputs(cuda, heads, win, D, shifted, dtype,
                                   seed=90 + win + D)
    g = torch.from_numpy(_rng(91).normal(size=q.shape).astype(
        np.float32)).to(cuda, dtype)
    got = window_attention_bwd(q, k, v, g, num_windows=nW, **kw)
    want = TPS.probsparse_attention_bnc_bwd(q, k, v, g, **kw)
    torch.cuda.synchronize()
    _assert_grads_close(got, want, dtype, q.shape, True)


@pytest.mark.cuda
def test_k1_backward_is_deterministic(cuda):
    """dbias is reduced in a fixed order: two runs agree bit for bit."""
    q, k, v, kw, nW = _attn_inputs(cuda, 2, 8, 32, True, torch.float32, 4)
    q, k, v = (t.repeat(64, 1, 1) for t in (q, k, v))
    g = torch.randn_like(q)
    a = window_attention_bwd(q, k, v, g, num_windows=nW, **kw)
    b = window_attention_bwd(q, k, v, g, num_windows=nW, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _bwd_flipped_rows(dq, want_dq, q, k, v, kw, numerics="v4"):
    """Rows where the backward's kept rows differ from the twin's
    selection (numerics as for _flipped_rows), as dq shows them: a kernel's dq is exactly zero on the rows
    it did not keep. So a flip is a nonzero dq on a row the twin does not
    keep, or a zero dq on a kept row where the twin's dq is far from zero
    (above 1e-30; a kept row whose softmax saturates under the -100 masks
    has a dq that rounds to zero in the twin too)."""
    heads = kw["num_heads"]
    mask = TPS.attention_mask(kw.get("sw_region"), kw.get("pad_flag"))
    row_mask = TPS._chain_bhnd(
        TPS._heads(q, heads), TPS._heads(k, heads), TPS._heads(v, heads),
        kw["sample_idx"], kw.get("rel_pos_bias"), mask, 5,
        TPS._scale(q, heads, None), numerics)[3]              # [B, H, N]
    zero = (TPS._heads(dq, heads) == 0).all(-1)
    clear = TPS._heads(want_dq.float(), heads).abs().amax(-1) > 1e-30
    return int((~row_mask & ~zero).sum() + (row_mask & clear & zero).sum())


# (heads, win, D, shifted, pad, bias): N 16, 49 and 64 at every head dim,
# with and without bias, region ids and pad flags; and N = 4
_TC_BWD_CASES = [
    (1, 8, 32, True, False, True), (2, 8, 64, True, True, True),
    (4, 8, 16, False, False, False), (1, 8, 48, False, True, True),
    (2, 7, 32, False, False, True), (1, 7, 64, False, True, False),
    (3, 7, 16, False, False, True), (1, 7, 48, False, False, True),
    (2, 4, 32, True, False, True), (1, 4, 64, False, True, True),
    (4, 4, 16, True, True, False), (2, 4, 48, False, False, True),
    (8, 2, 32, False, False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("std", [0.5, 2.0])
@pytest.mark.parametrize("heads,win,D,shifted,pad,bias", _TC_BWD_CASES)
def test_k1_tc_backward_matches_twin(cuda, heads, win, D, shifted, pad, bias,
                                     std):
    """The tensor-core backward (bf16) against the twin, q and k at std 0.5
    and 2, over 64 windows: K1B_TOL per gradient tensor, and it keeps
    exactly the twin's rows (0 flipped)."""
    q, k, v, kw, nW = _attn_inputs(cuda, heads, win, D, shifted,
                                   torch.bfloat16, seed=60 + heads + win + D,
                                   bias=bias, pad=pad)
    reps = 64 // q.shape[0]
    q, k, v = (t.repeat(reps, 1, 1) for t in (q, k, v))
    q = (q.float() * (std / 0.5) + torch.randn_like(q.float()) * 0.01
         ).bfloat16()
    k = (k.float() * (std / 0.5)).bfloat16()
    g = torch.from_numpy(_rng(win + D).normal(size=q.shape).astype(
        np.float32)).to(cuda, torch.bfloat16)
    assert bwd_kernel_for(torch.bfloat16, "v4", win * win, D) == "tc"
    before = (window_attention_bwd.launches_tc, window_attention_bwd.launches)
    got = window_attention_bwd(q, k, v, g, num_windows=nW, **kw)
    assert (window_attention_bwd.launches_tc - before[0],
            window_attention_bwd.launches - before[1]) == (1, 0)
    want = TPS.probsparse_attention_bnc_bwd(q, k, v, g, **kw)
    torch.cuda.synchronize()
    _assert_grads_close(got, want, torch.bfloat16, q.shape, bias)
    assert _bwd_flipped_rows(got[0], want[0], q, k, v, kw) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 37, 130])
def test_k1_tc_backward_ragged_window_counts(cuda, B):
    """Window counts below the warps of a CTA and off its multiple: every
    warp's dbias slot is zeroed, the idle ones' too."""
    q, k, v, kw, _ = _attn_inputs(cuda, 2, 8, 32, False, torch.bfloat16,
                                  seed=70 + B)
    q, k, v = (t.repeat(B, 1, 1)[:B] for t in (q, k, v))
    q = q + (torch.randn_like(q.float()) * 0.05).bfloat16()
    g = torch.randn_like(q.float()).bfloat16()
    got = window_attention_bwd(q, k, v, g, **kw)
    want = TPS.probsparse_attention_bnc_bwd(q, k, v, g, **kw)
    torch.cuda.synchronize()
    _assert_grads_close(got, want, torch.bfloat16, q.shape, True)
    assert _bwd_flipped_rows(got[0], want[0], q, k, v, kw) == 0


@pytest.mark.cuda
def test_k1_tc_backward_is_deterministic(cuda):
    """The tensor-core backward's dbias (per-warp partials summed in slot
    order) and gradients agree bit for bit between two runs."""
    q, k, v, kw, nW = _attn_inputs(cuda, 2, 8, 32, True, torch.bfloat16, 5)
    q, k, v = (t.repeat(256, 1, 1) for t in (q, k, v))
    q = q + (torch.randn_like(q.float()) * 0.05).bfloat16()
    g = torch.randn_like(q.float()).bfloat16()
    before = window_attention_bwd.launches_tc
    a = window_attention_bwd(q, k, v, g, num_windows=nW, **kw)
    b = window_attention_bwd(q, k, v, g, num_windows=nW, **kw)
    assert window_attention_bwd.launches_tc == before + 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_bwd_kernel_for_routes_by_shape_and_dtype():
    """bf16, K1's or K3-v3's numerics, N <= 64, head dim 16/32/48/64 and u
    <= 32 go to the tensor-core backward; f32, N = 256, head dim 96 and u >
    32 (a larger ProbSparse factor) to the CUDA-core one."""
    bf, f32 = torch.bfloat16, torch.float32
    for num in ("v4", "v23"):
        for n, d in ((64, 32), (64, 16), (49, 48), (16, 64), (4, 32)):
            assert bwd_kernel_for(bf, num, n, d) == "tc", (num, n, d)
        for args in ((f32, num, 64, 32), (bf, num, 256, 32),
                     (bf, num, 64, 96), (bf, num, 64, 128)):
            assert bwd_kernel_for(*args) == "cuda_core", args
        assert bwd_kernel_for(bf, num, 64, 32, factor=7) == "cuda_core"
    assert TPS.probsparse_u(64, 7) > 32


def test_fwd_kernel_for_routes_head_major():
    """The head-major K3 forwards: bf16 v1 and v2 ("v23") at N <= 64 and
    head dims 16/32/48/64 go to the tensor-core forward; f32, N = 256 and
    other head dims to the CUDA-core one. K1 ("v4") has no head-major form
    on the tensor cores, and v1 no token-major one, nor any backward."""
    bf, f32 = torch.bfloat16, torch.float32
    for num in ("v1", "v23"):
        for n, d in ((64, 32), (64, 16), (49, 48), (16, 64), (4, 32)):
            assert fwd_kernel_for(bf, num, n, d, head_major=True) == "tc"
        for args in ((f32, num, 64, 32), (bf, num, 256, 32),
                     (bf, num, 64, 96), (bf, num, 64, 24)):
            assert fwd_kernel_for(*args, head_major=True) == "cuda_core"
    assert fwd_kernel_for(bf, "v4", 64, 32, head_major=True) == "cuda_core"
    assert fwd_kernel_for(bf, "v1", 64, 32) == "cuda_core"
    assert bwd_kernel_for(bf, "v1", 64, 32) == "cuda_core"


@pytest.mark.cuda
@pytest.mark.parametrize("win,D,dtype", [(8, 32, torch.float32),
                                         (16, 32, torch.bfloat16),
                                         (8, 96, torch.bfloat16)])
def test_k1_backward_routes_to_the_cuda_core_kernel(cuda, win, D, dtype):
    q, k, v, kw, nW = _attn_inputs(cuda, 1, win, D, True, dtype, seed=3)
    g = torch.randn_like(q.float()).to(dtype)
    before = (window_attention_bwd.launches_tc, window_attention_bwd.launches)
    got = window_attention_bwd(q, k, v, g, num_windows=nW, **kw)
    assert (window_attention_bwd.launches_tc - before[0],
            window_attention_bwd.launches - before[1]) == (0, 1)
    want = TPS.probsparse_attention_bnc_bwd(q, k, v, g, **kw)
    torch.cuda.synchronize()
    _assert_grads_close(got, want, dtype, q.shape, True)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,shifted,dtype", [
    (1, True, torch.float32), (1, True, torch.bfloat16),
    (2, False, torch.float32), (16, False, torch.bfloat16),
    (4, True, torch.float32)])
def test_k1_pad_flag_matches_twin(cuda, heads, shifted, dtype):
    """Padding flags (−100 between padded tokens, on top of the region
    mask), forward and backward."""
    q, k, v, kw, nW = _attn_inputs(cuda, heads, 8, 32, shifted, dtype,
                                   seed=40 + heads, pad=True)
    got = fused_window_attention(q, k, v, num_windows=nW, **kw)
    want = TPS.probsparse_attention_bnc(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_rows_close(got, want, heads, 32, dtype)
    g = torch.from_numpy(_rng(heads).normal(size=q.shape).astype(
        np.float32)).to(cuda, dtype)
    got = window_attention_bwd(q, k, v, g, num_windows=nW, **kw)
    want = TPS.probsparse_attention_bnc_bwd(q, k, v, g, **kw)
    torch.cuda.synchronize()
    _assert_grads_close(got, want, dtype, q.shape, True)


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("heads,win,shifted,dtype,bias", [
    (2, 8, True, torch.float32, True), (2, 8, True, torch.bfloat16, True),
    (16, 8, False, torch.float32, True), (4, 4, False, torch.bfloat16, False)])
def test_k3_v1_v2_match_twins(cuda, version, heads, win, shifted, dtype,
                              bias):
    """The head-major K3 forwards ([B, H, N, D]) against their twins, each
    call counted on the kernel `fwd_kernel_for` names (bf16 on the tensor
    cores, f32 on the CUDA cores)."""
    entry, twin = {
        "v1": (probsparse_window_attention_v1, TPS.probsparse_attention_v1),
        "v2": (probsparse_window_attention_v2, TPS.probsparse_attention_v2),
    }[version]
    q, k, v, kw, nW = _attn_inputs(cuda, heads, win, 32, shifted, dtype,
                                   seed=50 + heads, bias=bias)
    B, N = q.shape[:2]
    q, k, v = (t.reshape(B, N, heads, 32).transpose(1, 2).contiguous()
               for t in (q, k, v))
    kw.pop("num_heads")
    numerics = "v1" if version == "v1" else "v23"
    attr = ("launches_tc" if fwd_kernel_for(dtype, numerics, win * win, 32,
                                            head_major=True) == "tc"
            else "launches")
    before = getattr(entry, attr)
    got = entry(q, k, v, num_windows=nW, **kw)
    assert getattr(entry, attr) == before + 1
    want = twin(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    _assert_rows_close(got, want, heads, 32, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,shifted,dtype,bias", [
    (1, True, torch.float32, True), (2, True, torch.bfloat16, True),
    (16, False, torch.float32, True), (2, False, torch.bfloat16, False)])
def test_k3_v3_matches_twin(cuda, heads, shifted, dtype, bias):
    """fused_window_attention(version=3): the v3 forward and backward
    kernels against the twins with "v23" numerics (bf16 on the tensor-core
    kernels, f32 on the CUDA-core ones)."""
    q, k, v, kw, nW = _attn_inputs(cuda, heads, 8, 32, shifted, dtype,
                                   seed=60 + heads, bias=bias)
    attr = "launches_tc" if dtype == torch.bfloat16 else "launches"
    counts = (getattr(window_attention_v3_fwd, attr),
              getattr(window_attention_v3_bwd, attr))
    got = fused_window_attention(q, k, v, num_windows=nW, version=3, **kw)
    want = TPS.probsparse_attention_bnc(q, k, v, numerics="v23", **kw)
    torch.cuda.synchronize()
    _assert_rows_close(got, want, heads, 32, dtype)
    g = torch.from_numpy(_rng(heads + 1).normal(size=q.shape).astype(
        np.float32)).to(cuda, dtype)
    got = window_attention_v3_bwd(q, k, v, g, num_windows=nW, **kw)
    want = TPS.probsparse_attention_bnc_bwd(q, k, v, g, numerics="v23", **kw)
    torch.cuda.synchronize()
    _assert_grads_close(got, want, dtype, q.shape, bias)
    assert (getattr(window_attention_v3_fwd, attr),
            getattr(window_attention_v3_bwd, attr)) == (counts[0] + 1,
                                                        counts[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("std", [0.5, 2.0])
@pytest.mark.parametrize("heads,win,D,shifted,pad,bias", _TC_BWD_CASES)
def test_k3_v3_tc_matches_twin(cuda, heads, win, D, shifted, pad, bias,
                               std):
    """K3-v3 on the tensor-core kernels (bf16), forward and backward,
    against the "v23" twins at N 4, 16, 49 and 64 and head dims 16-64, q
    and k at std 0.5 and 2, over 64 windows: K1_TOL per row, K1B_TOL per
    gradient tensor, and exactly the twin's rows kept (0 flipped)."""
    q, k, v, kw, nW = _attn_inputs(cuda, heads, win, D, shifted,
                                   torch.bfloat16, seed=90 + heads + win + D,
                                   bias=bias, pad=pad)
    reps = 64 // q.shape[0]
    q, k, v = (t.repeat(reps, 1, 1) for t in (q, k, v))
    q = (q.float() * (std / 0.5) + torch.randn_like(q.float()) * 0.01
         ).bfloat16()
    k = (k.float() * (std / 0.5)).bfloat16()
    g = torch.from_numpy(_rng(win + D + 1).normal(size=q.shape).astype(
        np.float32)).to(cuda, torch.bfloat16)
    N = win * win
    assert fwd_kernel_for(torch.bfloat16, "v23", N, D) == "tc"
    assert bwd_kernel_for(torch.bfloat16, "v23", N, D) == "tc"
    before = (window_attention_v3_fwd.launches_tc,
              window_attention_v3_bwd.launches_tc,
              window_attention_v3_fwd.launches,
              window_attention_v3_bwd.launches)
    out = window_attention_v3_fwd(q, k, v, num_windows=nW, **kw)
    got = window_attention_v3_bwd(q, k, v, g, num_windows=nW, **kw)
    assert (window_attention_v3_fwd.launches_tc,
            window_attention_v3_bwd.launches_tc,
            window_attention_v3_fwd.launches,
            window_attention_v3_bwd.launches) == (before[0] + 1,
                                                  before[1] + 1,
                                                  before[2], before[3])
    want_out = TPS.probsparse_attention_bnc(q, k, v, numerics="v23", **kw)
    want = TPS.probsparse_attention_bnc_bwd(q, k, v, g, numerics="v23", **kw)
    torch.cuda.synchronize()
    _assert_rows_close(out, want_out, heads, D, torch.bfloat16)
    assert _flipped_rows(out, q, k, v, kw, "v23") == 0
    _assert_grads_close(got, want, torch.bfloat16, q.shape, bias)
    assert _bwd_flipped_rows(got[0], want[0], q, k, v, kw, "v23") == 0


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 37, 130])
def test_k3_v3_tc_ragged_window_counts(cuda, B):
    """K3-v3 on the tensor cores at window counts below a CTA's warps and
    off its multiple, forward and backward."""
    q, k, v, kw, _ = _attn_inputs(cuda, 2, 8, 32, False, torch.bfloat16,
                                  seed=75 + B)
    q, k, v = (t.repeat(B, 1, 1)[:B] for t in (q, k, v))
    q = q + (torch.randn_like(q.float()) * 0.05).bfloat16()
    g = torch.randn_like(q.float()).bfloat16()
    out = window_attention_v3_fwd(q, k, v, **kw)
    got = window_attention_v3_bwd(q, k, v, g, **kw)
    want_out = TPS.probsparse_attention_bnc(q, k, v, numerics="v23", **kw)
    want = TPS.probsparse_attention_bnc_bwd(q, k, v, g, numerics="v23", **kw)
    torch.cuda.synchronize()
    _assert_rows_close(out, want_out, 2, 32, torch.bfloat16)
    assert _flipped_rows(out, q, k, v, kw, "v23") == 0
    _assert_grads_close(got, want, torch.bfloat16, q.shape, True)
    assert _bwd_flipped_rows(got[0], want[0], q, k, v, kw, "v23") == 0


def _head_major(t, heads):
    """[B, N, C] -> [B, H, N, D], contiguous."""
    B, N, C = t.shape
    return t.reshape(B, N, heads, C // heads).transpose(1, 2).contiguous()


def _token_major(t):
    """[B, H, N, D] -> [B, N, C]."""
    B, H, N, D = t.shape
    return t.transpose(1, 2).reshape(B, N, H * D)


_HM_CASES = [c[:4] + c[5:] for c in _TC_BWD_CASES]  # no pad flags


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("std", [0.5, 2.0])
@pytest.mark.parametrize("heads,win,D,shifted,bias", _HM_CASES)
def test_k3_v1_v2_tc_matches_twin(cuda, version, heads, win, D, shifted,
                                  bias, std):
    """K3-v1 and K3-v2 (head-major [B, H, N, D]) on the tensor-core
    forward (bf16) against their twins at N 4, 16, 49 and 64 and head dims
    16-64, with and without bias and region ids, q and k at std 0.5 and 2,
    over 64 windows: K1_TOL per row, exactly the twin's rows kept (0
    flipped), and the call counted in `.launches_tc` only."""
    entry, twin, numerics = {
        "v1": (probsparse_window_attention_v1, TPS.probsparse_attention_v1,
               "v1"),
        "v2": (probsparse_window_attention_v2, TPS.probsparse_attention_v2,
               "v23")}[version]
    q, k, v, kw, nW = _attn_inputs(cuda, heads, win, D, shifted,
                                   torch.bfloat16, seed=110 + heads + win + D,
                                   bias=bias)
    reps = 64 // q.shape[0]
    q, k, v = (t.repeat(reps, 1, 1) for t in (q, k, v))
    q = (q.float() * (std / 0.5) + torch.randn_like(q.float()) * 0.01
         ).bfloat16()
    k = (k.float() * (std / 0.5)).bfloat16()
    qh, kh, vh = (_head_major(t, heads) for t in (q, k, v))
    hkw = {n: x for n, x in kw.items() if n != "num_heads"}
    assert fwd_kernel_for(torch.bfloat16, numerics, win * win, D,
                          head_major=True) == "tc"
    before = (entry.launches_tc, entry.launches)
    out = entry(qh, kh, vh, num_windows=nW, **hkw)
    assert (entry.launches_tc, entry.launches) == (before[0] + 1, before[1])
    want = twin(qh, kh, vh, **hkw)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == qh.shape
    _assert_rows_close(_token_major(out), _token_major(want), heads, D,
                       torch.bfloat16)
    assert _flipped_rows(_token_major(out), q, k, v, kw, numerics) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("B", [1, 3, 37, 130])
def test_k3_v1_v2_tc_ragged_window_counts(cuda, version, B):
    """K3-v1 and v2 on the tensor cores at window counts below a CTA's
    warps and off its multiple."""
    entry, twin, numerics = {
        "v1": (probsparse_window_attention_v1, TPS.probsparse_attention_v1,
               "v1"),
        "v2": (probsparse_window_attention_v2, TPS.probsparse_attention_v2,
               "v23")}[version]
    q, k, v, kw, _ = _attn_inputs(cuda, 2, 8, 32, False, torch.bfloat16,
                                  seed=120 + B)
    q, k, v = (t.repeat(B, 1, 1)[:B] for t in (q, k, v))
    q = q + (torch.randn_like(q.float()) * 0.05).bfloat16()
    hkw = {n: x for n, x in kw.items() if n != "num_heads"}
    before = entry.launches_tc
    out = entry(*(_head_major(t, 2) for t in (q, k, v)), **hkw)
    assert entry.launches_tc == before + 1
    want = twin(*(_head_major(t, 2) for t in (q, k, v)), **hkw)
    torch.cuda.synchronize()
    _assert_rows_close(_token_major(out), _token_major(want), 2, 32,
                       torch.bfloat16)
    assert _flipped_rows(_token_major(out), q, k, v, kw, numerics) == 0


def _gap(got, ref, own):
    """Σ over output tensors of mean |got − ref| over the largest |own|."""
    if torch.is_tensor(got):
        got, ref, own = (got,), (ref,), (own,)
    return sum(float((a.float() - b.float()).abs().mean()
                     / o.float().abs().max())
               for a, b, o in zip(got, ref, own) if a is not None)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,own", [
    ("k1_fwd", "v4"), ("k1_bwd", "v4"), ("v1", "v1"), ("v2", "v23"),
    ("v3_fwd", "v23"), ("v3_bwd", "v23")])
def test_kernels_round_where_their_own_twin_does(cuda, kernel, own):
    """bf16, q and k at std 1 (where the rounding of S moves the output):
    each kernel lies nearer its own twin than the twins of the other
    numerics, mean gap at most NUMERICS_SEP (0.5, as chip_smoke.py) of
    each other's; the variants differ by about one bf16 ulp, inside
    K1_TOL."""
    q, k, v, kw, nW = _attn_inputs(cuda, 2, 8, 32, True, torch.bfloat16,
                                   seed=70)
    q, k = q * 2, k * 2
    g = torch.from_numpy(_rng(71).normal(size=q.shape).astype(
        np.float32)).to(cuda, torch.bfloat16)
    if kernel in ("v1", "v2"):
        B, N = q.shape[:2]
        q, k, v = (t.reshape(B, N, 2, 32).transpose(1, 2).contiguous()
                   for t in (q, k, v))
        kw.pop("num_heads")
        entry = {"v1": probsparse_window_attention_v1,
                 "v2": probsparse_window_attention_v2}[kernel]
        got = entry(q, k, v, num_windows=nW, **kw)

        def twin(n):
            return TPS.probsparse_attention_bhnd(q, k, v, numerics=n, **kw)
    elif kernel.endswith("fwd"):
        entry = {"k1_fwd": window_attention_fwd,
                 "v3_fwd": window_attention_v3_fwd}[kernel]
        got = entry(q, k, v, num_windows=nW, **kw)

        def twin(n):
            return TPS.probsparse_attention_bnc(q, k, v, numerics=n, **kw)
    else:
        entry = {"k1_bwd": window_attention_bwd,
                 "v3_bwd": window_attention_v3_bwd}[kernel]
        got = entry(q, k, v, g, num_windows=nW, **kw)

        def twin(n):
            return TPS.probsparse_attention_bnc_bwd(q, k, v, g, numerics=n,
                                                    **kw)
    want = twin(own)
    torch.cuda.synchronize()
    for other in TPS.NUMERICS:
        if other != own:
            assert _gap(got, want, want) <= 0.5 * _gap(got, twin(other),
                                                       want), other


def _leff_inputs(dev, B, H, W, C, Ch, dtype, seed):
    rng = _rng(seed)

    def n(mean, std, *shape):
        return torch.from_numpy(rng.normal(mean, std, size=shape).astype(
            np.float32)).to(dev)

    p = {"ln_scale": n(1, 0.1, C), "ln_bias": n(0, 0.1, C),
         "w1": n(0, C ** -0.5, C, Ch), "b1": n(0, 0.1, Ch),
         "dw_kernel": n(0, 1 / 3, 3, 3, 1, Ch), "dw_bias": n(0, 0.1, Ch),
         "w2": n(0, Ch ** -0.5, Ch, C), "b2": n(0, 0.1, C)}
    return n(0, 1, B, H, W, C).to(dtype), p


# Every bf16 tile class of plan_tile (C 8 ... 512, 8x32, 8x16 and 8x8
# tiles), and the float32 path's plans, with Ch = 4C: each C in both types
# and both GELUs; W ragged against every tile width (13, 37 and 21 leave a
# partial tile of 8, 16 and 32 columns); batches of 1 to 3; H = 8 (one tile
# row) and H = 24.
_K2_SHAPES = [  # B, H, W, C
    (1, 8, 37, 8), (2, 16, 13, 16), (1, 24, 70, 32), (3, 8, 21, 64),
    (1, 16, 40, 96), (2, 8, 37, 128), (1, 16, 24, 256), (1, 8, 13, 512),
]


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,W,C", _K2_SHAPES,
                         ids=[f"C{s[3]}" for s in _K2_SHAPES])
def test_k2_matches_twin(cuda, B, H, W, C, dtype, fast):
    x, p = _leff_inputs(cuda, B, H, W, C, 4 * C, dtype, seed=C + W)
    before = leff_fused.launches
    got = leff_fused(x, fast_gelu=fast, **p)
    assert leff_fused.launches == before + 1
    want = leff_reference(x, fast_gelu=fast, **p)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    tol = K2_TOL[dtype]
    err = (got.float() - want.float()).abs() - tol * (1 + want.float().abs())
    assert float(err.max()) <= 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,Ch,dtype", [
    (32, 8, 8, 512, 2048, torch.float32),   # training eval bottleneck
    (32, 8, 8, 512, 2048, torch.bfloat16),
    (1, 8, 19, 20, 100, torch.bfloat16),    # C, Ch off the MMA tiles
    (1, 8, 9, 40, 52, torch.bfloat16),      # Ch not a multiple of 8
    (1, 8, 21, 40, 160, torch.bfloat16),    # cp.async path, ragged chunk
])
def test_k2_matches_twin_at_other_widths(cuda, B, H, W, C, Ch, dtype):
    x, p = _leff_inputs(cuda, B, H, W, C, Ch, dtype, seed=C + Ch)
    got = leff_fused(x, **p)
    want = leff_reference(x, **p)
    torch.cuda.synchronize()
    tol = K2_TOL[dtype]
    err = (got.float() - want.float()).abs() - tol * (1 + want.float().abs())
    assert float(err.max()) <= 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("C,W", [(32, 20), (512, 13)])
@pytest.mark.parametrize("H", [4, 12, 76])
def test_k2_matches_twin_at_ragged_heights(cuda, H, C, W, dtype):
    """Stage heights that are not a multiple of the tile's 8 rows (a ragged
    last row tile), e.g. the 76-row bottleneck of a 1216x1664 canvas."""
    x, p = _leff_inputs(cuda, 1, H, W, C, 4 * C, dtype, seed=H + C)
    before = leff_fused.launches
    got = leff_fused(x, **p)
    assert leff_fused.launches == before + 1
    want = leff_reference(x, **p)
    torch.cuda.synchronize()
    tol = K2_TOL[dtype]
    err = (got.float() - want.float()).abs() - tol * (1 + want.float().abs())
    assert float(err.max()) <= 0


# (C, Ch) beyond Ch = 4C that move int8's design: two sweeps at C = 64 and
# 128 in the classes of larger C, three sweeps at C = 64
_K2_INT8_WIDTHS = [(64, 512), (128, 1024), (64, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("C,Ch,act_store",
                         [pytest.param(s[3], 4 * s[3], None, id=str(s[3]))
                          for s in _K2_SHAPES]
                         + [pytest.param(s[3], 4 * s[3], m, id=f"{s[3]}-{m}")
                            for s in _K2_SHAPES for m in ("fp8", "int8")]
                         + [pytest.param(C, Ch, "int8", id=f"{C}-Ch{Ch}-int8")
                            for C, Ch in _K2_INT8_WIDTHS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k2_plan_is_what_the_kernel_allocates(cuda, C, Ch, act_store, dtype):
    """The planner and the compiled kernel count the same bytes for every
    mode, and for int8 in each of its designs (one pass, two sweeps, three
    sweeps)."""
    assert kernel_smem_bytes(C, dtype, act_store, Ch) == plan_tile(
        C, dtype, act_store, Ch).smem


@pytest.mark.cuda
def test_k2_refuses_what_it_does_not_take(cuda):
    x, p = _leff_inputs(cuda, 1, 8, 16, 16, 64, torch.float32, 0)
    with pytest.raises(NotImplementedError):
        leff_fused(x.clone().requires_grad_(), **p)
    with pytest.raises(ValueError):
        leff_fused(x, **{**p, "w1": p["w1"][:, :32]})


# the act_store cases: every tile class at Ch = 4C, C and Ch off the MMA
# tiles, and a ragged last row tile in each bf16 int8 design (one pass at
# C = 32, two sweeps at C = 128 and 256, three sweeps at C = 64 with
# Ch = 2048 and at C = 512)
_K2_ACT_SHAPES = ([s + (4 * s[3],) for s in _K2_SHAPES]
                  + [(1, 8, 19, 20, 100), (1, 8, 21, 40, 160),
                     (1, 12, 13, 512, 2048), (1, 12, 37, 32, 128),
                     (1, 11, 19, 128, 512), (1, 13, 9, 256, 1024),
                     (1, 9, 21, 64, 2048)])


def test_k2_act_store_cases_reach_every_int8_design():
    """The act_store cases above run int8 in one pass, two sweeps and three
    sweeps, each with a last row tile that the image leaves ragged (runs
    on the CPU: the planner only)."""
    ragged = {}
    for B, H, W, C, Ch in _K2_ACT_SHAPES:
        plan = plan_tile(C, torch.bfloat16, "int8", Ch)
        if H % plan.th:
            ragged.setdefault(plan.sweeps, []).append(C)
    assert sorted(ragged) == [1, 2, 3]


def _act_within_two_steps(got, want, mode, dtype):
    """K2 with act_store against its twin, as `chip_smoke.py` holds it: the
    same NaNs; every finite element within K2_TOL plus two quantization
    steps at the output's largest magnitude (int8: its amax / 127; fp8:
    the e4m3 spacing there): a step flipped at the LN output or in a hidden
    value reaches every output channel of a pixel. Returns the share of
    elements beyond K2_TOL."""
    g, w = got.float(), want.float()
    nan = torch.isnan(w)
    assert torch.equal(torch.isnan(g), nan)
    top = float(torch.where(nan, 0.0, w.abs()).max())
    step = (top / 127 if mode == "int8"
            else 2.0 ** (math.floor(math.log2(max(top, 2.0 ** -6))) - 3))
    d = torch.where(nan, 0.0, (g - w).abs())
    bar = K2_TOL[dtype] * (1 + w.abs())
    assert float((d - bar).max()) <= 2 * step
    return float(((d > bar) & ~nan).sum()) / max(1, int((~nan).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fp8", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,W,C,Ch", _K2_ACT_SHAPES,
                         ids=[f"C{s[3]}" for s in _K2_SHAPES]
                         + ["C20-Ch100", "C40-Ch160", "C512-H12", "C32-H12",
                            "C128-H11", "C256-H13", "C64-Ch2048-H9"])
def test_k2_act_store_matches_twin(cuda, B, H, W, C, Ch, dtype, mode):
    """Every tile class, C and Ch off the MMA tiles, a ragged chunk and a
    ragged last row tile, with act_store: within two steps (above), and at
    most 1% of the elements beyond K2_TOL (at these small shapes a few
    flips weigh more than on the serving frame, where chip_smoke.py's bar
    is 0.5% in bf16 and 0.1% in f32). In bf16 int8 runs each of its
    designs, each with a ragged last tile (test_k2_act_store_cases_reach_
    every_int8_design)."""
    x, p = _leff_inputs(cuda, B, H, W, C, Ch, dtype, seed=C + W + 1)
    before = leff_fused.launches
    got = leff_fused(x, act_store=mode, **p)
    assert leff_fused.launches == before + 1
    want = leff_reference(x, act_store=mode, **p)
    torch.cuda.synchronize()
    assert _act_within_two_steps(got, want, mode, dtype) <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("value,nan", [(448.0, False), (464.0, False),
                                       (466.0, True), (1e4, True)])
def test_k2_fp8_gives_nan_beyond_464(cuda, dtype, value, nan):
    """An LN output channel fixed at `value` (ln_scale 0) that feeds no
    hidden channel: fp8 stores 448 and 464 as 448, and gives NaN (no
    saturation) beyond 464, which dense1 then spreads to every output."""
    x, p = _leff_inputs(cuda, 1, 8, 37, 32, 128, dtype, seed=9)
    p["ln_scale"][0], p["ln_bias"][0], p["w1"][0] = 0.0, value, 0.0
    got = leff_fused(x, act_store="fp8", **p)
    want = leff_reference(x, act_store="fp8", **p)
    assert bool(torch.isnan(want).all()) is nan
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    if not nan:
        _act_within_two_steps(got, want, "fp8", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k2_fp8_trip_matches_compress(cuda, dtype):
    """K2's fp8 device function (`fp8_trip`, the hardware e4m3 convert and
    its NaN select) equals `compress(·, "fp8")` NaN for NaN and bit for
    bit elsewhere: every bf16 pattern; in float32, the 2^21 patterns
    around each edge (448, 464, 480, e4m3's smallest subnormal and normal,
    zero, inf) and their negatives."""
    from dehaze_tpu_torch.ops import actstore
    from dehaze_tpu_torch.ops.kernels.leff import fp8_trip

    if dtype == torch.bfloat16:
        x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32,
                         device=cuda).to(torch.int16).view(torch.bfloat16)
    else:
        edges = torch.tensor([448.0, 464.0, 480.0, 2.0 ** -9, 2.0 ** -6,
                              0.0, float("inf")]).view(torch.int32)
        x = torch.cat([torch.arange(int(e) - 2 ** 20, int(e) + 2 ** 20,
                                    dtype=torch.int32, device=cuda)
                       for e in edges.tolist()])
        x = torch.cat([x, x | -2 ** 31]).view(torch.float32)
    got, want = fp8_trip(x), actstore.compress(x, "fp8")
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[dtype]
    same = (got.view(bits) == want.view(bits)) | (got.isnan() & want.isnan())
    assert bool(same.all()), int((~same).sum())
    assert int(want.isnan().sum()) > 0


@pytest.mark.cuda
def test_k2_i8_trip_matches_compress(cuda):
    """K2's int8 device function of its bf16 kernels (the division as a
    product and a remainder step) equals `i8_trip_reference` (compress's
    int8 steps at the same scale, on the card) bit for bit, NaN for NaN:
    every bf16 value v against 258 amaxes a (every 128th non-negative bf16
    pattern, inf and NaN) with |v| <= a or a not finite, at compress's
    scale for a; and `compress([a, v], "int8")` as a value (compress's
    int8 cast gives +0 where the kernel keeps -0)."""
    from dehaze_tpu_torch.ops import actstore
    from dehaze_tpu_torch.ops.kernels.leff import i8_trip, i8_trip_reference

    pat = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32, device=cuda)
    v = pat.to(torch.int16).view(torch.bfloat16)
    amax = torch.cat([pat[(pat >= 0) & (pat % 128 == 0)],
                      torch.tensor([0x7F80, 0x7FC0], device=cuda)])
    a = amax.to(torch.int16).view(torch.bfloat16).repeat_interleave(
        v.numel())
    x = v.repeat(amax.numel())
    keep = (x.abs() <= a) | ~a.isfinite()
    scale = torch.clamp_min(a, 1e-8) / torch.full_like(a, 127.0)
    got = i8_trip(x, scale)
    want = i8_trip_reference(x, scale)
    same = (got.view(torch.int16) == want.view(torch.int16)) | (
        got.isnan() & want.isnan()) | ~keep
    assert bool(same.all()), int((~same).sum())
    ref = actstore.compress(torch.stack([a, x], -1), "int8")[:, 1]
    assert torch.equal(torch.nan_to_num(got[keep]),
                       torch.nan_to_num(ref[keep]))


@pytest.mark.cuda
def test_k2_refuses_an_unknown_act_store(cuda):
    x, p = _leff_inputs(cuda, 1, 8, 16, 16, 64, torch.float32, 0)
    with pytest.raises(ValueError):
        leff_fused(x, act_store="int4", **p)
    args = [x] + [p[k] for k in ("ln_scale", "ln_bias", "w1", "b1",
                                 "dw_kernel", "dw_bias", "w2", "b2")]
    with pytest.raises(ValueError):
        torch.ops.dehaze_tpu_torch.leff_fused(*args, 1e-5, False, 3)


@pytest.mark.cuda
def test_model_cuda_matches_cpu(cuda):
    """A small Uformer (embed 8) at 128², f32: the CUDA forward (kernels)
    against the CPU forward (twins), same weights and sampling seed."""
    torch.manual_seed(0)
    cfg = ModelConfig(img_size=64, embed_dim=8, dtype=torch.float32)
    cpu_model = Uformer(cfg).eval()
    gpu_model = Uformer(cfg, device=cuda).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    x = torch.from_numpy(_rng(3).uniform(size=(2, 128, 128, 3)).astype(
        np.float32))
    k1, k2 = window_attention_fwd.launches, leff_fused.launches
    with torch.inference_mode():
        want = cpu_model(x, generator=torch.Generator().manual_seed(5))
        got = gpu_model(x.to(cuda), generator=torch.Generator().manual_seed(5))
    assert window_attention_fwd.launches - k1 == 18
    assert leff_fused.launches - k2 == 18
    assert float((got.cpu() - want).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_model_ragged_stage_heights_cuda_matches_cpu(cuda):
    """A small Uformer configured at 32² (embed 8) on a 96x64 input: enc3,
    the bottleneck and dec0 have 12, 6 and 12 rows (K2's ragged last row
    tile; windows 4, 2, 4). f32 CUDA (kernels) against the CPU (twins); and
    in bf16 at embed 16 (head dim 16 at every stage) every K1 forward goes
    to the tensor-core kernel."""
    torch.manual_seed(0)
    cfg = ModelConfig(img_size=32, embed_dim=8, dtype=torch.float32)
    cpu_model = Uformer(cfg).eval()
    gpu_model = Uformer(cfg, device=cuda).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    x = torch.from_numpy(_rng(7).uniform(size=(1, 96, 64, 3)).astype(
        np.float32))
    k2 = leff_fused.launches
    with torch.inference_mode():
        want = cpu_model(x, generator=torch.Generator().manual_seed(5))
        got = gpu_model(x.to(cuda), generator=torch.Generator().manual_seed(5))
    assert leff_fused.launches - k2 == 18
    assert float((got.cpu() - want).abs().max()) <= 1e-3
    bf = Uformer(ModelConfig(img_size=32, embed_dim=16), device=cuda).eval()
    k1 = (window_attention_fwd.launches, window_attention_fwd.launches_tc)
    with torch.inference_mode():
        y = bf(x.to(cuda), generator=torch.Generator().manual_seed(5))
    assert (window_attention_fwd.launches - k1[0],
            window_attention_fwd.launches_tc - k1[1]) == (0, 18)
    assert bool(torch.isfinite(y).all())


@pytest.mark.cuda
def test_model_backward_launches_k1_backward(cuda):
    """A training forward and backward of a small Uformer (embed 8, 64²,
    f32) on CUDA runs K1 forward and backward 18 times each and no K2, and
    its gradients match the CPU's (the twins) to 1e-3 (sum order of cuBLAS
    and cuDNN against the CPU's, ~1e-6 relative per layer)."""
    torch.manual_seed(0)
    cfg = ModelConfig(img_size=64, embed_dim=8, dtype=torch.float32,
                      drop_path_rate=0.0)
    cpu_model = Uformer(cfg).train()
    gpu_model = Uformer(cfg, device=cuda).train()
    gpu_model.load_state_dict(cpu_model.state_dict())
    x = torch.from_numpy(_rng(4).uniform(size=(2, 64, 64, 3)).astype(
        np.float32))
    counts = (window_attention_fwd.launches, window_attention_bwd.launches,
              leff_fused.launches)
    for model, dev in ((cpu_model, "cpu"), (gpu_model, cuda)):
        model(x.to(dev), generator=torch.Generator().manual_seed(5)
              ).square().mean().backward()
    assert window_attention_fwd.launches - counts[0] == 18
    assert window_attention_bwd.launches - counts[1] == 18
    assert leff_fused.launches == counts[2]
    gpu = dict(gpu_model.named_parameters())
    for name, p in cpu_model.named_parameters():
        err = (gpu[name].grad.cpu() - p.grad).abs().max()
        assert float(err) <= 1e-3 * (1 + float(p.grad.abs().max())), name


@pytest.mark.cuda
def test_model_with_pad_mask_cuda_matches_cpu(cuda):
    """A small Uformer (embed 8) on a 128² canvas with a centred 100×120
    image and its padding mask, f32: CUDA (kernels) against the CPU
    (twins)."""
    from dehaze_tpu_torch.infer.anyres import expand2square

    torch.manual_seed(0)
    cfg = ModelConfig(img_size=64, embed_dim=8, dtype=torch.float32)
    cpu_model = Uformer(cfg).eval()
    gpu_model = Uformer(cfg, device=cuda).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    x = torch.from_numpy(_rng(6).uniform(size=(1, 100, 120, 3)).astype(
        np.float32))
    canvas, pad, _ = expand2square(x, 128)
    k1 = window_attention_fwd.launches
    with torch.inference_mode():
        want = cpu_model(canvas, generator=torch.Generator().manual_seed(5),
                         pad_mask=pad)
        got = gpu_model(canvas.to(cuda), pad_mask=pad.to(cuda),
                        generator=torch.Generator().manual_seed(5))
    assert window_attention_fwd.launches - k1 == 18
    assert float((got.cpu() - want).abs().max()) <= 1e-3
