"""The port's CUDA kernels against their plain twins, on an NVIDIA GPU.

Every test here needs the card and skips without one (the kernels have no
CPU mode). The file imports neither jax nor the JAX package, so it runs on
the GPU host, which has neither; there, without the repo's conftest (which
imports jax):

    PYTHONPATH=. python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances are chip_smoke.py's: K1 f32 1e-4 on every row, bf16 1.6e-2 on
all but 0.1% of rows; K1 backward, per gradient tensor, every element
within tol·max|ref| with tol 1e-5 (f32) and 2^-7 (bf16, one ulp at the
tensor's largest magnitude); K2 |Δ| <= tol·(1 + |ref|) with tol 1e-4 (f32)
and 1e-2 (bf16).
"""

import numpy as np
import pytest
import torch

from dehaze_tpu_torch.config import ModelConfig
from dehaze_tpu_torch.models.uformer import Uformer
from dehaze_tpu_torch.ops import probsparse as TPS
from dehaze_tpu_torch.ops import window as TW
from dehaze_tpu_torch.ops.kernels.leff import leff_fused, leff_reference
from dehaze_tpu_torch.ops.kernels.window_attention import (
    fused_window_attention, window_attention_bwd, window_attention_fwd)

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


def _attn_inputs(dev, heads, win, D, shifted, dtype, seed, bias=True):
    N = win * win
    rng = _rng(seed)
    nW = 8 if shifted else 1
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
    return q, k, v, kw, nW


@pytest.mark.cuda
@pytest.mark.parametrize("heads,win,D,shifted,dtype,bias", [
    (1, 8, 32, True, torch.float32, True),
    (2, 8, 32, False, torch.bfloat16, True),
    (16, 8, 32, False, torch.float32, True),
    (3, 6, 64, True, torch.float32, True),   # N=36, >48 KB shared memory
    (4, 4, 32, False, torch.bfloat16, True),
    (8, 2, 32, False, torch.float32, True),
    (2, 8, 32, True, torch.float32, False),  # rel-pos-bias ablation
])
def test_k1_matches_twin(cuda, heads, win, D, shifted, dtype, bias):
    q, k, v, kw, nW = _attn_inputs(cuda, heads, win, D, shifted, dtype,
                                   seed=heads * 10 + win, bias=bias)
    before = window_attention_fwd.launches
    got = fused_window_attention(q, k, v, num_windows=nW, **kw)
    assert window_attention_fwd.launches == before + 1
    want = TPS.probsparse_attention_bnc(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    tol, share = K1_TOL[dtype]
    rows = (got.float() - want.float()).abs().reshape(
        q.shape[0], q.shape[1], heads, D).amax(-1)
    assert int((rows > tol).sum()) <= share * rows.numel()


@pytest.mark.cuda
def test_k1_refuses_what_it_does_not_take(cuda):
    q, k, v, kw, nW = _attn_inputs(cuda, 2, 8, 32, False, torch.float32, 1)
    with pytest.raises(NotImplementedError):
        fused_window_attention(q, k, v, pad_flag=torch.zeros(1, 64), **kw)
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
    before = window_attention_bwd.launches
    got = window_attention_bwd(q, k, v, g, num_windows=nW, **kw)
    assert window_attention_bwd.launches == before + 1
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
def test_k1_backward_is_deterministic(cuda):
    """dbias is reduced in a fixed order: two runs agree bit for bit."""
    q, k, v, kw, nW = _attn_inputs(cuda, 2, 8, 32, True, torch.float32, 4)
    q, k, v = (t.repeat(64, 1, 1) for t in (q, k, v))
    g = torch.randn_like(q)
    a = window_attention_bwd(q, k, v, g, num_windows=nW, **kw)
    b = window_attention_bwd(q, k, v, g, num_windows=nW, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


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


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,Ch,dtype,fast", [
    (1, 16, 40, 32, 128, torch.float32, False),
    (2, 8, 13, 8, 32, torch.float32, False),      # ragged W edge
    (1, 8, 16, 512, 2048, torch.bfloat16, False),  # 4-row tiles
    (1, 24, 20, 96, 384, torch.float32, True),
    (1, 16, 24, 64, 256, torch.bfloat16, True),
    (32, 8, 8, 512, 2048, torch.float32, False),   # training eval bottleneck
    (32, 8, 8, 512, 2048, torch.bfloat16, False),
])
def test_k2_matches_twin(cuda, B, H, W, C, Ch, dtype, fast):
    x, p = _leff_inputs(cuda, B, H, W, C, Ch, dtype, seed=C + W)
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
def test_k2_refuses_what_it_does_not_take(cuda):
    x, p = _leff_inputs(cuda, 1, 12, 16, 16, 64, torch.float32, 0)
    with pytest.raises(ValueError, match="H % 8"):
        leff_fused(x, **p)
    x, p = _leff_inputs(cuda, 1, 8, 16, 16, 64, torch.float32, 0)
    with pytest.raises(NotImplementedError):
        leff_fused(x.clone().requires_grad_(), **p)
    with pytest.raises(ValueError):
        leff_fused(x, **{**p, "w1": p["w1"][:, :32]})


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
