"""The port at the window sizes, head widths and stage heights that the JAX
model runs beyond its default configuration, against the JAX package, on
the CPU.

- 16×16 windows (N = 256, `--win_size 16`) and a head dim of 96 (one head
  at `--embed_dim 96`): the plain twin of K1 against the jnp path, and one
  port LeWin block against the JAX block (same params through the JAX
  package's converter, the same pinned sampling);
- a Uformer configured at 32² (embed 8) on a 96×64 input, whose enc3,
  bottleneck and dec0 stages have 12, 6 and 12 rows (not a multiple of
  K2's 8-row tile; the JAX model takes its jnp LeFF there);
- which kernel a CUDA call of K1's forward takes (`fwd_kernel_for`).

On the card the same shapes go through the kernels
(`tests/test_torch_port_cuda.py`). Tolerance f32 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dehaze_tpu.config import ModelConfig as JaxModelConfig
from dehaze_tpu.models.uformer import LeWinBlock as JaxLeWinBlock
from dehaze_tpu.models.uformer import Uformer as JaxUformer
from dehaze_tpu.ops import probsparse as PS
from dehaze_tpu.ops import window as W
from dehaze_tpu.utils.convert_torch import _block, convert_uformer_state_dict
from dehaze_tpu_torch.config import ModelConfig
from dehaze_tpu_torch.models.uformer import LeWinBlock, Uformer
from dehaze_tpu_torch.ops import probsparse as TPS
from dehaze_tpu_torch.ops.kernels.window_attention import fwd_kernel_for

TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU tensors: with several test
    workers on the host, torch's thread pools stall each other in
    hand-offs (a small op then takes tens of times as long)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(43)
    return {n: rng.integers(0, n, size=(n, PS.probsparse_u(n))).astype(
        np.int32) for n in (4, 16, 64, 256)}


@pytest.fixture
def pinned(monkeypatch, tables):
    monkeypatch.setattr(PS, "sample_indices",
                        lambda key, l_q, l_k, u_part: jnp.asarray(
                            tables[l_q][:, :u_part]))
    monkeypatch.setattr(TPS, "sample_indices",
                        lambda n_q, n_k, u_part, generator: torch.from_numpy(
                            tables[n_q][:, :u_part].copy()))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("heads,win,D,shifted", [
    (1, 16, 32, True), (2, 16, 32, False), (1, 8, 96, True),
    (2, 8, 96, False)])
def test_k1_twin_matches_jnp_at_large_shapes(heads, win, D, shifted):
    N = win * win
    rng = np.random.default_rng(N + D)
    region = (W.shift_region_ids(2 * win, 2 * win, win, win // 2)
              if shifted else None)
    B = 2 * (4 if shifted else 1)
    q, k, v = (rng.normal(size=(B, N, heads * D)).astype(np.float32) * 0.3
               for _ in range(3))
    si = rng.integers(0, N, size=(N, PS.probsparse_u(N))).astype(np.int32)
    bias = rng.normal(size=(heads, N, N)).astype(np.float32) * 0.1
    got = TPS.probsparse_attention_bnc(
        _t(q), _t(k), _t(v), num_heads=heads, sample_idx=_t(si),
        rel_pos_bias=_t(bias),
        sw_region=None if region is None else _t(region)).numpy()
    want = PS.probsparse_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), layout="bnc",
        num_heads=heads, sample_idx=jnp.asarray(si),
        rel_pos_bias=jnp.asarray(bias),
        sw_region=None if region is None else jnp.asarray(region))
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dim,heads,win,shift,size", [
    (32, 1, 16, 8, 32),   # N = 256, shifted
    (96, 1, 8, 4, 16),    # head dim 96, shifted
])
def test_lewin_block_matches_jax(pinned, dim, heads, win, shift, size):
    rng = np.random.default_rng(dim + win)
    block = LeWinBlock(dim, input_resolution=64, num_heads=heads,
                       win_size=win, shift_size=shift).eval()
    with torch.no_grad():
        for name, p in block.named_parameters():
            mean = 1.0 if name.endswith("norm1.weight") or name.endswith(
                "norm2.weight") else 0.0
            p.copy_(_t(rng.normal(mean, 0.05, size=p.shape).astype(
                np.float32)))
    sd = {f"b.{k}": v.numpy() for k, v in block.state_dict().items()}
    params = _block(sd, "b", "probsparse")
    x = rng.normal(size=(1, size, size, dim)).astype(np.float32)
    jblock = JaxLeWinBlock(dim=dim, input_resolution=64, num_heads=heads,
                           win_size=win, shift_size=shift)
    want = jblock.apply({"params": params}, jnp.asarray(x),
                        rngs={"sample": jax.random.PRNGKey(0)})
    with torch.inference_mode():
        got = block(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def test_uformer_ragged_stage_heights_matches_jax(pinned):
    """Configured at 32² (windows 8, 8, 8, 4, 2 by stage), on a 96×64
    input: enc3, the bottleneck and dec0 have 12, 6 and 12 rows."""
    cfg = dict(img_size=32, embed_dim=8)
    torch.manual_seed(0)
    model = Uformer(ModelConfig(dtype=torch.float32, **cfg)).eval()
    params = jax.tree.map(np.asarray,
                          convert_uformer_state_dict(model.state_dict()))
    jmodel = JaxUformer(JaxModelConfig(dtype=jnp.float32, **cfg))
    x = np.random.default_rng(11).uniform(size=(1, 96, 64, 3)).astype(
        np.float32)
    want = jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, train=False,
        rngs={"sample": jax.random.PRNGKey(0)}))(params, jnp.asarray(x))
    with torch.inference_mode():
        got = model(_t(x)).numpy()
    assert got.shape == (1, 96, 64, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype,numerics,N,D,kernel", [
    (torch.bfloat16, "v4", 64, 32, "tc"),      # every default stage
    (torch.bfloat16, "v4", 16, 32, "tc"),
    (torch.bfloat16, "v4", 4, 32, "tc"),
    (torch.bfloat16, "v4", 36, 64, "tc"),
    (torch.bfloat16, "v4", 49, 16, "tc"),
    (torch.bfloat16, "v4", 64, 48, "tc"),
    # f32: K1's float32 kernel (the case keeps the id it had when f32 took
    # the CUDA-core kernel)
    pytest.param(torch.float32, "v4", 64, 32, "f32",
                 id="dtype6-v4-64-32-cuda_core"),
    (torch.bfloat16, "v23", 64, 32, "tc"),     # K3-v3, token-major
    (torch.bfloat16, "v1", 64, 32, "cuda_core"),
    (torch.bfloat16, "v4", 256, 32, "cuda_core"),  # F2: 16x16 windows
    (torch.bfloat16, "v4", 64, 96, "cuda_core"),   # F2: wide heads
    (torch.bfloat16, "v4", 64, 128, "cuda_core"),
    (torch.bfloat16, "v4", 64, 24, "cuda_core"),
    (torch.bfloat16, "v4", 64, 8, "cuda_core"),
])
def test_fwd_kernel_for_routes_by_shape_and_dtype(dtype, numerics, N, D,
                                                  kernel):
    assert fwd_kernel_for(dtype, numerics, N, D) == kernel


@pytest.mark.parametrize("dtype,numerics,N,D,kernel", [
    (torch.bfloat16, "v23", 64, 32, "tc"),         # K3-v3 at train enc0
    (torch.bfloat16, "v23", 49, 16, "tc"),
    (torch.bfloat16, "v23", 4, 64, "tc"),
    (torch.float32, "v23", 64, 32, "cuda_core"),   # f32
    (torch.bfloat16, "v23", 256, 32, "cuda_core"),  # N > 64
    (torch.bfloat16, "v23", 64, 96, "cuda_core"),  # wide heads
])
def test_fwd_kernel_for_routes_k3_v3(dtype, numerics, N, D, kernel):
    """The token-major K3-v3 forward takes the tensor-core kernel where
    K1's does, and so do its head-major form, K3-v2 (same numerics), and
    K3-v1; K3-v1 token-major (no entry point has it) stays on the CUDA-core
    kernel."""
    assert fwd_kernel_for(dtype, numerics, N, D) == kernel
    assert fwd_kernel_for(dtype, numerics, N, D, head_major=False) == kernel
    for num in ("v23", "v1"):
        assert fwd_kernel_for(dtype, num, N, D, head_major=True) == kernel
    assert fwd_kernel_for(dtype, "v1", N, D) == "cuda_core"
