"""The port's operators against their JAX counterparts, on the CPU.

Window ops, the plain twin of K1 (ProbSparse window attention) against the
jnp `bnc` path and the Pallas v4 kernel in interpret mode, and the plain
twin of K2 (LN + LeFF) against the Pallas kernel in interpret mode and the
jnp composition. Inputs come from numpy seeds; f32 tolerance 2e-4.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dehaze_tpu.ops import probsparse as PS
from dehaze_tpu.ops import window as W
from dehaze_tpu.ops.pallas.leff import leff_fused as jax_leff_fused
from dehaze_tpu.ops.pallas.window_attention import (
    fused_window_attention as jax_fused_window_attention)
from dehaze_tpu_torch.ops import probsparse as TPS
from dehaze_tpu_torch.ops import window as TW
from dehaze_tpu_torch.ops.kernels.leff import (SMEM_LIMIT, leff_fused,
                                               leff_reference, plan_tile)
from dehaze_tpu_torch.ops.kernels.window_attention import (
    fused_window_attention)

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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_window_partition_reverse_and_shift():
    x = np.random.default_rng(0).normal(size=(2, 16, 24, 3)).astype(
        np.float32)
    win = 8
    got = TW.window_partition(_t(x), win)
    want = np.asarray(W.window_partition(jnp.asarray(x), win))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        TW.window_reverse(got, win, 16, 24).numpy(), x)
    for fn, jfn in ((TW.cyclic_shift, W.cyclic_shift),
                    (TW.cyclic_unshift, W.cyclic_unshift)):
        np.testing.assert_array_equal(fn(_t(x), 4).numpy(),
                                      np.asarray(jfn(jnp.asarray(x), 4)))


@pytest.mark.parametrize("win", [2, 4, 8])
def test_rel_pos_index_bias_and_regions(win):
    np.testing.assert_array_equal(TW.relative_position_index(win, win),
                                  W.relative_position_index(win, win))
    table = np.random.default_rng(1).normal(
        size=((2 * win - 1) ** 2, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        TW.gather_rel_pos_bias(_t(table), win, win).numpy(),
        np.asarray(W.gather_rel_pos_bias(jnp.asarray(table), win, win)))
    region = TW.shift_region_ids(4 * win, 2 * win, win, win // 2)
    np.testing.assert_array_equal(
        region, W.shift_region_ids(4 * win, 2 * win, win, win // 2))
    np.testing.assert_array_equal(
        TW.region_mask(_t(region)).numpy(),
        np.asarray(W.region_mask(jnp.asarray(region))))


def test_topu_row_mask_first_index_ties():
    rng = np.random.default_rng(2)
    m = rng.integers(0, 4, size=(5, 64)).astype(np.float32)  # many ties
    for u in (1, 25, 64):
        np.testing.assert_array_equal(
            TPS.topu_row_mask_sorted(_t(m), u).numpy(),
            np.asarray(PS.topu_row_mask_sorted(jnp.asarray(m), u)))


def _attn_data(B, N, C, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, N, C)).astype(np.float32) * 0.3
               for _ in range(3))
    si = rng.integers(0, N, size=(N, PS.probsparse_u(N))).astype(np.int32)
    return q, k, v, si, rng


@pytest.mark.parametrize("heads", [1, 2, 4])
@pytest.mark.parametrize("shifted", [False, True])
def test_k1_twin_matches_jnp_and_pallas(heads, shifted):
    B, N, D = 8, 64, 32
    nW = 4 if shifted else 1
    q, k, v, si, rng = _attn_data(B, N, heads * D, seed=heads)
    bias = rng.normal(size=(heads, N, N)).astype(np.float32) * 0.1
    region = (rng.integers(0, 9, size=(nW, N)).astype(np.int32)
              if shifted else None)

    got = fused_window_attention(
        _t(q), _t(k), _t(v), num_heads=heads, sample_idx=_t(si),
        rel_pos_bias=_t(bias), sw_region=None if region is None
        else _t(region), num_windows=nW).numpy()
    jargs = dict(sample_idx=jnp.asarray(si), rel_pos_bias=jnp.asarray(bias),
                 sw_region=None if region is None else jnp.asarray(region))
    want_jnp = PS.probsparse_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), layout="bnc",
        num_heads=heads, **jargs)
    want_pallas = jax_fused_window_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=heads,
        num_windows=nW, interpret=True, wtile=8, **jargs)
    np.testing.assert_allclose(got, np.asarray(want_jnp), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, np.asarray(want_pallas), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("N", [4, 16])
def test_k1_twin_collapsed_windows(N):
    """Deep stages of a model configured at 32² run N = 16 and N = 4."""
    q, k, v, si, _ = _attn_data(6, N, 64, seed=10 + N)
    got = TPS.probsparse_attention_bnc(_t(q), _t(k), _t(v), num_heads=2,
                                       sample_idx=_t(si)).numpy()
    want = PS.probsparse_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), sample_idx=jnp.asarray(si),
                                   layout="bnc", num_heads=2)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def test_k1_twin_bf16():
    """bf16 q/k/v: S and a1 round to bf16 at the same points as the jnp
    path. Tolerance 2e-2 — a few bf16 ulps of the O(1) context; the rows
    selected may differ only where sum order moves a bf16 rounding of S."""
    q, k, v, si, rng = _attn_data(8, 64, 64, seed=20)
    bias = rng.normal(size=(2, 64, 64)).astype(np.float32) * 0.1
    got = TPS.probsparse_attention_bnc(
        _t(q).bfloat16(), _t(k).bfloat16(), _t(v).bfloat16(), num_heads=2,
        sample_idx=_t(si), rel_pos_bias=_t(bias))
    assert got.dtype == torch.bfloat16
    want = PS.probsparse_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), sample_idx=jnp.asarray(si),
        rel_pos_bias=jnp.asarray(bias), layout="bnc", num_heads=2)
    diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    row_bad = (diff > 2e-2).any(-1)
    assert row_bad.mean() <= 0.02, row_bad.mean()


def test_k1_cpu_rejects_pad_flag():
    """A pad_flag that is not [num_windows, N] is refused on the CPU as on
    the card (here 2 windows' flags against num_windows=1), and so is a
    version other than 3 or 4."""
    q, k, v, si, _ = _attn_data(2, 64, 32, seed=3)
    with pytest.raises(ValueError, match="pad_flag"):
        fused_window_attention(_t(q), _t(k), _t(v), num_heads=1,
                               sample_idx=_t(si),
                               pad_flag=torch.zeros(2, 64))
    with pytest.raises(ValueError, match="version"):
        fused_window_attention(_t(q), _t(k), _t(v), num_heads=1,
                               sample_idx=_t(si), version=2)


def _leff_params(C, Ch, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda m, s, shape: rng.normal(m, s, size=shape).astype(np.float32)
    return {"ln_scale": n(1, 0.1, (C,)), "ln_bias": n(0, 0.1, (C,)),
            "w1": n(0, 0.1, (C, Ch)), "b1": n(0, 0.1, (Ch,)),
            "dw_kernel": n(0, 0.3, (3, 3, 1, Ch)), "dw_bias": n(0, 0.1, (Ch,)),
            "w2": n(0, 0.1, (Ch, C)), "b2": n(0, 0.1, (C,))}


def _jnp_leff(x, p, fast_gelu):
    xn = nn.LayerNorm(epsilon=1e-5).apply(
        {"params": {"scale": p["ln_scale"], "bias": p["ln_bias"]}}, x)
    h = jax.nn.gelu(xn @ p["w1"] + p["b1"], approximate=fast_gelu)
    h = jax.lax.conv_general_dilated(
        h, p["dw_kernel"], (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=h.shape[-1]) + p["dw_bias"]
    h = jax.nn.gelu(h, approximate=fast_gelu)
    return h @ p["w2"] + p["b2"]


@pytest.mark.parametrize("fast_gelu", [False, True])
def test_k2_twin_matches_pallas_and_jnp(fast_gelu):
    B, H, Wd, C, Ch = 2, 16, 24, 8, 32
    x = np.random.default_rng(4).normal(size=(B, H, Wd, C)).astype(
        np.float32)
    p = _leff_params(C, Ch)
    got = leff_fused(_t(x), fast_gelu=fast_gelu,
                     **{n: _t(a) for n, a in p.items()}).numpy()
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    want_pallas = jax_leff_fused(jnp.asarray(x), interpret=True,
                                 fast_gelu=fast_gelu, **jp)
    want_jnp = _jnp_leff(jnp.asarray(x), jp, fast_gelu)
    np.testing.assert_allclose(got, np.asarray(want_pallas), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got, np.asarray(want_jnp), rtol=TOL, atol=TOL)


def test_k2_twin_bf16():
    """bf16: LN output, each Dense, GELU and the dwconv round to bf16 in
    both. Tolerance 5e-2 absolute on outputs of magnitude ~1: bf16 keeps
    8 bits (ulp 2^-7 at 1), and the roundings happen at other points inside
    the jnp chain (per elementwise op vs. once per stage)."""
    x = np.random.default_rng(5).normal(size=(1, 8, 16, 16)).astype(
        np.float32)
    p = _leff_params(16, 64, seed=1)
    got = leff_fused(_t(x).bfloat16(), **{n: _t(a) for n, a in p.items()})
    assert got.dtype == torch.bfloat16
    want = jax_leff_fused(jnp.asarray(x, jnp.bfloat16), interpret=True,
                          **{n: jnp.asarray(a) for n, a in p.items()})
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=5e-2,
                               rtol=0)


def test_k2_reference_is_the_cpu_path():
    x = torch.randn(1, 8, 8, 8, generator=torch.Generator().manual_seed(0))
    p = {n: _t(a) for n, a in _leff_params(8, 32, seed=2).items()}
    assert torch.equal(leff_fused(x, **p), leff_reference(x, **p))



def _k2_plan_before(C, itemsize):
    """K2's tile before its bf16 path moved onto the tensor cores: 8
    columns, the most rows of 8, 4, 2, 1 whose float accumulator, hidden
    chunks and LN tile fit 200 KiB. Returns its halo ratio."""
    for th in (8, 4, 2, 1):
        hp, tp = (th + 2) * 10, th * 8
        if (tp * C + 32 * (hp + tp)) * 4 + hp * C * itemsize + hp \
                <= 200 * 1024:
            return hp / tp
    raise AssertionError(f"no earlier plan for C={C}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("C", [8, 16, 32, 64, 96, 128, 256, 512])
def test_k2_tile_plan(C, dtype):
    """The planned K2 tile fits a Hopper CTA's shared memory (the bytes
    the kernel allocates, checked against the compiled kernel on the card),
    has at most 8 rows (any H is covered, the last row tile ragged), and
    computes dense1 on the halo no more often than the earlier plan did."""
    plan = plan_tile(C, dtype)
    assert 0 < plan.smem <= SMEM_LIMIT == 232448
    assert plan.th in (1, 2, 4, 8)
    assert plan.halo_ratio <= _k2_plan_before(C, dtype.itemsize) + 1e-12
    if dtype == torch.bfloat16:  # the tensor-core classes: 8 rows
        assert plan.th == 8 and plan.tw in (8, 16, 32)
