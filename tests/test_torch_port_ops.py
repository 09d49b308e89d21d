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


# Today's plans (mode 0, any hidden width): (C -> (th, tw, smem)), bf16;
# and float32's 3xTF32 classes (every mode and hidden width)
_K2_PLANS_BF16 = {8: (8, 32, 73568), 16: (8, 32, 73568),
                  32: (8, 32, 86112), 64: (8, 32, 162272),
                  96: (8, 32, 197600), 128: (8, 32, 224736),
                  256: (8, 16, 222400), 512: (8, 8, 207024)}
_K2_PLANS_F32 = {8: (8, 32, 134624), 16: (8, 32, 134624),
                 32: (8, 32, 159712), 64: (8, 16, 186304),
                 96: (8, 16, 163008), 128: (8, 16, 192704),
                 256: (8, 8, 222000), 512: (8, 4, 225088)}
_K2_DTYPES = ((torch.float32, "f32"), (torch.bfloat16, "bf16"))
# (C, dtype, act_store, Ch / C): mode 0 at 4C under the ids it always had,
# then every mode at C in {8, 32, 64, 128, 256, 512} and Ch in {2C, 4C}
_K2_PLAN_CASES = (
    [pytest.param(C, dt, None, 4, id=f"{C}-{name}")
     for C in _K2_PLANS_BF16 for dt, name in _K2_DTYPES]
    + [pytest.param(C, dt, mode, r, id=f"{C}-{name}-{mode}-Ch{r}C")
       for C in (8, 32, 64, 128, 256, 512) for dt, name in _K2_DTYPES
       for mode in (None, "fp8", "int8") for r in (2, 4)])


@pytest.mark.parametrize("C,dtype,act_store,ratio", _K2_PLAN_CASES)
def test_k2_tile_plan(C, dtype, act_store, ratio):
    """The planned K2 tile fits a Hopper CTA's shared memory (the bytes
    the kernel allocates, checked against the compiled kernel on the card),
    has at most 8 rows (any H is covered, the last row tile ragged), and
    computes dense1 on the halo no more often than the earlier plan did.
    Mode 0 and fp8 keep the plan of every C as it was, whatever Ch; int8
    runs dense1 once over the hidden width where the whole hidden tile
    fits (C <= 64 at Ch = 4C), twice where the output pixels' hidden fits
    (C = 128, 256), and three times where neither does (C = 512). float32
    has one 3xTF32 class per C for every mode and Ch (int8 in three
    sweeps)."""
    Ch = ratio * C
    plan = plan_tile(C, dtype, act_store, Ch)
    assert 0 < plan.smem <= SMEM_LIMIT == 232448
    assert plan.th in (1, 2, 4, 8)
    assert plan.halo_ratio <= _k2_plan_before(C, dtype.itemsize) + 1e-12
    if dtype == torch.bfloat16:  # the tensor-core classes: 8 rows
        assert plan.th == 8 and plan.tw in (8, 16, 32)
        if act_store != "int8":
            assert plan[:3] == _K2_PLANS_BF16[C] and plan.sweeps == 1
        elif ratio == 4:
            assert plan.sweeps == {8: 1, 32: 1, 64: 1, 128: 2, 256: 2,
                                   512: 3}[C]
    else:  # the 3xTF32 classes, one plan for every mode: int8 in three
        # sweeps
        assert plan[:3] == _K2_PLANS_F32[C]
        assert plan.sweeps == (3 if act_store == "int8" else 1)
    assert plan == plan_tile(C, dtype, act_store, Ch)
    if act_store is None and ratio == 4:
        assert plan == plan_tile(C, dtype)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """t rounded to TF32 as `cvt.rna.tf32.f32` rounds it: to nearest on
    the 10-bit mantissa, ties away from zero (finite values)."""
    return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _linear_tf32(split: bool):
    """F.linear with K2's float32 products on the tensor cores: 3xTF32
    (x = hi + lo on each side, hi = tf32(x), lo = tf32(x - hi); the three
    products lo·hi + hi·lo + hi·hi, each exact in float32, summed in
    float32) or, with split False, one TF32 product."""
    def linear(x, wt, b):
        w = wt.t()
        xh, wh = _tf32(x), _tf32(w)
        if not split:
            return xh @ wh + b
        xl, wl = _tf32(x - xh), _tf32(w - wh)
        return xl @ wh + xh @ wl + xh @ wh + b
    return linear


@pytest.mark.parametrize("C", [32, 512])
def test_k2_3xtf32_split_keeps_float32_accuracy(C, monkeypatch):
    """The float32 kernel's 3xTF32 products, modelled in the twin's dense1
    and dense2, stay within K2_TOL["float32"] / 10 (1e-5·(1 + |ref|)) of
    the float32 twin; one TF32 product per term does not."""
    import types

    import torch.nn.functional as F

    from dehaze_tpu_torch.ops.kernels import leff as K2

    rng = np.random.default_rng(C)
    Ch = 4 * C
    x = _t(rng.normal(size=(1, 6, 7, C)).astype(np.float32))
    p = {n: _t(a) for n, a in _leff_params(C, Ch, seed=C + 1).items()}
    want = leff_reference(x, **p)
    errs = []
    for split in (True, False):
        monkeypatch.setattr(K2, "F", types.SimpleNamespace(
            layer_norm=F.layer_norm, gelu=F.gelu, conv2d=F.conv2d,
            linear=_linear_tf32(split)))
        got = leff_reference(x, **p)
        errs.append(float(((got - want).abs() / (1 + want.abs())).max()))
    assert errs[0] <= 1e-4 / 10 < errs[1], errs


@pytest.mark.parametrize("C,Ch,sweeps", [(32, 128, 1), (64, 256, 1),
                                         (64, 512, 2), (128, 512, 2),
                                         (256, 1024, 2), (64, 2048, 3),
                                         (256, 2048, 3), (512, 2048, 3)])
def test_k2_int8_plan_keeps_what_fits(C, Ch, sweeps):
    """int8's design is the fewest sweeps whose resident hidden fits: a
    plan of fewer sweeps would exceed SMEM_LIMIT at this (C, Ch)."""
    from dehaze_tpu_torch.ops.kernels import leff as K2

    plan = plan_tile(C, torch.bfloat16, "int8", Ch)
    assert plan.sweeps == sweeps and plan.smem <= SMEM_LIMIT
    fewer = [K2._mma_smem_bytes(C, Ch, tw, cmax, kc, r)
             for cmax, tw, kc, r in K2._I8_CLASSES if C <= cmax and r < sweeps]
    assert all(b > SMEM_LIMIT for b in fewer)


def test_k2_fp8_trip_is_compress_on_the_cpu():
    """On a CPU tensor the wrapper of K2's fp8 device function is
    `compress(·, "fp8")` itself, edges included (NaN beyond ±464)."""
    from dehaze_tpu_torch.ops import actstore
    from dehaze_tpu_torch.ops.kernels.leff import fp8_trip

    x = torch.tensor([0.0, -0.0, 1e-3, 2.0 ** -10, 0.3, 17.0, 447.0, 448.0,
                      464.0, -464.0, 464.5, 480.0, float("inf"),
                      float("nan")])
    for dtype in (torch.float32, torch.bfloat16):
        got = fp8_trip(x.to(dtype))
        want = actstore.compress(x.to(dtype), "fp8")
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
        assert bool(torch.isnan(got[-3:]).all())  # 480, inf, NaN
        assert float(got[8]) == 448.0  # 464 ties to 448
        # 464.5 is NaN in float32 but 464 (so 448) once rounded to bf16
        assert bool(torch.isnan(got[10])) == (dtype == torch.float32)


def test_k2_i8_trip_is_compress_on_the_cpu():
    """On CPU tensors the wrapper of K2's int8 device function is
    `i8_trip_reference`, `compress(·, "int8")`'s round trip at a given
    scale: for rows [a, v] with |v| <= a (and rows of an inf or NaN amax),
    v's trip at the scale compress takes from a equals compress's output
    (NaN for NaN); the bits differ only where v / scale rounds to -0,
    which compress's int8 cast turns into +0."""
    from dehaze_tpu_torch.ops import actstore
    from dehaze_tpu_torch.ops.kernels.leff import i8_trip

    rng = np.random.default_rng(21)
    a = np.abs(rng.normal(size=512) * 10.0 ** rng.integers(-12, 6, 512))
    a[:4] = [0.0, np.inf, np.nan, 1e-9]
    v = rng.uniform(-1, 1, (512, 64)) * np.nan_to_num(a, posinf=1e4)[:, None]
    v[:, :3] = [0.0, -0.0, 1e-30]
    a, v = (torch.from_numpy(t).float().bfloat16() for t in (a, v))
    a = a[:, None].expand_as(v)
    scale = torch.clamp_min(a, 1e-8) / torch.full_like(a, 127.0)
    want = actstore.compress(torch.stack([a, v], -1), "int8")[..., 1]
    got = i8_trip(v, scale)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    bits = got.view(torch.int16) != want.view(torch.int16)
    assert bool((got[bits & ~got.isnan()] == 0).all())
    assert bool(torch.signbit(got[bits & ~got.isnan()]).all())
    assert int((bits & ~got.isnan()).sum()) > 0  # such quotients occur
