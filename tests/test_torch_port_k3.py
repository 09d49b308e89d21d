"""The K3 twins (the older TPU kernels of the ProbSparse chain) against the
JAX package's Pallas kernels in interpret mode, on the CPU.

- v1 and v2 (`probsparse_window_attention_pallas` and `..._v2`, q/k/v
  [B, H, N, D], forward only) through the port's entries: 1e-5 in f32 and
  2e-2 in bf16, the JAX tests' own tolerances
  (`tests/test_pallas_attention.py:46,76`), and no row selected otherwise
  than JAX selects it.
- `fused_window_attention(version=3)` against JAX `version=3`: the value
  within 2e-5 and the gradients of q, k, v and the bias within 2e-4
  (`tests/test_pallas_attention.py:166,177`).
- In bf16, each of v1, v2, v3 (value and gradients) and K1 (version 4)
  nearer its own JAX kernel than the JAX kernels that round elsewhere.
Inputs come from numpy seeds, with the same sampled columns on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dehaze_tpu.ops import probsparse as PS
from dehaze_tpu.ops.pallas.window_attention import (
    fused_window_attention as jax_fused_window_attention,
    probsparse_window_attention_pallas, probsparse_window_attention_pallas_v2)
from dehaze_tpu_torch.ops import probsparse as TPS
from dehaze_tpu_torch.ops.kernels.window_attention import (
    fused_window_attention, probsparse_window_attention_v1,
    probsparse_window_attention_v2)

VARIANTS = {
    "v1": (probsparse_window_attention_v1, probsparse_window_attention_pallas,
           "v1"),
    "v2": (probsparse_window_attention_v2,
           probsparse_window_attention_pallas_v2, "v23"),
}


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


def _bhnd_case(B, H, shifted, bias, seed):
    N, D, nW = 64, 32, 2
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, N, D)).astype(np.float32)
               for _ in range(3))
    si = rng.integers(0, N, size=(N, PS.probsparse_u(N))).astype(np.int32)
    kw = {"sample_idx": si,
          "rel_pos_bias": rng.normal(size=(H, N, N)).astype(np.float32)
          if bias else None,
          "sw_region": rng.integers(0, 9, size=(nW, N)).astype(np.int32)
          if shifted else None,
          "num_windows": nW if shifted else 1}
    return q, k, v, kw


def _flipped_rows(want, q, k, v, kw, numerics, dtype):
    """Rows whose JAX output is nearer the other branch (attention or
    mean(V)) than the one the twin selected."""
    qh, kh, vh = (_t(a).to(dtype) for a in (q, k, v))
    mask = TPS.attention_mask(None if kw["sw_region"] is None
                              else _t(kw["sw_region"]), None)
    _, _, vf, rows, _, a2 = TPS._chain_bhnd(
        qh, kh, vh, _t(kw["sample_idx"]),
        None if kw["rel_pos_bias"] is None else _t(kw["rel_pos_bias"]),
        mask, 5, 1.0 / np.sqrt(q.shape[-1]), numerics)
    if numerics != "v1":
        a2 = a2.to(dtype).float()
    w = torch.from_numpy(np.array(want, np.float32))
    d_ctx = (w - torch.matmul(a2, vf)).abs().amax(-1)
    d_mean = (w - vf.mean(-2, keepdim=True)).abs().amax(-1)
    return int(((d_ctx < d_mean) != rows).sum())


def _run(variant, q, k, v, kw, dtype):
    entry, jax_kernel, numerics = VARIANTS[variant]
    tkw = {n: (None if a is None else _t(a)) if n != "num_windows" else a
           for n, a in kw.items()}
    got = entry(*(_t(a).to(dtype) for a in (q, k, v)), **tkw)
    jkw = {n: (None if a is None else jnp.asarray(a))
           if n != "num_windows" else a for n, a in kw.items()}
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_kernel(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                      interpret=True, **jkw)
    assert got.dtype == dtype and got.shape == q.shape
    return got, want, numerics


@pytest.mark.parametrize("variant", ["v1", "v2"])
@pytest.mark.parametrize("shifted,bias", [(False, False), (False, True),
                                          (True, True)])
def test_v1_v2_match_pallas_f32(variant, shifted, bias):
    q, k, v, kw = _bhnd_case(6 if shifted else 4, 2, shifted, bias,
                             seed=3 * shifted + bias)
    got, want, numerics = _run(variant, q, k, v, kw, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert _flipped_rows(want, q, k, v, kw, numerics, torch.float32) == 0


@pytest.mark.parametrize("variant", ["v1", "v2"])
@pytest.mark.parametrize("shifted", [False, True])
def test_v1_v2_match_pallas_bf16(variant, shifted):
    q, k, v, kw = _bhnd_case(4, 1, shifted, True, seed=4)
    got, want, numerics = _run(variant, q, k, v, kw, torch.bfloat16)
    assert str(want.dtype) == "bfloat16"
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)
    assert _flipped_rows(want, q, k, v, kw, numerics, torch.bfloat16) == 0


def test_v2_rounds_where_its_kernel_does():
    """In bf16 "v23" differs from "v1" (q·scale, a2 rounded) and from "v4"
    (S and a1 rounded): the three twins give three results."""
    q, k, v, kw = _bhnd_case(4, 1, False, True, seed=4)
    args = [_t(a).bfloat16() for a in (q, k, v)]
    tkw = dict(sample_idx=_t(kw["sample_idx"]),
               rel_pos_bias=_t(kw["rel_pos_bias"]))
    v1 = TPS.probsparse_attention_v1(*args, **tkw)
    v2 = TPS.probsparse_attention_v2(*args, **tkw)
    bnc = [a.transpose(1, 2).reshape(4, 64, 32) for a in args]
    v4 = TPS.probsparse_attention_bnc(*bnc, num_heads=1, **tkw).reshape(
        4, 64, 1, 32).transpose(1, 2)
    assert not torch.equal(v1, v2) and not torch.equal(v2, v4)


@pytest.mark.parametrize("use_mask", [False, True])
def test_v3_value_and_grads_match_pallas(use_mask):
    """fused_window_attention(version=3): value and gradients (q, k, v,
    rel-pos bias) against the JAX custom VJP of version 3 (interpret
    mode)."""
    B, N, H, D = 6, 64, 2, 32
    nW = 2 if use_mask else 1
    rng = np.random.default_rng(7 + use_mask)
    q, k, v = (rng.normal(size=(B, N, H * D)).astype(np.float32) * .3
               for _ in range(3))
    si = rng.integers(0, N, size=(N, PS.probsparse_u(N))).astype(np.int32)
    bias = rng.normal(size=(H, N, N)).astype(np.float32) * 0.1
    region = (rng.integers(0, 9, size=(nW, N)).astype(np.int32)
              if use_mask else None)
    cot = rng.normal(size=(B, N, H * D)).astype(np.float32)

    def jfn(q, k, v, b):
        return jax_fused_window_attention(
            q, k, v, num_heads=H, sample_idx=jnp.asarray(si), rel_pos_bias=b,
            sw_region=None if region is None else jnp.asarray(region),
            num_windows=nW, interpret=True, wtile=8, version=3)

    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v, bias)))
    g_want = vjp(jnp.asarray(cot))
    tq, tk, tv, tb = (_t(a).requires_grad_() for a in (q, k, v, bias))
    got = fused_window_attention(
        tq, tk, tv, num_heads=H, sample_idx=_t(si), rel_pos_bias=tb,
        sw_region=None if region is None else _t(region), num_windows=nW,
        version=3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    got.backward(_t(cot))
    for name, a, b in zip(("dq", "dk", "dv", "dbias"),
                          (tq.grad, tk.grad, tv.grad, tb.grad), g_want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def test_v3_bf16_matches_pallas():
    """bf16 version 3 against JAX version 3: 2e-2 on every element, and
    the backward's dk from the rounded q·scale within 2e-2 of the largest
    |dk|."""
    B, N, H, D = 4, 64, 1, 32
    rng = np.random.default_rng(12)
    q, k, v = (rng.normal(size=(B, N, H * D)).astype(np.float32) * .5
               for _ in range(3))
    si = rng.integers(0, N, size=(N, PS.probsparse_u(N))).astype(np.int32)
    bias = rng.normal(size=(H, N, N)).astype(np.float32) * 0.1
    cot = rng.normal(size=(B, N, H * D)).astype(np.float32)

    def jfn(q, k, v):
        return jax_fused_window_attention(
            q, k, v, num_heads=H, sample_idx=jnp.asarray(si),
            rel_pos_bias=jnp.asarray(bias), interpret=True, wtile=4,
            version=3)

    want, vjp = jax.vjp(jfn, *(jnp.asarray(a, jnp.bfloat16)
                               for a in (q, k, v)))
    g_want = vjp(jnp.asarray(cot, jnp.bfloat16))
    tq, tk, tv = (_t(a).bfloat16().requires_grad_() for a in (q, k, v))
    got = fused_window_attention(tq, tk, tv, num_heads=H, sample_idx=_t(si),
                                 rel_pos_bias=_t(bias), version=3)
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=2e-2)
    got.backward(_t(cot).bfloat16())
    for name, a, b in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                          g_want):
        b = np.asarray(b, np.float32)
        err = np.abs(a.float().numpy() - b).max()
        assert err <= 2e-2 * np.abs(b).max(), name


# ----------------------------------------- rounding points, told apart
# The variants differ by about one bf16 ulp on a few percent of the
# elements, inside the tolerances above, which would pass a port that
# rounds as another variant does. So in bf16, with q and k at std 2 (where
# the rounding of S moves the output), each port entry must lie nearer its
# own JAX kernel than each JAX kernel that rounds elsewhere: mean |port −
# own| <= SEP · mean |port − other|, per output tensor over its largest
# |own| and summed over the tensors.
SEP = 0.5
# the JAX kernels that round elsewhere ("v2" and "v3" share their points)
OTHERS = {"v1": ("v2", "v4"), "v2": ("v1", "v4"), "v3": ("v1", "v4"),
          "v4": ("v1", "v3")}


@pytest.fixture(scope="module")
def rounding_case():
    """bf16 q/k/v [B_, N, C] (C = 2 heads × 32), bias, sampled columns,
    output gradient, and each JAX kernel's output on them, token-major:
    v1 and v2 (head-major Pallas kernels), v3 and v4
    (`fused_window_attention`, with their VJPs' gradients of q, k, v)."""
    B, N, H, D = 4, 64, 2, 32
    rng = np.random.default_rng(21)
    q, k = (rng.normal(size=(B, N, H * D)).astype(np.float32) * 2
            for _ in range(2))
    v, cot = (rng.normal(size=(B, N, H * D)).astype(np.float32)
              for _ in range(2))
    si = rng.integers(0, N, size=(N, PS.probsparse_u(N))).astype(np.int32)
    bias = rng.normal(size=(H, N, N)).astype(np.float32) * 0.1
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))

    def bhnd(a):
        return a.reshape(B, N, H, D).transpose(0, 2, 1, 3)

    want, grads = {}, {}
    for name, kernel in (("v1", probsparse_window_attention_pallas),
                         ("v2", probsparse_window_attention_pallas_v2)):
        out = kernel(bhnd(jq), bhnd(jk), bhnd(jv), sample_idx=jnp.asarray(si),
                     rel_pos_bias=jnp.asarray(bias), interpret=True)
        want[name] = np.asarray(out, np.float32).transpose(0, 2, 1, 3)\
            .reshape(B, N, H * D)
    for version in (3, 4):
        out, vjp = jax.vjp(lambda q, k, v: jax_fused_window_attention(
            q, k, v, num_heads=H, sample_idx=jnp.asarray(si),
            rel_pos_bias=jnp.asarray(bias), interpret=True, wtile=B,
            version=version), jq, jk, jv)
        want[f"v{version}"] = np.asarray(out, np.float32)
        grads[f"v{version}"] = [np.asarray(g, np.float32) for g in
                                vjp(jnp.asarray(cot, jnp.bfloat16))]
    return dict(q=q, k=k, v=v, cot=cot, si=si, bias=bias, heads=H,
                want=want, grads=grads)


def _gap(got, ref, own):
    return sum(float(np.abs(a - b).mean() / np.abs(o).max())
               for a, b, o in zip(got, ref, own))


@pytest.mark.parametrize("variant", ["v1", "v2", "v3", "v4"])
def test_bf16_rounds_where_its_jax_kernel_does(rounding_case, variant):
    c = rounding_case
    H = c["heads"]
    tq, tk, tv = (_t(c[n]).bfloat16() for n in "qkv")
    kw = dict(sample_idx=_t(c["si"]), rel_pos_bias=_t(c["bias"]))
    if variant in ("v1", "v2"):
        B, N, C = tq.shape
        entry = VARIANTS[variant][0]
        got = entry(*(t.reshape(B, N, H, C // H).transpose(1, 2)
                      .contiguous() for t in (tq, tk, tv)), **kw)
        got = got.transpose(1, 2).reshape(B, N, C)
    else:
        got = fused_window_attention(tq, tk, tv, num_heads=H,
                                     version=int(variant[1]), **kw)
    got = [got.float().numpy()]
    own = [c["want"][variant]]
    for other in OTHERS[variant]:
        assert _gap(got, own, own) <= SEP * _gap(got, [c["want"][other]],
                                                 own), other


@pytest.mark.parametrize("version", [3, 4])
def test_bf16_backward_rounds_where_its_jax_kernel_does(rounding_case,
                                                        version):
    """The same for the gradients of q, k and v: version 3 (dk from the
    rounded q·scale, S and a1 not rounded) against version 4's VJP."""
    c = rounding_case
    tq, tk, tv = (_t(c[n]).bfloat16().requires_grad_() for n in "qkv")
    fused_window_attention(tq, tk, tv, num_heads=c["heads"],
                           sample_idx=_t(c["si"]),
                           rel_pos_bias=_t(c["bias"]), version=version
                           ).backward(_t(c["cot"]).bfloat16())
    got = [t.grad.float().numpy() for t in (tq, tk, tv)]
    own = c["grads"][f"v{version}"]
    other = c["grads"][f"v{7 - version}"]
    assert _gap(got, own, own) <= SEP * _gap(got, other, own)
