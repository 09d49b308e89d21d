"""The port's evaluation path against the JAX package, on the CPU: the K1
twin with padding flags (forward and backward), `expand2square`, the
Uformer with a padding mask and the evaluation image iterator (the CLIs:
`test_torch_port_eval_cli.py`).

Inputs come from numpy seeds; ProbSparse sampling is pinned on both sides
with one table per window size N. Tolerances: f32 2e-4 (the K1 twin's
backward and the model); bf16 as stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dehaze_tpu.config import ModelConfig as JaxModelConfig
from dehaze_tpu.data import pipeline as jpipe
from dehaze_tpu.infer import anyres as janyres
from dehaze_tpu.models.uformer import Uformer as JaxUformer
from dehaze_tpu.ops import probsparse as PS
from dehaze_tpu.utils.convert_torch import convert_uformer_state_dict
from dehaze_tpu_torch.config import ModelConfig
from dehaze_tpu_torch.data import pipeline as tpipe
from dehaze_tpu_torch.data.synth import write_dataset
from dehaze_tpu_torch.infer import anyres as tanyres
from dehaze_tpu_torch.models.uformer import Uformer
from dehaze_tpu_torch.ops import probsparse as TPS
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


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(42)
    return {n: rng.integers(0, n, size=(n, PS.probsparse_u(n))).astype(
        np.int32) for n in (4, 16, 64)}


@pytest.fixture
def pinned(monkeypatch, tables):
    monkeypatch.setattr(PS, "sample_indices",
                        lambda key, l_q, l_k, u_part: jnp.asarray(
                            tables[l_q][:, :u_part]))
    monkeypatch.setattr(TPS, "sample_indices",
                        lambda n_q, n_k, u_part, generator: torch.from_numpy(
                            tables[n_q][:, :u_part].copy()))


# ------------------------------------------------------- K1 with pad_flag

def _pad_case(heads, shifted, seed):
    B, N, D, nW = 8, 64, 32, 4
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, N, heads * D)).astype(np.float32) * 0.3
               for _ in range(3))
    si = rng.integers(0, N, size=(N, PS.probsparse_u(N))).astype(np.int32)
    bias = rng.normal(size=(heads, N, N)).astype(np.float32) * 0.1
    region = (rng.integers(0, 9, size=(nW, N)).astype(np.int32)
              if shifted else None)
    pad = (rng.uniform(size=(nW, N)) < 0.5).astype(np.float32)
    pad[0] = 1.0  # a window of padding only
    pad[1] = 0.0
    return q, k, v, si, bias, region, pad, nW


def _jax_bnc(q, k, v, si, bias, region, pad, heads):
    return PS._probsparse_bnc(
        q, k, v, num_heads=heads, sample_idx=jnp.asarray(si),
        rel_pos_bias=jnp.asarray(bias),
        sw_region=None if region is None else jnp.asarray(region),
        pad_flag=jnp.asarray(pad))


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("shifted", [False, True])
def test_k1_twin_pad_flag_matches_jnp(heads, shifted):
    """The twin with padding flags (on top of the region ids when shifted)
    against JAX `_probsparse_bnc`, f32, through the port's entry."""
    q, k, v, si, bias, region, pad, nW = _pad_case(heads, shifted,
                                                   seed=heads + 2 * shifted)
    got = fused_window_attention(
        _t(q), _t(k), _t(v), num_heads=heads, sample_idx=_t(si),
        rel_pos_bias=_t(bias), sw_region=None if region is None
        else _t(region), pad_flag=_t(pad), num_windows=nW).numpy()
    want = _jax_bnc(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), si,
                    bias, region, pad, heads)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shifted", [False, True])
def test_k1_twin_pad_flag_bf16(shifted):
    """bf16: tolerance 2e-2 on all but 2% of rows, as the unpadded bf16
    twin test holds it (a sum-order difference can move a bf16 rounding
    of S and flip a near-tied row)."""
    q, k, v, si, bias, region, pad, nW = _pad_case(2, shifted, seed=9)
    got = TPS.probsparse_attention_bnc(
        _t(q).bfloat16(), _t(k).bfloat16(), _t(v).bfloat16(), num_heads=2,
        sample_idx=_t(si), rel_pos_bias=_t(bias),
        sw_region=None if region is None else _t(region), pad_flag=_t(pad))
    assert got.dtype == torch.bfloat16
    want = _jax_bnc(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), si,
                    bias, region, pad, 2)
    diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    assert (diff > 2e-2).any(-1).mean() <= 0.02


@pytest.mark.parametrize("shifted", [False, True])
def test_k1_twin_pad_flag_backward_matches_jax_grad(shifted):
    """probsparse_attention_bnc_bwd with padding flags against jax.grad of
    `_probsparse_bnc`: dq, dk, dv and dbias."""
    q, k, v, si, bias, region, pad, nW = _pad_case(2, shifted, seed=5)
    g = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)

    def loss(q, k, v, b):
        return jnp.sum(_jax_bnc(q, k, v, si, b, region, pad, 2)
                       * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (q, k, v, bias)))
    got = TPS.probsparse_attention_bnc_bwd(
        _t(q), _t(k), _t(v), _t(g), num_heads=2, sample_idx=_t(si),
        rel_pos_bias=_t(bias), sw_region=None if region is None
        else _t(region), pad_flag=_t(pad))
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL, err_msg=name)


# ------------------------------------------------------ any-resolution

@pytest.mark.parametrize("h,w,factor", [(40, 56, 32), (100, 120, 128),
                                        (64, 64, 64), (21, 26, 32)])
def test_expand2square_matches_jax(h, w, factor):
    x = np.random.default_rng(h).uniform(size=(2, h, w, 3)).astype(
        np.float32)
    canvas, pad, off = tanyres.expand2square(_t(x), factor)
    jcanvas, jpad, joff = janyres.expand2square(jnp.asarray(x), factor)
    assert off == joff
    np.testing.assert_array_equal(canvas.numpy(), np.asarray(jcanvas))
    np.testing.assert_array_equal(pad.numpy(), np.asarray(jpad))


@pytest.fixture(scope="module")
def port_model():
    """A seeded random-init port Uformer (32², embed 8, f32) and the same
    weights as JAX params (the JAX package's own converter)."""
    torch.manual_seed(7)
    model = Uformer(ModelConfig(img_size=32, embed_dim=8,
                                dtype=torch.float32)).eval()
    # the reference init leaves the Linear biases at 0; give them values so
    # that the bias paths of both models are compared too
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.normal_(0.0, 0.02)
    params = convert_uformer_state_dict(model.state_dict())
    return model, jax.tree.map(jnp.asarray, params)


@pytest.mark.parametrize("h,w,X", [(21, 26, 32), (45, 60, 64)])
def test_model_with_pad_mask_matches_jax(port_model, pinned, h, w, X):
    """The Uformer (configured at 32², embed 8, f32) on an X² canvas with a
    centred h×w image and its padding mask, against JAX. The padding
    starts at an odd row, so half-pixel resizing would move the mask
    border at the 2× and 4× downsampled stages (checked here); the legacy
    nearest indices keep it where the reference has it."""
    x = np.random.default_rng(X).uniform(size=(1, h, w, 3)).astype(
        np.float32)
    canvas, pad, (r0, _) = tanyres.expand2square(_t(x), X)
    assert r0 % 2 == 1
    col = pad[0, :, X // 2, 0].numpy()
    for s in (2, 4):
        n = X // s
        legacy = col[np.minimum((np.arange(n) * s).astype(np.int32), X - 1)]
        half = col[np.minimum(((np.arange(n) + 0.5) * s).astype(np.int32),
                              X - 1)]
        assert (legacy != half).any()

    port, params = port_model
    model = JaxUformer(JaxModelConfig(img_size=32, embed_dim=8,
                                      dtype=jnp.float32))
    want = np.asarray(jax.jit(lambda p, c, m: model.apply(
        {"params": p}, c, train=False, pad_mask=m,
        rngs={"sample": jax.random.PRNGKey(0)}))(
            params, jnp.asarray(canvas.numpy()), jnp.asarray(pad.numpy())))
    with torch.inference_mode():
        got = port(canvas, pad_mask=pad).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# ------------------------------------------------------ eval images

def test_val_images_match_jax(tmp_path):
    write_dataset(str(tmp_path), 3, (12, 20), seed=4)
    got = list(tpipe.val_images(tpipe.PairedFolder(str(tmp_path))))
    want = list(jpipe.val_images(jpipe.PairedFolder(str(tmp_path))))
    assert [g[2] for g in got] == [w[2] for w in want] == [
        "00000.png", "00001.png", "00002.png"]
    for g, w in zip(got, want):
        assert g[0].dtype == np.float32
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
