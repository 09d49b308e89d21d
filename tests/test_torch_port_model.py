"""The port's Uformer and whole-image function against the JAX package.

The same params go to both packages through the weight bridge
(`dehaze_tpu_torch.utils.convert.state_dict_from_jax_params`), and the
ProbSparse key sampling is pinned on both sides with one table per window
size N (deep stages of a model configured at 32² run N = 16 and N = 4).
Tolerances: f32 2e-4; bf16 and uint8 cases state theirs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dehaze_tpu.config import ModelConfig as JaxModelConfig
from dehaze_tpu.infer.tiled import (make_whole_image_fn as
                                    jax_make_whole_image_fn)
from dehaze_tpu.infer.tiled import quantize_u8 as jax_quantize_u8
from dehaze_tpu.models.uformer import Uformer as JaxUformer
from dehaze_tpu.ops import probsparse as PS
from dehaze_tpu.utils.convert_torch import convert_uformer_state_dict
from dehaze_tpu_torch.config import ModelConfig
from dehaze_tpu_torch.infer import tiled as ttiled
from dehaze_tpu_torch.models.uformer import Uformer
from dehaze_tpu_torch.ops import probsparse as TPS
from dehaze_tpu_torch.utils.convert import (load_weights,
                                            state_dict_from_jax_params)

TOL = 2e-4
IMG = 32


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
def jax_params():
    """Uformer params (32², embed 8, f32) in the JAX package's layout: a
    seeded port init (the reference's truncated-normal scheme, as the JAX
    model's) through the JAX package's own converter. Their tree, shapes
    and dtypes are those of the JAX model's init, traced but not compiled."""
    torch.manual_seed(0)
    sd = Uformer(ModelConfig(img_size=IMG, embed_dim=8,
                             dtype=torch.float32)).state_dict()
    params = jax.tree.map(np.asarray, convert_uformer_state_dict(sd))
    model = JaxUformer(JaxModelConfig(img_size=IMG, embed_dim=8,
                                      dtype=jnp.float32))
    k = jax.random.PRNGKey(0)
    want = jax.eval_shape(lambda: model.init(
        {"params": k, "sample": k}, jnp.zeros((1, IMG, IMG, 3))))["params"]
    assert jax.tree.structure(params) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    return params


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


def _port(jax_params, dtype=torch.float32, **flags):
    m = Uformer(ModelConfig(img_size=IMG, embed_dim=8, dtype=dtype, **flags))
    m.load_state_dict(state_dict_from_jax_params(jax_params), strict=True)
    return m.eval()


def _jax_apply(dtype=jnp.float32, **flags):
    model = JaxUformer(JaxModelConfig(img_size=IMG, embed_dim=8,
                                      dtype=dtype, **flags))
    return lambda p, x: model.apply({"params": p}, x, train=False,
                                    rngs={"sample": jax.random.PRNGKey(0)})


def test_weight_bridge_round_trip_exact(jax_params):
    """JAX-layout params → port state_dict → load → state_dict() → the JAX
    package's own converter → the same params, leaf for leaf, exactly."""
    sd = _port(jax_params).state_dict()
    back = convert_uformer_state_dict(sd)
    flat_a = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))


def test_load_weights_reference_format(jax_params, tmp_path):
    """`{'state_dict': ...}` with DataParallel prefixes and the reference's
    unused attn.qkv/attn.proj keys loads strictly."""
    sd = state_dict_from_jax_params(jax_params)
    ref = {f"module.{k}": v for k, v in sd.items()}
    ref["module.encoderlayer_0.blocks.0.attn.qkv.to_q.weight"] = torch.zeros(
        8, 8)
    ref["module.encoderlayer_0.blocks.0.attn.proj.bias"] = torch.zeros(8)
    path = tmp_path / "ref.pth"
    torch.save({"epoch": 3, "state_dict": ref}, path)
    m = Uformer(ModelConfig(img_size=IMG, embed_dim=8,
                            dtype=torch.float32))
    m.load_state_dict(load_weights(str(path)), strict=True)
    for k, v in m.state_dict().items():
        assert torch.equal(v, sd[k]), k


def _without_bias_tables(tree):
    """The params of the same model built with use_rel_pos_bias=False."""
    if not isinstance(tree, dict):
        return tree
    return {k: _without_bias_tables(v) for k, v in tree.items()
            if k != "relative_position_bias_table"}


# the ablation flags an exported artifact bakes in: --no_rel_pos_bias (no
# bias table, no bias term) and --fast_gelu (tanh GELU in K2)
_FLAGS = {"": {}, "no_rel_pos_bias": {"use_rel_pos_bias": False},
          "fast_gelu": {"fast_gelu": True}}


@pytest.mark.parametrize("size,variant",
                         [(32, ""), (64, ""), (32, "no_rel_pos_bias"),
                          (32, "fast_gelu")],
                         ids=["32", "64", "32-no_rel_pos_bias",
                              "32-fast_gelu"])
def test_model_matches_jax_f32(jax_params, pinned, size, variant):
    flags = _FLAGS[variant]
    params = (jax_params if flags.get("use_rel_pos_bias", True)
              else _without_bias_tables(jax_params))
    x = np.random.default_rng(size).uniform(size=(1, size, size, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(_jax_apply(**flags))(params, jnp.asarray(x)))
    with torch.inference_mode():
        got = _port(params, **flags)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_model_matches_jax_bf16(jax_params, pinned):
    """bf16 activations: both round at every layer boundary, but XLA and
    torch place the elementwise roundings differently inside LN, GELU and
    the dwconv. The image is x + a small residual; 2e-2 absolute is ~2.5
    bf16 ulps of the residual path's largest values."""
    x = np.random.default_rng(5).uniform(size=(1, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(_jax_apply(jnp.bfloat16))(jax_params,
                                                       jnp.asarray(x)))
    with torch.inference_mode():
        got = _port(jax_params, torch.bfloat16)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


@pytest.mark.parametrize("square", [False, True])
def test_whole_image_u8_matches_jax(jax_params, pinned, square):
    h, w, ps = 40, 56, 32
    img = np.random.default_rng(7).integers(0, 256, size=(1, h, w, 3),
                                            dtype=np.uint8)
    apply = _jax_apply()
    jrun = jax_make_whole_image_fn(lambda x: apply(jax_params, x), h, w, ps,
                                   square=square)
    want = np.asarray(jrun(jnp.asarray(img)))
    model = _port(jax_params)
    trun = ttiled.make_whole_image_fn(model, h, w, ps, square=square,
                                      device="cpu")
    got = trun(img).numpy()
    assert got.shape == (1, h, w, 3)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    # uint8 quantization: at most 1 LSB, on at most 1% of values (a value
    # within 2e-4 of a rounding boundary may round the other way). JAX's
    # quantize_u8 wraps the frame `jrun` already gave (wrapping jrun itself
    # compiles the whole model a second time for the same values)
    got_u8 = ttiled.quantize_u8(trun)(img).numpy().astype(int)
    want_u8 = np.asarray(jax_quantize_u8(lambda _: jnp.asarray(want))(
        jnp.asarray(img))).astype(int)
    d = np.abs(got_u8 - want_u8)
    assert d.max() <= 1 and (d > 0).mean() <= 0.01


def test_canvas_and_wrap_pad_match_jax():
    from dehaze_tpu.infer import tiled as jtiled

    assert ttiled.canvas_size(40, 56, 32) == jtiled.canvas_size(40, 56, 32)
    assert ttiled.rect_canvas_size(40, 64, 32) == jtiled.rect_canvas_size(
        40, 64, 32)
    x = np.random.default_rng(8).normal(size=(2, 40, 56, 3)).astype(
        np.float32)
    for L, Lw in ((64, 64), (64, 96)):
        np.testing.assert_array_equal(
            ttiled.wrap_pad_canvas(torch.from_numpy(x), L, Lw).numpy(),
            np.asarray(jtiled.wrap_pad_canvas(jnp.asarray(x), L, Lw)))
