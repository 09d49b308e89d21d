"""The port's W-MSA Uformer (`attention='full'`) against the JAX package's,
on the CPU at 32², embed 8, f32.

The same params go to both packages through the weight bridge
(`dehaze_tpu_torch.utils.convert.state_dict_from_jax_params`). They come
from a seeded port init through the JAX package's own converter, or, for
`token_mlp='ffn'` (which that converter cannot read: it always reads the
LeFF keys), from the JAX init's tree (`jax.eval_shape`, nothing compiled)
filled with seeded numpy. W-MSA draws no samples, so nothing is pinned.
Tolerances: f32 2e-4; the bf16 case states its own.
"""

import argparse
import functools
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dehaze_tpu.config import ModelConfig as JaxModelConfig
from dehaze_tpu.models import layers as JL
from dehaze_tpu.models.uformer import Uformer as JaxUformer
from dehaze_tpu.ops import probsparse as JPS
from dehaze_tpu.ops import window as JW
from dehaze_tpu.utils.convert_torch import convert_uformer_state_dict
from dehaze_tpu_torch.config import ModelConfig
from dehaze_tpu_torch.data.synth import write_dataset
from dehaze_tpu_torch.infer.tiled import make_whole_image_fn, quantize_u8
from dehaze_tpu_torch.models import layers as TL
from dehaze_tpu_torch.models.uformer import Uformer, draw_sample_tables
from dehaze_tpu_torch.ops import probsparse as TPS
from dehaze_tpu_torch.ops import window as TW
from dehaze_tpu_torch.utils.convert import (load_weights,
                                            state_dict_from_jax_params)

TOL = 2e-4
IMG = 32
TINY = ["--embed_dim", "8", "--train_ps", "32", "--dtype", "float32",
        "--device", "cpu"]
VARIANTS = {
    "linear-leff": {},
    "conv-ffn-se": dict(token_projection="conv", token_mlp="ffn",
                        se_layer=True),
    "linear_concat-leff": dict(token_projection="linear_concat"),
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


def _cfg(**flags):
    return ModelConfig(img_size=IMG, embed_dim=8, dtype=torch.float32,
                       attention="full", **flags)


def _jax_model(**flags):
    return JaxUformer(JaxModelConfig(img_size=IMG, embed_dim=8,
                                     dtype=jnp.float32, attention="full",
                                     **flags))


def _jax_tree(**flags):
    """The JAX W-MSA model's params as its init makes them: shapes and
    dtypes only (traced, not compiled)."""
    return _jax_tree_of(tuple(sorted(flags.items())))


@functools.lru_cache(maxsize=None)
def _jax_tree_of(flags):
    model, k = _jax_model(**dict(flags)), jax.random.PRNGKey(0)
    return jax.eval_shape(lambda: model.init(
        {"params": k}, jnp.zeros((1, IMG, IMG, 3))))["params"]


def _converted(sd, **flags):
    """A port state_dict through the JAX package's converter."""
    return jax.tree.map(np.asarray, convert_uformer_state_dict(
        sd, attention="full",
        token_projection=flags.get("token_projection", "linear"),
        se_layer=flags.get("se_layer", False)))


def _assert_tree_like(params, want):
    assert jax.tree.structure(params) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.fixture(scope="module")
def jax_params():
    """{variant: params in the JAX package's layout}, each checked against
    the JAX init's tree."""
    out = {}
    for i, (name, flags) in enumerate(VARIANTS.items()):
        want = _jax_tree(**flags)
        if flags.get("token_mlp") == "ffn":
            rng = np.random.default_rng(i)

            def fill(path, leaf, rng=rng):
                mean = 1.0 if "scale" in jax.tree_util.keystr(path) else 0.0
                return rng.normal(mean, 0.05, leaf.shape).astype(np.float32)

            params = jax.tree_util.tree_map_with_path(fill, want)
        else:
            torch.manual_seed(i)
            params = _converted(Uformer(_cfg(**flags)).state_dict(), **flags)
        _assert_tree_like(params, want)
        out[name] = params
    return out


def _port(params, **flags):
    m = Uformer(_cfg(**flags))
    m.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return m.eval()


# (region ids, pad flags, kv widened to 2N, the mask as [nW, N, N])
_ATTN_CASES = {"plain": (False, False, False, False),
               "region": (True, False, False, False),
               "pad": (False, True, False, False),
               "region_pad": (True, True, False, False),
               "concat_region_pad": (True, True, True, False),
               "sw_mask_pad": (False, True, False, True)}


def _attn_inputs(layout, case, dtype=np.float32, seed=0):
    region, pad, concat, full_mask = _ATTN_CASES[case]
    rng = np.random.default_rng(seed)
    B, H, N, D, nW = 8, 2, 16, 8, 4
    M = 2 * N if concat else N
    shape = ((lambda n: (B, n, H, D)) if layout == "bnhd"
             else (lambda n: (B, H, n, D)))
    q, k, v = (rng.normal(size=shape(n)).astype(dtype) for n in (N, M, M))
    kw = {"rel_pos_bias": rng.normal(size=(H, N, N)).astype(np.float32),
          "layout": layout}
    if region:
        kw["sw_region"] = rng.integers(0, 3, size=(nW, N)).astype(np.int32)
    if pad:
        kw["pad_flag"] = (rng.uniform(size=(nW, N)) < 0.4).astype(
            np.float32)
    if full_mask:  # the 8×8 map of 4×4 windows shifted by 2
        kw["sw_mask"] = TW.shift_attn_mask(8, 8, 4, 2)
    return q, k, v, kw


def _both(fn_jax, fn_port, q, k, v, kw, to_port=torch.from_numpy):
    want = fn_jax(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  **{a: b if isinstance(b, str) else jnp.asarray(b)
                     for a, b in kw.items()})
    got = fn_port(to_port(q), to_port(k), to_port(v),
                  **{a: b if isinstance(b, str) else torch.from_numpy(
                      np.ascontiguousarray(b)) for a, b in kw.items()})
    return got, want


@pytest.mark.parametrize("case", list(_ATTN_CASES))
@pytest.mark.parametrize("layout", ["bnhd", "bhnd"])
def test_full_window_attention_matches_jax(layout, case):
    """With and without region ids, pad flags, the full mask and M = 2N
    (the interleaved widening of the bias and masks), in both layouts."""
    q, k, v, kw = _attn_inputs(layout, case)
    got, want = _both(JPS.full_window_attention, TPS.full_window_attention,
                      q, k, v, kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_full_window_attention_bf16_matches_jax():
    """bf16 q/k/v: the scores and softmax stay float32 on both sides and
    the probabilities are rounded to bf16 for P·V, so the outputs differ
    only in a bf16 rounding of an f32 sum taken in another order: 1e-2 is
    at most 2 bf16 ulps at the outputs' magnitude (|out| < 2)."""
    q, k, v, kw = _attn_inputs("bnhd", "concat_region_pad",
                               dtype=jnp.bfloat16, seed=3)
    got, want = _both(JPS.full_window_attention, TPS.full_window_attention,
                      q, k, v, kw, to_port=lambda a: torch.from_numpy(
                          np.asarray(a, np.float32)).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=1e-2)


@pytest.mark.parametrize("H,W,win,shift", [(16, 16, 8, 4), (32, 48, 8, 4),
                                           (8, 8, 4, 2)])
def test_shift_attn_mask_matches_jax(H, W, win, shift):
    got = TW.shift_attn_mask(H, W, win, shift)
    np.testing.assert_array_equal(got, JW.shift_attn_mask(H, W, win, shift))
    assert got.dtype == np.float32
    # the mask the model builds from region ids on the fly
    region = torch.from_numpy(TW.shift_region_ids(H, W, win, shift))
    np.testing.assert_array_equal(TW.region_mask(region).numpy(), got)


def _lin(m):
    p = {"kernel": m.weight.detach().numpy().T}
    if m.bias is not None:
        p["bias"] = m.bias.detach().numpy()
    return p


def _conv(m):
    return {"kernel": m.weight.detach().numpy().transpose(2, 3, 1, 0),
            "bias": m.bias.detach().numpy()}


# port module, its flax counterpart and flax params, the input's shape
_LAYERS = {
    "mlp": lambda: (TL.Mlp(8, 32), JL.Mlp(32, 8),
                    lambda m: {"fc1": _lin(m.fc1), "fc2": _lin(m.fc2)},
                    (2, 16, 8)),
    "mlp_tanh": lambda: (TL.Mlp(8, 32, fast_gelu=True),
                         JL.Mlp(32, 8, fast_gelu=True),
                         lambda m: {"fc1": _lin(m.fc1), "fc2": _lin(m.fc2)},
                         (2, 16, 8)),
    # C < 16: the first Linear is zero-width and the gate sigmoid(0)
    "se_8": lambda: (TL.SELayer(8), JL.SELayer(8),
                     lambda m: {"fc1": _lin(m.fc[0]), "fc2": _lin(m.fc[2])},
                     (3, 16, 8)),
    "se_32": lambda: (TL.SELayer(32), JL.SELayer(32),
                      lambda m: {"fc1": _lin(m.fc[0]), "fc2": _lin(m.fc[2])},
                      (3, 16, 32)),
    "sepconv": lambda: (TL.SepConv2d(8, 8), JL.SepConv2d(8),
                        lambda m: {"depthwise": _conv(m.depthwise),
                                   "pointwise": _conv(m.pointwise)},
                        (2, 4, 4, 8)),
}


@pytest.mark.parametrize("name", list(_LAYERS))
def test_layer_matches_flax(name):
    port, flax_mod, params_of, shape = _LAYERS[name]()
    rng = np.random.default_rng(len(name))
    with torch.no_grad():
        for p in port.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.3, p.shape).astype(
                np.float32)))
    x = rng.normal(size=shape).astype(np.float32)
    want = flax_mod.apply({"params": params_of(port)}, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    if name == "se_8":
        assert port.fc[0].weight.shape == (0, 8)
        np.testing.assert_allclose(got.numpy(), 0.5 * x, rtol=1e-6)


def _pad_mask():
    pm = np.zeros((1, IMG, IMG, 1), np.float32)
    pm[:, 24:] = 1.0
    pm[:, :, 20:] = 1.0
    return pm


@pytest.mark.parametrize("variant,pad", [
    ("linear-leff", False), ("conv-ffn-se", False),
    ("linear_concat-leff", True)],
    ids=["linear-leff", "conv-ffn-se", "linear_concat-leff-pad"])
def test_wmsa_model_matches_jax_f32(jax_params, variant, pad):
    """Eval forward, f32; the 'linear_concat' case with a padding mask
    (any-resolution inputs), which is widened to its 2N keys as well."""
    flags = VARIANTS[variant]
    params = jax_params[variant]
    x = np.random.default_rng(7).uniform(size=(1, IMG, IMG, 3)).astype(
        np.float32)
    pm = _pad_mask() if pad else None
    model = _jax_model(**flags)
    want = np.asarray(jax.jit(lambda p, x, pm: model.apply(
        {"params": p}, x, train=False, pad_mask=pm))(
            params, jnp.asarray(x), None if pm is None else jnp.asarray(pm)))
    with torch.inference_mode():
        got = _port(params, **flags)(
            torch.from_numpy(x),
            pad_mask=None if pm is None else torch.from_numpy(pm)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_wmsa_gradient_matches_jax_grad(jax_params):
    """d/dθ Σ(w ⊙ model(x)) for the 'linear' model (drop_path 0): the
    port's backward (train mode: the unfused LeFF) against jax.grad, each
    leaf mapped by the JAX package's converter, within 2e-4 of the leaf's
    largest gradient plus 2e-4 relative."""
    params = jax_params["linear-leff"]
    rng = np.random.default_rng(8)
    x = rng.uniform(size=(1, IMG, IMG, 3)).astype(np.float32)
    w = rng.normal(size=(1, IMG, IMG, 3)).astype(np.float32)
    model = _jax_model(drop_path_rate=0.0)
    want = jax.jit(jax.grad(lambda p: jnp.sum(jnp.asarray(w) * model.apply(
        {"params": p}, jnp.asarray(x), train=False))))(params)
    port = _port(params, drop_path_rate=0.0).train()
    (port(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    got = _converted({k: p.grad for k, p in port.named_parameters()})
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        leaf = np.asarray(leaf)
        np.testing.assert_allclose(
            flat_got[path], leaf, rtol=TOL,
            atol=TOL * max(float(np.abs(leaf).max()), 1e-3),
            err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("proj,se", [("linear", False), ("conv", True),
                                     ("linear_concat", False)])
def test_weight_round_trip_exact(proj, se):
    """Port state_dict → the JAX converter → state_dict_from_jax_params →
    load strictly → state_dict → the JAX converter: the same params, leaf
    for leaf, and the same state_dict, exactly."""
    flags = dict(token_projection=proj, se_layer=se)
    torch.manual_seed(5)
    sd0 = Uformer(_cfg(**flags)).state_dict()
    params = _converted(sd0, **flags)
    _assert_tree_like(params, _jax_tree(**flags))
    sd = state_dict_from_jax_params(params)
    assert set(sd) == set(sd0)
    for key, value in sd0.items():
        assert torch.equal(sd[key], value), key
    m = Uformer(_cfg(**flags))
    m.load_state_dict(sd, strict=True)
    back = _converted(m.state_dict(), **flags)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))


def test_config_refusals_mirror_jax():
    """The combinations the JAX package refuses (tests/test_model.py),
    refused by the port too; the live ones construct."""
    from dehaze_tpu.models import get_arch

    for kw, match in ((dict(token_projection="banana"),
                       "unknown token_projection"),
                      (dict(attention="probsparse", token_projection="conv"),
                       "attention='full'"),
                      (dict(attention="probsparse",
                            token_projection="linear_concat"),
                       "attention='full'"),
                      (dict(attention="probsparse", se_layer=True),
                       "attention='full'")):
        with pytest.raises(ValueError, match=match):
            get_arch(JaxModelConfig(**kw))
        with pytest.raises(ValueError, match=match):
            Uformer(ModelConfig(**kw))
    # values the JAX CLI's choices refuse
    for kw in (dict(attention="sparse"), dict(token_mlp="mlp")):
        with pytest.raises(ValueError, match="unknown"):
            Uformer(ModelConfig(**kw))
    # an unknown arch is refused by the registry, in both packages
    from dehaze_tpu_torch.models import get_arch as port_get_arch

    with pytest.raises(ValueError, match="unknown arch"):
        get_arch(JaxModelConfig(arch="cnn"))
    with pytest.raises(ValueError, match="unknown arch"):
        port_get_arch(ModelConfig(arch="cnn"))
    small = dict(img_size=IMG, embed_dim=8)
    Uformer(ModelConfig(attention="full", token_projection="conv", **small))
    Uformer(ModelConfig(attention="full", token_projection="linear_concat",
                        se_layer=True, **small))
    Uformer(ModelConfig(attention="probsparse", token_mlp="ffn", **small))


def test_cli_flags_map_to_the_config():
    from dehaze_tpu_torch.cli.common import add_common_args, config_from_args

    p = add_common_args(argparse.ArgumentParser())
    cfg = config_from_args(p.parse_args([])).model
    assert (cfg.attention, cfg.token_projection, cfg.token_mlp,
            cfg.se_layer) == ("probsparse", "linear", "leff", False)
    cfg = config_from_args(p.parse_args(
        ["--attention", "full", "--token_projection", "conv", "--token_mlp",
         "ffn", "--se_layer"])).model
    assert (cfg.attention, cfg.token_projection, cfg.token_mlp,
            cfg.se_layer) == ("full", "conv", "ffn", True)
    with pytest.raises(SystemExit):
        p.parse_args(["--token_projection", "banana"])


def test_reference_wmsa_pth_loads_strict(tmp_path):
    """A reference-format W-MSA checkpoint (`{'epoch', 'state_dict',
    'optimizer'}`, DataParallel prefixes, the rel-pos index buffers) loads
    strictly: its attn.qkv/attn.proj/se_layer keys are its attention. A
    ProbSparse model refuses it."""
    flags = VARIANTS["conv-ffn-se"]
    torch.manual_seed(6)
    sd = Uformer(_cfg(**flags)).state_dict()
    ref = {f"module.{k}": v for k, v in sd.items()}
    for k in sd:
        if k.endswith("attn.relative_position_bias_table"):
            ref["module." + k.replace("bias_table", "index")] = torch.zeros(
                64, 64, dtype=torch.long)
    path = tmp_path / "ref.pth"
    torch.save({"epoch": 3, "state_dict": ref, "optimizer": {}}, path)
    m = Uformer(_cfg(**flags))
    m.load_state_dict(load_weights(str(path)), strict=True)
    for k, v in m.state_dict().items():
        assert torch.equal(v, sd[k]), k
    with pytest.raises(RuntimeError, match="ProbSpare"):
        Uformer(ModelConfig(img_size=IMG, embed_dim=8)).load_state_dict(
            load_weights(str(path)), strict=True)


@pytest.fixture(scope="module")
def wmsa_setup(tmp_path_factory):
    """A seeded 'linear' W-MSA Uformer saved as .pth and a two-pair 40×56
    folder."""
    root = tmp_path_factory.mktemp("wmsa")
    torch.manual_seed(9)
    model = Uformer(_cfg()).eval()
    pth = str(root / "w.pth")
    torch.save({"state_dict": model.state_dict()}, pth)
    write_dataset(str(root / "DS"), 2, (40, 56), seed=4)
    return root, pth, model


def test_export_wmsa_equals_eager(wmsa_setup):
    """`cli.export --attention full --square`: no sample tables, one K2
    operator per block and no K1 in the graph; the artifact equals the
    eager forward bit for bit, and `cli.test_long --exported` gives
    `--weights`' PSNRs."""
    import collections

    from dehaze_tpu_torch.cli import export as cli_export
    from dehaze_tpu_torch.cli import test_long
    from dehaze_tpu_torch.infer.export import load_exported, load_program

    root, pth, model = wmsa_setup
    assert draw_sample_tables(model, torch.Generator().manual_seed(0)) == []
    flags = ["--attention", "full"] + TINY
    sq = str(root / "square.dhz")
    cli_export.main(["--weights", pth, "--height", "40", "--width", "56",
                     "--square", "--out", sq] + flags)
    ep, _ = load_program(sq, "cpu")
    ops = collections.Counter(str(n.target) for n in ep.graph.nodes
                              if n.op == "call_function")
    assert ops["dehaze_tpu_torch.leff_fused.default"] == 18
    assert ops["dehaze_tpu_torch.window_attention_fwd.default"] == 0
    fn, _ = load_exported(sq, "cpu")
    eager = make_whole_image_fn(model, 40, 56, 32, square=True,
                                device="cpu")
    x = np.random.default_rng(1).uniform(size=(1, 40, 56, 3)).astype(
        np.float32)
    assert torch.equal(fn(x), eager(x))
    common = ["--input_dir", str(root / "DS"), "--no-save_images"]
    got = test_long.main(common + ["--exported", sq, "--device", "cpu"])
    want = test_long.main(common + ["--weights", pth] + flags)
    assert got["psnr"] == want["psnr"] and got["ssim"] == want["ssim"]


@pytest.mark.parametrize("cli", ["test_long", "test_anyres", "stream",
                                 "serve"])
def test_cli_runs_wmsa(wmsa_setup, tmp_path, cli):
    """Each serving and evaluation CLI with `--attention full` gives the
    in-process forward of the same model: the eval CLIs its PSNRs, the
    stream and the server its uint8 frames."""
    import importlib

    from dehaze_tpu_torch.data.images import load_img
    from dehaze_tpu_torch.data.pipeline import PairedFolder, val_images
    from dehaze_tpu_torch.infer.anyres import make_anyres_fn
    from dehaze_tpu_torch.ops import metrics as M

    root, pth, model = wmsa_setup
    flags = ["--weights", pth, "--attention", "full"] + TINY
    pairs = list(val_images(PairedFolder(str(root / "DS"))))
    if cli in ("test_long", "test_anyres"):
        res = importlib.import_module(f"dehaze_tpu_torch.cli.{cli}").main(
            flags + ["--input_dir", str(root / "DS"), "--no-save_images"])
        for (clean, hazy, _), psnr in zip(pairs, res["psnr"]):
            run = (make_anyres_fn(lambda x, pad_mask=None: model(
                x, pad_mask=pad_mask), 40, 56, 128, device="cpu")
                if cli == "test_anyres" else
                make_whole_image_fn(model, 40, 56, 32, square=True,
                                    device="cpu"))
            want = float(M.psnr(run(hazy[None])[0],
                                torch.from_numpy(clean)))
            assert abs(psnr - want) <= 1e-6
        return
    run = quantize_u8(make_whole_image_fn(model, 40, 56, 32, square=False,
                                          device="cpu"))
    hazy = str(root / "DS" / "hazy")
    names = sorted(os.listdir(hazy))
    if cli == "stream":
        from dehaze_tpu_torch.cli import stream

        stats = stream.main(flags + ["--input_dir", hazy, "--result_dir",
                                     str(tmp_path)])
        assert stats["frames"] == 2
        for name in names:
            img = load_img(f"{hazy}/{name}", u8=True)
            np.testing.assert_array_equal(
                load_img(str(tmp_path / name), u8=True),
                run(img[None])[0].numpy())
        return
    from dehaze_tpu_torch.cli.common import config_from_args
    from dehaze_tpu_torch.cli.serve import build_dehaze_fn, build_parser

    args = build_parser().parse_args(flags)
    dehaze, info = build_dehaze_fn(args, config_from_args(args).model)
    try:
        img = load_img(f"{hazy}/{names[0]}", u8=True)
        np.testing.assert_array_equal(dehaze(img), run(img[None])[0].numpy())
    finally:
        dehaze.batcher.close()


def test_wmsa_remat_gradients_equal_plain():
    """`--remat` on a W-MSA model with DropPath and FFN dropout on: the
    recompute replays the droppath and dropout generators (no tables are
    drawn), so gradients and generator states equal the plain step's
    bit for bit."""
    flags = dict(token_mlp="ffn", drop_path_rate=0.1, drop_rate=0.1)
    torch.manual_seed(11)
    state = Uformer(_cfg(**flags)).state_dict()
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(2, IMG, IMG, 3)).astype(np.float32))
    grads, states = [], []
    for remat in (False, True):
        m = Uformer(_cfg(remat=remat, **flags)).train()
        m.load_state_dict(state)
        gens = [torch.Generator().manual_seed(s) for s in (1, 2)]
        m(x, droppath=gens[0], dropout_gen=gens[1]).square().sum().backward()
        grads.append({k: p.grad for k, p in m.named_parameters()})
        states.append([g.get_state() for g in gens])
    for k, g in grads[0].items():
        assert torch.equal(grads[1][k], g), k
    for a, b in zip(*states):
        assert torch.equal(a, b)


def test_cli_train_wmsa(tmp_path):
    """`cli.train --attention full --token_projection conv --token_mlp ffn
    --se_layer --remat` at tiny size: finite step losses and a
    model_best.pth that loads strictly into the same configuration."""
    from dehaze_tpu_torch.cli import train

    write_dataset(str(tmp_path / "train"), 8, 48, seed=1)
    write_dataset(str(tmp_path / "val"), 2, 32, seed=2)
    flags = ["--attention", "full", "--token_projection", "conv",
             "--token_mlp", "ffn", "--se_layer"]
    train.main(flags + TINY + [
        "--remat", "--train_dir", str(tmp_path / "train"), "--val_dir",
        str(tmp_path / "val"), "--batch_size", "4", "--nepoch", "1",
        "--w_loss_vgg7", "0", "--save_dir", str(tmp_path / "log")])
    events = [json.loads(ln) for f in glob.glob(
        str(tmp_path / "log" / "uformer_" / "*.jsonl")) for ln in open(f)]
    losses = next(e for e in events if e["kind"] == "epoch")["step_losses"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    m = Uformer(_cfg(**VARIANTS["conv-ffn-se"]))
    m.load_state_dict(load_weights(str(
        tmp_path / "log" / "uformer_" / "models" / "model_best.pth")),
        strict=True)
