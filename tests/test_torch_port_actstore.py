"""`--act_store` in the port (`ops/actstore.py`; its six sites in the LeWin
block, LeFF's unfused branch and K2's twin; the CLI flag; the artifact)
against the JAX package, on the CPU at embed 8 and 32², f32.

- `compress` is the JAX function bit for bit in f32 and bf16, both modes,
  NaN cases included.
- Placement: both packages' `compress` is replaced by one smooth,
  row-dependent stand-in, x · (1 + 0.5 · tanh(mean(x))) + 0.1 · mean(|x|)
  over the last axis. A missing or extra site, a wrong tensor or a wrong
  axis then moves the output far beyond the f32 bar of 2e-4 (each test
  checks that the stand-in moves its output by more than 20× the bar), so
  the Uformer at eval (LeFF and the plain FFN), K2's twin against the JAX
  norm2 + compress + LeFF chain and LeFF's unfused branch are held to
  2e-4.
- The real modes at model level, the CLI flag on every CLI that takes it,
  `cli.test_long --act_store int8` against the in-process forward, and a
  `torch.export` artifact.

The models have the depths `DEPTHS`: two blocks (unshifted, shifted) at
32² in the first and last stages, one at 16² in the second and the
second-to-last, none elsewhere. Every site is in every block, so the
blocks left out add nothing to the placement, and each JAX compile takes a
quarter of the full depth's.
"""

import importlib
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from dehaze_tpu.config import ModelConfig as JaxModelConfig
from dehaze_tpu.models import layers as JL
from dehaze_tpu.models.uformer import Uformer as JaxUformer
from dehaze_tpu.ops import actstore as JA
from dehaze_tpu.ops import probsparse as PS
from dehaze_tpu_torch.config import ModelConfig
from dehaze_tpu_torch.data.synth import write_dataset
from dehaze_tpu_torch.infer import export as E
from dehaze_tpu_torch.infer.tiled import make_whole_image_fn
from dehaze_tpu_torch.models.layers import LeFF
from dehaze_tpu_torch.models.uformer import Uformer
from dehaze_tpu_torch.ops import actstore as TA
from dehaze_tpu_torch.ops import metrics as TM
from dehaze_tpu_torch.ops import probsparse as TPS
from dehaze_tpu_torch.ops.kernels import leff as K2
from dehaze_tpu_torch.utils.convert import state_dict_from_jax_params

TOL = 2e-4
IMG = 32
DEPTHS = (2, 1, 0, 0, 0, 0, 0, 1, 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU tensors: with several test
    workers on the host, torch's thread pools stall each other in
    hand-offs (a small op then takes tens of times as long)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ compress


def _unit_rows():
    """Seeded rows at scales 0.01-50; rows of the fp8 edge values (448 the
    largest e4m3fn value, 464 the midpoint to 480), ±inf and NaN; a zero
    row (its scale is 1e-8 / 127)."""
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((256, 64)) * np.exp(rng.uniform(
        np.log(0.01), np.log(50), (256, 1)))
    edge = np.zeros((4, 64))
    edge[0, :10] = [448, -448, 464, -464, 464.01, -464.01, 480, -480, 1000,
                    -1000]
    edge[1, :3] = [np.inf, 1.5, -2.0]
    edge[2, :3] = [-np.inf, np.nan, 3.0]
    edge[3, 5] = np.nan
    return np.concatenate([rows, edge, np.zeros((1, 64))]).astype(np.float32)


def _same_bits(got, want):
    """NaN at the same places, every other value bit for bit."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))


@pytest.mark.parametrize("mode", ["fp8", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_matches_jax_bit_for_bit(dtype, mode):
    xj = jnp.asarray(_unit_rows()).astype(dtype)
    want = np.asarray(JA.compress(xj, mode).astype(jnp.float32))
    x = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = TA.compress(x, mode)
    assert got.dtype == x.dtype and got.shape == x.shape
    _same_bits(got.float().numpy(), want)
    # where JAX's fp8 cast gives NaN, torch's own cast saturates
    if mode == "fp8":
        assert np.isnan(want[256, 6:10]).all()
        assert torch.isfinite(x[256, 6:10].to(torch.float8_e4m3fn).float()
                              ).all()


def test_compress_none_is_x_and_unknown_modes_raise():
    x = torch.ones(2, 3)
    assert TA.compress(x, None) is x
    for fn, arr in ((TA.compress, x), (JA.compress, jnp.ones((2, 3)))):
        with pytest.raises(ValueError, match="int4"):
            fn(arr, "int4")
    assert [TA.mode_code(m) for m in TA.MODES] == [0, 1, 2]
    assert [TA.mode_of(c) for c in (0, 1, 2)] == list(TA.MODES)
    with pytest.raises(ValueError):
        TA.mode_of(3)
    with pytest.raises(ValueError, match="int4"):
        Uformer(ModelConfig(img_size=IMG, embed_dim=8, act_store="int4"))


# ------------------------------------------------------------ placement


def _standin_jax(x, mode):
    if mode is None:
        return x
    y = x.astype(jnp.float32)
    m = jnp.mean(y, axis=-1, keepdims=True)
    a = jnp.mean(jnp.abs(y), axis=-1, keepdims=True)
    return (y * (1 + 0.5 * jnp.tanh(m)) + 0.1 * a).astype(x.dtype)


def _standin_torch(x, mode):
    if mode is None:
        return x
    y = x.float()
    m, a = y.mean(dim=-1, keepdim=True), y.abs().mean(dim=-1, keepdim=True)
    return (y * (1 + 0.5 * torch.tanh(m)) + 0.1 * a).to(x.dtype)


@pytest.fixture
def standin(monkeypatch):
    monkeypatch.setattr(JA, "compress", _standin_jax)
    monkeypatch.setattr(TA, "compress", _standin_torch)


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


def _jax_model(**flags):
    return JaxUformer(JaxModelConfig(img_size=IMG, embed_dim=8,
                                     dtype=jnp.float32, depths=DEPTHS,
                                     **flags))


@pytest.fixture(scope="module")
def params():
    """{token_mlp: the JAX model's params}: its init's tree (traced, not
    compiled) filled with seeded numpy, N(0, 0.05), LayerNorm scales
    around 1."""
    out = {}
    for i, mlp in enumerate(("leff", "ffn")):
        model, k = _jax_model(token_mlp=mlp), jax.random.PRNGKey(0)
        tree = jax.eval_shape(lambda: model.init(
            {"params": k, "sample": k}, jnp.zeros((1, IMG, IMG, 3))))
        rng = np.random.default_rng(i)

        def fill(path, leaf, rng=rng):
            mean = 1.0 if "scale" in jax.tree_util.keystr(path) else 0.0
            return rng.normal(mean, 0.05, leaf.shape).astype(np.float32)

        out[mlp] = jax.tree_util.tree_map_with_path(fill, tree["params"])
    return out


def _port(p, **flags):
    m = Uformer(ModelConfig(img_size=IMG, embed_dim=8, dtype=torch.float32,
                            depths=DEPTHS, **flags))
    # a stage without blocks has no params in the JAX tree
    stages = ["bottleneck"] + [f"{s}_{i}" for s in ("encoder", "decoder")
                               for i in range(4)]
    p = {**{name: {} for name in stages}, **p}
    m.load_state_dict(state_dict_from_jax_params(p), strict=True)
    return m.eval()


def _jax_forward(p, x, **flags):
    model = _jax_model(**flags)
    fn = jax.jit(lambda p, x: model.apply(
        {"params": p}, x, train=False,
        rngs={"sample": jax.random.PRNGKey(0)}))
    return np.asarray(fn(p, jnp.asarray(x)))


def _frame(seed):
    return np.random.default_rng(seed).uniform(
        size=(1, IMG, IMG, 3)).astype(np.float32)


@pytest.mark.parametrize("mlp", ["leff", "ffn"])
def test_sites_in_the_model_match_jax(params, pinned, standin, mlp):
    """The Uformer at eval (DEPTHS: unshifted and shifted blocks at 32²,
    unshifted ones at 16²), both packages' compress replaced by the
    stand-in: 2e-4."""
    x = _frame(1)
    want = _jax_forward(params[mlp], x, token_mlp=mlp, act_store="int8")
    with torch.inference_mode():
        got = _port(params[mlp], token_mlp=mlp, act_store="int8")(
            torch.from_numpy(x)).numpy()
        plain = _port(params[mlp], token_mlp=mlp)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert np.abs(plain - want).max() > 20 * TOL


def _leff_case(C=16, Ch=64, shape=(2, 8, 12)):
    """Seeded x [B, H, W, C] and LN + LeFF params in the JAX layout."""
    rng = np.random.default_rng(3)

    def n(*s, mean=0.0, std=0.3):
        return rng.normal(mean, std, s).astype(np.float32)

    x = n(*shape, C, std=1.0)
    p = {"ln_scale": n(C, mean=1.0, std=0.1), "ln_bias": n(C, std=0.1),
         "w1": n(C, Ch), "b1": n(Ch, std=0.1),
         "dw_kernel": n(3, 3, 1, Ch), "dw_bias": n(Ch, std=0.1),
         "w2": n(Ch, C, std=0.15), "b2": n(C, std=0.1)}
    return x, p


def _jax_chain(x, p, mode):
    """The JAX block's norm2 → compress → LeFF(act_store) → compress."""
    C, Ch = p["w1"].shape
    ln = fnn.LayerNorm(epsilon=1e-5, dtype=jnp.float32)
    leff = JL.LeFF(Ch, C, act_store=mode, dtype=jnp.float32)
    z = ln.apply({"params": {"scale": p["ln_scale"], "bias": p["ln_bias"]}},
                 jnp.asarray(x))
    z = JA.compress(z, mode)
    z = leff.apply({"params": {
        "linear1": {"kernel": p["w1"], "bias": p["b1"]},
        "dwconv": {"kernel": p["dw_kernel"], "bias": p["dw_bias"]},
        "linear2": {"kernel": p["w2"], "bias": p["b2"]}}}, z)
    return np.asarray(JA.compress(z, mode))


def _unfused(x, p, mode):
    """LeFF's unfused branch (training, or bands) given a mode directly."""
    C, Ch = p["w1"].shape
    m, norm = LeFF(C, Ch), nn.LayerNorm(C, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(p["ln_scale"]))
        norm.bias.copy_(torch.from_numpy(p["ln_bias"]))
        m.linear1[0].weight.copy_(torch.from_numpy(p["w1"]).t())
        m.linear1[0].bias.copy_(torch.from_numpy(p["b1"]))
        m.dwconv[0].weight.copy_(torch.from_numpy(p["dw_kernel"]).permute(
            3, 2, 0, 1))
        m.dwconv[0].bias.copy_(torch.from_numpy(p["dw_bias"]))
        m.linear2[0].weight.copy_(torch.from_numpy(p["w2"]).t())
        m.linear2[0].bias.copy_(torch.from_numpy(p["b2"]))
        return m.train()(torch.from_numpy(x), norm, None, mode).numpy()


def test_sites_in_k2_twin_and_unfused_leff_match_jax(standin):
    """K2's twin, its operator on the CPU and LeFF's unfused branch against
    the JAX chain, the stand-in in place of compress: 2e-4."""
    x, p = _leff_case()
    want = _jax_chain(x, p, "int8")
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    twin = K2.leff_reference(torch.from_numpy(x), act_store="int8", **tp)
    op = K2.leff_fused(torch.from_numpy(x), act_store="int8", **tp)
    for got in (twin.numpy(), op.numpy(), _unfused(x, p, "int8")):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    plain = K2.leff_reference(torch.from_numpy(x), **tp).numpy()
    assert np.abs(plain - want).max() > 20 * TOL


def test_train_mode_never_compresses(params, monkeypatch):
    """Training never quantizes (JAX: only when deterministic): a train-mode
    forward with act_store set calls compress with no mode, and equals the
    forward without it bit for bit; the eval forward does call it."""
    modes = []
    monkeypatch.setattr(TA, "compress",
                        lambda x, mode: modes.append(mode) or x)
    x = torch.from_numpy(_frame(2))
    outs = []
    for act in (None, "fp8"):
        m = _port(params["leff"], act_store=act).train()
        outs.append(m(x, generator=torch.Generator().manual_seed(0),
                      droppath=torch.Generator().manual_seed(1)))
    assert torch.equal(outs[0], outs[1])
    assert set(modes) == {None}
    with torch.inference_mode():
        m.eval()(x, generator=torch.Generator().manual_seed(0))
    assert "fp8" in modes


@pytest.mark.parametrize("mode", ["fp8", "int8"])
def test_real_modes_model_within_the_perturbation_gap(params, pinned, mode):
    """The real quantizers at model level. f32 rounding alone puts the port
    ~1e-6 (relative) from JAX in every layer, and a quantizer turns such a
    gap into whole steps wherever a value sits near a step boundary (fp8
    steps are 1/16-1/8 of the value, int8's 1/127 of the token's amax). So
    no fixed f32 bar holds. The bar is the quantizers' own sensitivity in
    JAX itself: the JAX output on x against the JAX output on x · (1 +
    1e-6 · noise) for two seeded noises. The port's gap to JAX must be
    within twice the larger of those max gaps, and its share of outputs
    beyond 2e-4 within twice theirs plus 1%."""
    x = _frame(4)
    p = params["leff"]
    model = _jax_model(act_store=mode)
    fn = jax.jit(lambda p, x: model.apply(
        {"params": p}, x, train=False,
        rngs={"sample": jax.random.PRNGKey(0)}))
    want = np.asarray(fn(p, jnp.asarray(x)))
    gaps, shares = [], []
    for s in (1, 2):
        noise = np.random.default_rng(s).standard_normal(x.shape)
        xs = (x * (1 + 1e-6 * noise)).astype(np.float32)
        d = np.abs(np.asarray(fn(p, jnp.asarray(xs))) - want)
        gaps.append(d.max())
        shares.append((d > TOL).mean())
    with torch.inference_mode():
        got = _port(p, act_store=mode)(torch.from_numpy(x)).numpy()
    d = np.abs(got - want)
    assert np.isfinite(got).all()
    assert d.max() <= 2 * max(gaps), (d.max(), gaps)
    assert (d > TOL).mean() <= 2 * max(shares) + 0.01, ((d > TOL).mean(),
                                                        shares)


# ------------------------------------------------------------ entry points


# the ten CLIs that take --act_store in the JAX package, with the flags
# each needs before it builds its config
_CLIS = {"export": ["--weights", "w.pth", "--out", "m.dhz"],
         "landscape": ["--weights", "w.pth"],
         "params_flops": [],
         "parity_gate": ["--ref_ckpt", "w.pth", "--input_dir", "DS",
                         "--expected_psnr", "20"],
         "serve": ["--weights", "w.pth"],
         "stream": ["--input_dir", "DS", "--weights", "w.pth"],
         "test_anyres": ["--input_dir", "DS", "--weights", "w.pth"],
         "test_long": ["--input_dir", "DS", "--weights", "w.pth"],
         "train": [],
         "trajectory": ["--ckpt_dir", "C", "--best", "b.pth"]}


class _Built(Exception):
    pass


def test_every_cli_takes_the_flag(monkeypatch):
    """Each CLI that takes --act_store in the JAX package parses it into
    its model config (the config builder is stopped there)."""
    from dehaze_tpu_torch.cli import common

    seen = {}
    for name, flags in _CLIS.items():
        mod = importlib.import_module(f"dehaze_tpu_torch.cli.{name}")

        def stop(a, _name=name):
            seen[_name] = common.config_from_args(a).model.act_store
            raise _Built

        monkeypatch.setattr(mod, "config_from_args", stop)
        argv = flags + ["--act_store", "int8", "--device", "cpu"]
        monkeypatch.setattr(sys, "argv", [name] + argv)
        with pytest.raises(_Built):
            mod.main() if name == "serve" else mod.main(argv)
    assert seen == {name: "int8" for name in _CLIS}


def _small(**kw):
    return ModelConfig(**{"depths": DEPTHS, **kw})


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """A two-pair 40×56 folder and a seeded `.pth` of depths DEPTHS."""
    root = tmp_path_factory.mktemp("port_actstore")
    write_dataset(str(root / "DS"), 2, (40, 56), seed=3)
    torch.manual_seed(3)
    pth = str(root / "w.pth")
    torch.save({"state_dict": Uformer(_small(
        img_size=IMG, embed_dim=8, dtype=torch.float32)).state_dict()}, pth)
    return root, pth


@pytest.fixture
def small_cli(monkeypatch):
    """The CLIs build their models with depths DEPTHS."""
    from dehaze_tpu_torch.cli import common

    monkeypatch.setattr(common, "ModelConfig", _small)


TINY = ["--embed_dim", "8", "--train_ps", "32", "--dtype", "float32",
        "--device", "cpu", "--seed", "5"]


def _eager(pth, act_store, h=40, w=56):
    from dehaze_tpu_torch.cli.common import build_model_and_params

    model = build_model_and_params(
        _small(img_size=IMG, embed_dim=8, dtype=torch.float32,
               act_store=act_store), pth, torch.device("cpu"))
    return make_whole_image_fn(
        lambda c: model(c, generator=torch.Generator().manual_seed(5)),
        h, w, IMG, square=False, device="cpu")


def test_test_long_act_store_equals_in_process(cli_setup, small_cli):
    """`cli.test_long --rect_canvas --act_store int8 --device cpu`: the
    per-image PSNRs of the in-process forward with act_store='int8', and
    not those of the plain forward."""
    from dehaze_tpu_torch.cli import test_long
    from dehaze_tpu_torch.data.pipeline import PairedFolder, val_images

    root, pth = cli_setup
    got = test_long.main(["--input_dir", str(root / "DS"), "--weights", pth,
                          "--rect_canvas", "--no-save_images",
                          "--act_store", "int8"] + TINY)
    runs = {mode: _eager(pth, mode) for mode in (None, "int8")}
    want = {mode: [] for mode in runs}
    for clean, hazy, _ in val_images(PairedFolder(str(root / "DS"))):
        for mode, run in runs.items():
            want[mode].append(float(TM.psnr(run(hazy[None])[0],
                                            torch.from_numpy(clean))))
    assert got["psnr"] == want["int8"]
    assert got["psnr"] != want[None]


def test_artifact_with_act_store_equals_eager(cli_setup, small_cli):
    """`cli.export --act_store fp8` on the CPU: the artifact equals the
    eager fp8 forward bit for bit, records the mode, and keeps it as the
    K2 operator's argument; the operator called without it (as in an
    artifact exported before the flag existed) computes plain LeFF."""
    from dehaze_tpu_torch.cli import export as cli_export

    root, pth = cli_setup
    art = str(root / "fp8.dhz")
    cli_export.main(["--weights", pth, "--height", "40", "--width", "56",
                     "--out", art, "--act_store", "fp8"] + TINY)
    fn, meta = E.load_exported(art, "cpu")
    assert meta["act_store"] == "fp8"
    x = np.random.default_rng(0).uniform(size=(1, 40, 56, 3)).astype(
        np.float32)
    assert torch.equal(fn(x), _eager(pth, "fp8")(x))
    ep, _ = E.load_program(art, "cpu")
    k2 = [n for n in ep.graph_module.graph.nodes
          if n.target is torch.ops.dehaze_tpu_torch.leff_fused.default]
    assert len(k2) == sum(DEPTHS) and all(n.args[11] == 1 for n in k2)

    xs, p = _leff_case()
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    args = [torch.from_numpy(xs)] + [tp[k] for k in (
        "ln_scale", "ln_bias", "w1", "b1", "dw_kernel", "dw_bias", "w2",
        "b2")] + [1e-5, False]
    plain = K2.leff_reference(torch.from_numpy(xs), **tp)
    assert torch.equal(torch.ops.dehaze_tpu_torch.leff_fused(*args), plain)
    assert torch.equal(torch.ops.dehaze_tpu_torch.leff_fused(*args, 1),
                       K2.leff_reference(torch.from_numpy(xs),
                                         act_store="fp8", **tp))
