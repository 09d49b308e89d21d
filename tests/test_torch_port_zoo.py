"""The classification zoo on the port against the JAX package, on the CPU.

Every family's port model (tiny widths, as `tests/test_zoo_models.py`
builds them) carries its weights to the JAX module through the JAX
package's own `convert_zoo_state_dict` (its bijection check holds the
names and shapes; the JAX variables' tree comes from `jax.eval_shape` of
the init, nothing compiled for it), BN running stats made non-trivial.
Then: the eval forward at 32², batch 2, f32 within 2e-4 (the ImageNet stem
at 64²); a train-mode forward (sd 0, no MC dropout) with its logits and
updated running stats; bf16 for a conv and a transformer family; the
latents the JAX modules `sow`; every registered size's names and shapes
from a model on the `meta` device; every registered name, alias and
refusal; the generators of MC dropout and drop_path; the state_dict
arithmetic; the checkpoints (`.pth.tar` round trip, a JAX `.msgpack`
read by `load`) and the JAX → port weight bridge. Images are NHWC for
JAX and NCHW for the port, whose taps are NCHW maps or [B, N, C] tokens.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dehaze_tpu.utils.convert_torch import convert_zoo_state_dict
from dehaze_tpu.zoo import arithmetic as JA
from dehaze_tpu.zoo import checkpoint as JCK
from dehaze_tpu.zoo import convnets as JCN
from dehaze_tpu.zoo import get_model as jax_get_model
from dehaze_tpu.zoo import list_models as jax_list_models
from dehaze_tpu.zoo import transformers as JTR
from dehaze_tpu_torch.utils.convert import zoo_state_dict_from_jax_variables
from dehaze_tpu_torch.zoo import arithmetic as TA
from dehaze_tpu_torch.zoo import checkpoint as TCK
from dehaze_tpu_torch.zoo import convnets as TCN
from dehaze_tpu_torch.zoo import get_model, list_models
from dehaze_tpu_torch.zoo import layers as TL
from dehaze_tpu_torch.zoo import transformers as TTR

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


# name → (class name, kwargs, image side); the same kwargs build the JAX
# module and the port's
CASES = {
    "resnet": ("ResNetZoo", dict(num_blocks=(1, 1, 1, 1)), 32),
    "resnext": ("ResNetZoo", dict(block="bottleneck", num_blocks=(1, 1, 1, 1),
                                  groups=2, width_per_group=8), 32),
    "preresnet": ("ResNetZoo", dict(num_blocks=(1, 1, 1, 1), style="pre",
                                    cblock="bngap"), 32),
    "preresnet_bottleneck": ("ResNetZoo", dict(
        block="bottleneck", num_blocks=(1, 1, 1, 1), style="pre",
        cblock="bngap"), 32),
    "seresnet": ("ResNetZoo", dict(num_blocks=(1, 1, 1, 1), gate="se"), 32),
    "cbamresnet": ("ResNetZoo", dict(num_blocks=(1, 1, 1, 1), gate="cbam"),
                   32),
    "resnet_smoothing_mlp": ("ResNetZoo", dict(
        num_blocks=(1, 1, 1, 1), num_sblocks=(1, 1, 1, 1), cblock="mlp"), 32),
    "resnet_stem": ("ResNetZoo", dict(num_blocks=(1, 1, 1, 1), stem=True),
                    64),
    "vgg": ("VGGZoo", dict(num_blocks=(1, 1, 1, 1, 1)), 32),
    "prevgg_smoothing": ("VGGZoo", dict(num_blocks=(1, 1, 1, 1, 1), pre=True,
                                        num_sblocks=(1, 0, 1, 0, 0),
                                        cblock="bngap"), 32),
    "alexnet": ("AlexNetZoo", dict(), 32),
    "alexnet_stem": ("AlexNetZoo", dict(stem=True, cblock="gap"), 64),
    "mobilenet": ("MobileNetZoo", dict(width_mult=0.25), 32),
    "vit": ("ViTZoo", dict(image_size=32, patch_size=8, depth=2, dim=32,
                           heads=2, dim_head=16, dim_mlp=64), 32),
    "pit": ("PiTZoo", dict(image_size=32, patch_size=4, stride=2,
                           dims=(16, 32, 64), depths=(1, 1, 1),
                           heads=(1, 2, 2), dims_head=(8, 8, 8),
                           dims_mlp=(32, 64, 64)), 32),
    # window 3 on maps 16, 8, 4, 2: every stage collapses (to 2, 2, 2, 2)
    "swin_collapse": ("SwinZoo", dict(depths=(2, 2, 2, 2),
                                      dims=(8, 16, 32, 64),
                                      heads=(1, 2, 4, 8),
                                      dims_mlp=(16, 32, 64, 128), dim_head=8,
                                      window_size=3, pools=(2, 2, 2, 2)), 32),
    # the registry's window 7 and pools on 32²: maps 8, 4, 2, 1
    "swin": ("SwinZoo", dict(depths=(2, 2, 2, 2), dims=(8, 16, 32, 64),
                             heads=(1, 2, 4, 8), dims_mlp=(16, 32, 64, 128),
                             dim_head=8), 32),
    "convit": ("ConViTZoo", dict(image_size=32, patch_size=4, depth=2, dim=16,
                                 heads=2, dim_head=8, dim_mlp=32), 32),
    "alternet": ("AlterNetZoo", dict(num_blocks=(1, 1, 2, 2),
                                     num_blocks2=(0, 0, 1, 1),
                                     heads=(1, 1, 2, 2), window_size=4,
                                     dim_head=8), 32),
    "mixer": ("MixerZoo", dict(image_size=32, patch_size=8, depth=2,
                               hidden_dim=32, spatial_dim=16,
                               channel_dim=64), 32),
}


def _modules(cls):
    for jm, tm in ((JCN, TCN), (JTR, TTR)):
        if hasattr(jm, cls):
            return getattr(jm, cls), getattr(tm, cls)
    raise KeyError(cls)


def _template(jmodel, side):
    k = jax.random.PRNGKey(0)
    return jax.eval_shape(lambda: jmodel.init(
        {"params": k, "dropout": k, "droppath": k},
        jnp.zeros((1, side, side, 3)), train=False))


def _pair(case, seed=0, dtype=torch.float32, jdtype=jnp.float32, **over):
    """(port model, JAX module, JAX variables, image side): a seeded port
    init with random BN stats, its weights carried to JAX."""
    cls, kw, side = CASES[case]
    kw = {**kw, **over}
    jcls, tcls = _modules(cls)
    torch.manual_seed(seed)
    model = tcls(dtype=dtype, **kw).eval()
    g = torch.Generator().manual_seed(seed + 1)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.rand(m.num_features, generator=g) - .5)
            m.running_var.copy_(torch.rand(m.num_features, generator=g) + .5)
            m.weight.data.copy_(torch.rand(m.num_features, generator=g) + .5)
            m.bias.data.copy_(torch.rand(m.num_features, generator=g) * .4
                              - .2)
    jmodel = jcls(dtype=jdtype, **kw)
    # copied: the converter's arrays share the torch tensors' memory, which
    # a train-mode forward of the port updates in place
    variables = jax.tree.map(lambda a: jnp.asarray(np.array(a)),
                             convert_zoo_state_dict(model.state_dict(),
                                                    _template(jmodel, side)))
    return model, jmodel, variables, side


def _x(side, batch=2, seed=3):
    return (np.random.default_rng(seed).standard_normal(
        (batch, side, side, 3)).astype(np.float32) * 0.5)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _jax_apply(jmodel, variables, x, **kw):
    return jax.jit(lambda v, a: jmodel.apply(v, a, **kw))(variables,
                                                         jnp.asarray(x))


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case):
    model, jmodel, variables, side = _pair(case)
    x = _x(side)
    want = np.asarray(_jax_apply(jmodel, variables, x, train=False))
    with torch.no_grad():
        got = model(_nchw(x)).numpy()
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", ["resnet", "preresnet_bottleneck",
                                  "cbamresnet", "prevgg_smoothing",
                                  "mobilenet", "alternet", "vit"])
def test_train_mode_forward_and_running_stats(case):
    """Train mode, sd 0, no MC dropout: the logits, and the running stats
    BN moved to (flax's momentum 0.9 ≙ torch's 0.1, the batch's biased
    variance on both sides)."""
    model, jmodel, variables, side = _pair(case)
    x = _x(side, batch=4)
    want, new = jax.block_until_ready(jax.jit(lambda v, a: jmodel.apply(
        v, a, train=True, mutable=["batch_stats"]))(variables,
                                                    jnp.asarray(x)))
    model.train()
    with torch.no_grad():
        got = model(_nchw(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    if "batch_stats" not in variables:
        return
    moved = convert_zoo_state_dict(model.state_dict(),
                                   jax.eval_shape(lambda: variables))
    flat_w = jax.tree_util.tree_leaves_with_path(new["batch_stats"])
    flat_g = dict(jax.tree_util.tree_leaves_with_path(moved["batch_stats"]))
    assert len(flat_w) == len(flat_g) > 0
    for path, leaf in flat_w:
        np.testing.assert_allclose(np.asarray(flat_g[path]), np.asarray(leaf),
                                   rtol=TOL, atol=TOL, err_msg=str(path))
    assert all(int(m.num_batches_tracked) == 1 for m in model.modules()
               if isinstance(m, torch.nn.BatchNorm2d))


@pytest.mark.parametrize("case,tol", [("resnet", 3e-2), ("vit", 3e-2)])
def test_bf16_forward_matches_jax(case, tol):
    """bf16 activations, f32 parameters cast at use: both round at every
    layer, XLA and torch at slightly different points inside the norms and
    the attention (the softmax and the statistics in f32 on both sides).
    The logits (|logit| <= 2) agree within `tol`, ~4 bf16 ulps at 1."""
    model, jmodel, variables, side = _pair(case, dtype=torch.bfloat16,
                                           jdtype=jnp.bfloat16)
    x = _x(side)
    want = np.asarray(_jax_apply(jmodel, variables, x, train=False),
                      np.float32)
    with torch.no_grad():
        got = model(_nchw(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("case", ["resnet", "pit", "swin"])
def test_taps_match_jax_intermediates(case):
    """The latents a forward appends to `taps`, against the JAX module's
    `intermediates` tap0, tap1, ... in count and value (NCHW maps
    against NHWC)."""
    model, jmodel, variables, side = _pair(case)
    x = _x(side)
    _, inter = jax.jit(lambda v, a: jmodel.apply(
        v, a, train=False, mutable=["intermediates"]))(variables,
                                                       jnp.asarray(x))
    inter = inter["intermediates"]
    want = [np.asarray(inter[f"tap{i}"][0]) for i in range(len(inter))]
    taps = []
    with torch.no_grad():
        model(_nchw(x), taps=taps)
    assert len(taps) == len(want) > 4
    for i, (g, w) in enumerate(zip(taps, want)):
        g = g.numpy()
        if g.ndim == 4:
            g = g.transpose(0, 2, 3, 1)
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=str(i))


def _shape_only(sd):
    """Each tensor as a zero-stride uint8 array of its shape (no memory)."""
    return {k: np.broadcast_to(np.zeros((), np.uint8), tuple(v.shape))
            for k, v in sd.items()}


# one registered size of each family, on CIFAR geometry where the family
# takes it
REGISTERED = ["resnet_dnn_18", "preresnet_dnn_50", "seresnet_dnn_18",
              "cbamresnet_dnn_18", "resnext_dnn_50", "wideresnet_dnn_50",
              "vgg_dnn_16", "prevgg_dnn_11", "alexnet_dnn", "mobilenet",
              "vit_ti", "pit_ti", "mixer_ti", "swin_t", "convit_ti",
              "alternet_18", "alternet_50"]


@pytest.mark.parametrize("name", REGISTERED)
def test_registered_sizes_names_and_shapes(name, monkeypatch):
    """The port model built on `meta` (no memory) against `jax.eval_shape`
    of the JAX init, through the JAX converter's own bijection check: every
    tensor of the port finds its JAX leaf with its shape, and no JAX leaf
    is left. The converter's last step (placing the numbers) records a
    shape instead, so nothing of the model's size is allocated."""
    # AlterNet's window 7 tiles none of its maps at 32² (both packages
    # refuse it); 4 does, as in the JAX package's parity cases
    kw = {"image_size": 32, **({"window_size": 4} if "alternet" in name
                               else {})}
    model = get_model(name, device="meta", **kw)
    assert model.registry_name == name
    assert all(p.device.type == "meta" for p in model.parameters())
    template = _template(jax_get_model(name, **kw), 32)
    monkeypatch.setattr(jnp, "asarray", lambda a, dtype=None:
                        jax.ShapeDtypeStruct(a.shape, dtype))
    out = convert_zoo_state_dict(_shape_only(model.state_dict()), template)
    monkeypatch.undo()
    assert jax.tree.structure(out) == jax.tree.structure(template)
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(template)):
        assert a.shape == b.shape
    n = sum(int(np.prod(b.shape)) for b in jax.tree.leaves(
        template["params"]))
    assert TCK.count_parameters(model) == n


def test_every_registered_name_constructs_and_refusals():
    names = list_models()
    assert names == jax_list_models() and len(names) > 150
    for name in names:
        m = get_model(name, device="meta")
        assert m.registry_name == name
    assert get_model("resnet_mcdo_18", device="meta").layer1[0].mc_rate == .3
    sm = get_model("seresnet_dnn_smoothing_34", device="meta")
    assert tuple(sm.num_sblocks) == (1, 1, 1, 1)
    nxt = get_model("resnext_dnn_101", device="meta")
    assert nxt.layer1[0].conv2["0"].groups == 32

    def shapes(n):
        return {k: tuple(v.shape) for k, v in
                get_model(n, device="meta").state_dict().items()}

    for alias, name in (("resnet_18", "resnet_dnn_18"),
                        ("vgg_11", "vgg_dnn_11"),
                        ("alexnet", "alexnet_dnn")):
        assert shapes(alias) == shapes(name)
    for bad in ("resnet_dnn_19", "not_a_model", "vit", "resnext_18",
                "Uformer_Informer", "swin_xl", "alternet_20"):
        kinds = []
        for fn in (jax_get_model, lambda n: get_model(n, device="meta")):
            try:
                fn(bad)
                kinds.append(None)
            except Exception as e:  # noqa: BLE001 — the kinds must agree
                kinds.append(type(e))
        assert kinds[0] is not None and kinds[0] is kinds[1], (bad, kinds)
    with pytest.raises(ValueError, match="get_arch"):
        get_model("Uformer_Informer")
    # block kwargs a family does not take are dropped, as in the JAX registry
    m = get_model("resnet_18", device="meta", image_size=32, sd=0.1)
    assert m.layer4[1].sd == pytest.approx(0.1)


def test_convit_padding_validation():
    model = TTR.ConViTZoo(image_size=16, patch_size=4, depth=1, dim=16,
                          heads=2, dim_head=8, dim_mlp=32, padding=0)
    with pytest.raises(ValueError, match="padding"):
        model(torch.zeros(1, 3, 16, 16))


def test_mc_dropout_generators():
    """An mcdo model is random in eval mode: the same generator seed gives
    the same logits, another seed other logits; no generator raises."""
    model = get_model("resnet_mcdo_18", num_classes=10).eval()
    x = _nchw(_x(32, batch=2))

    def run(seed):
        with torch.no_grad():
            return model(x, generators={
                "dropout": torch.Generator().manual_seed(seed)})

    a, b, c = run(5), run(5), run(6)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    with pytest.raises(ValueError, match="dropout"):
        model(x)


def test_drop_path_scale_and_generators():
    x = torch.ones(20000, 3, 2)
    g = torch.Generator().manual_seed(0)
    y = TL.drop_path(x, 0.25, True, {"droppath": g})
    vals = torch.unique(y)
    assert torch.allclose(vals, torch.tensor([0.0, 1 / 0.75]))
    assert abs(float(y.mean()) - 1.0) < 0.02       # E[y] = x
    assert torch.equal(y[:, 0, 0], y[:, 2, 1])     # one draw per sample
    kept = float((y[:, 0, 0] > 0).float().mean())
    assert abs(kept - 0.75) < 0.02
    assert TL.drop_path(x, 0.25, False, None) is x
    assert TL.drop_path(x, 0.0, True, None) is x
    with pytest.raises(ValueError, match="Generator"):
        TL.drop_path(x, 0.25, True, {})
    model = TCN.ResNetZoo(num_blocks=(1, 1, 1, 1), sd=0.5).train()
    inp = _nchw(_x(32))
    outs = [model(inp, generators={"droppath": torch.Generator()
                                   .manual_seed(s)}) for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                             outs[2])


def _sd(seed):
    torch.manual_seed(seed)
    return TCN.ResNetZoo(num_blocks=(1, 1, 1, 1), gate="cbam").state_dict()


def test_arithmetic_matches_jax():
    s1, s2 = _sd(1), _sd(2)
    tmpl = _template(JCN.ResNetZoo(num_blocks=(1, 1, 1, 1), gate="cbam"), 32)

    def jx(sd):
        return jax.tree.map(lambda a: jnp.asarray(np.array(a)),
                            convert_zoo_state_dict(sd, tmpl))

    j1, j2 = jx(s1), jx(s2)
    for fn in ("inner", "rad", "cos", "sin"):
        got = float(getattr(TA, fn)(s1, s2))
        want = float(getattr(JA, fn)(j1, j2))
        assert got == pytest.approx(want, rel=1e-5, abs=1e-7), fn
    assert float(TA.norm(s1)) == pytest.approx(float(JA.norm(j1)), rel=1e-6)
    # sin is 0 where cos rounds to 1 or above (|w|² exact in f32 here)
    one = {"w": torch.tensor([1e3, 0.0])}
    assert float(TA.cos(one, one)) == 1.0
    assert float(TA.sin(one, one)) == 0.0 == float(
        JA.sin({"w": jnp.asarray([1e3, 0.0])}, {"w": jnp.asarray([1e3, 0.0])}))
    for fn, args, jargs in (("add", (s1, s2), (j1, j2)),
                            ("diff", (s1, s2), (j1, j2)),
                            ("mul", (s1, 0.5), (j1, 0.5))):
        got = jx(getattr(TA, fn)(*args))
        want = getattr(JA, fn)(*jargs)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-7)
    with pytest.raises(KeyError):
        TA.inner(s1, {k: v for k, v in s2.items() if "layer4" not in k})


def test_jax_variables_bridge_round_trip():
    """Port state_dict → JAX converter → the port's inverse: every tensor
    exactly (num_batches_tracked to 0); a missing, extra or misshapen JAX
    leaf raises."""
    for case in ("cbamresnet", "mixer", "swin", "alternet", "pit"):
        model, _, variables, _ = _pair(case)
        sd = model.state_dict()
        back = zoo_state_dict_from_jax_variables(variables, model)
        assert set(back) == set(sd)
        for k, v in sd.items():
            want = torch.zeros_like(v) if k.endswith(
                "num_batches_tracked") else v
            assert torch.equal(back[k], want), (case, k)
    model, _, variables, _ = _pair("resnet")
    extra = {**variables, "params": {**variables["params"],
                                     "stray": {"kernel": np.zeros(3)}}}
    with pytest.raises(KeyError, match="stray"):
        zoo_state_dict_from_jax_variables(extra, model)
    short = {**variables, "params": {k: v for k, v in
                                     variables["params"].items()
                                     if k != "layer0_0"}}
    with pytest.raises(KeyError, match="layer0"):
        zoo_state_dict_from_jax_variables(short, model)
    bad = {**variables, "params": {**variables["params"], "layer0_0": {
        "kernel": np.zeros((3, 3, 3, 8), np.float32)}}}
    with pytest.raises(ValueError, match="shape"):
        zoo_state_dict_from_jax_variables(bad, model)


def test_checkpoint_pth_tar_round_trip(tmp_path):
    root = str(tmp_path / "ck")
    model, _, _, side = _pair("cbamresnet", seed=4)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model.train()
    model(_nchw(_x(side))).sum().backward()
    opt.step()
    path = TCK.save(model, "cifar10", "cbamresnet_dnn_18", "42",
                    optimizer=opt, root=root, epoch=7)
    assert path == os.path.join(root, "cifar10", "cbamresnet_dnn_18",
                                "cifar10_cbamresnet_dnn_18_42.pth.tar")
    payload = torch.load(path, weights_only=True)
    assert payload["name"] == "cbamresnet_dnn_18" and payload["epoch"] == 7
    fresh, _, _, _ = _pair("cbamresnet", seed=9)
    opt2 = torch.optim.SGD(fresh.parameters(), lr=0.1, momentum=0.9)
    TCK.load(fresh, "cifar10", "cbamresnet_dnn_18", "42", optimizer=opt2,
             root=root)
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    assert opt2.state_dict()["state"].keys() == opt.state_dict()[
        "state"].keys()
    snap = TCK.save_snapshot(model, "cifar10", "m", "1", "best", root=root)
    assert snap == os.path.join(root, "cifar10", "m", "cifar10_m_1",
                                "cifar10_m_1_best.pth.tar")
    TCK.load_snapshot(fresh, "cifar10", "m", "1", "best", root=root)
    # a reference save from a DataParallel model: `module.` prefixes
    torch.save({"name": "m", "state_dict": {f"module.{k}": v for k, v in
                                            model.state_dict().items()}},
               os.path.join(root, "cifar10", "m", "cifar10_m_dp.pth.tar"))
    TCK.load(fresh, "cifar10", "m", "dp", root=root)
    with pytest.raises(FileNotFoundError):
        TCK.load(fresh, "cifar10", "m", "nope", root=root)


def test_checkpoint_reads_jax_msgpack(tmp_path):
    """A JAX `zoo.checkpoint.save` `.msgpack` (no `.pth.tar` beside it)
    loads through the port's `load`, with the JAX model's forward."""
    root = str(tmp_path / "ck")
    model, jmodel, variables, side = _pair("alternet", seed=2)
    jvars = jax.tree.map(lambda a: jnp.asarray(np.array(a)), variables)
    JCK.save(jvars, "cifar10", "alternet_18", "7", root=root, epoch=3)
    fresh, _, _, _ = _pair("alternet", seed=11)
    TCK.load(fresh, "cifar10", "alternet_18", "7", root=root)
    x = _x(side)
    want = np.asarray(_jax_apply(jmodel, jvars, x, train=False))
    with torch.no_grad():
        got = fresh.eval()(_nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="optax"):
        TCK.load(fresh, "cifar10", "alternet_18", "7", root=root,
                 optimizer=torch.optim.SGD(fresh.parameters(), lr=0.1))


def test_stats_and_executive_time(capsys):
    model = get_model("alexnet", num_classes=10)
    line = TCK.stats(model, torch.zeros(2, 3, 32, 32))
    assert line.startswith("model: alexnet , params: ")
    assert line.endswith("output: [2, 10]")
    assert capsys.readouterr().out.strip() == line
    secs = TCK.measure_executive_time(model, size=(2, 3, 32, 32), n=3,
                                      chunk=2)
    assert 0.0 < secs < 10.0
    mc = get_model("alexnet_mcdo", num_classes=10)
    with pytest.raises(ValueError, match="dropout"):
        TCK.measure_executive_time(mc, n=1)
    assert TCK.measure_executive_time(
        mc, n=2, generators={"dropout": torch.Generator()}) > 0.0


def test_ensemble_logits_matches_jax():
    rng = np.random.default_rng(8)
    members = [rng.normal(size=(3, 10)).astype(np.float32) for _ in range(4)]
    want = np.asarray(JTR.ensemble_logits([jnp.asarray(m) for m in members]))
    got = TTR.ensemble_logits([torch.from_numpy(m) for m in members]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
