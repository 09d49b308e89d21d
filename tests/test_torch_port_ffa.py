"""FFA-Net on the port against the JAX package, on the CPU.

Same inputs (made with numpy from a seed) go through `dehaze_tpu.models.
ffa` and `dehaze_tpu_torch.models.ffa`, with the JAX params carried across
from a seeded port init by the JAX package's own converter
(`convert_ffa_state_dict`): PALayer, CALayer, Block, Group and the whole
FFA (the hazy normalization on and off, and one bf16 case), the weight
bridge both ways and a reference `.pk`, the schedule and the
normalization, one `FFATrainer` step (L1, and L1 + perceptual on a seeded
VGG16) and one `Trainer` step with `--arch ffa`, and the banded native
forward on 2 gloo ranks against the one-process port and JAX's banded
forward on a 2-device mesh. Small sizes: 1-2 blocks, widths 16 and 64,
frames of 24×32 and less. Tolerances: f32 2e-4 unless a test states its
own.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dehaze_tpu import config as JC
from dehaze_tpu.models import ffa as JF
from dehaze_tpu.train import ffa_trainer as JFT
from dehaze_tpu.train import schedule as JSch
from dehaze_tpu.utils import convert_torch as CT
from dehaze_tpu_torch import config as TC
from dehaze_tpu_torch.infer import halo_sharded as thalo
from dehaze_tpu_torch.infer.tiled import make_native_image_fn
from dehaze_tpu_torch.models import get_arch
from dehaze_tpu_torch.models.ffa import FFA
from dehaze_tpu_torch.parallel.halo import Bands
from dehaze_tpu_torch.train import ffa_trainer as TFT
from dehaze_tpu_torch.train import schedule as TSch
from dehaze_tpu_torch.utils.convert import (ffa_state_dict_from_jax_params,
                                            load_weights)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


def _model(blocks=2, dim=16, seed=0, dtype=torch.float32):
    torch.manual_seed(seed)
    return FFA(blocks=blocks, dim=dim, dtype=dtype).eval()


def _params(model, blocks):
    """JAX params of a port model, copied: the converter's arrays share
    memory with the torch parameters, which a port step updates in
    place."""
    return jax.tree.map(lambda a: jnp.asarray(np.array(a)),
                        CT.convert_ffa_state_dict(model.state_dict(),
                                                  blocks=blocks))


def _img(shape, seed=1):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


# ----------------------------------------------------------------- layers

@pytest.mark.parametrize("layer", ["palayer", "calayer", "block", "group"])
def test_layers_match_jax(layer):
    """Each FFA layer against its flax module on the same params."""
    model = _model()
    params = _params(model, 2)
    x = _img((2, 12, 20, 16), seed=3) - 0.5
    port, flax_mod, p = {
        "palayer": (model.palayer, JF.PALayer(16), params["palayer"]),
        "calayer": (model.g1.gp[0].calayer, JF.CALayer(16),
                    params["g1"]["block_0"]["calayer"]),
        "block": (model.g1.gp[1], JF.Block(16), params["g1"]["block_1"]),
        "group": (model.g2, JF.Group(16, 2), params["g2"]),
    }[layer]
    want = np.asarray(flax_mod.apply({"params": p}, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("normalize", [True, False])
def test_ffa_matches_jax(normalize):
    """The whole FFA-Net (2 blocks, width 16) in f32 on the input the
    protocol gives it: with the normalization, the residual is added to
    the normalized hazy image, in both packages."""
    model = _model()
    x = _img((2, 24, 32, 3))
    jx = JFT.normalize_hazy(jnp.asarray(x)) if normalize else jnp.asarray(x)
    want = np.asarray(JF.FFA(blocks=2, dim=16).apply(
        {"params": _params(model, 2)}, jx))
    tx = torch.from_numpy(x)
    tx = TFT.normalize_hazy(tx) if normalize else tx
    with torch.no_grad():
        got = model(tx).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if normalize:  # x + residual with x normalized: far outside [0, 1]
        assert np.abs(got).max() > 2


def test_ffa_bf16_matches_jax_bf16():
    """bf16 activations over f32 params, against JAX's bf16 FFA: within
    0.05 absolute (the outputs are O(1); both round the 16 convs' inputs
    and the pooled means to bf16, at different points)."""
    model = _model(dtype=torch.bfloat16)
    x = _img((1, 24, 32, 3), seed=4)
    want = np.asarray(JF.FFA(blocks=2, dim=16, dtype=jnp.bfloat16).apply(
        {"params": _params(model, 2)}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.05)


def test_get_arch_builds_ffa_and_refuses_gps():
    cfg = TC.ModelConfig(arch="ffa", ffa_blocks=1, ffa_dim=16,
                         dtype=torch.float32)
    m = get_arch(cfg)
    assert isinstance(m, FFA) and len(m.g1.gp) == 2
    with pytest.raises(ValueError, match="ffa_gps must be 3"):
        get_arch(TC.replace(cfg, ffa_gps=2))
    # the Uformer's options do not concern FFA-Net (as in the JAX package)
    get_arch(TC.replace(cfg, token_projection="conv"))


# --------------------------------------------------------- weight bridge

def test_jax_params_round_trip_and_reference_pk(tmp_path):
    """JAX params → torch keys is the inverse of the JAX converter; a
    reference-format `.pk` (`module.` prefixes, numpy history beside the
    weights) loads strictly, and gives the JAX
    `load_reference_ffa_checkpoint`'s forward."""
    model = _model(blocks=1)
    sd = model.state_dict()
    back = ffa_state_dict_from_jax_params(CT.convert_ffa_state_dict(
        sd, blocks=1))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    pk = str(tmp_path / "ffa_best.pk")
    torch.save({"step": 5000, "max_psnr": np.float64(21.5),
                "max_ssim": np.float64(0.8), "psnrs": [np.float64(21.5)],
                "ssims": [np.float64(0.8)], "losses": [0.1],
                "model": {f"module.{k}": v for k, v in sd.items()}}, pk)
    fresh = FFA(blocks=1, dim=16).eval()
    fresh.load_state_dict(load_weights(pk, "ffa"), strict=True)
    x = _img((1, 16, 24, 3), seed=5)
    want = np.asarray(JF.FFA(blocks=1, dim=16).apply(
        {"params": jax.tree.map(jnp.asarray,
                                CT.load_reference_ffa_checkpoint(
                                    pk, blocks=1))}, jnp.asarray(x)))
    with torch.no_grad():
        got = fresh(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_schedule_and_normalize_match_jax():
    lr_t, lr_j = TSch.ffa_cosine_lr(1e-4, 1000), JSch.ffa_cosine_lr(1e-4,
                                                                    1000)
    for step in (0, 1, 250, 500, 999, 1000):
        np.testing.assert_allclose(lr_t(step), float(lr_j(step)),
                                   rtol=1e-6, atol=1e-12)
    x = _img((2, 5, 7, 3), seed=6)
    np.testing.assert_array_equal(
        TFT.normalize_hazy(torch.from_numpy(x)).numpy(),
        np.asarray(JFT.normalize_hazy(jnp.asarray(x))))
    np.testing.assert_array_equal(TFT.FFA_MEAN, JFT.FFA_MEAN)
    np.testing.assert_array_equal(TFT.FFA_STD, JFT.FFA_STD)


# ----------------------------------------------------------------- train

@pytest.fixture(scope="module")
def vgg16_npz(tmp_path_factory):
    from dehaze_tpu.cli.convert_vgg import convert
    from dehaze_tpu_torch.models.vgg import synthesize_torchvision_state_dict

    td = tmp_path_factory.mktemp("vgg16")
    torch.save(synthesize_torchvision_state_dict("vgg16", seed=2),
               td / "vgg16.pth")
    convert(str(td / "vgg16.pth"), str(td / "vgg16.npz"))
    return str(td / "vgg16.npz")


def _snapshot(model):
    return {k: p.detach().numpy().copy() for k, p in model.named_parameters()}


def hold_steps(model, port_step, jax_step, state, to_sd, lr, steps=2,
                b1=0.9):
    """Two steps on both sides from the same params, each held against
    JAX's: the loss within 1e-5 relative; every gradient leaf (JAX's read
    back from Adam's first moment, mu_t = b1 mu_(t-1) + (1 - b1) g_t)
    within 2e-4 of its largest entry; and the update itself, new − old,
    within 1e-3 relative, plus two f32 spacings of the weight (each side
    rounds its update into the weight, and from the second step on the
    weights differ by those roundings), on the weights that carry it:
    |g| ≥ 1e-6 (100 × Adam's eps; below, lr·g/(|g| + eps) turns the
    gradient's rounding into update noise) and ≥ 1e-6 of the leaf's
    largest, and on the second step an update of at least 0.1·lr (where
    the two steps' moments do not cancel); at least 3/4 of the leaves
    hold such weights on each step (a deep UNet level's gradients lie
    below the floor at these sizes). The first step moves each such weight by
    lr·(1 + wd·|p|) with the sign of -g, the second by a ratio of the
    moments: a missing or flipped update, an lr read a step late, lost
    weight decay or other betas all fall outside 1e-3."""
    named = dict(model.named_parameters())
    mu_old = g_old = None
    for _ in range(steps):
        old = _snapshot(model)
        jold = to_sd(jax.tree.map(np.array, state.params))  # donated below
        state, jloss = jax_step(state)
        loss = port_step()
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        mu = jax.tree.map(np.asarray, next(
            s for s in state.opt_state if hasattr(s, "mu")).mu)
        prev = jax.tree.map(np.zeros_like, mu) if mu_old is None else mu_old
        jg = to_sd(jax.tree.map(
            lambda m, m0: (m - np.float32(b1) * m0) / np.float32(1 - b1),
            mu, prev))
        jnew = to_sd(jax.tree.map(np.asarray, state.params))
        assert set(named) == set(jg)
        n_live = 0
        for name, p in named.items():
            g = jg[name].numpy()
            np.testing.assert_allclose(p.grad.numpy(), g, rtol=TOL,
                                       atol=TOL * max(np.abs(g).max(), 1e-3),
                                       err_msg=name)
            live = np.abs(g) >= max(1e-6, 1e-6 * np.abs(g).max())
            want = jnew[name].numpy() - jold[name].numpy()
            if g_old is not None:
                live &= np.abs(g_old[name]) >= 1e-6
                live &= np.abs(want) >= 0.1 * lr
            got = p.detach().numpy() - old[name]
            bad = live & (np.abs(got - want) > 1e-3 * np.abs(want)
                          + 2 * np.spacing(np.abs(old[name])))
            assert not bad.any(), (name, bad.sum(), got[bad][:4],
                                   want[bad][:4])
            n_live += bool(live.any())
        assert n_live >= 0.75 * len(named), (n_live, len(named))
        mu_old, g_old = mu, {k: v.numpy() for k, v in jg.items()}
    return state


@pytest.mark.parametrize("perceptual", [False, True])
def test_ffa_trainer_step_matches_jax(perceptual, vgg16_npz):
    """Two FFATrainer steps (Adam on the per-step cosine over 10 steps,
    L1, + 0.04 × the VGG16 perceptual loss on a seeded VGG16) against the
    JAX FFATrainer's, full width 64, one block per group, 24² crops: the
    loss, the gradients and the update of each step (`hold_steps`)."""
    lr = 1e-4
    rng = np.random.default_rng(8)
    clean = rng.integers(0, 256, size=(2, 24, 24, 3), dtype=np.uint8)
    hazy = np.clip(clean * 0.6 + 80, 0, 255).astype(np.uint8)
    kw = dict(blocks=1, lr=lr, total_steps=10, perceptual=perceptual,
              vgg_weights=vgg16_npz if perceptual else None)
    tr = TFT.FFATrainer(device="cpu", seed=3, **kw)
    jt = JFT.FFATrainer(**kw)
    params = _params(tr.model, 1)
    state = JFT.FFAState(step=jnp.zeros((), jnp.int32), params=params,
                         opt_state=jt.tx.init(params))
    new_state = hold_steps(
        tr.model, lambda: tr.train_step(clean, hazy),
        lambda st: jt.train_step(st, clean.astype(np.float32) / 255,
                                 hazy.astype(np.float32) / 255),
        state, ffa_state_dict_from_jax_params, lr)
    assert tr.step == 2 and int(new_state.step) == 2
    # evaluation: clamped output, batch PSNR/SSIM over n_valid rows
    p, s = tr.evaluate([(clean, hazy)], n_valid=1)
    jp, js = jt.evaluate(new_state.params,
                         iter([(clean.astype(np.float32) / 255,
                                hazy.astype(np.float32) / 255)]), n_valid=1)
    np.testing.assert_allclose((p, s), (jp, js), rtol=0, atol=2e-3)


def test_trainer_arch_ffa_step_matches_jax():
    """Two steps of `cli.train --arch ffa` (the Uformer recipe:
    Charbonnier, AdamW with weight decay 0.02, the epoch lr table over
    one-step epochs) against the JAX Trainer's with arch='ffa': no
    normalization, no sampling; Charbonnier only (`hold_steps`)."""
    from dehaze_tpu.train.trainer import Trainer as JaxTrainer
    from dehaze_tpu.train.trainer import TrainState
    from dehaze_tpu_torch.train.trainer import Trainer

    kw = dict(arch="ffa", img_size=32, ffa_blocks=1, ffa_dim=16)
    jcfg = JC.Config(model=JC.ModelConfig(dtype=jnp.float32, **kw),
                     loss=JC.LossConfig(w_contrast=0.0),
                     train=JC.TrainConfig(warmup=False))
    tcfg = TC.Config(model=TC.ModelConfig(dtype=torch.float32, remat=True,
                                          **kw),
                     loss=TC.LossConfig(w_contrast=0.0),
                     train=TC.TrainConfig(warmup=False))
    rng = np.random.default_rng(9)
    clean = rng.integers(0, 256, size=(2, 32, 32, 3), dtype=np.uint8)
    hazy = np.clip(clean * 0.6 + 80, 0, 255).astype(np.uint8)
    tr = Trainer(tcfg, steps_per_epoch=1, device="cpu")
    jt = JaxTrainer(jcfg, steps_per_epoch=1)
    params = _params(tr.model, 1)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=jt.tx.init(params))

    def jax_step(st):
        st, jm = jt.train_step(st, clean, hazy, jax.random.PRNGKey(1),
                               use_mixup=False)
        return st, jm["loss"]

    hold_steps(tr.model,
                lambda: tr.train_step(clean, hazy, use_mixup=False)["loss"],
                jax_step, state, ffa_state_dict_from_jax_params,
                tcfg.train.lr_initial)


# ---------------------------------------------------------------- banded

WORKER = r'''
import sys
import numpy as np, torch
torch.set_num_threads(1)
from dehaze_tpu_torch.infer import halo_sharded as H
from dehaze_tpu_torch.models.ffa import FFA
from dehaze_tpu_torch.parallel import dist

out_dir = sys.argv[1]
dist.init("cpu")
outs = {}
for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
    torch.manual_seed(0)
    model = FFA(blocks=1, dim=16, dtype=dtype).eval()
    img = np.random.default_rng(11).uniform(size=(2, 24, 20, 3)).astype(
        np.float32)
    outs[name] = H.make_halo_sharded_native_fn(model, device="cpu")(
        img).numpy()
if dist.rank() == 0:
    np.savez(f"{out_dir}/banded.npz", **outs)
dist.shutdown()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def banded(tmp_path_factory):
    """The banded outputs of 2 gloo ranks (one process each), started in
    the background when the module's tests begin."""
    td = tmp_path_factory.mktemp("ffa_bands")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(td)], cwd=str(td),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": _REPO, "OMP_NUM_THREADS": "1",
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
             "RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": str(r)})
        for r in range(2)]
    done = {}

    def get():
        if not done:
            try:
                for p in procs:
                    _, err = p.communicate(timeout=300)
                    assert p.returncode == 0, err[-3000:]
            finally:
                for p in procs:
                    p.kill()
            done.update(np.load(td / "banded.npz"))
        return done

    yield get
    for p in procs:
        p.kill()


def _banded_img():
    return np.random.default_rng(11).uniform(size=(2, 24, 20, 3)).astype(
        np.float32)


@pytest.mark.parametrize("name,tol", [("f32", 2e-5), ("bf16", 0.0625)])
def test_banded_native_equals_one_process(banded, name, tol):
    """Two bands of 12 rows against the one-process native forward: f32
    within 2e-5 (the pooled means are summed in another order); bf16
    within 0.0625 (the bands' means are rounded to bf16 before their
    average: a bf16 rounding of an O(1) pixel, the bar of the Uformer's
    bf16 bands on the card)."""
    torch.manual_seed(0)
    model = FFA(blocks=1, dim=16, dtype={"f32": torch.float32,
                                         "bf16": torch.bfloat16}[name]
                ).eval()
    ref = make_native_image_fn(model, device="cpu")(_banded_img()).numpy()
    got = banded()[name]
    assert got.shape == (2, 24, 20, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def test_banded_native_matches_jax_halo_sharded(banded):
    """The port's 2 bands against JAX's make_halo_sharded_native_fn on a
    2-device mesh (halo convs, pmean pools), f32."""
    from dehaze_tpu.infer.halo_sharded import make_halo_sharded_native_fn
    from dehaze_tpu.parallel.mesh import make_mesh

    cfg = JC.ModelConfig(arch="ffa", ffa_blocks=1, ffa_dim=16,
                         dtype=jnp.float32)
    variables = {"params": _params(_model(blocks=1), 1)}
    run = make_halo_sharded_native_fn(cfg, variables, make_mesh(2))
    want = np.asarray(run(_banded_img()))
    np.testing.assert_allclose(banded()["f32"], want, rtol=TOL, atol=TOL)


def test_banded_native_refusals():
    """FFA-only (the JAX wording), and rows must divide by the bands."""
    from dehaze_tpu_torch.models.unet import UNet

    with pytest.raises(ValueError, match="native banded inference is "
                                         "FFA-only.*arch='unet'"):
        thalo.make_halo_sharded_native_fn(UNet(dim=8), bands=Bands(0, 2),
                                          device="cpu")
    run = thalo.make_halo_sharded_native_fn(_model(blocks=1),
                                            bands=Bands(0, 2), device="cpu")
    with pytest.raises(ValueError, match="rows % bands == 0 \\(got 25 rows "
                                         "over 2 bands"):
        run(_img((1, 25, 20, 3)))
