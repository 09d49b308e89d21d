"""The port's training path against the JAX package, on the CPU.

Same inputs (made with numpy from a seed) go through the JAX function and
its port: the K1 backward twin against JAX's v4 custom VJP (Pallas in
interpret mode), one train step against `Trainer._train_step_impl`, the
VGG19 CR loss, the metrics, the schedules, the augmentations and the data
pipeline, the `.pth` checkpoint through the JAX package's converter, and a
two-epoch `fit` with a resume. Small sizes: embed 8, 32² images, batch 2.
ProbSparse sampling is pinned on both sides, as in test_torch_port_model.
Tolerances: f32 2e-4 unless a test states its own.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dehaze_tpu import config as JC
from dehaze_tpu.data import augment as JA
from dehaze_tpu.data import pipeline as JP
from dehaze_tpu.data import synth as JS
from dehaze_tpu.models import vgg as JV
from dehaze_tpu.ops import losses as JL
from dehaze_tpu.ops import metrics as JM
from dehaze_tpu.ops import probsparse as PS
from dehaze_tpu.train import schedule as JSch
from dehaze_tpu.train.trainer import Trainer as JaxTrainer
from dehaze_tpu_torch import config as TC
from dehaze_tpu_torch.data import augment as TA
from dehaze_tpu_torch.data import pipeline as TP
from dehaze_tpu_torch.data import synth as TS
from dehaze_tpu_torch.models import vgg as TV
from dehaze_tpu_torch.ops import losses as TL
from dehaze_tpu_torch.ops import metrics as TM
from dehaze_tpu_torch.ops import probsparse as TPS
from dehaze_tpu_torch.ops.kernels.window_attention import (
    fused_window_attention)
from dehaze_tpu_torch.train import checkpoint as TCk
from dehaze_tpu_torch.train import schedule as TSch
from dehaze_tpu_torch.train.loop import fit
from dehaze_tpu_torch.train.trainer import Trainer
from dehaze_tpu_torch.utils.convert import state_dict_from_jax_params

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


# ------------------------------------------------------------ K1 backward

@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("use_mask", [False, True])
def test_k1_backward_twin_matches_jax_vjp(heads, use_mask):
    """probsparse_attention_bnc_bwd against jax.vjp of the Pallas v4 kernel
    (`_kernel_v4_bwd`, interpret mode): dq, dk, dv and dbias."""
    from dehaze_tpu.ops.pallas.window_attention import (
        fused_window_attention as jax_fused)

    B, N, D = 4, 64, 32
    C = heads * D
    nW = 2 if use_mask else 1
    rng = np.random.default_rng(heads * 10 + use_mask)
    q, k, v, g = (rng.normal(size=(B, N, C)).astype(np.float32) * s
                  for s in (0.3, 0.3, 0.3, 1.0))
    si = rng.integers(0, N, size=(N, PS.probsparse_u(N))).astype(np.int32)
    bias = rng.normal(size=(heads, N, N)).astype(np.float32) * 0.1
    region = (rng.integers(0, 9, size=(nW, N)).astype(np.int32)
              if use_mask else None)

    def jfn(q, k, v, b):
        return jax_fused(q, k, v, num_heads=heads, sample_idx=jnp.asarray(si),
                         rel_pos_bias=b,
                         sw_region=None if region is None
                         else jnp.asarray(region),
                         num_windows=nW, interpret=True, wtile=4, version=4)

    _, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v, bias)))
    want = vjp(jnp.asarray(g))
    got = TPS.probsparse_attention_bnc_bwd(
        *(torch.from_numpy(a) for a in (q, k, v, g)), num_heads=heads,
        sample_idx=torch.from_numpy(si), rel_pos_bias=torch.from_numpy(bias),
        sw_region=None if region is None else torch.from_numpy(region))
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL, err_msg=name)


def _k1_inputs(dtype, heads=2, shifted=True, seed=0, images=2):
    """q, k, v [images · nW, 16, heads · 4] and the bias, with nW = 4
    shifted windows (or 1 unshifted) per image."""
    from dehaze_tpu_torch.ops import window as TW

    rng = np.random.default_rng(seed)
    N, D = 16, 4
    region = torch.from_numpy(TW.shift_region_ids(8, 8, 4, 2)) \
        if shifted else None
    nW = 4 if shifted else 1
    q, k, v = (torch.tensor(rng.normal(size=(images * nW, N, heads * D)),
                            dtype=dtype, requires_grad=True)
               for _ in range(3))
    bias = torch.tensor(rng.normal(size=(heads, N, N)) * 0.1, dtype=dtype,
                        requires_grad=True)
    kw = dict(num_heads=heads, sample_idx=torch.from_numpy(rng.integers(
        0, N, size=(N, TPS.probsparse_u(N))).astype(np.int32)),
        sw_region=region, num_windows=nW)
    return q, k, v, bias, kw


@pytest.mark.parametrize("shifted", [False, True])
def test_autograd_function_gives_twin_gradients(shifted):
    """On CPU tensors, backward through fused_window_attention returns what
    probsparse_attention_bnc_bwd computes (and what autograd through the
    plain forward gives), for q, k, v and the bias."""
    q, k, v, bias, kw = _k1_inputs(torch.float32, shifted=shifted)
    out = fused_window_attention(q, k, v, rel_pos_bias=bias, **kw)
    g = torch.from_numpy(np.random.default_rng(1).normal(
        size=out.shape).astype(np.float32))
    out.backward(g)
    kw.pop("num_windows")
    twin = TPS.probsparse_attention_bnc_bwd(
        q.detach(), k.detach(), v.detach(), g, rel_pos_bias=bias.detach(),
        **kw)
    q2, k2, v2, b2 = (t.detach().clone().requires_grad_()
                      for t in (q, k, v, bias))
    TPS.probsparse_attention_bnc(q2, k2, v2, rel_pos_bias=b2, **kw
                                 ).backward(g)
    for got, want, auto in zip((q.grad, k.grad, v.grad, bias.grad), twin,
                               (q2.grad, k2.grad, v2.grad, b2.grad)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(got, auto, rtol=1e-5, atol=1e-6)


def test_k1_gradcheck_float64():
    """Finite differences in float64 agree with the backward over every
    element of q, k, v and the bias: one image of four shifted windows, two
    heads (the inputs are far from ties in the sparsity measure, so the
    selection holds)."""
    q, k, v, bias, kw = _k1_inputs(torch.float64, seed=3, images=1)
    assert torch.autograd.gradcheck(
        lambda q, k, v, b: fused_window_attention(q, k, v, rel_pos_bias=b,
                                                  **kw),
        (q, k, v, bias), eps=1e-6, atol=1e-5)


# -------------------------------------------------------------- train step

def _jax_cfg(**model):
    return JC.Config(model=JC.ModelConfig(img_size=IMG, embed_dim=8,
                                          dtype=jnp.float32, **model),
                     loss=JC.LossConfig(w_contrast=0.0),
                     train=JC.TrainConfig(warmup=False))


def _port_cfg(**model):
    return TC.Config(model=TC.ModelConfig(img_size=IMG, embed_dim=8,
                                          dtype=torch.float32, **model),
                     loss=TC.LossConfig(w_contrast=0.0),
                     train=TC.TrainConfig(warmup=False))


def _batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    clean = rng.integers(0, 256, size=(b, IMG, IMG, 3), dtype=np.uint8)
    hazy = np.clip(clean * 0.6 + 80, 0, 255).astype(np.uint8)
    return clean, hazy


def _jax_state(jt):
    """The JAX trainer's step-0 state for a seeded port init (the JAX
    package's own converter gives the params; no init is compiled)."""
    from dehaze_tpu.train.trainer import TrainState
    from dehaze_tpu.utils.convert_torch import convert_uformer_state_dict
    from dehaze_tpu_torch.models.uformer import Uformer

    torch.manual_seed(0)
    sd = Uformer(_port_cfg(drop_path_rate=0.0).model).state_dict()
    params = jax.tree.map(jnp.asarray, convert_uformer_state_dict(sd))
    return TrainState(step=jnp.zeros((), jnp.int32), params=params,
                      opt_state=jt.tx.init(params))


def test_train_step_matches_jax(pinned):
    """One Trainer.train_step against the JAX trainer's step: drop_path 0,
    no MixUp, Charbonnier only. Loss within 1e-5 relative; every gradient
    leaf within 2e-4; parameters after the AdamW step within 5e-4
    absolute: Adam's first step moves each weight by about ±lr (2e-4), so
    a near-zero gradient whose sign differs by rounding may land 4e-4
    away."""
    clean, hazy = _batch()
    jt = JaxTrainer(_jax_cfg(drop_path_rate=0.0), steps_per_epoch=1)
    state = _jax_state(jt)
    params = jax.tree.map(np.asarray, state.params)

    new_state, jm = jt.train_step(state, clean, hazy, jax.random.PRNGKey(1),
                                  use_mixup=False)
    jnew = state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                   new_state.params))
    # the gradient, read back from Adam's first moment: mu = (1 - b1) g
    mu = new_state.opt_state[0].mu
    jgrads = state_dict_from_jax_params(jax.tree.map(
        lambda m: np.asarray(m) / np.float32(1 - 0.9), mu))

    tr = Trainer(_port_cfg(drop_path_rate=0.0), steps_per_epoch=1,
                 device="cpu")
    tr.model.load_state_dict(state_dict_from_jax_params(params))
    m = tr.train_step(clean, hazy, use_mixup=False)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    named = dict(tr.model.named_parameters())
    assert set(named) == set(jgrads)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), jnew[name].numpy(),
                                   rtol=0, atol=5e-4, err_msg=name)
    assert tr.step == 1


def test_train_step_accumulation_and_mixup():
    """accum_steps=2 reuses the step's sampling tables in both microbatches
    and equals the full-batch step (Charbonnier only, drop_path 0); MixUp
    and the CR loss run and stay finite."""
    clean, hazy = _batch(1, b=4)
    grads = []
    for accum in (1, 2):
        tr = Trainer(_port_cfg(drop_path_rate=0.0), steps_per_epoch=1,
                     device="cpu")
        tr.train_step(clean, hazy, use_mixup=False, accum_steps=accum)
        grads.append({n: p.grad.clone()
                      for n, p in tr.model.named_parameters()})
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-4,
                                   atol=1e-7)
    cfg = TC.replace(_port_cfg(), loss=TC.LossConfig(w_contrast=1.0))
    with pytest.warns(UserWarning, match="RANDOM VGG"):
        tr = Trainer(cfg, steps_per_epoch=1, device="cpu")
    m = tr.train_step(clean, hazy, use_mixup=True)
    assert all(np.isfinite(float(v)) for v in m.values())
    assert float(m["contrast"]) > 0 and float(m["all_an"]) > 0


# --------------------------------------------------------- losses and VGG

@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    from dehaze_tpu.cli.convert_vgg import convert

    td = tmp_path_factory.mktemp("tvgg")
    sd = TV.synthesize_torchvision_state_dict("vgg19", seed=3)
    for key, t in JV.synthesize_torchvision_state_dict("vgg19", seed=3
                                                       ).items():
        assert torch.equal(sd[key], t), key
    torch.save(sd, td / "vgg19.pth")
    convert(str(td / "vgg19.pth"), str(td / "vgg19.npz"))
    return str(td / "vgg19.npz")


def test_vgg19_features_and_contrast_loss_match_jax(vgg_npz):
    rng = np.random.default_rng(5)
    a, p, n = (rng.uniform(size=(2, IMG, IMG, 3)).astype(np.float32)
               for _ in range(3))
    jm = JV.make_cr_vgg()
    jvars = JV.load_params_npz(jm, vgg_npz)
    tm = TV.load_params_npz(TV.make_cr_vgg(), vgg_npz)
    assert not any(t.requires_grad for t in tm.parameters())
    jf = [jm.apply(jvars, jnp.asarray(x)) for x in (a, p, n)]
    tf = [tm(torch.from_numpy(x)) for x in (a, p, n)]
    for jx, tx in zip(jf, tf):
        for j, t in zip(jx, tx):
            j = np.asarray(j)
            np.testing.assert_allclose(t.numpy(), j, rtol=TOL,
                                       atol=TOL * np.abs(j).max())
    for ablation in (False, True):
        want = JL.contrast_loss_from_features(*jf, ablation=ablation)
        got = TL.contrast_loss_from_features(*tf, ablation=ablation)
        for w, g in zip(want, got):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


def test_losses_match_jax():
    rng = np.random.default_rng(6)
    x, y = (rng.uniform(size=(2, IMG, IMG, 3)).astype(np.float32)
            for _ in range(2))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    for got, want in ((TL.charbonnier_loss(tx, ty),
                       JL.charbonnier_loss(jx, jy)),
                      (TL.tv_loss(tx), JL.tv_loss(jx)),
                      (TL.l1(tx, ty), JL.l1(jx, jy)),
                      (TL.perceptual_loss_from_features([tx, ty], [ty, tx]),
                       JL.perceptual_loss_from_features([jx, jy], [jy, jx]))):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_batch_psnr_ssim_match_jax():
    rng = np.random.default_rng(7)
    x = rng.uniform(size=(3, IMG, 40, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(size=x.shape).astype(np.float32) * 0.05,
                0, 1)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(
        TM.batch_psnr(tx, ty).numpy(),
        np.asarray(JM.batch_psnr(jnp.asarray(x), jnp.asarray(y))), rtol=1e-5)
    for dr in (1.0, 2.0):
        np.testing.assert_allclose(
            TM.batch_ssim(tx, ty, data_range=dr).numpy(),
            np.asarray(JM.batch_ssim(jnp.asarray(x), jnp.asarray(y),
                                     data_range=dr)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(TM.psnr(tx[0], ty[0])),
                               float(JM.psnr(jnp.asarray(x[0]),
                                             jnp.asarray(y[0]))), rtol=1e-5)


# ------------------------------------------------------ schedule and data

@pytest.mark.parametrize("warmup", [True, False])
def test_epoch_lr_table_equals_jax(warmup):
    jt = JC.TrainConfig(warmup=warmup, nepoch=40, step_size=7)
    tt = TC.TrainConfig(warmup=warmup, nepoch=40, step_size=7)
    np.testing.assert_array_equal(
        TSch.epoch_lr_table(TSch.make_epoch_lr(tt), 64),
        JSch.epoch_lr_table(JSch.make_epoch_lr(jt), 64))
    np.testing.assert_array_equal(
        TSch.epoch_lr_table(TSch.resume_cosine_lr(tt, 12, 1.5e-4), 64),
        JSch.epoch_lr_table(JSch.resume_cosine_lr(jt, 12, 1.5e-4), 64))


def test_mixup_with_pinned_draws_matches_jax(monkeypatch):
    rng = np.random.default_rng(8)
    gt, hz = (rng.uniform(size=(4, 8, 8, 3)).astype(np.float32)
              for _ in range(2))
    lam = np.array([0.2, 0.9, 0.5, 0.7], np.float32)
    perm = np.array([2, 0, 3, 1])
    draw = TA.mixup_draw
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, b: jnp.asarray(perm))
    monkeypatch.setattr(jax.random, "beta",
                        lambda key, a, b, shape: jnp.asarray(
                            lam.reshape(shape)))
    monkeypatch.setattr(TA, "mixup_draw", lambda b, beta, g: (lam, perm))
    want = JA.mixup(jax.random.PRNGKey(0), jnp.asarray(gt), jnp.asarray(hz))
    got = TA.mixup(None, torch.from_numpy(gt), torch.from_numpy(hz))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    lam2, perm2 = draw(6, 1.2, torch.Generator().manual_seed(0))
    assert sorted(perm2.tolist()) == list(range(6))
    assert lam2.shape == (6,) and ((lam2 > 0) & (lam2 < 1)).all()


def test_dihedral_and_crop_plan_equal_jax():
    img = np.arange(5 * 7 * 3, dtype=np.uint8).reshape(5, 7, 3)
    for k in range(8):
        np.testing.assert_array_equal(TA.dihedral(img, k),
                                      JA.dihedral(img, k))
    for seed in range(5):
        assert TA.crop_augment_plan(seed, 48, 40, 32) == \
            JA.crop_augment_plan(seed, 48, 40, 32)


@pytest.fixture(scope="module")
def synth_dirs(tmp_path_factory):
    td = tmp_path_factory.mktemp("tsynth")
    TS.write_dataset(str(td / "train"), 6, 40, seed=1)
    TS.write_dataset(str(td / "val"), 3, IMG, seed=2)
    return str(td / "train"), str(td / "val")


def test_synth_and_train_batches_equal_jax(synth_dirs):
    """The same scenes from one seed, and the same batches: order, crops and
    dihedrals (JAX decodes the port's PNGs with cv2)."""
    for a, b in zip(TS.make_scene(np.random.default_rng(3), (24, 40)),
                    JS.make_scene(np.random.default_rng(3), (24, 40))):
        np.testing.assert_array_equal(a, b)
    tf, jf = TP.PairedFolder(synth_dirs[0]), JP.PairedFolder(synth_dirs[0])
    kw = dict(batch_size=4, patch_size=IMG, seed=5, epoch=2, num_workers=2,
              u8=True)
    got = list(TP.train_batches(tf, **kw))
    want = list(JP.train_batches(jf, process_index=0, process_count=1, **kw))
    assert len(got) == len(want) == 2
    for (gc, gn), (wc, wn) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gn, wn)


# ------------------------------------------------- checkpoint and the loop

def test_pth_checkpoint_read_by_jax_converter(tmp_path, pinned):
    """A port checkpoint is the reference's `.pth`: the JAX package's
    `load_reference_checkpoint` reads it into params whose forward equals
    the port's."""
    from dehaze_tpu.models.uformer import Uformer as JaxUformer
    from dehaze_tpu.utils.convert_torch import load_reference_checkpoint

    tr = Trainer(_port_cfg(), steps_per_epoch=1, device="cpu")
    clean, hazy = _batch(2)
    tr.train_step(clean, hazy, use_mixup=False)
    path = str(tmp_path / "epoch_model_3.pth")
    TCk.save_checkpoint(path, 3, tr.model.state_dict(), tr.opt.state_dict(),
                        extra={"psnr": 12.5})
    payload = TCk.load_checkpoint(path)
    assert TCk.load_start_epoch(path) == 3 and payload["extra"]["psnr"] == 12.5
    assert payload["optimizer"]["state"]
    params = load_reference_checkpoint(path)
    x = hazy.astype(np.float32) / 255.0
    jm = JaxUformer(JC.ModelConfig(img_size=IMG, embed_dim=8,
                                   dtype=jnp.float32))
    want = jax.jit(lambda p, x: jm.apply(
        {"params": p}, x, train=False,
        rngs={"sample": jax.random.PRNGKey(0)}))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    with torch.no_grad():
        got = tr.model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_fit_two_epochs_with_resume(synth_dirs, tmp_path):
    """fit stops after epoch 1 (--exit_after 1); a resume from
    epoch_model_1.pth runs epoch 2 with the optimizer restored, keeps the
    best tracker and the checkpoints."""
    train_dir, val_dir = synth_dirs
    cfg = TC.Config(
        model=TC.ModelConfig(img_size=IMG, embed_dim=8, dtype=torch.float32),
        loss=TC.LossConfig(w_contrast=0.0),
        data=TC.DataConfig(train_dir=train_dir, val_dir=val_dir,
                           train_ps=IMG, batch_size=2, num_workers=2),
        train=TC.TrainConfig(nepoch=2, warmup=False, exit_after=1,
                             save_dir=str(tmp_path), env="_t"))
    best, best_path = fit(cfg, device="cpu")
    models = tmp_path / "uformer_t" / "models"
    assert os.path.exists(models / "epoch_model_1.pth")
    assert not os.path.exists(models / "epoch_model_2.pth")
    assert best > 0 and os.path.exists(best_path)
    payload = TCk.load_checkpoint(str(models / "epoch_model_1.pth"))
    assert payload["epoch"] == 1 and payload["optimizer"]["state"]

    cfg2 = TC.replace(cfg, train=TC.replace(
        cfg.train, resume=True, exit_after=0,
        pretrain_weights=str(models / "epoch_model_1.pth")))
    best2, _ = fit(cfg2, device="cpu")
    assert os.path.exists(models / "epoch_model_2.pth")
    assert best2 >= best
    assert TCk.load_checkpoint(best_path)["extra"]["psnr"] == best2
    logs = "".join(open(f).read() for f in glob.glob(
        str(tmp_path / "uformer_t" / "*.txt")))
    assert "Resuming from epoch 2" in logs and "Input & GT" in logs
    events = [json.loads(ln) for f in glob.glob(
        str(tmp_path / "uformer_t" / "*.jsonl")) for ln in open(f)]
    epochs = [e for e in events if e["kind"] == "epoch"]
    assert sorted(e["epoch"] for e in epochs) == [1, 2]
    assert all(len(e["step_losses"]) == 3 and np.isfinite(e["loss"])
               for e in epochs)
    assert sum(e["kind"] == "eval" for e in events) == 6


def test_cli_train_flags_and_refusals():
    from dehaze_tpu_torch.cli.common import add_common_args, config_from_args
    import argparse

    p = add_common_args(argparse.ArgumentParser())
    cfg = config_from_args(p.parse_args(
        ["--embed_dim", "8", "--train_ps", "32", "--dtype", "float32",
         "--w_loss_vgg7", "0", "--batch_size", "4", "--nepoch", "3",
         "--accum_steps", "2", "--keep_ckpts", "1"]))
    assert cfg.model.embed_dim == 8 and cfg.model.dtype == torch.float32
    assert cfg.loss.w_contrast == 0 and cfg.data.batch_size == 4
    assert cfg.train.nepoch == 3 and cfg.train.accum_steps == 2
    assert cfg.train.lr_initial == 2e-4 and cfg.train.weight_decay == 0.02
    assert not cfg.model.remat and not cfg.data.device_data
    cfg = config_from_args(p.parse_args(["--remat", "--device_data"]))
    assert cfg.model.remat and cfg.data.device_data
    cfg = config_from_args(p.parse_args(["--data_axis", "2"]))
    assert cfg.train.data_axis == 2
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
        fit(cfg, device="cpu")  # no process group of 2 ranks
