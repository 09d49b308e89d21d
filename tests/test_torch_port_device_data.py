"""The port's device-resident training data (`--device_data`) against the
JAX package and against the port's own streaming pipeline, on the CPU.

Mirrors tests/test_device_data.py: the index-map dihedral against JAX's
`dihedral_dev` and the NumPy `dihedral`; `epoch_schedule_arrays` and
`load_all_pairs` equal to the JAX package's; the gathered batches equal to
`train_batches`' for a whole epoch; `Trainer.train_step_data` equal to
`train_step` on the streaming batch bit for bit, and to the JAX data step
with ProbSparse sampling pinned (f32 2e-4, as test_torch_port_train; at
the depths `JAX_DEPTHS`, one block a stage and two in the first and last,
so that the JAX step compiles in about 60% of the full depth's time: the
data step's gather is the same for every block, and the streaming step is
held to JAX at full depth in test_torch_port_train); the
refusals; and `cli.train --device_data --remat` for one epoch, whose step
losses equal the streaming run's. Small sizes: embed 8, 32² crops of 40²
or 48² images.
"""

import glob
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dehaze_tpu import config as JC
from dehaze_tpu.data import augment as JA
from dehaze_tpu.data import pipeline as JP
from dehaze_tpu.ops import probsparse as PS
from dehaze_tpu.train.trainer import Trainer as JaxTrainer
from dehaze_tpu_torch import config as TC
from dehaze_tpu_torch.data import augment as TA
from dehaze_tpu_torch.data import pipeline as TP
from dehaze_tpu_torch.data.synth import write_dataset
from dehaze_tpu_torch.ops import probsparse as TPS
from dehaze_tpu_torch.train.trainer import Trainer
from dehaze_tpu_torch.utils.convert import state_dict_from_jax_params

TOL = 2e-4
IMG = 32
JAX_DEPTHS = (2, 1, 1, 1, 1, 1, 1, 1, 2)


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


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_devdata")
    write_dataset(str(root / "train"), 10, 48, seed=11)
    write_dataset(str(root / "val"), 3, IMG, seed=12)
    return str(root / "train"), str(root / "val")


@pytest.mark.parametrize("k", range(8))
def test_index_map_dihedral_equals_jax_and_numpy(k):
    img = np.arange(6 * 6 * 3, dtype=np.uint8).reshape(6, 6, 3)
    maps = TA.dihedral_index_maps(6)
    got = TA.gather_crops(torch.from_numpy(img)[None],
                          torch.tensor([[0, 0, 0, k]], dtype=torch.int32),
                          maps)[0].numpy()
    np.testing.assert_array_equal(got, TA.dihedral(img, k))
    want = jax.jit(JA.dihedral_dev)(jnp.asarray(img), jnp.int32(k))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("n,hw,bs,ps,seed,epoch", [
    (10, (48, 48), 4, 32, 3, 2),    # wrap-padded last batch of 2
    (12, (48, 40), 4, 32, 0, 1),    # whole batches, H != W
    (7, (32, 32), 3, 32, 9, 5),     # patch = image: no crop draws
    (5, (64, 48), 8, 16, 1, 3),     # one batch, wrap-padded from 5 rows
])
def test_epoch_schedule_arrays_equal_jax(n, hw, bs, ps, seed, epoch):
    got = TP.epoch_schedule_arrays(n, hw, bs, ps, seed, epoch)
    want = JP.epoch_schedule_arrays(n, hw, bs, ps, seed, epoch)
    assert got.dtype == np.int32 and got.shape == (-(-n // bs), bs, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("u8", [True, False])
def test_load_all_pairs_equals_jax(dirs, u8):
    got = TP.load_all_pairs(TP.PairedFolder(dirs[0]), u8=u8, num_workers=2)
    want = JP.load_all_pairs(JP.PairedFolder(dirs[0]), u8=u8, num_workers=2)
    for g, w in zip(got, want):
        assert g.shape == (10, 48, 48, 3)
        assert g.dtype == (np.uint8 if u8 else np.float32) == w.dtype
        np.testing.assert_array_equal(g, w)


def test_gathered_batches_equal_train_batches(dirs):
    """Every batch of an epoch, the wrap-padded last one included, gathered
    from the stacked arrays equals the streaming pipeline's batch."""
    folder = TP.PairedFolder(dirs[0])
    bs, seed, epoch = 4, 3, 2
    host = list(TP.train_batches(folder, batch_size=bs, patch_size=IMG,
                                 seed=seed, epoch=epoch, num_workers=2,
                                 u8=True))
    all_c, all_n = (torch.from_numpy(a) for a in
                    TP.load_all_pairs(folder, u8=True, num_workers=2))
    sched = TP.epoch_schedule_arrays(len(folder), (48, 48), bs, IMG, seed,
                                     epoch)
    maps = TA.dihedral_index_maps(IMG)
    assert len(sched) == len(host) == 3
    for rows, (hc, hn) in zip(sched, host):
        rows = torch.from_numpy(rows)
        np.testing.assert_array_equal(
            TA.gather_crops(all_c, rows, maps).numpy(), hc)
        np.testing.assert_array_equal(
            TA.gather_crops(all_n, rows, maps).numpy(), hn)


def _port_cfg(**model):
    return TC.Config(model=TC.ModelConfig(img_size=IMG, embed_dim=8,
                                          dtype=torch.float32, **model),
                     loss=TC.LossConfig(w_contrast=0.0),
                     data=TC.DataConfig(train_ps=IMG, batch_size=4),
                     train=TC.TrainConfig(warmup=False))


def test_train_step_data_equals_train_step(dirs):
    """The data step and the streaming step, from one seed, on the same
    batch: loss, every gradient, every parameter after AdamW and every
    generator's state bit for bit (drop_path 0.1, MixUp on, unpinned
    sampling)."""
    folder = TP.PairedFolder(dirs[0])
    hc, hn = next(iter(TP.train_batches(folder, batch_size=4,
                                        patch_size=IMG, seed=5, epoch=1,
                                        num_workers=2, u8=True)))
    all_c, all_n = (torch.from_numpy(a) for a in
                    TP.load_all_pairs(folder, u8=True, num_workers=2))
    sched = TP.epoch_schedule_arrays(len(folder), (48, 48), 4, IMG, 5, 1)
    runs = []
    for data in (False, True):
        tr = Trainer(_port_cfg(), steps_per_epoch=3, device="cpu")
        m = (tr.train_step_data(all_c, all_n, sched[0], use_mixup=True)
             if data else tr.train_step(hc, hn, use_mixup=True))
        runs.append((m, tr))
    (m1, t1), (m2, t2) = runs
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    p2 = dict(t2.model.named_parameters())
    for name, p in t1.model.named_parameters():
        assert torch.equal(p.grad, p2[name].grad), name
        assert torch.equal(p, p2[name]), name
    for g in ("sample_gen", "droppath_gen", "dropout_gen", "mixup_gen"):
        assert torch.equal(getattr(t1, g).get_state(),
                           getattr(t2, g).get_state()), g


def test_train_step_data_matches_jax(dirs, pinned):
    """One `train_step_data` against the JAX `train_step_data` on the same
    arrays and schedule rows: drop_path 0, no MixUp, Charbonnier only.
    Loss within 1e-5 relative, every gradient leaf within 2e-4, parameters
    after AdamW within 5e-4 (test_torch_port_train's bars)."""
    from dehaze_tpu.train.trainer import TrainState
    from dehaze_tpu.utils.convert_torch import convert_uformer_state_dict

    all_c, all_n = TP.load_all_pairs(TP.PairedFolder(dirs[0]), u8=True,
                                     num_workers=2)
    sched = TP.epoch_schedule_arrays(10, (48, 48), 2, IMG, 7, 1)[0]
    jcfg = JC.Config(model=JC.ModelConfig(img_size=IMG, embed_dim=8,
                                          dtype=jnp.float32,
                                          depths=JAX_DEPTHS,
                                          drop_path_rate=0.0),
                     loss=JC.LossConfig(w_contrast=0.0),
                     data=JC.DataConfig(train_ps=IMG, batch_size=2),
                     train=JC.TrainConfig(warmup=False))
    jt = JaxTrainer(jcfg, steps_per_epoch=1)
    tr = Trainer(TC.replace(_port_cfg(drop_path_rate=0.0,
                                      depths=JAX_DEPTHS),
                            data=TC.DataConfig(train_ps=IMG, batch_size=2)),
                 steps_per_epoch=1, device="cpu")
    params = jax.tree.map(jnp.asarray, convert_uformer_state_dict(
        tr.model.state_dict(), depths=JAX_DEPTHS))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=jt.tx.init(params))
    new_state, jm = jt.train_step_data(state, jnp.asarray(all_c),
                                       jnp.asarray(all_n), sched,
                                       jax.random.PRNGKey(1),
                                       use_mixup=False)
    jnew = state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                   new_state.params))
    jgrads = state_dict_from_jax_params(jax.tree.map(
        lambda m: np.asarray(m) / np.float32(1 - 0.9),
        new_state.opt_state[0].mu))

    m = tr.train_step_data(torch.from_numpy(all_c), torch.from_numpy(all_n),
                           sched, use_mixup=False)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    named = dict(tr.model.named_parameters())
    assert set(named) == set(jgrads)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), jnew[name].numpy(),
                                   rtol=0, atol=5e-4, err_msg=name)


def test_load_all_pairs_rejects_mixed_sizes(tmp_path):
    write_dataset(str(tmp_path / "a"), 1, 32, seed=0)
    write_dataset(str(tmp_path / "b"), 1, 48, seed=0)
    root = tmp_path / "mix"
    for sub in ("gt", "hazy"):
        os.makedirs(root / sub)
        shutil.copy(tmp_path / "a" / sub / "00000.png", root / sub / "0.png")
        shutil.copy(tmp_path / "b" / sub / "00000.png", root / sub / "1.png")
    with pytest.raises(ValueError, match="uniform image sizes"):
        TP.load_all_pairs(TP.PairedFolder(str(root)), u8=True)


def test_device_data_refuses_accum_steps(dirs, tmp_path):
    """The JAX data step runs one microbatch whatever --accum_steps says;
    the port refuses the combination instead."""
    from dehaze_tpu_torch.cli import train

    with pytest.raises(ValueError,
                       match="--device_data with --accum_steps 2"):
        train.main(["--device", "cpu", "--device_data", "--accum_steps", "2",
                    "--train_dir", dirs[0], "--val_dir", dirs[1],
                    "--save_dir", str(tmp_path)])


def _events(log_dir):
    return [json.loads(ln) for f in glob.glob(os.path.join(log_dir,
                                                           "*.jsonl"))
            for ln in open(f)]


def test_cli_train_device_data_remat_equals_streaming(dirs, tmp_path,
                                                      capsys):
    """`cli.train --device_data --remat --device cpu`, one epoch at embed
    8 (drop_path 0.1, unpinned sampling), logs the resident dataset and
    gives the streaming run's step losses and evals bit for bit."""
    from dehaze_tpu_torch.cli import train

    common = ["--device", "cpu", "--embed_dim", "8", "--train_ps", str(IMG),
              "--dtype", "float32", "--w_loss_vgg7", "0", "--batch_size",
              "4", "--nepoch", "1", "--train_workers", "2", "--train_dir",
              dirs[0], "--val_dir", dirs[1], "--save_dir", str(tmp_path)]
    train.main(common + ["--env", "_s"])
    train.main(common + ["--env", "_d", "--device_data", "--remat"])
    assert "best PSNR" in capsys.readouterr().out
    stream = _events(str(tmp_path / "uformer_s"))
    data = _events(str(tmp_path / "uformer_d"))
    epochs = [next(e for e in ev if e["kind"] == "epoch")
              for ev in (stream, data)]
    assert len(epochs[0]["step_losses"]) == 3
    assert all(np.isfinite(epochs[1]["step_losses"]))
    assert epochs[0]["step_losses"] == epochs[1]["step_losses"]
    assert ([e["psnr"] for e in stream if e["kind"] == "eval"]
            == [e["psnr"] for e in data if e["kind"] == "eval"])
    text = "".join(open(f).read() for f in glob.glob(
        str(tmp_path / "uformer_d" / "*.txt")))
    assert "device-resident dataset: (10, 48, 48, 3) ×2 torch.uint8 on cpu" \
        in text
    assert os.path.exists(tmp_path / "uformer_d" / "models" /
                          "model_best.pth")
