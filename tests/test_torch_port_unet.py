"""The residual conv UNet on the port against the JAX package, on the CPU:
the forward (width 8, f32) against `dehaze_tpu.models.unet` with the
params carried across by the JAX package's converter
(`convert_unet_state_dict`, whose `_deconv` flips torch's transposed-conv
layout into JAX's), the weight bridge both ways and a reference `.pth`,
one `Trainer` step with `--arch unet` against the JAX Trainer's,
`cli.train --arch unet` end to end, `cli.test_long --arch unet` (the
canvas protocol) against the JAX CLI, and `cli.export --arch unet` bit
for bit against the eager forward. Tolerances: f32 2e-4; PSNR 1e-3 dB and
SSIM 1e-4 against the JAX CLI (which prints 4 decimals).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dehaze_tpu import config as JC
from dehaze_tpu.models.unet import UNet as JUNet
from dehaze_tpu.utils import convert_torch as CT
from dehaze_tpu_torch import config as TC
from dehaze_tpu_torch.cli import export as cli_export
from dehaze_tpu_torch.cli import test_long
from dehaze_tpu_torch.data.images import load_img
from dehaze_tpu_torch.data.synth import write_dataset
from dehaze_tpu_torch.infer.export import load_exported
from dehaze_tpu_torch.infer.tiled import make_whole_image_fn
from dehaze_tpu_torch.models import get_arch
from dehaze_tpu_torch.models.unet import UNet
from dehaze_tpu_torch.utils.convert import (load_weights,
                                            unet_state_dict_from_jax_params)

TOL = 2e-4
UNET_FLAGS = ["--arch", "unet", "--embed_dim", "8", "--train_ps", "32",
              "--dtype", "float32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(seed=1):
    torch.manual_seed(seed)
    return UNet(dim=8).eval()


def test_unet_matches_jax():
    model = _model()
    params = jax.tree.map(jnp.asarray, CT.convert_unet_state_dict(
        model.state_dict()))
    x = np.random.default_rng(1).uniform(size=(2, 32, 48, 3)).astype(
        np.float32)
    want = np.asarray(JUNet(dim=8).apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert isinstance(get_arch(TC.ModelConfig(arch="unet", embed_dim=8)),
                      UNet)


def test_jax_params_round_trip_and_reference_pth(tmp_path):
    """JAX params → torch keys inverts the JAX converter (the transposed
    convs unflipped to torch's layout); a reference `.pth` with
    DataParallel prefixes loads strictly."""
    model = _model(2)
    sd = model.state_dict()
    back = unet_state_dict_from_jax_params(CT.convert_unet_state_dict(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    pth = str(tmp_path / "unet.pth")
    torch.save({"epoch": 3, "state_dict": {f"module.{k}": v
                                           for k, v in sd.items()}}, pth)
    fresh = UNet(dim=8)
    fresh.load_state_dict(load_weights(pth, "unet"), strict=True)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_trainer_arch_unet_step_matches_jax():
    """Two steps of `cli.train --arch unet` (Charbonnier, AdamW at lr 2e-4
    with weight decay 0.02, the epoch lr table over one-step epochs)
    against the JAX Trainer's with arch='unet': the loss, the gradients
    and the update of each step, within the bounds of `hold_steps`."""
    from dehaze_tpu.train.trainer import Trainer as JaxTrainer
    from dehaze_tpu.train.trainer import TrainState
    from dehaze_tpu_torch.train.trainer import Trainer
    from test_torch_port_ffa import hold_steps

    kw = dict(arch="unet", img_size=32, embed_dim=8)
    jcfg = JC.Config(model=JC.ModelConfig(dtype=jnp.float32, **kw),
                     loss=JC.LossConfig(w_contrast=0.0),
                     train=JC.TrainConfig(warmup=False))
    tcfg = TC.Config(model=TC.ModelConfig(dtype=torch.float32, **kw),
                     loss=TC.LossConfig(w_contrast=0.0),
                     train=TC.TrainConfig(warmup=False))
    rng = np.random.default_rng(9)
    clean = rng.integers(0, 256, size=(2, 32, 32, 3), dtype=np.uint8)
    hazy = np.clip(clean * 0.6 + 80, 0, 255).astype(np.uint8)
    tr = Trainer(tcfg, steps_per_epoch=1, device="cpu")
    jt = JaxTrainer(jcfg, steps_per_epoch=1)
    # copied: the converter's arrays share the torch parameters' memory
    params = jax.tree.map(lambda a: jnp.asarray(np.array(a)),
                          CT.convert_unet_state_dict(tr.model.state_dict()))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=jt.tx.init(params))

    def jax_step(st):
        st, jm = jt.train_step(st, clean, hazy, jax.random.PRNGKey(1),
                               use_mixup=False)
        return st, jm["loss"]

    hold_steps(tr.model,
               lambda: tr.train_step(clean, hazy, use_mixup=False)["loss"],
               jax_step, state, unet_state_dict_from_jax_params,
               tcfg.train.lr_initial)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("unet_cli")
    pth = str(root / "unet.pth")
    torch.save({"state_dict": _model(3).state_dict()}, pth)
    write_dataset(str(root / "DS"), 2, (24, 40), seed=5)
    write_dataset(str(root / "train"), 4, (40, 40), seed=6)
    write_dataset(str(root / "val"), 2, (32, 32), seed=7)
    return root, pth


def test_cli_train_arch_unet(setup, tmp_path):
    """`cli.train --arch unet`, one epoch of 2 steps with the CR loss on a
    random VGG19: the UNet's model_best.pth loads strictly."""
    from dehaze_tpu_torch.cli import train

    root, _ = setup
    with pytest.warns(UserWarning, match="RANDOM VGG"):
        train.main(["--train_dir", str(root / "train"), "--val_dir",
                    str(root / "val"), "--batch_size", "2", "--nepoch", "1",
                    "--train_workers", "2", "--device", "cpu", "--save_dir",
                    str(tmp_path)] + UNET_FLAGS)
    best = str(tmp_path / "unet_" / "models" / "model_best.pth")
    UNet(dim=8).load_state_dict(load_weights(best, "unet"), strict=True)


def test_test_long_unet_matches_jax_cli(setup, capsys, monkeypatch):
    """`test_long --arch unet` (the square canvas) against the JAX CLI on
    the same `.pth`."""
    from dehaze_tpu.cli import test_long as jax_test_long

    root, pth = setup
    flags = ["--input_dir", str(root / "DS"), "--weights", pth,
             "--no-save_images"] + UNET_FLAGS
    monkeypatch.setattr(sys, "argv", ["test_long", "--result_dir",
                                      str(root / "jax")] + flags)
    jax_test_long.main()
    want = {}
    for ln in capsys.readouterr().out.splitlines():
        if ": PSNR " in ln and not ln.startswith("PSNR"):
            name, rest = ln.split(": PSNR ")
            want[name] = tuple(float(v) for v in rest.split(" SSIM "))
    got = test_long.main(flags + ["--device", "cpu", "--result_dir",
                                  str(root / "port")])
    assert got["names"] == sorted(want) == ["00000.png", "00001.png"]
    np.testing.assert_allclose(got["psnr"], [want[n][0] for n in
                                             got["names"]], atol=1e-3)
    np.testing.assert_allclose(got["ssim"], [want[n][1] for n in
                                             got["names"]], atol=1e-4)


def test_export_unet_is_the_eager_forward(setup, tmp_path):
    """`cli.export --arch unet` (the rect canvas, no sample tables) equals
    the eager whole-image forward bit for bit."""
    root, pth = setup
    art = str(tmp_path / "unet.dhz")
    res = cli_export.main(["--weights", pth, "--height", "24", "--width",
                           "40", "--out", art, "--device", "cpu"] + UNET_FLAGS)
    assert res["meta"]["canvas"] == "rect" and res["meta"]["arch"] == "unet"
    run, _ = load_exported(art, "cpu")
    model = UNet(dim=8).eval()
    model.load_state_dict(load_weights(pth, "unet"))
    img = load_img(os.path.join(root, "DS", "hazy", "00000.png"))[None]
    want = make_whole_image_fn(model, 24, 40, 32, square=False,
                               device="cpu")(img)
    torch.testing.assert_close(run(img), want, rtol=0, atol=0)
