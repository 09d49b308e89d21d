"""`cli.zoo train` of the port against the JAX package's, and the zoo
trainer's data parallelism, on the CPU.

- The port's `cli.zoo train --device cpu` against the JAX package's
  `cli.zoo train`, run in this process on the same synthetic data:
  ViT-Ti at 32² with 8×8 patches, `--n_synth 96`, 1 epoch of 3 batches of
  32, AdamW (lr 1e-3, weight decay 0.05), `--no_augment`, no mixup. Both
  start from the JAX CLI's init: the port's `_build` is patched to load
  it, and no flag is added. The epoch line's numbers within their
  last printed digit (and l1, l2 within 1e-5 relative), every number of
  the `val:` line within 2.1e-2 (2e-4 of a metric printed in %, and its
  last digit), `best acc` equal.
  The port's `best.pth.tar` loads into JAX (`load_torch_zoo_checkpoint`)
  and into the port's `eval --ckpt`, and `evaluate.test` on it gives the
  accuracy the port's train run printed, in both.
- Two gloo ranks, each a real process started once by a module fixture,
  on `ResNetZoo(num_blocks=(1, 1, 1, 1))` (BatchNorm in every block):
  one `ZooTrainer(data_parallel=True)` step at 16 rows of 32², augment
  and mixup on, against the one-process step on the whole batch: the
  gradients within rtol 1e-4 over a floor of 1e-5 of each tensor's
  largest entry, the BatchNorm running statistics within 1e-5 and the
  same on both ranks. This step runs in float64 (the statistics too): in
  float32 two equal steps computed in other orders (convolutions on 8
  rows against 16) differ far beyond float32's rounding in some gradient
  entries, not for a fault: a ReLU input within rounding of 0 flips, and
  the gradients of the parameters around BatchNorm are small differences
  of large terms (BatchNorm is blind to a shift of its input). A backward
  that did not sum the statistics' gradient over the ranks misses the
  float64 bar by orders of magnitude.
- `cli.zoo train --data_axis 2` on the same two ranks (16² synthetic
  images, 4 batches of 16, SGD with weight decay, augment and mixup on,
  its `_build` patched to that ResNet in float64, for the reason
  above, which SGD carries from step to step) against the one-process
  CLI run: the parameters and running statistics within
  1e-4, the epoch's loss within 1e-5.
"""

import inspect
import json
import os
import re
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dehaze_tpu.cli import zoo as JZ
from dehaze_tpu.zoo import data as JD
from dehaze_tpu.zoo import evaluate as JE
from dehaze_tpu.zoo import get_model as jax_get_model
from dehaze_tpu.zoo.checkpoint import load_torch_zoo_checkpoint
from dehaze_tpu_torch.cli import zoo as TZ
from dehaze_tpu_torch.utils.convert import zoo_state_dict_from_jax_variables
from dehaze_tpu_torch.zoo import get_model
from dehaze_tpu_torch.zoo.convnets import ResNetZoo
from dehaze_tpu_torch.zoo.train import ZooTrainer

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4
VIT = ["--name", "vit_ti", "--image_size", "32", "--patch_size", "8"]
TRAIN = ["train", *VIT, "--dataset", "synthetic", "--n_synth", "96",
         "--batch_size", "32", "--optimizer", "AdamW", "--lr", "1e-3",
         "--weight_decay", "0.05", "--no_augment"]
# the data-parallel runs
STEP_KW = dict(num_classes=10, optimizer_name="SGD", lr=0.05,
               weight_decay=5e-4, mixup={"mixup_alpha": 1.0,
                                         "cutmix_alpha": 0.8, "prob": 1.0},
               smoothing=0.1, seed=3)
DP_CLI = ["train", "--name", "resnet_dnn_18", "--dataset", "synthetic",
          "--n_synth", "64", "--image_size", "16", "--batch_size", "16",
          "--optimizer", "SGD", "--lr", "0.05", "--weight_decay", "5e-4",
          "--mixup", "--device", "cpu"]


def small_resnet(num_classes=10, dtype=torch.float32):
    """The ResNet of the data-parallel runs, its init seeded; its
    parameters and activations in `dtype`."""
    torch.manual_seed(0)
    return ResNetZoo(num_blocks=(1, 1, 1, 1), num_classes=num_classes,
                     dtype=dtype).to(dtype)


def step_batch():
    rng = np.random.default_rng(11)
    return (rng.random((16, 32, 32, 3), dtype=np.float32),
            rng.integers(0, 10, 16).astype(np.int32))


# Each rank: one data-parallel ZooTrainer step (its gradients and buffers
# saved), then `cli.zoo train --data_axis 2` with the ResNet as its model.
WORKER = r'''
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from dehaze_tpu_torch.cli import zoo as TZ
from dehaze_tpu_torch.parallel import dist
from dehaze_tpu_torch.zoo.convnets import ResNetZoo
from dehaze_tpu_torch.zoo.train import ZooTrainer
''' + inspect.getsource(small_resnet) + inspect.getsource(step_batch) + r'''
out, step_kw, cli = sys.argv[1], json.loads(sys.argv[2]), json.loads(
    sys.argv[3])
dist.init("cpu")
r = dist.rank()
tr = ZooTrainer(small_resnet(dtype=torch.float64), data_parallel=True,
                **step_kw)
tr.init()
tr.train_step(*step_batch())
np.savez(f"{out}/step{r}.npz",
         **{"grad." + k: p.grad.numpy() for k, p in
            tr.model.named_parameters()},
         **{"buf." + k: v.numpy() for k, v in tr.model.named_buffers()})
TZ._build = lambda args, nc, sample_x=None, seed=0: small_resnet(
    nc, torch.float64)
TZ.main(cli + ["--data_axis", "2", "--out", f"{out}/cli"])
dist.shutdown()
'''


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: with several test
    workers on the host, torch's thread pools stall each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two gloo ranks' directory (step0.npz, step1.npz, cli/) and
    rank 0's stdout, started in the background at the first use."""
    td = tmp_path_factory.mktemp("zoo_ddp")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(td), json.dumps(STEP_KW),
         json.dumps(DP_CLI)], cwd=str(td), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": _REPO, "OMP_NUM_THREADS": "1",
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
             "RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": str(r)})
        for r in range(2)]
    done = []

    def get():
        if not done:
            try:
                outs = [p.communicate(timeout=300) for p in procs]
            finally:
                for p in procs:
                    p.kill()
            for p, (_, err) in zip(procs, outs):
                assert p.returncode == 0, err[-3000:]
            done.append((td, outs[0][0]))
        return done[0]

    yield get
    for p in procs:
        p.kill()


def test_ddp_step_equals_one_process_step(two_ranks):
    td, _ = two_ranks()
    tr = ZooTrainer(small_resnet(dtype=torch.float64), **STEP_KW)
    tr.init()
    tr.train_step(*step_batch())
    ranks = [np.load(td / f"step{r}.npz") for r in range(2)]
    for k, p in tr.model.named_parameters():
        want, got = p.grad.numpy(), ranks[0]["grad." + k]
        floor = 1e-5 * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=floor,
                                   err_msg=k)
    for k, v in tr.model.named_buffers():
        np.testing.assert_allclose(ranks[0]["buf." + k], v.numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(ranks[1]["buf." + k],
                                      ranks[0]["buf." + k], err_msg=k)


def _loss(out):
    return float(re.search(r"^Epoch: 0, Loss: (\S+),", out, re.M).group(1))


def test_cli_data_axis_2_equals_one_process(two_ranks, tmp_path,
                                            monkeypatch, capsys):
    td, rank0_out = two_ranks()
    monkeypatch.setattr(TZ, "_build", lambda args, nc, sample_x=None,
                        seed=0: small_resnet(nc, torch.float64))
    capsys.readouterr()
    TZ.main(DP_CLI + ["--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert abs(_loss(rank0_out) - _loss(out)) < 1e-5
    want = torch.load(tmp_path / "epoch_0.pth.tar", weights_only=True)
    got = torch.load(td / "cli" / "epoch_0.pth.tar", weights_only=True)
    assert got["name"] == "resnet_dnn_18" and got["epoch"] == 0
    for k, v in want["state_dict"].items():
        np.testing.assert_allclose(got["state_dict"][k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-4, err_msg=k)
    assert {"acc", "loss"} <= set(got)


# ------------------------------------------------- the CLI against JAX's

class _JitInit:
    """A flax module whose `init` runs as one jitted program (called
    eagerly, as the JAX trainer calls it, each primitive of ViT-Ti's init
    compiles on its own); every other attribute is the module's."""

    def __init__(self, module):
        self.module = module
        self._init = jax.jit(lambda rngs, x: module.init(rngs, x,
                                                         train=False))

    def __getattr__(self, name):
        return getattr(self.module, name)

    def init(self, rngs, x, train=False):
        assert not train
        return self._init(rngs, x)


def _lines(out, prefix):
    return [ln for ln in out.splitlines() if ln.startswith(prefix)]


def _numbers(line):
    return [float(v) for v in re.findall(r"-?\d+\.\d+(?:e[-+]\d+)?", line)]


def test_cli_train_equals_jax(tmp_path, monkeypatch, capsys):
    jax_build = JZ._build
    jax_models = []

    def jitted_build(args, num_classes, sample_x=None):
        jax_models.append(_JitInit(jax_build(args, num_classes, sample_x)))
        return jax_models[-1]

    monkeypatch.setattr(JZ, "_build", jitted_build)
    monkeypatch.setattr(sys, "argv", ["zoo"] + TRAIN + ["--out",
                                                        str(tmp_path / "j")])
    capsys.readouterr()
    JZ.main()
    want = capsys.readouterr().out

    # the JAX CLI's init: ZooTrainer.init's first split of PRNGKey(seed)
    jm = jax_models[0].module
    (xtr, _), (xte, yte), _, _ = JD.get_dataset("synthetic", n_synth=96,
                                                synth_size=32)
    k = jax.random.split(jax.random.PRNGKey(0))[0]
    variables = jax_models[0].init(
        {"params": k, "dropout": k, "droppath": k}, xtr[:32])

    def port_build(args, num_classes, sample_x=None, seed=0):
        model = get_model("vit_ti", num_classes=num_classes, image_size=32,
                          patch_size=8, device=args.device)
        model.load_state_dict(zoo_state_dict_from_jax_variables(variables,
                                                                model))
        return model

    monkeypatch.setattr(TZ, "_build", port_build)
    best = TZ.main(TRAIN + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    got = capsys.readouterr().out

    (g,), (w,) = _lines(got, "Epoch: 0"), _lines(want, "Epoch: 0")
    assert re.sub(r"-?\d+\.\d+(?:e[-+]\d+)?", "#", g) == re.sub(
        r"-?\d+\.\d+(?:e[-+]\d+)?", "#", w)
    gn, wn = _numbers(g), _numbers(w)
    np.testing.assert_allclose(gn[0], wn[0], rtol=0, atol=TOL + 5e-5)
    np.testing.assert_allclose(gn[1], wn[1], rtol=1e-6)  # lr, printed .3e
    np.testing.assert_allclose(gn[2:], wn[2:], rtol=1e-5)
    (g,), (w,) = _lines(got, "  val: "), _lines(want, "  val: ")
    np.testing.assert_allclose(_numbers(g), _numbers(w), rtol=0,
                               atol=100 * TOL + 1e-3)
    (g,), (w,) = _lines(got, "best acc"), _lines(want, "best acc")
    assert g == w and abs(best - float(g.split()[-1])) < 5e-5

    # the port's checkpoint in JAX: its accuracy
    path = tmp_path / "t" / "best.pth.tar"
    assert sorted(os.listdir(tmp_path / "t")) == ["best.pth.tar",
                                                  "epoch_0.pth.tar"]
    jv = load_torch_zoo_checkpoint(str(path), variables)
    metrics = JE.test(jm, jv, JD.batches(xte, yte, 32))
    assert abs(metrics[3][0] - best) < 1e-9
    # and in the port's --ckpt
    metrics = TZ.main(["eval", *VIT, "--dataset", "synthetic", "--n_synth",
                       "96", "--batch_size", "32", "--ckpt", str(path),
                       "--device", "cpu"])
    assert abs(metrics[3][0] - best) < 1e-9

