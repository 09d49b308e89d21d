"""`cli.zoo` of the port (`--device cpu`) against the JAX package's
`cli.zoo`, run in this process on the same files: ViT-Ti with 8×8 patches
at 32², its weights a JAX init (nudged by seeded noise so that the logits
spread) written by the JAX package's `save_checkpoint` as `.msgpack`, with
no training step. `eval` (CIFAR-10 pickles, synthetic data with
`--ensemble`, CIFAR-10-C with `--ctype`, an ImageNet-style folder;
`--json_out`, `--metrics_csv`, `--fig`), `perturbation`, `attack` (FGSM,
PGD, Random, `--freq`), `fourier`'s CSVs, the YAML overlay's resolved
arguments, `predtime`'s lines and `train --data_axis 2`'s launch hint
outside torchrun. f32: the
metrics within 2e-4; printed values within their last printed digit.
"""

import json
import os
import pickle
import re
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dehaze_tpu.cli import zoo as JZ
from dehaze_tpu.train.checkpoint import save_checkpoint
from dehaze_tpu.zoo import get_model as jax_get_model
from dehaze_tpu_torch.cli import zoo as TZ

TOL = 2e-4
MODEL = ["--name", "vit_ti", "--image_size", "32", "--patch_size", "8"]
SYNTH = ["--dataset", "synthetic", "--n_synth", "32", "--batch_size", "16"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU tensors: with several test
    workers on the host, torch's thread pools stall each other in
    hand-offs (a small op then takes tens of times as long)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _init(model, shape=(1, 32, 32, 3)):
    """`model.init` as the JAX CLI calls it, a function of the key."""
    return lambda k: model.init({"params": k, "dropout": k, "droppath": k},
                                jnp.zeros(shape), train=False)


class _Jitted:
    """A flax module whose `apply` runs as one jitted program per set of
    static keywords; every other attribute is the module's."""

    def __init__(self, module):
        self.module = module
        self._fns = {}

    def __getattr__(self, name):
        return getattr(self.module, name)

    def apply(self, variables, x, rngs=None, **static):
        key = repr(sorted(static.items()))
        if key not in self._fns:
            self._fns[key] = jax.jit(lambda vs, a, r: self.module.apply(
                vs, a, rngs=r, **static))
        return self._fns[key](variables, x, rngs)


@pytest.fixture(scope="module")
def _jax_programs():
    """The JAX CLI's models and attack programs, kept across its runs."""
    return {}


@pytest.fixture(autouse=True)
def _jax_compiled(monkeypatch, _jax_programs):
    """The JAX CLI with its model's `apply`, its init and its two gradient
    attacks each run as one jitted program, the weights a jit argument:
    called eagerly, each primitive of ViT-Ti's forward, init and backward
    pass compiles on its own (tens of seconds), and JAX's `pgd` bakes the
    weights into its loop's program as constants. A checkpoint's template
    is the init's `jax.eval_shape` (its leaves are read from the file).
    The functions and their arguments are JAX's."""
    from dehaze_tpu.train.checkpoint import load_checkpoint
    from dehaze_tpu.zoo import adversarial as JAD

    def load_variables(args, model, sample_x, ckpt=None):
        init = _init(model.module, (1,) + tuple(sample_x.shape[1:]))
        ckpt = ckpt or args.ckpt
        if ckpt:
            return load_checkpoint(ckpt, jax.eval_shape(
                init, jax.random.PRNGKey(0)))[1]
        print("[zoo] no --ckpt given: using random init")
        return jax.jit(init)(jax.random.PRNGKey(0))

    def jitted(attack):
        def run(model, variables, xs, ys, **kw):
            rng = kw.pop("rng")
            key = (attack, id(model), repr(sorted(kw.items())))
            if key not in _jax_programs:
                _jax_programs[key] = jax.jit(lambda v, x, y, r: attack(
                    model, v, x, y, rng=r, **kw))
            return _jax_programs[key](variables, xs, ys, rng)
        return run

    build = JZ._build

    def cached_build(args, num_classes, sample_x=None):
        key = (args.name, args.bf16, args.stem, num_classes,
               repr(sorted(JZ._model_kwargs(args, sample_x).items())))
        if key not in _jax_programs:
            _jax_programs[key] = _Jitted(build(args, num_classes, sample_x))
        return _jax_programs[key]

    monkeypatch.setattr(JZ, "_build", cached_build)
    monkeypatch.setattr(JZ, "_load_variables", load_variables)
    monkeypatch.setattr(JAD, "fgsm", jitted(JAD.fgsm))
    monkeypatch.setattr(JAD, "pgd", jitted(JAD.pgd))


def _checkpoint(path, params, seed):
    """A JAX init of ViT-Ti, every parameter nudged by half its own spread
    (0.02 on a constant leaf) and the head ×3, saved as the JAX CLI saves."""
    rng = np.random.default_rng(seed)

    def nudge(a):
        a = np.asarray(a)
        scale = 0.5 * a.std() if a.std() > 0 else 0.02
        a = a + scale * rng.standard_normal(a.shape).astype(np.float32)
        return a * 3.0 if a.ndim == 2 and a.shape[1] == 10 else a

    save_checkpoint(str(path), 0, {"params": jax.tree.map(nudge, params)})
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo_cli")
    rng = np.random.default_rng(0)
    c10 = root / "cifar-10-batches-py"
    c10.mkdir()
    for f in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(c10 / f, "wb") as fh:
            pickle.dump({b"data": rng.integers(0, 256, (16, 3072),
                                               dtype=np.uint8),
                         b"labels": rng.integers(0, 10, 16).tolist()}, fh)
    os.makedirs(root / "CIFAR-10-C")
    np.save(root / "CIFAR-10-C" / "fog.npy",
            rng.integers(0, 256, (16, 32, 32, 3), dtype=np.uint8))
    np.save(root / "CIFAR-10-C" / "labels.npy", rng.integers(0, 10, 16))
    os.makedirs(root / "cifar-10-p")
    np.save(root / "cifar-10-p" / "gaussian_noise.npy",
            rng.integers(0, 256, (2, 8, 32, 32, 3), dtype=np.uint8))
    for ci in range(10):  # 10 classes, 2 images in each of the first 8
        d = root / "imagenet" / "val" / f"class{ci}"
        os.makedirs(d)
        for i in range(2 if ci < 8 else 0):
            h, w = rng.integers(30, 60, 2)
            img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3),
                                                dtype=np.uint8), (5, 5), 0)
            cv2.imwrite(str(d / f"{i}.png"), img)
    jm = jax_get_model("vit_ti", num_classes=10, image_size=32, patch_size=8)
    params = jax.jit(_init(jm))(jax.random.PRNGKey(1))["params"]
    return {"root": str(root), "ck": _checkpoint(root / "a.msgpack", params, 1),
            "ck2": _checkpoint(root / "b.msgpack", params, 2)}


def _jax(argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["zoo"] + argv)
    capsys.readouterr()
    JZ.main()
    return capsys.readouterr().out


def _port(argv, capsys):
    capsys.readouterr()
    result = TZ.main(argv + ["--device", "cpu"])
    return result, capsys.readouterr().out


def _numbers(line):
    return [float(v) for v in re.findall(r"-?\d+\.\d+(?:e[-+]\d+)?", line)]


def _same_line(got, want, tol):
    """The same text, its numbers within tol."""
    num = r"-?\d+\.\d+(?:e[-+]\d+)?"
    assert re.sub(num, "#", got) == re.sub(num, "#", want)
    np.testing.assert_allclose(_numbers(got), _numbers(want), rtol=0,
                               atol=tol)


def _close_json(got_path, want_path):
    got, want = (json.load(open(p)) for p in (got_path, want_path))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                   err_msg=k)
    return got


def _close_csv(got_path, want_path):
    got, want = (open(p).read().strip().split(",")
                 for p in (got_path, want_path))
    assert got[0] == want[0] and len(got) == len(want)
    np.testing.assert_allclose(np.array(got[1:], float),
                               np.array(want[1:], float), rtol=TOL, atol=TOL)
    return got


def test_eval_cifar_json_csv_fig(files, tmp_path, monkeypatch, capsys):
    base = MODEL + ["--dataset", "cifar10", "--root", files["root"],
                    "--batch_size", "16", "--ckpt", files["ck"]]
    out = {s: {k: str(tmp_path / f"{s}.{k}") for k in ("json", "csv")}
           for s in ("jax", "port")}
    want_out = _jax(["eval", *base, "--json_out", out["jax"]["json"],
                     "--metrics_csv", out["jax"]["csv"]], monkeypatch, capsys)
    fig = tmp_path / "rel.png"
    metrics, got_out = _port(["eval", *base, "--json_out",
                              out["port"]["json"], "--metrics_csv",
                              out["port"]["csv"], "--fig", str(fig)], capsys)
    _same_line(got_out, want_out, 0.021)  # percentages to 3 decimals
    assert "no --ckpt" not in got_out
    js = _close_json(out["port"]["json"], out["jax"]["json"])
    assert js["acc"] == metrics[3][0]
    assert _close_csv(out["port"]["csv"], out["jax"]["csv"])[0] == "cifar10"
    assert fig.stat().st_size > 0


def test_eval_ensemble_and_ctype(files, tmp_path, monkeypatch, capsys):
    """--ensemble of two checkpoints (stacked weights) and CIFAR-10-C
    --ctype fog --intensity 1 (its CSV keyed by the corruption)."""
    runs = {"ensemble": ["eval", *MODEL, *SYNTH, "--ckpt", files["ck"],
                         "--ensemble", files["ck2"]],
            "ctype": ["eval", *MODEL, "--root", files["root"], "--ctype",
                      "fog", "--intensity", "1", "--batch_size", "16",
                      "--ckpt", files["ck2"]]}
    for name, argv in runs.items():
        paths = {s: (str(tmp_path / f"{name}_{s}.json"),
                     str(tmp_path / f"{name}_{s}.csv"))
                 for s in ("jax", "port")}
        want_out = _jax(argv + ["--json_out", paths["jax"][0],
                                "--metrics_csv", paths["jax"][1]],
                        monkeypatch, capsys)
        _, got_out = _port(argv + ["--json_out", paths["port"][0],
                                   "--metrics_csv", paths["port"][1]],
                           capsys)
        _same_line(got_out, want_out, 0.021)
        _close_json(paths["port"][0], paths["jax"][0])
        key = _close_csv(paths["port"][1], paths["jax"][1])[0]
        assert key == {"ensemble": "synthetic", "ctype": "fog"}[name]
        assert ("[zoo] deep ensemble of 2 members" in got_out) == (
            name == "ensemble")


def test_eval_ensemble_line_and_pth_checkpoint(files, tmp_path, capsys):
    """The ensemble's notice; a reference `.pth.tar` of the same weights
    (DataParallel's `module.` prefixes) gives the `.msgpack`'s metrics."""
    from dehaze_tpu_torch.zoo import get_model
    from dehaze_tpu_torch.zoo.checkpoint import read_state_dict

    model = get_model("vit_ti", num_classes=10, image_size=32, patch_size=8)
    sd = read_state_dict(files["ck"], model)
    pth = str(tmp_path / "w.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               pth)
    runs = [_port(["eval", *MODEL, *SYNTH, "--ckpt", ck], capsys)
            for ck in (files["ck"], pth)]
    assert runs[0][1] == runs[1][1]
    ens, out = _port(["eval", *MODEL, *SYNTH, "--ckpt", files["ck"],
                      "--ensemble", files["ck"]], capsys)
    assert out.startswith("[zoo] deep ensemble of 2 members\n")
    # the same member twice: log Σ is a constant shift of one member
    np.testing.assert_allclose(ens[0], runs[0][0][0], rtol=1e-5)


def test_perturbation(files, monkeypatch, capsys):
    argv = ["perturbation", *MODEL, "--root", files["root"], "--batch_size",
            "2", "--ckpt", files["ck"]]
    want = _jax(argv, monkeypatch, capsys)
    (cons, cec), got = _port(argv, capsys)
    assert got.startswith("ptype: gaussian_noise, consistency: ")
    _same_line(got, want, 1e-4)
    assert 0.0 <= cons <= 1.0 and np.isfinite(cec)


@pytest.mark.parametrize("method,extra,exact", [
    ("fgsm", ["--eps", "0.05"], True),
    ("fgsm", ["--eps", "0.05", "--freq", "1.0"], True),
    # PGD's random start and Random's noise come from torch generators on
    # the port and from JAX keys in the JAX package: their accuracies may
    # differ by a few of the 16 examples
    ("pgd", ["--eps", "0.05", "--steps", "2"], False),
    ("random", ["--eps", "0.05"], False)])
def test_attack(files, monkeypatch, capsys, method, extra, exact):
    argv = ["attack", *MODEL, *SYNTH, "--n_examples", "16", "--ckpt",
            files["ck"], "--method", method, *extra]
    want = _jax(argv, monkeypatch, capsys)
    res, got = _port(argv, capsys)
    clean_j, adv_j = _numbers(want)[-2:]
    assert got.startswith(f"method: {method}, eps: 0.05, clean acc: ")
    assert res["clean"] == clean_j
    assert abs(res["adv"] - adv_j) <= (0.0 if exact else 3 / 16), (
        res["adv"], adv_j)
    assert tuple(res["x_adv"].shape) == (16, 3, 32, 32)


def test_fourier_csvs(files, tmp_path, monkeypatch, capsys):
    argv = ["fourier", *MODEL, *SYNTH, "--ckpt", files["ck"]]
    want = _jax(argv + ["--out", str(tmp_path / "jax")], monkeypatch, capsys)
    res, got = _port(argv + ["--out", str(tmp_path / "port")], capsys)
    assert got.splitlines()[0] == want.splitlines()[0].replace(
        "jax", "port")
    assert len(res["latents"]) == 25  # the embedding + 2 × 12 blocks
    for f in ("highfreq_delta.csv", "variance.csv"):
        np.testing.assert_allclose(
            np.loadtxt(tmp_path / "port" / f, delimiter=","),
            np.loadtxt(tmp_path / "jax" / f, delimiter=","),
            rtol=TOL, atol=TOL, err_msg=f)
    for f in ("fourier.png", "variance.png"):
        assert (tmp_path / "port" / f).stat().st_size > 0
    _, got = _port(argv + ["--out", str(tmp_path / "csv"), "--out_plot", ""],
                   capsys)
    assert "(no figures)" in got
    assert sorted(os.listdir(tmp_path / "csv")) == ["highfreq_delta.csv",
                                                    "variance.csv"]


def test_predtime_lines(files, monkeypatch, capsys):
    """The stats line, the time and the throughput lines (the image size
    from the data: no --image_size); without --ckpt, the JAX CLI's
    random-init notice first."""
    argv = ["predtime", "--name", "vit_ti", "--patch_size", "8", *SYNTH,
            "--n", "2"]
    want = _jax(argv + ["--ckpt", files["ck"]], monkeypatch,
                capsys).splitlines()
    res, got = _port(argv + ["--ckpt", files["ck"]], capsys)
    got = got.splitlines()
    assert got[0] == want[0] == (
        "model: vit_ti , params: 5.4M, output: [1, 10]")
    assert re.fullmatch(r"Time: \d+\.\d{3}±\d+\.\d{3} ms", got[1])
    assert re.fullmatch(r"throughput: \d+\.\d img/s at batch 16", got[2])
    assert len(got) == len(want) == 3
    assert res["img_per_s"] > 0
    _, got = _port(argv, capsys)
    assert got.splitlines()[:2] == [
        "[zoo] no --ckpt given: using random init", want[0]]


CONFIG = """
dataset:
  name: cifar10
  root: /data/somewhere
train:
  warmup_epochs: 1
  epochs: 3
  batch_size: 64
  smoothing: 0.1
  max_norm: 1.0
  mixup:
    mixup_alpha: 1.0
    cutmix_alpha: 0.8
    prob: 1.0
model:
  stem: true
  block:
    image_size: 32
    patch_size: 4
    sd: 0.1
optim:
  name: AdamW
  lr: 1.0e-3
  weight_decay: 0.05
  scheduler:
    name: CosineAnnealingLR
    T_max: 10
val:
  n_ff: 2
"""


@pytest.mark.parametrize("cmd", ["eval", "train"])
def test_yaml_overlay_resolves_as_jax(tmp_path, cmd):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(CONFIG)
    argv = [cmd, "--name", "vit_ti", "--config", str(cfg), "--batch_size",
            "8"]
    resolved = []
    for mod in (JZ, TZ):
        top, parsers = mod.build_parsers()
        args = mod._apply_config(top.parse_args(argv), parsers[cmd])
        resolved.append(vars(args))
    jax_args, port = resolved
    assert port.pop("device") == "cuda"
    assert port == jax_args
    assert port["batch_size"] == 8 and port["n_ff"] == 2
    assert port["scheduler_cfg"]["T_max"] == 10


def test_config_without_yaml_and_train_refusal(tmp_path, monkeypatch):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(CONFIG)
    top, parsers = TZ.build_parsers()
    args = top.parse_args(["eval", "--name", "vit_ti", "--config", str(cfg)])
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(SystemExit, match="needs PyYAML"):
        TZ._apply_config(args, parsers["eval"])
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(SystemExit, match=r"--data_axis 2 runs one process "
                       r"per GPU: launch it with `torchrun --nproc_per_node "
                       r"2`.*not started by torchrun"):
        TZ.main(["train", "--name", "vit_ti", "--epochs", "2", "--mixup",
                 "--data_axis", "2", "--optimizer", "AdamW", "--out",
                 str(tmp_path / "never")])
    assert not (tmp_path / "never").exists()
    with pytest.raises(SystemExit):  # argparse: an unknown train flag
        TZ.main(["train", "--name", "vit_ti", "--no_such_flag"])
    top, parsers = TZ.build_parsers()
    jtop, jparsers = JZ.build_parsers()
    for cmd, p in parsers.items():
        mine = {a.dest for a in p._actions} - {"device", "out_plot"}
        assert mine == {a.dest for a in jparsers[cmd]._actions}, cmd


def test_imagenet_folder_eval(files, tmp_path, monkeypatch, capsys):
    """--dataset imagenet: the folder's 10 classes (two empty), decoded
    and resized by the port, against cv2 in the JAX package (metrics
    within 2e-4)."""
    argv = ["eval", *MODEL, "--dataset", "imagenet", "--root",
            files["root"], "--batch_size", "16", "--ckpt", files["ck"]]
    paths = [str(tmp_path / f"{s}.json") for s in ("jax", "port")]
    want = _jax(argv + ["--json_out", paths[0]], monkeypatch, capsys)
    _, got = _port(argv + ["--json_out", paths[1]], capsys)
    _same_line(got, want, 0.021)
    _close_json(paths[1], paths[0])
