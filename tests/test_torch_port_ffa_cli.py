"""FFA-Net on the port's entry points, on the CPU (`--device cpu`, f32, 1
block per group, width 16): `cli.test_long --arch ffa` (the native
protocol, `--ffa_normalize` on and off) against the JAX CLI on the same
reference `.pk`; `cli.stream` and `cli.serve` against the in-process
native forward; `cli.export` + `--exported` bit for bit against the eager
forward; `test_long --arch ffa --bands 2` (2 gloo ranks under torchrun)
against the one-process lines; `cli.ffa_train` end to end, its
`ffa_best.pk` read back by the JAX `load_reference_ffa_checkpoint`; and
the refusals. Tolerances: PSNR 1e-3 dB and SSIM 1e-4 against the JAX CLI
(which prints 4 decimals).
"""

import json
import os
import subprocess
import sys
import threading
import urllib.request
from http.server import ThreadingHTTPServer
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dehaze_tpu.models import ffa as JF
from dehaze_tpu.utils import convert_torch as CT
from dehaze_tpu_torch.cli import export as cli_export
from dehaze_tpu_torch.cli import ffa_train as cli_ffa_train
from dehaze_tpu_torch.cli import stream as cli_stream
from dehaze_tpu_torch.cli import test_anyres, test_long
from dehaze_tpu_torch.cli.serve import build_dehaze_fn, make_handler
from dehaze_tpu_torch.config import ModelConfig
from dehaze_tpu_torch.data.images import (decode_img, encode_img, load_img,
                                          save_img)
from dehaze_tpu_torch.data.synth import write_dataset
from dehaze_tpu_torch.infer.export import load_exported
from dehaze_tpu_torch.infer.tiled import make_native_image_fn, quantize_u8
from dehaze_tpu_torch.models.ffa import FFA
from dehaze_tpu_torch.train.ffa_trainer import normalize_hazy
from dehaze_tpu_torch.utils.convert import load_weights

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FFA_FLAGS = ["--arch", "ffa", "--ffa_blocks", "1", "--ffa_dim", "16",
             "--dtype", "float32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A seeded FFA-Net (1 block, width 16) as a reference-format `.pk`;
    a paired folder of two 24×40 frames; train and val sets."""
    root = tmp_path_factory.mktemp("ffa_cli")
    torch.manual_seed(6)
    model = FFA(blocks=1, dim=16).eval()
    pk = str(root / "ffa.pk")
    torch.save({"step": 1, "max_psnr": np.float64(1.0), "psnrs": [],
                "ssims": [], "losses": [],
                "model": {f"module.{k}": v
                          for k, v in model.state_dict().items()}}, pk)
    write_dataset(str(root / "DS"), 2, (24, 40), seed=5)
    write_dataset(str(root / "train"), 6, (40, 40), seed=6)
    write_dataset(str(root / "val"), 3, (32, 32), seed=7)
    return root, pk, model


def _forward(model, normalize=True):
    return make_native_image_fn(
        (lambda x: model(normalize_hazy(x))) if normalize else model,
        device="cpu")


def _jax_lines(out: str):
    """{name: (psnr, ssim)} of a JAX CLI's per-image lines."""
    rows = {}
    for ln in out.splitlines():
        if ": PSNR " in ln and not ln.startswith("PSNR"):
            name, rest = ln.split(": PSNR ")
            p, s = rest.split(" SSIM ")
            rows[name] = (float(p), float(s))
    return rows


@pytest.mark.parametrize("normalize", [True, False])
def test_test_long_ffa_matches_jax_cli(setup, capsys, monkeypatch,
                                       normalize):
    """`test_long --arch ffa`, the native protocol, with and without the
    normalization, against the JAX CLI on the same `.pk`."""
    from dehaze_tpu.cli import test_long as jax_test_long

    root, pk, _ = setup
    flags = ["--input_dir", str(root / "DS"), "--weights", pk,
             "--no-save_images"] + FFA_FLAGS + (
        [] if normalize else ["--no-ffa_normalize"])
    monkeypatch.setattr(sys, "argv", ["test_long", "--result_dir",
                                      str(root / "jax_long")] + flags)
    jax_test_long.main()
    want = _jax_lines(capsys.readouterr().out)
    got = test_long.main(flags + ["--device", "cpu", "--result_dir",
                                  str(root / "port_long")])
    assert got["names"] == ["00000.png", "00001.png"] == sorted(want)
    np.testing.assert_allclose(got["psnr"], [want[n][0] for n in
                                             got["names"]], atol=1e-3)
    np.testing.assert_allclose(got["ssim"], [want[n][1] for n in
                                             got["names"]], atol=1e-4)


def test_export_and_exported_are_the_eager_forward(setup, tmp_path):
    """`cli.export --arch ffa` writes a native artifact (normalization
    folded in, geometry baked) that equals the eager native forward bit
    for bit; `test_long --exported` prints the `--weights` lines; another
    geometry is refused."""
    root, pk, model = setup
    art = str(tmp_path / "ffa.dhz")
    res = cli_export.main(["--weights", pk, "--height", "24", "--width",
                           "40", "--out", art, "--device", "cpu"] + FFA_FLAGS)
    assert res["meta"]["canvas"] == "native" and res["meta"]["arch"] == "ffa"
    run, meta = load_exported(art, "cpu")
    img = load_img(str(root / "DS" / "hazy" / "00000.png"))[None]
    with torch.no_grad():
        torch.testing.assert_close(run(img), _forward(model)(img), rtol=0,
                                   atol=0)
    flags = ["--input_dir", str(root / "DS"), "--no-save_images",
             "--device", "cpu"]
    got = test_long.main(flags + ["--exported", art])
    want = test_long.main(flags + ["--weights", pk] + FFA_FLAGS)
    assert got["psnr"] == want["psnr"] and got["ssim"] == want["ssim"]
    with pytest.raises(ValueError, match="bakes 24x40"):
        cli_stream.main(["--input_dir", str(root / "train" / "hazy"),
                         "--exported", art, "--device", "cpu",
                         "--result_dir", str(tmp_path / "bad")])


def test_stream_is_the_native_forward(setup, tmp_path):
    """`cli.stream --arch ffa` (uint8 decode) writes each frame's
    quantized native forward, of frames of two geometries; `--exported`
    writes the same bytes."""
    root, pk, model = setup
    src = tmp_path / "hazy"
    src.mkdir()
    rng = np.random.default_rng(3)
    for name, (h, w) in (("a.png", (24, 40)), ("b.png", (20, 36))):
        save_img(str(src / name), rng.integers(0, 256, size=(h, w, 3),
                                               dtype=np.uint8))
    stats = cli_stream.main(["--input_dir", str(src), "--weights", pk,
                             "--device", "cpu", "--result_dir",
                             str(tmp_path / "out")] + FFA_FLAGS)
    assert stats["frames"] == 2
    for name in ("a.png", "b.png"):
        img = load_img(str(src / name), u8=True)
        want = quantize_u8(_forward(model))(img[None])[0].numpy()
        np.testing.assert_array_equal(
            load_img(str(tmp_path / "out" / name), u8=True), want)
    art = str(tmp_path / "a.dhz")
    cli_export.main(["--weights", pk, "--height", "24", "--width", "40",
                     "--out", art, "--device", "cpu"] + FFA_FLAGS)
    os.remove(src / "b.png")
    cli_stream.main(["--input_dir", str(src), "--exported", art, "--device",
                     "cpu", "--result_dir", str(tmp_path / "out_x")])
    assert (open(tmp_path / "out_x" / "a.png", "rb").read()
            == open(tmp_path / "out" / "a.png", "rb").read())


def test_serve_answers_with_the_native_forward(setup):
    """`cli.serve --arch ffa`: a POSTed PNG comes back as the quantized
    native forward at its own geometry; /healthz names the arch."""
    root, pk, model = setup
    args = SimpleNamespace(weights=pk, train_ps=128, square=False,
                           device="cpu", seed=1234, max_batch=4)
    cfg = ModelConfig(arch="ffa", ffa_blocks=1, ffa_dim=16,
                      dtype=torch.float32)
    dehaze, info = build_dehaze_fn(args, cfg)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(dehaze, info))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_port}"
    try:
        img = np.random.default_rng(4).integers(0, 256, size=(20, 28, 3),
                                                dtype=np.uint8)
        req = urllib.request.Request(url + "/dehaze", data=encode_img(img),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            got = decode_img(r.read(), u8=True)
        want = quantize_u8(_forward(model))(img[None])[0].numpy()
        np.testing.assert_array_equal(got, want)
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["arch"] == "ffa" and health["served"] == 1
    finally:
        srv.shutdown()
        srv.server_close()
        dehaze.batcher.close()


@pytest.mark.parametrize("flag", ["--bands", "--data_axis"])
def test_test_long_bands_gives_the_one_process_lines(setup, flag):
    """`torchrun --nproc_per_node 2 -m ...test_long --arch ffa --bands 2`
    (24 rows: 12 per band) and `--data_axis 2` (a frame per rank) print
    the one-process lines within 1e-3 dB."""
    root, pk, _ = setup
    flags = ["-m", "dehaze_tpu_torch.cli.test_long", "--input_dir",
             str(root / "DS"), "--weights", pk, "--device", "cpu",
             "--no-save_images"] + FFA_FLAGS
    env = {**os.environ, "PYTHONPATH": _REPO}
    outs = []
    for head in ([sys.executable],
                 [sys.executable, "-m", "torch.distributed.run",
                  "--standalone", "--nproc_per_node", "2"]):
        r = subprocess.run(head + flags + ([flag, "2"] if len(head) > 1
                                           else []),
                           capture_output=True, text=True, timeout=300,
                           env=env)
        assert r.returncode == 0, r.stderr[-3000:]
        outs.append(_jax_lines(r.stdout))
    assert sorted(outs[1]) == sorted(outs[0]) == ["00000.png", "00001.png"]
    for name in outs[0]:
        np.testing.assert_allclose(outs[1][name], outs[0][name], atol=1e-3)


def test_ffa_train_end_to_end_checkpoint_reads_in_jax(setup, tmp_path):
    """`cli.ffa_train` (4 steps, an eval every 2): finite losses, the
    history file, and an `ffa_best.pk` in the reference layout that the
    JAX `load_reference_ffa_checkpoint` turns into the same forward as the
    port's loader; its max_psnr is the best logged PSNR, which the
    reloaded model reproduces."""
    from dehaze_tpu_torch.data.pipeline import PairedFolder, _val_batches
    from dehaze_tpu_torch.train.ffa_trainer import FFATrainer

    root, _, _ = setup
    out = cli_ffa_train.main([
        "--train_dir", str(root / "train"), "--val_dir", str(root / "val"),
        "--steps", "4", "--eval_step", "2", "--blocks", "1", "--bs", "2",
        "--crop_size", "24", "--device", "cpu", "--model_dir",
        str(tmp_path)])
    assert len(out["losses"]) == 4 and np.all(np.isfinite(out["losses"]))
    assert len(out["psnrs"]) == 2
    hist = json.load(open(tmp_path / "ffa_history.json"))
    assert hist["max_psnr"] == max(hist["psnrs"]) == out["max_psnr"]
    pk = str(tmp_path / "ffa_best.pk")
    payload = torch.load(pk, weights_only=True)
    assert set(payload) == {"step", "max_psnr", "max_ssim", "ssims",
                            "psnrs", "losses", "model"}
    tr = FFATrainer(blocks=1, device="cpu")
    tr.model.load_state_dict(load_weights(pk, "ffa"), strict=True)
    val, n_val = _val_batches(PairedFolder(str(root / "val")), 24, 2,
                              u8=True)
    np.testing.assert_allclose(tr.evaluate(val, n_valid=n_val)[0],
                               payload["max_psnr"], rtol=0, atol=1e-4)
    params = jax.tree.map(jnp.asarray, CT.load_reference_ffa_checkpoint(
        pk, blocks=1))
    x = np.random.default_rng(2).uniform(size=(1, 16, 24, 3)).astype(
        np.float32)
    want = np.asarray(JF.FFA(blocks=1).apply({"params": params},
                                             jnp.asarray(x)))
    with torch.no_grad():
        got = tr.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_ffa_train_data_axis_gives_the_one_process_steps(setup, tmp_path):
    """`torchrun --nproc_per_node 2 -m ...ffa_train --data_axis 2` (DDP,
    one row of the global batch of 2 per rank): the one-process run's
    step losses within 1e-5 relative and its PSNRs within 1e-4 dB; rank
    0 alone writes the checkpoint and the history."""
    root, _, _ = setup
    flags = ["-m", "dehaze_tpu_torch.cli.ffa_train", "--train_dir",
             str(root / "train"), "--val_dir", str(root / "val"), "--steps",
             "4", "--eval_step", "2", "--blocks", "1", "--bs", "2",
             "--crop_size", "24", "--device", "cpu"]
    env = {**os.environ, "PYTHONPATH": _REPO}
    hist = []
    for n in (1, 2):
        head = [sys.executable] + ([] if n == 1 else [
            "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "2"])
        out = tmp_path / f"p{n}"
        r = subprocess.run(head + flags + ["--model_dir", str(out)] + (
            ["--data_axis", "2"] if n == 2 else []), capture_output=True,
            text=True, timeout=300, env=env)
        assert r.returncode == 0, r.stderr[-3000:]
        assert r.stdout.count("best PSNR") == 1
        assert sorted(os.listdir(out)) == ["ffa_best.pk", "ffa_history.json"]
        hist.append(json.load(open(out / "ffa_history.json")))
    np.testing.assert_allclose(hist[1]["losses"], hist[0]["losses"],
                               rtol=1e-5)
    np.testing.assert_allclose(hist[1]["psnrs"], hist[0]["psnrs"], rtol=0,
                               atol=1e-4)


def test_refusals(setup):
    """test_anyres is Uformer-only and --bands has no UNet forward, in the
    JAX package's words; the gate checks Uformers only."""
    from dehaze_tpu_torch.cli import parity_gate

    root, pk, _ = setup
    base = ["--input_dir", str(root / "DS"), "--weights", pk, "--device",
            "cpu"]
    for arch in ("ffa", "unet"):
        with pytest.raises(SystemExit, match="test_anyres is Uformer-only"):
            test_anyres.main(base + ["--arch", arch])
    with pytest.raises(SystemExit, match="halo-banded inference exists for "
                                         "the Uformer"):
        test_long.main(base + ["--arch", "unet", "--bands", "2"])
    with pytest.raises(SystemExit, match="--arch ffa has no gate"):
        parity_gate.main(["--ref_ckpt", pk, "--input_dir", str(root / "DS"),
                          "--device", "cpu", "--arch", "ffa"])
