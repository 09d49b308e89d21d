"""The port's streaming and artifact-serving paths on the CPU (embed 8, f32,
`--device cpu`): `infer.stream.stream_dehaze`, `cli.stream` with
`--weights` and `--exported`, `cli.serve --exported` and the hazy-only
`data.pipeline.test_images`, against the port's in-process forward and the
JAX package's stream.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from functools import partial
from http.server import ThreadingHTTPServer
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dehaze_tpu.config import ModelConfig as JaxModelConfig
from dehaze_tpu.data import pipeline as jax_pipeline
from dehaze_tpu.infer.stream import stream_dehaze as jax_stream_dehaze
from dehaze_tpu.models.uformer import Uformer as JaxUformer
from dehaze_tpu.ops import probsparse as PS
from dehaze_tpu.utils.convert_torch import convert_uformer_state_dict
from dehaze_tpu_torch.cli import stream as cli_stream
from dehaze_tpu_torch.cli.export import main as export_main
from dehaze_tpu_torch.cli.serve import (build_dehaze_fn, make_handler,
                                        warm_up)
from dehaze_tpu_torch.config import ModelConfig
from dehaze_tpu_torch.data import pipeline
from dehaze_tpu_torch.data.images import (decode_img, encode_img, load_img,
                                          save_img)
from dehaze_tpu_torch.infer.export import load_exported
from dehaze_tpu_torch.infer.stream import stream_dehaze
from dehaze_tpu_torch.infer.tiled import make_whole_image_fn, quantize_u8
from dehaze_tpu_torch.models.uformer import Uformer
from dehaze_tpu_torch.ops import probsparse as TPS

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 7
PSZ = 32
TINY = ["--embed_dim", "8", "--train_ps", "32", "--dtype", "float32",
        "--device", "cpu", "--seed", str(SEED)]


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
def setup(tmp_path_factory):
    """A seeded tiny Uformer as .pth; a folder of two 40×56 hazy frames
    and one 48×64; the 40×56 artifact of `cli.export`."""
    root = tmp_path_factory.mktemp("port_stream")
    torch.manual_seed(5)
    model = Uformer(ModelConfig(img_size=PSZ, embed_dim=8,
                                dtype=torch.float32)).eval()
    pth = str(root / "w.pth")
    torch.save({"state_dict": model.state_dict()}, pth)
    src = root / "hazy"
    src.mkdir()
    rng = np.random.default_rng(1)
    for name, (h, w) in (("a.png", (40, 56)), ("b.png", (40, 56)),
                         ("c.png", (48, 64))):
        save_img(str(src / name), rng.integers(0, 256, size=(h, w, 3),
                                               dtype=np.uint8))
    art = str(root / "m.dhz")
    export_main(["--weights", pth, "--height", "40", "--width", "56",
                 "--out", art] + TINY)
    return root, pth, model, art


def _forward(model):
    return lambda c: model(c, generator=torch.Generator().manual_seed(SEED))


def _frames(root, src, out):
    names = sorted(os.listdir(root / src))
    os.makedirs(root / out, exist_ok=True)
    return [(str(root / src / n), str(root / out / n)) for n in names]


@pytest.mark.parametrize("u8", [False, True])
def test_stream_writes_the_in_process_forward(setup, u8):
    """Each PNG `stream_dehaze` writes equals, byte for byte, the encoded
    in-process quantize_u8(make_whole_image_fn(...)) of its frame, over a
    folder of two geometries (one forward each)."""
    root, _, model, _ = setup
    frames = _frames(root, "hazy", f"out_{u8}")
    load = partial(load_img, u8=u8)
    stats = stream_dehaze(_forward(model), frames, ps=PSZ, load_fn=load,
                          device="cpu")
    assert stats["frames"] == 3 and stats["mpix_s"] > 0
    # the time split: each stage's seconds, the pools' busy time included
    assert stats["decode"] > 0 and stats["encode"] > 0 and stats["queue"] > 0
    assert min(stats[k] for k in ("wait_card", "wait_decode")) >= 0
    for src, out in frames:
        img = load(src)
        run = quantize_u8(make_whole_image_fn(_forward(model), *img.shape[:2],
                                              PSZ, square=False,
                                              device="cpu"))
        with open(out, "rb") as f:
            assert f.read() == encode_img(run(img[None])[0].numpy()), src


@pytest.fixture
def pinned(monkeypatch):
    rng = np.random.default_rng(42)
    tables = {n: rng.integers(0, n, size=(n, PS.probsparse_u(n))).astype(
        np.int32) for n in (4, 16, 64)}
    monkeypatch.setattr(PS, "sample_indices",
                        lambda key, l_q, l_k, u_part: jnp.asarray(
                            tables[l_q][:, :u_part]))
    monkeypatch.setattr(TPS, "sample_indices",
                        lambda n_q, n_k, u_part, generator: torch.from_numpy(
                            tables[n_q][:, :u_part].copy()))


def test_stream_matches_jax_stream(setup, pinned):
    """The same weights (the weight bridge) and pinned tables: the port's
    stream against the JAX package's on the 40×56 frames, within one code
    value (a value within 2e-4 of a rounding boundary may round the other
    way)."""
    root, _, model, _ = setup
    src = root / "hazy40"
    src.mkdir(exist_ok=True)
    for n in ("a.png", "b.png"):
        shutil.copy(root / "hazy" / n, src / n)
    params = jax.tree.map(np.asarray,
                          convert_uformer_state_dict(model.state_dict()))
    jmodel = JaxUformer(JaxModelConfig(img_size=PSZ, embed_dim=8,
                                       dtype=jnp.float32))
    jframes = _frames(root, "hazy40", "out_jax")
    jax_stream_dehaze(
        lambda x: jmodel.apply({"params": params}, x, train=False,
                               rngs={"sample": jax.random.PRNGKey(0)}),
        jframes, ps=PSZ)
    frames = _frames(root, "hazy40", "out_port")
    stream_dehaze(_forward(model), frames, ps=PSZ, device="cpu")
    for (_, want), (_, got) in zip(jframes, frames):
        d = np.abs(load_img(got, u8=True).astype(int)
                   - load_img(want, u8=True).astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= 0.01


def test_cli_stream_exported_equals_weights(setup, capsys):
    """`cli.stream --exported` writes the files of `cli.stream --weights
    --no-u8_transfer` (the artifact bakes a float32 input; a uint8 input
    differs by an ulp, which can flip a pixel on a rounding boundary)."""
    root, pth, _, art = setup
    src = root / "hazy40"
    src.mkdir(exist_ok=True)
    for n in ("a.png", "b.png"):
        shutil.copy(root / "hazy" / n, src / n)
    cli_stream.main(["--input_dir", str(src), "--exported", art,
                     "--device", "cpu", "--result_dir",
                     str(root / "cli_art")])
    assert "2 frames in " in capsys.readouterr().out
    cli_stream.main(["--input_dir", str(src), "--weights", pth,
                     "--no-u8_transfer", "--result_dir",
                     str(root / "cli_w")] + TINY)
    assert "(rect canvas)" in capsys.readouterr().out
    for n in ("a.png", "b.png"):
        with open(root / "cli_art" / n, "rb") as a, \
                open(root / "cli_w" / n, "rb") as b:
            assert a.read() == b.read(), n


def test_cli_stream_subprocess_hazy_subdir(setup, tmp_path):
    """The user's flow: a folder with a HAZY/ subdirectory, the artifact,
    a JPEG input written out as a PNG of its name."""
    root, _, _, art = setup
    Image = pytest.importorskip("PIL.Image")
    (tmp_path / "in" / "HAZY").mkdir(parents=True)
    shutil.copy(root / "hazy" / "a.png", tmp_path / "in" / "HAZY" / "a.png")
    Image.fromarray(load_img(str(root / "hazy" / "b.png"), u8=True)).save(
        tmp_path / "in" / "HAZY" / "b.jpg", quality=95)
    r = subprocess.run(
        [sys.executable, "-m", "dehaze_tpu_torch.cli.stream", "--input_dir",
         str(tmp_path / "in"), "--exported", art, "--device", "cpu",
         "--result_dir", str(tmp_path / "out")], capture_output=True,
        text=True, timeout=300, env={**os.environ, "PYTHONPATH": _REPO})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "2 frames in " in r.stdout and "(exported canvas)" in r.stdout
    assert sorted(os.listdir(tmp_path / "out")) == ["a.png", "b.png"]
    assert decode_img((tmp_path / "out" / "b.png").read_bytes(),
                      u8=True).shape == (40, 56, 3)


def test_stream_refuses_other_geometry_and_mesh(setup):
    root, _, _, art = setup
    fn, meta = load_exported(art, "cpu")
    frames = _frames(root, "hazy", "out_bad")
    with pytest.raises(ValueError, match="48x64 but the exported artifact "
                                         "bakes 40x56"):
        stream_dehaze(None, frames, base_fn=fn,
                      base_hw=(meta["height"], meta["width"]), device="cpu")
    with pytest.raises(ValueError, match="artifact serves single-device"):
        stream_dehaze(None, frames, base_fn=fn,
                      base_hw=(meta["height"], meta["width"]),
                      device="cpu", data_parallel=True)


def _args(**kw):
    base = dict(weights=None, exported=None, train_ps=PSZ, square=False,
                device="cpu", seed=SEED, max_batch=4, u8_transfer=True)
    base.update(kw)
    return SimpleNamespace(**base)


def _cfg():
    return ModelConfig(img_size=PSZ, embed_dim=8, dtype=torch.float32)


def _post(url, body):
    req = urllib.request.Request(url + "/dehaze", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.read()


def test_serve_exported(setup):
    """A request at the baked geometry gets the bytes `--weights` gives
    (float32 input on both sides); another geometry a 400 naming the baked
    one; /healthz shows max_batch 1, the geometry and no uint8 input."""
    _, pth, _, art = setup
    img = np.random.default_rng(9).integers(0, 256, size=(40, 56, 3),
                                            dtype=np.uint8)
    dehaze_w, _ = build_dehaze_fn(_args(weights=pth, u8_transfer=False),
                                  _cfg())
    try:
        want = encode_img(dehaze_w(decode_img(encode_img(img))))
    finally:
        dehaze_w.batcher.close()
    dehaze, info = build_dehaze_fn(_args(exported=art, max_batch=4), _cfg())
    assert warm_up(dehaze, info, "auto") > 0 and info["served"] == 0
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(dehaze, info))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_port}"
    try:
        assert _post(url, encode_img(img)) == (200, want)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, encode_img(np.zeros((48, 64, 3), np.uint8)))
        assert e.value.code == 400
        assert b"bakes 40x56" in e.value.read()
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        dehaze.batcher.close()
    assert health["max_batch"] == 1 and health["geometry"] == [40, 56]
    assert health["u8_input"] is False and health["served"] == 1


def test_serve_precompile_auto_needs_exported(setup):
    dehaze, info = build_dehaze_fn(_args(weights=setup[1]), _cfg())
    try:
        assert info["max_batch"] == 4 and info["u8_input"] is True
        with pytest.raises(SystemExit, match="needs --exported"):
            warm_up(dehaze, info, "auto")
    finally:
        dehaze.batcher.close()


def test_cli_serve_exported_subprocess(setup):
    """`cli.serve --exported --precompile auto` as the user runs it."""
    art = setup[3]
    proc = subprocess.Popen(
        [sys.executable, "-m", "dehaze_tpu_torch.cli.serve", "--exported",
         art, "--port", "0", "--device", "cpu", "--precompile", "auto"],
        env={**os.environ, "PYTHONPATH": _REPO}, stdout=subprocess.PIPE,
        text=True)
    try:
        assert proc.stdout.readline().startswith("warmed auto")
        url = "http://" + proc.stdout.readline().split("http://")[1].split()[0]
        status, body = _post(url, encode_img(np.zeros((40, 56, 3),
                                                      np.uint8)))
        assert status == 200
        assert decode_img(body, u8=True).shape == (40, 56, 3)
    finally:
        proc.terminate()
        proc.wait(timeout=30)


@pytest.mark.parametrize("subdir", ["HAZY", ""])
def test_test_images_matches_jax(tmp_path, subdir):
    """The hazy-only iterator, under HAZY/ or flat: names and pixels as the
    JAX package's."""
    root = tmp_path / subdir if subdir else tmp_path
    root.mkdir(exist_ok=True)
    rng = np.random.default_rng(2)
    for n in ("b.png", "a.png"):
        save_img(str(root / n), rng.integers(0, 256, size=(8, 12, 3),
                                             dtype=np.uint8))
    (root / "notes.txt").write_text("skipped")
    got = list(pipeline.test_images(str(tmp_path), subdir))
    want = list(jax_pipeline.test_images(str(tmp_path), subdir))
    assert [n for _, n in got] == [n for _, n in want] == ["a.png", "b.png"]
    for (a, _), (b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)
