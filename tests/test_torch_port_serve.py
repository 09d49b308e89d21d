"""The port's serving path on the CPU: the PNG codec against PIL,
the HTTP server in-process and as a CLI subprocess, and the rule that the
port imports neither jax nor the JAX package."""

import concurrent.futures as cf
import json
import os
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib
from http.server import ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dehaze_tpu_torch.cli.serve import (MicroBatcher, build_dehaze_fn,
                                        make_handler)
from dehaze_tpu_torch.config import ModelConfig
from dehaze_tpu_torch.data.images import decode_img, encode_img
from dehaze_tpu_torch.infer.tiled import make_whole_image_fn, quantize_u8
from dehaze_tpu_torch.models.uformer import Uformer

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU tensors: with several test
    workers on the host, torch's thread pools stall each other in
    hand-offs (a small op then takes tens of times as long)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _filtered_png(img, ctype):
    """A PNG whose rows cycle through filter types 0-4 (encoded here)."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    out = []
    for y in range(h):
        ft = y % 5
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([ft]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(b"".join(out)))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype,channels", [(0, 1), (2, 3), (6, 4)])
def test_png_decode_all_filters_matches_pil(ctype, channels):
    Image = pytest.importorskip("PIL.Image")
    import io

    img = np.random.default_rng(ctype).integers(0, 256, size=(11, 7, channels),
                                                dtype=np.uint8)
    data = _filtered_png(img, ctype)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(decode_img(data, u8=True), want)
    np.testing.assert_array_equal(
        decode_img(data), want.astype(np.float32) / 255.0)


def test_png_encode_round_trips_through_pil():
    Image = pytest.importorskip("PIL.Image")
    import io

    img = np.random.default_rng(1).integers(0, 256, size=(9, 13, 3),
                                            dtype=np.uint8)
    data = encode_img(img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)
    bio = io.BytesIO()
    Image.fromarray(img).save(bio, format="PNG")  # PIL's own filters
    np.testing.assert_array_equal(decode_img(bio.getvalue(), u8=True), img)
    f = np.random.default_rng(2).uniform(size=(4, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(decode_img(encode_img(f), u8=True),
                                  np.clip(f * 255 + 0.5, 0, 255).astype(
                                      np.uint8))


# the start of a baseline JPEG (SOI, then an APP0/JFIF marker segment)
JPEG_HEAD = b"\xff\xd8\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01"


def test_png_rejects_unsupported():
    """What stays refused: a truncated JPEG (named), payloads that are no
    image, and encoding anything but PNG. (16-bit and the other PNG formats
    decode: tests/test_torch_port_images.py; JPEG:
    tests/test_torch_port_jpeg.py.)"""
    with pytest.raises(ValueError, match="not a PNG or BMP"):
        decode_img(b"not an image")
    with pytest.raises(ValueError, match="truncated JPEG"):
        decode_img(JPEG_HEAD + bytes(64))
    with pytest.raises(ValueError):
        encode_img(np.zeros((2, 2, 3), np.uint8), ext=".jpg")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    torch.manual_seed(SEED)
    model = Uformer(ModelConfig(img_size=32, embed_dim=8,
                                dtype=torch.float32))
    path = str(tmp_path_factory.mktemp("port_serve") / "w.pth")
    torch.save({"state_dict": model.state_dict()}, path)
    return path, model.eval()


def _args(weights, **kw):
    base = dict(weights=weights, train_ps=32, square=False, device="cpu",
                seed=SEED, max_batch=4)
    base.update(kw)
    return SimpleNamespace(**base)


def _cfg():
    return ModelConfig(img_size=32, embed_dim=8, dtype=torch.float32)


@pytest.fixture(scope="module")
def server(weights):
    dehaze, info = build_dehaze_fn(_args(weights[0]), _cfg())
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(dehaze, info))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()
    srv.server_close()
    dehaze.batcher.close()


def _post(url, body):
    req = urllib.request.Request(url + "/dehaze", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.headers["Content-Type"], r.read()


def test_serve_answers_post_like_the_library_path(server, weights):
    img = np.random.default_rng(4).integers(0, 256, size=(40, 56, 3),
                                            dtype=np.uint8)
    status, ctype, body = _post(server, encode_img(img))
    assert status == 200 and ctype == "image/png"
    got = decode_img(body, u8=True)

    model = weights[1]
    run = quantize_u8(make_whole_image_fn(
        lambda x: model(x, generator=torch.Generator().manual_seed(SEED)),
        40, 56, 32, square=False, device="cpu"))
    np.testing.assert_array_equal(got, run(img[None])[0].numpy())

    with urllib.request.urlopen(server + "/healthz", timeout=60) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["served"] >= 1


def test_serve_concurrent_posts_group_and_bad_payload(server):
    img = np.random.default_rng(5).integers(0, 256, size=(40, 56, 3),
                                            dtype=np.uint8)
    body = encode_img(img)
    with cf.ThreadPoolExecutor(6) as ex:
        outs = list(ex.map(lambda _: _post(server, body), range(6)))
    assert [o[0] for o in outs] == [200] * 6
    assert len({o[2] for o in outs}) == 1  # deterministic per request
    with urllib.request.urlopen(server + "/healthz", timeout=60) as r:
        hist = json.loads(r.read())["batch_hist"]
    assert sum(int(k) * v for k, v in hist.items()) >= 6
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, b"not an image")
    assert e.value.code == 400


def test_serve_answers_jpeg_with_400(server):
    """A JPEG the decoder refuses (here a truncated one) gets a 400 that
    names it."""
    req = urllib.request.Request(server + "/dehaze",
                                 data=JPEG_HEAD + bytes(64), method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 400
    assert b"truncated JPEG" in e.value.read()


def test_serve_answers_jpeg_as_its_pixels_in_png(server):
    """A JPEG body gets a 200 and the same PNG answer as a PNG body of the
    pixels the JPEG decodes to."""
    Image = pytest.importorskip("PIL.Image")
    import io

    img = np.random.default_rng(6).integers(0, 256, size=(40, 56, 3),
                                            dtype=np.uint8)
    bio = io.BytesIO()
    Image.fromarray(img).save(bio, "JPEG", quality=90)
    status, ctype, body = _post(server, bio.getvalue())
    assert status == 200 and ctype == "image/png"
    pixels = decode_img(bio.getvalue(), u8=True)
    assert _post(server, encode_img(pixels)) == (status, ctype, body)


def test_micro_batcher_groups_and_preserves_order():
    calls = []

    def get_run(h, w):
        def run(x):
            calls.append(x.shape[0])
            time.sleep(0.2)
            return torch.from_numpy(x)

        return run

    mb = MicroBatcher(get_run, max_batch=4)
    try:
        imgs = [np.full((4, 4, 3), i, np.uint8) for i in range(6)]
        with cf.ThreadPoolExecutor(6) as ex:
            first = ex.submit(mb.submit, imgs[0])
            time.sleep(0.05)
            rest = [ex.submit(mb.submit, im) for im in imgs[1:]]
            outs = [first.result(timeout=30)] + [f.result(timeout=30)
                                                 for f in rest]
        for im, out in zip(imgs, outs):
            np.testing.assert_array_equal(im, out)
        assert calls[0] == 1 and sum(calls) == 6 and 1 < max(calls) <= 4
    finally:
        mb.close()


def test_cli_serve_subprocess(weights):
    """The user's flow: the CLI with --precompile, on the CPU."""
    env = {**os.environ, "PYTHONPATH": _REPO}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dehaze_tpu_torch.cli.serve", "--weights",
         weights[0], "--port", "0", "--embed_dim", "8", "--train_ps", "32",
         "--dtype", "float32", "--device", "cpu", "--precompile", "40x56"],
        env=env, stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().startswith("warmed 40x56")
        url = "http://" + proc.stdout.readline().split("http://")[1].split()[0]
        img = np.zeros((40, 56, 3), np.uint8)
        status, _, body = _post(url, encode_img(img))
        assert status == 200 and decode_img(body, u8=True).shape == (40, 56,
                                                                      3)
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'dehaze_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import dehaze_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "dehaze_tpu_torch.__path__, 'dehaze_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(len(mods))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": _REPO})
    assert r.returncode == 0, r.stderr[-2000:]
    assert int(r.stdout.strip()) >= 15
