"""Halo-banded inference of one frame over several processes, on the CPU:
`parallel.halo`, `infer.halo_sharded` and `--bands` on `cli.test_long` and
`cli.test_anyres`.

The banded runs are real gloo ranks, one process each (2 and 4 bands),
started once per band count by a module fixture; the JAX side is
`dehaze_tpu.infer.halo_sharded` on the conftest's virtual CPU devices.
Tiny model (embed 8, img_size 32, f32), ProbSparse sampling pinned on
every side. Tolerances: the port's banded forward against its own
one-process forward 2e-5 (the bar of `tests/test_halo_sharding.py`),
against JAX's banded forward 2e-4; the CLIs' per-image lines within
1e-3 dB.
"""

import json
import os
import socket
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dehaze_tpu.config import ModelConfig as JaxModelConfig
from dehaze_tpu.infer import halo_sharded as jhalo
from dehaze_tpu.ops import probsparse as PS
from dehaze_tpu.parallel.mesh import make_mesh
from dehaze_tpu.utils.convert_torch import convert_uformer_state_dict
from dehaze_tpu_torch.config import ModelConfig
from dehaze_tpu_torch.data.synth import write_dataset
from dehaze_tpu_torch.infer import halo_sharded as thalo
from dehaze_tpu_torch.infer.anyres import make_anyres_fn
from dehaze_tpu_torch.infer.tiled import make_whole_image_fn
from dehaze_tpu_torch.models.uformer import Uformer
from dehaze_tpu_torch.ops import probsparse as TPS
from dehaze_tpu_torch.parallel.halo import Bands

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PS_ = 32  # --train_ps: the canvas multiple
# (name, bands, kind, h, w, square, compared with the one-process port):
# the exact cases divide band_unit · n = 128 · n rows; 'pad_exceeds' pads
# a 64-row canvas to 256 (the wrap fill tiles); 'anyres_pad' pads the
# 128-row any-resolution canvas with 128 masked rows.
CASES = [
    ("frame_square", 2, "frame", 250, 250, True, True),
    ("frame_rect", 2, "frame", 230, 60, False, True),
    ("frame_pad_exceeds", 2, "frame", 40, 56, True, False),
    ("anyres", 2, "anyres", 250, 200, None, True),
    ("anyres_pad", 2, "anyres", 100, 90, None, False),
    ("frame_rect", 4, "frame", 500, 60, False, True),
    ("anyres", 4, "anyres", 500, 400, None, True),
]
# JAX's banded forward at 2 bands (both with the alignment pad) and 4
JAX_CASES = [("frame_pad_exceeds", 2), ("anyres_pad", 2), ("frame_rect", 4),
             ("anyres", 4)]

# Each rank: the halo primitives on its band of a seeded canvas, then every
# case of its band count through infer.halo_sharded with pinned sampling;
# rank 0 saves the outputs, every rank its primitives' bands.
WORKER = r'''
import json, sys, warnings
import numpy as np, torch
torch.set_num_threads(1)
from dehaze_tpu_torch.config import ModelConfig
from dehaze_tpu_torch.infer import halo_sharded as H
from dehaze_tpu_torch.models.uformer import Uformer
from dehaze_tpu_torch.ops import probsparse as TPS
from dehaze_tpu_torch.parallel import dist, halo

out_dir, cases = sys.argv[1], json.loads(sys.argv[2])
dist.init("cpu")
r, n = dist.rank(), dist.world()
bands = halo.Bands.of_group()
tables = {k: v for k, v in np.load(f"{out_dir}/tables.npz").items()}
TPS.sample_indices = lambda nq, nk, u, g: torch.from_numpy(
    tables[str(nq)][:, :u].copy())
x = torch.from_numpy(np.random.default_rng(7).normal(
    size=(2, 4 * n, 5, 3)).astype(np.float32))
xl = halo.band_rows(x, bands)
prims = {"halo": halo.halo_rows(xl, 1, 1, bands),
         "halo_wrap": halo.halo_rows(xl, 2, 1, bands, wrap=True),
         "roll_up": halo.roll_rows(xl, 3, bands),
         "roll_down": halo.roll_rows(xl, -3, bands),
         "shift": halo.cyclic_shift_banded(xl, 2, bands),
         "unshift": halo.cyclic_unshift_banded(xl, 2, bands)}
np.savez(f"{out_dir}/prims_{n}_{r}.npz",
         **{k: v.numpy() for k, v in prims.items()})
torch.manual_seed(0)
model = Uformer(ModelConfig(img_size=32, embed_dim=8,
                            dtype=torch.float32)).eval()
outs = {}
for name, kind, h, w, square in cases:
    img = np.random.default_rng(h * 1000 + w).uniform(
        size=(1, h, w, 3)).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the alignment pad warns
        run = (H.make_halo_sharded_frame_fn(model, h, w, 32, square=square,
                                            device="cpu")
               if kind == "frame" else
               H.make_halo_sharded_anyres_fn(model, h, w, 128, device="cpu"))
    outs[name] = run(img).numpy()
if r == 0:
    np.savez(f"{out_dir}/out_{n}.npz", **outs)
dist.shutdown()
'''


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(script: str, n: int, args, cwd: str):
    """n processes of `python -c script args...` as the ranks of one gloo
    group (the variables torchrun would set)."""
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, "-c", script] + [str(a) for a in args], cwd=cwd,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": _REPO, "OMP_NUM_THREADS": "1",
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
             "RANK": str(r), "WORLD_SIZE": str(n), "LOCAL_RANK": str(r)})
        for r in range(n)]


def wait_all(procs, timeout=300):
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            p.kill()


@pytest.fixture(scope="module")
def banded(tmp_path_factory, tables):
    """{n: (outputs of rank 0 by case, [primitives of each rank])}: both
    band counts run as background processes until the first test asks."""
    td = tmp_path_factory.mktemp("bands")
    np.savez(td / "tables.npz", **{str(k): v for k, v in tables.items()})
    procs = {n: launch(WORKER, n, [td, json.dumps(
        [c[0:1] + c[2:6] for c in CASES if c[1] == n])], str(td))
        for n in (2, 4)}
    done = {}

    def get(n):
        if n not in done:
            wait_all(procs[n])
            done[n] = (dict(np.load(td / f"out_{n}.npz")),
                       [dict(np.load(td / f"prims_{n}_{r}.npz"))
                        for r in range(n)])
        return done[n]

    yield get
    for ps in procs.values():
        for p in ps:
            p.kill()


def _port_model():
    torch.manual_seed(0)
    return Uformer(ModelConfig(img_size=32, embed_dim=8,
                               dtype=torch.float32)).eval()


def _img(h, w):
    return np.random.default_rng(h * 1000 + w).uniform(
        size=(1, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("n", [2, 4])
def test_halo_primitives_match_roll_and_zero_padding(banded, n):
    """halo_rows against zero padding (and the cyclic ring with wrap),
    roll_rows and the banded shift/unshift against torch.roll of the
    whole canvas."""
    _, prims = banded(n)
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(2, 4 * n, 5, 3)).astype(np.float32))
    padded = torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 1))
    wrapped = torch.cat([x[:, -2:], x, x[:, :1]], 1)
    for r in range(n):
        got = {k: torch.from_numpy(v) for k, v in prims[r].items()}
        lo = 4 * r
        torch.testing.assert_close(got["halo"], padded[:, lo:lo + 6],
                                   rtol=0, atol=0)
        torch.testing.assert_close(got["halo_wrap"], wrapped[:, lo:lo + 7],
                                   rtol=0, atol=0)
        for key, want in (
                ("roll_up", torch.roll(x, -3, 1)),
                ("roll_down", torch.roll(x, 3, 1)),
                ("shift", torch.roll(x, (-2, -2), (1, 2))),
                ("unshift", torch.roll(x, (2, 2), (1, 2)))):
            torch.testing.assert_close(got[key], want[:, lo:lo + 4],
                                       rtol=0, atol=0, msg=key)


@pytest.mark.parametrize("name,n", [(c[0], c[1]) for c in CASES if c[6]])
def test_banded_forward_equals_one_process(banded, pinned, name, n):
    """The banded forward of n ranks against the port's one-process
    forward on the same canvas (the canvas divides 128 · n rows)."""
    _, _, kind, h, w, square, _ = next(c for c in CASES
                                       if c[:2] == (name, n))
    model = _port_model()
    if kind == "frame":
        ref = make_whole_image_fn(
            lambda x: model(x, generator=torch.Generator()), h, w, PS_,
            square=square, device="cpu")(_img(h, w))
    else:
        ref = make_anyres_fn(
            lambda x, p: model(x, generator=torch.Generator(), pad_mask=p),
            h, w, 128, device="cpu")(_img(h, w))
    got = banded(n)[0][name]
    assert got.shape == (1, h, w, 3)
    np.testing.assert_allclose(got, ref.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name,n", JAX_CASES)
def test_banded_forward_matches_jax_halo_sharded(banded, pinned, name, n):
    """The port's banded forward against JAX's make_halo_sharded_frame_fn /
    make_halo_sharded_anyres_fn on an n-device mesh, the alignment-pad
    cases included."""
    _, _, kind, h, w, square, _ = next(c for c in CASES
                                       if c[:2] == (name, n))
    cfg = JaxModelConfig(img_size=32, embed_dim=8, dtype=jnp.float32)
    variables = {"params": jax.tree.map(
        jnp.asarray, convert_uformer_state_dict(_port_model().state_dict()))}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the alignment pad warns
        run = (jhalo.make_halo_sharded_frame_fn(
                   cfg, variables, make_mesh(n), h, w, ps=PS_, square=square)
               if kind == "frame" else
               jhalo.make_halo_sharded_anyres_fn(
                   cfg, variables, make_mesh(n), h, w, factor=128))
    want = np.asarray(run(_img(h, w)))
    np.testing.assert_allclose(banded(n)[0][name], want, rtol=2e-4,
                               atol=2e-4)


def test_band_unit_and_alignment_warnings():
    """band_unit is JAX's; a canvas that needs the alignment pad warns (the
    frame with wrap-filled rows, the any-resolution canvas with masked
    ones), one that divides does not."""
    model = _port_model()
    assert thalo.band_unit(model.cfg) == jhalo.band_unit(
        JaxModelConfig(img_size=32, embed_dim=8)) == 128
    with pytest.warns(UserWarning, match="pads the 64-row canvas to 256 "
                                         "wrap-filled rows"):
        thalo.make_halo_sharded_frame_fn(model, 40, 56, PS_, square=True,
                                         bands=Bands(0, 2), device="cpu")
    with pytest.warns(UserWarning, match="pads the 256-row canvas to 512 "
                                         "masked rows"):
        thalo.make_halo_sharded_anyres_fn(model, 250, 200, 128,
                                          bands=Bands(1, 4), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        thalo.make_halo_sharded_frame_fn(model, 230, 60, PS_, square=False,
                                         bands=Bands(0, 2), device="cpu")
    # the native (no-canvas) banded forward is FFA-Net's only
    with pytest.raises(ValueError, match="native banded inference is "
                                         "FFA-only.*arch='uformer'"):
        thalo.make_halo_sharded_native_fn(model, bands=Bands(0, 2),
                                          device="cpu")


# ------------------------------------------------------------------ CLIs

@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("bands_cli")
    write_dataset(str(root / "DS"), 2, (230, 60), seed=5)
    torch.manual_seed(4)
    pth = str(root / "w.pth")
    torch.save(Uformer(ModelConfig(img_size=32, embed_dim=8,
                                   dtype=torch.float32)).state_dict(), pth)
    return root, pth


def _numbers(line):
    """The PSNR and SSIM of a per-image or mean line."""
    return [float(t) for t in line.replace(",", " ").split()
            if t[0].isdigit() and not t.endswith(".png:")]


def _lines(stdout):
    return [ln for ln in stdout.splitlines() if ": PSNR " in ln
            or ln.startswith("PSNR: ")]


@pytest.mark.parametrize("cli,extra", [("test_long", ["--rect_canvas"]),
                                       ("test_anyres", [])])
def test_cli_bands_gives_one_process_lines(cli_setup, cli, extra):
    """`torchrun --nproc_per_node 2 -m ...{cli} --bands 2` prints the
    one-process run's per-image and mean lines (within 1e-3 dB), from rank
    0 only; its PNGs are the one-process ones within one level."""
    from dehaze_tpu_torch.data.images import load_img

    root, pth = cli_setup
    flags = ["--input_dir", str(root / "DS"), "--weights", pth, "--device",
             "cpu", "--embed_dim", "8", "--train_ps", "32", "--dtype",
             "float32"] + extra
    one = subprocess.run(
        [sys.executable, "-m", f"dehaze_tpu_torch.cli.{cli}", "--result_dir",
         str(root / f"{cli}_1")] + flags, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": _REPO})
    assert one.returncode == 0, one.stderr[-3000:]
    two = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", f"dehaze_tpu_torch.cli.{cli}",
         "--result_dir", str(root / f"{cli}_2"), "--bands", "2"] + flags,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": _REPO})
    assert two.returncode == 0, two.stderr[-3000:]
    want, got = _lines(one.stdout), _lines(two.stdout)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.split(":")[0] == b.split(":")[0]
        np.testing.assert_allclose(_numbers(a), _numbers(b), rtol=0,
                                   atol=1e-3)
    for name in ("00000.png", "00001.png"):
        a = load_img(str(root / f"{cli}_2" / name), u8=True).astype(int)
        b = load_img(str(root / f"{cli}_1" / name), u8=True).astype(int)
        assert np.abs(a - b).max() <= 1


def test_cli_bands_refusals(cli_setup):
    """--bands N needs N processes started by torchrun; --bands with
    --data_axis is refused, as in the JAX CLI."""
    from dehaze_tpu_torch.cli import test_anyres, test_long

    root, pth = cli_setup
    base = ["--input_dir", str(root / "DS"), "--weights", pth, "--device",
            "cpu", "--embed_dim", "8", "--train_ps", "32"]
    for cli in (test_long, test_anyres):
        with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
            cli.main(base + ["--bands", "2"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        test_long.main(base + ["--bands", "2", "--data_axis", "2"])
    with pytest.raises(SystemExit, match="has no --data_axis"):
        test_anyres.main(base + ["--data_axis", "2"])
