"""The port's serving artifact (`infer/export.py`, `cli/export.py`, the
`--exported` leg of `cli/common.resolve_forward` and `cli.test_long`) on
the CPU, at embed 8 and 40×56 frames, in f32.

- The artifact equals the port's eager forward with the same seed, bit
  for bit; loaded in a fresh process that imports no model code, too.
- Its graph holds one K1-forward and one K2 operator node per LeWin block
  and no softmax or GELU: the kernels stay in the artifact.
- The port's artifact and the JAX package's (`dehaze_tpu.infer.export`) of
  the same weights (the weight bridge) with the same pinned sample tables
  agree within 2e-4.
"""

import collections
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dehaze_tpu.config import ModelConfig as JaxModelConfig
from dehaze_tpu.infer import export as jax_export
from dehaze_tpu.infer.tiled import (make_whole_image_fn as
                                    jax_make_whole_image_fn)
from dehaze_tpu.models.uformer import Uformer as JaxUformer
from dehaze_tpu.ops import probsparse as PS
from dehaze_tpu.utils.convert_torch import convert_uformer_state_dict
from dehaze_tpu_torch.cli import export as cli_export
from dehaze_tpu_torch.cli import test_anyres, test_long
from dehaze_tpu_torch.config import ModelConfig
from dehaze_tpu_torch.data.synth import write_dataset
from dehaze_tpu_torch.infer import export as E
from dehaze_tpu_torch.infer.tiled import make_whole_image_fn
from dehaze_tpu_torch.models.uformer import Uformer, draw_sample_tables
from dehaze_tpu_torch.ops import probsparse as TPS
from dehaze_tpu_torch.utils.convert import state_dict_from_jax_params

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, PSZ = 40, 56, 32
SEED = 5
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


def _cfg(**kw):
    return ModelConfig(img_size=PSZ, embed_dim=8, dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A seeded tiny Uformer saved as .pth, a two-pair 40×56 folder and
    the artifact `cli.export` writes for them (a subprocess: the user's
    flow)."""
    root = tmp_path_factory.mktemp("port_export")
    torch.manual_seed(3)
    model = Uformer(_cfg()).eval()
    pth = str(root / "w.pth")
    torch.save({"state_dict": model.state_dict()}, pth)
    write_dataset(str(root / "DS"), 2, (H, W), seed=3)
    art = str(root / "m.dhz")
    r = subprocess.run(
        [sys.executable, "-m", "dehaze_tpu_torch.cli.export", "--weights",
         pth, "--height", str(H), "--width", str(W), "--out", art] + TINY,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": _REPO})
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith(f"exported rect-canvas {H}x{W} uformer "
                               f"forward -> {art} (")
    return root, pth, model, art


def _eager(model, square=False):
    """The --weights forward: sampling re-seeded from SEED at every call."""
    return make_whole_image_fn(
        lambda c: model(c, generator=torch.Generator().manual_seed(SEED)),
        H, W, PSZ, square=square, device="cpu")


def _frame(seed):
    return np.random.default_rng(seed).uniform(size=(1, H, W, 3)).astype(
        np.float32)


def test_artifact_equals_eager_forward_bit_for_bit(setup):
    _, _, model, art = setup
    fn, meta = E.load_exported(art, "cpu")
    assert (meta["height"], meta["width"], meta["canvas"], meta["seed"],
            meta["trace_device"]) == (H, W, "rect", SEED, "cpu")
    assert meta["torch_version"] == torch.__version__
    for seed in (0, 1):
        x = _frame(seed)
        assert torch.equal(fn(x), _eager(model)(x))


def test_sample_tables_are_what_a_seeded_forward_draws(setup):
    """draw_sample_tables gives one table per block, and a forward on them
    equals the generator forward; a list of the wrong length raises."""
    model = setup[2]
    tables = draw_sample_tables(model, torch.Generator().manual_seed(SEED))
    assert [tuple(t.shape) for t in tables[:3]] == [(64, 25)] * 3
    assert len(tables) == sum(model.cfg.depths) == 18
    x = torch.from_numpy(_frame(2)[:, :32, :32])
    with torch.inference_mode():
        want = model(x, generator=torch.Generator().manual_seed(SEED))
        assert torch.equal(model(x, sample_tables=tables), want)
        with pytest.raises(ValueError, match="17 tables"):
            model(x, sample_tables=tables[:-1])


def test_graph_keeps_k1_and_k2_as_operators(setup):
    """One K1-forward node and one K2 node per LeWin block, no softmax or
    GELU (the twins are not traced in); moved to another device, no node
    names the trace device any more."""
    art = setup[3]
    ep, _ = E.load_program(art, "cpu")
    ops = collections.Counter(str(n.target) for n in ep.graph.nodes
                              if n.op == "call_function")
    blocks = sum(_cfg().depths)
    assert ops["dehaze_tpu_torch.window_attention_fwd.default"] == blocks
    assert ops["dehaze_tpu_torch.leff_fused.default"] == blocks
    assert not [k for k in ops if "softmax" in k or "gelu" in k]
    assert E.graph_devices(ep) == {"cpu"}
    moved, _ = E.load_program(art, "meta")
    assert E.graph_devices(moved) == {"meta"}
    assert all(t.device.type == "meta" for t in moved.state_dict.values())


def test_artifact_runs_in_a_fresh_process_without_model_code(setup,
                                                             tmp_path):
    _, _, model, art = setup
    x = _frame(3)
    np.save(tmp_path / "x.npy", x)
    code = (
        "import sys, numpy as np\n"
        "from dehaze_tpu_torch.infer.export import load_exported\n"
        f"fn, meta = load_exported({art!r}, 'cpu')\n"
        f"y = fn(np.load({str(tmp_path / 'x.npy')!r}))\n"
        f"np.save({str(tmp_path / 'y.npy')!r}, y.numpy())\n"
        "bad = [m for m in sys.modules if m.startswith("
        "('dehaze_tpu_torch.models', 'dehaze_tpu_torch.cli', 'jax', "
        "'dehaze_tpu.'))]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": _REPO})
    assert r.returncode == 0, r.stderr[-3000:]
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"),
                                  _eager(model)(x).numpy())


def test_square_artifact_in_process(setup, tmp_path):
    """`cli.export --square` in process: the square canvas, bit for bit."""
    _, pth, model, _ = setup
    art = str(tmp_path / "sq.dhz")
    res = cli_export.main(["--weights", pth, "--height", str(H), "--width",
                           str(W), "--out", art, "--square"] + TINY)
    assert res["meta"]["canvas"] == "square"
    fn, _ = E.load_exported(art, "cpu")
    x = _frame(4)
    assert torch.equal(fn(x), _eager(model, square=True)(x))


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(42)
    return {n: rng.integers(0, n, size=(n, PS.probsparse_u(n))).astype(
        np.int32) for n in (4, 16, 64)}


def test_artifact_matches_jax_artifact(setup, tables, monkeypatch, tmp_path):
    """The same weights through the weight bridge and the same pinned
    tables: the port's artifact against the JAX package's, within 2e-4."""
    model = setup[2]
    params = jax.tree.map(np.asarray,
                          convert_uformer_state_dict(model.state_dict()))
    monkeypatch.setattr(PS, "sample_indices",
                        lambda key, l_q, l_k, u_part: jnp.asarray(
                            tables[l_q][:, :u_part]))
    monkeypatch.setattr(TPS, "sample_indices",
                        lambda n_q, n_k, u_part, generator: torch.from_numpy(
                            tables[n_q][:, :u_part].copy()))
    jmodel = JaxUformer(JaxModelConfig(img_size=PSZ, embed_dim=8,
                                       dtype=jnp.float32))
    jrun = jax_make_whole_image_fn(
        lambda x: jmodel.apply({"params": params}, x, train=False,
                               rngs={"sample": jax.random.PRNGKey(0)}),
        H, W, PSZ, square=False)
    jart = str(tmp_path / "jax.dhz")
    jax_export.save_exported(jart, jax_export.export_whole_image_bytes(
        jrun, H, W), {"height": H, "width": W})
    jfn, _ = jax_export.load_exported(jart)

    port = Uformer(_cfg()).eval()
    port.load_state_dict(state_dict_from_jax_params(params), strict=True)
    pinned = draw_sample_tables(port, None)
    art = str(tmp_path / "port.dhz")
    E.save_exported(art, E.export_whole_image_bytes(
        E.WholeImage(port, pinned, H, W, PSZ, False), H, W, "cpu"),
        {"height": H, "width": W})
    fn, _ = E.load_exported(art, "cpu")
    x = _frame(6)
    np.testing.assert_allclose(fn(x).numpy(), np.asarray(jfn(jnp.asarray(x))),
                               rtol=2e-4, atol=2e-4)


def test_test_long_exported_matches_weights_rect_canvas(setup, capsys):
    """`cli.test_long --exported` prints the summary line of `--weights
    --rect_canvas` (the canvas the artifact bakes), per image too."""
    root, pth, _, art = setup
    flags = ["--input_dir", str(root / "DS"), "--no-save_images"]
    got = test_long.main(flags + ["--exported", art, "--device", "cpu"])
    out_exp = capsys.readouterr().out
    want = test_long.main(flags + ["--weights", pth, "--rect_canvas"] + TINY)
    out_w = capsys.readouterr().out
    assert got["psnr"] == want["psnr"] and got["ssim"] == want["ssim"]
    assert out_exp.splitlines()[:3] == out_w.splitlines()[:3]
    assert out_exp.splitlines()[2].startswith("PSNR: ")


def test_test_long_exported_refusals(setup, tmp_path):
    root, pth, _, art = setup
    base = ["--input_dir", str(root / "DS"), "--device", "cpu",
            "--no-save_images"]
    with pytest.raises(SystemExit, match="exactly one of --weights / "
                                         "--exported"):
        test_long.main(base + ["--exported", art, "--weights", pth])
    with pytest.raises(SystemExit, match="exactly one"):
        test_long.main(base)
    for flag in (["--rect_canvas"], ["--bands", "2"], ["--data_axis", "2"]):
        with pytest.raises(SystemExit, match="--exported bakes its canvas"):
            test_long.main(base + ["--exported", art] + flag)
    write_dataset(str(tmp_path / "DS48"), 1, (48, W), seed=4)
    with pytest.raises(SystemExit, match=f"48x{W} but the artifact bakes "
                                         f"{H}x{W}"):
        test_long.main(["--input_dir", str(tmp_path / "DS48"), "--exported",
                        art, "--device", "cpu", "--no-save_images"])


def test_test_anyres_has_no_exported_flag(setup, capsys):
    """The JAX `test_anyres` has no --exported; the port's refuses it
    instead of ignoring it."""
    root, pth, _, art = setup
    with pytest.raises(SystemExit) as e:
        test_anyres.main(["--input_dir", str(root / "DS"), "--weights", pth,
                          "--exported", art] + TINY)
    assert e.value.code == 2
    assert "unrecognized arguments: --exported" in capsys.readouterr().err
