"""`cli.test_long` and `cli.test_anyres` of the port against the JAX CLIs,
on the CPU: the same `.pth` and a two-pair synthetic folder at tiny sizes
(embed 8, f32, `--device cpu`), ProbSparse sampling pinned on both sides.
Per-image PSNR within 1e-3 dB and SSIM within 1e-4.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dehaze_tpu.ops import metrics as JM
from dehaze_tpu.ops import probsparse as PS
from dehaze_tpu_torch.config import ModelConfig
from dehaze_tpu_torch.data.synth import write_dataset
from dehaze_tpu_torch.models.uformer import Uformer
from dehaze_tpu_torch.ops import probsparse as TPS


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
def eval_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_eval")
    write_dataset(str(root / "DS"), 2, (40, 56), seed=3)
    torch.manual_seed(3)
    model = Uformer(ModelConfig(img_size=32, embed_dim=8,
                                dtype=torch.float32))
    pth = str(root / "w.pth")
    torch.save({"state_dict": model.state_dict()}, pth)
    return root, pth


@pytest.mark.parametrize("cli", ["test_long", "test_anyres"])
def test_eval_cli_matches_jax_cli(eval_setup, pinned, monkeypatch, cli):
    """The port's CLI (`--device cpu`, f32) against the JAX CLI on the same
    `.pth` and folder: per-image PSNR within 1e-3 dB and SSIM within 1e-4
    (the JAX values recorded where its CLI computes them)."""
    import importlib

    root, pth = eval_setup
    flags = ["--input_dir", str(root / "DS"), "--weights", pth,
             "--embed_dim", "8", "--train_ps", "32", "--dtype", "float32",
             "--no-save_images"]
    seen = {"psnr": [], "ssim": []}
    for name in seen:
        fn = getattr(JM, name)
        monkeypatch.setattr(JM, name, lambda *a, _fn=fn, _k=name, **kw: (
            seen[_k].append(float(_fn(*a, **kw))) or seen[_k][-1]))
    monkeypatch.setattr(sys, "argv", [cli, "--result_dir",
                                      str(root / f"jax_{cli}")] + flags)
    importlib.import_module(f"dehaze_tpu.cli.{cli}").main()
    port = importlib.import_module(f"dehaze_tpu_torch.cli.{cli}")
    got = port.main(flags + ["--device", "cpu", "--result_dir",
                             str(root / f"port_{cli}")])
    assert got["names"] == ["00000.png", "00001.png"]
    assert len(seen["psnr"]) == 2
    np.testing.assert_allclose(got["psnr"], seen["psnr"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["ssim"], seen["ssim"], rtol=0, atol=1e-4)


def test_eval_cli_refuses_what_is_not_ported(eval_setup):
    from dehaze_tpu_torch.cli import test_long

    root, pth = eval_setup
    base = ["--input_dir", str(root / "DS"), "--weights", pth,
            "--device", "cpu"]
    # ported: FFA-Net runs natively, but has no any-resolution protocol
    # and the UNet no banded forward (as in the JAX package)
    from dehaze_tpu_torch.cli import test_anyres

    with pytest.raises(SystemExit, match="Uformer-only"):
        test_anyres.main(base + ["--arch", "ffa"])
    with pytest.raises(SystemExit, match="halo-banded inference exists"):
        test_long.main(base + ["--arch", "unet", "--bands", "2"])
    for flag in (["--bands", "2"], ["--data_axis", "2"]):
        # ported: they need as many processes, started by torchrun
        with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
            test_long.main(base + flag)
