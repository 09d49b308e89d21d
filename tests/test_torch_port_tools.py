"""The port's offline tools against the JAX package's, on the CPU.

`cli.parity_gate`: passes and fails as tests/test_parity_gate.py has the
JAX gate do, on a seeded port Uformer (embed 8) saved in the reference's
`{"state_dict": ...}` layout with DataParallel `module.` prefixes; its
mean PSNR against the JAX gate's `evaluate_checkpoint` on the same `.pth`
with ProbSparse sampling pinned, within 1e-3 dB (the eval CLIs' bar), and
likewise for a W-MSA `.pth` with `--attention full`.
`cli.convert_vgg`: its `.npz` equals the JAX tool's array for array, and
loads into both packages' VGG19 to the same features (f32 2e-4).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dehaze_tpu import config as JC
from dehaze_tpu.models import vgg as JV
from dehaze_tpu.ops import probsparse as PS
from dehaze_tpu_torch.config import ModelConfig
from dehaze_tpu_torch.data.images import save_img
from dehaze_tpu_torch.models import vgg as TV
from dehaze_tpu_torch.models.uformer import Uformer
from dehaze_tpu_torch.ops import probsparse as TPS

TOL = 2e-4
SIZE = ["--embed_dim", "8", "--train_ps", "32", "--dtype", "float32",
        "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU tensors: with several test
    workers on the host, torch's thread pools stall each other in
    hand-offs (a small op then takes tens of times as long)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


@pytest.fixture(scope="module")
def pth_and_data(tmp_path_factory):
    """A seeded port Uformer as a reference checkpoint (`module.` keys
    under "state_dict") and two 48² gt/hazy pairs."""
    torch.manual_seed(0)
    model = Uformer(ModelConfig(img_size=32, embed_dim=8,
                                dtype=torch.float32))
    root = tmp_path_factory.mktemp("gate")
    pth = str(root / "ref.pth")
    torch.save({"epoch": 1, "state_dict": {
        f"module.{k}": v for k, v in model.state_dict().items()}}, pth)
    rng = np.random.default_rng(0)
    for sub in ("gt", "hazy"):
        os.makedirs(root / "test" / sub)
    for i in range(2):
        g = rng.uniform(size=(48, 48, 3)).astype(np.float32)
        save_img(str(root / "test" / "gt" / f"{i}.png"), g)
        save_img(str(root / "test" / "hazy" / f"{i}.png"),
                 np.clip(g * 0.7 + 0.2, 0, 1))
    return pth, str(root / "test")


def test_parity_gate_pass_and_fail(pth_and_data, capsys):
    from dehaze_tpu_torch.cli.parity_gate import main

    pth, data = pth_and_data
    common = ["--ref_ckpt", pth, "--input_dir", data] + SIZE
    # wide tolerance: must pass (and prints the measured PSNR)
    assert main(common + ["--expected_psnr", "0", "--tol", "1e9"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in out[:2]] == ["0.png", "1.png"]
    assert out[-1].endswith("PARITY OK")
    measured = float(out[-1].split()[1])
    # exact expectation at tight tolerance: parity OK
    assert main(common + ["--expected_psnr", f"{measured:.4f}",
                          "--tol", "0.05"]) == 0
    # wrong expectation: parity FAIL with rc 1
    assert main(common + ["--expected_psnr", f"{measured + 5:.4f}",
                          "--tol", "0.05"]) == 1
    assert capsys.readouterr().out.strip().endswith("PARITY FAIL")


def test_parity_gate_full_attention_matches_jax_gate(pth_and_data,
                                                     tmp_path, capsys):
    """`--attention full`: the port gate on a seeded W-MSA `.pth` in the
    reference's layout passes at the JAX gate's mean PSNR with --tol 1e-3,
    and its mean PSNR and SSIM (the 6-decimal line) lie within 1e-3 dB and
    1e-4 of the JAX gate's `evaluate_checkpoint` on the same file."""
    from dehaze_tpu.cli.parity_gate import evaluate_checkpoint as jax_eval
    from dehaze_tpu.utils.convert_torch import load_reference_checkpoint
    from dehaze_tpu_torch.cli.parity_gate import main

    data = pth_and_data[1]
    torch.manual_seed(1)
    model = Uformer(ModelConfig(img_size=32, embed_dim=8, attention="full",
                                dtype=torch.float32))
    pth = str(tmp_path / "wmsa.pth")
    torch.save({"epoch": 1, "state_dict": {
        f"module.{k}": v for k, v in model.state_dict().items()}}, pth)
    jcfg = JC.Config(model=JC.ModelConfig(img_size=32, embed_dim=8,
                                          attention="full",
                                          dtype=jnp.float32))
    want = jax_eval(jcfg, load_reference_checkpoint(pth, attention="full"),
                    data, 32)
    assert main(["--ref_ckpt", pth, "--input_dir", data, "--attention",
                 "full", "--expected_psnr", repr(want[0]), "--tol", "1e-3"]
                + SIZE) == 0
    out = capsys.readouterr().out
    assert out.strip().endswith("PARITY OK")
    mean = next(ln for ln in out.splitlines() if ln.startswith("PSNR: "))
    psnr, ssim = (float(f.split(": ")[1]) for f in mean.split(", "))
    assert abs(psnr - want[0]) <= 1e-3
    assert abs(ssim - want[1]) <= 1e-4


def test_parity_gate_psnr_matches_jax_gate(pth_and_data, pinned):
    """The port gate's mean PSNR and SSIM against the JAX gate's
    `evaluate_checkpoint` (its params from the JAX package's reader of the
    same `.pth`), sampling pinned on both sides."""
    from dehaze_tpu.cli.parity_gate import evaluate_checkpoint as jax_eval
    from dehaze_tpu.utils.convert_torch import load_reference_checkpoint
    from dehaze_tpu_torch.cli.parity_gate import evaluate_checkpoint

    pth, data = pth_and_data
    jcfg = JC.Config(model=JC.ModelConfig(img_size=32, embed_dim=8,
                                          dtype=jnp.float32))
    want = jax_eval(jcfg, load_reference_checkpoint(pth), data, 32)
    got = evaluate_checkpoint(ModelConfig(img_size=32, embed_dim=8,
                                          dtype=torch.float32), pth, data,
                              32, device="cpu")
    assert abs(got[0] - want[0]) <= 1e-3
    assert abs(got[1] - want[1]) <= 1e-4


@pytest.mark.parametrize("prefixed", [False, True])
def test_convert_vgg_equals_jax_tool(tmp_path, prefixed):
    """A seeded VGG19 `features` state_dict in torchvision's key layout
    (bare `{i}.weight`, or already `features.{i}.weight`) through both
    tools: the same keys and the same array bytes; loaded into each
    package's VGG19, the same features."""
    from dehaze_tpu.cli.convert_vgg import convert as jax_convert
    from dehaze_tpu_torch.cli.convert_vgg import convert, main

    sd = TV.synthesize_torchvision_state_dict("vgg19", seed=4)
    if prefixed:
        sd = {f"features.{k}": v for k, v in sd.items()}
    torch.save(sd, tmp_path / "vgg19.pth")
    main(["--pth", str(tmp_path / "vgg19.pth"),
          "--out", str(tmp_path / "port.npz")])
    assert convert(str(tmp_path / "vgg19.pth"),
                   str(tmp_path / "port2.npz")) == 32
    jax_convert(str(tmp_path / "vgg19.pth"), str(tmp_path / "jax.npz"))
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert list(got.keys()) == list(want.keys())
    assert all(k.startswith("features.") for k in got.keys())
    for k in want.keys():
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k

    x = np.random.default_rng(6).uniform(size=(1, 32, 32, 3)).astype(
        np.float32)
    jm = JV.make_cr_vgg()
    jf = jm.apply(JV.load_params_npz(jm, str(tmp_path / "jax.npz")),
                  jnp.asarray(x))
    tf = TV.load_params_npz(TV.make_cr_vgg(), str(tmp_path / "port.npz"))(
        torch.from_numpy(x))
    assert len(jf) == len(tf) == 5
    for j, t in zip(jf, tf):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=TOL,
                                   atol=TOL * np.abs(j).max())
