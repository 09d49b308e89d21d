"""The JAX package's `.msgpack` checkpoints read by the port, and the
leftover functions of ported modules, against the JAX package on the CPU.

Checkpoints are written by `dehaze_tpu.train.checkpoint.save_checkpoint`
(params from a seeded port init through the JAX package's converters, and
an optax AdamW state beside them) for the ProbSparse and W-MSA Uformers,
FFA-Net and the UNet at tiny widths, and for a bfloat16 params tree; each
loads through the port's `load_weights`, and its forward matches the JAX
model's (ProbSparse sampling pinned to one table per window size). The
pure-Python decoder agrees with `flax.serialization.msgpack_restore` leaf
by leaf, on those files and on a file with chunked arrays, and loads a
file with msgpack, flax and jax blocked. `cli.trajectory` reads a JAX
run's directory, `cli.test_long --weights X.msgpack` gives the JAX CLI's
PSNRs, and `--resume` refuses a `.msgpack`. The leftovers:
`gaussian_train_batches` byte for byte, `ssim_gaussian` (SAME and VALID)
within 2.5e-7 of float64 and 1.25e-6 of JAX's float32, the step lr table
exactly, `dehaze_whole_image` at 2e-4.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from dehaze_tpu import config as JC
from dehaze_tpu.data import pipeline as JP
from dehaze_tpu.infer import tiled as JTiled
from dehaze_tpu.models.ffa import FFA as JFFA
from dehaze_tpu.models.unet import UNet as JUNet
from dehaze_tpu.models.uformer import Uformer as JUformer
from dehaze_tpu.ops import metrics as JM
from dehaze_tpu.ops import probsparse as PS
from dehaze_tpu.train import schedule as JS
from dehaze_tpu.train.checkpoint import save_checkpoint
from dehaze_tpu.utils import convert_torch as CT
from dehaze_tpu_torch import config as TC
from dehaze_tpu_torch.cli import test_long, trajectory
from dehaze_tpu_torch.cli import train as cli_train
from dehaze_tpu_torch.data import pipeline as TP
from dehaze_tpu_torch.data.synth import write_dataset
from dehaze_tpu_torch.infer import tiled as TTiled
from dehaze_tpu_torch.models import get_arch
from dehaze_tpu_torch.ops import metrics as TM
from dehaze_tpu_torch.ops import probsparse as TPS
from dehaze_tpu_torch.train import schedule as TS
from dehaze_tpu_torch.train.checkpoint import load_jax_checkpoint
from dehaze_tpu_torch.utils import msgpack as TMP
from dehaze_tpu_torch.utils.convert import load_weights

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4
IMG = 32


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


# arch → (port ModelConfig flags, JAX converter, JAX model)
_ARCHS = {
    "probsparse": (dict(embed_dim=8),
                   lambda sd: CT.convert_uformer_state_dict(sd),
                   lambda dt: JUformer(JC.ModelConfig(
                       img_size=IMG, embed_dim=8, dtype=dt))),
    "wmsa": (dict(embed_dim=8, attention="full"),
             lambda sd: CT.convert_uformer_state_dict(sd, attention="full"),
             lambda dt: JUformer(JC.ModelConfig(
                 img_size=IMG, embed_dim=8, attention="full", dtype=dt))),
    "ffa": (dict(arch="ffa", ffa_blocks=1, ffa_dim=16),
            lambda sd: CT.convert_ffa_state_dict(sd, blocks=1),
            lambda dt: JFFA(blocks=1, dim=16, dtype=dt)),
    "unet": (dict(arch="unet", embed_dim=8),
             lambda sd: CT.convert_unet_state_dict(sd),
             lambda dt: JUNet(dim=8, dtype=dt)),
}


def _cfg(arch):
    return TC.ModelConfig(img_size=IMG, dtype=torch.float32,
                          **_ARCHS[arch][0])


def _jax_params(arch, seed=0):
    """The JAX params of a seeded port init, as numpy (copied: the
    converter's arrays share the torch weights' memory)."""
    torch.manual_seed(seed)
    sd = get_arch(_cfg(arch)).state_dict()
    return jax.tree.map(lambda a: np.array(a), _ARCHS[arch][1](sd))


def _save(path, params, epoch=3, with_opt=True):
    opt = optax.adamw(1e-3).init(params) if with_opt else None
    save_checkpoint(str(path), epoch, params, opt, extra={"psnr": 12.5})
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{name: (path, params)} of the JAX-written checkpoints."""
    root = tmp_path_factory.mktemp("jax_msgpack")
    out = {}
    for arch in _ARCHS:
        p = _jax_params(arch)
        out[arch] = (_save(root / f"{arch}.msgpack", p), p)
    p16 = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                       out["probsparse"][1])
    out["bf16"] = (_save(root / "bf16.msgpack", p16, with_opt=False), p16)
    return out


def _jax_forward(arch, params, x):
    model = _ARCHS[arch][2](jnp.float32)
    return np.asarray(jax.jit(lambda p, v: model.apply(
        {"params": p}, v, train=False,
        rngs={"sample": jax.random.PRNGKey(0)}))(params, jnp.asarray(x)))


@pytest.mark.parametrize("name", ["probsparse", "wmsa", "ffa", "unet",
                                  "bf16"])
def test_load_weights_msgpack_matches_jax(files, pinned, name):
    """A JAX `.msgpack` through `load_weights` loads strictly, and the
    port's forward matches the JAX model's on the same params within 2e-4
    (the bf16 tree: its values, widened to f32 on both sides, exactly so)."""
    path, params = files[name]
    arch = "probsparse" if name == "bf16" else name
    model = get_arch(_cfg(arch))
    model.load_state_dict(load_weights(path, _cfg(arch).arch), strict=True)
    if name == "bf16":
        params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    x = np.random.default_rng(1).uniform(size=(1, IMG, IMG, 3)).astype(
        np.float32)
    want = _jax_forward(arch, params, x)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_load_jax_checkpoint_fields(files):
    ck = load_jax_checkpoint(files["unet"][0])
    assert ck["epoch"] == 3 and ck["extra"] == {"psnr": 12.5}
    assert set(ck["params"]) == set(files["unet"][1])
    bf = load_jax_checkpoint(files["bf16"][0])["params"]
    leaf = bf["input_proj"]["proj"]["kernel"]
    assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
    want = np.asarray(files["bf16"][1]["input_proj"]["proj"]["kernel"])
    np.testing.assert_array_equal(leaf.view(torch.int16).numpy(),
                                  want.view(np.int16))


def _same_tree(got, want, path=""):
    """Leaf by leaf: equal types of container, keys, dtypes, shapes and
    bits (a bfloat16 leaf is a torch tensor on the port's side)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{path}/{i}")
    elif isinstance(want, np.ndarray) and want.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor), path
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16), err_msg=path)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("name", ["probsparse", "ffa", "bf16"])
def test_decoder_agrees_with_flax(files, name):
    """The whole file and its nested params/opt_state records, as flax
    decodes them."""
    with open(files[name][0], "rb") as f:
        data = f.read()
    outer = serialization.msgpack_restore(data)
    _same_tree(TMP.unpackb(data), outer)
    for key in ("params", "opt_state"):
        if outer[key]:
            _same_tree(TMP.unpackb(outer[key]),
                       serialization.msgpack_restore(outer[key]), key)


def test_decoder_chunked_and_every_type(monkeypatch):
    """flax's chunked arrays (MAX_CHUNK_SIZE made small here only), and
    every type flax emits: ints of every width and sign, float32/64
    scalars, complex, str and bin of each length class, nil, bools,
    arrays, maps of over 15 keys, bf16, bool and int arrays."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(0)
    tree = {
        "big": rng.normal(size=(5, 7)).astype(np.float32),
        "bf": np.asarray(jnp.asarray(rng.normal(size=(40,)), jnp.bfloat16)),
        "nested": {"i64": np.arange(-9, 9, dtype=np.int64),
                   "flags": np.array([True, False, True]),
                   "small": np.float32(2.5) * np.ones((2,), np.float32)},
        "scalars": {"f32": np.float32(-1.25), "u8": np.uint8(200),
                    "py_int": -(2 ** 40), "u64": 2 ** 63 + 5, "pos": 7,
                    "neg": -3, "i8": -100, "i16": -30000, "u16": 60000,
                    "f64": 0.1, "c": complex(1.5, -2.0), "none": None,
                    "t": True, "f": False},
        "text": {"short": "ab", "s8": "x" * 40, "s16": "y" * 300,
                 "bin": b"\x00\x01", "bin16": bytes(range(256)) * 2},
        "list": [1, "two", 3.0, None, [4, 5]],
        "wide": {str(i): i for i in range(20)},
    }
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    _same_tree(TMP.unpackb(data), serialization.msgpack_restore(data))
    with pytest.raises(ValueError, match="truncated"):
        TMP.unpackb(data[:-3])


def test_reader_needs_no_msgpack_flax_or_jax(files):
    """A process with `msgpack`, `flax`, `jax` and `dehaze_tpu` blocked
    reads a JAX file and bridges it."""
    code = (
        "import sys\n"
        "for m in ('msgpack', 'flax', 'jax', 'dehaze_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from dehaze_tpu_torch.utils.convert import load_weights\n"
        "sd = load_weights(sys.argv[1], 'unet')\n"
        "print(len(sd), float(sum(v.double().sum() for v in sd.values())))\n")
    r = subprocess.run([sys.executable, "-c", code, files["unet"][0]],
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": _REPO})
    assert r.returncode == 0, r.stderr
    n, total = r.stdout.split()
    sd = load_weights(files["unet"][0], "unet")
    assert int(n) == len(sd)
    assert float(total) == float(sum(v.double().sum() for v in sd.values()))


def test_trajectory_reads_a_jax_run(tmp_path, capsys):
    """`cli.trajectory` on a directory of JAX `epoch_model_{e}.msgpack`
    files and a `.msgpack` best gives the points of the same weights as
    the port's `.pth` files, exactly."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    pdir.mkdir()
    for e in (1, 2, 10):
        p = _jax_params("unet", seed=e)
        _save(jdir / f"epoch_model_{e}.msgpack", p, epoch=e)
        torch.save({"state_dict": load_weights(
            str(jdir / f"epoch_model_{e}.msgpack"), "unet")},
            pdir / f"epoch_model_{e}.pth")
    flags = ["--arch", "unet", "--embed_dim", "8", "--device", "cpu",
             "--out", ""]
    trajectory.main(flags + ["--ckpt_dir", str(jdir), "--best",
                             str(jdir / "epoch_model_10.msgpack")])
    got = capsys.readouterr().out
    trajectory.main(flags + ["--ckpt_dir", str(pdir), "--best",
                             str(pdir / "epoch_model_10.pth")])
    want = capsys.readouterr().out
    assert got.count("theta=") == 3
    assert got.replace(".msgpack", "") == want.replace(".pth", "")


def test_test_long_msgpack_matches_jax_cli(tmp_path, monkeypatch):
    """`cli.test_long --weights X.msgpack` (the UNet, f32) gives the JAX
    CLI's per-image PSNRs on the same file and pairs, within 1e-3 dB."""
    import importlib

    write_dataset(str(tmp_path / "DS"), 2, (40, 56), seed=3)
    path = _save(tmp_path / "model_best.msgpack", _jax_params("unet"))
    flags = ["--input_dir", str(tmp_path / "DS"), "--weights", path,
             "--arch", "unet", "--embed_dim", "8", "--train_ps", "32",
             "--dtype", "float32", "--no-save_images"]
    seen = []
    fn = JM.psnr
    monkeypatch.setattr(JM, "psnr", lambda *a, **kw: (
        seen.append(float(fn(*a, **kw))) or seen[-1]))
    monkeypatch.setattr(sys, "argv", ["test_long", "--result_dir",
                                      str(tmp_path / "jax")] + flags)
    importlib.import_module("dehaze_tpu.cli.test_long").main()
    got = test_long.main(flags + ["--device", "cpu", "--result_dir",
                                  str(tmp_path / "port")])
    assert len(seen) == 2
    np.testing.assert_allclose(got["psnr"], seen, rtol=0, atol=1e-3)


def test_resume_refuses_a_msgpack(tmp_path):
    with pytest.raises(SystemExit, match="optax"):
        cli_train.main(["--resume", "--pretrain_weights",
                        str(tmp_path / "epoch_model_3.msgpack"),
                        "--device", "cpu", "--save_dir", str(tmp_path)])


# -------------------------------------------------------------- leftovers

def test_gaussian_train_batches_bytes(tmp_path):
    write_dataset(str(tmp_path / "DS"), 5, (24, 30), seed=2)
    clean = str(tmp_path / "DS" / "gt")
    kw = dict(batch_size=2, patch_size=16, seed=7, epoch=3, noise_level=5.0,
              num_workers=2)
    want = list(JP.gaussian_train_batches(clean, **kw))
    got = list(TP.gaussian_train_batches(clean, **kw))
    assert len(got) == len(want) == 3
    for (gc, gn), (wc, wn) in zip(got, want):
        assert gc.dtype == wc.dtype and gn.dtype == wn.dtype
        assert gc.tobytes() == wc.tobytes() and gn.tobytes() == wn.tobytes()


def _ssim64(a, b, padding):
    """The same SSIM in float64 (torch convs), for the rounding bars."""
    import torch.nn.functional as F

    p, t = (torch.from_numpy(v).double().clamp(0, 1).permute(0, 3, 1, 2)
            for v in (a, b))
    g = np.exp(-((np.arange(11) - 5) ** 2) / (2 * 1.5 ** 2))
    k = torch.from_numpy(np.outer(g, g) / g.sum() ** 2).expand(3, 1, 11, 11)

    def f(x):
        return F.conv2d(x, k, padding=5 if padding == "SAME" else 0,
                        groups=3)

    m1, m2 = f(p), f(t)
    s1, s2, s12 = f(p * p) - m1 * m1, f(t * t) - m2 * m2, f(p * t) - m1 * m2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return float((((2 * m1 * m2 + c1) * (2 * s12 + c2)) /
                  ((m1 * m1 + m2 * m2 + c1) * (s1 + s2 + c2))).mean())


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_ssim_gaussian_matches_jax(padding):
    """Both packages compute in float32. The port lies within 2.5e-7 of the
    float64 value; the JAX package's XLA result lies up to 1.0e-6 from it
    (1.00e-6 on the VALID case here, 8.0e-7 on SAME), so the two agree
    within 1e-6 plus the port's 2.5e-7 ([H, W, C] and batched input)."""
    rng = np.random.default_rng(4)
    a = rng.uniform(-0.1, 1.1, size=(2, 24, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    exact = _ssim64(a, b, padding)
    want = float(JM.ssim_gaussian(jnp.asarray(a), jnp.asarray(b),
                                  padding=padding))
    got = float(TM.ssim_gaussian(torch.from_numpy(a), torch.from_numpy(b),
                                 padding=padding))
    assert abs(got - exact) <= 2.5e-7
    assert abs(got - want) <= 1e-6 + 2.5e-7
    one = float(TM.ssim_gaussian(torch.from_numpy(a[0]),
                                 torch.from_numpy(b[0]), padding=padding))
    want1 = float(JM.ssim_gaussian(jnp.asarray(a[0]), jnp.asarray(b[0]),
                                   padding=padding))
    assert abs(one - _ssim64(a[:1], b[:1], padding)) <= 2.5e-7
    assert abs(one - want1) <= 1e-6 + 2.5e-7


def test_lr_schedule_from_epoch_fn_exact():
    t = TC.TrainConfig(nepoch=20, warmup=True, warmup_epochs=3,
                       lr_initial=2e-4)
    jt = JC.TrainConfig(nepoch=20, warmup=True, warmup_epochs=3,
                        lr_initial=2e-4)
    got = TS.lr_schedule_from_epoch_fn(TS.make_epoch_lr(t), 7)
    want = JS.lr_schedule_from_epoch_fn(JS.make_epoch_lr(jt), 7)
    for step in list(range(0, 200, 3)) + [4096 * 7 + 5, 10 ** 6]:
        w = np.float32(want(step))
        assert np.float32(got(step)) == w and got(step) == float(w), step


def test_dehaze_whole_image_matches_jax():
    """The UNet (width 8) through both packages' single-image path on a
    40×56 frame (64² canvas at ps 32)."""
    torch.manual_seed(5)
    model = get_arch(_cfg("unet")).eval()
    params = jax.tree.map(jnp.asarray,
                          CT.convert_unet_state_dict(model.state_dict()))
    jmodel = JUNet(dim=8)
    img = np.random.default_rng(6).uniform(size=(40, 56, 3)).astype(
        np.float32)
    want = JTiled.dehaze_whole_image(
        lambda x: jmodel.apply({"params": params}, x), img, ps=32)
    got = TTiled.dehaze_whole_image(model, img, ps=32, device="cpu")
    assert got.shape == (40, 56, 3) and isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


_FIXTURE = os.path.join(_REPO, "tests", "data", "uformer_e4_bf16")


def _sha(sd):
    import hashlib

    return {k: hashlib.sha256(v.float().contiguous().numpy().tobytes())
            .hexdigest() for k, v in sd.items()}


def test_committed_fixture_digests():
    """`scripts/make_msgpack_fixture.py`'s checkpoint, decoded by flax and
    by the port's reader, gives the state_dict of its JSON's digests, and
    that state_dict loads strictly into the model of its flags."""
    from dehaze_tpu_torch.utils.convert import state_dict_from_jax_params

    with open(_FIXTURE + ".json") as f:
        meta = json.load(f)
    assert os.path.getsize(_FIXTURE + ".msgpack") <= 1 << 20
    with open(_FIXTURE + ".msgpack", "rb") as f:
        outer = serialization.msgpack_restore(f.read())
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          serialization.msgpack_restore(outer["params"]))
    assert _sha(state_dict_from_jax_params(params)) == meta["sha256"]
    sd = load_weights(_FIXTURE + ".msgpack")
    assert _sha(sd) == meta["sha256"]
    assert meta["params_dtype"] == "bfloat16"
    model = get_arch(TC.ModelConfig(embed_dim=int(meta["flags"][1])),
                     device="meta")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in sd.items()}


def test_smoke_writer_matches_flax_bytes():
    """The writer `chip_smoke.py` uses to make a Uformer-32 `.msgpack` on a
    host without flax writes flax's bytes."""
    sys.path.insert(0, _REPO)
    import chip_smoke

    rng = np.random.default_rng(2)
    params = {"a": {"kernel": rng.normal(size=(3, 4)).astype(np.float32),
                    "bias": np.zeros(300, np.float32)},
              "b": {str(i): np.full((i + 1,), i, np.float32)
                    for i in range(18)}}
    want = serialization.msgpack_serialize(
        {"epoch": 5, "params": serialization.msgpack_serialize(params),
         "opt_state": b"", "extra": json.dumps({"x": 1})})
    got = chip_smoke.pack_jax_checkpoint(5, params, {"x": 1})
    assert got == want


def test_extra_is_json(files):
    with open(files["ffa"][0], "rb") as f:
        payload = TMP.read_map(f.read(), skip=("opt_state", "params"))
    assert set(payload) == {"epoch", "extra"}
    assert json.loads(payload["extra"]) == {"psnr": 12.5}
