"""The port's analysis tools against the JAX package, on the CPU.

The optimization trajectory (ops.trajectory and cli.trajectory over the
`.pth` series of a two-epoch cli.train run, shadowed by
cli.archive_params), the training curves (cli.curves on the port's logs
and on JAX-format logs), the parameter and FLOP report (utils.flops,
cli.params_flops), the host monitor, the patch generator, blur-pool
downsampling, the DND bundler and the AverageMeter. Small sizes: embed 8,
32² patches, f32. Tolerances: trajectory points 1e-5; blur_downsample
exact on inputs on a 1/256 grid and 2.4e-7 (two float32 ulps at 1) on
arbitrary floats; the rest exact unless a test states its own.
"""

import csv
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dehaze_tpu.config import ModelConfig as JaxModelConfig
from dehaze_tpu.models import get_arch as jax_get_arch
from dehaze_tpu.ops import trajectory as JT
from dehaze_tpu.utils import convert_torch as CT
from dehaze_tpu_torch.config import ModelConfig
from dehaze_tpu_torch.data.synth import write_dataset
from dehaze_tpu_torch.models import get_arch
from dehaze_tpu_torch.ops import probsparse as TPS
from dehaze_tpu_torch.ops import trajectory as TT
from dehaze_tpu_torch.utils import flops as TF
from dehaze_tpu_torch.utils.convert import load_weights

IMG = 32
TRAJ_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU tensors: with several test
    workers on the host, torch's thread pools stall each other in
    hand-offs (a small op then takes tens of times as long)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(**fields):
    return ModelConfig(img_size=IMG, embed_dim=8, dtype=torch.float32,
                       **fields)


def _jax_tree(sd, **flags):
    return jax.tree.map(jnp.asarray, CT.convert_uformer_state_dict(
        sd, **flags))


# ----------------------------------------------------------- trajectory

def _series(flags, seed=0):
    """A seeded init, a moved checkpoint and a best, as port state dicts;
    the moved checkpoint keeps some tensors at the best's values (skipped
    there) and, for W-MSA 'linear', every `to_kv` (its fused JAX leaf
    moves with `to_q`)."""
    torch.manual_seed(seed)
    names = [k for k, _ in get_arch(_cfg(**flags)).named_parameters()]
    best = get_arch(_cfg(**flags)).state_dict()
    rng = np.random.default_rng(seed)

    def moved(scale, keep=()):
        return {k: v if k in keep else v + torch.from_numpy(
            rng.normal(size=v.shape).astype(np.float32) * scale)
            for k, v in best.items()}

    init = moved(0.05)
    keep = set(names[::3])
    if flags.get("attention") == "full":
        keep |= {k for k in names if ".qkv.to_kv." in k}
    return [init, moved(0.01, keep), dict(best)], best


def test_trajectory_matches_jax():
    """(theta, r) per checkpoint of the W-MSA 'linear' Uformer against
    JAX's trajectory on the same weights (the JAX layout through its
    converter): a checkpoint with some tensors at the best's values
    (skipped) and to_q moved while its to_kv is not (one fused leaf in JAX,
    one group in the port), and one equal to the best (every tensor
    skipped: (0, 0)). The ProbSparse Uformer's series is held in
    test_archive_params_and_cli_trajectory."""
    flags = {"attention": "full"}
    ckpts, best = _series(flags)
    got = np.asarray(TT.trajectory(ckpts, best))
    want = np.asarray(JT.trajectory([_jax_tree(c, **flags) for c in ckpts],
                                    _jax_tree(best, **flags)))
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=TRAJ_TOL,
                               atol=TRAJ_TOL)
    # the init's own theta is acos(1 - rounding): 0 in exact arithmetic and
    # sqrt(2·eps)-sized noise in float32 on either side (dθ = dcos / sin θ)
    np.testing.assert_allclose(got[1:, 0], want[1:, 0], rtol=TRAJ_TOL,
                               atol=TRAJ_TOL)
    assert got[0, 0] < 1e-3 and want[0, 0] < 1e-3 and got[0, 1] == 1.0
    assert tuple(got[-1]) == (0.0, 0.0) and tuple(want[-1]) == (0.0, 0.0)


def test_trajectory_grouping_counts_fused_leaf_once():
    """With every tensor but one block's to_q at the best's values, JAX
    averages one fused qkv leaf; the port, one to_q+to_kv group (a per-
    tensor port would skip to_kv and average to_q alone: the same here;
    with to_kv moved the other way, only the group gives JAX's r)."""
    torch.manual_seed(1)
    best = get_arch(_cfg(attention="full")).state_dict()
    q = "encoderlayer_0.blocks.0.attn.qkv.to_q.weight"
    kv = "encoderlayer_0.blocks.0.attn.qkv.to_kv.weight"
    init = {k: v.clone() for k, v in best.items()}
    w_t = {k: v.clone() for k, v in best.items()}
    init[q] += 1.0
    init[kv] += 1.0
    w_t[q] += 0.5
    w_t[kv] += 2.0
    got = TT.trajectory_point(w_t, init, best)
    want = JT.trajectory_point(*(_jax_tree(w, attention="full")
                                 for w in (w_t, init, best)))
    np.testing.assert_allclose(got, want, rtol=TRAJ_TOL, atol=TRAJ_TOL)


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    """A two-epoch cli.train run on the CPU (no CR): its models dir and
    its log dir."""
    from dehaze_tpu_torch.cli import train

    td = tmp_path_factory.mktemp("an_train")
    write_dataset(str(td / "train"), 8, 40, seed=4)
    write_dataset(str(td / "val"), 2, IMG, seed=5)
    train.main(["--device", "cpu", "--embed_dim", "8", "--train_ps",
                str(IMG), "--dtype", "float32", "--train_dir",
                str(td / "train"), "--val_dir", str(td / "val"),
                "--batch_size", "4", "--nepoch", "2", "--w_loss_vgg7", "0",
                "--train_workers", "1", "--save_dir", str(td / "log")])
    log = str(td / "log" / "uformer_")
    return os.path.join(log, "models"), log


def test_archive_params_and_cli_trajectory(train_run, tmp_path, capsys):
    """cli.archive_params shadows each epoch file params-only (no
    optimizer), writes nothing on a second pass, and load_weights reads the
    copies; cli.trajectory over the archive with --best prints JAX's
    trajectory of the same weights."""
    from dehaze_tpu_torch.cli import archive_params, trajectory

    models, _ = train_run
    arch = str(tmp_path / "arch")
    archive_params.main(["--models_dir", models, "--out_dir", arch])
    assert capsys.readouterr().out.strip() == "archived 2 new (2 total)"
    names = sorted(os.listdir(arch))
    assert names == ["epoch_model_1.pth", "epoch_model_2.pth"]
    stamps = [os.stat(os.path.join(arch, n)).st_mtime_ns for n in names]
    archive_params.main(["--models_dir", models, "--out_dir", arch])
    assert capsys.readouterr().out.strip() == "archived 0 new (2 total)"
    assert stamps == [os.stat(os.path.join(arch, n)).st_mtime_ns
                      for n in names]
    for n in names:
        full = torch.load(os.path.join(models, n), weights_only=True)
        slim = torch.load(os.path.join(arch, n), weights_only=True)
        assert "optimizer" in full and "optimizer" not in slim
        assert slim.keys() == {"epoch", "state_dict", "extra"}
        sd = load_weights(os.path.join(arch, n))
        for k, v in load_weights(os.path.join(models, n)).items():
            assert torch.equal(sd[k], v), k

    best = os.path.join(models, "model_best.pth")
    trajectory.main(["--ckpt_dir", arch, "--best", best, "--device", "cpu",
                     "--embed_dim", "8", "--train_ps", str(IMG), "--out",
                     str(tmp_path / "traj.png")])
    out = capsys.readouterr().out
    assert os.path.getsize(tmp_path / "traj.png") > 0
    got = [(float(a), float(b)) for a, b in re.findall(
        r"epoch_model_\d+\.pth: theta=(\S+) r=(\S+)", out)]
    want = JT.trajectory(
        [_jax_tree(load_weights(os.path.join(arch, n))) for n in names],
        _jax_tree(load_weights(best)))
    assert len(got) == 2  # epoch 1 is the init: its theta is noise (above)
    np.testing.assert_allclose(np.asarray(got)[:, 1], np.asarray(want)[:, 1],
                               atol=6e-5)  # printed to 4 places
    np.testing.assert_allclose(got[1][0], want[1][0], atol=6e-5)


# --------------------------------------------------------------- curves

def _write_jsonl(path, events, torn=False):
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")
        if torn:
            f.write('{"kind": "epoch", "epo')


def _segments(log_dir, mem_key):
    """Two segments of a resumed run: the first's epoch 2 and its eval are
    superseded by the second's, and it ends in a torn line."""
    os.makedirs(log_dir)
    ev = lambda e, i, p: {"kind": "eval", "epoch": e, "iter": i,  # noqa
                          "psnr": p, "ssim": p / 40}
    ep = lambda e, loss, m: {"kind": "epoch", "epoch": e,  # noqa
                             "loss": loss, "img_per_s": 10.0 + e,
                             mem_key: m}
    _write_jsonl(os.path.join(log_dir, "2026-01-01T00-00-00.jsonl"),
                 [ev(1, 3, 20.0), ep(1, 0.5, 1.25), ev(2, 3, 21.0),
                  ep(2, 0.45, 1.5)], torn=True)
    _write_jsonl(os.path.join(log_dir, "2026-01-01T01-00-00.jsonl"),
                 [ev(2, 3, 21.5), ev(2, 7, 22.0), ep(2, 0.4, 1.75),
                  ev(3, 7, 21.0), ep(3, 0.35, 2.0)])


def _read(path):
    with open(path) as f:
        return f.read()


def test_curves_on_jax_format_logs_equal_jax_cli(tmp_path, monkeypatch,
                                                 capsys):
    """JAX-format logs (`rss_gb`): the merge (later segment wins on
    (kind, epoch, iter), the torn line skipped, the best eval per epoch)
    and the CSV equal the JAX CLI's, byte for byte; both figures drawn."""
    from dehaze_tpu.cli import curves as JCurves
    from dehaze_tpu_torch.cli import curves as TCurves

    log = str(tmp_path / "jax_log")
    _segments(log, "rss_gb")
    TCurves.main(["--log_dir", log, "--out", str(tmp_path / "t.png"),
                  "--csv", str(tmp_path / "t.csv")])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["curves", "--log_dir", log, "--out",
                                      str(tmp_path / "j.png"), "--csv",
                                      str(tmp_path / "j.csv")])
    JCurves.main()
    want = capsys.readouterr().out
    assert _read(tmp_path / "t.csv") == _read(tmp_path / "j.csv")
    assert got.splitlines()[0] == want.splitlines()[0]
    rows = list(csv.DictReader(open(tmp_path / "t.csv")))
    assert [r["loss"] for r in rows] == ["0.5", "0.4", "0.35"]
    assert [r["psnr"] for r in rows] == ["20.0", "22.0", "21.0"]
    assert os.path.getsize(tmp_path / "t.png") > 0


def test_curves_on_port_logs(tmp_path, train_run, capsys):
    """The port's logs: a CUDA run's `peak_mem_gib` is the memory column
    (named so); a CPU run (the two-epoch train run) logs no memory and
    the CSV has no memory column; --out '' writes the CSV alone."""
    from dehaze_tpu_torch.cli import curves as TCurves

    log = str(tmp_path / "port_log")
    _segments(log, "peak_mem_gib")
    TCurves.main(["--log_dir", log, "--out", "", "--csv",
                  str(tmp_path / "p.csv")])
    assert capsys.readouterr().out.splitlines()[-1] == \
        f"wrote {tmp_path / 'p.csv'}"
    rows = list(csv.DictReader(open(tmp_path / "p.csv")))
    assert list(rows[0]) == ["epoch", "loss", "img_per_s", "peak_mem_gib",
                             "psnr", "ssim"]
    assert [r["peak_mem_gib"] for r in rows] == ["1.25", "1.75", "2.0"]
    _, run_log = train_run
    TCurves.main(["--log_dir", run_log, "--out", str(tmp_path / "c.png"),
                  "--csv", str(tmp_path / "c.csv")])
    assert capsys.readouterr().out.startswith("2 epochs, 2 eval points, "
                                              "1 segments")
    rows = list(csv.DictReader(open(tmp_path / "c.csv")))
    assert list(rows[0]) == ["epoch", "loss", "img_per_s", "psnr", "ssim"]
    assert len(rows) == 2 and os.path.getsize(tmp_path / "c.png") > 0


# --------------------------------------------------------- params/flops

PARAM_ARCHS = {
    "probsparse": {},
    "wmsa_conv_se_ffn": {"attention": "full", "token_projection": "conv",
                         "se_layer": True, "token_mlp": "ffn"},
    "ffa": {"arch": "ffa", "ffa_blocks": 2, "ffa_dim": 16},
    "unet": {"arch": "unet"},
}


@pytest.mark.parametrize("name", list(PARAM_ARCHS))
def test_count_params_equals_jax(name):
    """count_params of every arch against the JAX package's count of its
    init's variables (traced by eval_shape, not compiled)."""
    from dehaze_tpu.utils.flops import count_params

    flags = PARAM_ARCHS[name]
    model = jax_get_arch(JaxModelConfig(img_size=IMG, embed_dim=8,
                                        dtype=jnp.float32, **flags))
    k = jax.random.PRNGKey(0)
    variables = jax.eval_shape(lambda: model.init(
        {"params": k, "sample": k}, jnp.zeros((1, IMG, IMG, 3))))
    assert TF.count_params(get_arch(_cfg(**flags))) == \
        count_params(variables)


def _uformer_flops(cfg: ModelConfig, s: int) -> int:
    """The ProbSparse Uformer's eval forward at s², batch 1, by hand: its
    Linear and conv matmuls (a transposed conv by its input positions, as
    FlopCounterMode counts it) and K1's and K2's formulas."""
    c, n_enc = cfg.embed_dim, 4
    total = 2 * s * s * c * 3 * 9  # input_proj

    def stage(d, r):
        w = min(cfg.win_size, r)
        n, t = w * w, r * r
        u = TPS.probsparse_u(n, cfg.probsparse_factor)
        h = int(d * cfg.mlp_ratio)
        block = (4 * 2 * t * d * d                 # q, k, v, out
                 + t * (2 * n * d + 2 * u * d)     # K1
                 + 2 * t * (d * h + 9 * h + h * d))  # K2
        return 2 * block

    d, r = c, s
    for _ in range(n_enc):
        total += stage(d, r)
        total += 2 * (r // 2) ** 2 * (2 * d) * d * 16  # 4×4/s2 conv
        d, r = 2 * d, r // 2
    total += stage(d, r)
    in_ch = d
    for _ in range(n_enc):
        up = d // 2
        total += 2 * r * r * in_ch * up * 4  # 2×2/s2 transposed conv
        r, in_ch, d = 2 * r, 2 * up, up
        total += stage(in_ch, r)
    return total + 2 * s * s * 3 * (2 * c) * 9  # output_proj


# the port's count over XLA's cost analysis of the JAX model's compiled
# forward, at 32² and embed 8 (counted on the CPU: 0.0958 / 0.1982 =
# 0.4835): XLA also counts the elementwise work, softmax, norms and the
# ProbSparse selection, which the port's count leaves out
XLA_RATIO = (0.45, 0.52)


def test_flops_equal_analytic_count_and_xla_ratio(capsys):
    """cli.params_flops on the ProbSparse Uformer: the params line, and
    GFLOPs equal to the analytic count of its matmuls, convs and K1's and
    K2's formulas (the two operators' formulas counted: without them the
    count drops by their share); the ratio to XLA's count of the JAX
    model's compiled forward lies in XLA_RATIO."""
    from dehaze_tpu.utils.flops import model_report
    from dehaze_tpu_torch.cli import params_flops

    rep = params_flops.main(["--device", "cpu", "--embed_dim", "8",
                             "--train_ps", str(IMG), "--dtype", "float32"])
    out = capsys.readouterr().out
    assert f"Total params: {rep['params']:,}" in out
    assert "parameters, input and output once each" in out
    cfg = _cfg()
    want = _uformer_flops(cfg, IMG)
    assert rep["gflops"] * 1e9 == pytest.approx(want, rel=1e-12)
    counter = torch.utils.flop_counter.FlopCounterMode(display=False)
    model = get_arch(cfg).eval()
    with torch.no_grad(), counter:
        model(torch.zeros(1, IMG, IMG, 3),
              generator=torch.Generator().manual_seed(0))
    ops = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    assert ops["dehaze_tpu_torch.window_attention_fwd"] > 0
    assert ops["dehaze_tpu_torch.leff_fused"] > 0

    torch.manual_seed(0)
    sd = get_arch(cfg).state_dict()
    jm = jax_get_arch(JaxModelConfig(img_size=IMG, embed_dim=8,
                                     dtype=jnp.float32))
    k = jax.random.PRNGKey(0)
    xla = model_report(jm, {"params": _jax_tree(sd)},
                       jnp.zeros((1, IMG, IMG, 3)), train=False,
                       rngs={"sample": k})
    ratio = rep["gflops"] / xla["gflops"]
    print(f"port / XLA GFLOPs: {rep['gflops']:.6f} / {xla['gflops']:.6f} "
          f"= {ratio:.4f}")
    assert XLA_RATIO[0] < ratio < XLA_RATIO[1]
    assert rep["params"] == xla["params"]


# -------------------------------------------------------------- monitor

LINE = re.compile(r"^\d\d:\d\d:\d\d cpu +(\d+\.\d)%  mem +(\d+\.\d)%$")


def test_monitor_line_format_and_psutil(tmp_path, capsys, monkeypatch):
    """cli.monitor --count 1 --log (the JAX tool's 2 s cpu window) and
    monitor_loop with two samples over a short window: lines in the JAX
    tool's format, printed and appended; mem% within 2 points of psutil's
    here, cpu% in [0, 100]; the background monitor stops on its event."""
    import time

    import psutil

    from dehaze_tpu_torch.cli import monitor
    from dehaze_tpu_torch.utils import monitor as TM

    log = str(tmp_path / "cpu_mem.txt")
    monitor.main(["--count", "1", "--interval", "0", "--log", log])
    TM.monitor_loop(interval=0.2, cpu_sample_secs=0.1, log_path=log,
                    max_iters=2)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and _read(log).splitlines() == lines
    for ln in lines:
        cpu, mem = (float(v) for v in LINE.match(ln).groups())
        assert 0.0 <= cpu <= 100.0
        assert abs(mem - psutil.virtual_memory().percent) < 2.0
    assert abs(TM.mem_percent() - psutil.virtual_memory().percent) < 2.0
    # the background thread's samples over a 0.05 s window
    sample = TM.cpu_percent
    monkeypatch.setattr(TM, "cpu_percent", lambda _secs: sample(0.05))
    bg = tmp_path / "bg.txt"
    stop = TM.start_background_monitor(interval=0.05, log_path=str(bg))
    time.sleep(0.5)
    stop.set()
    time.sleep(0.3)  # one sample in flight may still land
    n = len(_read(bg).splitlines())
    time.sleep(0.3)
    assert n >= 2 and len(_read(bg).splitlines()) == n


# ------------------------------------------------------------- patches

def test_generate_patches_equal_jax(tmp_path, capsys):
    """cli.generate_patches (a pool of 2) against the JAX package's
    generate_patches at the same seed: the same file names and the same
    decoded pixels (the recreated target dir drops a stale file)."""
    from dehaze_tpu.data.patches import generate_patches as jax_patches
    from dehaze_tpu_torch.cli import generate_patches
    from dehaze_tpu_torch.data.images import load_img

    src = str(tmp_path / "src")
    write_dataset(src, 2, 40, seed=6)
    tar = tmp_path / "port"
    os.makedirs(tar / "gt")
    (tar / "gt" / "stale.png").write_bytes(b"")
    generate_patches.main(["--src_dir", src, "--tar_dir", str(tar), "--ps",
                           "16", "--num_patches", "3", "--num_cores", "2",
                           "--seed", "7"])
    assert "processed 2 image pairs" in capsys.readouterr().out
    jax_patches(src, str(tmp_path / "jax"), ps=16, num_patches=3,
                num_workers=1, seed=7)
    for sub in ("gt", "hazy"):
        names = sorted(os.listdir(tar / sub))
        assert names == sorted(os.listdir(tmp_path / "jax" / sub))
        assert len(names) == 6
        for n in names:
            np.testing.assert_array_equal(
                load_img(str(tar / sub / n), u8=True),
                load_img(str(tmp_path / "jax" / sub / n), u8=True))


# ------------------------------------------------------------ antialias

@pytest.mark.parametrize("pad_type", ["reflect", "repl", "zero"])
def test_blur_downsample_equals_jax(pad_type):
    """blur_downsample against JAX's for filt_size 1-7, strides 1 and 2 and
    pad_off 0 and 1. On inputs that are multiples of 1/256 every product
    and sum is exact in float32 (the filter taps are k/2^m), so the two
    must agree bit for bit whatever order their convolutions sum in; on
    arbitrary floats to two ulps."""
    from dehaze_tpu.ops.antialias import blur_downsample as jax_blur
    from dehaze_tpu_torch.ops.antialias import blur_downsample

    rng = np.random.default_rng(0)
    grid = (rng.integers(0, 256, size=(2, 13, 11, 3)) / 256).astype(
        np.float32)
    floats = rng.uniform(size=(2, 13, 11, 3)).astype(np.float32)
    for f in range(1, 8):
        for stride in (1, 2):
            for off in (0, 1):
                args = (f, stride, pad_type, off)
                a = blur_downsample(torch.from_numpy(grid), *args).numpy()
                b = np.asarray(jax_blur(jnp.asarray(grid), *args))
                np.testing.assert_array_equal(a, b, err_msg=str(args))
                a = blur_downsample(torch.from_numpy(floats), *args).numpy()
                b = np.asarray(jax_blur(jnp.asarray(floats), *args))
                np.testing.assert_allclose(a, b, rtol=0, atol=2.4e-7,
                                           err_msg=str(args))
    with pytest.raises(ValueError):
        blur_downsample(torch.zeros(1, 4, 4, 3), pad_type="wrap")


# ---------------------------------------------------- bundle and meter

def test_bundle_equals_jax(tmp_path):
    """The bundled per-image .mat files against the JAX bundler's: the
    same keys, object arrays of the same crops and the same flags."""
    import scipy.io as sio

    from dehaze_tpu.utils import bundle as JB
    from dehaze_tpu_torch.utils import bundle as TB

    rng = np.random.default_rng(0)
    for i in range(2):
        for b in range(3):
            sio.savemat(str(tmp_path / ("%04d_%02d.mat" % (i + 1, b + 1))),
                        {"Idenoised_crop": rng.uniform(size=(4, 5, 3))})
    for raw, tfn, jfn in ((True, TB.bundle_submissions_raw,
                           JB.bundle_submissions_raw),
                          (False, TB.bundle_submissions_srgb,
                           JB.bundle_submissions_srgb)):
        t = tfn(str(tmp_path), f"t{raw}", n_images=2, n_blocks=3)
        j = jfn(str(tmp_path), f"j{raw}", n_images=2, n_blocks=3)
        assert sorted(os.listdir(t)) == sorted(os.listdir(j)) == [
            "0001.mat", "0002.mat"]
        for n in os.listdir(t):
            a, b = sio.loadmat(os.path.join(t, n)), sio.loadmat(
                os.path.join(j, n))
            assert sorted(k for k in a if not k.startswith("__")) == \
                sorted(k for k in b if not k.startswith("__")) == [
                    "Idenoised", "eval_version", "israw"]
            assert a["Idenoised"].dtype == object
            for x, y in zip(a["Idenoised"].ravel(), b["Idenoised"].ravel()):
                np.testing.assert_array_equal(x, y)
            for k in ("israw", "eval_version"):
                np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(FileNotFoundError):
        TB.bundle_submissions(str(tmp_path), "x", israw=False, n_images=3,
                              n_blocks=3)


def test_average_meter_equals_jax():
    from dehaze_tpu.ops.meters import AverageMeter as JM
    from dehaze_tpu_torch.ops.meters import AverageMeter as TM

    t, j = TM("loss"), JM("loss")
    for m in (t, j):
        m.update(1.0)
        m.update(np.array([2.0, 3.0, 4.0]))
        m.update(5.0, n=2)
        m.update(np.float32(0.5))
    assert (t.count, t.sum, t.avg, t.std, str(t)) == \
        (j.count, j.sum, j.avg, j.std, str(j))
    t.update(torch.tensor([1.0, 2.0]))
    assert t.count == j.count + 2
    t.reset()
    assert (t.count, t.avg, t.std) == (0, 0.0, 0.0)
