"""The port's loss-landscape stack against the JAX package, on the CPU.

Same inputs go through the JAX function and its port: the filter-
normalized bases (seeded numpy bases in the JAX layout, through the weight
bridge), the l1/l2 columns, the sweep's rows through both packages'
`cli.landscape` with the same bases, the CSVs (each package reads,
resumes and merges the other's), the flatness statistics, and the
`--points_per_batch` and `--data_axis` sweeps against the serial one.
Small sizes: embed 8, 32² patches, f32, batch 2. ProbSparse sampling and
MixUp draws are pinned on both sides, as in test_torch_port_train.
Tolerances: bases 1e-6, l1/l2 1e-5 relative, losses 2e-4 relative (the
parity bar); the port's own sweeps agree bit for bit.
"""

import csv
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dehaze_tpu.cli import landscape as JCLI
from dehaze_tpu.models import get_arch as jax_get_arch
from dehaze_tpu.ops import landscape as JLS
from dehaze_tpu.ops import probsparse as PS
from dehaze_tpu.utils import convert_torch as CT
from dehaze_tpu_torch.cli import landscape as TCLI
from dehaze_tpu_torch.config import ModelConfig
from dehaze_tpu_torch.data import augment as TA
from dehaze_tpu_torch.data.synth import write_dataset
from dehaze_tpu_torch.models import get_arch
from dehaze_tpu_torch.models import vgg as TV
from dehaze_tpu_torch.ops import landscape as TLS
from dehaze_tpu_torch.ops import probsparse as TPS
from dehaze_tpu_torch.utils import convert as TC

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 32
LOSS_TOL = 2e-4

# variant: (port ModelConfig fields, JAX converter, port bridge)
VARIANTS = {
    "probsparse": (dict(), CT.convert_uformer_state_dict,
                   TC.state_dict_from_jax_params),
    "wmsa_linear": (dict(attention="full"),
                    lambda sd: CT.convert_uformer_state_dict(
                        sd, attention="full", token_projection="linear"),
                    TC.state_dict_from_jax_params),
    "wmsa_conv": (dict(attention="full", token_projection="conv"),
                  lambda sd: CT.convert_uformer_state_dict(
                      sd, attention="full", token_projection="conv"),
                  TC.state_dict_from_jax_params),
    "ffa": (dict(arch="ffa", ffa_blocks=1, ffa_dim=16),
            lambda sd: CT.convert_ffa_state_dict(sd, blocks=1),
            TC.ffa_state_dict_from_jax_params),
    "unet": (dict(arch="unet"), CT.convert_unet_state_dict,
             TC.unet_state_dict_from_jax_params),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU tensors: with several test
    workers on the host, torch's thread pools stall each other in
    hand-offs (a small op then takes tens of times as long)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(variant, seed=0):
    torch.manual_seed(seed)
    fields = VARIANTS[variant][0]
    return get_arch(ModelConfig(img_size=IMG, embed_dim=8,
                                dtype=torch.float32, **fields)).eval()


def _jax_params(model, variant):
    """The port model's params in the JAX layout (copied)."""
    return jax.tree.map(lambda a: np.array(a, np.float32),
                        VARIANTS[variant][1](model.state_dict()))


def _raw_bases(jparams, seed):
    """Two seeded standard-normal bases in the JAX layout."""
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32), jparams) for _ in range(2)]


@jax.jit
def _jax_normalize(b, params):
    b = JLS.normalize_filter(b, params)
    return JLS.ignore_kw(JLS.ignore_bn(b), list(TLS.DEFAULT_KWS))


def _jax_bases(jparams, raw):
    """JAX's create_bases with the given draws in place of jax.random (one
    compiled program for the pair)."""
    return [jax.tree.map(np.asarray, _jax_normalize(b, jparams))
            for b in raw]


@pytest.fixture(scope="module")
def jax_bases(cases):
    """{variant: JAX's bases}, computed at first use."""
    memo = {}

    def get(variant):
        if variant not in memo:
            _, jparams, raw = cases[variant]
            memo[variant] = _jax_bases(jparams, raw)
        return memo[variant]

    return get


def _bridge(variant, tree):
    return {k: v.clone() for k, v in VARIANTS[variant][2](tree).items()}


@pytest.fixture(scope="module")
def cases():
    """{variant: (port model, JAX params, raw bases)}."""
    out = {}
    for i, variant in enumerate(VARIANTS):
        model = _model(variant, seed=i)
        jparams = _jax_params(model, variant)
        out[variant] = (model, jparams, _raw_bases(jparams, 10 + i))
    return out


# ---------------------------------------------------------------- bases

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bases_match_jax(cases, jax_bases, variant):
    """Seeded bases in the JAX layout through JAX's normalize_filter /
    ignore_bn / ignore_kw, then the bridge, equal the bridged raw bases
    through the port's functions (norms over `filter_dims`)."""
    model, jparams, raw = cases[variant]
    params = TLS.model_params(model)
    dims = TLS.filter_dims(model)
    want = [_bridge(variant, b) for b in jax_bases(variant)]
    for r, w in zip(raw, want):
        b = TLS.normalize_filter(_bridge(variant, r), params, dims)
        got = TLS.ignore_kw(TLS.ignore_bn(b), TLS.DEFAULT_KWS)
        assert got.keys() == w.keys() == params.keys()
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), w[k].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    # a slip of the axis shows: dim 0 everywhere is another basis
    if variant == "probsparse":
        b = TLS.normalize_filter(_bridge(variant, raw[0]), params)
        k = "input_proj.proj.0.weight"
        assert not np.allclose(b[k].numpy(), want[0][k].numpy(), rtol=1e-3)


def test_create_bases_seeded_and_normalized(cases):
    """The port's own bases: the same at the same seed, other at another,
    zero on 1-D and kw-matched tensors, and each Linear weight's rows (the
    JAX Dense kernel's columns) with the weight's norms."""
    model = cases["probsparse"][0]
    params, dims = TLS.model_params(model), TLS.filter_dims(model)
    a = TLS.create_bases(params, TLS.DEFAULT_KWS, seed=3, dims=dims)
    b = TLS.create_bases(params, TLS.DEFAULT_KWS, seed=3, dims=dims)
    c = TLS.create_bases(params, TLS.DEFAULT_KWS, seed=4, dims=dims)
    k = "encoderlayer_0.blocks.0.attn.ProbSpare.query_projection.weight"
    assert torch.equal(a[0][k], b[0][k]) and not torch.equal(a[0][k],
                                                             a[1][k])
    assert not torch.equal(a[0][k], c[0][k])
    np.testing.assert_allclose(a[0][k].norm(dim=1).numpy(),
                               params[k].norm(dim=1).numpy(), rtol=1e-5)
    for name, t in a[0].items():
        if t.ndim < 2 or "relative_position" in name:
            assert not t.any(), name


@pytest.mark.parametrize("variant", ["wmsa_linear"])
def test_norm_columns_match_jax(cases, jax_bases, variant):
    """l1 / l2 of perturbed weights against JAX's param_l1 / param_l2, the
    W-MSA 'linear' qkv counted as its one fused JAX leaf (the ProbSparse
    Uformer's and FFA-Net's columns are held in the sweep test)."""
    model, jparams, _ = cases[variant]
    jb = jax_bases(variant)
    tb = [_bridge(variant, b) for b in jb]
    params = TLS.model_params(model)
    # JAX's get_loss_landscape jits its perturb and its norms the same way
    perturb = jax.jit(JLS.perturb)
    norms = jax.jit(lambda q: (JLS._param_l1_val(q), JLS._param_l2_val(q)))
    for x, y in [(0.0, 0.0), (-1.0, 0.5), (0.75, -0.25)]:
        l1, l2 = norms(perturb(jparams, jb, jnp.float32(x), jnp.float32(y)))
        tp = TLS.perturb(params, tb, x, y)
        np.testing.assert_allclose(TLS.param_l1(tp), float(l1), rtol=1e-5)
        np.testing.assert_allclose(TLS.param_l2(tp), float(l2), rtol=1e-5)
    if variant == "wmsa_linear":  # the fused leaf is one group
        groups = TLS.tensor_groups(params)
        assert len(groups) == len(jax.tree.leaves(jparams)) < len(params)


# ------------------------------------------------------- the CLI sweeps

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    td = tmp_path_factory.mktemp("ls_data")
    write_dataset(str(td / "train"), 4, 40, seed=3)
    return str(td)


@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    from dehaze_tpu.cli.convert_vgg import convert

    td = tmp_path_factory.mktemp("ls_vgg")
    out = {}
    for arch in ("vgg19", "vgg16"):
        torch.save(TV.synthesize_torchvision_state_dict(arch, seed=5),
                   td / f"{arch}.pth")
        convert(str(td / f"{arch}.pth"), str(td / f"{arch}.npz"))
        out[arch] = str(td / f"{arch}.npz")
    return out


@pytest.fixture(scope="module")
def weights(cases, data):
    """The probsparse and ffa models as the checkpoints both CLIs read."""
    ps = os.path.join(data, "uformer.pth")
    torch.save({"epoch": 0, "state_dict": cases["probsparse"][0]
                .state_dict()}, ps)
    pk = os.path.join(data, "ffa.pk")
    torch.save({"model": cases["ffa"][0].state_dict()}, pk)
    return {"probsparse": ps, "ffa": pk}


LAM = np.array([0.3, 0.8], np.float32)
PERM = np.array([1, 0])


@pytest.fixture
def pinned(monkeypatch):
    """ProbSparse tables (one per N) and the MixUp draws, the same on both
    sides."""
    rng = np.random.default_rng(42)
    tables = {n: rng.integers(0, n, size=(n, PS.probsparse_u(n))).astype(
        np.int32) for n in (4, 16, 64)}
    monkeypatch.setattr(PS, "sample_indices",
                        lambda key, l_q, l_k, u_part: jnp.asarray(
                            tables[l_q][:, :u_part]))
    monkeypatch.setattr(TPS, "sample_indices",
                        lambda n_q, n_k, u_part, generator: torch.from_numpy(
                            tables[n_q][:, :u_part].copy()))
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, b: jnp.asarray(PERM))
    monkeypatch.setattr(jax.random, "beta",
                        lambda key, a, b, shape: jnp.asarray(
                            LAM.reshape(shape)))
    monkeypatch.setattr(TA, "mixup_draw", lambda b, beta, g: (LAM, PERM))


def _flags(variant, weights, data, vgg_npz):
    flags = ["--weights", weights[variant], "--train_dir",
             os.path.join(data, "train"), "--train_ps", IMG, "--batch_size",
             2, "--dtype", "float32", "--max_batches", 1, "--n", 3,
             "--train_workers", 1]
    if variant == "ffa":
        return flags + ["--arch", "ffa", "--ffa_blocks", 1, "--ffa_dim", 16,
                        "--perloss", "--vgg_weights", vgg_npz["vgg16"]]
    return flags + ["--embed_dim", 8, "--vgg_weights", vgg_npz["vgg19"]]


def _port_sweep(flags, out_csv, *extra):
    TCLI.main([str(a) for a in flags] + ["--device", "cpu", "--out_csv",
                                         out_csv, "--out_plot", ""]
              + [str(a) for a in extra])
    return TLS.load_landscape_csv(out_csv)


@pytest.mark.parametrize("variant", ["probsparse", "ffa"])
def test_sweep_rows_match_jax_cli(cases, jax_bases, weights, data, vgg_npz,
                                  pinned, monkeypatch, tmp_path, variant):
    """Both packages' cli.landscape on a 3×3 grid with the same bases
    (JAX's create_bases and the port's return them): the ProbSparse
    Uformer with the CR loss on VGG19, and FFA-Net with --perloss on
    VGG16. Every row's loss, l1 and l2 against JAX's; the (0, 0) row, the
    checkpoint itself, needs no bases at all."""
    jb = jax_bases(variant)
    tb = [_bridge(variant, b) for b in jb]
    monkeypatch.setattr(JLS, "create_bases", lambda params, kws=None,
                        seed=0: [jax.tree.map(jnp.asarray, b) for b in jb])
    monkeypatch.setattr(TLS, "create_bases",
                        lambda params, kws=None, seed=0, dims=None: tb)
    flags = _flags(variant, weights, data, vgg_npz)

    def build(cfg, path, train_ps):
        """JAX's build_model_and_params for a torch checkpoint, without
        the init it compiles as a template for .msgpack files."""
        params = (CT.load_reference_ffa_checkpoint(path, blocks=1)
                  if variant == "ffa" else CT.load_reference_checkpoint(path))
        return (jax_get_arch(cfg.model),
                {"params": jax.tree.map(jnp.asarray, params)},
                jax.random.PRNGKey(0))

    monkeypatch.setattr(JCLI, "build_model_and_params", build)
    jcsv = str(tmp_path / "jax.csv")
    monkeypatch.setattr(sys, "argv", ["landscape"] + [str(a) for a in flags]
                        + ["--out_csv", jcsv, "--out_plot",
                           str(tmp_path / "jax.jpg")])
    JCLI.main()
    want = {(r["x"], r["y"]): r for r in JLS.load_landscape_csv(jcsv)}
    got = {(r["x"], r["y"]): r
           for r in _port_sweep(flags, str(tmp_path / "port.csv"))}
    assert got.keys() == want.keys() and len(got) == 9
    for xy, w in want.items():
        np.testing.assert_allclose(got[xy]["loss"], w["loss"],
                                   rtol=LOSS_TOL, err_msg=str(xy))
        for k in ("l1", "l2"):
            np.testing.assert_allclose(got[xy][k], w[k], rtol=1e-5,
                                       err_msg=f"{xy} {k}")
    center = got[(0.0, 0.0)]
    assert center["loss"] > 0 and np.isfinite(list(center.values())).all()
    # the two packages' statistics of the same rows are the same numbers
    rows = list(got.values())
    assert TLS.landscape_stats(rows) == JLS.landscape_stats(rows)
    for a, b in zip(TLS.radial_profile(rows), JLS.radial_profile(rows)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def serial_csv(weights, data, vgg_npz, tmp_path_factory):
    """The port's serial sweep of the ProbSparse Uformer (unpinned draws,
    no CR: the generator seeded 1 per pass draws MixUp and the tables)."""
    out = str(tmp_path_factory.mktemp("ls_serial") / "serial.csv")
    _port_sweep(_flags("probsparse", weights, data, vgg_npz) +
                ["--w_loss_vgg7", 0], out)
    return out


@pytest.mark.parametrize("p", [2, 4])
def test_points_per_batch_equals_serial(serial_csv, weights, data, vgg_npz,
                                        tmp_path, p):
    """--points_per_batch 2 and 4 (9 points: the last chunk padded) write
    the serial sweep's CSV byte for byte."""
    out = str(tmp_path / f"p{p}.csv")
    _port_sweep(_flags("probsparse", weights, data, vgg_npz) +
                ["--w_loss_vgg7", 0], out, "--points_per_batch", p)
    with open(out) as a, open(serial_csv) as b:
        assert a.read() == b.read()


@pytest.fixture(autouse=True, scope="module")
def data_axis_run(weights, data, vgg_npz, tmp_path_factory):
    """torchrun with 2 CPU ranks (gloo), --points_per_batch 2 --data_axis
    2, started with the module's first test so that it runs beside the
    others: (its process, its CSV)."""
    out = str(tmp_path_factory.mktemp("ls_dp") / "dp.csv")
    flags = [str(a) for a in _flags("probsparse", weights, data, vgg_npz)]
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "dehaze_tpu_torch.cli.landscape"]
        + flags + ["--w_loss_vgg7", "0", "--device", "cpu",
                   "--points_per_batch", "2", "--data_axis", "2",
                   "--out_csv", out, "--out_plot", ""],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": _REPO, "OMP_NUM_THREADS": "1"})
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_data_axis_two_gloo_ranks_equal_serial(serial_csv, data_axis_run):
    """The two gloo ranks' sweep: rank 0's CSV is the serial sweep's, byte
    for byte, and only rank 0 prints the grid."""
    proc, out = data_axis_run
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-3000:]
    assert stdout.count("Grid: [") == 9
    with open(out) as a, open(serial_csv) as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("extra,message", [
    (["--data_axis", "2"], "--data_axis needs --points_per_batch > 1"),
    (["--data_axis", "2", "--points_per_batch", "3"],
     "--points_per_batch 3 not divisible by --data_axis 2"),
    (["--data_axis", "2", "--points_per_batch", "2"],
     "torchrun --nproc_per_node 2"),
])
def test_data_axis_refusals(weights, data, vgg_npz, tmp_path, extra,
                            message):
    """JAX's two refusals with its messages, and the launch hint outside
    torchrun; nothing is written."""
    flags = [str(a) for a in _flags("probsparse", weights, data, vgg_npz)]
    with pytest.raises(SystemExit) as e:
        TCLI.main(flags + ["--device", "cpu", "--out_csv",
                           str(tmp_path / "x.csv"), "--out_plot", ""]
                  + extra)
    assert message in str(e.value.code)
    assert not os.path.exists(tmp_path / "x.csv")


# ---------------------------------------------------------------- CSVs

def _toy():
    """A tiny parameter set in both layouts (a Dense kernel, its bias and a
    bias table) and one pair of bases, through the same bridge rule."""
    rng = np.random.default_rng(0)
    jp = {"dense": {"kernel": rng.normal(size=(4, 3)).astype(np.float32),
                    "bias": rng.normal(size=(3,)).astype(np.float32)},
          "relative_position_bias_table": rng.normal(size=(9, 2)).astype(
              np.float32)}
    jb = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32), jp) for _ in range(2)]

    def port(t):
        return {"dense.weight": torch.from_numpy(t["dense"]["kernel"].T
                                                 .copy()),
                "dense.bias": torch.from_numpy(t["dense"]["bias"]),
                "relative_position_bias_table": torch.from_numpy(
                    t["relative_position_bias_table"])}

    return jp, jb, port(jp), [port(b) for b in jb]


def _jax_toy_loss(p):
    return float(sum(jnp.sum(jnp.square(x)) for x in jax.tree.leaves(p)))


def _port_toy_loss(points):
    return [float(sum((t.double() ** 2).sum() for t in p.values()))
            for p in points]


def test_shard_merge_and_cross_reading(tmp_path):
    """--shard-style point filters: the port's two shards and JAX's two
    shards each merge to the full 9-point grid in either package; JAX's
    rows read by the port and the port's by JAX are the same rows."""
    jp, jb, tp, tb = _toy()
    jparams = jax.tree.map(jnp.asarray, jp)
    jbases = [jax.tree.map(jnp.asarray, b) for b in jb]
    for i in range(2):
        JLS.get_loss_landscape(jparams, _jax_toy_loss, bases=jbases, n=3,
                               scale=0.5, csv_path=str(tmp_path /
                                                       f"j_{i}.csv"),
                               point_filter=lambda idx, _i=i: idx % 2 == _i)
        TLS.get_loss_landscape(tp, _port_toy_loss, bases=tb, n=3, scale=0.5,
                               csv_path=str(tmp_path / f"t_{i}.csv"),
                               point_filter=lambda idx, _i=i: idx % 2 == _i)
    merged = {}
    for who, lib in (("t", TLS), ("j", JLS)):
        for src in ("t", "j"):
            rows = lib.merge_landscape_csvs(str(tmp_path / f"{src}_*.csv"))
            assert len({(r["x"], r["y"]) for r in rows}) == 9
            merged[who, src] = {(r["x"], r["y"]): r for r in rows}
    assert merged["t", "t"] == merged["j", "t"]
    assert merged["t", "j"] == merged["j", "j"]
    for xy, r in merged["t", "j"].items():
        for k in ("l1", "l2", "loss"):
            np.testing.assert_allclose(merged["t", "t"][xy][k], r[k],
                                       rtol=1e-5, err_msg=f"{xy} {k}")
    with pytest.raises(FileNotFoundError):
        TLS.merge_landscape_csvs(str(tmp_path / "nope_*.csv"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_after_header_only_crash(tmp_path, writer):
    """A sweep killed after the header (written by either package) resumes
    in the port without a second header; a resumed sweep skips the points
    already in the file (here 3 of JAX's rows), and JAX resumes the port's
    file the same way."""
    jp, jb, tp, tb = _toy()
    jparams = jax.tree.map(jnp.asarray, jp)
    jbases = [jax.tree.map(jnp.asarray, b) for b in jb]
    path = str(tmp_path / "ls.csv")
    if writer == "jax":
        JLS.get_loss_landscape(jparams, _jax_toy_loss, bases=jbases, n=3,
                               csv_path=path, point_filter=lambda i: i < 3)
        seen = []
        rows = TLS.get_loss_landscape(
            tp, lambda pts: seen.extend(pts) or _port_toy_loss(pts),
            bases=tb, n=3, csv_path=path)
        assert len(rows) == len(seen) == 6
    else:
        with open(path, "w", newline="") as f:
            csv.writer(f).writerow(["x", "y", "l1", "l2", "loss"])
        TLS.get_loss_landscape(tp, _port_toy_loss, bases=tb, n=3,
                               csv_path=path, point_filter=lambda i: i < 5)
        assert len(JLS.get_loss_landscape(jparams, _jax_toy_loss,
                                          bases=jbases, n=3,
                                          csv_path=path)) == 4
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines.count("x,y,l1,l2,loss") == 1 and len(lines) == 10
    assert len(TLS.load_landscape_csv(path)) == len(
        JLS.load_landscape_csv(path)) == 9


def test_grid_coordinates_equal_jax():
    jg = np.stack(np.meshgrid(np.linspace(-1.5, 1.5, 5),
                              np.linspace(-1.5, 1.5, 5)), 0).transpose(
        1, 2, 0).reshape(-1, 2)
    assert TLS.grid(5, 1.5) == [(float(x), float(y)) for x, y in jg]


def test_landscape_pair_cli(tmp_path, capsys):
    """cli.landscape_pair: the JAX tool's JSON line on the same CSVs, with
    the figure, and the statistics alone with --out ''."""
    import json

    from dehaze_tpu.cli import landscape_pair as JPair
    from dehaze_tpu_torch.cli import landscape_pair as TPair

    def bowl(path, k):
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["x", "y", "l1", "l2", "loss"])
            for x, y in TLS.grid(5, 1.0):
                w.writerow([x, y, 0.0, 0.0, 1.0 + k * (x * x + y * y)])

    a, b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    bowl(a, 1.0)
    bowl(b, 4.0)
    fig = str(tmp_path / "pair.jpg")
    TPair.main([a, b, "--out", fig])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert os.path.getsize(fig) > 0 and got["flatter"] == "ViT"
    old = sys.argv
    sys.argv = ["landscape_pair", a, b, "--out", str(tmp_path / "j.jpg")]
    try:
        JPair.main()
    finally:
        sys.argv = old
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    TPair.main([a, b, "--out", ""])
    assert json.loads(capsys.readouterr().out.strip()) == want
