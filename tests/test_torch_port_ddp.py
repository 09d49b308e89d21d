"""Data parallelism of the port on the CPU: the DDP train step
(`Trainer(data_parallel=True)`), the per-process batch slices of
`train_batches`, and `--data_axis` on `cli.train`, `cli.test_long` and
`cli.stream`.

The two-rank runs are real gloo ranks, one process each, started once by
a module fixture; the JAX side is the mesh train step on the conftest's
virtual CPU devices. Tiny model (embed 8, img_size 32, f32), batch 4; the
train steps' models have the depths `DEPTHS` (two blocks, unshifted and
shifted, in the first and last stages, one, unshifted, in every other:
DDP's reduction, the per-rank slices and the generators' replay are the
same for every block, and the JAX mesh step then compiles in about 60% of
the full depth's time); the CLIs' models have the full depth.
Tolerances: the two-rank step against the one-rank step, loss rtol 1e-5,
gradients rtol 1e-4 over a floor of 1e-5 of the tensor's largest
element (`_grad_floor`), parameters after the first step rtol
1e-4 / atol 1e-6 (the bar of `tests/test_sharding.py`) where the gradient
is 100 times AdamW's eps (`_adam_moved`); against JAX's mesh step 2e-4 with the sample
tables and the MixUp draws pinned on both sides; the CLIs bit for bit,
except `cli.train`'s step losses (rtol 1e-5).
"""

import glob
import inspect
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dehaze_tpu import config as JC
from dehaze_tpu.data import pipeline as JP
from dehaze_tpu.ops import probsparse as PS
from dehaze_tpu.parallel.mesh import batch_sharding, make_mesh, replicated
from dehaze_tpu.train.trainer import Trainer as JaxTrainer, TrainState
from dehaze_tpu.utils.convert_torch import convert_uformer_state_dict
from dehaze_tpu_torch import config as TC
from dehaze_tpu_torch.data import pipeline as TP
from dehaze_tpu_torch.data.synth import write_dataset
from dehaze_tpu_torch.models import vgg as TV
from dehaze_tpu_torch.models.uformer import Uformer
from dehaze_tpu_torch.train.trainer import Trainer
from dehaze_tpu_torch.utils.convert import state_dict_from_jax_params

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG, B, STEPS = 32, 4, 2
DEPTHS = (2, 1, 1, 1, 1, 1, 1, 1, 2)
LAM = np.array([0.2, 0.9, 0.5, 0.7], np.float32)  # pinned MixUp draws
PERM = np.array([2, 0, 3, 1])


# 'free': MixUp, CR (random VGG) and drop_path 0.1, nothing pinned;
# 'remat': the same with --remat (the recompute replays the generators);
# 'pinned': CR on converted VGG weights, drop_path 0, the sampling and
# MixUp draws pinned (for JAX); 'accum': Charbonnier only, drop_path 0,
# two microbatches.
SCENARIOS = {
    "free": dict(drop_path_rate=0.1, cr=True, vgg=False, pinned=False,
                 mixup=True, accum=1),
    "remat": dict(drop_path_rate=0.1, cr=True, vgg=False, pinned=False,
                  mixup=True, accum=1, remat=True),
    "pinned": dict(drop_path_rate=0.0, cr=True, vgg=True, pinned=True,
                   mixup=True, accum=1),
    "accum": dict(drop_path_rate=0.0, cr=False, vgg=False, pinned=False,
                  mixup=False, accum=2),
}


def port_cfg(spec, vgg_npz):
    """The port's config of a scenario (the workers run this source)."""
    return TC.Config(
        model=TC.ModelConfig(img_size=32, embed_dim=8, dtype=torch.float32,
                             depths=DEPTHS,
                             drop_path_rate=spec["drop_path_rate"],
                             remat=spec.get("remat", False)),
        loss=TC.LossConfig(w_contrast=1.0 if spec["cr"] else 0.0,
                           vgg_weights=vgg_npz if spec["vgg"] else None),
        train=TC.TrainConfig(warmup=False))


# Each rank runs STEPS steps of each scenario on its rows of the global
# batches and rank 0 saves the metrics of every step, and the gradients
# and the parameters of the first: after a second AdamW step a weight whose
# gradient cancels to rounding noise can move by a fraction of the lr.
WORKER = r'''
import json, sys, warnings
import numpy as np, torch
torch.set_num_threads(1)
from dehaze_tpu_torch import config as TC
''' + f"DEPTHS = {DEPTHS!r}\n" + inspect.getsource(port_cfg) + r'''
from dehaze_tpu_torch.data import augment as TA
from dehaze_tpu_torch.ops import probsparse as TPS
from dehaze_tpu_torch.parallel import dist
from dehaze_tpu_torch.train.trainer import Trainer

out_dir, vgg_npz, steps = sys.argv[1], sys.argv[2], int(sys.argv[3])
scenarios, (lam, perm) = json.loads(sys.argv[4]), json.loads(sys.argv[5])
lam, perm = np.asarray(lam, np.float32), np.asarray(perm)
dist.init("cpu")
r, n = dist.rank(), dist.world()
data = np.load(f"{out_dir}/batches.npz")
tables = {k: v for k, v in np.load(f"{out_dir}/tables.npz").items()}
sample_indices, mixup_draw = TPS.sample_indices, TA.mixup_draw
for name, spec in scenarios.items():
    TPS.sample_indices = (lambda nq, nk, u, g: torch.from_numpy(
        tables[str(nq)][:, :u].copy())) if spec["pinned"] else sample_indices
    TA.mixup_draw = ((lambda b, beta, g: (lam, perm)) if spec["pinned"]
                     else mixup_draw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random VGG warns
        tr = Trainer(port_cfg(spec, vgg_npz), steps_per_epoch=1,
                     device="cpu", data_parallel=True)
    b = data["clean"].shape[1] // n
    rows = slice(r * b, (r + 1) * b)
    metrics, grads = [], {}
    for s in range(steps):
        m = tr.train_step(data["clean"][s][rows], data["hazy"][s][rows],
                          use_mixup=spec["mixup"], accum_steps=spec["accum"])
        metrics.append({k: float(v) for k, v in m.items()})
        if s == 0:
            grads = {k: p.grad.numpy().copy()
                     for k, p in tr.model.named_parameters()}
            params = {k: p.detach().numpy().copy()
                      for k, p in tr.model.named_parameters()}
    if r == 0:
        np.savez(f"{out_dir}/{name}.npz", metrics=json.dumps(metrics),
                 **{"grad." + k: v for k, v in grads.items()},
                 **{"param." + k: v for k, v in params.items()})
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
def vgg_npz(tmp_path_factory):
    from dehaze_tpu.cli.convert_vgg import convert

    td = tmp_path_factory.mktemp("ddp_vgg")
    torch.save(TV.synthesize_torchvision_state_dict("vgg19", seed=3),
               td / "vgg19.pth")
    convert(str(td / "vgg19.pth"), str(td / "vgg19.npz"))
    return str(td / "vgg19.npz")


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    clean = rng.integers(0, 256, size=(STEPS, B, IMG, IMG, 3),
                         dtype=np.uint8)
    hazy = np.clip(clean * 0.6 + 80, 0, 255).astype(np.uint8)
    return clean, hazy


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, tables, vgg_npz, batches):
    """{scenario: (metrics per step, grads and params of step 1)} of
    the two-rank run, started in the background at the first use."""
    td = tmp_path_factory.mktemp("ddp")
    np.savez(td / "tables.npz", **{str(k): v for k, v in tables.items()})
    np.savez(td / "batches.npz", clean=batches[0], hazy=batches[1])
    procs = launch(WORKER, 2, [td, vgg_npz, STEPS, json.dumps(SCENARIOS),
                               json.dumps([LAM.tolist(), PERM.tolist()])],
                   str(td))
    done = {}

    def get(scenario):
        if not done:
            wait_all(procs)
            for s in SCENARIOS:
                z = np.load(td / f"{s}.npz")
                done[s] = (json.loads(str(z["metrics"])),
                           {k[5:]: z[k] for k in z.files
                            if k.startswith("grad.")},
                           {k[6:]: z[k] for k in z.files
                            if k.startswith("param.")})
        return done[scenario]

    yield get
    for p in procs:
        p.kill()


def _one_rank(scenario, vgg_npz, batches):
    """The one-process step on the global batches, in one microbatch:
    metrics per step, grads and params of step 1."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random VGG warns
        tr = Trainer(port_cfg(SCENARIOS[scenario], vgg_npz),
                     steps_per_epoch=1, device="cpu")
    metrics, grads = [], {}
    for s in range(STEPS):
        m = tr.train_step(batches[0][s], batches[1][s],
                          use_mixup=SCENARIOS[scenario]["mixup"])
        metrics.append({k: float(v) for k, v in m.items()})
        if s == 0:
            grads = {k: p.grad.clone().numpy()
                     for k, p in tr.model.named_parameters()}
            params = {k: p.detach().clone().numpy()
                      for k, p in tr.model.named_parameters()}
    return metrics, grads, params


def _grad_floor(grad):
    """The summation-order floor of a gradient tensor: each element is a
    sum over the batch's pixels whose order differs between 2 and 4 rows a
    process, so an element that cancels to far below the tensor's scale
    keeps noise of that scale (1.2e-7 of it measured); 1e-5 of max|g|,
    and 1e-9 for the key biases, whose gradient is zero analytically (a
    softmax ignores a shift of its row) and rounding noise in fact."""
    return 1e-5 * float(np.abs(grad).max()) + 1e-9


def _adam_moved(got, want, grad):
    """The weights whose first AdamW update, lr·g/(|g| + eps), is set by the
    gradient's sign: |g| ≥ 100·eps (1e-6). Below, the update's slope in g,
    lr·eps/(|g| + eps)², turns the gradient's rounding noise into weight
    differences above 1e-6 (a gradient of 4e-10 against 9e-10 on one of
    32,768 weights of a downsample conv here, where the terms cancel); the
    gradient check holds those weights."""
    live = np.abs(grad) >= 1e-6
    return got[live], want[live]


def test_ddp_step_equals_one_rank_step(two_ranks, vgg_npz, batches):
    """Two steps with MixUp, the CR loss and DropPath 0.1, nothing pinned:
    the two-rank step is the one-process step on the global batch (global
    MixUp, the CR ratio of global means, global DropPath masks)."""
    got_m, got_g, got_p = two_ranks("free")
    want_m, want_g, want_p = _one_rank("free", vgg_npz, batches)
    for g, w in zip(got_m, want_m):
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, err_msg=key)
    assert got_m[0]["contrast"] > 0 and got_m[0]["all_an"] > 0
    assert set(got_p) == set(want_p)
    for k in want_p:
        np.testing.assert_allclose(got_g[k], want_g[k], rtol=1e-4,
                                   atol=_grad_floor(want_g[k]), err_msg=k)
        np.testing.assert_allclose(*_adam_moved(got_p[k], want_p[k],
                                                want_g[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_ddp_remat_step_equals_one_rank_plain_step(two_ranks, vgg_npz,
                                                   batches):
    """The two-rank step under --remat (each block recomputed, its
    generators replayed on the rank's share of the masks) against the
    one-process plain step."""
    got_m, got_g, got_p = two_ranks("remat")
    want_m, want_g, want_p = _one_rank("free", vgg_npz, batches)
    for g, w in zip(got_m, want_m):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], rtol=1e-4,
                                   atol=_grad_floor(want_g[k]), err_msg=k)
        np.testing.assert_allclose(*_adam_moved(got_p[k], want_p[k],
                                                want_g[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_ddp_accumulated_step_gives_the_full_batch_gradient(two_ranks,
                                                            vgg_npz,
                                                            batches):
    """Charbonnier only, drop_path 0: two microbatches on each of two
    ranks (DDP's reduction deferred to the last) give the one-process
    full-batch gradient."""
    _, got_g, got_p = two_ranks("accum")
    _, want_g, want_p = _one_rank("accum", vgg_npz, batches)
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], rtol=1e-4,
                                   atol=_grad_floor(want_g[k]), err_msg=k)
        np.testing.assert_allclose(*_adam_moved(got_p[k], want_p[k],
                                                want_g[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_ddp_step_matches_jax_mesh_step(two_ranks, tables, vgg_npz,
                                        batches, monkeypatch):
    """The two-rank step against JAX's train step on a 2-device mesh:
    MixUp and the CR loss (converted VGG19 weights) on, drop_path 0, the
    sample tables and MixUp's λ and permutation pinned on both sides.
    Losses of both steps within 2e-4 relative; every gradient leaf of the
    first step within 2e-4 (JAX's, read back from Adam's first moment)."""
    monkeypatch.setattr(PS, "sample_indices",
                        lambda key, l_q, l_k, u_part: jnp.asarray(
                            tables[l_q][:, :u_part]))
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, b: jnp.asarray(PERM))
    monkeypatch.setattr(jax.random, "beta",
                        lambda key, a, b, shape: jnp.asarray(
                            LAM.reshape(shape)))
    jcfg = JC.Config(model=JC.ModelConfig(img_size=IMG, embed_dim=8,
                                          dtype=jnp.float32, depths=DEPTHS,
                                          drop_path_rate=0.0),
                     loss=JC.LossConfig(vgg_weights=vgg_npz),
                     train=JC.TrainConfig(warmup=False))
    mesh = make_mesh(2)
    jt = JaxTrainer(jcfg, steps_per_epoch=1, mesh=mesh)
    init = Trainer(port_cfg(SCENARIOS["pinned"], vgg_npz),
                   steps_per_epoch=1, device="cpu").model.state_dict()
    params = jax.tree.map(jnp.asarray,
                          convert_uformer_state_dict(init, depths=DEPTHS))
    state = jax.device_put(TrainState(step=jnp.zeros((), jnp.int32),
                                      params=params,
                                      opt_state=jt.tx.init(params)),
                           replicated(mesh))
    losses = []
    for s in range(STEPS):
        c, h = (jax.device_put(a[s], batch_sharding(mesh)) for a in batches)
        state, m = jt.train_step(state, c, h, jax.random.PRNGKey(s),
                                 use_mixup=True)
        losses.append(float(m["loss"]))
        if s == 0:
            jgrads = state_dict_from_jax_params(jax.tree.map(
                lambda mu: np.asarray(mu) / np.float32(1 - 0.9),
                state.opt_state[0].mu))
    got_m, got_g, _ = two_ranks("pinned")
    np.testing.assert_allclose([m["loss"] for m in got_m], losses,
                               rtol=2e-4)
    assert set(got_g) == set(jgrads)
    for k, g in got_g.items():
        np.testing.assert_allclose(g, jgrads[k].numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=k)


# stages 2 to 6 empty: the model the act_store tests use
EMPTY_DEPTHS = (2, 1, 0, 0, 0, 0, 0, 1, 2)


def test_one_rank_step_matches_jax_in_float64_at_empty_stages(
        tables, vgg_npz, batches, monkeypatch):
    """A witness that tells a port fault from rounding. At EMPTY_DEPTHS the
    pinned scenario's float32 gradients (MixUp and the CR loss on, as in
    the mesh test above) differ from JAX's far beyond 2e-4, on one process
    and one device as on two ranks and a 2-device mesh; with the CR loss
    off they agree within it. Here the same one-process step and JAX's
    one-device step run their activations in float64 (the parameters stay
    float32 on both sides): every gradient leaf within 1e-5 of the
    tensor's largest element (and 1e-12 for the key biases, zero
    analytically), so the float32 gap is the CR loss's rounding, not a
    difference of the two functions."""
    from dehaze_tpu_torch.data import augment as TA
    from dehaze_tpu_torch.ops import probsparse as TPS

    monkeypatch.setattr(PS, "sample_indices",
                        lambda key, l_q, l_k, u_part: jnp.asarray(
                            tables[l_q][:, :u_part]))
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, b: jnp.asarray(PERM))
    monkeypatch.setattr(jax.random, "beta",
                        lambda key, a, b, shape: jnp.asarray(
                            LAM.reshape(shape)))
    monkeypatch.setattr(TPS, "sample_indices",
                        lambda n_q, n_k, u_part, generator: torch.from_numpy(
                            tables[n_q][:, :u_part].copy()))
    monkeypatch.setattr(TA, "mixup_draw", lambda b, beta, g: (LAM, PERM))
    tr = Trainer(TC.Config(
        model=TC.ModelConfig(img_size=IMG, embed_dim=8, dtype=torch.float64,
                             depths=EMPTY_DEPTHS, drop_path_rate=0.0),
        loss=TC.LossConfig(w_contrast=1.0, vgg_weights=vgg_npz),
        train=TC.TrainConfig(warmup=False)), steps_per_epoch=1, device="cpu")
    params = convert_uformer_state_dict(tr.model.state_dict(),
                                        depths=EMPTY_DEPTHS)
    with jax.enable_x64(True):
        jt = JaxTrainer(JC.Config(
            model=JC.ModelConfig(img_size=IMG, embed_dim=8,
                                 dtype=jnp.float64, depths=EMPTY_DEPTHS,
                                 drop_path_rate=0.0),
            loss=JC.LossConfig(vgg_weights=vgg_npz),
            train=JC.TrainConfig(warmup=False)), steps_per_epoch=1)
        params = jax.tree.map(jnp.asarray, params)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=jt.tx.init(params))
        state, _ = jt.train_step(state, batches[0][0], batches[1][0],
                                 jax.random.PRNGKey(0), use_mixup=True)
        jgrads = state_dict_from_jax_params(jax.tree.map(
            lambda mu: np.asarray(mu, np.float64) / (1 - 0.9),
            state.opt_state[0].mu))
    tr.train_step(batches[0][0], batches[1][0], use_mixup=True)
    named = dict(tr.model.named_parameters())
    assert set(named) == set(jgrads)
    for k, p in named.items():
        want = jgrads[k].numpy()
        np.testing.assert_allclose(
            p.grad.double().numpy(), want, rtol=0,
            atol=1e-5 * float(np.abs(want).max()) + 1e-12, err_msg=k)


# ------------------------------------------------------------ data slices

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_data")
    write_dataset(str(root / "train"), 8, 48, seed=5)
    write_dataset(str(root / "val"), 3, IMG, seed=6)
    write_dataset(str(root / "DS"), 3, (40, 56), seed=7)
    torch.manual_seed(3)
    pth = str(root / "w.pth")
    torch.save(Uformer(TC.ModelConfig(img_size=IMG, embed_dim=8,
                                      dtype=torch.float32)).state_dict(), pth)
    return root, pth


def test_train_batches_process_slices_tile_the_global_batch(synth):
    """Process p of 2 gets rows [2p, 2p + 2) of every global batch of 4,
    as the JAX pipeline's process slices; 3 processes do not divide 4."""
    root, _ = synth
    kw = dict(batch_size=4, patch_size=IMG, seed=3, epoch=2, num_workers=2,
              u8=True)
    folder = TP.PairedFolder(str(root / "train"))
    whole = list(TP.train_batches(folder, **kw))
    jfolder = JP.PairedFolder(str(root / "train"))
    for p in (0, 1):
        got = list(TP.train_batches(folder, process_index=p,
                                    process_count=2, **kw))
        want = list(JP.train_batches(jfolder, process_index=p,
                                     process_count=2, **kw))
        assert len(got) == len(whole) == len(want) == 2
        for (gc, gn), (wc, wn), (jc, jn) in zip(got, whole, want):
            np.testing.assert_array_equal(gc, wc[2 * p:2 * p + 2])
            np.testing.assert_array_equal(gn, wn[2 * p:2 * p + 2])
            np.testing.assert_array_equal(gc, jc)
            np.testing.assert_array_equal(gn, jn)
    with pytest.raises(ValueError, match="divide evenly across 3"):
        next(iter(TP.train_batches(folder, process_index=0,
                                   process_count=3, **kw)))


# ------------------------------------------------------------------ CLIs

TINY = ["--device", "cpu", "--embed_dim", "8", "--train_ps", str(IMG),
        "--dtype", "float32"]


def _run(args, n=1):
    """`python -m args` in one process, or under torchrun with n."""
    head = ([sys.executable, "-m"] if n == 1 else
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(n), "-m"])
    r = subprocess.run(head + [str(a) for a in args], capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": _REPO})
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def _files(d):
    return {os.path.basename(f): open(f, "rb").read()
            for f in sorted(glob.glob(os.path.join(d, "*.png")))}


def test_cli_test_long_data_axis_is_the_one_process_run(synth):
    """`test_long --data_axis 2`: rank 0 prints the one-process lines in
    its order, and the PNGs (written by the rank that ran each frame) are
    the one-process ones, byte for byte."""
    root, pth = synth
    flags = ["dehaze_tpu_torch.cli.test_long", "--input_dir",
             str(root / "DS"), "--weights", pth] + TINY
    one = _run(flags + ["--result_dir", root / "long1"])
    two = _run(flags + ["--result_dir", root / "long2", "--data_axis", "2"],
               n=2)
    lines = [ln for ln in one.splitlines() if "PSNR" in ln]
    assert len(lines) == 4
    assert [ln for ln in two.splitlines() if "PSNR" in ln] == lines
    assert _files(root / "long2") == _files(root / "long1")
    assert len(_files(root / "long1")) == 3


def test_cli_stream_data_axis_is_the_one_process_run(synth):
    """`stream --data_axis 2`: every output PNG byte for byte the
    one-process stream's; rank 0 prints one summary over the 3 frames."""
    root, pth = synth
    flags = ["dehaze_tpu_torch.cli.stream", "--input_dir",
             str(root / "DS" / "hazy"), "--weights", pth] + TINY
    _run(flags + ["--result_dir", root / "s1"])
    two = _run(flags + ["--result_dir", root / "s2", "--data_axis", "2"],
               n=2)
    assert two.count("3 frames in ") == 1 and "2 processes" in two
    assert two.count("time split") == 1
    assert _files(root / "s2") == _files(root / "s1")
    assert len(_files(root / "s1")) == 3


def test_cli_train_data_axis_gives_the_one_process_steps(synth, tmp_path):
    """`train --data_axis 2` (one epoch of 2 steps at batch 4, CR on, an
    eval after each step): the one-process step losses within 1e-5
    relative and its eval PSNRs; only rank 0 logs and writes checkpoints,
    and its model_best.pth loads into the Uformer with strict=True."""
    root, _ = synth
    flags = ["dehaze_tpu_torch.cli.train", "--train_dir", root / "train",
             "--val_dir", root / "val", "--batch_size", "4", "--nepoch",
             "1", "--train_workers", "2"] + TINY

    def events(d):
        logs = glob.glob(str(d / "uformer_" / "*.jsonl"))
        assert len(logs) == 1  # one logger: rank 0's
        ev = [json.loads(ln) for ln in open(logs[0])]
        return ([x for e in ev if e["kind"] == "epoch"
                 for x in e["step_losses"]],
                [e["psnr"] for e in ev if e["kind"] == "eval"])

    _run(flags + ["--save_dir", tmp_path / "one"])
    _run(flags + ["--save_dir", tmp_path / "two", "--data_axis", "2"], n=2)
    (l1, p1), (l2, p2) = events(tmp_path / "one"), events(tmp_path / "two")
    assert len(l1) == len(l2) == 2 and len(p1) == len(p2) == 2
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    np.testing.assert_allclose(p2, p1, rtol=0, atol=1e-4)
    models = tmp_path / "two" / "uformer_" / "models"
    assert sorted(os.listdir(models)) == ["epoch_model_1.pth",
                                          "model_best.pth"]
    sd = torch.load(models / "model_best.pth", weights_only=True)
    Uformer(TC.ModelConfig(img_size=IMG, embed_dim=8)).load_state_dict(
        sd["state_dict"], strict=True)


def test_cli_data_axis_refusals(synth, tmp_path):
    """--data_axis N needs N processes started by torchrun; the JAX
    package's refusals: --exported with it, --rect_canvas with it in
    test_long, --device_data with it in training; the one-process CLIs
    (export, parity_gate; serve alike) refuse it."""
    from dehaze_tpu_torch.cli import (export, parity_gate, stream, test_long,
                                      train)
    from dehaze_tpu_torch.cli.common import add_common_args, config_from_args
    from dehaze_tpu_torch.train.loop import fit
    import argparse

    root, pth = synth
    base = ["--weights", pth] + TINY
    for cli, args in ((test_long, ["--input_dir", str(root / "DS")]),
                      (stream, ["--input_dir", str(root / "DS" / "hazy"),
                                "--result_dir", str(tmp_path / "s")])):
        with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
            cli.main(args + base + ["--data_axis", "2"])
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
        train.main(["--train_dir", str(root / "train"), "--val_dir",
                    str(root / "val"), "--data_axis", "2"] + TINY)
    with pytest.raises(SystemExit, match="drop --rect_canvas"):
        test_long.main(["--input_dir", str(root / "DS"), "--data_axis", "2",
                        "--rect_canvas"] + base)
    with pytest.raises(SystemExit, match="--exported serves single-device"):
        stream.main(["--input_dir", str(root / "DS" / "hazy"), "--exported",
                     "m.dhz", "--data_axis", "2"] + TINY)
    for cli, args in ((export, ["--weights", pth, "--out",
                                str(tmp_path / "m.dhz")]),
                      (parity_gate, ["--ref_ckpt", pth, "--input_dir",
                                     str(root / "DS"), "--expected_psnr",
                                     "20"])):
        with pytest.raises(SystemExit, match="runs in one process"):
            cli.main(args + TINY + ["--data_axis", "2"])
    p = add_common_args(argparse.ArgumentParser())
    cfg = config_from_args(p.parse_args(
        ["--data_axis", "2", "--device_data", "--train_dir",
         str(root / "train"), "--val_dir", str(root / "val")] + TINY))
    assert cfg.train.data_axis == 2
    with pytest.raises(NotImplementedError, match="--device_data with "
                                                  "--data_axis"):
        fit(cfg, device="cpu")
