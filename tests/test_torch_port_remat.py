"""`--remat` (each LeWin block recomputed in the backward pass) on the CPU.

Against the port's plain model: forward, every gradient and every
generator's state after the step bit for bit, with drop_path 0.1 and
unpinned ProbSparse sampling (so the recompute must replay the block's
sample tables and DropPath masks), in a train step with one and with two
microbatches, and for the model alone with a padding mask; K1's forward
runs twice per block, its backward once. Against the JAX model with
`remat=True`: one train step with sampling pinned and drop_path 0, every
gradient within 2e-4 (test_torch_port_train's bar), at the depths
`JAX_DEPTHS` (one block a stage, two in the first and last: remat wraps
every block alike, and the JAX remat step compiles in about 60% of the
full depth's time; the plain step is held to JAX at full depth in
test_torch_port_train, and the remat step to the plain one here). Embed
8, 32² images.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dehaze_tpu import config as JC
from dehaze_tpu.ops import probsparse as PS
from dehaze_tpu.train.trainer import Trainer as JaxTrainer
from dehaze_tpu_torch import config as TC
from dehaze_tpu_torch.infer.anyres import expand2square
from dehaze_tpu_torch.ops import probsparse as TPS
from dehaze_tpu_torch.ops.kernels import window_attention as wa
from dehaze_tpu_torch.train.trainer import Trainer, build_model
from dehaze_tpu_torch.utils.convert import state_dict_from_jax_params

TOL = 2e-4
IMG = 32
JAX_DEPTHS = (2, 1, 1, 1, 1, 1, 1, 1, 2)
GENS = ("sample_gen", "droppath_gen", "dropout_gen", "mixup_gen")


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


@pytest.fixture
def k1_calls(monkeypatch):
    """Counts of K1's forward and backward (their CPU twins) per call."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = wa._VERSIONS[4]

    def counted(key, fn):
        def run(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setitem(wa._VERSIONS, 4, (counted("fwd", fwd),
                                          counted("bwd", bwd)))
    return calls


def _cfg(remat, **model):
    return TC.Config(model=TC.ModelConfig(img_size=IMG, embed_dim=8,
                                          dtype=torch.float32, remat=remat,
                                          **model),
                     loss=TC.LossConfig(w_contrast=0.0),
                     train=TC.TrainConfig(warmup=False))


def _batch(seed=0, b=4):
    rng = np.random.default_rng(seed)
    clean = rng.integers(0, 256, size=(b, IMG, IMG, 3), dtype=np.uint8)
    hazy = np.clip(clean * 0.6 + 80, 0, 255).astype(np.uint8)
    return clean, hazy


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_remat_train_step_equals_plain(accum_steps, k1_calls):
    """A train step with MixUp, drop_path 0.1 and unpinned sampling: loss,
    gradients, parameters after AdamW and generator states bit for bit;
    K1's forward runs 36 times per microbatch with remat, 18 without, its
    backward 18 times in both."""
    clean, hazy = _batch(1)
    runs = []
    for remat in (False, True):
        k1_calls.update(fwd=0, bwd=0)
        tr = Trainer(_cfg(remat), steps_per_epoch=1, device="cpu")
        m = tr.train_step(clean, hazy, use_mixup=True,
                          accum_steps=accum_steps)
        runs.append((m, tr, dict(k1_calls)))
    (m0, t0, c0), (m1, t1, c1) = runs
    assert c0 == {"fwd": 18 * accum_steps, "bwd": 18 * accum_steps}
    assert c1 == {"fwd": 36 * accum_steps, "bwd": 18 * accum_steps}
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    p1 = dict(t1.model.named_parameters())
    for name, p in t0.model.named_parameters():
        assert p.grad is not None and torch.equal(p.grad, p1[name].grad), \
            name
        assert torch.equal(p, p1[name]), name
    for g in GENS:
        assert torch.equal(getattr(t0, g).get_state(),
                           getattr(t1, g).get_state()), g


def test_remat_model_with_padding_mask_equals_plain(k1_calls):
    """The model alone in train mode on a 24×20 image centred on its 32²
    canvas with the padding mask: output, input gradient, every parameter
    gradient and both generators' states bit for bit; eval runs no
    recompute."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(size=(2, 24, 20, 3)).astype(
        np.float32))
    canvas, pad, _ = expand2square(x, IMG)
    assert canvas.shape[1:3] == (IMG, IMG) and pad.any()
    cot = torch.from_numpy(rng.normal(size=canvas.shape).astype(np.float32))
    runs = []
    for remat in (False, True):
        model = build_model(_cfg(remat), "cpu").train()
        gens = (torch.Generator().manual_seed(5),
                torch.Generator().manual_seed(6))
        xin = canvas.clone().requires_grad_(True)
        k1_calls.update(fwd=0, bwd=0)
        y = model(xin, generator=gens[0], droppath=gens[1], pad_mask=pad)
        (y * cot).sum().backward()
        runs.append((y.detach(), xin.grad, dict(model.named_parameters()),
                     [g.get_state() for g in gens], dict(k1_calls)))
        with torch.no_grad():
            k1_calls.update(fwd=0)
            model.eval()(canvas, generator=torch.Generator().manual_seed(0),
                         pad_mask=pad)
            assert k1_calls["fwd"] == 18
    (y0, gx0, p0, s0, c0), (y1, gx1, p1, s1, c1) = runs
    assert (c0["fwd"], c1["fwd"], c0["bwd"], c1["bwd"]) == (18, 36, 18, 18)
    assert torch.equal(y0, y1) and torch.equal(gx0, gx1)
    for name, p in p0.items():
        assert torch.equal(p.grad, p1[name].grad), name
    for a, b in zip(s0, s1):
        assert torch.equal(a, b)


def test_remat_train_step_matches_jax_remat(pinned):
    """One train step of the port with remat against the JAX trainer with
    `ModelConfig.remat=True`: drop_path 0, no MixUp, Charbonnier only.
    Loss within 1e-5 relative, every gradient leaf within 2e-4."""
    from dehaze_tpu.train.trainer import TrainState
    from dehaze_tpu.utils.convert_torch import convert_uformer_state_dict

    clean, hazy = _batch(2, b=2)
    jcfg = JC.Config(model=JC.ModelConfig(img_size=IMG, embed_dim=8,
                                          dtype=jnp.float32,
                                          depths=JAX_DEPTHS,
                                          drop_path_rate=0.0, remat=True),
                     loss=JC.LossConfig(w_contrast=0.0),
                     train=JC.TrainConfig(warmup=False))
    jt = JaxTrainer(jcfg, steps_per_epoch=1)
    tr = Trainer(_cfg(True, drop_path_rate=0.0, depths=JAX_DEPTHS),
                 steps_per_epoch=1, device="cpu")
    params = jax.tree.map(jnp.asarray, convert_uformer_state_dict(
        tr.model.state_dict(), depths=JAX_DEPTHS))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=jt.tx.init(params))
    new_state, jm = jt.train_step(state, clean, hazy, jax.random.PRNGKey(1),
                                  use_mixup=False)
    jgrads = state_dict_from_jax_params(jax.tree.map(
        lambda m: np.asarray(m) / np.float32(1 - 0.9),
        new_state.opt_state[0].mu))
    m = tr.train_step(clean, hazy, use_mixup=False)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    named = dict(tr.model.named_parameters())
    assert set(named) == set(jgrads)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)
