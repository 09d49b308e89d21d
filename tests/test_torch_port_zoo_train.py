"""The zoo's trainer on the port (`dehaze_tpu_torch/zoo/train.py`) against
the JAX package's (`dehaze_tpu/zoo/train.py`), on the CPU.

- `make_schedule`: the four schedules (WarmRestarts with T_mult 1 and 2),
  with and without warmup, at every step: within 1e-7 in the warmup and
  1e-6 after (JAX computes in float32, the port in Python floats).
- `get_optimizer` against the optax chain over 5 steps on three tensors:
  SGD (plain, momentum 0.9, nesterov), Adam, AdamW and RMSprop, weight
  decay 0 and 5e-4, with and without a max_norm that clips; RMSprop also
  with gradients near 1e-4, where the eps inside the root shows. The
  parameters after every step within rtol 1e-6, atol 1e-7 (f32).
- `ZooTrainer.train_epoch` against JAX's on `ResNetZoo(num_blocks=(1, 1,
  1, 1))` at 32², batch 16, 64 synthetic rows, 2 epochs, augment off,
  from JAX's init: SGD with weight decay, clipping and a warmup epoch,
  then Adam with smoothing 0.1 at lr 1e-5 (see `RECIPES`). The epoch
  losses, l1, l2, the parameters and the BatchNorm running statistics
  within 2e-4 (f32; l1 and l2 relative).
- `ZooTrainer.prep` with augment and mixup on, given the numbers JAX's
  `_prep` draws from its key: JAX's images and targets (exact but for one
  f32 rounding at the largest magnitude, where XLA may fuse λ·a + (1 − λ)·b).
- A bf16 SGD step of that ResNet against JAX's bf16 step (bf16
  activations over float32 parameters on both sides): the loss within
  1e-3, the running statistics within 1e-2 of each tensor's largest
  entry, and the update (every parameter's change, as one vector) within
  25% of its norm. The two round activations and their gradients to bf16
  at different points (XLA keeps float32 inside a fusion), so single
  gradient entries can differ by a large share of the largest.
- The generators of an MC-dropout ResNet: the same seed gives the same
  step, another seed another.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dehaze_tpu.zoo import data as JD
from dehaze_tpu.zoo import train as JT
from dehaze_tpu.zoo.convnets import ResNetZoo as JaxResNet
from dehaze_tpu_torch.utils.convert import zoo_state_dict_from_jax_variables
from dehaze_tpu_torch.zoo import train as TT
from dehaze_tpu_torch.zoo.convnets import ResNetZoo

SMALL = (1, 1, 1, 1)
BATCH, ROWS, EPOCHS = 16, 64, 2
TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: with several test workers on the host,
    torch's thread pools stall each other in hand-offs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------- schedules

SCHEDULES = [
    ("StepLR", {"step_size": 3, "gamma": 0.5}),
    ("MultiStepLR", {"milestones": [2, 5], "gamma": 0.1}),
    ("CosineAnnealingLR", {"T_max": 10, "eta_min": 1e-4}),
    ("CosineAnnealingWarmRestarts", {"T_0": 4, "T_mult": 1,
                                     "eta_min": 1e-3}),
    ("CosineAnnealingWarmRestarts", {"T_0": 4, "T_mult": 2}),
]


@pytest.mark.parametrize("warmup", [0, 2])
@pytest.mark.parametrize("name,kw", SCHEDULES)
def test_schedule_equals_jax_at_every_step(name, kw, warmup):
    base, spe = 0.1, 5
    steps = np.arange((warmup + 40) * spe)
    want = np.asarray(jax.jit(jax.vmap(JT.make_schedule(
        base, spe, warmup, name, **kw)))(jnp.asarray(steps)))
    sched = TT.make_schedule(base, spe, warmup, name, **kw)
    got = np.array([sched(int(s)) for s in steps])
    split = warmup * spe
    np.testing.assert_allclose(got[:split], want[:split], rtol=0, atol=1e-7)
    np.testing.assert_allclose(got[split:], want[split:], rtol=0, atol=1e-6)
    assert got[0] == (0.0 if warmup else base)


def test_schedule_refuses_an_unknown_name():
    with pytest.raises(NotImplementedError, match="OneCycleLR"):
        TT.make_schedule(0.1, 5, 0, "OneCycleLR")
    with pytest.raises(NotImplementedError, match="LBFGS"):
        TT.get_optimizer([torch.nn.Parameter(torch.zeros(1))], "LBFGS",
                         lambda s: 0.1)


# ------------------------------------------------------------ optimizers

OPTIMIZERS = [
    ("SGD", {}), ("SGD", {"momentum": 0.9}),
    ("SGD", {"momentum": 0.9, "nesterov": True}),
    ("Adam", {}), ("AdamW", {}), ("RMSprop", {}),
]
SHAPES = [(4, 3), (3,), (2, 2, 3)]


def _optimizer_cases():
    for name, kw in OPTIMIZERS:
        for wd in (0.0, 5e-4):
            for max_norm in (None, 0.5):
                yield pytest.param(name, kw, wd, max_norm, 1.0,
                                   id=f"{name}{kw or ''}-wd{wd}-clip"
                                      f"{max_norm}")
    for wd in (0.0, 5e-4):
        yield pytest.param("RMSprop", {}, wd, None, 1e-4,
                           id=f"RMSprop-wd{wd}-grads1e-4")


@pytest.mark.parametrize("name,kw,wd,max_norm,grad_scale",
                         list(_optimizer_cases()))
def test_optimizer_equals_optax_chain(name, kw, wd, max_norm, grad_scale):
    rng = np.random.default_rng(7)
    init = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[(grad_scale * rng.standard_normal(s)).astype(np.float32)
              for s in SHAPES] for _ in range(5)]
    if max_norm is not None:  # every step clips, none is near the edge
        assert min(np.sqrt(sum(np.square(g).sum() for g in gs))
                   for gs in grads) > 4 * max_norm
    sched_args = (0.1, 2, 1, "CosineAnnealingLR")
    chain = JT.get_optimizer(name, JT.make_schedule(*sched_args, T_max=3),
                             wd, max_norm, **kw)
    jparams = [jnp.asarray(a) for a in init]
    state = chain.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt = TT.get_optimizer(tparams, name, TT.make_schedule(*sched_args,
                                                           T_max=3),
                           wd, max_norm, **kw)
    for step, gs in enumerate(grads):
        updates, state = chain.update([jnp.asarray(g) for g in gs], state,
                                      jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tparams, gs):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        for p, w in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step}")
    assert opt.update_count == 5
    if grad_scale < 1:  # eps outside the root would move these far off
        moved = np.abs(tparams[0].detach().numpy() - init[0]).max()
        assert moved > 0.05


def test_clip_keeps_gradients_below_max_norm():
    g = [torch.tensor([3.0, 4.0])]
    TT.clip_by_global_norm_(g, 5.5)
    assert torch.equal(g[0], torch.tensor([3.0, 4.0]))
    TT.clip_by_global_norm_(g, 1.0)
    torch.testing.assert_close(g[0], torch.tensor([0.6, 0.8]), rtol=0,
                               atol=1e-7)


# --------------------------------------------------------------- trainer

class _JitInit:
    """A flax module whose `init` runs as one jitted program (called
    eagerly, as the JAX trainer calls it, each primitive of the init
    compiles on its own: ~11 s for this ResNet); every other attribute is
    the module's."""

    def __init__(self, module):
        self.module = module
        self._init = jax.jit(lambda rngs, x: module.init(rngs, x,
                                                         train=False))

    def __getattr__(self, name):
        return getattr(self.module, name)

    def init(self, rngs, x, train=False):
        assert not train
        return self._init(rngs, x)


@pytest.fixture(scope="module")
def jax_resnet():
    return _JitInit(JaxResNet(num_blocks=SMALL))


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((ROWS, 32, 32, 3), dtype=np.float32)
    y = rng.integers(0, 10, ROWS).astype(np.int32)
    return x, y


def _port_model(jax_variables, **kw):
    model = ResNetZoo(num_blocks=SMALL, **kw)
    model.load_state_dict(zoo_state_dict_from_jax_variables(jax_variables,
                                                            model))
    return model


def _held(got_sd, jax_variables, model):
    """The port's state_dict against JAX's variables (parameters and
    running statistics) within TOL."""
    want = zoo_state_dict_from_jax_variables(jax_variables, model)
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(),
                                       rtol=TOL, atol=TOL, err_msg=k)


RECIPES = {
    "sgd_wd_clip_warmup": dict(optimizer_name="SGD", lr=0.05,
                               weight_decay=5e-4, max_norm=1.0,
                               warmup_epochs=1),
    # Adam's first update is ±lr on every entry whatever the size of its
    # gradient, so where a gradient is rounding noise (XLA and oneDNN sum
    # in other orders) the two packages can step apart by 2·lr: at lr 1e-5
    # that is at most 1.6e-4 over the 8 steps
    "adam_smoothing": dict(optimizer_name="Adam", lr=1e-5, smoothing=0.1),
}


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_train_epoch_equals_jax(recipe, jax_resnet):
    x, y = _data()
    kw = dict(num_classes=10, scheduler={"name": "CosineAnnealingLR",
                                         "T_max": 3},
              steps_per_epoch=ROWS // BATCH, augment=False, seed=0,
              **RECIPES[recipe])
    jt = JT.ZooTrainer(jax_resnet, **kw)
    jt.init(x[:BATCH])
    model = _port_model(jt.variables)
    tt = TT.ZooTrainer(model, **kw)
    tt.init(x[:BATCH])
    for epoch in range(EPOCHS):
        want = jt.train_epoch(JD.batches(x, y, BATCH, shuffle=True,
                                         seed=epoch))
        got = tt.train_epoch(JD.batches(x, y, BATCH, shuffle=True,
                                        seed=epoch))
        np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=TOL)
        np.testing.assert_allclose(got[2:], want[2:], rtol=TOL)
        assert tt.global_step == jt.global_step
        np.testing.assert_allclose(tt.lr(), jt.lr(), rtol=1e-6)
    _held(tt.variables, jt.variables, model)


def _jax_draws(rng, b, h, w, mixup):
    """The numbers JAX's `_prep` draws from its step key: augment's from
    the first split, mixup's from the second (`zoo/data.py` key use)."""
    k1, rng = jax.random.split(rng)
    kc, kf = jax.random.split(k1)
    offs = jax.random.randint(kc, (b, 2), 0, 9)
    flip = jax.random.bernoulli(kf, 0.5, (b, 1, 1, 1))
    k2, _ = jax.random.split(rng)
    q1, q2, q3, q4 = jax.random.split(k2, 4)
    cutmix = bool(jax.random.bernoulli(q2, 0.5))
    alpha = mixup["cutmix_alpha"] if cutmix else mixup["mixup_alpha"]
    mix = {"use": bool(jax.random.bernoulli(q1, mixup["prob"])),
           "use_cutmix": cutmix,
           "lam0": float(jax.random.beta(q3, alpha, alpha)),
           "cy": int(jax.random.randint(q4, (), 0, h)),
           "cx": int(jax.random.randint(q4, (), 0, w))}
    aug = (torch.from_numpy(np.asarray(offs).copy()),
           torch.from_numpy(np.asarray(flip).reshape(b).copy()))
    return aug, mix


def test_prep_equals_jax_given_its_draws(jax_resnet):
    x, y = _data(seed=3)
    x, y = x[:8], y[:8]
    mixup = {"mixup_alpha": 1.0, "cutmix_alpha": 0.8, "prob": 0.8}
    kw = dict(num_classes=10, smoothing=0.1, mixup=mixup, augment=True)
    jt = JT.ZooTrainer(jax_resnet, **kw)
    tt = TT.ZooTrainer(torch.nn.Linear(1, 1), **kw)
    jax_prep = jax.jit(jt._prep)
    seen = set()
    for seed in range(40):
        rng = jax.random.PRNGKey(seed)
        draws = _jax_draws(rng, 8, 32, 32, mixup)
        wx, wt = (np.asarray(a) for a in jax_prep(x, y, rng))
        gx, gt = tt.prep(x, y, draws)
        for g, w in ((gx.permute(0, 2, 3, 1), wx), (gt, wt)):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=np.spacing(
                np.float32(np.abs(w).max())))
        seen.add((draws[1]["use"], draws[1]["use"] and
                  draws[1]["use_cutmix"]))
        if len(seen) == 3:
            break
    assert seen == {(True, True), (True, False), (False, False)}
    # the port's own draws: one CPU generator, the same numbers each time
    a = TT.ZooTrainer(torch.nn.Linear(1, 1), **kw).draw(8, 32, 32)
    b = TT.ZooTrainer(torch.nn.Linear(1, 1), **kw).draw(8, 32, 32)
    assert torch.equal(a[0][0], b[0][0]) and a[1] == b[1]


def test_bf16_step_against_jax():
    x, y = _data(seed=5)
    kw = dict(num_classes=10, optimizer_name="SGD", lr=0.05,
              scheduler={"name": "CosineAnnealingLR", "T_max": 3},
              augment=False, seed=0)
    jt = JT.ZooTrainer(_JitInit(JaxResNet(num_blocks=SMALL,
                                          dtype=jnp.bfloat16)), **kw)
    jt.init(x[:BATCH])
    model = _port_model(jt.variables, dtype=torch.bfloat16)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tt = TT.ZooTrainer(model, **kw)
    tt.init()
    want = jt.train_epoch([(x[:BATCH], y[:BATCH])])
    got = tt.train_epoch([(x[:BATCH], y[:BATCH])])
    assert abs(got[0] - want[0]) < 1e-3
    jsd = zoo_state_dict_from_jax_variables(jt.variables, model)
    step, jax_step = [], []
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        assert v.dtype == torch.float32, k  # the parameters stay float32
        if "running" in k:
            np.testing.assert_allclose(
                v.numpy(), jsd[k].numpy(), rtol=0,
                atol=1e-2 * float(jsd[k].abs().max()), err_msg=k)
        else:
            step.append((v - before[k]).numpy().ravel())
            jax_step.append((jsd[k] - before[k]).numpy().ravel())
    step, jax_step = np.concatenate(step), np.concatenate(jax_step)
    assert np.linalg.norm(step - jax_step) < 0.25 * np.linalg.norm(jax_step)


def test_mc_dropout_generators_are_seeded():
    x, y = _data(seed=9)
    torch.manual_seed(0)
    init = ResNetZoo(num_blocks=SMALL, mc_rate=0.3).state_dict()

    def one_step(seed):
        model = ResNetZoo(num_blocks=SMALL, mc_rate=0.3)
        model.load_state_dict(init)
        tt = TT.ZooTrainer(model, num_classes=10, lr=0.05, augment=False,
                           seed=seed)
        tt.init()
        loss = tt.train_step(x[:BATCH], y[:BATCH])
        return float(loss), model.state_dict()

    (l0, a), (l0b, b), (l1, c) = one_step(0), one_step(0), one_step(1)
    assert l0 == l0b and all(torch.equal(a[k], b[k]) for k in a)
    assert l0 != l1 and not all(torch.equal(a[k], c[k]) for k in a)
