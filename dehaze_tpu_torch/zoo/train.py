"""The zoo's trainer (counterpart of `dehaze_tpu/zoo/train.py`, ≙ the
reference's `ops/trains.py` and `ops/schedulers.py`).

- `make_schedule`: step → lr, the torch scheduler timeline: a warmup of
  lr = base·i/N per iteration (the first step at lr 0), then the main
  scheduler indexed by the epochs completed since the warmup ended
  (`scheduler.step()` once an epoch).
- `get_optimizer`: a torch optimizer whose update is the JAX package's
  optax chain: `optax.clip_by_global_norm` first (`clip_by_global_norm_`:
  the gradients kept below max_norm, else g / ‖g‖ · max_norm, with no
  epsilon), then SGD, Adam or RMSprop with coupled L2 (the decay term
  joins the gradient) or AdamW with decoupled decay (scaled by the lr, on
  the old parameters). torch's SGD computes optax's SGD; Adam and AdamW
  are optax's (`Adam` here: its bias corrections 1 − b^t in float32,
  where torch's are float64 and differ by ~1e-5 relative) and so is
  RMSprop (`RMSprop` here: decay 0.9, eps inside the root; torch's takes
  alpha 0.99 and eps outside). The lr of each update is the schedule at
  the update count, written into the param groups before `step()`.
- `ZooTrainer`: per batch the pad-crop-flip and mixup/cutmix (or the
  smoothed one-hot), a train-mode forward, the soft-target CE in float32,
  the backward and the optimizer; the BatchNorm statistics move in the
  forward (`zoo.layers.bn`). The model is the caller's, as in the JAX
  package, so it can start from any weights.

Data-parallel (`data_parallel=True`, one process per GPU in a process
group; `cli.zoo train --data_axis N`): the step is the one-process step on
the global batch, as the JAX package's step on a sharded batch is. Every
rank draws the same augment and mixup numbers (a CPU generator seeded
`seed`), applies them to the whole global batch and keeps its contiguous
share of the rows; `zoo.layers.bn` normalizes with the global batch's
statistics (one all-reduce a layer, whose backward sums the gradient over
the ranks); DDP averages the gradients. The dropout and drop-path
generators are seeded per rank, so each rank's rows draw their own masks:
not the masks one process would draw for the same rows.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from dehaze_tpu_torch.ops.landscape import model_params, param_l1, param_l2
from dehaze_tpu_torch.parallel import dist
from dehaze_tpu_torch.utils.transfer import to_device
from dehaze_tpu_torch.zoo import data as zdata

SCHEDULES = ("StepLR", "MultiStepLR", "CosineAnnealingLR",
             "CosineAnnealingWarmRestarts")


# --------------------------------------------------------------------------
# schedules (torch semantics, epoch-indexed after per-iteration warmup)
# --------------------------------------------------------------------------

def make_schedule(base_lr: float, steps_per_epoch: int, warmup_epochs: int,
                  name: str = "CosineAnnealingLR", **kw
                  ) -> Callable[[int], float]:
    """step → lr (a Python float). Warmup: lr = base·i/warmup_steps per
    iteration (`ops/schedulers.py`); then the main scheduler of `name`
    indexed by completed epochs (`ops/trains.py:106`). An unknown name
    raises NotImplementedError."""
    if name not in SCHEDULES:
        raise NotImplementedError(name)
    warmup_steps = warmup_epochs * steps_per_epoch

    def cosine(t_cur, t_i, eta_min):
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1 + math.cos(math.pi * t_cur / t_i))

    def main(epoch: int) -> float:
        if name == "StepLR":
            step_size, gamma = kw.get("step_size", 30), kw.get("gamma", 0.1)
            return base_lr * gamma ** (epoch // step_size)
        if name == "MultiStepLR":
            passed = sum(epoch >= m for m in kw.get("milestones", []))
            return base_lr * kw.get("gamma", 0.1) ** passed
        eta_min = kw.get("eta_min", 0.0)
        if name == "CosineAnnealingLR":
            return cosine(epoch, kw.get("T_max", 200), eta_min)
        t0, t_mult = kw.get("T_0", 10), kw.get("T_mult", 1)
        if t_mult == 1:
            return cosine(epoch % t0, t0, eta_min)
        # the closed form of torch's CosineAnnealingWarmRestarts: cycle n
        # starts at epoch t0·(t_mult^n − 1)/(t_mult − 1)
        n = math.floor(math.log(epoch / t0 * (t_mult - 1) + 1) /
                       math.log(t_mult))
        start = t0 * (t_mult ** n - 1) / (t_mult - 1)
        return cosine(epoch - start, t0 * t_mult ** n, eta_min)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * step / warmup_steps
        return main((step - warmup_steps) // steps_per_epoch)

    return schedule


# --------------------------------------------------------------------------
# optimizers with the optax chains' updates
# --------------------------------------------------------------------------

class Adam(torch.optim.Optimizer):
    """`optax.adam` and `optax.adamw` (optax 0.2.6, `scale_by_adam` with
    eps_root 0): mu ← b1·mu + (1 − b1)·g, nu ← b2·nu + (1 − b2)·g², the
    update u = (mu / (1 − b1^t)) / (sqrt(nu / (1 − b2^t)) + eps), with
    optax's float32 bias corrections (b^t rounded to float32 first; at
    b2 0.999 that moves 1 − b2^t by ~1e-5 relative from torch's float64
    ones), p ← p − lr·u. Coupled (decoupled=False, Adam): weight_decay·p
    joins g first (`optax.add_decayed_weights` before adam). Decoupled
    (AdamW): it joins u, so p ← p − lr·(u + weight_decay·p)."""

    def __init__(self, params, lr: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: bool = False):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay,
                                      decoupled=decoupled, step=0))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2, wd = group["b1"], group["b2"], group["weight_decay"]
            grads = [p.grad for p in params]
            if wd and not group["decoupled"]:
                grads = torch._foreach_add(grads, params, alpha=wd)
            for p in params:
                if not self.state[p]:
                    self.state[p].update(mu=torch.zeros_like(p),
                                         nu=torch.zeros_like(p))
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1 - b2)
            group["step"] += 1
            one, t = np.float32(1), np.float32(group["step"])
            u = torch._foreach_div(mus, float(one - np.float32(b1) ** t))
            den = torch._foreach_div(nus, float(one - np.float32(b2) ** t))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            torch._foreach_div_(u, den)
            if wd and group["decoupled"]:
                torch._foreach_add_(u, params, alpha=wd)
            torch._foreach_add_(params, u, alpha=-group["lr"])


class RMSprop(torch.optim.Optimizer):
    """`optax.rmsprop` (optax 0.2.6, `scale_by_rms` with eps_in_sqrt):
    nu ← decay·nu + (1 − decay)·g², p ← p − lr·g·rsqrt(nu + eps), nu from
    0; weight_decay·p joins g first (`optax.add_decayed_weights` before
    it). torch's RMSprop takes alpha 0.99 and g / (sqrt(nu) + eps)."""

    def __init__(self, params, lr: float = 0.0, decay: float = 0.9,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params,
                                           alpha=group["weight_decay"])
            nus = []
            for p in params:
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nus.append(state["nu"])
            torch._foreach_mul_(nus, group["decay"])
            torch._foreach_addcmul_(nus, grads, grads,
                                    value=1 - group["decay"])
            scale = torch._foreach_add(nus, group["eps"])
            torch._foreach_rsqrt_(scale)
            torch._foreach_mul_(scale, grads)
            torch._foreach_add_(params, scale, alpha=-group["lr"])


def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float) -> None:
    """`optax.clip_by_global_norm` in place: ‖g‖ = sqrt(Σ g²) over every
    gradient; each kept when ‖g‖ < max_norm, else (g / ‖g‖)·max_norm, with
    no epsilon (torch's clip_grad_norm_ divides by ‖g‖ + 1e-6). Computed
    on the gradients' device: the host does not wait for it."""
    grads = list(grads)
    if not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, max_norm * one))


def get_optimizer(params, name: str, schedule: Callable[[int], float],
                  weight_decay: float = 0.0, max_norm: Optional[float] = None,
                  **kw) -> torch.optim.Optimizer:
    """≙ `ops/trains.get_optimizer` (`trains.py:24-49`) as the JAX package
    chains it in optax. name: SGD (kw momentum, nesterov; plain without a
    momentum, as `optax.sgd(momentum=None)` ignores nesterov), Adam, AdamW
    (β 0.9/0.999, eps 1e-8, optax's defaults) or RMSprop; anything else
    raises NotImplementedError. Before each `step()` the gradients are
    clipped to `max_norm` (when given) and the param groups take the lr
    `schedule(update_count)`; `update_count` counts the steps taken."""
    params = list(params)
    lname = name.lower()
    if lname == "sgd":
        momentum = kw.get("momentum", 0.0) or 0.0
        opt = torch.optim.SGD(params, lr=0.0, momentum=momentum,
                              nesterov=bool(momentum and
                                            kw.get("nesterov", False)),
                              weight_decay=weight_decay)
    elif lname in ("adam", "adamw"):
        opt = Adam(params, weight_decay=weight_decay,
                   decoupled=lname == "adamw")
    elif lname == "rmsprop":
        opt = RMSprop(params, weight_decay=weight_decay)
    else:
        raise NotImplementedError(name)
    opt.update_count = 0

    def before_step(opt, args, kwargs):
        if max_norm is not None:
            clip_by_global_norm_([p.grad for g in opt.param_groups
                                  for p in g["params"] if p.grad is not None],
                                 max_norm)
        lr = schedule(opt.update_count)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.update_count += 1

    opt.register_step_pre_hook(before_step)
    return opt


def soft_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Soft-target CE == timm SoftTargetCrossEntropy: float32 log_softmax,
    the sum over classes, the mean over the batch; with one-hot (smoothed)
    targets it is (LabelSmoothing)CrossEntropyLoss (`trains.py:137-143`)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.sum(targets * logp, dim=-1))


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------

class ZooTrainer:
    """≙ `ops/trains.train`/`train_epoch`: warmup epochs (per-iteration lr
    ramp), then the main epochs; per epoch (loss, nll, l1, l2); optional
    mixup/cutmix and label smoothing; `data_parallel` trains under DDP in
    the process group with global-batch BatchNorm (see the module
    docstring). The model (built by the caller, on its device) trains in
    place; `variables` is its state_dict."""

    def __init__(self, model: torch.nn.Module, *, num_classes: int,
                 optimizer_name: str = "SGD", lr: float = 0.1,
                 weight_decay: float = 0.0,
                 scheduler: Optional[Dict[str, Any]] = None,
                 warmup_epochs: int = 0, steps_per_epoch: int = 1,
                 smoothing: float = 0.0, mixup: Optional[Dict] = None,
                 max_norm: Optional[float] = None, augment: bool = True,
                 data_parallel: bool = False, seed: int = 0):
        self.model = model
        self.num_classes = num_classes
        self.smoothing = smoothing
        self.mixup = mixup
        self.augment = augment
        self.data_parallel = data_parallel
        self.seed = seed
        sch = dict(scheduler or {"name": "CosineAnnealingLR", "T_max": 200})
        self.schedule = make_schedule(lr, steps_per_epoch, warmup_epochs,
                                      sch.pop("name"), **sch)
        self.optimizer_name = optimizer_name
        self.weight_decay = weight_decay
        self.max_norm = max_norm
        self.device = next(model.parameters()).device
        # the augment and mixup draws: on the CPU, the same on every rank
        # and device (`mixup_draw` reads its numbers on the host)
        self.data_gen = torch.Generator().manual_seed(seed)
        self.generators = None
        self.optimizer = None
        self.ddp = None
        self.global_step = 0

    def init(self, sample_x=None):
        """The optimizer, the dropout and drop-path generators (on the
        model's device, seeded from `seed` and this rank) and, with
        `data_parallel`, the DDP wrapper, which broadcasts rank 0's
        weights. sample_x: the JAX signature's; the model is built."""
        r = dist.rank() if self.data_parallel else 0
        self.generators = {
            "dropout": torch.Generator(self.device).manual_seed(
                self.seed + 1 + 2 * r),
            "droppath": torch.Generator(self.device).manual_seed(
                self.seed + 2 + 2 * r)}
        if self.data_parallel:
            if not dist.is_on():
                raise RuntimeError("data_parallel=True needs the process "
                                   "group (parallel.dist.init)")
            # the global statistics keep the BN buffers equal on every rank
            self.ddp = torch.nn.parallel.DistributedDataParallel(
                self.model, broadcast_buffers=False, device_ids=(
                    [self.device] if self.device.type == "cuda" else None))
        self.optimizer = get_optimizer(
            self.model.parameters(), self.optimizer_name, self.schedule,
            self.weight_decay, self.max_norm)

    @property
    def variables(self) -> Dict[str, torch.Tensor]:
        return self.model.state_dict()

    def draw(self, batch: int, h: int, w: int):
        """The batch's random numbers from the CPU generator: augment's
        offsets and flips (None without augment), then mixup's (None
        without mixup)."""
        aug = (zdata.augment_draw(self.data_gen, batch) if self.augment
               else None)
        mix = (zdata.mixup_draw(self.data_gen, h, w, **self.mixup)
               if self.mixup is not None else None)
        return aug, mix

    def prep(self, x, y, draws):
        """`_prep` (`dehaze_tpu/zoo/train.py:203-216`) given `draw`'s
        numbers, on the model's device: the pad-crop-flip, then
        mixup/cutmix with the smoothing, or the smoothed one-hot. x NHWC
        (numpy or tensor) → (x NCHW, soft targets)."""
        aug, mix = draws
        x = to_device(torch.as_tensor(x), self.device)
        y = to_device(torch.as_tensor(y), self.device)
        if aug is not None:
            x = zdata.augment_apply(x, *(to_device(a, self.device)
                                         for a in aug))
        if mix is not None:
            x, t = zdata.mixup_apply(x, y, self.num_classes, mix,
                                     self.smoothing)
        else:
            t = zdata.one_hot_smooth(y, self.num_classes, self.smoothing)
        return x.permute(0, 3, 1, 2), t

    def _rows(self, batch: int) -> slice:
        """This rank's contiguous share of a global batch."""
        if not self.data_parallel:
            return slice(None)
        p = dist.world()
        if batch % p:
            raise ValueError(f"a global batch of {batch} rows does not "
                             f"split over {p} ranks")
        share = batch // p
        return slice(dist.rank() * share, (dist.rank() + 1) * share)

    def train_step(self, x, y) -> torch.Tensor:
        """One update on the global batch (x NHWC, y labels; this rank's
        rows of it when data-parallel). Returns this rank's loss, on the
        device."""
        if self.optimizer is None:
            raise RuntimeError("ZooTrainer.init first")
        self.model.train()
        xs, t = self.prep(x, y, self.draw(*x.shape[:3]))
        rows = self._rows(xs.shape[0])
        logits = (self.ddp or self.model)(xs[rows],
                                          generators=self.generators)
        loss = soft_ce(logits, t[rows])
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.global_step += 1
        return loss.detach()

    def train_epoch(self, batch_iter: Iterable):
        """Returns (loss_avg, nll_avg, l1, l2) like `trains.train_epoch`:
        the mean of the steps' global losses (summed on the device, read
        once), and Σ|p| and Σ‖p‖ over the parameters (not the BN buffers)
        after the epoch."""
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        steps = 0
        for x, y in batch_iter:
            total += self.train_step(x, y).double()
            steps += 1
        if self.data_parallel:
            total = dist.mean_over_ranks(total)
        loss = float(total) / max(steps, 1)
        params = model_params(self.model)
        return loss, loss, param_l1(params), param_l2(params)

    def lr(self) -> float:
        return float(np.float32(self.schedule(self.global_step)))
