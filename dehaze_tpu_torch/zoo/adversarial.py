"""Adversarial attacks (counterpart of `dehaze_tpu/zoo/adversarial.py`,
≙ the reference's `ops/adversarial.py`).

FGSM, PGD, Random and FreqAttack on NCHW image tensors, with the
reference's loss surface: CrossEntropyLoss applied to the LOG of the
n_ff-averaged softmax, i.e. `soft_ce(log p̂, one_hot)`
(`adversarial.py:32-38`), differentiated by autograd with respect to the
input only. MC dropout draws its masks from a `torch.Generator`.

The reference's quirks stay: PGD clamps to [0, 1] only at its random
start, not inside the iteration (`adversarial.py:74-96`), on inputs that
are already normalized; Random ignores the model.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from dehaze_tpu_torch.zoo.train import soft_ce


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return torch.Generator().manual_seed(0) if generator is None \
        else generator


def attack_loss(model, n_ff: int, xs: torch.Tensor, ys: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """soft_ce(log mean_n_ff softmax(model(xs)), one_hot(ys))."""
    gens = {"dropout": generator}
    p = torch.stack([torch.softmax(model(xs, generators=gens), dim=-1)
                     for _ in range(n_ff)]).mean(dim=0)
    t = F.one_hot(ys.long(), p.shape[-1]).float()
    return soft_ce(torch.log(p), t)


def input_grad(model, xs: torch.Tensor, ys: torch.Tensor, n_ff: int = 1,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """d attack_loss / d xs for the eval-mode model (the weights get no
    gradient)."""
    model.eval()
    with torch.enable_grad():
        x = xs.detach().requires_grad_(True)
        loss = attack_loss(model, n_ff, x, ys, _generator(generator))
        (g,) = torch.autograd.grad(loss, x)
    return g


def fgsm(model, xs: torch.Tensor, ys: torch.Tensor, *, eps: float = 0.007,
         n_ff: int = 1, generator: Optional[torch.Generator] = None):
    """`FGSM` (`adversarial.py:11-45`): xs + eps·sign(∇)."""
    g = input_grad(model, xs, ys, n_ff, generator)
    return xs + eps * torch.sign(g), ys


def pgd(model, xs: torch.Tensor, ys: torch.Tensor, *, eps: float = 0.3,
        alpha: float = 2 / 255, steps: int = 40, random_start: bool = True,
        n_ff: int = 1, generator: Optional[torch.Generator] = None):
    """`PGD` (`adversarial.py:48-96`). The random start, uniform in
    [-eps, eps] and then clamped to [0, 1], comes from the generator,
    which then seeds one generator per step (each step's own dropout
    stream, as the JAX package folds the step into its key)."""
    g = _generator(generator)
    xs_adv = xs
    if random_start:
        noise = torch.rand(xs.shape, generator=g, device=g.device)
        xs_adv = torch.clamp(xs + (noise.to(xs.device) * (2 * eps) - eps),
                             0.0, 1.0)
    seeds = torch.randint(0, 2 ** 62, (steps,), generator=g,
                          device=g.device).tolist()
    for seed in seeds:
        step_g = torch.Generator(g.device).manual_seed(seed)
        grad = input_grad(model, xs_adv, ys, n_ff, step_g)
        adv = xs_adv + alpha * torch.sign(grad)
        xs_adv = xs + torch.clamp(adv - xs, -eps, eps)
    return xs_adv, ys


def random_attack(xs: torch.Tensor, ys: torch.Tensor, *, eps: float = 0.007,
                  generator: Optional[torch.Generator] = None):
    """`Random` (`adversarial.py:99-119`): model-free sign noise, xs ± eps."""
    g = _generator(generator)
    noise = torch.randn(xs.shape, generator=g, device=g.device)
    return xs + eps * torch.sign(noise).to(xs.device), ys


def _center_mask(w1: int, w2: int, device) -> torch.Tensor:
    w1 = min(max(w1, 0), w2)
    m = torch.zeros(1, 1, w2, w2, device=device)
    pad = (w2 - w1) // 2
    m[:, :, pad:pad + w1, pad:pad + w1] = 1.0
    return m


def freq_mask(x: torch.Tensor, f: float, s: float = 0.2) -> torch.Tensor:
    """`FreqAttack._fourier_mask` (`adversarial.py:131-169`): band-pass an
    NCHW perturbation around radial frequency f: the spectrum rolled by
    half the size, a square ring between masks of side
    int(((f ± s)·h) / 2π)·2 (clamped to [0, h]) kept, rolled by half again,
    the real part of the inverse FFT. Square images only, as in the
    reference."""
    h, w = x.shape[-2:]
    z = torch.fft.fft2(x.float())
    z = torch.roll(z, (h // 2, w // 2), dims=(2, 3))
    mag, ang = z.abs(), z.angle()
    m1 = _center_mask(int(((f + s) * h) / (2 * math.pi)) * 2, h, x.device)
    m2 = _center_mask(int(((f - s) * h) / (2 * math.pi)) * 2, h, x.device)
    mag = (m1 - m2) * mag
    z = mag * torch.exp(1j * ang)
    z = torch.roll(z, (h // 2, w // 2), dims=(2, 3))
    return torch.fft.ifft2(z).real


def freq_attack(attack_fn: Callable, xs: torch.Tensor, ys: torch.Tensor, *,
                f: float, s: float = 0.2):
    """`FreqAttack` (`adversarial.py:122-129`): any attack, keeping only
    the band-passed part of its perturbation."""
    xs_adv, ys = attack_fn(xs, ys)
    return xs + freq_mask(xs_adv - xs, f, s), ys
