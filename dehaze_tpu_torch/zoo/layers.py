"""Shared layers of the classification zoo (counterpart of
`dehaze_tpu/zoo/layers.py`).

Feature maps are NCHW and token sequences [B, N, C], as in the
reference's torch models, whose state_dict names the port's modules carry
(`layer1.0.conv1.0.weight`, `classifier.0.dense.weight`, ...), so a
reference `.pth.tar` loads with `load_state_dict` as it is; the JAX
package's names are these with "." → "_". Parameters are float32 and are
cast to the activation dtype at use; LayerNorm, BatchNorm, softmax and the
gates' sigmoid compute in float32 and round to it, as the JAX modules do.

Random draws come from explicit `torch.Generator`s that a model's forward
takes under the JAX package's rng stream names: `generators={"dropout":
g, "droppath": g2}`. MC dropout (the `_mcdo` models) stays active in eval
mode, as the reference's `F.dropout` default does, so those models need a
"dropout" generator even there; train-mode dropout and stochastic depth
need theirs only when their rate is above 0.

A forward given `taps=[]` appends the latents the JAX modules `sow` as
`intermediates/tap{i}`, in the order of i.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dehaze_tpu_torch.models import layers as ml
from dehaze_tpu_torch.parallel import dist

Generators = Optional[Dict[str, torch.Generator]]


def _cast(t: Optional[torch.Tensor], like: torch.Tensor):
    return None if t is None else t.to(like.dtype)


def slots(modules: Dict[int, nn.Module]) -> nn.ModuleDict:
    """Modules at the reference's `nn.Sequential` indices (the layers
    between them, activations and rearranges, hold no weights)."""
    return nn.ModuleDict({str(i): m for i, m in modules.items()})


# ------------------------------------------------------------ primitives

def conv(x: torch.Tensor, m: nn.Conv2d) -> torch.Tensor:
    """`m` applied in x's dtype (`zoo/layers.py:conv`: explicit zero
    padding, bias=False unless the layer has one)."""
    return F.conv2d(x, _cast(m.weight, x), _cast(m.bias, x), m.stride,
                    m.padding, m.dilation, m.groups)


def linear(x: torch.Tensor, m: nn.Linear) -> torch.Tensor:
    return F.linear(x, _cast(m.weight, x), _cast(m.bias, x))


def layer_norm(x: torch.Tensor, m: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm (eps 1e-5) over the last axis, in float32, rounded to x's
    dtype (CUDA's layer_norm takes no bf16 x with float32 parameters)."""
    return F.layer_norm(x.float(), m.normalized_shape, m.weight, m.bias,
                        m.eps).to(x.dtype)


def conv2d(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
           groups: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                     groups=groups, bias=bias)


def bn2d(c: int) -> nn.BatchNorm2d:
    """`zoo/layers.py:bn`: eps 1e-5, torch momentum 0.1 (flax's 0.9)."""
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def _global_var_mean(xf: torch.Tensor):
    """The biased variance and the mean over N, H, W of every rank's rows:
    one all-reduce of Σx, Σx² and the count (`dist.sum_over_ranks`, whose
    backward sums the gradient over the ranks), then flax's
    max(E[x²] − E[x]², 0)."""
    c = xf.shape[1]
    count = xf.new_full((1,), xf.numel() // c)
    sums = dist.sum_over_ranks(torch.cat([xf.sum(dim=(0, 2, 3)),
                                          xf.square().sum(dim=(0, 2, 3)),
                                          count]))
    mean = sums[:c] / sums[-1]
    var = torch.clamp_min(sums[c:2 * c] / sums[-1] - mean.square(), 0.0)
    return var, mean


def bn(x: torch.Tensor, m: nn.BatchNorm2d) -> torch.Tensor:
    """BatchNorm over N, H, W, computed in float32 (float64 for a float64
    x, as flax promotes) and rounded to x's dtype. In eval mode it is
    torch's (mixed-type with a bf16 x). In training it normalizes by the
    batch's mean and biased variance and moves the running stats by
    `m.momentum` towards them; the running variance takes the biased
    variance too, as flax's BatchNorm does (torch's takes the unbiased
    one). In a process group of more than one rank (data-parallel
    training) the batch is the global one: the statistics of every
    rank's rows (`_global_var_mean`), as the JAX package's BatchNorm sees
    its whole sharded batch."""
    if not m.training:
        return F.batch_norm(x, m.running_mean, m.running_var, m.weight,
                            m.bias, False, 0.0, m.eps)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if dist.world() > 1:
        var, mean = _global_var_mean(xf)
    else:
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
    with torch.no_grad():
        m.running_mean.lerp_(mean, m.momentum)
        m.running_var.lerp_(var, m.momentum)
        m.num_batches_tracked.add_(1)
    scale = m.weight * torch.rsqrt(var + m.eps)
    y = (xf - mean[:, None, None]) * scale[:, None, None]
    return (y + m.bias[:, None, None]).to(x.dtype)


def relu6(x: torch.Tensor, mx: float = 6.0, mn: float = 0.0) -> torch.Tensor:
    """`layers.relu6`: a clamp."""
    return torch.clamp(x, mn, mx)


def max_pool(x: torch.Tensor, kernel: int, stride: int, padding: int = 0):
    return F.max_pool2d(x, kernel, stride, padding)


def blur_pool(x: torch.Tensor) -> torch.Tensor:
    """`layers.blur` (sfilter (1, 1)): AvgPool2d(2, stride 1, padding 1)
    counting the zero padding; it grows each side by one."""
    return F.avg_pool2d(x, 2, stride=1, padding=1, count_include_pad=True)


def adaptive_avg_pool(x: torch.Tensor, out: Tuple[int, int]) -> torch.Tensor:
    """torch's AdaptiveAvgPool2d bins: bin i of `size` covers
    [floor(i·size/o), ceil((i+1)·size/o)). The same slabs as the JAX
    package (`zoo/layers.py:85-104`): rows, then columns."""
    oh, ow = out
    if (oh, ow) == (1, 1):
        return x.mean(dim=(2, 3), keepdim=True)

    def pool_axis(a, size, osize, dim):
        slabs = [a.narrow(dim, (i * size) // osize,
                          -(-((i + 1) * size) // osize) - (i * size) // osize
                          ).mean(dim=dim, keepdim=True)
                 for i in range(osize)]
        return torch.cat(slabs, dim=dim)

    return pool_axis(pool_axis(x, x.shape[2], oh, 2), x.shape[3], ow, 3)


def drop_path(x: torch.Tensor, rate: float, training: bool,
              gens: Generators) -> torch.Tensor:
    """Per-sample stochastic depth scaled by 1/keep, from the "droppath"
    generator; the identity at eval or rate 0."""
    return ml.drop_path(x, rate, training, (gens or {}).get("droppath"))


def train_dropout(x: torch.Tensor, rate: float, training: bool,
                  gens: Generators) -> torch.Tensor:
    """Element-wise dropout in training, from the "dropout" generator."""
    return ml.dropout(x, rate, training, (gens or {}).get("dropout"))


def mc_dropout(x: torch.Tensor, rate: float, gens: Generators):
    """MC dropout (`F.dropout(x, p)` in the reference's mcdo blocks): on in
    train and eval mode alike; needs the "dropout" generator."""
    if rate == 0.0:
        return x
    g = (gens or {}).get("dropout")
    if g is None:
        raise ValueError("an MC-dropout model needs a 'dropout' generator "
                         "(generators={'dropout': torch.Generator()}), in "
                         "eval mode too")
    return ml.dropout(x, rate, True, g)


def tap(taps: Optional[List[torch.Tensor]], x: torch.Tensor) -> torch.Tensor:
    """Record a latent (`zoo/layers.py:tap`) when the caller asked."""
    if taps is not None:
        taps.append(x)
    return x


# ------------------------------------------------------------------ gates

class ChannelGate(nn.Module):
    """SE / CBAM channel gate (`gates.py`): average (and max) pool over HW
    → shared `ff.0` C→C/r, ReLU, `ff.2` C/r→C → mean over the pools →
    sigmoid → scale."""

    def __init__(self, channels: int, reduction: int = 16,
                 max_pool_too: bool = True):
        super().__init__()
        self.max_pool_too = max_pool_too
        self.ff = slots({0: nn.Linear(channels, channels // reduction,
                                      bias=False),
                         2: nn.Linear(channels // reduction, channels,
                                      bias=False)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pools = [x.mean(dim=(2, 3))]
        if self.max_pool_too:
            pools.append(x.amax(dim=(2, 3)))
        s = torch.stack(pools, dim=1)                  # [B, pools, C]
        s = linear(F.relu(linear(s, self.ff["0"])), self.ff["2"])
        s = torch.sigmoid(s.mean(dim=1).float()).to(x.dtype)
        return x * s[:, :, None, None]


class SpatialGate(nn.Module):
    """CBAM spatial gate: channel mean and max maps → `ff.0` conv 7×7 →
    `ff.1` BN → sigmoid → scale."""

    def __init__(self, kernel: int = 7):
        super().__init__()
        self.ff = slots({0: conv2d(2, 1, kernel, padding=(kernel - 1) // 2),
                         1: bn2d(1)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.cat([x.mean(dim=1, keepdim=True),
                       x.amax(dim=1, keepdim=True)], dim=1)
        s = bn(conv(s, self.ff["0"]), self.ff["1"])
        return x * torch.sigmoid(s.float()).to(x.dtype)


# -------------------------------------------------------------- smoothing

def tanh_blur_block(x: torch.Tensor, temp: float = 1e1) -> torch.Tensor:
    """`TanhBlurBlock`: temp·tanh(x/temp) → ReLU → blur."""
    return blur_pool(F.relu(temp * torch.tanh(x / temp)))


def smooth_layer(x: torch.Tensor, count: int, temp: float = 1e1):
    for _ in range(count):
        x = tanh_blur_block(x, temp)
    return x


# ------------------------------------------------------------ classifiers

class GAPBlock(nn.Module):
    """`GAPBlock`: global average pool → `dense`."""

    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        self.dense = nn.Linear(in_features, num_classes)

    def forward(self, x, gens: Generators = None):
        return linear(x.mean(dim=(2, 3)), self.dense)


class BNGAPBlock(nn.Module):
    """`BNGAPBlock`: `bn` → ReLU → global average pool → `dense`."""

    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        self.bn = bn2d(in_features)
        self.dense = nn.Linear(in_features, num_classes)

    def forward(self, x, gens: Generators = None):
        return linear(F.relu(bn(x, self.bn)).mean(dim=(2, 3)), self.dense)


class GMaxPBlock(nn.Module):
    """`GMaxPBlock`: global max pool → `dense`."""

    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        self.dense = nn.Linear(in_features, num_classes)

    def forward(self, x, gens: Generators = None):
        return linear(x.amax(dim=(2, 3)), self.dense)


class MLPBlock(nn.Module):
    """`MLPBlock`: flatten (c, h, w) → `dense1` 4096 → ReLU → dropout .5 →
    `dense2` 4096 → ReLU → dropout .5 → `dense3`."""

    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        self.dense1 = nn.Linear(in_features, 4096)
        self.dense2 = nn.Linear(4096, 4096)
        self.dense3 = nn.Linear(4096, num_classes)

    def forward(self, x, gens: Generators = None):
        x = x.flatten(1)
        x = train_dropout(F.relu(linear(x, self.dense1)), 0.5,
                          self.training, gens)
        x = train_dropout(F.relu(linear(x, self.dense2)), 0.5,
                          self.training, gens)
        return linear(x, self.dense3)


CLASSIFIERS = {"gap": GAPBlock, "bngap": BNGAPBlock, "gmaxp": GMaxPBlock,
               "mlp": MLPBlock}


def classifier(cblock: str, in_features: int, num_classes: int):
    if cblock not in CLASSIFIERS:
        raise ValueError(f"unknown cblock {cblock!r}")
    return CLASSIFIERS[cblock](in_features, num_classes)


# --------------------------------------------------------------- helpers

def stochastic_depths(sd: float, num_blocks: Sequence[int]):
    """Per-block drop-path rates, linear over the whole depth."""
    total = sum(num_blocks)
    idxs = [list(range(sum(num_blocks[:i]), sum(num_blocks[:i + 1])))
            for i in range(len(num_blocks))]
    return [[sd * j / (total - 1) if total > 1 else 0.0 for j in js]
            for js in idxs]


def make_divisible(v: float, divisor: int, min_value: Optional[int] = None):
    """MobileNet's channel rounding."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def interpret_pad(image: int, kernel: int, stride: int, padding: int = 0):
    return (image - kernel + 2 * padding) // stride + 1


def randn_param(*shape: int, std: float = 0.02) -> nn.Parameter:
    """`nn.Parameter(torch.randn(...) * 0.02)` (class tokens, position
    embeddings and tables)."""
    return nn.Parameter(torch.randn(*shape) * std)
