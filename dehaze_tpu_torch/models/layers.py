"""Building blocks of the Uformer (counterpart of `dehaze_tpu/models/layers.py`).

All modules take and return NHWC tensors. Parameters are float32 and carry
the reference torch model's state_dict names (`proj.0`, `conv.0`,
`deconv.0`, `linear1.0`, `dwconv.0`, `linear2.0`: the reference wraps each
layer in an `nn.Sequential`; `fc1`/`fc2` of the plain FFN, `fc.0`/`fc.2`
of the squeeze-excite gate, `depthwise`/`pointwise` of the separable
conv), so reference `.pth` checkpoints load
unchanged; each forward casts them to the activation dtype
at use, as the JAX modules do.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dehaze_tpu_torch.ops import actstore
from dehaze_tpu_torch.ops.kernels.leff import leff_fused
from dehaze_tpu_torch.parallel.halo import Bands, halo_rows
from dehaze_tpu_torch.utils.transfer import to_device


def cast(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A parameter in the activation dtype of `like`."""
    return t.to(like.dtype)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def _conv_rows(x: torch.Tensor, bands: Optional[Bands]):
    """(input, padding) of a 3×3 or 4×4/p1 conv over NHWC x: one zero row
    and column on each side, or, on a band of a canvas, the neighbour
    bands' rows (`parallel.halo.halo_rows`, zeros at the canvas edge) and
    zero columns. Returned as NCHW."""
    if bands is None:
        return _nchw(x), 1
    return _nchw(halo_rows(x, 1, 1, bands)), (0, 1)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm with float32 statistics and affine, rounded to x.dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps).to(x.dtype)


class RowShare:
    """A generator for the per-sample draws of a batch of `total` rows of
    which this process holds rows [lo, lo + its batch): each mask is drawn
    for all `total` rows, as one process holding the whole batch draws it,
    and this process's rows are kept. Data-parallel training passes one in
    place of each DropPath and dropout generator, so P ranks apply the
    masks of the one-process step. get_state/set_state are the generator's
    (the remat replay uses them)."""

    def __init__(self, generator: torch.Generator, lo: int, total: int):
        self.generator, self.lo, self.total = generator, lo, total

    def get_state(self) -> torch.Tensor:
        return self.generator.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self.generator.set_state(state)


def _keep_mask(shape, keep: float, generator, device) -> torch.Tensor:
    """Bernoulli(keep) mask drawn from an explicit generator (on its device,
    the CPU unless the caller gave a CUDA one) or a `RowShare` of one,
    moved to `device`."""
    if generator is None:
        raise ValueError("a random layer in training needs an explicit "
                         "torch.Generator")
    rows = slice(None)
    if isinstance(generator, RowShare):
        rows = slice(generator.lo, generator.lo + shape[0])
        shape = (generator.total,) + tuple(shape[1:])
        generator = generator.generator
    draw = torch.rand(shape, generator=generator, device=generator.device)
    return to_device(draw[rows] < keep, device)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Element-wise dropout scaled by 1/keep; the identity at eval or rate 0."""
    if rate == 0.0 or not training:
        return x
    keep = 1.0 - rate
    mask = _keep_mask(x.shape, keep, generator, x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Per-sample stochastic depth scaled by 1/keep; the identity at eval
    or rate 0."""
    if rate == 0.0 or not training:
        return x
    keep = 1.0 - rate
    mask = _keep_mask((x.shape[0],) + (1,) * (x.ndim - 1), keep, generator,
                      x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))


class DropPath(nn.Module):
    """`drop_path` as a module. The mask comes from the generator passed
    to forward."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return drop_path(x, self.rate, self.training, generator)


class InputProj(nn.Module):
    """3→C conv3×3 + LeakyReLU(0.01)."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.proj = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, padding=1, device=device))

    def forward(self, x: torch.Tensor, bands: Optional[Bands] = None
                ) -> torch.Tensor:
        conv = self.proj[0]
        x_, pad = _conv_rows(x, bands)
        y = F.conv2d(x_, cast(conv.weight, x), cast(conv.bias, x),
                     padding=pad)
        return _nhwc(F.leaky_relu(y, 0.01))


class OutputProj(nn.Module):
    """2C→3 conv3×3."""

    def __init__(self, in_channels: int, out_channels: int = 3, device=None):
        super().__init__()
        self.proj = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, padding=1, device=device))

    def forward(self, x: torch.Tensor, bands: Optional[Bands] = None
                ) -> torch.Tensor:
        conv = self.proj[0]
        x_, pad = _conv_rows(x, bands)
        return _nhwc(F.conv2d(x_, cast(conv.weight, x), cast(conv.bias, x),
                              padding=pad))


class Downsample(nn.Module):
    """C→2C conv4×4, stride 2, padding 1."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(in_channels, out_channels, 4,
                                            stride=2, padding=1,
                                            device=device))

    def forward(self, x: torch.Tensor, bands: Optional[Bands] = None
                ) -> torch.Tensor:
        conv = self.conv[0]
        x_, pad = _conv_rows(x, bands)
        return _nhwc(F.conv2d(x_, cast(conv.weight, x), cast(conv.bias, x),
                              stride=2, padding=pad))


class Upsample(nn.Module):
    """C→C/2 transposed conv2×2, stride 2."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.deconv = nn.Sequential(nn.ConvTranspose2d(
            in_channels, out_channels, 2, stride=2, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        deconv = self.deconv[0]
        return _nhwc(F.conv_transpose2d(_nchw(x), cast(deconv.weight, x),
                                        cast(deconv.bias, x), stride=2))


class LeFF(nn.Module):
    """Locally-enhanced FFN: Linear(C→hidden) → GELU → depthwise conv3×3
    (a grouped `nn.Conv2d`) → GELU → Linear(hidden→C).

    forward(x, norm) computes LeFF(norm(x)). At eval it is one call of
    kernel K2 (`ops.kernels.leff.leff_fused`): on CUDA the fused kernel, on
    CPU its plain twin. In training, and on a band of a canvas (`bands`),
    it runs the unfused path the JAX package runs there (K2 is inference
    only there too, and its zero halo is the canvas edge's, not a band's):
    LayerNorm, `F.linear`, GELU, grouped `F.conv2d` (over the neighbour
    bands' rows), GELU, `F.linear`. The residual add stays with the
    block.

    `act_store` (the block's mode, None in training) round-trips four
    tensors through `ops.actstore.compress`, as the JAX block and LeFF do:
    norm's output, the hidden after each GELU (the first before the
    conv, so the neighbour bands exchange compressed rows) and the
    output. K2 does it inside the kernel."""

    def __init__(self, dim: int, hidden_dim: int, fast_gelu: bool = False,
                 device=None):
        super().__init__()
        self.fast_gelu = fast_gelu
        self.linear1 = nn.Sequential(nn.Linear(dim, hidden_dim, device=device))
        self.dwconv = nn.Sequential(
            nn.Conv2d(hidden_dim, hidden_dim, 3, padding=1, groups=hidden_dim,
                      device=device))
        self.linear2 = nn.Sequential(nn.Linear(hidden_dim, dim, device=device))

    def forward(self, x: torch.Tensor, norm: nn.LayerNorm,
                bands: Optional[Bands] = None,
                act_store: Optional[str] = None) -> torch.Tensor:
        l1, dw, l2 = self.linear1[0], self.dwconv[0], self.linear2[0]
        if self.training or bands is not None:
            approx = "tanh" if self.fast_gelu else "none"

            def store(t):
                return actstore.compress(t, act_store)

            h = F.linear(store(layer_norm(x, norm)), cast(l1.weight, x),
                         cast(l1.bias, x))
            h = store(F.gelu(h, approximate=approx))
            h_, pad = _conv_rows(h, bands)
            h = F.conv2d(h_, cast(dw.weight, h), cast(dw.bias, h),
                         padding=pad, groups=h.shape[-1])
            h = store(F.gelu(_nhwc(h), approximate=approx))
            return store(F.linear(h, cast(l2.weight, h), cast(l2.bias, h)))
        return leff_fused(
            x, ln_scale=norm.weight, ln_bias=norm.bias, w1=l1.weight.t(),
            b1=l1.bias, dw_kernel=dw.weight.permute(2, 3, 1, 0),
            dw_bias=dw.bias, w2=l2.weight.t(), b2=l2.bias, eps=norm.eps,
            fast_gelu=self.fast_gelu, act_store=act_store)


class Mlp(nn.Module):
    """The plain FFN of token_mlp='ffn': Linear(C→hidden) → GELU → dropout
    → Linear(hidden→C) → dropout (state_dict `fc1`, `fc2`). forward takes
    the normalised tokens; its dropouts draw from `dropout_gen` in
    training (none is needed at rate 0)."""

    def __init__(self, dim: int, hidden_dim: int, drop: float = 0.0,
                 fast_gelu: bool = False, device=None):
        super().__init__()
        self.drop = drop
        self.fast_gelu = fast_gelu
        self.fc1 = nn.Linear(dim, hidden_dim, device=device)
        self.fc2 = nn.Linear(hidden_dim, dim, device=device)

    def forward(self, x: torch.Tensor,
                dropout_gen: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        h = F.linear(x, cast(self.fc1.weight, x), cast(self.fc1.bias, x))
        h = F.gelu(h, approximate="tanh" if self.fast_gelu else "none")
        h = dropout(h, self.drop, self.training, dropout_gen)
        y = F.linear(h, cast(self.fc2.weight, h), cast(self.fc2.bias, h))
        return dropout(y, self.drop, self.training, dropout_gen)


class SELayer(nn.Module):
    """Squeeze-excite over the tokens of each window, [B, N, C]: mean over
    N (float32) → Linear(C→C//reduction) → ReLU → Linear(→C) → sigmoid
    (float32), multiplied back per channel. Both Linears are bias-free
    (state_dict `fc.0`, `fc.2`); below C = reduction the first is
    zero-width, as the reference builds it, and the gate is sigmoid(0)."""

    def __init__(self, channels: int, reduction: int = 16, device=None):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(channels, channels // reduction, bias=False,
                      device=device),
            nn.ReLU(),
            nn.Linear(channels // reduction, channels, bias=False,
                      device=device),
            nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.float().mean(dim=1).to(x.dtype)
        y = F.relu(F.linear(y, cast(self.fc[0].weight, x)))
        y = F.linear(y, cast(self.fc[2].weight, x))
        return x * torch.sigmoid(y.float()).to(x.dtype)[:, None, :]


class SepConv2d(nn.Module):
    """Separable conv on NHWC: depthwise k×k (zero padding k//2) → ReLU →
    pointwise 1×1, both with bias (state_dict `depthwise`, `pointwise`)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, device=None):
        super().__init__()
        self.depthwise = nn.Conv2d(in_channels, in_channels, kernel_size,
                                   padding=kernel_size // 2,
                                   groups=in_channels, device=device)
        self.pointwise = nn.Conv2d(in_channels, out_channels, 1,
                                   device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dw, pw = self.depthwise, self.pointwise
        y = F.conv2d(_nchw(x), cast(dw.weight, x), cast(dw.bias, x),
                     padding=dw.padding, groups=dw.groups)
        y = F.conv2d(F.relu(y), cast(pw.weight, x), cast(pw.bias, x))
        return _nhwc(y)
