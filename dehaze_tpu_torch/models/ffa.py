"""FFA-Net, the CNN baseline (counterpart of `dehaze_tpu/models/ffa.py`).

Three residual Groups of `blocks` Blocks (conv-relu-conv, channel
attention, pixel attention), a learned 3-way fusion of the group outputs by
channel attention over their pooled means, pixel attention, two post
convs and the global residual. The module names are the reference
FFA.py's (`pre.0`, `g{g}.gp.{i}.conv1`, `...calayer.ca.0`, `ca.1`,
`palayer.pa.0`, `post.0`, ...), so a reference checkpoint loads with
`strict=True`; torch's default Conv2d init is the reference's (the JAX
package copies it: FFA has no normalization layers, so the init scale
decides whether training is stable).

forward takes NHWC float images and returns float32 x + residual, where x
is the input it *received* (the normalized hazy image under the FFA
protocol's normalization, as in the reference). Inside, activations are
NCHW views of channels-last memory (`x.permute(0, 3, 1, 2)` of an NHWC
tensor), the layout of cuDNN's bf16 convolutions, so no layout copy is
made at either end (for float32, cuDNN picks NCHW kernels and converts
each conv's input and output itself). Parameters are float32 and cast to
the activation dtype at use.

On a band of a frame (`bands`, `infer.halo_sharded.
make_halo_sharded_native_fn`), each 3×3 conv takes one row from each
neighbour band (`parallel.halo.halo_rows`) and runs VALID on rows, and the
global average pools average the bands' means (`parallel.halo.
mean_over_bands`): the one-process forward when the bands have equal
heights.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dehaze_tpu_torch.models.layers import cast
from dehaze_tpu_torch.parallel.halo import Bands, halo_rows, mean_over_bands


def _conv(x: torch.Tensor, conv: nn.Conv2d, padding=0) -> torch.Tensor:
    return F.conv2d(x, cast(conv.weight, x), cast(conv.bias, x),
                    padding=padding)


def _conv3(x: torch.Tensor, conv: nn.Conv2d, bands: Optional[Bands]
           ) -> torch.Tensor:
    """3×3 SAME conv of NCHW x; on a band, the neighbours' rows in place
    of the zero rows."""
    if bands is None:
        return _conv(x, conv, 1)
    xh = halo_rows(x.permute(0, 2, 3, 1), 1, 1, bands).permute(0, 3, 1, 2)
    return _conv(xh, conv, (0, 1))


def _gmean(x: torch.Tensor, bands: Optional[Bands]) -> torch.Tensor:
    """Global [B, C, 1, 1] average pool, over the whole frame on a band."""
    y = x.mean((2, 3), keepdim=True)
    return y if bands is None else mean_over_bands(y, bands)


def _default_conv(cin: int, cout: int, k: int, device=None) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2, device=device)


class PALayer(nn.Module):
    """Pixel attention: x · sigmoid(conv(relu(conv(x))))."""

    def __init__(self, channel: int, device=None):
        super().__init__()
        self.pa = nn.Sequential(
            nn.Conv2d(channel, channel // 8, 1, device=device), nn.ReLU(),
            nn.Conv2d(channel // 8, 1, 1, device=device), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _conv(F.relu(_conv(x, self.pa[0])), self.pa[2])
        return x * torch.sigmoid(y)


class CALayer(nn.Module):
    """Channel attention on the global average pool."""

    def __init__(self, channel: int, device=None):
        super().__init__()
        self.ca = nn.Sequential(
            nn.Conv2d(channel, channel // 8, 1, device=device), nn.ReLU(),
            nn.Conv2d(channel // 8, channel, 1, device=device), nn.Sigmoid())

    def forward(self, x: torch.Tensor, bands: Optional[Bands] = None
                ) -> torch.Tensor:
        y = _conv(F.relu(_conv(_gmean(x, bands), self.ca[0])), self.ca[2])
        return x * torch.sigmoid(y)


class Block(nn.Module):
    """conv-relu (+x) conv, CA, PA, +x."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.conv1 = _default_conv(dim, dim, 3, device)
        self.act1 = nn.ReLU()
        self.conv2 = _default_conv(dim, dim, 3, device)
        self.calayer = CALayer(dim, device)
        self.palayer = PALayer(dim, device)

    def forward(self, x: torch.Tensor, bands: Optional[Bands] = None
                ) -> torch.Tensor:
        res = F.relu(_conv3(x, self.conv1, bands)) + x
        res = _conv3(res, self.conv2, bands)
        res = self.palayer(self.calayer(res, bands))
        return res + x


class Group(nn.Module):
    """`blocks` Blocks and a conv (`gp.{blocks}`), residual."""

    def __init__(self, dim: int, blocks: int, device=None):
        super().__init__()
        self.gp = nn.Sequential(*[Block(dim, device) for _ in range(blocks)],
                                _default_conv(dim, dim, 3, device))

    def forward(self, x: torch.Tensor, bands: Optional[Bands] = None
                ) -> torch.Tensor:
        res = x
        for blk in self.gp[:-1]:
            res = blk(res, bands)
        return _conv3(res, self.gp[-1], bands) + x


class FFA(nn.Module):
    """The whole FFA-Net. forward: NHWC float [B, H, W, 3] → float32
    [B, H, W, 3]; any H and W."""

    def __init__(self, gps: int = 3, blocks: int = 19, dim: int = 64,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if gps != 3:
            raise ValueError(f"ffa_gps must be 3 (the reference asserts it); "
                             f"got {gps}")
        self.gps, self.dim, self.dtype = gps, dim, dtype
        self.pre = nn.Sequential(_default_conv(3, dim, 3, device))
        self.g1 = Group(dim, blocks, device)
        self.g2 = Group(dim, blocks, device)
        self.g3 = Group(dim, blocks, device)
        self.ca = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(dim * gps, dim // 16, 1, device=device), nn.ReLU(),
            nn.Conv2d(dim // 16, dim * gps, 1, device=device), nn.Sigmoid())
        self.palayer = PALayer(dim, device)
        self.post = nn.Sequential(_default_conv(dim, dim, 3, device),
                                  _default_conv(dim, 3, 3, device))

    def forward(self, x: torch.Tensor, bands: Optional[Bands] = None
                ) -> torch.Tensor:
        """bands: x is this rank's band of the frame's rows, or None."""
        y = _conv3(x.to(self.dtype).permute(0, 3, 1, 2), self.pre[0], bands)
        res1 = self.g1(y, bands)
        res2 = self.g2(res1, bands)
        res3 = self.g3(res2, bands)
        # the reference pools the 3·dim concat of the group outputs; the
        # concat of their pooled means is the same, without the
        # full-resolution concat
        w = torch.cat([_gmean(r, bands) for r in (res1, res2, res3)], 1)
        w = torch.sigmoid(_conv(F.relu(_conv(w, self.ca[1])), self.ca[3]))
        w = w.view(w.shape[0], self.gps, self.dim, 1, 1)
        out = w[:, 0] * res1 + w[:, 1] * res2 + w[:, 2] * res3
        out = self.palayer(out)
        out = _conv3(_conv3(out, self.post[0], bands), self.post[1], bands)
        return x.float() + out.permute(0, 2, 3, 1).float()
