"""The residual conv UNet baseline (counterpart of
`dehaze_tpu/models/unet.py`).

Five levels of ConvBlocks (conv3-lrelu-conv3-lrelu plus a 1×1 shortcut),
4×4 stride-2 convs down, 2×2 stride-2 transposed convs up with the skip
concatenated after the upsampled map, a 3×3 conv out, and the global
residual. Module names are the reference's (`ConvBlock{i}.block.0/.2`,
`ConvBlock{i}.conv11`, `pool{i}`, `upv{i}`, `conv10`) and the transposed
convs keep torch's [in, out, kh, kw] weight layout, so a reference `.pth`
loads with `strict=True` (the JAX package's converter flips them into
its layout). Like FFA-Net it runs on NCHW views of channels-last memory
and casts its float32 parameters to the activation dtype at use. H and W
must be multiples of 16.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from dehaze_tpu_torch.models.layers import cast


def _conv(x, conv: nn.Conv2d, stride=1, padding=0):
    return F.conv2d(x, cast(conv.weight, x), cast(conv.bias, x),
                    stride=stride, padding=padding)


class ConvBlock(nn.Module):
    """(conv3-lrelu-conv3-lrelu) + conv1×1 shortcut."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv2d(cin, cout, 3, padding=1, device=device),
            nn.LeakyReLU(0.01),
            nn.Conv2d(cout, cout, 3, padding=1, device=device),
            nn.LeakyReLU(0.01))
        self.conv11 = nn.Conv2d(cin, cout, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(_conv(x, self.block[0], padding=1), 0.01)
        y = F.leaky_relu(_conv(y, self.block[2], padding=1), 0.01)
        return y + _conv(x, self.conv11)


class UNet(nn.Module):
    """forward: NHWC float [B, H, W, 3] → float32 [B, H, W, 3]."""

    def __init__(self, dim: int = 32, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        widths = [dim, dim * 2, dim * 4, dim * 8, dim * 16]
        cin = 3
        for i, c in enumerate(widths, start=1):
            setattr(self, f"ConvBlock{i}", ConvBlock(cin, c, device))
            if i < 5:
                setattr(self, f"pool{i}", nn.Conv2d(c, c, 4, stride=2,
                                                    padding=1, device=device))
            cin = c
        for i, c in zip(range(6, 10), widths[3::-1]):
            setattr(self, f"upv{i}", nn.ConvTranspose2d(cin, c, 2, stride=2,
                                                        device=device))
            setattr(self, f"ConvBlock{i}", ConvBlock(2 * c, c, device))
            cin = c
        self.conv10 = nn.Conv2d(dim, 3, 3, padding=1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.dtype).permute(0, 3, 1, 2)
        skips = []
        for i in range(1, 5):
            y = getattr(self, f"ConvBlock{i}")(y)
            skips.append(y)
            y = _conv(y, getattr(self, f"pool{i}"), stride=2, padding=1)
        y = self.ConvBlock5(y)
        for i in range(6, 10):
            up = getattr(self, f"upv{i}")
            y = F.conv_transpose2d(y, cast(up.weight, y), cast(up.bias, y),
                                   stride=2)
            y = getattr(self, f"ConvBlock{i}")(torch.cat([y, skips.pop()],
                                                         1))
        out = _conv(y, self.conv10, padding=1)
        return x.float() + out.permute(0, 2, 3, 1).float()
