"""The convolutional families of the zoo (counterpart of
`dehaze_tpu/zoo/convnets.py`): the ResNet superfamily (ResNet, PreResNet,
ResNeXt, WideResNet, SE and CBAM gates, MC dropout, smoothing blocks),
VGG and PreVGG, AlexNet and MobileNetV2.

Modules carry the reference's state_dict names (`layer0.0`, `layer1.0.
conv1.0`, `classifier.0.dense`, `features.3.conv2.1`, ...). Each forward
takes NCHW images, `generators` (the "dropout" and "droppath" streams) and
`taps` (a list the latents are appended to), and returns logits in the
model's dtype. Where MC dropout sits in a block is the reference's: after
the last conv of a plain ResNet block, mid-block in the gated and
pre-activation ones, after each ReLU in VGG and AlexNet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dehaze_tpu_torch.zoo import layers as zl


class PostBlock(nn.Module):
    """`resnet_dnn_block.py` and its se / cbam / mcdo variants: basic
    (conv3-conv3) or bottleneck (conv1-conv3-conv1), BN after each conv,
    the gate, then the residual and a ReLU."""

    def __init__(self, block: str, in_ch: int, out_ch: int, stride: int,
                 groups: int = 1, width_per_group: int = 64,
                 gate: Optional[str] = None, mc_rate: float = 0.0,
                 sd: float = 0.0):
        super().__init__()
        exp = 4 if block == "bottleneck" else 1
        width = int(out_ch * (width_per_group / 64.0)) * groups
        self.basic, self.mc_rate, self.sd = block == "basic", mc_rate, sd
        self.shortcut = None
        if stride != 1 or in_ch != out_ch * exp:
            self.shortcut = zl.slots({
                0: zl.conv2d(in_ch, out_ch * exp, 1, stride=stride),
                1: zl.bn2d(out_ch * exp)})
        if self.basic:
            self.conv1 = zl.slots({0: zl.conv2d(in_ch, width, 3, stride, 1),
                                   1: zl.bn2d(width)})
            self.conv2 = zl.slots({0: zl.conv2d(width, out_ch * exp, 3,
                                                padding=1),
                                   1: zl.bn2d(out_ch * exp)})
        else:
            self.conv1 = zl.slots({0: zl.conv2d(in_ch, width, 1),
                                   1: zl.bn2d(width)})
            self.conv2 = zl.slots({0: zl.conv2d(width, width, 3, stride, 1,
                                                groups=groups),
                                   1: zl.bn2d(width)})
            self.conv3 = zl.slots({0: zl.conv2d(width, out_ch * exp, 1),
                                   1: zl.bn2d(out_ch * exp)})
        if gate == "se":
            self.gate = zl.ChannelGate(out_ch * exp, max_pool_too=False)
        elif gate == "cbam":
            self.gate = zl.slots({0: zl.ChannelGate(out_ch * exp),
                                  1: zl.SpatialGate()})
        elif gate is not None:
            raise ValueError(f"unknown gate {gate!r}")
        self.gate_kind = gate

    @staticmethod
    def _cbr(x, seq, relu=True):
        y = zl.bn(zl.conv(x, seq["0"]), seq["1"])
        return F.relu(y) if relu else y

    def forward(self, x, gens=None):
        skip = x if self.shortcut is None else self._cbr(x, self.shortcut,
                                                         relu=False)
        y = self._cbr(x, self.conv1)
        if not self.basic:
            y = self._cbr(y, self.conv2)
        if self.mc_rate and self.gate_kind is not None:
            y = zl.mc_dropout(y, self.mc_rate, gens)
        y = self._cbr(y, self.conv2 if self.basic else self.conv3,
                      relu=False)
        if self.gate_kind == "se":
            y = self.gate(y)
        elif self.gate_kind == "cbam":
            y = self.gate["1"](self.gate["0"](y))
        if self.mc_rate and self.gate_kind is None:
            y = zl.mc_dropout(y, self.mc_rate, gens)
        return F.relu(zl.drop_path(y, self.sd, self.training, gens) + skip)


class PreBlock(nn.Module):
    """`preresnet_dnn_block.py` (and mcdo): BN-ReLU before each conv, the
    shortcut taken after the first pre-activation, no ReLU after the
    sum. AlterNet's plain blocks are these."""

    def __init__(self, block: str, in_ch: int, out_ch: int, stride: int,
                 groups: int = 1, width_per_group: int = 64,
                 mc_rate: float = 0.0, sd: float = 0.0):
        super().__init__()
        exp = 4 if block == "bottleneck" else 1
        width = int(out_ch * (width_per_group / 64.0)) * groups
        self.basic, self.mc_rate, self.sd = block == "basic", mc_rate, sd
        self.bn = zl.bn2d(in_ch)
        self.shortcut = None
        if stride != 1 or in_ch != out_ch * exp:
            self.shortcut = zl.slots({0: zl.conv2d(in_ch, out_ch * exp, 1,
                                                   stride=stride)})
        if self.basic:
            self.conv1 = zl.conv2d(in_ch, width, 3, stride, 1)
            self.conv2 = zl.slots({0: zl.bn2d(width),
                                   2: zl.conv2d(width, out_ch * exp, 3,
                                                padding=1)})
        else:
            self.conv1 = zl.conv2d(in_ch, width, 1)
            self.conv2 = zl.slots({0: zl.bn2d(width),
                                   2: zl.conv2d(width, width, 3, stride, 1,
                                                groups=groups)})
            self.conv3 = zl.slots({0: zl.bn2d(width),
                                   2: zl.conv2d(width, out_ch * exp, 1)})

    @staticmethod
    def _brc(x, seq):
        return zl.conv(F.relu(zl.bn(x, seq["0"])), seq["2"])

    def forward(self, x, gens=None):
        h = F.relu(zl.bn(x, self.bn))
        skip = x if self.shortcut is None else zl.conv(h, self.shortcut["0"])
        y = zl.conv(h, self.conv1)
        if self.basic:
            if self.mc_rate:
                y = zl.mc_dropout(y, self.mc_rate, gens)
            y = self._brc(y, self.conv2)
        else:
            y = self._brc(y, self.conv2)
            if self.mc_rate:
                y = zl.mc_dropout(y, self.mc_rate, gens)
            y = self._brc(y, self.conv3)
        return zl.drop_path(y, self.sd, self.training, gens) + skip


class ResNetZoo(nn.Module):
    """Nine reference families in one module (`models/resnet.py`).

    block: "basic" | "bottleneck"; style: "post" (resnet) | "pre"
    (preresnet, whose stem has no BN/ReLU); gate: None | "se" | "cbam";
    mc_rate > 0 ≙ the mcdo blocks; num_sblocks ≙ the smoothing variants;
    cblock: "gap" | "bngap" | "mlp" (the classifier)."""

    def __init__(self, block: str = "basic",
                 num_blocks: Sequence[int] = (2, 2, 2, 2),
                 style: str = "post", gate: Optional[str] = None,
                 mc_rate: float = 0.0,
                 num_sblocks: Sequence[int] = (0, 0, 0, 0),
                 cblock: str = "gap", sd: float = 0.0, num_classes: int = 10,
                 stem: bool = False, groups: int = 1,
                 width_per_group: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.stem, self.num_sblocks = dtype, stem, num_sblocks
        exp = 4 if block == "bottleneck" else 1
        first = (zl.conv2d(3, 64, 7, 2, 3) if stem
                 else zl.conv2d(3, 64, 3, 1, 1))
        self.post_stem = style == "post"
        self.layer0 = zl.slots({0: first, 1: zl.bn2d(64)} if self.post_stem
                               else {0: first})
        sds = zl.stochastic_depths(sd, num_blocks)
        in_ch = 64
        for li, (n, out_ch, stride) in enumerate(zip(
                num_blocks, (64, 128, 256, 512), (1, 2, 2, 2)), start=1):
            blocks = []
            for bi in range(n):
                s = stride if bi == 0 else 1
                if style == "pre":
                    blocks.append(PreBlock(block, in_ch, out_ch, s, groups,
                                           width_per_group, mc_rate,
                                           sds[li - 1][bi]))
                else:
                    blocks.append(PostBlock(block, in_ch, out_ch, s, groups,
                                            width_per_group, gate, mc_rate,
                                            sds[li - 1][bi]))
                in_ch = out_ch * exp
            setattr(self, f"layer{li}", nn.ModuleList(blocks))
        self.cblock = cblock
        if cblock == "mlp":  # AdaptiveAvgPool2d((7, 7)) at index 0
            self.classifier = zl.slots({1: zl.classifier(
                "mlp", 7 * 7 * 512 * exp, num_classes)})
        else:
            self.classifier = zl.slots({0: zl.classifier(
                cblock, 512 * exp, num_classes)})

    def forward(self, x: torch.Tensor, generators: zl.Generators = None,
                taps: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        x = zl.conv(x.to(self.dtype), self.layer0["0"])
        if self.post_stem:
            x = F.relu(zl.bn(x, self.layer0["1"]))
        if self.stem:
            x = zl.max_pool(x, 3, 2, 1)
        zl.tap(taps, x)
        for li in range(1, 5):
            for blk in getattr(self, f"layer{li}"):
                x = zl.tap(taps, blk(x, generators))
            x = zl.smooth_layer(x, self.num_sblocks[li - 1])
        if self.cblock == "mlp":
            return self.classifier["1"](zl.adaptive_avg_pool(x, (7, 7)),
                                        generators)
        return self.classifier["0"](x, generators)


class VGGBlock(nn.Module):
    """`vggnet_dnn_block.py` (conv → BN → ReLU) or, pre-activation,
    `prevggnet_dnn_block.py` (BN → ReLU → conv)."""

    def __init__(self, in_ch: int, out_ch: int, pre: bool):
        super().__init__()
        self.pre = pre
        self.conv = zl.conv2d(in_ch, out_ch, 3, padding=1)
        self.bn = zl.bn2d(in_ch if pre else out_ch)

    def forward(self, x):
        if self.pre:
            return zl.conv(F.relu(zl.bn(x, self.bn)), self.conv)
        return F.relu(zl.bn(zl.conv(x, self.conv), self.bn))


class VGGZoo(nn.Module):
    """`vggnet.py` / `prevggnet.py`: five stages of 3×3 convs (64, 128,
    256, 512, 512 wide), a max pool before each stage but the first (at
    the stage's Sequential index 0)."""

    def __init__(self, num_blocks: Sequence[int] = (1, 1, 2, 2, 2),
                 pre: bool = False, mc_rate: float = 0.0,
                 num_sblocks: Sequence[int] = (0, 0, 0, 0, 0),
                 cblock: str = "mlp", num_classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.mc_rate = dtype, mc_rate
        self.num_sblocks = num_sblocks
        in_ch = 3
        for li, (n, w) in enumerate(zip(num_blocks, (64, 128, 256, 512, 512))):
            idx0 = 1 if li > 0 else 0
            blocks = {}
            for bi in range(n):
                blocks[idx0 + bi] = VGGBlock(in_ch, w, pre)
                in_ch = w
            setattr(self, f"layer{li}", zl.slots(blocks))
        self.n_stages = len(num_blocks)
        self.cblock = cblock
        if cblock == "mlp":  # MaxPool, AdaptiveAvgPool2d((7, 7)) at 0, 1
            self.classifier = zl.slots({2: zl.classifier("mlp", 7 * 7 * 512,
                                                         num_classes)})
        else:
            self.classifier = zl.slots({0: zl.classifier(cblock, 512,
                                                         num_classes)})

    def forward(self, x: torch.Tensor, generators: zl.Generators = None,
                taps: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        x = x.to(self.dtype)
        for li in range(self.n_stages):
            if li > 0:
                x = zl.max_pool(x, 2, 2)
            for blk in getattr(self, f"layer{li}").values():
                x = blk(x)
                if self.mc_rate:
                    x = zl.mc_dropout(x, self.mc_rate, generators)
                zl.tap(taps, x)
            x = zl.smooth_layer(x, self.num_sblocks[li])
        if self.cblock == "mlp":
            x = zl.adaptive_avg_pool(zl.max_pool(x, 2, 2), (7, 7))
            return self.classifier["2"](x, generators)
        return self.classifier["0"](x, generators)


class AlexNetBlock(nn.Module):
    """`alexnet_dnn_block.py`: conv (no bias) → ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 padding: int):
        super().__init__()
        self.conv = zl.conv2d(in_ch, out_ch, kernel, stride, padding)

    def forward(self, x):
        return F.relu(zl.conv(x, self.conv))


class AlexNetZoo(nn.Module):
    """`alexnet.py`: 64 → 192 → 384 → 256 → 256 with max pools between
    the three stages (kernel 3 with the ImageNet stem, else 2)."""

    def __init__(self, mc_rate: float = 0.0,
                 num_sblocks: Sequence[int] = (0, 0, 0), cblock: str = "mlp",
                 num_classes: int = 10, stem: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.mc_rate, self.stem = dtype, mc_rate, stem
        self.num_sblocks = num_sblocks
        first = (AlexNetBlock(3, 64, 11, 4, 2) if stem
                 else AlexNetBlock(3, 64, 3, 2, 1))
        self.layer0 = zl.slots({0: first})
        self.layer1 = zl.slots({1: AlexNetBlock(64, 192, 5, 1, 2)})
        self.layer2 = zl.slots({1: AlexNetBlock(192, 384, 3, 1, 1),
                                2: AlexNetBlock(384, 256, 3, 1, 1),
                                3: AlexNetBlock(256, 256, 3, 1, 1)})
        self.cblock = cblock
        if cblock == "mlp":
            side = 6 if stem else 2
            self.classifier = zl.slots({2: zl.classifier(
                "mlp", side * side * 256, num_classes)})
        elif cblock == "gap":
            self.classifier = zl.slots({0: zl.classifier("gap", 256,
                                                         num_classes)})
        else:
            raise ValueError(f"unknown cblock {cblock!r}")

    def forward(self, x: torch.Tensor, generators: zl.Generators = None,
                taps: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        x = x.to(self.dtype)
        pool_k = 3 if self.stem else 2
        for li in range(3):
            if li > 0:
                x = zl.max_pool(x, pool_k, 2)
            for blk in getattr(self, f"layer{li}").values():
                x = blk(x)
                if self.mc_rate:
                    x = zl.mc_dropout(x, self.mc_rate, generators)
                zl.tap(taps, x)
            x = zl.smooth_layer(x, self.num_sblocks[li])
        if self.cblock == "mlp":
            side = 6 if self.stem else 2
            x = zl.adaptive_avg_pool(zl.max_pool(x, pool_k, 2), (side, side))
            return self.classifier["2"](x, generators)
        return self.classifier["0"](x, generators)


class InvertedBlock(nn.Module):
    """MobileNetV2's `Basic` (expand 1: depthwise 3×3, then 1×1) and
    `Bottleneck` (1×1 up, depthwise 3×3, 1×1 down) blocks, BN after each
    conv, ReLU6 after all but the last; the residual where the shape
    stays."""

    def __init__(self, dim_in: int, dim_out: int, stride: int, expand: int):
        super().__init__()
        hidden = round(dim_in * expand)
        self.identity = stride == 1 and dim_in == dim_out
        if expand == 1:
            convs = [zl.conv2d(dim_in, hidden, 3, stride, 1, groups=dim_in),
                     zl.conv2d(hidden, dim_out, 1)]
        else:
            convs = [zl.conv2d(dim_in, hidden, 1),
                     zl.conv2d(hidden, hidden, 3, stride, 1, groups=hidden),
                     zl.conv2d(hidden, dim_out, 1)]
        self.n = len(convs)
        for i, c in enumerate(convs, start=1):
            setattr(self, f"conv{i}", zl.slots({0: c,
                                                1: zl.bn2d(c.out_channels)}))

    def forward(self, x):
        y = x
        for i in range(1, self.n + 1):
            seq = getattr(self, f"conv{i}")
            y = zl.bn(zl.conv(y, seq["0"]), seq["1"])
            if i < self.n:
                y = zl.relu6(y)
        return y + x if self.identity else y


class MobileNetZoo(nn.Module):
    """MobileNetV2 (`mobilenet.py`) under `features.{i}` and a GAP
    `classifier` (no Sequential around it)."""

    CONF = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))

    def __init__(self, num_classes: int = 10, width_mult: float = 1.0,
                 stem: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        min_value = 4 if width_mult < 0.1 else 8
        dim_in = zl.make_divisible(32 * width_mult, min_value)
        feats = {0: zl.slots({0: zl.conv2d(3, dim_in, 3, 2 if stem else 1,
                                           1),
                              1: zl.bn2d(dim_in)})}
        idx = 1
        for ci, (t, c, n, s) in enumerate(self.CONF):
            if ci == 1 and not stem:
                s = 1
            dim_out = zl.make_divisible(c * width_mult, min_value)
            for i in range(n):
                feats[idx] = InvertedBlock(dim_in, dim_out,
                                           s if i == 0 else 1, t)
                dim_in = dim_out
                idx += 1
        dim_last = (zl.make_divisible(1280 * width_mult, min_value)
                    if width_mult > 1.0 else 1280)
        feats[idx] = zl.slots({0: zl.conv2d(dim_in, dim_last, 1),
                               1: zl.bn2d(dim_last)})
        self.features = zl.slots(feats)
        self.classifier = zl.GAPBlock(dim_last, num_classes)

    def forward(self, x: torch.Tensor, generators: zl.Generators = None,
                taps: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        x = x.to(self.dtype)
        feats = list(self.features.values())
        for i, f in enumerate(feats):
            if i in (0, len(feats) - 1):
                x = zl.relu6(zl.bn(zl.conv(x, f["0"]), f["1"]))
            else:
                x = f(x)
            zl.tap(taps, x)
        return self.classifier(x)
