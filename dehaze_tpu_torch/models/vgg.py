"""VGG19 / VGG16 feature extractors for the contrastive and perceptual losses.

Counterpart of `dehaze_tpu/models/vgg.py`, built by hand (torchvision is not
installed). VGG19 is cut into the CR loss's five slices at torchvision
`features` indices [0, 2), [2, 7), [7, 12), [12, 21), [21, 30); VGG16 into
the perceptual loss's [0, 4), [4, 9), [9, 16). Inputs are unnormalised
NHWC images in [0, 1], as the reference feeds them; features come back
NHWC (views of the NCHW convolution outputs) in the activation dtype.

Weights: `load_params_npz` reads torchvision-converted weights (keys
`features.{i}.weight` OIHW and `features.{i}.bias`), used as they are by
`conv2d`. Without them the extractor is a fixed-seed random VGG and
`warn_random_vgg` says so. The weights are frozen.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# torchvision VGG feature-layer specs: (out_channels | 'M' for maxpool)
_VGG19_LAYERS = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
                 512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
_VGG16_LAYERS = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                 512, 512, 512, "M", 512, 512, 512, "M"]

VGG19_CR_SLICES = ((0, 2), (2, 7), (7, 12), (12, 21), (21, 30))
VGG16_PERCEPTUAL_SLICES = ((0, 4), (4, 9), (9, 16))


def _features_index_map(layers) -> List[Tuple[str, int]]:
    """torchvision `features` flat index -> ('conv', i) | ('relu' | 'pool',
    -1)."""
    ops = []
    conv_i = 0
    for l in layers:
        if l == "M":
            ops.append(("pool", -1))
        else:
            ops.append(("conv", conv_i))
            ops.append(("relu", -1))
            conv_i += 1
    return ops


class VGGFeatures(nn.Module):
    """The VGG conv stack up to the last slice boundary; forward returns the
    activations at each boundary. `convs[i]` is the i-th conv layer."""

    def __init__(self, arch: str = "vgg19",
                 slices: Sequence[Tuple[int, int]] = VGG19_CR_SLICES,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.arch = arch
        self.slices = tuple(slices)
        self.dtype = dtype
        layers = _VGG19_LAYERS if arch == "vgg19" else _VGG16_LAYERS
        self.ops = _features_index_map(layers)[:max(e for _, e in slices)]
        widths = [l for l in layers if l != "M"]
        n_conv = sum(op == "conv" for op, _ in self.ops)
        in_ch = [3] + widths[:n_conv - 1]
        self.convs = nn.ModuleList([
            nn.Conv2d(i, o, 3, padding=1, device=device)
            for i, o in zip(in_ch, widths[:n_conv])])
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        boundaries = {e for _, e in self.slices}
        y = x.to(self.dtype).permute(0, 3, 1, 2)
        outs = []
        for i, (op, conv_i) in enumerate(self.ops):
            if op == "conv":
                c = self.convs[conv_i]
                y = F.conv2d(y, c.weight.to(self.dtype),
                             c.bias.to(self.dtype), padding=1)
            elif op == "relu":
                y = F.relu(y)
            else:
                y = F.max_pool2d(y, 2, 2)
            if i + 1 in boundaries:
                outs.append(y.permute(0, 2, 3, 1))
        return outs


def make_cr_vgg(dtype=torch.float32, device=None) -> VGGFeatures:
    """VGG19 with the five CR slice boundaries."""
    return VGGFeatures("vgg19", VGG19_CR_SLICES, dtype, device)


def make_perceptual_vgg(dtype=torch.float32, device=None) -> VGGFeatures:
    """VGG16 with the three perceptual-loss boundaries."""
    return VGGFeatures("vgg16", VGG16_PERCEPTUAL_SLICES, dtype, device)


def warn_random_vgg(where: str) -> None:
    """Loud warning for the random-VGG stand-in: the reference trains its
    CR and perceptual losses against torchvision's pretrained VGG; a
    fixed-seed random VGG is a valid random-projection regularizer but not
    the published recipe, so losses and PSNR differ from the paper's."""
    warnings.warn(
        f"{where}: no --vgg_weights given — falling back to a FIXED-SEED "
        "RANDOM VGG feature extractor. This differs from the reference's "
        "pretrained-VGG loss; pass converted torchvision weights (.npz, "
        "keys features.{i}.weight/.bias) for parity.",
        UserWarning, stacklevel=3)


def init_vgg_params(model: VGGFeatures, seed: int = 0) -> VGGFeatures:
    """Deterministic init from `seed`: LeCun-normal kernels (truncated at
    two standard deviations, as flax's default conv init), zero biases."""
    gen = torch.Generator().manual_seed(seed)
    for c in model.convs:
        fan_in = c.weight[0].numel()
        std = (1.0 / fan_in) ** 0.5 / .87962566103423978
        w = torch.empty(c.weight.shape)
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
        with torch.no_grad():
            c.weight.copy_(w)
            c.bias.zero_()
    return model


def synthesize_torchvision_state_dict(arch: str = "vgg19", seed: int = 0
                                      ) -> Dict[str, torch.Tensor]:
    """A torchvision-`features`-format state_dict (`{flat}.weight` OIHW,
    `{flat}.bias`) with Kaiming-normal random weights, so the `.npz`
    loading path can be exercised without torchvision."""
    layers = _VGG19_LAYERS if arch == "vgg19" else _VGG16_LAYERS
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    in_ch, flat = 3, 0
    for l in layers:
        if l == "M":
            flat += 1
            continue
        w = torch.empty(l, in_ch, 3, 3)
        nn.init.kaiming_normal_(w, generator=gen)
        sd[f"{flat}.weight"] = w
        sd[f"{flat}.bias"] = torch.zeros(l)
        in_ch = l
        flat += 2  # conv + relu
    return sd


def load_params_npz(model: VGGFeatures, path: str) -> VGGFeatures:
    """Load torchvision-converted weights from an .npz with keys
    `features.{flat}.weight` (OIHW) / `features.{flat}.bias`; convs whose
    keys are missing keep their values."""
    raw = np.load(path)
    with torch.no_grad():
        for flat, (op, conv_i) in enumerate(model.ops):
            wk, bk = f"features.{flat}.weight", f"features.{flat}.bias"
            if op != "conv" or wk not in raw:
                continue
            c = model.convs[conv_i]
            c.weight.copy_(torch.from_numpy(raw[wk]))
            c.bias.copy_(torch.from_numpy(raw[bk]))
    return model
