"""The zoo's model registry (counterpart of `dehaze_tpu/zoo/registry.py`).

`get_model` takes every name of the reference's registry, with its
aliases ("resnet_18" is "resnet_dnn_18"), and the families the reference
ships as modules without registering them (swin, convit, alternet,
mobilenet), by the name grammar

    <family>[_dnn|_mcdo][_smoothing][_<depth or size>]

and returns the port's `nn.Module` on `device`, stamped with its
`registry_name`. Block kwargs that a family's constructor does not take
are dropped, as the JAX registry's `_filter` drops them.
"""

from __future__ import annotations

import contextlib
import inspect

import torch

from dehaze_tpu_torch.zoo.convnets import (AlexNetZoo, MobileNetZoo,
                                           ResNetZoo, VGGZoo)
from dehaze_tpu_torch.zoo.transformers import (AlterNetZoo, ConViTZoo,
                                               MixerZoo, PiTZoo, SwinZoo,
                                               ViTZoo)

_RESNET_DEPTHS = {
    "18": ("basic", (2, 2, 2, 2)),
    "34": ("basic", (3, 4, 6, 3)),
    "50": ("bottleneck", (3, 4, 6, 3)),
    "101": ("bottleneck", (3, 4, 23, 3)),
    "152": ("bottleneck", (3, 8, 36, 3)),
}

_VGG_BLOCKS = {
    "11": (1, 1, 2, 2, 2),
    "13": (2, 2, 2, 2, 2),
    "16": (2, 2, 3, 3, 3),
    "19": (2, 2, 4, 4, 4),
}

_VIT = {  # depth, dim, heads, dim_head, dim_mlp
    "ti": (12, 192, 3, 64, 768),
    "s": (12, 384, 6, 64, 1536),
    "b": (12, 768, 12, 64, 3072),
    "l": (24, 1024, 16, 64, 4096),
    "h": (32, 1280, 16, 80, 5120),
}

_PIT = {  # dims, depths, heads, dims_head, dims_mlp, stride
    "ti": ((64, 128, 256), (2, 6, 4), (2, 4, 8), (32, 32, 32),
           (256, 512, 1024), 8),
    "xs": ((96, 192, 384), (2, 6, 4), (2, 4, 8), (48, 48, 48),
           (384, 768, 1024), 8),
    "s": ((144, 288, 576), (2, 6, 4), (3, 6, 12), (48, 48, 48),
         (576, 1152, 2304), 8),
    "b": ((256, 512, 1024), (3, 6, 4), (4, 8, 16), (64, 64, 64),
         (256, 512, 1024), 7),
}

_MIXER = {  # depth, hidden, spatial, channel
    "ti": (8, 256, 128, 1024),
    "s": (8, 512, 256, 2048),
    "b": (12, 768, 384, 3072),
    "l": (24, 1024, 512, 4096),
    "h": (32, 1280, 640, 5120),
}

_SWIN = {  # dims, depths, heads, dims_mlp
    "t": ((96, 192, 384, 768), (2, 2, 6, 2), (3, 6, 12, 24),
          (384, 768, 1536, 3072)),
    "s": ((96, 192, 384, 768), (2, 2, 18, 2), (3, 6, 12, 24),
          (384, 768, 1536, 3072)),
    "b": ((128, 256, 512, 1024), (2, 2, 18, 2), (4, 8, 16, 32),
          (512, 1024, 2048, 4096)),
    "l": ((192, 384, 768, 1536), (2, 2, 6, 2), (3, 6, 12, 24),
          (768, 1536, 3072, 6144)),
}

_CONVIT = _VIT  # the ViT size grid

_ALTERNET = {  # block, num_blocks, num_blocks2
    "18": ("basic", (2, 2, 2, 2), (0, 1, 1, 1)),
    "34": ("basic", (3, 4, 6, 4), (0, 1, 3, 2)),
    "50": ("bottleneck", (3, 4, 6, 4), (0, 1, 3, 2)),
    "101": ("bottleneck", (3, 4, 23, 4), (0, 1, 3, 2)),
    "152": ("bottleneck", (3, 8, 36, 4), (0, 1, 3, 2)),
}

_RESNET_FAMILIES = {
    # family: (style, gate, default cblock, {depth: (groups, width_per_group)})
    "resnet": ("post", None, "gap", None),
    "preresnet": ("pre", None, "bngap", None),
    "seresnet": ("post", "se", "gap", None),
    "cbamresnet": ("post", "cbam", "gap", None),
    "resnext": ("post", None, "gap", {"50": (32, 4), "101": (32, 8)}),
    "wideresnet": ("post", None, "gap", {"50": (1, 128), "101": (1, 128)}),
}

_MC_RATE = 0.3  # the reference's mcdo blocks' default


def _filter(kwargs: dict, module_cls) -> dict:
    fields = set(inspect.signature(module_cls.__init__).parameters)
    return {k: v for k, v in kwargs.items() if k in fields}


def get_model(name: str, num_classes: int = 10, stem: bool = False,
              dtype: torch.dtype = torch.float32, device=None,
              **block_kwargs) -> torch.nn.Module:
    """The zoo model `name` (≙ the reference's `models.get_model(name,
    num_classes, stem, **block_kwargs)`), its parameters on `device`
    (torch's default device when None; "meta" allocates nothing). An
    unknown name raises NotImplementedError; "Uformer_Informer" a
    ValueError that points at the dehazing models."""
    with torch.device(device) if device is not None else \
            contextlib.nullcontext():
        try:
            model = _get_model(name, num_classes, stem, dtype,
                               **block_kwargs)
        except (KeyError, IndexError) as e:
            raise NotImplementedError(
                f"unknown model name {name!r} ({e!r})") from e
    model.registry_name = name
    return model


def _get_model(name, num_classes, stem, dtype, **block_kwargs):
    parts = name.split("_")
    family = parts[0]

    if name == "Uformer_Informer":
        raise ValueError(
            "the dehazing model lives in dehaze_tpu_torch.models.get_arch — "
            "the reference registry silently returns None for this name")

    if family in _RESNET_FAMILIES:
        style, gate, cblock, special = _RESNET_FAMILIES[family]
        variant, smoothing, depth = _parse_variant(parts[1:])
        block, num_blocks = _RESNET_DEPTHS[depth]
        groups, wpg = (special or {}).get(depth, (1, 64))
        if special and depth not in special:
            raise ValueError(f"{family} has no depth {depth}")
        return ResNetZoo(
            block=block, num_blocks=num_blocks, style=style, gate=gate,
            mc_rate=_MC_RATE if variant == "mcdo" else 0.0,
            num_sblocks=(1, 1, 1, 1) if smoothing else (0, 0, 0, 0),
            cblock=cblock, num_classes=num_classes, stem=stem, groups=groups,
            width_per_group=wpg, dtype=dtype,
            **_filter(block_kwargs, ResNetZoo))

    if family in ("vgg", "prevgg"):
        variant, smoothing, depth = _parse_variant(parts[1:])
        return VGGZoo(
            num_blocks=_VGG_BLOCKS[depth], pre=family == "prevgg",
            mc_rate=_MC_RATE if variant == "mcdo" else 0.0,
            num_sblocks=(1, 1, 1, 1, 1) if smoothing else (0,) * 5,
            num_classes=num_classes, dtype=dtype,
            **_filter(block_kwargs, VGGZoo))

    if family == "alexnet":
        variant, smoothing, _ = _parse_variant(parts[1:], depth_optional=True)
        return AlexNetZoo(
            mc_rate=_MC_RATE if variant == "mcdo" else 0.0,
            num_sblocks=(1, 1, 1) if smoothing else (0, 0, 0),
            num_classes=num_classes, stem=stem, dtype=dtype,
            **_filter(block_kwargs, AlexNetZoo))

    if family == "mobilenet":
        return MobileNetZoo(num_classes=num_classes, stem=stem, dtype=dtype,
                            **_filter(block_kwargs, MobileNetZoo))

    if family == "vit":
        depth, dim, heads, dim_head, dim_mlp = _VIT[parts[1]]
        return ViTZoo(num_classes=num_classes, depth=depth, dim=dim,
                      heads=heads, dim_head=dim_head, dim_mlp=dim_mlp,
                      dtype=dtype, **_filter(block_kwargs, ViTZoo))

    if family == "pit":
        dims, depths, heads, dims_head, dims_mlp, stride = _PIT[parts[1]]
        kw = _filter(block_kwargs, PiTZoo)
        kw.setdefault("stride", stride)
        return PiTZoo(num_classes=num_classes, dims=dims, depths=depths,
                      heads=heads, dims_head=dims_head, dims_mlp=dims_mlp,
                      dtype=dtype, **kw)

    if family == "mixer":
        depth, hidden, spatial, channel = _MIXER[parts[1]]
        return MixerZoo(num_classes=num_classes, depth=depth,
                        hidden_dim=hidden, spatial_dim=spatial,
                        channel_dim=channel, dtype=dtype,
                        **_filter(block_kwargs, MixerZoo))

    if family == "swin":
        dims, depths, heads, dims_mlp = _SWIN[parts[1]]
        return SwinZoo(num_classes=num_classes, dims=dims, depths=depths,
                       heads=heads, dims_mlp=dims_mlp, dtype=dtype,
                       **_filter(block_kwargs, SwinZoo))

    if family == "convit":
        depth, dim, heads, dim_head, dim_mlp = _CONVIT[parts[1]]
        return ConViTZoo(num_classes=num_classes, depth=depth, dim=dim,
                         heads=heads, dim_head=dim_head, dim_mlp=dim_mlp,
                         dtype=dtype, **_filter(block_kwargs, ConViTZoo))

    if family == "alternet":
        block, num_blocks, num_blocks2 = _ALTERNET[parts[-1]]
        return AlterNetZoo(num_blocks=num_blocks, num_blocks2=num_blocks2,
                           heads=(3, 6, 12, 24), block=block,
                           num_classes=num_classes, stem=stem, dtype=dtype,
                           **_filter(block_kwargs, AlterNetZoo))

    raise NotImplementedError(f"unknown model name {name!r}")


def _parse_variant(parts, depth_optional: bool = False):
    """Parse [dnn|mcdo][_smoothing][_depth] name tails; a bare depth (or
    nothing) aliases the dnn variant."""
    parts = list(parts)
    variant = "dnn"
    if parts and parts[0] in ("dnn", "mcdo"):
        variant = parts.pop(0)
    smoothing = bool(parts) and parts[0] == "smoothing"
    if smoothing:
        parts.pop(0)
    if not parts:
        if depth_optional:
            return variant, smoothing, None
        raise NotImplementedError("missing depth suffix")
    return variant, smoothing, parts[0]


def list_models():
    """Every name `get_model` takes, aliases included."""
    variants = ("dnn", "mcdo", "dnn_smoothing", "mcdo_smoothing")
    names = []
    for fam in ("resnet", "preresnet", "seresnet", "cbamresnet"):
        for d in ("18", "34", "50", "101", "152"):
            names += [f"{fam}_{v}_{d}" for v in variants] + [f"{fam}_{d}"]
    for fam in ("resnext", "wideresnet"):
        for d in ("50", "101"):
            names += [f"{fam}_{v}_{d}" for v in variants] + [f"{fam}_{d}"]
    for fam in ("vgg", "prevgg"):
        for d in ("11", "13", "16", "19"):
            names += [f"{fam}_{v}_{d}" for v in variants] + [f"{fam}_{d}"]
    names += [f"alexnet_{v}" for v in variants] + ["alexnet", "mobilenet"]
    names += [f"vit_{s}" for s in _VIT]
    names += [f"pit_{s}" for s in _PIT]
    names += [f"mixer_{s}" for s in _MIXER]
    names += [f"swin_{s}" for s in _SWIN]
    names += [f"convit_{s}" for s in _CONVIT]
    names += [f"alternet_{d}" for d in _ALTERNET]
    return names
