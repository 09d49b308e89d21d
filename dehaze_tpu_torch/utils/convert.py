"""Weights for the port: JAX params → torch state_dict, and checkpoint
loading.

`state_dict_from_jax_params` is the inverse of
`dehaze_tpu/utils/convert_torch.py:convert_uformer_state_dict` for both
attention flavors (every token_projection, the SE layer, LeFF and the
plain FFN); `ffa_state_dict_from_jax_params` and
`unet_state_dict_from_jax_params` invert `convert_ffa_state_dict` and
`convert_unet_state_dict`:
  kernel [in, out]          → Linear weight [out, in]
  HWIO [kh, kw, in, out]    → Conv2d weight [out, in, kh, kw]
  HWIO, spatially flipped   → ConvTranspose2d weight [in, out, kh, kw]
  LayerNorm scale/bias      → weight/bias
  fused W-MSA `qkv` [C, 3C] → `to_q` [C, C] + `to_kv` [2C, C]
`zoo_state_dict_from_jax_variables` inverts `convert_zoo_state_dict` for
any zoo model, keyed by the port model's own state_dict names. `load_weights`
also reads the JAX package's `.msgpack` checkpoints through these bridges.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from dehaze_tpu_torch.train.checkpoint import load_jax_checkpoint

# The numpy scalars and dtypes a reference FFA checkpoint pickles beside its
# weights (its PSNR/SSIM history holds np.float64s), allowed past
# `torch.load(weights_only=True)`.
_NUMPY_SAFE = [(getattr(np, "_core", None) or np.core).multiarray.scalar,
               np.dtype] + [
    type(np.dtype(t)) for t in ("float64", "float32", "int64", "int32")]

# The rel-pos index buffer, which every reference checkpoint carries and the
# port computes; and the W-MSA projections and SE layer that the reference's
# ProbSparse model builds but never calls, unused in a ProbSparse checkpoint
# (one holding `attn.ProbSpare.*`) and the whole attention in a W-MSA one.
_BUFFER_KEY_PARTS = (".attn.relative_position_index",)
_PROBSPARSE_UNUSED_KEY_PARTS = (".attn.qkv.", ".attn.proj.",
                                ".attn.se_layer.")


def _t(a) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a, np.float32))


def _lin(sd, key, p):
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:  # absent: qkv_bias=False, the SE layer
        sd[f"{key}.bias"] = _t(p["bias"])


def _conv(sd, key, p):
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{key}.bias"] = _t(p["bias"])


def _deconv(sd, key, p):
    k = np.flip(np.asarray(p["kernel"]), (0, 1))  # [kh, kw, in, out]
    sd[f"{key}.weight"] = _t(k.transpose(2, 3, 0, 1))
    sd[f"{key}.bias"] = _t(p["bias"])


def _ln(sd, key, p):
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])


def _stage(sd, prefix: str, stage: Mapping[str, Any]):
    for name, blk in stage.items():
        j = int(name.split("_")[1])
        b = f"{prefix}.blocks.{j}"
        _ln(sd, f"{b}.norm1", blk["norm1"])
        _ln(sd, f"{b}.norm2", blk["norm2"])
        attn = blk["attn"]
        if "relative_position_bias_table" in attn:
            sd[f"{b}.attn.relative_position_bias_table"] = _t(
                attn["relative_position_bias_table"])
        _attn(sd, f"{b}.attn", attn)
        mlp = blk["mlp"]
        if "fc1" in mlp:  # token_mlp='ffn'
            _lin(sd, f"{b}.mlp.fc1", mlp["fc1"])
            _lin(sd, f"{b}.mlp.fc2", mlp["fc2"])
        else:
            _lin(sd, f"{b}.mlp.linear1.0", mlp["linear1"])
            _conv(sd, f"{b}.mlp.dwconv.0", mlp["dwconv"])
            _lin(sd, f"{b}.mlp.linear2.0", mlp["linear2"])


def _attn(sd, a: str, attn: Mapping[str, Any]):
    """One block's attention params under the prefix `a` (`...attn`)."""
    if "query" in attn:  # ProbSparse
        for jax_name, torch_name in (("query", "query_projection"),
                                     ("key", "key_projection"),
                                     ("value", "value_projection"),
                                     ("out", "out_projection")):
            _lin(sd, f"{a}.ProbSpare.{torch_name}", attn[jax_name])
        return
    if "qkv" in attn:  # 'linear': the JAX package fuses to_q and to_kv
        qkv = attn["qkv"]
        c = np.asarray(qkv["kernel"]).shape[0]
        for name, cols in (("to_q", slice(0, c)), ("to_kv", slice(c, None))):
            _lin(sd, f"{a}.qkv.{name}",
                 {k: np.asarray(v)[..., cols] for k, v in qkv.items()})
    elif "to_qkv" in attn:  # 'linear_concat'
        _lin(sd, f"{a}.qkv.to_qkv", attn["to_qkv"])
        _lin(sd, f"{a}.qkv.to_kv", attn["to_kv"])
    else:  # 'conv'
        for name in ("to_q", "to_k", "to_v"):
            for part in ("depthwise", "pointwise"):
                _conv(sd, f"{a}.qkv.{name}.{part}", attn[name][part])
    _lin(sd, f"{a}.proj", attn["proj"])
    if "se_layer" in attn:
        _lin(sd, f"{a}.se_layer.fc.0", attn["se_layer"]["fc1"])
        _lin(sd, f"{a}.se_layer.fc.2", attn["se_layer"]["fc2"])


def state_dict_from_jax_params(params: Mapping[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (the JAX Uformer params) → torch state_dict
    with the reference's key names."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "input_proj.proj.0", params["input_proj"]["proj"])
    _conv(sd, "output_proj.proj.0", params["output_proj"]["proj"])
    _stage(sd, "conv", params["bottleneck"])
    n_enc = sum(1 for k in params if k.startswith("encoder_"))
    for i in range(n_enc):
        _stage(sd, f"encoderlayer_{i}", params[f"encoder_{i}"])
        _conv(sd, f"dowsample_{i}.conv.0", params[f"downsample_{i}"]["conv"])
        _deconv(sd, f"upsample_{i}.deconv.0",
                params[f"upsample_{i}"]["deconv"])
        _stage(sd, f"decoderlayer_{i}", params[f"decoder_{i}"])
    return sd


def _pa_ca(sd, prefix: str, p: Mapping[str, Any]):
    """A PALayer/CALayer's 1×1 conv pair: `{prefix}.0` and `{prefix}.2`."""
    _conv(sd, f"{prefix}.0", p["conv1"])
    _conv(sd, f"{prefix}.2", p["conv2"])


def ffa_state_dict_from_jax_params(params: Mapping[str, Any]
                                   ) -> Dict[str, torch.Tensor]:
    """The JAX FFA-Net params → torch state_dict with the reference
    FFA.py's key names."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "pre.0", params["pre"])
    for g in (1, 2, 3):
        grp = params[f"g{g}"]
        blocks = sum(1 for k in grp if k.startswith("block_"))
        for i in range(blocks):
            b, p = f"g{g}.gp.{i}", grp[f"block_{i}"]
            _conv(sd, f"{b}.conv1", p["conv1"])
            _conv(sd, f"{b}.conv2", p["conv2"])
            _pa_ca(sd, f"{b}.calayer.ca", p["calayer"])
            _pa_ca(sd, f"{b}.palayer.pa", p["palayer"])
        _conv(sd, f"g{g}.gp.{blocks}", grp["conv"])
    _conv(sd, "ca.1", params["ca_conv1"])
    _conv(sd, "ca.3", params["ca_conv2"])
    _pa_ca(sd, "palayer.pa", params["palayer"])
    _conv(sd, "post.0", params["post1"])
    _conv(sd, "post.1", params["post2"])
    return sd


def unet_state_dict_from_jax_params(params: Mapping[str, Any]
                                    ) -> Dict[str, torch.Tensor]:
    """The JAX UNet params → torch state_dict with the reference's key
    names (the transposed convs in torch's [in, out, kh, kw] layout)."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(1, 10):
        p = params[f"block{i}"]
        _conv(sd, f"ConvBlock{i}.block.0", p["conv1"])
        _conv(sd, f"ConvBlock{i}.block.2", p["conv2"])
        _conv(sd, f"ConvBlock{i}.conv11", p["conv11"])
    for i in range(1, 5):
        _conv(sd, f"pool{i}", params[f"pool{i}"])
    for i in range(6, 10):
        _deconv(sd, f"upv{i}", params[f"up{i}"])
    _conv(sd, "conv10", params["conv10"])
    return sd


def clean_state_dict(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Strip DataParallel `module.` prefixes and drop the rel-pos index
    buffers; in a ProbSparse checkpoint, also the W-MSA projections and SE
    layer that its forward never uses. A W-MSA checkpoint keeps them: they
    are its attention."""
    probsparse = any(".attn.ProbSpare." in k for k in sd)
    drop = _BUFFER_KEY_PARTS + (_PROBSPARSE_UNUSED_KEY_PARTS if probsparse
                                else ())
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if any(part in k for part in drop):
            continue
        out[k] = torch.as_tensor(v)
    return out


def _f32_leaves(tree):
    """A params tree with its bfloat16 tensor leaves as float32 numpy
    arrays (exact), so the bridges' numpy transposes take them."""
    if isinstance(tree, Mapping):
        return {k: _f32_leaves(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


_JAX_BRIDGES = {"ffa": ffa_state_dict_from_jax_params,
                "unet": unet_state_dict_from_jax_params}


def load_weights(path: str, arch: str = "uformer"
                 ) -> Dict[str, torch.Tensor]:
    """Read a checkpoint of `arch` for `load_state_dict`: a `.pth`, `.pt`
    or `.pk` in the reference's formats, `{'state_dict': ...}` (the
    Uformer's and the UNet's) or `{'model': ...}` (FFA-Net's `.pk`, as
    `cli.ffa_train` writes it), or a bare state_dict; or a `.msgpack` the
    JAX package wrote (its trainers' `epoch_model_{e}`/`model_best`, or
    `ffa_best`), whose params go through the arch's bridge."""
    if path.endswith(".msgpack"):
        params = load_jax_checkpoint(path)["params"]
        if isinstance(params.get("params"), Mapping):  # a variables tree
            params = params["params"]
        bridge = _JAX_BRIDGES.get(arch, state_dict_from_jax_params)
        return bridge(_f32_leaves(params))
    with torch.serialization.safe_globals(_NUMPY_SAFE):
        payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, Mapping):
        raise ValueError(f"{path}: not a state_dict checkpoint")
    key = "model" if arch == "ffa" else "state_dict"
    return clean_state_dict(payload.get(key, payload))


def _flat(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}_{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


def zoo_state_dict_from_jax_variables(variables: Mapping[str, Any],
                                      model: torch.nn.Module
                                      ) -> Dict[str, torch.Tensor]:
    """A JAX zoo model's variables ({'params': ..., 'batch_stats': ...})
    → the state_dict of the port's `model` (the inverse of
    `dehaze_tpu/utils/convert_torch.py:convert_zoo_state_dict`). The JAX
    names are the torch names with "." → "_", which cannot be undone, so
    each of the model's own names looks up its JAX leaf:
      weight, 4-D   ← HWIO kernel [kh, kw, in/g, out] → [out, in/g, kh, kw]
      weight, 3-D   ← token-mix kernel [N, out] → Conv1d [out, N, 1]
      weight, 2-D   ← Dense kernel [in, out] → [out, in]
      weight, 1-D   ← LayerNorm/BatchNorm scale
      bias          ← bias
      running_mean/var ← batch_stats mean/var
      num_batches_tracked = 0
      anything else (cls_token, pos_embedding) ← the leaf of its name.
    Raises if a tensor of the model has no JAX leaf, if a shape differs,
    or if a JAX leaf is left unused."""
    flat = {}
    for col, tree in variables.items():
        for k, v in _flat(tree).items():
            if k in flat:
                raise KeyError(f"JAX leaf name collision: {k}")
            flat[k] = v
    sd: Dict[str, torch.Tensor] = {}
    used = set()
    for name, want in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            sd[name] = torch.zeros_like(want, device="cpu")
            continue
        prefix, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        joined = prefix.replace(".", "_")
        key = {"weight": f"{joined}_kernel" if want.ndim > 1
               else f"{joined}_scale", "bias": f"{joined}_bias",
               "running_mean": f"{joined}_mean",
               "running_var": f"{joined}_var"}.get(
                   leaf, name.replace(".", "_"))
        if key not in flat:
            raise KeyError(f"{name}: no JAX leaf {key!r}")
        a = flat[key]
        t = (a.float() if isinstance(a, torch.Tensor)
             else torch.from_numpy(np.array(a, np.float32)))
        if leaf == "weight" and want.ndim == 4:
            t = t.permute(3, 2, 0, 1)
        elif leaf == "weight" and want.ndim == 3:
            t = t.T[:, :, None]
        elif leaf == "weight" and want.ndim == 2:
            t = t.T
        if tuple(t.shape) != tuple(want.shape):
            raise ValueError(f"{name}: shape {tuple(want.shape)}, JAX leaf "
                             f"{key} gives {tuple(t.shape)}")
        sd[name] = t.contiguous().to(want.dtype)
        used.add(key)
    unused = sorted(set(flat) - used)
    if unused:
        raise KeyError(f"JAX leaves with no tensor in the model: "
                       f"{unused[:10]}{' ...' if len(unused) > 10 else ''}")
    return sd
