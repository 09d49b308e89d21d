"""Uformer with window attention (counterpart of
`dehaze_tpu/models/uformer.py`), both flavors:

- ``attention='probsparse'``: ProbSparse attention in each window through
  kernel K1 (the reference's active `My_model_1.py` model);
- ``attention='full'``: W-MSA, one softmax over each window in plain torch
  (`ops.probsparse.full_window_attention`; the JAX package has no TPU
  kernel for it either), with the q/k/v projection named by
  `token_projection` ('linear', 'conv', 'linear_concat') and an optional
  squeeze-excite gate (`se_layer`): the reference's `My_model.py`.

The feed-forward part is LeFF (`token_mlp='leff'`, kernel K2 at eval) or
the plain FFN (`'ffn'`), under either flavor.

InputProj → 4 encoder stages (depth × LeWin block, then a 4×4/s2 conv that
doubles C) → bottleneck stage → 4 decoder stages (2×2/s2 transposed conv that
halves C, skip concat, depth × LeWin block) → OutputProj(2C→3) → global
residual x + y. NHWC throughout; parameters float32, activations in
`cfg.dtype`.

Module names follow the reference torch model's state_dict
(`encoderlayer_{i}`, `dowsample_{i}`, `conv` for the bottleneck,
`upsample_{i}`, `decoderlayer_{i}`, `attn.ProbSpare.*_projection`,
`attn.qkv.*`, `attn.proj`, `attn.se_layer.fc.*`, `mlp.fc1`), which
`dehaze_tpu/utils/convert_torch.py` reads.

ProbSparse key sampling draws from the `generator` passed to forward: each
ProbSparse layer draws its [N, U_part] table in module order, so a forward
with a freshly seeded generator is deterministic. Serving re-seeds it per
forward; training lets it advance from step to step. A forward given
`sample_tables` (one table per ProbSparse layer, in module order) draws
nothing and uses those: `draw_sample_tables` draws the list a forward with
a generator would, so the two compute the same. An exported artifact
(`infer.export`) folds such a list in; a W-MSA model has none and ignores
the generator. In train mode, DropPath and dropout draw their masks from
the `droppath` and `dropout_gen` generators (none is needed at rate 0),
never from torch's global RNG.

A forward given `bands` (`parallel.halo.Bands`) runs on this process's
row band of a canvas whose other bands run on the other ranks of the
process group, as the JAX model runs under `band_axis`: the convs take
their neighbours' rows, the SW-MSA roll rotates rows across the band ring,
the region ids and the padding flags are the global canvas's, sliced to
the band's rows, and LeFF runs unfused (K2's zero halo is the canvas
edge's). The sample tables are [N, u] and shared by every window, so each
band draws the tables of the whole canvas.

With `cfg.remat`, each LeWin block runs under `torch.utils.checkpoint`
when grad is on, and its activations are recomputed in the backward pass.
The recompute replays the block's draws from the generators (its sample
tables, DropPath and dropout masks), which `preserve_rng_state` alone
would not: that restores torch's global RNG only.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dehaze_tpu_torch.config import ModelConfig
from dehaze_tpu_torch.models.layers import (DropPath, InputProj, LeFF, Mlp,
                                            OutputProj, Downsample, SELayer,
                                            SepConv2d, Upsample, cast,
                                            dropout, layer_norm)
from dehaze_tpu_torch.ops import actstore
from dehaze_tpu_torch.ops import probsparse as ps_ops
from dehaze_tpu_torch.ops import window as win_ops
from dehaze_tpu_torch.ops.kernels.window_attention import (
    fused_window_attention)
from dehaze_tpu_torch.parallel import halo


@win_ops.device_constant_cache
def _region_ids(H: int, W: int, win: int, shift: int,
                device: torch.device) -> torch.Tensor:
    """SW-MSA region ids [nW, N] as an int32 tensor on `device`."""
    return torch.from_numpy(win_ops.shift_region_ids(H, W, win, shift)).to(
        device)


@win_ops.device_constant_cache
def _legacy_nearest(n_in: int, n_out: int,
                    device: torch.device) -> torch.Tensor:
    """torch F.interpolate's LEGACY nearest source indices for resizing
    n_in to n_out, floor(dst · n_in / n_out), computed in float64 as the
    JAX model does (`models/uformer.py:325-330`); F.interpolate's float32
    scale can pick other rows. int64 on `device`."""
    idx = np.minimum((np.arange(n_out) * (n_in / n_out)).astype(np.int32),
                     n_in - 1)
    with torch.inference_mode(False):  # cached: usable outside it too
        return torch.from_numpy(idx.astype(np.int64)).to(device)


def pad_flags(pad_mask: torch.Tensor, H: int, W: int, win: int,
              bands: Optional[halo.Bands] = None) -> torch.Tensor:
    """The full-resolution padding mask [1, X, X', 1] (1 on padding) resized
    to a stage's H × W with legacy nearest indices and windowed: [nW, N]
    flags. Built from unshifted coordinates even for shifted blocks, as the
    reference does. On a band (H its rows), the mask of the whole canvas is
    resized to the stage's global height and the band's rows kept."""
    dev = pad_mask.device
    n = 1 if bands is None else bands.count
    pm = halo.band_rows(
        pad_mask[:, _legacy_nearest(pad_mask.shape[1], H * n, dev)], bands)
    pm = pm[:, :, _legacy_nearest(pad_mask.shape[2], W, dev)]
    return win_ops.window_partition(pm, win)[..., 0]


def _linear(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, cast(m.weight, x),
                    None if m.bias is None else cast(m.bias, x))


class AttentionLayer(nn.Module):
    """The q/k/v/out projections of the reference's ProbSparse
    AttentionLayer (state_dict `attn.ProbSpare.*_projection`)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.query_projection = nn.Linear(dim, dim, device=device)
        self.key_projection = nn.Linear(dim, dim, device=device)
        self.value_projection = nn.Linear(dim, dim, device=device)
        self.out_projection = nn.Linear(dim, dim, device=device)


class WindowAttention(nn.Module):
    """ProbSparse window attention with relative-position bias, through
    kernel K1 (`ops.kernels.window_attention.fused_window_attention`)."""

    def __init__(self, dim: int, win_size: int, num_heads: int,
                 factor: int = 5, use_rel_pos_bias: bool = True,
                 device=None):
        super().__init__()
        self.win_size = win_size
        self.num_heads = num_heads
        self.factor = factor
        self.relative_position_bias_table = None
        if use_rel_pos_bias:
            self.relative_position_bias_table = nn.Parameter(torch.empty(
                (2 * win_size - 1) ** 2, num_heads, device=device))
        self.ProbSpare = AttentionLayer(dim, device=device)

    def sample_shape(self):
        """(N, U_part) of the table a forward draws: N = win²."""
        n = self.win_size * self.win_size
        return n, ps_ops.probsparse_u(n, self.factor)

    def forward(self, x: torch.Tensor, sw_region: Optional[torch.Tensor],
                generator: Optional[torch.Generator],
                pad_flag: Optional[torch.Tensor] = None,
                sample_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sample_idx: this layer's [N, U_part] table, or None to draw it
        from `generator`."""
        n = x.shape[1]
        p = self.ProbSpare
        q = _linear(p.query_projection, x)
        k = _linear(p.key_projection, x)
        v = _linear(p.value_projection, x)
        if sample_idx is None:
            u_part = ps_ops.probsparse_u(n, self.factor)
            sample_idx = ps_ops.sample_indices(n, n, u_part, generator)
        bias = None
        if self.relative_position_bias_table is not None:
            bias = win_ops.gather_rel_pos_bias(
                self.relative_position_bias_table, self.win_size,
                self.win_size)
        masks = [t for t in (sw_region, pad_flag) if t is not None]
        out = fused_window_attention(
            q, k, v, num_heads=self.num_heads, sample_idx=sample_idx,
            rel_pos_bias=bias, sw_region=sw_region, pad_flag=pad_flag,
            num_windows=masks[0].shape[0] if masks else 1,
            factor=self.factor)
        return _linear(p.out_projection, out)


class QKVProjection(nn.Module):
    """The W-MSA q/k/v projection (state_dict `attn.qkv.*`), by
    token_projection, as the reference builds it:
    'linear' `to_q` [C→C] + `to_kv` [C→2C] (LinearProjection);
    'linear_concat' `to_qkv` [C→3C] + `to_kv` [C→2C], k and v the 2N-token
    concat of the two (LinearProjection_Concat_kv);
    'conv' `to_q`, `to_k`, `to_v`, each a 3×3 SepConv2d over the window as
    a √N × √N tile with zero padding (ConvProjection)."""

    def __init__(self, dim: int, token_projection: str, bias: bool = True,
                 device=None):
        super().__init__()
        self.kind = token_projection
        if token_projection == "conv":
            self.to_q, self.to_k, self.to_v = (
                SepConv2d(dim, dim, 3, device=device) for _ in range(3))
            return
        if token_projection == "linear_concat":
            self.to_qkv = nn.Linear(dim, 3 * dim, bias=bias, device=device)
        else:
            self.to_q = nn.Linear(dim, dim, bias=bias, device=device)
        self.to_kv = nn.Linear(dim, 2 * dim, bias=bias, device=device)

    def forward(self, x: torch.Tensor, heads: int):
        """x [B_, N, C] → q [B_, N, h, d] and k, v [B_, M, h, d] (M = 2N
        for 'linear_concat', else N)."""
        b, n, c = x.shape
        d = c // heads
        if self.kind == "conv":
            side = math.isqrt(n)
            tile = x.reshape(b, side, side, c)
            return tuple(m(tile).reshape(b, n, heads, d)
                         for m in (self.to_q, self.to_k, self.to_v))
        kv = _linear(self.to_kv, x).reshape(b, n, 2, heads, d)
        if self.kind == "linear_concat":
            qkv = _linear(self.to_qkv, x).reshape(b, n, 3, heads, d)
            return (qkv[:, :, 0],
                    torch.cat([qkv[:, :, 1], kv[:, :, 0]], dim=1),
                    torch.cat([qkv[:, :, 2], kv[:, :, 1]], dim=1))
        q = _linear(self.to_q, x).reshape(b, n, heads, d)
        return q, kv[:, :, 0], kv[:, :, 1]


class FullWindowAttention(nn.Module):
    """W-MSA with relative-position bias (`attention='full'`): the
    projection of `token_projection` (`QKVProjection`), single-softmax
    attention in plain torch (`ops.probsparse.full_window_attention`), the
    output Linear `proj`, then the squeeze-excite gate `se_layer` if
    asked."""

    def __init__(self, dim: int, win_size: int, num_heads: int,
                 token_projection: str = "linear", qkv_bias: bool = True,
                 se_layer: bool = False, use_rel_pos_bias: bool = True,
                 device=None):
        super().__init__()
        self.win_size = win_size
        self.num_heads = num_heads
        self.relative_position_bias_table = None
        if use_rel_pos_bias:
            self.relative_position_bias_table = nn.Parameter(torch.empty(
                (2 * win_size - 1) ** 2, num_heads, device=device))
        self.qkv = QKVProjection(dim, token_projection, qkv_bias,
                                 device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        self.se_layer = SELayer(dim, device=device) if se_layer else None

    def forward(self, x: torch.Tensor, sw_region: Optional[torch.Tensor],
                pad_flag: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, c = x.shape
        q, k, v = self.qkv(x, self.num_heads)
        bias = None
        if self.relative_position_bias_table is not None:
            bias = win_ops.gather_rel_pos_bias(
                self.relative_position_bias_table, self.win_size,
                self.win_size)
        out = ps_ops.full_window_attention(
            q, k, v, rel_pos_bias=bias, sw_region=sw_region,
            pad_flag=pad_flag, layout="bnhd")
        out = _linear(self.proj, out.reshape(b, n, c))
        return out if self.se_layer is None else self.se_layer(out)


class LeWinBlock(nn.Module):
    """x + WinAttn(LN(x), shift); then x + LeFF(LN(x)) or x + Mlp(LN(x)).
    WinAttn is `WindowAttention` (ProbSparse, K1) or `FullWindowAttention`
    (W-MSA) by `attention`; the feed-forward part LeFF or Mlp by
    `token_mlp`.

    Window and shift collapse (win = resolution, shift 0) when the
    CONFIGURED stage resolution is not bigger than the window, so the
    parameters do not depend on the runtime geometry; the runtime H and W
    must be multiples of the (collapsed) window.

    `act_store` ('fp8', 'int8' or None) round-trips six tensors through
    `ops.actstore.compress` when not training, as the JAX block does when
    deterministic: norm1's output, the attention's output (after the
    unshift, before the residual), and norm2's output, the hidden after
    each GELU and the output of LeFF (`LeFF`; inside K2 at eval), or
    norm2's and the output of the plain FFN."""

    def __init__(self, dim: int, input_resolution: int, num_heads: int,
                 win_size: int = 8, shift_size: int = 0,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 factor: int = 5, use_rel_pos_bias: bool = True,
                 fast_gelu: bool = False, attention: str = "probsparse",
                 token_projection: str = "linear", token_mlp: str = "leff",
                 se_layer: bool = False, qkv_bias: bool = True,
                 drop: float = 0.0, act_store: Optional[str] = None,
                 device=None):
        super().__init__()
        actstore.mode_code(act_store)  # refuses an unknown mode
        self.act_store = act_store
        self.win = win_size
        self.shift = shift_size
        if input_resolution <= win_size:
            self.win = input_resolution
            self.shift = 0
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, device=device)
        if attention == "full":
            self.attn = FullWindowAttention(
                dim, self.win, num_heads, token_projection, qkv_bias,
                se_layer, use_rel_pos_bias, device=device)
        else:
            self.attn = WindowAttention(dim, self.win, num_heads, factor,
                                        use_rel_pos_bias, device=device)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, device=device)
        hidden = int(dim * mlp_ratio)
        if token_mlp == "leff":
            self.mlp = LeFF(dim, hidden, fast_gelu=fast_gelu, device=device)
        else:
            self.mlp = Mlp(dim, hidden, drop, fast_gelu, device=device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                droppath: Optional[torch.Generator] = None,
                pad_mask: Optional[torch.Tensor] = None,
                sample_idx: Optional[torch.Tensor] = None,
                dropout_gen: Optional[torch.Generator] = None,
                bands: Optional[halo.Bands] = None) -> torch.Tensor:
        B, H, W, C = x.shape
        win, shift = self.win, self.shift
        if H % win or W % win:
            raise ValueError(f"feature map {H}x{W} not divisible by window "
                             f"{win}; pad the input to a multiple of "
                             "win*2^4 (see infer.tiled)")
        mode = None if self.training else self.act_store
        y = actstore.compress(layer_norm(x, self.norm1), mode)
        sw_region = None
        if shift > 0 and bands is None:
            y = win_ops.cyclic_shift(y, shift)
            sw_region = _region_ids(H, W, win, shift, x.device)
        elif shift > 0:  # the global window grid's ids, the band's windows
            y = halo.cyclic_shift_banded(y, shift, bands)
            per_band = (H // win) * (W // win)
            sw_region = _region_ids(H * bands.count, W, win, shift, x.device)[
                bands.index * per_band:(bands.index + 1) * per_band]
        pad_flag = (None if pad_mask is None
                    else pad_flags(pad_mask, H, W, win, bands))
        y = win_ops.window_partition(y, win)
        if isinstance(self.attn, WindowAttention):
            y = self.attn(y, sw_region, generator, pad_flag, sample_idx)
        else:
            y = self.attn(y, sw_region, pad_flag)
        y = win_ops.window_reverse(y, win, H, W)
        if shift > 0:
            y = (win_ops.cyclic_unshift(y, shift) if bands is None
                 else halo.cyclic_unshift_banded(y, shift, bands))
        x = x + self.drop_path(actstore.compress(y, mode), droppath)
        if isinstance(self.mlp, LeFF):
            z = self.mlp(x, self.norm2, bands, mode)
        else:
            z = actstore.compress(self.mlp(actstore.compress(
                layer_norm(x, self.norm2), mode), dropout_gen), mode)
        return x + self.drop_path(z, droppath)


def _remat_block(blk: LeWinBlock, x: torch.Tensor,
                 generator: Optional[torch.Generator],
                 droppath: Optional[torch.Generator],
                 pad_mask: Optional[torch.Tensor],
                 sample_idx: Optional[torch.Tensor],
                 dropout_gen: Optional[torch.Generator],
                 bands: Optional[halo.Bands]) -> torch.Tensor:
    """blk(x, ...) with its activations recomputed in the backward pass.

    The generators' states at the block's entry are kept; the recompute
    starts from them, so it draws the forward's sample tables, DropPath
    and dropout masks, and afterwards puts back the states it found (in
    `finally`: the checkpoint may stop a recompute early), so later blocks
    and steps see the generators as they would without remat."""
    gens = [g for g in (generator, droppath, dropout_gen) if g is not None]
    entry = [g.get_state() for g in gens]
    replay = False

    def call(x, pad_mask):
        return blk(x, generator, droppath, pad_mask, sample_idx, dropout_gen,
                   bands)

    def run(x, pad_mask):
        nonlocal replay
        if not replay:  # the forward itself
            replay = True
            return call(x, pad_mask)
        found = [g.get_state() for g in gens]
        for g, state in zip(gens, entry):
            g.set_state(state)
        try:
            return call(x, pad_mask)
        finally:
            for g, state in zip(gens, found):
                g.set_state(state)

    return checkpoint(run, x, pad_mask, use_reentrant=False)


class UformerStage(nn.Module):
    """depth × LeWin blocks, shift 0 / win//2 alternating (state_dict
    `blocks.{j}`); with `cfg.remat` and grad on, each block is
    recomputed in the backward pass (`_remat_block`)."""

    def __init__(self, dim: int, input_resolution: int, depth: int,
                 num_heads: int, cfg: ModelConfig, drop_path, device=None):
        super().__init__()
        self.blocks = nn.ModuleList([
            LeWinBlock(
                dim, input_resolution, num_heads, win_size=cfg.win_size,
                shift_size=(0 if (j % 2 == 0 or not cfg.use_shift)
                            else cfg.win_size // 2),
                mlp_ratio=cfg.mlp_ratio, drop_path=float(drop_path[j]),
                factor=cfg.probsparse_factor,
                use_rel_pos_bias=cfg.use_rel_pos_bias,
                fast_gelu=cfg.fast_gelu, attention=cfg.attention,
                token_projection=cfg.token_projection,
                token_mlp=cfg.token_mlp, se_layer=cfg.se_layer,
                qkv_bias=cfg.qkv_bias, drop=cfg.drop_rate,
                act_store=cfg.act_store, device=device)
            for j in range(depth)])
        self.remat = cfg.remat

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                droppath: Optional[torch.Generator] = None,
                pad_mask: Optional[torch.Tensor] = None,
                sample_tables: Optional[Sequence[torch.Tensor]] = None,
                dropout_gen: Optional[torch.Generator] = None,
                bands: Optional[halo.Bands] = None) -> torch.Tensor:
        """sample_tables: one [N, U_part] table per block (None for a W-MSA
        block), or None to draw them from `generator`."""
        remat = self.remat and torch.is_grad_enabled()
        for j, blk in enumerate(self.blocks):
            idx = None if sample_tables is None else sample_tables[j]
            x = (_remat_block(blk, x, generator, droppath, pad_mask, idx,
                              dropout_gen, bands)
                 if remat else blk(x, generator, droppath, pad_mask, idx,
                                   dropout_gen, bands))
        return x


def check_config(cfg: ModelConfig) -> None:
    """Refuse the Uformer option combinations the JAX package refuses
    (`dehaze_tpu/models/__init__.py`): the reference's ProbSparse model
    builds the W-MSA projections and the SE layer but its forward never
    calls them, so accepting them would train a different model than
    asked."""
    for field, allowed in (("attention", ("probsparse", "full")),
                           ("token_projection",
                            ("linear", "conv", "linear_concat")),
                           ("token_mlp", ("leff", "ffn"))):
        value = getattr(cfg, field)
        if value not in allowed:
            raise ValueError(f"unknown {field} {value!r}; expected "
                             + " | ".join(repr(a) for a in allowed))
    if cfg.attention == "probsparse" and (cfg.token_projection != "linear"
                                         or cfg.se_layer):
        raise ValueError(
            "token_projection='conv'/'linear_concat' and se_layer require "
            "attention='full'; the reference's ProbSparse forward ignores "
            "them")


class Uformer(nn.Module):
    """The 9-stage U-shaped model. forward takes NHWC float images in
    [0, 1] and returns float32 x + y; H and W must be multiples of
    win_size · 2⁴."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_config(cfg)
        self.cfg = cfg
        depths, heads = cfg.depths, cfg.num_heads
        n_enc = cfg.num_enc_layers
        enc_dpr = list(np.linspace(0, cfg.drop_path_rate,
                                   sum(depths[:n_enc])))
        conv_dpr = [cfg.drop_path_rate] * depths[n_enc]
        dec_dpr = enc_dpr[::-1]

        self.input_proj = InputProj(cfg.in_chans, cfg.embed_dim, device=device)
        dim, res, start = cfg.embed_dim, cfg.img_size, 0
        for i in range(n_enc):
            setattr(self, f"encoderlayer_{i}", UformerStage(
                dim, res, depths[i], heads[i], cfg,
                enc_dpr[start:start + depths[i]], device=device))
            # the reference spells it 'dowsample'
            setattr(self, f"dowsample_{i}",
                    Downsample(dim, dim * 2, device=device))
            dim, res, start = dim * 2, res // 2, start + depths[i]
        self.conv = UformerStage(dim, res, depths[n_enc], heads[n_enc], cfg,
                                 conv_dpr, device=device)
        dstart, in_ch = 0, dim
        for i in range(n_enc):
            idx = n_enc + 1 + i
            up_dim = dim // 2
            setattr(self, f"upsample_{i}",
                    Upsample(in_ch, up_dim, device=device))
            res *= 2
            in_ch = up_dim * 2  # skip concat
            setattr(self, f"decoderlayer_{i}", UformerStage(
                in_ch, res, depths[idx], heads[idx], cfg,
                dec_dpr[dstart:dstart + depths[idx]], device=device))
            dstart += depths[idx]
            dim = up_dim
        self.output_proj = OutputProj(2 * cfg.embed_dim, cfg.in_chans,
                                      device=device)
        self.apply(self._init_weights)

    @staticmethod
    def _init_weights(m: nn.Module) -> None:
        """The reference's init: truncated-normal(0.02) Linear weights and
        bias tables, zero Linear biases, unit LayerNorms."""
        if isinstance(m, nn.Linear):
            nn.init.trunc_normal_(m.weight, std=0.02)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif (isinstance(m, (WindowAttention, FullWindowAttention))
              and m.relative_position_bias_table is not None):
            nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                droppath: Optional[torch.Generator] = None,
                dropout_gen: Optional[torch.Generator] = None,
                pad_mask: Optional[torch.Tensor] = None,
                sample_tables: Optional[Sequence[torch.Tensor]] = None,
                bands: Optional[halo.Bands] = None) -> torch.Tensor:
        """pad_mask: [1, H, W, 1], 1 on padding (any-resolution inputs, see
        `infer.anyres`), or None. sample_tables: the ProbSparse tables of
        every ProbSparse layer in module order (`draw_sample_tables`; none
        for a W-MSA model), used in place of drawing them from
        `generator`; or None. bands: x is this rank's band of the canvas
        (`infer.halo_sharded`), and pad_mask the whole canvas's; or
        None."""
        n_enc = self.cfg.num_enc_layers
        if sample_tables is not None:
            n = sum(isinstance(m, WindowAttention) for m in self.modules())
            if len(sample_tables) != n:
                raise ValueError(f"sample_tables holds {len(sample_tables)} "
                                 f"tables; the model has {n} ProbSparse "
                                 "layers")
            tables = iter(sample_tables)

        def run(stage, y):  # the stage's tables come next in module order
            idx = (None if sample_tables is None
                   else [next(tables) if isinstance(b.attn, WindowAttention)
                         else None for b in stage.blocks])
            return stage(y, generator, droppath, pad_mask, idx, dropout_gen,
                         bands)

        y = dropout(self.input_proj(x.to(self.cfg.dtype), bands),
                    self.cfg.drop_rate, self.training, dropout_gen)
        skips = []
        for i in range(n_enc):
            y = run(getattr(self, f"encoderlayer_{i}"), y)
            skips.append(y)
            y = getattr(self, f"dowsample_{i}")(y, bands)
        y = run(self.conv, y)
        for i in range(n_enc):
            y = getattr(self, f"upsample_{i}")(y)
            y = torch.cat([y, skips[n_enc - 1 - i]], dim=-1)
            y = run(getattr(self, f"decoderlayer_{i}"), y)
        out = self.output_proj(y, bands)
        return x.float() + out.float()


def draw_sample_tables(model: Uformer, generator: Optional[torch.Generator],
                       device=None) -> List[torch.Tensor]:
    """The [N, U_part] ProbSparse tables a forward of `model` with
    `generator` draws, one per ProbSparse layer in module order (the
    forward's order; none for a W-MSA model), drawn as that forward draws them and then moved to
    `device` (default: where they were drawn). `model(x,
    sample_tables=draw_sample_tables(model, torch.Generator().manual_seed(
    s)))` computes `model(x, generator=torch.Generator().manual_seed(s))`."""
    tables = []
    for m in model.modules():
        if isinstance(m, WindowAttention):
            n, u_part = m.sample_shape()
            t = ps_ops.sample_indices(n, n, u_part, generator)
            tables.append(t if device is None else t.to(device))
    return tables
