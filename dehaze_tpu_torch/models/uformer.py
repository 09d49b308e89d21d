"""Uformer with ProbSparse window attention (counterpart of
`dehaze_tpu/models/uformer.py`, the `attention='probsparse'` flavor).

InputProj → 4 encoder stages (depth × LeWin block, then a 4×4/s2 conv that
doubles C) → bottleneck stage → 4 decoder stages (2×2/s2 transposed conv that
halves C, skip concat, depth × LeWin block) → OutputProj(2C→3) → global
residual x + y. NHWC throughout; parameters float32, activations in
`cfg.dtype`.

Module names follow the reference torch model's state_dict
(`encoderlayer_{i}`, `dowsample_{i}`, `conv` for the bottleneck,
`upsample_{i}`, `decoderlayer_{i}`, `attn.ProbSpare.*_projection`), which
`dehaze_tpu/utils/convert_torch.py` reads.

ProbSparse key sampling draws from the `generator` passed to forward: each
attention layer draws its [N, U_part] table in module order, so a forward
with a freshly seeded generator is deterministic. Serving re-seeds it per
forward; training lets it advance from step to step. A forward given
`sample_tables` (one table per attention layer, in module order) draws
nothing and uses those: `draw_sample_tables` draws the list a forward with
a generator would, so the two compute the same. An exported artifact
(`infer.export`) folds such a list in. In train mode,
DropPath and dropout draw their masks from the `droppath` and
`dropout_gen` generators (none is needed at rate 0), never from torch's
global RNG.

With `cfg.remat`, each LeWin block runs under `torch.utils.checkpoint`
when grad is on, and its activations are recomputed in the backward pass.
The recompute replays the block's draws from the generators (its sample
tables and DropPath masks), which `preserve_rng_state` alone would not:
that restores torch's global RNG only.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dehaze_tpu_torch.config import ModelConfig
from dehaze_tpu_torch.models.layers import (DropPath, InputProj, LeFF,
                                            OutputProj, Downsample, Upsample,
                                            cast, dropout, layer_norm)
from dehaze_tpu_torch.ops import probsparse as ps_ops
from dehaze_tpu_torch.ops import window as win_ops
from dehaze_tpu_torch.ops.kernels.window_attention import (
    fused_window_attention)


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


def pad_flags(pad_mask: torch.Tensor, H: int, W: int,
              win: int) -> torch.Tensor:
    """The full-resolution padding mask [1, X, X', 1] (1 on padding) resized
    to a stage's H × W with legacy nearest indices and windowed: [nW, N]
    flags. Built from unshifted coordinates even for shifted blocks, as the
    reference does."""
    dev = pad_mask.device
    pm = pad_mask[:, _legacy_nearest(pad_mask.shape[1], H, dev)]
    pm = pm[:, :, _legacy_nearest(pad_mask.shape[2], W, dev)]
    return win_ops.window_partition(pm, win)[..., 0]


def _linear(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, cast(m.weight, x), cast(m.bias, x))


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


class LeWinBlock(nn.Module):
    """x + WinAttn(LN(x), shift); then x + LeFF(LN(x)).

    Window and shift collapse (win = resolution, shift 0) when the
    CONFIGURED stage resolution is not bigger than the window, so the
    parameters do not depend on the runtime geometry; the runtime H and W
    must be multiples of the (collapsed) window."""

    def __init__(self, dim: int, input_resolution: int, num_heads: int,
                 win_size: int = 8, shift_size: int = 0,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 factor: int = 5, use_rel_pos_bias: bool = True,
                 fast_gelu: bool = False, device=None):
        super().__init__()
        self.win = win_size
        self.shift = shift_size
        if input_resolution <= win_size:
            self.win = input_resolution
            self.shift = 0
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.attn = WindowAttention(dim, self.win, num_heads, factor,
                                    use_rel_pos_bias, device=device)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.mlp = LeFF(dim, int(dim * mlp_ratio), fast_gelu=fast_gelu,
                        device=device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                droppath: Optional[torch.Generator] = None,
                pad_mask: Optional[torch.Tensor] = None,
                sample_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, H, W, C = x.shape
        win, shift = self.win, self.shift
        if H % win or W % win:
            raise ValueError(f"feature map {H}x{W} not divisible by window "
                             f"{win}; pad the input to a multiple of "
                             "win*2^4 (see infer.tiled)")
        y = layer_norm(x, self.norm1)
        sw_region = None
        if shift > 0:
            y = win_ops.cyclic_shift(y, shift)
            sw_region = _region_ids(H, W, win, shift, x.device)
        pad_flag = (None if pad_mask is None
                    else pad_flags(pad_mask, H, W, win))
        y = self.attn(win_ops.window_partition(y, win), sw_region, generator,
                      pad_flag, sample_idx)
        y = win_ops.window_reverse(y, win, H, W)
        if shift > 0:
            y = win_ops.cyclic_unshift(y, shift)
        x = x + self.drop_path(y, droppath)
        return x + self.drop_path(self.mlp(x, self.norm2), droppath)


def _remat_block(blk: LeWinBlock, x: torch.Tensor,
                 generator: Optional[torch.Generator],
                 droppath: Optional[torch.Generator],
                 pad_mask: Optional[torch.Tensor],
                 sample_idx: Optional[torch.Tensor]) -> torch.Tensor:
    """blk(x, ...) with its activations recomputed in the backward pass.

    The generators' states at the block's entry are kept; the recompute
    starts from them, so it draws the forward's sample tables and DropPath
    masks, and afterwards puts back the states it found (in `finally`: the
    checkpoint may stop a recompute early), so later blocks and steps see
    the generators as they would without remat."""
    gens = [g for g in (generator, droppath) if g is not None]
    entry = [g.get_state() for g in gens]
    replay = False

    def run(x, pad_mask):
        nonlocal replay
        if not replay:  # the forward itself
            replay = True
            return blk(x, generator, droppath, pad_mask, sample_idx)
        found = [g.get_state() for g in gens]
        for g, state in zip(gens, entry):
            g.set_state(state)
        try:
            return blk(x, generator, droppath, pad_mask, sample_idx)
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
                fast_gelu=cfg.fast_gelu, device=device)
            for j in range(depth)])
        self.remat = cfg.remat

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                droppath: Optional[torch.Generator] = None,
                pad_mask: Optional[torch.Tensor] = None,
                sample_tables: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        """sample_tables: one [N, U_part] table per block, or None to draw
        them from `generator`."""
        remat = self.remat and torch.is_grad_enabled()
        for j, blk in enumerate(self.blocks):
            idx = None if sample_tables is None else sample_tables[j]
            x = (_remat_block(blk, x, generator, droppath, pad_mask, idx)
                 if remat else blk(x, generator, droppath, pad_mask, idx))
        return x


def check_config(cfg: ModelConfig) -> None:
    """Refuse configurations the port does not implement yet."""
    if cfg.arch != "uformer":
        raise ValueError(f"arch {cfg.arch!r} is not ported yet")
    if (cfg.attention != "probsparse" or cfg.token_projection != "linear"
            or cfg.token_mlp != "leff" or cfg.se_layer):
        raise ValueError(
            "the port implements the ProbSparse Uformer only (attention="
            "'probsparse', token_projection='linear', token_mlp='leff', no "
            "se_layer)")


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
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif (isinstance(m, WindowAttention)
              and m.relative_position_bias_table is not None):
            nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                droppath: Optional[torch.Generator] = None,
                dropout_gen: Optional[torch.Generator] = None,
                pad_mask: Optional[torch.Tensor] = None,
                sample_tables: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        """pad_mask: [1, H, W, 1], 1 on padding (any-resolution inputs, see
        `infer.anyres`), or None. sample_tables: the ProbSparse tables of
        every attention layer in module order (`draw_sample_tables`), used
        in place of drawing them from `generator`; or None."""
        n_enc = self.cfg.num_enc_layers
        if sample_tables is not None:
            n = sum(self.cfg.depths)
            if len(sample_tables) != n:
                raise ValueError(f"sample_tables holds {len(sample_tables)} "
                                 f"tables; the model has {n} attention "
                                 "layers")
            tables = iter(sample_tables)

        def run(stage, y):  # the stage's tables come next in module order
            idx = (None if sample_tables is None
                   else [next(tables) for _ in stage.blocks])
            return stage(y, generator, droppath, pad_mask, idx)

        y = dropout(self.input_proj(x.to(self.cfg.dtype)), self.cfg.drop_rate,
                    self.training, dropout_gen)
        skips = []
        for i in range(n_enc):
            y = run(getattr(self, f"encoderlayer_{i}"), y)
            skips.append(y)
            y = getattr(self, f"dowsample_{i}")(y)
        y = run(self.conv, y)
        for i in range(n_enc):
            y = getattr(self, f"upsample_{i}")(y)
            y = torch.cat([y, skips[n_enc - 1 - i]], dim=-1)
            y = run(getattr(self, f"decoderlayer_{i}"), y)
        out = self.output_proj(y)
        return x.float() + out.float()


def draw_sample_tables(model: Uformer, generator: Optional[torch.Generator],
                       device=None) -> List[torch.Tensor]:
    """The [N, U_part] ProbSparse tables a forward of `model` with
    `generator` draws, one per attention layer in module order (the
    forward's order), drawn as that forward draws them and then moved to
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
