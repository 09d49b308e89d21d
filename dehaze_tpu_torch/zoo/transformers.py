"""The transformer and token-mixing families of the zoo (counterpart of
`dehaze_tpu/zoo/transformers.py`): ViT, PiT, Swin, ConViT, AlterNet and
the MLP-Mixer, and `ensemble_logits`.

Modules carry the reference's state_dict names (`embedding.0.
patch_embedding.1`, `transformers.{i}.attn.to_qkv`, `layer1.1.attn.
pos_embedding`, `mlps.{i}.ff1.net.0`, ...). Maps are NCHW and tokens
[B, N, C]; softmax runs in float32. Quirks of the JAX package that the
port follows:
- Swin on a map that its window does not tile (the deep stages at 32²)
  takes the largest window ≤ min(window, h, w) that divides the map, and
  indexes the central block of the (2w−1)² position table with it; the
  left/right shift mask covers windows `[-n1-1::n1]`, as the reference's;
- ConViT refuses a padding that makes its q and k/v token counts differ
  (the reference's default padding 0 crashes its own model);
- `ensemble_logits` sums the members' probabilities (log Σ softmax), a
  constant log M above their mean.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dehaze_tpu_torch.ops.window import device_constant_cache
from dehaze_tpu_torch.zoo import layers as zl
from dehaze_tpu_torch.zoo.convnets import PreBlock


def _softmax(dots: torch.Tensor) -> torch.Tensor:
    return torch.softmax(dots.float(), dim=-1).to(dots.dtype)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[..., heads·d] → [..., heads, d]."""
    return t.reshape(*t.shape[:-1], heads, t.shape[-1] // heads)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW → [B, H·W, C]."""
    return x.flatten(2).transpose(1, 2)


def _map(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H·W, C] → NCHW."""
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], h, w)


class Attention1d(nn.Module):
    """`Attention1d` on [B, N, C] tokens: `to_qkv` (no bias), softmax
    attention per head, `to_out.0`; an additive mask broadcasts over
    [B, heads, N, N]."""

    def __init__(self, dim_in: int, dim_out: int, heads: int, dim_head: int,
                 dropout: float = 0.0):
        super().__init__()
        self.heads, self.scale, self.dropout = heads, dim_head ** -0.5, dropout
        self.to_qkv = nn.Linear(dim_in, heads * dim_head * 3, bias=False)
        self.to_out = zl.slots({0: nn.Linear(heads * dim_head, dim_out)})

    def forward(self, x, mask=None, gens=None):
        b, n, _ = x.shape
        q, k, v = (_heads(t, self.heads)
                   for t in zl.linear(x, self.to_qkv).chunk(3, dim=-1))
        dots = torch.einsum("bihd,bjhd->bhij", q, k) * self.scale
        if mask is not None:
            dots = dots + mask
        out = torch.einsum("bhij,bjhd->bihd", _softmax(dots), v)
        out = zl.linear(out.reshape(b, n, -1), self.to_out["0"])
        return zl.train_dropout(out, self.dropout, self.training, gens)


class Attention2d(nn.Module):
    """`Attention2d` on NCHW maps: 1×1-conv q, k×k stride-k conv kv, full
    attention between the two token sets, 1×1 `to_out.0`."""

    def __init__(self, dim_in: int, dim_out: int, heads: int, dim_head: int,
                 k: int = 1, dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.scale, self.dropout = heads, dim_head ** -0.5, dropout
        self.to_q = nn.Conv2d(dim_in, inner, 1, bias=False)
        self.to_kv = nn.Conv2d(dim_in, inner * 2, k, stride=k, bias=False)
        self.to_out = zl.slots({0: nn.Conv2d(inner, dim_out, 1)})

    def forward(self, x, mask=None, gens=None):
        b, _, h, w = x.shape
        q = _heads(_tokens(zl.conv(x, self.to_q)), self.heads)
        kk, vv = (_heads(_tokens(t), self.heads)
                  for t in zl.conv(x, self.to_kv).chunk(2, dim=1))
        dots = torch.einsum("bihd,bjhd->bhij", q, kk) * self.scale
        if mask is not None:
            dots = dots + mask
        out = torch.einsum("bhij,bjhd->bihd", _softmax(dots), vv)
        out = zl.conv(_map(out.reshape(b, h * w, -1), h, w), self.to_out["0"])
        return zl.train_dropout(out, self.dropout, self.training, gens)


class FeedForward(nn.Module):
    """`FeedForward`: `net.0` → GELU (exact) → dropout → `net.3` → dropout,
    with f = Linear on tokens, a 1×1 Conv2d on maps (`kind="conv"`) or a
    Conv1d(k=1) over the token axis (`kind="tokens"`, the Mixer's
    token mix)."""

    def __init__(self, dim_in: int, hidden: int, dim_out: int,
                 dropout: float = 0.0, kind: str = "linear"):
        super().__init__()
        make = {"linear": nn.Linear,
                "conv": lambda i, o: nn.Conv2d(i, o, 1),
                "tokens": lambda i, o: nn.Conv1d(i, o, 1)}[kind]
        self.kind, self.dropout = kind, dropout
        self.net = zl.slots({0: make(dim_in, hidden), 3: make(hidden,
                                                              dim_out)})

    def _f(self, x, m):
        if self.kind == "linear":
            return zl.linear(x, m)
        if self.kind == "conv":
            return zl.conv(x, m)
        return F.conv1d(x, m.weight.to(x.dtype), m.bias.to(x.dtype))

    def forward(self, x, gens=None):
        x = F.gelu(self._f(x, self.net["0"]))
        x = zl.train_dropout(x, self.dropout, self.training, gens)
        x = self._f(x, self.net["3"])
        return zl.train_dropout(x, self.dropout, self.training, gens)


class Transformer(nn.Module):
    """`Transformer` with Attention1d, LayerNorm and Linear: the ViT and
    PiT block (a LayerNorm+Linear `shortcut` where the width changes)."""

    def __init__(self, dim_in: int, dim_out: Optional[int], heads: int,
                 dim_head: int, dim_mlp: int, dropout: float = 0.0,
                 sd: float = 0.0):
        super().__init__()
        dim_out = dim_in if dim_out is None else dim_out
        self.sd = sd
        self.shortcut = None
        if dim_in != dim_out:
            self.shortcut = zl.slots({0: nn.LayerNorm(dim_in),
                                      1: nn.Linear(dim_in, dim_out)})
        self.norm1 = nn.LayerNorm(dim_in)
        self.attn = Attention1d(dim_in, dim_out, heads, dim_head, dropout)
        self.norm2 = nn.LayerNorm(dim_out)
        self.ff = FeedForward(dim_out, dim_mlp, dim_out, dropout)

    def forward(self, x, gens=None, taps=None):
        skip = x
        if self.shortcut is not None:
            skip = zl.linear(zl.layer_norm(x, self.shortcut["0"]),
                             self.shortcut["1"])
        h = self.attn(zl.layer_norm(x, self.norm1), gens=gens)
        x = zl.tap(taps, zl.drop_path(h, self.sd, self.training, gens) + skip)
        h = self.ff(zl.layer_norm(x, self.norm2), gens)
        return zl.tap(taps, zl.drop_path(h, self.sd, self.training, gens) + x)


# ------------------------------------------------------------ embeddings

class PatchEmbedding(nn.Module):
    """`PatchEmbedding`: non-overlapping p×p patches flattened (p1, p2, c),
    channel fastest, then `patch_embedding.1` Linear."""

    def __init__(self, patch: int, dim: int, channels: int = 3):
        super().__init__()
        self.patch = patch
        self.patch_embedding = zl.slots({1: nn.Linear(patch * patch *
                                                      channels, dim)})

    def forward(self, x):
        b, c, h, w = x.shape
        p = self.patch
        x = x.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 3, 5, 1)
        return zl.linear(x.reshape(b, (h // p) * (w // p), p * p * c),
                         self.patch_embedding["1"])


class ConvEmbedding(nn.Module):
    """`ConvEmbedding`: overlapping Unfold(patch, stride), channel slowest
    (torch's unfold order), then `patch_embedding.2` Linear."""

    def __init__(self, patch: int, stride: int, dim: int, channels: int = 3):
        super().__init__()
        self.patch, self.stride = patch, stride
        self.patch_embedding = zl.slots({2: nn.Linear(patch * patch *
                                                      channels, dim)})

    def forward(self, x):
        cols = F.unfold(x, self.patch, stride=self.stride)
        return zl.linear(cols.transpose(1, 2), self.patch_embedding["2"])


class CLSToken(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.cls_token = zl.randn_param(1, 1, dim)

    def forward(self, x):
        tok = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        return torch.cat([tok, x], dim=1)


class AbsPosEmbedding(nn.Module):
    def __init__(self, num_tokens: int, dim: int):
        super().__init__()
        self.pos_embedding = zl.randn_param(1, num_tokens, dim)

    def forward(self, x):
        return x + self.pos_embedding.to(x.dtype)


def _head(dim: int, num_classes: int, ln: int, dense: int) -> nn.ModuleDict:
    """The classifier `Sequential`: LayerNorm at index `ln`, Linear at
    `dense`."""
    return zl.slots({ln: nn.LayerNorm(dim),
                     dense: nn.Linear(dim, num_classes)})


def _apply_head(seq: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
    ln, dense = seq.values()
    return zl.linear(zl.layer_norm(x, ln), dense)


# ------------------------------------------------------------------- ViT

class ViTZoo(nn.Module):
    """`vit.py`: patch embedding, class token, absolute positions, `depth`
    Transformer blocks, LayerNorm and Linear on the class token."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 num_classes: int = 10, depth: int = 12, dim: int = 192,
                 heads: int = 3, dim_head: int = 64, dim_mlp: int = 768,
                 dropout: float = 0.0, emb_dropout: float = 0.0,
                 sd: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        if image_size % patch_size:
            raise ValueError("image_size must be divisible by patch_size")
        self.dtype, self.emb_dropout = dtype, emb_dropout
        n = (image_size // patch_size) ** 2
        self.embedding = zl.slots({0: PatchEmbedding(patch_size, dim),
                                   1: CLSToken(dim),
                                   2: AbsPosEmbedding(n + 1, dim)})
        self.transformers = nn.ModuleList(
            Transformer(dim, None, heads, dim_head, dim_mlp, dropout,
                        sd * i / (depth - 1) if depth > 1 else 0.0)
            for i in range(depth))
        self.classifier = _head(dim, num_classes, 1, 2)

    def forward(self, x: torch.Tensor, generators: zl.Generators = None,
                taps: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        x = x.to(self.dtype)
        for emb in self.embedding.values():
            x = emb(x)
        x = zl.train_dropout(x, self.emb_dropout, self.training, generators)
        zl.tap(taps, x)
        for blk in self.transformers:
            x = blk(x, generators, taps)
        return _apply_head(self.classifier, x[:, 0])


# ------------------------------------------------------------------- PiT

class Pool(nn.Module):
    """PiT's `Pool`: `cls_ff` Linear on the class token, a stride-2 grouped
    3×3 conv (`downsample.net.0`, groups = dim_in) on the spatial
    tokens."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.cls_ff = nn.Linear(dim_in, dim_out)
        self.downsample = nn.Module()
        self.downsample.net = zl.slots({0: nn.Conv2d(
            dim_in, dim_out, 3, stride=2, padding=1, groups=dim_in)})

    def forward(self, x, side: int):
        cls = zl.linear(x[:, :1], self.cls_ff)
        spat = zl.conv(_map(x[:, 1:], side, side), self.downsample.net["0"])
        return torch.cat([cls, _tokens(spat)], dim=1), spat.shape[2]


class PiTZoo(nn.Module):
    """`pit.py`: conv embedding, three stages of Transformer blocks with a
    `Pool` between them, each at an index of `transformers`."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 stride: int = 8, num_classes: int = 10,
                 dims: Sequence[int] = (64, 128, 256),
                 depths: Sequence[int] = (2, 6, 4),
                 heads: Sequence[int] = (2, 4, 8),
                 dims_head: Sequence[int] = (32, 32, 32),
                 dims_mlp: Sequence[int] = (256, 512, 1024),
                 dropout: float = 0.0, emb_dropout: float = 0.0,
                 sd: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        if len(depths) != 3:
            raise ValueError("`depths` must have length 3")
        self.dtype, self.emb_dropout = dtype, emb_dropout
        self.side = zl.interpret_pad(image_size, patch_size, stride)
        dims = (dims[0], *dims)
        self.embedding = zl.slots({
            0: ConvEmbedding(patch_size, stride, dims[0]),
            1: CLSToken(dims[0]),
            2: AbsPosEmbedding(self.side ** 2 + 1, dims[0])})
        sds = zl.stochastic_depths(sd, depths)
        blocks = []
        for si in range(3):
            if si > 0:
                blocks.append(Pool(dims[si], dims[si + 1]))
            blocks += [Transformer(dims[si + 1], None, heads[si],
                                   dims_head[si], dims_mlp[si], dropout,
                                   sds[si][bi]) for bi in range(depths[si])]
        self.transformers = nn.ModuleList(blocks)
        self.classifier = _head(dims[-1], num_classes, 1, 2)

    def forward(self, x: torch.Tensor, generators: zl.Generators = None,
                taps: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        x = x.to(self.dtype)
        for emb in self.embedding.values():
            x = emb(x)
        x = zl.train_dropout(x, self.emb_dropout, self.training, generators)
        zl.tap(taps, x)
        side = self.side
        for blk in self.transformers:
            if isinstance(blk, Pool):
                x, side = blk(x, side)
                zl.tap(taps, x)
            else:
                x = blk(x, generators, taps)
        return _apply_head(self.classifier, x[:, 0])


# ------------------------------------------------------------------ Swin

def _rel_index(window: int) -> np.ndarray:
    """[w², w², 2] relative offsets of two positions in a window, shifted
    to index a (2w−1)² table."""
    coords = np.array([[i, j] for i in range(window) for j in range(window)])
    return coords[None, :, :] - coords[:, None, :] + window - 1


def _swin_shift_masks(n1: int, n2: int, p: int, d: int) -> np.ndarray:
    """The upper/lower and left/right masks of the shifted windows
    ([nW, 1, p², p²]), the `[-n1-1::n1]` quirk included."""
    neg = float("-inf")
    mask = np.zeros((n1 * n2, 1, p * p, p * p), np.float32)
    ul = np.zeros((p * p, p * p), np.float32)
    ul[-d * p:, :-d * p] = neg
    ul[:-d * p, -d * p:] = neg
    mask[-n2:] += ul
    lr = np.zeros((p, p, p, p), np.float32)
    lr[:, -d:, :, :-d] = neg
    lr[:, :-d, :, -d:] = neg
    mask[-n1 - 1::n1] += lr.reshape(p * p, p * p)
    return mask


@device_constant_cache
def _rel_index_on(p: int, offset: int, device: torch.device):
    """(rows, cols) of `_rel_index(p) + offset` as int64 on `device`, made
    once per device."""
    with torch.inference_mode(False):
        idx = torch.from_numpy(_rel_index(p) + offset).to(device)
        return idx[..., 0], idx[..., 1]


@device_constant_cache
def _shift_masks_on(n1: int, n2: int, p: int, d: int, device: torch.device):
    with torch.inference_mode(False):
        return torch.from_numpy(_swin_shift_masks(n1, n2, p, d)).to(device)


def _windows(x: torch.Tensor, p: int) -> torch.Tensor:
    """NCHW → [B·n1·n2, C, p, p] windows, row-major."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(-1, c, p, p)


def _unwindows(x: torch.Tensor, b: int, h: int, w: int) -> torch.Tensor:
    """[B·n1·n2, C, p, p] → NCHW."""
    c, p = x.shape[1], x.shape[2]
    x = x.reshape(b, h // p, w // p, c, p, p).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, h, w)


class WindowAttention(nn.Module):
    """Swin's `WindowAttention` on NCHW maps: the relative position table
    `pos_embedding` [(2w−1)², ] added to Attention1d's scores in each
    window (`attn`), and, shifted, a cyclic shift by half a window with
    the masks that keep wrapped regions apart."""

    def __init__(self, dim: int, heads: int, dim_head: int, window: int,
                 shifted: bool, dropout: float = 0.0):
        super().__init__()
        self.window, self.shifted = window, shifted
        self.pos_embedding = zl.randn_param(2 * window - 1, 2 * window - 1)
        self.attn = Attention1d(dim, dim, heads, dim_head, dropout)

    def forward(self, x, gens=None):
        b, c, h, w = x.shape
        p = min(self.window, h, w)
        while p > 1 and (h % p or w % p):
            p -= 1
        n1, n2, d = h // p, w // p, p // 2
        rows, cols = _rel_index_on(p, self.window - p,
                                   self.pos_embedding.device)
        mask = self.pos_embedding[rows, cols].to(x.dtype)
        shift = self.shifted and d > 0
        if shift:
            sm = _shift_masks_on(n1, n2, p, d, x.device)
            mask = (mask + sm.to(x.dtype)).repeat(b, 1, 1, 1)
            x = torch.roll(x, (-d, -d), dims=(2, 3))
        t = _windows(x, p).flatten(2).transpose(1, 2)    # [B', p², C]
        t = self.attn(t, mask=mask, gens=gens)
        x = _unwindows(t.transpose(1, 2).reshape(-1, c, p, p), b, h, w)
        return torch.roll(x, (d, d), dims=(2, 3)) if shift else x


def _ln2d(x: torch.Tensor, m: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm over the channels of an NCHW map."""
    return zl.layer_norm(x.permute(0, 2, 3, 1), m).permute(0, 3, 1, 2)


class SwinBlock(nn.Module):
    """A Transformer with ln2d (`norm1.1`, `norm2.1`), WindowAttention
    (`attn`) and 1×1-conv FeedForward (`ff`)."""

    def __init__(self, dim: int, heads: int, dim_head: int, dim_mlp: int,
                 window: int, shifted: bool, dropout: float = 0.0,
                 sd: float = 0.0):
        super().__init__()
        self.sd = sd
        self.norm1 = zl.slots({1: nn.LayerNorm(dim)})
        self.attn = WindowAttention(dim, heads, dim_head, window, shifted,
                                    dropout)
        self.norm2 = zl.slots({1: nn.LayerNorm(dim)})
        self.ff = FeedForward(dim, dim_mlp, dim, dropout, kind="conv")

    def forward(self, x, gens=None):
        h = self.attn(_ln2d(x, self.norm1["1"]), gens)
        x = zl.drop_path(h, self.sd, self.training, gens) + x
        h = self.ff(_ln2d(x, self.norm2["1"]), gens)
        return zl.drop_path(h, self.sd, self.training, gens) + x


class PatchMerge(nn.Module):
    """Swin's patch merging: a pool×pool conv of stride pool."""

    def __init__(self, dim_in: int, dim_out: int, pool: int):
        super().__init__()
        self.patch_merge = nn.Conv2d(dim_in, dim_out, pool, stride=pool)

    def forward(self, x, gens=None):
        return zl.conv(x, self.patch_merge)


class SwinZoo(nn.Module):
    """`swin.py`: four stages, each a patch merge (`layer{i}.0`) and
    `depths[i]` blocks alternating plain and shifted windows; global
    average pool, LayerNorm (`classifier.2`) and Linear (`.3`)."""

    def __init__(self, num_classes: int = 10,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 heads: Sequence[int] = (3, 6, 12, 24),
                 dims_mlp: Sequence[int] = (384, 768, 1536, 3072),
                 dim_head: int = 32, window_size: int = 7,
                 pools: Sequence[int] = (4, 2, 2, 2), dropout: float = 0.0,
                 sd: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        sds = zl.stochastic_depths(sd, depths)
        cin = 3
        for li in range(4):
            blocks = [PatchMerge(cin, dims[li], pools[li])]
            blocks += [SwinBlock(dims[li], heads[li], dim_head, dims_mlp[li],
                                 window_size, bool(bi % 2), dropout,
                                 sds[li][bi])
                       for bi in range(depths[li] // 2 * 2)]
            setattr(self, f"layer{li + 1}", nn.ModuleList(blocks))
            cin = dims[li]
        self.classifier = _head(dims[-1], num_classes, 2, 3)

    def forward(self, x: torch.Tensor, generators: zl.Generators = None,
                taps: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        x = x.to(self.dtype)
        for li in range(1, 5):
            for blk in getattr(self, f"layer{li}"):
                x = zl.tap(taps, blk(x, generators))
        return _apply_head(self.classifier, x.mean(dim=(2, 3)))


# ---------------------------------------------------------------- ConViT

class ConvAttention2d(nn.Module):
    """`ConvAttention2d` (`convit.py`): each query attends to the
    kernel_size² unfolded k/v patch around it."""

    def __init__(self, dim_in: int, dim_out: int, heads: int, dim_head: int,
                 k: int = 1, kernel_size: int = 3, dilation: int = 1,
                 padding: int = 1, stride: int = 1, dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.scale, self.dropout = heads, dim_head ** -0.5, dropout
        self.kernel_size, self.dilation = kernel_size, dilation
        self.padding, self.stride = padding, stride
        self.to_q = nn.Conv2d(dim_in, inner, 1, bias=False)
        self.to_kv = nn.Conv2d(dim_in, inner * 2, k, stride=k, bias=False)
        self.to_out = zl.slots({0: nn.Conv2d(inner, dim_out, 1)})

    def forward(self, x, gens=None):
        b, _, h, w = x.shape
        ks = self.kernel_size
        span = self.dilation * (ks - 1) + 1
        if (h + 2 * self.padding - span) // self.stride + 1 != h:
            raise ValueError(
                "ConvAttention2d needs padding == dilation*(kernel_size-1)/2 "
                "and stride 1 so q and k/v token counts match (the "
                "reference's default padding=0 crashes its own model)")
        q = _heads(_tokens(zl.conv(x, self.to_q)), self.heads)

        def unfold(t):  # [B, C, H, W] → [B, N, K², heads, d], (kh, kw)
            # K² strided slices of the padded map, as the JAX package
            # takes them (F.unfold launches one im2col per image)
            tp = F.pad(t, (self.padding,) * 4)
            span_h = (h - 1) * self.stride + 1
            span_w = (w - 1) * self.stride + 1
            cols = torch.stack([
                tp[:, :, i * self.dilation:i * self.dilation + span_h:
                   self.stride,
                   j * self.dilation:j * self.dilation + span_w:self.stride]
                for i in range(ks) for j in range(ks)], dim=1)
            cols = cols.flatten(3).permute(0, 3, 1, 2)     # [B, N, K², C]
            return _heads(cols, self.heads)

        kk, vv = (unfold(t) for t in zl.conv(x, self.to_kv).chunk(2, dim=1))
        dots = torch.einsum("bnhd,bnwhd->bhnw", q, kk) * self.scale
        out = torch.einsum("bhnw,bnwhd->bnhd", _softmax(dots), vv)
        out = zl.conv(_map(out.reshape(b, h * w, -1), h, w), self.to_out["0"])
        return zl.train_dropout(out, self.dropout, self.training, gens)


class ConViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, dim_mlp: int,
                 k: int, kernel_size: int, dilation: int, padding: int,
                 stride: int, dropout: float = 0.0, sd: float = 0.0):
        super().__init__()
        self.sd = sd
        self.norm1 = zl.slots({1: nn.LayerNorm(dim)})
        self.attn = ConvAttention2d(dim, dim, heads, dim_head, k, kernel_size,
                                    dilation, padding, stride, dropout)
        self.norm2 = zl.slots({1: nn.LayerNorm(dim)})
        self.ff = FeedForward(dim, dim_mlp, dim, dropout, kind="conv")

    def forward(self, x, gens=None):
        h = self.attn(_ln2d(x, self.norm1["1"]), gens)
        x = zl.drop_path(h, self.sd, self.training, gens) + x
        h = self.ff(_ln2d(x, self.norm2["1"]), gens)
        return zl.drop_path(h, self.sd, self.training, gens) + x


class ConViTZoo(nn.Module):
    """`convit.py` (conv-MSA): a patch conv (`embedding.0`), absolute
    positions (`embedding.2`), `depth` ConViT blocks, global average pool,
    LayerNorm and Linear."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 num_classes: int = 10, depth: int = 12, dim: int = 192,
                 heads: int = 3, dim_head: int = 64, dim_mlp: int = 768,
                 k: int = 1, kernel_size: int = 3, dilation: int = 1,
                 padding: int = 1, stride: int = 1, dropout: float = 0.0,
                 emb_dropout: float = 0.0, sd: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.emb_dropout = dtype, emb_dropout
        self.side = image_size // patch_size
        self.embedding = zl.slots({
            0: nn.Conv2d(3, dim, patch_size, stride=patch_size),
            2: AbsPosEmbedding(self.side ** 2, dim)})
        self.transformers = nn.ModuleList(
            ConViTBlock(dim, heads, dim_head, dim_mlp, k, kernel_size,
                        dilation, padding, stride, dropout,
                        sd * i / (depth - 1) if depth > 1 else 0.0)
            for i in range(depth))
        self.classifier = _head(dim, num_classes, 2, 3)

    def forward(self, x: torch.Tensor, generators: zl.Generators = None,
                taps: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        x = _tokens(zl.conv(x.to(self.dtype), self.embedding["0"]))
        x = self.embedding["2"](x)
        x = zl.train_dropout(x, self.emb_dropout, self.training, generators)
        x = zl.tap(taps, _map(x, self.side, self.side))
        for blk in self.transformers:
            x = zl.tap(taps, blk(x, generators))
        return _apply_head(self.classifier, x.mean(dim=(2, 3)))


# -------------------------------------------------------------- AlterNet

class LocalAttention(nn.Module):
    """AlterNet's `LocalAttention`: window partition and Attention2d
    (`attn`) with a relative position bias (`pos_embedding`)."""

    def __init__(self, dim_in: int, dim_out: int, heads: int, dim_head: int,
                 window: int, k: int = 1):
        super().__init__()
        self.window = window
        self.pos_embedding = zl.randn_param(2 * window - 1, 2 * window - 1)
        self.attn = Attention2d(dim_in, dim_out, heads, dim_head, k)

    def forward(self, x, gens=None):
        b, _, h, w = x.shape
        p = self.window
        if h % p or w % p:
            raise ValueError(f"feature map {h}x{w} not divisible by window "
                             f"{p}")
        rows, cols = _rel_index_on(p, 0, self.pos_embedding.device)
        mask = self.pos_embedding[rows, cols].to(x.dtype)
        y = self.attn(_windows(x, p), mask=mask, gens=gens)
        return _unwindows(y, b, h, w)


class AttentionBlockB(nn.Module):
    """AlterNet's `AttentionBlockB`: BN (`norm1`) and GELU, a 1×1 conv to
    the width (`conv`), BN (`norm2`), LocalAttention to out·expansion; a
    1×1 `shortcut` (strided) from the pre-activation where the shape
    changes."""

    def __init__(self, block: str, in_ch: int, out_ch: int, stride: int,
                 heads: int, dim_head: int, window: int, k: int,
                 sd: float = 0.0):
        super().__init__()
        exp = 4 if block == "bottleneck" else 1
        width = in_ch // exp
        self.sd = sd
        self.norm1 = zl.bn2d(in_ch)
        self.shortcut = None
        if stride != 1 or in_ch != out_ch * exp:
            self.shortcut = zl.slots({0: zl.conv2d(in_ch, out_ch * exp, 1,
                                                   stride=stride)})
        self.conv = zl.conv2d(in_ch, width, 1)
        self.norm2 = zl.bn2d(width)
        self.attn = LocalAttention(width, out_ch * exp, heads, dim_head,
                                   window, k)

    def forward(self, x, gens=None):
        h = F.gelu(zl.bn(x, self.norm1))
        skip = x if self.shortcut is None else zl.conv(h, self.shortcut["0"])
        y = zl.bn(zl.conv(h, self.conv), self.norm2)
        y = self.attn(y, gens)
        return zl.drop_path(y, self.sd, self.training, gens) + skip


class AlterNetZoo(nn.Module):
    """`alternet.py`: a conv stem (`layer0.layer0.0`, max pool with the
    ImageNet stem), four stages of pre-activation ResNet blocks whose last
    `num_blocks2[i]` odd positions are attention blocks, and a BN-GAP
    classifier."""

    def __init__(self, num_blocks: Sequence[int] = (2, 2, 2, 2),
                 num_blocks2: Sequence[int] = (0, 1, 1, 1),
                 heads: Sequence[int] = (3, 6, 12, 24), block: str = "basic",
                 num_classes: int = 10, stem: bool = False,
                 window_size: int = 7, k: int = 1, dim_head: int = 64,
                 sd: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.stem = dtype, stem
        exp = 4 if block == "bottleneck" else 1
        self.layer0 = nn.Module()
        self.layer0.layer0 = zl.slots({0: zl.conv2d(3, 64, 7, 2, 3) if stem
                                       else zl.conv2d(3, 64, 3, 1, 1)})
        sds = zl.stochastic_depths(sd, num_blocks)
        in_ch = 64
        for li, (n, n2, out_ch, stride) in enumerate(zip(
                num_blocks, num_blocks2, (64, 128, 256, 512), (1, 2, 2, 2)),
                start=1):
            alt_seq = [False] * (n - n2 * 2) + [False, True] * n2
            blocks = []
            for bi, alt in enumerate(alt_seq):
                s = stride if bi == 0 else 1
                if alt:
                    blocks.append(AttentionBlockB(
                        block, in_ch, out_ch, s, heads[li - 1], dim_head,
                        window_size, k, sds[li - 1][bi]))
                else:
                    blocks.append(PreBlock(block, in_ch, out_ch, s,
                                           sd=sds[li - 1][bi]))
                in_ch = out_ch * exp
            setattr(self, f"layer{li}", nn.ModuleList(blocks))
        self.classifier = zl.slots({0: zl.BNGAPBlock(512 * exp,
                                                     num_classes)})

    def forward(self, x: torch.Tensor, generators: zl.Generators = None,
                taps: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        x = zl.conv(x.to(self.dtype), self.layer0.layer0["0"])
        if self.stem:
            x = zl.max_pool(x, 3, 2, 1)
        for li in range(1, 5):
            for blk in getattr(self, f"layer{li}"):
                x = zl.tap(taps, blk(x, generators))
        return self.classifier["0"](x)


# ----------------------------------------------------------------- Mixer

class MixerBlock(nn.Module):
    """A token mix (`ff1`, Conv1d over the tokens) and a channel mix
    (`ff2`, Linear), each after a LayerNorm and with a residual."""

    def __init__(self, n: int, hidden: int, spatial: int, channel: int,
                 dropout: float = 0.0, sd: float = 0.0):
        super().__init__()
        self.sd = sd
        self.norm1 = nn.LayerNorm(hidden)
        self.ff1 = FeedForward(n, spatial, n, dropout, kind="tokens")
        self.norm2 = nn.LayerNorm(hidden)
        self.ff2 = FeedForward(hidden, channel, hidden, dropout)

    def forward(self, x, gens=None, taps=None):
        h = self.ff1(zl.layer_norm(x, self.norm1), gens)
        x = zl.tap(taps, zl.drop_path(h, self.sd, self.training, gens) + x)
        h = self.ff2(zl.layer_norm(x, self.norm2), gens)
        return zl.tap(taps, zl.drop_path(h, self.sd, self.training, gens) + x)


class MixerZoo(nn.Module):
    """`mixer.py`: patch embedding, `depth` Mixer blocks (`mlps`),
    LayerNorm (`classifier.0`), mean over the tokens, Linear
    (`classifier.2`)."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 num_classes: int = 10, depth: int = 8,
                 hidden_dim: int = 256, spatial_dim: int = 128,
                 channel_dim: int = 1024, dropout: float = 0.0,
                 sd: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        if image_size % patch_size:
            raise ValueError("image must be divisible by patch size")
        self.dtype = dtype
        n = (image_size // patch_size) ** 2
        self.embedding = zl.slots({0: PatchEmbedding(patch_size,
                                                     hidden_dim)})
        self.mlps = nn.ModuleList(
            MixerBlock(n, hidden_dim, spatial_dim, channel_dim, dropout,
                       sd * i / (depth - 1) if depth > 1 else 0.0)
            for i in range(depth))
        self.classifier = zl.slots({0: nn.LayerNorm(hidden_dim),
                                    2: nn.Linear(hidden_dim, num_classes)})

    def forward(self, x: torch.Tensor, generators: zl.Generators = None,
                taps: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        x = zl.tap(taps, self.embedding["0"](x.to(self.dtype)))
        for blk in self.mlps:
            x = blk(x, generators, taps)
        x = zl.layer_norm(x, self.classifier["0"]).mean(dim=1)
        return zl.linear(x, self.classifier["2"])


def ensemble_logits(member_logits: Sequence[torch.Tensor]) -> torch.Tensor:
    """log Σ_m softmax_m over the members (the reference's log-probability
    sum: a constant log M above the mean, the same ranking)."""
    xs = torch.stack(list(member_logits))
    xs = xs - torch.logsumexp(xs, dim=-1, keepdim=True)
    return torch.logsumexp(xs, dim=0)
