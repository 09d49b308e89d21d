"""Row-band halo exchange for one frame over several processes
(counterpart of `dehaze_tpu/parallel/halo.py`).

The canvas splits into horizontal bands, one per rank, in rank order, and
each rank runs the Uformer on its band. Every op of the forward is
band-local except

  - the 3×3 convs (InputProj, OutputProj, LeFF's depthwise conv) and the
    4×4/s2 Downsample: one row from each neighbour band (`halo_rows`);
  - the SW-MSA cyclic roll: a true cyclic rotation of rows across the band
    ring (`roll_rows`); columns roll locally.

FFA-Net's 3×3 convs take the same one-row halos, and its global average
pools average the bands' means (`mean_over_bands`).

Without `wrap` the edge bands receive zero rows, which is the zero padding
the single-process conv applies at the canvas edge; with `wrap` the ring
is cyclic. Every exchange is one `all_gather` of each band's edge rows:
one code path that runs under NCCL across GPUs and under gloo on the CPU
(and for two ranks that share one GPU), where NCCL has no point-to-point
alternative for ranks on one device. With n bands it moves n/2 times the
bytes of a point-to-point exchange. Bands must stay window-aligned through
all four downsamplings (`infer.halo_sharded`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.distributed as dist

from dehaze_tpu_torch.parallel import dist as pdist


@dataclasses.dataclass(frozen=True)
class Bands:
    """This process's band: band `index` of `count`, over the default
    process group (count 1 needs none)."""

    index: int = 0
    count: int = 1

    @classmethod
    def of_group(cls) -> "Bands":
        return cls(pdist.rank(), pdist.world())


def _gather(x: torch.Tensor, bands: Bands) -> List[torch.Tensor]:
    """Every band's `x` (the same shape on each), in band order."""
    x = x.contiguous()
    if bands.count == 1:
        return [x]
    parts = [torch.empty_like(x) for _ in range(bands.count)]
    dist.all_gather(parts, x)
    return parts


def halo_rows(x: torch.Tensor, up: int, down: int, bands: Bands,
              wrap: bool = False) -> torch.Tensor:
    """[B, Hl, W, C] → [B, up + Hl + down, W, C]: the previous band's last
    `up` rows above, the next band's first `down` rows below. Without
    `wrap` the first band gets zeros above and the last zeros below."""
    if up == 0 and down == 0:
        return x
    n, d = bands.count, bands.index
    parts = _gather(torch.cat([x[:, :down], x[:, x.shape[1] - up:]], 1),
                    bands)
    out = []
    if up:
        out.append(parts[(d - 1) % n][:, down:] if wrap or d > 0
                   else x.new_zeros((x.shape[0], up) + x.shape[2:]))
    out.append(x)
    if down:
        out.append(parts[(d + 1) % n][:, :down] if wrap or d < n - 1
                   else x.new_zeros((x.shape[0], down) + x.shape[2:]))
    return torch.cat(out, 1)


def roll_rows(x: torch.Tensor, shift: int, bands: Bands) -> torch.Tensor:
    """The band's rows of `torch.roll(canvas, -shift, dims=1)`: rows move
    up by `shift` (down for a negative shift) across the band ring."""
    if shift == 0:
        return x
    n, d = bands.count, bands.index
    if shift > 0:  # my first rows become the previous band's last
        recv = _gather(x[:, :shift], bands)[(d + 1) % n]
        return torch.cat([x[:, shift:], recv], 1)
    s = -shift  # my last rows become the next band's first
    recv = _gather(x[:, x.shape[1] - s:], bands)[(d - 1) % n]
    return torch.cat([recv, x[:, :x.shape[1] - s]], 1)


def cyclic_shift_banded(x: torch.Tensor, shift: int, bands: Bands
                        ) -> torch.Tensor:
    """The band's part of `ops.window.cyclic_shift` of the canvas (rows and
    columns rolled by -shift); columns roll locally."""
    return roll_rows(torch.roll(x, -shift, dims=2), shift, bands)


def cyclic_unshift_banded(x: torch.Tensor, shift: int, bands: Bands
                          ) -> torch.Tensor:
    return roll_rows(torch.roll(x, shift, dims=2), -shift, bands)


def mean_over_bands(x: torch.Tensor, bands: Bands) -> torch.Tensor:
    """The mean of every band's `x` (each band's mean over its rows), the
    same on every rank: the canvas's mean when the bands have equal
    heights. Summed in band order from one `all_gather`, so every rank
    gets the same bits."""
    if bands.count == 1:
        return x
    parts = _gather(x, bands)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total / bands.count


def gather_bands(x: torch.Tensor, bands: Bands) -> torch.Tensor:
    """Every band's rows [B, Hl, ...] stacked into the canvas [B, n·Hl,
    ...], on every rank."""
    return torch.cat(_gather(x, bands), 1)


def band_rows(canvas: torch.Tensor, bands: Optional[Bands]) -> torch.Tensor:
    """This band's rows of a [B, L, ...] canvas (L divisible by the band
    count)."""
    if bands is None:
        return canvas
    h = canvas.shape[1] // bands.count
    return canvas[:, bands.index * h:(bands.index + 1) * h]
