"""Frames spread over several GPUs, one process per GPU (counterpart of
`dehaze_tpu/infer/sharded.py`).

Frames never communicate, so a batch of frames is embarrassingly parallel:
rank r of P takes frames r, r + P, r + 2P, ... and runs each whole on its
own device, with no collective inside the forward. The results are
gathered to every rank in input order. A short tail needs no padded frame:
a rank with fewer frames than the others waits at the gather. Used by
`cli.test_long --data_axis` (each rank decodes and scores its own frames),
`infer.stream` (each rank decodes, runs and encodes its own share) and the
trainer's evaluation under DDP; output quantization is `infer.tiled.
quantize_u8`, `data.images.save_img`'s rounding.
"""

from __future__ import annotations

from typing import Any, Callable, List

from dehaze_tpu_torch.parallel import dist


def frame_share(n: int) -> range:
    """This rank's indices of n frames: rank, rank + P, ..."""
    return range(dist.rank(), n, dist.world())


def map_frames(fn: Callable[[int], Any], n: int) -> List[Any]:
    """[fn(0), ..., fn(n - 1)] on every rank, in input order, with fn(i)
    computed on rank i % P only; fn's results are pickled to the other
    ranks."""
    merged = {}
    for part in dist.gather_objects({i: fn(i) for i in frame_share(n)}):
        merged.update(part)
    return [merged[i] for i in range(n)]
