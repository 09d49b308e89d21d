"""One frame over several GPUs: the canvas's rows split into bands, one per
rank, with halo exchange inside the model (counterpart of
`dehaze_tpu/infer/halo_sharded.py`).

Each rank builds the whole canvas, runs the Uformer on its band
(`models.uformer.Uformer.forward(..., bands=)`, `parallel.halo`), and the
bands are gathered back in rank order, so every rank returns the whole
output. The result is the single-process forward, not an overlap-tile
approximation. FFA-Net's protocol has no canvas: its frame's own rows are
banded (`make_halo_sharded_native_fn`).

Alignment: every band must stay window-aligned through the four
downsamplings, so the canvas height is padded up to a multiple of
n · win · 2⁴ (`band_unit` · n; 256 rows for the flagship over two bands).
The frame pads with wrap-filled rows, the any-resolution canvas with
masked zero rows below the image; both are cropped from the output. When
the canvas already divides (the rect canvas 1280×1664 of a 1200×1600
frame over 2 bands) the banded output is the single-process one; otherwise
the taller canvas moves the SW-MSA wrap seam, a valid forward that
differs near the boundary from the single-process protocol, and a warning
says so.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, Optional

import torch

from dehaze_tpu_torch.config import ModelConfig
from dehaze_tpu_torch.infer.tiled import (_as_tensor, canvas_of, u8_norm,
                                          wrap_pad_canvas)
from dehaze_tpu_torch.models.uformer import Uformer
from dehaze_tpu_torch.parallel import halo
from dehaze_tpu_torch.parallel.halo import Bands


def band_unit(cfg: ModelConfig) -> int:
    """Rows each band must be a multiple of: win · 2**num_enc_layers."""
    return cfg.win_size * (2 ** cfg.num_enc_layers)


def _aligned(rows: int, cfg: ModelConfig, bands: Bands, what: str) -> int:
    unit = band_unit(cfg) * bands.count
    padded = -(-rows // unit) * unit
    if padded != rows:
        warnings.warn(
            f"halo banding pads the {rows}-row canvas to {padded} {what} "
            f"rows for {bands.count} window-aligned bands: the SW wrap seam "
            "moves, so outputs deviate near the boundary from the "
            "single-process protocol; use a band count where canvas % "
            f"{unit} == 0 for parity", stacklevel=3)
    return padded


def _banded(model: Uformer, canvas: torch.Tensor, seed: int, bands: Bands,
            pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The model on this rank's band of `canvas`, the bands gathered back:
    the whole output on every rank."""
    out = model(halo.band_rows(canvas, bands),
                generator=torch.Generator().manual_seed(seed),
                pad_mask=pad_mask, bands=bands)
    return halo.gather_bands(out, bands)


def make_halo_sharded_frame_fn(
    model: Uformer,
    h: int,
    w: int,
    ps: int = 128,
    square: bool = False,
    seed: int = 1234,
    bands: Optional[Bands] = None,
    device="cuda",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """[B, h, w, C] (float in [0, 1] or raw uint8, tensor or ndarray; the
    same frame on every rank) → restored float32 [B, h, w, C] on `device`,
    on every rank: the whole-image protocol of `infer.tiled` (square or
    rect canvas) with the canvas's rows banded over the process group
    (`bands`, by default the group's). The sampling generator is seeded
    with `seed` at every call."""
    bands = bands or Bands.of_group()
    L, Lw = canvas_of(h, w, ps, square)
    Lp = _aligned(L, model.cfg, bands, "wrap-filled")

    @torch.inference_mode()
    def run(img):
        canvas = wrap_pad_canvas(u8_norm(_as_tensor(img, device)), L, Lw)
        if Lp != L:
            # the pad can exceed L (small frames, many bands): tile first
            reps = -(-(Lp - L) // L)
            canvas = torch.cat(
                [canvas, canvas.repeat(1, reps, 1, 1)[:, :Lp - L]], 1)
        out = _banded(model, canvas, seed, bands)
        return torch.clamp(out[:, :h, :w], 0.0, 1.0)

    return run


def make_halo_sharded_anyres_fn(
    model: Uformer,
    h: int,
    w: int,
    factor: Optional[int] = None,
    seed: int = 1234,
    bands: Optional[Bands] = None,
    device="cuda",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Any-resolution inference (`infer.anyres`: the frame centred on a zero
    X×X canvas with a padding mask) with the canvas's rows banded over the
    process group; the mask of the whole canvas goes to every band, which
    keeps its rows at each stage. Canvas rows pad to a multiple of
    band_unit · n with masked zero rows below the image."""
    bands = bands or Bands.of_group()
    factor = factor or band_unit(model.cfg)
    X = int(math.ceil(max(h, w) / float(factor)) * factor)
    Xp = _aligned(X, model.cfg, bands, "masked")
    r0, c0 = (X - h) // 2, (X - w) // 2
    pad = torch.ones((1, Xp, X, 1), dtype=torch.float32, device=device)
    pad[:, r0:r0 + h, c0:c0 + w] = 0.0  # 1 on padding

    @torch.inference_mode()
    def run(img):
        img = u8_norm(_as_tensor(img, device))
        canvas = img.new_zeros((img.shape[0], Xp, X, img.shape[-1]))
        canvas[:, r0:r0 + h, c0:c0 + w] = img
        out = _banded(model, canvas, seed, bands, pad)
        return torch.clamp(out[:, r0:r0 + h, c0:c0 + w], 0.0, 1.0)

    return run


def make_halo_sharded_native_fn(
    model: torch.nn.Module,
    bands: Optional[Bands] = None,
    device="cuda",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """FFA-Net's raw-resolution protocol (no canvas, `infer.tiled.
    make_native_image_fn`) with the frame's rows banded over the process
    group: [B, H, W, C] (float or raw uint8, tensor or ndarray; the same
    frame on every rank, normalized by the caller if the protocol wants
    it) → the clamped float32 output on `device`, on every rank. Each
    rank runs its band (`models.ffa.FFA.forward(..., bands=)`: 1-row halos
    for the 3×3 convs, rank-averaged global pools), so the result is the
    one-process forward. H must divide by the band count: the average of
    unequal bands' means would not be the frame's mean."""
    from dehaze_tpu_torch.models.ffa import FFA

    if not isinstance(model, FFA):
        arch = getattr(getattr(model, "cfg", None), "arch",
                       type(model).__name__.lower())
        raise ValueError(
            "native banded inference is FFA-only (halo convs + rank-"
            f"averaged pools); got arch={arch!r} — use "
            "make_halo_sharded_frame_fn for the Uformer canvas protocol")
    bands = bands or Bands.of_group()

    @torch.inference_mode()
    def run(img):
        x = u8_norm(_as_tensor(img, device))
        if x.shape[1] % bands.count:
            raise ValueError(
                f"native banded inference needs rows % bands == 0 (got "
                f"{x.shape[1]} rows over {bands.count} bands — unequal "
                "bands would skew the FFA global-mean pools)")
        out = model(halo.band_rows(x, bands), bands=bands)
        return torch.clamp(halo.gather_bands(out, bands), 0.0, 1.0)

    return run
