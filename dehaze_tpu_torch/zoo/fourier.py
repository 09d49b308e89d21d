"""Fourier and feature-map analysis (counterpart of
`dehaze_tpu/zoo/fourier.py`, ≙ the reference's `fourier_analysis.ipynb`
and `featuremap_variance.ipynb`): per depth, the relative log amplitude
of the Fourier-transformed feature maps (half-diagonal profile, Δ against
the lowest frequency) and the feature-map variance.

The latents are the ones a zoo model appends to `taps=[]`
(`zoo.layers.tap`), in definition order: NCHW maps and [B, N, C] tokens,
where the JAX package's are NHWC; every function here gives the JAX
package's numbers on the corresponding NHWC latents.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from dehaze_tpu_torch.zoo.evaluate import to_nchw


def collect_latents(model, x, generator: Optional[torch.Generator] = None
                    ) -> List[np.ndarray]:
    """The eval-mode model's taps on the NHWC batch x, as float32 numpy
    arrays in definition order (NCHW maps, [B, N, C] tokens). The
    generator (seed 0 by default) feeds MC dropout."""
    generator = (torch.Generator().manual_seed(0) if generator is None
                 else generator)
    model.eval()
    taps: List[torch.Tensor] = []
    with torch.inference_mode():
        model(to_nchw(x, next(model.parameters()).device),
              generators={"dropout": generator}, taps=taps)
    return [t.float().cpu().numpy() for t in taps]


def _to_map(latent: np.ndarray) -> np.ndarray:
    """A latent as an NCHW map: tokens [B, N, C] to a square map (a cls
    token dropped when N is not square), a map as it is."""
    if latent.ndim == 3:
        b, n, c = latent.shape
        side = int(math.isqrt(n))
        if side * side != n:  # cls token present (`fourier_analysis.ipynb`)
            latent = latent[:, 1:]
            n = n - 1
            side = int(math.isqrt(n))
        if side * side != n:
            raise ValueError(f"token count {n} is not square")
        return latent.reshape(b, side, side, c).transpose(0, 3, 1, 2)
    if latent.ndim == 4:
        return latent
    raise ValueError(f"shape {latent.shape}")


def fourier_latents(latents: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Δ log-amplitude half-diagonal per latent (`fourier_analysis.ipynb`):
    log|FFT2|, centred, the mean over batch and channels, the half
    diagonal, minus its lowest-frequency value."""
    out = []
    for latent in latents:
        m = _to_map(latent).astype(np.float32)
        b, c, h, w = m.shape
        f = np.fft.fft2(m, axes=(2, 3))
        f = np.log(np.abs(f) + 1e-6)
        f = np.roll(f, (h // 2, w // 2), axis=(2, 3))
        f = f.mean(axis=(0, 1))          # [H, W]
        diag = np.diagonal(f)[h // 2:]   # half-diagonal
        out.append(diag - diag[0])
    return out


def high_freq_deltas(latents: Sequence[np.ndarray]) -> np.ndarray:
    """Fig 2b's summary: Δ log amplitude at the highest frequency, per
    depth."""
    return np.array([fl[-1] for fl in fourier_latents(latents)])


def variance_latents(latents: Sequence[np.ndarray]) -> np.ndarray:
    """`featuremap_variance.ipynb`: spatial variance per (batch, channel)
    (unbiased, as torch's .var), averaged: one scalar per depth."""
    out = []
    for latent in latents:
        m = _to_map(latent).astype(np.float64)
        b, c, h, w = m.shape
        out.append(m.reshape(b, c, h * w).var(axis=-1, ddof=1).mean())
    return np.array(out)


def save_fourier_plot(deltas: Sequence[np.ndarray], path: str,
                      title: Optional[str] = None):
    """Fig 2a: Δ log amplitude against normalized frequency, one line per
    depth (the notebook's plasma colormap)."""
    from dehaze_tpu_torch.utils.plot import pyplot

    plt = pyplot(f"the Fourier figure {path}")
    import matplotlib.cm as cm

    fig, ax = plt.subplots(1, 1, figsize=(3.3, 4), dpi=150)
    n = len(deltas)
    for i, latent in enumerate(deltas):
        freq = np.linspace(0, 1, len(latent))
        ax.plot(freq, latent, color=cm.plasma_r(i / max(n - 1, 1)))
    ax.set(xlim=(0, 1), xlabel="Frequency",
           ylabel=r"$\Delta$ Log amplitude", title=title)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def save_variance_plot(variances: np.ndarray, path: str,
                       title: Optional[str] = None):
    from dehaze_tpu_torch.utils.plot import pyplot

    plt = pyplot(f"the variance figure {path}")
    fig, ax = plt.subplots(1, 1, figsize=(4, 3), dpi=150)
    ax.plot(range(len(variances)), variances, marker="o", color="tab:red")
    ax.set(xlabel="Depth", ylabel="Feature map variance", title=title)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
