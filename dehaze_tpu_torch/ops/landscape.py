"""Filter-normalized loss-landscape sweeps (counterpart of
`dehaze_tpu/ops/landscape.py`; the reference's `*/ops/loss_landscapes.py`
and its crash-merge flow).

A parameter set is an ordered dict name → tensor: the model's named
parameters (not its buffers), in `named_parameters` order. The grid point
(x, y) is the model at w0 + x·b1 + y·b2, evaluated through
`torch.func.functional_call` by the caller's `loss_on_dataset`.

Where the JAX package's pytree and the port's named parameters differ,
the port follows the JAX package, so that both compute the same numbers:

- `normalize_filter` takes norms over axis 0 of the JAX layouts. Through
  the weight bridge (`utils.convert`) that axis is dim 1 of a Linear weight
  (a Dense kernel's input axis) and dim 2 of a Conv2d or ConvTranspose2d
  weight (an HWIO kernel's kh axis); every other tensor keeps its layout
  (dim 0). `filter_dims(model)` maps each name to its dim.
- With `attention='full'` and `token_projection='linear'`, the JAX package
  holds `to_q` and `to_kv` as one fused `qkv` leaf (weight and bias).
  `tensor_groups` joins them again, so the per-tensor sums (`param_l2`)
  and the trajectory's per-tensor averages count the fused leaf once.
- `create_bases` draws from `torch.Generator`s seeded as the JAX package
  seeds its keys (`(seed << 1) + i`), in `named_parameters` order: the
  bases differ from the JAX package's at the same seed (torch cannot
  reproduce `jax.random`); given the same bases, the sweeps agree.

Every completed grid point is appended to the CSV at once, so an
interrupted sweep resumes by skipping the coordinates already present;
the CSV is the JAX package's (`x,y,l1,l2,loss`, the same coordinates), so
either package reads, resumes and merges the other's files.
"""

from __future__ import annotations

import csv
import glob
import os
import re
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from dehaze_tpu_torch.utils.plot import pyplot

Params = Dict[str, torch.Tensor]

# the reference sweep's ignored keys (`My_losslandscape.py:198`)
DEFAULT_KWS = ("pos_embed", "relative_position")


def model_params(model: torch.nn.Module) -> Params:
    """The model's named parameters, detached, in order."""
    return {k: p.detach() for k, p in model.named_parameters()}


def filter_dims(model: torch.nn.Module) -> Dict[str, int]:
    """{parameter name: the dim `normalize_filter` takes norms over}: the
    dim that is axis 0 of the JAX package's layout (see the module
    docstring)."""
    dims = {}
    for mname, m in model.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            d = 0
            if pname == "weight":
                if isinstance(m, torch.nn.Linear):
                    d = 1
                elif isinstance(m, (torch.nn.Conv2d,
                                    torch.nn.ConvTranspose2d)):
                    d = 2
            dims[f"{mname}.{pname}" if mname else pname] = d
    return dims


def tensor_groups(names: Iterable[str]) -> List[List[str]]:
    """The names as the JAX package's leaves: one group per tensor, except
    a W-MSA 'linear' projection's `qkv.to_q` and `qkv.to_kv` weight (and
    bias), which are one fused leaf there. Groups keep the names' order."""
    names = list(names)
    present = set(names)
    groups, joined = [], set()
    for k in names:
        if k in joined:
            continue
        m = re.fullmatch(r"(.*\.qkv\.)to_q\.(weight|bias)", k)
        kv = m and f"{m.group(1)}to_kv.{m.group(2)}"
        if kv and kv in present:
            groups.append([k, kv])
            joined.add(kv)
        else:
            groups.append([k])
    return groups


def normalize_filter(basis: Params, weights: Params,
                     dims: Optional[Mapping[str, int]] = None) -> Params:
    """b *= ||w||_dim / (||b||_dim + 1e-7), norms over `dims[name]` (0 where
    not given) with keepdim (`loss_landscapes.py:11-21`)."""
    dims = dims or {}
    out = {}
    for k, b in basis.items():
        d = dims.get(k, 0)
        w = weights[k]
        wn = torch.linalg.vector_norm(w, dim=d, keepdim=True)
        bn = torch.linalg.vector_norm(b, dim=d, keepdim=True)
        out[k] = wn / (bn + 1e-7) * b
    return out


def ignore_bn(basis: Params) -> Params:
    """Zero 1-D (and 0-D) tensors (`loss_landscapes.py:24-31`)."""
    return {k: torch.zeros_like(b) if b.ndim < 2 else b
            for k, b in basis.items()}


def ignore_kw(basis: Params, kws: Optional[Sequence[str]] = None) -> Params:
    """Zero tensors whose name matches any regex
    (`loss_landscapes.py:38-47`)."""
    kws = list(kws or [])
    return {k: torch.zeros_like(b) if any(re.search(kw, k) for kw in kws)
            else b for k, b in basis.items()}


def create_bases(params: Params, kws: Optional[Sequence[str]] = None,
                 seed: int = 0, dims: Optional[Mapping[str, int]] = None
                 ) -> List[Params]:
    """Two filter-normalized random bases (`loss_landscapes.py:54-72`):
    basis i draws standard normals for every tensor, in order, from a
    `torch.Generator` seeded `(seed << 1) + i` on the CPU (so every device
    gets the same bases), then `normalize_filter` (over `dims`),
    `ignore_bn` and `ignore_kw`. Not the JAX package's bases at the same
    seed: it draws from `jax.random`."""
    bases = []
    for i in range(2):
        gen = torch.Generator().manual_seed((seed << 1) + i)
        b = {k: torch.randn(w.shape, generator=gen, dtype=torch.float32
                            ).to(w.device) for k, w in params.items()}
        b = normalize_filter(b, params, dims)
        b = ignore_kw(ignore_bn(b), kws)
        bases.append(b)
    return bases


def perturb(params: Params, bases: Sequence[Params], x: float, y: float
            ) -> Params:
    """w0 + x·b1 + y·b2 (`loss_landscapes.py:108-111`), x and y rounded to
    float32 as the JAX package passes them."""
    x, y = float(np.float32(x)), float(np.float32(y))
    return {k: w + x * bases[0][k] + y * bases[1][k]
            for k, w in params.items()}


def param_l1(params: Params) -> float:
    """Σ ||p||_1 over tensors (`ops/norm.py:4-12`)."""
    return float(sum(p.abs().sum() for p in params.values()))


def param_l2(params: Params) -> float:
    """Σ ||p||_2 over the JAX package's leaves (`tensor_groups`): a sum of
    per-tensor norms (`ops/norm.py:15-21`), the fused W-MSA `qkv` one
    tensor."""
    total = 0.0
    for group in tensor_groups(params):
        sq = sum(params[k].float().square().sum() for k in group)
        total = total + torch.sqrt(sq)
    return float(total)


def grid(n: int, scale: float) -> List[Tuple[float, float]]:
    """The sweep's n×n coordinates over [-scale, scale]², x fastest, as
    Python floats of `np.linspace` (the JAX package's CSV coordinates)."""
    xs = np.linspace(-scale, scale, n)
    ys = np.linspace(-scale, scale, n)
    g = np.stack(np.meshgrid(xs, ys), axis=0).transpose(1, 2, 0)
    return [(float(x), float(y)) for x, y in g.reshape(-1, 2)]


def get_loss_landscape(
    params: Params,
    loss_on_dataset: Callable[[List[Params]], Sequence[float]],
    *,
    kws: Optional[Sequence[str]] = None,
    bases: Optional[Sequence[Params]] = None,
    dims: Optional[Mapping[str, int]] = None,
    n: int = 21,
    scale: float = 1.0,
    seed: int = 0,
    csv_path: Optional[str] = None,
    point_filter: Optional[Callable[[int], bool]] = None,
    verbose: bool = False,
    points_per_batch: int = 1,
    agree: Optional[Callable[[list], list]] = None,
) -> List[Dict[str, float]]:
    """Sweep the n×n grid over [-scale, scale]² (`loss_landscapes.py:
    75-124`).

    loss_on_dataset(points) takes a list of perturbed parameter sets and
    returns their mean losses over the eval set, in order; the caller owns
    the batches and the model. Points go to it `points_per_batch` (P) at a
    time: every call has exactly P points (the last chunk is padded with
    its last point, whose results are dropped), so the caller can load and
    draw each batch once for P points. The rows do not depend on P.

    Rows: {x, y, l1, l2, loss}. With csv_path, each point is appended and
    flushed as it completes; points already in the file are skipped, and
    the header is written only to an empty file (a sweep killed after the
    header resumes without a second one). `agree` (a process group's
    sweep) maps this process's list of pending points to the list every
    process sweeps (rank 0's, which alone reads and writes the CSV)."""
    bases = bases if bases is not None else create_bases(params, kws, seed,
                                                         dims)
    done = set()
    fh = writer = None
    if csv_path:
        os.makedirs(os.path.dirname(os.path.abspath(csv_path)),
                    exist_ok=True)
        if os.path.exists(csv_path):
            with open(csv_path) as f:
                for row in csv.DictReader(f):
                    done.add((float(row["x"]), float(row["y"])))
        has_header = (os.path.exists(csv_path)
                      and os.path.getsize(csv_path) > 0)
        fh = open(csv_path, "a", newline="")
        writer = csv.writer(fh)
        if not has_header:
            writer.writerow(["x", "y", "l1", "l2", "loss"])
            fh.flush()

    pending = [xy for i, xy in enumerate(grid(n, scale))
               if not (point_filter and not point_filter(i))
               and xy not in done]
    if agree is not None:
        pending = [tuple(xy) for xy in agree(pending)]

    rows = []
    try:
        for c in range(0, len(pending), points_per_batch):
            chunk = pending[c:c + points_per_batch]
            padded = chunk + [chunk[-1]] * (points_per_batch - len(chunk))
            points = [perturb(params, bases, x, y) for x, y in padded]
            losses = list(loss_on_dataset(points))
            for (x, y), p, loss in zip(chunk, points, losses):
                row = {"x": x, "y": y, "l1": param_l1(p), "l2": param_l2(p),
                       "loss": float(loss)}
                rows.append(row)
                if writer:
                    writer.writerow([row[k] for k in
                                     ("x", "y", "l1", "l2", "loss")])
                    fh.flush()
                if verbose:
                    print(f"Grid: [{x:+.2f} {y:+.2f}] loss: "
                          f"{row['loss']:.6f}", flush=True)
    finally:
        if fh:
            fh.close()
    return rows


def load_landscape_csv(csv_path: str) -> List[Dict[str, float]]:
    with open(csv_path) as f:
        return [{k: float(v) for k, v in row.items()}
                for row in csv.DictReader(f)]


def merge_landscape_csvs(pattern: str) -> List[Dict[str, float]]:
    """Union shard CSVs (from `--shard i/n` sweeps) into one row list
    (≙ the reference's crash-merge tool, `text.py:18-40`). Duplicate (x, y)
    points keep the last occurrence, files taken in sorted order."""
    paths = sorted(glob.glob(pattern))
    if not paths:
        raise FileNotFoundError(f"no CSVs match {pattern!r}")
    by_xy: Dict[tuple, Dict[str, float]] = {}
    for p in paths:
        for row in load_landscape_csv(p):
            by_xy[(row["x"], row["y"])] = row
    return list(by_xy.values())


def _rows_to_grid(rows: Iterable[Dict[str, float]]):
    rows = list(rows)
    xs = sorted({r["x"] for r in rows})
    ys = sorted({r["y"] for r in rows})
    g = np.full((len(ys), len(xs)), np.nan)
    xi = {v: i for i, v in enumerate(xs)}
    yi = {v: i for i, v in enumerate(ys)}
    for r in rows:
        g[yi[r["y"]], xi[r["x"]]] = r["loss"]
    return np.asarray(xs), np.asarray(ys), g


def plot_landscape(rows: Iterable[Dict[str, float]], out_path: str,
                   title: str = "loss landscape") -> None:
    """3-D surface plot (≙ `My_losslandscape.py:219-279`)."""
    plt = pyplot(f"the landscape figure {out_path}")
    xs, ys, g = _rows_to_grid(rows)
    X, Y = np.meshgrid(xs, ys)
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    ax.plot_surface(X, Y, g, cmap="viridis")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("loss")
    ax.set_title(title)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def radial_profile(rows: Iterable[Dict[str, float]]):
    """Mean RELATIVE loss rise against grid radius from the (0, 0) center:
    (radii, mean of loss(x, y) / loss(0, 0) - 1 per radius). Relative,
    because the two sweeps compared use different losses (Charbonnier+CR
    for the ViT model, L1 for FFA-Net), so raw heights do not compare."""
    rows = list(rows)
    center = [r["loss"] for r in rows if r["x"] == 0.0 and r["y"] == 0.0]
    if not center:
        raise ValueError("no (0,0) center point in landscape rows")
    c = center[0]
    by_r: Dict[float, List[float]] = {}
    for r in rows:
        rad = round(float(np.hypot(r["x"], r["y"])), 6)
        by_r.setdefault(rad, []).append(r["loss"] / c - 1.0)
    radii = np.asarray(sorted(by_r))
    rises = np.asarray([float(np.mean(by_r[r])) for r in radii])
    return radii, rises


def landscape_stats(rows: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """Scalar flatness summary of one sweep: center_loss / min_loss /
    center_is_min (is the checkpoint the grid minimum?), mean_rel_rise /
    max_rel_rise (loss / loss(0, 0) - 1 over the grid; lower = flatter),
    edge_rel_rise (the same over the grid's boundary) and points."""
    rows = list(rows)
    xs, ys, g = _rows_to_grid(rows)
    iy, ix = np.searchsorted(ys, 0.0), np.searchsorted(xs, 0.0)
    if iy >= len(ys) or ix >= len(xs) or ys[iy] != 0.0 or xs[ix] != 0.0:
        raise ValueError(
            "landscape_stats: sweep grid has no (0, 0) coordinate — the "
            "center loss (the checkpoint itself) is undefined; use an odd "
            "grid size n so linspace(-1, 1, n) contains 0")
    c = g[iy, ix]
    rel = g / c - 1.0
    edge = np.concatenate([rel[0, :], rel[-1, :], rel[1:-1, 0],
                           rel[1:-1, -1]])
    return {
        "center_loss": float(c),
        "min_loss": float(np.nanmin(g)),
        "center_is_min": bool(np.nanmin(g) == c),
        "mean_rel_rise": float(np.nanmean(rel)),
        "max_rel_rise": float(np.nanmax(rel)),
        "edge_rel_rise": float(np.nanmean(edge)),
        "points": len(rows),
    }


def plot_landscape_pair(rows_a: Iterable[Dict[str, float]],
                        rows_b: Iterable[Dict[str, float]],
                        out_path: str,
                        labels: Sequence[str] = ("ViT", "FFA"),
                        title: str = "loss landscape comparison") -> None:
    """The ViT-vs-FFA comparison figure (≙ README.md:165-209): the two raw
    surfaces as `plot_landscape` draws them, and their normalized radial
    profiles (`radial_profile`) overlaid."""
    plt = pyplot(f"the comparison figure {out_path}")
    rows_a, rows_b = list(rows_a), list(rows_b)
    fig = plt.figure(figsize=(18, 5.5))
    for i, (rows, label, cmap) in enumerate(
            [(rows_a, labels[0], "viridis"), (rows_b, labels[1], "magma")]):
        xs, ys, g = _rows_to_grid(rows)
        X, Y = np.meshgrid(xs, ys)
        ax = fig.add_subplot(1, 3, i + 1, projection="3d")
        ax.plot_surface(X, Y, g, cmap=cmap)
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        ax.set_zlabel("loss")
        ax.set_title(f"{label} (raw loss)")
    ax = fig.add_subplot(1, 3, 3)
    for rows, label, color in [(rows_a, labels[0], "tab:blue"),
                               (rows_b, labels[1], "tab:red")]:
        radii, rises = radial_profile(rows)
        ax.plot(radii, rises, marker="o", ms=3, color=color, label=label)
    ax.set_xlabel("grid radius from optimum")
    ax.set_ylabel("mean relative loss rise  loss/loss(0,0) − 1")
    ax.set_title("normalized flatness profile")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.suptitle(title)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
