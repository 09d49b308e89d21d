#!/usr/bin/env python3
"""Time K1's forward (ProbSparse window attention) at the nine stages of one
serving frame, on one NVIDIA GPU, from the port found under --root.

    python3 scripts/k1_stages.py [--root DIR] [--reps N] [--twin]

The shapes are Uformer-32's on the rect canvas 1280×1664: at each stage one
unshifted and one shifted block (region ids of the stage's map), N = 64,
head dim 32, bf16, q/k/v at std 0.5, a rel-pos bias, seeded inputs. These
are the 18 K1 forward launches of a serving frame. --root names a checkout
holding `dehaze_tpu_torch/` (default: this repository), so that two trees'
kernels are timed on the same card in one call. Prints one line per stage,
then a JSON line with each launch's kernel ms (CUDA events, mean of --reps
calls after a warm-up) and its bound and, with --twin, the plain twin's ms
and the largest |kernel - twin|. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (stage, windows B_, C, heads, stage map H x W)
STAGES = [("enc0", 33280, 32, 1, (1280, 1664)),
          ("enc1", 8320, 64, 2, (640, 832)),
          ("enc2", 2080, 128, 4, (320, 416)),
          ("enc3", 520, 256, 8, (160, 208)),
          ("bottleneck", 130, 512, 16, (80, 104)),
          ("dec0", 520, 512, 16, (160, 208)),
          ("dec1", 2080, 256, 8, (320, 416)),
          ("dec2", 8320, 128, 4, (640, 832)),
          ("dec3", 33280, 64, 2, (1280, 1664))]
HBM_BPS, BF16_FLOPS = 3.35e12, 989e12  # H100 SXM data sheet


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--twin", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    from dehaze_tpu_torch.ops import probsparse as ps_ops
    from dehaze_tpu_torch.ops import window as win_ops
    from dehaze_tpu_torch.ops.kernels.window_attention import (
        window_attention_fwd)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1238)
    N, u = 64, ps_ops.probsparse_u(64)
    si = torch.from_numpy(np.random.default_rng(1234).integers(
        0, N, size=(N, u)).astype(np.int32))
    rows = []
    for name, B, C, heads, (H, W) in STAGES:
        bias = torch.randn(heads, N, N, generator=g, device=dev) * 0.1
        q, k, v = (torch.randn(B, N, C, generator=g, device=dev).mul_(0.5)
                   .bfloat16() for _ in range(3))
        for region in (None, torch.from_numpy(win_ops.shift_region_ids(
                H, W, 8, 4)).to(dev)):
            kw = dict(num_heads=heads, sample_idx=si, rel_pos_bias=bias,
                      sw_region=region)
            nW = 1 if region is None else region.shape[0]
            nbytes = (4 * q.numel() * 2 + bias.numel() * 4 + N * N * 4
                      + (0 if region is None else nW * N * 4))
            flops = B * heads * (2 * N * N * (C // heads)
                                 + 2 * u * N * (C // heads))
            b_bytes = nbytes / HBM_BPS * 1e3
            b_ops = flops / BF16_FLOPS * 1e3
            row = {"stage": name, "shifted": region is not None,
                   "windows": B, "C": C, "heads": heads,
                   "ms": cuda_ms(lambda: window_attention_fwd(
                       q, k, v, num_windows=nW, **kw), args.reps),
                   "bound_ms": max(b_bytes, b_ops),
                   "bound_by": "bytes" if b_bytes >= b_ops else "operations"}
            if args.twin:
                got = window_attention_fwd(q, k, v, num_windows=nW, **kw)
                want = ps_ops.probsparse_attention_bnc(q, k, v, **kw)
                row["max_abs_err"] = float((got.float() - want.float())
                                           .abs().max())
                row["plain_ms"] = cuda_ms(
                    lambda: ps_ops.probsparse_attention_bnc(q, k, v, **kw), 2)
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            rows.append(row)
            print(f"{name} B_={B} C={C} h={heads} shifted="
                  f"{region is not None}: {row['ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
                  f"{row['share_of_bound']:.2%} of it"
                  + (f"; twin {row['plain_ms']:.3f} ms, max|d| "
                     f"{row['max_abs_err']:.3e}" if args.twin else ""),
                  flush=True)
        del q, k, v
    total = sum(r["ms"] for r in rows)
    print(f"18 K1 forward launches of a serving frame: {total:.3f} ms",
          flush=True)
    print(json.dumps({"root": os.path.abspath(args.root),
                      "frame_ms": total, "stages": rows}), flush=True)


if __name__ == "__main__":
    main()
