#!/usr/bin/env python3
"""Time K2 (fused LayerNorm + LeFF) at the nine stage shapes of one serving
frame, on one NVIDIA GPU, from the port found under --root.

    python3 scripts/k2_stages.py [--root DIR] [--reps N] [--twin]
                                 [--act_store fp8|int8]

The shapes are Uformer-32's on the rect canvas 1280×1664 (chip_smoke's
K2_STAGES), bf16, exact GELU, hidden width 4C, seeded random weights. --root
names a checkout holding `dehaze_tpu_torch/` (default: this repository), so
that two trees' kernels are timed on the same card in one call. Prints one
line per stage, then a JSON line with each stage's kernel ms (CUDA events,
mean of --reps calls after a warm-up), its bound and, with --twin, the plain
twin's ms and the largest |kernel - twin|. --act_store times the kernel
(and the twin) with that mode's round trips; the bound is the plain one's
(the same bytes and operations). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = [("enc0", (1, 1280, 1664, 32)), ("enc1", (1, 640, 832, 64)),
          ("enc2", (1, 320, 416, 128)), ("enc3", (1, 160, 208, 256)),
          ("bottleneck", (1, 80, 104, 512)), ("dec0", (1, 160, 208, 512)),
          ("dec1", (1, 320, 416, 256)), ("dec2", (1, 640, 832, 128)),
          ("dec3", (1, 1280, 1664, 64))]
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
    ap.add_argument("--act_store", choices=["fp8", "int8"], default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    from dehaze_tpu_torch.ops.kernels.leff import leff_fused, leff_reference

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1235)
    mode = {"act_store": args.act_store} if args.act_store else {}
    rows = []
    for name, shape in STAGES:
        C = shape[-1]
        Ch = 4 * C

        def rnd(*s, std=1.0, mean=0.0):
            return (torch.randn(*s, generator=g, device=dev) * std + mean
                    ).bfloat16()

        p = {"ln_scale": rnd(C, std=0.1, mean=1.0), "ln_bias": rnd(C, std=0.1),
             "w1": rnd(C, Ch, std=1 / math.sqrt(C)), "b1": rnd(Ch, std=0.1),
             "dw_kernel": rnd(3, 3, 1, Ch, std=1 / 3),
             "dw_bias": rnd(Ch, std=0.1),
             "w2": rnd(Ch, C, std=1 / math.sqrt(Ch)), "b2": rnd(C, std=0.1)}
        x = rnd(*shape)
        pixels = x.numel() // C
        nbytes = 2 * (2 * x.numel() + sum(t.numel() for t in p.values()))
        flops = pixels * (4 * C * Ch + 18 * Ch)
        b_bytes, b_ops = nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
        row = {"stage": name, "x": list(shape), "hidden": Ch,
               "ms": cuda_ms(lambda: leff_fused(x, **p, **mode), args.reps),
               "bound_ms": max(b_bytes, b_ops),
               "bound_by": "bytes" if b_bytes >= b_ops else "operations"}
        if args.twin:
            got = leff_fused(x, **p, **mode)
            want = leff_reference(x, **p, **mode)
            row["max_abs_err"] = float((got.float() - want.float()).abs()
                                       .max())
            row["plain_ms"] = cuda_ms(lambda: leff_reference(x, **p, **mode),
                                      3)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        print(f"{name} x={list(shape)} hidden={Ch}: {row['ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"{row['share_of_bound']:.2%} of it"
              + (f"; twin {row['plain_ms']:.3f} ms, max|d| "
                 f"{row['max_abs_err']:.3e}" if args.twin else ""),
              flush=True)
    total = 2 * sum(r["ms"] for r in rows)
    print(f"18 launches of a serving frame (2 per stage): {total:.3f} ms",
          flush=True)
    print(json.dumps({"root": os.path.abspath(args.root),
                      "act_store": args.act_store, "frame_ms": total,
                      "stages": rows}), flush=True)


if __name__ == "__main__":
    main()
