#!/usr/bin/env python3
"""Time K1 (ProbSparse window attention) at the nine stages of one serving
frame (forward) or of one train step (backward, --bwd), on one NVIDIA GPU,
from the port found under --root.

    python3 scripts/k1_stages.py [--root DIR [--root DIR2]] [--reps N]
        [--twin] [--bwd] [--numerics v4|v23|v1|v2hm]
        [--dtype bfloat16|float32] [--save DIR]

The shapes are Uformer-32's, N = 64, head dim 32, bf16 (or --dtype
float32), q/k/v at std 0.5 (the output gradient at std 1), a rel-pos bias,
seeded inputs: at each stage one unshifted and one shifted block (region
ids of the stage's map; the 8×8 bottleneck of a 128² crop does not shift).
Forward: the rect canvas 1280×1664, the 18 K1 forward launches of a
serving frame. --bwd: batch 32 × 128², the 18 K1 backward calls of a train
step. --root names a checkout holding `dehaze_tpu_torch/` (default: this
repository). Prints one line per stage, then a JSON line with each call's
kernel ms (CUDA events, mean of --reps calls after a warm-up) and its bound
and, with --twin, the plain twin's ms and the largest |kernel - twin| (over
dq, dk and dv in the backward, relative to each tensor's largest |twin|).
The bound is the larger of the bytes over 3.35 TB/s and the operations over
their peak on the card: bf16 at 989 TFLOP/s; float32's S (QK^T, an ordered
float64 fma chain per element, which the tensor cores do not give) at 34
TFLOP/s, the float64 rate of the CUDA cores, and its other products at 67.
--save DIR writes each call's output (the backward's gradients) to
DIR/<stage>_<shifted>.pt. With two roots (say the parent and the change),
it runs itself once per root in turns, A, B, B, A, each in a process of
its own on the same card, then compares the two trees' outputs bit for bit
at each call (NaN matches NaN); its JSON line gives each root's ms and
18-call totals. --numerics v23 times
K3-v3 (`window_attention_v3_fwd` / `_bwd`, the same kernels with K3-v3's
rounding points) at the same shapes instead; no path runs it, but its
per-stage times compare with K1's. --numerics v1 and v2hm time the
head-major K3-v1 and K3-v2 forwards (`probsparse_window_attention_v1` /
`_v2`, q/k/v [B_, heads, N, D]) at the same shapes; no path runs them
either, and they take no precomputed counts, so each call builds its own
(as chip_smoke.py times them). The sample-count matrix is otherwise built
once, as the model builds it once per forward. Imports nothing of JAX.
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
# a train step at batch 32 × 128²
BWD_STAGES = [("enc0", 8192, 32, 1, (128, 128)),
              ("enc1", 2048, 64, 2, (64, 64)),
              ("enc2", 512, 128, 4, (32, 32)),
              ("enc3", 128, 256, 8, (16, 16)),
              ("bottleneck", 32, 512, 16, None),
              ("dec0", 128, 512, 16, (16, 16)),
              ("dec1", 512, 256, 8, (32, 32)),
              ("dec2", 2048, 128, 4, (64, 64)),
              ("dec3", 8192, 64, 2, (128, 128))]
# H100 SXM data sheet: HBM bytes/s; bf16 tensor-core, float64 and float32
# CUDA-core FLOP/s
HBM_BPS, BF16_FLOPS, F64_FLOPS, F32_FLOPS = 3.35e12, 989e12, 34e12, 67e12


def bound_ms(nbytes: float, s_flops: float, other_flops: float,
             dtype: str):
    """(bound ms, what bounds it): bytes against the products (S and the
    rest) at their type's peak (see the docstring)."""
    if dtype == "bfloat16":
        ops = (s_flops + other_flops) / BF16_FLOPS
    else:
        ops = s_flops / F64_FLOPS + other_flops / F32_FLOPS
    t_bytes = nbytes / HBM_BPS
    return (max(t_bytes, ops) * 1e3,
            "bytes" if t_bytes >= ops else "operations")


def _save_path(save: str, row: dict) -> str:
    return os.path.join(save, f"{row['stage']}_{int(row['shifted'])}.pt")


def compare_roots(args) -> None:
    """Run each of the two roots twice in turns (A, B, B, A), the first run
    of each saving its outputs, then compare the outputs call by call."""
    import shutil
    import subprocess
    import tempfile

    import torch

    roots = [os.path.abspath(r) for r in args.root]
    tmp = tempfile.mkdtemp(prefix="k1_stages_")
    runs = []
    try:
        for turn, i in enumerate((0, 1, 1, 0)):
            cmd = [sys.executable, os.path.abspath(__file__), "--root",
                   roots[i], "--reps", str(args.reps), "--numerics",
                   args.numerics, "--dtype", args.dtype]
            if args.bwd:
                cmd.append("--bwd")
            if turn < 2:
                cmd += ["--save", os.path.join(tmp, str(i))]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                sys.exit(f"{roots[i]}: exit {r.returncode}\n{r.stderr[-3000:]}")
            print(f"run {turn + 1} ({roots[i]}): "
                  f"{r.stdout.splitlines()[-2]}", flush=True)
            runs.append((i, json.loads(r.stdout.splitlines()[-1])))
        calls = []
        for k, row in enumerate(runs[0][1]["stages"]):
            a, b = (torch.load(_save_path(os.path.join(tmp, str(i)), row))
                    for i in (0, 1))
            a = a if isinstance(a, (list, tuple)) else [a]
            b = b if isinstance(b, (list, tuple)) else [b]
            n_diff, numel, worst = 0, 0, 0.0
            for x, y in zip(a, b):
                if x is None:
                    continue
                x, y = x.cuda(), y.cuda()
                ints = torch.int16 if x.element_size() == 2 else torch.int32
                same = (x.view(ints) == y.view(ints)) | (x.isnan() & y.isnan())
                n_diff += int((~same).sum())
                numel += x.numel()
                if not bool(same.all()):
                    worst = max(worst, float((x.float() - y.float()).abs()
                                             [~same].max()))
            ms = [[r["stages"][k]["ms"] for i, r in runs if i == j]
                  for j in (0, 1)]
            call = {"stage": row["stage"], "shifted": row["shifted"],
                    "ms": ms, "equal": n_diff == 0, "n_diff": n_diff,
                    "numel": numel, "max_abs_diff": worst}
            calls.append(call)
            same = ("bit for bit equal" if not n_diff else
                    f"{n_diff} of {numel} elements differ, max|d| "
                    f"{worst:.3e}")
            print(f"{row['stage']} shifted={row['shifted']}: {same}; ms "
                  f"{ms[0]} against {ms[1]}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    key = "step_ms" if args.bwd else "frame_ms"
    totals = [[r[key] for i, r in runs if i == j] for j in (0, 1)]
    print(f"18 calls: {roots[0]} {totals[0]} ms, {roots[1]} {totals[1]} ms "
          f"(in turns A, B, B, A)", flush=True)
    print(json.dumps({"roots": roots, "numerics": args.numerics,
                      "dtype": args.dtype, "bwd": args.bwd, key: totals,
                      "stages": calls}), flush=True)


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
    ap.add_argument("--root", action="append")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--twin", action="store_true")
    ap.add_argument("--bwd", action="store_true")
    ap.add_argument("--numerics", choices=("v4", "v23", "v1", "v2hm"),
                    default="v4")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--save", default=None)
    args = ap.parse_args()
    head_major = args.numerics in ("v1", "v2hm")
    if head_major and args.bwd:
        sys.exit("K3-v1 and v2 have no backward")
    roots = args.root or [HERE]
    if len(roots) > 2:
        sys.exit("--root takes one or two checkouts")
    if len(roots) == 2:
        if args.twin or args.save:
            sys.exit("two roots compare the kernels: no --twin or --save")
        compare_roots(args)
        return
    args.root = roots[0]
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    from dehaze_tpu_torch.ops import probsparse as ps_ops
    from dehaze_tpu_torch.ops import window as win_ops
    from dehaze_tpu_torch.ops.kernels import window_attention as K1

    count_matrix = K1.count_matrix
    fwd, bwd = {
        "v4": (K1.window_attention_fwd, K1.window_attention_bwd),
        "v23": (K1.window_attention_v3_fwd, K1.window_attention_v3_bwd),
        "v1": (K1.probsparse_window_attention_v1, None),
        "v2hm": (K1.probsparse_window_attention_v2, None)}[args.numerics]
    # the twins' name of the numerics; the head-major twins
    numerics = {"v1": "v1", "v2hm": "v23"}.get(args.numerics, args.numerics)
    twin_hm = (ps_ops.probsparse_attention_v1 if args.numerics == "v1"
               else ps_ops.probsparse_attention_v2)

    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1238)
    N, u = 64, ps_ops.probsparse_u(64)
    si = torch.from_numpy(np.random.default_rng(1234).integers(
        0, N, size=(N, u)).astype(np.int32))
    # the sample counts, built once as the model's forward builds them for
    # its kernel calls (and not on the host for every timed call)
    cnt = count_matrix(si, N, dev)
    rows = []
    for name, B, C, heads, hw in BWD_STAGES if args.bwd else STAGES:
        bias = torch.randn(heads, N, N, generator=g, device=dev) * 0.1
        shape = (B, heads, N, C // heads) if head_major else (B, N, C)
        q, k, v = (torch.randn(*shape, generator=g, device=dev).mul_(0.5)
                   .to(dtype) for _ in range(3))
        go = (torch.randn(B, N, C, generator=g, device=dev).to(dtype)
              if args.bwd else None)
        regions = (None, None if hw is None else torch.from_numpy(
            win_ops.shift_region_ids(hw[0], hw[1], 8, 4)).to(dev))
        for region in regions:
            kw = dict(num_heads=heads, sample_idx=si, rel_pos_bias=bias,
                      sw_region=region)
            nW = 1 if region is None else region.shape[0]
            if head_major:
                hkw = dict(sample_idx=si, rel_pos_bias=bias, sw_region=region)

                def kern():
                    return fwd(q, k, v, num_windows=nW, **hkw)

                def twin():
                    return twin_hm(q, k, v, **hkw)
            elif args.bwd:
                def kern():
                    return bwd(q, k, v, go, num_windows=nW, cnt=cnt, **kw)

                def twin():
                    return ps_ops.probsparse_attention_bnc_bwd(
                        q, k, v, go, numerics=numerics, **kw)
            else:
                def kern():
                    return fwd(q, k, v, num_windows=nW, cnt=cnt, **kw)

                def twin():
                    return ps_ops.probsparse_attention_bnc(
                        q, k, v, numerics=numerics, **kw)
            # bytes: q/k/v and out (q/k/v/g and dq/dk/dv, the bias read and
            # dbias written in a backward), the counts, the region ids;
            # operations: S and the kept rows' products (PV; dv, da2, dq
            # and dk in a backward)
            nbytes = ((7 if args.bwd else 4) * q.numel() * q.element_size()
                      + (2 if args.bwd else 1) * bias.numel() * 4
                      + N * N * 4 + (0 if region is None else nW * N * 4))
            b_ms, b_by = bound_ms(
                nbytes, B * heads * 2 * N * N * (C // heads),
                B * heads * (8 if args.bwd else 2) * u * N * (C // heads),
                args.dtype)
            row = {"stage": name, "shifted": region is not None,
                   "windows": B, "C": C, "heads": heads,
                   "ms": cuda_ms(kern, args.reps),
                   "bound_ms": b_ms, "bound_by": b_by}
            if args.twin:
                got, want = kern(), twin()
                if args.bwd:
                    row["max_rel_err"] = max(
                        float((a.float() - b.float()).abs().max()
                              / b.float().abs().max())
                        for a, b in zip(got[:3], want[:3]))
                else:
                    row["max_abs_err"] = float((got.float() - want.float())
                                               .abs().max())
                row["plain_ms"] = cuda_ms(twin, 2)
            if args.save:
                os.makedirs(args.save, exist_ok=True)
                got = kern()
                torch.save([t.cpu() if t is not None else None for t in got]
                           if args.bwd else got.cpu(),
                           _save_path(args.save, row))
                del got
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            rows.append(row)
            err = ("" if not args.twin else
                   f"; twin {row['plain_ms']:.3f} ms, max|d| "
                   + (f"{row['max_rel_err']:.3e} of max|ref|" if args.bwd
                      else f"{row['max_abs_err']:.3e}"))
            print(f"{name} B_={B} C={C} h={heads} shifted="
                  f"{region is not None}: {row['ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
                  f"{row['share_of_bound']:.2%} of it" + err, flush=True)
        del q, k, v, go
    total = sum(r["ms"] for r in rows)
    what = ("backward calls of a train step" if args.bwd
            else "forward launches of a serving frame")
    name = {"v4": "K1", "v23": "K3-v3", "v1": "K3-v1",
            "v2hm": "K3-v2"}[args.numerics]
    print(f"18 {name} {what}: {total:.3f} ms", flush=True)
    print(json.dumps({"root": os.path.abspath(args.root),
                      "numerics": args.numerics, "dtype": args.dtype,
                      "step_ms" if args.bwd else "frame_ms": total,
                      "stages": rows}), flush=True)


if __name__ == "__main__":
    main()
