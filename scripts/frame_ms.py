#!/usr/bin/env python3
"""Time one 1200×1600 frame through the whole-image function on one NVIDIA
GPU, from the port found under --root, and count its kernel launches.

    python3 scripts/frame_ms.py [--root DIR [--root DIR2]]
                                [--dtype bfloat16|float32] [--reps N]

Uformer-32 (`ModelConfig` defaults but the activation type), seeded
random-init weights (`torch.manual_seed(1234)`, as chip_smoke.py makes
them), a seeded uint8 frame on the rect canvas 1280×1664, the ProbSparse
sampling seeded per frame; TF32 off (cuBLAS and cuDNN), so a float32 frame
is float32 throughout. Prints the seconds per frame (host clock over --reps
frames after a warm-up, ending in a synchronize), the launches per frame
of every kernel counter the tree has and the calls of the plain twins,
then a JSON line. --root names a checkout holding `dehaze_tpu_torch/`
(default: this repository). With two roots (say the parent and the
change) it runs itself once per root in turns, A, B, B, A, each in a
process of its own on the same card, and gives the largest |Δ| between the
two trees' frames. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME, SEED = (1200, 1600), 1234
# (entry point, counter attributes) of every kernel, where the tree has them
COUNTERS = {"window_attention_fwd": ("launches", "launches_tc",
                                     "launches_f32"),
            "window_attention_bwd": ("launches", "launches_tc"),
            "leff_fused": ("launches",)}


def compare_roots(args) -> None:
    import torch

    roots = [os.path.abspath(r) for r in args.root]
    tmp = tempfile.mkdtemp(prefix="frame_ms_")
    runs = []
    try:
        for turn, i in enumerate((0, 1, 1, 0)):
            cmd = [sys.executable, os.path.abspath(__file__), "--root",
                   roots[i], "--reps", str(args.reps), "--dtype", args.dtype]
            if turn < 2:
                cmd += ["--save", os.path.join(tmp, f"{i}.pt")]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                sys.exit(f"{roots[i]}: exit {r.returncode}\n{r.stderr[-3000:]}")
            print(f"run {turn + 1} ({roots[i]}): "
                  f"{r.stdout.splitlines()[-2]}", flush=True)
            runs.append((i, json.loads(r.stdout.splitlines()[-1])))
        a, b = (torch.load(os.path.join(tmp, f"{i}.pt")) for i in (0, 1))
        diff = float((a - b).abs().max())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    secs = [[r["s_per_frame"] for i, r in runs if i == j] for j in (0, 1)]
    print(f"{args.dtype} frame: {roots[0]} {secs[0]} s, {roots[1]} "
          f"{secs[1]} s (in turns A, B, B, A); max|d| between the trees' "
          f"frames {diff:.3e}", flush=True)
    print(json.dumps({"roots": roots, "dtype": args.dtype,
                      "s_per_frame": secs, "max_abs_diff": diff,
                      "launches_per_frame": [runs[0][1]["launches_per_frame"],
                                             runs[1][1]["launches_per_frame"]]
                      }), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="float32")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--save", default=None)
    args = ap.parse_args()
    roots = args.root or [HERE]
    if len(roots) > 2:
        sys.exit("--root takes one or two checkouts")
    if len(roots) == 2:
        compare_roots(args)
        return
    sys.path.insert(0, os.path.abspath(roots[0]))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    from dehaze_tpu_torch.cli.common import build_model_and_params
    from dehaze_tpu_torch.config import ModelConfig
    from dehaze_tpu_torch.infer.tiled import make_whole_image_fn
    from dehaze_tpu_torch.models.uformer import Uformer
    from dehaze_tpu_torch.ops import probsparse
    from dehaze_tpu_torch.ops.kernels import leff, window_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entries = {"window_attention_fwd": window_attention.window_attention_fwd,
               "window_attention_bwd": window_attention.window_attention_bwd,
               "leff_fused": leff.leff_fused}
    counters = [(f"{name}.{attr}", entries[name], attr)
                for name, attrs in COUNTERS.items() for attr in attrs
                if hasattr(entries[name], attr)]
    # the plain twins, counted where the forward might reach them
    twins = {"probsparse_attention_bnc": 0, "leff_reference": 0}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **kw):
            twins[name] += 1
            return fn(*a, **kw)
        setattr(mod, name, wrapper)

    counted(probsparse, "probsparse_attention_bnc")
    counted(leff, "leff_reference")

    torch.manual_seed(SEED)
    tmp = tempfile.mkdtemp(prefix="frame_ms_w_")
    try:
        pth = os.path.join(tmp, "uformer32_seed.pth")
        torch.save({"state_dict": Uformer(ModelConfig()).state_dict()}, pth)
        model = build_model_and_params(
            ModelConfig(dtype=getattr(torch, args.dtype)), pth,
            torch.device("cuda"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    run = make_whole_image_fn(
        lambda c: model(c, generator=torch.Generator().manual_seed(SEED)),
        FRAME[0], FRAME[1], ps=128, square=False, device="cuda")
    frame = np.random.default_rng(SEED).integers(
        0, 256, size=(1,) + FRAME + (3,), dtype=np.uint8)
    y = run(frame)
    torch.cuda.synchronize()
    if args.save:
        torch.save(y.float().cpu(), args.save)
    for _, fn, attr in counters:
        setattr(fn, attr, 0)
    for name in twins:
        twins[name] = 0
    t0 = time.perf_counter()
    for _ in range(args.reps):
        y = run(frame)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / args.reps
    per_frame = {key: getattr(fn, attr) / args.reps
                 for key, fn, attr in counters}
    per_frame.update({f"twin {k}": v / args.reps for k, v in twins.items()})
    ok = bool(torch.isfinite(y).all())
    print(f"{args.dtype} {FRAME[0]}x{FRAME[1]} frame, rect canvas "
          f"1280x1664: {secs:.4f} s/frame, finite {ok}; per frame "
          + ", ".join(f"{k} {v:g}" for k, v in per_frame.items()),
          flush=True)
    print(json.dumps({"root": os.path.abspath(roots[0]), "dtype": args.dtype,
                      "s_per_frame": secs, "finite": ok,
                      "launches_per_frame": per_frame}), flush=True)
    if not ok:
        sys.exit("the frame is not finite")


if __name__ == "__main__":
    main()
