#!/usr/bin/env python3
"""Hold float32 K2 with --act_store (fp8, int8) to its twin and to the same
function summed exactly, on one NVIDIA GPU, for one or two checkouts.

    python3 scripts/k2_act_share.py [--root DIR [--root DIR2]] [--seeds N]

In float32 nothing rounds K2's hidden values to a coarser type before their
8-bit round trip, so the last bit of a sum decides a quantization step
wherever a value lies at a step's edge. This script shows how much of the
share of outputs beyond K2_TOL (chip_smoke's ACT_SHARE bar) comes from the
kernel and how much from the twin's own float32 sums. For each case (the
serving frame's enc0 and dec0 on the rect canvas 1280×1664, hidden 4C,
chip_smoke's seeded parameters, --seeds seeds each) and each mode (None,
fp8, int8) it prints three comparisons, each as chip_smoke's _act_check
reads it (share beyond K2_TOL, steps beyond it at the output's largest
magnitude):

  - kernel against the float32 twin (`leff_reference`): the smoke's check;
  - kernel against `exact` (chip_smoke's _k2_exact): the twin's chain with
    its LayerNorm, both Dense layers and the dwconv summed in float64, each
    rounded once to float32 at the twin's points, GELU and the round trips
    as the twin has them;
  - the float32 twin against `exact`: the twin's own sum noise (the bar
    of chip_smoke's ACT_SHARE_BY_CHAIN cases);
  - the twin with its products in TF32 against the float32 twin: a control
    of lower precision, which a bar must reject.

Each root's kernel runs in a process of its own (its own build); the twin
and `exact` run from this repository. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = [("enc0", (1, 1280, 1664, 32)), ("dec0", (1, 160, 208, 512))]
MODES = (None, "fp8", "int8")


def cases(seeds: int):
    """(label, seed, shape) of every case."""
    return [(f"{name} seed {s}", 1236 + s, shape)
            for name, shape in STAGES for s in range(seeds)]


def inputs(seed: int, shape):
    """chip_smoke's _k2_case on a generator seeded with `seed`."""
    import torch

    sys.path.insert(0, HERE)
    from chip_smoke import _k2_case

    g = torch.Generator(device="cuda").manual_seed(seed)
    return _k2_case(g, shape, 4 * shape[-1])


def save_kernel(root: str, out: str, seeds: int) -> None:
    """Child: root's kernel on every case and mode, saved under out."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from dehaze_tpu_torch.ops.kernels.leff import leff_fused

    os.makedirs(out, exist_ok=True)
    for k, (_, seed, shape) in enumerate(cases(seeds)):
        p, x = inputs(seed, shape)
        for mode in MODES:
            torch.save(leff_fused(x, act_store=mode, **p).cpu(),
                       os.path.join(out, f"{k}_{mode}.pt"))
        del p, x
    torch.cuda.synchronize()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append")
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--save_kernel", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    roots = [os.path.abspath(r) for r in (args.root or [HERE])]
    if args.save_kernel:
        save_kernel(roots[0], args.save_kernel, args.seeds)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="k2_act_share_")
    try:
        for i, root in enumerate(roots):
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--root", root,
                 "--seeds", str(args.seeds), "--save_kernel",
                 os.path.join(tmp, str(i))], capture_output=True, text=True)
            if r.returncode != 0:
                sys.exit(f"{root}: exit {r.returncode}\n{r.stderr[-3000:]}")
        sys.path.insert(0, HERE)
        from chip_smoke import _act_check, _k2_exact
        from dehaze_tpu_torch.ops.kernels.leff import leff_reference

        rows = []
        for k, (label, seed, shape) in enumerate(cases(args.seeds)):
            p, x = inputs(seed, shape)
            for mode in MODES:
                twin = leff_reference(x, act_store=mode, **p)
                ref = _k2_exact(x, p, mode)
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True
                ctl = leff_reference(x, act_store=mode, **p)
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
                pairs = [("twin vs exact", twin, ref),
                         ("tf32 twin vs twin", ctl, twin)]
                for i, root in enumerate(roots):
                    got = torch.load(os.path.join(tmp, str(i),
                                                  f"{k}_{mode}.pt")).cuda()
                    pairs += [(f"{root} vs twin", got, twin),
                              (f"{root} vs exact", got, ref)]
                for what, a, b in pairs:
                    row = {"case": label, "x": list(shape),
                           "act_store": mode, "pair": what}
                    if mode is None:
                        row["max_abs_diff"] = float((a - b).abs().max())
                        text = f"max|d| {row['max_abs_diff']:.3e}"
                    else:
                        err, share, _, top, text = _act_check(
                            what, mode, "float32", a, b, [])
                        row.update(max_abs_diff=err, share=share,
                                   top_steps=top)
                    rows.append(row)
                    print(f"{label} act_store={mode} {what}: {text}",
                          flush=True)
            del p, x
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"roots": roots, "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
