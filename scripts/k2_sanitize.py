#!/usr/bin/env python3
"""Run compute-sanitizer's racecheck and synccheck over K2 (csrc/leff.cu)
at small shapes, in every act_store mode and every int8 design, on one
NVIDIA GPU.

    python3 scripts/k2_sanitize.py [--root DIR] [--tools racecheck,synccheck]
                                   [--drop_wait]

Each tool runs this script's child (`--child`) under `compute-sanitizer
--tool T`; the child launches K2 once per case and synchronizes: float32
in each mode, and bf16 in each mode at every tile class (C 32 ... 512,
Ch = 4C), which runs int8 in one pass (C 32, 64), two sweeps (C 128, 256)
and three sweeps (C 512, and C 64 at Ch = 2048); every case has a ragged
last row and column tile. K2's copies are `cp.async` groups that each
step waits for (`cp.async.wait_group`) before its barrier, so a dropped
wait is a race between the copy's shared-memory writes and the reads
after the barrier.

--drop_wait checks that the tools can see such a race: it copies the
package under --root to a temporary directory outside the checkout,
deletes the `cp.async.wait_group` before barrier A of dense1's steps in
both bf16 kernels, and runs the tools on that copy, where they should
report hazards. Prints each tool's summary and exit code, then a JSON
line; exits 1 if a tool reports an error on the real kernel (or none on
the mutant), 2 if a tool cannot run the child to its end (e.g. where it
reports "Device not supported", which stops the child at its first CUDA
call). Too slow for the smoke (the child builds K2 first). Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# B, H, W, C, Ch: the last row and column tiles ragged for every class
SHAPES = [(1, 9, 19, 32, 128), (2, 9, 21, 64, 256), (1, 9, 19, 128, 512),
          (1, 9, 11, 256, 1024), (1, 9, 11, 512, 2048),
          (1, 9, 21, 64, 2048)]
N_CASES = 3 * (1 + len(SHAPES))  # the child's launches: modes x cases
# the line of each bf16 kernel's dense1 step that --drop_wait deletes
WAIT_BEFORE_A = re.compile(
    r"^\s*cp_async_wait_all\(\);[^\n]*\n(\s*__syncthreads\(\);\s*// A\b)",
    re.M)


def child(root: str) -> None:
    """Launch K2 on each case (the plan's design) and synchronize."""
    sys.path.insert(0, root)
    import torch

    from dehaze_tpu_torch.ops.kernels.leff import leff_fused, plan_tile

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    cases = [(SHAPES[0], torch.float32)] + [(s, torch.bfloat16)
                                            for s in SHAPES]
    for (B, H, W, C, Ch), dtype in cases:
        def rnd(*s, std=1.0):
            return torch.randn(*s, generator=g, device=dev) * std

        p = {"ln_scale": 1 + rnd(C, std=0.1), "ln_bias": rnd(C, std=0.1),
             "w1": rnd(C, Ch, std=C ** -0.5), "b1": rnd(Ch, std=0.1),
             "dw_kernel": rnd(3, 3, 1, Ch, std=1 / 3),
             "dw_bias": rnd(Ch, std=0.1), "w2": rnd(Ch, C, std=Ch ** -0.5),
             "b2": rnd(C, std=0.1)}
        x = rnd(B, H, W, C).to(dtype)
        for mode in (None, "fp8", "int8"):
            leff_fused(x, act_store=mode, **p)
            torch.cuda.synchronize()
            plan = plan_tile(C, dtype, mode, Ch)
            print(f"ran {dtype} x={[B, H, W, C]} Ch={Ch} act_store={mode} "
                  f"tile 8x{plan.tw} sweeps {plan.sweeps}", flush=True)


def sanitizer() -> str:
    path = shutil.which("compute-sanitizer")
    for cand in (path, "/usr/local/cuda/bin/compute-sanitizer"):
        if cand and os.path.exists(cand):
            return cand
    sys.exit("compute-sanitizer not found (PATH or /usr/local/cuda/bin)")


def run_tool(tool: str, root: str, tool_bin: str) -> dict:
    """The child under one tool: its exit code, summary lines and the
    number of errors or hazards it reports (None if it printed none)."""
    cmd = [tool_bin, "--tool", tool, "--error-exitcode", "99"]
    if tool == "racecheck":
        cmd += ["--racecheck-report", "hazard"]
    cmd += [sys.executable, os.path.abspath(__file__), "--child", "--root",
            root]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=3000)
    text = r.stdout + r.stderr
    summary = [ln.strip("= ").strip() for ln in text.splitlines()
               if "SUMMARY" in ln]
    counts = [int(m.group(1)) for ln in summary
              for m in [re.search(r"(\d+) (?:errors?|hazards?)", ln)] if m]
    ran = len(re.findall(r"^ran ", r.stdout, re.M))
    # the tool's own lines (its reports), the first of them
    report = [ln for ln in text.splitlines() if ln.startswith("=========")]
    return {"tool": tool, "rc": r.returncode, "cases_run": ran,
            "summary": summary, "reported": max(counts) if counts else None,
            "report": report[:40],
            "tail": text[-1500:] if r.returncode not in (0, 99) or not ran
            else ""}


def mutant(root: str, tmp: str) -> str:
    """A copy of root's package with the wait before barrier A of dense1's
    steps deleted in both bf16 kernels; returns the copy's root."""
    dst = os.path.join(tmp, "mutant")
    shutil.copytree(os.path.join(root, "dehaze_tpu_torch"),
                    os.path.join(dst, "dehaze_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = os.path.join(dst, "dehaze_tpu_torch", "csrc", "leff.cu")
    with open(src) as f:
        text = f.read()
    text, n = WAIT_BEFORE_A.subn(r"\1", text)
    if n != 2:
        sys.exit(f"--drop_wait: found {n} waits before barrier A, not 2")
    with open(src, "w") as f:
        f.write(text)
    return dst


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tools", default="racecheck,synccheck")
    ap.add_argument("--drop_wait", action="store_true")
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    if args.child:
        child(root)
        return
    tool_bin = sanitizer()
    version = subprocess.run([tool_bin, "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()
    print(f"{tool_bin}: {version[-1] if version else '?'}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        target = mutant(root, tmp) if args.drop_wait else root
        results = [run_tool(t, target, tool_bin)
                   for t in args.tools.split(",")]
    cannot = False
    for r in results:
        print(f"{r['tool']}{' (dropped wait)' if args.drop_wait else ''}: "
              f"rc {r['rc']}, {r['cases_run']} cases run, reported "
              f"{r['reported']}; " + " | ".join(r["summary"]), flush=True)
        for ln in r["report"][:25]:
            print(f"  {ln}", flush=True)
        if r["tail"]:
            print(r["tail"], flush=True)
        # a tool that cannot attach (e.g. "Device not supported") stops the
        # child before its first case
        cannot |= r["cases_run"] < N_CASES or r["reported"] is None
    print(json.dumps({"root": target if not args.drop_wait else root,
                      "drop_wait": args.drop_wait, "results": results}),
          flush=True)
    if cannot:
        sys.exit(2)
    errors = [r["reported"] or r["rc"] == 99 for r in results]
    if args.drop_wait:
        sys.exit(0 if any(errors) else 1)
    sys.exit(1 if any(errors) else 0)


if __name__ == "__main__":
    main()
