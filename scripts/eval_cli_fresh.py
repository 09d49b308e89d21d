#!/usr/bin/env python3
"""`cli.test_long` with `--weights` and with `--exported`, each in a fresh
process on one NVIDIA GPU: Uformer-32 (seeded random init, bf16, square
canvas 1664²) with ProbSparse and with W-MSA attention, on synthetic
1200×1600 pairs.

    python3 scripts/eval_cli_fresh.py [--pairs 4]

Exports a square artifact of each model in process (`cli.export`), then
runs each CLI as `python -c` in a new process that nothing else shares
the card with, and prints one line per run: the seconds of each frame
(the first holds the process's kernel loads) and the caching allocator's
retries, cudaMalloc and cudaFree counts. The card's name and power limit
come first. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 1234
CHILD = (
    "import json, sys, torch\n"
    "from dehaze_tpu_torch.cli import test_long\n"
    "res = test_long.main(sys.argv[1:])\n"
    "st = torch.cuda.memory_stats()\n"
    "print('RES ' + json.dumps({'secs': res['secs'], 'retries': "
    "st.get('num_alloc_retries'), 'mallocs': st.get('num_device_alloc'), "
    "'frees': st.get('num_device_free')}), flush=True)\n")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pairs", type=int, default=4)
    args = p.parse_args()
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        sys.exit("this needs an NVIDIA GPU")
    from dehaze_tpu_torch.cli import export as cli_export
    from dehaze_tpu_torch.config import ModelConfig
    from dehaze_tpu_torch.data.synth import write_dataset
    from dehaze_tpu_torch.models.uformer import Uformer

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ds = os.path.join(tmp, "pairs")
        write_dataset(ds, args.pairs, (1200, 1600), seed=5)
        files = {}
        for att in ("full", "probsparse"):
            torch.manual_seed(SEED)
            pth = os.path.join(tmp, f"{att}.pth")
            torch.save({"state_dict": Uformer(ModelConfig(
                attention=att)).state_dict()}, pth)
            art = os.path.join(tmp, f"{att}.dhz")
            cli_export.main(["--weights", pth, "--attention", att,
                             "--square", "--out", art])
            files[att] = {"weights": ["--weights", pth, "--attention", att],
                          "exported": ["--exported", art]}
        for att, mode in (("full", "exported"), ("full", "weights"),
                          ("full", "exported"), ("probsparse", "exported"),
                          ("probsparse", "weights")):
            r = subprocess.run(
                [sys.executable, "-c", CHILD, "--input_dir", ds,
                 "--no-save_images"] + files[att][mode],
                capture_output=True, text=True, timeout=600,
                env={**os.environ, "PYTHONPATH": HERE})
            res = [ln[4:] for ln in r.stdout.splitlines()
                   if ln.startswith("RES ")]
            if r.returncode or not res:
                sys.exit(f"{att} --{mode} exited {r.returncode}: "
                         f"{r.stderr[-3000:]}")
            stats = json.loads(res[0])
            secs = stats.pop("secs")
            print(f"attention={att} --{mode}: s per frame "
                  f"{[round(s, 4) for s in secs]}, after the first "
                  f"{sum(secs[1:]) / max(len(secs) - 1, 1):.4f}; "
                  f"allocator {stats}", flush=True)


if __name__ == "__main__":
    main()
