#!/usr/bin/env python3
"""The multi-GPU paths on 1, 2 and 4 NVIDIA GPUs of one host, one process
per GPU under `torchrun`, NCCL: what `chip_smoke.py` cannot show with its
one card.

    python3 scripts/multi_gpu_bench.py [--gpus 1 2 4]

Uformer-32 (seeded random weights, bf16). For each GPU count N (one
`torchrun --nproc_per_node N` each, after the kernels are built once):
  - the 1200×1600 frame on the rect canvas in N row bands
    (`infer.halo_sharded`; 1280 rows, padded to a multiple of 128·N):
    s/frame and peak memory per rank over FRAMES frames, and rank 0's
    max / mean |Δ| against its own one-process forward of the frame;
  - frames spread over the ranks (`infer.sharded.frame_share`, the
    whole-image forward of each frame on its rank): FRAMES·N frames,
    frames/s from a common start to the last rank's end;
  - DDP train steps at the global batch 32 × 128² (32/N rows a rank), CR
    on: ms per step (median after two warm-up steps) and img/s, the
    82.5 MB gradient all-reduce alone, and the step losses (held to the
    one-GPU run's within DDP_TOL).
Prints one line per GPU count and a JSON line of all of them, then the
cards' names and power limits. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, FRAME, FRAMES, STEPS = 1234, (1200, 1600), 5, 6
DDP_TOL = (2e-3, 2e-2)  # chip_smoke.py's: first step, later steps

WORKER = r'''
import json, os, sys, time
import numpy as np, torch
from dehaze_tpu_torch.config import Config, DataConfig, LossConfig, TrainConfig
from dehaze_tpu_torch.config import ModelConfig
from dehaze_tpu_torch.infer.halo_sharded import make_halo_sharded_frame_fn
from dehaze_tpu_torch.infer.sharded import frame_share
from dehaze_tpu_torch.infer.tiled import make_whole_image_fn
from dehaze_tpu_torch.models.uformer import Uformer
from dehaze_tpu_torch.parallel import dist
from dehaze_tpu_torch.train.trainer import Trainer

out_dir = sys.argv[2]
seed, (H, W), frames, steps = json.loads(sys.argv[1])
dev = dist.init("cuda")
r, n = dist.rank(), dist.world()
def sync_s(t0):
    torch.cuda.synchronize()
    return time.perf_counter() - t0
res = {"rank": r, "world": n, "device": torch.cuda.get_device_name(dev)}
torch.manual_seed(seed)
model = Uformer(ModelConfig()).to(dev).eval()
frame = np.random.default_rng(seed).integers(0, 256, size=(1, H, W, 3),
                                             dtype=np.uint8)
run = make_halo_sharded_frame_fn(model, H, W, 128, seed=seed, device=dev)
run(frame)
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
dist.barrier()
t0 = time.perf_counter()
for _ in range(frames):
    y = run(frame)
res["band_s"] = sync_s(t0) / frames
res["band_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
whole = make_whole_image_fn(
    lambda c: model(c, generator=torch.Generator().manual_seed(seed)),
    H, W, 128, square=False, device=dev)
if r == 0:
    d = (y - whole(frame)).abs()
    res["band_max_d"], res["band_mean_d"] = float(d.max()), float(d.mean())
# frames over the ranks: each runs its share of frames * n whole frames
whole(frame)
dist.barrier()
t0 = time.perf_counter()
for _ in frame_share(frames * n):
    whole(frame)
mine = sync_s(t0)
res["spread_s"] = max(dist.gather_objects(mine))
res["spread_frames"] = frames * n
del model
rng = np.random.default_rng(seed)
clean = rng.integers(0, 256, size=(steps, 32, 128, 128, 3), dtype=np.uint8)
hazy = np.clip(clean * 0.6 + 60, 0, 255).astype(np.uint8)
b = 32 // n
cfg = Config(data=DataConfig(batch_size=32), train=TrainConfig(warmup=False),
             loss=LossConfig(w_contrast=1.0))
tr = Trainer(cfg, steps_per_epoch=steps, device=dev, data_parallel=True)
sl = slice(r * b, (r + 1) * b)
losses, step_s = [], []
for s in range(steps):
    dist.barrier()
    t0 = time.perf_counter()
    m = tr.train_step(clean[s][sl], hazy[s][sl], use_mixup=s % 2 == 1)
    losses.append(float(m["loss"]))
    step_s.append(sync_s(t0))
res.update(losses=losses, step_ms=[x * 1e3 for x in step_s],
           train_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
flat = torch.cat([p.detach().reshape(-1) for p in tr.model.parameters()])
for _ in range(3):
    dist.barrier()
    t0 = time.perf_counter()
    torch.distributed.all_reduce(flat)
    res["allreduce_ms"] = sync_s(t0) * 1e3
with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
    json.dump(res, f)
dist.shutdown()
'''


def build_kernels() -> None:
    """Build every kernel once, before the ranks load them."""
    sys.path.insert(0, HERE)
    from dehaze_tpu_torch.ops.kernels import _build, leff, window_attention

    for name, sig in (("window_attention", window_attention._SIGNATURES),
                      ("window_attention_tc",
                       window_attention._TC_SIGNATURES),
                      ("leff", leff._SIGNATURES)):
        _build.load_library(name, sig)


def run_group(n: int, timeout: int = 900):
    """One torchrun of n ranks; each rank's results (a JSON file each)."""
    with tempfile.TemporaryDirectory() as tmp:
        _torchrun(n, tmp, timeout)
        return [json.load(open(os.path.join(tmp, f"rank{r}.json")))
                for r in range(n)]


def _torchrun(n: int, out_dir: str, timeout: int) -> None:
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(n), "--no-python",
         sys.executable, "-c", WORKER,
         json.dumps([SEED, list(FRAME), FRAMES, STEPS]), out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=HERE, env={**os.environ, "PYTHONPATH": HERE},
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        sys.exit(f"{n} GPUs: the ranks did not end within {timeout} s")
    if proc.returncode != 0:
        sys.exit(f"{n} GPUs: torchrun exited {proc.returncode}: "
                 f"{err[-3000:]}")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--gpus", type=int, nargs="+", default=[1, 2, 4])
    a = p.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs NVIDIA GPUs")
    if max(a.gpus) > torch.cuda.device_count():
        sys.exit(f"asked for {max(a.gpus)} GPUs, {torch.cuda.device_count()}"
                 " visible")
    t0 = time.perf_counter()
    build_kernels()
    print(f"kernels built in {time.perf_counter() - t0:.1f}s", flush=True)
    out, ref = {}, None
    for n in a.gpus:
        t0 = time.perf_counter()
        ranks = run_group(n)
        r0 = ranks[0]
        step = float(np.median(r0["step_ms"][2:]))
        ref = ref or r0["losses"]
        rel = [abs(x - y) / abs(y) for x, y in zip(r0["losses"], ref)]
        out[n] = {"band_s": [x["band_s"] for x in ranks],
                  "band_peak_gib": [x["band_peak_gib"] for x in ranks],
                  "band_max_d": r0["band_max_d"],
                  "band_mean_d": r0["band_mean_d"],
                  "spread_frames_per_s": r0["spread_frames"]
                  / r0["spread_s"],
                  "step_ms": r0["step_ms"], "step_ms_median": step,
                  "img_per_s": 32 / step * 1e3,
                  "allreduce_ms": [x["allreduce_ms"] for x in ranks],
                  "losses": r0["losses"], "loss_rel_to_1": rel,
                  "devices": sorted({x["device"] for x in ranks})}
        print(f"{n} GPU(s): banded frame {max(out[n]['band_s']):.4f} s "
              f"(peak {max(out[n]['band_peak_gib']):.2f} GiB a rank, max|d| "
              f"{r0['band_max_d']:.3e} mean|d| {r0['band_mean_d']:.3e} "
              f"against one process); frames over the ranks "
              f"{out[n]['spread_frames_per_s']:.2f} frames/s; DDP step "
              f"{step:.2f} ms median ({out[n]['img_per_s']:.1f} img/s), "
              f"all-reduce alone {max(out[n]['allreduce_ms']):.2f} ms, "
              f"losses rel to 1 GPU {[f'{x:.1e}' for x in rel]}; "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        if rel[0] > DDP_TOL[0] or max(rel[1:]) > DDP_TOL[1]:
            sys.exit(f"{n} GPUs: the DDP steps are not the one-GPU steps")
    print(json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
