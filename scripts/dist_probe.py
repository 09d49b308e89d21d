#!/usr/bin/env python3
"""What `torch.distributed` carries between two ranks that share one
NVIDIA GPU, by backend.

    python3 scripts/dist_probe.py

Launches `torchrun --standalone --nproc_per_node 2` twice, both ranks on
cuda:0: once with NCCL, once with gloo. Each rank tries, on CUDA tensors,
`all_gather` (bf16, uint8, f32), `all_reduce` (f32 sum), `broadcast`,
`all_gather_object` and `send`/`recv`, and prints one JSON line of what
passed (with the values checked) and what raised. Then the script prints a
line per backend and the card's name and power limit. A backend that
fails at init is reported, not retried on another. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import signal
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(backend: str) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    rank = int(os.environ["RANK"])
    res = {"rank": rank, "backend": backend}
    try:
        dist.init_process_group(backend, init_method="env://",
                                timeout=datetime.timedelta(seconds=60))
    except Exception as e:  # the finding itself: report and stop
        res["init"] = f"{type(e).__name__}: {e}"[:400]
        print("RES " + json.dumps(res), flush=True)
        return
    res["init"] = "ok"
    dev = torch.device("cuda:0")

    def attempt(name, fn):
        try:
            res[name] = fn()
        except Exception as e:
            res[name] = f"{type(e).__name__}: {e}"[:400]

    def gather(dtype):
        x = torch.full((4, 8), rank + 1, dtype=dtype, device=dev)
        out = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(out, x)
        torch.cuda.synchronize()
        return "ok" if [int(o[0, 0]) for o in out] == [1, 2] else "wrong"

    for dtype in (torch.bfloat16, torch.uint8, torch.float32):
        attempt(f"all_gather_{str(dtype).split('.')[-1]}",
                lambda: gather(dtype))

    def reduce():
        x = torch.full((16,), rank + 1.0, device=dev)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        return "ok" if float(x[0]) == 3.0 else "wrong"

    def broadcast():
        x = torch.full((16,), float(rank), device=dev)
        dist.broadcast(x, src=1)
        torch.cuda.synchronize()
        return "ok" if float(x[0]) == 1.0 else "wrong"

    def send_recv():
        x = torch.full((16,), 7.0, device=dev)
        if rank == 0:
            dist.send(x, dst=1)
            return "ok"
        y = torch.zeros(16, device=dev)
        dist.recv(y, src=0)
        torch.cuda.synchronize()
        return "ok" if float(y[0]) == 7.0 else "wrong"

    def objects():
        got = [None, None]
        dist.all_gather_object(got, {"rank": rank})
        return "ok" if [g["rank"] for g in got] == [0, 1] else "wrong"

    attempt("all_reduce_f32", reduce)
    attempt("broadcast_f32", broadcast)
    attempt("all_gather_object", objects)
    attempt("send_recv_f32", send_recv)  # last: a failure breaks the pair
    print("RES " + json.dumps(res), flush=True)
    dist.destroy_process_group()


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    a = p.parse_args()
    if a.worker:
        worker(a.worker)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    for backend in ("nccl", "gloo"):
        # its own session, so a rank that hangs dies with the launcher
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", os.path.abspath(__file__), "--worker",
             backend], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=HERE, start_new_session=True)
        try:
            out, err = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, err = proc.communicate()
            print(f"{backend}: timed out after 240 s", flush=True)
        rows = [json.loads(ln[4:]) for ln in out.splitlines()
                if ln.startswith("RES ")]
        tail = "" if rows else err[-1500:]
        print(f"{backend}: exit {proc.returncode} " + json.dumps(rows)
              + (f"\n  stderr: {tail}" if tail else ""), flush=True)
    print(f"card: {card}", flush=True)


if __name__ == "__main__":
    main()
