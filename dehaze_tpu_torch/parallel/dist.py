"""The process group of a multi-GPU run (counterpart of
`dehaze_tpu/parallel/mesh.py`).

The JAX package runs one SPMD program over a device mesh; the port runs one
process per GPU, started by `torchrun` (`python -m torch.distributed.run
--nproc_per_node N ...`), which sets RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT for each. `init` joins them into the default
process group: NCCL on CUDA devices, gloo on the CPU, or the backend the
caller names (two ranks that share one GPU need gloo: NCCL refuses them).
A failed init raises; nothing falls back to another backend or device.

Data-parallel training wraps the model in `DistributedDataParallel`, which
broadcasts rank 0's parameters and averages the gradients, so nothing here
replicates state. The helpers gather per-rank rows to every rank in rank
order; without a process group they return the caller's rows.
`mean_over_ranks` (a global loss term) and `sum_over_ranks` (global-batch
statistics) reduce a tensor over the ranks, each with the backward its
use needs.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, List, Optional

import torch
import torch.distributed as dist


def launch_hint(flag: str, n: int) -> str:
    """What to run for `flag` N: one process per band or per replica."""
    return (f"{flag} {n} runs one process per GPU: launch it with "
            f"`torchrun --nproc_per_node {n}` (python -m "
            f"torch.distributed.run)")


def env_world() -> int:
    """The number of processes torchrun started (1 without torchrun)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def check_world(flag: str, n: int) -> None:
    """Raise unless `flag` N names as many processes as were launched."""
    world = env_world()
    if n != world or "RANK" not in os.environ:
        raise SystemExit(f"{launch_hint(flag, n)}; this run has {world} "
                         "process(es)" + ("" if "RANK" in os.environ
                                          else ", not started by torchrun"))


def device_for(kind: str) -> torch.device:
    """The device of this rank: 'cuda' is cuda:{LOCAL_RANK}; 'cpu' and an
    explicit 'cuda:N' are taken as given."""
    dev = torch.device(kind)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def init(device: str = "cuda", backend: Optional[str] = None
         ) -> torch.device:
    """Join the process group torchrun describes and return this rank's
    device (`device_for`). backend: 'nccl' or 'gloo'; by default NCCL for a
    CUDA device, gloo for the CPU."""
    dev = device_for(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                timeout=datetime.timedelta(minutes=10))
    return dev


def is_on() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_on() else 0


def world() -> int:
    return dist.get_world_size() if is_on() else 1


def barrier() -> None:
    if is_on():
        dist.barrier()


def shutdown() -> None:
    if is_on():
        dist.destroy_process_group()


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's `x` (the same shape on each) concatenated along dim 0
    in rank order, on every rank."""
    if world() == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(world())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def gather_objects(obj: Any) -> List[Any]:
    """[rank 0's obj, rank 1's, ...] on every rank (pickled)."""
    if world() == 1:
        return [obj]
    out: List[Any] = [None] * world()
    dist.all_gather_object(out, obj)
    return out


class _MeanOverRanks(torch.autograd.Function):
    """Forward: the mean of every rank's x. Backward: the identity.

    Under DDP each rank back-propagates its own loss and DDP averages the
    gradients over the P ranks. A loss built on this mean is the global
    loss on every rank, and the identity backward gives rank p the
    gradient of the global loss through its own x times P (the mean's
    true derivative is 1/P), so DDP's average is the global gradient.
    Summing the gradient over the ranks here as well would count the
    reduction twice and scale it by P."""

    @staticmethod
    def forward(ctx, x):
        total = x.clone()
        dist.all_reduce(total)
        return total / world()

    @staticmethod
    def backward(ctx, g):
        return g


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean of every rank's `x` (`_MeanOverRanks`); `x` itself without
    a process group."""
    return _MeanOverRanks.apply(x) if world() > 1 else x


class _SumOverRanks(torch.autograd.Function):
    """Forward: the sum of every rank's x. Backward: the sum of every
    rank's incoming gradient.

    For statistics that enter each rank's own loss (global-batch
    BatchNorm): rank p's x reaches every rank's loss through the sum, so
    its gradient is the sum of all the ranks' gradients of the sum; DDP
    then averages the parameters' gradients as for any other path."""

    @staticmethod
    def forward(ctx, x):
        total = x.clone()
        dist.all_reduce(total)
        return total

    @staticmethod
    def backward(ctx, g):
        total = g.clone()
        dist.all_reduce(total)
        return total


def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's `x`, its backward summed too
    (`_SumOverRanks`); `x` itself without a process group."""
    return _SumOverRanks.apply(x) if world() > 1 else x
