"""Zoo checkpoints and model statistics (counterpart of
`dehaze_tpu/zoo/checkpoint.py`, ≙ the reference's `models/__init__.py`
`save`/`load`, `save_snapshot`/`load_snapshot`, `count_parameters`,
`stats` and `measure_executive_time`).

Files are the reference's: `{"name", "state_dict", "epoch"[, "optimizer"]}`
at `<root>/<dataset>/<model>/<dataset>_<model>_<uid>.pth.tar`, snapshots
one directory deeper with a `_<typ>` suffix. Where that file is missing,
`load`/`load_snapshot` read the JAX package's `.msgpack` of the same stem
(its zoo `save` writes `{"params", "batch_stats"}` variables) through
`utils.convert.zoo_state_dict_from_jax_variables`; the JAX package falls
back the other way.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Sequence

import torch

from dehaze_tpu_torch.train.checkpoint import load_jax_checkpoint
from dehaze_tpu_torch.utils.convert import zoo_state_dict_from_jax_variables


def _stem(root: str, dataset_name: str, model_name: str, uid: str) -> str:
    return os.path.join(root, dataset_name, model_name,
                        f"{dataset_name}_{model_name}_{uid}")


def _final_path(root: str, dataset_name: str, model_name: str,
                uid: str) -> str:
    return _stem(root, dataset_name, model_name, uid) + ".pth.tar"


def _snapshot_path(root: str, dataset_name: str, model_name: str,
                   uid: str, typ: Any) -> str:
    """One directory deeper, `_<typ>` suffix (an epoch or e.g. 'best')."""
    stem = _stem(root, dataset_name, model_name, uid)
    return os.path.join(stem, f"{os.path.basename(stem)}_{typ}.pth.tar")


def save_file(path: str, model: torch.nn.Module, model_name: str,
              optimizer, epoch: int,
              extra: Optional[Dict[str, Any]] = None) -> str:
    """The reference's payload (and `extra`'s entries beside it) written
    to a temporary file, then moved to `path`."""
    payload = {"name": model_name, "state_dict": model.state_dict(),
               "epoch": epoch, **(extra or {})}
    if optimizer is not None:
        payload["optimizer"] = optimizer.state_dict()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def save(model: torch.nn.Module, dataset_name: str, model_name: str,
         uid: str, optimizer=None, root: str = "models_checkpoints",
         epoch: int = 0) -> str:
    """≙ `models.save`. Returns the path."""
    return save_file(_final_path(root, dataset_name, model_name, uid),
                     model, model_name, optimizer, epoch)


def save_snapshot(model: torch.nn.Module, dataset_name: str,
                  model_name: str, uid: str, typ: Any, optimizer=None,
                  root: str = "models_checkpoints", epoch: int = 0) -> str:
    """≙ `models.save_snapshot`. Returns the path."""
    return save_file(_snapshot_path(root, dataset_name, model_name, uid,
                                    typ), model, model_name, optimizer, epoch)


def load(model: torch.nn.Module, dataset_name: str, model_name: str,
         uid: str, optimizer=None, root: str = "models_checkpoints"
         ) -> torch.nn.Module:
    """≙ `models.load`: the checkpoint's weights into `model` (strictly),
    and its optimizer state into `optimizer` when given. Returns model."""
    return _load(_final_path(root, dataset_name, model_name, uid), model,
                 optimizer)


def load_snapshot(model: torch.nn.Module, dataset_name: str,
                  model_name: str, uid: str, typ: Any, optimizer=None,
                  root: str = "models_checkpoints") -> torch.nn.Module:
    """≙ `models.load_snapshot`."""
    return _load(_snapshot_path(root, dataset_name, model_name, uid, typ),
                 model, optimizer)


def _unwrap(payload: dict) -> Dict[str, torch.Tensor]:
    """The state_dict of a reference checkpoint ({"state_dict": ...} or a
    bare state_dict), DataParallel's `module.` prefixes dropped."""
    sd = payload.get("state_dict", payload)
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def read_state_dict(path: str, model: torch.nn.Module
                    ) -> Dict[str, torch.Tensor]:
    """The weights of a checkpoint file as `model`'s state_dict, on the
    CPU: the JAX package's `.msgpack` (zoo variables, through
    `zoo_state_dict_from_jax_variables`) or a reference `.pth`/`.pth.tar`."""
    if path.endswith(".msgpack"):
        return zoo_state_dict_from_jax_variables(
            load_jax_checkpoint(path)["params"], model)
    return _unwrap(torch.load(path, map_location="cpu", weights_only=True))


def _load(path: str, model: torch.nn.Module, optimizer):
    if not os.path.exists(path):
        jax_path = path[:-len(".pth.tar")] + ".msgpack"
        if not os.path.exists(jax_path):
            raise FileNotFoundError(path)
        if optimizer is not None:
            raise ValueError(f"{jax_path}: a JAX checkpoint's optimizer "
                             "state is optax's; it cannot load into a "
                             "torch optimizer")
        model.load_state_dict(read_state_dict(jax_path, model))
        return model
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(_unwrap(payload))
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer"])
    return model


def count_parameters(model: torch.nn.Module) -> int:
    """≙ `models.count_parameters`: the trainable parameters' elements."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)


def stats(model: torch.nn.Module, xs: Optional[torch.Tensor] = None,
          name: str = "", generators=None) -> str:
    """≙ `models.stats`: "model: <name> , params: X.XM[, output: shape]",
    printed and returned."""
    line = "model: %s , params: %.1fM" % (
        name or getattr(model, "registry_name", type(model).__name__),
        count_parameters(model) / 1e6)
    if xs is not None:
        with torch.inference_mode():
            ys = model.eval()(xs, generators=generators)
        line += ", output: %s" % list(ys.shape)
    print(line)
    return line


def measure_executive_time(model: torch.nn.Module,
                           size: Sequence[int] = (1, 3, 32, 32),
                           n: int = 1000, seed: int = 0, chunk: int = 10,
                           generators=None) -> float:
    """≙ `models.measure_executive_time`: mean seconds per eval forward of
    a random NCHW input of `size` on the model's device. One warm-up call
    first; then `chunk` forwards per synchronize, each on its own input
    (drawn before the chunk's clock starts), timed by CUDA events on a
    GPU and by the host clock on the CPU. An MC-dropout model needs
    `generators={"dropout": ...}`."""
    dev = next(model.parameters()).device
    g = torch.Generator(dev).manual_seed(seed)
    model.eval()
    cuda = dev.type == "cuda"

    def fwd(x):
        return model(x, generators=generators)

    total = 0.0
    with torch.inference_mode():
        fwd(torch.randn(*size, generator=g, device=dev))
        for base in range(0, n, chunk):
            m = min(chunk, n - base)
            xs = [torch.randn(*size, generator=g, device=dev)
                  for _ in range(m)]
            if cuda:
                torch.cuda.synchronize(dev)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for x in xs:
                    fwd(x)
                end.record()
                end.synchronize()
                total += start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                for x in xs:
                    fwd(x)
                total += time.perf_counter() - t0
    return total / n
