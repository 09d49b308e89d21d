"""A serving artifact: the fixed-geometry whole-image forward as a
`torch.export` program (counterpart of `dehaze_tpu/infer/export.py`).

The artifact holds the [1, h, w, 3] float32 → [1, h, w, 3] forward of
`infer.tiled.make_whole_image_fn` (wrap-pad canvas, model, crop, clamp;
`WholeImage`) with the weights and the ProbSparse sample tables folded
in, so it computes what `--weights --seed S` computes for the seed it was
drawn with (and with the model's `--act_store`: its plain-torch round
trips are traced in, and K2's mode is an argument of its operator node); or, for FFA-Net, the native-resolution forward of
`infer.tiled.make_native_image_fn` with the protocol's input
normalization folded in (`Native`). K1's forward and K2 stay in its
graph as the operators
`dehaze_tpu_torch::window_attention_fwd` and `dehaze_tpu_torch::leff_fused`
(`ops/kernels/`): on the card they launch the CUDA kernels, on the CPU they
run the plain twins.

Properties of the artifact:
  - self-contained: running it needs torch and the port's kernel modules
    (which register the two operators) but no model code and no
    checkpoint: `load_exported(path)` returns a callable;
  - portable across devices: a program traced on the CPU loads onto the
    card (`torch.export.passes.move_to_device_pass`, which rewrites every
    device the graph names), so it can be built on a host without a GPU;
  - tied to its torch version: `meta.json` records it, and loading under
    another version is not promised (as `jax.export`'s window is not).

Container: a zip with `model.pt2` (`torch.export.save` bytes) and
`meta.json` (geometry and configuration, checked at load and serve time).
"""

from __future__ import annotations

import io
import json
import warnings
import zipfile
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

from dehaze_tpu_torch.infer.tiled import (FFA_MEAN, FFA_STD, _as_tensor,
                                          canvas_of, whole_image)
# registers the operators the artifact's graph calls
from dehaze_tpu_torch.ops.kernels import leff, window_attention  # noqa: F401

_MEMBER_MODEL = "model.pt2"
_MEMBER_META = "meta.json"


class WholeImage(torch.nn.Module):
    """`model`'s whole-image forward for one h×w geometry on the canvas
    `canvas_of(h, w, ps, square)`, with the sample tables as buffers (a
    Uformer's; None for a model that takes none, the UNet):
    [1, h, w, 3] float32 in [0, 1] → restored [1, h, w, 3] float32."""

    def __init__(self, model: torch.nn.Module,
                 tables: Optional[Sequence[torch.Tensor]], h: int, w: int,
                 ps: int, square: bool):
        super().__init__()
        self.model = model
        self.tabled = tables is not None
        self.n_tables = len(tables or ())
        for i, t in enumerate(tables or ()):
            self.register_buffer(f"table_{i}", t)
        self.canvas = canvas_of(h, w, ps, square)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.tabled:
            return whole_image(self.model, x, *self.canvas)
        tables = [getattr(self, f"table_{i}") for i in range(self.n_tables)]
        return whole_image(lambda c: self.model(c, sample_tables=tables), x,
                           *self.canvas)


class Native(torch.nn.Module):
    """FFA-Net's native-resolution forward: [1, h, w, 3] float32 in
    [0, 1] → `model` on the normalized input (`infer.tiled.
    normalize_hazy`, with the mean and std as buffers), clamped to
    [0, 1]."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model
        dev = next(model.parameters()).device
        self.register_buffer("mean", torch.as_tensor(FFA_MEAN, device=dev))
        self.register_buffer("std", torch.as_tensor(FFA_STD, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(self.model((x - self.mean) / self.std), 0.0, 1.0)


def export_whole_image_bytes(run_module: torch.nn.Module, h: int, w: int,
                             device) -> bytes:
    """`torch.export.save` bytes of `run_module` ([1, h, w, 3] float32 →
    [1, h, w, 3], e.g. `WholeImage`) traced on `device` under no_grad."""
    x = torch.zeros((1, h, w, 3), dtype=torch.float32, device=device)
    with torch.no_grad():
        ep = torch.export.export(run_module, (x,), strict=False)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def save_exported(path: str, model_bytes: bytes, meta: dict) -> None:
    """Write the zip container: the saved program + meta.json."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as z:
        z.writestr(_MEMBER_MODEL, model_bytes)
        z.writestr(_MEMBER_META, json.dumps(meta, indent=1, sort_keys=True))


def graph_devices(ep) -> set:
    """Every device a node of `ep`'s graph names, in its arguments or as
    its `device` keyword (as strings)."""
    found = set()
    for node in ep.graph_module.graph.nodes:
        for a in pytree.tree_leaves((node.args, node.kwargs)):
            if isinstance(a, torch.device):
                found.add(str(a))
        if "device" in node.kwargs:
            found.add(str(node.kwargs["device"]))
    return found


def load_program(path: str, device="cuda"):
    """(ExportedProgram on `device`, meta) of an artifact. The program's
    weights, constants and every device its graph names move to `device`;
    a device left behind raises."""
    from torch.export.passes import move_to_device_pass

    with zipfile.ZipFile(path, "r") as z:
        blob = z.read(_MEMBER_MODEL)
        meta = json.loads(z.read(_MEMBER_META).decode("utf-8"))
    device = torch.device(device)
    with warnings.catch_warnings():  # the loader wraps read-only bytes
        warnings.filterwarnings("ignore", message="The given buffer is not "
                                "writable")
        ep = torch.export.load(io.BytesIO(blob))
    ep = move_to_device_pass(ep, device)
    # the pass rewrites `device` keywords (and, in newer torch, the target
    # of aten.to.device); a device left in any other argument would copy
    # tensors back to the trace device on every call
    for node in ep.graph_module.graph.nodes:
        node.args = pytree.tree_map_only(torch.device, lambda _: device,
                                         node.args)
    ep.graph_module.recompile()
    stale = {d for d in graph_devices(ep) if torch.device(d) != device}
    if stale:
        raise ValueError(f"the artifact still names {sorted(stale)} after "
                         f"the move to {device}")
    return ep, meta


def load_exported(path: str, device="cuda") -> Tuple[Callable, dict]:
    """Load an artifact onto `device` → (callable, meta dict).

    The callable takes [1, H, W, 3] float32 in [0, 1] (tensor or ndarray) at
    the geometry meta records and returns the restored float32 frame on
    `device`."""
    ep, meta = load_program(path, device)
    module = ep.module()

    @torch.inference_mode()
    def run(img):
        return module(_as_tensor(img, device))

    return run, meta
