#!/usr/bin/env python3
"""Where K1 spends its time, phase by phase, on one NVIDIA GPU.

    python3 scripts/k1_phases.py [--root DIR]
        [--kernel cuda_core|tc|cuda_core_bwd|tc_bwd|f32]
        [--numerics v4|v23|v1|v2hm]

Builds an instrumented copy of one K1 source of the port found under
--root (default: this repository), in a temporary directory; the source
itself is not touched. Thread 0 of every CTA reads clock64() at the end of
each phase and adds the cycles since the last one to a per-phase counter.
The forward kernels run once at four stage shapes of the serving frame,
the backward kernels at four stage shapes of a train step (batch 32 ×
128²) (bf16, N = 64, seeded inputs, rel-pos bias; enc0 and dec3 shifted);
prints the cycles per CTA of each phase.

--kernel cuda_core: `window_attention_fwd_kernel` of
  csrc/window_attention.cu (one CTA per window-head); its phases end at
  its barriers: stage (the count matrix), load (q/k/v), QK^T (float64,
  scalar), row chain (one thread per row), select (rank), PV / mean(V).
  bf16 calls reach it only in a tree without the tensor-core kernel (the
  parent of that kernel's commit, given by --root); elsewhere its counters
  stay 0.
--kernel tc: `window_attention_tc_kernel` of csrc/window_attention_tc.cu
  (a warp per window-head, several per CTA); its phases end at the lines
  marked `// phase: <name>`, as warp 0 of each CTA sees them.
--kernel cuda_core_bwd: `window_attention_bwd_kernel` of
  csrc/window_attention.cu (a CTA per window group and head, walking its
  windows); phases end at its barriers. The first phase ("dq/dk") is the
  previous window's dq and dk (the first window's: the count staging), the
  last ("end") the last window's and the dbias partial's store. bf16 calls
  reach it only in a tree without the tensor-core backward.
--kernel tc_bwd: `window_attention_tc_bwd_kernel` of
  csrc/window_attention_tc.cu, by its `// phase:` lines as for tc.
--kernel f32: `window_attention_f32_fwd_kernel` of csrc/window_attention.cu
  (float32 inputs; persistent CTAs walking window-heads); its phases end
  at its barriers: wait (the copies of this window-head, and the previous
  one's PV and stores), widen (q and k to float64), QK^T, S store, M /
  mean(V), rank, chain read, chain, and the end (the last window-head's
  PV and stores), summed over the CTA's window-heads.
--numerics v23 runs K3-v3's calls (`window_attention_v3_fwd` / `_bwd`,
the same kernels with K3-v3's rounding points) instead of K1's; v1 and
v2hm the head-major K3-v1 and K3-v2 forwards
(`probsparse_window_attention_v1` / `_v2`, q/k/v [B_, heads, N, D]).
The counters and clock reads slow the kernel somewhat; shares are what they
show. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (name, windows B_, C, heads, region map H x W or None)
STAGES = [("enc0", 33280, 32, 1, (1280, 1664)),
          ("enc1", 8320, 64, 2, None),
          ("bottleneck", 130, 512, 16, None),
          ("dec3", 33280, 64, 2, (1280, 1664))]
BWD_STAGES = [("enc0", 8192, 32, 1, (128, 128)),
              ("enc1", 2048, 64, 2, None),
              ("bottleneck", 32, 512, 16, None),
              ("dec3", 8192, 64, 2, (128, 128))]
# kernel -> (source, __global__ name, phase names where the phases end at
# barriers (None: at `// phase:` lines))
KERNELS = {
    "cuda_core": ("window_attention", "window_attention_fwd_kernel",
                  ["stage", "load", "QK^T", "row chain", "select",
                   "PV/mean"]),
    "tc": ("window_attention_tc", "window_attention_tc_kernel", None),
    "cuda_core_bwd": ("window_attention", "window_attention_bwd_kernel",
                      ["dq/dk", "load", "QK^T", "row chain", "select",
                       "g_unsel", "g_sel", "dv+da2", "dz", "dbias", "ds",
                       "end"]),
    "tc_bwd": ("window_attention_tc", "window_attention_tc_bwd_kernel",
               None),
    "f32": ("window_attention", "window_attention_f32_fwd_kernel",
            ["wait", "widen", "QK^T", "S store", "M/mean", "rank",
             "chain read", "chain", "end"]),
}
COUNTERS = """
__device__ unsigned long long g_phase[16];
#define PHASE(i) do { if (threadIdx.x == 0) { long long t_ = clock64(); \\
  atomicAdd(&g_phase[(i)], (unsigned long long)(t_ - t_prev)); \\
  t_prev = t_; } } while (0)
"""
READ_OUT = """
extern "C" int k1_phases(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[16] = {0};
    return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
"""


def _body(src: str, name: str):
    """(start, end) of the body of __global__ kernel `name` in src."""
    i = src.index(f"{name}(")
    start = src.index("{", src.index(")", i)) + 1
    depth, j = 1, start
    while depth:
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        j += 1
    return start, j - 1


def instrument(src: str, kernel: str):
    """The source with phase counters; returns (source, phase names)."""
    _, name, fixed = KERNELS[kernel]
    a, b = _body(src, name)
    body = src[a:b]
    names = []
    if fixed:
        pat = re.compile(r"(__syncthreads\(\);[^\n]*\n)")
    else:
        pat = re.compile(r"(// phase: ([^\n]+)\n)")

    def mark(m):
        names.append(f"phase {len(names)}" if fixed
                     else m.group(2).strip())
        return m.group(1) + f"  PHASE({len(names) - 1});\n"

    body = pat.sub(mark, body)
    tail = len(names)
    names.append("end")
    if fixed and len(names) == len(fixed):
        names = list(fixed)
    body = ("\n  long long t_prev = clock64();\n" + body
            + f"  PHASE({tail});\n  if (threadIdx.x == 0) "
            "atomicAdd(&g_phase[15], 1ull);\n")
    src = src[:a] + body + src[b:]
    src = src.replace("namespace {\n", "namespace {\n" + COUNTERS, 1)
    return src + READ_OUT, names


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--kernel", choices=tuple(KERNELS), default="tc")
    ap.add_argument("--numerics", choices=("v4", "v23", "v1", "v2hm"),
                    default="v4")
    args = ap.parse_args()
    head_major = args.numerics in ("v1", "v2hm")
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    from dehaze_tpu_torch.ops import probsparse as ps_ops
    from dehaze_tpu_torch.ops import window as win_ops
    from dehaze_tpu_torch.ops.kernels import _build
    from dehaze_tpu_torch.ops.kernels import window_attention as K1

    lib_name = KERNELS[args.kernel][0]
    sigs = (K1._SIGNATURES if lib_name == "window_attention"
            else K1._TC_SIGNATURES)
    bwd = args.kernel.endswith("_bwd")
    if head_major and bwd:
        sys.exit("K3-v1 and v2 have no backward")
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = os.path.join(tmp, "k1.cu"), os.path.join(tmp, "k1.so")
        with open(_build.CSRC / f"{lib_name}.cu") as f:
            src, names = instrument(f.read(), args.kernel)
        with open(cu, "w") as f:
            f.write(src)
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                           capture_output=True, text=True)
        if r.returncode:
            sys.exit(f"nvcc failed:\n{r.stderr[-3000:]}")
        lib = ctypes.CDLL(so)
    for fn, argtypes in sigs.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    lib.k1_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.k1_phases.restype = ctypes.c_int
    _build._libs[lib_name] = lib  # the wrapper launches the instrumented copy

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1237)
    fwd, bwd_fn = {
        "v4": (K1.window_attention_fwd, K1.window_attention_bwd),
        "v23": (K1.window_attention_v3_fwd, K1.window_attention_v3_bwd),
        "v1": (K1.probsparse_window_attention_v1, None),
        "v2hm": (K1.probsparse_window_attention_v2, None)}[args.numerics]
    label = {"v4": "K1", "v23": "K3-v3", "v1": "K3-v1",
             "v2hm": "K3-v2"}[args.numerics]
    print(f"{label} "
          f"{'backward' if bwd else 'forward'}, {args.kernel} kernel, "
          f"from {lib_name}.cu under {os.path.abspath(args.root)}",
          flush=True)
    for name, B, C, heads, reg_hw in BWD_STAGES if bwd else STAGES:
        N = 64
        si = torch.from_numpy(np.random.default_rng(1234).integers(
            0, N, size=(N, ps_ops.probsparse_u(N))).astype(np.int32))
        bias = torch.randn(heads, N, N, generator=g, device=dev) * 0.1
        region = None
        if reg_hw is not None:
            region = torch.from_numpy(win_ops.shift_region_ids(
                reg_hw[0], reg_hw[1], 8, 4)).to(dev)
        shape = (B, heads, N, C // heads) if head_major else (B, N, C)
        dtype = torch.float32 if args.kernel == "f32" else torch.bfloat16
        q, k, v = (torch.randn(*shape, generator=g, device=dev).mul_(0.5)
                   .to(dtype) for _ in range(3))
        go = torch.randn(B, N, C, generator=g, device=dev).to(dtype)
        kw = dict(sample_idx=si, rel_pos_bias=bias, sw_region=region,
                  num_windows=1 if region is None else region.shape[0])
        if not head_major:
            kw["num_heads"] = heads

        def run():
            if bwd:
                return bwd_fn(q, k, v, go, **kw)
            return fwd(q, k, v, **kw)

        run()
        torch.cuda.synchronize()
        lib.k1_phases(None, 1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        out = (ctypes.c_ulonglong * 16)()
        lib.k1_phases(out, 0)
        ctas = max(out[15], 1)
        total = sum(out[i] for i in range(len(names))) / ctas
        print(f"{name} B_={B} C={C} h={heads} shifted={region is not None}: "
              f"{start.elapsed_time(end):.4f} ms instrumented, {out[15]} "
              f"CTAs, {total:.0f} cycles per CTA", flush=True)
        for i, ph in enumerate(names):
            per = out[i] / ctas
            print(f"  {ph:12s} {per:10.0f} cycles/CTA {per / total:7.1%}",
                  flush=True)


if __name__ == "__main__":
    main()
