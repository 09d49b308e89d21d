#!/usr/bin/env python3
"""Where K2's bf16 kernel spends its time, phase by phase, on one NVIDIA GPU.

    python3 scripts/k2_phases.py [--ablate-gelu]

Builds an instrumented copy of dehaze_tpu_torch/csrc/leff.cu (in a temporary
directory; the source in the repository is not touched): thread 0 of every
CTA reads clock64() after each of the kernel's barriers and adds the cycles
since the last one to a per-phase counter. Runs it once at five stage shapes
of the serving frame (bf16, exact GELU, hidden 4C, seeded random weights)
and prints the cycles per CTA and per hidden chunk of each phase:
  LN        LayerNorm of the haloed tile, until chunk 0's weights landed;
  dense2    dense2 of the previous chunk, and the wait for this one's W1;
  dense1    the W2 copy's issue and dense1 (tensor cores);
  gelu      the next W1 copy's issue and the GELU pass over the hidden tile;
  dwconv    the depthwise conv + GELU, and the wait for this chunk's W2.
The counters and clock reads slow the kernel somewhat; shares are what they
show. With --ablate-gelu the GELU is the identity (results wrong): the time
it saves is the GELU's cost. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = [("enc0", (1, 1280, 1664, 32)), ("enc1", (1, 640, 832, 64)),
          ("enc3", (1, 160, 208, 256)), ("bottleneck", (1, 80, 104, 512)),
          ("dec0", (1, 160, 208, 512))]
PHASES = ["LN", "dense2", "dense1", "gelu", "dwconv", "last dense2"]
EXACT_GELU = "return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));"


def instrument(src: str, ablate_gelu: bool) -> str:
    src = src.replace("namespace {\n", """namespace {
__device__ unsigned long long g_phase[8];
#define PHASE(i) do { if (threadIdx.x == 0) { long long t_ = clock64(); \\
  atomicAdd(&g_phase[(i)], (unsigned long long)(t_ - t_prev)); \\
  t_prev = t_; } } while (0)
""", 1)
    src = src.replace("  issue_p1(0);\n",
                      "  long long t_prev = clock64();\n  issue_p1(0);\n", 1)
    for tag, idx in (("A", "v == 0 ? 0 : 1"), ("B", "2"), ("G", "3"),
                     ("C", "4")):
        src, n = re.subn(rf"(__syncthreads\(\); +// {tag}\n)",
                         rf"\1    PHASE({idx});\n", src, count=1)
        assert n == 1, f"barrier {tag} not found"
    mark = "  store_tile<L, MODE>(acc, b2, out, sMax2,"
    assert mark in src
    src = src.replace(mark, "  PHASE(5);\n  if (threadIdx.x == 0) "
                      "atomicAdd(&g_phase[7], 1ull);\n" + mark, 1)
    if ablate_gelu:
        assert EXACT_GELU in src
        src = src.replace(EXACT_GELU, "return x;")
    return src + """
extern "C" int leff_phases(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[8] = {0};
    return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ablate-gelu", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    from dehaze_tpu_torch.ops.kernels import _build
    from dehaze_tpu_torch.ops.kernels import leff as K2

    with tempfile.TemporaryDirectory() as tmp:
        cu, so = os.path.join(tmp, "leff.cu"), os.path.join(tmp, "leff.so")
        with open(_build.CSRC / "leff.cu") as f:
            src = instrument(f.read(), args.ablate_gelu)
        with open(cu, "w") as f:
            f.write(src)
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                           capture_output=True, text=True)
        if r.returncode:
            sys.exit(f"nvcc failed:\n{r.stderr[-3000:]}")
        lib = ctypes.CDLL(so)
    lib.leff_fwd.argtypes = K2._SIGNATURES["leff_fwd"]
    lib.leff_fwd.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    lib.leff_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.leff_phases.restype = ctypes.c_int
    _build._libs["leff"] = lib  # leff_fused launches the instrumented copy

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1236)
    for name, shape in STAGES:
        C = shape[-1]
        Ch = 4 * C

        def rnd(*s, std=1.0, mean=0.0):
            return (torch.randn(*s, generator=g, device=dev) * std + mean
                    ).bfloat16()

        p = {"ln_scale": rnd(C, std=0.1, mean=1.0), "ln_bias": rnd(C, std=0.1),
             "w1": rnd(C, Ch, std=1 / math.sqrt(C)), "b1": rnd(Ch, std=0.1),
             "dw_kernel": rnd(3, 3, 1, Ch, std=1 / 3),
             "dw_bias": rnd(Ch, std=0.1),
             "w2": rnd(Ch, C, std=1 / math.sqrt(Ch)), "b2": rnd(C, std=0.1)}
        x = rnd(*shape)
        K2.leff_fused(x, **p)
        torch.cuda.synchronize()
        lib.leff_phases(None, 1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        K2.leff_fused(x, **p)
        end.record()
        torch.cuda.synchronize()
        out = (ctypes.c_ulonglong * 8)()
        lib.leff_phases(out, 0)
        ctas = out[7]
        kc = next(c[2] for c in K2._MMA_CLASSES if C <= c[0])
        chunks = -(-Ch // kc)
        total = sum(out[i] for i in range(6)) / ctas
        print(f"{name} x={list(shape)} hidden={Ch}: "
              f"{start.elapsed_time(end):.4f} ms instrumented, {ctas} CTAs, "
              f"{total:.0f} cycles per CTA, {chunks} chunks of {kc}",
              flush=True)
        for i, ph in enumerate(PHASES):
            per = out[i] / ctas
            per_chunk = per / chunks if 1 <= i <= 4 else per
            print(f"  {ph:12s} {per:10.0f} cycles/CTA {per_chunk:8.0f} per "
                  f"chunk {per / total:7.1%}", flush=True)


if __name__ == "__main__":
    main()
