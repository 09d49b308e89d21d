"""Build the sources in `dehaze_tpu_torch/csrc/` and load them.

Each `csrc/<name>.cu` exposes a plain C interface. At first use it is compiled
with nvcc for Hopper (`sm_90a`) into a content-hashed shared library under
`dehaze_tpu_torch/_build/` and loaded with ctypes. Each `csrc/<name>.c` (host
code, such as the PNG unfilter) is built the same way with the host C
compiler (`cc`, the one nvcc itself needs). Nothing is built at import time,
and nothing falls back: a missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CC_FLAGS = ("-std=c99", "-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_name_locks: Dict[str, threading.Lock] = {}  # one build per source at a time
_libs: Dict[str, ctypes.CDLL] = {}
# name -> (seconds spent building, ptxas report); empty when loaded from disk
build_info: Dict[str, Tuple[float, str]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _cc() -> str:
    path = shutil.which("cc") or shutil.which("gcc")
    if path is None:
        raise RuntimeError("no host C compiler (cc or gcc) on PATH: the "
                           "host helpers in dehaze_tpu_torch/csrc/*.c need "
                           "one")
    return path


def _build(src: Path, compiler, flags: Sequence[str]) -> Path:
    """Compile `src` into `_build/<stem>-<hash of source and flags>.so`,
    once: concurrent builds (threads or processes) each write their own
    temporary file and rename it into place."""
    name = src.stem
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()
                            ).hexdigest()[:16]
    so = BUILD_DIR / f"{name}-{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    tool = compiler()
    r = subprocess.run([tool, *flags, "-o", str(tmp), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{os.path.basename(tool)} failed on {src.name}:"
                           f"\n{r.stderr[-4000:]}")
    os.replace(tmp, so)
    build_info[name] = (time.perf_counter() - t0, r.stderr)
    return so


def _load(src: Path, compiler, flags, signatures, cuda: bool):
    name = src.stem
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(src, compiler, flags)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            if cuda:
                lib.cuda_error_string.argtypes = [ctypes.c_int]
                lib.cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def load_library(name: str,
                 signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`; `signatures` maps each C
    entry point to its ctypes argtypes (every entry returns an int error
    code, `cudaGetLastError()` after the launch). Different sources build
    in parallel when called from several threads."""
    return _load(CSRC / f"{name}.cu", _nvcc, NVCC_FLAGS, signatures, True)


def load_host_library(name: str,
                      signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Build (if needed) and load the host C source `csrc/<name>.c`, as
    `load_library` does for CUDA sources (every entry returns an int)."""
    return _load(CSRC / f"{name}.c", _cc, CC_FLAGS, signatures, False)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
