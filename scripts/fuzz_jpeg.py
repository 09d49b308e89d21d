#!/usr/bin/env python3
"""Mutation fuzzing of the port's JPEG decoder against cv2.

    python3 scripts/fuzz_jpeg.py [--n 3000] [--seed 0] [--asan]

Seeded mutations of small JPEGs (five that cv2 writes, and the committed
CMYK, YCCK, arithmetic-coded and smoothed-progressive fixtures of
`scripts/make_jpeg_fixtures.py`: bytes flipped or replaced in the headers
and the scan data, runs deleted, random bytes and marker-like pairs
inserted) go through the port's `decode_img` and through
`cv2.imdecode(IMREAD_COLOR)`, the JAX package's decoder. The port must
either raise ValueError or decode to exactly cv2's pixels (so where cv2
returns nothing, the port raises). Anything else is counted, and makes the
exit code 1. With --asan, `csrc/jpeg_decode.c` is built with
AddressSanitizer and UndefinedBehaviorSanitizer (the script runs itself
again with their runtime preloaded), so any read or write out of bounds,
or undefined arithmetic, aborts the run. Needs cv2 and gcc (the dev box;
the GPU host has no cv2). `tests/test_torch_port_jpeg.py` runs a short
`--asan` pass and uses `seed_jpegs` and `mutate` for its own cases.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SANITIZERS = "-fsanitize=address,undefined"


# committed fixtures that seed mutations too: name -> file in tests/data
FIXTURE_SEEDS = {"cmyk": "cmyk_120x160.jpg",
                 "ycck-progressive": "ycck_120x160_420.jpg",
                 "arith-rst": "arith_120x160_420.jpg",
                 "arith-progressive-rst": "arith_prog_120x160_422.jpg",
                 "smoothed-progressive": "smoothed_120x160_420.jpg"}


def seed_jpegs() -> dict:
    """Name → a 17×33 JPEG cv2 writes in that mode (every sampling the
    port decodes, sequential and progressive, restart intervals), and the
    120×160 fixtures of FIXTURE_SEEDS (Adobe CMYK and YCCK, arithmetic
    coding with DAC conditioning and restarts, block smoothing)."""
    import cv2

    rng = np.random.default_rng(19)
    base = cv2.GaussianBlur(rng.uniform(0, 255, (17, 33, 3)).astype(
        np.float32), (0, 0), 1.5)
    yy, xx = np.mgrid[:17, :33]
    base += (60 * np.sin(xx / 7.0) + 40 * np.cos(yy / 5.0))[..., None]
    img = np.clip(base, 0, 255).astype(np.uint8)
    S = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    modes = {
        "420-baseline": [S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420],
        "444-progressive": [S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                            cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
        "411-optimized-rst": [S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
                              cv2.IMWRITE_JPEG_OPTIMIZE, 1,
                              cv2.IMWRITE_JPEG_RST_INTERVAL, 1],
        "422-progressive-rst": [S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                                cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
        "gray-progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]}
    out = {}
    for name, params in modes.items():
        src = img[:, :, 0] if name.startswith("gray") else img
        ok, buf = cv2.imencode(".jpg", src,
                               [cv2.IMWRITE_JPEG_QUALITY, 80] + params)
        assert ok
        out[name] = buf.tobytes()
    for name, file in FIXTURE_SEEDS.items():
        with open(os.path.join(ROOT, "tests", "data", file), "rb") as f:
            out[name] = f.read()
    return out


def mutate(jpeg: bytes, rng: np.random.Generator) -> bytes:
    """One seeded mutation: 1-3 bytes flipped or replaced (half of them in
    the headers up to the first scan header, half in the scan data), or a
    run of 1-5 bytes deleted, or 1-4 random bytes inserted, or a pair
    0xFF, x inserted."""
    d = bytearray(jpeg)
    sos = jpeg.index(b"\xff\xda")
    kind = rng.integers(0, 4)
    at = int(rng.integers(2, len(d) - 2))
    if kind == 0:
        for _ in range(int(rng.integers(1, 4))):
            at = int(rng.integers(2, sos + 14) if rng.random() < 0.5
                     else rng.integers(sos, len(d) - 2))
            d[at] = (d[at] ^ 1 << int(rng.integers(0, 8))
                     if rng.random() < 0.5 else int(rng.integers(0, 256)))
    elif kind == 1:
        del d[at:at + int(rng.integers(1, 6))]
    elif kind == 2:
        d[at:at] = rng.integers(0, 256, int(rng.integers(1, 5)),
                                np.uint8).tobytes()
    else:
        d[at:at] = bytes([0xFF, int(rng.integers(0, 256))])
    return bytes(d)


def overfull_tables(jpeg: bytes):
    """The JPEG with a DHT segment put before its first scan that defines a
    table whose codes overflow their lengths (libjpeg refuses each): 255
    one-bit AC codes, whose lookup entries would reach 64 KB past a
    512-entry table; 248 nine-bit AC codes after one of each shorter
    length; 5 two-bit DC codes."""
    i = jpeg.index(b"\xff\xda")
    for table, counts, symbol in ((0x10, [255] + [0] * 15, 0x41),
                                  (0x10, [1] * 8 + [248] + [0] * 7, 0x41),
                                  (0x00, [0, 5] + [0] * 14, 3)):
        body = bytes([table] + counts + [symbol] * sum(counts))
        yield (jpeg[:i] + b"\xff\xc4" + (len(body) + 2).to_bytes(2, "big")
               + body + jpeg[i:])


def _use_sanitized_decoder(images) -> None:
    """Point the codec at a sanitizer build of the decoder."""
    from dehaze_tpu_torch.ops.kernels import _build

    with tempfile.TemporaryDirectory() as tmp:  # loaded, then deleted
        so = os.path.join(tmp, "jpeg_decode_asan.so")
        subprocess.run(["gcc", "-std=c99", "-O1", "-g", SANITIZERS,
                        "-fno-sanitize-recover=all", "-shared", "-fPIC",
                        "-o", so, os.path.join(ROOT, "dehaze_tpu_torch",
                                               "csrc", "jpeg_decode.c")],
                       check=True)
        lib = ctypes.CDLL(so)
    for fn, argtypes in images._JPEG.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    load = _build.load_host_library
    _build.load_host_library = (
        lambda name, sig: lib if name == "jpeg_decode" else load(name, sig))


def run(n: int, seed: int) -> collections.Counter:
    """n mutations of each seed JPEG, and its over-full tables; counts of
    each outcome."""
    import cv2

    from dehaze_tpu_torch.data import images

    counts = collections.Counter()
    for k, jpeg in enumerate(seed_jpegs().values()):
        rng = np.random.default_rng([seed, k])
        cases = [mutate(jpeg, rng) for _ in range(n)]
        for data in cases + list(overfull_tables(jpeg)):
            want = cv2.imdecode(np.frombuffer(data, np.uint8),
                                cv2.IMREAD_COLOR)
            try:
                got = images.decode_img(data, u8=True)
            except ValueError:
                counts["port raises, cv2 decodes" if want is not None
                       else "both refuse"] += 1
                continue
            if want is None:
                counts["port decodes what cv2 refuses"] += 1
            elif got.shape != want.shape or (got != want[:, :, ::-1]).any():
                counts["port differs from cv2"] += 1
            else:
                counts["same pixels"] += 1
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=3000,
                    help="mutations per seed JPEG")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--asan", action="store_true",
                    help="decode with a sanitizer build of the decoder")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.asan:
        if "FUZZ_JPEG_PRELOADED" not in os.environ:
            runtime = [subprocess.run(
                ["gcc", f"-print-file-name={lib}"], capture_output=True,
                text=True, check=True).stdout.strip()
                for lib in ("libasan.so", "libubsan.so")]
            env = dict(os.environ, LD_PRELOAD=":".join(runtime),
                       ASAN_OPTIONS="detect_leaks=0",
                       FUZZ_JPEG_PRELOADED="1")
            return subprocess.run([sys.executable] + sys.argv,
                                  env=env).returncode
        from dehaze_tpu_torch.data import images

        _use_sanitized_decoder(images)
    counts = run(args.n, args.seed)
    for outcome, count in sorted(counts.items()):
        print(f"{count:7d}  {outcome}")
    bad = (counts["port decodes what cv2 refuses"]
           + counts["port differs from cv2"])
    print(f"FUZZ_JPEG n={sum(counts.values())} bad={bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
