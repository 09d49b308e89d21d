#!/usr/bin/env python3
"""Write the JPEG fixtures that `chip_smoke.py` decodes on the GPU host,
and the SHA-256 of the RGB pixels cv2 decodes from each.

    python3 scripts/make_jpeg_fixtures.py [--out tests/data]

The GPU host has neither cv2 nor PIL, so the reference pixels come from
here: cv2.imdecode(IMREAD_COLOR), swapped to RGB, as the JAX package's
`decode_img` gives them. Fixtures (written by cv2, seeded):
- scene_1200x1600_420.jpg: a hazy 1200×1600 scene of `data.synth` with
  sensor-like noise, 4:2:0, quality 95 (the serving frame);
- progressive_240x320_422.jpg: a synthetic scene, progressive, 4:2:2,
  optimised tables, a restart interval of 3 MCUs, quality 90;
- exif6_120x160.jpg: a synthetic scene, baseline 4:4:4, with an APP1 Exif
  block (big-endian) whose orientation is 6: it decodes to 160×120.
The hashes go to jpeg_fixtures.json beside them, with each decoded shape.
`tests/test_torch_port_jpeg.py` checks the files against both.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import struct
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _exif6() -> bytes:
    """APP1 payload: Exif header, big-endian TIFF, IFD0 Orientation = 6."""
    ifd = (struct.pack(">H", 1) + struct.pack(">HHIH2x", 0x0112, 3, 1, 6)
           + struct.pack(">I", 0))
    return b"Exif\0\0" + b"MM" + struct.pack(">HI", 42, 8) + ifd


def fixtures():
    """{file name: JPEG bytes}."""
    import cv2
    import numpy as np

    sys.path.insert(0, HERE)
    from dehaze_tpu_torch.data.synth import make_scene

    def scene(seed, size, noise):
        rng = np.random.default_rng(seed)
        hazy = make_scene(rng, size)[1] * 255.0
        hazy = hazy + rng.normal(0.0, noise, size=hazy.shape)
        return np.clip(hazy + 0.5, 0, 255).astype(np.uint8)[:, :, ::-1]

    def jpeg(img, *params):
        ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(img),
                               list(params))
        assert ok
        return buf.tobytes()

    exif = _exif6()
    base = jpeg(scene(3, (120, 160), 2.0), cv2.IMWRITE_JPEG_QUALITY, 90,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    return {
        "scene_1200x1600_420.jpg": jpeg(
            scene(1, (1200, 1600), 2.0), cv2.IMWRITE_JPEG_QUALITY, 95,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
        "progressive_240x320_422.jpg": jpeg(
            scene(2, (240, 320), 2.0), cv2.IMWRITE_JPEG_QUALITY, 90,
            cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_OPTIMIZE, 1,
            cv2.IMWRITE_JPEG_RST_INTERVAL, 3,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
        "exif6_120x160.jpg": (base[:2] + b"\xff\xe1"
                              + struct.pack(">H", len(exif) + 2) + exif
                              + base[2:]),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "tests", "data"))
    args = ap.parse_args()
    import cv2
    import numpy as np

    os.makedirs(args.out, exist_ok=True)
    manifest = {}
    for name, data in fixtures().items():
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
        rgb = cv2.imdecode(np.frombuffer(data, np.uint8),
                           cv2.IMREAD_COLOR)[:, :, ::-1]
        manifest[name] = {"shape": list(rgb.shape),
                          "sha256": hashlib.sha256(
                              np.ascontiguousarray(rgb).tobytes()).hexdigest(),
                          "bytes": len(data)}
        print(f"{name}: {len(data)} bytes, RGB {rgb.shape}")
    with open(os.path.join(args.out, "jpeg_fixtures.json"), "w") as f:
        json.dump({"decoder": f"cv2 {cv2.__version__} IMREAD_COLOR, BGR to "
                   "RGB", "files": manifest}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
