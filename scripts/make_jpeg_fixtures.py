#!/usr/bin/env python3
"""Write the JPEG fixtures that `chip_smoke.py` decodes on the GPU host,
and the SHA-256 of the RGB pixels cv2 decodes from each.

    python3 scripts/make_jpeg_fixtures.py [--out tests/data]

The GPU host has neither cv2 nor PIL, so the reference pixels come from
here: cv2.imdecode(IMREAD_COLOR), swapped to RGB, as the JAX package's
`decode_img` gives them. Fixtures (seeded synthetic scenes of `data.synth`
with sensor-like noise):
- scene_1200x1600_420.jpg: cv2, 4:2:0, quality 95 (the serving frame);
- progressive_240x320_422.jpg: cv2, progressive, 4:2:2, optimised tables,
  a restart interval of 3 MCUs, quality 90;
- exif6_120x160.jpg: cv2, baseline 4:4:4, with an APP1 Exif block
  (big-endian) whose orientation is 6: it decodes to 160×120;
- smoothed_120x160_420.jpg: cv2, progressive 4:2:0, cut after its sixth
  scan (an EOI put there): the first 10 coefficients are not all refined,
  so libjpeg smooths its blocks;
- cmyk_120x160.jpg: PIL's CMYK (Adobe APP14 transform 0, inverted);
- ycck_120x160_420.jpg: libjpeg, YCCK (Adobe transform 2), progressive,
  2×2 luma sampling;
- arith_120x160_420.jpg: libjpeg, arithmetic-coded sequential (SOF9), DAC
  conditioning L=1, U=5, K=10, a restart interval of 3 MCUs;
- arith_prog_120x160_422.jpg: libjpeg, arithmetic-coded progressive
  (SOF10), 2×1 luma sampling, a restart interval of 2 MCUs;
- scene_1200x1600_cmyk.jpg and scene_1200x1600_arith.jpg: the serving
  frame as PIL's CMYK (quality 85) and as SOF9 4:2:0 (quality 95), whose
  decode chip_smoke.py times.
The libjpeg files come from a small C writer (`_WRITER`), built here with
`cc` against Pillow's bundled libjpeg-turbo, which has the arithmetic
encoder (the system libjpeg does not); its header is the system
`jpeglib.h`, so the writer first round-trips a file through cv2 to check
that the two agree on the struct layout. The hashes go to
jpeg_fixtures.json beside them, with each decoded shape.
`tests/test_torch_port_jpeg.py` checks the files against both, and
`scripts/fuzz_jpeg.py` mutates the small CMYK, YCCK and arithmetic ones.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import hashlib
import io
import json
import os
import struct
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# pixels h x w x comps -> a JPEG in memory. cs: 1 gray, 2 RGB (YCbCr in
# the file), 4 CMYK, 5 CMYK (YCCK in the file); o: quality, arithmetic,
# progressive, restart interval, DAC L, U, K, first component's h and v
# sampling
_WRITER = r"""
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>

int write_jpeg(const unsigned char* px, int w, int h, int comps, int cs,
               const int* o, unsigned char** out, unsigned long* size) {
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  int i, y;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  *out = NULL;
  *size = 0;
  jpeg_mem_dest(&c, out, size);
  c.image_width = w;
  c.image_height = h;
  c.input_components = comps;
  c.in_color_space = cs == 1 ? JCS_GRAYSCALE : cs == 2 ? JCS_RGB : JCS_CMYK;
  jpeg_set_defaults(&c);
  if (cs == 5) jpeg_set_colorspace(&c, JCS_YCCK);
  jpeg_set_quality(&c, o[0], TRUE);
  c.arith_code = o[1];
  if (o[2]) jpeg_simple_progression(&c);
  c.restart_interval = o[3];
  for (i = 0; i < NUM_ARITH_TBLS; ++i) {
    c.arith_dc_L[i] = o[4];
    c.arith_dc_U[i] = o[5];
    c.arith_ac_K[i] = o[6];
  }
  c.comp_info[0].h_samp_factor = o[7];
  c.comp_info[0].v_samp_factor = o[8];
  for (i = 1; i < c.num_components; ++i) {
    c.comp_info[i].h_samp_factor = c.comp_info[i].v_samp_factor = 1;
  }
  jpeg_start_compress(&c, TRUE);
  for (y = 0; y < h; ++y) {
    JSAMPROW row = (JSAMPROW)(px + (size_t)y * w * comps);
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  return 0;
}

void free_jpeg(unsigned char* p) { free(p); }
"""


def libjpeg_writer(tmp: str):
    """write(pixels, cs, quality, arith, progressive, restart, L, U, K, h0,
    v0) -> JPEG bytes, through Pillow's bundled libjpeg-turbo."""
    import PIL

    libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(
        PIL.__file__)), "pillow.libs", "libjpeg-*.so*"))
    if not libs:
        raise SystemExit("Pillow's bundled libjpeg-turbo was not found")
    so = os.path.join(tmp, "jpeg_writer.so")
    src = os.path.join(tmp, "jpeg_writer.c")
    with open(src, "w") as f:
        f.write(_WRITER)
    subprocess.run(["cc", "-O1", "-shared", "-fPIC", "-o", so, src, libs[0],
                    "-Wl,-rpath," + os.path.dirname(libs[0])], check=True)
    lib = ctypes.CDLL(so)
    if not hasattr(ctypes.CDLL(libs[0]), "jinit_arith_encoder"):
        raise SystemExit(f"{libs[0]} has no arithmetic encoder")

    def write(px, cs, *opts):
        import numpy as np

        px = np.ascontiguousarray(px, np.uint8)
        h, w, comps = px.shape if px.ndim == 3 else px.shape + (1,)
        o = (ctypes.c_int * 9)(*opts)
        out = ctypes.POINTER(ctypes.c_ubyte)()
        size = ctypes.c_ulong()
        lib.write_jpeg(px.ctypes.data_as(ctypes.c_void_p), w, h, comps, cs, o,
                       ctypes.byref(out), ctypes.byref(size))
        data = ctypes.string_at(out, size.value)
        lib.free_jpeg(out)
        return data

    return write


def _scan_ends(jpeg: bytes):
    """Offsets where each scan's entropy-coded data ends."""
    ends, p = [], 2
    while jpeg[p + 1] != 0xD9:
        n = struct.unpack_from(">H", jpeg, p + 2)[0]
        p += 2 + n
        if jpeg[p - n - 1] == 0xDA:  # skip the data up to the next marker
            while not (jpeg[p] == 0xFF and jpeg[p + 1] != 0
                       and not 0xD0 <= jpeg[p + 1] <= 0xD7):
                p += 1
            ends.append(p)
    return ends


def _exif6() -> bytes:
    """APP1 payload: Exif header, big-endian TIFF, IFD0 Orientation = 6."""
    ifd = (struct.pack(">H", 1) + struct.pack(">HHIH2x", 0x0112, 3, 1, 6)
           + struct.pack(">I", 0))
    return b"Exif\0\0" + b"MM" + struct.pack(">HI", 42, 8) + ifd


def fixtures(write):
    """{file name: JPEG bytes}; write: a `libjpeg_writer`."""
    import cv2
    import numpy as np
    from PIL import Image

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

    def cmyk(img, quality):
        bio = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(img[:, :, ::-1])).convert(
            "CMYK").save(bio, "JPEG", quality=quality)
        return bio.getvalue()

    def to_cmyk(img):  # a naive RGB -> CMYK with some black
        rgb = img[:, :, ::-1].astype(np.int32)
        k = 255 - rgb.max(axis=2, keepdims=True)
        return np.concatenate([255 - rgb - k, k], axis=2).astype(np.uint8)

    exif = _exif6()
    base = jpeg(scene(3, (120, 160), 2.0), cv2.IMWRITE_JPEG_QUALITY, 90,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    prog = jpeg(scene(4, (120, 160), 2.0), cv2.IMWRITE_JPEG_QUALITY, 85,
                cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    frame = scene(1, (1200, 1600), 2.0)
    small = scene(5, (120, 160), 2.0)
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
        "smoothed_120x160_420.jpg": prog[:_scan_ends(prog)[5]] + b"\xff\xd9",
        "cmyk_120x160.jpg": cmyk(small, 90),
        "ycck_120x160_420.jpg": write(to_cmyk(scene(6, (120, 160), 2.0)), 5,
                                      90, 0, 1, 0, 0, 1, 5, 2, 2),
        "arith_120x160_420.jpg": write(small[:, :, ::-1], 2, 90, 1, 0, 3, 1,
                                       5, 10, 2, 2),
        "arith_prog_120x160_422.jpg": write(scene(7, (120, 160), 2.0)[
            :, :, ::-1], 2, 90, 1, 1, 2, 0, 1, 5, 2, 1),
        "scene_1200x1600_cmyk.jpg": cmyk(frame, 85),
        "scene_1200x1600_arith.jpg": write(frame[:, :, ::-1], 2, 95, 1, 0, 0,
                                           0, 1, 5, 2, 2),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "tests", "data"))
    args = ap.parse_args()
    import cv2
    import numpy as np

    os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        write = libjpeg_writer(tmp)
        # the writer's header and Pillow's library must agree: a file it
        # writes decodes (by cv2) close to what it was given
        img = np.random.default_rng(0).integers(0, 256, (8, 8, 3), np.uint8)
        back = cv2.imdecode(np.frombuffer(write(img, 2, 100, 1, 0, 0, 0, 1, 5,
                                                1, 1), np.uint8),
                            cv2.IMREAD_COLOR)
        if back is None or np.abs(back[:, :, ::-1].astype(int)
                                  - img).mean() > 8:
            raise SystemExit("the JPEG writer does not round-trip; its "
                             "jpeglib.h does not match Pillow's libjpeg")
        files = fixtures(write)
    manifest = {}
    for name, data in files.items():
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
