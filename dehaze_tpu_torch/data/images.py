"""Image I/O with a standard-library PNG and BMP codec (zlib, struct, numpy
and a small C helper).

Counterpart of `dehaze_tpu/data/images.py` with the same functions and
semantics — RGB [H, W, 3], float32 in [0, 1] or raw uint8 — but without cv2
or PIL, which the GPU host does not have. It decodes what cv2's
IMREAD_COLOR gives the JAX package for these two containers:
- PNG of every colour type (gray, RGB, palette, gray + alpha, RGBA) at
  every bit depth (1, 2, 4, 8, 16), interlaced (Adam7) or not. Alpha and
  `tRNS` are dropped, gray is repeated to RGB, 16-bit samples keep their
  high byte and gray below 8 bits is scaled to 0..255, as libpng does for
  cv2. The row filters are undone by `csrc/png_unfilter.c`, built with the
  host C compiler at first use.
- BMP: uncompressed 1, 4 and 8-bit palette, 24-bit and 32-bit (`BI_RGB`,
  or `BI_BITFIELDS` with the standard masks), bottom-up or top-down.
Anything else (JPEG, RLE-compressed BMP, other containers) raises a
ValueError that names it. `encode_png` writes 8-bit RGB with libpng's
per-row filter choice.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from dehaze_tpu_torch.ops.kernels import _build

_SIG = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples per pixel, allowed bit depths)
_PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
              4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_UNFILTER = {"png_unfilter": [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_int64, ctypes.c_int64, ctypes.c_int]}
_BMP_COMPRESSION = {1: "RLE8", 2: "RLE4", 4: "JPEG", 5: "PNG",
                    6: "ALPHABITFIELDS"}
_BMP_STANDARD_MASKS = (0x00FF0000, 0x0000FF00, 0x000000FF)


def _chunks(data: bytes):
    pos = len(_SIG)
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("truncated PNG chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"bad CRC in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG ends without IEND")


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """h filtered rows of 1 + stride bytes -> [h, stride] uint8."""
    out = np.empty((h, stride), np.uint8)
    lib = _build.load_host_library("png_unfilter", _UNFILTER)
    bad = lib.png_unfilter(raw.ctypes.data, out.ctypes.data, h, stride, bpp)
    if bad:
        ft = int(raw[(bad - 1) * (stride + 1)])
        raise ValueError(f"unknown PNG filter type {ft} in row {bad - 1}")
    return out


def _samples(rows: np.ndarray, width: int, channels: int,
             depth: int) -> np.ndarray:
    """Unfiltered rows [h, stride] (any padding at the end of a row) ->
    uint8 samples [h, width, channels]: 16-bit samples keep their high
    byte, sub-byte ones are unpacked (most significant bits first)."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    if depth == 16:  # big-endian: the high byte comes first
        return np.ascontiguousarray(
            rows[:, :2 * width * channels].reshape(h, width, channels,
                                                  2)[..., 0])
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    vals = np.zeros(bits.shape[:2], np.uint8)
    for b in range(depth):
        vals = (vals << 1) | bits[..., b]
    return vals[:, :width, None]


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → uint8 RGB [H, W, 3]."""
    if not data.startswith(_SIG):
        raise ValueError("undecodable image payload (not a PNG)")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError("PNG IHDR of the wrong size")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, comp, filt, interlace = header
    if (ctype not in _PNG_TYPES or depth not in _PNG_TYPES[ctype][1]
            or comp or filt or interlace > 1 or not w or not h):
        raise ValueError(f"unsupported PNG: bit depth {depth}, color type "
                         f"{ctype}, interlace {interlace}")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    ch = _PNG_TYPES[ctype][0]
    bits = ch * depth
    bpp = max(1, bits // 8)
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG data: {e}") from None
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    img = np.empty((h, w, ch), np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:  # an empty pass has no bytes at all
            continue
        stride = -(-pw * bits // 8)
        n = ph * (stride + 1)
        if pos + n > raw.size:
            raise ValueError("PNG data size does not match its header")
        rows = _unfilter(raw[pos:pos + n], ph, stride, bpp)
        img[y0::dy, x0::dx] = _samples(rows, pw, ch, depth)
        pos += n
    if pos != raw.size:
        raise ValueError("PNG data size does not match its header")
    if ctype == 3:
        if int(img.max()) >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[img[..., 0]]
    if ch >= 3:
        return np.ascontiguousarray(img[:, :, :3])
    gray = img[:, :, :1]
    if depth < 8:  # libpng's expansion: 1 -> 255, 2 -> 85, 4 -> 17 per step
        gray = gray * np.uint8(255 // ((1 << depth) - 1))
    return np.repeat(gray, 3, axis=2)


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP bytes → uint8 RGB [H, W, 3]: uncompressed 1/4/8-bit palette,
    24-bit and 32-bit (alpha dropped), bottom-up or top-down."""
    if not data.startswith(b"BM"):
        raise ValueError("undecodable image payload (not a BMP)")
    if len(data) < 14 + 40:  # file header, info header
        raise ValueError("truncated BMP header")
    (offset,) = struct.unpack_from("<I", data, 10)
    (hsize,) = struct.unpack_from("<I", data, 14)
    if hsize < 40:
        raise ValueError(f"unsupported BMP header size {hsize}")
    w, h, _, bits, comp = struct.unpack_from("<iiHHI", data, 18)
    (n_colors,) = struct.unpack_from("<I", data, 46)
    if comp in _BMP_COMPRESSION:
        raise ValueError(f"unsupported BMP compression "
                         f"{_BMP_COMPRESSION[comp]} (uncompressed BMP only)")
    if comp == 3:  # BI_BITFIELDS: masks after a 40-byte header, else in it
        if bits != 32 or len(data) < 14 + 40 + 12:
            raise ValueError(f"unsupported {bits}-bit BITFIELDS BMP")
        masks = struct.unpack_from("<III", data, 14 + 40)
        if masks != _BMP_STANDARD_MASKS:
            raise ValueError("unsupported BMP channel masks "
                             + ", ".join(f"{m:#010x}" for m in masks))
    elif comp != 0:
        raise ValueError(f"unsupported BMP compression {comp}")
    if bits not in (1, 4, 8, 24, 32):
        raise ValueError(f"unsupported {bits}-bit BMP")
    top_down = h < 0
    h = abs(h)
    if w <= 0 or h == 0:
        raise ValueError(f"BMP of size {w}x{h}")
    stride = (w * bits + 31) // 32 * 4
    if offset + stride * h > len(data):
        raise ValueError("BMP pixel data is truncated")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h,
                                                                     stride)
    if not top_down:
        rows = rows[::-1]
    if bits >= 24:
        bgr = rows[:, :w * bits // 8].reshape(h, w, bits // 8)[:, :, :3]
        return np.ascontiguousarray(bgr[:, :, ::-1])
    n = n_colors or 1 << bits
    start = 14 + hsize  # 4-byte entries, blue green red
    if start + 4 * n > offset:
        raise ValueError("BMP palette overlaps its pixel data")
    palette = np.frombuffer(data, np.uint8, 4 * n, start).reshape(
        n, 4)[:, 2::-1]
    idx = _samples(rows, w, 1, bits)[..., 0]
    if int(idx.max()) >= n:
        raise ValueError("BMP palette index out of range")
    return palette[idx]


def _residuals(rows: np.ndarray, bpp: int) -> np.ndarray:
    """The five PNG filters of every row at once: [5, h, stride] uint8
    residuals of the uint8 rows [h, stride] (filters read original bytes
    only, so no row depends on another's result; uint8 differences wrap
    modulo 256, as the filters do)."""
    up = np.zeros_like(rows)
    up[1:] = rows[:-1]
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    ul = np.zeros_like(rows)
    ul[:, bpp:] = up[:, :-bpp]
    avg = (left >> 1) + (up >> 1) + (left & up & 1)  # floor((a + b) / 2)
    a, b, c = (x.astype(np.int16) for x in (left, up, ul))
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    return np.stack([rows, rows - left, rows - up, rows - avg, rows - paeth])


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """uint8 RGB [H, W, 3] → PNG bytes. Each row takes the filter whose
    residual bytes, read as signed, have the least sum of magnitudes
    (libpng's heuristic; ties go to the lower filter type). zlib level 1
    by default, as cv2 (the JAX package's encoder) writes PNGs."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png takes uint8 [H, W, 3], got "
                         f"{img.dtype} {img.shape}")
    h, w, _ = img.shape
    res = _residuals(img.reshape(h, 3 * w), 3)
    cost = np.abs(res.view(np.int8).astype(np.int16)).sum(-1,
                                                          dtype=np.int64)
    ft = cost.argmin(0)
    raw = np.empty((h, 1 + 3 * w), np.uint8)
    raw[:, 0] = ft
    raw[:, 1:] = res[ft, np.arange(h)]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def is_png_file(filename: str) -> bool:
    return filename.lower().endswith(".png")


def is_image_file(filename: str) -> bool:
    return filename.lower().endswith((".png", ".jpg", ".jpeg", ".bmp"))


def _to_u8(img: np.ndarray) -> np.ndarray:
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return img


def decode_img(data: bytes, u8: bool = False) -> np.ndarray:
    """Encoded PNG or BMP bytes → [H, W, 3] float32 RGB in [0, 1], or raw
    uint8 RGB with `u8=True` (the serving forwards normalize on the
    device). JPEG and other formats raise ValueError."""
    if data.startswith(_SIG):
        img = decode_png(data)
    elif data.startswith(b"BM"):
        img = decode_bmp(data)
    elif data.startswith(b"\xff\xd8\xff"):
        raise ValueError("JPEG is not supported (the port decodes PNG and "
                         "BMP only)")
    else:
        raise ValueError("undecodable image payload (not a PNG or BMP)")
    return img if u8 else img.astype(np.float32) / 255.0


def encode_img(img: np.ndarray, ext: str = ".png") -> bytes:
    """[H, W, 3] float (0..1) or uint8 RGB → PNG bytes, rounding floats as
    floor(x * 255 + 0.5)."""
    if ext.lower() != ".png":
        raise ValueError(f"only .png is supported, got {ext!r}")
    return encode_png(_to_u8(img))


def load_img(path: str, u8: bool = False) -> np.ndarray:
    """[H, W, 3] float32 RGB in [0, 1] (or uint8 with u8=True)."""
    with open(path, "rb") as f:
        return decode_img(f.read(), u8=u8)


def save_img(path: str, img: np.ndarray) -> None:
    """Save [H, W, 3] float (0..1) or uint8 RGB as PNG."""
    with open(path, "wb") as f:
        f.write(encode_img(img))
