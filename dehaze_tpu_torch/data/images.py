"""Image I/O with a standard-library PNG codec (zlib + struct).

Counterpart of `dehaze_tpu/data/images.py` with the same functions and
semantics — RGB [H, W, 3], float32 in [0, 1] or raw uint8 — but without cv2
or PIL, which the GPU host does not have. Decodes 8-bit grayscale, RGB and
RGBA PNGs (non-interlaced; all five filter types; alpha is dropped and gray
is repeated to RGB, as cv2's IMREAD_COLOR does) and encodes 8-bit RGB.
Anything else raises ValueError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # color type -> samples per pixel


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


def _unfilter_row(ft: int, row: np.ndarray, prev: np.ndarray, bpp: int
                  ) -> np.ndarray:
    if ft == 0:
        return row
    if ft == 1:  # Sub: running sum of each channel along the row
        return np.cumsum(row.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    if ft == 2:  # Up
        return row + prev
    if ft not in (3, 4):
        raise ValueError(f"unknown PNG filter type {ft}")
    cur = bytearray(row.tobytes())
    up = prev.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if ft == 3:  # Average
            pred = (a + b) >> 1
        else:  # Paeth
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → uint8 RGB [H, W, 3]."""
    if not data.startswith(_SIG):
        raise ValueError("undecodable image payload (not a PNG)")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, color type "
                         f"{ctype}, interlace {interlace} (8-bit gray, RGB "
                         "or RGBA, non-interlaced only)")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG data: {e}") from None
    if len(raw) != h * (stride + 1):
        raise ValueError("PNG data size does not match its header")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev,
                                      bpp)
    img = out.reshape(h, w, bpp)
    if bpp == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """uint8 RGB [H, W, 3] → PNG bytes (filter type 0 on every row)."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png takes uint8 [H, W, 3], got "
                         f"{img.dtype} {img.shape}")
    h, w, _ = img.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = img.reshape(h, 3 * w)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def is_png_file(filename: str) -> bool:
    return filename.lower().endswith(".png")


def _to_u8(img: np.ndarray) -> np.ndarray:
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return img


def decode_img(data: bytes, u8: bool = False) -> np.ndarray:
    """Encoded PNG bytes → [H, W, 3] float32 RGB in [0, 1], or raw uint8
    RGB with `u8=True` (the serving forwards normalize on the device)."""
    img = decode_png(data)
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
