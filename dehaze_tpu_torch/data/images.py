"""Image I/O with a standard-library PNG, BMP and JPEG codec (zlib, struct,
numpy and two small C helpers).

Counterpart of `dehaze_tpu/data/images.py` with the same functions and
semantics — RGB [H, W, 3], float32 in [0, 1] or raw uint8 — but without cv2
or PIL, which the GPU host does not have. It decodes what cv2's
IMREAD_COLOR gives the JAX package for these containers, byte for byte:
- PNG of every colour type (gray, RGB, palette, gray + alpha, RGBA) at
  every bit depth (1, 2, 4, 8, 16), interlaced (Adam7) or not. Alpha and
  `tRNS` are dropped, gray is repeated to RGB, 16-bit samples keep their
  high byte and gray below 8 bits is scaled to 0..255, as libpng does for
  cv2. The row filters are undone by `csrc/png_unfilter.c`.
- BMP: uncompressed 1, 4 and 8-bit palette, 24-bit and 32-bit (`BI_RGB`,
  or `BI_BITFIELDS` with the standard masks), bottom-up or top-down.
- JPEG: 8-bit, gray, three or four components (Adobe CMYK and YCCK),
  Huffman or arithmetic-coded (with DAC conditioning), baseline, extended
  sequential and progressive, any integral sampling factors (4:4:4, 4:2:2,
  4:2:0, 4:4:0, 4:1:1, ...), restart intervals, as libjpeg-turbo decodes
  it for cv2 (islow IDCT, block smoothing of a progressive image whose low
  coefficients are not all refined, fancy upsampling, its fixed-point
  YCbCr -> RGB; CMYK as OpenCV converts libjpeg's CMYK output). The
  markers are parsed here; the entropy decode, smoothing, IDCT,
  upsampling and colour conversion are `csrc/jpeg_decode.c`. Corrupt data
  decodes as libjpeg-turbo decodes it for cv2 (restart
  resynchronisation, zero fill, the 16-bit arithmetic of its SIMD IDCT,
  the segments it reads leniently) or raises ValueError where cv2 returns
  nothing (`scripts/fuzz_jpeg.py` holds mutated files to cv2). A file
  without its EOI decodes where cv2's libjpeg never asks for a byte past
  the end.
The C helpers are built with the host C compiler at first use. As cv2
does, a JPEG's EXIF orientation (APP1 `Exif`) and a PNG's (`eXIf`) turn or
flip the image upright. Anything else (lossless, hierarchical or 12-bit
JPEG, a truncated file, RLE-compressed BMP, other containers) raises a
ValueError that names it. `encode_png` writes 8-bit RGB with libpng's
per-row filter choice.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Optional

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
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_JPEG = {"jpeg_decode_scan": [_P, _I64] + [_P] * 7,
         "jpeg_decode_scan_arith": [_P, _I64] + [_P] * 7,
         "jpeg_output": [_I, _I, _I] + [_P] * 6 + [_I, _P, _P]}
# JPEG frame markers this decoder refuses, by name, as cv2's libjpeg-turbo
# does (see ROADMAP.md, F6)
_JPEG_REFUSED = {
    0xC3: "lossless (SOF3)", 0xC5: "hierarchical (SOF5)",
    0xC6: "hierarchical (SOF6)", 0xC7: "hierarchical lossless (SOF7)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "hierarchical arithmetic-coded (SOF13)",
    0xCE: "hierarchical arithmetic-coded (SOF14)",
    0xCF: "hierarchical arithmetic-coded lossless (SOF15)",
    0xDE: "hierarchical (DHP)", 0xDF: "hierarchical (EXP)"}
_JPEG_ERRORS = {1: "a corrupt Huffman table", 2: "an undefined Huffman table",
                3: "a corrupt scan",
                4: "truncated JPEG (its data ends where libjpeg asks for "
                   "more)"}
# markers with a length and a body that libjpeg reads or skips: SOF0-2,
# SOF9-10, DHT, DAC, DQT, DRI, SOS, DNL, APP0-15, COM (RST0-7 and TEM stand
# alone); libjpeg stops at any other marker, and so does this decoder
_JPEG_SEGMENTS = frozenset([0xC0, 0xC1, 0xC2, 0xC9, 0xCA, 0xC4, 0xCC, 0xDB,
                            0xDD, 0xDA, 0xDC, 0xFE, *range(0xE0, 0xF0)])
# the segments libjpeg skips (or saves) without checking their length: one
# below 2 is read as no body at all, and reading goes on after it
_JPEG_SKIPPED = frozenset([0xDC, 0xFE, *range(0xE0, 0xF0)])
# frame markers: (progressive, arithmetic-coded)
_JPEG_FRAMES = {0xC0: (False, False), 0xC1: (False, False),
                0xC2: (True, False), 0xC9: (False, True), 0xCA: (True, True)}
# the Huffman tables of ITU-T T.81 Annex K.3 (16 counts, then the symbols),
# which libjpeg-turbo installs in DC/AC slots 0 and 1 of a sequential JPEG
# that leaves them undefined (motion-JPEG frames), in the order DC 0, DC 1,
# AC 0, AC 1
_STD_HUFF = {slot: bytes.fromhex(spec) for slot, spec in (
    (0, "00010501010101010100000000000000000102030405060708090a0b"),
    (1, "00030101010101010101010000000000000102030405060708090a0b"),
    (4, "0002010303020403050504040000017d01020300041105122131410613516107"
        "227114328191a1082342b1c11552d1f02433627282090a161718191a25262728"
        "292a3435363738393a434445464748494a535455565758595a63646566676869"
        "6a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7"
        "a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2"
        "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    (5, "0002010204040304070504040001027700010203110405213106124151076171"
        "1322328108144291a1b1c109233352f0156272d10a162434e125f11718191a26"
        "2728292a35363738393a434445464748494a535455565758595a636465666768"
        "696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5"
        "a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
        "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))}
# zigzag position -> natural position of a DCT coefficient
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])
# the first 10 coefficients (zigzag order) whose partial refinement makes
# libjpeg smooth a progressive image's blocks (jdcoefct.c, SAVED_COEFS)
_SMOOTHED = 10
# EXIF tags whose value cv2's ExifReader reads from an offset, and the bytes
# it reads there: the ASCII strings (their count; up to 4 are held in the
# entry) and the rationals (8 bytes each). An offset past the block's end
# makes it give up on the rest of the IFD.
_EXIF_STRINGS = frozenset([0x010E, 0x010F, 0x0110, 0x0131, 0x0132, 0x8298])
_EXIF_RATIONALS = {0x011A: 8, 0x011B: 8, 0x013E: 16, 0x013F: 48, 0x0211: 24,
                   0x0214: 48}


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


def exif_orientation(tiff: bytes) -> Optional[int]:
    """The Orientation tag (0x0112) of a TIFF/EXIF block's first IFD, read
    as cv2's ExifReader reads it: either byte order, the 16-bit value at the
    entry's value field whatever its declared type and count, the first
    such entry among the IFD's counted entries. The entries are read in
    order, and a string or rational tag whose data lies past the block's
    end stops the reading, so an Orientation after it is not seen. None
    when there is none or the block is malformed (no byte order mark, a
    magic other than 42, an IFD or entry past the end)."""
    n = len(tiff)
    if n < 8 or tiff[:2] not in (b"II", b"MM"):
        return None
    e = "<" if tiff[:2] == b"II" else ">"
    magic, off = struct.unpack_from(e + "HI", tiff, 2)
    if magic != 42 or off + 2 > n:
        return None
    (count,) = struct.unpack_from(e + "H", tiff, off)
    for i in range(count):
        p = off + 2 + 12 * i
        if p + 2 > n:
            return None
        (tag,) = struct.unpack_from(e + "H", tiff, p)
        if tag == 0x0112:
            if p + 10 > n:
                return None
            return struct.unpack_from(e + "H", tiff, p + 8)[0]
        if tag in _EXIF_STRINGS or tag in _EXIF_RATIONALS:
            if p + 12 > n:
                return None
            cnt, at = struct.unpack_from(e + "II", tiff, p + 4)
            size = _EXIF_RATIONALS.get(tag, cnt)
            if (tag in _EXIF_RATIONALS or cnt > 4) and at + size > n:
                return None
    return None


def apply_orientation(img: np.ndarray, orientation: Optional[int]
                      ) -> np.ndarray:
    """[H, W, C] turned or flipped upright for an EXIF orientation 1-8, as
    cv2's ExifTransform does; any other value (or None) leaves it."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → uint8 RGB [H, W, 3], upright by its `eXIf` orientation."""
    if not data.startswith(_SIG):
        raise ValueError("undecodable image payload (not a PNG)")
    header, palette, idat, exif = None, None, [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError("PNG IHDR of the wrong size")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf" and exif is None:
            exif = body
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
        rgb = palette[img[..., 0]]
    elif ch >= 3:
        rgb = img[:, :, :3]
    else:
        gray = img[:, :, :1]
        if depth < 8:  # libpng's expansion: 1 -> 255, 2 -> 85, 4 -> 17
            gray = gray * np.uint8(255 // ((1 << depth) - 1))
        rgb = np.repeat(gray, 3, axis=2)
    return apply_orientation(rgb, None if exif is None
                             else exif_orientation(exif))


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


def _jpeg_frame(seg: bytes):
    """A SOF0/1/2/9/10 segment -> (height, width, [(id, h, v, table)])."""
    if len(seg) < 6:
        raise ValueError("truncated JPEG frame header")
    prec, h, w, nf = struct.unpack_from(">BHHB", seg)
    if prec != 8:
        raise ValueError(f"{prec}-bit JPEG is not supported (8-bit only)")
    if nf not in (1, 3, 4):
        raise ValueError(f"JPEG with {nf} components is not supported")
    if h == 0:
        raise ValueError("JPEG with its height in a DNL marker is not "
                         "supported")
    if w == 0 or len(seg) != 6 + 3 * nf or len(set(seg[6::3])) != nf:
        raise ValueError("corrupt JPEG frame header")
    if max(h, w) > 65500:  # libjpeg's JPEG_MAX_DIMENSION
        raise ValueError(f"JPEG of {w}x{h} exceeds 65500 pixels a side")
    if h * w > 1 << 30:  # cv2's CV_IO_MAX_IMAGE_PIXELS
        raise ValueError(f"JPEG of {w}x{h} exceeds 2^30 pixels")
    comps = []
    for i in range(nf):
        cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
        if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4) or tq > 3:
            raise ValueError("corrupt JPEG frame header (sampling factors "
                             "or quantisation table)")
        comps.append((cid, hv >> 4, hv & 15, tq))
    return h, w, comps


def _jpeg_tables(seg: bytes, marker: int, qt: dict, huff: np.ndarray):
    """DQT or DHT segment into qt ({id: 64 divisors in natural order}) or
    huff ([8, 16 + 256]: DC 0..3, then AC 0..3)."""
    i = 0
    while i < len(seg):
        if marker == 0xDB:
            pq, tq = seg[i] >> 4, seg[i] & 15
            n = 128 if pq else 64
            if tq > 3 or pq > 1 or i + 1 + n > len(seg):
                raise ValueError("corrupt JPEG quantisation table")
            vals = np.frombuffer(seg, ">u2" if pq else np.uint8, 64, i + 1)
            q = np.zeros(64, np.uint16)
            q[_ZIGZAG] = vals
            qt[tq] = q
            i += 1 + n
        else:
            tc, th = seg[i] >> 4, seg[i] & 15
            counts = seg[i + 1:i + 17]
            n = sum(counts)
            if tc > 1 or th > 3 or len(counts) < 16 or n > 256 \
                    or i + 17 + n > len(seg):
                raise ValueError("corrupt JPEG Huffman table")
            huff[4 * tc + th] = 0
            huff[4 * tc + th, :16] = np.frombuffer(counts, np.uint8)
            huff[4 * tc + th, 16:16 + n] = np.frombuffer(seg, np.uint8, n,
                                                         i + 17)
            i += 17 + n


def _next_marker(data: bytes, pos: int):
    """The next marker at or after pos, as libjpeg's next_marker finds it
    (bytes that are not 0xFF, fill bytes and stuffed FF 00 pairs are
    skipped): (marker code, position after it), or (None, len(data))."""
    n = len(data)
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0:
            return None, n
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            return None, n
        if data[pos]:
            return data[pos], pos + 1
        pos += 1


def _jpeg_dac(seg: bytes, cond: np.ndarray) -> None:
    """A DAC segment into cond (L[16], U[16], K[16]), as libjpeg reads it."""
    if len(seg) % 2:
        raise ValueError("corrupt JPEG arithmetic conditioning (DAC)")
    for i in range(0, len(seg), 2):
        index, val = seg[i], seg[i + 1]
        if index >= 32 or (index < 16 and val & 15 > val >> 4):
            raise ValueError("corrupt JPEG arithmetic conditioning (DAC)")
        if index >= 16:
            cond[32 + index - 16] = val
        else:
            cond[index], cond[16 + index] = val & 15, val >> 4


def _smoothing(comps, coef_bits: np.ndarray, prev_bits: np.ndarray,
               scans: int, last_good: int) -> Optional[np.ndarray]:
    """libjpeg's test for block smoothing (jdcoefct.c, smoothing_ok): every
    component has its quantisation table, nonzero at the first 10
    coefficients, and a DC scan, and some of those 10 coefficients are not
    fully refined. Then per component the 10 precisions, the 10 before its
    last scan (all -1 in a one-scan file), and last the last iMCU row that
    uses the first ten (the rows after it use the others); or None."""
    natural = _ZIGZAG[:_SMOOTHED]
    if any(c["quant"] is None or not c["quant"][natural].all()
           for c in comps) or (coef_bits[:, 0] < 0).any():
        return None
    if not (coef_bits[:, 1:_SMOOTHED] != 0).any():
        return None
    prev = prev_bits[:, :_SMOOTHED] if scans > 1 else np.full_like(
        prev_bits[:, :_SMOOTHED], -1)
    latch = np.concatenate([coef_bits[:, :_SMOOTHED], prev], axis=1)
    return np.append(latch.reshape(-1), last_good).astype(np.int32)


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes → uint8 RGB [H, W, 3], upright by its EXIF orientation,
    as cv2.imdecode(IMREAD_COLOR) and a BGR → RGB swap give it.

    The markers are read as libjpeg reads them for cv2. A sequential JPEG
    whose first scan holds every component is done with that scan: cv2
    ignores what follows it (libjpeg reads it only when the image is
    finished, and cv2 does not look at that step's errors), and its data
    need not end at a marker where libjpeg asks for no byte past the end.
    Any other JPEG is read to its EOI."""
    if not data.startswith(b"\xff\xd8\xff"):  # cv2's JPEG signature
        raise ValueError("undecodable image payload (not a JPEG)")
    lib = _build.load_host_library("jpeg_decode", _JPEG)
    buf = np.frombuffer(data, np.uint8)
    n, pos = len(data), 2
    qt, huff = {}, np.zeros((8, 272), np.uint8)
    cond = np.array([0] * 16 + [1] * 16 + [5] * 16, np.uint8)  # DAC defaults
    frame, progressive, arith, comps, restart = None, False, False, [], 0
    jfif, adobe, exif = False, None, []
    coef_bits, stop, scans = None, np.zeros(2, np.int64), 0
    last_good = 0  # libjpeg's last good iMCU row of the last scan
    while True:
        m, pos = _next_marker(data, pos)
        if m is None:
            raise ValueError("truncated JPEG (no EOI marker)")
        if m == 0xD9:
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:  # markers without a segment
            continue
        if m in _JPEG_REFUSED:
            raise ValueError(f"{_JPEG_REFUSED[m]} JPEG is not supported")
        if m not in _JPEG_SEGMENTS:
            raise ValueError(f"corrupt JPEG (unknown marker 0x{m:02x})")
        if pos + 2 > n:
            raise ValueError("truncated JPEG")
        (length,) = struct.unpack_from(">H", data, pos)
        if length < 2 and m in _JPEG_SKIPPED:
            pos += 2
            continue
        if length < 2 or pos + length > n:
            raise ValueError("truncated JPEG marker segment")
        seg = data[pos + 2:pos + length]
        pos += length
        if m in _JPEG_FRAMES:
            if frame is not None:
                raise ValueError("corrupt JPEG (two frame headers)")
            frame = _jpeg_frame(seg)
            progressive, arith = _JPEG_FRAMES[m]
            H, W, fcomps = frame
            hmax = max(c[1] for c in fcomps)
            vmax = max(c[2] for c in fcomps)
            mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
            for cid, h, v, tq in fcomps:
                comps.append(dict(
                    id=cid, h=h, v=v, tq=tq, quant=None,
                    wib=-(-W * h // (8 * hmax)), hib=-(-H * v // (8 * vmax)),
                    bw=mcux * h,
                    coef=np.zeros((mcuy * v, mcux * h, 64), np.int16)))
            coef_bits = np.full((len(comps), 64), -1, np.int32)
            prev_bits = np.zeros_like(coef_bits)
        elif m in (0xDB, 0xC4):
            _jpeg_tables(seg, m, qt, huff)
        elif m == 0xCC:
            _jpeg_dac(seg, cond)
        elif m == 0xDD:
            if len(seg) != 2:
                raise ValueError("corrupt JPEG restart interval")
            (restart,) = struct.unpack_from(">H", seg)
        elif scans and m in (0xE0, 0xE1, 0xEE):
            pass  # libjpeg and cv2 read these only before the first scan
        elif m == 0xE0 and seg.startswith(b"JFIF\0") and len(seg) >= 14:
            jfif = True
        elif m == 0xEE and seg.startswith(b"Adobe") and len(seg) >= 12:
            adobe = seg[11]
        elif m == 0xE1 and seg.startswith(b"Exif\0\0"):
            exif.append(seg[6:])
        elif m == 0xDA:
            if frame is None:
                raise ValueError("corrupt JPEG (a scan before the frame "
                                 "header)")
            ns = seg[0] if seg else 0
            if not 1 <= ns <= 4 or len(seg) != 4 + 2 * ns:
                raise ValueError("corrupt JPEG scan header")
            ss, se, ahal = seg[1 + 2 * ns:4 + 2 * ns]
            ah, al = ahal >> 4, ahal & 15
            if progressive and (se > 63 or ss > se or (ss == 0) != (se == 0)
                                or (ss > 0 and ns != 1) or al > 13
                                or (ah and al != ah - 1)):
                raise ValueError("corrupt JPEG (invalid progressive scan)")
            if not scans and not progressive and not arith:
                for slot, spec in _STD_HUFF.items():  # as libjpeg-turbo
                    if not huff[slot, :16].any():
                        huff[slot, :len(spec)] = np.frombuffer(spec, np.uint8)
            # the tables the scan reads (a DC refinement reads none), each
            # below 4 (Huffman) or 16 (arithmetic), as libjpeg checks them
            uses_dc = not progressive or (ss == 0 and ah == 0)
            uses_ac = not progressive or ss > 0
            limit = 16 if arith else 4
            ids = [c["id"] for c in comps]
            if len(set(seg[1:1 + 2 * ns:2])) != ns:
                raise ValueError("corrupt JPEG scan header (a component "
                                 "twice)")
            desc = [int(progressive), ss, se, ah, al, restart, ns, 0, 0]
            ptrs, blocks = [None] * 4, 0
            for j in range(ns):
                cs, t = seg[1 + 2 * j:3 + 2 * j]
                # libjpeg-turbo takes the frame component with this id only
                # if scan slot ci is still free: one after a component that
                # follows it in the frame fails
                ci = ids.index(cs) if cs in ids else -1
                if ci < j or (uses_dc and t >> 4 >= limit) \
                        or (uses_ac and t & 15 >= limit):
                    raise ValueError("corrupt JPEG scan header")
                c = comps[ci]
                if c["quant"] is None:  # latched at its first scan
                    if c["tq"] not in qt:
                        raise ValueError("JPEG quantisation table "
                                         f"{c['tq']} is not defined")
                    c["quant"] = qt[c["tq"]].copy()
                ptrs[j] = c["coef"].ctypes.data
                desc += [j, c["h"], c["v"], c["bw"], c["wib"], c["hib"],
                         t >> 4 if uses_dc else 0, t & 15 if uses_ac else 0]
                blocks += c["h"] * c["v"]
                if progressive:  # as jdphuff.c's start_pass keeps them
                    span = slice(min(ss, 1), max(se, 9) + 1)
                    prev_bits[ci, span] = coef_bits[ci, span] if scans else 0
                    coef_bits[ci, ss:se + 1] = al
                else:
                    coef_bits[ci, :] = 0
            if ns == 1:  # one block per MCU, over the component's blocks
                desc[7:9] = [c["wib"], c["hib"]]
            else:
                if blocks > 10:
                    raise ValueError("corrupt JPEG (more than 10 blocks "
                                     "in an MCU)")
                desc[7:9] = [mcux, mcuy]
            decode = (lib.jpeg_decode_scan_arith if arith
                      else lib.jpeg_decode_scan)
            err = decode(buf[pos:].ctypes.data, n - pos,
                         np.asarray(desc, np.int32).ctypes.data, *ptrs,
                         (cond if arith else huff).ctypes.data,
                         stop.ctypes.data)
            if err:
                raise ValueError(_JPEG_ERRORS[err] if err == 4
                                 else f"corrupt JPEG: {_JPEG_ERRORS[err]}")
            pos += int(stop[0])
            scans += 1
            # the iMCU row of the last MCU begun with data to read (a
            # one-component scan's MCU rows are block rows, v to an iMCU row)
            mcu_row = int(stop[1]) // desc[7]
            last_good = mcu_row // c["v"] if ns == 1 else mcu_row
            if scans == 1 and not progressive and ns == len(comps):
                break
    if frame is None or not scans:
        raise ValueError("corrupt JPEG (no frame or no scan)")
    smooth = (_smoothing(comps, coef_bits, prev_bits, scans, last_good)
              if progressive else None)
    H, W, _ = frame
    if len(comps) == 1:
        color = 0
    elif len(comps) == 4:  # CMYK, or YCCK: Adobe transform 2 (or another)
        color = 3 if adobe in (None, 0) else 4
    elif jfif:
        color = 1
    elif adobe is not None:
        color = 2 if adobe == 0 else 1
    else:
        color = 2 if [c["id"] for c in comps] == [82, 71, 66] else 1
    cdesc = np.asarray([[c["h"], c["v"], c["bw"], c["wib"], c["hib"]]
                        for c in comps], np.int32)
    quant = np.stack([np.zeros(64, np.uint16) if c["quant"] is None
                      else c["quant"] for c in comps])
    out = np.empty((H, W, 3), np.uint8)
    ptrs = [c["coef"].ctypes.data for c in comps] + [None] * (4 - len(comps))
    if lib.jpeg_output(H, W, len(comps), cdesc.ctypes.data, *ptrs,
                       quant.ctypes.data, color,
                       None if smooth is None else smooth.ctypes.data,
                       out.ctypes.data):
        raise ValueError("JPEG with fractional sampling factors is not "
                         "supported")
    for block in exif:  # the first block that has the tag decides
        orientation = exif_orientation(block)
        if orientation is not None:
            return apply_orientation(out, orientation)
    return out


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
    """Encoded PNG, BMP or JPEG bytes → [H, W, 3] float32 RGB in [0, 1], or
    raw uint8 RGB with `u8=True` (the serving forwards normalize on the
    device), upright by the EXIF orientation as cv2 applies it. Other
    formats, and the kinds of JPEG listed in the module's docstring, raise
    ValueError."""
    if data.startswith(_SIG):
        img = decode_png(data)
    elif data.startswith(b"BM"):
        img = decode_bmp(data)
    elif data.startswith(b"\xff\xd8\xff"):
        img = decode_jpeg(data)
    else:
        raise ValueError("undecodable image payload (not a PNG or BMP, nor "
                         "a JPEG)")
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
