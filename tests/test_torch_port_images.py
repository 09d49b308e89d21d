"""The port's image codec (`dehaze_tpu_torch.data.images`) against the JAX
package's `decode_img` (cv2's IMREAD_COLOR on this host), byte for byte:
every PNG colour type and bit depth, palettes, 16-bit samples, Adam7
interlacing, all five row filters in one image, and BMP at 1, 4, 8, 24 and
32 bits, bottom-up and top-down, with padded rows. Also the encoder's
per-row filter choice and the formats that stay refused."""

import struct
import zlib

import cv2
import numpy as np
import pytest

from dehaze_tpu.data import images as jax_images
from dehaze_tpu_torch.data import images

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# every (colour type, bit depth) that the PNG spec allows
PNG_FORMATS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
               (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8),
               (6, 16)]


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _pack_rows(samples, depth):
    """[h, w, ch] ints -> [h, stride] bytes, as PNG packs them."""
    h, w, ch = samples.shape
    flat = samples.reshape(h, w * ch).astype(np.uint16)
    if depth == 16:
        return np.stack([flat >> 8, flat & 0xFF], -1).reshape(
            h, -1).astype(np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(
        h, -1).astype(np.uint8)
    return np.packbits(bits, axis=1)


def _filter_rows(rows, bpp, first_filter):
    """Filter byte rows, cycling through types 0-4 from `first_filter`."""
    rows = rows.astype(np.int32)
    out = []
    for y, cur in enumerate(rows):
        ft = (first_filter + y) % 5
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul))
        pred = (0, left, up, (left + up) // 2, paeth)[ft]
        out.append(bytes([ft]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
    return b"".join(out)


def _png(samples, ctype, depth, interlace=False, palette=None, extra=b""):
    """A PNG of `samples` [h, w, ch] written by hand, rows cycling through
    all five filter types (in every Adam7 pass)."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    data = b""
    for n, (x0, y0, dx, dy) in enumerate(passes):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            data += _filter_rows(_pack_rows(sub, depth), bpp, n)
    body = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                          0, int(interlace))))
    if palette is not None:
        body += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return (body + extra + _chunk(b"IDAT", zlib.compress(data))
            + _chunk(b"IEND", b""))


def _same_as_cv2(data):
    got = images.decode_img(data, u8=True)
    want = jax_images.decode_img(data, u8=True)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(images.decode_img(data),
                                  jax_images.decode_img(data))
    return got


@pytest.mark.parametrize("interlace", [False, True],
                         ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,depth", PNG_FORMATS,
                         ids=[f"type{c}-{d}bit" for c, d in PNG_FORMATS])
def test_png_decode_matches_cv2(ctype, depth, interlace):
    """Each colour type and bit depth, plain and Adam7 (13×11: neither
    side a multiple of 8, so passes are ragged), all five filters."""
    rng = np.random.default_rng(ctype * 100 + depth + 7 * interlace)
    ch = CHANNELS[ctype]
    palette = None
    if ctype == 3:
        n = min(1 << depth, 200)  # not every index value has an entry
        palette = rng.integers(0, 256, size=(n, 3))
        samples = rng.integers(0, n, size=(11, 13, 1))
    else:
        samples = rng.integers(0, 1 << depth, size=(11, 13, ch))
    got = _same_as_cv2(_png(samples, ctype, depth, interlace, palette))
    assert got.shape == (11, 13, 3)


def test_png_palette_ignores_trns():
    """A tRNS chunk (palette transparency) is dropped with the alpha."""
    rng = np.random.default_rng(3)
    palette = rng.integers(0, 256, size=(16, 3))
    samples = rng.integers(0, 16, size=(9, 10, 1))
    trns = _chunk(b"tRNS", bytes(range(0, 256, 16)))
    _same_as_cv2(_png(samples, 3, 4, palette=palette, extra=trns))


def _bmp(img, bits, top_down, bitfields=False):
    """A BMP of uint8 RGB `img` (through a palette below 24 bits), written
    by hand with rows padded to 4 bytes."""
    h, w, _ = img.shape
    palette = None
    if bits <= 8:
        n = 1 << bits
        palette = np.random.default_rng(bits).integers(0, 256, (n, 3))
        idx = np.random.default_rng(bits + 1).integers(0, n, (h, w))
        img = palette[idx].astype(np.uint8)
        rows = _pack_rows(idx[..., None], bits)
    else:
        bgr = img[:, :, ::-1]
        if bits == 32:
            alpha = np.full((h, w, 1), 77, np.uint8)
            bgr = np.concatenate([bgr, alpha], -1)
        rows = bgr.reshape(h, -1)
    stride = (w * bits + 31) // 32 * 4
    pix = np.zeros((h, stride), np.uint8)
    pix[:, :rows.shape[1]] = rows
    if not top_down:
        pix = pix[::-1]
    extra = b""
    if palette is not None:
        pal = np.zeros((len(palette), 4), np.uint8)
        pal[:, :3] = palette[:, ::-1]
        extra = pal.tobytes()
    elif bitfields:
        extra = struct.pack("<III", 0xFF0000, 0xFF00, 0xFF)
    offset = 14 + 40 + len(extra)
    dib = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bits,
                      3 if bitfields else 0, pix.size, 2835, 2835, 0, 0)
    head = struct.pack("<2sIHHI", b"BM", offset + pix.size, 0, 0, offset)
    return head + dib + extra + pix.tobytes(), img


@pytest.mark.parametrize("hw", [(7, 13), (1, 1)], ids=["7x13", "1x1"])
@pytest.mark.parametrize("top_down", [False, True], ids=["bottom_up",
                                                         "top_down"])
@pytest.mark.parametrize("bits", [1, 4, 8, 24, 32])
def test_bmp_decode_matches_cv2(bits, top_down, hw):
    """Odd widths, so every row carries padding; and a single pixel."""
    img = np.random.default_rng(bits).integers(0, 256, hw + (3,),
                                               dtype=np.uint8)
    data, want = _bmp(img, bits, top_down)
    np.testing.assert_array_equal(_same_as_cv2(data), want)


def test_bmp_32bit_bitfields_matches_cv2():
    img = np.random.default_rng(32).integers(0, 256, (5, 9, 3),
                                             dtype=np.uint8)
    data, want = _bmp(img, 32, False, bitfields=True)
    np.testing.assert_array_equal(_same_as_cv2(data), want)


def test_bmp_written_by_cv2():
    img = np.random.default_rng(5).integers(0, 256, (6, 11, 3),
                                            dtype=np.uint8)
    ok, buf = cv2.imencode(".bmp", img[:, :, ::-1])
    assert ok
    np.testing.assert_array_equal(_same_as_cv2(buf.tobytes()), img)


def _textured(h, w, seed):
    """Smooth gradients plus noise: rows on which different filters win."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 3, yy * 2, xx + yy], -1) % 256
    noise = rng.integers(0, 6, size=(h, w, 3))
    img = (base + noise) % 256
    img[: h // 3] = rng.integers(0, 256, size=(h // 3, w, 3))
    return img.astype(np.uint8)


def _filter_types(png):
    h = struct.unpack(">I", png[20:24])[0]
    raw = zlib.decompress(b"".join(body for kind, body in images._chunks(png)
                                   if kind == b"IDAT"))
    return np.frombuffer(raw, np.uint8).reshape(h, -1)[:, 0]


def test_encoder_filters_rows_and_round_trips_through_cv2():
    img = _textured(40, 57, 1)
    png = images.encode_img(img)
    types = set(_filter_types(png).tolist())
    assert len(types) >= 3 and types <= {0, 1, 2, 3, 4}
    back = cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(back[:, :, ::-1], img)
    np.testing.assert_array_equal(images.decode_img(png, u8=True), img)


def test_encoder_picks_libpngs_filter():
    """Per row, the filter with the least sum of |signed residual|."""
    img = _textured(12, 9, 2)
    got = _filter_types(images.encode_png(img))
    rows = img.reshape(12, -1).astype(np.int32)
    for y, ft in enumerate(got):
        costs = []
        for cand in range(5):
            res = _filter_rows(rows[max(0, y - 1):y + 1], 3,
                               cand - (1 if y else 0))
            r = np.frombuffer(res, np.uint8).reshape(-1, 1 + rows.shape[1])
            r = r[-1, 1:].astype(np.int32)
            costs.append(int(np.minimum(r, 256 - r).sum()))
        assert ft == int(np.argmin(costs)), (y, costs)


def test_png_written_by_cv2_with_its_own_filters():
    img = _textured(33, 45, 3)
    ok, buf = cv2.imencode(".png", img[:, :, ::-1])
    assert ok
    np.testing.assert_array_equal(_same_as_cv2(buf.tobytes()), img)


def test_refused_formats_name_themselves():
    """Formats that stay refused, by name: an arithmetic-coded lossless JPEG
    (the kinds of JPEG: tests/test_torch_port_jpeg.py), RLE8 BMP, GIF."""
    img = _textured(8, 8, 4)
    ok, jpg = cv2.imencode(".jpg", img)
    assert ok
    jpg = jpg.tobytes()
    i = jpg.index(b"\xff\xc0")
    with pytest.raises(ValueError, match="arithmetic-coded lossless"):
        images.decode_img(jpg[:i + 1] + b"\xcb" + jpg[i + 2:])
    data, _ = _bmp(img, 8, False)
    rle = bytearray(data)
    rle[30:34] = struct.pack("<I", 1)  # biCompression = BI_RLE8
    with pytest.raises(ValueError, match="RLE8"):
        images.decode_img(bytes(rle))
    with pytest.raises(ValueError, match="not a PNG or BMP"):
        images.decode_img(b"GIF89a" + bytes(20))


@pytest.mark.parametrize("cut", [2, 20, 60, 200])
def test_truncated_payloads_raise_value_error(cut):
    """A payload cut short raises ValueError (a 400 from the server), never
    another exception."""
    img = _textured(8, 9, 6)
    for data in (images.encode_img(img), _bmp(img, 24, False)[0]):
        with pytest.raises(ValueError):
            images.decode_img(data[:cut])


def test_is_image_file_as_the_jax_package():
    for name in ("a.png", "B.PNG", "c.jpg", "d.jpeg", "e.bmp", "f.gif",
                 "g.txt", "png"):
        assert images.is_image_file(name) == jax_images.is_image_file(name)
        assert images.is_png_file(name) == jax_images.is_png_file(name)
