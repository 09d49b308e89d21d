"""The port's JPEG decoder and EXIF orientation (`dehaze_tpu_torch.data.
images`) against the JAX package's `decode_img` (cv2's IMREAD_COLOR, which
is libjpeg-turbo's decode here), byte for byte: every sampling factor cv2
writes (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1), baseline, progressive and
optimised Huffman tables, restart intervals, qualities 5 to 100, sizes
that are not a multiple of the MCU, grayscale, JPEGs written by PIL, a
1200×1600 frame, and the EXIF orientations 1-8 of JPEG (APP1) and PNG
(eXIf) in both byte orders. Also what stays refused, each by name, and
corrupt input: over-full Huffman tables, coefficients out of the 8-bit
range, seeded mutations (each decodes to cv2's pixels or raises
ValueError), and the decoder under AddressSanitizer and UBSan. No JAX
compile: the JAX package's codec is cv2 itself."""

import io
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from dehaze_tpu.data import images as jax_images
from dehaze_tpu_torch.data import images

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
MODES = {"baseline": [], "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
         "optimized": [cv2.IMWRITE_JPEG_OPTIMIZE, 1]}


def _textured(h, w, seed, channels=3):
    """Smooth structure plus noise, so every coefficient band is used."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h, w, channels)).astype(np.float32)
    base = cv2.GaussianBlur(base, (0, 0), 1.5).reshape(h, w, channels)
    yy, xx = np.mgrid[:h, :w]
    base += (60 * np.sin(xx / 7.0) + 40 * np.cos(yy / 5.0))[..., None]
    return np.clip(base, 0, 255).astype(np.uint8)


def _cv2_jpeg(rgb, *params):
    img = rgb[:, :, ::-1] if rgb.shape[2] == 3 else rgb[:, :, 0]
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(img), list(params))
    assert ok
    return buf.tobytes()


def _same_as_cv2(data):
    want = jax_images.decode_img(data, u8=True)
    got = images.decode_img(data, u8=True)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("rst", [0, 2])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_jpeg_matches_cv2(sampling, mode, rst):
    """Each sampling factor, coding mode and restart interval at qualities
    5, 50, 95 and 100 and sizes 1×1, 7×13 and 17×33."""
    for h, w in ((1, 1), (7, 13), (17, 33)):
        img = _textured(h, w, seed=h * w)
        for q in (5, 50, 95, 100):
            _same_as_cv2(_cv2_jpeg(
                img, cv2.IMWRITE_JPEG_QUALITY, q,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                cv2.IMWRITE_JPEG_RST_INTERVAL, rst, *MODES[mode]))


@pytest.mark.parametrize("mode", list(MODES))
def test_grayscale_jpeg_matches_cv2(mode):
    img = _textured(19, 27, seed=5, channels=1)
    for q in (5, 50, 95, 100):
        got = _same_as_cv2(_cv2_jpeg(img, cv2.IMWRITE_JPEG_QUALITY, q,
                                     *MODES[mode]))
        assert (got[..., 0] == got[..., 2]).all()


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("progressive", [False, True])
def test_jpeg_written_by_pil_matches_cv2(subsampling, progressive):
    """PIL's encoder (its own headers and tables), with and without
    optimised tables; a grayscale one; one with PIL's web_high tables."""
    img = _textured(23, 31, seed=7)
    for optimize in (False, True):
        bio = io.BytesIO()
        Image.fromarray(img).save(bio, "JPEG", quality=85,
                                  subsampling=subsampling,
                                  progressive=progressive, optimize=optimize)
        _same_as_cv2(bio.getvalue())
    bio = io.BytesIO()
    Image.fromarray(img[:, :, 0]).save(bio, "JPEG", quality=70,
                                       progressive=progressive)
    _same_as_cv2(bio.getvalue())
    bio = io.BytesIO()
    Image.fromarray(img).save(bio, "JPEG", qtables="web_high",
                              subsampling=subsampling)
    _same_as_cv2(bio.getvalue())


def test_rgb_jpeg_matches_cv2():
    """A JPEG that libjpeg takes as RGB (PIL's keep_rgb: no colour
    transform, component ids R, G, B) is copied through, as cv2 does."""
    bio = io.BytesIO()
    Image.fromarray(_textured(16, 24, seed=8)).save(bio, "JPEG", quality=90,
                                                    keep_rgb=True)
    _same_as_cv2(bio.getvalue())


@pytest.mark.parametrize("progressive", [False, True])
def test_full_frame_jpeg_matches_cv2(progressive):
    """The published protocol's 1200×1600 frame, 4:2:0 at quality 95."""
    img = _textured(1200, 1600, seed=9)
    _same_as_cv2(_cv2_jpeg(img, cv2.IMWRITE_JPEG_QUALITY, 95,
                           cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)))


@pytest.mark.parametrize("rst", [0, 1])
def test_premature_marker_in_scan_data_matches_cv2(rst):
    """Scan data cut short by an EOI: libjpeg fills the block that runs out
    with zero bits and leaves the rest of the scan gray (resynchronising at
    the restart markers), and cv2 returns that image."""
    data = _cv2_jpeg(_textured(64, 80, seed=10), cv2.IMWRITE_JPEG_QUALITY,
                     90, cv2.IMWRITE_JPEG_RST_INTERVAL, rst)
    sos = data.index(b"\xff\xda")
    start = sos + 2 + struct.unpack_from(">H", data, sos + 2)[0]
    cut = start + (len(data) - start) // 2
    while 0xFF in data[cut - 1:cut + 1]:
        cut += 1
    _same_as_cv2(data[:cut] + b"\xff\xd9")


# ---- EXIF orientation ----------------------------------------------------

def _tiff(orientation, order="II", magic=42, entries=None):
    """A TIFF block whose first IFD holds the Orientation tag (SHORT)."""
    e = "<" if order == "II" else ">"
    if entries is None:
        entries = [struct.pack(e + "HHIH2x", 0x0112, 3, 1, orientation)]
    return (order.encode() + struct.pack(e + "HI", magic, 8)
            + struct.pack(e + "H", len(entries)) + b"".join(entries)
            + struct.pack(e + "I", 0))


def _with_app1(jpeg, payload):
    return (jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2)
            + payload + jpeg[2:])


def _with_exif_chunk(png, tiff):
    i = png.index(b"IDAT") - 4
    return (png[:i] + struct.pack(">I", len(tiff)) + b"eXIf" + tiff
            + struct.pack(">I", zlib.crc32(b"eXIf" + tiff)) + png[i:])


@pytest.mark.parametrize("container", ["jpeg", "png"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_cv2(orientation, container):
    """Orientations 1-8 turn or flip a 5×9 image as cv2 does, from a
    JPEG's APP1 Exif block and a PNG's eXIf chunk, in both byte orders."""
    img = _textured(5, 9, seed=11)
    for order in ("II", "MM"):
        tiff = _tiff(orientation, order)
        if container == "jpeg":
            data = _with_app1(_cv2_jpeg(img, cv2.IMWRITE_JPEG_QUALITY, 95),
                              b"Exif\0\0" + tiff)
        else:
            data = _with_exif_chunk(images.encode_img(img), tiff)
        got = _same_as_cv2(data)
        assert got.shape == ((9, 5, 3) if orientation >= 5 else (5, 9, 3))


def test_malformed_exif_as_cv2():
    """What cv2 does with odd tags, followed: a value of 0 or 9 and a
    block without the tag leave the image; a LONG-typed tag is read as its
    first 16 bits; a wrong magic, a bad byte order and an IFD past the end
    are ignored, and then a later APP1 Exif block decides; the first block
    with the tag wins over later ones."""
    img = _textured(5, 9, seed=12)
    jpeg = _cv2_jpeg(img, cv2.IMWRITE_JPEG_QUALITY, 95)
    png = images.encode_img(img)
    make = struct.pack("<HHI", 0x010F, 2, 4) + b"Cam\0"
    long6 = struct.pack(">HHII", 0x0112, 4, 1, 6)
    far = bytearray(_tiff(6))
    far[4:8] = struct.pack("<I", 500)
    blocks = [_tiff(0), _tiff(9), _tiff(6, magic=43), b"XX" + _tiff(6)[2:],
              bytes(far), _tiff(0, entries=[make]), _tiff(6)[:19],
              _tiff(0, "MM", entries=[long6]),
              _tiff(0, "II", entries=[struct.pack("<HHII", 0x0112, 4, 1,
                                                  6)])]
    for tiff in blocks:
        _same_as_cv2(_with_app1(jpeg, b"Exif\0\0" + tiff))
        _same_as_cv2(_with_exif_chunk(png, tiff))
    for first in (_tiff(3), _tiff(6, magic=43), bytes(far), _tiff(0)):
        _same_as_cv2(_with_app1(_with_app1(jpeg, b"Exif\0\0" + _tiff(6)),
                                b"Exif\0\0" + first))
    _same_as_cv2(_with_app1(jpeg, b"http://ns.adobe.com/xap/1.0/\0<x/>"))


# ---- what stays refused ---------------------------------------------------

def _with_frame_marker(jpeg, marker):
    i = jpeg.index(b"\xff\xc0")
    return jpeg[:i + 1] + bytes([marker]) + jpeg[i + 2:]


@pytest.mark.parametrize("kind,match", [
    ("SOF3", "lossless"), ("SOF9", "arithmetic"), ("SOF10", "arithmetic"),
    ("SOF5", "hierarchical"), ("12-bit", "12-bit"), ("CMYK", "CMYK")])
def test_refused_jpeg_kinds_name_themselves(kind, match):
    """Lossless, arithmetic-coded, hierarchical, 12-bit and Adobe CMYK
    JPEG raise a ValueError that names the kind (ROADMAP.md, F6)."""
    jpeg = _cv2_jpeg(_textured(8, 8, seed=13), cv2.IMWRITE_JPEG_QUALITY, 90)
    if kind.startswith("SOF"):
        data = _with_frame_marker(jpeg, 0xC0 + int(kind[3:]))
    elif kind == "12-bit":
        i = jpeg.index(b"\xff\xc0")
        data = jpeg[:i + 4] + b"\x0c" + jpeg[i + 5:]
    else:
        bio = io.BytesIO()
        Image.fromarray(_textured(8, 8, seed=13)).convert("CMYK").save(
            bio, "JPEG")
        data = bio.getvalue()
    with pytest.raises(ValueError, match=match):
        images.decode_img(data)


@pytest.mark.parametrize("cut", [3, 20, 150, 400, -3])
def test_truncated_jpeg_raises_value_error(cut):
    """A JPEG cut short in its headers or its scan data raises ValueError,
    where cv2 returns nothing (and the JAX package raises too)."""
    data = _cv2_jpeg(_textured(30, 41, seed=14), cv2.IMWRITE_JPEG_QUALITY,
                     90)
    with pytest.raises(ValueError):
        jax_images.decode_img(data[:cut])
    with pytest.raises(ValueError, match="JPEG"):
        images.decode_img(data[:cut])


def test_committed_fixtures_match_their_cv2_hashes():
    """The JPEG fixtures chip_smoke.py decodes on the GPU host (which has
    no cv2): the port and cv2 both decode each to the SHA-256 that
    scripts/make_jpeg_fixtures.py recorded."""
    import hashlib
    import json
    import os

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    with open(os.path.join(root, "jpeg_fixtures.json")) as f:
        files = json.load(f)["files"]
    assert len(files) == 3
    for name, want in files.items():
        with open(os.path.join(root, name), "rb") as f:
            data = f.read()
        got = _same_as_cv2(data)
        assert list(got.shape) == want["shape"]
        assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]


# ---- corrupt input ---------------------------------------------------------

def _with_dht(jpeg, table, counts, symbols):
    """A DHT segment that redefines `table` (0x00-0x03 DC, 0x10-0x13 AC),
    put just before the first scan."""
    body = bytes([table]) + bytes(counts) + bytes(symbols)
    i = jpeg.index(b"\xff\xda")
    return (jpeg[:i] + b"\xff\xc4" + struct.pack(">H", len(body) + 2) + body
            + jpeg[i:])


@pytest.mark.parametrize("table,counts", [
    (0x10, [255] + [0] * 15), (0x10, [3] + [0] * 15),
    (0x10, [1] * 8 + [248] + [0] * 7), (0x10, [2] + [0] * 15),
    (0x11, [0, 0, 8] + [0] * 13), (0x01, [0, 5] + [0] * 14)])
def test_overfull_huffman_table_raises_as_cv2_refuses(table, counts):
    """A Huffman table with more codes of a length than the length holds
    (255 or 3 one-bit codes; 248 nine-bit codes after one of each shorter
    length, which would spill past the 512-entry lookup table; 5 two-bit
    DC codes), or whose last code is all ones (2 one-bit codes, 8
    three-bit codes), is refused before it is used, as libjpeg refuses it
    and cv2 returns nothing."""
    jpeg = _cv2_jpeg(_textured(16, 16, seed=15), cv2.IMWRITE_JPEG_QUALITY,
                     90)
    n = sum(counts)
    data = _with_dht(jpeg, table, counts, [0x41 if table >> 4 else 3] * n)
    assert cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match="corrupt Huffman table"):
        images.decode_img(data)


@pytest.mark.parametrize("table,counts", [
    (0x13, [1, 2, 4] + [0] * 13), (0x10, [0, 0, 7] + [0] * 13),
    (0x10, [0] * 8 + [255, 1] + [0] * 6), (0x00, [0] * 15 + [255])])
def test_full_huffman_table_decodes_as_cv2(table, counts):
    """Tables one code short of the refused ones (every length full but
    for the all-ones code; 255 nine-bit codes; 255 sixteen-bit DC codes)
    are taken, and the scan decodes (into garbage where the table is not
    the one it was coded with) as cv2 decodes it."""
    jpeg = _cv2_jpeg(_textured(16, 16, seed=15), cv2.IMWRITE_JPEG_QUALITY,
                     90)
    n = sum(counts)
    _same_as_cv2(_with_dht(jpeg, table, counts,
                           [(i * 7) % 12 if table >> 4 == 0 else i % 256
                            for i in range(n)]))


def test_missing_huffman_tables_are_the_standard_ones():
    """A sequential JPEG without DHT (a motion-JPEG frame) decodes with the
    tables of T.81 Annex K.3, as libjpeg-turbo installs them; a
    progressive one without them is refused, as cv2 refuses it."""
    img = _textured(24, 40, seed=16)

    def strip_dht(jpeg):
        out, p = jpeg[:2], 2
        while jpeg[p + 1] != 0xDA:
            n = struct.unpack_from(">H", jpeg, p + 2)[0]
            if jpeg[p + 1] != 0xC4:
                out += jpeg[p:p + 2 + n]
            p += 2 + n
        return out + jpeg[p:]

    _same_as_cv2(strip_dht(_cv2_jpeg(img, cv2.IMWRITE_JPEG_QUALITY, 75)))
    data = strip_dht(_cv2_jpeg(img, cv2.IMWRITE_JPEG_QUALITY, 75,
                               cv2.IMWRITE_JPEG_PROGRESSIVE, 1))
    with pytest.raises(ValueError):
        jax_images.decode_img(data)
    with pytest.raises(ValueError, match="undefined Huffman table"):
        images.decode_img(data)


def test_extreme_coefficients_decode_as_cv2():
    """Coefficients far outside what 8-bit samples give (quantisation
    divisors raised to 255 after encoding, so dequantised values leave 16
    bits): libjpeg-turbo's SIMD IDCT wraps and saturates its 16-bit lanes,
    and the port follows it, in the DC-only shortcut and the full IDCT."""
    for q, img in ((100, np.full((16, 16, 3), 255, np.uint8)),
                   (100, _textured(16, 16, seed=17)),
                   (60, _textured(16, 16, seed=18))):
        jpeg = bytearray(_cv2_jpeg(img, cv2.IMWRITE_JPEG_QUALITY, q))
        i = jpeg.index(b"\xff\xdb")
        for k in (0, 1, 2, 9, 17, 63):  # DC and some AC divisors of table 0
            jpeg[i + 5 + k] = 255
        _same_as_cv2(bytes(jpeg))


def _fuzz_script():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "fuzz_jpeg.py")
    spec = importlib.util.spec_from_file_location("fuzz_jpeg", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module, path


FUZZ, FUZZ_PATH = _fuzz_script()
SEED_JPEGS = FUZZ.seed_jpegs()


@pytest.mark.parametrize("name", list(SEED_JPEGS))
def test_mutated_jpeg_raises_or_matches_cv2(name):
    """Seeded mutations of a small JPEG (`scripts/fuzz_jpeg.py`'s: bytes
    flipped or replaced in the headers and the scan data, runs deleted,
    bytes and marker-like pairs inserted): each either decodes to exactly
    what cv2 gives, where cv2 decodes it, or raises ValueError. Nothing
    else is raised and nothing crashes."""
    rng = np.random.default_rng(list(SEED_JPEGS).index(name))
    decoded = 0
    for _ in range(300):
        data = FUZZ.mutate(SEED_JPEGS[name], rng)
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        try:
            got = images.decode_img(data, u8=True)
        except ValueError:
            continue
        assert want is not None, "decoded what cv2 refuses"
        np.testing.assert_array_equal(got, want[:, :, ::-1])
        decoded += 1
    assert decoded >= 100  # the mutations leave many files decodable


def test_decoder_stays_in_bounds_under_sanitizers():
    """`scripts/fuzz_jpeg.py --asan`: the decoder built with AddressSanitizer
    and UndefinedBehaviorSanitizer decodes 100 mutations of each seed JPEG
    and three over-full Huffman tables in each with no out-of-bounds access
    or undefined arithmetic, and no outcome other than cv2's pixels or a
    ValueError."""
    import subprocess
    import sys

    r = subprocess.run([sys.executable, FUZZ_PATH, "--asan", "--n", "100",
                        "--seed", "7"], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert "FUZZ_JPEG n=515 bad=0" in r.stdout
