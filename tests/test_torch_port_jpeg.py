"""The port's JPEG decoder and EXIF orientation (`dehaze_tpu_torch.data.
images`) against the JAX package's `decode_img` (cv2's IMREAD_COLOR, which
is libjpeg-turbo's decode here), byte for byte: every sampling factor cv2
writes (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1), baseline, progressive and
optimised Huffman tables, restart intervals, qualities 5 to 100, sizes
that are not a multiple of the MCU, grayscale, JPEGs written by PIL, a
1200×1600 frame, Adobe CMYK and YCCK, arithmetic coding (sequential and
progressive, DAC conditioning, restarts), progressive files whose scans
leave low coefficients unrefined (libjpeg's block smoothing), files cut
short of their EOI, and the EXIF orientations 1-8 of JPEG (APP1) and PNG
(eXIf) in both byte orders, with the malformed tags that make cv2 give up
on them. Also what stays refused, each by name, and corrupt input:
libjpeg's leniencies, over-full Huffman tables, coefficients out of the
8-bit range, seeded mutations (each decodes to cv2's pixels or raises
ValueError), and the decoder under AddressSanitizer and UBSan. No JAX
compile: the JAX package's codec is cv2 itself. The arithmetic-coded
files come from `scripts/make_jpeg_fixtures.py`'s libjpeg writer (built
with cc against Pillow's bundled libjpeg-turbo)."""

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


def _same_outcome_as_cv2(data):
    """The port decodes to cv2's pixels where cv2 decodes, and raises
    ValueError where cv2 returns nothing; True where both decode."""
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if want is None:
        with pytest.raises(ValueError, match="JPEG"):
            images.decode_img(data, u8=True)
        return False
    np.testing.assert_array_equal(images.decode_img(data, u8=True),
                                  want[:, :, ::-1])
    return True


def _script(name):
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", name)
    spec = importlib.util.spec_from_file_location(name[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module, path


@pytest.fixture(scope="module")
def libjpeg(tmp_path_factory):
    """write(pixels, cs, quality, arith, progressive, restart, L, U, K, h0,
    v0): libjpeg-turbo's encoder, arithmetic coding included."""
    return _script("make_jpeg_fixtures.py")[0].libjpeg_writer(
        str(tmp_path_factory.mktemp("writer")))


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


def _ifd_entry(tag, typ, count, value, order="II"):
    return struct.pack(("<" if order == "II" else ">") + "HHII", tag, typ,
                       count, value)


# (name, the entry put before the Orientation entry, whether cv2 still
# applies the orientation). The block is 50 bytes: header 8, count 2, three
# entries, next-IFD 4.
EXIF_MALFORMED = [
    ("make-past-end", (0x010F, 2, 20, 40), False),
    ("make-ends-at-end", (0x010F, 2, 10, 40), True),
    ("model-offset-huge", (0x0110, 2, 5, 0xFFFFFFF0), False),
    ("copyright-inline", (0x8298, 2, 4, 0xFFFFFFFF), True),
    ("datetime-count-huge", (0x0132, 2, 0xFFFFFFFF, 8), False),
    ("xresolution-past-end", (0x011A, 5, 1, 43), False),
    ("yresolution-at-end", (0x011B, 5, 1, 42), True),
    ("whitepoint-past-end", (0x013E, 5, 2, 40), False),
    ("ycbcr-coefficients-past-end", (0x0211, 5, 3, 30), False),
    ("primaries-past-end", (0x013F, 5, 6, 8), False),
    ("reference-black-white-past-end", (0x0214, 5, 6, 8), False),
    ("resolution-unit-any", (0x0128, 3, 0xFFFFFFFF, 0xFFFFFFFF), True),
    ("exif-ifd-pointer-any", (0x8769, 4, 1, 0xFFFFFFFF), True),
    ("unknown-tag-any", (0x9999, 7, 0xFFFFFFFF, 0xFFFFFFFF), True)]


@pytest.mark.parametrize("container", ["jpeg", "png"])
@pytest.mark.parametrize("name,entry,kept", EXIF_MALFORMED,
                         ids=[m[0] for m in EXIF_MALFORMED])
def test_exif_malformed_tags_as_cv2(name, entry, kept, container):
    """cv2's ExifReader reads the IFD's entries in order and gives up at a
    string tag (count above 4) or a rational one whose data lies past the
    block's end, so an Orientation after it is lost; the same entry after
    the Orientation leaves it. Other tags are not read. Each case in both
    byte orders, from a JPEG's APP1 and a PNG's eXIf."""
    img = _textured(5, 9, seed=21)
    for order in ("II", "MM"):
        e = "<" if order == "II" else ">"
        orient = struct.pack(e + "HHIH2x", 0x0112, 3, 1, 6)
        pad = _ifd_entry(0x9999, 7, 1, 0, order)
        bad = _ifd_entry(*entry, order=order)
        for entries, rotated in (([bad, orient, pad], kept),
                                 ([pad, orient, bad], True)):
            tiff = _tiff(0, order, entries=entries)
            assert len(tiff) == 50
            if container == "jpeg":
                data = _with_app1(_cv2_jpeg(img, cv2.IMWRITE_JPEG_QUALITY,
                                            95), b"Exif\0\0" + tiff)
            else:
                data = _with_exif_chunk(images.encode_img(img), tiff)
            got = _same_as_cv2(data)
            assert got.shape == ((9, 5, 3) if rotated else (5, 9, 3))
            assert images.exif_orientation(tiff) == (6 if rotated else None)


# ---- CMYK, YCCK and arithmetic coding ---------------------------------------

def _pil_cmyk(img, subsampling, progressive):
    bio = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(
        bio, "JPEG", quality=90, subsampling=subsampling,
        progressive=progressive)
    return bio.getvalue()


def _adobe(jpeg, transform):
    """The JPEG with its Adobe APP14 transform byte set, or the marker
    dropped (transform None)."""
    i = jpeg.index(b"\xff\xee\x00\x0eAdobe")
    if transform is None:
        return jpeg[:i] + jpeg[i + 16:]
    return jpeg[:i + 15] + bytes([transform]) + jpeg[i + 16:]


@pytest.mark.parametrize("transform", [0, 2, 1, None],
                         ids=["cmyk", "ycck", "transform1", "no-adobe"])
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("subsampling", [0, 2], ids=["1x1", "2x2"])
def test_four_component_jpeg_matches_cv2(subsampling, progressive,
                                         transform):
    """Four-component JPEGs as libjpeg reads them for cv2, then OpenCV's
    CMYK → BGR: PIL's Adobe CMYK (transform 0, inverted), the same data
    read as YCCK (transform 2, which libjpeg converts to CMYK; an unknown
    transform 1 too), and without an Adobe marker (plain CMYK), at 1×1 and
    2×2 sampling of the first component, baseline and progressive, at
    sizes off the MCU."""
    for h, w in ((1, 1), (13, 21), (40, 56)):
        img = _textured(h, w, seed=h + w)
        _same_as_cv2(_adobe(_pil_cmyk(img, subsampling, progressive),
                            transform))


ARITH = {"default": (0, 1, 5), "L1-U5-K10": (1, 5, 10),
         "L0-U0-K1": (0, 0, 1), "L2-U9-K63": (2, 9, 63)}


@pytest.mark.parametrize("cond", list(ARITH))
@pytest.mark.parametrize("rst", [0, 2])
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["sof9", "sof10"])
def test_arithmetic_jpeg_matches_cv2(libjpeg, progressive, rst, cond):
    """Arithmetic-coded JPEG (SOF9 sequential, SOF10 progressive) with the
    DAC conditioning (DC L and U, AC K) and restart intervals, at 4:4:4,
    4:2:0 and 4:2:2, gray, YCCK, quality 10 and 95, and sizes off the MCU,
    decodes to cv2's pixels (libjpeg's jdarith.c)."""
    L, U, K = ARITH[cond]
    for h, w in ((1, 1), (17, 33), (40, 56)):
        img = _textured(h, w, seed=h * w + 1)
        for q in (10, 95):
            for h0, v0 in ((1, 1), (2, 2), (2, 1)):
                _same_as_cv2(libjpeg(img, 2, q, 1, int(progressive), rst, L,
                                     U, K, h0, v0))
        _same_as_cv2(libjpeg(img[:, :, 0], 1, 90, 1, int(progressive), rst,
                             L, U, K, 1, 1))
        cmyk = np.concatenate([img, img[:, :, :1]], axis=2)
        _same_as_cv2(libjpeg(cmyk, 5, 90, 1, int(progressive), rst, L, U, K,
                             2, 2))


def test_refused_arithmetic_kinds_as_cv2(libjpeg):
    """SOF11 (lossless) and SOF13-15 (hierarchical) stay refused as cv2
    refuses them; a DAC index above 31, a DC condition with L above U and
    an odd DAC length raise as libjpeg raises."""
    data = libjpeg(_textured(16, 16, seed=22), 2, 90, 1, 0, 0, 0, 1, 5, 1, 1)
    i = data.index(b"\xff\xc9")
    for marker in (0xCB, 0xCD, 0xCE, 0xCF):
        bad = data[:i + 1] + bytes([marker]) + data[i + 2:]
        assert not _same_outcome_as_cv2(bad)
    j = data.index(b"\xff\xcc")
    for body in (b"\x20\x05", b"\x00\x23", b"\x10\x05\x00"):
        bad = (data[:j] + b"\xff\xcc" + struct.pack(">H", len(body) + 2)
               + body + data[j:])
        assert not _same_outcome_as_cv2(bad)


# ---- progressive block smoothing --------------------------------------------

def _scan_ends(jpeg):
    return _script("make_jpeg_fixtures.py")[0]._scan_ends(jpeg)


@pytest.mark.parametrize("sampling", ["444", "420", "422", "440", "gray"])
def test_unrefined_progressive_jpeg_is_smoothed_as_cv2(sampling):
    """A progressive JPEG cut after each of its scans (an EOI put there)
    leaves some of the first 10 coefficients unrefined, and libjpeg smooths
    its blocks from their neighbours' DCs (jdcoefct.c, the 5×5 window;
    the DCs too when only DC scans came): the port gives cv2's pixels, at
    sizes with one, two and many block columns and rows. Also a last scan
    cut short mid-way, after which libjpeg smooths the rows it did not
    reach with the precisions of the scan before."""
    for h, w in ((17, 9), (9, 130), (37, 53), (120, 8), (64, 80)):
        img = _textured(h, w, seed=h + 2 * w)
        if sampling == "gray":
            jpeg = _cv2_jpeg(img[:, :, :1], cv2.IMWRITE_JPEG_QUALITY, 75,
                             cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
        else:
            jpeg = _cv2_jpeg(img, cv2.IMWRITE_JPEG_QUALITY, 75,
                             cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                             SAMPLING[sampling])
        ends = _scan_ends(jpeg)
        for k, end in enumerate(ends[:-1]):
            assert _same_outcome_as_cv2(jpeg[:end] + b"\xff\xd9")
            sos = jpeg.rindex(b"\xff\xda", 0, end)
            start = sos + 2 + struct.unpack_from(">H", jpeg, sos + 2)[0]
            mid = (start + end) // 2
            while 0xFF in jpeg[mid - 1:mid + 1]:
                mid += 1
            if mid < end:  # a scan of a few bytes may have no such cut
                assert _same_outcome_as_cv2(jpeg[:mid] + b"\xff\xd9")


# ---- a missing EOI ----------------------------------------------------------

@pytest.mark.parametrize("kind", ["baseline", "restarts", "progressive",
                                  "arithmetic", "arithmetic-progressive"])
def test_jpeg_cut_near_its_end_as_cv2(libjpeg, kind):
    """A JPEG cut at each of the last 64 bytes (and with a few bytes of
    padding after the cut): cv2's source cannot supply more data, so libjpeg
    finishes a sequential image only if its bit buffer never asks for a
    byte past the end (a progressive one never: it reads to the EOI). The
    port decodes exactly those, to cv2's pixels, and raises for the rest."""
    decoded = 0
    for seed, (h, w) in enumerate(((37, 53), (64, 80))):
        img = _textured(h, w, seed=30 + seed)
        jpeg = {"baseline": lambda: _cv2_jpeg(img, cv2.IMWRITE_JPEG_QUALITY,
                                              90),
                "restarts": lambda: _cv2_jpeg(
                    img, cv2.IMWRITE_JPEG_QUALITY, 90,
                    cv2.IMWRITE_JPEG_RST_INTERVAL, 1),
                "progressive": lambda: _cv2_jpeg(
                    img, cv2.IMWRITE_JPEG_QUALITY, 90,
                    cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
                "arithmetic": lambda: libjpeg(img, 2, 90, 1, 0, 0, 0, 1, 5,
                                              2, 2),
                "arithmetic-progressive": lambda: libjpeg(
                    img, 2, 90, 1, 1, 2, 0, 1, 5, 2, 2)}[kind]()
        for tail in (b"", b"\0" * 7, b"\0" * 9, b"\x55" * 12):
            for cut in range(len(jpeg) - 64, len(jpeg)):
                decoded += _same_outcome_as_cv2(jpeg[:cut] + tail)
    if not kind.endswith("progressive"):
        assert decoded > 0  # some cuts leave libjpeg all it asks for


# ---- libjpeg's leniencies ---------------------------------------------------

def _insert(jpeg, at_marker, segment):
    i = jpeg.index(at_marker)
    return jpeg[:i] + segment + jpeg[i:]


def _progressive_scans(jpeg):
    """Offsets of the SOS markers of a progressive JPEG."""
    ends = _scan_ends(jpeg)
    out, p = [], 0
    for end in ends:
        out.append(jpeg.rindex(b"\xff\xda", p, end))
        p = end
    return out


LENIENCIES = ["short-com", "short-app0", "short-app1", "short-app14",
              "short-app5", "short-dnl", "dac-in-huffman",
              "dc-refine-tables", "dc-first-ac-table", "ac-dc-table",
              "scan-order-ok", "scan-order-bad", "component-twice",
              "short-dqt", "short-dqt-16bit", "short-dht"]


@pytest.mark.parametrize("case", LENIENCIES)
def test_jpeg_leniencies_as_libjpeg(case):
    """Corrupt headers read as libjpeg-turbo reads them for cv2: a COM,
    APPn or DNL segment whose length is below 2 is read as empty and
    reading goes on after its length; a DAC in a Huffman-coded file is read
    and unused; table numbers above 3 are checked only where the scan reads
    the table (none in a DC refinement scan, the DC table in a DC first
    scan, the AC table in an AC scan); scan components after one that
    follows them in the frame, or named twice, are refused; a short DQT or
    DHT is refused (libjpeg-turbo 3 no longer fills a short DQT with 1s).
    Each gives cv2's outcome."""
    img = _textured(17, 33, seed=23)
    base = _cv2_jpeg(img, cv2.IMWRITE_JPEG_QUALITY, 80)
    prog = _cv2_jpeg(img, cv2.IMWRITE_JPEG_QUALITY, 80,
                     cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    decodes = True
    if case.startswith("short-") and case[6:] in ("com", "app0", "app1",
                                                   "app14", "app5", "dnl"):
        marker = {"com": 0xFE, "app0": 0xE0, "app1": 0xE1, "app14": 0xEE,
                  "app5": 0xE5, "dnl": 0xDC}[case[6:]]
        datas = [base[:2] + bytes([0xFF, marker]) + struct.pack(">H", n)
                 + base[2:] for n in (0, 1)]
    elif case == "dac-in-huffman":
        datas = [_insert(base, b"\xff\xda", b"\xff\xcc\x00\x06\x00\x21"
                         b"\x10\x07")]
    elif case in ("dc-refine-tables", "dc-first-ac-table", "ac-dc-table"):
        scans = _progressive_scans(prog)
        datas = []
        for si in scans:
            ns, ss, ah = prog[si + 4], prog[si + 5 + 2 * prog[si + 4]], \
                prog[si + 7 + 2 * prog[si + 4]] >> 4
            wanted = {"dc-refine-tables": ss == 0 and ah > 0,
                      "dc-first-ac-table": ss == 0 and ah == 0,
                      "ac-dc-table": ss > 0}[case]
            if wanted:
                t = {"dc-refine-tables": 0xFF, "dc-first-ac-table": 0x0F,
                     "ac-dc-table": 0xF0}[case]
                d = bytearray(prog)
                for j in range(ns):
                    d[si + 6 + 2 * j] = (d[si + 6 + 2 * j] & (
                        0x0F if t == 0xF0 else 0xF0) if t != 0xFF else 0) | t
                datas.append(bytes(d))
        assert datas
    elif case.startswith("scan-order") or case == "component-twice":
        sos = base.index(b"\xff\xda")
        ids = {"scan-order-ok": (1, 2, 3), "scan-order-bad": (3, 2, 1),
               "component-twice": (1, 3, 3)}[case]
        d = bytearray(base)
        for j, c in enumerate(ids):
            d[sos + 5 + 2 * j] = c
        datas = [bytes(d)]
        decodes = case == "scan-order-ok"
    else:
        decodes = False
        sof = base.index(b"\xff\xc0")
        if case == "short-dht":
            body = bytes([0x00, 1] + [0] * 15)  # one code, no symbol
            seg = b"\xff\xc4" + struct.pack(">H", len(body) + 2) + body
        else:
            pq = 0x10 if case.endswith("16bit") else 0
            body = bytes([pq]) + bytes(range(1, 1 + (20 if pq else 10)))
            seg = b"\xff\xdb" + struct.pack(">H", len(body) + 2) + body
        datas = [base[:sof] + seg + base[sof:]]
    for data in datas:
        assert _same_outcome_as_cv2(data) == decodes


# ---- what stays refused ---------------------------------------------------

def _with_frame_marker(jpeg, marker):
    i = jpeg.index(b"\xff\xc0")
    return jpeg[:i + 1] + bytes([marker]) + jpeg[i + 2:]


@pytest.mark.parametrize("kind,match", [
    ("SOF3", "lossless"), ("SOF9", None), ("SOF10", None),
    ("SOF5", "hierarchical"), ("12-bit", "12-bit"), ("CMYK", None)])
def test_refused_jpeg_kinds_name_themselves(kind, match):
    """Lossless, hierarchical and 12-bit JPEG raise a ValueError that names
    the kind, where cv2 refuses them too (ROADMAP.md, F6). Arithmetic
    coding (a baseline file relabelled SOF9 or SOF10, its Huffman data read
    as arithmetic-coded) and Adobe CMYK are no longer refused: the port
    gives cv2's outcome."""
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
    if match is None:
        _same_outcome_as_cv2(data)
        return
    assert cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR) is None
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
    assert len(files) == 10
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


FUZZ, FUZZ_PATH = _script("fuzz_jpeg.py")
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
    and UndefinedBehaviorSanitizer decodes 100 mutations of each of the 10
    seed JPEGs and three over-full Huffman tables in each with no
    out-of-bounds access or undefined arithmetic, and no outcome other than
    cv2's pixels or a ValueError."""
    import subprocess
    import sys

    r = subprocess.run([sys.executable, FUZZ_PATH, "--asan", "--n", "100",
                        "--seed", "7"], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert "FUZZ_JPEG n=1030 bad=0" in r.stdout
