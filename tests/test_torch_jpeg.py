"""The port's baseline JPEG (smoe_tpu_torch/io/jpeg.py) and still readers
against OpenCV, which the JAX package's scripts and reader call: the
encoder's bytes equal cv2.imencode's, the decoder's pixels equal
cv2.imdecode's (IMREAD_COLOR, IMREAD_GRAYSCALE, IMREAD_UNCHANGED) and
smoe_tpu.io.images.read_image's, bit for bit, at sizes 1x1 to 37x53,
qualities 2-100, 4:2:0 / 4:2:2 / 4:4:4 / gray and restart intervals;
binary PGM / PPM read as cv2.imread and the JAX reader read them."""

import os
import struct

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401

from smoe_tpu.io import images as jimg  # noqa: E402
from smoe_tpu_torch.io import images as timg  # noqa: E402
from smoe_tpu_torch.io import jpeg  # noqa: E402

SIZES = [(1, 1), (8, 8), (17, 16), (37, 53)]
QUALITIES = (2, 50, 90, 100)
FACTOR = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
          "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
          "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
MODES = (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE),
         ("unchanged", cv2.IMREAD_UNCHANGED))


def picture(h, w, seed=0):
    """Smooth colour ramps with noise: both flat and busy blocks."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h, w, 2)
    base = np.stack([0.5 + 0.4 * np.sin(5 * x + 2 * y),
                     0.5 + 0.3 * np.cos(7 * x * y),
                     0.4 + 0.3 * y], -1) * 255
    return np.clip(base + rng.normal(0, 20, base.shape), 0,
                   255).astype(np.uint8)


def cv2_file(img, q, sampling, rst=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, q]
    if sampling != "gray":
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, FACTOR[sampling]]
    if rst:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def cases(h, w, sampling):
    img = picture(h, w)
    img = img[..., 1] if sampling == "gray" else img
    for q in QUALITIES:
        for rst in (0, 2):
            yield img, q, rst


@pytest.mark.parametrize("sampling", ["420", "422", "444", "gray"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_encoder_writes_cv2_bytes(size, sampling):
    for img, q, rst in cases(*size, sampling):
        want = cv2_file(img, q, sampling, rst)
        got = jpeg.encode(img, q, "420" if sampling == "gray" else sampling,
                          rst)
        assert got == want, (q, rst)


@pytest.mark.parametrize("sampling", ["420", "422", "444", "gray"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_decoder_returns_cv2_pixels(size, sampling):
    for img, q, rst in cases(*size, sampling):
        data = cv2_file(img, q, sampling, rst)
        for mode, flag in MODES:
            want = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
            got = jpeg.decode(data, mode)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"{q} {rst} "
                                          f"{mode}")


@pytest.mark.parametrize("gray", [False, True])
def test_grace_hopper_decode_is_cv2_imread(gray):
    """matplotlib's photograph (SOF0 4:2:0, its own optimised Huffman
    tables), as the committed byte copy."""
    from smoe_tpu_torch.apps import content
    path = os.path.join(content.SAMPLE_DATA, "grace_hopper.jpg")
    flag = cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR
    np.testing.assert_array_equal(
        jpeg.read_jpeg(path, "gray" if gray else "color"),
        cv2.imread(path, flag))


@pytest.mark.parametrize("sampling", ["420", "422", "444", "gray"])
@pytest.mark.parametrize("use_yuv", [True, False])
def test_read_image_jpeg_is_jax_read_image(tmp_path, sampling, use_yuv):
    """read_image of a .jpg: the decode, the gray auto-detect and the YUV
    conversion, against the JAX reader (cv2.imread IMREAD_UNCHANGED)."""
    img = picture(23, 30, seed=3)
    img = img[..., 1] if sampling == "gray" else img
    path = str(tmp_path / "in.jpg")
    with open(path, "wb") as f:
        f.write(cv2_file(img, 75, sampling))
    got, gp, _ = timg.read_image(path, use_yuv)
    want, wp, _ = jimg.read_image(path, use_yuv)
    assert gp == wp and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_read_image_jpeg_of_gray_in_colour_auto_detects(tmp_path):
    """A colour file whose decode is gray (equal planes) reads as one
    channel, as the JAX reader's auto-detect makes it."""
    g = picture(16, 16)[..., :1].repeat(3, -1)
    path = str(tmp_path / "g.jpg")
    with open(path, "wb") as f:
        f.write(cv2_file(g, 100, "444"))
    got, _, _ = timg.read_image(path)
    want, _, _ = jimg.read_image(path)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _with_exif(data: bytes, orientation: int) -> bytes:
    """A little-endian TIFF IFD with one Orientation entry, as an APP1
    "Exif" segment right after SOI."""
    tiff = (b"II*\x00" + struct.pack("<I", 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack("<I", 0))
    app1 = b"Exif\x00\x00" + tiff
    return (data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2)
            + app1 + data[2:])


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_imread_color(tmp_path, orientation):
    """IMREAD_COLOR applies the EXIF orientation, IMREAD_UNCHANGED ignores
    it (read_image reads as the latter; anchor_jpeg's file argument as the
    former)."""
    data = _with_exif(cv2_file(picture(9, 14), 90, "420"), orientation)
    path = str(tmp_path / "o.jpg")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(timg.read_color(path),
                                  cv2.imread(path, cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(jpeg.decode(data, "unchanged"),
                                  cv2.imread(path, cv2.IMREAD_UNCHANGED))


def _retagged(data: bytes, offset_marker: bytes, new: bytes) -> bytes:
    i = data.index(offset_marker)
    return data[:i] + new + data[i + len(new):]


@pytest.mark.parametrize("kind", ["progressive", "arithmetic", "12-bit"])
def test_unported_jpeg_kinds_raise_naming_roadmap(kind):
    img = picture(16, 16)
    if kind == "progressive":                  # SOF10: arithmetic-coded
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        data = _retagged(buf.tobytes(), b"\xff\xc2", b"\xff\xca")
    elif kind == "arithmetic":                 # SOF9 in place of SOF0
        data = _retagged(cv2_file(img, 75, "420"), b"\xff\xc0", b"\xff\xc9")
    else:                                      # SOF1 with 12-bit samples
        base = cv2_file(img, 75, "420")
        i = base.index(b"\xff\xc0")
        data = base[:i] + b"\xff\xc1" + base[i + 2:i + 4] + b"\x0c" \
            + base[i + 5:]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        jpeg.decode(data)


def _pnm(path, img, maxval, comment=False):
    magic = b"P6" if img.ndim == 3 else b"P5"
    h, w = img.shape[:2]
    head = magic + b"\n" + (b"# a comment\n" if comment else b"") \
        + f"{w} {h}\n{maxval}\n".encode()
    data = img[..., ::-1] if img.ndim == 3 else img
    dt = ">u2" if maxval > 255 else np.uint8
    with open(path, "wb") as f:
        f.write(head + np.ascontiguousarray(data).astype(dt).tobytes())


@pytest.mark.parametrize("ext,maxval", [(".pgm", 255), (".pgm", 1000),
                                        (".ppm", 255), (".ppm", 65535)])
def test_binary_pnm_reads_as_cv2_and_jax(tmp_path, ext, maxval):
    rng = np.random.default_rng(maxval)
    shape = (11, 7, 3) if ext == ".ppm" else (11, 7)
    img = rng.integers(0, maxval + 1, shape).astype(
        np.uint16 if maxval > 255 else np.uint8)
    path = str(tmp_path / f"x{ext}")
    _pnm(path, img, maxval, comment=True)
    got = timg.read_pnm(path)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for use_yuv in (True, False):
        t, tp, _ = timg.read_image(path, use_yuv)
        j, jp, _ = jimg.read_image(path, use_yuv)
        assert tp == jp
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(timg.read_color(path),
                                  cv2.imread(path, cv2.IMREAD_COLOR))


def test_ascii_pnm_and_tiff_raise_naming_roadmap(tmp_path):
    """The kinds still refused beside them: a PAM (P7, an ASCII header)
    named .pgm and a JPEG-compressed TIFF."""
    path = str(tmp_path / "a.pgm")
    with open(path, "wb") as f:
        f.write(b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\1\2")
    with pytest.raises(NotImplementedError, match="PAM.*ROADMAP.md"):
        timg.read_image(path)
    tif = str(tmp_path / "scan.tiff")
    with open(tif, "wb") as f:
        f.write(b"II*\0\x08\0\0\0\x01\0" + struct.pack("<HHII", 259, 3, 1,
                                                       7) + bytes(4))
    with pytest.raises(NotImplementedError, match="JPEG.*ROADMAP.md"):
        timg.read_image(tif)


def test_quality_tables_are_libjpeg_scaling():
    """jpeg_set_quality's tables against the DQT cv2 writes at each q."""
    for q in (1, 2, 25, 50, 75, 95, 100):
        data = cv2_file(picture(8, 8), q, "444")
        i = data.index(b"\xff\xdb")
        luma = np.frombuffer(data[i + 5:i + 69], np.uint8)
        j = data.index(b"\xff\xdb", i + 2)
        chroma = np.frombuffer(data[j + 5:j + 69], np.uint8)
        lq, cq = jpeg.quality_tables(q)
        np.testing.assert_array_equal(lq[jpeg.ZIGZAG], luma)
        np.testing.assert_array_equal(cq[jpeg.ZIGZAG], chroma)


def test_fill_bytes_before_markers():
    """0xFF fill bytes before RSTn and EOI (which a decoder skips) as
    cv2.imdecode reads them."""
    data = cv2_file(picture(20, 33), 60, "420", rst=1)
    head = data.index(b"\xff\xda")
    body = data[head:]
    for m in list(range(0xD0, 0xD8)) + [0xD9]:
        body = body.replace(bytes([0xFF, m]), bytes([0xFF, 0xFF, m]))
    filled = data[:head] + body
    for mode, flag in MODES:
        np.testing.assert_array_equal(
            jpeg.decode(filled, mode),
            cv2.imdecode(np.frombuffer(filled, np.uint8), flag))
