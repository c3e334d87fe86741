"""The port's still readers (smoe_tpu_torch/io/images.py, io/jpeg.py)
against OpenCV, which the JAX package's reader calls, on every kind the
JAX reader takes besides TIFF (tests/test_torch_tiff.py): read_still
equals cv2.imread(IMREAD_UNCHANGED), read_color IMREAD_COLOR, bit for bit
and dtype for dtype, over PNG colour type x depth x tRNS x Adam7 x row
filter, PNM P1-P6, progressive JPEG (complete and cut to its first scans,
which takes libjpeg-turbo's block smoothing), 4:1:1 / 4:4:0 sampling,
CMYK / YCCK, and files whose signature is not their extension's;
read_image equals smoe_tpu.io.images.read_image; each kind still refused
raises NotImplementedError naming ROADMAP.md.  ~4 s alone on one worker."""

import io
import struct

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pytest.importorskip("torch")

from smoe_tpu.io import images as jimg  # noqa: E402
from smoe_tpu_torch.io import images as timg  # noqa: E402
from smoe_tpu_torch.io import jpeg  # noqa: E402
from tests.torch_still_writers import (first_scans, scan_starts,  # noqa
                                       write_png)

H, W = 37, 53


def held_to_cv2(path):
    """read_still == IMREAD_UNCHANGED, read_color == IMREAD_COLOR."""
    for flag, ours in ((cv2.IMREAD_UNCHANGED, timg.read_still),
                       (cv2.IMREAD_COLOR, timg.read_color)):
        want = cv2.imread(path, flag)
        got = ours(path)
        assert got.dtype == want.dtype and got.shape == want.shape, \
            (flag, got.dtype, got.shape, want.dtype, want.shape)
        np.testing.assert_array_equal(got, want)


def held_to_jax(path):
    """read_image's array, dtype and precision, or the JAX reader's
    exception class, with and without use_yuv."""
    for use_yuv in (True, False):
        try:
            want = jimg.read_image(path, use_yuv)
        except Exception as e:
            with pytest.raises(type(e)):
                timg.read_image(path, use_yuv)
            continue
        got = timg.read_image(path, use_yuv)
        assert got[1] == want[1] and got[0].dtype == want[0].dtype
        np.testing.assert_array_equal(got[0], want[0])


PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
             (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8),
             (6, 16)]
# PNG allows a tRNS chunk on colour types 0, 2 and 3 only
PNG_CASES = [(c, d, t) for c, d in PNG_KINDS for t in (False, True)
             if not (t and c in (4, 6))]


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("color,depth,trns", PNG_CASES)
def test_png_kind_matches_cv2(tmp_path, color, depth, trns, interlace):
    """Colour type x bit depth x tRNS x Adam7, the five row filters in
    turn; gray and RGB take a tRNS colour of one of their pixels, a
    palette a tRNS alpha for half its entries."""
    rng = np.random.default_rng(color * 100 + depth)
    ns = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    s = rng.integers(0, 1 << depth, (H, W, ns))
    plte = t = None
    if color == 3:
        n = min(1 << depth, 200)
        s %= n
        plte = rng.integers(0, 256, (n, 3))
        t = bytes(rng.integers(0, 256, n // 2).tolist()) if trns else None
    elif trns:
        t = struct.pack(">" + "H" * ns, *(int(v) for v in s[3, 4]))
    path = str(tmp_path / "k.png")
    write_png(path, s, color, depth, interlace, plte, t,
              filters=(0, 1, 2, 3, 4))
    held_to_cv2(path)
    if depth >= 8 or color == 3:
        held_to_jax(path)


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (9, 1), (3, 5), (8, 8),
                                   (17, 9)])
def test_adam7_small_images_with_empty_passes(tmp_path, shape):
    """Images too small for some Adam7 passes (which then hold no rows,
    not even filter bytes), gray at 2 bits and RGBA at 16."""
    rng = np.random.default_rng(sum(shape))
    for color, depth, ns in ((0, 2, 1), (6, 16, 4)):
        path = str(tmp_path / f"a{color}.png")
        write_png(path, rng.integers(0, 1 << depth, shape + (ns,)), color,
                  depth, 1, filters=(4, 3, 1))
        held_to_cv2(path)


def _pnm_files():
    rng = np.random.default_rng(3)
    g8 = rng.integers(0, 256, (H, W))
    c16 = rng.integers(0, 65536, (H, W, 3))
    bits = rng.integers(0, 2, (H, W))

    def ascii_(magic, maxval, img, comments=True):
        head = f"{magic}\n# made for a test\n{W} {H}\n" \
            f"# a comment between the fields\n{maxval}\n"
        body = "\n".join(" ".join(str(int(v)) for v in row)
                         for row in img.reshape(H, -1))
        return (head if comments else f"{magic} {W} {H} {maxval} ").encode() \
            + body.encode() + b"\n"
    return {
        "P1": f"P1\n# bitmap\n{W} {H}\n".encode() + "\n".join(
            "".join(str(int(v)) for v in row) for row in bits).encode(),
        "P2_255": ascii_("P2", 255, g8),
        "P2_100": ascii_("P2", 100, np.minimum(g8, 120), comments=False),
        "P2_1000": ascii_("P2", 1000, g8 * 4),
        "P3_255": ascii_("P3", 255, c16 >> 8),
        "P3_7": ascii_("P3", 7, c16 >> 13),
        "P3_65535": ascii_("P3", 65535, c16),
        "P4": f"P4\n{W} {H}\n".encode() + np.packbits(
            bits.astype(np.uint8), axis=1).tobytes(),
        "P5_255": f"P5 {W} {H} 255\n".encode() + g8.astype(np.uint8)
        .tobytes(),
        "P5_100": f"P5\n{W} {H}\n100\n".encode() + (g8 % 101).astype(
            np.uint8).tobytes(),
        "P6_65535": f"P6\n{W} {H}\n65535\n".encode() + c16.astype(">u2")
        .tobytes(),
        "P6_1000": f"P6 {W} {H} 1000\n".encode() + (c16 % 1001).astype(">u2")
        .tobytes(),
    }


@pytest.mark.parametrize("ext", [".pgm", ".ppm"])
@pytest.mark.parametrize("kind", sorted(_pnm_files()))
def test_pnm_kind_matches_cv2_and_jax(tmp_path, kind, ext):
    """P1-P6 under either extension (cv2 decodes by signature): ASCII
    values clamped to maxval and, below 256, scaled to i * 255 // maxval;
    binary values as stored; a bitmap's 1 black."""
    path = str(tmp_path / f"x{ext}")
    with open(path, "wb") as f:
        f.write(_pnm_files()[kind])
    held_to_cv2(path)
    held_to_jax(path)


def picture(h=H, w=W):
    """Smooth colour ramps with noise (BGR)."""
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([0.5 + 0.4 * np.sin(5 * x + 2 * y),
                     0.5 + 0.3 * np.cos(7 * x * y), 0.4 + 0.3 * y], -1)
    return np.clip(base * 255 + rng.normal(0, 20, base.shape), 0,
                   255).astype(np.uint8)


FACTORS = {s: getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{s}")
           for s in ("411", "440", "420", "422", "444")}


def jpeg_bytes(img, q=90, sampling=None, progressive=False, rst=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, q]
    if sampling:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, FACTORS[sampling]]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if rst:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def jpeg_held(data):
    """decode == cv2.imdecode under IMREAD_UNCHANGED, COLOR, GRAYSCALE."""
    for mode, flag in (("unchanged", cv2.IMREAD_UNCHANGED),
                       ("color", cv2.IMREAD_COLOR),
                       ("gray", cv2.IMREAD_GRAYSCALE)):
        want = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        got = jpeg.decode(data, mode)
        assert got.shape == want.shape, (mode, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=mode)


@pytest.mark.parametrize("size", [(37, 53), (8, 8), (17, 3), (1, 1)])
@pytest.mark.parametrize("sampling", ["411", "440", "420", "422", "444",
                                      "gray"])
def test_sampling_baseline_and_progressive_match_cv2(size, sampling):
    """4:1:1 (int_upsample) and 4:4:0 (fancy h1v2) beside the baseline
    kinds, sequential and progressive, at q 50 and 95."""
    img = picture(*size)
    img = img[..., 1] if sampling == "gray" else img
    for q in (50, 95):
        for prog in (False, True):
            jpeg_held(jpeg_bytes(img, q, None if sampling == "gray"
                                 else sampling, prog))


@pytest.mark.parametrize("sampling", ["420", "444", "411", "440", "gray"])
def test_progressive_cut_after_each_scan_matches_cv2(sampling):
    """libjpeg-turbo's default progressive script cut after each of its
    scans: the first leaves only DC known (the smoothing's DC
    interpolation), later cuts leave coefficients 1-9 with bits still
    unknown (its 5 x 5 estimates, clamped below 1 << Al); a complete file
    takes no smoothing."""
    img = picture(61, 45)
    img = img[..., 2] if sampling == "gray" else img
    data = jpeg_bytes(img, 85, None if sampling == "gray" else sampling,
                      progressive=True)
    n = len(scan_starts(data))
    for k in range(1, n + 1):
        jpeg_held(first_scans(data, k))


def test_progressive_with_restart_intervals_matches_cv2():
    """EOB runs and DC predictions restart at each RSTn."""
    data = jpeg_bytes(picture(40, 90), 80, "420", progressive=True, rst=3)
    assert b"\xff\xdd" in data
    for k in (1, 3, len(scan_starts(data))):
        jpeg_held(first_scans(data, k))


def _cmyk_jpeg(adobe_transform=None):
    """PIL's CMYK JPEG (libjpeg writes an Adobe marker, transform 0); with
    `adobe_transform` the marker's byte is set (2: the same data read as
    YCCK), with -1 the marker dropped."""
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(picture()[..., ::-1]).convert("CMYK").save(
        buf, "JPEG", quality=90)
    data = buf.getvalue()
    i = data.index(b"\xff\xee")
    assert data[i + 4:i + 9] == b"Adobe" and data[i + 15] == 0
    if adobe_transform == -1:
        n = (data[i + 2] << 8) | data[i + 3]
        return data[:i] + data[i + 2 + n:]
    if adobe_transform is not None:
        data = data[:i + 15] + bytes([adobe_transform]) + data[i + 16:]
    return data


@pytest.mark.parametrize("transform", [None, 2, -1])
def test_four_component_jpeg_matches_cv2(tmp_path, transform):
    """CMYK (Adobe transform 0, or no marker) and YCCK (transform 2) to
    OpenCV's 3-channel BGR (icvCvt_CMYK2BGR) and gray."""
    data = _cmyk_jpeg(transform)
    jpeg_held(data)
    path = str(tmp_path / "c.jpg")
    with open(path, "wb") as f:
        f.write(data)
    held_to_cv2(path)
    held_to_jax(path)


def test_progressive_jpeg_through_read_image(tmp_path):
    path = str(tmp_path / "p.jpeg")
    with open(path, "wb") as f:
        f.write(first_scans(jpeg_bytes(picture(), 90, "420", True), 4))
    held_to_cv2(path)
    held_to_jax(path)


def _content(kind: str) -> bytes:
    img = picture(9, 11)
    if kind == "png":
        return cv2.imencode(".png", img)[1].tobytes()
    if kind == "jpeg":
        return jpeg_bytes(img, 90, "420", progressive=True)
    if kind == "tiff":
        return cv2.imencode(".tif", img)[1].tobytes()
    return b"P6 11 9 255\n" + img[..., ::-1].tobytes()


@pytest.mark.parametrize("ext", [".png", ".jpg", ".tif", ".ppm"])
@pytest.mark.parametrize("kind", ["png", "jpeg", "tiff", "pnm"])
def test_sniffed_decoder_matches_cv2(tmp_path, kind, ext):
    """The decoder follows the file's signature, not its extension, as
    cv2's findDecoder does (a JPEG named .png reads)."""
    path = str(tmp_path / f"s{ext}")
    with open(path, "wb") as f:
        f.write(_content(kind))
    held_to_cv2(path)
    held_to_jax(path)


@pytest.mark.parametrize("name,head", [
    ("BMP", b"BM" + bytes(60)),
    ("JPEG 2000", b"\0\0\0\x0cjP  \r\n\x87\n" + bytes(40)),
    ("WebP", b"RIFF\x20\0\0\0WEBPVP8 " + bytes(40)),
    ("PAM", b"P7\nWIDTH 1\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\0"),
    ("Radiance HDR", b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 1\n"
     + bytes(4)),
    ("PFM", b"PF\n1 1\n-1.0\n" + bytes(12))])
def test_sniffed_formats_outside_the_decoders_name_roadmap(tmp_path, name,
                                                           head):
    path = str(tmp_path / "other.png")
    with open(path, "wb") as f:
        f.write(head)
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as e:
        timg.read_still(path)
    assert name in str(e.value)


def test_unknown_signature_and_extension_raise_value_error(tmp_path):
    """No decoder takes the file: cv2.imread returns None and both readers
    raise ValueError; an extension outside IMG_EXT is JAX's ValueError."""
    path = str(tmp_path / "junk.png")
    with open(path, "wb") as f:
        f.write(b"not an image at all")
    assert cv2.imread(path) is None
    for reader in (jimg.read_image, timg.read_image):
        with pytest.raises(ValueError):
            reader(path)
    with pytest.raises(ValueError, match="Unknown data format"):
        timg.read_still(str(tmp_path / "x.bmp"))


@pytest.mark.parametrize("kind,marker", [
    ("arithmetic", b"\xff\xc9"), ("lossless", b"\xff\xc3"),
    ("progressive arithmetic", b"\xff\xca")])
def test_refused_jpeg_kinds_name_roadmap(kind, marker):
    """Neither cv2 nor PIL here writes these, so no decoder of them could
    be held to cv2: they stay refused, and say so."""
    data = jpeg_bytes(picture(16, 16), 75, "420", progressive="progr" in kind)
    sof = b"\xff\xc2" if "progr" in kind else b"\xff\xc0"
    i = data.index(sof)
    data = data[:i] + marker + data[i + 2:]
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as e:
        jpeg.decode(data)
    assert "neither cv2 nor PIL" in str(e.value)


@pytest.mark.parametrize("name,data", [
    ("t.tif", b"II*\0\x08\0\0\0\x05\0"),
    ("j.jpg", b"\xff\xd8\xff\xc0\x00"),
    ("p.png", b"\x89PNG\r\n\x1a\n\0\0\0\x0dIHDR\0\0"),
    ("n.pgm", b"P5 4 4 255\n\0")])
def test_broken_files_raise_value_error_as_jax(tmp_path, name, data):
    """A file its decoder finds broken: cv2.imread returns None, and both
    readers raise ValueError."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    assert cv2.imread(path, cv2.IMREAD_UNCHANGED) is None
    for reader in (jimg.read_image, timg.read_image):
        with pytest.raises(ValueError):
            reader(path)
