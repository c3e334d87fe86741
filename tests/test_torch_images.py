"""PyTorch port: image input (io/images.py read_png / read_image /
bgr_to_yuv, numpy + zlib only) against the JAX package's OpenCV reader
(smoe_tpu/io/images.py:24-49, 105-114) and cv2 itself.  Exact equality:
the port reproduces OpenCV's integer and float colour arithmetic."""

import struct
import zlib

import numpy as np
import pytest

pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401
cv2 = pytest.importorskip("cv2")

from smoe_tpu.io.images import read_image as jax_read_image  # noqa: E402
from smoe_tpu.io.images import write_image as jax_write_image  # noqa: E402
from smoe_tpu_torch.io import images as timg  # noqa: E402


def _smooth(h, w, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h - 1, 1)
    img = np.stack([0.5 + 0.3 * np.sin(5 * x), 0.5 + 0.3 * np.cos(4 * y),
                    0.4 + 0.2 * np.sin(3 * (x + y))], -1)
    return np.clip(img + rng.normal(0, 0.02, img.shape), 0, 1)


CASES = {
    "rgb8": lambda: np.uint8(np.round(_smooth(23, 31) * 255)),
    "rgb16": lambda: np.uint16(np.round(_smooth(17, 12, 1) * 65535)),
    "gray8": lambda: np.uint8(np.round(_smooth(20, 9, 2)[..., 0] * 255)),
    "gray16": lambda: np.uint16(np.round(_smooth(8, 8, 3)[..., 1] * 65535)),
    "gray_as_rgb8": lambda: np.repeat(
        np.uint8(np.round(_smooth(10, 14, 4)[..., :1] * 255)), 3, -1),
    "rgba8": lambda: np.concatenate(
        [np.uint8(np.round(_smooth(13, 11, 5) * 255)),
         np.full((13, 11, 1), 77, np.uint8)], -1),
    "rgba16": lambda: np.concatenate(
        [np.uint16(np.round(_smooth(6, 7, 6) * 65535)),
         np.full((6, 7, 1), 1234, np.uint16)], -1),
}


@pytest.mark.parametrize("use_yuv", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_read_image_matches_jax(tmp_path, case, use_yuv):
    path = str(tmp_path / f"{case}.png")
    assert cv2.imwrite(path, CASES[case]())
    np.testing.assert_array_equal(timg.read_png(path),
                                  cv2.imread(path, cv2.IMREAD_UNCHANGED))
    ref, prec_j, aff_j = jax_read_image(path, use_yuv=use_yuv)
    got, prec_t, aff_t = timg.read_image(path, use_yuv=use_yuv)
    assert got.dtype == ref.dtype == np.float32
    assert (prec_t, aff_t) == (prec_j, aff_j)
    np.testing.assert_array_equal(got, ref)


def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_rows(rows, bpp, types):
    """Encode byte rows (h, stride) with the given PNG filter per row, by
    the PNG specification's formulas (independent of the decoder)."""
    out = []
    prior = np.zeros(rows.shape[1], np.int64)
    for row, ft in zip(rows.astype(np.int64), types):
        f = []
        for x in range(len(row)):
            a = row[x - bpp] if x >= bpp else 0
            b = prior[x]
            c = prior[x - bpp] if x >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ft]
            f.append((row[x] - pred) % 256)
        out.append(bytes([ft]) + bytes(f))
        prior = row
    return b"".join(out)


@pytest.mark.parametrize("color,depth", [(2, 8), (6, 8), (0, 16), (2, 16),
                                         (4, 8)])
def test_hand_filtered_rows_cover_all_five_filters(tmp_path, color, depth):
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[color]
    rng = np.random.default_rng(color * 100 + depth)
    h, w = 10, 7
    dt = np.uint8 if depth == 8 else np.uint16
    img = rng.integers(0, np.iinfo(dt).max + 1, (h, w, ch)).astype(dt)
    rows = img.astype(img.dtype.newbyteorder(">")).reshape(h, -1).view(
        np.uint8)
    bpp = ch * depth // 8
    types = [0, 1, 2, 3, 4, 4, 3, 2, 1, 0]
    raw = _filter_rows(rows, bpp, types)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as fd:
        fd.write(b"\x89PNG\r\n\x1a\n")
        fd.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                             0, 0, 0)))
        z = zlib.compress(raw)
        # image data split over two IDAT chunks
        fd.write(_chunk(b"IDAT", z[:len(z) // 2]))
        fd.write(_chunk(b"IDAT", z[len(z) // 2:]))
        fd.write(_chunk(b"IEND", b""))
    got = timg.read_png(path)
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_UNCHANGED))
    order = {1: [0], 2: [0, 0, 0, 1], 3: [2, 1, 0], 4: [2, 1, 0, 3]}[ch]
    want = img[..., order]
    if ch == 1:
        want = want[..., 0]
    np.testing.assert_array_equal(got, want)


def _colours(dtype, n=1_000_000, seed=0):
    top = np.iinfo(dtype).max
    rng = np.random.default_rng(seed)
    vals = [0, 1, top // 2, top // 2 + 1, top - 1, top]
    edges = np.array([[b, g, r] for b in vals for g in vals for r in vals],
                     dtype)
    rand = rng.integers(0, top + 1, (n, 3)).astype(dtype)
    return np.concatenate([rand, edges])[:, None, :]


def test_bgr_to_yuv_uint8_is_opencv():
    bgr = _colours(np.uint8)
    np.testing.assert_array_equal(timg.bgr_to_yuv(bgr),
                                  cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV))


def test_bgr_to_yuv_float_is_opencv():
    """The float path read_image takes for 16-bit colour input."""
    bgr = _colours(np.uint16, seed=1).astype(np.float32) / 65535
    np.testing.assert_array_equal(timg.bgr_to_yuv(bgr),
                                  cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV))


def test_yuv_round_trip_through_write_image(tmp_path):
    """read_image inverts write_image to 1 LSB (the codec's own loop)."""
    img = np.uint8(np.round(_smooth(16, 16, 7) * 255))
    path = str(tmp_path / "in.png")
    cv2.imwrite(path, img)
    yuv, _, _ = timg.read_image(path)
    out = timg.write_image(yuv, str(tmp_path / "out"), 2, yuv=True)
    back = cv2.imread(out)
    assert np.abs(back.astype(int) - img.astype(int)).max() <= 2


@pytest.mark.parametrize("name,match", [
    ("clip.mp4", ".npz"), ("scan.tif", "PNG")])
def test_other_formats_raise(tmp_path, name, match):
    """A video container, and a still whose signature names a format the
    port does not decode (a BMP named .tif)."""
    path = str(tmp_path / name)
    with open(path, "wb") as fd:
        fd.write(b"BM" + bytes(64))
    with pytest.raises(NotImplementedError, match=match):
        timg.read_image(path)


def test_unsupported_png_kinds_raise(tmp_path):
    path = str(tmp_path / "pal.png")
    with open(path, "wb") as fd:
        fd.write(b"\x89PNG\r\n\x1a\n")
        fd.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, 8, 3, 0, 0,
                                             0)))
        fd.write(_chunk(b"IDAT", zlib.compress(b"\x00\x00\x00" * 2)))
        fd.write(_chunk(b"IEND", b""))
    # a palette PNG without its PLTE chunk is malformed (cv2 reads none)
    with pytest.raises(ValueError, match="colour type 3"):
        timg.read_png(path)
    bad = bytearray(open(path, "rb").read())
    bad[-5] ^= 1                                   # corrupt IEND's CRC
    bad[29] ^= 1                                   # and IHDR's
    open(path, "wb").write(bytes(bad))
    with pytest.raises(ValueError, match="CRC"):
        timg.read_png(path)


# ---------------- video: .npz bundles in, raw I420 .yuv out ----------------

@pytest.mark.parametrize("use_yuv", [True, False])
def test_npz_bundle_read_matches_jax(tmp_path, use_yuv):
    """A video bundle (frames + per-frame affines) reads to the JAX
    reader's values exactly: (H, W, T, C) float, cv2's RGB -> YUV through
    the port's BGR -> YUV on the flipped channels."""
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (4, 12, 20, 3), dtype=np.uint8)
    aff = rng.normal(size=(4, 2, 3)).astype(np.float32)
    path = str(tmp_path / "clip.npz")
    np.savez(path, imgs=imgs, affines=aff)
    ref, prec_j, aff_j = jax_read_image(path, use_yuv=use_yuv)
    got, prec_t, aff_t = timg.read_image(path, use_yuv=use_yuv)
    assert got.shape == (12, 20, 4, 3) and got.dtype == np.float32
    assert prec_t == prec_j == 8
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(aff_t, aff_j)


def test_npz_bundle_needs_rgb_for_yuv(tmp_path):
    path = str(tmp_path / "gray.npz")
    np.savez(path, imgs=np.zeros((2, 4, 4, 1), np.uint8),
             affines=np.zeros((2, 2, 3), np.float32))
    with pytest.raises(ValueError, match="RGB"):
        timg.read_image(path, use_yuv=True)
    got, _, _ = timg.read_image(path, use_yuv=False)
    assert got.shape == (4, 4, 2, 1)


@pytest.mark.parametrize("shape", [(8, 8), (12, 20), (6, 10)])
def test_bgr_to_i420_is_cv2_s(shape):
    bgr = np.random.default_rng(sum(shape)).integers(
        0, 256, shape + (3,), dtype=np.uint8)
    np.testing.assert_array_equal(
        timg.bgr_to_i420(bgr),
        cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV_I420).reshape(-1))
    with pytest.raises(ValueError, match="even"):
        timg.bgr_to_i420(bgr[:-1])


@pytest.mark.parametrize("c,yuv", [(3, True), (3, False), (1, True)])
def test_yuv_video_bytes_match_jax(tmp_path, c, yuv):
    """write_image(dim_domain=3): the raw I420 stream equals the JAX
    writer's byte for byte, colour (YUV or BGR model) and grayscale
    (neutral chroma), H * W * 3 / 2 bytes a frame."""
    vid = np.random.default_rng(3).uniform(0, 1, (12, 20, 4, 3)) \
        .astype(np.float32)[..., :c]
    pa = jax_write_image(vid, str(tmp_path / "a"), 3, yuv=yuv)
    pb = timg.write_image(vid, str(tmp_path / "b"), 3, yuv=yuv)
    assert pb.endswith(".yuv")
    with open(pa, "rb") as fa, open(pb, "rb") as fb:
        a, b = fa.read(), fb.read()
    assert len(b) == 12 * 20 * 3 // 2 * 4
    assert a == b
