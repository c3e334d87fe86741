"""The port's TIFF reader (smoe_tpu_torch/io/tiff.py) against OpenCV,
which the JAX package's reader calls: read_still equals
cv2.imread(IMREAD_UNCHANGED) and read_color equals IMREAD_COLOR, array
and dtype, over compression (none, LZW, Deflate, old Deflate, PackBits)
x predictor (1, 2, 3) x depth (1, 8, 16, 32) x samples (1-4, with
ExtraSamples) x photometric x byte order x strips / tiles x planar layout;
read_image equals smoe_tpu.io.images.read_image (or raises its class);
each refused kind raises NotImplementedError naming ROADMAP.md.  The
files come from tests/torch_still_writers.py (cv2 writes neither tiles
nor planar files nor MM order).  ~3 s alone on one worker."""

import struct

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pytest.importorskip("torch")

from smoe_tpu.io import images as jimg  # noqa: E402
from smoe_tpu_torch.io import images as timg  # noqa: E402
from smoe_tpu_torch.io.tiff import read_tiff  # noqa: E402
from tests.torch_still_writers import write_tiff  # noqa: E402

H, W = 37, 53


def samples(kind: str, seed: int = 0):
    """(stored samples, write_tiff keywords) of one kind of TIFF."""
    rng = np.random.default_rng(seed)

    def u(n, dt, hi):
        shape = (H, W) if n == 1 else (H, W, n)
        return rng.integers(0, hi, shape).astype(dt)
    # a smooth ramp, so the predictors' differences repeat under LZW
    ramp = (np.add.outer(np.arange(H), np.arange(W)) * 97).astype(np.uint16)
    table = {
        "gray8": (u(1, np.uint8, 256), {}),
        "rgb8": (u(3, np.uint8, 256), {}),
        "rgba8_unassoc": (u(4, np.uint8, 256), {"extra": [2]}),
        "rgba8_assoc": (u(4, np.uint8, 256), {"extra": [1]}),
        "graya8": (u(2, np.uint8, 256), {"extra": [2]}),
        "white8": (u(1, np.uint8, 256), {"photometric": 0}),
        "gray16": (ramp + u(1, np.uint16, 64), {}),
        "rgb16": (u(3, np.uint16, 65536), {}),
        "rgba16": (u(4, np.uint16, 65536), {"extra": [2]}),
        "graya16": (u(2, np.uint16, 65536), {"extra": [2]}),
        "white16": (u(1, np.uint16, 65536), {"photometric": 0}),
        "float32": (rng.normal(0.5, 0.4, (H, W)).astype(np.float32), {}),
        "float32_rgb": (rng.random((H, W, 3)).astype(np.float32), {}),
        "float32_rgba": (rng.random((H, W, 4)).astype(np.float32),
                         {"extra": [2]}),
        "uint32": (u(1, np.uint32, 2 ** 32), {}),
        "bilevel": (u(1, np.uint8, 2), {"bps": 1}),
        "bilevel_white": (u(1, np.uint8, 2), {"bps": 1, "photometric": 0}),
        "palette8": (u(1, np.uint8, 256), {
            "photometric": 3, "colormap": rng.integers(0, 65536, (256, 3))}),
        "palette8_8bit_map": (u(1, np.uint8, 256), {
            "photometric": 3, "colormap": rng.integers(0, 256, (256, 3))}),
        "palette4": (u(1, np.uint8, 16), {
            "bps": 4, "photometric": 3,
            "colormap": rng.integers(0, 65536, (16, 3))}),
        "palette1": (u(1, np.uint8, 2), {
            "bps": 1, "photometric": 3,
            "colormap": rng.integers(0, 65536, (2, 3))}),
    }
    return table[kind]


KINDS = ["gray8", "rgb8", "rgba8_unassoc", "rgba8_assoc", "graya8",
         "white8", "gray16", "rgb16", "rgba16", "graya16", "white16",
         "float32", "float32_rgb", "float32_rgba", "uint32", "bilevel",
         "bilevel_white", "palette8", "palette8_8bit_map", "palette4",
         "palette1"]
COMPRESSIONS = [1, 5, 8, 32946, 32773]


def held_to_cv2(path):
    """read_still == IMREAD_UNCHANGED and read_color == IMREAD_COLOR (or
    the ValueError where cv2.imread returns None)."""
    for flag, ours in ((cv2.IMREAD_UNCHANGED, timg.read_still),
                       (cv2.IMREAD_COLOR, timg.read_color)):
        want = cv2.imread(path, flag)
        if want is None:
            with pytest.raises(ValueError):
                ours(path)
            continue
        got = ours(path)
        assert got.dtype == want.dtype and got.shape == want.shape, \
            (flag, got.dtype, got.shape, want.dtype, want.shape)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("comp", COMPRESSIONS)
@pytest.mark.parametrize("kind", KINDS)
def test_kind_by_compression_matches_cv2(tmp_path, kind, comp):
    """Every kind under every compression; strips of 8 rows in II order
    or 16 x 32 tiles in MM order, alternating."""
    img, kw = samples(kind, seed=comp)
    i = KINDS.index(kind) + COMPRESSIONS.index(comp)
    layout = {"tile": (16, 32)} if i % 2 else {"rows_per_strip": 8}
    path = str(tmp_path / "x.tif")
    write_tiff(path, img, order=">" if i % 2 else "<", compression=comp,
               **layout, **kw)
    held_to_cv2(path)


@pytest.mark.parametrize("comp", [5, 8])
@pytest.mark.parametrize("kind,predictor", [
    ("gray8", 2), ("rgb8", 2), ("gray16", 2), ("rgba16", 2), ("uint32", 2),
    ("float32", 3), ("float32_rgb", 3), ("float32", 2)])
@pytest.mark.parametrize("order", ["<", ">"])
def test_predictors_match_cv2(tmp_path, kind, predictor, comp, order):
    img, kw = samples(kind, seed=predictor)
    path = str(tmp_path / "p.tif")
    write_tiff(path, img, order=order, compression=comp, predictor=predictor,
               rows_per_strip=5, **kw)
    held_to_cv2(path)


@pytest.mark.parametrize("layout", [{"rows_per_strip": 6},
                                    {"tile": (16, 16)}])
@pytest.mark.parametrize("kind", ["rgb8", "rgba8_unassoc", "graya8"])
def test_planar_separate_8bit_matches_cv2(tmp_path, kind, layout):
    img, kw = samples(kind)
    path = str(tmp_path / "s.tif")
    write_tiff(path, img, planar=2, compression=8, **layout, **kw)
    held_to_cv2(path)


@pytest.mark.parametrize("kind", ["rgb16", "rgba16", "float32_rgb"])
def test_planar_separate_wide_reads_the_samples(tmp_path, kind):
    """At 16 and 32 bits OpenCV 5.0 reads a planar-separate file's first
    plane as if interleaved, into an uncleared buffer (its result varies
    between calls); the port reads the stored samples, BGR(A) as cv2
    orders an interleaved file's."""
    img, kw = samples(kind)
    path = str(tmp_path / "s.tif")
    write_tiff(path, img, planar=2, compression=5, rows_per_strip=7, **kw)
    want = img[..., [2, 1, 0, 3][:img.shape[2]]]
    got = timg.read_still(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    inter = str(tmp_path / "i.tif")
    write_tiff(inter, img, compression=5, rows_per_strip=7, **kw)
    np.testing.assert_array_equal(cv2.imread(inter, cv2.IMREAD_UNCHANGED),
                                  want)


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "rgba8_unassoc",
                                  "gray16", "rgb16", "rgba16", "white16",
                                  "graya16", "float32", "float32_rgb",
                                  "uint32", "palette8", "bilevel"])
def test_read_image_matches_jax(tmp_path, kind):
    """read_image's array, dtype and precision, or the JAX reader's
    exception class (a 3-channel float image under use_yuv reaches
    np.iinfo(float32), a ValueError)."""
    img, kw = samples(kind)
    path = str(tmp_path / "r.tiff")
    write_tiff(path, img, compression=5, **kw)
    for use_yuv in (True, False):
        try:
            want = jimg.read_image(path, use_yuv)
        except Exception as e:     # the JAX reader's own exception
            with pytest.raises(type(e)):
                timg.read_image(path, use_yuv)
            continue
        got = timg.read_image(path, use_yuv)
        assert got[1] == want[1]
        assert got[0].dtype == want[0].dtype
        np.testing.assert_array_equal(got[0], want[0])


def _tagged(tmp_path, compression=1, bps=8, fmt=1, spp=1, photometric=1):
    """A 4 x 4 file with the given tags over 64 bytes of data."""
    path = str(tmp_path / "t.tif")
    tags = [(256, 3, 4), (257, 3, 4), (258, 3, bps), (259, 3, compression),
            (262, 3, photometric), (273, 4, 8), (277, 3, spp), (278, 3, 4),
            (279, 4, 64), (339, 3, fmt)]
    ifd = struct.pack("<H", len(tags)) + b"".join(
        struct.pack("<HHI", t, typ, 1) + struct.pack(
            "<H" if typ == 3 else "<I", v).ljust(4, b"\0")
        for t, typ, v in tags) + b"\0" * 4
    with open(path, "wb") as f:
        f.write(b"II*\0" + struct.pack("<I", 72) + bytes(64) + ifd)
    return path


@pytest.mark.parametrize("what,kw", [
    ("JPEG", {"compression": 7}), ("old-style JPEG", {"compression": 6}),
    ("CCITT", {"compression": 3, "bps": 1}), ("LZMA", {"compression": 34925}),
    ("ZSTD", {"compression": 50000}), ("WebP", {"compression": 50001}),
    ("JPEG XL", {"compression": 50002}), ("LERC", {"compression": 34887}),
    ("sample format 2", {"fmt": 2}), ("(64,) bits", {"bps": 64, "fmt": 3}),
    ("photometric interpretation 5", {"photometric": 5, "spp": 4})])
def test_refused_kinds_name_roadmap(tmp_path, what, kw):
    path = _tagged(tmp_path, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as e:
        timg.read_still(path)
    assert what in str(e.value)


def test_bigtiff_and_four_bit_gray(tmp_path):
    """BigTIFF is refused naming ROADMAP.md; 4-bit gray, which OpenCV
    refuses (imread returns None), raises the JAX reader's ValueError."""
    big = str(tmp_path / "b.tif")
    with open(big, "wb") as f:
        f.write(b"II+\0\x08\0\0\0" + bytes(16))
    with pytest.raises(NotImplementedError, match="BigTIFF.*ROADMAP.md"):
        timg.read_still(big)
    path = _tagged(tmp_path, bps=4)
    assert cv2.imread(path, cv2.IMREAD_UNCHANGED) is None
    with pytest.raises(ValueError):
        jimg.read_image(path)
    with pytest.raises(ValueError):
        timg.read_image(path)


def test_lzw_clears_and_grows_to_twelve_bits(tmp_path):
    """A strip long enough to fill the LZW table (Clear codes mid-strip,
    codes of 9-12 bits) decodes as cv2 decodes it, in either order."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 7, (120, 200)).astype(np.uint16) * 9000
    for order in "<>":
        path = str(tmp_path / f"l{order == '>'}.tif")
        write_tiff(path, img, order=order, compression=5, predictor=2)
        held_to_cv2(path)
    assert read_tiff(path).dtype == np.uint16
