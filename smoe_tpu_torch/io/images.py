"""Image, video and light-field input and output of the port (from
smoe_tpu/io/images.py:24-191; every still the JAX reader takes, `.npz`
video bundles and `.mat` light fields in, PNG, raw I420 `.yuv` video and
`.mat` light fields out).

Written in numpy, zlib and struct alone, so it runs where OpenCV and PIL
are absent.  A still's extension must be one of IMG_EXT (the JAX
reader's gate); its decoder is then chosen by the file's signature, as
cv2's findDecoder chooses it, and returns cv2.imread(path,
IMREAD_UNCHANGED)'s array:
  * `read_png`: every colour type, bit depth and Adam7 interlace, as
    libpng expands them for OpenCV: (H, W) gray (1 / 2 / 4-bit scaled to
    0..255, a tRNS colour ignored), (H, W, 3) BGR (a palette expanded),
    (H, W, 4) BGRA (gray+alpha, RGBA, RGB or palette with tRNS);
  * a JPEG through `io/jpeg.py` (sequential and progressive, any integral
    sampling, CMYK / YCCK; EXIF orientation ignored, as IMREAD_UNCHANGED
    ignores it), a TIFF through `io/tiff.py`;
  * `read_pnm`: P1-P6 (PxM's rules: ASCII samples clamped to maxval and
    scaled below 256, binary ones as stored, a bitmap's 1 black);
  * a signature outside these raises NotImplementedError naming the
    format (BMP, JPEG 2000, WebP, PAM, Radiance HDR, PFM, ...) and
    ROADMAP.md; no signature at all raises ValueError, where cv2.imread
    returns None and the JAX reader raises ValueError;
  * `bgr_to_yuv` is OpenCV's `COLOR_BGR2YUV`: the 14-bit fixed-point
    integer path on uint8 and uint16 and the float path on float32 as
    OpenCV's AVX2 build rounds it (its vector loop over a row's first W -
    W % 8 pixels, its scalar loop over the rest), so `read_image` gives
    the JAX package's values;
  * `read_image` keeps the JAX reader's gray auto-detect, alpha drop,
    uint16 scaling (precision 16) and float clipping, and raises its
    exception classes;
  * `read_color` is `cv2.imread(path, IMREAD_COLOR)`: 8-bit BGR, gray
    replicated, alpha dropped, 16-bit samples to their high byte (a TIFF
    through libtiff's RGBA path), a JPEG's EXIF orientation applied;
  * `yuv_to_bgr` is OpenCV's integer `COLOR_YUV2BGR` (color_yuv: 14-bit
    fixed-point coefficients 2.032 / -0.395 / -0.581 / 1.140, round half
    up by CV_DESCALE, saturating), so the PNG matches `cv2.cvtColor`;
  * `write_png` writes an 8- or 16-bit grayscale or RGB PNG;
  * a `.npz` bundle (`imgs` (T, H, W, C) uint8 RGB, `affines` (T, 2|3, 3))
    is a video with its per-frame global-motion matrices; its YUV is
    `bgr_to_yuv` of the flipped channels, which is cv2's `COLOR_RGB2YUV`;
  * `bgr_to_i420` is OpenCV's `COLOR_BGR2YUV_I420` (BT.601 studio range,
    20-bit fixed point, chroma taken from the top-left pixel of each 2 x 2
    cell), so a `.yuv` file holds the bytes the JAX package writes;
  * a `.mat` light field (variable `LF`, (U, V, H, W, C)) reads through
    `scipy.io.loadmat` (MATLAB v5 / v7) or, for a v7.3 (HDF5) file, through
    h5py when it imports; without h5py a v7.3 file raises the JAX
    package's ValueError naming the conversion.  `write_image` writes
    d = 4 through `scipy.io.savemat`, or as v7.3 through h5py.
cv2's video containers (`.mp4`, `.avi`, ...: the card's machine has no
OpenCV to decode them; convert to `.npz`) raise NotImplementedError
naming ROADMAP.md.
"""

from __future__ import annotations

import re
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from smoe_tpu_torch.io.jpeg import ROADMAP, read_jpeg
from smoe_tpu_torch.io.tiff import read_tiff, unpack_bits

_YUV_SHIFT = 14
# OpenCV's YUV -> RGB coefficients (R from V, G from V, G from U, B from U)
_C_RV, _C_GV, _C_GU, _C_BU = 18678, -9519, -6472, 33292
# OpenCV's RGB -> YUV coefficients, integer (x 2^14) and float
_C_BY, _C_GY, _C_RY, _C_RV_I, _C_BU_I = 1868, 9617, 4899, 14369, 8061
_F_BY, _F_GY, _F_RY, _F_RV, _F_BU = (np.float32(v) for v in
                                     (0.114, 0.587, 0.299, 0.877, 0.492))
_CV_LANES = 8               # float32 lanes of OpenCV's AVX2 colour loops

IMG_EXT = (".png", ".tif", ".tiff", ".pgm", ".ppm", ".jpg", ".jpeg")
VID_EXT = (".mp4", ".avi", ".mov", ".mkv", ".flv")
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}    # gray, RGB, gray+alpha, RGBA


def _fma32(a: np.ndarray, b: np.float32, c) -> np.ndarray:
    """float32 a * b + c with one rounding, as a fused multiply-add: the
    product of two float32 is exact in float64, so only the sum rounds
    before the cast (a second rounding that can differ from the fused one
    only on an exact float32 midpoint)."""
    return (a.astype(np.float64) * np.float64(b)
            + np.asarray(c, np.float64)).astype(np.float32)


def bgr_to_yuv(bgr: np.ndarray) -> np.ndarray:
    """(..., W, 3) BGR -> YUV of the same dtype, as cv2.cvtColor(x,
    cv2.COLOR_BGR2YUV) of each row of W pixels: uint8 and uint16 through
    the integer path (CV_DESCALE by 2^14, chroma offset half the range,
    saturating), float32 through the float path as OpenCV's AVX2 build
    runs it: its 8-lane vector loop over a row's first W - W % 8 pixels
    (Y = fma(B, .114, fma(G, .587, R * .299))) and its scalar loop over
    the rest (Y = fma(R, .299, fma(B, .114, G * .587))); then U = fma(B -
    Y, .492, .5), V = fma(R - Y, .877, .5)."""
    if bgr.dtype in (np.uint8, np.uint16):
        info = np.iinfo(bgr.dtype)
        b, g, r = (bgr[..., i].astype(np.int64) for i in range(3))
        half = 1 << (_YUV_SHIFT - 1)
        delta = ((int(info.max) + 1) // 2) << _YUV_SHIFT
        y = (b * _C_BY + g * _C_GY + r * _C_RY + half) >> _YUV_SHIFT
        u = ((b - y) * _C_BU_I + delta + half) >> _YUV_SHIFT
        v = ((r - y) * _C_RV_I + delta + half) >> _YUV_SHIFT
        return np.clip(np.stack([y, u, v], -1), 0,
                       info.max).astype(bgr.dtype)
    if bgr.dtype != np.float32:
        raise ValueError(f"bgr_to_yuv takes uint8, uint16 or float32, got "
                         f"{bgr.dtype}")
    b, g, r = (bgr[..., i] for i in range(3))
    y = _fma32(r, _F_RY, _fma32(b, _F_BY, g * _F_GY))
    lanes = bgr.shape[-2] - bgr.shape[-2] % _CV_LANES if bgr.ndim > 1 else 0
    y[..., :lanes] = _fma32(b[..., :lanes], _F_BY, _fma32(
        g[..., :lanes], _F_GY, r[..., :lanes] * _F_RY))
    u = _fma32(b - y, _F_BU, 0.5)
    v = _fma32(r - y, _F_RV, 0.5)
    return np.stack([y, u, v], -1)


def _unfilter(data: bytes, pos: int, h: int, stride: int,
              bpp: int) -> np.ndarray:
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth) of h rows
    of `stride` bytes from data[pos:], `bpp` bytes per pixel (at least 1);
    returns (h, stride) uint8."""
    if len(data) < pos + h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = data[pos]
        row = np.frombuffer(data, np.uint8, stride, pos + 1)
        pos += stride + 1
        if ftype == 0:
            cur = row
        elif ftype == 1:            # Sub: running sum per byte of a pixel
            pad = (-stride) % bpp
            cur = np.cumsum(np.concatenate([row, np.zeros(pad, np.uint8)])
                            .reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)[:stride]
        elif ftype == 2:            # Up
            cur = row + prior
        elif ftype in (3, 4):       # Average, Paeth: sequential along x
            r, p = row.tolist(), prior.tolist()
            c = [0] * stride
            for x in range(stride):
                a = c[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    c[x] = (r[x] + ((a + p[x]) >> 1)) & 255
                else:
                    b = p[x]
                    cc = p[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - cc), abs(a - cc), abs(a + b - 2 * cc)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                            else cc)
                    c[x] = (r[x] + pred) & 255
            cur = np.asarray(c, np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def _unpack(rows: np.ndarray, w: int, ns: int, depth: int) -> np.ndarray:
    """(h, stride) bytes of packed samples -> (h, w * ns) int64 samples:
    big-endian 16-bit, bytes, or 1 / 2 / 4-bit samples MSB first."""
    if depth == 16:
        return rows.view(">u2").astype(np.int64)
    if depth == 8:
        return rows.astype(np.int64)
    return unpack_bits(rows, w * ns, depth)


# Adam7's passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}


def _png_samples(raw: bytes, w: int, h: int, ns: int, depth: int,
                 interlace: int) -> np.ndarray:
    """The (h, w, ns) int64 samples of a PNG's inflated image data, its
    passes put in place when Adam7-interlaced."""
    bpp = max(1, ns * depth // 8)
    out = np.zeros((h, w, ns), np.int64)
    pos = 0
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue        # an empty pass holds no rows, not even filters
        stride = -(-pw * ns * depth // 8)
        rows = _unfilter(raw, pos, ph, stride, bpp)
        pos += ph * (stride + 1)
        out[y0::dy, x0::dx] = _unpack(rows, pw, ns, depth).reshape(ph, pw,
                                                                    ns)
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG as cv2.imread(path, cv2.IMREAD_UNCHANGED) does through
    libpng: every colour type, bit depth and Adam7 interlace.  Gray gives
    (H, W), its 1 / 2 / 4-bit samples scaled to 0..255 and a tRNS colour
    ignored; gray+alpha (H, W, 4) BGRA; RGB (H, W, 3) BGR, or BGRA when a
    tRNS colour makes that colour's alpha 0; a palette expanded to BGR, or
    BGRA with the tRNS alphas (255 past them); RGBA BGRA.  uint8, or
    uint16 at 16 bits."""
    with open(path, "rb") as fd:
        buf = fd.read()
    if buf[:8] != _PNG_MAGIC:
        raise ValueError(f"cannot read image {path}: not a PNG")
    pos, ihdr, idat, plte, trns = 8, None, [], None, None
    while pos + 8 <= len(buf):
        length, tag = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", buf[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(tag + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"cannot read image {path}: bad CRC in "
                             f"{tag.decode(errors='replace')}")
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"PLTE":
            plte = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = data
        elif tag == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError(f"cannot read image {path}: no IHDR or IDAT")
    w, h, depth, color, _, _, interlace = ihdr
    if depth not in _PNG_DEPTHS.get(color, ()) or interlace > 1 or (
            color == 3 and plte is None):
        raise ValueError(f"cannot read image {path}: PNG colour type "
                         f"{color}, bit depth {depth}, interlace "
                         f"{interlace}")
    ns = _PNG_CHANNELS.get(color, 1)
    img = _png_samples(zlib.decompress(b"".join(idat)), w, h, ns, depth,
                       interlace)
    dt = np.uint16 if depth == 16 else np.uint8
    if color == 0:
        if depth < 8:                   # png_set_expand_gray_1_2_4_to_8
            img = img * (255 // ((1 << depth) - 1))
        return img[..., 0].astype(dt)
    if color == 3:
        idx = img[..., 0]
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte)] = plte
        rgb = pal[idx]
        if trns is None:
            return np.ascontiguousarray(rgb[..., ::-1])
        alpha = np.full(256, 255, np.uint8)
        alpha[:len(trns)] = np.frombuffer(trns, np.uint8)[:256]
        return np.concatenate([rgb[..., ::-1], alpha[idx][..., None]], -1)
    if color == 2 and trns is not None and len(trns) >= 6:
        key = np.array(struct.unpack(">HHH", trns[:6]), np.int64)
        top = (1 << depth) - 1
        alpha = np.where((img == key).all(-1), 0, top)[..., None]
        return np.concatenate([img[..., ::-1], alpha], -1).astype(dt)
    img = img.astype(dt)
    if ns == 2:                                 # gray+alpha -> BGRA
        return img[..., [0, 0, 0, 1]]
    return img[..., [2, 1, 0, 3][:ns]]          # RGB(A) -> BGR(A)


def _pnm_tokens(buf: bytes, i: int, n: int):
    """n whitespace-separated integers of a PNM from byte i, '#' comments
    skipped to the line's end; (the integers, the offset after the last)."""
    out = []
    while len(out) < n:
        while i < len(buf) and buf[i:i + 1].isspace():
            i += 1
        if buf[i:i + 1] == b"#":
            j = buf.find(b"\n", i)
            i = len(buf) if j < 0 else j + 1
            continue
        j = i
        while j < len(buf) and buf[j:j + 1].isdigit():
            j += 1
        if j == i:
            raise ValueError(f"PNM: expected a number at byte {i}")
        out.append(int(buf[i:j]))
        i = j
    return out, i


def read_pnm(path: str) -> np.ndarray:
    """A PBM, PGM or PPM (P1-P6, whatever its extension) as
    cv2.imread(path, IMREAD_UNCHANGED) reads it: (H, W) gray or (H, W, 3)
    BGR, uint8 for a maxval below 256 and uint16 above.  Binary samples
    keep their stored values; ASCII ones are clamped to maxval, and at 8
    bits scaled to i * 255 // maxval; a bitmap's 0 reads 255 and its 1
    reads 0."""
    with open(path, "rb") as fd:
        buf = fd.read()
    magic = buf[:2]
    if magic not in (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6"):
        raise ValueError(f"cannot read image {path}: not a PNM")
    kind = magic[1] - ord("0")
    bitmap = kind in (1, 4)
    (w, h, *mv), i = _pnm_tokens(buf, 2, 2 if bitmap else 3)
    maxval = 1 if bitmap else mv[0]
    if not 0 < maxval < 65536:
        raise ValueError(f"cannot read image {path}: maxval {maxval}")
    ch = 3 if kind in (3, 6) else 1
    if kind == 1:               # '0' / '1' digits, whitespace optional
        digits = np.frombuffer(buf, np.uint8, offset=i)
        digits = digits[(digits == ord("0")) | (digits == ord("1"))]
        img = np.where(digits[:h * w] == ord("1"), 0, 255).astype(np.uint8)
        return img.reshape(h, w)
    i += 1                      # the one whitespace after the header
    if kind == 4:
        rows = np.frombuffer(buf, np.uint8, h * (-(-w // 8)), i)
        bits = np.unpackbits(rows.reshape(h, -1), axis=1)[:, :w]
        return np.where(bits == 1, 0, 255).astype(np.uint8)
    wide = maxval > 255
    if kind in (5, 6):
        dt = np.dtype(">u2") if wide else np.dtype(np.uint8)
        img = np.frombuffer(buf, dt, h * w * ch, i).astype(
            np.uint16 if wide else np.uint8).reshape(h, w, ch)
    else:
        body = re.sub(rb"#[^\n]*", b" ", buf[i - 1:])
        toks = body.split()
        if len(toks) < h * w * ch or (len(toks) == h * w * ch
                                      and not body[-1:].isspace()):
            # OpenCV reads each number up to the byte after it
            raise ValueError(f"cannot read image {path}: the ASCII "
                             "samples end early")
        vals = np.array(toks[:h * w * ch], np.int64)
        vals = np.minimum(vals, maxval)
        if not wide:
            vals = vals * 255 // maxval
        img = vals.astype(np.uint16 if wide else np.uint8).reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img[..., ::-1].copy()


def _sniff(head: bytes) -> str:
    """The decoder cv2's findDecoder picks by a file's first bytes: "png",
    "jpeg", "tiff" or "pnm"; another signature names its format and
    raises NotImplementedError."""
    if head[:8] == _PNG_MAGIC:
        return "png"
    if head[:2] == b"\xff\xd8":
        return "jpeg"
    if head[:4] in (b"II*\0", b"MM\0*"):
        return "tiff"
    if len(head) >= 3 and head[0:1] == b"P" and head[1:2] in b"123456" \
            and head[2:3].isspace():
        return "pnm"
    known = ((b"BM", "BMP"), (b"\0\0\0\x0cjP  \r\n\x87\n", "JPEG 2000"),
             (b"\xffO\xffQ", "JPEG 2000 codestream"), (b"P7", "PAM"),
             (b"#?RADIANCE", "Radiance HDR"), (b"#?RGBE", "Radiance HDR"),
             (b"PF", "PFM"), (b"Pf", "PFM"), (b"II+\0", "BigTIFF"),
             (b"MM\0+", "BigTIFF"), (b"GIF8", "GIF"),
             (b"\x59\xa6\x6a\x95", "Sun raster"), (b"v/1\x01", "OpenEXR"))
    name = next((n for sig, n in known if head.startswith(sig)), None)
    if name is None and head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        name = "WebP"
    if name is None:            # cv2.imread returns None, JAX raises this
        raise ValueError(f"cannot read image: no decoder for first bytes "
                         f"{head[:12]!r}")
    raise NotImplementedError(
        f"{name} (first bytes {head[:12]!r}); "
        f"smoe_tpu_torch reads PNG, JPEG, TIFF and PNM stills ({ROADMAP})")


def _decoder(path: str) -> str:
    """read_still's choice of decoder for `path`: IMG_EXT's gate, then
    the file's signature."""
    if not path.lower().endswith(IMG_EXT):
        raise ValueError(f"Unknown data format: {path}")
    try:
        with open(path, "rb") as fd:
            head = fd.read(16)
    except OSError as e:
        raise ValueError(f"cannot read image {path}") from e
    try:
        return _sniff(head)
    except (NotImplementedError, ValueError) as e:
        raise type(e)(f"{path}: {e}") from None


def _decode(path: str, mode: str) -> np.ndarray:
    """cv2.imread(path, IMREAD_UNCHANGED) ("unchanged") or IMREAD_COLOR
    ("color") through the decoder the file's signature picks; a decoder's
    error on a broken file becomes ValueError."""
    kind = _decoder(path)
    try:
        if kind == "jpeg":
            return read_jpeg(path, mode)
        if kind == "tiff":
            return read_tiff(path, mode)
        img = read_png(path) if kind == "png" else read_pnm(path)
    except (IndexError, struct.error, zlib.error) as e:
        raise ValueError(f"cannot read image {path}: {e!r}") from e
    if mode == "unchanged":
        return img
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] == 1:
        return np.repeat(img, 3, -1)
    return np.ascontiguousarray(img[..., :3])


def read_still(path: str) -> np.ndarray:
    """A still image as cv2.imread(path, IMREAD_UNCHANGED) returns it: the
    extension must be one of IMG_EXT, as the JAX reader's gate asks; the
    decoder is then chosen by the file's signature, as cv2 chooses it (a
    JPEG named .png reads as a JPEG).  A file no decoder takes, or one
    its decoder finds broken, raises ValueError, where cv2.imread returns
    None and the JAX reader raises ValueError."""
    return _decode(path, "unchanged")


def read_color(path: str) -> np.ndarray:
    """cv2.imread(path, IMREAD_COLOR): (H, W, 3) uint8 BGR.  A PNG or PNM
    replicates gray, drops alpha and keeps a 16-bit sample's high byte; a
    TIFF goes through libtiff's RGBA path (io/tiff.py); a JPEG applies its
    EXIF orientation (io/jpeg.py)."""
    return _decode(path, "color")


def read_mat(path: str) -> np.ndarray:
    """The `LF` array of a `.mat` light field (images.py:69-85): MATLAB v5 /
    v7 through scipy.io.loadmat; v7.3, an HDF5 container that loadmat
    refuses, through h5py, whose column-major axes transpose() restores to
    (U, V, H, W, C).  Without h5py a v7.3 file raises ValueError."""
    from scipy.io import loadmat
    try:
        return loadmat(path)["LF"]
    except NotImplementedError:
        try:
            import h5py
        except ImportError as e:
            raise ValueError(
                "v7.3 .mat light fields need h5py; convert with "
                "scipy.io.savemat(..., do_compression=True) first") from e
        with h5py.File(path, "r") as f:
            return np.asarray(f["LF"]).transpose()


def read_image(path: str, use_yuv: bool = True
               ) -> Tuple[np.ndarray, int, Optional[np.ndarray]]:
    """images.py:24-114: (float image in [0, 1], precision 8 or 16,
    affines or None).  A PNG, JPEG, PGM or PPM gives (H, W, C): gray
    auto-detect, alpha dropped, BGR -> YUV when use_yuv; uint16 scales by
    1 / 2^16 as in JAX.
    A `.npz` bundle gives a video (H, W, T, C) and its (T, 2|3, 3)
    affines.  A `.mat` light field gives (U, V, H, W, C) with at most three
    channels, RGB -> YUV per view when use_yuv and C = 3."""
    affines = None
    p = path.lower()
    if p.endswith(IMG_EXT):
        orig = read_still(path)
        if orig.ndim == 2:
            orig = orig[..., None]
        elif orig.shape[2] >= 3:
            orig = orig[..., :3]
            # grayscale auto-detect (reference utils.py:73-78)
            if np.array_equal(orig[..., 0], orig[..., 1]) and \
                    np.array_equal(orig[..., 0], orig[..., 2]):
                orig = orig[..., :1]
            elif use_yuv:
                if orig.dtype == np.uint8:
                    orig = bgr_to_yuv(orig)
                else:
                    # YUV conversion on uint16 via float path
                    f = orig.astype(np.float32) / np.iinfo(orig.dtype).max
                    f = bgr_to_yuv(f)
                    orig = (f * np.iinfo(orig.dtype).max).astype(orig.dtype)
    elif p.endswith(".npz"):
        # a video bundle with its per-frame affines (images.py:93-101)
        with np.load(path) as npz:
            orig = np.moveaxis(npz["imgs"], 0, -2)       # (H, W, T, C)
            affines = npz["affines"]
        if use_yuv:
            if orig.shape[-1] != 3:
                raise ValueError(f"{path}: use_yuv needs RGB frames, got "
                                 f"{orig.shape[-1]} channel(s)")
            # cv2's COLOR_RGB2YUV is COLOR_BGR2YUV of the flipped channels
            orig = bgr_to_yuv(np.ascontiguousarray(orig[..., ::-1]))
    elif p.endswith(VID_EXT):
        raise NotImplementedError(
            f"{path}: smoe_tpu_torch reads video from .npz bundles only "
            "(imgs (T, H, W, C) uint8 RGB + affines): decoding a container "
            "needs OpenCV (see ROADMAP.md, \"Blocked, not queued\"); "
            "convert it to .npz")
    elif p.endswith(".mat"):
        orig = read_mat(path)[..., 0:3]
        if use_yuv and orig.shape[-1] == 3:      # grayscale LFs skip YUV
            # per view cv2's COLOR_RGB2YUV (images.py:87-91), which is
            # COLOR_BGR2YUV of the flipped channels
            orig = bgr_to_yuv(np.ascontiguousarray(orig[..., ::-1]))
    else:
        raise ValueError(f"Unknown data format: {path}")

    if orig.dtype == np.uint8:
        orig = orig.astype(np.float32) / 255.0
        precision = 8
    elif orig.dtype == np.uint16:
        orig = orig.astype(np.float32) / 2 ** 16
        precision = 16
    else:
        orig = np.clip(orig.astype(np.float32), 0, 1)
        precision = 8
    return orig, precision, affines


def yuv_to_bgr(yuv: np.ndarray) -> np.ndarray:
    """(..., 3) uint8/uint16 YUV -> BGR of the same dtype, bit-exact to
    cv2.cvtColor(x, cv2.COLOR_YUV2BGR)."""
    info = np.iinfo(yuv.dtype)
    delta = (int(info.max) + 1) // 2
    y, u, v = (yuv[..., i].astype(np.int64) for i in range(3))
    u, v = u - delta, v - delta
    half = 1 << (_YUV_SHIFT - 1)
    b = y + ((u * _C_BU + half) >> _YUV_SHIFT)
    g = y + ((u * _C_GU + v * _C_GV + half) >> _YUV_SHIFT)
    r = y + ((v * _C_RV + half) >> _YUV_SHIFT)
    return np.clip(np.stack([b, g, r], -1), 0, info.max).astype(yuv.dtype)


# OpenCV's RGB -> YUV 4:2:0 coefficients (BT.601 studio range, x 2^20)
_I420_SHIFT = 20
_I_RY, _I_GY, _I_BY = 269484, 528482, 102760
_I_RU, _I_GU, _I_BU = -155188, -305135, 460324
_I_GV, _I_BV = -385875, -74448


def bgr_to_i420(bgr: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 BGR, H and W even -> the (H * W * 3 / 2,) bytes of
    one I420 frame (the Y plane, then U, then V at half size), bit-exact to
    cv2.cvtColor(x, cv2.COLOR_BGR2YUV_I420): chroma comes from the top-left
    pixel of each 2 x 2 cell, not from its mean."""
    h, w = bgr.shape[:2]
    if bgr.dtype != np.uint8 or h % 2 or w % 2:
        raise ValueError(f"I420 needs uint8 frames of even size, got "
                         f"{bgr.dtype} {bgr.shape}")
    b, g, r = (bgr[..., i].astype(np.int64) for i in range(3))
    half = 1 << (_I420_SHIFT - 1)
    y = (_I_RY * r + _I_GY * g + _I_BY * b + half
         + (16 << _I420_SHIFT)) >> _I420_SHIFT
    b, g, r = b[::2, ::2], g[::2, ::2], r[::2, ::2]
    bias = half + (128 << _I420_SHIFT)
    u = (_I_RU * r + _I_GU * g + _I_BU * b + bias) >> _I420_SHIFT
    v = (_I_BU * r + _I_GV * g + _I_BV * b + bias) >> _I420_SHIFT
    return np.concatenate([np.clip(p, 0, 255).astype(np.uint8).reshape(-1)
                           for p in (y, u, v)])


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W) gray or (H, W, 3) RGB uint8/uint16 array as PNG."""
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG needs uint8 or uint16, got {img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[-1] == 3:
        color = 2
    else:
        raise ValueError(f"PNG needs (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">")))
    rows = rows.reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    with open(path, "wb") as fd:
        fd.write(b"\x89PNG\r\n\x1a\n")
        fd.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                             0, 0, 0)))
        fd.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        fd.write(_chunk(b"IEND", b""))


def _write_mat_v73(path: str, lf: np.ndarray) -> None:
    """A MATLAB v7.3 (HDF5) light-field container (images.py:117-136): the
    column-major dataset with its MATLAB_class attribute and the 512-byte
    MAT userblock header, which MATLAB and `read_mat` accept."""
    import h5py
    classes = {"uint8": b"uint8", "uint16": b"uint16",
               "float32": b"single", "float64": b"double"}
    with h5py.File(path, "w", userblock_size=512) as f:
        ds = f.create_dataset("LF", data=lf.transpose())
        ds.attrs.create(
            "MATLAB_class", np.bytes_(classes.get(str(lf.dtype), b"double")))
    head = b"MATLAB 7.3 MAT-file, created by smoe_tpu"
    with open(path, "r+b") as fd:
        fd.write(head.ljust(116, b" "))
        fd.write(b"\x00" * 8)                       # subsystem data offset
        fd.write(struct.pack("<H", 0x0200))         # version
        fd.write(b"IM")                             # endian indicator


def write_image(img: np.ndarray, path: str, dim_domain: int,
                yuv: bool = True, precision: int = 8,
                mat_v73: bool = False) -> str:
    """Write a reconstruction (images.py:139-191, reference
    utils.py:136-162): a PNG for d = 2, a raw I420 `.yuv` stream for a
    video (H, W, T, C) of 8-bit precision, a `.mat` light field (U, V, H,
    W, C) for d = 4 (YUV -> RGB per view; v7.3 through h5py with mat_v73).
    Returns the path actually written."""
    if dim_domain not in (2, 3, 4):
        raise ValueError(f"unsupported dim_domain {dim_domain}")
    if precision == 8:
        out = np.uint8(np.round(img * 255))
    else:
        out = np.uint16(np.round(np.clip(img * 2 ** precision, 0,
                                         2 ** 16 - 1)))
    if dim_domain == 3:
        if precision != 8:
            raise ValueError("the .yuv writer takes 8-bit video")
        with open(path + ".yuv", "wb") as fd:
            for t in range(out.shape[2]):
                frame = out[:, :, t, :]
                if frame.shape[-1] == 1:
                    # grayscale: luma + neutral chroma (images.py:166-173)
                    neutral = np.full_like(frame, 128)
                    frame = np.concatenate([frame, neutral, neutral], -1)
                elif not yuv:
                    frame = bgr_to_yuv(np.ascontiguousarray(frame))
                fd.write(bgr_to_i420(yuv_to_bgr(frame)).tobytes())
        return path + ".yuv"
    if dim_domain == 4:
        lf = out
        if yuv and lf.shape[-1] == 3:
            # per view cv2's COLOR_YUV2RGB (images.py:182-185)
            lf = np.ascontiguousarray(yuv_to_bgr(lf)[..., ::-1])
        if mat_v73:
            _write_mat_v73(path + ".mat", lf)
        else:
            from scipy.io import savemat
            savemat(path + ".mat", {"LF": lf})
        return path + ".mat"
    if out.shape[-1] == 3:
        # the codec works in BGR->YUV (images.py:42-49); a PNG holds RGB
        bgr = yuv_to_bgr(out) if yuv else out
        out = bgr[..., ::-1]
    write_png(path + ".png", out)
    return path + ".png"
