"""Image input and output of the port (from smoe_tpu/io/images.py:24-49,
105-114 and 139-160; d == 2, PNG).

Written in numpy, zlib and struct alone, so it runs where OpenCV and PIL
are absent:
  * `read_png` decodes an 8- or 16-bit gray, gray+alpha, RGB or RGBA PNG
    (all five row filters) into what `cv2.imread(path, IMREAD_UNCHANGED)`
    returns: (H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA;
  * `bgr_to_yuv` is OpenCV's `COLOR_BGR2YUV`: the 14-bit fixed-point
    integer path on uint8 and the fused-multiply-add float path on
    float32, so `read_image` gives the JAX package's values;
  * `read_image` keeps the JAX reader's gray auto-detect, alpha drop and
    uint16 scaling;
  * `yuv_to_bgr` is OpenCV's integer `COLOR_YUV2BGR` (color_yuv: 14-bit
    fixed-point coefficients 2.032 / -0.395 / -0.581 / 1.140, round half
    up by CV_DESCALE, saturating), so the PNG matches `cv2.cvtColor`;
  * `write_png` writes an 8- or 16-bit grayscale or RGB PNG.
Other image formats, video and light fields raise NotImplementedError.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

_YUV_SHIFT = 14
# OpenCV's YUV -> RGB coefficients (R from V, G from V, G from U, B from U)
_C_RV, _C_GV, _C_GU, _C_BU = 18678, -9519, -6472, 33292
# OpenCV's RGB -> YUV coefficients, integer (x 2^14) and float
_C_BY, _C_GY, _C_RY, _C_RV_I, _C_BU_I = 1868, 9617, 4899, 14369, 8061
_F_BY, _F_GY, _F_RY, _F_RV, _F_BU = (np.float32(v) for v in
                                     (0.114, 0.587, 0.299, 0.877, 0.492))

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
    """(..., 3) BGR -> YUV of the same dtype, as cv2.cvtColor(x,
    cv2.COLOR_BGR2YUV): uint8 through the integer path (CV_DESCALE by
    2^14, saturating), float32 through the SIMD float path
    (Y = fma(R, .299, fma(B, .114, G * .587)), U = fma(B - Y, .492, .5),
    V = fma(R - Y, .877, .5))."""
    if bgr.dtype == np.uint8:
        b, g, r = (bgr[..., i].astype(np.int64) for i in range(3))
        half = 1 << (_YUV_SHIFT - 1)
        delta = 128 << _YUV_SHIFT
        y = (b * _C_BY + g * _C_GY + r * _C_RY + half) >> _YUV_SHIFT
        u = ((b - y) * _C_BU_I + delta + half) >> _YUV_SHIFT
        v = ((r - y) * _C_RV_I + delta + half) >> _YUV_SHIFT
        return np.clip(np.stack([y, u, v], -1), 0, 255).astype(np.uint8)
    if bgr.dtype != np.float32:
        raise ValueError(f"bgr_to_yuv takes uint8 or float32, got "
                         f"{bgr.dtype}")
    b, g, r = (bgr[..., i] for i in range(3))
    y = _fma32(r, _F_RY, _fma32(b, _F_BY, g * _F_GY))
    u = _fma32(b - y, _F_BU, 0.5)
    v = _fma32(r - y, _F_RV, 0.5)
    return np.stack([y, u, v], -1)


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth) of h rows
    of `stride` bytes, `bpp` bytes per pixel; returns (h, stride) uint8."""
    if len(data) < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ftype = data[pos]
        row = np.frombuffer(data, np.uint8, stride, pos + 1)
        pos += stride + 1
        if ftype == 0:
            cur = row
        elif ftype == 1:            # Sub: running sum per byte of a pixel
            cur = np.cumsum(row.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
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


def read_png(path: str) -> np.ndarray:
    """Decode a PNG as cv2.imread(path, cv2.IMREAD_UNCHANGED) does: (H, W)
    gray, (H, W, 3) BGR or (H, W, 4) BGRA (gray+alpha becomes BGRA), uint8
    or uint16.  Palette, sub-byte and interlaced PNGs raise
    NotImplementedError."""
    with open(path, "rb") as fd:
        buf = fd.read()
    if buf[:8] != _PNG_MAGIC:
        raise ValueError(f"cannot read image {path}: not a PNG")
    pos, ihdr, idat = 8, None, []
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
        elif tag == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError(f"cannot read image {path}: no IHDR or IDAT")
    w, h, depth, color, _, _, interlace = ihdr
    if color not in _PNG_CHANNELS or depth not in (8, 16) or interlace:
        raise NotImplementedError(
            f"{path}: PNG color type {color}, bit depth {depth}, interlace "
            f"{interlace}; smoe_tpu_torch reads non-interlaced 8- and 16-bit "
            "gray, gray+alpha, RGB and RGBA PNGs")
    ch = _PNG_CHANNELS[color]
    bpp = ch * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    img = (rows.view(">u2").astype(np.uint16) if depth == 16
           else rows).reshape(h, w, ch)
    if ch == 1:
        return img[..., 0]
    if ch == 2:                                 # gray+alpha -> BGRA
        return img[..., [0, 0, 0, 1]]
    return img[..., [2, 1, 0, 3][:ch]]          # RGB(A) -> BGR(A)


def read_image(path: str, use_yuv: bool = True
               ) -> Tuple[np.ndarray, int, Optional[np.ndarray]]:
    """images.py:24-49, 105-114 for PNG: (float image in [0, 1] (H, W, C),
    precision 8 or 16, affines None).  Gray auto-detect, alpha dropped,
    BGR -> YUV when use_yuv; uint16 scales by 1 / 2^16 as in JAX."""
    p = path.lower()
    if p.endswith(".png"):
        orig = read_png(path)
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
    elif p.endswith(IMG_EXT):
        raise NotImplementedError(
            f"{path}: smoe_tpu_torch reads PNG images only; convert to PNG")
    elif p.endswith(VID_EXT) or p.endswith(".npz"):
        raise NotImplementedError(
            f"{path}: video input is not ported to smoe_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 10)")
    elif p.endswith(".mat"):
        raise NotImplementedError(
            f"{path}: light-field input is not ported to smoe_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 11)")
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
    return orig, precision, None


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


def write_image(img: np.ndarray, path: str, dim_domain: int,
                yuv: bool = True, precision: int = 8) -> str:
    """Write a reconstruction (images.py:139-160, reference
    utils.py:136-162).  Returns the path actually written."""
    if dim_domain != 2:
        raise NotImplementedError(
            "smoe_tpu_torch writes images (d=2) only; video and light-field "
            "output wait for those slices (ROADMAP.md, Queue 1)")
    if precision == 8:
        out = np.uint8(np.round(img * 255))
    else:
        out = np.uint16(np.round(np.clip(img * 2 ** precision, 0,
                                         2 ** 16 - 1)))
    if out.shape[-1] == 3:
        # the codec works in BGR->YUV (images.py:42-49); a PNG holds RGB
        bgr = yuv_to_bgr(out) if yuv else out
        out = bgr[..., ::-1]
    write_png(path + ".png", out)
    return path + ".png"
