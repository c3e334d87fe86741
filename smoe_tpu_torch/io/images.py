"""Image output of the port (from smoe_tpu/io/images.py:139-160, d == 2).

Written in numpy, zlib and struct alone, so it runs where OpenCV and PIL
are absent:
  * `yuv_to_bgr` is OpenCV's integer `COLOR_YUV2BGR` (color_yuv: 14-bit
    fixed-point coefficients 2.032 / -0.395 / -0.581 / 1.140, round half
    up by CV_DESCALE, saturating), so the PNG matches `cv2.cvtColor`;
  * `write_png` writes an 8- or 16-bit grayscale or RGB PNG.
Video (.yuv) and light-field (.mat) output wait for those slices.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_YUV_SHIFT = 14
# OpenCV's YUV -> RGB coefficients (R from V, G from V, G from U, B from U)
_C_RV, _C_GV, _C_GU, _C_BU = 18678, -9519, -6472, 33292


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
