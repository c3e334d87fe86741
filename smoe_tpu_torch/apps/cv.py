"""The OpenCV operations apps/content.py and the demos use, in numpy,
with OpenCV's own arithmetic so their images are the JAX scripts' bit for
bit (scripts/content.py, bench_video.py, bench_lf.py, demo_superres.py)
on a machine without cv2.

  resize_area(img, size)        cv2.resize(..., interpolation=INTER_AREA),
                                downsizing
  resize_cubic(img, size)       cv2.resize(..., interpolation=INTER_CUBIC)
                                in OpenCV's own resize code
  rotation_matrix(c, deg, s)    cv2.getRotationMatrix2D
  warp_affine_linear_reflect    cv2.warpAffine(flags=INTER_LINEAR,
                                borderMode=BORDER_REFLECT) on float32

An OpenCV built with Intel IPP hands a cubic resize to IPP's own code
first, except a uint8 resize by a whole factor; IPP rounds otherwise than
OpenCV (ROADMAP.md, Queue 3) and is not reproduced here.  Host-side
content code, not a kernel.
"""

from __future__ import annotations

import math

import numpy as np

_F32 = np.float32
# warpAffine's INTER_LINEAR body handles this many columns a step with
# fused multiply-adds; the columns past the last whole step take the
# scalar tail, whose coordinates round differently
_WARP_STEP = 16
# the vertical pass of the cubic resize: this many values of a row a step
# in float32 (VResizeCubicVec_32s8u: two 4-lane vectors; _32f: one), the
# rest in the scalar tail (uint8: fixed point; float32: another order)
_CUBIC_STEP = {np.uint8: 8, np.float32: 4}
_CUBIC_BITS = 11                  # INTER_RESIZE_COEF_BITS


def _area_table(ssize: int, dsize: int, scale: float):
    """cv2's computeResizeAreaTab for one axis, as a (dsize, m) table of
    source indices and float32 weights in OpenCV's order (unused slots
    weigh 0)."""
    rows = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        terms = []
        if sx1 - fsx1 > 1e-3:
            terms.append((sx1 - 1, (sx1 - fsx1) / cell))
        terms += [(sx, 1.0 / cell) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            terms.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        rows.append(terms)
    m = max(len(t) for t in rows)
    idx = np.zeros((dsize, m), np.int64)
    alpha = np.zeros((dsize, m), _F32)
    for dx, terms in enumerate(rows):
        for j, (sx, a) in enumerate(terms):
            idx[dx, j] = sx
            alpha[dx, j] = _F32(a)
    return idx, alpha


def _area_general(src, dw: int, dh: int):
    """cv2's resizeArea_: each source row summed across in float32 with the
    x table's weights, then the rows summed down with the y table's, one
    multiply and one add a term in OpenCV's order."""
    h, w = src.shape[:2]
    xi, xa = _area_table(w, dw, 1.0 / (dw / w))
    yi, ya = _area_table(h, dh, 1.0 / (dh / h))
    s = src.astype(_F32)
    buf = np.zeros((h, dw, s.shape[2]), _F32)
    for j in range(xi.shape[1]):
        buf = buf + s[:, xi[:, j]] * xa[:, j, None]
    out = np.zeros((dh, dw, s.shape[2]), _F32)
    for j in range(yi.shape[1]):
        out = out + ya[:, j, None, None] * buf[yi[:, j]]
    return out


def _area_fast(src, fx: int, fy: int):
    """cv2's resizeAreaFast_ at integer factors: uint8 sums exactly (2 x 2:
    (a + b + c + d + 2) >> 2, else the sum times a float32 1 / area,
    rounded); float32 adds the block's values in row-major order four to
    a term, or, 2 x 2 with 1 or 4 channels, as (a + b) + (c + d) on the
    row's whole 4-lane vectors."""
    h, w, cn = src.shape
    x = src.reshape(h // fy, fy, w // fx, fx, cn)
    terms = [x[:, i, :, j] for i in range(fy) for j in range(fx)]
    area = fx * fy
    if src.dtype == np.uint8:
        total = sum(t.astype(np.int32) for t in terms)
        if fx == fy == 2 and cn in (1, 3, 4):
            return ((total + 2) >> 2).astype(np.uint8)
        return np.clip(np.rint(total.astype(_F32) * _F32(1.0 / area)), 0,
                       255).astype(np.uint8)
    acc = np.zeros(terms[0].shape, _F32)
    k = 0
    while k <= area - 4:
        acc = acc + (((terms[k] + terms[k + 1]) + terms[k + 2])
                     + terms[k + 3])
        k += 4
    for t in terms[k:]:
        acc = acc + t
    out = acc * _F32(1.0 / area)
    if fx == fy == 2 and cn in (1, 4):
        lanes = out.reshape(h // 2, -1)
        vec = (((terms[0] + terms[1]) + (terms[2] + terms[3]))
               * _F32(0.25)).reshape(h // 2, -1)
        n = lanes.shape[1] // 4 * 4
        lanes[:, :n] = vec[:, :n]
    return out


def resize_area(img, size):
    """cv2.resize(img, size, interpolation=cv2.INTER_AREA) for a downsize of
    a uint8 or float32 image (h, w) or (h, w, c); size = (width, height) as
    cv2 takes it."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.float32):
        raise TypeError(f"resize_area takes uint8 or float32, not {img.dtype}")
    dw, dh = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if (dw, dh) == (w, h):
        return img.copy()
    if dw > w or dh > h:
        raise ValueError(f"resize_area downsizes, not {w}x{h} -> {dw}x{dh}: "
                         "upsize with resize_cubic, as the scripts do")
    src = img.reshape(h, w, -1)
    scale_x, scale_y = 1.0 / (dw / w), 1.0 / (dh / h)
    fx, fy = round(scale_x), round(scale_y)
    eps = np.finfo(np.float64).eps
    if abs(scale_x - fx) < eps and abs(scale_y - fy) < eps:
        out = _area_fast(src, fx, fy)
    else:
        out = _area_general(src, dw, dh)
        if img.dtype == np.uint8:
            out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.reshape((dh, dw) + img.shape[2:])


def _cubic_table(ssize: int, dsize: int):
    """One axis of cv2's INTER_CUBIC: (dsize, 4) source indices, clamped
    to the border (BORDER_REPLICATE), and float32 weights from
    interpolateCubic (A = -0.75) at half-pixel centres."""
    scale = 1.0 / (dsize / ssize)
    a, one = _F32(-0.75), _F32(1)
    idx = np.empty((dsize, 4), np.int64)
    w = np.empty((dsize, 4), _F32)
    for d in range(dsize):
        f = _F32((d + 0.5) * scale - 0.5)
        s = math.floor(f)
        x = _F32(f - _F32(s))
        c0 = ((a * (x + one) - _F32(5) * a) * (x + one) + _F32(8) * a) \
            * (x + one) - _F32(4) * a
        c1 = ((a + _F32(2)) * x - (a + _F32(3))) * x * x + one
        c2 = ((a + _F32(2)) * (one - x) - (a + _F32(3))) * (one - x) \
            * (one - x) + one
        w[d] = (c0, c1, c2, one - c0 - c1 - c2)
        idx[d] = np.clip(np.arange(s - 1, s + 3), 0, ssize - 1)
    return idx, w


def resize_cubic(img, size):
    """cv2.resize(img, size, interpolation=cv2.INTER_CUBIC) in OpenCV's own
    resize code (resizeGeneric_ with HResizeCubic / VResizeCubic) for a
    uint8 or float32 image (h, w) or (h, w, c); size = (width, height).

    uint8: weights x 2048 rounded to int16, rows summed across exactly in
    int32, then down: the first whole steps of 8 values of a row in
    float32 (S0 b0 + (S1 b1 + (S2 b2 + S3 b3)) with b = w / 2^22, rounded
    half to even), the rest as (sum + 2^21) >> 22, saturated.  float32:
    across as ((p0 + p1) + p2) + p3, down in steps of 4 as the vector's
    S0 b0 + (S1 b1 + (S2 b2 + S3 b3)), the tail left to right."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.float32):
        raise TypeError(f"resize_cubic takes uint8 or float32, not "
                        f"{img.dtype}")
    dw, dh = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    src = img.reshape(h, w, -1)
    xi, xw = _cubic_table(w, dw)
    yi, yw = _cubic_table(h, dh)
    step = _CUBIC_STEP[img.dtype.type]
    if img.dtype == np.uint8:
        xw = np.rint(xw * _F32(1 << _CUBIC_BITS)).astype(np.int64)
        yw = np.rint(yw * _F32(1 << _CUBIC_BITS)).astype(np.int64)
        s = src.astype(np.int64)
        across = sum(s[:, xi[:, j]] * xw[None, :, j, None] for j in range(4))
        rows = [across[yi[:, j]].reshape(dh, -1) for j in range(4)]
        shift = 2 * _CUBIC_BITS
        out = (sum(rows[j] * yw[:, j, None] for j in range(4))
               + (1 << (shift - 1))) >> shift
        b = [(yw[:, j, None] * _F32(2.0 ** -shift)).astype(_F32)
             for j in range(4)]
        r = [x.astype(_F32) for x in rows]
        vec = np.rint(r[0] * b[0] + (r[1] * b[1]
                                     + (r[2] * b[2] + r[3] * b[3])))
    else:
        s = src
        across = s[:, xi[:, 0]] * xw[None, :, 0, None]
        for j in range(1, 4):
            across = across + s[:, xi[:, j]] * xw[None, :, j, None]
        r = [across[yi[:, j]].reshape(dh, -1) for j in range(4)]
        b = [yw[:, j, None] for j in range(4)]
        out = r[0] * b[0] + r[1] * b[1] + r[2] * b[2] + r[3] * b[3]
        vec = r[0] * b[0] + (r[1] * b[1] + (r[2] * b[2] + r[3] * b[3]))
    n = out.shape[1] // step * step
    out[:, :n] = vec[:, :n]
    if img.dtype == np.uint8:
        out = np.clip(out, 0, 255).astype(np.uint8)
    return out.reshape((dh, dw) + img.shape[2:])


def rotation_matrix(center, angle_deg: float, scale: float):
    """cv2.getRotationMatrix2D: the (2, 3) float64 matrix turning by
    `angle_deg` (counter-clockwise) about `center` (x, y), which OpenCV
    holds as float32."""
    cx, cy = (float(_F32(v)) for v in center)
    a = angle_deg * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _fma(a, b, c):
    """float32 a * b + c rounded once.  The product of two float32 values
    is exact in float64; the float64 sum is nudged off a float32 midpoint
    toward the part it rounded away, so rounding it to float32 is the
    single rounding of the exact value."""
    a, b, c = (np.asarray(v, np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))           # s + err == p + c exactly
    lo = s.astype(_F32).astype(np.float64)
    hi = np.nextafter(lo.astype(_F32), np.where(s > lo, np.inf, -np.inf),
                      dtype=_F32).astype(np.float64)
    tie = (err != 0) & (s == (lo + hi) / 2)
    s = np.where(tie, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(_F32)


def _reflect(p, n: int):
    """BORDER_REFLECT: fedcba|abcdef|fedcba."""
    if n == 1:
        return np.zeros_like(p)
    p = np.mod(p, 2 * n)
    return np.where(p >= n, 2 * n - 1 - p, p)


def _inverse(m):
    """warpAffine's inverse of the forward matrix, in float64."""
    m = np.asarray(m, np.float64).ravel().copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def warp_affine_linear_reflect(img, m, size):
    """cv2.warpAffine(img, m, size, flags=cv2.INTER_LINEAR,
    borderMode=cv2.BORDER_REFLECT) for float32 (h, w) or (h, w, c); size =
    (width, height).  Source coordinates in float32 from the inverse
    matrix, x * m0 + (y * m1 + m2) as one fma on whole steps of columns
    and fma(x, m0, y * m1) + m2 past them; bilinear weights from the
    coordinates' fractions, lerped across then down with fmas."""
    img = np.asarray(img)
    if img.dtype != np.float32:
        raise TypeError("warp_affine_linear_reflect takes float32, not "
                        f"{img.dtype}")
    mi = _inverse(m).astype(_F32)
    dw, dh = int(size[0]), int(size[1])
    x = np.broadcast_to(np.arange(dw, dtype=_F32)[None, :], (dh, dw))
    y = np.broadcast_to(np.arange(dh, dtype=_F32)[:, None], (dh, dw))
    sx = _fma(mi[0], x, mi[1] * y + mi[2])
    sy = _fma(mi[3], x, mi[4] * y + mi[5])
    n = dw // _WARP_STEP * _WARP_STEP
    sx[:, n:] = (_fma(x, mi[0], y * mi[1]) + mi[2])[:, n:]
    sy[:, n:] = (_fma(x, mi[3], y * mi[4]) + mi[5])[:, n:]
    ix, iy = np.floor(sx), np.floor(sy)
    a = (sx - ix)[..., None]
    b = (sy - iy)[..., None]
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    h, w = img.shape[:2]
    src = img.reshape(h, w, -1)
    x0, x1 = _reflect(ix, w), _reflect(ix + 1, w)
    y0, y1 = _reflect(iy, h), _reflect(iy + 1, h)
    p00, p01, p10, p11 = src[y0, x0], src[y0, x1], src[y1, x0], src[y1, x1]
    v0 = _fma(a, p01 - p00, p00)
    v1 = _fma(a, p11 - p10, p10)
    out = _fma(b, v1 - v0, v0)
    return out.reshape((dh, dw) + img.shape[2:])
