"""TIFF stills in numpy, zlib and struct, read as OpenCV 5.0 reads them
through libtiff (`cv2.imread(path, IMREAD_UNCHANGED)` and
`IMREAD_COLOR`), on a machine without OpenCV.

  read_tiff(path, mode)  "unchanged": the array cv2.imread(path,
                         IMREAD_UNCHANGED) returns for the first page;
                         "color": IMREAD_COLOR's (H, W, 3) uint8 BGR

Read: classic TIFF in either byte order; strips and tiles;
PlanarConfiguration 1 and 2; compression none (1), LZW (5), Deflate (8,
32946) and PackBits (32773); Predictor 1, 2 (horizontal) and 3 (floating
point), which libtiff applies only under LZW and Deflate; BitsPerSample
1, 4 (palette), 8, 16 and 32 with SampleFormat uint or IEEE float;
Photometric MinIsWhite, MinIsBlack, RGB and Palette; 1-4 samples a pixel
with ExtraSamples.

What OpenCV returns follows two paths:
  * 8-bit output (1-, 4- and 8-bit files, palettes, two samples a pixel at
    16 bits, and every file under IMREAD_COLOR) goes through libtiff's
    TIFFReadRGBA: MinIsWhite inverted, a palette looked up (a 16-bit
    colormap to its high byte, an 8-bit one as stored), 16-bit RGB to
    (v + 128) // 257 and 16-bit gray to v >> 8, unassociated alpha
    premultiplied ((v a + 127) // 255), then OpenCV's BGRA to BGR(A) or
    to gray ((R 4899 + G 9617 + B 1868 + 8192) >> 14, 1-bit files);
  * 16- and 32-bit output takes the samples as stored (MinIsWhite not
    inverted), RGB(A) to BGR(A); 32-bit files under IMREAD_COLOR make
    cv2.imread return None, which raises ValueError here.
PlanarConfiguration 2 at 16 and 32 bits is read as stored; OpenCV 5.0
reads such a file's first plane as if interleaved, into a buffer it does
not clear, so its result differs from call to call.

Refused with NotImplementedError naming ROADMAP.md: JPEG-in-TIFF (6, 7),
CCITT (2-4), LZMA, ZSTD, WebP, JPEG XL, LERC and other compressions,
signed or 64-bit samples, BigTIFF.  Host code, not a kernel: the LZW code
loop runs serially on its string table.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from smoe_tpu_torch.io.jpeg import ROADMAP

_TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4),
          6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4),
          11: ("f", 4), 12: ("d", 8), 16: ("Q", 8)}
_COMPRESSION_NAMES = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
                      6: "old-style JPEG", 7: "JPEG", 34925: "LZMA",
                      50000: "ZSTD", 50001: "WebP", 50002: "JPEG XL",
                      52546: "JPEG XL", 34887: "LERC", 34712: "JPEG 2000"}
# OpenCV's BGRA -> gray (14-bit fixed point)
_GRAY_R, _GRAY_G, _GRAY_B = 4899, 9617, 1868


def _refuse(what: str):
    raise NotImplementedError(
        f"TIFF: {what} is not read by smoe_tpu_torch ({ROADMAP}); the port "
        "reads uncompressed, LZW, Deflate and PackBits TIFFs of 1-, 8-, "
        "16- and 32-bit unsigned or float samples")


def _ifd(buf: bytes) -> dict:
    """The first IFD's tags: tag -> tuple of values."""
    if buf[:4] in (b"II+\0", b"MM\0+"):
        _refuse("BigTIFF")
    e = {b"II": "<", b"MM": ">"}.get(buf[:2])
    if e is None or struct.unpack(e + "H", buf[2:4])[0] != 42:
        raise ValueError("not a TIFF file")
    off = struct.unpack(e + "I", buf[4:8])[0]
    n = struct.unpack(e + "H", buf[off:off + 2])[0]
    tags = {"<": e}
    for k in range(n):
        tag, typ, cnt = struct.unpack(e + "HHI",
                                      buf[off + 2 + 12 * k:off + 10 + 12 * k])
        if typ not in _TYPES:
            continue
        ch, size = _TYPES[typ]
        raw = buf[off + 10 + 12 * k:off + 14 + 12 * k]
        if size * cnt > 4:
            p = struct.unpack(e + "I", raw)[0]
            raw = buf[p:p + size * cnt]
        else:
            raw = raw[:size * cnt]
        tags[tag] = struct.unpack(e + ch * cnt, raw)
    return tags


def _lzw(data: bytes, expect: int) -> bytes:
    """TIFF LZW: MSB-first codes of 9-12 bits, the width growing one code
    early, Clear 256, EOI 257; decoding stops at EOI or `expect` bytes."""
    a = np.frombuffer(data + b"\0\0\0\0", np.uint8).astype(np.int64)
    win = ((a[:-3] << 16) | (a[1:-2] << 8) | a[2:-1]).tolist()
    nbits_total = 8 * len(data)
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    out = []
    n = 0
    pos, width, prev = 0, 9, None
    while pos + width <= nbits_total and n < expect:
        code = (win[pos >> 3] >> (24 - width - (pos & 7))) \
            & ((1 << width) - 1)
        pos += width
        if code == 256:
            del table[258:]
            width, prev = 9, None
            continue
        if code == 257:
            break
        if prev is None:
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            elif code == len(table):
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise ValueError("TIFF LZW: a code not yet in the table")
            if len(table) >= (1 << width) - 1 and width < 12:
                width += 1
        out.append(entry)
        n += len(entry)
        prev = entry
    return b"".join(out)


def _packbits(data: bytes, expect: int) -> bytes:
    """PackBits: a header byte n, then n + 1 literal bytes (n < 128) or one
    byte repeated 257 - n times (n > 128); 128 is a no-op."""
    out = bytearray()
    i = 0
    while i < len(data) and len(out) < expect:
        n = data[i]
        if n < 128:
            out += data[i + 1:i + 2 + n]
            i += 2 + n
        elif n > 128:
            out += data[i + 1:i + 2] * (257 - n)
            i += 2
        else:
            i += 1
    return bytes(out)


def _inflate(comp: int, data: bytes, expect: int) -> bytes:
    """A strip's or tile's bytes under compression 1, 5, 8 / 32946 or
    32773 (`_samples` refuses the others first)."""
    if comp == 5:
        return _lzw(data, expect)
    if comp in (8, 32946):
        return zlib.decompressobj().decompress(data)
    if comp == 32773:
        return _packbits(data, expect)
    return data


def unpack_bits(rows: np.ndarray, n: int, bits: int) -> np.ndarray:
    """(h, stride) bytes of 1-, 2- or 4-bit samples packed MSB first, each
    row padded to a byte -> the (h, n) int64 samples (PNG and TIFF)."""
    shifts = bits * np.arange(8 // bits - 1, -1, -1)
    s = (rows[..., None].astype(np.int64) >> shifts) & ((1 << bits) - 1)
    return s.reshape(rows.shape[0], -1)[:, :n]


def _block_samples(raw: bytes, rows: int, cols: int, ns: int, bps: int,
                   dt: np.dtype, predictor: int) -> np.ndarray:
    """(rows, cols, ns) samples of one decoded strip or tile, its
    predictor undone."""
    if bps < 8:
        stride = -(-cols * ns * bps // 8)
        b = np.frombuffer(raw.ljust(rows * stride, b"\0"), np.uint8,
                          rows * stride).reshape(rows, stride)
        return unpack_bits(b, cols * ns, bps).reshape(rows, cols, ns)
    size = rows * cols * ns * dt.itemsize
    buf = raw[:size].ljust(size, b"\0")
    if predictor == 3:
        by = np.frombuffer(buf, np.uint8).reshape(rows, -1)
        by = np.cumsum(by.reshape(rows, -1, ns), axis=1,
                       dtype=np.uint8).reshape(rows, dt.itemsize, cols * ns)
        be = np.ascontiguousarray(by.transpose(0, 2, 1))
        return be.view(dt.newbyteorder(">")).astype(dt.newbyteorder("="))\
            .reshape(rows, cols, ns)
    s = np.frombuffer(buf, dt).astype(dt.newbyteorder("="))
    s = s.reshape(rows, cols, ns)
    if predictor == 2:          # on the samples' bits, floats too
        u = np.dtype(f"u{dt.itemsize}")
        s = np.cumsum(s.view(u), axis=1, dtype=u).view(s.dtype)
    return s


def _samples(buf: bytes, t: dict):
    """The first page's (H, W, spp) samples and its layout facts."""
    comp = t.get(259, (1,))[0]
    if comp not in (1, 5, 8, 32946, 32773):
        _refuse(f"compression {_COMPRESSION_NAMES.get(comp, comp)}")
    if 256 not in t or 257 not in t:
        raise ValueError("TIFF: no image width or length")
    w, h = t[256][0], t[257][0]
    bps_all = t.get(258, (1,))
    bps = bps_all[0]
    spp = t.get(277, (1,))[0]
    photo = t.get(262, (None,))[0]
    planar = t.get(284, (1,))[0]
    fmt = t.get(339, (1,))[0]
    predictor = t.get(317, (1,))[0] if comp in (5, 8, 32946) else 1
    if photo not in (0, 1, 2, 3):
        _refuse(f"photometric interpretation {photo}")
    if len(set(bps_all)) != 1 or bps not in (1, 4, 8, 16, 32):
        _refuse(f"{bps_all} bits per sample")
    if fmt not in (1, 3) or (fmt == 3 and bps != 32):
        _refuse(f"sample format {fmt} at {bps} bits")
    if t.get(266, (1,))[0] != 1:
        _refuse("fill order 2")
    if not 1 <= spp <= 4 or (photo in (0, 1) and spp > 2) or (
            photo == 2 and spp < 3) or (photo == 3 and spp != 1):
        _refuse(f"{spp} samples a pixel at photometric {photo}")
    if bps == 4 and photo != 3:
        raise ValueError("TIFF: 4-bit samples outside a palette (OpenCV "
                         "refuses the file)")
    if predictor not in (1, 2, 3) or (predictor == 3 and fmt != 3):
        _refuse(f"predictor {predictor} at sample format {fmt}")
    dt = np.dtype(t["<"] + ({8: "u1", 16: "u2"}.get(bps, "u4") if fmt == 1
                            else "f4"))
    tiled = 322 in t
    if tiled:
        bw, bh = t[322][0], t[323][0]
        offs, counts = t[324], t[325]
    else:
        bw, bh = w, min(t.get(278, (h,))[0], h)
        offs, counts = t[273], t.get(279)
        if counts is None:
            counts = tuple(len(buf) - o for o in offs)
    planes = spp if planar == 2 else 1
    ns = 1 if planar == 2 else spp
    across, down = -(-w // bw), -(-h // bh)
    out = np.zeros((h, w, spp), dt.newbyteorder("=") if bps >= 8
                   else np.uint8)
    edge = []                   # the right column of partial tiles
    i = 0
    for p in range(planes):
        for by in range(down):
            for bx in range(across):
                rows = bh if tiled else min(bh, h - by * bh)
                raw = _inflate(comp, buf[offs[i]:offs[i] + counts[i]],
                               rows * (-(-bw * ns * bps // 8)))
                i += 1
                blk = _block_samples(raw, rows, bw, ns, bps, dt, predictor)
                y0, x0 = by * bh, bx * bw
                ph, pw = min(rows, h - y0), min(bw, w - x0)
                out[y0:y0 + ph, x0:x0 + pw, p:p + ns] = blk[:ph, :pw]
                if tiled and pw < bw and planes == 1:
                    edge.append((y0, x0, blk[:ph]))
    extra = t.get(338, ())
    # libtiff's TIFFRGBAImage: an RGB file with a 4th sample and no
    # ExtraSamples, or an unspecified one, holds associated alpha
    unassoc = bool(extra) and extra[0] == 2
    return out, {"bps": bps, "photo": photo, "fmt": fmt, "spp": spp,
                 "unassoc": unassoc, "cmap": t.get(320), "planar": planar,
                 "edge": edge}


def _skewed_gray(blk: np.ndarray, pw: int, bps: int) -> np.ndarray:
    """The gray samples libtiff's putagreytile (8 bits, two samples a
    pixel) and put16bitbwtile (16 bits) read from a tile that overhangs
    the image's right edge by tw - pw columns: each row advances its
    pointer by tw - pw (samples at 8 bits, bytes at 16) past its pw
    pixels, not by that many pixels, so rows after the first start early.
    At 16 bits the sample is the host's (little-endian) uint16 at the
    skewed byte offset."""
    rows, tw, spp = blk.shape
    r = np.arange(rows)[:, None]
    if bps == 8:
        idx = r * (spp * pw + tw - pw) + spp * np.arange(pw)
        return blk.reshape(-1)[idx].astype(np.int64)
    by = blk.astype("<u2").reshape(-1).view(np.uint8).astype(np.int64)
    off = r * (2 * spp * pw + tw - pw) + 2 * spp * np.arange(pw)
    return by[off] | (by[off + 1] << 8)


def _rgba8(s: np.ndarray, f: dict) -> np.ndarray:
    """libtiff's TIFFReadRGBA of the samples: (H, W, 4) RGBA uint8."""
    bps, photo = f["bps"], f["photo"]
    h, w = s.shape[:2]
    a = np.full((h, w), 255, np.int64)
    if photo == 3:
        cmap = np.asarray(f["cmap"], np.int64).reshape(3, -1).T
        if (cmap >= 256).any():         # a 16-bit colormap: its high byte
            cmap = cmap >> 8
        rgb = cmap[s[..., 0].astype(np.int64)]
    else:
        v = s.astype(np.int64)
        if photo in (0, 1) and f["planar"] == 2 and f["spp"] > 1:
            # gtStripSeparate / gtTileSeparate take gray + alpha planes
            # as R = G = B: RGB's 16-bit map, no MinIsWhite inversion
            v = np.concatenate([v[..., :1]] * 3 + [v[..., 1:2]], -1)
            photo = 2
        if photo in (0, 1):
            g = v[..., 0]
            if bps == 16 or (bps == 8 and f["spp"] == 2):
                for y0, x0, blk in f["edge"]:
                    g[y0:y0 + blk.shape[0], x0:] = _skewed_gray(
                        blk, g.shape[1] - x0, bps)
            if bps == 1:
                g = g * 255
            elif bps == 16:
                g = g >> 8
            if photo == 0:
                g = 255 - g
            rgb = np.repeat(g[..., None], 3, -1)
        else:
            rgb = v[..., :3]
            if bps == 16:
                rgb = (rgb + 128) // 257
            if v.shape[-1] == 4:
                a = v[..., 3]
                if bps == 16:
                    a = (a + 128) // 257
                if f["unassoc"]:
                    rgb = (rgb * a[..., None] + 127) // 255
    return np.concatenate([rgb, a[..., None]], -1).astype(np.uint8)


def _gray(rgba: np.ndarray) -> np.ndarray:
    """OpenCV's BGRA -> gray on libtiff's RGBA raster."""
    v = rgba.astype(np.int64)
    return ((v[..., 0] * _GRAY_R + v[..., 1] * _GRAY_G + v[..., 2] * _GRAY_B
             + 8192) >> 14).astype(np.uint8)


def read_tiff(path: str, mode: str = "unchanged") -> np.ndarray:
    """The first page of a TIFF as cv2.imread(path, IMREAD_UNCHANGED)
    ("unchanged") or IMREAD_COLOR ("color") returns it; see the module."""
    if mode not in ("unchanged", "color"):
        raise ValueError(f"mode {mode!r}")
    with open(path, "rb") as fd:
        buf = fd.read()
    s, f = _samples(buf, _ifd(buf))
    bps, photo, spp = f["bps"], f["photo"], f["spp"]
    if mode == "color":
        if bps == 32:
            raise ValueError(f"cannot read image {path}: OpenCV reads no "
                             "32-bit TIFF as 8-bit colour")
        return np.ascontiguousarray(_rgba8(s, f)[..., 2::-1])
    if bps <= 8 or photo == 3 or (bps == 16 and spp == 2):
        rgba = _rgba8(s, f)
        if bps == 1 or photo in (0, 1):
            return _gray(rgba)
        if photo == 3:
            return np.ascontiguousarray(rgba[..., 2::-1])
        return np.ascontiguousarray(rgba[..., [2, 1, 0, 3][:spp]])
    if spp == 1:
        return s[..., 0]
    if spp == 2:
        _refuse(f"two samples a pixel at {bps} bits")
    return np.ascontiguousarray(s[..., [2, 1, 0, 3][:spp]])
