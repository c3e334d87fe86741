"""Short writers of the still kinds that neither cv2 nor PIL writes here
(Adam7 PNGs, PNG filters at every depth, tRNS on 16-bit RGB, tiled and
planar TIFFs in either byte order with LZW / PackBits / Deflate and their
predictors), and cuts of progressive JPEGs, for the port's readers to be
held against cv2.imread on the files they write.  numpy, zlib and struct
only."""

from __future__ import annotations

import struct
import zlib

import numpy as np

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, n) sample values -> (h, stride) bytes, MSB first below 8 bits."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    s = np.concatenate([samples, np.zeros((h, (-n) % per), samples.dtype)],
                       1).reshape(h, -1, per).astype(np.int64)
    return (s << (depth * np.arange(per - 1, -1, -1))).sum(-1).astype(
        np.uint8)


def _filter_rows(rows: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """PNG filter `ftype` of (h, stride) raw bytes, bpp bytes a pixel."""
    x = rows.astype(np.int64)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    if ftype == 0:
        pred = 0
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) >> 1
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) & 255).astype(np.uint8)


def write_png(path: str, samples: np.ndarray, color: int, depth: int,
              interlace: int = 0, plte=None, trns: bytes = None,
              filters=(0,)) -> None:
    """A PNG of (h, w, channels) sample values as stored (palette indices
    for colour type 3), its rows filtered in turn by `filters`."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    raw = []
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack_rows(sub.reshape(sub.shape[0], -1), depth)
        done = {f: _filter_rows(rows, bpp, f) for f in set(filters)}
        for y in range(rows.shape[0]):
            f = filters[y % len(filters)]
            raw.append(bytes([f]) + done[f][y].tobytes())
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if plte is not None:
        out += _chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    out += _chunk(b"IDAT", zlib.compress(b"".join(raw))) + _chunk(b"IEND",
                                                                   b"")
    with open(path, "wb") as fd:
        fd.write(out)


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW of `data`: MSB-first codes, 9 to 12 bits, a Clear first
    and when the table fills, EOI last (libtiff's tif_lzw.c encoder)."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code, width):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)
            acc &= (1 << nacc) - 1

    def grow(nxt, width):
        if nxt == 4094:
            put(256, width)
            return {bytes([i]): i for i in range(256)}, 258, 9
        return None, nxt, width + (nxt > (1 << width) - 1)

    table = {bytes([i]): i for i in range(256)}
    nxt, width = 258, 9
    put(256, width)
    w = b""
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        put(table[w], width)
        table[wc] = nxt
        fresh, nxt, width = grow(nxt + 1, width)
        table = fresh or table
        w = bytes([byte])
    if w:
        put(table[w], width)
        _, nxt, width = grow(nxt + 1, width)
    put(257, width)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits: runs of three or more as (257 - n, byte), else literals."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([(257 - (j - i)) & 255, data[i]])
            i = j
        else:
            n = min(128, len(data) - i)
            out += bytes([n - 1]) + data[i:i + n]
            i += n
    return bytes(out)


def write_tiff(path: str, img: np.ndarray, order: str = "<",
               compression: int = 1, predictor: int = 1, planar: int = 1,
               tile=None, rows_per_strip=None, photometric=None, bps=None,
               sample_format=None, extra=None, colormap=None) -> None:
    """A one-page classic TIFF of (h, w) or (h, w, s) stored samples (1-
    and 4-bit: their values), strips or (th, tw) tiles, either plane
    layout, compression 1 / 5 / 8 / 32946 / 32773 with predictor 2 or 3."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, s = img.shape
    bps = bps or img.dtype.itemsize * 8
    fmt = sample_format or (3 if img.dtype.kind == "f" else 1)
    photometric = (2 if s >= 3 else 1) if photometric is None \
        else photometric

    def encode(block):
        bh, bw, sc = block.shape
        if bps < 8:
            raw = _pack_rows(block.reshape(bh, -1).astype(np.int64),
                             bps).tobytes()
        elif predictor == 3:
            by = block.astype(block.dtype.newbyteorder(">")).view(
                np.uint8).reshape(bh, bw, sc, -1)
            by = by.transpose(0, 3, 1, 2).reshape(bh, -1).astype(np.int64)
            d = by.copy()
            d[:, sc:] = by[:, sc:] - by[:, :-sc]
            raw = (d & 255).astype(np.uint8).tobytes()
        else:
            v = block
            if predictor == 2:
                u = block.view(f"u{block.dtype.itemsize}").astype(np.int64)
                d = u.copy()
                d[:, 1:] = u[:, 1:] - u[:, :-1]
                v = (d % (1 << bps)).astype(f"u{block.dtype.itemsize}")
            raw = v.astype(v.dtype.newbyteorder(order)).tobytes()
        return {1: lambda r: r, 5: lzw_encode, 8: zlib.compress,
                32946: zlib.compress, 32773: packbits}[compression](raw)

    planes = [img] if planar == 1 else [img[..., i:i + 1] for i in range(s)]
    blocks = []
    for p in planes:
        if tile:
            th, tw = tile
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    t = np.zeros((th, tw, p.shape[2]), img.dtype)
                    sub = p[y:y + th, x:x + tw]
                    t[:sub.shape[0], :sub.shape[1]] = sub
                    blocks.append(encode(t))
        else:
            rps = rows_per_strip or h
            blocks += [encode(p[y:y + rps]) for y in range(0, h, rps)]
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * s),
            259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [s]), 284: (3, [planar]), 339: (3, [fmt] * s)}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if extra is not None:
        tags[338] = (3, list(extra))
    if colormap is not None:
        tags[320] = (3, [int(v) for v in np.asarray(colormap).T.reshape(-1)])
    if tile:
        tags[322], tags[323] = (4, [tile[1]]), (4, [tile[0]])
    else:
        tags[278] = (4, [rows_per_strip or h])
    body = b"".join(blocks)
    offs = list(8 + np.cumsum([0] + [len(b) for b in blocks[:-1]]))
    tags[324 if tile else 273] = (4, [int(o) for o in offs])
    tags[325 if tile else 279] = (4, [len(b) for b in blocks])
    ifd_off = 8 + len(body) + (len(body) & 1)
    extra_off = ifd_off + 2 + 12 * len(tags) + 4
    ifd, ext = b"", b""
    for tag in sorted(tags):
        typ, vals = tags[tag]
        raw = struct.pack(order + {3: "H", 4: "I"}[typ] * len(vals), *vals)
        if len(raw) <= 4:
            ifd += struct.pack(order + "HHI", tag, typ, len(vals)) \
                + raw.ljust(4, b"\0")
        else:
            ifd += struct.pack(order + "HHII", tag, typ, len(vals),
                               extra_off + len(ext))
            ext += raw + b"\0" * (len(raw) & 1)
    head = (b"II*\0" if order == "<" else b"MM\0*") \
        + struct.pack(order + "I", ifd_off)
    with open(path, "wb") as fd:
        fd.write(head + body + b"\0" * (ifd_off - 8 - len(body))
                 + struct.pack(order + "H", len(tags)) + ifd + b"\0" * 4
                 + ext)


def scan_starts(data: bytes) -> list:
    """The byte offset of each SOS marker of a JPEG."""
    out, i = [], 2
    while i < len(data) and data[i + 1] != 0xD9:
        length = (data[i + 2] << 8) | data[i + 3]
        if data[i + 1] != 0xDA:
            i += 2 + length
            continue
        out.append(i)
        j = i + 2 + length
        while True:
            j = data.index(b"\xff", j)
            if data[j + 1] == 0 or 0xD0 <= data[j + 1] <= 0xD7:
                j += 2
                continue
            break
        i = j
    return out


def first_scans(data: bytes, n: int) -> bytes:
    """A progressive JPEG cut to its first n scans, then EOI."""
    st = scan_starts(data)
    return data[:st[n]] + b"\xff\xd9" if n < len(st) else data
