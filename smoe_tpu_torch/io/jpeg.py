"""JPEG in numpy, with libjpeg-turbo's integer arithmetic, so a
file decodes to `cv2.imdecode`'s pixels and `encode` writes
`cv2.imencode('.jpg', img, [IMWRITE_JPEG_QUALITY, q])`'s bytes, bit for bit
(OpenCV on libjpeg-turbo 3.1, its defaults: islow DCT, fancy upsampling,
the standard Huffman tables), on a machine without OpenCV.

  decode(data, mode)   "color": (H, W, 3) BGR, as IMREAD_COLOR (a gray file
                       replicated, EXIF orientation applied);
                       "gray": (H, W), as IMREAD_GRAYSCALE (a colour
                       file's Y plane, not cvtColor of its BGR);
                       "unchanged": (H, W) or (H, W, 3) BGR, as
                       IMREAD_UNCHANGED (EXIF orientation ignored)
  encode(img, quality, sampling, restart_interval)
                       (H, W) gray or (H, W, 3) BGR uint8 -> the JFIF
                       file's bytes

The decoder takes what OpenCV's libjpeg-turbo 3.1 decodes here:
sequential (SOF0 / SOF1) and progressive (SOF2: spectral selection,
successive approximation, EOB runs) Huffman files of 8-bit samples, 1, 3
(YCbCr, or RGB by the Adobe marker or component ids) or 4 components
(CMYK, or YCCK by the Adobe marker, turned into BGR by OpenCV's
icvCvt_CMYK2BGR), any integral sampling factors, any DHT / DQT, restart
markers; APPn and COM are skipped.  A progressive file whose
coefficients 1-9 are not all complete takes jdcoefct.c's block smoothing
(`_smooth_blocks`: each still-zero coefficient estimated from a 5 x 5
neighbourhood of DC values, and the DC itself when only DC is known).
Arithmetic coding, lossless (SOF3) and 12-bit samples raise
NotImplementedError naming ROADMAP.md: neither cv2 nor PIL here writes
such a file, so no decoder of them could be held to cv2.  The
arithmetic follows libjpeg-turbo's C sources: jfdctint.c / jidctint.c
(islow, CONST_BITS 13, PASS1_BITS 2, the IDCT's range-limit table),
jcdctmgr.c's reciprocal quantizer, jccolor.c / jdcolor.c (16-bit fixed
point), jcsample.c (h2v1 / h2v2 with alternating bias), jdsample.c
(fancy h2v1 / h2v2, box below three chroma columns, fancy h1v2,
int_upsample for other factors such as 4:1:1), jdphuff.c and
jdcoefct.c.  The DCT, colour, resampling, smoothing and the encoder's
entropy coding run vectorised; the decoder's symbol loops (sequential and
progressive) run serially on lookup tables.  Host code, not a kernel.
"""

from __future__ import annotations

import functools
import struct

import numpy as np

ROADMAP = "ROADMAP.md, \"Blocked, not queued\""

# jpeg_natural_order: the natural (row-major) index of each zigzag position
ZIGZAG = np.array(
    [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
     40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50,
     43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46,
     53, 60, 61, 54, 47, 55, 62, 63], np.int64)

# jcparam.c: the JPEG standard's example tables (Annex K.1), natural order
STD_LUMA_Q = np.array(
    [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
STD_CHROMA_Q = np.full(64, 99, np.int64)
STD_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = \
    [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# jstdhuff.c: the standard Huffman tables (Annex K.3), as DHT payloads
# (class / id byte, 16 code-length counts, the symbols)
STD_DHT = [bytes.fromhex(h) for h in (
    "0000010501010101010100000000000000000102030405060708090a0b",
    "100002010303020403050504040000017d01020300041105122131410613"
    "516107227114328191a1082342b1c11552d1f02433627282090a16171819"
    "1a25262728292a3435363738393a434445464748494a535455565758595a"
    "636465666768696a737475767778797a838485868788898a929394959697"
    "98999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9ca"
    "d2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa",
    "0100030101010101010101010000000000000102030405060708090a0b",
    "110002010204040304070504040001027700010203110405213106124151"
    "0761711322328108144291a1b1c109233352f0156272d10a162434e125f1"
    "1718191a262728292a35363738393a434445464748494a53545556575859"
    "5a636465666768696a737475767778797a82838485868788898a92939495"
    "969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8"
    "c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")]

SAMPLING = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}

# jfdctint.c / jidctint.c
_CONST_BITS, _PASS1_BITS = 13, 2
_FIX = {name: int(round(v * (1 << _CONST_BITS))) for name, v in (
    ("0_298631336", 0.298631336), ("0_390180644", 0.390180644),
    ("0_541196100", 0.541196100), ("0_765366865", 0.765366865),
    ("0_899976223", 0.899976223), ("1_175875602", 1.175875602),
    ("1_501321110", 1.501321110), ("1_847759065", 1.847759065),
    ("1_961570560", 1.961570560), ("2_053119869", 2.053119869),
    ("2_562915447", 2.562915447), ("3_072711026", 3.072711026))}


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _mul(x, name):
    return x * _FIX[name]


def _fdct_1d(d, out_shift, even_shift):
    """One pass of jpeg_fdct_islow over the last axis (8 samples)."""
    tmp0, tmp7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    tmp1, tmp6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    tmp2, tmp5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    tmp3, tmp4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = np.empty_like(d)
    if even_shift > 0:                      # pass 1: a left shift
        out[..., 0] = (tmp10 + tmp11) << even_shift
        out[..., 4] = (tmp10 - tmp11) << even_shift
    else:                                   # pass 2: a descale
        out[..., 0] = _descale(tmp10 + tmp11, -even_shift)
        out[..., 4] = _descale(tmp10 - tmp11, -even_shift)
    z1 = _mul(tmp12 + tmp13, "0_541196100")
    out[..., 2] = _descale(z1 + _mul(tmp13, "0_765366865"), out_shift)
    out[..., 6] = _descale(z1 - _mul(tmp12, "1_847759065"), out_shift)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = _mul(z3 + z4, "1_175875602")
    tmp4 = _mul(tmp4, "0_298631336")
    tmp5 = _mul(tmp5, "2_053119869")
    tmp6 = _mul(tmp6, "3_072711026")
    tmp7 = _mul(tmp7, "1_501321110")
    z1 = -_mul(z1, "0_899976223")
    z2 = -_mul(z2, "2_562915447")
    z3 = -_mul(z3, "1_961570560") + z5
    z4 = -_mul(z4, "0_390180644") + z5
    out[..., 7] = _descale(tmp4 + z1 + z3, out_shift)
    out[..., 5] = _descale(tmp5 + z2 + z4, out_shift)
    out[..., 3] = _descale(tmp6 + z2 + z3, out_shift)
    out[..., 1] = _descale(tmp7 + z1 + z4, out_shift)
    return out


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """(N, 8, 8) level-shifted samples -> jpeg_fdct_islow's coefficients,
    scaled up by 8 (rows first, then columns)."""
    d = blocks.astype(np.int64)
    d = _fdct_1d(d, _CONST_BITS - _PASS1_BITS, _PASS1_BITS)
    d = _fdct_1d(d.swapaxes(1, 2), _CONST_BITS + _PASS1_BITS, -_PASS1_BITS)
    return d.swapaxes(1, 2)


def _idct_1d(d, shift):
    """One pass of jpeg_idct_islow over the last axis."""
    z2, z3 = d[..., 2], d[..., 6]
    z1 = _mul(z2 + z3, "0_541196100")
    tmp2 = z1 - _mul(z3, "1_847759065")
    tmp3 = z1 + _mul(z2, "0_765366865")
    tmp0 = (d[..., 0] + d[..., 4]) << _CONST_BITS
    tmp1 = (d[..., 0] - d[..., 4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = d[..., 7], d[..., 5], d[..., 3], d[..., 1]
    z1, z2 = tmp0 + tmp3, tmp1 + tmp2
    z3, z4 = tmp0 + tmp2, tmp1 + tmp3
    z5 = _mul(z3 + z4, "1_175875602")
    tmp0 = _mul(tmp0, "0_298631336")
    tmp1 = _mul(tmp1, "2_053119869")
    tmp2 = _mul(tmp2, "3_072711026")
    tmp3 = _mul(tmp3, "1_501321110")
    z1 = -_mul(z1, "0_899976223")
    z2 = -_mul(z2, "2_562915447")
    z3 = -_mul(z3, "1_961570560") + z5
    z4 = -_mul(z4, "0_390180644") + z5
    tmp0 = tmp0 + z1 + z3
    tmp1 = tmp1 + z2 + z4
    tmp2 = tmp2 + z2 + z3
    tmp3 = tmp3 + z1 + z4
    out = np.empty_like(d)
    out[..., 0] = _descale(tmp10 + tmp3, shift)
    out[..., 7] = _descale(tmp10 - tmp3, shift)
    out[..., 1] = _descale(tmp11 + tmp2, shift)
    out[..., 6] = _descale(tmp11 - tmp2, shift)
    out[..., 2] = _descale(tmp12 + tmp1, shift)
    out[..., 5] = _descale(tmp12 - tmp1, shift)
    out[..., 3] = _descale(tmp13 + tmp0, shift)
    out[..., 4] = _descale(tmp13 - tmp0, shift)
    return out


def _idct_range_table() -> np.ndarray:
    """jdmaster.c's post-IDCT range limit, indexed by (x & 1023): x + 128
    clamped to 0..255 for x in -384..383, wrapping beyond."""
    t = np.empty(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[512:896] = 0
    t[896:] = np.arange(128)
    return t


_RANGE = _idct_range_table()


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """(N, 8, 8) dequantized coefficients -> jpeg_idct_islow's samples
    (columns first, then rows, then the range limit), uint8."""
    d = coef.astype(np.int64)
    d = _idct_1d(d.swapaxes(1, 2), _CONST_BITS - _PASS1_BITS).swapaxes(1, 2)
    d = _idct_1d(d, _CONST_BITS + _PASS1_BITS + 3)
    return _RANGE[d & 1023]


def quality_tables(quality: int):
    """jpeg_set_quality(q, force_baseline=TRUE): the luminance and
    chrominance tables, natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (STD_LUMA_Q, STD_CHROMA_Q))


@functools.lru_cache(maxsize=64)
def _reciprocals(divisor: tuple):
    """jcdctmgr.c's compute_reciprocal for 16-bit DCTELEM: (reciprocal,
    correction, shift) so that q = ((|x| + corr) * recip) >> shift."""
    recip, corr, shift = (np.empty(64, np.int64) for _ in range(3))
    for i, d in enumerate(divisor):
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip[i], corr[i], shift[i] = fq, c, r
    return recip, corr, shift


def _quantize(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """(N, 64) FDCT output -> quantized coefficients, natural order."""
    recip, corr, shift = _reciprocals(tuple(int(v) << 3 for v in qtable))
    mag = ((np.abs(coef) + corr) * recip) >> shift
    return np.where(coef < 0, -mag, mag)


def _bgr_to_ycc(bgr: np.ndarray) -> np.ndarray:
    """jccolor.c rgb_ycc_convert: (H, W, 3) BGR uint8 -> (3, H, W) Y, Cb,
    Cr in 16-bit fixed point."""
    b, g, r = (bgr[..., i].astype(np.int64) for i in range(3))
    half, off = 1 << 15, 128 << 16
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + off + half - 1) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + off + half - 1) >> 16
    return np.stack([y, cb, cr])


def _pad_edge(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    """Replicate the last row and column out to (h, w)."""
    ph, pw = plane.shape
    return np.pad(plane, ((0, h - ph), (0, w - pw)), mode="edge")


def _downsample(plane: np.ndarray, hs: int, vs: int, out_w: int,
                out_h: int) -> np.ndarray:
    """jcsample.c h2v1 / h2v2 (alternating bias 0, 1 / 1, 2) of a plane
    padded to (out_h * vs, out_w * hs) by replication."""
    p = _pad_edge(plane, out_h * vs, out_w * hs)
    if hs == vs == 1:
        return p
    bias = np.arange(out_w) % 2
    if vs == 1:
        return (p[:, 0::2] + p[:, 1::2] + bias) >> 1
    return (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
            + 1 + bias) >> 2


def _blocks_of(plane: np.ndarray) -> np.ndarray:
    """(8 bh, 8 bw) -> (bh, bw, 8, 8)."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).swapaxes(1, 2)


@functools.lru_cache(maxsize=8)
def _huff_enc(payload: bytes) -> "_HuffEnc":
    return _HuffEnc(payload)


class _HuffEnc:
    """A DHT payload's code and length for each symbol."""

    def __init__(self, payload: bytes):
        counts = payload[1:17]
        symbols = payload[17:17 + sum(counts)]
        self.code = np.zeros(256, np.int64)
        self.size = np.zeros(256, np.int64)
        code, k = 0, 0
        for length, n in enumerate(counts, 1):
            for _ in range(n):
                self.code[symbols[k]] = code
                self.size[symbols[k]] = length
                code += 1
                k += 1
            code <<= 1


def _nbits(v: np.ndarray) -> np.ndarray:
    """Bit length of |v| (0 for 0)."""
    a = np.abs(v)
    n = np.zeros(a.shape, np.int64)
    while np.any(a):
        nz = a > 0
        n += nz
        a >>= 1
    return n


def _entropy_events(zz: np.ndarray, pos: np.ndarray, dc_t: _HuffEnc,
                    ac_t: _HuffEnc):
    """Huffman events of blocks: zz (N, 64) quantized coefficients in
    zigzag order, DC already differenced, coded with (dc_t, ac_t); pos (N,)
    each block's place in the scan.  Returns (key, value, length) with key
    = pos * 200 + the event's slot in its block.  jchuff.c's
    encode_one_block: the DC category and its bits; each nonzero AC after
    a ZRL (0xF0) for every 16 zeros before it, as (run << 4 | size) and
    its bits; an EOB (0x00) after the last nonzero unless it is the 63rd."""
    n = zz.shape[0]
    # DC
    dc = zz[:, 0]
    s = _nbits(dc)
    dc_val = (dc_t.code[s] << s) | ((dc - (dc < 0)) & ((1 << s) - 1))
    dc_len = dc_t.size[s] + s
    # AC
    ac = zz[:, 1:]
    bi, ki = np.nonzero(ac)
    k = ki + 1
    prev = np.empty_like(k)
    if k.size:
        prev[1:] = k[:-1]
        first = np.ones(k.size, bool)
        first[1:] = bi[1:] != bi[:-1]
        prev[first] = 0
    run = k - prev - 1
    v = ac[bi, ki]
    s_ac = _nbits(v)
    sym = ((run & 15) << 4) | s_ac
    val = (ac_t.code[sym] << s_ac) | ((v - (v < 0)) & ((1 << s_ac) - 1))
    length = ac_t.size[sym] + s_ac
    nzrl = run >> 4
    last = np.full(n, 0, np.int64)
    if k.size:
        np.maximum.at(last, bi, k)
    eob = last < 63
    # slots: the DC 0, a nonzero at k 3 k after its ZRLs at 3 k - 3 + j
    # (at most three: 3 x 16 + 15 zeros fill the 63), the EOB 199
    zrl_v, zrl_l = ac_t.code[0xF0], ac_t.size[0xF0]
    key = pos * 200
    keys = [key, key[bi] + 3 * k]
    vals, lens = [dc_val, val], [dc_len, length]
    for j in range(3):
        m = nzrl > j
        keys.append(key[bi[m]] + 3 * k[m] - 3 + j)
        vals.append(np.full(m.sum(), zrl_v))
        lens.append(np.full(m.sum(), zrl_l))
    keys.append(key[eob] + 199)
    vals.append(np.full(eob.sum(), ac_t.code[0x00]))
    lens.append(np.full(eob.sum(), ac_t.size[0x00]))
    return (np.concatenate(keys), np.concatenate(vals),
            np.concatenate(lens))


def _pack_bits(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """Big-endian bit packing of (value, length) events, padded with 1s to
    a whole byte, 0xFF stuffed with 0x00."""
    total = int(lens.sum())
    pad = -total % 8
    if pad:
        vals = np.append(vals, (1 << pad) - 1)
        lens = np.append(lens, pad)
    ev = np.repeat(np.arange(lens.size), lens)
    start = np.cumsum(lens) - lens
    pos = np.arange(ev.size) - start[ev]
    bits = (vals[ev] >> (lens[ev] - 1 - pos)) & 1
    data = np.packbits(bits.astype(np.uint8))
    ff = np.nonzero(data == 0xFF)[0]
    if ff.size:
        data = np.insert(data, ff + 1, 0)
    return data.tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def encode(img: np.ndarray, quality: int = 95, sampling: str = "420",
           restart_interval: int = 0) -> bytes:
    """cv2.imencode('.jpg', img, [IMWRITE_JPEG_QUALITY, quality]) for an
    (H, W) / (H, W, 1) gray or (H, W, 3) BGR uint8 image: a baseline JFIF
    file with the quality-scaled standard tables, YCbCr at `sampling`
    ("420", "422" or "444", OpenCV's IMWRITE_JPEG_SAMPLING_FACTOR; a gray
    image has one component), the standard Huffman tables and, with
    restart_interval (IMWRITE_JPEG_RST_INTERVAL), a DRI and RSTn markers
    every that many MCUs."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"JPEG encode takes uint8, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if sampling not in SAMPLING:
        raise ValueError(f"sampling {sampling!r}; choose from "
                         f"{sorted(SAMPLING)}")
    h, w = img.shape[:2]
    gray = img.ndim == 2
    luma_q, chroma_q = quality_tables(quality)
    if gray:
        planes = [img.astype(np.int64)]
        factors = [(1, 1)]
    else:
        planes = list(_bgr_to_ycc(img))
        factors = [SAMPLING[sampling], (1, 1), (1, 1)]
    mh = max(f[0] for f in factors)
    mv = max(f[1] for f in factors)
    mcux, mcuy = -(-w // (8 * mh)), -(-h // (8 * mv))
    # the coefficients of each component, MCU-aligned (bh, bw, 64)
    comps = []
    for ci, (plane, (hs, vs)) in enumerate(zip(planes, factors)):
        wb = -(-w * hs // (8 * mh))              # width_in_blocks
        hb = -(-h * vs // (8 * mv))              # height_in_blocks
        fh, fv = mh // hs, mv // vs
        # downsampled rows: the image padded to a whole row group (mv
        # rows) first, then the result to the whole iMCU rows
        ds = _downsample(plane, fh, fv, wb * 8, -(-h // mv) * mv // fv)
        ds = _pad_edge(ds, mcuy * vs * 8, wb * 8)
        blocks = _blocks_of(ds - 128).reshape(-1, 8, 8)
        q = _quantize(fdct_islow(blocks).reshape(-1, 64),
                      luma_q if ci == 0 else chroma_q)
        q = q.reshape(mcuy * vs, wb, 64)
        full = np.zeros((mcuy * vs, mcux * hs, 64), np.int64)
        full[:, :wb] = q
        # dummy blocks (jccoefct.c compress_data): right of the image the
        # DC of the block to their left; in a dummy row below it (the last
        # iMCU row of an interleaved scan) that of the block before them
        # in the MCU, the last of the row above
        for bx in range(wb, mcux * hs):
            full[:, bx, 0] = full[:, bx - 1, 0]
        if len(planes) > 1:
            for by in range(hb, mcuy * vs):
                full[by] = 0
                full[by, :, 0] = np.repeat(full[by - 1, hs - 1::hs, 0], hs)
        else:
            full = full[:hb, :wb]
        comps.append(full)
    # coding order: MCU by MCU, each component's vs x hs blocks in turn
    parts, comp_of = [], []
    for ci, ((hs, vs), c) in enumerate(zip(factors, comps)):
        b = c.reshape(c.shape[0] // vs, vs, c.shape[1] // hs, hs, 64)
        parts.append(b.transpose(0, 2, 1, 3, 4).reshape(-1, vs * hs, 64))
        comp_of += [ci] * (vs * hs)
    mcus = parts[0].shape[0]
    blocks = np.concatenate(parts, axis=1).reshape(-1, 64)
    comp_of = np.tile(np.asarray(comp_of), mcus)
    mcu_of = np.repeat(np.arange(mcus), len(comp_of) // mcus)
    zz = blocks[:, ZIGZAG].copy()
    # DC differences per component, restarted at each restart interval
    interval = mcu_of // restart_interval if restart_interval else \
        np.zeros_like(mcu_of)
    for ci in range(len(planes)):
        sel = np.nonzero(comp_of == ci)[0]
        dcs = zz[sel, 0]
        prev = np.concatenate([[0], dcs[:-1]])
        new = np.concatenate([[True], interval[sel][1:] != interval[sel][:-1]])
        prev[new] = 0
        zz[sel, 0] = dcs - prev
    hts = [_huff_enc(p) for p in STD_DHT]
    out = [b"\xff\xd8", _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01"
                                 b"\x00\x01\x00\x00")]
    for tid, t in enumerate([luma_q] if gray else [luma_q, chroma_q]):
        out.append(_segment(0xFFDB, bytes([tid]) + t[ZIGZAG].astype(
            np.uint8).tobytes()))
    sof = struct.pack(">BHHB", 8, h, w, len(planes))
    for ci, (hs, vs) in enumerate(factors):
        sof += bytes([ci + 1, (hs << 4) | vs, 0 if ci == 0 else 1])
    out.append(_segment(0xFFC0, sof))
    for p in STD_DHT[:2] if gray else STD_DHT:
        out.append(_segment(0xFFC4, p))
    if restart_interval:
        out.append(_segment(0xFFDD, struct.pack(">H", restart_interval)))
    sos = bytes([len(planes)])
    for ci in range(len(planes)):
        sos += bytes([ci + 1, 0x00 if ci == 0 else 0x11])
    out.append(_segment(0xFFDA, sos + b"\x00\x3f\x00"))
    keys, vals, lens = [], [], []
    for ci in range(len(planes)):
        sel = np.nonzero(comp_of == ci)[0]
        t = hts[:2] if ci == 0 else hts[2:]
        for acc, x in zip((keys, vals, lens),
                          _entropy_events(zz[sel], sel, *t)):
            acc.append(x)
    keys = np.concatenate(keys)
    order = np.argsort(keys, kind="stable")
    keys, vals, lens = keys[order], np.concatenate(vals)[order], \
        np.concatenate(lens)[order]
    # one packed run a restart interval, RSTn markers between them
    cut = np.searchsorted(keys // 200, np.nonzero(np.diff(interval))[0] + 1)
    for iv, (v, ln) in enumerate(zip(np.split(vals, cut),
                                     np.split(lens, cut))):
        if iv:
            out.append(bytes([0xFF, 0xD0 + (iv - 1) % 8]))
        out.append(_pack_bits(v, ln))
    out.append(b"\xff\xd9")
    return b"".join(out)


def _refuse(what: str):
    raise NotImplementedError(
        f"JPEG: {what} is not read by smoe_tpu_torch ({ROADMAP}); the port "
        "decodes sequential and progressive Huffman files of 8-bit "
        "samples, 1, 3 or 4 components at integral sampling factors")


@functools.lru_cache(maxsize=16)
def _huff_dec(table: bytes) -> "_HuffDec":
    """The decoder's tables of a DHT table (its 16 counts and symbols)."""
    return _HuffDec(list(table[:16]), list(table[16:]))


class _HuffDec:
    """Lookup tables of a DHT table on 16-bit prefixes: the code length and
    symbol, and for symbols whose code and extra bits fit in 16 bits the
    total length and the extended value (0 total: decode the slow way)."""

    def __init__(self, counts, symbols):
        size = np.zeros(1 << 16, np.int64)
        sym = np.zeros(1 << 16, np.int64)
        ftot = np.zeros(1 << 16, np.int64)
        fval = np.zeros(1 << 16, np.int64)
        code, k = 0, 0
        for length, n in enumerate(counts, 1):
            for _ in range(n):
                s = symbols[k]
                lo = code << (16 - length)
                hi = (code + 1) << (16 - length)
                size[lo:hi], sym[lo:hi] = length, s
                extra = s & 15
                if length + extra <= 16:
                    idx = np.arange(lo, hi)
                    e = (idx >> (16 - length - extra)) & ((1 << extra) - 1)
                    ftot[lo:hi] = length + extra
                    fval[lo:hi] = np.where(
                        e < (1 << extra >> 1), e - (1 << extra) + 1, e) \
                        if extra else 0
                code += 1
                k += 1
            code <<= 1
        self.size, self.sym = size.tolist(), sym.tolist()
        self.ftot, self.fval = ftot.tolist(), fval.tolist()


def _unstuff(seg: bytes) -> list:
    """An entropy-coded segment's bytes, 0xFF00 -> 0xFF, as 32-bit windows
    w[i] = bytes i..i+3 (zero past the end)."""
    a = np.frombuffer(seg.replace(b"\xff\x00", b"\xff") + b"\0" * 8,
                      np.uint8).astype(np.int64)
    return ((a[:-3] << 24) | (a[1:-2] << 16) | (a[2:-1] << 8)
            | a[3:]).tolist()


def _decode_segment(win, mcus, plan, coef):
    """Decode `mcus` MCUs of one restart interval.  plan: per block of an
    MCU, (dc table, ac table, component, list of base offsets into that
    component's coefficient list, one an MCU).  Coefficients land in
    natural order; the DC predictors start at 0."""
    pos = 0
    pred = {}
    zz = ZIGZAG.tolist()
    for m in range(mcus):
        for dct, act, ci, bases in plan:
            out = coef[ci]
            base = bases[m]
            # DC
            o = pos & 7
            w = (win[pos >> 3] >> (16 - o)) & 0xFFFF
            t = dct.ftot[w]
            if t:
                diff = dct.fval[w]
                pos += t
            else:
                s = dct.sym[w]
                pos += dct.size[w]
                if s:
                    o = pos & 7
                    v = (win[pos >> 3] >> (32 - s - o)) & ((1 << s) - 1)
                    pos += s
                    diff = v if v >= 1 << (s - 1) else v - (1 << s) + 1
                else:
                    diff = 0
            dc = pred.get(ci, 0) + diff
            pred[ci] = dc
            out[base] = dc
            # AC
            k = 1
            asize, asym, aftot, afval = act.size, act.sym, act.ftot, \
                act.fval
            while k < 64:
                o = pos & 7
                w = (win[pos >> 3] >> (16 - o)) & 0xFFFF
                rs = asym[w]
                t = aftot[w]
                if t and rs & 15:
                    k += rs >> 4
                    out[base + zz[k]] = afval[w]
                    pos += t
                    k += 1
                    continue
                pos += asize[w]
                s = rs & 15
                if s:
                    k += rs >> 4
                    o = pos & 7
                    v = (win[pos >> 3] >> (32 - s - o)) & ((1 << s) - 1)
                    pos += s
                    out[base + zz[k]] = v if v >= 1 << (s - 1) \
                        else v - (1 << s) + 1
                    k += 1
                elif rs == 0xF0:
                    k += 16
                else:
                    break


def _decode_prog_segment(win, mcus, plan, coef, ss, se, ah, al):
    """Decode `mcus` MCUs of one restart interval of a progressive scan
    (jdphuff.c): a DC first (ah = 0) or refinement scan over the plan's
    blocks, or an AC first or refinement scan of band ss..se of one
    component, with its EOB runs.  Successive approximation: a first
    scan stores its values shifted up by al, a refinement adds bit al."""
    pos = 0
    pred = {}
    eobrun = 0
    zz = ZIGZAG.tolist()
    p1, m1 = 1 << al, -1 << al

    def huff(t):
        nonlocal pos
        o = pos & 7
        w = (win[pos >> 3] >> (16 - o)) & 0xFFFF
        pos += t.size[w]
        return t.sym[w]

    def bits(n):
        nonlocal pos
        o = pos & 7
        v = (win[pos >> 3] >> (32 - n - o)) & ((1 << n) - 1)
        pos += n
        return v

    def extend(v, n):
        return v if v >= 1 << (n - 1) else v - (1 << n) + 1

    for m in range(mcus):
        for dct, act, ci, bases in plan:
            out = coef[ci]
            base = bases[m]
            if ss == 0:
                if ah == 0:
                    n = huff(dct)
                    dc = pred.get(ci, 0) + (extend(bits(n), n) if n else 0)
                    pred[ci] = dc
                    out[base] = dc << al
                elif bits(1):
                    out[base] |= p1
                continue
            if ah == 0:
                if eobrun:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    rs = huff(act)
                    r, n = rs >> 4, rs & 15
                    if n:
                        k += r
                        out[base + zz[k]] = extend(bits(n), n) << al
                        k += 1
                    elif r == 15:
                        k += 16
                    else:
                        eobrun = (1 << r) + (bits(r) if r else 0) - 1
                        break
                continue
            k = ss
            if eobrun == 0:
                while k <= se:
                    rs = huff(act)
                    r, n = rs >> 4, rs & 15
                    if n:
                        n = p1 if bits(1) else m1
                    elif r != 15:
                        eobrun = (1 << r) + (bits(r) if r else 0)
                        break
                    # past the nonzero coefficients (a correction bit
                    # each) and r zero ones, to the new coefficient
                    while k <= se:
                        idx = base + zz[k]
                        c = out[idx]
                        if c:
                            if bits(1) and not c & p1:
                                out[idx] = c + p1 if c >= 0 else c + m1
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if n and k <= se:
                        out[base + zz[k]] = n
                    k += 1
            if eobrun > 0:
                while k <= se:
                    idx = base + zz[k]
                    c = out[idx]
                    if c and bits(1) and not c & p1:
                        out[idx] = c + p1 if c >= 0 else c + m1
                    k += 1
                eobrun -= 1


# jdcoefct.c's block smoothing: the natural positions of zigzag
# coefficients 1-9, and each one's estimate from the 5 x 5 neighbourhood
# of DC values (rows of the tuple: block rows -2..+2, columns -2..+2),
# with DC interpolation (all of 1-9 unknown) and without
_SMOOTH_POS = (1, 8, 16, 9, 2, 3, 10, 17, 24)
_SMOOTH_DC = np.array(
    [[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6], [-8, 42, 152, 42, -8],
     [-6, 6, 42, 6, -6], [-2, -6, -8, -6, -2]], np.int64)
_SMOOTH_INTERP = np.array([
    [[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3],
     [-3, 13, 0, -13, 3], [-1, -1, 0, 1, 1]],                  # AC01
    [[-1, -3, -3, -3, -1], [-1, 13, 38, 13, -1], [0, 0, 0, 0, 0],
     [1, -13, -38, -13, 1], [1, 3, 3, 3, 1]],                  # AC10
    [[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0],
     [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]],                        # AC20
    [[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0, 0, 0, 0, 0],
     [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]],                      # AC11
    [[0, 0, 0, 0, 0], [0, 2, -5, 2, 0], [1, 7, -14, 7, 1],
     [0, 2, -5, 2, 0], [0, 0, 0, 0, 0]],                       # AC02
    [[0, 0, 0, 0, 0], [0, 1, 0, -1, 0], [0, 2, 0, -2, 0],
     [0, 1, 0, -1, 0], [0, 0, 0, 0, 0]],                       # AC03
    [[0, 0, 0, 0, 0], [0, 1, -3, 1, 0], [0, 0, 0, 0, 0],
     [0, -1, 3, -1, 0], [0, 0, 0, 0, 0]],                      # AC12
    [[0, 0, 0, 0, 0], [0, 1, 0, -1, 0], [0, -3, 0, 3, 0],
     [0, 1, 0, -1, 0], [0, 0, 0, 0, 0]],                       # AC21
    [[0, 0, 0, 0, 0], [0, 1, 2, 1, 0], [0, 0, 0, 0, 0],
     [0, -1, -2, -1, 0], [0, 0, 0, 0, 0]]], np.int64)          # AC30
_SMOOTH_PLAIN = np.array([
    [[0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [-7, 50, 0, -50, 7],
     [0, 0, 0, 0, 0], [0, 0, 0, 0, 0]],                        # AC01
    [[0, 0, -7, 0, 0], [0, 0, 50, 0, 0], [0, 0, 0, 0, 0],
     [0, 0, -50, 0, 0], [0, 0, 7, 0, 0]],                      # AC10
    [[0, 0, -1, 0, 0], [0, 0, 13, 0, 0], [0, 0, -24, 0, 0],
     [0, 0, 13, 0, 0], [0, 0, -1, 0, 0]],                      # AC20
    [[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0, 0, 0, 0, 0],
     [1, -10, 0, 10, -1], [0, 1, 0, -1, 0]],                   # AC11
    [[0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [-1, 13, -24, 13, -1],
     [0, 0, 0, 0, 0], [0, 0, 0, 0, 0]]], np.int64)             # AC02


def _smooth_rows(hib: int, v: int, total: int) -> np.ndarray:
    """(hib, 5) block-row indices of rows -2..+2 around each block row, as
    decompress_smooth_data picks them: per iMCU row of v block rows (the
    last one holding only its real rows), a row's neighbours are counted
    on output_iMCU_row * block_rows + block_row against block_rows *
    total_iMCU_rows, and replicated past those bounds."""
    out = []
    for m in range(total):
        rows = v if m < total - 1 else (hib % v or v)
        image_rows = rows * total
        for b in range(rows):
            ibr, r = m * rows + b, m * v + b
            prev = r - 1 if ibr > 0 else r
            pprev = r - 2 if ibr > 1 else prev
            nxt = r + 1 if ibr < image_rows - 1 else r
            nnxt = r + 2 if ibr < image_rows - 2 else nxt
            out.append((pprev, prev, r, nxt, nnxt))
    return np.array(out[:hib], np.int64)


def _smooth_blocks(c: np.ndarray, hib: int, wib: int, v: int, total: int,
                   bits: list, q: np.ndarray) -> np.ndarray:
    """jdcoefct.c decompress_smooth_data on one component's (rows, cols,
    64) quantized coefficients: each of zigzag coefficients 1-9 whose bits
    are not all known (`bits`, coef_bits: -1 never sent, Al > 0 partly)
    and that is still 0 takes its estimate from the neighbours' DC values,
    clamped below 1 << Al; with none of 1-9 sent, the DC is interpolated
    too.  Returns the real blocks' coefficients to transform."""
    work = c[:hib, :wib].copy()
    dc = c[..., 0]
    rows = _smooth_rows(hib, v, total)
    cols = np.clip(np.arange(wib)[:, None] + np.arange(-2, 3), 0, wib - 1)
    nb = dc[rows[:, :, None, None], cols[None, None, :, :]]  # (h,5,w,5)
    nb = nb.transpose(0, 2, 1, 3)                            # (h,w,5,5)
    interp = all(b == -1 for b in bits[1:10])
    weights = _SMOOTH_INTERP if interp else _SMOOTH_PLAIN
    q00 = int(q[0])
    for i, w in enumerate(weights):
        al, pos = bits[1 + i], _SMOOTH_POS[i]
        if al == 0:
            continue
        qk = int(q[pos])
        num = q00 * np.einsum("hwij,ij->hw", nb, w)
        mag = ((qk << 7) + np.abs(num)) // (qk << 8)
        if al > 0:
            mag = np.minimum(mag, (1 << al) - 1)
        est = np.where(num >= 0, mag, -mag)
        work[..., pos] = np.where(work[..., pos] == 0, est, work[..., pos])
    if interp:
        num = q00 * np.einsum("hwij,ij->hw", nb, _SMOOTH_DC)
        mag = ((q00 << 7) + np.abs(num)) // (q00 << 8)
        work[..., 0] = np.where(num >= 0, mag, -mag)
    return work


def _fancy_h1v2(p: np.ndarray) -> np.ndarray:
    """jdsample.c h1v2_fancy_upsample: 3/4 nearer + 1/4 further row,
    rounding 1 (above) / 2 (below), the edges replicated."""
    x = p.astype(np.int64)
    up = np.concatenate([x[:1], x[:-1]], 0)
    down = np.concatenate([x[1:], x[-1:]], 0)
    out = np.empty((2 * x.shape[0], x.shape[1]), np.int64)
    out[0::2] = (3 * x + up + 1) >> 2
    out[1::2] = (3 * x + down + 2) >> 2
    return out


def _fancy_h2v1(p: np.ndarray) -> np.ndarray:
    """jdsample.c h2v1_fancy_upsample: 3/4 nearer + 1/4 further sample,
    rounding 1 / 2 alternately, the edges replicated."""
    x = p.astype(np.int64)
    left = np.concatenate([x[:, :1], x[:, :-1]], 1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int64)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    return out


def _fancy_h2v2(p: np.ndarray) -> np.ndarray:
    """jdsample.c h2v2_fancy_upsample: column sums 3 x nearer row +
    further row, then across 3 x nearer + further sum, (+ 8 / + 7) >> 4;
    the image's first and last rows and columns replicated."""
    x = p.astype(np.int64)
    up = np.concatenate([x[:1], x[:-1]], 0)
    down = np.concatenate([x[1:], x[-1:]], 0)
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int64)
    for v, far in ((0, up), (1, down)):
        c = 3 * x + far
        left = np.concatenate([c[:, :1], c[:, :-1]], 1)
        right = np.concatenate([c[:, 1:], c[:, -1:]], 1)
        out[v::2, 0::2] = (3 * c + left + 8) >> 4
        out[v::2, 1::2] = (3 * c + right + 7) >> 4
    return out


def _ycc_to_bgr(y, cb, cr) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert with its 16-bit fixed-point tables."""
    half = 1 << 15
    cbx, crx = cb.astype(np.int64) - 128, cr.astype(np.int64) - 128
    y = y.astype(np.int64)
    r = y + ((91881 * crx + half) >> 16)
    g = y + ((-22554 * cbx + half - 46802 * crx) >> 16)
    b = y + ((116130 * cbx + half) >> 16)
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)


def _u16(data, i):
    return (data[i] << 8) | data[i + 1]


def exif_orientation(data: bytes) -> int:
    """The EXIF Orientation tag (0x0112) of a JPEG's APP1 "Exif" segment,
    1 when it has none."""
    i = 2
    while i + 4 <= len(data) and data[i] == 0xFF:
        marker, length = data[i + 1], _u16(data, i + 2)
        if marker == 0xDA:
            break
        seg = data[i + 4:i + 2 + length]
        if marker == 0xE1 and seg[:6] == b"Exif\0\0":
            t = seg[6:]
            e = "<" if t[:2] == b"II" else ">"
            try:
                ifd = struct.unpack(e + "I", t[4:8])[0]
                n = struct.unpack(e + "H", t[ifd:ifd + 2])[0]
                for k in range(n):
                    ent = t[ifd + 2 + 12 * k:ifd + 14 + 12 * k]
                    tag, typ = struct.unpack(e + "HH", ent[:4])
                    if tag == 0x0112 and typ == 3:
                        return struct.unpack(e + "H", ent[8:10])[0]
            except struct.error:
                return 1
            return 1
        i += 2 + length
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ExifTransform: flips and transposes for orientations 2-8."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    for ax in flip.get(orientation, ()):
        img = np.flip(img, ax)
    return np.ascontiguousarray(img)


def _entropy_segments(data: bytes, i: int):
    """The entropy-coded data of a scan from byte i: its restart intervals'
    bytes (split at RSTn, stuffed 0xFF00 kept) and the offset of the
    marker that ends it (0xFF fill bytes before a marker dropped)."""
    segs, start = [], i
    while True:
        j = data.index(b"\xff", i)
        k = j
        while data[k + 1] == 0xFF:
            k += 1
        nxt = data[k + 1]
        if nxt == 0x00 and k == j:
            i = j + 2
        elif 0xD0 <= nxt <= 0xD7:
            segs.append(data[start:j])
            i = start = k + 2
        else:
            segs.append(data[start:j])
            return segs, k


def _decode_scan(sos: bytes, frame, dht, restart: int, segs, coef,
                 prog=None):
    """One scan's blocks into coef: its components (one: the component's
    blocks row by row; several: MCU by MCU, each component's v x h
    blocks), `restart` MCUs a segment.  prog: None for a sequential scan,
    else the coef_bits lists (updated here) of a progressive frame."""
    h, w, comps, hmax, vmax, mcux, mcuy = frame
    ids = [c[0] for c in comps]
    ncs = sos[0]
    sc = [(ids.index(sos[1 + 2 * k]), sos[2 + 2 * k] >> 4,
           sos[2 + 2 * k] & 15) for k in range(ncs)]
    ss, se = sos[1 + 2 * ncs], sos[2 + 2 * ncs]
    ah, al = sos[3 + 2 * ncs] >> 4, sos[3 + 2 * ncs] & 15
    plan_blocks = []
    if len(sc) == 1:
        ci = sc[0][0]
        hs, vs = comps[ci][1], comps[ci][2]
        bw, bh = -(-w * hs // (8 * hmax)), -(-h * vs // (8 * vmax))
        plan_blocks.append((ci, [(r * mcux * hs + c) * 64
                                 for r in range(bh) for c in range(bw)]))
    else:
        for ci, _, _ in sc:
            hs, vs = comps[ci][1], comps[ci][2]
            for yy in range(vs):
                for xx in range(hs):
                    plan_blocks.append((ci, [
                        ((my * vs + yy) * mcux * hs + mx * hs + xx) * 64
                        for my in range(mcuy) for mx in range(mcux)]))
    tables = {ci: (dht.get((0, td)), dht.get((1, ta))) for ci, td, ta in sc}
    if prog is not None:
        for ci, _, _ in sc:     # jdphuff.c start_pass_phuff_decoder
            prog[ci][ss:se + 1] = [al] * (se - ss + 1)
    total = len(plan_blocks[0][1])
    per = restart or total
    for s_i, seg in enumerate(segs):
        lo = s_i * per
        n = min(per, total - lo)
        if n <= 0:
            break
        plan = [(*tables[ci], ci, bases[lo:lo + n])
                for ci, bases in plan_blocks]
        if prog is None:
            _decode_segment(_unstuff(seg), n, plan, coef)
        else:
            _decode_prog_segment(_unstuff(seg), n, plan, coef, ss, se, ah,
                                 al)


def _upsample(px: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """jdsample.c's choice for a component sampled fh x fv below the
    frame: fancy h2v1 and h2v2 (box at two columns or fewer), fancy h1v2,
    and int_upsample's replication for every other integral factor."""
    wide = px.shape[1] > 2
    if (fh, fv) == (2, 1) and wide:
        return _fancy_h2v1(px)
    if (fh, fv) == (2, 2) and wide:
        return _fancy_h2v2(px)
    if (fh, fv) == (1, 2):
        return _fancy_h1v2(px)
    return np.repeat(np.repeat(px, fv, 0), fh, 1)


def _cmyk_to_bgr(c, m, y, k) -> np.ndarray:
    """OpenCV's icvCvt_CMYK2BGR_8u_C4C3R: each of C, M, Y becomes
    k - ((255 - x) * k >> 8)."""
    k = k.astype(np.int64)
    return np.stack([k - ((255 - x.astype(np.int64)) * k >> 8)
                     for x in (y, m, c)], -1).astype(np.uint8)


def _ycck_to_cmyk(y, cb, cr, k):
    """jdcolor.c ycck_cmyk_convert: C, M, Y are 255 less the R, G, B of
    the YCC triple; K passes through."""
    bgr = _ycc_to_bgr(y, cb, cr).astype(np.int64)
    return 255 - bgr[..., 2], 255 - bgr[..., 1], 255 - bgr[..., 0], k


def decode(data: bytes, mode: str = "unchanged") -> np.ndarray:
    """Decode a JPEG file's bytes as cv2.imdecode does with IMREAD_COLOR
    ("color": (H, W, 3) BGR, EXIF orientation applied), IMREAD_GRAYSCALE
    ("gray": (H, W)) or IMREAD_UNCHANGED ("unchanged": (H, W) for one
    component, (H, W, 3) BGR for three)."""
    if mode not in ("color", "gray", "unchanged"):
        raise ValueError(f"mode {mode!r}")
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file: no SOI marker")
    qt, dht, restart = {}, {}, 0
    frame = coef = prog = adobe = None
    jfif = False
    i = 2
    while i < len(data):
        if data[i] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {i}")
        marker = data[i + 1]
        if marker == 0xFF:
            i += 1
            continue
        if marker == 0xD9:
            break
        length = _u16(data, i + 2)
        seg = data[i + 4:i + 2 + length]
        i += 2 + length
        if marker == 0xDB:
            j = 0
            while j < len(seg):
                pq, tq = seg[j] >> 4, seg[j] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(seg[j + 1:j + 1 + n],
                                     ">u2" if pq else np.uint8)
                t = np.empty(64, np.int64)
                t[ZIGZAG] = vals
                qt[tq] = t
                j += 1 + n
        elif marker == 0xC4:
            j = 0
            while j < len(seg):
                n = sum(seg[j + 1:j + 17])
                dht[(seg[j] >> 4, seg[j] & 15)] = _huff_dec(
                    bytes(seg[j + 1:j + 17 + n]))
                j += 17 + n
        elif marker == 0xDD:
            restart = _u16(seg, 0)
        elif marker in (0xC0, 0xC1, 0xC2):
            if seg[0] != 8:
                _refuse(f"{seg[0]}-bit samples (neither cv2 nor PIL here "
                        "writes such a file to hold a decoder to)")
            h, w, nc = _u16(seg, 1), _u16(seg, 3), seg[5]
            if nc not in (1, 3, 4):
                _refuse(f"{nc} components")
            comps = [(seg[6 + 3 * c], seg[7 + 3 * c] >> 4,
                      seg[7 + 3 * c] & 15, seg[8 + 3 * c])
                     for c in range(nc)]
            hmax = max(c[1] for c in comps)
            vmax = max(c[2] for c in comps)
            if nc == 1:
                comps = [(comps[0][0], 1, 1, comps[0][3])]
                hmax = vmax = 1
            elif any(not 1 <= c[1] <= 4 or not 1 <= c[2] <= 4
                     or hmax % c[1] or vmax % c[2] for c in comps):
                _refuse("sampling factors "
                        + " ".join(f"{c[1]}x{c[2]}" for c in comps))
            mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            frame = (h, w, comps, hmax, vmax, mcux, mcuy)
            coef = [[0] * (mcuy * c[2] * mcux * c[1] * 64) for c in comps]
            if marker == 0xC2:
                prog = [[-1] * 64 for _ in comps]
        elif marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD,
                        0xCE, 0xCF):
            _refuse({0xC3: "lossless (SOF3)"}.get(
                marker, f"SOF{marker - 0xC0} (arithmetic coding or "
                "hierarchical)") + "; neither cv2 nor PIL here writes such "
                "a file to hold a decoder to")
        elif marker == 0xE0 and seg[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG: SOS before SOF")
            segs, i = _entropy_segments(data, i)
            _decode_scan(seg, frame, dht, restart, segs, coef, prog)
        # APPn, COM and the rest: skipped
    if frame is None:
        raise ValueError("JPEG: no frame")
    h, w, comps, hmax, vmax, mcux, mcuy = frame
    # jdcoefct.c smoothing_ok: a progressive file whose DC is known in
    # every component and whose coefficients 1-9 are not all complete
    smooth = prog is not None and all(b[0] >= 0 for b in prog) and any(
        b[k] != 0 for b in prog for k in range(1, 10))
    planes = []
    need = 1 if mode == "gray" and len(comps) != 4 else len(comps)
    for ci, (cid, hs, vs, tq) in enumerate(comps[:need]):
        c = np.asarray(coef[ci], np.int64).reshape(mcuy * vs, mcux * hs,
                                                   64)
        dw_, dh_ = -(-w * hs // hmax), -(-h * vs // vmax)
        if smooth:
            hib, wib = -(-dh_ // 8), -(-dw_ // 8)
            c[:hib, :wib] = _smooth_blocks(c, hib, wib, vs, mcuy, prog[ci],
                                           qt[tq])
        c = c.reshape(mcuy * vs, mcux * hs, 8, 8) * qt[tq].reshape(8, 8)
        px = idct_islow(c.reshape(-1, 8, 8)).reshape(
            mcuy * vs, mcux * hs, 8, 8).swapaxes(1, 2).reshape(
            mcuy * vs * 8, mcux * hs * 8)
        px = px[:dh_, :dw_]
        fh, fv = hmax // hs, vmax // vs
        if (fh, fv) != (1, 1):
            px = _upsample(px, fh, fv)[:h, :w]
        planes.append(px)
    if len(comps) == 4:
        cmyk = planes if adobe in (None, 0) else _ycck_to_cmyk(*planes)
        out = _cmyk_to_bgr(*cmyk)
        if mode == "gray":      # OpenCV's icvCvt_CMYK2Gray_8u_C4C1R
            v = out.astype(np.int64)
            out = ((v[..., 0] * 1868 + v[..., 1] * 9617 + v[..., 2] * 4899
                    + 8192) >> 14).astype(np.uint8)
    elif mode == "gray" or len(comps) == 1:
        out = planes[0].astype(np.uint8)
        if mode == "color":
            out = np.repeat(out[..., None], 3, -1)
    elif not jfif and (adobe == 0 or adobe is None and [
            c[0] for c in comps] == [82, 71, 66]):  # an RGB file
        out = np.stack(planes[::-1], -1).astype(np.uint8)
    else:
        out = _ycc_to_bgr(*planes)
    if mode == "color":
        out = apply_orientation(out, exif_orientation(data))
    return out


def read_jpeg(path: str, mode: str = "unchanged") -> np.ndarray:
    """cv2.imread(path, IMREAD_COLOR / IMREAD_GRAYSCALE / IMREAD_UNCHANGED)
    of a JPEG file; see decode."""
    with open(path, "rb") as f:
        return decode(f.read(), mode)
