"""Entropy-coded parameter bitstream (real rate, not the raw-bits proxy).

A numpy/ctypes copy of smoe_tpu/codec/bitstream.py (whole file) with its
imports pointed into the port, so both packages write byte-identical
files.  `_native_dir()` sits at the same depth and finds the shared
native/rangecoder.cc; the pure-Python coder stays as the bit-exact
fallback where no C++ compiler is present.

The reference's "decoded" path reads a pickle of quantized integers and
calls it a bitstream stand-in (reference smoe_reconstruction_decoded.py:
16-62); its rate metric is   #kernels x sum(bit_depths)   (reference
smoe.py:1012, smoe_test.py:302-303).  Here the quantized integers are
actually entropy-coded: an adaptive binary range coder (LZMA-style carry
tracking, 11-bit probabilities, context = (param group, bit position)),
implemented in C++ (native/rangecoder.cc, loaded via ctypes) with a
bit-exact pure-Python fallback.  Per-kernel streams are inter-kernel
predicted first: kernels sit in raster grid order, so per-component
deltas along the kernel axis (zigzag-mapped, one extra magnitude bit)
are small and the adaptive bit-position contexts squeeze them well; the
raw/delta choice is made per param by a magnitude estimate and recorded
in the header, keeping decode exactly invertible.  The "nbr" mode's
causal nearest-neighbour graph and its inversion run in the port's own
C++ (csrc/causal_nbr.cc: a grid search returning the loop's exact
indices), with the loops `_causal_nbr` / `_nbr_decode` as the fallback;
the readers time both in the span `smoe.decode.neighbours`.

Container layout:  b"SMOE" | u32 header_len | JSON header | payload
The JSON header carries everything the decoder needs to rebuild params
without the original image (shapes, bit depths, bounds, flags).
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
import struct
import subprocess
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from smoe_tpu_torch.diag.profile import span

MAGIC = b"SMOE"
_TOP = 1 << 24
_TOTAL = 1 << 11
_MOVE = 5
_NGROUPS = 8
_MAXBITS = 32

_lib = None
_lib_tried = False


def _native_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "native")


def _shared_library(src: str, so: str) -> Optional[ctypes.CDLL]:
    """Load the shared library `so`, building it from the C++ source `src`
    with g++ when it is missing or older than `src`; None if unavailable."""
    stale = (os.path.exists(src) and os.path.exists(so)
             and os.path.getmtime(src) > os.path.getmtime(so))
    if not os.path.exists(so) or stale:
        if not os.path.exists(src):
            return None
        # build to a private temp path, then rename: atomic against
        # concurrent builders (multi-process fleets) and never truncates
        # a .so another live process has dlopen'd
        tmp = f"{so}.build.{os.getpid()}"
        try:
            os.makedirs(os.path.dirname(so), exist_ok=True)
            subprocess.run(
                ["g++", "-O2", "-fPIC", "-std=c++17", "-shared", "-o", tmp,
                 src], check=True, capture_output=True)
            os.replace(tmp, so)
        except (subprocess.CalledProcessError, FileNotFoundError, OSError):
            try:
                os.unlink(tmp)
            except OSError:
                pass
            if not os.path.exists(so):
                return None
    try:
        return ctypes.CDLL(so)
    except OSError:
        return None


def load_native() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the C++ range coder; None if unavailable."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    lib = _shared_library(os.path.join(_native_dir(), "rangecoder.cc"),
                          os.path.join(_native_dir(), "libsmoe_rc.so"))
    if lib is None:
        return None
    lib.smoe_rc_encode.restype = ctypes.c_size_t
    lib.smoe_rc_encode.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t]
    lib.smoe_rc_decode.restype = ctypes.c_longlong
    lib.smoe_rc_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint32)]
    _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _load_nbr() -> Optional[ctypes.CDLL]:
    """The port's C++ neighbour search and its inversion
    (`csrc/causal_nbr.cc`, built into the git-ignored `build/` beside it);
    None where it cannot be built or loaded."""
    here = os.path.dirname(os.path.abspath(__file__))
    lib = _shared_library(os.path.join(here, "csrc", "causal_nbr.cc"),
                          os.path.join(here, "build", "libsmoe_nbr.so"))
    if lib is None:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.smoe_causal_nbr.restype = ctypes.c_int
    lib.smoe_causal_nbr.argtypes = [i64p, ctypes.c_int64, ctypes.c_int32,
                                    i64p]
    lib.smoe_nbr_decode.restype = None
    lib.smoe_nbr_decode.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64,
                                    i64p, i64p]
    return lib


# ---------------------------------------------------------------------------
# pure-Python mirror of native/rangecoder.cc (bit-exact; fallback + tests)
# ---------------------------------------------------------------------------

class _PyEncoder:
    def __init__(self):
        self.low = 0
        self.range = 0xFFFFFFFF
        self.cache = 0
        self.cache_size = 1
        self.out = bytearray()

    def _shift_low(self):
        if (self.low >> 32) != 0 or (self.low & 0xFFFFFFFF) < 0xFF000000:
            carry = self.low >> 32
            while True:
                self.out.append((self.cache + carry) & 0xFF)
                self.cache = 0xFF
                self.cache_size -= 1
                if self.cache_size == 0:
                    break
            self.cache = (self.low >> 24) & 0xFF
        self.cache_size += 1
        self.low = (self.low << 8) & 0xFFFFFFFF

    def encode_bit(self, probs, ctx, bit):
        p = probs[ctx]
        bound = (self.range >> 11) * p
        if not bit:
            self.range = bound
            probs[ctx] = p + ((_TOTAL - p) >> _MOVE)
        else:
            self.low += bound
            self.range -= bound
            probs[ctx] = p - (p >> _MOVE)
        while self.range < _TOP:
            self.range = (self.range << 8) & 0xFFFFFFFF
            self._shift_low()

    def flush(self):
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


class _PyDecoder:
    def __init__(self, data: bytes):
        self.range = 0xFFFFFFFF
        self.code = 0
        self.data = data
        self.pos = 0
        self._next()                          # leading zero byte
        for _ in range(4):
            self.code = ((self.code << 8) | self._next()) & 0xFFFFFFFF

    def _next(self) -> int:
        if self.pos < len(self.data):
            b = self.data[self.pos]
            self.pos += 1
            return b
        raise EOFError("truncated bitstream")

    def decode_bit(self, probs, ctx) -> int:
        p = probs[ctx]
        bound = (self.range >> 11) * p
        if self.code < bound:
            self.range = bound
            probs[ctx] = p + ((_TOTAL - p) >> _MOVE)
            bit = 0
        else:
            self.code -= bound
            self.range -= bound
            probs[ctx] = p - (p >> _MOVE)
            bit = 1
        while self.range < _TOP:
            self.range = (self.range << 8) & 0xFFFFFFFF
            self.code = ((self.code << 8) | self._next()) & 0xFFFFFFFF
        return bit


def _py_encode(vals, nbits, group) -> bytes:
    probs = [_TOTAL // 2] * (_NGROUPS * _MAXBITS)
    enc = _PyEncoder()
    for v, b, g in zip(vals, nbits, group):
        base = (int(g) & (_NGROUPS - 1)) * _MAXBITS
        v = int(v)
        for j in range(int(b) - 1, -1, -1):
            enc.encode_bit(probs, base + j, (v >> j) & 1)
    return enc.flush()


def _py_decode(data: bytes, nbits, group) -> np.ndarray:
    probs = [_TOTAL // 2] * (_NGROUPS * _MAXBITS)
    dec = _PyDecoder(data)
    out = np.zeros(len(nbits), np.uint32)
    for i, (b, g) in enumerate(zip(nbits, group)):
        base = (int(g) & (_NGROUPS - 1)) * _MAXBITS
        v = 0
        for j in range(int(b) - 1, -1, -1):
            v |= dec.decode_bit(probs, base + j) << j
        out[i] = v
    return out


# ---------------------------------------------------------------------------
# public symbol-stream API
# ---------------------------------------------------------------------------

def encode_symbols(vals: np.ndarray, nbits: np.ndarray,
                   group: np.ndarray) -> bytes:
    """Range-encode uint32 symbols; nbits/group per symbol."""
    vals = np.ascontiguousarray(vals, np.uint32)
    nbits = np.ascontiguousarray(nbits, np.uint8)
    group = np.ascontiguousarray(group, np.uint8)
    if nbits.size and int(nbits.max()) > 32:
        raise ValueError(f"symbol width {int(nbits.max())} > 32")
    lib = load_native()
    if lib is not None:
        cap = int(vals.size * 8 + 64)
        out = np.zeros(cap, np.uint8)
        n = lib.smoe_rc_encode(
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            nbits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            group.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            vals.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if n > 0:
            return out[:n].tobytes()
    return _py_encode(vals, nbits, group)


def decode_symbols(data: bytes, nbits: np.ndarray,
                   group: np.ndarray) -> np.ndarray:
    """Inverse of encode_symbols (needs the same nbits/group streams)."""
    nbits = np.ascontiguousarray(nbits, np.uint8)
    group = np.ascontiguousarray(group, np.uint8)
    if nbits.size and int(nbits.max()) > 32:
        # widths come from the (untrusted) file header; the coder models
        # 32 bit positions per group
        raise ValueError(f"corrupt bitstream: symbol width "
                         f"{int(nbits.max())} > 32")
    lib = load_native()
    if lib is not None:
        vals = np.zeros(nbits.size, np.uint32)
        buf = np.frombuffer(data, np.uint8)
        n = lib.smoe_rc_decode(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
            nbits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            group.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            nbits.size,
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        if n >= 0:
            return vals
    return _py_decode(data, nbits, group)


# ---------------------------------------------------------------------------
# container: qparams dict <-> file
# ---------------------------------------------------------------------------

_ORDER = ("A_diagonal", "A_corr", "musX", "nu_e", "pis", "gamma_e")
# version-3 stream order: musX FIRST so the decoder owns the kernel
# positions before any stream that predicts from spatial neighbors
# ("nbr" mode); version<=2 files keep the legacy _ORDER via the header
_ORDER_V3 = ("musX", "pis", "nu_e", "A_diagonal", "A_corr", "gamma_e")
_GROUP_BITS = {"A_diagonal": 0, "A_corr": 0, "musX": 1, "nu_e": 2,
               "pis": 3, "gamma_e": 4}
_BD_INDEX = {"A_diagonal": 0, "A_corr": 0, "musX": 1, "nu_e": 2,
             "pis": 3, "gamma_e": 4}


def _structural(name: str, arr: np.ndarray) -> np.ndarray:
    """Only the structurally meaningful entries of (K,d,d) steering factors:
    the diagonal of A_diagonal and the strict lower triangle of A_corr
    (the reference's reduced layout, smoe_reconstruction_decoded.py:36-39)."""
    if arr.ndim != 3 or name not in ("A_diagonal", "A_corr"):
        return arr.reshape(-1)
    d = arr.shape[1]
    if name == "A_diagonal":
        return np.diagonal(arr, axis1=1, axis2=2).reshape(-1)
    rows, cols = np.tril_indices(d, k=-1)
    return arr[:, rows, cols].reshape(-1)


def _unstructural(name: str, flat: np.ndarray, shape,
                  qzero: Optional[np.ndarray] = None) -> np.ndarray:
    """Scatter structural entries back; the structurally-zero entries are
    filled with the quantizer's representation of 0 (NOT integer 0) so the
    dequantized matrices are bit-identical to the non-bitstream path."""
    if len(shape) != 3 or name not in ("A_diagonal", "A_corr"):
        return flat.reshape(shape)
    k, d, _ = shape
    fill = np.zeros((1, d, d), flat.dtype) if qzero is None \
        else np.broadcast_to(qzero, (1, d, d)).astype(flat.dtype)
    out = np.tile(fill, (k, 1, 1))
    if name == "A_diagonal":
        v = flat.reshape(k, d)
        for i in range(d):
            out[:, i, i] = v[:, i]
    else:
        rows, cols = np.tril_indices(d, k=-1)
        out[:, rows, cols] = flat.reshape(k, len(rows))
    return out


def _structural_size(name: str, shape) -> int:
    if len(shape) != 3 or name not in ("A_diagonal", "A_corr"):
        return int(np.prod(shape))
    k, d, _ = shape
    return k * d if name == "A_diagonal" else k * (d * (d - 1) // 2)


def _zigzag(d: np.ndarray) -> np.ndarray:
    """Signed delta -> unsigned: 2d for d>=0, -2d-1 for d<0."""
    d = d.astype(np.int64)
    return np.where(d >= 0, 2 * d, -2 * d - 1).astype(np.uint32)


def _unzigzag(z: np.ndarray) -> np.ndarray:
    z = z.astype(np.int64)
    return np.where(z & 1, -((z + 1) >> 1), z >> 1)


def _delta_encode(v: np.ndarray, k: int) -> np.ndarray:
    """Per-component delta along the kernel axis (exact, invertible).

    v: flat uint32 stream of a (K, F) per-kernel array in row-major order.
    Kernels sit in raster grid order (core/init.py generate_kernel_grid),
    so consecutive kernels are spatial neighbors and musX/nu/A streams are
    strongly correlated — the inter-kernel prediction VERDICT r1 #5 names.
    """
    d = v.reshape(k, -1).astype(np.int64)
    d[1:] -= v.reshape(k, -1)[:-1].astype(np.int64)
    return _zigzag(d.reshape(-1))


def _delta_decode(z: np.ndarray, k: int) -> np.ndarray:
    d = _unzigzag(z).reshape(k, -1)
    return np.cumsum(d, axis=0, dtype=np.int64).reshape(-1).astype(np.uint32)


def _causal_nbr(mus_int: np.ndarray) -> np.ndarray:
    """Causal nearest-neighbor index per kernel from the DECODED quantized
    musX integers: nbr[i] = argmin_{j<i} ||mus_j - mus_i||^2 (exact int
    arithmetic, first-occurrence tie-break — deterministic on both sides).

    Spatially adjacent kernels share steering/expert statistics, and the
    true nearest decoded neighbor beats the raster-previous kernel once
    culling has punched holes in the grid (measured r3: A_diagonal
    residual magnitude estimate 4990 vs 5141 bits for raster-delta on the
    converged 256^2 fit).  nbr[0] = 0 (predict 0 for the first kernel).
    """
    m = mus_int.astype(np.int64)
    k = m.shape[0]
    idx = np.zeros(k, np.int64)
    for i in range(1, k):
        d2 = np.sum((m[:i] - m[i]) ** 2, axis=1)
        idx[i] = int(np.argmin(d2))
    return idx


def _nbr_encode(v: np.ndarray, k: int, nbr: np.ndarray) -> np.ndarray:
    comp = v.reshape(k, -1).astype(np.int64)
    res = comp.copy()
    res[1:] = comp[1:] - comp[nbr[1:]]
    return _zigzag(res.reshape(-1))


def _nbr_decode(z: np.ndarray, k: int, nbr: np.ndarray) -> np.ndarray:
    d = _unzigzag(z).reshape(k, -1)
    out = np.zeros_like(d)
    out[0] = d[0]
    for i in range(1, k):
        out[i] = d[i] + out[nbr[i]]
    return out.reshape(-1).astype(np.uint32)


# the native search's int64 squared distances over up to 4 axes stay exact
# while every axis spans less than this; wider inputs take the loop
_NBR_SPAN = 1 << 30


def causal_nbr(mus_int: np.ndarray) -> np.ndarray:
    """`_causal_nbr`'s indices, from the native grid search where it
    applies (2-D input of 1 to 4 axes, each spanning under 2^30, and a
    built library), else from the loop."""
    m = np.asarray(mus_int)
    if m.ndim == 2 and m.shape[0] > 1 and 1 <= m.shape[1] <= 4:
        m = np.ascontiguousarray(m.astype(np.int64))
        span = [int(hi) - int(lo) for lo, hi in zip(m.min(0), m.max(0))]
        lib = _load_nbr() if max(span) < _NBR_SPAN else None
        if lib is not None:
            idx = np.empty(m.shape[0], np.int64)
            i64p = ctypes.POINTER(ctypes.c_int64)
            if lib.smoe_causal_nbr(m.ctypes.data_as(i64p), m.shape[0],
                                   m.shape[1], idx.ctypes.data_as(i64p)) == 0:
                return idx
    return _causal_nbr(mus_int)


def nbr_decode(z: np.ndarray, k: int, nbr: np.ndarray) -> np.ndarray:
    """`_nbr_decode`'s output, from the native recurrence where every
    `nbr[i]` (i >= 1) points to an earlier row and the library is built,
    else from the loop."""
    nb = np.ascontiguousarray(nbr, np.int64)
    lib = _load_nbr()
    if (lib is not None and k >= 1 and nb.shape == (k,) and z.size % k == 0
            and np.all((nb[1:] >= 0) & (nb[1:] < np.arange(1, k)))):
        d = np.ascontiguousarray(_unzigzag(z).reshape(k, -1))
        out = np.empty_like(d)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.smoe_nbr_decode(d.ctypes.data_as(i64p), k, d.shape[1],
                            nb.ctypes.data_as(i64p),
                            out.ctypes.data_as(i64p))
        return out.reshape(-1).astype(np.uint32)
    return _nbr_decode(z, k, nbr)


def _est_bits(v: np.ndarray) -> float:
    """Cheap magnitude-entropy estimate to pick the coding mode per param."""
    return float(np.sum(np.ceil(np.log2(v.astype(np.float64) + 2.0))))


def _musx_grid_pred(kernels_per_dim, d: int, lb: np.ndarray, ub: np.ndarray,
                    step: int, used: np.ndarray) -> np.ndarray:
    """Quantized-integer prediction of musX from the init kernel grid.

    Both sides compute this from header fields only (kernels_per_dim,
    bounds, steps, used_kernels), so the residual coding is exactly
    invertible.  Slots beyond the grid (inc/video spares) predict 0.
    """
    from smoe_tpu_torch.core.init import kernel_centers
    grid = kernel_centers(kernels_per_dim, d)      # (G, d) float32
    idx = np.flatnonzero(np.asarray(used, bool))
    pred = np.zeros((idx.size, d), np.float64)
    ok = idx < grid.shape[0]
    pred[ok] = grid[idx[ok]]
    p = np.round((pred - lb) / (ub - lb + _RANGE_EPS()) * step)
    return np.clip(p, 0, step).astype(np.int64).reshape(-1)


def _RANGE_EPS():
    from smoe_tpu_torch.codec.quantize import RANGE_EPS
    return RANGE_EPS


def _symbol_stream(qparams: Dict, bit_depths,
                   num_kernels: int, cfg=None) -> Tuple[np.ndarray, ...]:
    """Returns (vals, nbits, group, modes).

    Per-kernel streams are inter-kernel predicted when the magnitude
    estimate says the residuals are cheaper, per param:
      "raw"      b-bit absolute integers
      "delta"    per-component deltas along the (raster-ordered) kernel axis
      "grid"     musX only: residual against the init-grid prediction the
                 decoder can recompute from the header
      "nbr"      residual against the causally-nearest kernel by DECODED
                 musX (musX is coded first, _ORDER_V3, so both sides own
                 the positions; _causal_nbr) — the steering-matrix
                 spatial prediction of VERDICT r2 #3
      "const:N"  residual against the stored per-param median N (quantized
                 values cluster mid-range because the bounds are
                 data-derived, so the MSBs of raw coding are maximally
                 uncertain — e.g. gamma_e concentrates at quantized 0.0)
    Residuals are zigzag-mapped (one extra magnitude bit); the mode per
    param goes into the header so decode is exact either way.

    Values outside [0, 2^b) are possible under fixed-bound quantization
    (QM2): the reference quantizer never clips (quantizer.py:58-77), so
    clipping here would decode differently from the in-memory qparams.
    Such streams are shifted by their minimum and coded at a widened
    width, recorded in the `ranges` header entry (absent = in-range).
    """
    vals, nbits, group, modes = [], [], [], {}
    ranges = {}
    mus_nbr = None            # causal-NN indices once musX is coded
    for name in _ORDER_V3:
        if name not in qparams:
            continue
        v = _structural(name, np.asarray(qparams[name]))
        b = int(bit_depths[_BD_INDEX[name]])
        v64 = np.round(v).astype(np.int64)
        if (name == "musX" and num_kernels > 1 and v.size
                and v.size % num_kernels == 0):
            mus_nbr = causal_nbr(v64.reshape(num_kernels, -1))
        lo = int(min(v64.min(), 0)) if v.size else 0
        hi = int(max(v64.max(), 0)) if v.size else 0
        if lo < 0 or hi >= (1 << b):
            b = max(int(hi - lo).bit_length(), 1)
            ranges[name] = [lo, b]
            v64 = v64 - lo
        if b > 32:
            raise ValueError(
                f"{name}: quantized values span {b} bits; the coder "
                f"models at most 32")
        v = v64.astype(np.uint32)
        cands = {"raw": (v, b)}
        zz_ok = b + 1 <= 32     # zigzag modes cost one extra magnitude bit
        if v.size and zz_ok:
            med = int(np.median(v))
            cands[f"const:{med}"] = (
                _zigzag(v.astype(np.int64) - med), b + 1)
        if num_kernels > 1 and v.size % num_kernels == 0 and v.size \
                and zz_ok:
            cands["delta"] = (_delta_encode(v, num_kernels), b + 1)
            if mus_nbr is not None and name != "musX":
                cands["nbr"] = (_nbr_encode(v, num_kernels, mus_nbr), b + 1)
        if name == "musX" and cfg is not None and v.size and zz_ok:
            pred = _musx_grid_pred(
                cfg.kernels_per_dim, cfg.dim_domain,
                np.asarray(qparams["lower_bounds"]["musX"]),
                np.asarray(qparams["upper_bounds"]["musX"]),
                int(qparams["steps"]["musX"]), qparams["used_kernels"])
            if pred.size == v.size:
                cands["grid"] = (_zigzag(v.astype(np.int64) - pred), b + 1)
        # Drop any candidate whose coded values overflow its declared
        # width — the range coder silently truncates high bits, which
        # would decode to wrong values with no error.  Reachable via
        # "grid" on a ranges-shifted stream (ADVICE r2): v is coded in
        # the shifted domain but the grid prediction lives in the
        # original 0..steps domain, so residuals can exceed b+1 bits
        # when the shifted width is narrow.  "raw" always fits by
        # construction, so the filtered set is never empty.
        def _fits(m):
            vv, bb = cands[m]
            return (not vv.size) or int(vv.max()).bit_length() <= bb
        mode = min((m for m in cands if _fits(m)),
                   key=lambda m: _est_bits(cands[m][0]))
        v, b = cands[mode]
        modes[name] = mode
        vals.append(v)
        nbits.append(np.full(v.size, b, np.uint8))
        group.append(np.full(v.size, _GROUP_BITS[name], np.uint8))
    return (np.concatenate(vals), np.concatenate(nbits),
            np.concatenate(group), modes, ranges)


def rate_breakdown(qparams: Dict, cfg) -> Dict[str, Dict]:
    """Per-param coded-bits attribution (diagnostic, not a file format).

    Encodes each param's symbol stream with a FRESH coder so its cost is
    attributable (slightly pessimistic vs the shared-context file: the
    adaptive contexts re-learn per stream).  Returns
    {name: {bits, raw_bits, mode, symbols}} plus a "_total" row.
    """
    bd = list(cfg.bit_depths)
    num_kernels = int(np.count_nonzero(
        np.asarray(qparams["used_kernels"], bool)))
    vals, nbits, group, modes, _ = _symbol_stream(
        qparams, bd, num_kernels, cfg=cfg)
    out: Dict[str, Dict] = {}
    off = 0
    tot = tot_raw = 0
    for name in _ORDER_V3:
        if name not in qparams:
            continue
        n = _structural_size(name, np.asarray(qparams[name]).shape)
        payload = encode_symbols(vals[off:off + n], nbits[off:off + n],
                                 group[off:off + n])
        raw = int(bd[_BD_INDEX[name]]) * n
        out[name] = {"bits": len(payload) * 8, "raw_bits": raw,
                     "mode": modes.get(name, "raw"), "symbols": int(n),
                     "coded_width": int(nbits[off])}
        tot += len(payload) * 8
        tot_raw += raw
        off += n
    out["_total"] = {"bits": tot, "raw_bits": tot_raw}
    return out


def kernel_importance(qparams: Dict, cfg, mode: str = "mass",
                      musX_grid: Optional[np.ndarray] = None,
                      model_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-kernel importance from the quantized params alone.

    mode="mass" (default): each kernel's ACTUAL share of the gating
    mass, measured by evaluating the decoder's own gating (dequantized
    params, same maha/floor semantics as core/model.gating) on a coarse
    uniform grid over [0,1]^d (~64k points).  This is never degenerate:
    two kernels with equal pi still differ by spatial footprint, so the
    layered-bitstream tier ordering (write_bitstream layers=) tracks
    what each kernel contributes to the picture.  Falls back to the
    analytic mode on any failure.

    mode="analytic": pi_k times the closed-form integral of the
    unnormalized responsibility — constant with the determinant
    normalizer (importance ~ pi_k, DEGENERATE when pis quantize equal),
    (2pi)^{d/2}/|prod diag(A_k)| without it.

    musX_grid: initial grid centers of the used kernels, required for
    mode="mass" when cfg.use_diff_center (same as codec.quantize.rescaler).
    model_mask: (reduced rows,) bool for dual-model video — True rows
    gate on the motion-transformed domain whose time coordinate is the
    constant TIME_PLANE (video/motion.py), so their mass is measured on
    that plane (identity-warp approximation of the spatial coords).
    """
    if mode == "mass":
        try:
            return _gating_mass(qparams, cfg, musX_grid, model_mask)
        except Exception as e:
            import warnings
            warnings.warn(
                f"kernel_importance: gating-mass mode failed ({e!r}); "
                "falling back to the analytic pi-based ordering, which "
                "ties (raster-order tiers) when pis quantize equal",
                RuntimeWarning)
    st = qparams["steps"]
    lo, up = qparams["lower_bounds"], qparams["upper_bounds"]

    def deq(name, skey):
        return (np.asarray(qparams[name], np.float64) / st[skey]
                * (np.asarray(up[name], np.float64)
                   - np.asarray(lo[name], np.float64))
                + np.asarray(lo[name], np.float64))

    imp = np.abs(deq("pis", "pis").reshape(-1))
    if not getattr(cfg, "use_determinant", True):
        ad = deq("A_diagonal", "A")
        if ad.ndim == 3:
            ad = np.diagonal(ad, axis1=1, axis2=2)
        vol = np.prod(np.maximum(np.abs(ad.reshape(imp.size, -1)), 1e-6),
                      axis=1)
        imp = imp / vol
    return imp


def _gating_mass(qparams: Dict, cfg,
                 musX_grid: Optional[np.ndarray],
                 model_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """sum_x w_k(x) over a coarse uniform grid of the [0,1]^d domain,
    with the decode-exact dequantized params (codec.quantize.rescaler)
    and the model's gating semantics (core/model.py: maha = y^T B y with
    B = A A^T — or the symmetrized lower-tri when train_inverse_cov —
    numerator exp(-0.5 maha) [* prod|diag A|/sqrt((2pi)^d)] * pi,
    denominator floored at 1e-11, reference smoe.py:791-823).

    Dual-model video (model_mask): True rows gate on the transformed
    domain, whose time coordinate is the constant TIME_PLANE — their
    maha is evaluated at sample points with t -> TIME_PLANE (spatial
    warp approximated by identity; good enough for an ordering), so
    motion-compensated kernels compete on their own plane instead of
    underflowing to zero mass against the raw [0,1] time range."""
    from smoe_tpu_torch.codec.quantize import rescaler

    rp = rescaler(qparams, cfg, musX_grid=musX_grid)
    mus = np.asarray(rp["musX"], np.float64)
    a = np.asarray(rp["A"], np.float64)
    pis = np.abs(np.asarray(rp["pis"], np.float64).reshape(-1))
    k, d = mus.shape
    if getattr(cfg, "train_inverse_cov", False):
        low = np.tril(a)
        b = low + np.transpose(np.tril(a, -1), (0, 2, 1))
    else:
        low = np.tril(a)
        b = low @ np.transpose(low, (0, 2, 1))
    # quadratic-feature form: maha[n,k] = phi(x_n) . q_k  (model.py:12-18)
    bm = np.einsum("kij,kj->ki", b, mus)
    q = np.concatenate(
        [b.reshape(k, d * d), -2.0 * bm,
         np.einsum("ki,ki->k", mus, bm)[:, None]], axis=1)
    num_scale = pis.copy()
    if getattr(cfg, "use_determinant", True):
        diag = np.abs(np.diagonal(low, axis1=1, axis2=2))
        num_scale = num_scale * diag.prod(1) / np.sqrt((2 * np.pi) ** d)
    n_per = max(4, int(round(65536 ** (1.0 / d))))
    axes = np.linspace(0.0, 1.0, n_per)
    pts = np.stack(np.meshgrid(*([axes] * d), indexing="ij"),
                   -1).reshape(-1, d)
    mm = None
    if model_mask is not None and np.any(model_mask):
        mm = np.asarray(model_mask, bool).reshape(-1)
        if mm.size != k:
            raise ValueError(f"model_mask has {mm.size} rows for {k}")

    def _phi(x):
        return np.concatenate(
            [np.einsum("ni,nj->nij", x, x).reshape(x.shape[0], d * d),
             x, np.ones((x.shape[0], 1))], axis=1)

    mass = np.zeros(k)
    for off in range(0, pts.shape[0], 8192):
        x = pts[off:off + 8192]
        maha = _phi(x) @ q.T
        if mm is not None:
            from smoe_tpu_torch.video.motion import TIME_PLANE
            xt = x.copy()
            xt[:, -1] = TIME_PLANE
            maha = np.where(mm[None, :], _phi(xt) @ q.T, maha)
        maha = np.maximum(maha, 0.0)
        num = np.exp(-0.5 * np.minimum(maha, 1400.0)) * num_scale
        w = num / np.maximum(num.sum(1, keepdims=True), 1e-11)
        mass += w.sum(0)
    return mass


def _bit_reversed_rank(n: int) -> np.ndarray:
    """Van der Corput (base-2 radical-inverse) value of each index
    0..n-1 — a deterministic stratified ordering over the raster."""
    v = np.zeros(n)
    idx = np.arange(n, dtype=np.int64)
    f = 0.5
    while idx.any():
        v += (idx & 1) * f
        idx >>= 1
        f *= 0.5
    return v


def _layer_rows(k: int, layers, importance: np.ndarray):
    """Partition the k reduced kernels into importance tiers.

    layers: int L (near-equal kernel counts) or an explicit list of
    per-layer counts summing to k.  Returns a list of row-index arrays,
    each sorted ascending (raster order within the layer) so the
    within-layer inter-kernel predictors see spatially-ordered kernels.
    """
    if isinstance(layers, (int, np.integer)):
        n = max(1, min(int(layers), k))
        base, rem = divmod(k, n)
        counts = [base + (1 if i < rem else 0) for i in range(n)]
    else:
        counts = [int(c) for c in layers]
        if not (all(c > 0 for c in counts) and sum(counts) == k):
            raise ValueError(
                f"layer counts {counts} must be positive and sum to {k}")
    # Ties break by bit-reversed (van der Corput) rank, not raster order:
    # equal-importance kernels then stratify across the raster instead of
    # carving the image into per-tier spatial wedges.
    order = np.lexsort((_bit_reversed_rank(k),
                        -np.asarray(importance, np.float64)))
    out, off = [], 0
    for c in counts:
        out.append(np.sort(order[off:off + c]))
        off += c
    return out


def write_bitstream(path: str, qparams: Dict, cfg,
                    extra: Optional[Dict] = None,
                    layers=None, importance: Optional[np.ndarray] = None
                    ) -> int:
    """Serialize quantized params as an entropy-coded file.

    extra: JSON-serializable fields merged into the header (image shape,
    flags) so the decode CLI needs nothing else.
    layers (beyond the reference): write an SNR-scalable LAYERED stream
    (container v4) — kernels are importance-ordered and split into
    tiers, each tier an independently range-coded payload segment with
    its own slot bitmap, coding modes and CRC.  A decoder can stop
    after any tier prefix (read_bitstream max_layers= /
    decode_bitstream layers=) and still reconstruct a valid SMoE model
    (gating renormalizes over the kernels present), so one file serves
    multiple quality levels and a truncated transmission decodes to the
    tiers fully received.  int L = near-equal split; list = per-layer
    kernel counts.
    importance: per-kernel sort keys (higher = earlier layer),
    e.g. a measured gating mass; default kernel_importance().
    Returns the payload size in bits (the real rate; compare against
    codec.quantize.rate_bits' raw proxy).
    """
    if layers is not None:
        return _write_layered(path, qparams, cfg, extra, layers, importance)
    bd = list(cfg.bit_depths)
    shapes = {n: list(np.asarray(qparams[n]).shape)
              for n in _ORDER if n in qparams}
    dtypes = {n: str(np.asarray(qparams[n]).dtype)
              for n in _ORDER if n in qparams}
    num_kernels = int(np.count_nonzero(
        np.asarray(qparams["used_kernels"], bool)))
    vals, nbits, group, modes, ranges = _symbol_stream(
        qparams, bd, num_kernels, cfg=cfg)
    header = {
        "version": 3,
        "order": list(_ORDER_V3),
        "modes": modes,
        **({"ranges": ranges} if ranges else {}),
        "num_kernels": num_kernels,
        "dim_domain": cfg.dim_domain,
        "radial_as": bool(cfg.radial_as),
        "use_diff_center": bool(cfg.use_diff_center),
        "nu_anchor": bool(qparams.get("nu_anchor", False)),
        **({"gamma_anchor": True,
            "gamma_anchor_eps": float(qparams.get("gamma_anchor_eps", 1.0))}
           if qparams.get("gamma_anchor", False) else {}),
        "train_inverse_cov": bool(cfg.train_inverse_cov),
        "kernels_per_dim": list(cfg.kernels_per_dim),
        "precision": cfg.precision,
        "bit_depths": bd,
        "shapes": shapes,
        "dtypes": dtypes,
        "steps": {k: int(v) for k, v in qparams["steps"].items()},
        "lower_bounds": {k: [np.asarray(v).tolist(),
                             str(np.asarray(v).dtype)]
                         for k, v in qparams["lower_bounds"].items()},
        "upper_bounds": {k: [np.asarray(v).tolist(),
                             str(np.asarray(v).dtype)]
                         for k, v in qparams["upper_bounds"].items()},
        "used_kernels": np.packbits(
            np.asarray(qparams["used_kernels"], bool)).tolist(),
        "num_slots": int(np.asarray(qparams["used_kernels"]).size),
    }
    if extra:
        header.update(extra)
    payload = encode_symbols(vals, nbits, group)
    # payload integrity: a flipped bit in an adaptive range-coded stream
    # silently corrupts EVERYTHING after it (the model contexts diverge),
    # so decoders need a cheap way to tell "corrupt file" from "bad
    # model".  Old readers ignore the extra header field.
    header["payload_crc32"] = zlib.crc32(payload) & 0xFFFFFFFF
    # Header bytes count against the real rate too: a CIF dual-model
    # video header is ~10 KB of JSON (model_mask + used_kernels +
    # per-group bounds), 13-17% of the file.  zlib level 9 takes it to
    # ~1.2 KB.  Old readers are unaffected: JSON starts with '{' (0x7b),
    # a zlib stream with 0x78 — read_bitstream dispatches on that byte.
    hjson = zlib.compress(json.dumps(header).encode("utf-8"), 9)
    with open(path, "wb") as fd:
        fd.write(MAGIC)
        fd.write(struct.pack("<I", len(hjson)))
        fd.write(hjson)
        fd.write(payload)
    return len(payload) * 8


def _grid_of_used(qparams: Dict, cfg) -> Optional[np.ndarray]:
    """Init-grid centers of the used slots (zeros for slots past the
    grid — inc insertions / video spares carry full centers), as the
    diff-center rescaler needs.  None when cfg stores full centers.
    Same convention as codec/serve.decode_bitstream."""
    if not getattr(cfg, "use_diff_center", False):
        return None
    from smoe_tpu_torch.core.init import generate_kernel_grid

    g, _ = generate_kernel_grid(cfg)
    g = np.asarray(g)
    idx = np.flatnonzero(np.asarray(qparams["used_kernels"], bool))
    grid = np.zeros((idx.size, g.shape[1]), np.float64)
    in_grid = idx < g.shape[0]
    grid[in_grid] = g[idx[in_grid]]
    return grid


def _write_layered(path: str, qparams: Dict, cfg, extra, layers,
                   importance) -> int:
    """Layered (v4) writer — see write_bitstream(layers=)."""
    bd = list(cfg.bit_depths)
    used = np.asarray(qparams["used_kernels"], bool).reshape(-1)
    slot_of_row = np.flatnonzero(used)
    k = int(slot_of_row.size)
    shapes = {n: list(np.asarray(qparams[n]).shape)
              for n in _ORDER if n in qparams}
    dtypes = {n: str(np.asarray(qparams[n]).dtype)
              for n in _ORDER if n in qparams}
    names = [n for n in _ORDER_V3 if n in qparams]
    for n in names:
        sz = _structural_size(n, shapes[n])
        if not (k and sz % k == 0 and np.asarray(qparams[n]).shape[0] == k):
            raise ValueError(
                f"layered bitstreams need per-kernel streams; {n} has "
                f"{sz} symbols for {k} kernels")
    imp = (np.asarray(importance, np.float64) if importance is not None
           else kernel_importance(
               qparams, cfg, musX_grid=_grid_of_used(qparams, cfg),
               model_mask=None if extra is None
               else extra.get("model_mask")))
    if imp.shape != (k,):
        raise ValueError(f"importance shape {imp.shape} != ({k},)")
    parts = _layer_rows(k, layers, imp)
    payloads, lheaders = [], []
    for rows in parts:
        lmask = np.zeros(used.size, bool)
        lmask[slot_of_row[rows]] = True
        sub = {"steps": qparams["steps"],
               "lower_bounds": qparams["lower_bounds"],
               "upper_bounds": qparams["upper_bounds"],
               "used_kernels": lmask}
        for n in names:
            sub[n] = np.asarray(qparams[n])[rows]
        vals, nbits, group, modes, ranges = _symbol_stream(
            sub, bd, int(rows.size), cfg=cfg)
        pay = encode_symbols(vals, nbits, group)
        payloads.append(pay)
        lh = {"kernels": np.packbits(lmask).tolist(),
              "num_kernels": int(rows.size),
              "bytes": len(pay),
              "crc32": zlib.crc32(pay) & 0xFFFFFFFF,
              "modes": modes}
        if ranges:
            lh["ranges"] = ranges
        lheaders.append(lh)
    header = {
        "version": 4,
        "order": list(_ORDER_V3),
        "layers": lheaders,
        "num_kernels": k,
        "dim_domain": cfg.dim_domain,
        "radial_as": bool(cfg.radial_as),
        "use_diff_center": bool(cfg.use_diff_center),
        "nu_anchor": bool(qparams.get("nu_anchor", False)),
        **({"gamma_anchor": True,
            "gamma_anchor_eps": float(qparams.get("gamma_anchor_eps", 1.0))}
           if qparams.get("gamma_anchor", False) else {}),
        "train_inverse_cov": bool(cfg.train_inverse_cov),
        "kernels_per_dim": list(cfg.kernels_per_dim),
        "precision": cfg.precision,
        "bit_depths": bd,
        "shapes": shapes,
        "dtypes": dtypes,
        "steps": {kk: int(v) for kk, v in qparams["steps"].items()},
        "lower_bounds": {kk: [np.asarray(v).tolist(),
                              str(np.asarray(v).dtype)]
                         for kk, v in qparams["lower_bounds"].items()},
        "upper_bounds": {kk: [np.asarray(v).tolist(),
                              str(np.asarray(v).dtype)]
                         for kk, v in qparams["upper_bounds"].items()},
        "used_kernels": np.packbits(used).tolist(),
        "num_slots": int(used.size),
    }
    if extra:
        header.update(extra)
    payload = b"".join(payloads)
    header["payload_crc32"] = zlib.crc32(payload) & 0xFFFFFFFF
    hjson = zlib.compress(json.dumps(header).encode("utf-8"), 9)
    with open(path, "wb") as fd:
        fd.write(MAGIC)
        fd.write(struct.pack("<I", len(hjson)))
        fd.write(hjson)
        fd.write(payload)
    return len(payload) * 8


def read_header(path: str) -> Dict:
    """Parse only the container header — no entropy decode, no payload
    read.  Cheap metadata access for serving decisions (tier table,
    shapes, flags) on files whose payload may be large or truncated."""
    with open(path, "rb") as fd:
        head = fd.read(8)
        assert head[:4] == MAGIC, "not an SMoE bitstream"
        hlen = struct.unpack("<I", head[4:8])[0]
        hraw = fd.read(hlen)
    if hraw[:1] != b"{":        # zlib-compressed header (files from v3.1+)
        hraw = zlib.decompress(hraw)
    return json.loads(hraw.decode("utf-8"))


def layers_for_budget(path: str, max_bytes: int) -> int:
    """Largest tier count m of a layered (v4) file such that the
    container header plus tiers 1..m fits in max_bytes — the
    encode-once / serve-any-rate decision a progressive transmission or
    a byte-budgeted cache makes.  Raises if even the base tier does not
    fit (an adaptive range-coded tier cannot be partially decoded)."""
    header = read_header(path)
    if "layers" not in header:
        raise ValueError(
            "max_bytes= needs a layered (v4) bitstream; this file was "
            "written without layers")
    per = [int(lh["bytes"]) for lh in header["layers"]]
    # container prefix = MAGIC(4) + u32 len(4) + header bytes — computed
    # from the length field, NOT from getsize minus declared tiers, so a
    # TRUNCATED file (the very case byte-budget serving exists for)
    # still yields the right prefix size
    with open(path, "rb") as fd:
        fixed = 8 + struct.unpack("<I", fd.read(8)[4:8])[0]
    avail = os.path.getsize(path) - fixed     # payload bytes actually here
    budget = int(max_bytes) - fixed
    if per[0] > budget or per[0] > avail:
        raise ValueError(
            f"byte budget {int(max_bytes)} cannot carry the base tier "
            f"(header + tier 1 = {fixed + per[0]} bytes"
            + ("" if per[0] <= avail else "; file truncated inside tier 1")
            + ")")
    cum, m = 0, 0
    for b in per:
        if cum + b > budget or cum + b > avail:
            break
        cum += b
        m += 1
    return m


def read_bitstream(path: str, max_layers: Optional[int] = None
                   ) -> Tuple[Dict, Dict]:
    """Read back (qparams dict, header dict).

    max_layers: for layered (v4) files, decode only the first m tiers —
    the returned qparams hold that kernel subset (rows in raster slot
    order, used_kernels/model_mask/shapes rewritten consistently), so
    every downstream consumer (rescaler, serve, CLIs) works unchanged.
    A FULL layered decode is bit-identical to the same model written
    without layers.  None = all layers (and on v<4 files the only valid
    value).
    """
    with open(path, "rb") as fd:
        data = fd.read()
    assert data[:4] == MAGIC, "not an SMoE bitstream"
    hlen = struct.unpack("<I", data[4:8])[0]
    hraw = data[8:8 + hlen]
    if hraw[:1] != b"{":        # zlib-compressed header (files from v3.1+)
        hraw = zlib.decompress(hraw)
    header = json.loads(hraw.decode("utf-8"))
    payload = data[8 + hlen:]
    if "layers" in header:
        return _read_layered(header, payload, max_layers)
    if max_layers is not None:
        raise ValueError(
            "max_layers= needs a layered (v4) bitstream; this file was "
            "written without layers")
    want_crc = header.get("payload_crc32")      # absent in pre-3.2 files
    if want_crc is not None and (zlib.crc32(payload) & 0xFFFFFFFF) \
            != want_crc:
        raise ValueError(
            "corrupt bitstream: payload CRC mismatch (truncated or "
            "bit-flipped file — adaptive range-coded payloads cannot "
            "be partially decoded)")

    bd = header["bit_depths"]
    shapes = header["shapes"]
    modes = header.get("modes", {})             # absent in version-1 files
    ranges = header.get("ranges", {})           # out-of-range QM2 streams
    num_kernels = int(header.get("num_kernels", 0))
    order = tuple(header.get("order", _ORDER))  # v<=2 files: legacy order
    nbits, group = [], []
    for name in order:
        if name not in shapes:
            continue
        n = _structural_size(name, shapes[name])
        base = ranges[name][1] if name in ranges else bd[_BD_INDEX[name]]
        b = int(base) + (1 if modes.get(name, "raw") != "raw" else 0)
        if not 0 < b <= 32:
            # validate the PYTHON int: a uint8 cast would wrap widths
            # >= 256 (e.g. a corrupt 288 -> 32) past the coder's guard
            raise ValueError(
                f"corrupt bitstream: {name} symbol width {b} not in 1..32")
        nbits.append(np.full(n, b, np.uint8))
        group.append(np.full(n, _GROUP_BITS[name], np.uint8))
    nbits = np.concatenate(nbits)
    group = np.concatenate(group)
    vals = decode_symbols(payload, nbits, group)

    qparams: Dict = {
        "steps": header["steps"],
        "lower_bounds": {k: np.asarray(v, np.dtype(dt))
                         for k, (v, dt) in header["lower_bounds"].items()},
        "upper_bounds": {k: np.asarray(v, np.dtype(dt))
                         for k, (v, dt) in header["upper_bounds"].items()},
        "used_kernels": np.unpackbits(
            np.asarray(header["used_kernels"], np.uint8),
            count=header["num_slots"]).astype(bool),
    }
    if header.get("nu_anchor"):
        qparams["nu_anchor"] = True     # rescaler inverts the center anchor
    if header.get("gamma_anchor"):
        qparams["gamma_anchor"] = True  # rescaler un-whitens the slopes
        qparams["gamma_anchor_eps"] = float(header.get("gamma_anchor_eps",
                                                       1.0))
    off = 0
    mus_nbr = None
    for name in order:
        if name not in shapes:
            continue
        n = _structural_size(name, shapes[name])
        dt = np.dtype(header.get("dtypes", {}).get(name, "float64"))
        raw = vals[off:off + n]
        mode = modes.get(name, "raw")
        if mode == "delta":
            raw = _delta_decode(raw, num_kernels)
        elif mode == "nbr":
            if mus_nbr is None:
                raise ValueError(
                    "corrupt bitstream: 'nbr' mode before musX decoded")
            with span("smoe.decode.neighbours"):
                raw = nbr_decode(raw, num_kernels, mus_nbr)
        elif mode.startswith("const:"):
            raw = (_unzigzag(raw) + int(mode[6:])).astype(np.uint32)
        elif mode == "grid":
            pred = _musx_grid_pred(
                header["kernels_per_dim"], header["dim_domain"],
                qparams["lower_bounds"]["musX"],
                qparams["upper_bounds"]["musX"],
                int(qparams["steps"]["musX"]), qparams["used_kernels"])
            raw = (_unzigzag(raw) + pred).astype(np.uint32)
        if name in ranges:      # undo the out-of-range shift (signed ints)
            raw = raw.astype(np.int64) + int(ranges[name][0])
        if (name == "musX" and num_kernels > 1 and n
                and n % num_kernels == 0):
            # same causal-NN graph the encoder built (original-domain ints)
            with span("smoe.decode.neighbours"):
                mus_nbr = causal_nbr(
                    np.asarray(raw, np.int64).reshape(num_kernels, -1))
        qzero = None
        if name in ("A_diagonal", "A_corr") and len(shapes[name]) == 3:
            from smoe_tpu_torch.codec.quantize import RANGE_EPS
            lb = qparams["lower_bounds"][name]
            ub = qparams["upper_bounds"][name]
            qzero = np.round((0.0 - lb) / (ub - lb + RANGE_EPS)
                             * header["steps"]["A"])
        qparams[name] = _unstructural(name, raw.astype(dt),
                                      shapes[name], qzero)
        off += n
    return qparams, header


def _read_layered(header: Dict, payload: bytes,
                  max_layers: Optional[int]) -> Tuple[Dict, Dict]:
    """Layered (v4) reader — see read_bitstream(max_layers=).

    Each tier decodes independently (own coder, own slot bitmap, own
    prediction context); decoded rows are then permuted back to raster
    slot order, so a full decode returns EXACTLY what the non-layered
    path would and a prefix decode returns a self-consistent sub-model.
    """
    lheaders = header["layers"]
    n_layers = len(lheaders)
    m = n_layers if max_layers is None \
        else max(1, min(int(max_layers), n_layers))
    bd = header["bit_depths"]
    shapes = header["shapes"]
    order = tuple(header.get("order", _ORDER_V3))
    names = [n for n in order if n in shapes]
    k_full = int(header["num_kernels"])
    num_slots = int(header["num_slots"])
    comps = {}
    for n in names:
        sz = _structural_size(n, shapes[n])
        if not (k_full and sz % k_full == 0):
            raise ValueError(f"corrupt bitstream: {n} has {sz} symbols "
                             f"for {k_full} kernels")
        comps[n] = sz // k_full
    if max_layers is None:
        want = header.get("payload_crc32")
        if want is not None and (zlib.crc32(payload) & 0xFFFFFFFF) != want:
            raise ValueError(
                "corrupt bitstream: payload CRC mismatch (truncated or "
                "bit-flipped file); pass max_layers= to decode the "
                "intact tier prefix of a truncated transmission")

    lower = {kk: np.asarray(v, np.dtype(dt))
             for kk, (v, dt) in header["lower_bounds"].items()}
    upper = {kk: np.asarray(v, np.dtype(dt))
             for kk, (v, dt) in header["upper_bounds"].items()}
    chunks = {n: [] for n in names}     # per-layer (k_i, comps) int64 rows
    slots_parts = []
    off_bytes = 0
    for li in range(m):
        lh = lheaders[li]
        nbytes = int(lh["bytes"])
        pay = payload[off_bytes:off_bytes + nbytes]
        off_bytes += nbytes
        if len(pay) != nbytes or \
                (zlib.crc32(pay) & 0xFFFFFFFF) != int(lh["crc32"]):
            raise ValueError(
                f"corrupt bitstream: layer {li} truncated or CRC "
                f"mismatch (intact prefix: max_layers={li})")
        ki = int(lh["num_kernels"])
        modes = lh.get("modes", {})
        ranges = lh.get("ranges", {})
        lmask = np.unpackbits(np.asarray(lh["kernels"], np.uint8),
                              count=num_slots).astype(bool)
        lslots = np.flatnonzero(lmask)
        if lslots.size != ki:
            raise ValueError(f"corrupt bitstream: layer {li} bitmap has "
                             f"{lslots.size} slots for {ki} kernels")
        slots_parts.append(lslots)
        nbits, group = [], []
        for n in names:
            base = ranges[n][1] if n in ranges else bd[_BD_INDEX[n]]
            b = int(base) + (1 if modes.get(n, "raw") != "raw" else 0)
            if not 0 < b <= 32:
                raise ValueError(f"corrupt bitstream: layer {li} {n} "
                                 f"symbol width {b} not in 1..32")
            nbits.append(np.full(ki * comps[n], b, np.uint8))
            group.append(np.full(ki * comps[n], _GROUP_BITS[n], np.uint8))
        vals = decode_symbols(pay, np.concatenate(nbits),
                              np.concatenate(group))
        off = 0
        mus_nbr = None
        for n in names:
            nsym = ki * comps[n]
            raw = vals[off:off + nsym]
            off += nsym
            mode = modes.get(n, "raw")
            if mode == "delta":
                raw = _delta_decode(raw, ki)
            elif mode == "nbr":
                if mus_nbr is None:
                    raise ValueError("corrupt bitstream: 'nbr' mode "
                                     "before musX decoded")
                with span("smoe.decode.neighbours"):
                    raw = nbr_decode(raw, ki, mus_nbr)
            elif mode.startswith("const:"):
                raw = (_unzigzag(raw) + int(mode[6:])).astype(np.uint32)
            elif mode == "grid":
                pred = _musx_grid_pred(
                    header["kernels_per_dim"], header["dim_domain"],
                    lower["musX"], upper["musX"],
                    int(header["steps"]["musX"]), lmask)
                raw = (_unzigzag(raw) + pred).astype(np.uint32)
            if n in ranges:
                raw = raw.astype(np.int64) + int(ranges[n][0])
            if n == "musX" and ki > 1:
                with span("smoe.decode.neighbours"):
                    mus_nbr = causal_nbr(
                        np.asarray(raw, np.int64).reshape(ki, -1))
            chunks[n].append(np.asarray(raw, np.int64).reshape(ki, -1))

    slots = np.concatenate(slots_parts)
    perm = np.argsort(slots, kind="stable")
    k_dec = int(slots.size)
    used_dec = np.zeros(num_slots, bool)
    used_dec[slots] = True
    qparams: Dict = {
        "steps": header["steps"],
        "lower_bounds": lower,
        "upper_bounds": upper,
        "used_kernels": used_dec,
    }
    if header.get("nu_anchor"):
        qparams["nu_anchor"] = True     # rescaler inverts the center anchor
    if header.get("gamma_anchor"):
        qparams["gamma_anchor"] = True  # rescaler un-whitens the slopes
        qparams["gamma_anchor_eps"] = float(header.get("gamma_anchor_eps",
                                                       1.0))
    header_out = dict(header)
    header_out["shapes"] = dict(shapes)
    header_out["layers_decoded"] = m
    if m < n_layers:
        header_out["num_kernels"] = k_dec
        header_out["used_kernels"] = np.packbits(used_dec).tolist()
        mm = header.get("model_mask")
        if mm is not None and len(mm) == k_full:
            # model_mask rows align with the FULL reduced kernel rows in
            # raster slot order (cli/fit extra) — keep the survivors
            full_slots = np.flatnonzero(np.unpackbits(
                np.asarray(header["used_kernels"], np.uint8),
                count=num_slots).astype(bool))
            keep = np.isin(full_slots, slots)
            header_out["model_mask"] = [v for v, kp in zip(mm, keep) if kp]
    for n in names:
        rows = np.concatenate(chunks[n])[perm]          # (k_dec, comps)
        dt = np.dtype(header.get("dtypes", {}).get(n, "float64"))
        shape_n = list(shapes[n])
        shape_n[0] = k_dec
        qzero = None
        if n in ("A_diagonal", "A_corr") and len(shape_n) == 3:
            from smoe_tpu_torch.codec.quantize import RANGE_EPS
            lb, ub = lower[n], upper[n]
            qzero = np.round((0.0 - lb) / (ub - lb + RANGE_EPS)
                             * header["steps"]["A"])
        qparams[n] = _unstructural(n, rows.reshape(-1).astype(dt),
                                   shape_n, qzero)
        header_out["shapes"][n] = shape_n
    return qparams, header_out
