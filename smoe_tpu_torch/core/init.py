"""Initialization: coordinate domain, kernel grid, expert means, pis, block
shape.

A numpy copy of smoe_tpu/core/init.py:20-238 (imports pointed into the
port; `init_motion_identity` from smoe_tpu/core/params.py:119-127 written
in numpy).  Host-side, run once before a fit (reference equivalents:
gen_domain smoe.py:2395-2426, generate_kernel_grid :2146-2163,
generate_experts :2165-2235, generate_pis :2237-2242,
get_batch_shape :2459-2543, init_domain_and_target :1890-1893).
"""

from __future__ import annotations

from itertools import product
from typing import Optional, Sequence, Tuple

import numpy as np

from smoe_tpu_torch.config import SmoeConfig
from smoe_tpu_torch.core.params import SmoeParams


def init_motion_identity(num_frames: int) -> np.ndarray:
    """Identity global-motion params, shape (8, F): h11,h12,h13,h21,h22,h23,h31,h32.

    Reference initializes h11=h22=1, rest 0 (smoe.py:577-586).
    """
    m = np.zeros((8, num_frames), dtype=np.float32)
    m[0] = 1.0  # h11
    m[4] = 1.0  # h22
    return m


def gen_domain(shape_like, dim: int) -> np.ndarray:
    """Pixel-domain coordinates for an image: per-dim linspace(0, 1, n)
    inclusive -> (*, d) grid (reference gen_domain with ndarray input,
    smoe.py:2411-2422).

    Accepts an image array or a bare shape TUPLE (decoders know only the
    geometry).  For kernel-grid CENTERS use `kernel_centers` — the two
    used to share this function dispatching on tuple-vs-list, which
    silently produced wrong centers for a tuple-typed kernels_per_dim
    (ADVICE r2).
    """
    if not isinstance(shape_like, (np.ndarray, tuple)):
        raise TypeError(
            f"gen_domain expects an image array or shape tuple, got "
            f"{type(shape_like).__name__}; for kernels-per-dim centers "
            f"use kernel_centers()")
    dims = shape_like[:dim] if isinstance(shape_like, tuple) \
        else shape_like.shape[:dim]
    coords = [np.linspace(0.0, 1.0, n) for n in dims]
    grids = np.meshgrid(*coords, indexing="ij")
    return np.stack(grids, axis=-1).astype(np.float32)


def kernel_centers(kernels_per_dim, dim: int) -> np.ndarray:
    """Initial kernel-grid centers, inset by half a spacing per dim:
    linspace(1/(2n), 1 - 1/(2n), n) -> (prod(n), d) flat list
    (reference smoe.py:2415).  Accepts any sequence (list OR tuple)."""
    kpd = list(kernels_per_dim)
    if len(kpd) == 1:
        kpd = kpd * dim
    coords = [np.linspace(0.5 / n, 1.0 - 0.5 / n, n) for n in kpd]
    grids = np.meshgrid(*coords, indexing="ij")
    return np.stack(grids, axis=-1).reshape(-1, dim).astype(np.float32)


def generate_kernel_grid(cfg: SmoeConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Regular kernel grid + initial steering.

    A starts as diag(2*(kernels_per_dim+1)) per kernel, squared when training
    the inverse covariance directly (reference smoe.py:2146-2163).
    Returns (musX (K,d), A (K,d,d)).
    """
    d = cfg.dim_domain
    kpd = list(cfg.kernels_per_dim)
    if len(kpd) == 1:
        kpd = kpd * d
    musX = kernel_centers(kpd, d)
    a_vals = np.array([2.0 * (k + 1) for k in kpd], dtype=np.float32)
    A = np.tile(np.diag(a_vals)[None], (musX.shape[0], 1, 1)).astype(np.float32)
    if cfg.train_inverse_cov:
        A = A ** 2
    return musX, A


def generate_experts(image: np.ndarray, musX: np.ndarray,
                     cfg: SmoeConfig, with_means: bool = True
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Expert init: nu_e = local image mean around each center, gamma_e = 0.

    Patch bounds are center +- half grid spacing scaled to pixels
    (reference smoe.py:2165-2235; the 4D branch clamps view indices to [4,11],
    smoe.py:2212-2215).  When the clamp empties a patch (outer-view kernels
    with fine view grids: lo > hi) the mean falls back to 0.5 — the
    reference's np.mean over the empty slice would produce NaN there.
    Returns (nu_e (K,C), gamma_e (K,d,C)).
    """
    d = cfg.dim_domain
    c = image.shape[-1]
    k = musX.shape[0]
    gamma_e = np.zeros((k, d, c), dtype=np.float32)
    if not with_means:
        return np.full((k, c), 0.5, dtype=np.float32), gamma_e

    stride = musX[0]                       # first center = half spacing per dim
    sizes = image.shape[:d]
    nu_e = np.empty((k, c), dtype=np.float32)
    for ki in range(k):
        sl = []
        for di in range(d):
            lo = int(round((musX[ki, di] - stride[di]) * sizes[di]))
            hi = int(round((musX[ki, di] + stride[di]) * sizes[di]))
            if d == 4 and di < 2:          # light-field view clamp
                lo = max(lo, 4)
                hi = min(hi, 11)
            sl.append(slice(lo, hi))
        patch = image[tuple(sl)]
        nu_e[ki] = patch.reshape(-1, c).mean(axis=0) if patch.size else 0.5
    return nu_e, gamma_e


def generate_pis(num: int, normalize: bool) -> np.ndarray:
    """pis = 1/K (normalized) or 1 (reference smoe.py:2237-2242)."""
    return (np.ones((num,), np.float32) / num) if normalize \
        else np.ones((num,), np.float32)


def init_params(image: np.ndarray, cfg: SmoeConfig,
                init: Optional[dict] = None) -> SmoeParams:
    """Build the full fixed-capacity SmoeParams for an image.

    Slots beyond the live grid (inc block + add_kernel_slots) are zeroed with
    pis=0, matching the zero-padded variables of reference smoe.py:380-384.
    """
    if init is not None:
        musX = np.asarray(init["musX"], np.float32)
        if "A" in init:
            A = np.asarray(init["A"], np.float32)
        else:
            A = np.asarray(init["A_diagonal"], np.float32) + \
                np.asarray(init["A_corr"], np.float32)
        nu_e = np.asarray(init["nu_e"], np.float32)
        gamma_e = np.asarray(init["gamma_e"], np.float32)
        pis = np.asarray(init["pis"], np.float32)
    else:
        musX, A = generate_kernel_grid(cfg)
        nu_e, gamma_e = generate_experts(image, musX, cfg)
        pis = generate_pis(musX.shape[0], cfg.normalize_pis)

    k_live = pis.shape[0]
    cap = cfg.capacity if cfg.capacity >= k_live else k_live
    d, c = cfg.dim_domain, image.shape[-1]

    def pad(x, rows):
        if x.shape[0] >= rows:
            return x[:rows]
        padding = np.zeros((rows - x.shape[0],) + x.shape[1:], x.dtype)
        return np.concatenate([x, padding], axis=0)

    if cfg.radial_as:
        a_diag = pad(A[:, 0, 0] if A.ndim == 3 else A, cap)
        a_corr = np.zeros((cap, d, d), np.float32)
    else:
        # split the (possibly merged diag+corr) steering factor into its
        # diagonal and strict-lower parts.  The reference re-initializes
        # A_corr_var to zeros on reload (smoe.py:431-437), silently dropping
        # loaded correlations; splitting preserves them (documented
        # deviation) and keeps quantized A_diagonal structurally clean.
        diag_part = np.zeros_like(A)
        idx = np.arange(A.shape[1])
        diag_part[:, idx, idx] = A[:, idx, idx]
        a_diag = pad(diag_part, cap)
        a_corr = pad(np.tril(A, -1).astype(np.float32), cap)

    motion = None
    if cfg.dim_domain == 3 and (cfg.train_trafo or cfg.num_frames > 0):
        motion = init_motion_identity(cfg.num_frames or image.shape[2])
        if cfg.train_trafo and init is None:
            # the motion transform replaces every pixel's t with the
            # constant plane TIME_PLANE=-5 (reference smoe.py:684), so
            # motion-compensated kernels must live on that plane too
            # (reference sets musX_init[:, 2] = -5, smoe.py:304).  The
            # affines-driven video init does this via video_kernel_init;
            # the plain train_trafo init (learn motion from identity)
            # needs the same or every maha is astronomically large and
            # the fit never moves.
            from smoe_tpu_torch.video.motion import TIME_PLANE
            musX = musX.copy()
            musX[:, 2] = TIME_PLANE

    sv = sv_bw_diag = sv_bw_corr = None
    if cfg.train_svs:
        # per-pixel SV coefficients (zero) and bandwidth factors
        # A_SV = diag(sqrt(34/2 * 50/32 * sqrt(N))) (reference smoe.py:411-426),
        # stored in block-flattened pixel order.
        spatial = image.shape[:d]
        bs = cfg.block_shape or spatial
        win = tuple(b + 2 * cfg.overlap for b in bs)
        nblocks = int(np.prod([s // b for s, b in zip(spatial, bs)]))
        if getattr(cfg, "sv_shared_grid", False):
            # one SV per image pixel (global raster order) + a zeroed dummy
            # row that image-edge pad positions gather (cfg.sv_shared_grid)
            n_sv = int(np.prod(spatial)) + 1
        else:
            n_sv = nblocks * int(np.prod(win))
        n_joint = float(np.prod(spatial))
        bw0 = np.sqrt(34.0 / 2.0 * 50.0 / 32.0 * np.sqrt(n_joint))
        sv = np.zeros((n_sv, 1), np.float32)
        sv_bw_diag = np.tile((bw0 * np.eye(d, dtype=np.float32))[None],
                             (n_sv, 1, 1))
        sv_bw_corr = np.zeros_like(sv_bw_diag)

    return SmoeParams(
        musX=pad(musX, cap), a_diag=a_diag, a_corr=a_corr,
        pis=pad(pis, cap), nu_e=pad(nu_e, cap), gamma_e=pad(gamma_e, cap),
        motion=motion, sv=sv, sv_bw_diag=sv_bw_diag, sv_bw_corr=sv_bw_corr)


def get_batch_shape(desired_batches: int, domain_shape: Sequence[int]
                    ) -> Tuple[int, ...]:
    """Pick a block shape: smallest divisor-product >= desired batch count,
    preferring near-cubic blocks (reference smoe.py:2459-2543).

    domain_shape includes the channel-ish last dim (kept undivided).
    """
    def divisors(n):
        return [i for i in range(1, n + 1) if n % i == 0]

    dims = list(domain_shape)
    factor_lists = [divisors(n) for n in dims[:-1]] + [[1]]
    if len(dims) > 4:                      # light-field: never split views
        factor_lists[0] = [1]
        factor_lists[1] = [1]

    shapes = list(product(*factor_lists))
    counts = np.array([np.prod(s[:-1]) for s in shapes], dtype=np.float64)
    diff = counts - desired_batches
    diff[diff < 0] = np.inf
    target = counts[int(np.argmin(diff))]
    candidates = [s for s, c in zip(shapes, counts) if c == target]
    # prefer near-cubic: minimize sum of divisors (reference :2531-2538);
    # the light-field branch scores ONLY the 3rd-dim divisor — the
    # reference's identical `divs[2:3]` slice (smoe.py:2535-2536)
    def score(s):
        return np.sum(s[2:3]) if len(s) > 4 else np.sum(s)
    best = min(candidates, key=score)
    return tuple(int(n // f) for n, f in zip(dims, best))
