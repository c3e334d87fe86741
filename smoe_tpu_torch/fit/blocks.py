"""Spatial block partitioning and per-block kernel locality lists (from
smoe_tpu/fit/blocks.py:32-289).

Blocks are materialized once as dense (B, Nb, d+C) tensors on the device,
so a sweep walks them without host round trips (the reference streamed
them through per-block feed dicts, smoe.py:18-35, 1643-1702).

Kernel locality ("kernel lists", reference smoe.py:2244-2365) is a (B, K)
bool tensor: block-center assignment at init, then corner/edge probing with
maha < 800 plus the influence-culling survivors fed back after each sweep
(reference smoe.py:1763-1766).  For motion-compensated video the caller
passes probes on the transformed block extent; dual-model kernels are
routed to their own domain's probes by the model mask.
"""

from __future__ import annotations

from itertools import product
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from smoe_tpu_torch.config import SmoeConfig
from smoe_tpu_torch.core.init import gen_domain
from smoe_tpu_torch.core.model import maha_from_A

MAHA_PROBE_THRESHOLD = 800.0   # reference smoe.py:806


class BlockSet(NamedTuple):
    """Static, device-resident blocked view of one image."""
    coords: torch.Tensor       # (B, Nb, d) pixel coordinates (zero in pad)
    targets: torch.Tensor      # (B, Nb, C) pixel values   (zero in pad)
    valid: torch.Tensor        # (Nb,) bool: interior (non-overlap) pixels
    probes: torch.Tensor       # (B, P, d) block corner/edge/mid probe points
    centers: torch.Tensor      # (B, d) block centers (mean coords incl. pad)
    image_shape: Tuple[int, ...]       # spatial dims
    block_valued: Tuple[int, ...]      # block size per dim without overlap
    block_padded: Tuple[int, ...]      # block size per dim with 2*overlap
    overlap: int
    train_mask: Optional[torch.Tensor] = None   # (B, Nb) LF corner views


def row_chunks(nb: int, width: int, budget_bytes: int = 2 << 30) -> int:
    """Row-chunks per block for dense (rows, width) passes, sized so the
    gating map and its handful of same-shaped f32 temporaries stay inside
    a fixed device-memory share (blocks.py:51-69).  Returns a divisor of nb
    (1 = unchunked).  Row chunking is exact for the forward: the gating and
    expert reductions run over the kernel axis, never across rows.

    The divisor search is bounded: an estimate at or above nb gives nb (one
    row per chunk), and the search walks up to the first divisor at or
    above the estimate, which exists because nb divides itself."""
    est = int(max(1, -(-nb * width * 4 * 6 // budget_bytes)))
    if est <= 1:
        return 1
    if est >= nb:
        return max(nb, 1)
    return next(s for s in range(est, nb + 1) if nb % s == 0)


def _block_view(arr: np.ndarray, bs: Tuple[int, ...], ov: int) -> np.ndarray:
    """(spatial..., F) -> (B, Nb, F) overlapping zero-padded blocks in the
    reference's row-major block order."""
    d = len(bs)
    f = arr.shape[-1]
    pad = [(ov, ov)] * d + [(0, 0)]
    a = np.pad(arr, pad, mode="constant")
    nb = [arr.shape[i] // bs[i] for i in range(d)]
    win = [bs[i] + 2 * ov for i in range(d)]
    blocks = np.empty((int(np.prod(nb)), int(np.prod(win)), f), arr.dtype)
    for bi, idx in enumerate(product(*[range(n) for n in nb])):
        sl = tuple(slice(idx[i] * bs[i], idx[i] * bs[i] + win[i]) for i in range(d))
        blocks[bi] = a[sl].reshape(-1, f)
    return blocks


def build_blockset(image: np.ndarray, cfg: SmoeConfig,
                   block_shape: Optional[Tuple[int, ...]] = None,
                   device="cpu") -> BlockSet:
    """Partition an image into the device-resident BlockSet
    (blocks.py:88-162).

    image: (*spatial, C) float array in [0,1].
    block_shape: pixels per block per dim (must divide the image dims,
    reference smoe.py:238-241); defaults to cfg.block_shape or whole image.
    """
    d = cfg.dim_domain
    spatial = image.shape[:d]
    bs = tuple(block_shape or cfg.block_shape or spatial)
    assert len(bs) == d, f"block shape {bs} does not match domain dim {d}"
    for n, b in zip(spatial, bs):
        if n % b:
            raise ValueError(f"block shape {bs} does not divide image {spatial}")
    ov = cfg.overlap

    coords_grid = gen_domain(image, d)                    # (*spatial, d)
    joint = np.concatenate([coords_grid, image], axis=-1)
    blocks = _block_view(joint, bs, ov)                   # (B, Nb, d+C)
    coords = blocks[..., :d]
    targets = blocks[..., d:]

    win = tuple(b + 2 * ov for b in bs)
    interior = np.ones(win, dtype=bool)
    if ov > 0:
        sl = tuple(slice(ov, ov + b) for b in bs)
        interior = np.zeros(win, dtype=bool)
        interior[sl] = True
    valid = interior.reshape(-1)

    probes = probe_points(coords.min(axis=1), coords.max(axis=1),
                          grid=getattr(cfg, "probe_grid", 3))
    centers = blocks.mean(axis=1)[:, :d]

    def dev(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    train_mask = None
    if d >= 4:
        # per-block corner-view mask, blocked like the pixel data
        # (reference smoe.py:902-904); lf_corner_weight makes it a weight
        tm = _lf_train_mask(spatial)[..., None].astype(np.float32)
        cw = float(getattr(cfg, "lf_corner_weight", 0.0))
        if cw > 0.0:
            tm = tm + cw * (1.0 - tm)
            train_mask = dev(_block_view(tm, bs, ov)[..., 0])
        else:
            train_mask = dev(_block_view(tm, bs, ov)[..., 0] > 0.5,
                             torch.bool)

    return BlockSet(
        coords=dev(coords), targets=dev(targets), valid=dev(valid, torch.bool),
        probes=dev(probes), centers=dev(centers),
        image_shape=spatial, block_valued=bs, block_padded=win,
        overlap=ov, train_mask=train_mask)


def _lf_train_mask(spatial: Tuple[int, ...]) -> np.ndarray:
    """Hardcoded 15x15 light-field view mask excluding corner views
    (reference smoe.py:2374-2389)."""
    m = np.ones(spatial, dtype=bool)
    m[0, 0:4] = False; m[0, 11:] = False
    m[1, 0:2] = False; m[1, 13:] = False
    m[2:4, 0] = False; m[2:4, 14] = False
    m[11:13, 0] = False; m[11:13, 14] = False
    m[13, 0:2] = False; m[13, 13:] = False
    m[14, 0:4] = False; m[14, 11:] = False
    return m


def stitch_blocks(block_vals: torch.Tensor, bset: BlockSet) -> torch.Tensor:
    """(B, Nb, F) block outputs -> (*spatial, F) image (interior crop);
    inverse of _block_view (blocks.py:178-200)."""
    d = len(bset.block_valued)
    f = block_vals.shape[-1]
    win = bset.block_padded
    bs = bset.block_valued
    ov = bset.overlap
    nb = [s // b for s, b in zip(bset.image_shape, bs)]
    x = block_vals.reshape(tuple(nb) + tuple(win) + (f,))
    if ov > 0:
        sl = tuple([slice(None)] * d +
                   [slice(ov, ov + b) for b in bs] + [slice(None)])
        x = x[sl]
    # interleave block-grid dims with in-block dims: (n0, b0, n1, b1, ..., F)
    perm = []
    for i in range(d):
        perm += [i, d + i]
    perm += [2 * d]
    return x.permute(perm).reshape(tuple(bset.image_shape) + (f,))


# ---------------- kernel locality lists ----------------

def initialize_kernel_lists(A: torch.Tensor, musX: torch.Tensor,
                            pis: torch.Tensor, cfg: SmoeConfig,
                            bset: BlockSet) -> torch.Tensor:
    """(B, K) bool: each kernel assigned to its nearest block center by
    maha, then extended by probe points (blocks.py:205-224, reference
    smoe.py:2244-2285).  Takes the effective assembled tensors."""
    B = bset.centers.shape[0]
    maha = maha_from_A(A, musX, cfg, bset.centers)         # (B, K)
    nearest = torch.argmin(maha, dim=0)                    # first on ties
    lists = nearest[None, :] == torch.arange(B, device=maha.device)[:, None]
    # dead slots have maha == 0 everywhere and would all land in block 0
    lists = lists & (pis > 0)[None, :]
    return update_kernel_lists(A, musX, pis, cfg, bset, lists)


def probe_points(mins, maxs, grid: int = 3):
    """(B, d) min/max per block -> (B, grid^d, d) per-dim-linspace product
    probe points (blocks.py:227-243).  grid=3 gives the reference's
    {min, max, mid} set (smoe.py:2332-2354).  numpy in gives numpy out;
    a tensor gives a tensor on its device."""
    d = mins.shape[1]
    fr = np.linspace(0.0, 1.0, grid).astype(np.float32)    # (g,)
    idx = np.array(list(product(range(grid), repeat=d)))   # (g^d, d)
    if torch.is_tensor(mins):
        fr = torch.as_tensor(fr, device=mins.device)
        idx = torch.as_tensor(idx, device=mins.device)
        dims = torch.arange(d, device=mins.device)
    else:
        dims = np.arange(d)
    tt = mins[:, :, None] + (maxs - mins)[:, :, None] * fr  # (B, d, g)
    return tt[:, dims[None, :], idx]                       # (B, g^d, d)


def update_kernel_lists(A: torch.Tensor, musX: torch.Tensor,
                        pis: torch.Tensor, cfg: SmoeConfig, bset: BlockSet,
                        lists: torch.Tensor,
                        probes: Optional[torch.Tensor] = None,
                        probes_raw: Optional[torch.Tensor] = None,
                        model_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """OR in all active kernels whose maha to any block probe point is below
    the threshold, or whose center lies inside the block's probe box
    (blocks.py:246-289, reference smoe.py:2287-2365).

    probes: override probe points (the motion-transformed block extent for
    video, reference smoe.py:2292-2317); probes_raw + model_mask route the
    dual model's raw-domain kernels (mask False) to the raw probes, for the
    maha and for the center-inside test."""
    pr = bset.probes if probes is None else probes
    B, P, d = pr.shape
    maha = maha_from_A(
        A, musX, cfg, pr.reshape(B * P, d),
        coords_raw=None if probes_raw is None
        else probes_raw.reshape(B * P, d), model_mask=model_mask)
    maha = maha.reshape(B, P, A.shape[0])
    thr = getattr(cfg, "probe_maha_threshold", MAHA_PROBE_THRESHOLD)
    near = torch.any(maha < thr, dim=1)                    # (B, K)
    # center-inside-block: a sharp kernel deep inside a block can read
    # maha > thr at every probe yet dominate its neighbourhood
    def _inside(box):
        lo = box.amin(dim=1)                               # (B, d)
        hi = box.amax(dim=1)
        return torch.all((musX[None, :, :] >= lo[:, None, :])
                         & (musX[None, :, :] <= hi[:, None, :]), dim=-1)
    inside = _inside(pr)
    if probes_raw is not None and model_mask is not None:
        inside = torch.where(model_mask[None, :], inside, _inside(probes_raw))
    near = near | inside
    return lists | (near & (pis > 0)[None, :])
