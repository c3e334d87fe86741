"""Automatic per-group bit allocation at encode (beyond the reference;
from smoe_tpu/codec/alloc.py).

Round-4 finding: the transparency knee of the 5-group allocation is
FIT-DEPENDENT — the Adam-era knee (A8/mu10/nu8/pi10/g6, round 3) breaks
on LS-refreshed fits, which need nu10/g8 (the reference's nu6 default
cost a measured 2.5 dB on the video lsri fit; g6 cost ~4 dB).  Instead
of hand-tuned per-recipe knees, `search_bit_depths` finds the knee for
THE fit being coded: greedy per-group descent from a generous
allocation, accepting a depth reduction only while the REAL quantized
decode stays within `tol_db` of the generous-allocation PSNR.

Cost: each candidate is one host-side quantize/rescale plus one
quantized-decode eval on the trainer's exact plain path (torch ops, as
the JAX package keeps it in XLA outside any Pallas kernel) — typically
~30-50 evals.

Exposed as `cli/reconstruct --auto-bd TOL`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

GROUPS = ("A", "musX", "nu_e", "pis", "gamma_e")

# generous starting allocation: transparent for every fit family
# measured so far (reference depths already are for A/musX; nu/gamma
# get headroom above the LS-fit knee)
START = (20, 18, 14, 12, 14)
FLOOR = 4


def grid_numpy(smoe) -> Optional[np.ndarray]:
    """The trainer's musX grid (a device tensor under use_diff_center) as
    numpy, or None."""
    g = smoe.musX_grid
    return None if g is None else g.detach().cpu().numpy()


def _quantized_psnr(smoe, bit_depths: Tuple[int, ...]) -> float:
    """Decoded PSNR of the CURRENT params coded at bit_depths (real
    quantize -> rescale -> compiled dense eval; same path rd_curve and
    the qm=1 validation use)."""
    from smoe_tpu_torch.codec.quantize import quantize_params, rescaler
    from smoe_tpu_torch.core.losses import psnr_from_mse

    cfg = smoe.cfg.replace(bit_depths=tuple(int(b) for b in bit_depths))
    musX_grid = grid_numpy(smoe)
    qp = quantize_params(smoe.get_params(), cfg, musX_grid=musX_grid)
    grid = None
    if musX_grid is not None:
        grid = musX_grid[np.asarray(qp["used_kernels"])]
    smoe.qparams = qp
    smoe.rparams = rescaler(qp, cfg, grid)
    _, qmse, _, _ = smoe.run_batched(train=False,
                                     with_quantized_params=True)
    return float(psnr_from_mse(qmse, smoe.cfg.precision))


def choose_anchors(smoe, log=None) -> Tuple[bool, bool, float]:
    """Pick (nu_anchor, gamma_anchor) by MEASURED quantized decode.

    Round-4 finding: the center-anchored nu coding helps LS-refreshed
    fits (+3.4 dB on the video lsri fit) but HURT one lsinit-only fit by
    3 dB (an outlier kernel's gamma.mu stretched the anchored bounds
    past the origin-nu range), and gamma whitening measured negative on
    every video/LF fit tried — the right transform is a per-fit
    measurement, not a recipe rule.  4 evals; sets smoe.cfg to the
    winner (the flags ride the bitstream header, so decoders follow
    automatically).  Returns (nu_anchor, gamma_anchor, psnr)."""
    best = None
    for nu_a, g_a in ((False, False), (True, False), (True, True),
                      (False, True)):
        smoe.cfg = smoe.cfg.replace(nu_anchor=nu_a, gamma_anchor=g_a)
        p = _quantized_psnr(smoe, smoe.cfg.bit_depths)
        if log:
            log(f"auto-anchor: nu={int(nu_a)} gamma={int(g_a)} "
                f"-> {p:.3f} dB")
        if best is None or p > best[2]:
            best = (nu_a, g_a, p)
    smoe.cfg = smoe.cfg.replace(nu_anchor=best[0], gamma_anchor=best[1])
    return best


def search_bit_depths(smoe, tol_db: float = 0.05,
                      start: Optional[Tuple[int, ...]] = None,
                      floor: int = FLOOR,
                      log=None) -> Tuple[Tuple[int, ...], float, float]:
    """Greedy coordinate descent on the per-group bit depths.

    Returns (bit_depths, psnr_at_depths, psnr_reference).  The reference
    PSNR is measured at `start` (generous); every accepted reduction
    keeps decoded PSNR >= reference - tol_db, so the result is a
    per-fit transparency knee in the round-3/4 studies' sense.
    """
    bd: List[int] = list(start or START)
    ref = _quantized_psnr(smoe, tuple(bd))
    cur = ref
    if log:
        log(f"auto-bd: reference {ref:.3f} dB at {bd}")
    # one step per group per pass: the tol budget is shared (measured vs
    # the fixed reference), so round-robin spreads it across groups
    # instead of letting the first group spend it all
    blocked = [False] * len(bd)
    evals = 1
    while not all(blocked):
        for gi in range(len(bd)):
            if blocked[gi] or bd[gi] <= floor:
                blocked[gi] = True
                continue
            trial = list(bd)
            trial[gi] -= 1
            p = _quantized_psnr(smoe, tuple(trial))
            evals += 1
            if p >= ref - tol_db:
                bd = trial
                cur = p
            else:
                blocked[gi] = True
    if log:
        log(f"auto-bd: chose {bd} ({cur:.3f} dB, {evals} evals)")
    # leave the trainer's qparams/rparams at the CHOSEN allocation
    cur = _quantized_psnr(smoe, tuple(bd))
    return tuple(bd), cur, ref
