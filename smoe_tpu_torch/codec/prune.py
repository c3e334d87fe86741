"""Post-hoc RD kernel pruning (no reference analog; from
smoe_tpu/codec/prune.py).

Quantization can make the least-important kernels net-negative: on
reseed-grown video/LF fits a gating-mass-ordered prefix can decode at
or above the full model at a fraction of the bits (BASELINE.md, round
3), while a converged 2D image fit keeps every kernel (rd_curve.py
--prune).  The sweep here finds that boundary per model, through the
real quantized decode.  Exposed as `cli.reconstruct --prune TOL_DB`
and `scripts/rd_curve.py --prune`.

Dual-model video fits sweep a second candidate ordering ("msplit":
transformed-domain kernels pruned first within mass order) because the
two models' masses are measured on different domains — the raw grid vs
the t=TIME_PLANE plane under an identity-warp approximation — so their
scales are not strictly comparable; measured on the CIF k=28 fit the
split ordering finds a better RD point than interleaved mass (30.78 dB
@ 81% kernels vs 30.32 @ 87%).  Every candidate is validated through
the actual decode, so extra orderings can only improve the chosen point.
"""

from __future__ import annotations

import numpy as np


def prune_search(smoe, tol_db=None, target_bits=None, extra_fn=None):
    """Evaluate importance-ordered kernel prefixes through the real
    quantized decode.  smoe.qparams must hold the quantized set
    (quantize_params).  Two selection modes:

    tol_db: return the qparams of the smallest prefix within tol_db of
    the best candidate.  The full set is always a candidate, so decoded
    quality never drops below full-model minus tol_db.

    target_bits (encoder-side rate control, no reference analog): every
    candidate is additionally entropy-encoded for its REAL payload size
    (write_bitstream, adaptive range coder — no proxy), and the
    best-PSNR candidate that fits the budget wins (ties -> fewer bits).
    If even the smallest candidate exceeds the budget it is returned
    with a warning.  extra_fn(qparams) -> dict supplies the header
    extra for candidate encodes (dual-model video needs the candidate's
    used-kernel model_mask); bits are measured with the same header
    fields the final file will carry.
    """
    from smoe_tpu_torch.codec.alloc import grid_numpy, mask_numpy
    from smoe_tpu_torch.codec.bitstream import (_bit_reversed_rank,
                                                kernel_importance)
    from smoe_tpu_torch.codec.quantize import rescaler, subset_qparams
    from smoe_tpu_torch.core.losses import psnr_from_mse

    if (tol_db is None) == (target_bits is None):
        raise ValueError("prune_search: give exactly one of tol_db / "
                         "target_bits")

    full = smoe.qparams
    used = np.asarray(full["used_kernels"], bool)
    k = int(np.count_nonzero(used))
    musX_grid = grid_numpy(smoe)
    grid = None if musX_grid is None else musX_grid[used]
    mm = mask_numpy(smoe)
    if mm is not None:
        mm = mm[used]                      # same slot indexing as the
        # dual-model extra in cli/reconstruct (capacity-length mask)
    imp = -np.asarray(kernel_importance(full, smoe.cfg, musX_grid=grid,
                                        model_mask=mm), np.float64)
    # same stratified tie-break as the layered tiers (_layer_rows):
    # exact-tie kernels spread across the raster, not a contiguous wedge
    bitrev = _bit_reversed_rank(k)
    orderings = {"mass": np.lexsort((bitrev, imp))}
    if mm is not None and mm.any() and not mm.all():
        # raw-domain kernels first, transformed-domain (True) last —
        # i.e. pruned first — each model internally mass-ordered
        orderings["msplit"] = np.lexsort((bitrev, imp, mm))
    # Zeroing a kernel's dequantized pi removes it EXACTLY (numerator
    # pi*N[*det] = 0, denominator = sum over the others), so every
    # candidate prefix evaluates at the full row count.
    rp_full = rescaler(full, smoe.cfg, grid)
    smoe.qparams = full

    def coded_bits(qp):
        import os
        import tempfile
        from smoe_tpu_torch.codec.bitstream import write_bitstream
        fd, tmp = tempfile.mkstemp(suffix=".smoe")
        os.close(fd)
        try:
            return write_bitstream(tmp, qp, smoe.cfg,
                                   extra=extra_fn(qp) if extra_fn else None)
        finally:
            os.unlink(tmp)

    cands = sorted({max(1, (k * j) // 16) for j in range(2, 16)} | {k})
    results = []    # (kc, psnr, ordering name, bits or None)
    for name, order in orderings.items():
        rank = np.empty(k, np.int64)
        rank[order] = np.arange(k)
        for kc in cands:
            if kc == k and any(r[0] == k for r in results):
                continue    # the full set is ordering-independent
            rp = dict(rp_full)
            rp["pis"] = np.where(rank < kc, rp_full["pis"],
                                 0.0).astype(rp_full["pis"].dtype)
            smoe.rparams = rp
            _, mse, *_ = smoe.run_batched(train=False,
                                          update_reconstruction=False,
                                          with_quantized_params=True)
            bits = None
            if target_bits is not None:
                qp_c = (full if kc == k else
                        subset_qparams(full, np.sort(order[:kc])))
                bits = coded_bits(qp_c)
            results.append((kc, float(psnr_from_mse(mse,
                                                    smoe.cfg.precision)),
                            name, bits))
            print(f"prune sweep[{name}]: {kc}/{k} kernels -> "
                  f"{results[-1][1]:.2f} dB"
                  + (f" @ {bits} bits" if bits is not None else ""))
    if target_bits is not None:
        fits = [r for r in results if r[3] <= target_bits]
        if fits:
            kc, ps, name, bits = max(fits, key=lambda r: (r[1], -r[3]))
        else:
            import warnings
            kc, ps, name, bits = min(results, key=lambda r: r[3])
            warnings.warn(
                f"prune_search: no candidate fits {target_bits} bits; "
                f"returning the smallest ({bits} bits)", RuntimeWarning)
        print(f"prune: keeping {kc}/{k} kernels ({ps:.2f} dB @ {bits} "
              f"bits via {name}; budget {target_bits} bits)")
    else:
        best = max(r[1] for r in results)
        kc, ps, name, _ = min((r for r in results if r[1] >= best - tol_db),
                              key=lambda r: r[0])
        print(f"prune: keeping {kc}/{k} kernels ({ps:.2f} dB via {name}; "
              f"best candidate {best:.2f} dB, tol {tol_db})")
    return (full if kc == k else
            subset_qparams(full, np.sort(orderings[name][:kc])))
