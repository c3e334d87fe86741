"""The least work of the fused gate + expert kernels, and the card's peaks.

Frozen copies of the port's arithmetic at the time the benchmark was
written (`diag/contraction.py:mode_work`, `bound`; `chip_smoke.py:k2_bound`),
so that a roofline reads the same work whatever computes it.

Per launch over P = N * K (pixel, kernel) pairs, S of which pass the
influence cull, at F quadratic features, E expert features, C channels:

    K1 (forward)   flops (2F + 4) P + (1 + 2EC) S
                   bytes 4 (N (F + C + E) + K (F + EC + 2))
    K2 (backward)  flops (4F + 10) P + (4EC + 4) S
                   bytes 4 (N (F + E + C + 1) + 2 K (F + EC + 1))

A pair's gate is F maha FMAs, the clamp, the exp, the pi_det multiply and
the denominator add; a surviving weight adds the division and E*C mixing
FMAs.  K2 recomputes the gate once per pair and adds dn, dpi, the clamp
factor and the F dq' FMAs; a survivor adds the dw dot, s_n, dG and the
division.  Bytes count each input read once and each output written once
(K2 reads K1's (N,) denominator).

The peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit:
67 TFLOP/s fp32 outside the tensor cores, 3.35 TB/s of HBM.  The fused
kernels compute the maha in exact fp32 (the quadratic-feature form cancels
in TF32), so no tensor-core peak applies.
"""

from __future__ import annotations

FP32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def k1_work(n: int, k: int, f: int, e: int, c: int, survivors: float):
    """(flops, bytes) of K1's least work."""
    p = n * k
    flops = (2 * f + 4) * p + (1 + 2 * e * c) * survivors
    nbytes = 4 * (n * (f + c + e) + k * (f + e * c + 2))
    return flops, nbytes


def k2_work(n: int, k: int, f: int, e: int, c: int, survivors: float):
    """(flops, bytes) of K2's least work, fed K1's denominator."""
    p = n * k
    flops = (4 * f + 10) * p + (4 * e * c + 4) * survivors
    nbytes = 4 * (n * (f + e + c + 1) + 2 * k * (f + e * c + 1))
    return flops, nbytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds the card could take: the larger of the operations
    over the fp32 peak and the bytes over the memory bandwidth."""
    return max(flops / FP32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


def widths(d: int, c: int):
    """(F, E, C) of the fused op on a d-dimensional domain with affine
    experts: F = d*d + d + 1 quadratic features, E = d + 1."""
    return d * d + d + 1, d + 1, c
