"""Ablation variants of the fused gate+expert forward: the Hopper kernel K3
and its plain version.

Counterpart of scripts/bench_contraction.py (`_variant_kernel` :50-73,
`variant_call` :76-111).  Each mode is K1's forward chain with parts
removed, so that timing the modes tells where K1's time goes
(smoe_tpu_torch/diag/contraction.py):

    full     cull(n_w / max(floor, sum_k n_w)),  n_w = exp(mh) * pi_det
    exp2     the same through exp2, log2(e) folded into the q prescale
    no_cull  no cull
    no_norm  w = n_w: no denominator pass, no division, no cull
    no_exp   w = mh

with mh = min(phi . q', 0), q' = -0.5 q (times log2 e in exp2), and the
tail res = sum_j (w @ G)[:, 3j:3j+3] for every mode (no xe mix).

On the card every mode is an instance of the body K1 is built from
(csrc/gate_expert_fwd_body.cuh): full and exp2 keep K1's per-CTA
candidates and skip the division of a certainly culled pair, and `full`
gives K1's bits for xe = 1, mask = 1.  Unlike the TPU script, whose maha
dot runs at the TPU's default one-pass bf16 precision, every maha product
here is exact fp32, as in production K1, so that `full` times K1's own
arithmetic.  Widths: K1's C = 3 instances, F = 7 / 13 / 21 (d = 2, 3, 4)
and the dual-model F = 26, E = d + 1 or 1.

The plain version forms phi . q' as K1's fixed-order chain of fp32 fmas
over the F features (`fixed_order_maha`), not a BLAS product, so that its
bits, and the side of the cull threshold a near-tie pair falls on, are the
same on every machine.

`gate_expert_variant` dispatches on where its tensors lie: CPU tensors go
to `gate_expert_variant_reference`, CUDA tensors launch the CUDA C++
kernel csrc/gate_expert_variants.cu (built by kernels/build.py at first
use) or raise.  `gate_expert_variant.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from smoe_tpu_torch.kernels import build
from smoe_tpu_torch.kernels.gate_expert import _check, _refuse_tf32

_NAME = "gate_expert_variants"
VARIANTS = ("full", "exp2", "no_cull", "no_norm", "no_exp")
LOG2E = float(np.log2(np.e))
C_DIM = 3            # the TPU variant's fixed channel count (:79-81)


def _mode_index(mode: str) -> int:
    if mode not in VARIANTS:
        raise ValueError(f"gate_expert_variant: unknown mode {mode!r}; "
                         f"one of {VARIANTS}")
    return VARIANTS.index(mode)


def _prescale(q: torch.Tensor, mode: str) -> torch.Tensor:
    """q' = q * (-0.5), or q * (-0.5 log2 e) in exp2 (:87-88)."""
    return q * (-0.5 * (LOG2E if mode == "exp2" else 1.0))


def fixed_order_maha(phi: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """phi @ q.T (N, K) in K1's order (csrc/gate_expert_common.cuh:
    dot_padded): acc = fma(phi_f, q_f, acc) over f = 0 .. F-1 from 0, each
    step rounded once to fp32.  A step is computed in float64, where the
    product of two fp32 values is exact, then rounded to fp32; so the bits
    are the same on every machine and thread count, where a BLAS product's
    summation order may follow the CPU's instruction set.  (The double
    rounding can move a step by one fp32 ulp from a true fma, in about
    2^-29 of the steps.)"""
    p64, q64 = phi.double(), q.double()
    acc = (p64[:, :1] * q64[None, :, 0]).float()
    for f in range(1, phi.shape[1]):
        acc = (p64[:, f:f + 1] * q64[None, :, f] + acc.double()).float()
    return acc


def variant_weights(phi, q, pi_det, mode: str, thr: float = 1e-4,
                    floor: float = 1e-11, cull: bool = True) -> torch.Tensor:
    """The mode's gating weights w (N, K) in `_variant_kernel`'s op order
    (:53-67); cull=False gives full's and exp2's before the cull."""
    _mode_index(mode)
    _refuse_tf32(phi)
    mh = torch.minimum(fixed_order_maha(phi, _prescale(q, mode)),
                       phi.new_zeros(()))
    if mode == "no_exp":
        return mh
    e = torch.exp2(mh) if mode == "exp2" else torch.exp(mh)
    n_w = e * pi_det[None, :]
    if mode == "no_norm":
        return n_w
    denom = torch.maximum(phi.new_full((), floor),
                          torch.sum(n_w, dim=1, keepdim=True))
    w = n_w / denom
    if mode == "no_cull" or not cull:
        return w
    return torch.where(w > thr, w, torch.zeros_like(w))


def gate_expert_variant_reference(phi, q, G, pi_det, mode: str,
                                  thr: float = 1e-4,
                                  floor: float = 1e-11) -> torch.Tensor:
    """Plain torch version in `_variant_kernel`'s op order (:53-73).

    phi (N, F) quadratic features; q (K, F) kernel quadratics (unscaled);
    G (K, E*3); pi_det (K,).  Returns res (N, 3)."""
    wg = variant_weights(phi, q, pi_det, mode, thr, floor) @ G
    res = torch.zeros((wg.shape[0], C_DIM), dtype=wg.dtype, device=wg.device)
    for j in range(G.shape[1] // C_DIM):
        res = res + wg[:, j * C_DIM:(j + 1) * C_DIM]
    return res


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load(_NAME)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.smoe_gate_expert_variant.argtypes = ([ptr] * 5 + [i32] * 5
                                             + [f32, f32, ptr])
    lib.smoe_gate_expert_variant.restype = i32
    lib.smoe_gate_expert_variant_supported.argtypes = [i32, i32, i32]
    lib.smoe_gate_expert_variant_supported.restype = i32
    lib.smoe_cuda_error_string.argtypes = [i32]
    lib.smoe_cuda_error_string.restype = ctypes.c_char_p
    return lib


def gate_expert_variant(phi, q, G, pi_det, mode: str, thr: float = 1e-4,
                        floor: float = 1e-11) -> torch.Tensor:
    """One ablation variant of the fused forward; same arguments and result
    as `gate_expert_variant_reference`.  CPU tensors take the plain
    version; CUDA tensors launch the Hopper kernel K3 (and count one
    launch) or raise."""
    m = _mode_index(mode)
    if phi.device.type == "cpu":
        return gate_expert_variant_reference(phi, q, G, pi_det, mode, thr,
                                             floor)
    if phi.device.type != "cuda":
        raise ValueError(f"gate_expert_variant: no kernel for {phi.device}")
    n, f = phi.shape
    k, ec = q.shape[0], G.shape[1]
    if ec % C_DIM:
        raise ValueError(f"gate_expert_variant: G width {ec} is not a "
                         f"multiple of {C_DIM} channels")
    dev = phi.device
    for name, t, shape in (("phi", phi, (n, f)), ("q", q, (k, f)),
                           ("G", G, (k, ec)), ("pi_det", pi_det, (k,))):
        _check(name, t, shape, dev)
    lib = _library()
    if not lib.smoe_gate_expert_variant_supported(f, ec, m):
        raise ValueError(f"gate_expert_variant: no kernel instance for "
                         f"F={f}, E*C={ec} (F = 7, 13, 21 for d = 2, 3, 4 "
                         f"or the dual-model F = 26; E = d + 1 or 1; C = 3)")
    q_s = _prescale(q, mode).contiguous()
    res = torch.empty((n, C_DIM), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.smoe_gate_expert_variant(
        phi.data_ptr(), q_s.data_ptr(), G.data_ptr(), pi_det.data_ptr(),
        res.data_ptr(), n, f, ec, k, m, thr, floor, stream)
    if err:
        raise RuntimeError("gate_expert_variant launch failed: "
                           + lib.smoe_cuda_error_string(err).decode())
    gate_expert_variant.launches += 1
    return res


gate_expert_variant.launches = 0
