"""SMoE forward pass in PyTorch (from smoe_tpu/core/model.py).

The math is the JAX package's (model.py:1-30): with B_k = A_k A_k^T (or the
symmetric inverse-cov matrix directly)

    maha[n, k] = < phi(x_n), q_k >,   phi(x) = [vec(x x^T), x, 1]
                                      q_k    = [vec(B_k), -2 B_k mu_k, mu_k^T B_k mu_k]
    w          = pi * exp(-0.5 maha) [* det] / max(1e-11, sum_k ...), culled
    res        = w @ nu_e + sum_d x_d * (w @ gamma_e[:, d, :])

Two paths, as in the JAX package:
  * the plain path (`maha_from_A` -> `gating` -> `expert_regression`,
    `smoe_forward`; model.py:57-215, 345-367) — plain torch ops;
  * `forward_fused` (model.py:250-342, forward only) — the same function
    through the fused gate+expert op (kernels/gate_expert.py), which on a
    CUDA tensor runs the hand-written Hopper kernel.

Numerics: every maha contraction is exact fp32.  The quadratic-feature
form cancels A^2-scale terms, so TF32 (like the TPU's one-pass bf16)
breaks it; the small per-kernel contractions are written as elementwise
products and sums, and the one (N, F) x (F, K) matmul refuses to run on a
CUDA tensor while `torch.backends.cuda.matmul.allow_tf32` is set.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from smoe_tpu_torch.config import SmoeConfig
from smoe_tpu_torch.core.params import SmoeParams, assemble_A

# Floor for the gating denominator.  Reference writes `10e-12` (= 1e-11),
# smoe.py:821.
DENOM_FLOOR = 1e-11


class ForwardOut(NamedTuple):
    res: torch.Tensor                   # (N, C) clipped + fake-quantized
    w_e: Optional[torch.Tensor]         # (N, K) culled gating weights
    survivors: torch.Tensor             # (K,) bool
    maha: Optional[torch.Tensor]        # (N, K)


def _exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full fp32: refuses a CUDA matmul while TF32 is allowed."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: the quadratic-"
            "feature maha needs exact fp32 (TF32 cancels it away)")
    return a @ b


def quadratic_features(x: torch.Tensor) -> torch.Tensor:
    """phi(x) = [vec(x x^T), x, 1] for a batch of coords.  (N,d) -> (N, d*d+d+1)."""
    n, d = x.shape
    outer = (x[:, :, None] * x[:, None, :]).reshape(n, d * d)
    ones = torch.ones((n, 1), dtype=x.dtype, device=x.device)
    return torch.cat([outer, x, ones], dim=-1)


def _aat(A: torch.Tensor) -> torch.Tensor:
    """A A^T per kernel, as exact elementwise products and sums."""
    return (A[:, :, None, :] * A[:, None, :, :]).sum(-1)


def kernel_quadratics(B: torch.Tensor, musX: torch.Tensor) -> torch.Tensor:
    """q_k = [vec(B_k), -2 B_k mu_k, mu_k^T B_k mu_k].  (K,d,d),(K,d) -> (K, d*d+d+1)."""
    k, d, _ = B.shape
    Bmu = (B * musX[:, None, :]).sum(-1)
    const = (Bmu * musX).sum(-1)[:, None]
    return torch.cat([B.reshape(k, d * d), -2.0 * Bmu, const], dim=-1)


def maha_from_A(A: torch.Tensor, musX: torch.Tensor, cfg: SmoeConfig,
                coords: torch.Tensor) -> torch.Tensor:
    """(N, K) Mahalanobis distances given the assembled steering factor A
    (model.py:102-144; single domain — the dual-model video form waits for
    the video slice).

    train_inverse_cov: maha = x^T A x (A already symmetrized);
    otherwise:         maha = x^T A A^T x, clamped at 0 (the quadratic-
    feature form can go slightly negative under f32 cancellation).
    """
    B = A if cfg.train_inverse_cov else _aat(A)
    q = kernel_quadratics(B, musX)
    maha = _exact_matmul(quadratic_features(coords), q.T)
    if not cfg.train_inverse_cov:
        maha = torch.clamp(maha, min=0.0)
    return maha


def gating(maha: torch.Tensor, pis: torch.Tensor, diag_A: torch.Tensor,
           cfg: SmoeConfig, kernel_mask: torch.Tensor) -> torch.Tensor:
    """Softmax-like gating with influence culling (model.py:155-185,
    reference smoe.py:807-827).  (N,K) -> (N,K)."""
    mask = kernel_mask & (pis > 0)
    # mask inside the exp so dead kernels can never give inf * 0 = nan
    n_exp = torch.exp(-0.5 * torch.where(mask[None, :], maha,
                                         torch.zeros_like(maha)))
    if cfg.use_determinant:
        n_div = torch.prod(diag_A, dim=-1)
        n_quo = n_div / math.sqrt((2.0 * math.pi) ** cfg.dim_domain)
        n_exp = n_exp * n_quo[None, :]
    n_w = n_exp * torch.where(mask, pis, torch.zeros_like(pis))[None, :]
    denom = torch.clamp(torch.sum(n_w, dim=1, keepdim=True), min=DENOM_FLOOR)
    w_e = n_w / denom
    return w_e * (w_e > cfg.minimum_influence)


def _masked_gamma(gamma_e: torch.Tensor, cfg: SmoeConfig) -> torch.Tensor:
    if cfg.only_y_gamma and cfg.use_yuv:
        # slopes only on the Y channel (reference smoe.py:725-729)
        chan = torch.zeros(gamma_e.shape[-1], dtype=gamma_e.dtype,
                           device=gamma_e.device)
        chan[0] = 1.0
        return gamma_e * chan[None, None, :]
    return gamma_e


def expert_regression(w_e: torch.Tensor, coords: torch.Tensor,
                      nu_e: torch.Tensor, gamma_e: torch.Tensor,
                      cfg: SmoeConfig) -> torch.Tensor:
    """res[n,c] = sum_k w[n,k] (gamma_k^T x_n + nu_k)  (model.py:188-215,
    reference smoe.py:840-848)."""
    k, d, c = gamma_e.shape
    res = _exact_matmul(w_e, nu_e)
    if cfg.train_gammas:
        gamma_e = _masked_gamma(gamma_e, cfg)
        g = _exact_matmul(w_e, gamma_e.reshape(k, d * c)).reshape(-1, d, c)
        res = res + (coords[:, :, None] * g).sum(1)
    return res


def fake_quant_unit(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Fake-quantize values in [0,1] to `bits` with a straight-through
    gradient (model.py:218-226; reference smoe.py:899).  torch.round
    rounds half to even, as jnp.round does."""
    steps = (1 << bits) - 1
    q = torch.round(torch.clamp(x, 0.0, 1.0) * steps) / steps
    return x + (q - x).detach()


def forward_fused(A: torch.Tensor, musX: torch.Tensor, nu_e: torch.Tensor,
                  gamma_e: torch.Tensor, pis: torch.Tensor, cfg: SmoeConfig,
                  coords: torch.Tensor,
                  kernel_mask: torch.Tensor) -> ForwardOut:
    """Forward through the fused gate+expert op (model.py:250-342, forward
    only): builds q, pi_det, phi, xe and G as model.py:284-316 does and
    calls `kernels.gate_expert.gate_expert_fwd`.

    The backward kernel (K2) is not ported yet, so inputs that require
    grad are refused; the capped-dense `k_cap` gather, `sv_add` and the
    dual-model features wait for the trainer and video slices.
    """
    from smoe_tpu_torch.kernels.gate_expert import gate_expert_fwd

    if any(t.requires_grad for t in (A, musX, nu_e, gamma_e, pis, coords)):
        raise NotImplementedError(
            "forward_fused has no backward kernel yet (K2, ROADMAP.md "
            "Queue 2); use smoe_forward for gradients")
    B = A if cfg.train_inverse_cov else _aat(A)
    q = kernel_quadratics(B, musX)

    mask = kernel_mask & (pis > 0)
    zero = torch.zeros_like(pis)
    if cfg.use_determinant:
        diag_A = torch.diagonal(A, dim1=1, dim2=2)
        det = torch.prod(diag_A, dim=-1) / math.sqrt(
            (2.0 * math.pi) ** cfg.dim_domain)
        pi_det = torch.where(mask, pis * det, zero)
    else:
        pi_det = torch.where(mask, pis, zero)

    k, d, c = gamma_e.shape
    phi = quadratic_features(coords)
    ones = torch.ones((coords.shape[0], 1), dtype=coords.dtype,
                      device=coords.device)
    if cfg.train_gammas:
        gamma_e = _masked_gamma(gamma_e, cfg)
        xe = torch.cat([coords, ones], dim=1)
        G = torch.cat([gamma_e.reshape(k, d * c), nu_e], dim=1)
    else:
        xe, G = ones, nu_e
    res_raw, surv = gate_expert_fwd(
        phi, xe, q, G, pi_det.float(), mask.float(),
        float(cfg.minimum_influence), float(DENOM_FLOOR))
    res = fake_quant_unit(torch.clamp(res_raw, 0.0, 1.0), cfg.precision)
    return ForwardOut(res=res, w_e=None, survivors=surv > 0, maha=None)


def smoe_forward(params: SmoeParams, cfg: SmoeConfig,
                 coords: torch.Tensor,
                 kernel_mask: Optional[torch.Tensor] = None,
                 A_override: Optional[torch.Tensor] = None) -> ForwardOut:
    """Full plain forward pass on a flat pixel set (model.py:345-367).

    coords: (N, d) in [0,1]^d.  kernel_mask: (K,) bool per-block kernel
    list (defaults to all-on).  A_override: explicit (K, d, d) steering
    factor (decode path).
    """
    if kernel_mask is None:
        kernel_mask = torch.ones((params.capacity,), dtype=torch.bool,
                                 device=params.pis.device)
    A = A_override if A_override is not None else assemble_A(params, cfg)
    maha = maha_from_A(A, params.musX, cfg, coords)
    diag_A = torch.diagonal(A, dim1=1, dim2=2)
    w_e = gating(maha, params.pis, diag_A, cfg, kernel_mask)
    res = expert_regression(w_e, coords, params.nu_e, params.gamma_e, cfg)
    res = fake_quant_unit(torch.clamp(res, 0.0, 1.0), cfg.precision)
    survivors = torch.any(w_e > cfg.minimum_influence, dim=0)
    return ForwardOut(res=res, w_e=w_e, survivors=survivors, maha=maha)
