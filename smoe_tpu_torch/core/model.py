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
  * `forward_fused` (model.py:250-342) — the same function through the
    fused gate+expert op (kernels/gate_expert.py), which on a CUDA tensor
    runs the hand-written Hopper kernels: K1 forward, K2 backward.
Both take the dual-model video form (model.py:65-77): kernels whose
`model_mask` is False see the raw pixels, the others the motion-transformed
ones, through one product over the concatenated 2F-wide features.

Numerics: every maha contraction is exact fp32.  The quadratic-feature
form cancels A^2-scale terms, so TF32 (like the TPU's one-pass bf16)
breaks it; the small per-kernel contractions are written as elementwise
products and sums, and the one (N, F) x (F, K) matmul refuses to run on a
CUDA tensor while `torch.backends.cuda.matmul.allow_tf32` is set.

compute_dtype="bfloat16" (model.py:121, 201; any other value is fp32) is
the JAX package's opt-in: the operands of the maha and of both expert
products are rounded to bf16 (`round_bf16`) and multiplied in fp32, so
each product is exact and the sums fp32.  The rounding's autograd rounds
the cotangents to bf16 at each cast, as JAX's astype does.  Never a
matmul on bf16 tensors: it would return, and may sum in, bf16.  The fused
op (forward_fused) rounds only the maha's operands, inside K1 and K2.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from smoe_tpu_torch.config import SmoeConfig
from smoe_tpu_torch.core.params import SmoeParams, assemble_A
from smoe_tpu_torch.kernels.gate_expert import GateExpert, round_bf16
from smoe_tpu_torch.parallel.compat import psum, pvary

# Floor for the gating denominator.  Reference writes `10e-12` (= 1e-11),
# smoe.py:821.
DENOM_FLOOR = 1e-11


class ForwardOut(NamedTuple):
    res: torch.Tensor                   # (N, C) clipped + fake-quantized
    w_e: Optional[torch.Tensor]         # (N, K) culled gating weights
    survivors: torch.Tensor             # (K,) bool
    maha: Optional[torch.Tensor]        # (N, K)


def clip_unit(x: torch.Tensor) -> torch.Tensor:
    """jnp.clip(x, 0, 1) with its gradient.

    Every clamp a gradient passes through in the port is torch.maximum /
    torch.minimum against a 0-dim constant, never torch.clamp: at an exact
    tie their gradient is 0.5, as jnp.maximum's and jnp.clip's are, where
    torch.clamp's is 1."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def is_bf16(cfg: SmoeConfig) -> bool:
    """Whether the fit computes its products from bf16 operands: exactly
    compute_dtype == "bfloat16", as in the JAX package."""
    return cfg.compute_dtype == "bfloat16"


def _operand(x: torch.Tensor, cfg: SmoeConfig) -> torch.Tensor:
    """x as a product of the plain path takes it: rounded to bf16 under
    compute_dtype="bfloat16" (JAX's x.astype(bfloat16); the cotangent is
    rounded too), else as it is."""
    return round_bf16(x) if is_bf16(cfg) else x


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


def dual_domain_features(coords_t: torch.Tensor, coords_raw: torch.Tensor,
                         q: torch.Tensor, model_mask: torch.Tensor):
    """Concatenated features for the dual-model video mode (model.py:65-77):
    the per-kernel domain select folded into the quadratic-feature product.

    Returns (phi2 (N, 2F), q2 (K, 2F)) with
        phi2 @ q2^T == where(model_mask, phi_t @ q^T, phi_raw @ q^T):
    half of every q2 row is exact zeros.
    """
    phi2 = torch.cat([quadratic_features(coords_t),
                      quadratic_features(coords_raw)], dim=-1)
    mm = model_mask.to(q.dtype)[:, None]
    q2 = torch.cat([q * mm, q * (1.0 - mm)], dim=-1)
    return phi2, q2


def det_diag(diag_A: torch.Tensor) -> torch.Tensor:
    """prod(diag A) per kernel, (K, d) -> (K,), as a chain of multiplies:
    the backward of torch.prod looks for zeros with `nonzero`, which waits
    for the card once per backward."""
    out = diag_A[:, 0]
    for i in range(1, diag_A.shape[1]):
        out = out * diag_A[:, i]
    return out


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
                coords: torch.Tensor,
                coords_raw: Optional[torch.Tensor] = None,
                model_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, K) Mahalanobis distances given the assembled steering factor A
    (model.py:102-144).

    train_inverse_cov: maha = x^T A x (A already symmetrized);
    otherwise:         maha = x^T A A^T x, clamped at 0 (the quadratic-
    feature form can go slightly negative under f32 cancellation).

    Dual-model video: kernels with model_mask False are evaluated on
    `coords_raw` instead of the motion-transformed `coords`, through one
    product over the concatenated features (`dual_domain_features`).
    compute_dtype="bfloat16": phi and q rounded to bf16 for the product.
    """
    B = A if cfg.train_inverse_cov else _aat(A)
    q = kernel_quadratics(B, musX)
    if coords_raw is not None and model_mask is not None:
        phi, q = dual_domain_features(coords, coords_raw, q, model_mask)
    else:
        phi = quadratic_features(coords)
    maha = _exact_matmul(_operand(phi, cfg), _operand(q.T, cfg))
    if not cfg.train_inverse_cov:
        maha = torch.maximum(maha, maha.new_zeros(()))
    return maha


def gating(maha: torch.Tensor, pis: torch.Tensor, diag_A: torch.Tensor,
           cfg: SmoeConfig, kernel_mask: torch.Tensor,
           kernel_group=None) -> torch.Tensor:
    """Softmax-like gating with influence culling (model.py:155-185,
    reference smoe.py:807-827).  (N,K) -> (N,K).

    kernel_group: the process group of the 'k' mesh dimension when the
    kernel rows are split over ranks.  The denominator is then psum'd over
    it, and pvary'd back where it meets this rank's kernels, so that each
    rank's share of its gradient is summed (parallel/compat.py)."""
    mask = kernel_mask & (pis > 0)
    # mask inside the exp so dead kernels can never give inf * 0 = nan
    n_exp = torch.exp(-0.5 * torch.where(mask[None, :], maha,
                                         torch.zeros_like(maha)))
    if cfg.use_determinant:
        n_div = det_diag(diag_A)
        n_quo = n_div / math.sqrt((2.0 * math.pi) ** cfg.dim_domain)
        n_exp = n_exp * n_quo[None, :]
    n_w = n_exp * torch.where(mask, pis, torch.zeros_like(pis))[None, :]
    denom = torch.sum(n_w, dim=1, keepdim=True)
    if kernel_group is not None:
        denom = pvary(psum(denom, kernel_group), kernel_group)
    denom = torch.maximum(n_w.new_full((), DENOM_FLOOR), denom)
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
                      cfg: SmoeConfig, kernel_group=None) -> torch.Tensor:
    """res[n,c] = sum_k w[n,k] (gamma_k^T x_n + nu_k)  (model.py:188-215,
    reference smoe.py:840-848).  kernel_group: each rank's partial sum over
    its kernels is psum'd over the 'k' group.  compute_dtype="bfloat16":
    w_e, nu_e and gamma_e rounded to bf16 for the two products, w_e once
    for each (JAX casts it twice, and so rounds each cotangent apart)."""
    k, d, c = gamma_e.shape
    res = _exact_matmul(_operand(w_e, cfg), _operand(nu_e, cfg))
    if cfg.train_gammas:
        gamma_e = _masked_gamma(gamma_e, cfg)
        g = _exact_matmul(_operand(w_e, cfg), _operand(
            gamma_e.reshape(k, d * c), cfg)).reshape(-1, d, c)
        res = res + (coords[:, :, None] * g).sum(1)
    return psum(res, kernel_group)


def fake_quant_unit(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Fake-quantize values in [0,1] to `bits` with a straight-through
    gradient (model.py:218-226; reference smoe.py:899).  torch.round
    rounds half to even, as jnp.round does."""
    steps = (1 << bits) - 1
    q = torch.round(torch.clamp(x, 0.0, 1.0) * steps) / steps
    return x + (q - x).detach()


def resolve_fused(use_pallas: str, device) -> bool:
    """Whether the trainer takes the fused op (counterpart of
    model.py:229-247 `resolve_pallas`).

    'auto' takes it on a CUDA device and the plain path on the CPU, as
    JAX's 'auto' takes the XLA path off the TPU; 'on' takes it everywhere
    (on the CPU the fused op runs through its plain versions); 'off' takes
    the plain path."""
    if use_pallas == "packed":
        raise ValueError(
            "use_pallas='packed' was removed from the JAX package: capped-"
            "dense ('auto') is faster at every measured size (see ROADMAP.md)")
    if use_pallas not in ("auto", "on", "off"):
        raise ValueError(f"use_pallas must be 'auto', 'on' or 'off', got "
                         f"{use_pallas!r}")
    if use_pallas == "off":
        return False
    return use_pallas == "on" or torch.device(device).type == "cuda"


def fused_op_inputs(A: torch.Tensor, musX: torch.Tensor, nu_e: torch.Tensor,
                    gamma_e: torch.Tensor, pis: torch.Tensor, cfg: SmoeConfig,
                    coords: torch.Tensor, kernel_mask: torch.Tensor,
                    coords_raw: Optional[torch.Tensor] = None,
                    model_mask: Optional[torch.Tensor] = None):
    """The fused op's operands at full width, built as model.py:284-316
    builds them: (phi (N, F), xe (N, E), q (K, F), G (K, E*C) contiguous,
    pi_det (K,) float, mask (K,) float, thr, floor).  With coords_raw and
    model_mask (dual-model video) phi and q are the 2F-wide dual-domain
    features; xe and G stay on `coords`, the transformed domain."""
    B = A if cfg.train_inverse_cov else _aat(A)
    q = kernel_quadratics(B, musX)

    mask = kernel_mask & (pis > 0)
    zero = torch.zeros_like(pis)
    if cfg.use_determinant:
        diag_A = torch.diagonal(A, dim1=1, dim2=2)
        det = det_diag(diag_A) / math.sqrt(
            (2.0 * math.pi) ** cfg.dim_domain)
        pi_det = torch.where(mask, pis * det, zero)
    else:
        pi_det = torch.where(mask, pis, zero)

    k, d, c = gamma_e.shape
    if coords_raw is not None and model_mask is not None:
        phi, q = dual_domain_features(coords, coords_raw, q, model_mask)
    else:
        phi = quadratic_features(coords)
    ones = torch.ones((coords.shape[0], 1), dtype=coords.dtype,
                      device=coords.device)
    if cfg.train_gammas:
        gamma_e = _masked_gamma(gamma_e, cfg)
        xe = torch.cat([coords, ones], dim=1)
        G = torch.cat([gamma_e.reshape(k, d * c), nu_e], dim=1)
    else:
        xe, G = ones, nu_e
    return (phi, xe, q, G.contiguous(), pi_det.float(), mask.float(),
            float(cfg.minimum_influence), float(DENOM_FLOOR))


def forward_fused(A: torch.Tensor, musX: torch.Tensor, nu_e: torch.Tensor,
                  gamma_e: torch.Tensor, pis: torch.Tensor, cfg: SmoeConfig,
                  coords: torch.Tensor, kernel_mask: torch.Tensor,
                  sv_add: Optional[torch.Tensor] = None,
                  k_cap: Optional[int] = None,
                  coords_raw: Optional[torch.Tensor] = None,
                  model_mask: Optional[torch.Tensor] = None) -> ForwardOut:
    """Forward through the fused gate+expert op (model.py:250-342): builds
    q, pi_det, phi, xe and G as model.py:284-316 does (`fused_op_inputs`)
    and calls `kernels.gate_expert.GateExpert`, whose backward is the K2
    kernel.  Gradients flow to A, musX, nu_e, gamma_e and pis; coords carry
    none, so a video fit with trainable motion (`train_trafo`) takes the
    plain path, as in the JAX package (trainer.py:159-160).

    coords_raw, model_mask: dual-model video.  coords are then the motion-
    transformed pixels, coords_raw the raw ones, and the op sees 2F-wide
    features (`dual_domain_features`; F = 13, so K1 and K2 run at 26).

    compute_dtype="bfloat16": the op rounds phi and q' to bf16 for the maha
    (K1's and K2's bf16 instances on the card; model.py:328, 336).

    k_cap: width cap of the capped-dense mode (model.py:318-329): the
    caller guarantees every kernel list holds at most k_cap active kernels;
    the active kernels are gathered first, in index order (a stable sort,
    as jnp.argsort), the op runs at the narrow width and the survivors are
    scattered back.  A falsy cap means no cap.
    sv_add: (N,) residual added to the Y channel before the clip
    (model.py:337-339).
    """
    if coords.requires_grad:
        raise NotImplementedError(
            "forward_fused gives coords no gradient: a train_trafo video "
            "fit takes the plain path (maha_from_A, gating, "
            "expert_regression)")
    phi, xe, q, G, pi_det, mask, thr, floor = fused_op_inputs(
        A, musX, nu_e, gamma_e, pis, cfg, coords, kernel_mask,
        coords_raw=coords_raw, model_mask=model_mask)
    k = q.shape[0]
    bf16 = is_bf16(cfg)
    if k_cap and k_cap < k:
        order = torch.argsort((mask == 0).to(torch.int32), stable=True)[:k_cap]
        res_raw, surv_c = GateExpert.apply(
            phi, xe, q[order], G[order], pi_det[order], mask[order], thr,
            floor, bf16)
        surv = torch.zeros((k,), dtype=surv_c.dtype,
                           device=surv_c.device).index_put((order,), surv_c)
    else:
        res_raw, surv = GateExpert.apply(phi, xe, q, G, pi_det, mask, thr,
                                         floor, bf16)
    if sv_add is not None:
        res_raw = torch.cat([res_raw[:, :1] + sv_add[:, None], res_raw[:, 1:]],
                            dim=1)
    res = fake_quant_unit(clip_unit(res_raw), cfg.precision)
    return ForwardOut(res=res, w_e=None, survivors=surv > 0, maha=None)


def smoe_forward(params: SmoeParams, cfg: SmoeConfig,
                 coords: torch.Tensor,
                 kernel_mask: Optional[torch.Tensor] = None,
                 coords_raw: Optional[torch.Tensor] = None,
                 model_mask: Optional[torch.Tensor] = None,
                 A_override: Optional[torch.Tensor] = None) -> ForwardOut:
    """Full plain forward pass on a flat pixel set (model.py:345-367).

    coords: (N, d) in [0,1]^d (already motion-transformed if applicable;
    coords_raw and model_mask route dual-model kernels).  kernel_mask:
    (K,) bool per-block kernel list (defaults to all-on).  A_override:
    explicit (K, d, d) steering factor (decode path).
    """
    if kernel_mask is None:
        kernel_mask = torch.ones((params.capacity,), dtype=torch.bool,
                                 device=params.pis.device)
    A = A_override if A_override is not None else assemble_A(params, cfg)
    maha = maha_from_A(A, params.musX, cfg, coords, coords_raw, model_mask)
    diag_A = torch.diagonal(A, dim1=1, dim2=2)
    w_e = gating(maha, params.pis, diag_A, cfg, kernel_mask)
    res = expert_regression(w_e, coords, params.nu_e, params.gamma_e, cfg)
    res = fake_quant_unit(clip_unit(res), cfg.precision)
    survivors = torch.any(w_e > cfg.minimum_influence, dim=0)
    return ForwardOut(res=res, w_e=w_e, survivors=survivors, maha=maha)
