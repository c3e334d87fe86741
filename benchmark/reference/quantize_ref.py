"""Frozen copy of the port's post-hoc quantizer and its dequantizer
(`smoe_tpu_torch/codec/quantize.py` up to `rescaler`, itself a numpy copy
of the reference quantizer.py:4-145), for the benchmark's reference of the
serving decode: the benchmark's own params go through these to the
dequantized values a decoder must reproduce from the coded file.  The
arithmetic and op order are unchanged; `cfg` is any object with the
config's attributes (`codec_cfg`).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np

RANGE_EPS = 10e-12   # reference quantizer.py:58

CODEC_DEFAULTS = dict(
    dim_domain=2, train_inverse_cov=False, radial_as=False,
    canonicalize_steering=True, quantization_mode=0,
    bit_depths=(20, 18, 6, 10, 10), quantize_pis=False,
    lower_bounds=(-2500.0, -0.3, -5.0, 0.0, -32.0),
    upper_bounds=(2500.0, 1.3, 5.0, 2.0, 32.0), gamma_anchor=False,
    gamma_anchor_eps=1.0, nu_anchor=False, train_gammas=True,
    use_diff_center=False)


def codec_cfg(**overrides) -> SimpleNamespace:
    """The codec settings of a configuration (the port's SmoeConfig
    defaults, overridden by the configuration file's `codec` group)."""
    kw = dict(CODEC_DEFAULTS)
    kw.update(overrides)
    kw["bit_depths"] = tuple(kw["bit_depths"])
    return SimpleNamespace(**kw)
def reduce_params(params: Dict[str, np.ndarray]):
    """Drop dead kernels (reference utils.py:7-15). Returns (reduced, idx)."""
    idx = params["pis"] > 0
    out = {k: (v[idx] if k in ("pis", "A_diagonal", "A_corr", "musX",
                               "nu_e", "gamma_e") else v)
           for k, v in params.items()}
    return out, idx


def canonicalize_steering(params: Dict[str, np.ndarray], cfg
                          ) -> Dict[str, np.ndarray]:
    """Flip steering-factor columns so every diagonal entry is positive.

    A A^T (the Mahalanobis quadratic form, core/model.maha_from_A) is
    invariant to per-column sign flips of the lower-triangular factor; the
    only forward-path consumer of the sign is the determinant normalizer
    prod(diag A) in the gating (core/model.gating, reference
    smoe.py:809-815).  Training can drift kernels into prod(diag A) < 0 —
    a fragile state whose near-zero gating denominators quantization
    perturbs catastrophically.  Canonicalizing at encode removes the
    hazard and tightens the A quantization bounds (measured r3: CIF video
    decode 14.0 -> 24.4 dB with 278/1280 kernels affected; 256^2 image
    +6.3 dB from a single kernel).  Beyond-reference: the reference codec
    preserves trained signs (quantizer.py:4-83).

    No-op for train_inverse_cov (the symmetrized form has no column-sign
    freedom).  Radial: a <- |a| (maha uses a^2; the normalizer is a^d).
    """
    if cfg.train_inverse_cov:
        return params
    p = {k: (np.array(v) if k in ("A_diagonal", "A_corr") else v)
         for k, v in params.items()}
    if cfg.radial_as:
        p["A_diagonal"] = np.abs(p["A_diagonal"])
        return p
    Ad, Ac = p["A_diagonal"], p["A_corr"]
    for j in range(cfg.dim_domain):
        flip = Ad[:, j, j] < 0
        Ad[flip, j, j] *= -1.0
        Ac[flip, :, j] *= -1.0      # column j's sub-diagonal lives in corr
    return p


def _whiten_scale(rA_full: np.ndarray, eps: float) -> np.ndarray:
    """Deterministic per-(kernel, axis) whitening scale for gamma coding
    (config.gamma_anchor): |diag| of the decoded steering factor, floored
    at eps.  Both encoder and decoder derive it from the SAME dequantized
    A, so gamma = w_q * scale inverts the coded w = gamma / scale exactly.

    Diagonal-only by design: whitening by the full triangular factor
    (w = A^-1 gamma, the mathematically exact per-Mahalanobis-unit slope)
    EXPLODED on the dual-model video fits — A_corr reaches ~±350 over
    unit-scale diagonals there, so A^-1 carries ~1e5 entries and the
    whitened bounds blew up to ±1300 (decoded 5.6 dB, run
    smoe_vidq_1w5pouz0, 2026-08-19).  |diag A| is the per-axis bandwidth;
    it captures the sharp-kernel-steep-slope correlation that stretches
    the bounds while staying perfectly conditioned."""
    diag = np.abs(np.diagonal(np.asarray(rA_full, np.float64),
                              axis1=1, axis2=2))
    return np.maximum(diag, eps)                        # (K, d)


def quantize_params(params: Dict[str, np.ndarray], cfg,
                    musX_grid: Optional[np.ndarray] = None
                    ) -> Dict[str, np.ndarray]:
    """Uniform scalar quantization of the reduced parameter set.

    params: dict with pis/musX/A_diagonal/A_corr/nu_e/gamma_e (full capacity;
    reduced internally).  Matches reference quantizer.quantize_params.

    musX_grid: full-capacity init-grid centers — required only for
    cfg.nu_anchor + cfg.use_diff_center (the anchor needs the decoder's
    ABSOLUTE centers; rescaler takes the same grid).
    """
    params, used = reduce_params(dict(params))
    if cfg.canonicalize_steering:
        params = canonicalize_steering(params, cfg)
    qm = cfg.quantization_mode
    bd = cfg.bit_depths
    radial = cfg.radial_as

    def data_bounds(x):
        return (np.amin(x, axis=0, keepdims=True),
                np.amax(x, axis=0, keepdims=True))

    d, c = cfg.dim_domain, params["nu_e"].shape[-1]
    if qm <= 1 or qm == 3:
        lb_Ad, ub_Ad = data_bounds(params["A_diagonal"])
        if not radial:
            lb_Ac, ub_Ac = data_bounds(params["A_corr"])
        lb_mu, ub_mu = data_bounds(params["musX"])
        lb_nu, ub_nu = data_bounds(params["nu_e"])
        lb_g, ub_g = data_bounds(params["gamma_e"])
    elif qm == 2:
        shape_A = (1,) if radial else (1, d, d)
        lb_Ad = np.full(shape_A, cfg.lower_bounds[0])
        ub_Ad = np.full(shape_A, cfg.upper_bounds[0])
        if not radial:
            lb_Ac = np.full((1, d, d), cfg.lower_bounds[0])
            ub_Ac = np.full((1, d, d), cfg.upper_bounds[0])
        lb_mu = np.full((1, d), cfg.lower_bounds[1])
        ub_mu = np.full((1, d), cfg.upper_bounds[1])
        lb_nu = np.full((1, c), cfg.lower_bounds[2])
        ub_nu = np.full((1, c), cfg.upper_bounds[2])
        lb_g = np.full((1, d, c), cfg.lower_bounds[4])
        ub_g = np.full((1, d, c), cfg.upper_bounds[4])
    else:
        raise ValueError(f"unknown quantization mode {qm}")

    if qm <= 1 and not cfg.quantize_pis:
        lb_pi, ub_pi = data_bounds(params["pis"])
    else:
        lb_pi = np.full((1,), cfg.lower_bounds[3])
        ub_pi = np.full((1,), cfg.upper_bounds[3])

    steps = {"A": 2 ** bd[0] - 1, "musX": 2 ** bd[1] - 1,
             "nu_e": 2 ** bd[2] - 1, "pis": 2 ** bd[3] - 1,
             "gamma_e": 2 ** bd[4] - 1}

    def q(x, lb, ub, step):
        return np.round((x - lb) / (ub - lb + RANGE_EPS) * step)

    def deq(v, lb, ub, step):
        return v / step * (ub - lb) + lb

    nu_val = params["nu_e"]
    q_mu = q(params["musX"], lb_mu, ub_mu, steps["musX"])

    g_val = params["gamma_e"]
    g_anchored = bool(cfg.gamma_anchor and cfg.train_gammas and qm != 2
                      and not cfg.train_inverse_cov)
    g_scale = None
    if g_anchored:
        # steering-whitened slope coding (config.gamma_anchor): code
        # w = gamma / |diag A| per axis — a steep slope on a sharp kernel
        # codes small, so LS-fitted fits stop stretching the shared
        # data-derived gamma bounds.  The scale comes from the DEQUANTIZED
        # A (coded above), so the decoder's scale is identical.
        q_Ad = q(params["A_diagonal"], lb_Ad, ub_Ad, steps["A"])
        r_Ad = deq(q_Ad, lb_Ad, ub_Ad, steps["A"])
        if radial:
            k = r_Ad.shape[0]
            rA_full = np.zeros((k, d, d))
            rA_full[:, np.arange(d), np.arange(d)] = r_Ad[:, None]
        else:
            rA_full = r_Ad
        g_scale = _whiten_scale(rA_full, cfg.gamma_anchor_eps)   # (K, d)
        g_val = np.asarray(params["gamma_e"], np.float64) \
            / g_scale[:, :, None]
        lb_g, ub_g = data_bounds(g_val)

    q_g = q(g_val, lb_g, ub_g, steps["gamma_e"])
    anchored = bool(cfg.nu_anchor and cfg.train_gammas and qm != 2)
    if anchored:
        # center-anchored offset coding (see config.nu_anchor): code the
        # expert value AT the decoded center, nu' = nu + gamma_q . mu_q,
        # using the DEQUANTIZED gamma/musX so the decoder's subtraction
        # (rescaler) inverts it exactly.  Tightens the data-derived nu
        # bounds when LS-fitted slopes make origin-nu an extrapolation
        # artifact.  Needs the absolute centers under use_diff_center.
        r_mu = deq(q_mu, lb_mu, ub_mu, steps["musX"])
        if cfg.use_diff_center:
            if musX_grid is None:
                raise ValueError(
                    "nu_anchor with use_diff_center needs musX_grid "
                    "(the decoder anchors at grid + decoded diff)")
            r_mu = r_mu + np.asarray(musX_grid, np.float64)[used]
        r_g = deq(q_g, lb_g, ub_g, steps["gamma_e"])
        if g_anchored:
            # un-whiten: the decoder's effective gamma
            r_g = r_g * g_scale[:, :, None]
        nu_val = params["nu_e"] + np.einsum("kd,kdc->kc", r_mu, r_g)
        lb_nu, ub_nu = data_bounds(nu_val)

    lower = {"A_diagonal": lb_Ad, "musX": lb_mu, "nu_e": lb_nu,
             "pis": lb_pi, "gamma_e": lb_g}
    upper = {"A_diagonal": ub_Ad, "musX": ub_mu, "nu_e": ub_nu,
             "pis": ub_pi, "gamma_e": ub_g}
    out = {"lower_bounds": lower, "upper_bounds": upper, "steps": steps,
           "A_diagonal": q(params["A_diagonal"], lb_Ad, ub_Ad, steps["A"]),
           "musX": q_mu,
           "nu_e": q(nu_val, lb_nu, ub_nu, steps["nu_e"]),
           "pis": q(params["pis"], lb_pi, ub_pi, steps["pis"]),
           "gamma_e": q_g,
           "used_kernels": used}
    if anchored:
        out["nu_anchor"] = True
    if g_anchored:
        out["gamma_anchor"] = True
        out["gamma_anchor_eps"] = float(cfg.gamma_anchor_eps)
    if not radial:
        lower["A_corr"] = lb_Ac
        upper["A_corr"] = ub_Ac
        out["A_corr"] = q(params["A_corr"], lb_Ac, ub_Ac, steps["A"])
    return out


def subset_qparams(qparams: Dict, keep) -> Dict:
    """Restrict a quantized parameter set to a row subset — post-hoc
    kernel pruning (no reference analog; the RD-prune search in
    cli/reconstruct --prune rides the layered bitstream's importance
    ordering).  keep: boolean mask or index array over the REDUCED rows.
    Bounds/steps are unchanged, so the kept rows' integers decode
    bit-identically; used_kernels is rewritten to the surviving slots.
    """
    keep = np.asarray(keep)
    rows = np.flatnonzero(keep) if keep.dtype == bool else np.sort(keep)
    used_slots = np.flatnonzero(np.asarray(qparams["used_kernels"], bool))
    new_used = np.zeros(np.asarray(qparams["used_kernels"]).size, bool)
    new_used[used_slots[rows]] = True
    out = dict(qparams)
    out["used_kernels"] = new_used
    for name in ("A_diagonal", "A_corr", "musX", "nu_e", "pis", "gamma_e"):
        if name in out:
            out[name] = np.asarray(out[name])[rows]
    return out


def rescaler(qparams: Dict, cfg,
             musX_grid: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """Dequantize and reassemble (reference quantizer.py:85-145).

    Returns dict with full A (K', d, d), musX, nu_e, pis, gamma_e.
    musX_grid: initial grid centers of the used kernels, required when
    cfg.use_diff_center (reference quantizer.py:140-141).
    """
    st = qparams["steps"]
    lo, up = qparams["lower_bounds"], qparams["upper_bounds"]

    def r(name, skey):
        return (qparams[name] / st[skey] * (up[name] - lo[name]) + lo[name])

    rA_diag = r("A_diagonal", "A")
    rmusX = r("musX", "musX")
    rnu = r("nu_e", "nu_e")
    rpis = r("pis", "pis")
    rg = r("gamma_e", "gamma_e")

    if cfg.radial_as:
        k = rA_diag.shape[0]
        rA = np.zeros((k, cfg.dim_domain, cfg.dim_domain))
        for i in range(k):
            np.fill_diagonal(rA[i], rA_diag[i])
    else:
        rA = rA_diag + r("A_corr", "A")

    if cfg.use_diff_center:
        assert musX_grid is not None, "use_diff_center needs the grid centers"
        rmusX = rmusX + musX_grid

    if qparams.get("gamma_anchor", False):
        # invert the steering-whitened slope coding (config.gamma_anchor):
        # the coded values are w = gamma / scale with the scale derived
        # from the SAME dequantized A available here — gamma = w * scale
        scale = _whiten_scale(rA, qparams.get("gamma_anchor_eps", 1.0))
        rg = np.asarray(rg, np.float64) * scale[:, :, None]

    if qparams.get("nu_anchor", False):
        # invert the center-anchored offset coding (config.nu_anchor):
        # the coded value is the expert surface AT the decoded center, so
        # nu = nu' - gamma_q . mu_q with the decoder's own dequantized
        # gamma/musX (deterministic — decode stays exactly reproducible)
        rnu = rnu - np.einsum("kd,kdc->kc", np.asarray(rmusX, np.float64),
                              np.asarray(rg, np.float64))

    return {"A": rA.astype(np.float32), "musX": rmusX.astype(np.float32),
            "nu_e": rnu.astype(np.float32), "pis": rpis.astype(np.float32),
            "gamma_e": rg.astype(np.float32)}


