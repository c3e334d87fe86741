"""Quantization-aware training: TF-semantics fake-quant with a straight-
through gradient, and the mode-2/3 parameter wrapping (from
smoe_tpu/core/quant.py:24-136; reference smoe.py:473-538).

Modes (reference smoe_test.py:298-301):
  0: none
  1: post-hoc quantize/rescale each validation (codec/quantize.py)
  2: in-graph fake-quant with FIXED bounds per group
  3: in-graph fake-quant with bounds derived from the active (pis > 0)
     kernels
  pis are always fake-quantized for modes >= 2 (smoe_test.py:36-37), and
  `quantize_pis` fake-quantizes them in any mode.  The motion rows of a
  video fit are fake-quantized to 8 bits with per-row bounds for modes >= 2
  (quant.py:130-135).
"""

from __future__ import annotations

import dataclasses

import torch

from smoe_tpu_torch.config import SmoeConfig
from smoe_tpu_torch.core.params import SmoeParams


def fake_quant(x: torch.Tensor, min_val, max_val, bits: int) -> torch.Tensor:
    """tf.fake_quant_with_min_max_args/vars semantics (quant.py:24-42).

    Nudges the range so zero is exactly representable, clips, rounds to
    2^bits-1 steps, and passes a straight-through gradient that is zero
    outside the nudged range.  The clip is torch.maximum / torch.minimum, so
    its gradient at a tie is jnp.clip's 0.5.
    """
    quant_max = float((1 << bits) - 1)
    # bounds are filled on x's device, never copied from the host
    min_val, max_val = (v.to(torch.float32) if torch.is_tensor(v)
                        else torch.full((), float(v), dtype=torch.float32,
                                        device=x.device)
                        for v in (min_val, max_val))
    scale = (max_val - min_val) / quant_max
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    zero_point_from_min = -min_val / scale
    nudged_zp = torch.clamp(torch.round(zero_point_from_min), 0.0, quant_max)
    nudged_min = (0.0 - nudged_zp) * scale
    nudged_max = (quant_max - nudged_zp) * scale
    clamped = torch.minimum(torch.maximum(x, nudged_min), nudged_max)
    q = torch.round((clamped - nudged_min) / scale) * scale + nudged_min
    return clamped + (q - clamped).detach()


def _masked_min_max(x: torch.Tensor, mask: torch.Tensor):
    """min / max of x over the rows where mask holds, detached
    (quant.py:45-76): the bounds carry no gradient, a documented deviation
    of the JAX package from the reference.  With no row active the
    sentinel bounds come back inverted (+big, -big) and collapse to the
    degenerate range [0, 0], which fake_quant passes through."""
    big = 3.4e38
    m = mask.reshape((-1,) + (1,) * (x.ndim - 1))
    x = x.detach()
    mn = torch.min(torch.where(m, x, torch.full_like(x, big)))
    mx = torch.max(torch.where(m, x, torch.full_like(x, -big)))
    empty = mn > mx
    zero = torch.zeros_like(mn)
    return torch.where(empty, zero, mn), torch.where(empty, zero, mx)


def apply_qat(params: SmoeParams, cfg: SmoeConfig) -> SmoeParams:
    """The effective (fake-quantized) params the forward pass sees
    (quant.py:79-136).  Modes 0 and 1 leave every group as it is, apart
    from the pis under `quantize_pis`."""
    lb, ub, bd = cfg.lower_bounds, cfg.upper_bounds, cfg.bit_depths
    qm = cfg.quantization_mode
    pis = params.pis
    if qm >= 2 or cfg.quantize_pis:
        pis = fake_quant(pis, lb[3], ub[3], bd[3])
    if qm < 2:
        return params if pis is params.pis else dataclasses.replace(
            params, pis=pis)
    if qm == 2:
        a_diag = fake_quant(params.a_diag, lb[0], ub[0], bd[0])
        a_corr = fake_quant(params.a_corr, lb[0], ub[0], bd[0])
        musX = fake_quant(params.musX, lb[1], ub[1], bd[1])
        nu_e = fake_quant(params.nu_e, lb[2], ub[2], bd[2])
        gamma_e = fake_quant(params.gamma_e, lb[4], ub[4], bd[4])
    elif qm == 3:
        active = pis > 0
        diag_vals = params.a_diag if cfg.radial_as else torch.diagonal(
            params.a_diag, dim1=1, dim2=2)
        mn, mx = _masked_min_max(diag_vals, active)
        # shift-to-zero trick (reference smoe.py:497-511)
        a_diag = fake_quant(params.a_diag - mn, 0.0, mx - mn, bd[0]) + mn
        mn, mx = _masked_min_max(params.a_corr, active)
        a_corr = fake_quant(params.a_corr, mn, mx, bd[0])
        if cfg.train_musx:
            mn, mx = _masked_min_max(params.musX, active)
            musX = fake_quant(params.musX, mn, mx, bd[1])
        else:
            musX = params.musX
        mn, mx = _masked_min_max(params.nu_e, active)
        nu_e = fake_quant(params.nu_e - mn, 0.0, mx - mn, bd[2]) + mn
        mn, mx = _masked_min_max(params.gamma_e, active)
        gamma_e = fake_quant(params.gamma_e, mn, mx, bd[4])
    else:
        raise ValueError(f"unknown quantization mode {qm}")
    out = dataclasses.replace(params, pis=pis, a_diag=a_diag, a_corr=a_corr,
                              musX=musX, nu_e=nu_e, gamma_e=gamma_e)
    if params.motion is not None:
        # 8-bit fake-quant of the motion rows with per-row bounds that carry
        # no gradient (quant.py:130-135, reference smoe.py:588-641)
        m = params.motion.detach()
        mn = torch.amin(m, dim=1, keepdim=True)
        mx = torch.amax(m, dim=1, keepdim=True)
        out = dataclasses.replace(out, motion=fake_quant(
            params.motion - mn, 0.0, mx - mn, 8) + mn)
    return out

