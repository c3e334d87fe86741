"""Quantization-aware training: TF-semantics fake-quant with a straight-
through gradient (from smoe_tpu/core/quant.py:24-42, 79-96).

Modes (reference smoe_test.py:298-301):
  0: none
  1: post-hoc quantize/rescale each validation (codec/quantize.py)
  2, 3: in-graph fake-quant of every parameter group — not ported yet
     (ROADMAP.md Queue 1 item 9); `apply_qat` raises for them.
  `quantize_pis` fake-quantizes the pis in any mode.
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


def apply_qat(params: SmoeParams, cfg: SmoeConfig) -> SmoeParams:
    """The effective (fake-quantized) params the forward pass sees
    (quant.py:79-96).  Modes 0 and 1 leave every group as it is, apart
    from the pis under `quantize_pis`."""
    qm = cfg.quantization_mode
    if qm >= 2:
        raise NotImplementedError(
            f"quantization_mode {qm} (in-graph QAT) is not ported yet "
            "(ROADMAP.md Queue 1 item 9)")
    if not cfg.quantize_pis:
        return params
    lb, ub, bd = cfg.lower_bounds, cfg.upper_bounds, cfg.bit_depths
    return dataclasses.replace(
        params, pis=fake_quant(params.pis, lb[3], ub[3], bd[3]))

