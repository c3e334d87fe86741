"""Losses and regularizers (from smoe_tpu/core/losses.py:22-106).

Reference smoe.py:902-1053:
  * eps-insensitive squared error: max(0, (|res-target| - eps))^2, with
    eps = margin / 2^precision and optional per-pixel loss weights
  * YUV channel weighting 6/8 : 1/8 : 1/8
  * L1 on pis (sparsification), L1 on diag(A) (bandwidth)
  * L1 - L2 on the support-vector residual's coefficients
  * reported MSE scaled by (2^precision)^2 so PSNR = 10 log10((2^p)^2 / mse)
The SSIM loss is core/ssim.py.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from smoe_tpu_torch.config import SmoeConfig
from smoe_tpu_torch.core.params import SmoeParams, diag_of_A


class LossAux(NamedTuple):
    mse: torch.Tensor          # scaled by (2^p)^2
    err_map: torch.Tensor      # per-pixel mean-channel squared error
    loss_pixel: torch.Tensor


def pixel_loss(res: torch.Tensor, target: torch.Tensor, cfg: SmoeConfig,
               loss_weights: Optional[torch.Tensor] = None,
               valid_mask: Optional[torch.Tensor] = None) -> LossAux:
    """eps-insensitive data term over a flat (N, C) block (losses.py:28-70).

    `valid_mask` (N,) combines the overlap crop (reference smoe.py:909-923)
    and the 4D train mask (smoe.py:902-904): masked-out pixels contribute
    neither to the loss nor to the mean's denominator; a float mask weighs
    each pixel's squared error linearly.
    """
    diff = res - target
    if valid_mask is not None:
        vm = valid_mask.to(res.dtype)[:, None]
        denom = torch.maximum(torch.sum(valid_mask.to(res.dtype)),
                              torch.ones((), dtype=res.dtype,
                                         device=res.device))
    else:
        vm = None
        denom = torch.full((), float(res.shape[0]), dtype=res.dtype,
                           device=res.device)

    sq = torch.square(diff)
    if vm is not None:
        sq = sq * vm
    mse = torch.sum(sq) / (denom * res.shape[1]) * float(2 ** cfg.precision) ** 2

    # |diff| with jnp.abs's derivative, +1 at diff == 0 (torch.abs gives 0
    # there, and a fake-quantized res equals an 8-bit target exactly on
    # many pixels); the max(0, .) of a square only differs on NaN
    lp = torch.square(abs_jax(diff) - cfg.epsilon)
    if vm is not None:
        lp = lp * vm
    if loss_weights is not None:
        lp = lp * loss_weights[:, None]
    if cfg.use_yuv and res.shape[1] == 3:
        per_chan = torch.sum(lp, dim=0) / denom                 # (3,)
        loss = 6.0 / 8.0 * per_chan[0] + 1.0 / 8.0 * (per_chan[1] + per_chan[2])
    else:
        loss = torch.sum(lp) / (denom * res.shape[1])

    err_map = torch.mean(sq, dim=1)          # reference smoe.py:906 (sampling prob)
    return LossAux(mse=mse, err_map=err_map, loss_pixel=loss)


def pis_l1_reg(params: SmoeParams, cfg: SmoeConfig,
               active_mask: torch.Tensor, weight: float,
               num_active: torch.Tensor) -> torch.Tensor:
    """L1 sparsifier on the active pis (reference smoe.py:1018-1027).

    Normalizer is start_pis, or the live kernel count when
    kernel_count_as_norm_l1 (smoe_test.py flag -kcn).
    """
    s = torch.sum(torch.where(active_mask, params.pis,
                              torch.zeros_like(params.pis)))
    norm = num_active.to(torch.float32) if cfg.kernel_count_as_norm_l1 \
        else float(cfg.start_pis)
    return weight * s / norm


def bandwidth_l1_reg(params: SmoeParams, cfg: SmoeConfig,
                     active_mask: torch.Tensor, weight: float) -> torch.Tensor:
    """u_l1 * sum(diag(A)) over active kernels (reference smoe.py:1044)."""
    diag = diag_of_A(params, cfg)                              # (K, d)
    return weight * torch.sum(torch.where(active_mask[:, None], diag,
                                          torch.zeros_like(diag)))


def abs_jax(x: torch.Tensor) -> torch.Tensor:
    """|x| with jnp.abs's derivative: +1 at x == 0, where torch.abs gives
    0 (an SV coefficient starts at exactly 0)."""
    return torch.where(x >= 0, x, -x)


def sv_l1_sub_l2_reg(sv: torch.Tensor, weight: float,
                     block_pixels: int) -> torch.Tensor:
    """Support-vector L1 - L2 penalty (losses.py:93-97, reference
    smoe.py:1029-1036), normalised by the pixels fed."""
    p1 = torch.sum(abs_jax(sv))
    p2 = torch.sqrt(torch.sum(torch.square(sv)) + 1e-9)
    return weight * 0.1 * (p1 - p2) / float(block_pixels)


def psnr_from_mse(mse: float, precision: int) -> float:
    """PSNR given the pre-scaled MSE (reference plotter.py:14-15).
    A perfect reconstruction (mse == 0) reports the ~144 dB f32 ceiling
    instead of dividing by zero."""
    return float(10.0 * np.log10((2 ** precision) ** 2 / max(mse, 1e-12)))
