"""SSIM of 2D images and 3D volumes in PyTorch (from smoe_tpu/core/ssim.py).

The semantics of the reference's forked TF SSIM (reference
ops/image_ops_impl.py:77-233 `custom_ssim`): an 11-tap Gaussian window with
sigma 1.5, K1 = 0.01, K2 = 0.03, compensation 1, VALID filtering, per-
channel SSIM means.  The loss symmetric-pads by 5 first, so the VALID
filter covers every pixel (reference smoe.py:993-1004).

The window factorises into 1D windows, so the filter is separable, as in
the JAX package, and built the same way: a weighted sum of 11 shifted
slices per axis, each an fp32 multiply-add on the elementwise units.  No
convolution is called, so cuDNN's TF32 default never applies.  The pad
is JAX's `mode="symmetric"`, which repeats the edge sample (torch's
"reflect" pad leaves it out): built from flipped slices and a cat.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_K1 = 0.01
_K2 = 0.03
FILTER_SIZE = 11
FILTER_SIGMA = 1.5


@functools.lru_cache()
def _gauss_1d(size: int = FILTER_SIZE,
              sigma: float = FILTER_SIGMA) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-0.5 * coords ** 2 / sigma ** 2)
    return (g / g.sum()).astype(np.float32)


def _separable_reduce(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """VALID separable Gaussian filter over the first `ndim` axes of an
    (*spatial, C) tensor (ssim.py:36-49): per axis, the taps' weighted
    slices summed in tap order."""
    w = [float(v) for v in _gauss_1d()]
    taps = len(w)
    for axis in range(ndim):
        n = x.shape[axis]
        m = n - taps + 1
        out = torch.zeros_like(x.narrow(axis, 0, m))
        for t in range(taps):
            out = out + w[t] * x.narrow(axis, t, m)
        x = out
    return x


def ssim_per_channel(img1: torch.Tensor, img2: torch.Tensor,
                     max_val: float = 1.0, ndim: int = 2) -> torch.Tensor:
    """Per-channel SSIM of (*spatial, C) tensors; returns (C,)
    (ssim.py:52-73: biased covariance, compensation 1)."""
    c1 = (_K1 * max_val) ** 2
    c2 = (_K2 * max_val) ** 2
    mean0 = _separable_reduce(img1, ndim)
    mean1 = _separable_reduce(img2, ndim)
    num0 = mean0 * mean1 * 2.0
    den0 = torch.square(mean0) + torch.square(mean1)
    luminance = (num0 + c1) / (den0 + c1)
    num1 = _separable_reduce(img1 * img2, ndim) * 2.0
    den1 = _separable_reduce(torch.square(img1) + torch.square(img2), ndim)
    cs = (num1 - num0 + c2) / (den1 - den0 + c2)
    return torch.mean(luminance * cs, dim=tuple(range(ndim)))


def symmetric_pad(x: torch.Tensor, pad: int, ndim: int) -> torch.Tensor:
    """jnp.pad(x, [(pad, pad)] * ndim + [(0, 0)], mode="symmetric"): the
    mirror image including the edge sample, on each of the first `ndim`
    axes."""
    for axis in range(ndim):
        lo = torch.flip(x.narrow(axis, 0, pad), (axis,))
        hi = torch.flip(x.narrow(axis, x.shape[axis] - pad, pad), (axis,))
        x = torch.cat([lo, x, hi], dim=axis)
    return x


def ssim_loss(res: torch.Tensor, target: torch.Tensor, use_yuv: bool,
              ndim: int = 2, max_val: float = 1.0) -> torch.Tensor:
    """1 - SSIM with the reference's symmetric pad and YUV 6/1/1 weighting
    (ssim.py:76-89, reference smoe.py:981-1010)."""
    per_chan = ssim_per_channel(symmetric_pad(res, 5, ndim),
                                symmetric_pad(target, 5, ndim),
                                max_val=max_val, ndim=ndim)
    if use_yuv and per_chan.shape[0] == 3:
        s = (6.0 * per_chan[0] + per_chan[1] + per_chan[2]) / 8.0
    else:
        s = torch.mean(per_chan)
    return 1.0 - s
