"""Incremental kernel insertion (from smoe_tpu/fit/incremental.py).

Reference flow (smoe.py:1312-1483, driver smoe_test.py:221-245):
  1. reinit_inc: a per-pixel error map (1 - SSIM between image and
     reconstruction, YUV-weighted), its peaks, and a re-initialised "inc"
     kernel block: pi := median of the live pis, nu := pixel value at the
     peak, A := diag(16 * H / 8), mu := peak coordinate;
  2. training with train_inc=True (a second Adam for the inc rows);
  3. apply_inc: the inc rows spliced into the main block at kernel_count,
     and a fresh inc optimizer.

The error map and the peak picker run on the host in numpy and scipy, as
in the JAX package; the splices write the trainer's parameter tensors in
place, so the optimizers keep holding them.  With `plot_dir` reinit_inc
also draws the error map and its peaks (`inc_{iteration}.png`) through the
port's numpy renderer.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from scipy.ndimage import maximum_filter, uniform_filter

from smoe_tpu_torch.diag.render import Dots, Image, Panel, render

MIN_DISTANCE_PEAKS = 8    # reference smoe.py:1365


def ssim_map(img1: np.ndarray, img2: np.ndarray, data_range: float = 1.0,
             win_size: int = 7) -> np.ndarray:
    """Per-pixel, per-channel SSIM map of skimage's compare_ssim(full=True)
    (uniform window, unbiased covariance; incremental.py:33-60)."""
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    ndim = img1.ndim - 1
    npix = win_size ** ndim
    cov_norm = npix / (npix - 1)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    def f(x):
        return uniform_filter(x, size=(win_size,) * ndim)

    out = np.empty_like(img1)
    for ch in range(img1.shape[-1]):
        x, y = img1[..., ch], img2[..., ch]
        ux, uy = f(x), f(y)
        uxx, uyy, uxy = f(x * x), f(y * y), f(x * y)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        a1, a2 = 2 * ux * uy + c1, 2 * vxy + c2
        b1, b2 = ux ** 2 + uy ** 2 + c1, vx + vy + c2
        out[..., ch] = (a1 * a2) / (b1 * b2)
    return out


def peak_local_max(image: np.ndarray, num_peaks: int,
                   min_distance: int = MIN_DISTANCE_PEAKS) -> np.ndarray:
    """Top-`num_peaks` local maxima with `min_distance` spacing, borders
    excluded (skimage.feature.peak_local_max; incremental.py:63-83)."""
    size = 2 * min_distance + 1
    mx = maximum_filter(image, size=size, mode="constant", cval=-np.inf)
    mask = image == mx
    if min_distance > 0:
        for ax in range(image.ndim):
            sl = [slice(None)] * image.ndim
            sl[ax] = slice(0, min_distance)
            mask[tuple(sl)] = False
            sl[ax] = slice(image.shape[ax] - min_distance, None)
            mask[tuple(sl)] = False
    coords = np.argwhere(mask)
    if coords.shape[0] == 0:
        return coords
    vals = image[tuple(coords.T)]
    order = np.argsort(-vals, kind="stable")
    return coords[order[:num_peaks]]


def error_map(smoe) -> np.ndarray:
    """YUV-weighted 1 - SSIM error map (incremental.py:86-93, reference
    smoe.py:1316-1324)."""
    rec = smoe.get_reconstruction()
    m = 1.0 - ssim_map(smoe.image, rec, data_range=1.0)
    if smoe.cfg.use_yuv and m.shape[-1] == 3:
        return np.average(m, axis=-1, weights=[6 / 8, 1 / 8, 1 / 8])
    return m.mean(axis=-1)


def _write_rows(smoe, rows: slice, values: dict) -> None:
    """params.<field>[rows] = values[field], in place (the optimizers hold
    these tensors)."""
    with torch.no_grad():
        for f, v in values.items():
            t = getattr(smoe.params, f)
            t[rows] = torch.as_tensor(v, dtype=t.dtype, device=t.device)


def reinit_inc(smoe, plot_dir: Optional[str] = None,
               threshold_rel: float = 0.2) -> None:
    """Refill the inc kernel block from error-map peaks (incremental.py:
    96-156, reference smoe.py:1405-1477).  threshold_rel is accepted and
    unused, as in the reference's live path.  plot_dir: also write the
    error map with its peaks there (`_plot_peaks`)."""
    cfg = smoe.cfg
    assert cfg.add_kernel_slots > 0, "model built without add_kernel_slots"
    num_inc = smoe.num_inc_kernels

    diff = error_map(smoe)
    used = smoe.get_num_pis()[-1][1] if smoe.get_num_pis() else cfg.start_pis
    num_new = max(int(cfg.start_pis - used), 0)
    peaks = peak_local_max(diff, num_peaks=num_new)
    n = peaks.shape[0]
    a = 16.0 * smoe.image.shape[0] / MIN_DISTANCE_PEAKS   # smoe.py:1379

    d, c = cfg.dim_domain, smoe.image.shape[-1]
    cap = smoe.params.capacity
    new = {"musX": np.zeros((num_inc, d), np.float32),
           "pis": np.zeros((num_inc,), np.float32),
           "nu_e": np.zeros((num_inc, c), np.float32),
           "gamma_e": np.zeros((num_inc, d, c), np.float32),
           "a_diag": np.zeros((num_inc, d, d), np.float32),
           "a_corr": np.zeros((num_inc, d, d), np.float32)}
    if n > 0:
        # peak coords -> [0,1] domain (inclusive linspace: i/(n-1))
        denom = np.maximum(np.array(smoe.image.shape[:d]) - 1, 1)
        new["musX"][:n] = peaks[:, :d] / denom
        live = smoe.params.pis.detach().cpu().numpy()
        live = live[live > 0]
        new["pis"][:n] = np.median(live) if live.size \
            else 1.0 / cfg.start_pis
        new["nu_e"][:n] = smoe.image[tuple(peaks[:, :d].T)]
        # only the first two diagonal entries, like the reference
        # (smoe.py:1428-1429): its inc path is written for 2D images
        for i in range(min(d, 2)):
            new["a_diag"][:n, i, i] = a
    if plot_dir:
        _plot_peaks(diff, peaks, plot_dir, smoe.iter)
    _write_rows(smoe, slice(cap - num_inc, cap), new)
    # every block sees every kernel until the next list refresh
    # (reference smoe.py:1477)
    smoe.kernel_lists = torch.ones_like(smoe.kernel_lists)
    smoe.valid = False


def apply_inc(smoe) -> None:
    """Splice the inc rows into the main block at kernel_count and reset
    the inc optimizer (incremental.py:159-187, reference smoe.py:
    1479-1483).  The inc tail keeps its live values after the splice, as
    in the reference, until the next reinit_inc overwrites it."""
    num_inc = smoe.num_inc_kernels
    cap = smoe.params.capacity
    pos = smoe.kernel_count
    assert pos + num_inc <= cap - num_inc, \
        "insert position overruns add_kernel_slots capacity"
    fields = ("musX", "pis", "nu_e", "gamma_e", "a_diag", "a_corr")
    tail = {f: getattr(smoe.params, f).detach()[cap - num_inc:].clone()
            for f in fields}
    _write_rows(smoe, slice(pos, pos + num_inc), tail)
    # fresh Adam state for the inc rows (reference reset_optimizers_op)
    smoe.set_inc_optimizer(reset=True)
    smoe.kernel_count += num_inc
    smoe.valid = False


def peak_panels(diff: np.ndarray, peaks: np.ndarray):
    """The peak plot's one panel (incremental.py:190-203): the error map in
    gray over its own range, the peaks as dots, "num peaks: n"."""
    items = [Image(diff if diff.ndim == 2 else diff[..., 0], "gray")]
    if peaks.shape[0]:
        items.append(Dots(peaks[:, 1], peaks[:, 0]))
    return [Panel(f"num peaks: {peaks.shape[0]}", items)]


def _plot_peaks(diff, peaks, plot_dir, iteration):
    """Write `peak_panels` as `inc_{iteration}.png` in plot_dir."""
    os.makedirs(plot_dir, exist_ok=True)
    render(peak_panels(diff, peaks),
           os.path.join(plot_dir, f"inc_{iteration}.png"))
