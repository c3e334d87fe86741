"""Plain reference of the motion-compensated dual-model video fit, in
PyTorch at float32.

Written from the model's definition (the reference smoe.py:280-329 dual
model, smoe.py:554-686 motion, the JAX package's core/model.py:65-77),
with no kernel, no CUDA graph and nothing of the port; the still model's
pieces (steering, maha, mixing, output rounding, Adam) are
`smoe_ref.py`'s.  A video volume (H, W, T, C) on linspace(0, 1) axes
(y, x, t) is fitted by K kernels of which those with model_mask True live
in the motion-compensated domain and the others in the raw one:

    x'      = [h11 x + h12 y + h13, h21 x + h22 y + h23]   (6 parameters,
              the frame's column of the (8, T) motion rows; frame =
              round(t (T - 1)), half to even), and t' = -5
    maha    = maha of x' (model 0) or of the raw (y, x, t) (model 1), each
              through the 13 quadratic features of d = 3
    n_w     = exp(-maha / 2) * q(pi_k) * prod(diag A_k) / (2 pi)^(3/2)
              over the block's listed, live kernels
    w       = n_w / max(1e-11, sum_k n_w), zero where w <= 0.5 / 2^p
    res     = sum_k w (nu_k + gamma_k^T x'),  clipped to [0, 1] and
              rounded to p bits (straight through for the gradient)

with the eps-insensitive loss weighted 6:1:1 over YUV, its gradient by
autograd summed unweighted over the blocks, Adam, and the kernel lists:
a kernel is near a block where its maha to one of the block's probe
points is under the threshold or its center lies in the probe box, the
box of a model-0 kernel being the block's transformed extent and of a
model-1 kernel its raw one.

Departures from the published description, each the port's definition:
  * every expert is evaluated at the transformed coordinates x' (t' = -5
    included), those of model-1 kernels too: one expert input for the
    whole pair, as the JAX package's model.py:65-77 writes the dual
    model;
  * q(pi) is the 10-bit fake quantisation of pi on [0, 2] (the fit CLI's
    `-qp 1` default, TF's fake_quant_with_min_max_args: the gradient passes
    straight through inside the range), and "live" means q(pi) > 0;
  * the probe boxes hold g^3 points (g = probe_grid) where the reference
    probes corners and mid-points, and the lists are refreshed every sweep
    (survivors | near), which the reference's host-side lists cannot do.

`VideoRef(cfg, precision)`: as `smoe_ref.Ref`, "fp32" (TF32 off on a
card) or "tf32" (each contraction's operands rounded to TF32).  Each
block is walked in row chunks over the columns of its listed kernels, so
a sweep at the cell's size fits one card.
"""

from __future__ import annotations

import importlib.util
import math
import os
import sys
from itertools import product
from typing import Dict, List

import numpy as np
import torch


def _base():
    """`smoe_ref.py` beside this file, loaded by path (the benchmark's
    drivers and the repository's tests load this file by path too)."""
    name = "smoe_video_ref_base"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "smoe_ref.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


R = _base()
FIELDS = R.FIELDS
Adam = R.Adam
DENOM_FLOOR = R.DENOM_FLOOR
TIME_PLANE = -5.0
PIS_RANGE, PIS_BITS = (0.0, 2.0), 10


def fake_quant(x: torch.Tensor, lo: float, hi: float, bits: int):
    """TF's fake_quant_with_min_max_args: the range nudged so that zero is
    on the grid, x clipped to it and rounded to 2^bits - 1 steps, the
    gradient straight through inside the range (clipped with max / min,
    half the gradient at a tie)."""
    steps = float((1 << bits) - 1)
    scale = (hi - lo) / steps
    zp = min(max(round(-lo / scale), 0.0), steps)
    n_lo, n_hi = -zp * scale, (steps - zp) * scale
    c = torch.minimum(torch.maximum(x, x.new_full((), n_lo)),
                      x.new_full((), n_hi))
    q = torch.round((c - n_lo) / scale) * scale + n_lo
    return c + (q - c).detach()


def transform(coords: torch.Tensor, motion: torch.Tensor) -> torch.Tensor:
    """(N, 3) (y, x, t) -> (N, 3) (y', x', -5) by the 6-parameter motion
    of each pixel's frame; `motion` (8, T) rows h11 .. h32."""
    t_count = motion.shape[1]
    y, x, t = coords[:, 0], coords[:, 1], coords[:, 2]
    frame = torch.clamp(torch.round(t * (t_count - 1)).long(), 0,
                        t_count - 1)
    h = motion[:, frame]
    xd = h[0] * x + h[1] * y + h[2]
    yd = h[3] * x + h[4] * y + h[5]
    return torch.stack([yd, xd, torch.full_like(t, TIME_PLANE)], 1)


def probe_box(lo: torch.Tensor, hi: torch.Tensor, grid: int):
    """(B, g^3, 3): the product of g points from lo to hi on each axis,
    the last axis fastest."""
    fr = torch.linspace(0.0, 1.0, grid, device=lo.device)
    pts = [torch.stack([lo[:, j] + (hi[:, j] - lo[:, j]) * fr[idx[j]]
                        for j in range(3)], -1)
           for idx in product(range(grid), repeat=3)]
    return torch.stack(pts, 1)


class VideoBlocks:
    """A volume cut into equal blocks without overlap, in row-major block
    order, each block's pixels row-major: coords (B, Nb, 3), targets (B,
    Nb, C), the raw probe points (B, g^3, 3) on each block's box."""

    def __init__(self, volume: np.ndarray, block: tuple, device,
                 probe_grid: int):
        shape = volume.shape[:3]
        c = volume.shape[3]
        axes = [np.linspace(0.0, 1.0, n).astype(np.float32) for n in shape]
        grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1)
        coords, targets = [], []
        for idx in product(*[range(n // b) for n, b in zip(shape, block)]):
            sl = tuple(slice(i * b, (i + 1) * b) for i, b in zip(idx, block))
            coords.append(grid[sl].reshape(-1, 3))
            targets.append(volume[sl].reshape(-1, c))
        self.coords = torch.as_tensor(np.stack(coords), device=device)
        self.targets = torch.as_tensor(np.stack(targets), device=device)
        self.num_pixel = int(np.prod(shape))
        self.grid = int(probe_grid)
        self.probes = probe_box(self.coords.amin(1), self.coords.amax(1),
                                self.grid)

    @property
    def count(self) -> int:
        return int(self.coords.shape[0])


class VideoRef:
    """The reference at one precision, for a config dict with `precision`,
    `use_yuv`, `use_determinant` and `probe_maha`.  Params are dicts of the
    FIELDS, `model_mask` (K,) bool and `motion` (8, T)."""

    def __init__(self, cfg: dict, precision: str = "fp32"):
        self.base = R.Ref(cfg, precision)
        self.cfg = cfg
        self.thr = self.base.thr
        self.eps = self.base.eps

    # ------------------------------------------------------------ model

    @staticmethod
    def pis(p) -> torch.Tensor:
        return fake_quant(p["pis"], *PIS_RANGE, PIS_BITS)

    def live(self, p) -> torch.Tensor:
        return self.pis(p).detach() > 0

    def maha(self, p, x_t, x_raw, cols=None) -> torch.Tensor:
        """(N, K') maha of the kernels `cols` (all by default): model 0 on
        x_t, model 1 on x_raw."""
        sub = {f: p[f] if cols is None else p[f][cols]
               for f in ("musX", "a_diag", "a_corr")}
        mm = p["model_mask"] if cols is None else p["model_mask"][cols]
        return torch.where(mm[None, :], self.base.maha(sub, x_t),
                           self.base.maha(sub, x_raw))

    def gate(self, p, x_t, x_raw, cols) -> torch.Tensor:
        """(N, K') culled weights over the kernels `cols`, every one of
        them listed and live."""
        A = R.Ref.steering({f: p[f][cols] for f in ("a_diag", "a_corr")})
        pik = self.pis(p)[cols]
        if self.cfg.get("use_determinant", True):
            det = torch.diagonal(A, dim1=1, dim2=2).prod(-1)
            pik = pik * det / math.sqrt((2.0 * math.pi) ** 3)
        n_w = torch.exp(-0.5 * self.maha(p, x_t, x_raw, cols)) * pik[None, :]
        denom = torch.clamp_min(n_w.sum(1, keepdim=True), DENOM_FLOOR)
        w = n_w / denom
        return w * (w > self.thr)

    def output(self, p, w, x_t, cols) -> torch.Tensor:
        sub = {"nu_e": p["nu_e"][cols], "gamma_e": p["gamma_e"][cols]}
        return self.base.output(self.base.mix(sub, w, x_t))

    def loss_terms(self, out, y, n_block: int):
        """The eps-insensitive loss 6:1:1 (YUV) over the chunk's rows, a
        sum over the block's count."""
        diff = out - y
        lp = torch.square(torch.where(diff >= 0, diff, -diff) - self.eps)
        per = lp.sum(0) / n_block
        if self.cfg.get("use_yuv", True) and y.shape[1] == 3:
            return 0.75 * per[0] + 0.125 * (per[1] + per[2])
        return per.sum() / y.shape[1]

    # ------------------------------------------------------------ lists

    def _cols(self, p, mask: torch.Tensor) -> torch.Tensor:
        return torch.nonzero(mask & self.live(p)).reshape(-1)

    @torch.no_grad()
    def near(self, p, blocks: VideoBlocks) -> torch.Tensor:
        """(B, K): live kernels whose maha to a probe point of the block's
        box in their domain is under the probe threshold, or whose center
        lies in that box."""
        t_lo, t_hi = [], []
        for b in range(blocks.count):
            tc = transform(blocks.coords[b], p["motion"])
            t_lo.append(tc.amin(0))
            t_hi.append(tc.amax(0))
        t_probes = probe_box(torch.stack(t_lo), torch.stack(t_hi),
                             blocks.grid)
        b, g, d = t_probes.shape
        mh = self.maha(p, t_probes.reshape(b * g, d),
                       blocks.probes.reshape(b * g, d)).reshape(b, g, -1)
        near = (mh < float(self.cfg.get("probe_maha", 800.0))).any(1)
        mu = p["musX"]

        def inside(box):
            lo, hi = box.amin(1), box.amax(1)
            return ((mu[None] >= lo[:, None]) & (mu[None] <= hi[:, None])) \
                .all(-1)
        ins = torch.where(p["model_mask"][None, :], inside(t_probes),
                          inside(blocks.probes))
        return (near | ins) & self.live(p)[None, :]

    @torch.no_grad()
    def survivors(self, p, blocks: VideoBlocks, lists: torch.Tensor,
                  rows: int = 1 << 14) -> torch.Tensor:
        """(B, K): the kernels that pass the cull at some pixel of the
        block, gated over its list."""
        out = torch.zeros_like(lists)
        for b in range(blocks.count):
            cols = self._cols(p, lists[b])
            for i in range(0, blocks.coords.shape[1], rows):
                x = blocks.coords[b, i:i + rows]
                w = self.gate(p, transform(x, p["motion"]), x, cols)
                out[b, cols] |= (w > 0).any(0)
        return out

    @torch.no_grad()
    def cull_counts(self, p, blocks: VideoBlocks, lists: torch.Tensor,
                    rows: int = 1 << 14) -> List[int]:
        """Per block, the (pixel, kernel) pairs that pass the cull."""
        out = []
        for b in range(blocks.count):
            cols = self._cols(p, lists[b])
            n = 0
            for i in range(0, blocks.coords.shape[1], rows):
                x = blocks.coords[b, i:i + rows]
                n += int((self.gate(p, transform(x, p["motion"]), x, cols)
                          > 0).sum())
            out.append(n)
        return out

    # ------------------------------------------------------------ sweep

    def grads(self, p, blocks: VideoBlocks, lists: torch.Tensor,
              rows: int = 1 << 14):
        """One sweep's gradients at p, summed unweighted over the blocks,
        and its loss weighted by each block's share of the volume.
        Returns (grads {field: tensor}, loss, survivors (B, K))."""
        leaves = {f: p[f].detach().clone().requires_grad_(True)
                  for f in FIELDS}
        q = dict(leaves, model_mask=p["model_mask"], motion=p["motion"])
        nb = blocks.coords.shape[1]
        share = nb / blocks.num_pixel
        loss_t = 0.0
        surv = torch.zeros_like(lists)
        for b in range(blocks.count):
            cols = self._cols(q, lists[b])
            for i in range(0, nb, rows):
                x = blocks.coords[b, i:i + rows]
                x_t = transform(x, q["motion"])
                w = self.gate(q, x_t, x, cols)
                loss = self.loss_terms(self.output(q, w, x_t, cols),
                                       blocks.targets[b, i:i + rows], nb)
                loss.backward()
                loss_t += share * float(loss.detach())
                surv[b, cols] |= (w.detach() > 0).any(0)
        g = {f: (leaves[f].grad if leaves[f].grad is not None
                 else torch.zeros_like(leaves[f])) for f in FIELDS}
        return g, loss_t, surv


def params_on(d: Dict[str, np.ndarray], model_mask, motion, device) -> Dict:
    """The reference's params, copies of the trainer's leaves (numpy or
    host tensors), its model mask and motion rows."""
    out = {f: torch.tensor(np.array(d[f], np.float32), device=device)
           for f in FIELDS}
    out["model_mask"] = torch.tensor(np.array(model_mask, bool),
                                     device=device)
    out["motion"] = torch.tensor(np.array(motion, np.float32), device=device)
    return out
