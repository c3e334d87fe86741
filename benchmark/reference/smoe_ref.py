"""Plain reference of the SMoE fit and decode, in PyTorch at float32.

Written from the model's definition (the JAX package's core/model.py:1-30,
the reference smoe.py it follows), with no kernel, no CUDA graph and
nothing of the port: for K steered kernels with centers mu_k, steering
factors A_k, gating weights pi_k and affine experts (nu_k, gamma_k),

    maha[n, k] = <phi(x_n), q_k>,  phi(x) = [vec(x x^T), x, 1],
                 q_k = [vec(B_k), -2 B_k mu_k, mu_k^T B_k mu_k],  B = A A^T
    n_w        = exp(-maha / 2) * pi_k * prod(diag A_k) / (2 pi)^(d/2)
    w          = n_w / max(1e-11, sum_k n_w), zero where w <= 0.5 / 2^p
    res        = sum_k w (nu_k + gamma_k^T x),  clipped to [0, 1] and
                 rounded to p bits (straight through for the gradient)

over each block's listed kernels, the eps-insensitive loss weighted 6:1:1
over the channels, its gradient by autograd, one Adam step per sweep,
the kernel lists (probe points, survivors), the least-squares refits of
the experts, and the decode of a raster.

`Ref(precision)`: "fp32" computes every contraction in float32 (TF32 off on
a card); "tf32" rounds the operands of each contraction to TF32's 10-bit
mantissa first (round to nearest even), as a card with TF32 on would: the
control that must fail the comparison.
"""

from __future__ import annotations

import math
from itertools import product
from typing import Dict, List

import numpy as np
import torch

DENOM_FLOOR = 1e-11
MASS_EPS = 1e-6
FIELDS = ("musX", "a_diag", "a_corr", "pis", "nu_e", "gamma_e")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits, ties to even)."""
    x = x.detach().contiguous()
    b = x.view(torch.int32)
    bias = 0xFFF + ((b >> 13) & 1)
    r = ((b + bias) & ~0x1FFF).to(torch.int32)
    return torch.where(torch.isfinite(x), r.view(torch.float32), x)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with the operands of the product and of both gradient
    products rounded to TF32, as a card with TF32 on computes them."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ round_tf32(b).T, round_tf32(a).T @ g


# ---------------------------------------------------------------- inputs


def grid_init(image: np.ndarray, kpd: int) -> Dict[str, np.ndarray]:
    """The grid initialisation of a 2-D fit (reference smoe.py:2146-2242):
    kpd x kpd centers inset by half a spacing, A = diag(2 (kpd + 1)),
    nu = the mean of the image over each center's cell, gamma = 0,
    pi = 1 / K.  Returns the dict `Smoe(init_params_dict=...)` takes."""
    d, c = 2, image.shape[-1]
    axis = np.linspace(0.5 / kpd, 1.0 - 0.5 / kpd, kpd)
    musX = np.stack(np.meshgrid(axis, axis, indexing="ij"),
                    axis=-1).reshape(-1, d).astype(np.float32)
    k = musX.shape[0]
    a = np.float32(2.0 * (kpd + 1))
    A = np.tile(np.diag([a, a]).astype(np.float32)[None], (k, 1, 1))
    stride = musX[0]
    nu = np.empty((k, c), np.float32)
    for i in range(k):
        sl = tuple(slice(int(round((musX[i, j] - stride[j]) * image.shape[j])),
                         int(round((musX[i, j] + stride[j]) * image.shape[j])))
                   for j in range(d))
        nu[i] = image[sl].reshape(-1, c).mean(axis=0)
    return {"musX": musX, "A": A, "nu_e": nu,
            "gamma_e": np.zeros((k, d, c), np.float32),
            "pis": np.full((k,), 1.0 / k, np.float32)}


def params_from_init(init: Dict[str, np.ndarray], device) -> Dict:
    """The trainer's leaves from a grid initialisation: a_diag holds A's
    diagonal, a_corr its strict lower part (both (K, d, d))."""
    A = init["A"]
    k, d, _ = A.shape
    diag = np.zeros_like(A)
    diag[:, np.arange(d), np.arange(d)] = A[:, np.arange(d), np.arange(d)]
    out = {"musX": init["musX"], "a_diag": diag,
           "a_corr": np.tril(A, -1).astype(np.float32),
           "pis": init["pis"], "nu_e": init["nu_e"],
           "gamma_e": init["gamma_e"]}
    return {f: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for f, v in out.items()}


class Blocks:
    """An image cut into equal blocks without overlap, in row-major block
    order: coords (B, Nb, d) on linspace(0, 1) axes, targets (B, Nb, C),
    the probe points (B, g^d, d) on each block's box and its center."""

    def __init__(self, image: np.ndarray, block: tuple, device,
                 probe_grid: int = 3):
        h, w, c = image.shape
        bh, bw = block
        ys = np.linspace(0.0, 1.0, h).astype(np.float32)
        xs = np.linspace(0.0, 1.0, w).astype(np.float32)
        coords, targets = [], []
        for by in range(h // bh):
            for bx in range(w // bw):
                yy, xx = np.meshgrid(ys[by * bh:(by + 1) * bh],
                                     xs[bx * bw:(bx + 1) * bw],
                                     indexing="ij")
                coords.append(np.stack([yy, xx], -1).reshape(-1, 2))
                targets.append(image[by * bh:(by + 1) * bh,
                                     bx * bw:(bx + 1) * bw].reshape(-1, c))
        self.coords = torch.as_tensor(np.stack(coords), device=device)
        self.targets = torch.as_tensor(np.stack(targets), device=device)
        self.num_pixel = h * w
        lo = self.coords.amin(dim=1)
        hi = self.coords.amax(dim=1)
        fr = torch.linspace(0.0, 1.0, probe_grid, device=device)
        pts = []
        for idx in product(range(probe_grid), repeat=2):
            pts.append(torch.stack([lo[:, j] + (hi[:, j] - lo[:, j])
                                    * fr[idx[j]] for j in range(2)], -1))
        self.probes = torch.stack(pts, dim=1)
        self.centers = self.coords.mean(dim=1)

    @property
    def count(self) -> int:
        return int(self.coords.shape[0])


# ---------------------------------------------------------------- model


class Ref:
    """The reference at one precision ("fp32" or "tf32"), for a config
    dict with `precision`, `use_yuv`, `use_determinant`, `probe_maha`."""

    def __init__(self, cfg: dict, precision: str = "fp32"):
        if precision not in ("fp32", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.cfg = cfg
        self.tf32 = precision == "tf32"
        self.bits = int(cfg.get("precision", 8))
        self.thr = 0.5 / 2 ** self.bits
        self.eps = 0.5 / 2 ** self.bits

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b at the reference's precision."""
        if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("the reference runs with TF32 off")
        if self.tf32:
            return _TF32MatMul.apply(a, b)
        return a @ b

    @staticmethod
    def steering(p) -> torch.Tensor:
        """A = diag(a_diag) + strict_lower(a_corr), (K, d, d)."""
        d = p["a_diag"].shape[1]
        eye = torch.eye(d, device=p["a_diag"].device)
        diag = torch.diagonal(p["a_diag"], dim1=1, dim2=2)
        return diag[:, :, None] * eye[None] + torch.tril(p["a_corr"], -1)

    def maha(self, p, x: torch.Tensor, A=None) -> torch.Tensor:
        """(N, K) maha through the quadratic features, clamped at 0."""
        A = self.steering(p) if A is None else A
        mu = p["musX"]
        k, d = mu.shape
        B = (A[:, :, None, :] * A[:, None, :, :]).sum(-1)
        Bmu = (B * mu[:, None, :]).sum(-1)
        q = torch.cat([B.reshape(k, d * d), -2.0 * Bmu,
                       (Bmu * mu).sum(-1)[:, None]], 1)
        n = x.shape[0]
        phi = torch.cat([(x[:, :, None] * x[:, None, :]).reshape(n, d * d),
                         x, torch.ones((n, 1), device=x.device)], 1)
        return torch.clamp_min(self.mm(phi, q.T), 0.0)

    def gate(self, p, x: torch.Tensor, mask: torch.Tensor, A=None):
        """(w (N, K) culled, denom) over the kernels in `mask` (bool)."""
        A = self.steering(p) if A is None else A
        live = mask & (p["pis"] > 0)
        mh = torch.where(live[None, :], self.maha(p, x, A),
                         torch.zeros((), device=x.device))
        pik = torch.where(live, p["pis"], torch.zeros_like(p["pis"]))
        if self.cfg.get("use_determinant", True):
            det = torch.diagonal(A, dim1=1, dim2=2).prod(-1)
            pik = pik * det / math.sqrt((2.0 * math.pi) ** A.shape[1])
        n_w = torch.exp(-0.5 * mh) * pik[None, :]
        denom = torch.clamp_min(n_w.sum(1, keepdim=True), DENOM_FLOOR)
        w = n_w / denom
        return w * (w > self.thr)

    def mix(self, p, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """sum_k w (nu_k + gamma_k^T x)."""
        res = self.mm(w, p["nu_e"])
        for j in range(x.shape[1]):
            res = res + x[:, j:j + 1] * self.mm(w, p["gamma_e"][:, j, :])
        return res

    def output(self, res: torch.Tensor) -> torch.Tensor:
        """Clip to [0, 1], round to `bits` with a straight-through
        gradient."""
        x = torch.minimum(torch.maximum(res, res.new_zeros(())),
                          res.new_ones(()))
        steps = 2 ** self.bits - 1
        return x + (torch.round(x * steps) / steps - x).detach()

    def chunk_terms(self, p, x, y, mask, n_block: int):
        """(loss, mse, survivors) contributions of a chunk of a block's
        rows: the eps-insensitive loss weighted 6:1:1 (YUV) or the channel
        mean, each a sum over the chunk's rows over the block's count."""
        w = self.gate(p, x, mask)
        out = self.output(self.mix(p, w, x))
        diff = out - y
        c = y.shape[1]
        lp = torch.square(torch.where(diff >= 0, diff, -diff) - self.eps)
        if self.cfg.get("use_yuv", True) and c == 3:
            per = lp.sum(0) / n_block
            loss = 0.75 * per[0] + 0.125 * (per[1] + per[2])
        else:
            loss = lp.sum() / (n_block * c)
        mse = torch.square(diff.detach()).sum() / (n_block * c) \
            * float(2 ** self.bits) ** 2
        return loss, mse, (w.detach() > 0).any(0)

    # ------------------------------------------------------------ lists

    def near(self, p, blocks: Blocks) -> torch.Tensor:
        """(B, K): live kernels whose maha to a probe point of the block
        is under the probe threshold or whose center lies in its box."""
        b, g, d = blocks.probes.shape
        mh = self.maha(p, blocks.probes.reshape(b * g, d)).reshape(b, g, -1)
        near = (mh < float(self.cfg.get("probe_maha", 800.0))).any(1)
        lo = blocks.probes.amin(1)
        hi = blocks.probes.amax(1)
        mu = p["musX"]
        inside = ((mu[None] >= lo[:, None]) & (mu[None] <= hi[:, None])).all(-1)
        return (near | inside) & (p["pis"] > 0)[None, :]

    def initial_lists(self, p, blocks: Blocks) -> torch.Tensor:
        """Each live kernel on the block whose center is nearest by maha
        (the first on ties), then every probe-near kernel."""
        mh = self.maha(p, blocks.centers)                 # (B, K)
        nearest = torch.argmin(mh, dim=0)
        own = nearest[None, :] == torch.arange(blocks.count,
                                               device=mh.device)[:, None]
        return (own & (p["pis"] > 0)[None, :]) | self.near(p, blocks)

    @torch.no_grad()
    def survivors(self, p, blocks: Blocks, lists: torch.Tensor,
                  rows: int = 1 << 16) -> torch.Tensor:
        """(B, K): the kernels that pass the cull at some pixel of the
        block, gated over its list."""
        out = []
        for b in range(blocks.count):
            s = torch.zeros_like(lists[b])
            for i in range(0, blocks.coords.shape[1], rows):
                w = self.gate(p, blocks.coords[b, i:i + rows], lists[b])
                s = s | (w > 0).any(0)
            out.append(s)
        return torch.stack(out)

    @torch.no_grad()
    def cull_counts(self, p, blocks: Blocks, lists: torch.Tensor,
                    rows: int = 1 << 16) -> List[int]:
        """Per block, the (pixel, kernel) pairs that pass the cull."""
        out = []
        for b in range(blocks.count):
            n = 0
            for i in range(0, blocks.coords.shape[1], rows):
                w = self.gate(p, blocks.coords[b, i:i + rows], lists[b])
                n += int((w > 0).sum())
            out.append(n)
        return out

    # ------------------------------------------------------------ sweep

    def grads(self, p, blocks: Blocks, lists: torch.Tensor,
              rows: int = 1 << 16):
        """One sweep's gradients at p, summed unweighted over the blocks,
        and its loss and mse weighted by each block's share of the image.
        Returns (grads {field: tensor}, loss, mse, survivors (B, K))."""
        leaves = {f: p[f].detach().clone().requires_grad_(True)
                  for f in FIELDS}
        nb = blocks.coords.shape[1]
        share = nb / blocks.num_pixel
        loss_t = torch.zeros((), device=blocks.coords.device)
        mse_t = torch.zeros((), device=blocks.coords.device)
        surv = torch.zeros_like(lists)
        for b in range(blocks.count):
            for i in range(0, nb, rows):
                loss, mse, s = self.chunk_terms(
                    leaves, blocks.coords[b, i:i + rows],
                    blocks.targets[b, i:i + rows], lists[b], nb)
                loss.backward()
                loss_t = loss_t + share * loss.detach()
                mse_t = mse_t + share * mse
                surv[b] |= s
        g = {f: (leaves[f].grad if leaves[f].grad is not None
                 else torch.zeros_like(leaves[f])) for f in FIELDS}
        return g, float(loss_t), float(mse_t), surv


class Adam:
    """torch.optim.Adam's update (betas 0.9, 0.999, eps 1e-8 outside the
    root) over the fit's learning-rate groups: nu, gamma, mu at base_lr, pi
    at base_lr / lr_div, A at base_lr * lr_mult.  `m`, `v` and `t` start
    it from a state (its moments by field and its step count), else fresh."""

    def __init__(self, base_lr=1e-3, lr_div=100.0, lr_mult=1000.0,
                 m=None, v=None, t: int = 0):
        self.lr = {"musX": base_lr, "nu_e": base_lr, "gamma_e": base_lr,
                   "pis": base_lr / lr_div, "a_diag": base_lr * lr_mult,
                   "a_corr": base_lr * lr_mult}
        self.t = int(t)
        self.m: Dict[str, torch.Tensor] = dict(m or {})
        self.v: Dict[str, torch.Tensor] = dict(v or {})

    @torch.no_grad()
    def step(self, p, g) -> Dict[str, torch.Tensor]:
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        out = {}
        for f in FIELDS:
            m = self.m.get(f, torch.zeros_like(p[f]))
            v = self.v.get(f, torch.zeros_like(p[f]))
            m = b1 * m + (1 - b1) * g[f]
            v = b2 * v + (1 - b2) * g[f] * g[f]
            self.m[f], self.v[f] = m, v
            bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
            denom = v.sqrt() / math.sqrt(bc2) + eps
            out[f] = p[f] - (self.lr[f] / bc1) * m / denom
        return out


# ------------------------------------------------------------ least squares


def _design(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.ones_like(x[:, :1]), x], 1)


@torch.no_grad()
def ls_kernel(ref: Ref, p, blocks: Blocks, lists, ridge: float = 1e-6,
              rows: int = 1 << 16, with_step: bool = False):
    """The per-kernel least-squares refit of the experts (the EM M-step of
    a mixture of affine experts) with a tiny ridge, as a direction, and the
    exact line search on the blend mse clipped to [0, 1].  Returns
    (nu, gamma), and with `with_step` also the line search's t and the
    full step (d nu, d gamma)."""
    k = p["pis"].shape[0]
    d, c = blocks.coords.shape[2], blocks.targets.shape[2]
    pp = 1 + d
    dev = blocks.coords.device
    G = torch.zeros((k, pp, pp), device=dev)
    bv = torch.zeros((k, pp, c), device=dev)
    for b in range(blocks.count):
        for i in range(0, blocks.coords.shape[1], rows):
            x = blocks.coords[b, i:i + rows]
            y = blocks.targets[b, i:i + rows]
            w = ref.gate(p, x, lists[b])
            ph = _design(x)
            G += ref.mm(w.T, (ph[:, :, None] * ph[:, None, :])
                        .reshape(-1, pp * pp)).reshape(k, pp, pp)
            bv += ref.mm(w.T, (ph[:, :, None] * y[:, None, :])
                         .reshape(-1, pp * c)).reshape(k, pp, c)
    mass = G[:, 0, 0]
    tr = torch.diagonal(G, dim1=1, dim2=2).sum(-1) / pp
    reg = (ridge * tr + MASS_EPS)[:, None, None] * torch.eye(pp, device=dev)
    x = torch.linalg.solve(G + reg, bv)
    ok = mass > MASS_EPS
    nu0, g0 = p["nu_e"], p["gamma_e"]
    nu1 = torch.where(ok[:, None], x[:, 0, :], nu0)
    g1 = torch.where(ok[:, None, None], x[:, 1:, :], g0)
    dn, dg = nu1 - nu0, g1 - g0
    uu = torch.zeros((), device=dev)
    ru = torch.zeros((), device=dev)
    for b in range(blocks.count):
        for i in range(0, blocks.coords.shape[1], rows):
            x_ = blocks.coords[b, i:i + rows]
            w = ref.gate(p, x_, lists[b])
            yhat = ref.mix({"nu_e": nu0, "gamma_e": g0}, w, x_)
            u = ref.mix({"nu_e": dn, "gamma_e": dg}, w, x_)
            r = yhat - blocks.targets[b, i:i + rows]
            uu = uu + (u * u).sum()
            ru = ru + (r * u).sum()
    t = torch.clamp(-ru / torch.clamp_min(uu, 1e-30), 0.0, 1.0) \
        if float(uu) > 0 else torch.zeros((), device=dev)
    if with_step:
        return nu0 + t * dn, g0 + t * dg, float(t), (dn, dg)
    return nu0 + t * dn, g0 + t * dg


@torch.no_grad()
def ls_coupled(ref: Ref, p, blocks: Blocks, lists, ridge: float = 1e-6,
               rows: int = 1 << 15):
    """The joint least-squares fit of every kernel's experts: one
    (K (1 + d))-square ridge solve; kernels with no gated mass keep
    theirs.  Returns (nu, gamma)."""
    k = p["pis"].shape[0]
    d, c = blocks.coords.shape[2], blocks.targets.shape[2]
    pp = 1 + d
    dev = blocks.coords.device
    G = torch.zeros((k * pp, k * pp), device=dev)
    bv = torch.zeros((k * pp, c), device=dev)
    for b in range(blocks.count):
        for i in range(0, blocks.coords.shape[1], rows):
            x = blocks.coords[b, i:i + rows]
            w = ref.gate(p, x, lists[b])
            z = (w[:, :, None] * _design(x)[:, None, :]).reshape(-1, k * pp)
            G += ref.mm(z.T, z)
            bv += ref.mm(z.T, blocks.targets[b, i:i + rows])
    diag = torch.diagonal(G)
    mass = diag.reshape(k, pp)[:, 0]
    ok = mass > MASS_EPS
    okp = ok[:, None].expand(k, pp).reshape(-1)
    fix = torch.where(okp, torch.zeros_like(diag), torch.ones_like(diag))
    scale = torch.where(okp, diag, torch.zeros_like(diag)).sum() \
        / torch.clamp_min(okp.float().sum(), 1.0)
    lam = ridge * torch.clamp_min(scale, MASS_EPS) + MASS_EPS
    x = torch.linalg.solve(G + torch.diag(fix + lam), bv).reshape(k, pp, c)
    nu = torch.where(ok[:, None], x[:, 0, :], p["nu_e"])
    g = torch.where(ok[:, None, None], x[:, 1:, :], p["gamma_e"])
    return nu, g


# ------------------------------------------------------------ decode


@torch.no_grad()
def decode(ref: Ref, dq: Dict[str, np.ndarray], shape: tuple, device,
           rows: int = 1 << 16) -> torch.Tensor:
    """The decoded raster (H, W, C) of dequantized params {A (K, d, d),
    musX, nu_e, gamma_e, pis}: every kernel gated at every pixel of the
    linspace(0, 1) axes, mixed, clipped and rounded to `bits`."""
    p = {f: torch.as_tensor(np.asarray(dq[f], np.float32), device=device)
         for f in ("musX", "nu_e", "gamma_e", "pis")}
    A = torch.as_tensor(np.asarray(dq["A"], np.float32), device=device)
    axes = [torch.as_tensor(np.linspace(0.0, 1.0, s).astype(np.float32),
                            device=device) for s in shape]
    x = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1) \
        .reshape(-1, len(shape))
    mask = p["pis"] > 0
    out = []
    for i in range(0, x.shape[0], rows):
        w = ref.gate(p, x[i:i + rows], mask, A=A)
        out.append(ref.output(ref.mix(p, w, x[i:i + rows])))
    c = p["nu_e"].shape[1]
    return torch.cat(out).reshape(tuple(shape) + (c,))
