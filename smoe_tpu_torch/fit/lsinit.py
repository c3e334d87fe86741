"""Least-squares expert (re)initialisation (from smoe_tpu/fit/lsinit.py).

For fixed gating weights w[n, k] the model

    res[n, c] = sum_k w[n, k] * (nu_e[k, c] + gamma_e[k, :, c] @ x[n])

is linear in (nu_e, gamma_e), so the squared reconstruction error has a
closed-form minimiser: one weighted normal-equations solve.  Two modes, as
in the JAX package (lsinit.py:17-46):

  * 'kernel' (any K): per-kernel responsibility-weighted LS, the EM M-step
    of a mixture of affine experts, K independent (1+d)x(1+d) solves; the
    result is a search direction, and an exact line search on the blend
    objective, clipped to [0, 1], takes the step (t = 0 is in the set, so
    the blend mse never rises);
  * 'coupled' (K*(1+d) <= coupled_max_cols): the exact joint minimiser,
    one (K*p, K*p) ridge-regularised solve.

Rows are weighted by the overlap crop, the light-field train mask and the
loss mask, as the training loss weighs them; gating comes from the same
effective (QAT'd) parameters as the forward; kernels with no gated mass
keep their experts.

The Gram accumulation and the line search are plain torch matmuls and
einsums in exact fp32 (a CUDA matmul refuses to run while TF32 is
allowed, core/model.py:_exact_matmul); the JAX package leaves them to XLA,
with no Pallas kernel.  Blocks are walked in row chunks
(fit/blocks.row_chunks), so no (N, K*p) array of a whole block is built.

The JAX package jits the accumulation, each solve and the line search
(lsinit.py:78, 150, 231, 304).  Here each is a program of the trainer's
(`Smoe._program`, fit/graph.py:Programs): on the card the first refresh of
a key runs eagerly, the second captures, later ones replay.  So no op of
theirs waits for the host: the solves are `torch.linalg.solve_ex`, whose
`info` rides the refresh's one host pull (with the gated mass) and raises
there with the message `torch.linalg.solve` gives, before any parameter is
written.
"""

from __future__ import annotations

from typing import Optional

import torch

from smoe_tpu_torch.config import SmoeConfig
from smoe_tpu_torch.core.model import _exact_matmul, gating, maha_from_A
from smoe_tpu_torch.video.motion import transform_coords
from smoe_tpu_torch.fit.blocks import row_chunks

# mass below which a kernel keeps its experts (no pixels to fit)
_MASS_EPS = 1e-6


def _refuse_tf32(t: torch.Tensor) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: the least-squares "
            "solve needs exact fp32")


def _design_coords(eff, cfg: SmoeConfig, coords: torch.Tensor):
    """(coords for the maha, raw coords for the dual model's raw-domain
    kernels, coords for the experts), as the trainer's forward routes them
    (lsinit.py:68-75): a motion-compensated video fit gates and regresses on
    the transformed coordinates."""
    if eff.motion is not None and cfg.dim_domain == 3:
        coords_t = transform_coords(coords, eff.motion, cfg.num_params_model,
                                    cfg.num_frames)
        return coords_t, coords, coords_t
    return coords, None, coords


def _row_weights(coords_all: torch.Tensor, valid, train_mask, loss_w):
    """(valid (Nb,), train_mask (B, Nb), loss_w (B, Nb)) as float tensors,
    with None meaning all ones."""
    b, nb = coords_all.shape[:2]
    dev = coords_all.device
    valid = torch.ones((nb,), device=dev) if valid is None \
        else valid.to(torch.float32)
    train_mask = torch.ones((b, nb), device=dev) if train_mask is None \
        else train_mask.to(torch.float32)
    loss_w = torch.ones((b, nb), device=dev) if loss_w is None \
        else loss_w.to(torch.float32)
    return valid, train_mask, loss_w


def _chunks(eff, cfg, coords_all, targets_all, klists, valid, train_mask,
            loss_w, model_mask, width: int):
    """Yield (w_e (m, K), row weights (m,), expert coords (m, d), targets
    (m, C)) over every block in row chunks, as lsinit.py:95-110 forms
    them."""
    valid, train_mask, loss_w = _row_weights(coords_all, valid, train_mask,
                                             loss_w)
    diag_A = torch.diagonal(eff.A, dim1=1, dim2=2)
    nb = coords_all.shape[1]
    s = row_chunks(nb, width)
    m = nb // s
    for b in range(coords_all.shape[0]):
        for i in range(s):
            sl = slice(i * m, (i + 1) * m)
            cin, craw, cexp = _design_coords(eff, cfg, coords_all[b, sl])
            maha = maha_from_A(eff.A, eff.musX, cfg, cin, craw, model_mask)
            w_e = gating(maha, eff.pis, diag_A, cfg, klists[b])
            rw = valid[sl] * loss_w[b, sl] * train_mask[b, sl]
            yield w_e, rw, cexp, targets_all[b, sl]


@torch.no_grad()
def _accumulate(eff, cfg: SmoeConfig, coords_all, targets_all, klists,
                valid, train_mask, loss_w, coupled: bool, model_mask=None):
    """One pass over the blocks, accumulating the weighted normal equations
    (lsinit.py:78-147).  Returns (G, b): 'kernel' mode G (K, p, p), b
    (K, p, C); 'coupled' mode G (K*p, K*p), b (K*p, C)."""
    _refuse_tf32(coords_all)
    k = eff.pis.shape[0]
    d = cfg.dim_domain
    c = targets_all.shape[-1]
    p = 1 + d
    dev = coords_all.device
    if coupled:
        G = torch.zeros((k * p, k * p), device=dev)
        bvec = torch.zeros((k * p, c), device=dev)
    else:
        G = torch.zeros((k, p, p), device=dev)
        bvec = torch.zeros((k, p, c), device=dev)
    for w_e, rw, cexp, targets in _chunks(
            eff, cfg, coords_all, targets_all, klists, valid, train_mask,
            loss_w, model_mask, k * p if coupled else k):
        wv = w_e * rw[:, None]                                   # (m, K)
        phi = torch.cat([torch.ones_like(cexp[:, :1]), cexp], dim=1)
        if coupled:
            z = (wv[:, :, None] * phi[:, None, :]).reshape(-1, k * p)
            G += _exact_matmul(z.T, z)
            bvec += _exact_matmul(z.T, targets)
        else:
            pp = (phi[:, :, None] * phi[:, None, :]).reshape(-1, p * p)
            G += _exact_matmul(wv.T, pp).reshape(k, p, p)
            py = (phi[:, :, None] * targets[:, None, :]).reshape(-1, p * c)
            bvec += _exact_matmul(wv.T, py).reshape(k, p, c)
    return G, bvec


_SINGULAR = "The solver failed because the input matrix is singular."


def _first_failure(info: torch.Tensor) -> torch.Tensor:
    """(index of the first system whose factorisation failed, or -1;
    1.0 for a batch of systems, 0.0 for one), on the device, without a
    sync."""
    bad = info.reshape(-1) > 0
    first = torch.where(bad.any(), torch.argmax(bad.to(torch.int32))
                        .to(torch.float32), torch.full((), -1.0,
                                                       device=info.device))
    return torch.stack([first, torch.full((), float(info.dim() > 0),
                                          device=info.device)])


def raise_failed_solves(failures) -> None:
    """Raise as `torch.linalg.solve` does for the first failed solve in
    `failures` (host numbers: pairs of `_first_failure`)."""
    f = [float(v) for v in failures]
    for first, batched in zip(f[::2], f[1::2]):
        if first >= 0:
            where = f"(Batch element {int(first)}): " if batched else ""
            raise torch.linalg.LinAlgError(
                f"torch.linalg.solve: {where}{_SINGULAR}")


def _solve(A: torch.Tensor, B: torch.Tensor, failures) -> torch.Tensor:
    """torch.linalg.solve(A, B) without its host sync: `solve_ex`, its
    `_first_failure` appended to `failures`; failures=None checks at once
    (one sync), as torch.linalg.solve does."""
    x, info = torch.linalg.solve_ex(A, B)
    if failures is None:
        raise_failed_solves(_first_failure(info).cpu().tolist())
    else:
        failures.append(_first_failure(info))
    return x


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """jnp.nanmedian: the mean of the two middle values of an even count
    (torch.nanmedian returns the lower one); nan when every entry is."""
    return torch.nanquantile(x, 0.5)


def _only_y(cfg: SmoeConfig, c: int) -> bool:
    return cfg.train_gammas and cfg.only_y_gamma and cfg.use_yuv and c == 3


@torch.no_grad()
def _solve_kernel(G, bvec, nu0, gam0, cfg: SmoeConfig, ridge: float,
                  damp: float, failures=None):
    """Per-kernel damped solves in the delta domain; kernels without mass
    keep (nu0, gam0) (lsinit.py:150-228: the slope entries are damped by
    damp x the median live slope curvature; damp = 0 is pure LS with a
    tiny ridge).  failures: a list that collects each solve's failure
    record (`_solve`), or None to raise at once."""
    _refuse_tf32(G)
    k, p, _ = G.shape
    c = bvec.shape[-1]
    dev = G.device
    eye = torch.eye(p, device=dev)
    mass = G[:, 0, 0]                                          # sum_n w
    tr = torch.diagonal(G, dim1=1, dim2=2).sum(-1) / p
    ok = mass > _MASS_EPS
    safe_mass = torch.clamp(mass, min=_MASS_EPS)

    if damp == 0.0:
        reg = (ridge * tr + _MASS_EPS)[:, None, None] * eye[None]
        if cfg.train_gammas:
            x = _solve(G + reg, bvec, failures)                 # (K, p, C)
        else:
            x = torch.zeros((k, p, c), device=dev)
            x[:, 0, :] = bvec[:, 0, :] / safe_mass[:, None]
        if _only_y(cfg, c):
            # slopes only on Y; U/V take the weighted-mean offset
            x[:, 1:, 1:] = 0.0
            x[:, 0, 1:] = bvec[:, 0, 1:] / safe_mass[:, None]
    else:
        tr_g = torch.diagonal(G[:, 1:, 1:], dim1=1, dim2=2).sum(-1) / (p - 1)
        med = _nanmedian(torch.where(ok, tr_g, torch.full_like(tr_g,
                                                              float("nan"))))
        med = torch.where(torch.isnan(med), torch.zeros_like(med), med)
        lam_g = ridge * tr + damp * med + _MASS_EPS             # (K,)
        lam_nu = ridge * tr + _MASS_EPS
        lam_d = torch.cat([lam_nu[:, None], lam_g[:, None].expand(k, p - 1)],
                          dim=1)                                # (K, p)
        x0 = torch.cat([nu0[:, None, :], gam0], dim=1)          # (K, p, C)
        if cfg.train_gammas:
            rhs = bvec - torch.einsum("kpq,kqc->kpc", G, x0)
            x = x0 + _solve(G + lam_d[:, :, None] * eye[None], rhs,
                            failures)
        else:
            dnu = (bvec[:, 0, :] - mass[:, None] * nu0) \
                / (mass + lam_nu)[:, None]
            x = torch.zeros((k, p, c), device=dev)
            x[:, 0, :] = nu0 + dnu
        if _only_y(cfg, c):
            dnu_uv = (bvec[:, 0, 1:] - mass[:, None] * nu0[:, 1:]) \
                / (mass + lam_nu)[:, None]
            x[:, 1:, 1:] = 0.0
            x[:, 0, 1:] = nu0[:, 1:] + dnu_uv
    nu = torch.where(ok[:, None], x[:, 0, :], nu0)
    gam = torch.where(ok[:, None, None], x[:, 1:, :], gam0)
    return nu, gam


@torch.no_grad()
def _solve_coupled(G, bvec, nu0, gam0, cfg: SmoeConfig, ridge: float,
                   damp: float, failures=None):
    """One joint damped solve over all kernels in the delta domain around
    (nu0, gam0), damping the slope entries only (lsinit.py:231-301).  Dead
    rows get a unit diagonal and keep their experts.  failures: as
    `_solve_kernel`'s."""
    _refuse_tf32(G)
    k = nu0.shape[0]
    c = bvec.shape[-1]
    p = G.shape[0] // k
    dev = G.device
    diag = torch.diagonal(G)
    diag_kp = diag.reshape(k, p)
    mass = diag_kp[:, 0]
    ok = mass > _MASS_EPS
    okp = ok[:, None].expand(k, p).reshape(-1)       # repeat_interleave
    diag_fix = torch.where(okp, torch.zeros_like(diag), torch.ones_like(diag))
    n_live = torch.clamp(torch.sum(okp.to(torch.float32)), min=1.0)
    scale = torch.sum(torch.where(okp, diag, torch.zeros_like(diag))) / n_live
    lam_nu = ridge * torch.clamp(scale, min=_MASS_EPS) + _MASS_EPS
    idx = torch.arange(k, device=dev) * p                      # nu columns

    if damp == 0.0:
        Gr = G + torch.diag(diag_fix + lam_nu)
        x = torch.zeros((k, p, c), device=dev)
        if cfg.train_gammas:
            x = _solve(Gr, bvec, failures).reshape(k, p, c)
        else:
            x[:, 0, :] = _solve(Gr[idx][:, idx], bvec[idx], failures)
        if _only_y(cfg, c):
            nu_uv = _solve(Gr[idx][:, idx], bvec[idx][:, 1:], failures)
            x[:, 1:, 1:] = 0.0
            x[:, 0, 1:] = nu_uv
    else:
        tr_g = torch.mean(diag_kp[:, 1:], dim=1)
        med = _nanmedian(torch.where(ok, tr_g, torch.full_like(tr_g,
                                                              float("nan"))))
        med = torch.where(torch.isnan(med), torch.zeros_like(med), med)
        lam_g = lam_nu + damp * med
        is_nu = (torch.arange(k * p, device=dev) % p) == 0
        lam = torch.where(is_nu, lam_nu, lam_g)
        Gr = G + torch.diag(diag_fix + lam)
        x0f = torch.cat([nu0[:, None, :], gam0], dim=1).reshape(k * p, c)
        if cfg.train_gammas:
            rhs = bvec - _exact_matmul(G, x0f)
            x = (x0f + _solve(Gr, rhs, failures)).reshape(k, p, c)
        else:
            rhs = bvec[idx] - _exact_matmul(G[idx][:, idx], nu0)
            x = torch.zeros((k, p, c), device=dev)
            x[:, 0, :] = nu0 + _solve(Gr[idx][:, idx], rhs, failures)
        if _only_y(cfg, c):
            rhs_uv = bvec[idx][:, 1:] - _exact_matmul(G[idx][:, idx],
                                                      nu0[:, 1:])
            x[:, 1:, 1:] = 0.0
            x[:, 0, 1:] = nu0[:, 1:] + _solve(Gr[idx][:, idx], rhs_uv,
                                              failures)
    nu = torch.where(ok[:, None], x[:, 0, :], nu0)
    gam = torch.where(ok[:, None, None], x[:, 1:, :], gam0)
    return nu, gam


@torch.no_grad()
def _line_search_t(eff, cfg: SmoeConfig, coords_all, targets_all, klists,
                   valid, train_mask, loss_w, nu0, gam0, d_nu, d_gam,
                   model_mask=None):
    """Exact step along (d_nu, d_gam) for the blend objective
    sum_n rw_n ||yhat_n + t u_n - y_n||^2: t* = -<r,u>/<u,u>, clipped to
    [0, 1] (lsinit.py:304-362).  yhat uses the float (pre-QAT) experts,
    what the solve fits."""
    _refuse_tf32(coords_all)
    uu = torch.zeros((), device=coords_all.device)
    ru = torch.zeros((), device=coords_all.device)
    for w_e, rw, cexp, targets in _chunks(
            eff, cfg, coords_all, targets_all, klists, valid, train_mask,
            loss_w, model_mask, int(eff.pis.shape[0])):
        yhat = torch.einsum("nk,kc->nc", w_e, nu0) + \
            torch.einsum("nk,nd,kdc->nc", w_e, cexp, gam0)
        u = torch.einsum("nk,kc->nc", w_e, d_nu) + \
            torch.einsum("nk,nd,kdc->nc", w_e, cexp, d_gam)
        r = yhat - targets
        uu = uu + torch.sum(rw[:, None] * u * u)
        ru = ru + torch.sum(rw[:, None] * r * u)
    t = torch.where(uu > 0, -ru / torch.clamp(uu, min=1e-30),
                    torch.zeros_like(uu))
    return torch.clamp(t, 0.0, 1.0)


def _effective(smoe):
    """The trainer's effective (QAT'd) params, as its forward takes them."""
    from smoe_tpu_torch.fit.trainer import effective_params
    with torch.no_grad():
        return effective_params(smoe.params, smoe.cfg, smoe.musX_grid)


def lists_buffer(smoe) -> torch.Tensor:
    """The trainer's kernel lists copied into the sweep's own lists buffer
    (which every chunk refills), so that a program reads them at one
    address."""
    lists, _ = smoe._sweep_buffers()
    lists.copy_(smoe.kernel_lists)
    return lists


def gram(smoe, coupled: bool, lw, lists):
    """(G, b) of `_accumulate` over the trainer's blocks, as the trainer's
    program keyed by every value and tensor it reads (`Smoe._program`):
    buffers that the next call overwrites."""
    from smoe_tpu_torch.fit.graph import tensor_key as t
    bset = smoe.bset
    key = ("ls_accumulate", coupled, t(lists), t(lw), smoe._state_key())
    return smoe._program(key, lambda: _accumulate(
        _effective(smoe), smoe.cfg, bset.coords, bset.targets, lists,
        bset.valid, bset.train_mask, lw, coupled,
        model_mask=smoe.model_mask))


def ls_refresh_experts(smoe, mode: str = "auto", ridge: float = 1e-6,
                       coupled_max_cols: int = 4096,
                       use_loss_mask: bool = True, damp: float = 0.0,
                       timings: Optional[dict] = None) -> float:
    """Replace (nu_e, gamma_e) of the trainer `smoe` with their least-
    squares fit under the current gating (lsinit.py:365-428).  Returns the
    gated pixel mass (a diagnostic).

    mode: 'kernel' | 'coupled' | 'auto' (coupled when K*(1+d) <=
    coupled_max_cols).  damp: Levenberg-style damping of the slopes toward
    the current experts (fraction of the median live slope curvature).
    The loss mask, where the trainer has one, weights the rows unless
    use_loss_mask is False.  The parameters are written in place; the
    optimizer state is left as it is.
    timings: when given a dict, it receives the seconds of "accumulate",
    "solve" and "line_search" (about 0 in coupled mode), by CUDA events on
    the card (each lap waits for its event: off by default)."""
    from smoe_tpu_torch.fit.graph import tensor_key

    cfg = smoe.cfg
    kcap = int(smoe.params.pis.shape[0])
    p = 1 + cfg.dim_domain
    if mode == "auto":
        mode = "coupled" if kcap * p <= coupled_max_cols else "kernel"
    if mode not in ("kernel", "coupled"):
        raise ValueError(f"ls mode must be 'auto', 'kernel' or 'coupled', "
                         f"got {mode!r}")
    coupled = mode == "coupled"
    bset = smoe.bset
    lw = smoe.loss_mask if (use_loss_mask and smoe.loss_mask is not None) \
        else None
    lists = lists_buffer(smoe)
    nu0 = smoe.params.nu_e.detach()
    gam0 = smoe.params.gamma_e.detach()
    t = tensor_key
    base = (coupled, t(lists), t(lw), smoe._state_key())
    clock = _Clock(smoe.device, timings)
    G, bvec = gram(smoe, coupled, lw, lists)
    clock.lap("accumulate")
    solve = _solve_coupled if coupled else _solve_kernel

    def solve_program():
        failures = []
        nu, gam = solve(G, bvec, nu0, gam0, cfg, float(ridge), float(damp),
                        failures)
        mass = torch.diagonal(G).reshape(kcap, p)[:, 0].sum() if coupled \
            else G[:, 0, 0].sum()
        return nu, gam, torch.cat([mass.reshape(1)] + failures)

    nu_x, gam_x, tail = smoe._program(
        ("ls_solve", float(ridge), float(damp), t(G), t(bvec), t(nu0),
         t(gam0)) + base, solve_program)
    clock.lap("solve")
    nu, gam = nu_x, gam_x
    if not coupled:
        # the M-step as a direction, with an exact line search on the
        # blend mse: never regresses
        def line_program():
            step = _line_search_t(_effective(smoe), cfg, bset.coords,
                                  bset.targets, lists, bset.valid,
                                  bset.train_mask, lw, nu0, gam0,
                                  nu_x - nu0, gam_x - gam0,
                                  model_mask=smoe.model_mask)
            return nu0 + step * (nu_x - nu0), gam0 + step * (gam_x - gam0)

        nu, gam = smoe._program(("ls_line_search", t(nu_x), t(gam_x))
                                + base, line_program)
    clock.lap("line_search")
    tail = tail.cpu().tolist()                 # the one host pull
    raise_failed_solves(tail[1:])
    with torch.no_grad():
        smoe.params.nu_e.copy_(nu)
        smoe.params.gamma_e.copy_(gam)
    smoe.valid = False
    return tail[0]


class _Clock:
    """Seconds between laps: CUDA events on the card, the host clock on the
    CPU; inert without a dict to fill."""

    def __init__(self, device, out: Optional[dict]):
        self.cuda = torch.device(device).type == "cuda"
        self.out = out
        if out is not None:
            self.t = self._mark()

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        import time
        return time.perf_counter()

    def lap(self, name: str) -> None:
        if self.out is None:
            return
        t = self._mark()
        if self.cuda:
            t.synchronize()
            self.out[name] = self.t.elapsed_time(t) / 1e3
        else:
            self.out[name] = t - self.t
        self.t = t
