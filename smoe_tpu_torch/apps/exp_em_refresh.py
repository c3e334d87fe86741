"""EM-style closed-form refresh of the GATING params (musX, A): a study
(from scripts/exp_em_refresh.py).

The LS expert refresh (`-lsri`, fit/lsinit.py) saturates at a ceiling set
by the gating: once the experts are optimal for the current gating, only
Adam moves (musX, A).  The SMoE model is the conditional-mean regressor of
a joint (x, y) Gaussian mixture, so the mixture M-step gives closed-form
gating updates from the same Gram matrices the LS solve accumulates
(kernel mode):

    G[k] = sum_n w[n,k] [1 x][1 x]^T  =  [[S0, S1^T], [S1, S2]]
    mu*_k    = S1/S0
    Sigma*_k = S2/S0 - mu* mu*^T          ->  A* = chol(Sigma*^-1)

Like the expert M-step this optimizes the mixture objective, not the blend
MSE, so (mu* - mu, A* - A) is a direction, stepped by the t of a small
candidate set that gives the lowest blend mse through the trainer's eval
(t = 0 included: never regresses).  A*'s columns are sign-matched to the
current diag(A).

Variants: lsri (the periodic LS expert refresh alone), em (a periodic EM
gating step, then a kernel-list refresh and the LS expert refresh) and
em_y (the same with responsibilities that also weigh how well each
kernel's own expert explains the pixel).

On the card the Gram accumulations and the evals of the candidate steps
are programs of the trainer's (fit/graph.py): the first call of a key runs
eagerly, the second captures, later ones replay, and each candidate's
params are written in place, so the replay reads them.

    python -m smoe_tpu_torch.apps.exp_em_refresh [--size 512] [--max 1000]
        [--refresh 100] [--ts 0,0.01,0.03,0.1,0.3,1]
        [--variants lsri,em,em_y] [--device cuda|cpu]

Prints a line a variant and one JSON line ({"metric": "em_refresh_study",
...}, with the card's name and power limit).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from smoe_tpu_torch.apps import add_device_arg, device_of
from smoe_tpu_torch.bench import common
from smoe_tpu_torch.bench.flagship import build_image, make_smoe, warm_chunk


def _yaware_gram(s, lists, s2: torch.Tensor) -> torch.Tensor:
    """The (K, 1+d, 1+d) moments of the joint mixture's responsibilities
    r[n,k] = w[n,k] exp(-|y_n - m_k(x_n)|^2 / (2 s2)) over every block
    (exp_em_refresh.py:60-93): the gating weighted by how well kernel k's
    own expert explains the pixel, summed channel by channel."""
    from smoe_tpu_torch.core.model import _exact_matmul, gating, maha_from_A
    from smoe_tpu_torch.fit.lsinit import _design_coords, _effective
    cfg, bset = s.cfg, s.bset
    eff = _effective(s)
    kcap = eff.pis.shape[0]
    p = 1 + cfg.dim_domain
    diag_A = torch.diagonal(eff.A, dim1=1, dim2=2)
    valid = bset.valid.to(torch.float32)[:, None]
    G = torch.zeros((kcap, p, p), device=s.device)
    for b in range(bset.coords.shape[0]):
        targets = bset.targets[b]
        cin, craw, cexp = _design_coords(eff, cfg, bset.coords[b])
        maha = maha_from_A(eff.A, eff.musX, cfg, cin, craw, s.model_mask)
        w_e = gating(maha, eff.pis, diag_A, cfg, lists[b])
        r2 = torch.zeros((cexp.shape[0], kcap), device=s.device)
        for c in range(targets.shape[-1]):
            pc = eff.nu_e[None, :, c] + _exact_matmul(
                cexp, eff.gamma_e[:, :, c].T)
            r2 = r2 + (pc - targets[:, c:c + 1]) ** 2
        r = w_e * torch.exp(-0.5 * r2 / s2) * valid
        phi = torch.cat([torch.ones_like(cexp[:, :1]), cexp], dim=1)
        pp = (phi[:, :, None] * phi[:, None, :]).reshape(-1, p * p)
        G = G + _exact_matmul(r.T, pp).reshape(kcap, p, p)
    return G


def accumulate_yaware(s, sigma2: float) -> torch.Tensor:
    """`_yaware_gram` as the trainer's program: sigma^2 goes into a
    0-dim buffer of the trainer's, the lists into the sweep's lists
    buffer, so every call replays one graph on the card."""
    from smoe_tpu_torch.fit.graph import tensor_key as t
    from smoe_tpu_torch.fit.lsinit import lists_buffer
    lists = lists_buffer(s)
    s2 = getattr(s, "_em_sigma2", None)
    if s2 is None:
        s2 = s._em_sigma2 = torch.zeros((), device=s.device)
    s2.fill_(float(sigma2))
    key = ("em_yaware_gram", t(lists), t(s2), s._state_key())
    with torch.no_grad():
        return s._program(key, lambda: (_yaware_gram(s, lists, s2),))[0]


def em_gating_direction(s, yaware=False, sigma2=None):
    """(d_mu, d_Adiag, d_Acorr, ok) toward the mixture M-step, zero for
    kernels without gated mass or with a non-SPD moment matrix
    (exp_em_refresh.py:97-150)."""
    from smoe_tpu_torch.fit.lsinit import gram, lists_buffer
    if yaware:
        G = accumulate_yaware(s, sigma2)
    else:
        G, _ = gram(s, False, s.loss_mask, lists_buffer(s))
    G = G.cpu().numpy().astype(np.float64)
    k, p, _ = G.shape
    d = p - 1
    S0 = G[:, 0, 0]
    ok = S0 > 1e-6
    mu_star = G[:, 0, 1:] / np.maximum(S0, 1e-12)[:, None]
    Exx = G[:, 1:, 1:] / np.maximum(S0, 1e-12)[:, None, None]
    Sigma = Exx - mu_star[:, :, None] * mu_star[:, None, :]
    Sigma = 0.5 * (Sigma + np.swapaxes(Sigma, 1, 2)) + 1e-12 * np.eye(d)

    with torch.no_grad():
        A_cur = (s.params.a_diag + s.params.a_corr).cpu().numpy() \
            .astype(np.float64)
        mu_cur = s.params.musX.cpu().numpy().astype(np.float64)[:, :d]
    A_star = np.array(A_cur)
    for i in range(k):
        if not ok[i]:
            continue
        try:
            Sinv = np.linalg.inv(Sigma[i])
            L = np.linalg.cholesky(0.5 * (Sinv + Sinv.T))
        except np.linalg.LinAlgError:
            ok[i] = False
            continue
        # the current column sign pattern (the maha is invariant; keeps
        # prod(diag A)'s sign for the determinant normalizer)
        sgn = np.sign(np.diagonal(A_cur[i]))
        sgn[sgn == 0] = 1.0
        A_star[i] = L * sgn[None, :]

    d_mu = np.where(ok[:, None], mu_star - mu_cur, 0.0)
    dA = np.where(ok[:, None, None], A_star - A_cur, 0.0)
    ii = np.arange(d)
    d_Adiag = np.zeros_like(dA)
    d_Adiag[:, ii, ii] = dA[:, ii, ii]
    d_Acorr = np.tril(dA, -1)
    return d_mu.astype(np.float32), d_Adiag.astype(np.float32), \
        d_Acorr.astype(np.float32), ok


def _set_gating(s, p0, step, t: float) -> None:
    """musX, a_diag, a_corr <- p0 + t * step, written in place (a program
    reads them where they are)."""
    with torch.no_grad():
        for f in ("musX", "a_diag", "a_corr"):
            getattr(s.params, f).copy_(p0[f] + t * step[f])
    s.valid = False


def em_gating_step(s, ts, yaware=False):
    """The line-searched EM gating step (exp_em_refresh.py:152-180):
    returns (the chosen t, the mse at t)."""
    s2 = None
    if yaware:
        _, mse, _, _ = s.run_batched(train=False)
        # sigma^2 of the joint model's y-noise ~ the current fit's mse
        # (reported scaled by (2^p)^2, reference smoe.py:1053)
        s2 = max(float(mse) / float(2 ** s.cfg.precision) ** 2, 1e-8)
    d_mu, d_Ad, d_Ac, _ = em_gating_direction(s, yaware, s2)
    p0 = {f: getattr(s.params, f).detach().clone()
          for f in ("musX", "a_diag", "a_corr")}
    step = {f: torch.as_tensor(v, device=s.device) for f, v in
            (("musX", d_mu), ("a_diag", d_Ad), ("a_corr", d_Ac))}
    best = (0.0, None)
    for t in ts:
        _set_gating(s, p0, step, t)
        _, mse, _, _ = s.run_batched(train=False)
        mse = float(mse)
        if best[1] is None or mse < best[1]:
            best = (t, mse)
    _set_gating(s, p0, step, best[0])
    return best


def fit(s, max_iters, chunk=20, refresh=100, em=False, ts=(0.0,)):
    """exp_em_refresh.py:182-201."""
    from smoe_tpu_torch.core.losses import psnr_from_mse
    iters, psnr = 0, 0.0
    traj, t_em = [], []
    while iters < max_iters:
        _, mse_a, _, _ = s.run_batched_chunk(chunk)
        iters += chunk
        if iters % 100 == 0:
            s.update_kernel_list()
        if refresh and iters % refresh == 0 and iters < max_iters:
            if em:
                t, _ = em_gating_step(s, ts, yaware=em == "y")
                t_em.append(t)
                s.update_kernel_list()
            s.ls_init_experts(mode="kernel")
        psnr = max(psnr, psnr_from_mse(np.nanmin(mse_a), s.cfg.precision))
        traj.append((iters, round(float(psnr), 2)))
    return {"psnr": round(float(psnr), 2),
            "traj": traj[:5] + traj[5::5],
            **({"t_chosen": t_em} if em else {})}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--max", type=int, default=1000)
    ap.add_argument("--refresh", type=int, default=100)
    ap.add_argument("--ts", type=str, default="0,0.01,0.03,0.1,0.3,1")
    ap.add_argument("--variants", type=str, default="lsri,em,em_y")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args.device)
    ts = tuple(float(x) for x in args.ts.split(","))

    img = build_image(args.size)
    s = make_smoe(img, device)
    s.set_optimizer()
    warm_chunk(s, 20, rounds=2)

    out = {}
    all_v = {"lsri": False, "em": True, "em_y": "y"}
    for tag in args.variants.split(","):
        em = all_v[tag]
        s.reinit()
        s.ls_init_experts(mode="kernel")
        t0 = time.time()
        out[tag] = fit(s, args.max, refresh=args.refresh, em=em, ts=ts)
        common.clock(device)
        out[tag]["wall_s"] = round(time.time() - t0, 1)
        print(tag, json.dumps(out[tag]), flush=True)
    out = {"metric": "em_refresh_study", **out,
           **common.card_fields(device)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
