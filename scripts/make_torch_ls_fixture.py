"""Record the JAX package's least-squares expert solves on the bench
flagship (512^2 RGB, 16x16 kernels, YUV loss, determinant gating, one
block; bench.py:26, 46-54) for the PyTorch port's solves to be held
against on the card.

    JAX_PLATFORMS=cpu python scripts/make_torch_ls_fixture.py

Output (committed, ~40 KB):
    tests/data/bench512_lsinit_ref.npz
        {auto,kernel}_nu_e (256, 3), {auto,kernel}_gamma_e (256, 2, 3):
            the experts after `Smoe.ls_init_experts(mode)` from the default
            init ("auto" is the coupled solve: 256 * 3 = 768 columns);
        {auto,kernel}_mse: the blend mse after the solve, by the exact
            (XLA) eval with the reconstruction;
        init_mse: the same eval before any solve;
        auto_f64_nu_e / auto_f64_gamma_e: the coupled system solved in
            float64 from the JAX package's fp32 normal equations, which
            shows how far its conditioning lets two fp32 solves drift.

The card has no JAX, so `chip_smoke.py` compares the port's solves on the
card with these recorded ones instead of live JAX solves.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-o", "--out", default=os.path.join(
        ROOT, "tests", "data", "bench512_lsinit_ref.npz"))
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from bench import BENCH_K, build_image
    from smoe_tpu import Smoe
    from smoe_tpu.fit import lsinit
    from smoe_tpu.fit.trainer import effective_params

    img = build_image(512)
    out = {}
    for mode in ("auto", "kernel"):
        s = Smoe(img, kernels_per_dim=[BENCH_K], use_yuv=True,
                 use_determinant=True)
        if mode == "auto":
            out["init_mse"] = np.float32(s.run_batched(
                train=False, update_reconstruction=True)[1])
        if mode == "auto":
            # the coupled normal equations the solve sees, for the float64
            # solve
            eff = effective_params(s.params, s.cfg, s.musX_grid)
            lw = jnp.ones(s.bset.coords.shape[:2], jnp.float32)
            G, b = lsinit._accumulate(eff, s.cfg, s.bset.coords,
                                      s.bset.targets, s.kernel_lists,
                                      s.bset.valid, s.bset.train_mask, lw,
                                      s.model_mask, True)
            nu64, gam64 = _solve64(np.asarray(G, np.float64),
                                   np.asarray(b, np.float64),
                                   np.asarray(s.params.nu_e, np.float64),
                                   np.asarray(s.params.gamma_e, np.float64))
            out["auto_f64_nu_e"] = nu64.astype(np.float32)
            out["auto_f64_gamma_e"] = gam64.astype(np.float32)
        t0 = time.time()
        s.ls_init_experts(mode=mode)
        secs = time.time() - t0
        mse = s.run_batched(train=False, update_reconstruction=True)[1]
        out[f"{mode}_nu_e"] = np.asarray(s.params.nu_e, np.float32)
        out[f"{mode}_gamma_e"] = np.asarray(s.params.gamma_e, np.float32)
        out[f"{mode}_mse"] = np.float32(mse)
        print(f"{mode}: {secs:.1f} s, mse {out['init_mse']:.4f} -> "
              f"{mse:.4f}")
    for f in ("nu_e", "gamma_e"):
        a32, a64 = out[f"auto_{f}"], out[f"auto_f64_{f}"]
        print(f"coupled {f}: fp32 vs float64 "
              f"{np.abs(a32 - a64).max() / np.abs(a64).max():.2e} of max")
    np.savez(a.out, **out)
    print(f"wrote {a.out}")


def _solve64(G, b, nu0, gam0, ridge=1e-6, eps=1e-6):
    """The damp = 0 coupled solve of smoe_tpu/fit/lsinit.py:252-270
    (train_gammas, all channels sloped) in float64."""
    k, p = nu0.shape[0], G.shape[0] // nu0.shape[0]
    diag = np.diagonal(G)
    ok = diag.reshape(k, p)[:, 0] > eps
    okp = np.repeat(ok, p)
    n_live = max(okp.sum(), 1.0)
    lam = ridge * max(np.where(okp, diag, 0.0).sum() / n_live, eps) + eps
    x = np.linalg.solve(G + np.diag(np.where(okp, 0.0, 1.0) + lam), b)
    x = x.reshape(k, p, -1)
    nu = np.where(ok[:, None], x[:, 0, :], nu0)
    gam = np.where(ok[:, None, None], x[:, 1:, :], gam0)
    return nu, gam


if __name__ == "__main__":
    main()
