"""PyTorch port: the least-squares expert solve (fit/lsinit.py) against the
JAX package's on the CPU.

Both trainers are built from the same image and config, so they hold the
same init.  Tolerances: the accumulated normal equations 1e-5 relative to
max |G| (fp32 sums over the pixels in another order); the solves fed the
same (G, b) 1e-4 of max |x|; the line-search step 1e-4 absolute; the
refreshed experts end to end 1e-4 of max |x| in kernel mode and 1e-3 in
coupled mode, and the eval mse after the solve 2e-3 relative (the eval
ends in the 8-bit output fake-quantizer: one pixel that lands a step apart
moves the mse of these 576-pixel toys by ~1e-4, as in
tests/test_torch_trainer.py).  The
coupled system of the toy has a condition number of about 1.2e4, which
turns the ~5e-7 relative difference of the two packages' fp32 normal
equations into ~2e-4 of max |x| (the JAX package's own fp32 solve sits
1.7e-4 of max from the float64 solve of its equations)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from smoe_tpu.fit import lsinit as jls  # noqa: E402
from smoe_tpu.fit.trainer import Smoe as JSmoe  # noqa: E402
from smoe_tpu.fit.trainer import effective_params as jeff  # noqa: E402
from smoe_tpu_torch.fit import lsinit as tls  # noqa: E402
from smoe_tpu_torch.fit.trainer import Smoe  # noqa: E402
from smoe_tpu_torch.fit.trainer import effective_params as teff  # noqa: E402

G_RTOL = 1e-5
X_TOL = 1e-4
X_TOL_COUPLED = 1e-3
MSE_RTOL = 2e-3


def _toy(n):
    y, x = np.mgrid[0:n, 0:n] / (n - 1)
    return np.stack([0.5 + 0.3 * np.sin(4 * x + 1.5 * y),
                     0.5 + 0.25 * np.cos(3 * (x - 0.3) * (y + 0.4) * 4),
                     0.4 + 0.3 * np.sin(5 * x * y)], -1).astype(np.float32)


def _pair(n=24, kpd=4, **kw):
    """A JAX and a port trainer on the same image and config."""
    img = _toy(n)
    bs = kw.pop("batch_size", None)
    extra = {} if bs is None else {"batch_size": bs}
    js = JSmoe(img, kernels_per_dim=[kpd], **extra, **kw)
    ts = Smoe(img, kernels_per_dim=[kpd], device="cpu", **extra, **kw)
    return js, ts


def _close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    assert np.abs(a - b).max() <= tol * scale, (what, np.abs(a - b).max(),
                                                scale)


def _args(s, jax_side):
    bset = s.bset
    if jax_side:
        eff = jeff(s.params, s.cfg, s.musX_grid)
        lw = jnp.ones(bset.coords.shape[:2], jnp.float32)
        return eff, (bset.coords, bset.targets, s.kernel_lists, bset.valid,
                     bset.train_mask, lw)
    eff = teff(s.params, s.cfg, s.musX_grid)
    return eff, (bset.coords, bset.targets, s.kernel_lists, bset.valid,
                 None, None)


@pytest.mark.parametrize("coupled", [False, True])
def test_accumulate_matches_jax(coupled):
    js, ts = _pair(batch_size=(12, 12))
    je, ja = _args(js, True)
    te, ta = _args(ts, False)
    jG, jb = jls._accumulate(je, js.cfg, *ja, js.model_mask, coupled)
    tG, tb = tls._accumulate(te, ts.cfg, *ta, coupled)
    assert tG.shape == jG.shape and tb.shape == jb.shape
    _close(tG.numpy(), jG, G_RTOL, "G")
    _close(tb.numpy(), jb, G_RTOL, "b")


def _gram(coupled, k=16, p=3, c=3, seed=0, live=12):
    """A seeded SPD system with `live` kernels of mass (an even count, so
    the damped branches' median takes two middle values) and the rest
    dead."""
    rng = np.random.default_rng(seed)
    nu0 = rng.normal(0.5, 0.3, (k, c)).astype(np.float32)
    gam0 = rng.normal(0, 0.5, (k, p - 1, c)).astype(np.float32)
    if coupled:
        z = rng.normal(size=(400, k * p)).astype(np.float32)
        z[:, live * p:] = 0.0
        z[:, ::p] = np.abs(z[:, ::p])
        G = z.T @ z
        b = z.T @ rng.normal(size=(400, c)).astype(np.float32)
    else:
        z = rng.normal(size=(k, 50, p)).astype(np.float32)
        z[..., 0] = np.abs(z[..., 0]) + 0.2
        z[live:] = 0.0
        G = np.einsum("knp,knq->kpq", z, z)
        b = np.einsum("knp,knc->kpc", z, rng.normal(size=(k, 50, c)))
    return (G.astype(np.float32), b.astype(np.float32), nu0, gam0)


@pytest.mark.parametrize("coupled", [False, True])
@pytest.mark.parametrize("damp", [0.0, 1e-2])
@pytest.mark.parametrize("variant", ["full", "only_y", "no_gamma"])
def test_solves_match_jax(coupled, damp, variant):
    from smoe_tpu.config import SmoeConfig as JConfig
    from smoe_tpu_torch.config import SmoeConfig
    kw = {"full": {}, "only_y": {"only_y_gamma": True},
          "no_gamma": {"train_gammas": False}}[variant]
    G, b, nu0, gam0 = _gram(coupled)
    jsolve = jls._solve_coupled if coupled else jls._solve_kernel
    tsolve = tls._solve_coupled if coupled else tls._solve_kernel
    jnu, jgam = jsolve(jnp.asarray(G), jnp.asarray(b), jnp.asarray(nu0),
                       jnp.asarray(gam0), JConfig(**kw), 1e-6, damp)
    tnu, tgam = tsolve(*(torch.as_tensor(x) for x in (G, b, nu0, gam0)),
                       SmoeConfig(**kw), 1e-6, damp)
    _close(tnu.numpy(), jnu, X_TOL, "nu")
    _close(tgam.numpy(), jgam, X_TOL, "gamma")
    # the dead kernels keep their experts exactly
    np.testing.assert_array_equal(tnu.numpy()[12:], nu0[12:])
    np.testing.assert_array_equal(tgam.numpy()[12:], gam0[12:])


def test_nanmedian_averages_the_middle_pair():
    x = torch.tensor([4.0, float("nan"), 1.0, 3.0, 2.0])
    assert float(tls._nanmedian(x)) == float(
        jnp.nanmedian(jnp.asarray(x.numpy()))) == 2.5
    assert float(torch.nanmedian(x)) == 2.0     # the trap avoided


def test_line_search_t_matches_jax():
    js, ts = _pair(batch_size=(12, 12))
    je, ja = _args(js, True)
    te, ta = _args(ts, False)
    rng = np.random.default_rng(3)
    k, d, c = js.cfg.capacity, 2, 3
    d_nu = rng.normal(0, 0.1, (k, c)).astype(np.float32)
    d_gam = rng.normal(0, 0.1, (k, d, c)).astype(np.float32)
    nu0 = np.array(js.params.nu_e)
    gam0 = np.array(js.params.gamma_e)
    jt = jls._line_search_t(je, js.cfg, *ja, js.model_mask, nu0, gam0,
                            d_nu, d_gam)
    tt = tls._line_search_t(te, ts.cfg, *ta,
                            *(torch.as_tensor(x) for x in (nu0, gam0, d_nu,
                                                           d_gam)))
    assert 0.0 <= float(tt) <= 1.0
    np.testing.assert_allclose(float(tt), float(jt), atol=1e-4)


CASES = {
    "auto_coupled": dict(mode="auto"),
    "kernel": dict(mode="kernel"),
    "kernel_damped": dict(mode="kernel", damp=1e-2),
    "coupled_damped": dict(mode="coupled", damp=1e-2),
    "only_y_gamma": dict(mode="auto", cfg=dict(only_y_gamma=True)),
    "no_gamma": dict(mode="kernel", cfg=dict(train_gammas=False)),
    "loss_mask": dict(mode="auto", mask=True),
    "blocks_overlap": dict(mode="kernel", cfg=dict(overlap=2),
                           batch_size=(12, 12)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ls_refresh_experts_matches_jax(case):
    spec = CASES[case]
    kw = dict(spec.get("cfg", {}))
    if "batch_size" in spec:
        kw["batch_size"] = spec["batch_size"]
    if spec.get("mask"):
        # rows outside the loss mask must not enter the solve
        m = np.ones((24, 24), np.float32)
        m[4:12, 8:16] = 0.0
        kw["loss_mask"] = m
    js, ts = _pair(**kw)
    mode, damp = spec["mode"], spec.get("damp", 0.0)
    jm = jls.ls_refresh_experts(js, mode=mode, damp=damp)
    tm = tls.ls_refresh_experts(ts, mode=mode, damp=damp)
    np.testing.assert_allclose(tm, jm, rtol=G_RTOL)
    tol = X_TOL if mode == "kernel" else X_TOL_COUPLED
    _close(ts.params.nu_e.detach().numpy(), js.params.nu_e, tol, "nu")
    _close(ts.params.gamma_e.detach().numpy(), js.params.gamma_e, tol,
           "gamma")
    jmse = js.run_batched(train=False)[1]
    tmse = ts.run_batched(train=False)[1]
    np.testing.assert_allclose(tmse, jmse, rtol=MSE_RTOL)


def test_ls_init_never_regresses_and_times_its_steps():
    _, ts = _pair()
    before = ts.run_batched(train=False)[1]
    timings = {}
    ts.ls_init_experts(mode="kernel", timings=timings)
    after = ts.run_batched(train=False)[1]
    assert after <= before
    assert set(timings) == {"accumulate", "solve", "line_search"}
    assert all(v >= 0 for v in timings.values())


def test_ls_refresh_in_train_cadence_matches_jax():
    """train(ls_refresh_iter=N): the chunks end at the refresh cadence,
    the refresh runs before the validation (trainer.py:1564-1607)."""
    js, ts = _pair()
    runs = []
    for s in (js, ts):
        seen = []
        s.train(12, val_iter=8, ls_refresh_iter=5,
                callbacks=[lambda m: seen.append(m.iter)])
        runs.append((seen, [v for _, v in s.mses]))
    assert runs[0][0] == runs[1][0] == [0, 8, 12]
    np.testing.assert_allclose(runs[1][1], runs[0][1], rtol=MSE_RTOL)


def test_loss_mask_rows_are_excluded():
    """A corrupted square under a zero loss weight leaves the coupled solve
    (damp 0: independent of the experts it starts from) as it is without
    the corruption: its rows carry no weight."""
    img = _toy(24)
    bad = img.copy()
    bad[4:12, 8:16] = 1.0 - bad[4:12, 8:16]
    m = np.ones((24, 24), np.float32)
    m[4:12, 8:16] = 0.0
    out = []
    for im in (img, bad):
        s = Smoe(im, kernels_per_dim=[4], loss_mask=m, device="cpu")
        s.ls_init_experts(mode="coupled")
        out.append(s.params.nu_e.detach().numpy())
    np.testing.assert_array_equal(out[0], out[1])
