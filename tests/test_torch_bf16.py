"""PyTorch port: compute_dtype="bfloat16" against the JAX package on the CPU.

The mode has three numerical behaviours, each held here to its JAX
counterpart on the same numpy inputs:

  * the plain path (core/model.py `maha_from_A`, `expert_regression`):
    the operands of the maha and of both expert products rounded to bf16,
    each product exact and summed in fp32, the cotangents rounded to bf16
    at each cast (JAX's astype; the port's round_bf16 under autograd);
  * the fused op (kernels/gate_expert.py `GateExpert` with bf16): phi and
    q' rounded for the maha alone, in the forward and in the backward's
    recomputation, dq' summed over the fp32 phi, the gradients unrounded;
    against `fused_gate_expert(..., interpret=True, bf16=True)`;
  * every caller that hands the fit's cfg to them: the trainer's sweeps
    (tests/test_flag_matrix.py's "bf16" case), the LS accumulation, the
    kernel lists; the decoder, whose cfg comes from the file's header,
    stays fp32.

Tolerances.  A maha from bf16 operands is a sum of exact products, so the
two packages part by their fp32 summation orders: 1e-6 of sum_j |phi_j q_j|
(the bf16 operands' own magnitudes, not the cancelled result).  A
cotangent is rounded to bf16 after an fp32 sum, so where the two fp32 sums
straddle a bf16 rounding boundary the packages part by one bf16 ulp
(2^-8 to 2^-7 relative); elsewhere the rounded cotangents are equal.  The fused
op at OP_TOL (tests/test_torch_gate_expert_bwd.py), the sweeps at the
trainer tests' rtol 2e-3.

Takes ~40 s alone on one worker (JAX compiles each shape)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from smoe_tpu.config import SmoeConfig as JConfig  # noqa: E402
from smoe_tpu.core import model as jm  # noqa: E402
from smoe_tpu.core.init import init_params  # noqa: E402
from smoe_tpu.core.params import assemble_A as j_assemble_A  # noqa: E402
from smoe_tpu.fit import blocks as JB  # noqa: E402
from smoe_tpu.fit import lsinit as jls  # noqa: E402
from smoe_tpu.fit.trainer import Smoe as JSmoe  # noqa: E402
from smoe_tpu.fit.trainer import effective_params as jeff  # noqa: E402
from smoe_tpu.kernels import gate_expert as jge  # noqa: E402
from smoe_tpu_torch.config import SmoeConfig  # noqa: E402
from smoe_tpu_torch.core import model as tm  # noqa: E402
from smoe_tpu_torch.core.params import (assemble_A,  # noqa: E402
                                        params_from_numpy)
from smoe_tpu_torch.fit import blocks as TB  # noqa: E402
from smoe_tpu_torch.fit import lsinit as tls  # noqa: E402
from smoe_tpu_torch.fit.trainer import Smoe  # noqa: E402
from smoe_tpu_torch.fit.trainer import effective_params as teff  # noqa: E402
from smoe_tpu_torch.kernels import gate_expert as tge  # noqa: E402

from test_torch_gate_expert_bwd import OP_TOL, _random_op  # noqa: E402

BF16 = {"compute_dtype": "bfloat16"}
SUM_RTOL = 1e-6          # of sum_j |phi_j q_j| (or |w_k nu_k|)
BF16_ULP = 2.0 ** -7     # one bf16 ulp, relative, at most
RTOL = 2e-3              # per-sweep loss and mse (tests/test_torch_trainer.py)
FLOOR = 1e-11


def _bf16(x):
    """x rounded to bf16 and back, in numpy (as torch and JAX round)."""
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _is_bf16(x) -> bool:
    x = np.asarray(x, np.float32)
    return bool(np.array_equal(x, _bf16(x)))


def _setup(case, n=57, seed=0):
    """(jcfg, tcfg, jax params, port params, coords, coords_raw, model
    mask) at d = 2, 3, 4, or the dual model at d = 3 (F = 26); the params
    as tests/test_torch_model.py perturbs them."""
    rng = np.random.default_rng(seed)
    d = {"d2": 2, "d3": 3, "dual": 3, "d4": 4}[case]
    img = rng.uniform(0.1, 0.9, (12,) * d + (3,)).astype(np.float32)
    kpd = (4, 4) if d == 2 else (2,) * d
    jcfg = JConfig(dim_domain=d, kernels_per_dim=kpd, **BF16)
    tcfg = SmoeConfig(dim_domain=d, kernels_per_dim=kpd, **BF16)
    p = init_params(img, jcfg)
    p = p.replace(
        gamma_e=rng.normal(0, 0.3, p.gamma_e.shape).astype(np.float32),
        a_corr=rng.normal(0, 1.0, p.a_corr.shape).astype(np.float32),
        nu_e=(p.nu_e + rng.normal(0, 0.05, p.nu_e.shape)).astype(
            np.float32))
    coords = rng.uniform(0, 1, (n, d)).astype(np.float32)
    raw = mm = None
    if case == "dual":
        raw = rng.uniform(0, 1, (n, d)).astype(np.float32)
        mm = rng.uniform(size=p.pis.shape[0]) < 0.5
    jp = p.replace(**{f: jnp.asarray(getattr(p, f))
                      for f in ("musX", "a_diag", "a_corr", "pis", "nu_e",
                                "gamma_e")})
    return jcfg, tcfg, jp, params_from_numpy(p.to_numpy()), coords, raw, mm


def _maha_terms(jA, jp, jcfg, coords, raw, mm):
    """sum_j |phi_j q_j| per (pixel, kernel) from the bf16-rounded
    operands: the scale of the maha's fp32 summation error."""
    B = np.einsum("klm,knm->kln", np.asarray(jA), np.asarray(jA))
    q = jm.kernel_quadratics(jnp.asarray(B), jp.musX)
    if raw is not None:
        phi, q = jm.dual_domain_features(jnp.asarray(coords),
                                         jnp.asarray(raw), q,
                                         jnp.asarray(mm))
    else:
        phi = jm.quadratic_features(jnp.asarray(coords))
    return np.abs(_bf16(phi)) @ np.abs(_bf16(q)).T


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    x = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _cotangent_close(a, b, scale):
    """Two gradients whose terms were rounded to bf16 after fp32 sums in
    different orders: equal to the sums' order (SUM_RTOL of `scale`) but
    where a sum straddles a bf16 rounding boundary, where they part by one
    bf16 ulp; at most 2 % of the entries do."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    close = np.abs(a - b) <= SUM_RTOL * scale + 1e-30
    ulp = np.abs(a - b) <= _bf16_ulp(np.maximum(np.abs(a), np.abs(b)))
    assert np.all(close | ulp), np.abs(a - b)[~(close | ulp)]
    assert np.mean(~close) <= 0.02, np.mean(~close)


@pytest.mark.parametrize("case", ["d2", "dual", "d4"])
def test_plain_maha_and_experts_match_jax(case):
    """maha_from_A and expert_regression at bf16: forward to the fp32
    summation order of the rounded operands, and the cotangents that
    leave each cast bf16-representable and equal on both sides."""
    jcfg, tcfg, jp, tp, coords, raw, mm = _setup(case)
    jA, tA = j_assemble_A(jp, jcfg), assemble_A(tp, tcfg)
    jraw = None if raw is None else jnp.asarray(raw)
    jmm = None if mm is None else jnp.asarray(mm)
    traw = None if raw is None else torch.as_tensor(raw)
    tmm = None if mm is None else torch.as_tensor(mm)
    terms = _maha_terms(jA, jp, jcfg, coords, raw, mm)
    maha_j = np.asarray(jm.maha_from_A(jA, jp.musX, jcfg,
                                       jnp.asarray(coords), jraw, jmm))
    maha_t = tm.maha_from_A(tA, tp.musX, tcfg, torch.as_tensor(coords),
                            traw, tmm)
    assert np.all(np.abs(maha_t.numpy() - maha_j) <= 1e-30
                  + SUM_RTOL * terms)
    # the bf16 maha is not the fp32 one: the rounding is on both sides
    tcfg32 = SmoeConfig(dim_domain=tcfg.dim_domain,
                        kernels_per_dim=tcfg.kernels_per_dim)
    maha32 = tm.maha_from_A(tA, tp.musX, tcfg32, torch.as_tensor(coords),
                            traw, tmm)
    assert not torch.equal(maha32, maha_t)

    # the cotangent of the maha's q operand, rounded at the cast: take the
    # gradient with respect to q itself through the same product
    rng = np.random.default_rng(1)
    W = rng.normal(0, 1, maha_j.shape).astype(np.float32)
    B = np.einsum("klm,knm->kln", np.asarray(jA), np.asarray(jA))
    q_np = np.asarray(jm.kernel_quadratics(jnp.asarray(B), jp.musX))
    if raw is not None:
        phi_np, q_np = (np.asarray(a) for a in jm.dual_domain_features(
            jnp.asarray(coords), jraw, jnp.asarray(q_np), jmm))
    else:
        phi_np = np.asarray(jm.quadratic_features(jnp.asarray(coords)))

    def j_prod(phi, q):
        return jnp.sum(jnp.dot(phi.astype(jnp.bfloat16),
                               q.T.astype(jnp.bfloat16),
                               preferred_element_type=jnp.float32,
                               precision=jax.lax.Precision.HIGHEST) * W)
    gphi_j, gq_j = jax.grad(j_prod, (0, 1))(jnp.asarray(phi_np),
                                            jnp.asarray(q_np))
    phi_t = torch.tensor(phi_np, requires_grad=True)
    q_t = torch.tensor(q_np, requires_grad=True)
    (tm._exact_matmul(tm._operand(phi_t, tcfg), tm._operand(q_t.T, tcfg))
     * torch.as_tensor(W)).sum().backward()
    for g_t, g_j, x in ((q_t.grad, gq_j, np.abs(_bf16(phi_np))),
                        (phi_t.grad, gphi_j, np.abs(_bf16(q_np)))):
        assert _is_bf16(g_t.numpy()) and _is_bf16(g_j)
        scale = (np.abs(W).T @ x if g_t.shape == q_np.shape
                 else np.abs(W) @ x)
        _cotangent_close(g_t.numpy(), g_j, scale)

    # the expert products: forward and the gradients of w_e, nu_e, gamma_e
    w = rng.uniform(0, 1, maha_j.shape).astype(np.float32)
    w[w < 0.6] = 0.0
    wts = rng.normal(0, 1, (coords.shape[0], 3)).astype(np.float32)

    def j_res(w, nu, gamma):
        return jnp.sum(jm.expert_regression(w, jnp.asarray(coords), nu,
                                            gamma, jcfg) * wts)
    res_j = np.asarray(jm.expert_regression(jnp.asarray(w),
                                            jnp.asarray(coords), jp.nu_e,
                                            jp.gamma_e, jcfg))
    g_j = jax.grad(j_res, (0, 1, 2))(jnp.asarray(w), jp.nu_e, jp.gamma_e)
    tw = torch.as_tensor(w).requires_grad_()
    tnu = tp.nu_e.clone().requires_grad_()
    tgam = tp.gamma_e.clone().requires_grad_()
    res_t = tm.expert_regression(tw, torch.as_tensor(coords), tnu, tgam,
                                 tcfg)
    (res_t * torch.as_tensor(wts)).sum().backward()
    mag = np.abs(_bf16(w)) @ (np.abs(_bf16(np.asarray(jp.nu_e)))
                              + np.abs(_bf16(np.asarray(jp.gamma_e)))
                              .sum(1))
    assert np.all(np.abs(res_t.detach().numpy() - res_j)
                  <= 1e-30 + 2 * SUM_RTOL * mag)
    # nu_e's and gamma_e's cotangents leave one cast each; w_e's two, one
    # a product, each rounded apart and then summed in fp32
    assert _is_bf16(tnu.grad.numpy()) and _is_bf16(g_j[1])
    scale_nu = np.abs(_bf16(w)).T @ np.abs(wts)
    _cotangent_close(tnu.grad.numpy(), g_j[1], scale_nu)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(g_j[0]),
                               rtol=2 * BF16_ULP, atol=1e-6)
    np.testing.assert_allclose(tgam.grad.numpy(), np.asarray(g_j[2]),
                               rtol=2 * BF16_ULP, atol=1e-6)


def test_plain_round_is_jax_astype():
    """round_bf16 rounds to nearest even as JAX's astype does, on ties,
    subnormals, infinities and NaN alike, and its gradient is the
    cotangent rounded to bf16."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(0, 1, 4000), rng.normal(0, 1e4, 1000),
                        [1 + 2 ** -8, 1 + 3 * 2 ** -8, 1e-40, -1e-39,
                         3.4e38, np.inf, -np.inf]]).astype(np.float32)
    t = tge.round_bf16(torch.as_tensor(x))
    np.testing.assert_array_equal(t.numpy(), _bf16(x))
    xt = torch.as_tensor(x[:4000]).requires_grad_()
    g = rng.normal(0, 1, 4000).astype(np.float32)
    (tge.round_bf16(xt) * torch.as_tensor(g)).sum().backward()
    gj = jax.grad(lambda v: jnp.sum(v.astype(jnp.bfloat16)
                                    .astype(jnp.float32) * g))(
        jnp.asarray(x[:4000]))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gj))
    assert np.isnan(tge.round_bf16(torch.tensor([np.nan])).item())


FUSED = {
    "clamp_d2": lambda: _random_op(64, 7, 9, 3, 2, 13),
    "dual_f26": lambda: _random_op(70, 26, 12, 4, 1, 23, q_scale=0.3),
}


@pytest.mark.parametrize("case", sorted(FUSED))
def test_fused_op_bf16_matches_pallas_interpret(case):
    """The port's GateExpert at bf16 (plain versions on the CPU) against
    JAX's fused_gate_expert(..., interpret=True, bf16=True): res, surv and
    the gradients of q, G and pi_det at OP_TOL; the gradients are fp32,
    not rounded to bf16; and bf16 is not the fp32 op."""
    args = FUSED[case]()
    phi, xe, q, G, pi_det, mask, wts = map(jnp.asarray, args)
    n = phi.shape[0]

    def j_loss(q, G, pi_det):
        res, _ = jge.fused_gate_expert(phi, xe, q, G, pi_det, mask, 1e-3,
                                       FLOOR, n, True, True)
        return jnp.sum(res * wts)
    res_j, surv_j = jge.fused_gate_expert(phi, xe, q, G, pi_det, mask, 1e-3,
                                          FLOOR, n, True, True)
    g_j = jax.grad(j_loss, (0, 1, 2))(q, G, pi_det)

    tphi, txe, tq, tG, tpi, tmask, twts = map(torch.as_tensor, args)
    tq, tG, tpi = (t.clone().requires_grad_() for t in (tq, tG, tpi))
    res_t, surv_t = tge.GateExpert.apply(tphi, txe, tq, tG, tpi, tmask,
                                         1e-3, FLOOR, True)
    (res_t * twts).sum().backward()
    np.testing.assert_allclose(res_t.detach().numpy(), np.asarray(res_j),
                               **OP_TOL)
    np.testing.assert_allclose(surv_t.numpy(), np.asarray(surv_j), **OP_TOL)
    for name, a, b in zip(("q", "G", "pi_det"), (tq.grad, tG.grad, tpi.grad),
                          g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **OP_TOL,
                                   err_msg=name)
    # the op's gradients leave it in fp32 (the VJP does not round them)
    assert not _is_bf16(tq.grad.numpy()) and not _is_bf16(g_j[0])
    assert not _is_bf16(tpi.grad.numpy())
    res32, _ = tge.GateExpert.apply(tphi, txe, tq, tG, tpi, tmask, 1e-3,
                                    FLOOR)
    assert not torch.equal(res32, res_t)


def test_fused_bwd_reference_uses_fp32_phi_for_dq():
    """K2's plain version at bf16: the recomputed maha from rounded phi and
    q', dq' over the fp32 phi (gate_expert.py:300): rounding phi in the
    dq' product too would give other bits."""
    args = _random_op(80, 21, 11, 5, 3, 21, q_scale=0.3)
    phi, xe, q, G, pi_det, mask, g = map(torch.as_tensor, args)
    q_s = q * (-0.5 * mask)[:, None]
    dq, dG, dpi = tge.gate_expert_bwd(phi, xe, q_s, G, pi_det, g, 1e-3,
                                      FLOOR, bf16=True)
    dq_r, _, _ = tge.gate_expert_bwd_reference(
        tge.round_bf16(phi), xe, q_s, G, pi_det, g, 1e-3, FLOOR, bf16=True)
    assert not torch.equal(dq, dq_r)
    # the gate (dG, dpi) sees the rounded phi alike either way
    _, dG_r, dpi_r = tge.gate_expert_bwd_reference(
        tge.round_bf16(phi), xe, q_s, G, pi_det, g, 1e-3, FLOOR, bf16=True)
    assert torch.equal(dG, dG_r) and torch.equal(dpi, dpi_r)


def _flag_img():
    """tests/test_flag_matrix.py's 16 x 16 toy."""
    y, x = np.mgrid[0:16, 0:16] / 15.0
    im = np.stack([0.5 + 0.3 * np.sin(4 * x), 0.5 + 0.2 * np.cos(3 * y),
                   0.45 + 0.1 * np.sin(2 * (x + y))], -1)
    return im.astype(np.float32)


def test_flag_matrix_bf16_sweeps_track_jax():
    """The flag matrix's "bf16" case (16^2 toy, kernels_per_dim=[3], the
    plain path off the TPU): the initial eval, 5 free-running sweeps with
    their per-sweep loss and mse, and the final eval against JAX's."""
    img = _flag_img()
    js = JSmoe(img, kernels_per_dim=[3], **BF16)
    ts = Smoe(img, kernels_per_dim=[3], device="cpu", **BF16)
    assert ts.cfg.compute_dtype == "bfloat16" and not ts.fused
    out = []
    for s in (js, ts):
        s.set_optimizer()
        rows = [s.run_batched(train=False)[:2]]
        for _ in range(5):
            rows.append(s.run_batched(train=True, pis_l1=1e-5,
                                      u_l1=1e-9)[:2])
        rows.append(s.run_batched(train=False,
                                  update_reconstruction=True)[:2])
        out.append(np.asarray(rows, np.float64))
    assert np.isfinite(out[1]).all()
    np.testing.assert_allclose(out[1], out[0], rtol=RTOL)
    assert ts.get_reconstruction().shape == img.shape


def test_fused_bf16_sweeps_match_jax():
    """The same fit through the fused op (JAX's Pallas op in interpret
    mode).  Free-running, the first 3 sweeps at RTOL; then the two fits
    part, as two correct bf16 fits do: an A that the two fp32 updates
    leave 1 ulp apart can round q to neighbouring bf16 values (a 2^-8 step
    of a B-scale term, which moves the maha by whole units).  So 5 sweeps
    are held each from JAX's state (params, lists, Adam's moments): the
    sweep's loss and mse at 1e-5 and the params it leaves at 1e-4 of
    their largest."""
    from test_torch_video import carry
    img = _flag_img()
    js = JSmoe(img, kernels_per_dim=[3], use_pallas="on", **BF16)
    ts = Smoe(img, kernels_per_dim=[3], use_pallas="on", device="cpu",
              **BF16)
    assert ts.fused
    free = Smoe(img, kernels_per_dim=[3], use_pallas="on", device="cpu",
                **BF16)
    for s in (js, ts, free):
        s.set_optimizer()
    for i in range(5):
        carry(js, ts)
        j = js.run_batched(train=True, pis_l1=1e-5, u_l1=1e-9)
        t = ts.run_batched(train=True, pis_l1=1e-5, u_l1=1e-9)
        np.testing.assert_allclose(t[:2], j[:2], rtol=1e-5)
        assert t[2] == j[2]
        f = free.run_batched(train=True, pis_l1=1e-5, u_l1=1e-9)
        if i < 3:
            np.testing.assert_allclose(f[:2], j[:2], rtol=RTOL)
        for name in ("musX", "a_diag", "a_corr", "pis", "nu_e", "gamma_e"):
            a = getattr(ts.params, name).detach().numpy()
            b = np.asarray(getattr(js.params, name))
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), (i, name)


def test_bf16_fit_differs_from_fp32():
    """compute_dtype selects bf16 exactly at "bfloat16"; any other value
    computes in fp32, as JAX's (model.py:121: else coords.dtype)."""
    img = _flag_img()
    losses = {}
    for dt in ("bfloat16", "float32", "float16"):
        s = Smoe(img, kernels_per_dim=[3], device="cpu", compute_dtype=dt)
        s.set_optimizer()
        losses[dt] = s.run_batched_chunk(3)[0]
    np.testing.assert_array_equal(losses["float16"], losses["float32"])
    assert not np.array_equal(losses["bfloat16"], losses["float32"])


@pytest.mark.parametrize("coupled", [False, True])
def test_ls_accumulation_and_lists_match_jax(coupled):
    """The LS refresh's accumulation (its maha through the fit's cfg, JAX
    lsinit.py:102 and :324 in one function in the port), the kernel lists
    (blocks.py:215 centres, :262 probes) and the per-kernel LS init at
    bf16, against JAX's."""
    kw = dict(kernels_per_dim=[4], batch_size=(12, 12), **BF16)
    img = _flag_img()
    img = np.concatenate([np.concatenate([img, img[::-1]], 0)] * 2, 1)[:24,
                                                                       :24]
    js = JSmoe(img, **kw)
    ts = Smoe(img, device="cpu", **kw)
    np.testing.assert_array_equal(ts.kernel_lists.numpy(),
                                  np.asarray(js.kernel_lists))
    je = jeff(js.params, js.cfg, js.musX_grid)
    te = teff(ts.params, ts.cfg, ts.musX_grid)
    jb, tb = js.bset, ts.bset
    lw = jnp.ones(jb.coords.shape[:2], jnp.float32)
    jG, jbv = jls._accumulate(je, js.cfg, jb.coords, jb.targets,
                              js.kernel_lists, jb.valid, jb.train_mask, lw,
                              js.model_mask, coupled)
    tG, tbv = tls._accumulate(te, ts.cfg, tb.coords, tb.targets,
                              ts.kernel_lists, tb.valid, None, None, coupled)
    for a, b in ((tG, jG), (tbv, jbv)):
        b = np.asarray(b, np.float64)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()
    # the probe lists through update_kernel_lists, bf16 maha on both sides
    rng = np.random.default_rng(2)
    base = rng.uniform(size=ts.kernel_lists.shape) < 0.1
    ju = JB.update_kernel_lists(je.A, je.musX, je.pis, js.cfg, jb,
                                jnp.asarray(base))
    tu = TB.update_kernel_lists(te.A, te.musX, te.pis, ts.cfg, tb,
                                torch.as_tensor(base))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    if coupled:
        return
    ts.ls_init_experts(mode="kernel")
    js.ls_init_experts(mode="kernel")
    for f in ("nu_e", "gamma_e"):
        a = ts.get_params()[f]
        b = np.asarray(js.get_params()[f], np.float64)
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max(), f


def test_decoder_of_a_bf16_fit_stays_fp32(tmp_path):
    """A bf16 fit's .smoe decodes in fp32: the header carries no compute
    dtype, and codec/serve.py builds its cfg from it, as JAX's
    serve.py:129-131 does.  The port's decode of the file is within 1 LSB
    of JAX's; the bf16 encoder's own quantized evals run in bf16, so they
    part from the decode by design and are not held to it here."""
    from smoe_tpu.codec.serve import decode_bitstream as j_decode
    from smoe_tpu_torch.codec.bitstream import write_bitstream
    from smoe_tpu_torch.codec.quantize import quantize_params
    from smoe_tpu_torch.codec.serve import decode_bitstream, read_model
    img = _flag_img()
    s = Smoe(img, kernels_per_dim=[3], device="cpu", **BF16)
    s.set_optimizer()
    s.run_batched_chunk(5)
    path = str(tmp_path / "m.smoe")
    write_bitstream(path, quantize_params(s.get_params(), s.cfg), s.cfg,
                    extra={"shape_of_img": [16, 16], "dim_of_output": [3],
                           "use_yuv": bool(s.cfg.use_yuv),
                           "use_determinant": bool(s.cfg.use_determinant)})
    cfg, _, _ = read_model(path)
    assert cfg.compute_dtype == "float32"
    dec = decode_bitstream(path, device="cpu")
    jdec = np.asarray(j_decode(path))
    assert dec.shape == jdec.shape == img.shape
    lsb = np.abs(np.round(dec * 255) - np.round(jdec * 255)).max()
    assert lsb <= 1


def test_program_keys_see_compute_dtype():
    """A captured sweep or program bakes in whether the fit is bf16: the
    chunk's key (`_graph_key`) and the evals' and LS refresh's
    (`_state_key`) hold the cfg, so a bf16 fit never replays an fp32
    graph, nor the reverse."""
    img = _flag_img()
    keys = {}
    for dt in ("bfloat16", "float32"):
        s = Smoe(img, kernels_per_dim=[3], device="cpu", compute_dtype=dt)
        s.set_optimizer()
        lists, row = s._sweep_buffers()
        args = (lists, row, None, None, None, None, None, True, False,
                False)
        keys[dt] = (s._graph_key(args), s._state_key())
    for i in range(2):
        assert keys["bfloat16"][i][0].compute_dtype == "bfloat16"
        assert keys["float32"][i][0].compute_dtype == "float32"
        assert keys["bfloat16"][i][0] != keys["float32"][i][0]
