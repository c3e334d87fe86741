"""PyTorch port: the plain forward path against smoe_tpu/core/model.py.

Same numpy inputs into both packages; fp32 tolerance rtol 1e-5 / atol
1e-6 because the two frameworks reduce in different orders."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from smoe_tpu.config import SmoeConfig as JConfig  # noqa: E402
from smoe_tpu.core import model as jm  # noqa: E402
from smoe_tpu.core.init import init_params  # noqa: E402
from smoe_tpu.core.params import assemble_A as j_assemble_A  # noqa: E402
from smoe_tpu_torch.config import SmoeConfig  # noqa: E402
from smoe_tpu_torch.core import model as tm  # noqa: E402
from smoe_tpu_torch.core.params import (assemble_A,  # noqa: E402
                                        params_from_numpy)

TOL = dict(rtol=1e-5, atol=1e-6)
VARIANTS = {
    "det_gammas": dict(use_determinant=True, train_gammas=True),
    "det_const": dict(use_determinant=True, train_gammas=False),
    "nodet_gammas": dict(use_determinant=False, train_gammas=True),
    "inverse_cov": dict(train_inverse_cov=True),
}


def _setup(d, kw, n=57, seed=0):
    """As tests/test_pallas.py::_setup: init params, perturbed so gammas
    and correlations are non-trivial, plus random coords."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.1, 0.9, (12,) * d + (3,)).astype(np.float32)
    kpd = (4, 4) if d == 2 else (2,) * d
    jcfg = JConfig(dim_domain=d, kernels_per_dim=kpd, **kw)
    tcfg = SmoeConfig(dim_domain=d, kernels_per_dim=kpd, **kw)
    p = init_params(img, jcfg)
    corr = 1.0 if not jcfg.train_inverse_cov else 0.2
    p = p.replace(
        gamma_e=rng.normal(0, 0.3, p.gamma_e.shape).astype(np.float32),
        a_corr=rng.normal(0, corr, p.a_corr.shape).astype(np.float32),
        nu_e=(p.nu_e + rng.normal(0, 0.05, p.nu_e.shape)).astype(
            np.float32))
    pis = np.asarray(p.pis).copy()
    pis[1] = 0.0                                  # a dead kernel
    p = p.replace(pis=pis)
    coords = rng.uniform(0, 1, (n, d)).astype(np.float32)
    jp = p.replace(**{f: jnp.asarray(getattr(p, f))
                      for f in ("musX", "a_diag", "a_corr", "pis", "nu_e",
                                "gamma_e")})
    return jcfg, tcfg, jp, params_from_numpy(p.to_numpy()), coords


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


@pytest.mark.parametrize("d", [2, 4])
def test_quadratic_features_and_kernel_quadratics(d):
    jcfg, tcfg, jp, tp, coords = _setup(d, {})
    _close(tm.quadratic_features(torch.as_tensor(coords)),
           jm.quadratic_features(jnp.asarray(coords)))
    A = j_assemble_A(jp, jcfg)
    B = np.einsum("klm,knm->kln", np.asarray(A), np.asarray(A))
    _close(tm.kernel_quadratics(torch.as_tensor(B), tp.musX),
           jm.kernel_quadratics(jnp.asarray(B), jp.musX))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("d", [2, 4])
def test_maha_gating_experts(d, variant):
    """Each stage is fed the SAME upstream values in both packages, so a
    mismatch points at the stage itself."""
    jcfg, tcfg, jp, tp, coords = _setup(d, VARIANTS[variant])
    kmask = np.ones(tp.capacity, bool)
    kmask[::5] = False
    jA, tA = j_assemble_A(jp, jcfg), assemble_A(tp, tcfg)
    maha_j = np.array(jm.maha_from_A(jA, jp.musX, jcfg,
                                       jnp.asarray(coords)))
    maha_t = tm.maha_from_A(tA, tp.musX, tcfg, torch.as_tensor(coords))
    # maha = phi . q cancels A^2-scale terms, so rtol 1e-5 is taken
    # against the sum of the absolute terms (the dot product's own
    # rounding scale), not against the cancelled result
    B = np.asarray(jA) if jcfg.train_inverse_cov else np.einsum(
        "klm,knm->kln", np.asarray(jA), np.asarray(jA))
    terms = np.abs(np.asarray(jm.quadratic_features(jnp.asarray(coords)))) \
        @ np.abs(np.asarray(jm.kernel_quadratics(jnp.asarray(B),
                                                 jp.musX))).T
    assert np.all(np.abs(maha_t.numpy() - maha_j) <= 1e-6 + 1e-5 * terms)

    diag_A = np.array(jnp.diagonal(jA, axis1=1, axis2=2))
    w_j = np.array(jm.gating(jnp.asarray(maha_j), jp.pis,
                               jnp.asarray(diag_A), jcfg,
                               jnp.asarray(kmask)))
    w_t = tm.gating(torch.as_tensor(maha_j), tp.pis,
                    torch.as_tensor(diag_A), tcfg, torch.as_tensor(kmask))
    _close(w_t, w_j)
    assert not w_t[:, ~(kmask & (np.asarray(jp.pis) > 0))].any()

    res_j = jm.expert_regression(jnp.asarray(w_j), jnp.asarray(coords),
                                 jp.nu_e, jp.gamma_e, jcfg)
    res_t = tm.expert_regression(torch.as_tensor(w_j),
                                 torch.as_tensor(coords), tp.nu_e,
                                 tp.gamma_e, tcfg)
    _close(res_t, res_j)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("d", [2, 4])
def test_smoe_forward(d, variant):
    jcfg, tcfg, jp, tp, coords = _setup(d, VARIANTS[variant], seed=3)
    kmask = np.ones(tp.capacity, bool)
    kmask[::3] = False
    out_j = jm.smoe_forward(jp, jcfg, jnp.asarray(coords),
                            jnp.asarray(kmask))
    out_t = tm.smoe_forward(tp, tcfg, torch.as_tensor(coords),
                            torch.as_tensor(kmask))
    _close(out_t.res, out_j.res)
    np.testing.assert_array_equal(out_t.survivors.numpy(),
                                  np.asarray(out_j.survivors))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("d", [2, 4])
def test_forward_fused_matches_jax(d, variant):
    """The port's fused forward (plain version on the CPU) against the JAX
    fused forward with the Pallas kernel in interpret mode."""
    jcfg, tcfg, jp, tp, coords = _setup(d, VARIANTS[variant], seed=5)
    kmask = np.ones(tp.capacity, bool)
    kmask[::4] = False
    jA, tA = j_assemble_A(jp, jcfg), assemble_A(tp, tcfg)
    out_j = jm.forward_fused(jA, jp.musX, jp.nu_e, jp.gamma_e, jp.pis, jcfg,
                             jnp.asarray(coords), jnp.asarray(kmask),
                             interpret=True)
    out_t = tm.forward_fused(tA, tp.musX, tp.nu_e, tp.gamma_e, tp.pis, tcfg,
                             torch.as_tensor(coords), torch.as_tensor(kmask))
    _close(out_t.res, out_j.res)
    np.testing.assert_array_equal(out_t.survivors.numpy(),
                                  np.asarray(out_j.survivors))


def test_forward_fused_refuses_grad():
    """The fused op's backward (K2) gives coords no gradient, so coords
    that require one are refused; parameters that require one are taken
    (tests/test_torch_train_model.py checks their gradients)."""
    jcfg, tcfg, jp, tp, coords = _setup(2, {})
    A = assemble_A(tp, tcfg).requires_grad_(True)
    mask = torch.ones(tp.capacity, dtype=torch.bool)
    out = tm.forward_fused(A, tp.musX, tp.nu_e, tp.gamma_e, tp.pis, tcfg,
                           torch.as_tensor(coords), mask)
    assert out.res.requires_grad
    with pytest.raises(NotImplementedError, match="coords"):
        tm.forward_fused(A, tp.musX, tp.nu_e, tp.gamma_e, tp.pis, tcfg,
                         torch.as_tensor(coords).requires_grad_(True), mask)


def test_fake_quant_rounds_half_to_even_with_straight_through():
    x = np.array([0.5 / 255, 1.5 / 255, 2.5 / 255, -0.2, 0.3, 1.4],
                 np.float32)
    _close(tm.fake_quant_unit(torch.as_tensor(x), 8),
           jm.fake_quant_unit(jnp.asarray(x), 8), rtol=0, atol=0)
    t = torch.as_tensor(x).requires_grad_(True)
    tm.fake_quant_unit(t, 8).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.ones_like(x))


def test_plain_matmul_refuses_tf32(monkeypatch):
    """On a CUDA tensor with TF32 allowed the plain maha raises; the
    check is exercised here with a stand-in CUDA flag."""
    class FakeCuda:
        is_cuda = True

        def __matmul__(self, other):
            raise AssertionError("matmul must not run")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        tm._exact_matmul(FakeCuda(), None)
