"""PyTorch port: the training forward `forward_fused` with gradients, its
capped-dense `k_cap` mode and `sv_add`, against the plain path and the
JAX package (smoe_tpu/core/model.py:229-342; tests/test_pallas.py
test_fused_gradients_match_xla and TestCappedDense).

Tolerances: gradients rtol 2e-4 / atol 2e-5 as tests/test_pallas.py
(the fused backward and autograd of the plain path sum in different
orders); capped against uncapped is exact (the gather keeps the kernels'
order, so every sum runs in the same order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from smoe_tpu.core import model as jm  # noqa: E402
from smoe_tpu.core.params import assemble_A as j_assemble_A  # noqa: E402
from smoe_tpu_torch.core import model as tm  # noqa: E402
from smoe_tpu_torch.core.params import assemble_A  # noqa: E402

from test_torch_model import VARIANTS, _setup  # noqa: E402

GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
NAMES = ("musX", "a_diag", "a_corr", "pis", "nu_e", "gamma_e")


def _torch_grads(tp, tcfg, coords, tgt, kmask, fused, k_cap=None):
    for n in NAMES:
        getattr(tp, n).requires_grad_().grad = None
    c = torch.as_tensor(coords)
    if fused:
        out = tm.forward_fused(assemble_A(tp, tcfg), tp.musX, tp.nu_e,
                               tp.gamma_e, tp.pis, tcfg, c, kmask,
                               k_cap=k_cap)
    else:
        out = tm.smoe_forward(tp, tcfg, c, kmask)
    loss = torch.sum(torch.square(out.res - tgt))
    loss.backward()
    return out, {n: torch.zeros_like(getattr(tp, n))
                 if getattr(tp, n).grad is None
                 else getattr(tp, n).grad.clone() for n in NAMES}


@pytest.mark.parametrize("variant", ["det_gammas", "det_const",
                                     "nodet_gammas"])
def test_forward_fused_gradients_match_jax_and_plain(variant):
    jcfg, tcfg, jp, tp, coords = _setup(2, VARIANTS[variant], seed=5)
    tgt = np.random.default_rng(9).uniform(
        0, 1, (coords.shape[0], 3)).astype(np.float32)
    kmask = np.ones(tp.capacity, bool)
    kmask[::5] = False

    def loss_xla(p):
        out = jm.smoe_forward(p, jcfg, jnp.asarray(coords),
                              jnp.asarray(kmask))
        return jnp.sum(jnp.square(out.res - tgt))

    g_x = jax.grad(loss_xla)(jp)
    km = torch.as_tensor(kmask)
    out_f, g_f = _torch_grads(tp, tcfg, coords, torch.as_tensor(tgt), km,
                              fused=True)
    out_p, g_p = _torch_grads(tp, tcfg, coords, torch.as_tensor(tgt), km,
                              fused=False)
    np.testing.assert_allclose(out_f.res.detach().numpy(),
                               out_p.res.detach().numpy(), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(out_f.survivors, out_p.survivors)
    for n in NAMES:
        for g in (g_f[n], g_p[n]):
            np.testing.assert_allclose(g.numpy(), np.asarray(getattr(g_x, n)),
                                       **GRAD_TOL, err_msg=n)


def test_forward_fused_matches_jax_fused_gradients():
    """Against jax.grad of the JAX forward_fused (Pallas, interpret)."""
    jcfg, tcfg, jp, tp, coords = _setup(2, VARIANTS["det_gammas"], seed=11)
    tgt = np.random.default_rng(3).uniform(
        0, 1, (coords.shape[0], 3)).astype(np.float32)
    kmask = np.ones(tp.capacity, bool)

    def loss_fused(p):
        out = jm.forward_fused(j_assemble_A(p, jcfg), p.musX, p.nu_e,
                               p.gamma_e, p.pis, jcfg, jnp.asarray(coords),
                               jnp.asarray(kmask), interpret=True)
        return jnp.sum(jnp.square(out.res - tgt))

    g_j = jax.grad(loss_fused)(jp)
    _, g_t = _torch_grads(tp, tcfg, coords, torch.as_tensor(tgt),
                          torch.as_tensor(kmask), fused=True)
    for n in NAMES:
        np.testing.assert_allclose(g_t[n].numpy(),
                                   np.asarray(getattr(g_j, n)), **GRAD_TOL,
                                   err_msg=n)


@pytest.mark.parametrize("k_cap", [8, 12])
def test_capped_dense_matches_uncapped(k_cap):
    """TestCappedDense.test_capped_dense_matches_uncapped: gathering the
    listed kernels (stable order) and running at the narrow width gives
    the same res, survivors, loss and gradients, bit for bit."""
    jcfg, tcfg, jp, tp, coords = _setup(2, VARIANTS["det_gammas"], seed=13)
    rng = np.random.default_rng(13)
    kmask = np.zeros(tp.capacity, bool)
    kmask[rng.choice(tp.capacity, 7, replace=False)] = True
    km = torch.as_tensor(kmask)
    tgt = torch.as_tensor(rng.uniform(0, 1, (coords.shape[0], 3)),
                          dtype=torch.float32)
    o_full, g_full = _torch_grads(tp, tcfg, coords, tgt, km, True, None)
    o_cap, g_cap = _torch_grads(tp, tcfg, coords, tgt, km, True, k_cap)
    assert torch.equal(o_cap.res, o_full.res)
    assert torch.equal(o_cap.survivors, o_full.survivors)
    for n in NAMES:
        assert torch.equal(g_cap[n], g_full[n]), n


def test_capped_gather_is_stable():
    """The gather takes active kernels first in index order, as
    jnp.argsort(~mask) does (stable)."""
    mask = torch.tensor([False, True, True, False, True, False, True])
    order = torch.argsort((~mask).to(torch.int32), stable=True)
    j_order = np.asarray(jnp.argsort(jnp.logical_not(jnp.asarray(
        mask.numpy()))))
    assert order.tolist() == j_order.tolist() == [1, 2, 4, 6, 0, 3, 5]


def test_sv_add_matches_jax():
    jcfg, tcfg, jp, tp, coords = _setup(2, VARIANTS["det_gammas"], seed=2)
    sv = np.random.default_rng(2).normal(
        0, 0.05, coords.shape[0]).astype(np.float32)
    kmask = np.ones(tp.capacity, bool)
    out_j = jm.forward_fused(j_assemble_A(jp, jcfg), jp.musX, jp.nu_e,
                             jp.gamma_e, jp.pis, jcfg, jnp.asarray(coords),
                             jnp.asarray(kmask), interpret=True,
                             sv_add=jnp.asarray(sv))
    out_t = tm.forward_fused(assemble_A(tp, tcfg), tp.musX, tp.nu_e,
                             tp.gamma_e, tp.pis, tcfg,
                             torch.as_tensor(coords),
                             torch.as_tensor(kmask),
                             sv_add=torch.as_tensor(sv))
    np.testing.assert_allclose(out_t.res.numpy(), np.asarray(out_j.res),
                               rtol=1e-5, atol=1e-6)


def test_resolve_fused():
    assert tm.resolve_fused("auto", "cuda")
    assert not tm.resolve_fused("auto", "cpu")
    assert tm.resolve_fused("on", "cpu") and tm.resolve_fused("on", "cuda")
    assert not tm.resolve_fused("off", "cuda")
    with pytest.raises(ValueError, match="packed"):
        tm.resolve_fused("packed", "cpu")

