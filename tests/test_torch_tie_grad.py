"""PyTorch port: gradients at exact ties of the clamps match jax.grad.

jnp.maximum / jnp.clip give half the gradient to each side of an exact
tie; torch.clamp gives all of it to the input.  The port's clamps (maha
>= 0, the gating denominator floor, the clip of res to [0, 1], in
core/model.py and kernels/gate_expert.py) are torch.maximum /
torch.minimum against constants, which split a tie as JAX does.  The ties
are built exactly: coordinates, centers and steering on dyadic grids, the
live weight equal to the float32 floor.  Tolerance rtol 1e-5 / atol 1e-6
(fp32 reductions in two frameworks); a tie taken as torch.clamp takes it
misses by far more."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from smoe_tpu.config import SmoeConfig as JConfig  # noqa: E402
from smoe_tpu.core import model as jm  # noqa: E402
from smoe_tpu.core.params import SmoeParams as JParams  # noqa: E402
from smoe_tpu.core.params import assemble_A as j_assemble_A  # noqa: E402
from smoe_tpu.kernels import gate_expert as jge  # noqa: E402
from smoe_tpu_torch.config import SmoeConfig  # noqa: E402
from smoe_tpu_torch.core import model as tm  # noqa: E402
from smoe_tpu_torch.core.params import (assemble_A,  # noqa: E402
                                        params_from_numpy)
from smoe_tpu_torch.kernels import gate_expert as tge  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
THR, FLOOR = 0.5 / 2 ** 8, 1e-11


def test_torch_clamp_is_the_fault():
    """The fault this file guards: at x = [-1, 0, .5, 1, 2],
    jax.grad(clip(x, 0, 1)) is [0, .5, 1, .5, 0]; torch.clamp gives 1 at
    both ties, the port's clip_unit gives JAX's values."""
    x = np.array([-1.0, 0.0, 0.5, 1.0, 2.0], np.float32)
    g_jax = np.asarray(jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 1.0)))(
        jnp.asarray(x)))
    np.testing.assert_array_equal(g_jax, [0, 0.5, 1, 0.5, 0])
    grads = {}
    for name, fn in (("clamp", lambda v: torch.clamp(v, 0.0, 1.0)),
                     ("port", tm.clip_unit)):
        v = torch.tensor(x, requires_grad=True)
        fn(v).sum().backward()
        grads[name] = v.grad.numpy()
    np.testing.assert_array_equal(grads["clamp"], [0, 1, 1, 1, 0])
    np.testing.assert_array_equal(grads["port"], g_jax)


def _op_case():
    """Fused-op inputs with exact ties: integer phi and indefinite q on a
    1/4 grid, so phi . q is exact and hits 0 on many pairs; one pixel whose
    only live weight equals the float32 floor."""
    rng = np.random.default_rng(3)
    n, f, k, e, c = 48, 7, 6, 3, 3
    phi = rng.integers(-2, 3, (n, f)).astype(np.float32)
    q = (rng.integers(-2, 3, (k, f)) / 4).astype(np.float32)
    phi[0] = 0.0                  # pixel 0: every maha 0 ...
    pi_det = rng.uniform(0.2, 0.6, k).astype(np.float32)
    mask = np.ones(k, np.float32)
    xe = rng.normal(0, 1, (n, e)).astype(np.float32)
    G = rng.normal(0, 0.5, (k, e * c)).astype(np.float32)
    wts = rng.normal(0, 1, (n, c)).astype(np.float32)
    return phi, xe, q, G, pi_det, mask, wts


def _op_grads_torch(args, forward):
    phi, xe, q, G, pi_det, mask, wts = map(torch.as_tensor, args)
    q, G, pi_det = (t.clone().requires_grad_() for t in (q, G, pi_det))
    res, _ = forward(phi, xe, q, G, pi_det, mask, THR, FLOOR)
    (res * wts).sum().backward()
    return [t.grad.numpy() for t in (q, G, pi_det)]


def _op_grads_jax(args, fused):
    """jax.grad of the JAX reference op, or of the Pallas op (interpret
    mode), whose backward takes the floor as straight-through: at a floor
    tie the two differ, and the port's ops follow their counterparts."""
    phi, xe, q, G, pi_det, mask, wts = map(jnp.asarray, args)

    def loss(q, G, pi_det):
        if fused:
            res, _ = jge.fused_gate_expert(phi, xe, q, G, pi_det, mask, THR,
                                           FLOOR, phi.shape[0], True)
        else:
            res, _ = jge.gate_expert_reference(phi, xe, q, G, pi_det, mask,
                                               THR, FLOOR)
        return jnp.sum(res * wts)
    return [np.asarray(g) for g in jax.grad(loss, (0, 1, 2))(q, G, pi_det)]


@pytest.mark.parametrize("tie", ["maha", "floor"])
def test_fused_op_tie_gradients_match_jax(tie):
    phi, xe, q, G, pi_det, mask, wts = _op_case()
    if tie == "floor":
        # pixel 0 sees only kernel 0, at maha 0 with pi_det == floor:
        # the denominator max(floor, sum) is an exact tie
        pi_det[0] = np.float32(FLOOR)
        mask[1:] = 0.0
        pi_det[1:] = 0.0
    args = (phi, xe, q, G, pi_det, mask, wts)
    maha = phi.astype(np.float64) @ q.T.astype(np.float64)
    assert (maha == 0).sum() >= 10 and (maha > 0).any() and (maha < 0).any()
    g_jax = _op_grads_jax(args, fused=False)
    for fused, forward in ((False, tge.gate_expert_reference),
                           (True, tge.GateExpert.apply)):
        for a, b in zip(_op_grads_torch(args, forward),
                        _op_grads_jax(args, fused)):
            np.testing.assert_allclose(a, b, **TOL)

    # the same gradients with torch.clamp at the ties miss JAX's
    def clamped(phi, xe, q, G, pi_det, mask, thr, floor):
        maha = torch.clamp(phi @ q.T, min=0.0)
        n_w = torch.exp(-0.5 * (maha * mask[None, :])) * pi_det[None, :]
        w = n_w / torch.clamp(n_w.sum(1, keepdim=True), min=floor)
        w = torch.where(w > thr, w, torch.zeros_like(w))
        wg = w @ G
        res = sum(xe[:, j:j + 1] * wg[:, 3 * j:3 * j + 3] for j in range(3))
        return res, None
    off = [not np.allclose(a, b, **TOL)
           for a, b in zip(_op_grads_torch(args, clamped), g_jax)]
    assert any(off)


def _model_case():
    """One live kernel, no determinant, centered at (1/2, 1/2) on a
    dyadic pixel grid: at the center pixel maha is exactly 0, the weight
    pis * 1 equals the float32 floor (a tie of the gating denominator),
    w = 1 and res = nu = 1 (a tie of the clip to [0, 1])."""
    kw = dict(dim_domain=2, num_channels=1, kernels_per_dim=(1, 1),
              use_determinant=False, use_yuv=False)
    p = {"musX": np.full((1, 2), 0.5, np.float32),
         "a_diag": np.diag([4.0, 4.0]).astype(np.float32)[None],
         "a_corr": np.zeros((1, 2, 2), np.float32),
         "pis": np.full((1,), FLOOR, np.float32),
         "nu_e": np.ones((1, 1), np.float32),
         "gamma_e": np.zeros((1, 2, 1), np.float32)}
    g = np.arange(1, 8) / 8.0
    coords = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    wts = np.random.default_rng(1).normal(0, 1, (coords.shape[0], 1))
    return kw, p, coords.astype(np.float32), wts.astype(np.float32)


@pytest.mark.parametrize("path", ["plain", "fused"])
def test_model_tie_gradients_match_jax(path, monkeypatch):
    kw, p, coords, wts = _model_case()
    jcfg, tcfg = JConfig(**kw), SmoeConfig(**kw)
    names = ("musX", "a_diag", "a_corr", "pis", "nu_e", "gamma_e")

    def j_loss(jp):
        if path == "plain":
            out = jm.smoe_forward(jp, jcfg, jnp.asarray(coords))
        else:
            A = j_assemble_A(jp, jcfg)
            out = jm.forward_fused(A, jp.musX, jp.nu_e, jp.gamma_e, jp.pis,
                                   jcfg, jnp.asarray(coords),
                                   jnp.ones((1,), bool), interpret=True)
        return jnp.sum(out.res * wts)

    jp = JParams(**{n: jnp.asarray(p[n]) for n in names})
    g_jax = jax.grad(j_loss)(jp)

    def t_grads():
        tp = params_from_numpy(p)
        for n in names:
            getattr(tp, n).requires_grad_()
        if path == "plain":
            out = tm.smoe_forward(tp, tcfg, torch.as_tensor(coords))
        else:
            out = tm.forward_fused(assemble_A(tp, tcfg), tp.musX, tp.nu_e,
                                   tp.gamma_e, tp.pis, tcfg,
                                   torch.as_tensor(coords),
                                   torch.ones((1,), dtype=torch.bool))
        (out.res * torch.as_tensor(wts)).sum().backward()
        return {n: getattr(tp, n).grad for n in names}

    g_t = t_grads()
    assert float(g_t["pis"][0]) != 0.0 and float(g_t["nu_e"][0, 0]) != 0.0
    for n in ("musX", "pis", "nu_e", "gamma_e"):
        np.testing.assert_allclose(g_t[n].numpy(),
                                   np.asarray(getattr(g_jax, n)), **TOL,
                                   err_msg=n)
    np.testing.assert_allclose(
        torch.diagonal(g_t["a_diag"], dim1=1, dim2=2).numpy(),
        np.diagonal(np.asarray(g_jax.a_diag), axis1=1, axis2=2), **TOL)

    # the clip taken as torch.clamp: nu's gradient at res == 1 doubles
    monkeypatch.setattr(tm, "clip_unit",
                        lambda x: torch.clamp(x, 0.0, 1.0))
    g_c = t_grads()
    assert not np.allclose(g_c["nu_e"].numpy(), np.asarray(g_jax.nu_e),
                           **TOL)
