"""PyTorch port: the fused op's backward (kernels/gate_expert.py) against
torch autograd of its own plain forward and against jax.grad of the JAX
package's Pallas op in interpret mode (smoe_tpu/kernels/gate_expert.py
:236-452), mirroring tests/test_pallas.py.

On the CPU `gate_expert_bwd` takes its plain version; the CUDA kernel K2
is held against that version on the card by chip_smoke.py.  Tolerances:
rtol 1e-5 / atol 1e-6 on the op-level gradients (fp32, reductions in
different orders), rtol 2e-4 / atol 2e-5 on the model-level gradients,
which pass through the steering assembly as well (tests/test_pallas.py
uses the same)."""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from smoe_tpu.kernels import gate_expert as jge  # noqa: E402
from smoe_tpu_torch.kernels import gate_expert as tge  # noqa: E402

from test_torch_gate_expert import _case  # noqa: E402

OP_TOL = dict(rtol=1e-5, atol=1e-6)
THR, FLOOR = 0.5 / 2 ** 8, 1e-11


def _random_op(n, f, k, e, c, seed, q_scale=1.0, pi_lo=0.1):
    """tests/test_pallas.py's random op inputs: indefinite q, so about half
    the maha entries clamp at 0."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return [f32(rng.normal(0, 1, (n, f))), f32(rng.normal(0, 1, (n, e))),
            f32(rng.normal(0, q_scale, (k, f))),
            f32(rng.normal(0, 1, (k, e * c))),
            f32(rng.uniform(pi_lo, 0.5, (k,))), np.ones(k, np.float32),
            f32(rng.normal(0, 1, (n, c)))]


def _grads_torch(args, forward, thr=THR):
    phi, xe, q, G, pi_det, mask, wts = map(torch.as_tensor, args)
    q, G, pi_det = (t.clone().requires_grad_() for t in (q, G, pi_det))
    res, _ = forward(phi, xe, q, G, pi_det, mask, thr, FLOOR)
    (res * wts).sum().backward()
    return [t.grad.numpy() for t in (q, G, pi_det)]


def _grads_pallas(args, thr=THR):
    phi, xe, q, G, pi_det, mask, wts = map(jnp.asarray, args)

    def loss(q, G, pi_det):
        res, _ = jge.fused_gate_expert(phi, xe, q, G, pi_det, mask, thr,
                                       FLOOR, phi.shape[0], True)
        return jnp.sum(res * wts)
    return [np.asarray(g) for g in jax.grad(loss, (0, 1, 2))(q, G, pi_det)]


CASES = {
    # test_fused_clamp_gradients_match_reference: indefinite q
    "clamp_d2": lambda: (_random_op(64, 7, 9, 3, 2, 13), 1e-3),
    # d = 4, F = 21, affine experts
    "d4_f21": lambda: (_random_op(80, 21, 11, 5, 3, 21, q_scale=0.3), 1e-3),
    # model-shaped inputs with dead (pi_det 0) and masked kernels
    "dead_masked_d2": lambda: (_case(2, 3, n=120, k=37, seed=4)
                               + [np.random.default_rng(5).normal(
                                   0, 1, (120, 3)).astype(np.float32)], THR),
    "dead_masked_d4": lambda: (_case(4, 5, n=90, k=23, seed=6)
                               + [np.random.default_rng(7).normal(
                                   0, 1, (90, 3)).astype(np.float32)], THR),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_op_gradients_match_pallas_interpret(case):
    args, thr = CASES[case]()
    maha = args[0].astype(np.float64) @ args[2].T.astype(np.float64)
    assert (maha < 0).any() and (maha > 0).any() or case.startswith("dead")
    g_t = _grads_torch(args, tge.GateExpert.apply, thr)
    g_j = _grads_pallas(args, thr)
    for name, a, b in zip(("q", "G", "pi_det"), g_t, g_j):
        np.testing.assert_allclose(a, b, **OP_TOL, err_msg=name)
    if case.startswith("dead"):
        # dead and masked kernels: zero G gradient, and zero q gradient
        # once the mask chain factor is applied
        mask, pi_det = args[5], args[4]
        dead = (mask == 0) | (pi_det == 0)
        assert not g_t[1][dead].any()
        assert not g_t[0][mask == 0].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_reference_matches_autograd_of_forward(case):
    """gate_expert_bwd_reference (dq' wrt the prescaled q', chain factor
    applied here) equals torch autograd of gate_expert_reference."""
    args, thr = CASES[case]()
    g_auto = _grads_torch(args, tge.gate_expert_reference, thr)
    phi, xe, q, G, pi_det, mask, wts = map(torch.as_tensor, args)
    scale = (-0.5 * mask)[:, None]
    dq_s, dG, dpi = tge.gate_expert_bwd(phi, xe, q * scale, G, pi_det, wts,
                                        thr, FLOOR)
    for name, a, b in zip(("q", "G", "pi_det"),
                          ((dq_s * scale).numpy(), dG.numpy(), dpi.numpy()),
                          g_auto):
        np.testing.assert_allclose(a, b, **OP_TOL, err_msg=name)


def test_cpu_backward_takes_plain_path_without_a_build(monkeypatch):
    def no_build(name):
        raise AssertionError("the CPU path must not build a kernel")
    monkeypatch.setattr(tge.build, "build", no_build)
    monkeypatch.setattr(tge.build, "load", no_build)
    before = (tge.gate_expert_fwd.launches, tge.gate_expert_bwd.launches)
    args, _ = CASES["clamp_d2"]()
    _grads_torch(args, tge.GateExpert.apply)
    assert (tge.gate_expert_fwd.launches,
            tge.gate_expert_bwd.launches) == before


def test_backward_other_devices_raise():
    args = [torch.empty(v.shape, device="meta")
            for v in CASES["clamp_d2"]()[0]]
    phi, xe, q, G, pi_det, _, g = args
    with pytest.raises(ValueError, match="no kernel"):
        tge.gate_expert_bwd(phi, xe, q, G, pi_det, g, THR, FLOOR)


def test_surv_carries_no_gradient():
    args, _ = CASES["clamp_d2"]()
    phi, xe, q, G, pi_det, mask, _ = map(torch.as_tensor, args)
    q = q.clone().requires_grad_()
    res, surv = tge.GateExpert.apply(phi, xe, q, G, pi_det, mask, THR,
                                     FLOOR)
    assert res.requires_grad and not surv.requires_grad


def test_bwd_kernel_source_is_exact_and_deterministic():
    """K2 keeps the numerics the maha needs and sums without atomics."""
    from smoe_tpu_torch.kernels import build
    src = pathlib.Path(build.SRC_DIR, "gate_expert_bwd.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert "__expf" not in code and "__fdividef" not in code
    assert "atomicAdd" not in code
    assert "smoe_gate_expert_bwd(" in code
    assert "smoe_tpu/kernels/gate_expert.py::_bwd_kernel" in src
