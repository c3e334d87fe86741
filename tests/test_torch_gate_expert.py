"""PyTorch port: the fused gate+expert op (kernels/gate_expert.py) against
the JAX package's Pallas kernel K1 (interpret mode) and its plain
reference (smoe_tpu/kernels/gate_expert.py:459-471).

On the CPU the port's wrapper takes its plain torch version; the CUDA
kernel itself is held against that version on the card by chip_smoke.py.
Tolerances: res atol 1e-6 / rtol 1e-5, surv atol 1e-7 / rtol 1e-5
(fp32; exp and the gating sum round differently in the two frameworks)."""

import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from smoe_tpu.kernels import gate_expert as jge  # noqa: E402
from smoe_tpu_torch.kernels import gate_expert as tge  # noqa: E402

THR, FLOOR = 0.5 / 2 ** 8, 1e-11


def _case(d, e, n=300, k=37, c=3, seed=0):
    """Model-shaped inputs: steered Gaussians with centers in [0,1]^d,
    dead pis and a partial mask (as tests/test_pallas.py's
    test_fused_respects_kernel_mask_and_dead_pis).

    Coordinates and centers sit on a 1/64 raster and the steering factors
    on a 1/4 grid, small enough that every product and partial sum of the
    maha contraction is exact in fp32: the quadratic-feature maha cancels
    large terms, and this keeps its value independent of each framework's
    summation order, so what is compared is the op, not the matmul."""
    rng = np.random.default_rng(seed)
    idx = np.arange(d)
    hi = 4.0 if d == 2 else 2.0
    A = np.zeros((k, d, d))
    A[:, idx, idx] = rng.integers(4, int(4 * hi) + 1, (k, d)) / 4
    A += np.tril(rng.integers(-2, 3, (k, d, d)), -1) / 4
    B = A @ np.transpose(A, (0, 2, 1))
    mus = rng.integers(0, 65, (k, d)) / 64
    Bmu = np.einsum("kij,kj->ki", B, mus)
    q = np.concatenate([B.reshape(k, -1), -2 * Bmu,
                        np.einsum("ki,ki->k", Bmu, mus)[:, None]], 1)
    x = rng.integers(0, 65, (n, d)) / 64
    phi = np.concatenate([np.einsum("ni,nj->nij", x, x).reshape(n, -1), x,
                          np.ones((n, 1))], 1)
    # exactness premise: all terms are multiples of 2^-16 and every
    # partial sum stays below 2^(24-16) = 256 in magnitude
    assert (np.abs(phi) @ np.abs(q).T).max() < 256
    xe = np.concatenate([x, np.ones((n, 1))], 1) if e == d + 1 \
        else np.ones((n, 1))
    pis = rng.uniform(0.5, 1.5, k) / k
    pis[[1, 7, 20]] = 0.0
    mask = np.ones(k)
    mask[::4] = 0.0
    pi_det = pis * np.prod(A[:, idx, idx], -1) / math.sqrt(
        (2 * math.pi) ** d) * mask
    G = rng.normal(0, 0.3, (k, e * c))
    G[:, -c:] += 0.5
    return [np.asarray(v, np.float32)
            for v in (phi, xe, q, G, pi_det, mask)]


CASES = [(2, 1), (2, 3), (4, 1), (4, 5)]


@pytest.mark.parametrize("d,e", CASES)
def test_plain_matches_pallas_interpret(d, e):
    args = _case(d, e, seed=d + e)
    res_j, surv_j = jge.fused_gate_expert(
        *map(jnp.asarray, args), THR, FLOOR, args[0].shape[0], True)
    res_t, surv_t = tge.gate_expert_fwd(*map(torch.as_tensor, args), THR,
                                        FLOOR)
    np.testing.assert_allclose(res_t.numpy(), np.asarray(res_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(surv_t.numpy(), np.asarray(surv_j),
                               rtol=1e-5, atol=1e-7)
    live = args[5] * (args[4] > 0)
    assert not surv_t.numpy()[live == 0].any()
    assert (surv_t.numpy() > 0).sum() > 0
    # the inputs reach the influence cull: some live weights fall below it
    phi, _, q, _, pi_det, mask = (a.astype(np.float64) for a in args)
    n_w = np.exp(-0.5 * np.maximum(phi @ q.T, 0) * mask) * pi_det
    w = n_w / n_w.sum(1, keepdims=True)
    assert ((w > 0) & (w <= THR)).any()


@pytest.mark.parametrize("d,e", CASES)
def test_plain_matches_jax_reference(d, e):
    args = _case(d, e, seed=10 + d + e)
    res_j, surv_j = jge.gate_expert_reference(*map(jnp.asarray, args), THR,
                                              FLOOR)
    res_t, surv_t = tge.gate_expert_reference(*map(torch.as_tensor, args),
                                              THR, FLOOR)
    np.testing.assert_allclose(res_t.numpy(), np.asarray(res_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(surv_t.numpy(), np.asarray(surv_j),
                               rtol=1e-5, atol=1e-7)


def test_cpu_tensor_takes_plain_path_without_a_build(monkeypatch):
    """A CPU tensor never builds or launches the kernel."""
    def no_build(name):
        raise AssertionError("the CPU path must not build a kernel")
    monkeypatch.setattr(tge.build, "build", no_build)
    monkeypatch.setattr(tge.build, "load", no_build)
    before = tge.gate_expert_fwd.launches
    args = list(map(torch.as_tensor, _case(2, 3)))
    res, surv = tge.gate_expert_fwd(*args, THR, FLOOR)
    ref = tge.gate_expert_reference(*args, THR, FLOOR)
    assert torch.equal(res, ref[0]) and torch.equal(surv, ref[1])
    assert tge.gate_expert_fwd.launches == before


def test_other_devices_raise():
    args = [torch.empty(v.shape, device="meta") for v in _case(2, 3)]
    with pytest.raises(ValueError, match="no kernel"):
        tge.gate_expert_fwd(*args, THR, FLOOR)


def test_import_needs_no_nvcc_or_triton():
    code = ("import sys; import smoe_tpu_torch.kernels.gate_expert as g; "
            "import smoe_tpu_torch.kernels.build as b; "
            "assert 'triton' not in sys.modules; "
            "assert g.gate_expert_fwd.launches == 0; "
            "assert b.load.cache_info().currsize == 0")
    env = {"PATH": "/usr/bin:/bin", "CUDA_HOME": "/nonexistent"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(pathlib.Path(__file__).parents[1]))


def test_kernel_source_is_exact_fp32():
    """The CUDA source and its build keep the numerics the maha needs."""
    from smoe_tpu_torch.kernels import build
    src = open(build.SRC_DIR + "/gate_expert_fwd.cu").read()
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "__expf" not in src and "__fdividef" not in src
    assert "_library" in dir(tge) and "smoe_gate_expert_fwd(" in src
