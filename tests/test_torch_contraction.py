"""PyTorch port: the forward ablation variants K3
(kernels/gate_expert_variants.py) and the attribution tool
(diag/contraction.py) against the JAX script scripts/bench_contraction.py,
whose Pallas kernel runs here in interpret mode (SMOE_BENCH_INTERPRET=1).

On the CPU the port's wrapper takes its plain torch version; the CUDA
kernel is held against that version on the card by chip_smoke.py.
Tolerance: 1e-5 of max |JAX| (fp32; exp and the gating sum round
differently in the two frameworks; JAX's f32 dot on the CPU is exact fp32,
as the port's maha)."""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from smoe_tpu_torch.diag import contraction  # noqa: E402
from smoe_tpu_torch.kernels import gate_expert as tge  # noqa: E402
from smoe_tpu_torch.kernels import gate_expert_variants as tgv  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 1e-5


@pytest.fixture
def bench(monkeypatch):
    """scripts/bench_contraction.py loaded by path, its Pallas kernel in
    interpret mode."""
    monkeypatch.setenv("SMOE_BENCH_INTERPRET", "1")
    spec = importlib.util.spec_from_file_location(
        "bench_contraction", os.path.join(ROOT, "scripts",
                                          "bench_contraction.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(d, n, k, seed=0):
    """phi (N, F) of random coordinates in [0,1]^d; q, G, pi_det drawn as
    the JAX script draws them (E = d + 1, C = 3)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, d)).astype(np.float32)
    phi = np.concatenate([np.einsum("ni,nj->nij", x, x).reshape(n, -1), x,
                          np.ones((n, 1), np.float32)], 1)
    q = rng.normal(0, 3, (k, d * d + d + 1)).astype(np.float32)
    G = rng.normal(0, .1, (k, (d + 1) * 3)).astype(np.float32)
    pi_det = np.full((k,), 1.0 / k, np.float32)
    return phi, q, G, pi_det


@pytest.mark.parametrize("d,n,k", [(2, 2048, 200), (4, 300, 40)])
@pytest.mark.parametrize("mode", tgv.VARIANTS)
def test_variant_matches_jax_interpret(bench, mode, d, n, k):
    phi, q, G, pi_det = _inputs(d, n, k)
    ref = np.asarray(bench.variant_call(jnp.asarray(phi), jnp.asarray(q),
                                        jnp.asarray(G), jnp.asarray(pi_det),
                                        mode))
    got = tgv.gate_expert_variant(*map(torch.as_tensor,
                                       (phi, q, G, pi_det)), mode)
    assert got.shape == (n, 3) and got.dtype == torch.float32
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(got.numpy() - ref).max()
    assert err <= REL_TOL * scale, (mode, err, scale)


@pytest.mark.parametrize("d", [2, 4])
def test_full_is_the_production_forward(d):
    """`full` is K1's chain with xe = 1 and mask = 1 (its tail sums the
    w @ G column groups)."""
    phi, q, G, pi_det = map(torch.as_tensor, _inputs(d, 1024, 64))
    full = tgv.gate_expert_variant(phi, q, G, pi_det, "full")
    ones_e = torch.ones((phi.shape[0], d + 1))
    res, _ = tge.gate_expert_reference(phi, ones_e, q, G, pi_det,
                                       torch.ones(q.shape[0]), 1e-4, 1e-11)
    assert float((full - res).abs().max()) <= 1e-7


def test_make_inputs_reproduces_the_jax_script(bench, monkeypatch):
    """Run the JAX script's main with its timer and kernels stubbed, and
    capture the arrays it builds."""
    seen = {}

    def fake_fused(phi, xe, q, G, pi, mask, *rest):
        seen.update(phi=phi, xe=xe, q=q, G=G, pi_det=pi, mask=mask)
        return (jnp.zeros((phi.shape[0], 3)),)

    def fake_variant(phi, q, G, pi, mode):
        seen.setdefault("variant_q", []).append(np.asarray(q))
        return jnp.zeros((phi.shape[0], 3))

    def fake_time(fn, iters=50, reps=5):
        fn(jnp.float32(0.0))
        return 1.0

    monkeypatch.setattr(bench, "fused_gate_expert", fake_fused)
    monkeypatch.setattr(bench, "variant_call", fake_variant)
    monkeypatch.setattr(bench, "time_fn", fake_time)
    monkeypatch.setattr("sys.argv", ["bench_contraction.py", "--n", "4096",
                                     "--k", "24"])
    bench.main()
    mine = dict(zip(("phi", "xe", "q", "G", "pi_det", "mask"),
                    contraction.make_inputs(4096, 24)))
    for name, arr in mine.items():
        assert arr.dtype == np.float32
        np.testing.assert_array_equal(arr, np.asarray(seen[name]),
                                      err_msg=name)
    assert len(seen["variant_q"]) == len(tgv.VARIANTS)
    for q in seen["variant_q"]:
        np.testing.assert_array_equal(mine["q"], q)


def test_unknown_mode_and_other_devices_raise():
    phi, q, G, pi_det = map(torch.as_tensor, _inputs(2, 64, 8))
    for fn in (tgv.gate_expert_variant, tgv.gate_expert_variant_reference):
        with pytest.raises(ValueError, match="unknown mode"):
            fn(phi, q, G, pi_det, "no_matmul")
    meta = [torch.empty(t.shape, device="meta") for t in (phi, q, G, pi_det)]
    with pytest.raises(ValueError, match="no kernel"):
        tgv.gate_expert_variant(*meta, "full")


def test_cpu_tensor_takes_plain_path_without_a_build(monkeypatch):
    def no_build(name):
        raise AssertionError("the CPU path must not build a kernel")
    monkeypatch.setattr(tgv.build, "build", no_build)
    monkeypatch.setattr(tgv.build, "load", no_build)
    before = tgv.gate_expert_variant.launches
    args = list(map(torch.as_tensor, _inputs(2, 256, 16)))
    for mode in tgv.VARIANTS:
        assert torch.equal(tgv.gate_expert_variant(*args, mode),
                           tgv.gate_expert_variant_reference(*args, mode))
    assert tgv.gate_expert_variant.launches == before


def test_tool_refuses_without_cuda(capsys, monkeypatch):
    """The attribution times the card: without CUDA the CLI exits non-zero
    with a message and `run` raises; nothing carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert contraction.main(["--n", "1024", "--k", "8"]) != 0
    assert "cuda" in capsys.readouterr().err.lower()
    with pytest.raises(RuntimeError, match="CUDA"):
        contraction.run(1024, 8)


def test_kernel_source_is_exact_fp32():
    from smoe_tpu_torch.kernels import build
    src = open(os.path.join(build.SRC_DIR, "gate_expert_variants.cu")).read()
    assert "__expf" not in src and "__fdividef" not in src
    assert '#include "gate_expert_common.cuh"' in src
    assert "smoe_gate_expert_variant(" in src
    assert "scripts/bench_contraction.py::_variant_kernel" in src
