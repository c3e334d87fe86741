"""PyTorch port: the forward ablation variants K3
(kernels/gate_expert_variants.py) and the attribution tool
(diag/contraction.py) against the JAX script scripts/bench_contraction.py,
whose Pallas kernel runs here in interpret mode (SMOE_BENCH_INTERPRET=1).

On the CPU the port's wrapper takes its plain torch version; the CUDA
kernel is held against that version on the card by chip_smoke.py, and its
sources (one forward body for K1 and K3) are held here to their instance
lists.  Tolerance: 1e-5 of max |JAX| (fp32; exp and the gating sum round
differently in the two frameworks; JAX's f32 dot on the CPU is exact fp32,
as the port's maha)."""

import importlib.util
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_cpu import threads as torch_threads  # noqa: E402

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


def _features(x):
    n = x.shape[0]
    return np.concatenate([np.einsum("ni,nj->nij", x, x).reshape(n, -1), x,
                           np.ones((n, 1), np.float32)], 1)


def _inputs(layout, n, k, seed=0):
    """phi (N, F) of random coordinates in [0,1]^d; q, G, pi_det drawn as
    the JAX script draws them (E = d + 1, C = 3).  layout "dual-e4" /
    "dual-e1": the dual-model video features (F = 26, two 13-wide d = 3
    halves from two coordinate sets), each q row nonzero in one half only,
    E = 4 or 1."""
    rng = np.random.default_rng(seed)
    if isinstance(layout, int):
        d = layout
        phi = _features(rng.uniform(0, 1, (n, d)).astype(np.float32))
        q = rng.normal(0, 3, (k, d * d + d + 1)).astype(np.float32)
        e = d + 1
    else:
        phi = np.concatenate([_features(rng.uniform(
            0, 1, (n, 3)).astype(np.float32)) for _ in range(2)], 1)
        half = rng.normal(0, 3, (k, 13)).astype(np.float32)
        first = rng.uniform(size=k) < 0.5
        q = np.zeros((k, 26), np.float32)
        q[first, :13] = half[first]
        q[~first, 13:] = half[~first]
        e = int(layout[-1])
    G = rng.normal(0, .1, (k, e * 3)).astype(np.float32)
    pi_det = np.full((k,), 1.0 / k, np.float32)
    return phi, q, G, pi_det


def _near_tie_rows(phi, q, pi_det, mode):
    """Rows holding a pair whose pre-cull weight lies within 1e-5
    relative of the cull threshold (full and exp2; none for the modes
    without a cull)."""
    if mode not in ("full", "exp2"):
        return np.zeros(phi.shape[0], bool)
    w = tgv.variant_weights(*map(torch.as_tensor, (phi, q, pi_det)), mode,
                            cull=False).numpy()
    return (np.abs(w - 1e-4) <= 1e-5 * 1e-4).any(1)


def _tie_alternatives(phi, q, G, pi_det, mode, row):
    """The port's result on `row` for every choice of keeping or culling
    its near-tie pairs (the other pairs culled as the port culls them)."""
    w = tgv.variant_weights(*map(torch.as_tensor, (phi[row:row + 1], q,
                                                   pi_det)), mode,
                            cull=False).numpy()[0]
    keep = w > 1e-4
    ties = np.nonzero(np.abs(w - 1e-4) <= 1e-5 * 1e-4)[0]
    for choice in range(2 ** len(ties)):
        k = keep.copy()
        k[ties] = [(choice >> i) & 1 == 1 for i in range(len(ties))]
        wg = torch.as_tensor(np.where(k, w, 0).astype(np.float32))[None] \
            @ torch.as_tensor(G)
        yield sum(wg[:, j * 3:(j + 1) * 3]
                  for j in range(G.shape[1] // 3)).numpy()[0]


@pytest.mark.parametrize("layout,n,k", [(2, 2048, 200), (4, 300, 40),
                                        ("dual-e4", 1024, 64),
                                        ("dual-e1", 1024, 64)])
@pytest.mark.parametrize("mode", tgv.VARIANTS)
def test_variant_matches_jax_interpret(bench, mode, layout, n, k):
    phi, q, G, pi_det = _inputs(layout, n, k)
    ref = np.asarray(bench.variant_call(jnp.asarray(phi), jnp.asarray(q),
                                        jnp.asarray(G), jnp.asarray(pi_det),
                                        mode))
    got = tgv.gate_expert_variant(*map(torch.as_tensor,
                                       (phi, q, G, pi_det)), mode)
    assert got.shape == (n, 3) and got.dtype == torch.float32
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(got.numpy() - ref).max(1)
    near = _near_tie_rows(phi, q, pi_det, mode)
    assert err[~near].max() <= REL_TOL * scale, (mode, err.max(), scale)
    for row in np.nonzero(near)[0]:
        # a pair within 1e-5 relative of the cull threshold: the port's row
        # with that pair kept or culled, whichever JAX's bits chose
        errs = [np.abs(alt - ref[row]).max()
                for alt in _tie_alternatives(phi, q, G, pi_det, mode, row)]
        assert min(errs) <= REL_TOL * scale, (mode, row, errs, scale)


@pytest.mark.parametrize("threads", [1, 2, 4, 8])
def test_near_tie_case_under_thread_counts(bench, threads):
    """The `full-2-2048-200` case of test_variant_matches_jax_interpret
    holds a pair 3.2e-6 relative above the cull threshold (row 1078,
    kernel 114: w = 1.0000032e-4), where the two packages' weights part by
    at most 5.2e-7 relative elsewhere.  The port's maha is a fixed-order
    fp32 sum (`fixed_order_maha`): under torch's thread counts 1, 2, 4 and
    8 its weights and result are bit-identical to one thread's.  JAX's
    interpret-mode dot may fall on either side of the threshold there, so
    that row holds REL_TOL against the port's row with the pair kept or
    culled, whichever JAX chose, and every other row holds REL_TOL."""
    phi, q, G, pi_det = _inputs(2, 2048, 200)
    tensors = tuple(map(torch.as_tensor, (phi, q, G, pi_det)))
    ref = np.asarray(bench.variant_call(*map(jnp.asarray,
                                             (phi, q, G, pi_det)), "full"))
    w1 = tgv.variant_weights(tensors[0], tensors[1], tensors[3], "full",
                             cull=False).numpy()
    r1 = tgv.gate_expert_variant(*tensors, "full").numpy()
    with torch_threads(threads):
        w = tgv.variant_weights(tensors[0], tensors[1], tensors[3], "full",
                                cull=False).numpy()
        got = tgv.gate_expert_variant(*tensors, "full").numpy()
    assert np.array_equal(w, w1) and np.array_equal(got, r1)
    near = _near_tie_rows(phi, q, pi_det, "full")
    assert np.nonzero(near)[0].tolist() == [1078]
    scale = np.abs(ref).max()
    assert np.abs(got - ref)[~near].max() <= REL_TOL * scale
    errs = [np.abs(alt - ref[1078]).max()
            for alt in _tie_alternatives(phi, q, G, pi_det, "full", 1078)]
    assert len(errs) == 2 and min(errs) <= REL_TOL * scale
    # the pair's contribution is far above the tolerance: a flip shows
    assert max(errs) > REL_TOL * scale


def test_fixed_order_maha_is_the_product():
    """The plain version's maha equals phi @ q.T to fp32 rounding, and its
    bits do not depend on the rows around a row."""
    phi, q, _, _ = map(torch.as_tensor, _inputs(2, 300, 40, seed=3))
    m = tgv.fixed_order_maha(phi, q)
    np.testing.assert_allclose(m.numpy(), (phi.double() @ q.double().T)
                               .numpy(), rtol=1e-5, atol=1e-4)
    assert torch.equal(tgv.fixed_order_maha(phi[17:18], q), m[17:18])


@pytest.mark.parametrize("layout", [2, 4, "dual-e4"])
def test_full_is_the_production_forward(layout):
    """`full` is K1's chain with xe = 1 and mask = 1 (its tail sums the
    w @ G column groups)."""
    phi, q, G, pi_det = map(torch.as_tensor, _inputs(layout, 1024, 64))
    full = tgv.gate_expert_variant(phi, q, G, pi_det, "full")
    ones_e = torch.ones((phi.shape[0], G.shape[1] // 3))
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


def _csrc(name):
    from smoe_tpu_torch.kernels import build
    with open(os.path.join(build.SRC_DIR, name)) as fd:
        return fd.read()


def _code(src):
    """The source without its // comments."""
    return "\n".join(line.split("//")[0] for line in src.splitlines())


def test_kernel_source_is_exact_fp32():
    from smoe_tpu_torch.kernels import build
    src = _csrc("gate_expert_variants.cu")
    for text in (src, _csrc("gate_expert_fwd_body.cuh")):
        assert "__expf" not in text and "__fdividef" not in text
        assert "__exp2f" not in text and "fast_math" not in _code(text)
    assert not any("fast" in flag for flag in build.NVCC_FLAGS)
    assert '#include "gate_expert_common.cuh"' in src
    assert "smoe_gate_expert_variant(" in src
    assert "scripts/bench_contraction.py::_variant_kernel" in src


def test_k1_and_k3_are_instances_of_one_body():
    """Both kernel files include the forward body and call it, K1 as
    MODE_PRODUCTION; the variants file keeps no loop of its own."""
    for name in ("gate_expert_fwd.cu", "gate_expert_variants.cu"):
        code = _code(_csrc(name))
        assert '#include "gate_expert_fwd_body.cuh"' in code, name
        assert "smoe::gate_expert_fwd_body<" in code, name
    assert ("gate_expert_fwd_body<F, E, C, smoe::MODE_PRODUCTION, BF16>"
            in _code(_csrc("gate_expert_fwd.cu")))
    var = _code(_csrc("gate_expert_variants.cu"))
    for loop in ("for (", "while (", "__syncthreads", "dot_padded",
                 "expf(", "fmaf("):
        assert loop not in var, loop
    body = _code(_csrc("gate_expert_fwd_body.cuh"))
    modes = dict((m, int(v)) for m, v in re.findall(
        r"MODE_([A-Z0-9_]+) = (\d+),", body))
    # modes 0-4 are the wrapper's VARIANTS in order
    assert [modes[v.upper()] for v in tgv.VARIANTS] == list(range(5))
    assert modes["PRODUCTION"] not in range(6)


def test_k3_instances_cover_k1_c3_widths():
    """Every C = 3 instance of K1 (gate_expert_fwd.cu SMOE_WIDTHS) has a K3
    instance, the dual-model F = 26 among them, and `*_supported` takes
    F = 26 as d = 3."""
    k1 = set(re.findall(r"X\((\d+), (\d+), 3\)", _csrc("gate_expert_fwd.cu")))
    var = _csrc("gate_expert_variants.cu")
    macro = var[var.index("#define SMOE_VARIANT_WIDTHS"):]
    macro = macro[:macro.index("extern")]
    k3 = set(re.findall(r"X\((\d+), (\d+)\)", macro))
    assert len(k1) == 8 and k1 == k3
    assert ("26", "4") in k3 and ("26", "1") in k3
    assert "(f == 13 || f == 26) ? 3" in var


def test_witness_mode_is_the_bodys_dense_full():
    """chip_smoke.py reaches the witness (full without compaction) through
    the C interface by its number; the wrapper does not offer it."""
    import chip_smoke
    m = re.search(r"MODE_FULL_DENSE = (\d+),",
                  _code(_csrc("gate_expert_fwd_body.cuh")))
    assert m and int(m.group(1)) == chip_smoke.FULL_DENSE_MODE
    assert chip_smoke.FULL_DENSE_MODE >= len(tgv.VARIANTS)
    phi, q, G, pi_det = map(torch.as_tensor, _inputs(2, 64, 8))
    with pytest.raises(ValueError, match="unknown mode"):
        tgv.gate_expert_variant(phi, q, G, pi_det, "full_dense")


# (F, E, C, N, K, S) hand counts: per pair 2F maha flops + clamp, exp
# (MUFU), pi multiply, denominator add; per mixed pair the division (1 flop,
# 1 MUFU) and 2EC mixing flops; bytes 4 * (N (F + C [+ E]) + K (F + EC
# [+ pi_det] [+ K1's surv]))
_TINY = dict(n=10, k=4, f=7, e=3, c=3, survivors=6)
_HAND = {
    # P = 40: 18 * 40 + 19 * 6, 40 + 6, 4 * (10 * 13 + 4 * 18)
    "production": (834, 46, 808),
    "full": (834, 46, 4 * (10 * 10 + 4 * 17)),
    "exp2": (834, 46, 4 * (10 * 10 + 4 * 17)),
    # 18 * 40 + 19 * 40, 80
    "no_cull": (1480, 80, 4 * (10 * 10 + 4 * 17)),
    # 16 * 40 + 18 * 40, 40
    "no_norm": (1360, 40, 4 * (10 * 10 + 4 * 17)),
    # 15 * 40 + 18 * 40, 0; no pi_det
    "no_exp": (1320, 0, 4 * (10 * 10 + 4 * 16)),
}


@pytest.mark.parametrize("mode", list(_HAND))
def test_mode_bound_hand_counts(mode):
    flops, mufu, nbytes = contraction.mode_work(mode, **_TINY)
    assert (flops, mufu, nbytes) == _HAND[mode]
    b = contraction.mode_bound(mode, **_TINY)
    assert b["flops"] == flops and b["mufu_ops"] == mufu
    assert b["bytes"] == nbytes
    # a tiny shape moves more bytes than it computes
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)
    # 16 MUFU results a clock per SM against 256 fp32 flops
    assert b["mufu_ms"] == pytest.approx(mufu / (67e12 / 16) * 1e3)


def test_full_bound_is_k1_bound_without_the_mix():
    """At the flagship (P = 6.7e7 pairs, S = 767943) `full`'s bound is the
    one K1's bound gave K3 before, (2F + 4) P + (1 + 2EC) S flops over the
    fp32 peak with xe left out, and K1's bound is chip_smoke.k1_bound's."""
    import chip_smoke
    n, k, f, e, c, s = 512 * 512, 256, 7, 3, 3, 767943
    flops = n * k * (2 * f + 4) + s * (1 + 2 * e * c)
    nbytes = 4 * (n * (f + c) + k * (f + e * c + 2))
    ms = max(flops / 67e12, nbytes / 3.35e12) * 1e3
    b = contraction.mode_bound("full", n, k, f, e, c, s)
    assert b["bound_by"] == "operations" and b["bound_ms"] == ms
    assert b["flops"] == flops
    k1 = contraction.mode_bound("production", n, k, f, e, c, s)
    assert chip_smoke.k1_bound(n, k, f, e, c, s) == (k1["bound_ms"],
                                                     k1["bound_by"])
    assert k1["bound_ms"] == ms
    with pytest.raises(ValueError, match="unknown mode"):
        contraction.mode_work("no_matmul", n, k, f, e, c, s)


@pytest.mark.parametrize("stride", [1, 3])
def test_versus_plain_counts_rows(stride):
    """The attribution's check against the plain version, on CPU tensors:
    in row chunks and on a strided subset; a row off by more than the
    tolerance is counted, one that holds a pair at the cull threshold is
    counted as a flip instead."""
    phi, q, G, pi_det = map(torch.as_tensor, _inputs(2, 300, 16))
    thr, floor = contraction.THR, contraction.FLOOR
    ref = tgv.gate_expert_variant_reference(phi, q, G, pi_det, "full", thr,
                                            floor)
    m = contraction.versus_plain(phi, q, G, pi_det, "full", ref, thr, floor,
                                 rows=64, stride=stride)
    assert m["rows_checked"] == len(range(0, 300, stride))
    assert m["max_abs_err"] == 0 and m["rows_over_tol"] == 0
    assert m["tol"] == contraction.VAR_ABS_TOL
    got = ref.clone()
    got[0, 1] += 1e-3
    got[3 * stride, 0] -= 1e-3
    m = contraction.versus_plain(phi, q, G, pi_det, "full", got, thr, floor,
                                 rows=64, stride=stride)
    assert m["rows_over_tol"] == 2 and m["cull_flip_rows"] == 0
    # a threshold on one of row 0's weights: row 0 off is a flip
    w = tgv.variant_weights(phi, q, pi_det, "full", thr, floor, cull=False)
    thr0 = float(w[0, 5])
    got = tgv.gate_expert_variant_reference(phi, q, G, pi_det, "full", thr0,
                                            floor)
    got[0, 2] += 1e-3
    m = contraction.versus_plain(phi, q, G, pi_det, "full", got, thr0, floor,
                                 rows=64, stride=stride)
    assert m["cull_flip_rows"] == 1 and m["rows_over_tol"] == 0
    m = contraction.versus_plain(phi, q, G, pi_det, "no_exp", got, thr,
                                 floor, rows=64, stride=stride)
    assert m["tol"] == contraction.VAR_REL_TOL * m["max_abs_plain"]
