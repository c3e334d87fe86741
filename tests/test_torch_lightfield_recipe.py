"""PyTorch port: the card's light field and the recorded JAX fit
(chip_smoke.py's light field, tests/data/lf_cut_ref.npz) and the
real-texture light field through the fused op, against the JAX package on
the CPU, with tests/test_torch_lightfield.py's tolerances."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401

from test_torch_lightfield import RTOL, _pair  # noqa: E402


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_smoke_script_lf_is_bench_lf_s():
    """chip_smoke.build_lf is scripts/bench_lf.py's synth light field."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import chip_smoke
    from bench_lf import build_lf
    for s in (6, 12):
        np.testing.assert_array_equal(chip_smoke.build_lf(s=s),
                                      build_lf(views=15, s=s))


def test_recorded_lf_recipe_is_reproduced_on_the_cpu(monkeypatch):
    """The recipe's trainer on the cut light field (chip_smoke.lf_smoe, the
    trainer cli.fit builds for bench_lf.py's flags) against the JAX run
    recorded in tests/data/lf_cut_ref.npz: the per-kernel LS experts to
    1e-3 of max (576 solves), the eval after them 1e-5, 20 sweeps' mse
    2e-3, num_pi and lists equal; the recorded JAX .smoe decodes within
    1 LSB of the recorded decode."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from smoe_tpu_torch.codec.serve import decode_bitstream
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    ref = np.load(chip_smoke.LF_REF)
    lf = chip_smoke.build_lf(s=int(ref["s"]))
    s = chip_smoke.lf_smoe(lf, "off")
    s.ls_init_experts(mode="kernel")
    x = np.concatenate([s.params.nu_e.detach().numpy().ravel(),
                        s.params.gamma_e.detach().numpy().ravel()])
    xr = np.concatenate([ref["ls_nu"].ravel(), ref["ls_gamma"].ravel()])
    np.testing.assert_allclose(x, xr, atol=1e-3 * np.abs(xr).max())
    np.testing.assert_allclose(s.run_batched(train=False)[1],
                               float(ref["ls_mse"]), rtol=1e-5)
    _, mse, npi, _ = s.run_batched_chunk(int(ref["mse"].shape[0]))
    np.testing.assert_allclose(mse, ref["mse"], rtol=RTOL)
    np.testing.assert_array_equal(npi, ref["num_pi"])
    np.testing.assert_array_equal(s.kernel_lists.numpy(), ref["lists"])
    rec = decode_bitstream(chip_smoke.LF_SMOE, device="cpu")
    st = int(ref["stride"])
    lsb = np.abs(np.round(rec[..., ::st, ::st, :] * 255)
                 - ref["sample"].astype(np.float64))
    assert lsb.max() <= 1 and np.mean(lsb == 0) >= 0.999
    psnr = 10 * np.log10(1.0 / np.mean((rec - lf) ** 2))
    assert abs(psnr - float(ref["psnr_db"])) <= 0.01


def test_fused_op_on_hopper_lf_steps_as_jax_fused_path():
    """The real-texture light field (bench_lf.py --texture hopper, the
    recipe's -k 4 4 6 6 and lf_corner_weight 0.1 at s = 8: F = 21, C = 1)
    through the fused op in both packages: JAX's Pallas kernel in
    interpret mode (use_pallas="on"), the port's fused op on its plain
    versions.  Six sweeps, each taken by both from the JAX trainer's state
    (params, lists, Adam moments carried over): loss and mse within 1e-5
    relative (measured: 4.3e-6 at most), num_pi and the lists equal, the
    updated params within a tenth of one Adam step of each group (lr 1 for
    A, 1e-5 for pis, 1e-3 else; measured: 4.8e-2 of a step at most, on
    A_corr, where Adam's early steps lr m / (sqrt(v) + eps) on near-zero
    gradients move by the gradients' relative rounding).
    tests/data/lf_hopper_fused_ref.json records the
    600-sweep recipe on this path: it decodes at 29.59 dB (trained views),
    inside the port's kernel-path spread, so the ~1.6 dB below the XLA path
    is the fused semantics', not the port's."""
    from smoe_tpu_torch.apps import content
    from test_torch_video import carry
    lf = content.build_lf(s=8, texture="hopper")
    lr = {"A_diagonal": 1.0, "A_corr": 1.0, "pis": 1e-5}
    js, ts = _pair(lf, kernels_per_dim=[4, 4, 6, 6], use_pallas="on",
                   lf_corner_weight=0.1)
    for i in range(6):
        if i:
            carry(js, ts)
        tl, tm, tn, _ = ts.run_batched_chunk(1)
        jl, jm, jn, _ = js.run_batched_chunk(1)
        np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-5)
        np.testing.assert_allclose(tm, np.asarray(jm), rtol=1e-5)
        np.testing.assert_array_equal(tn, np.asarray(jn))
        np.testing.assert_array_equal(ts.kernel_lists.numpy(),
                                      np.asarray(js.kernel_lists))
        tp, jp = ts.get_params(), js.get_params()
        for k in jp:
            np.testing.assert_allclose(
                tp[k], jp[k], rtol=0, atol=0.1 * lr.get(k, 1e-3),
                err_msg=f"{i} {k}")
