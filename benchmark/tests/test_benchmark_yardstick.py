"""The benchmark's frozen arithmetic and generators: the work formulas
against the kernel table's bounds, the inputs repeating for a seed, the
readers, and the reference against the port's plain path at a small size
(this test imports both; the benchmark's runs import only the port)."""

import numpy as np
import pytest
import torch

from reference import quantize_ref as Q
from reference import smoe_ref as R
from yardstick import content, trace as tr, work as W


def test_bounds_reproduce_the_kernel_table():
    """The random 512^2 x K256 case: K1 0.0182 ms, K2 0.0385 ms at
    S = 767,943 (the port's kernel table)."""
    n, k, s = 512 * 512, 256, 767943
    f, e, c = W.widths(2, 3)
    assert (f, e, c) == (7, 3, 3)
    k1 = W.bound_s(*W.k1_work(n, k, f, e, c, s)) * 1e3
    k2 = W.bound_s(*W.k2_work(n, k, f, e, c, s)) * 1e3
    assert round(k1, 4) == 0.0182
    assert round(k2, 4) == 0.0385


def test_images_repeat_for_a_seed_and_seed_zero_is_the_scripts():
    from smoe_tpu_torch.apps.content import build_image
    a = content.bench_image(64, 2 ** 31 + 11)
    assert np.array_equal(a, content.bench_image(64, 2 ** 31 + 11))
    assert not np.array_equal(a, content.bench_image(64, 12))
    assert np.array_equal(content.bench_image(512, 0), build_image(512))
    u = content.uhd_image(54, 96, 7)
    assert np.array_equal(u, content.uhd_image(54, 96, 7))


def test_uhd_image_at_full_size_is_the_scripts():
    from smoe_tpu_torch.apps.content import build_4k
    assert np.array_equal(content.uhd_image(2160, 3840, 0), build_4k())


def test_decode_pool_and_order_repeat_for_a_seed(small):
    import run
    drv = run.load_module(f"{run.HERE}/drivers/decode.py", "drv_decode")
    cfg = dict(run.read_json(run.HERE, "configs", "still4k.json"),
               **small["still4k.decode"]["config"])
    a, _ = drv.pool_params(cfg, 9, 3)
    b, _ = drv.pool_params(cfg, 9, 3)
    for x, y in zip(a, b):
        for key in x:
            assert np.array_equal(x[key], y[key])
    assert not np.array_equal(a[0]["A_corr"], a[1]["A_corr"])


def test_grid_init_is_the_ports():
    from smoe_tpu_torch.config import SmoeConfig
    from smoe_tpu_torch.core.init import init_params
    img = content.bench_image(48, 3)
    mine = R.grid_init(img, 6)
    port = init_params(img, SmoeConfig(kernels_per_dim=(6, 6)))
    p = R.params_from_init(mine, "cpu")
    for f in R.FIELDS:
        assert np.array_equal(p[f].numpy(), np.asarray(getattr(port, f))), f


def _port_trainer(img, kpd, block, **kw):
    from smoe_tpu_torch.fit.trainer import Smoe
    return Smoe(img, kernels_per_dim=[kpd], init_params_dict=R.grid_init(
        img, kpd), batch_size=block, use_yuv=True, use_determinant=True,
        device="cpu", **kw)


def test_sweep_matches_the_ports_plain_path():
    """One sweep's loss, gradients, Adam step and survivors."""
    img = content.uhd_image(48, 64, 5)
    s = _port_trainer(img, 6, (24, 32))
    s.set_optimizer()
    blocks = R.Blocks(img, (24, 32), "cpu")
    ref = R.Ref({"precision": 8, "use_yuv": True, "use_determinant": True,
                 "probe_maha": 800.0})
    p = {f: getattr(s.params, f).detach().clone() for f in R.FIELDS}
    lists = ref.initial_lists(p, blocks)
    assert torch.equal(lists, s.kernel_lists)
    loss_p, _, _, _ = s.run_batched_chunk(1)
    g, loss_r, _, surv = ref.grads(p, blocks, lists)
    assert abs(float(loss_p[0]) - loss_r) <= 1e-6 * abs(loss_r)
    for f in R.FIELDS:
        np.testing.assert_allclose(getattr(s.params, f).grad.numpy(),
                                   g[f].numpy(), rtol=1e-4, atol=1e-7)
    new = R.Adam().step(p, g)
    for f in R.FIELDS:
        np.testing.assert_allclose(getattr(s.params, f).detach().numpy(),
                                   new[f].numpy(), rtol=1e-5, atol=1e-7)
    assert torch.equal(surv, s.kernel_lists)


def test_lists_and_ls_match_the_port():
    from smoe_tpu_torch.fit.blocks import update_kernel_lists
    from smoe_tpu_torch.fit.lsinit import ls_refresh_experts
    from smoe_tpu_torch.fit.trainer import effective_params
    img = content.uhd_image(48, 64, 6)
    ref = R.Ref({"precision": 8, "use_yuv": True, "use_determinant": True,
                 "probe_maha": 800.0})
    blocks = R.Blocks(img, (24, 32), "cpu")
    for mode, solve in (("coupled", R.ls_coupled), ("kernel", R.ls_kernel)):
        s = _port_trainer(img, 6, (24, 32))
        p = {f: getattr(s.params, f).detach().clone() for f in R.FIELDS}
        lists = s.kernel_lists.clone()
        nu, ga = solve(ref, p, blocks, lists)
        ls_refresh_experts(s, mode=mode)
        # the coupled solve is ill-conditioned: entries part by ~1e-3 of
        # the largest between two fp32 solves, the norms by ~1e-5
        for a, b in ((s.params.nu_e.detach(), nu),
                     (s.params.gamma_e.detach(), ga)):
            assert float((a - b).abs().max()) <= 2e-3 * float(b.abs().max())
            assert abs(float(a.norm()) - float(b.norm())) \
                <= 1e-4 * float(b.norm())
    eff = effective_params(s.params, s.cfg, None)
    near = update_kernel_lists(eff.A, eff.musX, eff.pis, s.cfg, s.bset,
                               torch.zeros_like(s.kernel_lists))
    p = {f: getattr(s.params, f).detach() for f in R.FIELDS}
    assert torch.equal(near, ref.near(p, blocks))


def test_quantizer_and_decode_match_the_port():
    from smoe_tpu_torch.codec.quantize import quantize_params, rescaler
    from smoe_tpu_torch.codec.serve import make_decoder, pad_decoded_params
    from smoe_tpu_torch.config import SmoeConfig
    import run
    drv = run.load_module(f"{run.HERE}/drivers/decode.py", "drv_decode2")
    cfg = dict(run.read_json(run.HERE, "configs", "still4k.json"),
               content={"family": "uhd", "height": 40, "width": 56},
               kernels_per_dim=5)
    params, shape = drv.pool_params(cfg, 4, 1)
    pcfg = SmoeConfig(kernels_per_dim=(5, 5))
    dq_p = rescaler(quantize_params(params[0], pcfg), pcfg)
    qcfg = Q.codec_cfg(**cfg["codec"])
    dq_r = Q.rescaler(Q.quantize_params(params[0], qcfg), qcfg)
    for key in dq_p:
        assert np.array_equal(dq_p[key], dq_r[key]), key
    k = dq_p["pis"].shape[0]
    pad = pad_decoded_params(dq_p, k, 2, 3)
    dec = make_decoder(shape[:2], 3, pcfg, k, device="cpu")
    img_p = dec(pad["A"], pad["musX"], pad["nu_e"], pad["gamma_e"],
                pad["pis"]).numpy()
    img_r = R.decode(R.Ref({"precision": 8}), dq_r, shape[:2], "cpu").numpy()
    lsb = np.abs(np.rint(img_p * 255) - np.rint(img_r * 255))
    assert lsb.max() <= 1 and (lsb > 0).mean() < 1e-3


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      1.0 + 2 ** -12, -3.0], dtype=torch.float32)
    r = R.round_tf32(x)
    assert r.tolist() == [1.0, 1.0, 1.0 + 2 ** -9, 1.0, -3.0]


def _slice(kernels, window=1.0):
    dev = [(name, s, e) for name, s, e in kernels]
    host = [("cudaStreamSynchronize", 0.0, window)]
    return tr.Slice(dev, host, window)


def test_trace_union_and_gaps():
    sl = _slice([("a", 0.0, 0.2), ("b", 0.1, 0.3), ("c", 0.5, 0.6)])
    assert tr.busy_s(sl) == pytest.approx(0.4)
    gaps = tr.idle_gaps(sl)
    assert gaps[0][0] == "cudaStreamSynchronize"
    assert gaps[0][1] == pytest.approx(0.2)
    assert tr.top_ops(sl)[0][0] in ("a", "b")


def test_fit_readers_from_a_made_slice():
    import run
    read = {n: run.load_module(f"{run.HERE}/metrics/{n}.py", "r_" + n
                               .replace(".", "_")).read
            for n in ("fit.k1_roofline", "fit.k2_roofline", "fit.mfu",
                      "fit.other_device_ms_per_sweep",
                      "fit.device_idle_share", "fit.loop_share",
                      "fit.chunk_ms_per_sweep")}
    # two sweeps of one block, each one K1 and one K2 (three kernels), and
    # one eval's K1
    ks = [("void gate_expert_fwd_kernel<7>", 0.0, 1e-3),
          ("bwd_pixel_kernel", 1e-3, 2e-3), ("bwd_accum_kernel", 2e-3, 3e-3),
          ("bwd_reduce_kernel", 3e-3, 3.5e-3), ("elementwise", 4e-3, 5e-3),
          ("void gate_expert_fwd_kernel<7>", 5e-3, 6e-3),
          ("bwd_pixel_kernel", 6e-3, 7e-3), ("bwd_accum_kernel", 7e-3, 8e-3),
          ("bwd_reduce_kernel", 8e-3, 8.5e-3),
          ("void gate_expert_fwd_kernel<7>", 9e-3, 1e-2)]
    m = {"slice": _slice(ks, 0.02), "slice_sweeps": 2,
         "fit_work": {"blocks": [[262144, 256, 256, 2e6]], "f": 7, "e": 3,
                      "c": 3}, "chunk_s": 1.5, "window_s": 2.0,
         "sweeps": 1000}
    n, k, s = 262144, 256, 2e6
    b1 = W.bound_s(*W.k1_work(n, k, 7, 3, 3, s))
    b2 = W.bound_s(*W.k2_work(n, k, 7, 3, 3, s))
    assert read["fit.k1_roofline"](m) == pytest.approx(100 * 3 * b1 / 3e-3)
    assert read["fit.k2_roofline"](m) == pytest.approx(100 * 2 * b2 / 5e-3)
    assert read["fit.other_device_ms_per_sweep"](m) == pytest.approx(0.5)
    assert read["fit.device_idle_share"](m) == pytest.approx(
        100 * (1 - 9e-3 / 0.02))
    assert read["fit.loop_share"](m) == pytest.approx(25.0)
    assert read["fit.chunk_ms_per_sweep"](m) == pytest.approx(1.5)
    f1 = W.k1_work(n, k, 7, 3, 3, s)[0]
    f2 = W.k2_work(n, k, 7, 3, 3, s)[0]
    assert read["fit.mfu"](m) == pytest.approx(
        100 * (3 * f1 + 2 * f2) / (0.02 * W.FP32_PEAK_FLOPS))
    # nothing to read: no value, never 0
    empty = {"slice": _slice([], 0.02), "slice_sweeps": 2,
             "fit_work": m["fit_work"]}
    for n_ in ("fit.k1_roofline", "fit.k2_roofline", "fit.mfu",
               "fit.device_idle_share", "fit.other_device_ms_per_sweep"):
        assert read[n_](empty) is None
