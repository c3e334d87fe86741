"""PyTorch port: the trainer's video branches (the dual-model sweeps, the
motion probes and lists, train_trafo, the time-slab reseed, QAT of the
motion rows, the LS init on a video fit, the dual-model prune search)
against the JAX package on the CPU, with tests/test_torch_video.py's
inputs and tolerances."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from smoe_tpu.fit import trainer as jtr  # noqa: E402
from smoe_tpu_torch.fit import trainer as ttr  # noqa: E402
from smoe_tpu_torch.video.motion import TIME_PLANE  # noqa: E402

from test_torch_video import (RTOL, _motion, _pair,  # noqa: E402
                              _set_motion, _video_pair, carry, make_video)


@pytest.mark.parametrize("iukl", [False, True])
@pytest.mark.parametrize("mode", ["on", "off"])
def test_dual_model_sweeps_track_jax(mode, iukl):
    """8 sweeps (two chunks) of the dual-model fit from one carried state:
    per-sweep loss and mse, num_pi, the lists and the capped width."""
    js, ts = _video_pair(mode, in_graph_ukl=iukl)
    for s in (js, ts):
        s.set_optimizer()
    js.run_batched_chunk(2)
    carry(js, ts)
    assert ts._current_k_cap() == js._current_k_cap()
    for _ in range(2):
        jl, jm, jn, _ = js.run_batched_chunk(4)
        tl, tmse, tn, _ = ts.run_batched_chunk(4)
        np.testing.assert_allclose(tl, jl, rtol=RTOL)
        np.testing.assert_allclose(tmse, jm, rtol=RTOL)
        np.testing.assert_array_equal(tn, jn)
        np.testing.assert_array_equal(ts.kernel_lists.numpy(),
                                      np.asarray(js.kernel_lists))
        assert ts._current_k_cap() == js._current_k_cap()
    assert tmse[-1] < float(np.asarray(js.mses[0][1]) if js.mses else 1e9)
    # the motion rows are not trained without train_trafo
    np.testing.assert_array_equal(ts.params.motion.numpy(),
                                  np.asarray(js.params.motion))


def test_video_fit_with_affines_end_to_end():
    """tests/test_video.py's case on the port, beside JAX's numbers."""
    js, ts = _video_pair()
    out = {}
    for name, s in (("jax", js), ("torch", ts)):
        s.set_optimizer()
        _, m0, *_ = s.run_batched(train=False)
        for _ in range(15):
            loss, mse, npi, _ = s.run_batched(train=True)
        assert np.isfinite(loss) and mse < m0
        out[name] = (m0, mse, npi)
    # the first eval already differs by a few output-quantizer steps: the
    # t = -5 plane's maha cancels, so the two packages' weights part by
    # ~1e-4 and some values of a 576-value clip cross a rounding boundary
    np.testing.assert_allclose(out["torch"][0], out["jax"][0], rtol=RTOL)
    np.testing.assert_allclose(out["torch"][1], out["jax"][1], rtol=2e-2)
    assert out["torch"][2] == out["jax"][2]


def test_dual_model_fused_training():
    _, ts = _video_pair("on")
    ts.set_optimizer()
    _, m0, *_ = ts.run_batched(train=False)
    for _ in range(10):
        loss, mse, *_ = ts.run_batched(train=True)
    assert np.isfinite(loss) and mse < m0


@pytest.mark.parametrize("replace", [False, True])
def test_update_kernel_list_uses_motion_probes(replace):
    """Motion-plane kernels are probed against the transformed domain and
    raw-domain kernels against the raw one: the refreshed lists equal
    JAX's, and every live motion-plane kernel is reachable."""
    js, ts = _video_pair()
    js.kernel_lists = jnp.zeros_like(js.kernel_lists)
    ts.kernel_lists = torch.zeros_like(ts.kernel_lists)
    js.update_kernel_list(replace=replace)
    ts.update_kernel_list(replace=replace)
    lists = ts.kernel_lists.numpy()
    np.testing.assert_array_equal(lists, np.asarray(js.kernel_lists))
    m0 = ts.model_mask.numpy()[:ts.cfg.start_pis]
    live = m0 & (ts.params.pis.detach().numpy()[:ts.cfg.start_pis] > 0)
    assert np.all(lists[:, :ts.cfg.start_pis][:, live].any(axis=0))


def test_probe_lists_route_raw_kernels_to_raw_probes():
    """With live raw-domain kernels (after a reseed) the lists still match
    JAX's, in two blocks."""
    vid, aff = make_video(h=8, w=8, t=4)
    js, ts = _pair(vid, kernels_per_dim=[2, 2, 2], affines=aff, init_flag=1,
                   batch_size=(8, 8, 2))
    for s in (js, ts):
        s.set_optimizer()
    js.run_batched_chunk(3)
    js.reseed_time_slab(0, rng=0)
    carry(js, ts)
    js.update_kernel_list(replace=True)
    ts.update_kernel_list(replace=True)
    np.testing.assert_array_equal(ts.kernel_lists.numpy(),
                                  np.asarray(js.kernel_lists))
    assert ts.kernel_lists.shape[0] == 2 and not ts.kernel_lists.all()


def test_train_trafo_video_fits():
    """Trainable motion without affines: the motion rows take gradients on
    the plain path, frame 0's column never moves, and one step from a
    carried state moves the rows as JAX's does."""
    vid, _ = make_video(h=8, w=8, t=3)
    js, ts = _pair(vid, kernels_per_dim=[2, 2, 2], train_trafo=True,
                   num_params_model=6)
    assert ts.params.motion.requires_grad and ts.model_mask is None
    assert ts.kernel_lists.all()
    assert np.all(ts.params.musX.detach().numpy()[:, 2] == TIME_PLANE)
    for s in (js, ts):
        s.set_optimizer()
    m_before = ts.params.motion.detach().numpy().copy()
    js.run_batched_chunk(3)
    carry(js, ts)
    jl, jm, _, _ = js.run_batched_chunk(1)
    tl, tmse, _, _ = ts.run_batched_chunk(1)
    np.testing.assert_allclose(tmse, jm, rtol=1e-5)
    np.testing.assert_allclose(ts.params.motion.detach().numpy(),
                               np.asarray(js.params.motion), rtol=1e-4,
                               atol=1e-7)
    g = ts.params.motion.grad.numpy()
    assert np.all(g[:, 0] == 0) and np.abs(g[:, 1:]).max() > 0
    for _ in range(6):
        loss, mse, *_ = ts.run_batched(train=True)
    assert np.isfinite(loss)
    m_after = ts.params.motion.detach().numpy()
    np.testing.assert_array_equal(m_before[:, 0], m_after[:, 0])
    assert np.abs(m_after[:, 1:] - m_before[:, 1:]).max() > 0
    assert "motion" in ts.adam_state_numpy()["mu"]


def test_train_trafo_motion_gradient_matches_jax():
    """d loss / d motion of one block through the whole plain forward."""
    vid, _ = make_video(h=8, w=8, t=3)
    js, ts = _pair(vid, kernels_per_dim=[2, 2, 2], train_trafo=True,
                   num_params_model=8)
    m = _motion(8, 3)
    _set_motion(js, ts, m)
    reg = jtr.RegWeights(jnp.float32(0), jnp.float32(0), jnp.float32(0))

    def jloss(p):
        return jtr._block_loss(p, js.cfg, js.bset.coords[0],
                               js.bset.targets[0], js.kernel_lists[0], None,
                               None, reg, None, None,
                               js.bset.block_padded)[0]

    g_j = np.asarray(jax.grad(jloss)(js.params).motion)
    loss, _ = ttr._block_loss(ts.params, ts.cfg, ts.bset.coords[0],
                              ts.bset.targets[0], ts.kernel_lists[0], None,
                              None, ttr.RegWeights(0.0, 0.0, 0.0), None,
                              ts.bset.block_padded)
    loss.backward()
    g_t = ts.params.motion.grad.numpy()
    assert np.abs(g_j).max() > 0
    np.testing.assert_allclose(g_t, g_j, rtol=2e-3,
                               atol=2e-4 * np.abs(g_j).max())


def test_reseed_time_slab_rows_identical():
    """From one state and one reconstruction, numpy's generator picks the
    same pixels in both packages: the same rows come alive at the same
    centers, their offsets within 1e-6, and the next sweep is finite."""
    js, ts = _video_pair()
    for s in (js, ts):
        s.set_optimizer()
    js.run_batched_chunk(5)
    carry(js, ts)
    # one reconstruction for both draws (the two evals may differ by an
    # output-quantizer step at a borderline pixel)
    rec = js.get_reconstruction()
    np.testing.assert_allclose(ts.get_reconstruction(), rec,
                               atol=1.01 / 255)
    ts.reconstruction_image, ts.valid = np.asarray(rec), True
    before = int((ts.params.pis > 0).sum())
    rows_j = js.reseed_time_slab(0, rng=0)
    rows_t = ts.reseed_time_slab(0, rng=0)
    np.testing.assert_array_equal(rows_t, rows_j)
    np.testing.assert_array_equal(rows_t, np.arange(8, 12))
    assert int((ts.params.pis > 0).sum()) == before + 4
    assert np.all(ts.params.pis.detach().numpy()[rows_t] == 1.0)
    mus = ts.params.musX.detach().numpy()[rows_t]
    np.testing.assert_array_equal(mus, np.asarray(js.params.musX)[rows_j])
    assert np.all((mus >= 0) & (mus <= 1))
    np.testing.assert_allclose(ts.params.nu_e.detach().numpy()[rows_t],
                               np.asarray(js.params.nu_e)[rows_j], atol=1e-6)
    np.testing.assert_array_equal(ts.kernel_lists.numpy(),
                                  np.asarray(js.kernel_lists))
    loss, mse, *_ = ts.run_batched(train=True)
    assert np.isfinite(loss)
    # a second slab continues after the first; a third has no slots left
    np.testing.assert_array_equal(ts.reseed_time_slab(1, rng=1),
                                  np.arange(12, 16))
    with pytest.raises(ValueError, match="no spare kernel slots"):
        ts.reseed_time_slab(2, rng=2)


@pytest.mark.parametrize("qm", [2, 3])
def test_qat_motion_rows_match_jax(qm):
    """QAT modes 2 and 3 fake-quantize the motion rows to 8 bits with
    per-row bounds; the effective rows and get_params agree with JAX."""
    from smoe_tpu.core.quant import apply_qat as jqat
    from smoe_tpu_torch.core.quant import apply_qat as tqat
    js, ts = _video_pair(quantization_mode=qm)
    m = _motion(6, 3)
    _set_motion(js, ts, m)
    mj = np.asarray(jqat(js.params, js.cfg).motion)
    mt = tqat(ts.params, ts.cfg).motion.detach().numpy()
    np.testing.assert_allclose(mt, mj, atol=1e-7)
    assert np.abs(mt - m).max() > 0            # it did quantize
    for row in mt:                              # at most 256 levels a row
        assert len(np.unique(row)) <= 3
    pj, pt = js.get_params(), ts.get_params()
    for r in ("h11", "h13", "h23", "h32"):
        np.testing.assert_allclose(pt[r], pj[r], atol=1e-7)


def test_qat_motion_rows_pass_jax_s_straight_through_gradient():
    """The fake-quant's gradient to the motion rows: 1 inside the row's
    range, jnp.clip's 0.5 at its ends (each row's min and max sit on the
    clamp), the bounds themselves carrying none."""
    from smoe_tpu.core.quant import apply_qat as jqat
    from smoe_tpu_torch.core.quant import apply_qat as tqat
    vid, _ = make_video(h=8, w=8, t=3)
    js, ts = _pair(vid, kernels_per_dim=[2, 2, 2], train_trafo=True,
                   quantization_mode=2)
    _set_motion(js, ts, _motion(6, 3))
    wts = np.random.default_rng(2).normal(size=(8, 3)).astype(np.float32)
    g_j = np.asarray(jax.grad(lambda p: jnp.sum(
        jnp.asarray(wts) * jqat(p, js.cfg).motion))(js.params).motion)
    (torch.as_tensor(wts) * tqat(ts.params, ts.cfg).motion).sum().backward()
    np.testing.assert_allclose(ts.params.motion.grad.numpy(), g_j,
                               atol=1e-7)
    assert set(np.unique(np.abs(g_j / wts).round(3))) == {0.5, 1.0}


@pytest.mark.parametrize("mode", ["kernel", "coupled"])
def test_ls_init_on_a_video_fit_matches_jax(mode):
    """The least-squares expert solve on the dual-model fit: the design
    uses the transformed coordinates, the gating the dual features."""
    js, ts = _video_pair()
    for s in (js, ts):
        s.set_optimizer()
    js.run_batched_chunk(3)
    js.reseed_time_slab(0, rng=0)
    carry(js, ts)
    m_before = ts.run_batched(train=False)[1]
    mass_j = js.ls_init_experts(mode=mode)
    mass_t = ts.ls_init_experts(mode=mode)
    np.testing.assert_allclose(mass_t, mass_j, rtol=1e-4)
    mj = js.run_batched(train=False)[1]
    mt = ts.run_batched(train=False)[1]
    # 192 pixels carry 12 kernels x 4 unknowns: the solve is too loosely
    # conditioned for its experts to agree, its objective is not
    np.testing.assert_allclose(mt, mj, rtol=5e-3)
    assert mt < m_before


def test_prune_search_dual_model_sweeps_msplit(capsys):
    """tests/test_video.py's case on the port: a dual-model fit sweeps the
    msplit ordering too, and picks the same prefix as JAX."""
    from smoe_tpu.codec.prune import prune_search as jprune
    from smoe_tpu.codec.quantize import quantize_params as jq
    from smoe_tpu_torch.codec.prune import prune_search as tprune
    from smoe_tpu_torch.codec.quantize import quantize_params as tq
    js, ts = _video_pair()
    for s in (js, ts):
        s.set_optimizer()
    js.run_batched_chunk(5)
    js.reseed_time_slab(0, rng=0)
    js.run_batched_chunk(3)
    carry(js, ts)
    js.qparams = jq(js.get_params(), js.cfg)
    ts.qparams = tq(ts.get_params(), ts.cfg)
    used = np.asarray(ts.qparams["used_kernels"], bool)
    np.testing.assert_array_equal(used, np.asarray(js.qparams["used_kernels"],
                                                   bool))
    k = int(np.count_nonzero(used))
    mm_used = ts.model_mask.numpy()[used]
    assert mm_used.any() and not mm_used.all()
    qj = jprune(js, 99.0)
    capsys.readouterr()
    qt = tprune(ts, 99.0)
    out = capsys.readouterr().out
    assert "prune sweep[mass]" in out and "prune sweep[msplit]" in out
    assert int(np.count_nonzero(qt["used_kernels"])) == max(1, k * 2 // 16)
    np.testing.assert_array_equal(qt["used_kernels"], qj["used_kernels"])
