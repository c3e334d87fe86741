"""PyTorch port: incremental kernel insertion (fit/incremental.py and the
trainer's inc rows, second Adam and kernel_count) against the JAX
package's on the CPU.

The host parts (ssim_map, peak_local_max, error_map, the reinit_inc /
apply_inc splices) are numpy on the same inputs: equal to the JAX
package's (the splices exactly, the maps to 1e-12; the full gating map
1e-5 absolute).  Sweeps with
train_inc track the JAX package's mse within 2e-3 relative (the trainer
tests' tolerance) with the same kernel_count and num_pi.  Within the port,
a checkpoint restores the inc optimizer bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from smoe_tpu.fit import incremental as jinc  # noqa: E402
from smoe_tpu.fit.trainer import Smoe as JSmoe  # noqa: E402
from smoe_tpu_torch.fit import incremental as tinc  # noqa: E402
from smoe_tpu_torch.fit.trainer import PARAM_FIELDS, Smoe  # noqa: E402

RTOL = 2e-3
DEAD = [1, 6, 9, 14]          # kernels pruned before the insertion


def _toy(n):
    y, x = np.mgrid[0:n, 0:n] / (n - 1)
    img = np.stack([0.5 + 0.3 * np.sin(4 * x + 1.5 * y),
                    0.5 + 0.25 * np.cos(3 * (x - 0.3) * (y + 0.4) * 4),
                    0.4 + 0.3 * np.sin(5 * x * y)], -1)
    img[8:14, 20:27, 0] += 0.25                  # an edge the fit misses
    return np.clip(img, 0, 1).astype(np.float32)


def _params_np(s):
    p = s.params
    if isinstance(s, Smoe):
        return {f: getattr(p, f).detach().numpy().copy()
                for f in PARAM_FIELDS}
    return {f: np.array(getattr(p, f)) for f in PARAM_FIELDS}


def _pair(n=36, kpd=4, slots=2):
    """JAX and port trainers with `slots` inc steps of capacity, a few
    sweeps in, four kernels pruned (pis = 0) in both, the same
    reconstruction installed in both, so reinit_inc finds the same peaks."""
    img = _toy(n)
    kw = dict(kernels_per_dim=[kpd], add_kernel_slots=slots * kpd * kpd)
    js = JSmoe(img, **kw)
    ts = Smoe(img, device="cpu", **kw)
    js.set_optimizer()
    ts.set_optimizer()
    js.run_batched_chunk(5)
    pis = np.array(js.params.pis)
    pis[DEAD] = 0.0
    js.params = js.params.replace(pis=pis)
    ts.set_params(js.params.to_numpy())
    ts.kernel_lists = torch.as_tensor(np.array(js.kernel_lists))
    for s in (js, ts):
        s.set_optimizer()          # fresh Adam state in both
        s.num_pis.append((s.iter, kpd * kpd - len(DEAD)))
    js.run_batched(train=False, update_reconstruction=True)
    ts.reconstruction_image = np.array(js.reconstruction_image)
    ts.weight_matrix_argmax = np.array(js.weight_matrix_argmax)
    ts.valid = True
    return js, ts


def test_ssim_map_and_peaks_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (30, 26, 3))
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1)
    np.testing.assert_allclose(tinc.ssim_map(a, b), jinc.ssim_map(a, b),
                               rtol=0, atol=1e-12)
    m = 1.0 - tinc.ssim_map(a, b).mean(-1)
    for k in (0, 3, 50):
        np.testing.assert_array_equal(tinc.peak_local_max(m, k),
                                      jinc.peak_local_max(m, k))


def test_error_map_reinit_and_apply_inc_give_jax_params():
    js, ts = _pair()
    np.testing.assert_allclose(tinc.error_map(ts), jinc.error_map(js),
                               rtol=0, atol=1e-12)
    js.reinit_inc()
    ts.reinit_inc()
    jp, tp = _params_np(js), _params_np(ts)
    cap, num_inc = ts.cfg.capacity, ts.num_inc_kernels
    assert num_inc == 16 and cap == 2 * 16 + 2 * 16
    assert 1 <= np.sum(tp["pis"][cap - num_inc:] > 0) <= len(DEAD)
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(tp[f], jp[f], err_msg=f)
    assert bool(ts.kernel_lists.all())
    js.apply_inc()
    ts.apply_inc()
    assert ts.kernel_count == js.kernel_count == 32
    jp, tp = _params_np(js), _params_np(ts)
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(tp[f], jp[f], err_msg=f)
    np.testing.assert_array_equal(tp["pis"][16:32], tp["pis"][cap - 16:])


def test_inc_sweeps_track_jax():
    js, ts = _pair()
    for s in (js, ts):
        s.reinit_inc()
        s.apply_inc()
        s.reinit_inc()           # a fresh inc block for train_inc to move
    out = {}
    for name, s in (("jax", js), ("torch", ts)):
        a = s.run_batched_chunk(4, train_orig=False, train_inc=True)
        b = s.run_batched_chunk(4, train_orig=True, train_inc=True)
        out[name] = (np.concatenate([a[1], b[1]]),
                     np.concatenate([a[2], b[2]]))
    (jm, jn), (tm, tn) = out["jax"], out["torch"]
    np.testing.assert_allclose(tm, jm, rtol=RTOL)
    np.testing.assert_array_equal(tn, jn)
    assert ts.kernel_count == js.kernel_count
    # the inc rows moved; the main rows stood still in the inc-only chunk
    jp, tp = _params_np(js), _params_np(ts)
    for f in ("nu_e", "musX"):
        np.testing.assert_allclose(tp[f], jp[f], rtol=1e-2, atol=1e-3,
                                   err_msg=f)


def test_inc_only_sweep_leaves_main_rows():
    _, ts = _pair()
    ts.reinit_inc()
    before = _params_np(ts)
    ts.run_batched_chunk(3, train_orig=False, train_inc=True)
    after = _params_np(ts)
    cap, num_inc = ts.cfg.capacity, ts.num_inc_kernels
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(after[f][:cap - num_inc],
                                      before[f][:cap - num_inc], err_msg=f)
    assert not np.array_equal(after["nu_e"][cap - num_inc:],
                              before["nu_e"][cap - num_inc:])


def test_checkpoint_keeps_the_inc_state(tmp_path):
    _, a = _pair()
    a.reinit_inc()
    a.run_batched_chunk(3, train_inc=True)
    a.apply_inc()
    a.reinit_inc()
    a.run_batched_chunk(2, train_inc=True)
    path = str(tmp_path / "inc.pkl")
    a.checkpoint(path)
    b = Smoe(_toy(36), kernels_per_dim=[4], add_kernel_slots=32,
             device="cpu")
    b.restore(path)
    assert b.kernel_count == a.kernel_count == 32
    ia, ib = a.adam_state_numpy(a.inc_optimizer), \
        b.adam_state_numpy(b.inc_optimizer)
    assert ia["count"] == ib["count"] == 2
    for f in ia["mu"]:
        np.testing.assert_array_equal(ia["mu"][f], ib["mu"][f])
    for x, y in zip(a.run_batched_chunk(2, train_inc=True),
                    b.run_batched_chunk(2, train_inc=True)):
        np.testing.assert_array_equal(x, y)
    for f in PARAM_FIELDS:
        assert torch.equal(getattr(a.params, f), getattr(b.params, f))


def test_renormalize_weights_and_argmax_nu_match_jax():
    js, ts = _pair()
    js.re_normalize_pis()
    ts.re_normalize_pis()
    np.testing.assert_allclose(ts.params.pis.detach().numpy(),
                               np.asarray(js.params.pis), rtol=1e-6)
    # gating weights in [0, 1], normalised by a sum over the kernels taken
    # in another order: 1e-5 absolute
    np.testing.assert_allclose(ts.get_weight_matrix(),
                               js.get_weight_matrix(), rtol=0, atol=1e-5)
    rows = np.array([0, 3, 5])
    js.reinit_nu_from_argmax(rows=rows)
    ts.reinit_nu_from_argmax(rows=rows)
    np.testing.assert_array_equal(ts.params.nu_e.detach().numpy(),
                                  np.asarray(js.params.nu_e))


def test_peak_plot_is_not_ported():
    _, ts = _pair()
    with pytest.raises(NotImplementedError, match="item 7"):
        ts.reinit_inc(plot_dir="plots")
