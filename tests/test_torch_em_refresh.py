"""PyTorch port: the EM gating-refresh study (smoe_tpu_torch/apps/
exp_em_refresh.py) against the JAX package's scripts/exp_em_refresh.py,
both on the CPU.

Tolerances: the study at a cut size (32^2, 40 sweeps, a refresh at 20)
chooses the same step t at every refresh and reads each PSNR within
tests/test_torch_bench.py's 0.1 dB.  The direction itself is
ill-conditioned at this size (a kernel holds a few pixels, so
S2/S0 - mu mu^T cancels): the moments agree to 2.4e-7 relative while A*
parts by up to 1 % of its largest entry, so the moments are held to
G_RTOL = 1e-5 (tests/test_torch_lsinit.py's) and the host math, fed the
same moments, bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401

from smoe_tpu_torch.apps import exp_em_refresh  # noqa: E402
from smoe_tpu_torch.bench.flagship import build_image  # noqa: E402
from smoe_tpu_torch.bench.flagship import make_smoe  # noqa: E402
from smoe_tpu_torch.fit import trainer as ttr  # noqa: E402

from test_torch_bench import (assert_close, json_lines,  # noqa: E402
                              load_script, run_port, run_script)
from test_torch_graph_programs import replaying  # noqa: E402,F401

G_RTOL = 1e-5
CUT = ["--size", "32", "--max", "40", "--refresh", "20"]


def test_exp_em_refresh_tracks_script(monkeypatch):
    j = json_lines(run_script("exp_em_refresh", CUT + ["--cpu"],
                              monkeypatch))
    t = run_port(exp_em_refresh.main, CUT + ["--device", "cpu"])
    assert_close(t, j[-1], timed={"wall_s"}, db_keys=("psnr", "traj"))
    for tag in ("em", "em_y"):
        assert t[tag]["t_chosen"] == j[-1][tag]["t_chosen"]


def _pair(monkeypatch):
    """The JAX script's module and trainer, and the port's trainer, from
    the same 32^2 bench image (the same init)."""
    mod = load_script("exp_em_refresh", monkeypatch)
    img = build_image(32)
    return mod, mod["make_smoe"](img), make_smoe(img, "cpu")


@pytest.mark.parametrize("yaware", [False, True])
def test_em_direction_matches_jax(monkeypatch, yaware):
    """The moments (the port's programs) within G_RTOL of JAX's; fed the
    same moments, the direction's host math gives JAX's bits."""
    import jax.numpy as jnp
    from smoe_tpu.fit.lsinit import _accumulate
    from smoe_tpu.fit.trainer import effective_params
    from smoe_tpu_torch.fit import lsinit as tls
    mod, js, ts = _pair(monkeypatch)
    if yaware:
        jG = np.asarray(mod["_accumulate_yaware"](js, 1e-3))
        tG = exp_em_refresh.accumulate_yaware(ts, 1e-3).numpy()
    else:
        eff = effective_params(js.params, js.cfg, js.musX_grid)
        jG, _ = _accumulate(eff, js.cfg, js.bset.coords, js.bset.targets,
                            js.kernel_lists, js.bset.valid,
                            js.bset.train_mask,
                            jnp.ones(js.bset.coords.shape[:2]),
                            js.model_mask, False)
        jG = np.asarray(jG)
        tG = tls.gram(ts, False, None, tls.lists_buffer(ts))[0].numpy()
    assert np.abs(tG - jG).max() <= G_RTOL * np.abs(jG).max()
    jd = mod["em_gating_direction"](js, yaware, 1e-3 if yaware else None)
    same = torch.tensor(jG)
    monkeypatch.setattr(exp_em_refresh, "accumulate_yaware",
                        lambda s, s2: same)
    monkeypatch.setattr(tls, "gram", lambda *a: (same, None))
    td = exp_em_refresh.em_gating_direction(ts, yaware,
                                            1e-3 if yaware else None)
    np.testing.assert_array_equal(td[3], jd[3])
    assert td[3].any()
    for a, b in zip(td[:3], jd[:3]):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_gating_step_through_programs_equals_eager(replaying):  # noqa: F811
    """em_gating_step with the candidates' evals and the Gram through the
    trainer's programs (replayed after the first of a key) against a
    trainer made alike under eager(): the same t and mse, the same bits
    of the params it leaves, each candidate read where it was written."""
    img = build_image(32)
    a, b = make_smoe(img, "cpu"), make_smoe(img, "cpu")
    ts = (0.0, 0.01, 0.1, 1.0)
    for yaware in (False, True, False):
        got = exp_em_refresh.em_gating_step(a, ts, yaware=yaware)
        with ttr.eager():
            want = exp_em_refresh.em_gating_step(b, ts, yaware=yaware)
        assert got == want
        for f in ("musX", "a_diag", "a_corr"):
            assert torch.equal(getattr(a.params, f), getattr(b.params, f))
    assert len(a._programs.graphs) >= 2 and not b._programs.graphs
