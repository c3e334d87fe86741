"""PyTorch port: the studies that build on the bench modules
(smoe_tpu_torch/apps/exp_lsinit.py, exp_lsri_quant.py,
exp_recode_matrix.py, exp_a_domain.py, exp_layers_video.py,
dryrun_tp_bigk.py) against the JAX package's scripts, both on the CPU at
cut sizes, in-process as tests/test_torch_bench.py runs them.

A study that takes a saved fit (tests/test_torch_exp_recode.py) reads
either package's pickle: each such test runs both packages on a pickle
written by JAX and on one written by the port.  Tolerances (besides
tests/test_torch_bench.py's: PSNR within 0.1 dB, rates within 1 %,
integers and strings exact, times by key only):
  * a parameter range's end (exp_lsri_quant's "ranges") within RANGE_RTOL
    = 2 % of its magnitude: the extremes are the sharpest kernels' steering
    entries, which A's learning rate (x1000) moves fastest; measured 1.0 %
    after 100 sweeps with the LS refresh;
  * the 'k'-sharded fit's loss and mse (dryrun_tp_bigk) within 1e-3
    relative over its two sweeps (the denominator's sum over the ranks
    rounds otherwise than one sum)."""

import io
import re
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401

from smoe_tpu_torch.apps import (dryrun_tp_bigk, exp_a_domain,  # noqa: E402
                                 exp_layers_video, exp_lsinit, exp_lsri_quant,
                                 exp_recode_matrix)

from test_torch_bench import (_BUILD_VIDEO, assert_close,  # noqa: E402
                              json_lines, run_port, run_script)

RANGE_RTOL = 2e-2


def _cut_video(moving_obj=False, **kw):
    """The pure-pan clip cut to 8 x 12 x 4 (the studies run --static)."""
    assert not moving_obj
    return _BUILD_VIDEO(h=8, w=12, t=4)


def test_exp_lsinit_tracks_script(monkeypatch):
    """Plain sample init, -lsinit and the periodic refresh at 64^2 x 256
    kernels to 32 dB (at most 200 sweeps)."""
    args = ["--size", "64", "--max", "200", "--refresh", "100"]
    j = json_lines(run_script("exp_lsinit", args + ["--cpu"], monkeypatch))
    t = run_port(exp_lsinit.main, args + ["--device", "cpu"])
    assert_close(t, j[-1], timed={"ls_solve_s", "ls_solve_cold_s",
                                  "t_to_target_s"},
                 db_keys=("psnr", "init_psnr", "traj"))
    assert t["plain"]["iters_to_target"] == 20
    assert run_port(exp_lsinit.main, ["--size", "16", "--max", "20",
                                      "--cpu"])["plain"]["traj"] == \
        run_port(exp_lsinit.main, ["--size", "16", "--max", "20",
                                   "--device", "cpu"])["plain"]["traj"]


def test_exp_lsri_quant_tracks_script(monkeypatch):
    """The plain fit and the refreshed fit with the anchor off and on at
    64^2 x 144 kernels, 20 sweeps (one LS refresh)."""
    args = ["--size", "64", "--iters", "20"]
    j = json_lines(run_script("exp_lsri_quant", args, monkeypatch))[-1]
    t = run_port(exp_lsri_quant.main, args + ["--device", "cpu"])
    for tag in ("plain", "lsri_damp0", "lsri_damp0_anchor"):
        rt, rj = t[tag].pop("ranges"), j[tag].pop("ranges")
        assert list(rt) == list(rj)
        for name in rj:
            for a, b in zip(rt[name], rj[name]):
                assert abs(a - b) <= RANGE_RTOL * max(abs(b), 0.5), \
                    (tag, name, a, b)
    assert_close(t, j)
    # the anchor is the fix: the refreshed fit's qpsnr recovers with it
    assert t["lsri_damp0_anchor"]["qpsnr_db"] > \
        t["lsri_damp0"]["qpsnr_db"] + 3


def test_dryrun_tp_bigk_tracks_script(monkeypatch):
    """K = 64 on a (4 'b' x 2 'k') mesh, two QAT-3 sweeps: JAX on its 8
    virtual CPU devices, the port in a gloo world of 8 processes; each
    rank holds K / 2 rows of every kernel-indexed leaf."""
    args = ["--k", "8", "--size", "32", "--nk", "2"]
    out = run_script("dryrun_tp_bigk", args, monkeypatch)
    jl = re.search(r"loss ([\d.]+) -> ([\d.]+), mse ([\d.]+), live kernels "
                   r"(\d+)", out).groups()
    assert "mesh=(4b x 2k)  K=64  blocks=8" in out
    t = run_port(dryrun_tp_bigk.main, args + ["--world", "8", "--device",
                                              "cpu"])
    assert (t["mesh"], t["kernels"], t["blocks"]) == ([4, 2], 64, 8)
    assert t["per_rank_widths"] == [dict.fromkeys(dryrun_tp_bigk.LEAVES,
                                                  32)] * 8
    # the script prints the losses to 5 decimals and the mse to 1
    for a, b, half in zip([t["loss"][0], t["loss"][-1], t["mse"][-1]],
                          [float(x) for x in jl[:3]], (5e-6, 5e-6, 0.05)):
        assert abs(a - b) <= 1e-3 * abs(b) + half, (a, b)
    assert t["live_kernels"] == int(jl[3])


@pytest.mark.parametrize("main,argv", [
    (exp_lsinit.main, []), (exp_lsri_quant.main, []),
    (exp_recode_matrix.main, ["wd"]), (exp_a_domain.main, ["m.pkl"]),
    (exp_layers_video.main, ["--params", "p.pkl"]),
    (dryrun_tp_bigk.main, [])])
def test_studies_refuse_cuda_without_a_gpu(monkeypatch, main, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    with redirect_stdout(buf), pytest.raises(SystemExit,
                                             match="no CUDA device"):
        main(argv)
    assert buf.getvalue() == ""


def test_video_container_refusal_names_the_blocked_list(tmp_path):
    from smoe_tpu_torch.io.images import read_image
    with pytest.raises(NotImplementedError, match="Blocked, not queued"):
        read_image(str(tmp_path / "clip.mp4"))
