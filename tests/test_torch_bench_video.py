"""PyTorch port: the video benches (smoe_tpu_torch/bench/video.py and
video_quality.py) against scripts/bench_video.py and
scripts/bench_video_quality.py, on the CPU on cut clips, as
tests/test_torch_bench.py runs the bench modules and holds their JSON to
the scripts'."""

import io
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401

from smoe_tpu_torch.apps import content  # noqa: E402
from smoe_tpu_torch.bench import video, video_quality  # noqa: E402

from test_torch_bench import (_cut_video, assert_close,  # noqa: E402
                              json_lines, load_script, run_port, run_script)


def test_video_tracks_script(monkeypatch):
    """The dual-model fit's recipe on the cut clip (8 x 12 x 4)."""
    mod = load_script("bench_video", monkeypatch)
    mod["main"].__globals__["build_video"] = _cut_video
    monkeypatch.setattr(sys, "argv", ["bench_video.py"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod["main"]()
    j = json_lines(buf.getvalue())[-1]
    monkeypatch.setattr(content, "build_video", _cut_video)
    t = run_port(video.main, ["--device", "cpu"])
    assert_close(t, j, db_keys=("psnr_500_iters",))
    assert t["dual_model"] and t["frames"] == 4


VQ_ARGS = ["--k", "2", "--n", "4", "--ri", "2", "--val", "2", "--auto"]


def test_video_quality_tracks_script(monkeypatch, tmp_path):
    """The module against the script on the cut clip (136 x 128 x 4 with
    the moving square), -k 2 2 4, 4 + 4 x 2 sweeps (10 on the last slab),
    --auto, with the port's fit replaced by the JAX run's (its Smoe and its
    out/ directory): the decode of model_best.smoe, the PSNRs, the rate,
    the automatic encode of params_best.pkl (a JAX pickle read by the
    port's cli.reconstruct) and the JSON.  The fits themselves part after
    the first reseed (test_video_quality_runs_its_own_fit)."""
    import shutil

    import smoe_tpu.cli.fit as jfit
    from smoe_tpu_torch.cli import fit as tfit
    runs = {}
    real = jfit.main

    def record(argv):
        runs["smoe"] = real(argv)
        runs["out"] = argv[argv.index("-r") + 1]
        return runs["smoe"]

    def patch():
        import scripts.bench_video as sbv
        monkeypatch.setattr(sbv, "build_video", _cut_video)
        monkeypatch.setattr(jfit, "main", record)
    j = json_lines(run_script("bench_video_quality", VQ_ARGS, monkeypatch,
                              patch))

    def replay(argv):
        assert argv[-2:] == ["--device", "cpu"]
        shutil.copytree(runs["out"], argv[argv.index("-r") + 1])
        return runs["smoe"]
    monkeypatch.setattr(content, "build_video", _cut_video)
    monkeypatch.setattr(tfit, "main", replay)
    t = run_port(video_quality.main, VQ_ARGS + ["--device", "cpu"])
    assert len(t) == len(j) == 2
    for a, b in zip(t, j):
        assert_close(a, b, db_keys=("value",))
    wd = t[0]["workdir"]
    assert os.path.exists(os.path.join(wd, "cif.npz"))
    assert os.path.exists(os.path.join(wd, "out", "params_best.pkl"))


def test_video_quality_runs_its_own_fit(monkeypatch):
    """The port's module end to end with its own CLI fit, on the pure-pan
    cut clip (--static: 8 x 12 x 4), -k 2 2 4, 4 + 4 x 2 sweeps, --auto:
    the script's keys, every kernel live after the four reseeds, the
    decoded PSNR finite.  Its PSNR is not held to JAX's: the time-slab
    reseed draws its kernels error-proportionally (reseed_time_slab), and
    two correct fits whose reconstructions sit a few quantizer steps apart
    draw some kernels a pixel apart; tests/test_torch_fit_cli.py holds that
    loop at 5 % of the mse on its toy clip, and after four slabs the two
    packages part by up to 1.1 dB here (the moving-square clip at
    144 x 176 x 4, measured on the CPU)."""
    monkeypatch.setattr(content, "build_video", _cut_video)
    t = run_port(video_quality.main, [
        "--k", "2", "--n", "4", "--ri", "2", "--val", "2", "--static",
        "--auto", "--device", "cpu"])
    keys = ["metric", "value", "unit", "psnr_yuv_weighted_db",
            "psnr_train_best_db", "coded_bpp", "coded_bits", "live_kernels",
            "fit_wallclock_s", "decode_s", "frames", "workdir", "recipe",
            "card", "power_limit_w"]
    assert list(t[0]) == keys and t[0]["recipe"].endswith("static-pan")
    assert (t[0]["live_kernels"], t[0]["frames"]) == (32, 4)
    assert np.isfinite(t[0]["value"]) and np.isfinite(t[1]["value"])
    assert t[1]["metric"] == "video_cif_composed_auto_encode_psnr_db"
