"""PyTorch port: the studies that build on the bench modules
(smoe_tpu_torch/apps/exp_lsinit.py, exp_lsri_quant.py,
exp_recode_matrix.py, exp_a_domain.py, exp_layers_video.py,
dryrun_tp_bigk.py) against the JAX package's scripts, both on the CPU at
cut sizes, in-process as tests/test_torch_bench.py runs them.

A study that takes a saved fit reads either package's pickle: each such
test runs both packages on a pickle written by JAX and on one written by
the port.  Tolerances (besides tests/test_torch_bench.py's: PSNR within
0.1 dB, rates within 1 %, integers and strings exact, times by key only):
  * a parameter range's end (exp_lsri_quant's "ranges") within RANGE_RTOL
    = 2 % of its magnitude: the extremes are the sharpest kernels' steering
    entries, which A's learning rate (x1000) moves fastest; measured 1.0 %
    after 100 sweeps with the LS refresh;
  * the 'k'-sharded fit's loss and mse (dryrun_tp_bigk) within 1e-3
    relative over its two sweeps (the denominator's sum over the ranks
    rounds otherwise than one sum)."""

import io
import os
import pickle
import re
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from smoe_tpu_torch.apps import (content, dryrun_tp_bigk,  # noqa: E402
                                 exp_a_domain, exp_layers_video, exp_lsinit,
                                 exp_lsri_quant, exp_recode_matrix)
from smoe_tpu_torch.bench import lf as tlf  # noqa: E402

from test_torch_bench import (_BUILD_VIDEO, assert_close,  # noqa: E402
                              json_lines, run_port, run_script)

RANGE_RTOL = 2e-2


def _cut_video(moving_obj=False, **kw):
    """The pure-pan clip cut to 8 x 12 x 4 (the studies run --static)."""
    assert not moving_obj
    return _BUILD_VIDEO(h=8, w=12, t=4)



@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one torch thread: under the suite's xdist workers
    torch's default of a thread a core oversubscribes the CPU, and a fit's
    spinning threads slowed these tests ~10x (measured under -n 4)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

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
    64^2 x 144 kernels, 100 sweeps (one LS refresh)."""
    args = ["--size", "64", "--iters", "100"]
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


@pytest.fixture(scope="module")
def lf_workdirs(tmp_path_factory):
    """A light-field workdir of each package (bench_lf.py / bench.lf at
    --s 12 -k 3 3 4 4, 20 sweeps): lf.mat and out/params_best.pkl."""
    args = ["--s", "12", "--n", "20", "--val", "10", "--k", "4", "--kt",
            "3"]
    with pytest.MonkeyPatch.context() as mp:
        j = json_lines(run_script("bench_lf", args, mp))[-1]
    t = run_port(tlf.main, args + ["--device", "cpu"])
    return {"jax": j["workdir"], "torch": t["workdir"]}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_exp_recode_matrix_tracks_script(monkeypatch, lf_workdirs, writer):
    """The ten coding configurations of one light-field fit (its pickle
    written by `writer`) re-coded and decoded by both packages."""
    wd = lf_workdirs[writer]
    j = json_lines(run_script("exp_recode_matrix", [wd, "--lf"],
                              monkeypatch))
    t = run_port(exp_recode_matrix.main, [wd, "--lf", "--device", "cpu"])
    assert len(t) == len(j) == len(exp_recode_matrix.CONFIGS)
    for a, b in zip(t, j):
        assert_close(a, b)
    assert t[0]["config"] == "ref" and "decoded_trained_views_db" in t[0]


@pytest.fixture(scope="module")
def video_fits(tmp_path_factory):
    """A fit of the pure-pan cut clip (8 x 12 x 4) from each package's fit
    CLI: -k 3 3 4, 20 sweeps, no reseed retrains."""
    from smoe_tpu.cli import fit as jfit
    from smoe_tpu_torch.cli import fit as tfit
    root = tmp_path_factory.mktemp("exp_video")
    vid, aff = _cut_video()
    clip = str(root / "cif.npz")
    np.savez(clip, imgs=np.moveaxis((vid * 255).astype(np.uint8), 2, 0),
             affines=aff)
    flags = ["-k", "3", "3", "4", "-n", "20", "-v", "10", "-ri", "0",
             "-np", "0", "-qm", "1", "-iukl", "1"]
    out = {}
    for name, main, extra in (("jax", jfit.main, []),
                              ("torch", tfit.main, ["--device", "cpu"])):
        d = str(root / name)
        with redirect_stdout(io.StringIO()):
            main(["-i", clip, "-r", d] + flags + extra)
        out[name] = os.path.join(d, "params_best.pkl")
    return out


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_exp_layers_video_tracks_script(monkeypatch, video_fits, writer):
    """The 3-tier ladder of a video fit (its pickle written by `writer`),
    rebuilt and re-coded by both packages' encode CLI at the reference
    depths (--bd 20 18 6 10 10) and decoded prefix by prefix.  Without
    --bd the encode CLI's automatic search chooses among candidates that
    tie to 1e-3 dB on this 20-sweep toy fit, and the two packages break
    the tie differently (measured: the gamma anchor and 6 against 4 gamma
    bits, 3.4 % of the rate); tests/test_torch_encode_cli.py holds that
    search's choices on its fit."""
    import scripts.bench_video as sbv
    args = ["--params", video_fits[writer], "--layers", "3", "--static",
            "--bd", "20", "18", "6", "10", "10"]
    monkeypatch.setattr(sbv, "build_video", _cut_video)
    j = json_lines(run_script("exp_layers_video", args, monkeypatch))[-1]
    monkeypatch.setattr(content, "build_video", _cut_video)
    t = run_port(exp_layers_video.main, args + ["--device", "cpu"])
    assert_close(t, j, timed={"decode_s"})
    assert [r["tiers"] for r in t["ladder"]] == [1, 2, 3]


@pytest.fixture(scope="module")
def rd_models(tmp_path_factory):
    """exp_a_domain's inputs: a {"params", "cfg"} pickle of a 64^2 x 144
    kernel fit (100 sweeps) from each package, and the JAX fit's .smoe."""
    from smoe_tpu import Smoe as JSmoe
    from smoe_tpu.codec.bitstream import write_bitstream
    from smoe_tpu.codec.quantize import quantize_params
    from smoe_tpu_torch.fit.trainer import Smoe
    root = tmp_path_factory.mktemp("exp_a_domain")
    img = content.build_image(64)
    out = {}
    for name, s in (("jax", JSmoe(img, kernels_per_dim=[12], use_yuv=True)),
                    ("torch", Smoe(img, kernels_per_dim=[12], use_yuv=True,
                                   device="cpu"))):
        s.set_optimizer()
        s.run_batched_chunk(100)
        out[name] = str(root / f"{name}.pkl")
        with open(out[name], "wb") as f:
            pickle.dump({"params": s.get_params(), "cfg": s.cfg}, f)
        if name == "jax":
            out["smoe"] = str(root / "jax.smoe")
            write_bitstream(out["smoe"], quantize_params(s.get_params(),
                                                         s.cfg), s.cfg)
    return out


@pytest.mark.parametrize("model", ["jax", "torch", "smoe"])
def test_exp_a_domain_tracks_script(monkeypatch, rd_models, model):
    """Every row of the RD study (float, canonical, per-group, the A
    domain's linear and eigen sweeps with real coded bits, the allocation
    sweep) on a fit pickled by either package, and on a .smoe."""
    args = [rd_models[model], "--size", "64"]
    j = json_lines(run_script("exp_a_domain", args, monkeypatch))
    t = run_port(exp_a_domain.main, args + ["--device", "cpu"])
    assert len(t) == len(j) == 33
    for a, b in zip(t[:-1], j[:-1]):
        assert_close(a, b, key="row")        # no card fields on a row
    assert_close(t[-1], j[-1])


def test_jax_pickle_config_loads_as_the_ports(rd_models):
    from smoe_tpu_torch.config import SmoeConfig
    params, cfg = exp_a_domain.load_fit(rd_models["jax"])
    assert type(cfg) is SmoeConfig and cfg.kernels_per_dim == (12, 12)
    assert params["pis"].shape == (144,)


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
