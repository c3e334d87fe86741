"""PyTorch port: the studies that re-code a saved fit
(smoe_tpu_torch/apps/exp_recode_matrix.py, exp_layers_video.py and
exp_a_domain.py) against the JAX package's scripts, both on the CPU at cut
sizes, each on a fit pickled by either package, with
tests/test_torch_exp.py's tolerances."""

import io
import os
import pickle
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401

from smoe_tpu_torch.apps import (content, exp_a_domain,  # noqa: E402
                                 exp_layers_video, exp_recode_matrix)
from smoe_tpu_torch.bench import lf as tlf  # noqa: E402

from test_torch_bench import (assert_close, json_lines,  # noqa: E402
                              run_port, run_script)
from test_torch_exp import _cut_video  # noqa: E402


@pytest.fixture(scope="module")
def lf_workdirs(tmp_path_factory):
    """A light-field workdir of each package (bench_lf.py / bench.lf at
    --s 8 -k 3 3 4 4, 20 sweeps): lf.mat and out/params_best.pkl."""
    args = ["--s", "8", "--n", "20", "--val", "10", "--k", "4", "--kt",
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
