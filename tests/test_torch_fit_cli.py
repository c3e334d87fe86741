"""PyTorch port: the fit CLI (smoe_tpu_torch/cli/fit.py) against the JAX
package's (smoe_tpu/cli/fit.py) on a 32x32 PNG, both on the CPU.

Each arm runs both CLIs with the same flags and compares their
metrics.jsonl: the same validation iterations and kernel counts, and the
mse of every validation within 2e-3 relative (the trainer tests'
tolerance: the output fake-quantizer rounds, so a 1-ulp difference of a
pixel can move it by 1/255).  Trajectories through a quantizer are
chaotic: a value that sits on a rounding boundary in one package and not
in the other takes a whole quantization step, and after an exact least-
squares solve the experts' gradients are ~0, so Adam's first,
sign-like steps follow the rounding noise.  So each arm runs over the
horizon on which the two packages stay on one trajectory (measured on
these inputs): QAT mode 3 its first 2 sweeps at the default depths (the
6-bit experts flip a step apart from the third sweep on: 1.3e-3, then
8.6e-3) and 4 sweeps with 14-bit experts; the LS arm compares the
validation right after the coupled solve, 1e-3 relative (the solve's
conditioning, tests/test_torch_lsinit.py), and then that both fits
improve on it.  The -lsrs arm (the refresh every 2 sweeps, stopped after
6, then 6 sweeps without it) compares every validation within 1e-2: each
exact solve restarts Adam from experts a rounding apart (5e-3 measured).
Both CLIs write the same files: the plots (loss.png, iter_{n}.png,
inc_{n}.png) beside the logs and models."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401
cv2 = pytest.importorskip("cv2")

from smoe_tpu.cli import fit as jfit  # noqa: E402
from smoe_tpu_torch.cli import fit as tfit  # noqa: E402

MSE_RTOL = 2e-3
BASE = ["-k", "4"]
ARMS = {
    "default": (["-n", "12", "-v", "4"], None, MSE_RTOL),
    "ls": (["-n", "8", "-v", "4", "-lsinit", "auto", "-lsri", "4",
            "-iukl", "1", "-qm", "1"], 1, 1e-3),
    "inc": (["-n", "4", "-v", "4", "-is", "2", "-ni", "4", "-na", "4"],
            None, MSE_RTOL),
    "qm3": (["-n", "2", "-v", "2", "-qm", "3"], None, MSE_RTOL),
    "qm3_14bit": (["-n", "4", "-v", "2", "-qm", "3", "-bd", "20", "18",
                   "14", "10", "14"], None, MSE_RTOL),
    "ssim": (["-n", "12", "-v", "4", "-ssim", "1"], None, MSE_RTOL),
    "lsrs": (["-n", "12", "-v", "2", "-lsinit", "kernel", "-lsri", "2",
              "-lsrs", "6", "-iukl", "1"], None, 1e-2),
}


@pytest.fixture(scope="module")
def png(tmp_path_factory):
    root = tmp_path_factory.mktemp("fitcli")
    path = str(root / "img.png")
    y, x = np.mgrid[0:32, 0:32] / 31.0
    img = np.stack([0.5 + 0.3 * np.sin(5 * x),
                    0.5 + 0.3 * np.cos(4 * y),
                    0.4 + 0.2 * np.sin(3 * (x + y))], -1)
    cv2.imwrite(path, np.uint8(img * 255))
    return path, root


def _metrics(d):
    with open(os.path.join(d, "metrics.jsonl")) as fd:
        return [json.loads(line) for line in fd]


class _Runs(dict):
    """{(pkg, arm): (smoe, out_dir)}: an arm runs through both CLIs when a
    test first reads it, so each case pays for the arms it reads."""

    def __init__(self, path, root):
        super().__init__()
        self.path, self.root = path, root

    def __missing__(self, key):
        arm = key[1]
        for pkg, main, extra in (("jax", jfit.main, []),
                                 ("torch", tfit.main, ["--device", "cpu"])):
            d = str(self.root / f"{pkg}_{arm}")
            smoe = main(["-i", self.path, "-r", d] + BASE + ARMS[arm][0]
                        + extra)
            self[pkg, arm] = (smoe, d)
        return self[key]


@pytest.fixture(scope="module")
def runs(png):
    """Every arm through both CLIs, once each (`_Runs`)."""
    return _Runs(*png)


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_metrics_track_jax(runs, arm):
    _, n_cmp, rtol = ARMS[arm]
    j, t = (_metrics(runs[pkg, arm][1]) for pkg in ("jax", "torch"))
    assert [r["iter"] for r in t] == [r["iter"] for r in j]
    assert [r["num_kernels"] for r in t] == [r["num_kernels"] for r in j]
    n = len(j) if n_cmp is None else n_cmp
    np.testing.assert_allclose([r["mse"] for r in t[:n]],
                               [r["mse"] for r in j[:n]], rtol=rtol)
    if arm == "ls":
        # both fits improve on the state right after the solve
        for rows in (j, t):
            assert min(r["mse"] for r in rows[1:]) < rows[0]["mse"]
    if arm == "lsrs":
        # two train calls: the refreshed 6 sweeps, then 6 without
        assert [r["iter"] for r in t] == [0, 2, 4, 6, 6, 8, 10, 12]
    names = set(os.listdir(runs["torch", arm][1]))
    assert {"metrics.jsonl", "params", "reconstructions", "checkpoints",
            "params_best.pkl", "params_last.pkl"} <= names
    assert ("model_best.smoe" in names) == (arm in ("ls", "qm3",
                                                    "qm3_14bit"))


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_cli_writes_jax_plot_files(runs, arm):
    """The same file names as the JAX CLI: loss.png and an iter_{n}.png
    panel per validation, inc_{n}.png per insertion under -is; the last
    panel PNG at the renderer's size (four 256-pixel tiles, a title line
    and a caption line)."""
    from smoe_tpu_torch.diag import render
    from smoe_tpu_torch.io.images import read_png
    j, t = (set(os.listdir(runs[pkg, arm][1])) for pkg in ("jax", "torch"))
    assert t == j
    d = runs["torch", arm][1]
    iters = sorted({r["iter"] for r in _metrics(d)})
    plots = {n for n in t if n.endswith(".png")}
    incs = {n for n in plots if n.startswith("inc_")}
    assert len(incs) == (2 if arm == "inc" else 0)
    assert plots == {"loss.png"} | {f"iter_{i}.png" for i in iters} | incs
    out = read_png(os.path.join(d, f"iter_{iters[-1]}.png"))
    assert out.shape == (2 * render.PAD + 2 * render.LINE_H + 256,
                         4 * (256 + 2 * render.PAD), 3)


def test_inc_arm_grows_the_kernel_count(runs):
    js, ts = runs["jax", "inc"][0], runs["torch", "inc"][0]
    assert ts.kernel_count == js.kernel_count == 16 + 2 * 16
    assert ts.cfg.capacity == js.cfg.capacity == 2 * 16 + 2 * 16
    assert int(ts.kernel_lists.shape[1]) == ts.cfg.capacity


@pytest.mark.parametrize("arm", ["ls", "qm3"])
def test_jax_params_best_gives_identical_model_best(runs, arm, tmp_path):
    """JAX's params_best.pkl through the port's quantizer and bitstream
    writer gives JAX's model_best.smoe byte for byte."""
    import dataclasses
    from smoe_tpu_torch.codec.container import load_params
    from smoe_tpu_torch.config import SmoeConfig
    js, d = runs["jax", arm]
    cfg = SmoeConfig(**{f.name: getattr(js.cfg, f.name)
                        for f in dataclasses.fields(SmoeConfig)})
    best = load_params(os.path.join(d, "params_best.pkl"))
    assert np.all(best["pis"] > 0)     # nothing reduced away
    out = str(tmp_path / "model_best.smoe")
    tfit.write_model(out, best, cfg, js.image.shape)
    with open(out, "rb") as a, \
            open(os.path.join(d, "model_best.smoe"), "rb") as b:
        assert a.read() == b.read()


def test_resume_only_reconstruction_matches(png, tmp_path):
    """-c checkpoint -orfc 1 in both CLIs, each from the checkpoint its own
    100-sweep fit wrote: each reconstruction equals the one its fit logged
    at iteration 100 within 1 LSB (the pis are renormalised on restore),
    and the two packages' PSNRs agree within 0.1 dB (100 sweeps through
    the pis quantizer part their trajectories by a few LSB)."""
    from smoe_tpu_torch.io.images import read_image
    path, _ = png
    orig = np.round(read_image(path)[0] * 255)
    psnr = {}
    for pkg, main, extra in (("jax", jfit.main, []),
                             ("torch", tfit.main, ["--device", "cpu"])):
        d = str(tmp_path / f"{pkg}_fit")
        main(["-i", path, "-r", d, "-n", "100", "-v", "100"] + BASE + extra)
        ck = os.path.join(d, "checkpoints", "100.pkl")
        r = str(tmp_path / f"{pkg}_rec")
        main(["-i", path, "-r", r, "-c", ck, "-orfc", "1"] + BASE + extra)
        rec, _, _ = read_image(os.path.join(r, "reconstruction.png"))
        logged, _, _ = read_image(os.path.join(d, "reconstructions",
                                               "100.png"))
        assert np.abs(np.round(rec * 255) - np.round(logged * 255)).max() <= 1
        mse = np.mean((np.round(rec * 255) - orig) ** 2)
        psnr[pkg] = 10 * np.log10(255 ** 2 / mse)
    assert abs(psnr["torch"] - psnr["jax"]) <= 0.1, psnr


def test_video_input_and_cuda_without_a_gpu_are_refused(png, tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tfit.main(["-i", png[0], "-r", str(tmp_path)])


def test_parser_matches_jax():
    """Every JAX flag exists in the port's parser with its default."""
    jp, tp = jfit.build_parser(), tfit.build_parser()
    jd = {a.dest: a.default for a in jp._actions}
    td = {a.dest: a.default for a in tp._actions}
    assert set(jd) <= set(td)
    assert {k: td[k] for k in jd} == jd
    assert td["device"] == "cuda"


# ---------------- video: the reseed loop ----------------

@pytest.fixture(scope="module")
def video_runs(tmp_path_factory):
    """tests/test_video.py's toy clip as an .npz bundle through both CLIs
    (-k 3 3 2 -n 6 -v 3 -ri 2 -qm 1 -iukl 1 -lsinit kernel): the initial
    fit, then two time-slab reseeds with an LS refit and a retrain each,
    the last retrain five times as long."""
    root = tmp_path_factory.mktemp("fitcli_video")
    rng = np.random.default_rng(0)
    base = rng.uniform(0.2, 0.8, (12, 12, 3)).astype(np.float32)
    vid = np.stack([np.roll(base, i, axis=1) for i in range(4)], axis=0)
    aff = np.zeros((4, 2, 3), np.float32)
    aff[:, 0, 0] = aff[:, 1, 1] = 1.0
    aff[:, 0, 2] = -np.arange(4)
    clip = str(root / "clip.npz")
    np.savez(clip, imgs=np.uint8(np.round(vid * 255)), affines=aff)
    flags = ["-k", "3", "3", "2", "-n", "6", "-v", "3", "-ri", "2", "-qm",
             "1", "-iukl", "1", "-lsinit", "kernel"]
    out = {}
    for pkg, main, extra in (("jax", jfit.main, []),
                             ("torch", tfit.main, ["--device", "cpu"])):
        d = str(root / pkg)
        out[pkg] = (main(["-i", clip, "-r", d] + flags + extra), d)
    return out


def test_video_reseed_loop_tracks_jax(video_runs, capsys):
    """The same validations, the same live kernel counts after each
    reseed (18 motion-plane kernels, +9 per slab), the same rows alive at
    the end; the mse within 5e-3 over the initial fit (after the exact LS
    solve Adam's first, sign-like steps follow rounding noise) and 5 %
    after the reseeds (the error-proportional draw sees two
    reconstructions a few quantizer steps apart, so some new kernels sit
    a pixel apart)."""
    (js, jd), (ts, td) = video_runs["jax"], video_runs["torch"]
    j, t = _metrics(jd), _metrics(td)
    assert [r["iter"] for r in t] == [r["iter"] for r in j]
    assert [r["iter"] for r in t][-1] == 6 + 2 + 10
    assert [r["num_kernels"] for r in t] == [r["num_kernels"] for r in j]
    assert t[0]["num_kernels"] == 18 and t[-1]["num_kernels"] == 36
    n0 = sum(r["iter"] <= 6 for r in j)
    np.testing.assert_allclose([r["mse"] for r in t[:n0]],
                               [r["mse"] for r in j[:n0]], rtol=5e-3)
    np.testing.assert_allclose([r["mse"] for r in t[n0:]],
                               [r["mse"] for r in j[n0:]], rtol=5e-2)
    np.testing.assert_array_equal(ts.params.pis.detach().numpy() > 0,
                                  np.asarray(js.params.pis) > 0)
    assert ts.num_2d_kernels == js.num_2d_kernels == 18
    # the pis learning rate x 10 for the refits
    assert ts.opt_cfg.lr_div == js.opt_cfg.lr_div == 10.0
    names = set(os.listdir(td))
    assert {"model_best.smoe", "model_last.smoe", "params_best.pkl"} <= names


def test_video_model_best_is_byte_identical_from_jax_params(video_runs,
                                                            tmp_path):
    """JAX's params_best.pkl (motion rows and mask included) through the
    port's quantizer and writer gives JAX's model_best.smoe byte for
    byte, and both packages decode it within 1 LSB."""
    import dataclasses
    from smoe_tpu.codec.serve import decode_bitstream as jdec
    from smoe_tpu_torch.codec.container import load_model
    from smoe_tpu_torch.codec.serve import decode_bitstream as tdec
    from smoe_tpu_torch.config import SmoeConfig
    js, d = video_runs["jax"]
    cfg = SmoeConfig(**{f.name: getattr(js.cfg, f.name)
                        for f in dataclasses.fields(SmoeConfig)})
    cp = load_model(os.path.join(d, "params_best.pkl"))
    assert "h13" in cp["params"] and cp["model_mask"] is not None
    assert np.all(cp["params"]["pis"] > 0)     # nothing reduced away
    out = str(tmp_path / "model_best.smoe")
    tfit.write_model(out, cp["params"], cfg, js.image.shape,
                     model_mask=cp["model_mask"])
    ref = os.path.join(d, "model_best.smoe")
    with open(out, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    lsb = np.abs(np.round(tdec(ref, device="cpu") * 255)
                 - np.round(np.asarray(jdec(ref)) * 255))
    assert lsb.max() <= 1 and np.mean(lsb == 0) >= 0.99


def test_video_without_in_graph_lists_warns(tmp_path, capsys):
    rng = np.random.default_rng(1)
    clip = str(tmp_path / "clip.npz")
    np.savez(clip, imgs=rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8),
             affines=np.tile(np.eye(2, 3, dtype=np.float32), (2, 1, 1)))
    tfit.main(["-i", clip, "-r", str(tmp_path / "out"), "-k", "2", "2", "1",
               "-n", "0", "--device", "cpu"])
    assert "-iukl 1 is strongly recommended" in capsys.readouterr().out
