"""PyTorch port: the bench modules (smoe_tpu_torch/bench/) and their
inputs (apps/content.py) against the JAX package's bench.py and
scripts/bench_*.py, both on the CPU at cut sizes.

Each JAX script runs in-process with its argv set and its output captured
(a fixed-size script with its build function monkeypatched to return a cut
input); the port's module runs with the same arguments, the same input and
--device cpu.  Both print the same JSON keys, apart from the renames the
port makes (`tpu_` -> `cpu_` in a metric name, `tunnel_rt_ms` ->
`device_rt_ms`) and the card's fields it adds (`card`, `power_limit_w`),
and their values agree:
  * strings, flags and integers (kernel counts, blocks, iterations, bits
    where the file is bit-identical) exactly;
  * a PSNR (a key ending in "db", or "value" / "psnr_*" where it is one)
    within DB_TOL = 0.1 dB;
  * a rate (a key with "bits" or "bpp") within RATE_RTOL = 1 % relative;
  * a time, a rate of work and anything derived from one by key only.
The build functions are bit-identical to the scripts'."""

import ast
import io
import json
import os
import runpy
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from smoe_tpu_torch.apps import content  # noqa: E402
from smoe_tpu_torch.bench import (common, decode, fit_1080p,  # noqa: E402
                                  fit_4k, flagship, lf, video, video_quality)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
DB_TOL, RATE_RTOL = 0.1, 1e-2
# keys read from a clock (or a rate or share derived from one), or text
# that names the platform: compared by key only
TIMED = {"value", "vs_baseline", "wallclock_to_32db_median_s",
         "wallclock_runs_s", "wallclock_to_32db_lsinit_s", "lsinit_runs_s",
         "tunnel_rt_ms", "wallclock_compute_s", "cpu_s_per_iter",
         "pixel_kernel_evals_per_sec_per_chip", "mfu_pct", "mfu_note",
         "phases_ms", "fwd_frac_of_step", "bwd_frac_of_step",
         "opt_frac_of_step", "chunk_ms", "compile_s", "megapixels_per_s",
         "full_frame_ms", "ms_per_frame", "fit_wallclock_s", "decode_s",
         "encode_wallclock_s", "workdir"}
RENAMED = {"tunnel_rt_ms": "device_rt_ms"}
CARD = {"card": "cpu", "power_limit_w": None}
# the build functions before a test monkeypatches them
_BUILD_IMAGE, _BUILD_VIDEO = content.build_image, content.build_video
_BUILD_1080P, _BUILD_4K = content.build_1080p, content.build_4k


def run_script(name, argv, monkeypatch, patch=None):
    """scripts/<name>.py (or the root bench.py) run as __main__ with `argv`
    after `patch()`: its stdout."""
    monkeypatch.syspath_prepend(ROOT)
    monkeypatch.syspath_prepend(SCRIPTS)
    if patch is not None:
        patch()
    path = os.path.join(ROOT if name == "bench" else SCRIPTS, name + ".py")
    monkeypatch.setattr(sys, "argv", [name + ".py"] + list(argv))
    buf = io.StringIO()
    with redirect_stdout(buf):
        runpy.run_path(path, run_name="__main__")
    return buf.getvalue()


def load_script(name, monkeypatch):
    """scripts/<name>.py imported as a module (its main not run)."""
    monkeypatch.syspath_prepend(ROOT)
    monkeypatch.syspath_prepend(SCRIPTS)
    return runpy.run_path(os.path.join(SCRIPTS, name + ".py"),
                          run_name=name)


def json_lines(out):
    return [json.loads(x) for x in out.strip().splitlines()
            if x.startswith("{")]


def run_port(main, argv):
    """The port's main(argv): its printed JSON lines (the last alone where
    it returns one dict), checked equal to what it returns."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        ret = main(list(argv))
    lines = json_lines(buf.getvalue())
    ret = json.loads(json.dumps(ret))
    if isinstance(ret, dict):
        assert lines[-1] == ret
        return ret
    assert lines[-len(ret):] == ret
    return ret


def assert_close(t, j, key="", timed=TIMED, db_keys=()):
    """The port's value t against JAX's j (module docstring)."""
    if key in timed:
        assert type(t) is type(j) or {type(t), type(j)} <= {int, float}, key
    elif isinstance(j, dict):
        extra = {k: t[k] for k in t if k not in j and k not in
                 RENAMED.values()}
        if key == "":
            assert extra == CARD, extra
        assert [RENAMED.get(k, k) for k in j] == [k for k in t
                                                  if k not in extra], key
        for k in j:
            assert_close(t[RENAMED.get(k, k)], j[k], k, timed, db_keys)
    elif isinstance(j, list):
        assert len(t) == len(j), key
        for a, b in zip(t, j):
            assert_close(a, b, key, timed, db_keys)
    elif key == "metric":
        assert t == common.metric(j, "cpu"), (t, j)
    elif key.endswith("db") or key in db_keys:
        assert abs(t - j) <= DB_TOL, (key, t, j)
    elif "bits" in key or "bpp" in key:
        assert abs(t - j) <= RATE_RTOL * abs(j), (key, t, j)
    else:
        assert t == j, (key, t, j)



@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one torch thread: under the suite's xdist workers
    torch's default of a thread a core oversubscribes the CPU, and a fit's
    spinning threads slowed these tests ~10x (measured under -n 4)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# ---------------- the build functions ----------------

def _script_function(path, name):
    """The function `name` of a script, exec'd alone (its module body
    runs a bench)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = [n for n in tree.body if isinstance(n, ast.FunctionDef)
          and n.name == name]
    ns = {"np": np}
    exec(compile(ast.Module(body=fn, type_ignores=[]), path, "exec"), ns)
    return ns[name]


def test_build_1080p_and_4k_are_bit_identical(monkeypatch):
    j1080 = load_script("bench_1080p", monkeypatch)["build_1080p"]
    j4k = _script_function(os.path.join(SCRIPTS, "bench_4k.py"), "build_4k")
    for a, b in ((content.build_1080p(), j1080()),
                 (content.build_4k(), j4k())):
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kw", [{}, {"moving_obj": True},
                                {"h": 48, "w": 64, "t": 3, "shift": 1.5}])
def test_build_video_is_bit_identical(monkeypatch, kw):
    jv, ja = load_script("bench_video", monkeypatch)["build_video"](**kw)
    tv, ta = content.build_video(**kw)
    assert tv.dtype == jv.dtype and tv.tobytes() == jv.tobytes()
    assert ta.tobytes() == ja.tobytes()


@pytest.mark.parametrize("kw", [{}, {"s": 12}, {"views": 9, "s": 20,
                                                "seed": 5}])
def test_build_lf_is_bit_identical(monkeypatch, kw):
    j = load_script("bench_lf", monkeypatch)["build_lf"](**kw)
    t = content.build_lf(**kw)
    assert t.dtype == j.dtype and t.tobytes() == j.tobytes()


# ---------------- common ----------------

def test_metric_names_and_card_fields():
    assert common.metric("tpu_s_per_iter_64x64", "cpu") == \
        "cpu_s_per_iter_64x64"
    assert common.metric("tpu_s_per_iter_64x64", "cuda") == \
        "gpu_s_per_iter_64x64"
    assert common.metric("decode_ms_per_frame_512", "cuda:0") == \
        "decode_ms_per_frame_512"
    assert common.card_fields("cpu") == CARD
    assert common.platform("cuda:1") == "gpu"


@pytest.mark.parametrize("main,argv", [
    (flagship.main, []), (fit_1080p.main, []), (fit_4k.main, []),
    (decode.main, []), (video.main, []), (video_quality.main, []),
    (lf.main, [])])
def test_bench_modules_refuse_cuda_without_a_gpu(monkeypatch, main, argv):
    """The default device is the card; without one a module exits
    non-zero before it builds anything and prints no line."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    with redirect_stdout(buf), pytest.raises(SystemExit,
                                             match="no CUDA device"):
        main(argv)
    assert buf.getvalue() == ""


def test_fit_4k_packed_raises_as_jax():
    with pytest.raises(ValueError, match="packed"):
        fit_4k.main(["800", "2", "--packed", "--device", "cpu"])


# ---------------- the modules against the scripts ----------------

def test_flagship_tracks_bench_py(monkeypatch):
    """bench.py and the port at SMOE_BENCH_SIZE=32: five fits to 32 dB,
    three with the LS init, the phase breakdown and the CPU point."""
    monkeypatch.setenv("SMOE_BENCH_SIZE", "32")
    j = json_lines(run_script("bench", [], monkeypatch))[-1]
    t = run_port(flagship.main, ["--device", "cpu"])
    assert_close(t, j)
    assert t["reached_32db"] and t["metric"] == \
        "cpu_s_per_iter_32x32_rgb_256k"
    assert t["mfu_derivation"]["k_cap"] == 256


def _one_block(real, monkeypatch, module, name="Smoe"):
    """module.<name> (a Smoe class) replaced by one that fits in blocks of
    `block` (set on the returned dict) in place of the caller's batch
    size."""
    cut = {}

    def smoe(img, **kw):
        return real(img, **{**kw, "batch_size": cut["block"]})
    monkeypatch.setattr(module, name, smoe)
    return cut


def test_fit_1080p_tracks_script(monkeypatch):
    """The block recipe (20 + 100 + 4 x 100 sweeps, update_kernel_list
    after each chunk) on the 1080p image taken every 16th pixel (68 x 120),
    fitted as one block (the script's 270 x 480 blocks cut with the
    image), 5 x 5 kernels.  (Two correct fits of this recipe part where it
    oscillates, A's learning rate overshooting after a list refresh: in
    16 blocks, or with fewer kernels, by 0.2-0.9 dB in 520 sweeps.)"""
    import smoe_tpu
    from smoe_tpu_torch.fit import trainer
    img = _BUILD_1080P()[::16, ::16]
    for cut in (_one_block(smoe_tpu.Smoe, monkeypatch, smoe_tpu),
                _one_block(trainer.Smoe, monkeypatch, trainer)):
        cut["block"] = img.shape[:2]
    mod = load_script("bench_1080p", monkeypatch)
    monkeypatch.setattr(sys, "argv", ["bench_1080p.py", "5", "auto"])
    mod["main"].__globals__["build_1080p"] = lambda: img
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod["main"]()
    j = json_lines(buf.getvalue())[-1]
    monkeypatch.setattr(fit_1080p, "build_1080p", lambda: img)
    t = run_port(fit_1080p.main, ["5", "auto", "--device", "cpu"])
    assert_close(t, j, db_keys=("psnr_500_iters",))
    assert t["blocks"] == 1 and t["pixel_kernel_pairs_per_iter"] == \
        68 * 120 * 25


def _run_bench_4k(argv, cut, monkeypatch):
    """scripts/bench_4k.py's module body (its bench) statement by
    statement, with its build_4k replaced by `cut` once defined."""
    path = os.path.join(SCRIPTS, "bench_4k.py")
    monkeypatch.syspath_prepend(ROOT)
    monkeypatch.setattr(sys, "argv", ["bench_4k.py"] + argv)
    with open(path) as f:
        tree = ast.parse(f.read())
    ns = {"__name__": "__main__", "__file__": path}
    buf = io.StringIO()
    with redirect_stdout(buf):
        for node in tree.body:
            exec(compile(ast.Module(body=[node], type_ignores=[]), path,
                         "exec"), ns)
            if isinstance(node, ast.FunctionDef) and node.name == "build_4k":
                ns["build_4k"] = cut
    return json_lines(buf.getvalue())[-1]


def test_fit_4k_tracks_script(monkeypatch):
    """The 4K recipe (20 + 3 x 100 sweeps) on the 4K image taken every
    20th pixel (108 x 192) in the script's 4 x 8 = 32 blocks, cut with the
    image to 27 x 24, 6 x 6 kernels at the script's probe threshold."""
    import smoe_tpu
    from smoe_tpu_torch.fit import trainer
    img = _BUILD_4K()[::20, ::20]
    for cut in (_one_block(smoe_tpu.Smoe, monkeypatch, smoe_tpu),
                _one_block(trainer.Smoe, monkeypatch, trainer)):
        cut["block"] = (27, 24)
    j = _run_bench_4k(["800", "6"], lambda: img, monkeypatch)
    monkeypatch.setattr(fit_4k, "build_4k", lambda: img)
    t = run_port(fit_4k.main, ["800", "6", "--device", "cpu"])
    assert_close(t, j, db_keys=("psnr_300",))
    assert (t["blocks"], t["kernels"], t["thr"]) == (32, 36, 800.0)


def _cut_image(size=512):
    return _BUILD_IMAGE(64)


def _cut_video(moving_obj=False, **kw):
    """The clip cut to 8 x 12 x 4, or 144 x 176 x 4 with the moving
    square (which needs the room)."""
    if moving_obj:
        return _BUILD_VIDEO(h=144, w=176, t=4, moving_obj=True)
    return _BUILD_VIDEO(h=8, w=12, t=4)


def test_decode_tracks_script(monkeypatch):
    """Both sizes' fit, quantize and decode (psnr_db of the decoded
    frame), the windows and the CIF dual-model video on cut inputs: the
    images 64^2, the clip 8 x 12 x 4.  The port times one call of each
    decoder where the script times 50 / 20."""
    import bench as jbench

    def patch():
        import bench_video
        monkeypatch.setattr(jbench, "build_image", _cut_image)
        monkeypatch.setattr(bench_video, "build_video", _cut_video)
    j = json_lines(run_script("bench_decode", [], monkeypatch, patch))
    monkeypatch.setattr(content, "build_image", _cut_image)
    monkeypatch.setattr(content, "build_video", _cut_video)
    monkeypatch.setattr(decode, "N_FRAMES", 1)
    monkeypatch.setattr(decode, "N_VIDEO", 1)
    t = run_port(decode.main, ["--device", "cpu"])
    assert len(t) == len(j) == 5
    for a, b in zip(t, j):
        assert_close(a, b)
    assert [x["kernels"] for x in t[::2]] == [256, 576, 576]


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


VQ_ARGS = ["--k", "3", "--n", "10", "--ri", "5", "--val", "5", "--auto"]


def test_video_quality_tracks_script(monkeypatch, tmp_path):
    """The module against the script on the cut clip (144 x 176 x 4 with
    the moving square), -k 3 3 4, 10 + 4 x 5 sweeps (25 on the last slab),
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
    packages part by up to 1.1 dB here (the moving-square clip above,
    measured on the CPU)."""
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


def test_lf_tracks_script(monkeypatch):
    """The light-field recipe through the CLIs at --s 12, 3 x 3 x 4 x 4
    kernels, 20 sweeps."""
    args = ["--s", "12", "--n", "20", "--val", "10", "--k", "4", "--kt",
            "3"]
    j = json_lines(run_script("bench_lf", args, monkeypatch))[-1]
    t = run_port(lf.main, args + ["--device", "cpu"])
    assert_close(t, j, db_keys=("value",))
    assert t["views"] == [15, 15] and t["spatial"] == [12, 12]
