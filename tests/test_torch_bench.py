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
The build functions are bit-identical to the scripts'.  The blocked
stills and the video benches have files of their own
(tests/test_torch_bench_blocks.py, tests/test_torch_bench_video.py)."""

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
import torch_cpu  # noqa: E402,F401

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
_BUILD_VIDEO = content.build_video


def run_script(name, argv, monkeypatch, patch=None, cuts=()):
    """scripts/<name>.py (or the root bench.py) run as __main__ with `argv`
    after `patch()`, each (old, new) of `cuts` (a count the script fixes
    in its body) replaced once in its source: its stdout."""
    monkeypatch.syspath_prepend(ROOT)
    monkeypatch.syspath_prepend(SCRIPTS)
    if patch is not None:
        patch()
    path = os.path.join(ROOT if name == "bench" else SCRIPTS, name + ".py")
    monkeypatch.setattr(sys, "argv", [name + ".py"] + list(argv))
    buf = io.StringIO()
    with redirect_stdout(buf):
        if cuts:
            with open(path) as f:
                src = f.read()
            for old, new in cuts:
                assert src.count(old) == 1, old
                src = src.replace(old, new)
            exec(compile(src, path, "exec"),
                 {"__name__": "__main__", "__file__": path})
        else:
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


# ---------------- the modules against the scripts ----------------

def test_flagship_tracks_bench_py(monkeypatch):
    """bench.py and the port at SMOE_BENCH_SIZE=16: five fits to 32 dB,
    three with the LS init, the phase breakdown and the CPU point."""
    monkeypatch.setenv("SMOE_BENCH_SIZE", "16")
    j = json_lines(run_script("bench", [], monkeypatch))[-1]
    t = run_port(flagship.main, ["--device", "cpu"])
    assert_close(t, j)
    assert t["reached_32db"] and t["metric"] == \
        "cpu_s_per_iter_16x16_rgb_256k"
    assert t["mfu_derivation"]["k_cap"] == 256


def _cut_video(moving_obj=False, **kw):
    """The clip cut to 8 x 12 x 4, or 136 x 128 x 4 with the moving
    square (which needs the room: its 56-pixel square reaches row 134 and
    column 123 in the fourth frame)."""
    if moving_obj:
        return _BUILD_VIDEO(h=136, w=128, t=4, moving_obj=True)
    return _BUILD_VIDEO(h=8, w=12, t=4)


# the decode bench's images cut to 32^2 and 48^2 (their 16^2 and 24^2
# kernels kept), each fitted 20 sweeps, and every decoder timed over one
# call: the script's counts as the port's SIZES, N_FRAMES and N_VIDEO
DECODE_SIZES = ((32, 16, 20), (48, 24, 20))
DECODE_CUTS = (("((512, 16, 200), (1024, 24, 200))", repr(DECODE_SIZES)),
               ("n_frames = 50", "n_frames = 1"), ("n = 20\n", "n = 1\n"))


def test_decode_tracks_script(monkeypatch):
    """Both sizes' fit, quantize and decode (psnr_db of the decoded
    frame), the quarter windows and the CIF dual-model video (200 sweeps)
    on cut inputs: the images 32^2 and 48^2 after 20 sweeps, the clip
    8 x 12 x 4.  Both packages time one call of each decoder where the
    script times 50 / 20."""
    def patch():
        import bench_video
        monkeypatch.setattr(bench_video, "build_video", _cut_video)
    j = json_lines(run_script("bench_decode", [], monkeypatch, patch,
                              DECODE_CUTS))
    monkeypatch.setattr(content, "build_video", _cut_video)
    monkeypatch.setattr(decode, "SIZES", DECODE_SIZES)
    monkeypatch.setattr(decode, "N_FRAMES", 1)
    monkeypatch.setattr(decode, "N_VIDEO", 1)
    t = run_port(decode.main, ["--device", "cpu"])
    assert len(t) == len(j) == 5
    for a, b in zip(t, j):
        assert_close(a, b)
    assert [x["kernels"] for x in t[::2]] == [256, 576, 576]


def test_lf_tracks_script(monkeypatch):
    """The light-field recipe through the CLIs at --s 12, 3 x 3 x 4 x 4
    kernels, 20 sweeps."""
    args = ["--s", "12", "--n", "20", "--val", "10", "--k", "4", "--kt",
            "3"]
    j = json_lines(run_script("bench_lf", args, monkeypatch))[-1]
    t = run_port(lf.main, args + ["--device", "cpu"])
    assert_close(t, j, db_keys=("value",))
    assert t["views"] == [15, 15] and t["spatial"] == [12, 12]
