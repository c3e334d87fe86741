"""PyTorch port: the blocked still benches (smoe_tpu_torch/bench/fit_1080p.py
and fit_4k.py) against scripts/bench_1080p.py and scripts/bench_4k.py, on
the CPU at cut sizes, as tests/test_torch_bench.py runs the bench modules
and holds their JSON to the scripts'."""

import ast
import io
import os
import sys
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401

from smoe_tpu_torch.apps import content  # noqa: E402
from smoe_tpu_torch.bench import fit_1080p, fit_4k  # noqa: E402

from test_torch_bench import (ROOT, SCRIPTS, assert_close,  # noqa: E402
                              json_lines, load_script, run_port)


_BUILD_1080P, _BUILD_4K = content.build_1080p, content.build_4k


def test_fit_4k_packed_raises_as_jax():
    with pytest.raises(ValueError, match="packed"):
        fit_4k.main(["800", "2", "--packed", "--device", "cpu"])


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
