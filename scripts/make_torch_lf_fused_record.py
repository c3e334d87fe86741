"""Record the JAX package's FUSED path on the real-texture light field of
BASELINE.md:22 (`scripts/bench_lf.py --texture hopper --s 24 --n 600
--iukl --pmt 100 --pg 5 --lsinit --lsri 100 --cw 0.1`), for the PyTorch
port's kernel path to be held against.

The JAX package turns its fused Pallas kernel on only on a TPU
(`smoe_tpu/core/model.py:resolve_pallas`, "auto"); BASELINE.md's number
is the XLA path's.  Here the recipe's trainer runs with use_pallas="on",
which off a TPU is the kernel in interpret mode, then the automatic encode
of its best params (cli.reconstruct's default) and the serving decode.

    JAX_PLATFORMS=cpu python scripts/make_torch_lf_fused_record.py \
        --paths on off                     # ~12 min: the fused path ~7.5

Output (committed): tests/data/lf_hopper_fused_ref.json, one entry a path
("on": the fused kernel, interpreted; "off": the XLA path), each with
    train_best_db                  the fit's best validation PSNR
    trained_db, all_db, bpp        bench_lf.py's decode of model_best.smoe
    auto_trained_db, auto_all_db,  the automatic encode of params_best.pkl
    auto_bpp                       and its decode
    fit_s                          the fit's wall seconds on this CPU
and the recipe's flags, the sweeps run and the host.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import platform
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--texture", "hopper", "--s", "24", "--iukl", "--pmt", "100",
         "--pg", "5", "--lsinit", "--lsri", "100", "--cw", "0.1"]


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def psnr_pair(dec, orig):
    """(trained-view, all-view) PSNR of a decode, bench_lf.py's metric."""
    from smoe_tpu.fit.blocks import _lf_train_mask
    err2 = (np.asarray(dec, np.float64).reshape(orig.shape) - orig) ** 2
    tm = _lf_train_mask(orig.shape[:2])
    return (float(10 * np.log10(1.0 / err2[tm].mean())),
            float(10 * np.log10(1.0 / err2.mean())))


def run(path_mode: str, sweeps: int) -> dict:
    """bench_lf.py's main with use_pallas=path_mode, then the automatic
    encode of its params_best.pkl and the decode of that file."""
    from scipy.io import loadmat
    from smoe_tpu.cli import reconstruct
    from smoe_tpu.codec.serve import decode_bitstream
    from smoe_tpu.core import model

    resolve = model.resolve_pallas
    model.resolve_pallas = lambda u: resolve(path_mode if u == "auto" else u)
    try:
        bench_lf = _script("bench_lf")
        argv = sys.argv
        sys.argv = ["bench_lf.py", "--n", str(sweeps)] + FLAGS
        out = io.StringIO()
        t0 = time.time()
        try:
            with contextlib.redirect_stdout(out):
                bench_lf.main()
        finally:
            sys.argv = argv
        fit_s = time.time() - t0
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        wd = line["workdir"]
        mat = os.path.join(wd, "lf.mat")
        with contextlib.redirect_stdout(io.StringIO()):
            reconstruct.main(["-i", mat, "-p",
                              os.path.join(wd, "out", "params_best.pkl"),
                              "-r", os.path.join(wd, "enc")])
    finally:
        model.resolve_pallas = resolve
    smoe = os.path.join(wd, "enc", "model.smoe")
    orig = loadmat(mat)["LF"].astype(np.float64)
    auto_tr, auto_all = psnr_pair(decode_bitstream(smoe), orig)
    return {"train_best_db": line["psnr_train_best_db"],
            "trained_db": line["value"], "all_db": line["psnr_all_views_db"],
            "bpp": line["coded_bpp"], "auto_trained_db": round(auto_tr, 2),
            "auto_all_db": round(auto_all, 2),
            "auto_bpp": round(8 * os.path.getsize(smoe)
                              / int(np.prod(orig.shape[:4])), 4),
            "live_kernels": line["live_kernels"], "fit_s": round(fit_s, 1)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=600, help="sweeps (the "
                   "recipe's 600; fewer is a cut, recorded as such)")
    p.add_argument("--paths", nargs="+", default=["on"],
                   choices=["on", "off"])
    p.add_argument("-o", "--out", default=os.path.join(
        ROOT, "tests", "data", "lf_hopper_fused_ref.json"))
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")

    rec = {"recipe": "scripts/bench_lf.py " + " ".join(FLAGS),
           "sweeps": a.n, "host": platform.processor() or platform.machine(),
           "jax": jax.__version__}
    for mode in a.paths:
        rec[mode] = run(mode, a.n)
        print(mode, json.dumps(rec[mode]), flush=True)
    with open(a.out, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print("wrote", a.out)


if __name__ == "__main__":
    main()
