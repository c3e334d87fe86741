"""Record the JAX package at `scripts/bench_lf.py`'s default flags (the
synthetic texture, K = 6 x 6 x 4 x 4, lr 5e-4, no --iukl, no LS) through
both its XLA path and its fused path (Pallas in interpret mode), for the
PyTorch port's run of the same flags on the card to be held against.

The full width (--s 48 --n 2000) takes hours a path on a CPU, so the
record is the cut BASELINE.md:168-169 ran on the CPU: --s 24 --n 600.

    JAX_PLATFORMS=cpu python scripts/make_torch_lf_defaults_record.py  # ~15 min

Output (committed): tests/data/lf_defaults_ref.json, one entry a path
("off": the XLA path; "on": the fused kernel, interpreted) with the keys of
scripts/make_torch_lf_fused_record.py's record, and the flags, the sweeps
and the host.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import platform
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, SWEEPS = 24, 600
FLAGS = ["--s", str(SIZE)]


def _fused_record():
    spec = importlib.util.spec_from_file_location(
        "_lf_fused_record",
        os.path.join(ROOT, "scripts", "make_torch_lf_fused_record.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--paths", nargs="+", default=["off", "on"],
                   choices=["on", "off"])
    p.add_argument("-o", "--out", default=os.path.join(
        ROOT, "tests", "data", "lf_defaults_ref.json"))
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")

    rec = {"recipe": "scripts/bench_lf.py " + " ".join(FLAGS),
           "sweeps": SWEEPS,
           "host": platform.processor() or platform.machine(),
           "jax": jax.__version__}
    run = _fused_record().run
    for mode in a.paths:
        rec[mode] = run(mode, SWEEPS, FLAGS)
        print(mode, json.dumps(rec[mode]), flush=True)
    with open(a.out, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print("wrote", a.out)


if __name__ == "__main__":
    main()
