"""Record what the JAX fit CLI's headline recipe does against its own
sample-init run, at a size a CPU runs, for the PyTorch port's CLI to be
held against.

    JAX_PLATFORMS=cpu python scripts/make_torch_ls_recipe_fixture.py
    JAX_PLATFORMS=cpu python scripts/make_torch_ls_recipe_fixture.py \
        --size 512 --kernels 16 -o tests/data/ls_recipe512_ref.npz

Two runs of `python -m smoe_tpu.cli.fit` on a PNG of bench.py's synthetic
image at 128 x 128 with `-k 8 -n 500 -v 100 -qm 1 -iukl 1` (~30 s; the
port's CPU test repeats them), or at the bench flagship's 512 x 512 with
`-k 16` (~15 minutes; the card's run is held against it): one with
`-lsinit auto -lsri 100` (the recipe, BASELINE.md:14), one without (the
sample init).  The question it answers: after the least-squares init puts
the recipe far ahead at the first validation, does the sample-init run
catch up with it or pass it by the last one?

Output (committed, under 2 KB each):
    tests/data/ls_recipe_ref.npz, tests/data/ls_recipe512_ref.npz
        size, kernels, iters, val    the cut
        iter                         the validations' iterations
        ls_mse, sample_mse           each run's float mse per validation
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS, VAL = 500, 100
ARMS = {"ls": ["-lsinit", "auto", "-lsri", "100"], "sample": []}


def write_png(path: str, size: int) -> None:
    """bench.py's image at `size` as the PNG both CLIs read."""
    sys.path.insert(0, ROOT)
    from bench import build_image
    from smoe_tpu_torch.io.images import write_image
    write_image(build_image(size), path[:-len(".png")], 2, yuv=True)


def metrics(d: str):
    with open(os.path.join(d, "metrics.jsonl")) as fd:
        return [json.loads(line) for line in fd]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--kernels", type=int, default=8)
    p.add_argument("-o", "--out", default=os.path.join(
        ROOT, "tests", "data", "ls_recipe_ref.npz"))
    a = p.parse_args(argv)
    common = ["-k", str(a.kernels), "-n", str(ITERS), "-v", str(VAL), "-qm",
              "1", "-iukl", "1"]
    sys.path.insert(0, ROOT)

    import jax
    jax.config.update("jax_platforms", "cpu")
    from smoe_tpu.cli import fit

    out = {"size": a.size, "kernels": a.kernels, "iters": ITERS, "val": VAL}
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "img.png")
        write_png(png, a.size)
        for arm, flags in ARMS.items():
            d = os.path.join(tmp, arm)
            fit.main(["-i", png, "-r", d] + common + flags)
            rows = metrics(d)
            out["iter"] = np.asarray([r["iter"] for r in rows])
            out[arm + "_mse"] = np.asarray([r["mse"] for r in rows],
                                           np.float64)
    for arm in ARMS:
        print(arm, "mse per validation:",
              np.array2string(out[arm + "_mse"], precision=4))
    print("sample run below the LS run at the last validation:",
          bool(out["sample_mse"][-1] < out["ls_mse"][-1]))
    np.savez(a.out, **out)
    print(f"wrote {a.out}")


if __name__ == "__main__":
    main()
