"""PyTorch port: the fit CLI's headline recipe against its own sample-init
run, held against what the JAX CLI does (recorded by
scripts/make_torch_ls_recipe_fixture.py).  A file of its own so that the
test runner can give its two 500-sweep CPU fits a worker to themselves."""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_cpu import threads  # noqa: E402

from smoe_tpu_torch.cli import fit as tfit  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _metrics(d):
    with open(os.path.join(d, "metrics.jsonl")) as fd:
        return [json.loads(line) for line in fd]


def test_ls_recipe_against_sample_init_as_recorded_from_jax(tmp_path):
    """tests/data/ls_recipe_ref.npz (scripts/make_torch_ls_recipe_fixture.py)
    holds the JAX CLI's per-validation mse of `-lsinit auto -lsri 100
    -iukl 1` and of the sample-init run at 128 x 128, 64 kernels, 500
    sweeps.  The port's two runs: the first validation of each within 1e-3
    of JAX's (before any chaos), every later one within 15 % (500 sweeps
    through the pis quantizer), and the same order at the end: who is
    ahead after 500 sweeps is the recipe's property, not the package's."""
    root = ROOT
    sys.path.insert(0, os.path.join(root, "scripts"))
    import make_torch_ls_recipe_fixture as fx
    ref = np.load(os.path.join(root, "tests", "data", "ls_recipe_ref.npz"))
    png = str(tmp_path / "img.png")
    fx.write_png(png, int(ref["size"]))
    common = ["-k", str(int(ref["kernels"])), "-n", str(int(ref["iters"])),
              "-v", str(int(ref["val"])), "-qm", "1", "-iukl", "1",
              "--device", "cpu"]
    got = {}
    for arm, flags in fx.ARMS.items():
        d = str(tmp_path / arm)
        # the recorded recipe's 500 sweeps may not be cut: two threads keep
        # its worker under two minutes (the runs sit within 7 % of the
        # record at 1, 2 and 4 threads)
        with threads(2):
            tfit.main(["-i", png, "-r", d] + common + flags)
        rows = _metrics(d)
        assert [r["iter"] for r in rows] == list(ref["iter"])
        got[arm] = np.asarray([r["mse"] for r in rows])
        np.testing.assert_allclose(got[arm][0], ref[arm + "_mse"][0],
                                   rtol=1e-3)
        np.testing.assert_allclose(got[arm], ref[arm + "_mse"], rtol=0.15)
    assert got["ls"][0] < 0.2 * got["sample"][0]
    assert (got["sample"][-1] < got["ls"][-1]) == bool(
        ref["sample_mse"][-1] < ref["ls_mse"][-1])
