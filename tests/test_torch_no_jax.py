"""The PyTorch port never imports jax: the card it runs on has none.

Each check runs in a fresh interpreter, because this test process has
jax loaded already (tests/conftest.py imports it)."""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import smoe_tpu_torch
names = [m.name for m in pkgutil.walk_packages(smoe_tpu_torch.__path__,
                                               "smoe_tpu_torch.")]
for name in names:
    importlib.import_module(name)
{extra}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "smoe_tpu",
                                    "triton"))
assert not bad, bad
print(len(names))
"""


def _run(extra=""):
    out = subprocess.run([sys.executable, "-c",
                          _IMPORT_ALL.format(extra=extra)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_every_module_imports_without_jax():
    assert int(_run().split()[-1]) >= 15


def test_decode_path_runs_without_jax():
    """The serving decode and the smoke script's imports, run end to end
    on the CPU, load no jax either."""
    extra = """
import numpy as np
import chip_smoke
from bench import build_image
from smoe_tpu_torch.codec.serve import decode_bitstream
rec = decode_bitstream("tests/data/bench512_k256.smoe", device="cpu",
                       roi=((0, 64), (0, 64)))
assert rec.shape == (64, 64, 3) and np.isfinite(rec).all()
"""
    _run(extra)
