"""The port's tests run one torch thread a process (tests/torch_cpu.py):
every tests/test_torch_*.py imports the helper, and importing it leaves
torch at one thread in the importing process and in what that process
spawns."""

import glob
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
from torch_cpu import threads  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
IMPORTS = re.compile(r"^(import torch_cpu\b|from torch_cpu import )", re.M)

_CHILD = """
import os, subprocess, sys
import torch
import torch_cpu
print(torch.get_num_threads(), os.environ["OMP_NUM_THREADS"])
print(subprocess.run([sys.executable, "-c",
                      "import torch; print(torch.get_num_threads())"],
                     capture_output=True, text=True, check=True).stdout)
"""


def test_every_port_test_imports_the_one_thread_helper():
    files = sorted(glob.glob(os.path.join(HERE, "test_torch_*.py")))
    assert len(files) > 40
    missing = [os.path.basename(f) for f in files
               if not IMPORTS.search(open(f).read())]
    assert not missing, missing
    assert torch.get_num_threads() == 1
    with threads(3):
        assert torch.get_num_threads() == 3
        assert os.environ["OMP_NUM_THREADS"] == "3"
    assert torch.get_num_threads() == 1
    assert os.environ["OMP_NUM_THREADS"] == "1"
    # a fresh interpreter with torch's default count, and its child
    env = {k: v for k, v in os.environ.items() if k != "OMP_NUM_THREADS"}
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=HERE, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1", "1", "1"], out.stdout
