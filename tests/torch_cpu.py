"""One torch thread per port test process, decided here alone.

Every tests/test_torch_*.py imports this module before its first torch
work (tests/test_torch_cpu_threads.py checks that each does).  Importing
it pins torch to one intra-op thread in this process and exports
OMP_NUM_THREADS=1, which the interpreters and worlds the port's tests
spawn inherit.

Why: the suite runs in 6 xdist workers on one host's cores, and torch's
default of a thread a core made each worker's fits spin 8 threads beside
the others and beside XLA's pool.  On an 8-core host the tier-1 command
took 1141.75 s at torch's default and 541.27 s with OMP_NUM_THREADS=1 set
for the whole run; one case run 6 times at once took 28.0-28.4 s each at
the default and 4.1-5.5 s at one thread.

A case that needs another count runs inside `threads(n)`."""

from __future__ import annotations

import contextlib
import os

import torch

os.environ["OMP_NUM_THREADS"] = "1"
torch.set_num_threads(1)


@contextlib.contextmanager
def threads(n: int):
    """torch at n intra-op threads inside the block (and OMP_NUM_THREADS=n
    for what it spawns), the counts before it after it."""
    before = torch.get_num_threads(), os.environ["OMP_NUM_THREADS"]
    torch.set_num_threads(n)
    os.environ["OMP_NUM_THREADS"] = str(n)
    try:
        yield
    finally:
        torch.set_num_threads(before[0])
        os.environ["OMP_NUM_THREADS"] = before[1]
