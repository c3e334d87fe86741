"""The benchmark's CPU tests: its folder and the repository's root on the
path, torch on few threads, and the small sizes the tests run the cells
at (the traffic and the checks as the cells run them; the image, the
kernel count and the blocks cut down)."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

# the fit cells keep their steering's scale (A = 2 (kpd + 1) at the grid
# initialisation; still512's kpd, half of still4k's in 32 blocks), at
# which the TF32 control fails as on the card; calls of fewer sweeps
SMALL = {
    "still512.fit": {
        "config": {"content": {"family": "bench", "size": 64},
                   "kernels_per_dim": 16},
        "traffic": {"sweeps_per_call": 20, "val_iter": 5,
                    "ls_refresh_iter": 5}},
    "still4k.fit": {
        "config": {"content": {"family": "uhd", "height": 108,
                               "width": 192},
                   "kernels_per_dim": 24, "block_shape": [27, 24]},
        "traffic": {"sweeps_per_call": 10, "val_iter": 10}},
    "still4k.decode": {
        "config": {"content": {"family": "uhd", "height": 48, "width": 64},
                   "kernels_per_dim": 6},
        "traffic": {}},
}


@pytest.fixture(autouse=True)
def few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small():
    return {k: {g: dict(v) for g, v in d.items()} for k, d in SMALL.items()}
