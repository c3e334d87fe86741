"""The port's kernel build (kernels/build.py): a library is rebuilt when
its .cu source or any csrc/*.cuh header is newer than it.  Checked on
temporary files; nvcc is never called."""

import os

import pytest

pytest.importorskip("torch")

from smoe_tpu_torch.kernels import build  # noqa: E402


def _touch(path, t):
    with open(path, "a"):
        pass
    os.utime(path, (t, t))


@pytest.fixture
def tree(tmp_path):
    src_dir = tmp_path / "csrc"
    src_dir.mkdir()
    src = str(src_dir / "k.cu")
    hdr = str(src_dir / "common.cuh")
    so = str(tmp_path / "libk.so")
    _touch(src, 1000)
    _touch(hdr, 1000)
    return str(src_dir), src, hdr, so


@pytest.mark.parametrize("newer,stale", [
    (None, False),          # library newer than source and header
    ("src", True),          # the .cu was edited
    ("hdr", True),          # a header was edited
    ("missing", True),      # never built
])
def test_is_stale(tree, newer, stale):
    src_dir, src, hdr, so = tree
    if newer != "missing":
        _touch(so, 2000)
    if newer == "src":
        _touch(src, 3000)
    elif newer == "hdr":
        _touch(hdr, 3000)
    assert build.is_stale(so, src, src_dir) is stale


def test_other_files_do_not_rebuild(tree):
    src_dir, src, _, so = tree
    _touch(so, 2000)
    _touch(os.path.join(src_dir, "notes.txt"), 3000)
    _touch(os.path.join(src_dir, "other.cu"), 3000)
    assert build.is_stale(so, src, src_dir) is False


def test_every_header_of_the_repo_is_watched():
    """The shared header exists and is among the build's dependencies."""
    hdr = os.path.join(build.SRC_DIR, "gate_expert_common.cuh")
    assert os.path.exists(hdr)
    for name in ("gate_expert_fwd", "gate_expert_bwd", "gate_expert_variants"):
        src = open(os.path.join(build.SRC_DIR, name + ".cu")).read()
        assert '#include "gate_expert_common.cuh"' in src
