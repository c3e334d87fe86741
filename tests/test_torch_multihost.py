"""PyTorch port: parallel/multihost.py and multi-process training
(tests/test_multihost.py and tests/test_multihost_e2e.py on the port).

The single-process cases run here; the fleets run as spawned gloo worlds
(tests/torch_worlds.py:fleet): 8 blocks of 8 x 16 over the 'b' axis of 2
ranks, a ('b', 'k') = (2, 2) fleet, and resumes of the 2-rank checkpoint
on 2, 1 and 4 ranks.  Every rank's losses must be bit-identical, rank 0
alone writes the checkpoint, a resume carries the iteration count and
improves on the checkpointed fit, and resumes on different fleet shapes
agree to rtol 2e-3 (tests/test_multihost_e2e.py:194-197)."""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401

from smoe_tpu_torch.fit.trainer import Smoe  # noqa: E402
from smoe_tpu_torch.parallel import multihost  # noqa: E402
from smoe_tpu_torch.parallel.launch import run_world  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FLEET = os.path.join(HERE, "torch_worlds.py")


def test_initialize_noop_single_process():
    assert multihost.initialize() is False
    assert multihost.initialize(num_processes=1) is False
    assert not torch.distributed.is_initialized()


def test_primary_single_process():
    assert multihost.primary() is True


class FakeSmoe:
    def __init__(self):
        self.saved = []

    def checkpoint(self, path):
        self.saved.append(path)


def _as_rank(monkeypatch, rank):
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(multihost.dist, "get_rank", lambda: rank)


def test_save_checkpoint_ownership(tmp_path, monkeypatch):
    s = FakeSmoe()
    p = str(tmp_path / "ck.pkl")
    assert multihost.save_checkpoint(s, p) is True
    assert s.saved == [p]
    _as_rank(monkeypatch, 1)          # a non-zero rank must not write
    assert multihost.primary() is False
    assert multihost.save_checkpoint(s, p) is False
    assert s.saved == [p]
    wrote = []
    assert multihost.save_model_primary(lambda q: wrote.append(q), 1) is False
    assert wrote == []


def test_cli_flags_plumbed(monkeypatch, tmp_path):
    """--coordinator_address / --num_processes / --process_id reach
    multihost.initialize, with the run's device."""
    calls = {}

    def fake_init(coordinator_address=None, num_processes=None,
                  process_id=None, device="cuda", **kw):
        calls.update(addr=coordinator_address, n=num_processes,
                     pid=process_id, device=device)
        return False

    monkeypatch.setattr(multihost, "initialize", fake_init)
    from smoe_tpu_torch.cli.fit import main
    from smoe_tpu_torch.io.images import write_image
    img = np.random.default_rng(0).uniform(0, 1, (16, 16, 3))
    ip = write_image(img.astype(np.float32), str(tmp_path / "t"), 2)
    main(["-i", ip, "-r", str(tmp_path / "out"), "-n", "1", "-v", "1",
          "-k", "2", "--coordinator_address", "host0:1234",
          "--num_processes", "2", "--process_id", "0", "--device", "cpu"])
    assert calls == {"addr": "host0:1234", "n": 2, "pid": 0,
                     "device": "cpu"}
    assert os.path.exists(str(tmp_path / "out" / "params_last.pkl"))


def test_logger_skips_on_non_primary(tmp_path, monkeypatch):
    from smoe_tpu_torch.diag.log import JsonlLogger, ModelLogger
    _as_rank(monkeypatch, 1)
    lg = ModelLogger(str(tmp_path / "lg"))

    class Fake:
        iter = 7
    lg.log(Fake())    # must return before touching the fake's details
    JsonlLogger(str(tmp_path / "lg" / "m.jsonl")).log(Fake())
    assert os.listdir(str(tmp_path / "lg" / "params")) == []
    assert not os.path.exists(str(tmp_path / "lg" / "m.jsonl"))


def test_checkpoint_resume_deterministic(tmp_path):
    """Every process restores the same pickle: a resumed fit equals the
    uninterrupted one bit for bit."""
    y, x = np.mgrid[0:16, 0:16] / 15.0
    img = np.stack([.5 + .3 * np.sin(5 * x), .5 + .3 * np.cos(4 * y),
                    .4 + .2 * np.sin(3 * (x + y))], -1).astype(np.float32)
    a = Smoe(img, kernels_per_dim=[3], device="cpu")
    a.set_optimizer()
    a.run_batched_chunk(6)
    ck = str(tmp_path / "state.pkl")
    a.checkpoint(ck)
    a.run_batched_chunk(6)
    b = Smoe(img, kernels_per_dim=[3], device="cpu")
    b.set_optimizer()
    b.restore(ck)
    b.run_batched_chunk(6)
    pa, pb = a.get_params(), b.get_params()
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """The first fleets, then three resumes of the 2-rank checkpoint, each
    pair of worlds at once."""
    d = {n: str(tmp_path_factory.mktemp(n)) for n in
         ("run1", "bk", "run2", "runa", "runb")}
    with ThreadPoolExecutor(3) as ex:
        first = ex.submit(run_world, f"{FLEET}:fleet", 2, d["run1"],
                          out_dir=d["run1"], device="cpu")
        bk = ex.submit(run_world, f"{FLEET}:fleet_bk", 4, d["bk"],
                       out_dir=d["bk"], device="cpu")
        run1 = first.result()
        ck = os.path.join(d["run1"], "ckpt_0.pkl")
        resumed = {n: ex.submit(run_world, f"{FLEET}:fleet", w, d[name],
                                out_dir=d[name], resume_from=ck,
                                device="cpu")
                   for n, w, name in (("run2", 2, "run2"),
                                      ("a", 1, "runa"), ("b", 4, "runb"))}
        out = {"run1": run1, "bk": bk.result(), "dirs": d}
        out.update({n: f.result() for n, f in resumed.items()})
    return out


def test_two_process_lockstep_training_and_resume(fleets):
    r, d = fleets["run1"], fleets["dirs"]["run1"]
    assert r[0]["mesh_b"] == r[1]["mesh_b"] == 2
    assert r[0]["loss"] == r[1]["loss"] and np.isfinite(r[0]["loss"])
    assert r[0]["primary"] and not r[1]["primary"]
    assert r[0]["wrote_checkpoint"] and not r[1]["wrote_checkpoint"]
    assert os.path.exists(os.path.join(d, "ckpt_0.pkl"))
    assert not os.path.exists(os.path.join(d, "ckpt_1.pkl"))
    # a fresh fleet restores rank 0's checkpoint and goes on in lockstep
    s = fleets["run2"]
    assert s[0]["loss"] == s[1]["loss"]
    assert s[0]["iter"] == r[0]["iter"] + 2
    assert s[0]["loss"] < r[0]["loss"]


def test_two_process_bk_mesh_lockstep(fleets):
    r = [x["fleet"] for x in fleets["bk"]]
    assert r[0]["mesh_b"] == 2               # 2 'b' rows x 2 'k' columns
    assert all(x["loss"] == r[0]["loss"] for x in r)
    assert np.isfinite(r[0]["loss"])
    assert [x["wrote_checkpoint"] for x in r] == [True, False, False, False]


def test_elastic_resume_different_fleet_shape(fleets):
    """The 2-rank checkpoint resumed on 1 and on 4 ranks (8 blocks divide
    both): the same trajectory to the reduction order's noise."""
    base = fleets["run1"][0]
    a, b = fleets["a"][0], fleets["b"][0]
    assert (a["mesh_b"], b["mesh_b"]) == (1, 4)
    for r in (a, b):
        assert r["iter"] == base["iter"] + 2
        assert np.isfinite(r["loss"]) and r["loss"] < base["loss"]
    assert all(x["loss"] == b["loss"] for x in fleets["b"])
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=2e-3)


def test_non_dividing_fleet_raises(fleets):
    """Six blocks over a 4-way 'b' axis.  In one process JAX shrinks the
    axis to 3 of its 4 devices (tests/test_parallel.py:263-287); with a
    process a rank that shrink would orphan rank 3, so the port raises
    JAX's multi-process ValueError (ROADMAP.md Queue 3)."""
    for r in fleets["bk"]:
        msg = r["non_dividing"]
        assert msg is not None and "orphan processes [3]" in msg, msg


def test_workers_import_no_jax(fleets):
    for name in ("run1", "run2", "a", "b"):
        assert not any(r["jax_loaded"] for r in fleets[name])
    assert not any(r["fleet"]["jax_loaded"] for r in fleets["bk"])
