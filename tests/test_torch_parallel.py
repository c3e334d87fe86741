"""PyTorch port: the mesh paths of parallel/sharded.py and Smoe(mesh=)
against the JAX package's on the CPU.

The JAX side runs in this process on the 8 virtual CPU devices of
tests/conftest.py; the port's runs in spawned gloo worlds of 2 and 4
processes (tests/torch_worlds.py), one module-scoped world each, whose
results the cases below read.  Tolerances: the TP step as
tests/test_parallel.py holds it (one step: loss rtol 1e-5, musX atol 1e-5,
pis atol 1e-6, a_diag atol 1e-4 with the regularizers, QAT 3 nu_e atol
1e-5); the mesh trainer at the port trainer's rtol 2e-3 over 10 sweeps
(tests/test_torch_trainer.py); the ('b', 'k') gradient within 1e-5 of the
one-process gradient (of each field's largest), and the collectives'
gradient rules exactly."""

import functools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import torch_worlds as W  # noqa: E402
from smoe_tpu.config import SmoeConfig as JConfig  # noqa: E402
from smoe_tpu.core.init import init_params as jinit  # noqa: E402
from smoe_tpu.fit.blocks import build_blockset as jblocks  # noqa: E402
from smoe_tpu.fit.trainer import Smoe as JSmoe  # noqa: E402
from smoe_tpu.parallel import sharded as J  # noqa: E402
from smoe_tpu_torch.parallel.launch import run_world  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
WORLDS = os.path.join(HERE, "torch_worlds.py")
cpus = jax.devices("cpu")
RTOL = 2e-3
TP_SHAPES = [(2, 1), (2, 2), (1, 4)]
FIT_SHAPES = [(2, 1), (4, 1), (2, 2)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world size: [each rank's parallel_world result]}; both worlds run
    at once."""
    with ThreadPoolExecutor(2) as ex:
        futs = {n: ex.submit(run_world, f"{WORLDS}:parallel_world", n,
                             str(tmp_path_factory.mktemp(f"world{n}")),
                             timeout=120) for n in (2, 4)}
        return {n: f.result() for n, f in futs.items()}


def _port(worlds, shape, key):
    return worlds[shape[0] * shape[1]][0][key]


@functools.lru_cache(maxsize=None)
def _jax_step(shape, qm):
    """tests/test_parallel.py's setup and JAX's step at one mesh shape."""
    rng = np.random.default_rng(7)
    img = rng.uniform(0.2, 0.8, (16, 16, 1)).astype(np.float32)
    cfg = JConfig(dim_domain=2, num_channels=1, kernels_per_dim=(4, 4),
                  use_yuv=False, use_determinant=True, quantization_mode=qm)
    params = jax.tree_util.tree_map(jnp.asarray, jinit(img, cfg))
    mesh = J.make_mesh(*shape, devices=cpus)
    tx = optax.adam(1e-3)
    return (mesh, tx, params, jblocks(img, cfg, (4, 8)),
            J.make_sharded_train_step(cfg, mesh, tx, block_weight=1 / 8))


def _jax_tp(shape, qm, klists, pis_l1, u_l1):
    mesh, tx, params, bset, step = _jax_step(shape, qm)
    p, coords, targets, kl = J.shard_inputs(mesh, params, bset.coords,
                                            bset.targets, jnp.asarray(klists))
    p2, _, loss, mse = step(p, tx.init(p), coords, targets, kl,
                            jnp.float32(pis_l1), jnp.float32(u_l1))
    return float(loss), float(mse), jax.tree_util.tree_map(np.asarray, p2)


@pytest.mark.parametrize("shape", TP_SHAPES)
def test_tp_step_matches_jax(worlds, shape):
    t = _port(worlds, shape, "tp")[shape]["plain"]
    loss, mse, p = _jax_tp(shape, 0, np.ones((8, 16), bool), 0.0, 0.0)
    np.testing.assert_allclose(t["loss"], loss, rtol=1e-5)
    np.testing.assert_allclose(t["mse"], mse, rtol=1e-5)
    np.testing.assert_allclose(t["params"]["musX"], p.musX, atol=1e-5)
    np.testing.assert_allclose(t["params"]["pis"], p.pis, atol=1e-6)


@pytest.mark.parametrize("shape", TP_SHAPES)
def test_tp_regularizers_and_partial_lists(worlds, shape):
    t = _port(worlds, shape, "tp")[shape]["reg"]
    loss, _, p = _jax_tp(shape, 0, W.partial_lists(), 1e-4, 1e-6)
    np.testing.assert_allclose(t["loss"], loss, rtol=1e-5)
    np.testing.assert_allclose(t["params"]["pis"], p.pis, atol=1e-6)
    np.testing.assert_allclose(t["params"]["a_diag"], p.a_diag, atol=1e-4)


def test_tp_qat3_bounds_global_over_k(worlds):
    t = _port(worlds, (2, 2), "tp")[(2, 2)]["qat3"]
    loss, _, p = _jax_tp((2, 2), 3, np.ones((8, 16), bool), 0.0, 0.0)
    np.testing.assert_allclose(t["loss"], loss, rtol=1e-6)
    np.testing.assert_allclose(t["params"]["nu_e"], p.nu_e, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_fit(shape):
    axes = ("b", "k") if shape[1] > 1 else ("b",)
    devs = np.asarray(cpus[:shape[0] * shape[1]])
    mesh = Mesh(devs.reshape(shape) if shape[1] > 1 else devs, axes)
    s = JSmoe(W.img32(), kernels_per_dim=[4], batch_size=(8, 8), mesh=mesh)
    s.set_optimizer()
    loss, mse, npi, _ = s.run_batched_chunk(W.SWEEPS, **W.REG)
    return s, np.asarray(loss), np.asarray(mse), np.asarray(npi)


@pytest.mark.parametrize("shape", FIT_SHAPES)
def test_mesh_trainer_tracks_jax(worlds, shape):
    """Smoe(mesh=) on 'b' (2 and 4 ranks) and ('b', 'k') (2, 2), 16 blocks
    with kernel lists and both regularizers, against JAX's mesh trainer of
    the same shape; every rank in lockstep."""
    runs = [r["fits"][shape] for r in worlds[shape[0] * shape[1]]]
    for r in runs[1:]:
        np.testing.assert_array_equal(r["loss"], runs[0]["loss"])
        np.testing.assert_array_equal(r["lists"], runs[0]["lists"])
    t = runs[0]
    js, loss, mse, npi = _jax_fit(shape)
    np.testing.assert_allclose(t["loss"][0], loss[0], rtol=1e-6)
    np.testing.assert_allclose(t["loss"], loss, rtol=RTOL)
    np.testing.assert_allclose(t["mse"], mse, rtol=RTOL)
    np.testing.assert_array_equal(t["num_pi"], npi)
    np.testing.assert_array_equal(t["lists"], np.asarray(js.kernel_lists))
    assert not t["lists"].all() and t["mse"][-1] < t["mse"][0]


def test_mesh_eval_and_reconstruction(worlds):
    t = worlds[2][0]["fits"][(2, 1)]
    js, *_ = _jax_fit((2, 1))
    loss, mse, npi, _ = js.run_batched(train=False,
                                       update_reconstruction=True)
    np.testing.assert_allclose(t["eval"][:2], (loss, mse), rtol=RTOL)
    assert t["eval"][2] == npi
    rec = js.get_reconstruction()
    assert t["rec"].shape == rec.shape == W.img32().shape
    assert np.isfinite(t["rec"]).all()
    assert np.abs(t["rec"] - np.asarray(rec)).max() <= 2 / 255
    np.testing.assert_array_equal(worlds[2][1]["fits"][(2, 1)]["rec"],
                                  t["rec"])


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_bk_gradient_matches_one_process(worlds):
    """One sweep's gradients on a (2, 2) mesh (QAT 3, both regularizers)
    against one process's from the same state: an nk-fold psum backward
    or a missing pvary of the denominator breaks this by orders of
    magnitude."""
    g = worlds[4][0]["fits"]["grads"]
    assert g["mesh"]["loss"] == pytest.approx(g["one"]["loss"], rel=1e-6)
    for f, ref in g["one"]["grads"].items():
        assert _rel(g["mesh"]["grads"][f], ref) <= 1e-5, f


def test_bk_motion_gradient(worlds):
    """The video fit's motion gradient, psum'd over 'k' (trainer.py:553-
    559), within 1e-5 of one process's; the kernel fields' within 1e-3:
    on the t = -5 motion plane the maha's products cancel, and the split
    denominator's other summation order moves A's gradient by ~4e-4 of
    its largest in fp32 (~3e-8 in float64)."""
    g = worlds[4][0]["fits"]["grads_motion"]
    assert _rel(g["mesh"]["grads"]["motion"], g["one"]["grads"]["motion"]) \
        <= 1e-5
    for f, ref in g["one"]["grads"].items():
        assert _rel(g["mesh"]["grads"][f], ref) <= 1e-3, f


def test_collective_gradient_rules(worlds):
    """psum's backward is the identity and pvary's an all-reduce, as JAX
    transposes them; torch.distributed.nn's all_reduce would give 4 for
    psum(2x).  The row gather is exact."""
    for r in worlds[2]:
        rules = r["rules"]
        assert rules["psum_grad"] == 2.0 and rules["pvary_grad"] == 3.0
        assert rules["rows"] == [0.0, 1.0] and not rules["jax_loaded"]


def test_fit_many_matches_jax(worlds):
    """Two models over two ranks against JAX's fan-out over two devices,
    8 sweeps: the mses and every parameter at the trainer's rtol 2e-3 (the
    A group's learning rate of base x 1000 carries the packages' float-
    order differences into A); the per-model regularizer weights (none,
    3e-3) as given."""
    params, mses = worlds[2][0]["fits"]["fit_many"]
    jp, jm = J.fit_many(W.fan_images(), JConfig(**W.FAN_CFG), steps=8,
                        mesh=Mesh(np.asarray(cpus[:2]), ("m",)),
                        pis_l1=np.asarray(W.FAN_REG, np.float32))
    np.testing.assert_allclose(mses, jm, rtol=RTOL)
    for f in ("musX", "a_diag", "a_corr", "pis", "nu_e", "gamma_e"):
        np.testing.assert_allclose(getattr(params, f),
                                   np.asarray(getattr(jp, f)), atol=2e-4,
                                   rtol=RTOL, err_msg=f)
    p1 = worlds[2][1]["fits"]["fit_many"][0]
    np.testing.assert_array_equal(p1.pis, params.pis)
