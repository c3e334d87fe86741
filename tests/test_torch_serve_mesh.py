"""PyTorch port: the decode's mesh= and the mesh trainer's SSIM and video
paths (tests/test_serve.py::test_decode_bitstream_mesh_multichip,
tests/test_parallel.py's SSIM and motion cases) on the CPU.

The port runs in a spawned gloo world of 2 ranks (tests/torch_worlds.py:
serve_and_variants); JAX in this process on the virtual CPU devices.
The split decode must be bit-identical to the one-process decode, and
within 1 LSB of JAX's mesh decode with >= 99.9 % of the values identical
(the stated JAX-vs-port decode tolerance, tests/test_torch_serve.py).
The SSIM fit over 'b' tracks JAX's mesh fit at rtol 2e-3 over 8 sweeps,
the video fit over 'b' over 6 (its mse bumps at sweep 8, which carries
the packages' rounding differences to ~5e-3); the video fit with trained
motion rows over a (1, 2) ('b', 'k') mesh at tests/test_parallel.py's
bounds for it (step 0 rtol 1e-6, losses rtol 5e-3, motion rtol 1e-2 atol
1e-5)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import torch_worlds as W  # noqa: E402
from smoe_tpu.codec.serve import decode_bitstream as jdecode  # noqa: E402
from smoe_tpu.fit.trainer import Smoe as JSmoe  # noqa: E402
from smoe_tpu_torch.parallel.launch import run_world  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "data", "bench512_k256.smoe")
ROI = ((96, 160), (200, 296))       # 64 x 96 = 6 chunks of 1024 pixels
cpus = jax.devices("cpu")
RTOL = 2e-3


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(f"{os.path.join(HERE, 'torch_worlds.py')}:"
                     "serve_and_variants", 2,
                     str(tmp_path_factory.mktemp("serve")), device="cpu",
                     timeout=120,
                     smoe_path=FIXTURE, roi=[list(r) for r in ROI])


def _mesh(shape):
    n = int(np.prod(shape))
    axes = ("b", "k") if len(shape) == 2 else ("b",)
    return Mesh(np.asarray(cpus[:n]).reshape(shape), axes)


def test_decode_split_is_bit_identical(world):
    for r in world:
        assert r["split"].shape == (64, 96, 3)
        np.testing.assert_array_equal(r["split"], r["one"])
    np.testing.assert_array_equal(world[1]["split"], world[0]["split"])


@pytest.mark.parametrize("ndev", [2, 3])
def test_decode_split_matches_jax_mesh_decode(world, ndev):
    """JAX's mesh decode over 2 and 3 devices (3 pads the 6 chunks to
    chunks x devices) against the port's 2-rank decode."""
    ref = np.asarray(jdecode(FIXTURE, chunk_pixels=1024, roi=ROI,
                             mesh=Mesh(np.asarray(cpus[:ndev]), ("x",))))
    lsb = np.abs(np.round(world[0]["split"] * 255) - np.round(ref * 255))
    assert lsb.max() <= 1 and np.mean(lsb == 0) >= 0.999


def _jax_chunk(s, n):
    s.set_optimizer()
    loss, mse, npi, _ = s.run_batched_chunk(n)
    return s, np.asarray(loss), np.asarray(mse), np.asarray(npi)


def test_mesh_ssim_loss(world):
    t = world[0]["ssim"]
    np.testing.assert_array_equal(world[1]["ssim"]["loss"], t["loss"])
    _, loss, mse, npi = _jax_chunk(JSmoe(
        W.img32(), kernels_per_dim=[4], batch_size=(16, 16), ssim_opt=True,
        mesh=_mesh((2,))), 8)
    np.testing.assert_allclose(t["loss"], loss, rtol=RTOL)
    np.testing.assert_allclose(t["mse"], mse, rtol=RTOL)
    assert np.isfinite(t["loss"]).all() and t["mse"][-1] < t["mse"][0]


def test_mesh_video_motion(world):
    t = world[0]["video"]
    _, loss, mse, npi = _jax_chunk(JSmoe(
        W.vid16(), kernels_per_dim=[3, 3, 2], use_yuv=False,
        batch_size=(8, 8, 4), mesh=_mesh((2,))), W.VIDEO_SWEEPS)
    np.testing.assert_allclose(t["loss"], loss, rtol=RTOL)
    np.testing.assert_allclose(t["mse"], mse, rtol=RTOL)
    np.testing.assert_array_equal(t["num_pi"], npi)
    assert t["mse"][-1] < t["mse"][0]


def test_video_motion_k_axis(world):
    """train_trafo on ('b', 'k'): the motion gradient's per-rank partials
    are psum'd over 'k'."""
    t = world[0]["video_k"]
    np.testing.assert_array_equal(world[1]["video_k"]["motion"], t["motion"])
    js, loss, _, _ = _jax_chunk(JSmoe(
        W.vid16(), kernels_per_dim=[3, 3, 2], use_yuv=False,
        batch_size=(8, 8, 4), train_trafo=True, num_params_model=4,
        mesh=_mesh((1, 2))), W.SWEEPS)
    np.testing.assert_allclose(t["loss"][0], loss[0], rtol=1e-6)
    assert t["loss"][-1] < t["loss"][0]
    np.testing.assert_allclose(t["loss"], loss, rtol=5e-3)
    np.testing.assert_allclose(t["motion"], np.asarray(js.params.motion),
                               rtol=1e-2, atol=1e-5)
