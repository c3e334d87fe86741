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
    assert int(_run().split()[-1]) >= 26


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


def test_trainer_fit_runs_without_jax():
    """A 2-sweep CPU fit through the port's trainer (fused op on its plain
    versions, then a light eval and a quantized eval) loads no jax, optax
    or smoe_tpu either."""
    extra = """
import numpy as np
from bench import build_image
from smoe_tpu_torch.codec.quantize import quantize_params, rescaler
from smoe_tpu_torch.fit.trainer import Smoe
s = Smoe(build_image(32), kernels_per_dim=[4], use_pallas="on",
         device="cpu")
loss, mse, npi, _ = s.run_batched_chunk(2)
assert np.isfinite(mse).all() and mse[-1] < mse[0] and npi[-1] == 16
s.qparams = quantize_params(s.get_params(), s.cfg)
s.rparams = rescaler(s.qparams, s.cfg)
ql, qm, _, _ = s.run_batched(train=False, with_quantized_params=True)
assert np.isfinite(qm)
"""
    _run(extra)


def test_encode_cli_and_variants_run_without_jax():
    """The default automatic encode (--auto-bd 0.05 --prune 0), the pickle
    and .smoe decodes of its outputs, and every K3 mode on CPU tensors,
    in a process where jax is never loaded."""
    extra = """
import os, shutil, tempfile
import numpy as np
import torch
from bench import build_image
from smoe_tpu_torch.cli import decode, reconstruct
from smoe_tpu_torch.codec.container import save_model
from smoe_tpu_torch.fit.trainer import Smoe
from smoe_tpu_torch.io.images import write_png
from smoe_tpu_torch.kernels.gate_expert_variants import (
    VARIANTS, gate_expert_variant)
img = build_image(32)
d = tempfile.mkdtemp()
write_png(os.path.join(d, "img.png"), np.uint8(np.round(img * 255))[..., ::-1])
s = Smoe(img, kernels_per_dim=[4], use_yuv=False, device="cpu")
s.run_batched_chunk(10)
save_model(os.path.join(d, "p.pkl"), s.get_params(), s.cfg)
rec = reconstruct.main(["-i", os.path.join(d, "img.png"), "-p",
                        os.path.join(d, "p.pkl"), "-r", d, "--device", "cpu"])
for name in ("qparams.pkl", "model.smoe"):
    dec = decode.main(["-p", os.path.join(d, name), "-r", d, "--device",
                       "cpu"])
    assert np.abs(dec - rec).max() <= 1.01 / 255, name
phi, q = torch.rand(64, 7), torch.randn(8, 7)
G, pi = torch.randn(8, 9), torch.full((8,), 1 / 8)
for mode in VARIANTS:
    assert torch.isfinite(gate_expert_variant(phi, q, G, pi, mode)).all()
shutil.rmtree(d)
"""
    _run(extra)


def test_video_path_runs_without_jax():
    """The video entry points end to end on the CPU in a process where jax
    is never loaded: an .npz bundle through cli.fit (the motion-compensated
    dual-model fit and its reseed loop), cli.reconstruct (the .smoe with
    its motion rows and mask, the .yuv) and cli.decode; a train_trafo fit;
    the recorded dual-model file."""
    extra = """
import os, shutil, tempfile
import numpy as np
import chip_smoke
from smoe_tpu_torch.cli import decode, fit, reconstruct
from smoe_tpu_torch.codec.serve import decode_bitstream, read_model
from smoe_tpu_torch.fit.trainer import Smoe
vid, aff = chip_smoke.build_video(h=16, w=24, t=4)
d = tempfile.mkdtemp()
clip = os.path.join(d, "clip.npz")
np.savez(clip, imgs=np.uint8(np.round(np.moveaxis(vid, 2, 0) * 255)),
         affines=aff)
s = fit.main(["-i", clip, "-r", os.path.join(d, "fit"), "-k", "3", "3", "2",
              "-n", "4", "-v", "4", "-ri", "2", "-qm", "1", "-iukl", "1",
              "--device", "cpu"])
assert s.model_mask is not None and s.params.motion is not None
assert s.get_num_pis()[-1][1] == 36
rec = reconstruct.main(["-i", clip, "-p", os.path.join(d, "fit",
                        "params_best.pkl"), "-r", os.path.join(d, "enc"),
                        "--device", "cpu"])
assert os.path.getsize(os.path.join(d, "enc", "output.yuv")) == 16 * 24 * 6
_, _, header = read_model(os.path.join(d, "enc", "model.smoe"))
assert header["motion"] is not None and header["model_mask"] is not None
dec = decode.main(["-p", os.path.join(d, "enc", "model.smoe"), "-r",
                   os.path.join(d, "dec"), "--device", "cpu"])
assert dec.shape == vid.shape and np.abs(dec - rec).max() <= 1.01 / 255
t = Smoe(vid, kernels_per_dim=[2, 2, 2], train_trafo=True, device="cpu")
loss, mse, _, _ = t.run_batched_chunk(2)
assert np.isfinite(mse).all()
out = decode_bitstream("tests/data/video_cut.smoe", device="cpu",
                       frames=(1, 2))
assert out.shape == (144, 176, 1, 3) and np.isfinite(out).all()
shutil.rmtree(d)
"""
    _run(extra)


def test_lightfield_and_sv_paths_run_without_jax():
    """The light-field entry points end to end on the CPU in a process where
    jax is never loaded (a .mat through cli.fit with the corner weight,
    cli.reconstruct and cli.decode to .mat), and an SV fit on the shared
    grid under overlap with subsampling."""
    extra = """
import os, shutil, tempfile
import numpy as np
from scipy.io import loadmat, savemat
import chip_smoke
from bench import build_image
from smoe_tpu_torch.cli import decode, fit, reconstruct
from smoe_tpu_torch.fit.trainer import Smoe
lf = chip_smoke.build_lf(s=4)
d = tempfile.mkdtemp()
mat = os.path.join(d, "lf.mat")
savemat(mat, {"LF": lf})
s = fit.main(["-i", mat, "-r", os.path.join(d, "fit"), "-k", "2", "2", "2",
              "2", "-n", "4", "-v", "2", "-qm", "1", "-iukl", "1", "-lfcw",
              "0.1", "--device", "cpu"])
assert s.cfg.dim_domain == 4 and s.bset.train_mask is not None
rec = reconstruct.main(["-i", mat, "-p", os.path.join(d, "fit",
                        "params_best.pkl"), "-r", os.path.join(d, "enc"),
                        "--device", "cpu"])
dec = decode.main(["-p", os.path.join(d, "enc", "model.smoe"), "-r",
                   os.path.join(d, "dec"), "--device", "cpu"])
assert dec.shape == lf.shape and np.abs(dec - rec).max() <= 1.01 / 255
assert loadmat(os.path.join(d, "dec", "output.mat"))["LF"].shape == lf.shape
t = Smoe(build_image(16), kernels_per_dim=[2], train_svs=True,
         sv_shared_grid=True, batch_size=(8, 8), overlap=1, device="cpu")
_, mse, _, _ = t.run_batched_chunk(2)
_, mse2, _, _ = t.run_batched_chunk(2, sampling_percentage=50)
assert np.isfinite(mse).all() and np.isfinite(mse2).all()
shutil.rmtree(d)
"""
    _run(extra)


def test_mesh_paths_run_without_jax():
    """The parallel modules and a 2-rank world through the spawned
    workers' entry module (smoe_tpu_torch.parallel.launch) and
    tests/torch_worlds.py: no jax in the parent or in either worker."""
    extra = """
import tempfile
from smoe_tpu_torch.parallel import compat, launch, multihost, sharded
r = launch.run_world("tests/torch_worlds.py:world_grads_are_exact", 2,
                     tempfile.mkdtemp(), timeout=120)
assert [x["psum_grad"] for x in r] == [2.0, 2.0]
assert not any(x["jax_loaded"] for x in r)
"""
    _run(extra)


def test_chip_smoke_refuses_without_a_gpu():
    """chip_smoke.py measures the card or fails: without CUDA it exits
    non-zero and prints no result line."""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
