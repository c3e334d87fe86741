"""The PyTorch port never imports jax: the card it runs on has none.

Each check runs in a fresh interpreter, because this test process has
jax loaded already (tests/conftest.py imports it)."""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """{prelude}
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


# a finder ahead of every other that refuses the packages the card's
# machine lacks: an import of any of them fails at once
_BLOCK = """
import importlib.abc, sys
class _Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "optax", "smoe_tpu",
                                  "matplotlib", "cv2"):
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, _Blocked())
"""


def _run(extra="", prelude=""):
    out = subprocess.run([sys.executable, "-c",
                          _IMPORT_ALL.format(extra=extra, prelude=prelude)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_every_module_imports_without_jax():
    """Every module, the bench modules (smoe_tpu_torch.bench) and the
    studies of apps/ included, imports with jax, smoe_tpu, matplotlib and
    cv2 refused."""
    out = _run(extra="""
assert {"smoe_tpu_torch.bench.flagship", "smoe_tpu_torch.bench.decode",
        "smoe_tpu_torch.apps.exp_a_domain",
        "smoe_tpu_torch.apps.dryrun_tp_bigk", "smoe_tpu_torch.io.jpeg",
        "smoe_tpu_torch.apps.anchor_jpeg", "smoe_tpu_torch.apps.anchor_video",
        "smoe_tpu_torch.apps.anchor_lf"} <= set(names)
""", prelude=_BLOCK)
    assert int(out.split()[-1]) >= 72


def test_jpeg_and_anchor_paths_run_without_jax():
    """The JPEG codec, the upsized content, the three anchors and a .jpg
    through cli.fit, in a process where jax, smoe_tpu, matplotlib and cv2
    are refused at import."""
    extra = """
import contextlib, io, os, shutil, tempfile
import numpy as np
from smoe_tpu_torch.apps import anchor_jpeg, anchor_lf, anchor_video, content
from smoe_tpu_torch.cli import fit
from smoe_tpu_torch.io import jpeg
assert content.hopper_photo().shape == (600, 512, 3)
assert content.build_mri(300).shape == (300, 300, 1)
d = tempfile.mkdtemp()
path = os.path.join(d, "h.jpg")
with open(path, "wb") as f:
    f.write(jpeg.encode(np.uint8(content.build_hopper(32) * 255)[..., ::-1],
                        90))
with contextlib.redirect_stdout(io.StringIO()), \
        contextlib.redirect_stderr(io.StringIO()):
    rows = anchor_jpeg.main(["--family", "dem", "--size", "32", "--device",
                             "cpu"])
    rows += anchor_video.main(["--device", "cpu"])[:1]
    rows += anchor_lf.main(["--s", "8"])[:1]
    s = fit.main(["-i", path, "-r", os.path.join(d, "fit"), "-k", "2", "-n",
                  "2", "-v", "2", "--device", "cpu"])
assert len(rows) == 10 and all(r["bpp"] > 0 for r in rows)
assert s.get_num_pis()[-1][1] == 4
shutil.rmtree(d)
"""
    _run(extra, prelude=_BLOCK)


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
                     tempfile.mkdtemp(), device="cpu", timeout=120)
assert [x["psum_grad"] for x in r] == [2.0, 2.0]
assert not any(x["jax_loaded"] for x in r)
"""
    _run(extra)


def test_plots_and_apps_run_with_jax_matplotlib_and_cv2_blocked():
    """diag.render, diag.plots, the inc peak plot and every apps module
    run a step on the CPU in a process where jax, smoe_tpu, matplotlib and
    cv2 cannot be imported at all."""
    extra = """
import os, tempfile
import numpy as np
from smoe_tpu_torch.apps import (content, demo_denoise, demo_inpaint,
                                 demo_superres, exp_layers, rd_curve, smoke)
from smoe_tpu_torch.diag import plots, render
from smoe_tpu_torch.fit.trainer import Smoe
from smoe_tpu_torch.io.images import read_png, write_png
d = tempfile.mkdtemp()
img = content.build_image(16)
s = Smoe(img, kernels_per_dim=[2], add_kernel_slots=4, device="cpu")
cbs = [plots.ImagePlotter(d).plot,
       plots.LossPlotter(os.path.join(d, "loss.png")).plot,
       plots.DenoisePlotter(img, d).plot]
s.train(2, val_iter=1, callbacks=cbs)
s.reinit_inc(plot_dir=d)
names = sorted(os.listdir(d))
assert {"loss.png", "iter_2.png", "denoise_2.png", "inc_2.png"} <= set(names)
assert read_png(os.path.join(d, "iter_2.png")).ndim == 3
for fam in ("bench", "pink", "mosaic", "text"):
    assert content.build_family(fam, 16).shape == (16, 16, 3)
cpu = ["--device", "cpu"]
smoke.main(cpu)
demo_denoise.main(["--size", "16", "--k", "2", "--n", "2", "--val", "1",
                   "--plot-dir", d] + cpu)
demo_inpaint.main(["--size", "16", "--iters", "2", "--k", "2", "--cpu"])
demo_superres.main(["--iters", "1", "--k", "2"] + cpu)
exp_layers.main(["--size", "16", "--iters", "2", "--k", "2", "--layers",
                 "2"] + cpu)
png = os.path.join(d, "img.png")
write_png(png, np.uint8(np.round(img * 255))[..., ::-1])
rd_curve.main([png, "2", "--prune"] + cpu)
"""
    _run(extra, prelude=_BLOCK)


def test_bench_and_studies_run_with_jax_matplotlib_and_cv2_blocked():
    """The bench modules (bench.video, whose [12, 12, 4] fit is slow on the
    CPU, and the two fixed 1080p / 4K fits aside: they import above) and
    every study of apps/ run through their main on the CPU at cut sizes in
    a process where jax, smoe_tpu, matplotlib and cv2 cannot be
    imported."""
    extra = """
import os, pickle, tempfile
import torch
torch.set_num_threads(1)
from smoe_tpu_torch.apps import (content, dryrun_tp_bigk, exp_a_domain,
                                 exp_layers_video, exp_lsinit,
                                 exp_lsri_quant, exp_recode_matrix)
from smoe_tpu_torch.bench import decode, flagship, lf, video_quality
from smoe_tpu_torch.fit.trainer import Smoe
cpu = ["--device", "cpu"]
os.environ["SMOE_BENCH_SIZE"] = "16"
assert flagship.main(cpu)["metric"] == "cpu_s_per_iter_16x16_rgb_256k"
image, clip = content.build_image, content.build_video
content.build_image = lambda size=512: image(16)
content.build_video = lambda moving_obj=False, **kw: clip(
    h=144 if moving_obj else 8, w=176 if moving_obj else 12, t=4,
    moving_obj=moving_obj)
decode.SIZES, decode.N_FRAMES, decode.N_VIDEO = ((32, 4, 2), (64, 4, 2)), 1, 1
assert len(decode.main(cpu)) == 5
vq = video_quality.main(["--k", "2", "--n", "2", "--ri", "1", "--val", "2",
                         "--static", "--auto"] + cpu)
exp_layers_video.main(["--params", os.path.join(
    vq[0]["workdir"], "out", "params_best.pkl"), "--layers", "2",
    "--static"] + cpu)
wd = lf.main(["--s", "4", "--n", "2", "--val", "2", "--k", "2", "--kt",
              "2"] + cpu)["workdir"]
assert len(exp_recode_matrix.main([wd, "--lf"] + cpu)) == 10
exp_lsinit.main(["--size", "16", "--max", "20"] + cpu)
exp_lsri_quant.main(["--size", "16", "--iters", "10"] + cpu)
s = Smoe(image(16), kernels_per_dim=[4], use_yuv=True, device="cpu")
s.run_batched_chunk(2)
pkl = os.path.join(tempfile.mkdtemp(), "fit.pkl")
with open(pkl, "wb") as f:
    pickle.dump({"params": s.get_params(), "cfg": s.cfg}, f)
exp_a_domain.main([pkl, "--size", "16"] + cpu)
r = dryrun_tp_bigk.main(["--k", "4", "--size", "16", "--nk", "2",
                         "--world", "2"] + cpu)
assert r["per_rank_widths"][1]["pis"] == 8
"""
    _run(extra, prelude=_BLOCK)


def test_programs_and_em_study_run_with_jax_matplotlib_and_cv2_blocked():
    """The buffered evals (light, with the reconstruction, quantized), the
    LS refresh's programs (kernel and coupled mode), the replayed decoder
    and apps/exp_em_refresh run in a process where jax, smoe_tpu,
    matplotlib and cv2 cannot be imported, through the programs' graphed
    control flow (a stand-in graph that runs its function at each
    replay)."""
    extra = """
import torch
torch.set_num_threads(1)
from smoe_tpu_torch.codec import serve
from smoe_tpu_torch.fit import graph, trainer as ttr
class Replaying:
    def __init__(self, fn, pool=None, generators=()):
        self.fn, self.capture_s = fn, 0.0
    def replay(self):
        self.fn()
for mod in (ttr, serve):
    mod.graphed = lambda device: not graph._EAGER[0]
for mod in (ttr, graph):
    mod.warm_up, mod.SweepGraph = (lambda fn: fn()), Replaying
torch.cuda.graph_pool_handle = lambda: None
from smoe_tpu_torch.apps import content, exp_em_refresh
from smoe_tpu_torch.codec.serve import make_decoder, pad_decoded_params
s = ttr.Smoe(content.build_image(16), kernels_per_dim=[4],
             quantization_mode=1, device="cpu")
for _ in range(3):
    s.run_batched(train=False)
    s.run_batched(train=False, update_reconstruction=True)
    s._quantize_now()
    s.run_batched(train=False, update_reconstruction=True,
                  with_quantized_params=True)
    s.ls_init_experts(mode="kernel")
    s.ls_init_experts(mode="coupled")
assert len(s._programs.graphs) == 8, len(s._programs.graphs)
p = pad_decoded_params(s.rparams, 16, 2, 3)
dec = make_decoder((16, 16), 3, s.cfg, 16, device="cpu")
args = [p[n] for n in ("A", "musX", "nu_e", "gamma_e", "pis")]
outs = [dec(*args) for _ in range(3)]
assert all(torch.equal(o, outs[0]) for o in outs)
assert len(dec.programs.graphs) == 1
r = exp_em_refresh.main(["--size", "16", "--max", "40", "--refresh", "20",
                         "--device", "cpu"])
assert r["metric"] == "em_refresh_study" and len(r["em"]["t_chosen"]) == 1
"""
    _run(extra, prelude=_BLOCK)


def test_chip_smoke_refuses_without_a_gpu():
    """chip_smoke.py measures the card or fails: without CUDA it exits
    non-zero and prints no result line."""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_photo_content_builds_without_cv2_or_matplotlib():
    """apps.content builds every family, the photograph's clips (panned,
    with the turning patch) and its light field with cv2 and matplotlib
    unimportable (sys.modules[...] = None), as on the card's machine."""
    prelude = """
import sys
for name in ("cv2", "matplotlib"):
    sys.modules[name] = None
"""
    extra = """
import numpy as np
from smoe_tpu_torch.apps import content
for f in content.FAMILIES:
    img = content.build_family(f, 48)
    assert img.dtype == np.float32 and img.shape[:2] == (48, 48), f
    assert np.isfinite(img).all() and 0 <= img.min() and img.max() <= 1, f
vid, aff = content.build_video(moving_obj=True, texture="hopper", rot=5.0)
assert vid.shape == (288, 352, 8, 3) and np.isfinite(vid).all()
lf = content.build_lf(s=24, texture="hopper")
assert lf.shape == (15, 15, 24, 24, 1) and np.isfinite(lf).all()
assert sys.modules["cv2"] is None and sys.modules["matplotlib"] is None
"""
    _run(extra, prelude)
