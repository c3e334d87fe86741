"""The PyTorch port's applications, bench modules, studies and captured
programs run with jax, smoe_tpu, matplotlib and cv2 refused at import, as
on the card's machine, each in a fresh interpreter
(tests/test_torch_no_jax.py's `_run` and `_BLOCK`)."""

import pytest

pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401

from test_torch_no_jax import _BLOCK, _run  # noqa: E402


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
