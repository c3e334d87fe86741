"""Record the JAX package's light-field recipe on a cut light field, for
the PyTorch port's light-field path to be held against where there is no
JAX.

    JAX_PLATFORMS=cpu python scripts/make_torch_lf_fixture.py

The light field is scripts/bench_lf.py's `build_lf(views=15, s=12)` (the
synthetic two-plane scene, grayscale) instead of the published s = 24,
the largest the CPU finishes in about a minute, written as a float32
`.mat` as bench_lf.py writes it.  The flags are bench_lf.py:140-170's for
`--iukl --pmt 100 --pg 5 --lsinit --lsri 100 --cw 0.1` (BASELINE.md's
light-field point): -k 4 4 6 6 -lr 5e-4 -np 0 -qm 1 -iukl 1 -pmt 100
-pg 5 -lsinit kernel -nuanchor 1 -lsri 100 -lfcw 0.1, with -n 20 -v 10.

Outputs (committed, together under 100 KB):
    tests/data/lf_cut_ref.npz
        s, kernels_per_dim          the cut
        val_iter, val_mse           the JAX CLI's validations (metrics.jsonl)
        ls_nu, ls_gamma, ls_mse     the trainer the CLI builds, after its
                                    per-kernel LS init: the experts and the
                                    light eval's mse (the eval train()
                                    starts with)
        loss, mse, num_pi           run_batched_chunk(20) from there, per
                                    sweep (each describes the params before
                                    its sweep's update)
        lists                       the kernel lists after those sweeps
        stride, sample, psnr_db     the JAX decode of lf_cut.smoe, every
                                    `stride`-th pixel of each view as uint8,
                                    and its PSNR over all views
    tests/data/lf_cut.smoe          the CLI's model_best.smoe
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 12
KPD = (4, 4, 6, 6)
FLAGS = ["-k", "4", "4", "6", "6", "-lr", "5e-4", "-np", "0", "-qm", "1",
         "-iukl", "1", "-pmt", "100", "-pg", "5", "-lsinit", "kernel",
         "-nuanchor", "1", "-lsri", "100", "-lfcw", "0.1"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-n", "--iters", type=int, default=20)
    p.add_argument("-o", "--out", default=os.path.join(
        ROOT, "tests", "data", "lf_cut"))
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))

    import jax
    jax.config.update("jax_platforms", "cpu")
    from scipy.io import savemat

    from bench_lf import build_lf
    from smoe_tpu import Smoe
    from smoe_tpu.cli import fit as jfit
    from smoe_tpu.codec.serve import decode_bitstream
    from smoe_tpu.config import OptConfig
    from smoe_tpu.core.losses import psnr_from_mse
    from smoe_tpu.io.images import read_image

    lf = build_lf(views=15, s=S)
    tmp = tempfile.mkdtemp()
    try:
        mat = os.path.join(tmp, "lf.mat")
        savemat(mat, {"LF": lf})
        res = os.path.join(tmp, "fit")
        t0 = time.time()
        cli = jfit.main(["-i", mat, "-r", res, "-n", str(a.iters), "-v",
                         str(a.iters // 2)] + FLAGS)
        print(f"cli.fit: {time.time() - t0:.1f} s")
        with open(os.path.join(res, "metrics.jsonl")) as fd:
            rows = [json.loads(line) for line in fd]
        shutil.copyfile(os.path.join(res, "model_best.smoe"),
                        a.out + ".smoe")

        orig, _, _ = read_image(mat, use_yuv=True)
        s = Smoe(orig, kernels_per_dim=list(KPD),
                 opt_cfg=OptConfig(base_lr=5e-4), normalize_pis=False,
                 quantization_mode=1, in_graph_ukl=True,
                 probe_maha_threshold=100.0, probe_grid=5, nu_anchor=True,
                 lf_corner_weight=0.1, use_yuv=False, quantize_pis=True)
        assert s.cfg == cli.cfg, "the in-process trainer is not the CLI's"
        s.set_optimizer()
        s.ls_init_experts(mode="kernel")
        out = {"s": S, "kernels_per_dim": np.asarray(KPD),
               "val_iter": np.asarray([r["iter"] for r in rows]),
               "val_mse": np.asarray([r["mse"] for r in rows]),
               "ls_nu": np.asarray(s.params.nu_e, np.float32),
               "ls_gamma": np.asarray(s.params.gamma_e, np.float32)}
        # the light eval, as train() starts, then the sweeps from the
        # lists it leaves (its survivors)
        out["ls_mse"] = s.run_batched(train=False)[1]
        t0 = time.time()
        loss, mse, num_pi, _ = s.run_batched_chunk(a.iters)
        print(f"fit: {a.iters} sweeps in {time.time() - t0:.1f} s; mse "
              f"{float(mse[0]):.4f} -> {float(mse[-1]):.4f}")
        out.update(loss=np.asarray(loss, np.float32),
                   mse=np.asarray(mse, np.float32),
                   num_pi=np.asarray(num_pi, np.int32),
                   lists=np.asarray(s.kernel_lists))

        rec = np.asarray(decode_bitstream(a.out + ".smoe"))
        stride = 2
        out["stride"] = stride
        out["sample"] = np.uint8(np.round(rec[..., ::stride, ::stride, :]
                                          * 255))
        out["psnr_db"] = psnr_from_mse(
            float(np.mean((rec - orig) ** 2)) * 2 ** 16, 8)
    finally:
        shutil.rmtree(tmp)
    print(f"validations {out['val_mse'].tolist()}; LS mse "
          f"{out['ls_mse']:.4f}; decode PSNR {out['psnr_db']:.4f} dB")
    np.savez_compressed(a.out + "_ref.npz", **out)
    print(f"wrote {a.out}_ref.npz "
          f"({os.path.getsize(a.out + '_ref.npz')} bytes) and {a.out}.smoe "
          f"({os.path.getsize(a.out + '.smoe')} bytes)")


if __name__ == "__main__":
    main()
