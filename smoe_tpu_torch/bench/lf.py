"""End-to-end 4D light-field quality benchmark (from scripts/bench_lf.py;
the d = 4 analog of bench/video_quality.py, reference capability C14).

Builds the synthetic 15x15-view light field with real disparity structure
(apps/content.py:build_lf: a textured background plane and a foreground
square at another disparity) as a .mat, fits it through the port's CLI
(which applies the reference's corner-view train mask), quantizes,
entropy-codes and decodes it with the serving decoder.  Reports the
decoded PSNR over the trained views (the reference's evaluation frame) and
over all views, the coded bpp and the wall-clock, in one JSON line with
the script's keys and the card's name and power limit.

    python -m smoe_tpu_torch.bench.lf [--k 6] [--kt 4] [--n 2000] [--s 48]
        [... the script's flags] [--device cuda|cpu]

The workdir keeps lf.mat and out/params_best.pkl (apps/exp_recode_matrix.py
--lf takes it).  --texture hopper takes both planes from the photograph's
grayscale decode (apps/sample_data/).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from smoe_tpu_torch.apps import add_device_arg, content, device_of
from smoe_tpu_torch.bench import common


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=6,
                    help="spatial (y,x) kernels/dim")
    ap.add_argument("--kt", type=int, default=4,
                    help="view-axis (u,v) kernels/dim")
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--s", type=int, default=48, help="spatial size")
    ap.add_argument("--val", type=int, default=500)
    ap.add_argument("--ukl", type=int, default=None,
                    help="kernel-list refresh cadence")
    ap.add_argument("--iukl", action="store_true",
                    help="in-graph per-sweep kernel-list refresh")
    ap.add_argument("--pmt", type=float, default=None,
                    help="probe maha threshold")
    ap.add_argument("--pg", type=int, default=None,
                    help="probe grid points per dim")
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--lean", action="store_true",
                    help="code with the lean bit allocation")
    ap.add_argument("--ulean", action="store_true",
                    help="code with the ultra-lean allocation "
                         "A8/mu10/nu8/pi10/g6")
    ap.add_argument("--lslean", action="store_true",
                    help="code with the LS-fit knee A8/mu10/nu10/pi10/g8")
    ap.add_argument("--lsinit", action="store_true",
                    help="closed-form LS expert init (fit -lsinit kernel)")
    ap.add_argument("--lsri", type=int, default=0,
                    help="periodic LS expert refresh cadence (fit -lsri N)")
    ap.add_argument("--ganchor", action="store_true",
                    help="code gamma in the steering-whitened basis")
    ap.add_argument("--cw", type=float, default=0.0,
                    help="corner-view loss weight in (0,1] (fit -lfcw)")
    ap.add_argument("--texture", type=str, default="synth",
                    choices=["synth", "hopper"],
                    help="scene texture: synthetic or the real photograph "
                         "(luminance)")
    add_device_arg(ap)
    return ap


def fit_argv(args, mat: str, res_dir: str) -> list:
    argv = ["-i", mat, "-r", res_dir,
            "-n", str(args.n),
            "-k", str(args.kt), str(args.kt), str(args.k), str(args.k),
            "-v", str(args.val), "-lr", str(args.lr),
            "-np", "0", "-qm", "1"]
    if args.ukl:
        argv += ["-ukl", str(args.ukl)]
    if args.iukl:
        argv += ["-iukl", "1"]
    if args.pmt is not None:
        argv += ["-pmt", str(args.pmt)]
    if args.pg:
        argv += ["-pg", str(args.pg)]
    if args.lean:
        argv += ["-lean", "1"]
    if args.ulean:
        argv += ["-ulean", "1"]
    if args.lslean:
        argv += ["-lslean", "1"]
    if args.lsinit:
        argv += ["-lsinit", "kernel"]
    if args.lsinit or args.lsri:
        # LS-fitted slopes need center-anchored nu coding
        argv += ["-nuanchor", "1"]
    if args.lsri:
        argv += ["-lsri", str(args.lsri)]
    if args.ganchor:
        argv += ["-ganchor", "1"]
    if args.cw:
        argv += ["-lfcw", str(args.cw)]
    return argv + ["--device", args.device]


def recipe(args) -> str:
    return (f"fit {args.n}, k={args.kt},{args.kt},{args.k},{args.k}, "
            f"qm=1, lr={args.lr}"
            + (f", ukl={args.ukl}" if args.ukl else "")
            + (", iukl" if args.iukl else "")
            + (f", pmt={args.pmt}" if args.pmt is not None else "")
            + (f", pg={args.pg}" if args.pg else "")
            + (", lean" if args.lean else "")
            + (", ulean" if args.ulean else "")
            + (", lslean" if args.lslean else "")
            + (", lsinit" if args.lsinit else "")
            + (f", lsri={args.lsri}" if args.lsri else "")
            + (", ganchor" if args.ganchor else "")
            + (f", cw={args.cw}" if args.cw else "")
            + (f", texture={args.texture}"
               if args.texture != "synth" else ""))


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = device_of(args.device)
    from scipy.io import savemat

    from smoe_tpu_torch.cli.fit import main as fit_main
    from smoe_tpu_torch.codec.serve import decode_bitstream
    from smoe_tpu_torch.core.losses import psnr_from_mse
    from smoe_tpu_torch.fit.blocks import _lf_train_mask
    from smoe_tpu_torch.io.images import read_image

    lf = content.build_lf(s=args.s, texture=args.texture)
    tmp = tempfile.mkdtemp(prefix="smoe_lfq_")
    mat = os.path.join(tmp, "lf.mat")
    savemat(mat, {"LF": lf})
    res_dir = os.path.join(tmp, "out")

    t0 = common.clock(device)
    smoe = fit_main(fit_argv(args, mat, res_dir))
    fit_s = common.clock(device) - t0

    smoe_file = os.path.join(res_dir, "model_best.smoe")
    bits = os.path.getsize(smoe_file) * 8
    t0 = common.clock(device)
    rec = np.asarray(decode_bitstream(smoe_file, device=device))
    dec_s = common.clock(device) - t0

    orig, precision, _ = read_image(mat, False)
    rec = rec.reshape(orig.shape)
    scale = (2 ** precision) ** 2
    tm = _lf_train_mask(orig.shape[:2])          # (15, 15) trained views
    err2 = (rec - orig) ** 2
    mse_tr = float(err2[tm].mean()) * scale
    mse_all = float(err2.mean()) * scale
    n_pix = int(np.prod(orig.shape[:4]))
    gm = smoe.global_best_mse if smoe.global_best_mse is not None \
        else smoe.get_best_mse()

    out = {
        "metric": "lf_4d_e2e_decoded_psnr_db",
        "value": round(10 * np.log10(scale / mse_tr), 2),
        "unit": "dB (trained views)",
        "psnr_all_views_db": round(10 * np.log10(scale / mse_all), 2),
        "psnr_train_best_db": round(psnr_from_mse(gm, precision), 2),
        "coded_bpp": round(bits / n_pix, 4),
        "coded_bits": bits,
        "live_kernels": int(smoe.get_num_pis()[-1][1]),
        "fit_wallclock_s": round(fit_s, 1),
        "decode_s": round(dec_s, 3),
        "views": list(orig.shape[:2]), "spatial": list(orig.shape[2:4]),
        "workdir": tmp,
        "recipe": recipe(args),
        **common.card_fields(device),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
