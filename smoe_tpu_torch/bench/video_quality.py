"""End-to-end video quality benchmark (from scripts/bench_video_quality.py):
the full reference video recipe, motion-compensated dual-model fit,
per-time-slab reseeding and quantization, through the port's CLI on a CIF
clip, to a decoded PSNR, a coded bpp and a wall-clock.

The recipe (reference smoe_test.py:123-207): an initial fit of --n sweeps,
then for each of the 4 time slabs the spare raw-domain kernels activated
at the error hotspots and --ri sweeps of retraining (5x on the last
slab), validation every --val sweeps, then the entropy-coded .smoe of the
best validation, decoded by the serving decoder: the PSNR a receiver
sees, not an in-trainer eval.  --auto adds the production composed encode
(cli.reconstruct --auto-bd 0.05 --prune 0 on params_best) and a second
JSON line.  The workdir keeps cif.npz and out/params_best.pkl, which
apps/exp_recode_matrix.py and apps/exp_layers_video.py take.

    python -m smoe_tpu_torch.bench.video_quality [--k 16] [--n 2000]
        [--ri 1000] [--val 500] [... the script's flags] [--device cuda|cpu]

--texture hopper pans over the photograph (apps/sample_data/) and --rot
DEG turns the moving patch by DEG a frame (apps/cv.py's warpAffine), as
the script's flags do.
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
    ap.add_argument("--k", type=int, default=16,
                    help="spatial kernels/dim (time fixed at 4)")
    ap.add_argument("--n", type=int, default=2000,
                    help="initial fit iterations")
    ap.add_argument("--ri", type=int, default=1000,
                    help="retrain iterations per time-slab reseed "
                         "(reference hardcodes 1000, 5x on the last slab)")
    ap.add_argument("--val", type=int, default=500)
    ap.add_argument("--ukl", type=int, default=None,
                    help="kernel-list refresh cadence (iters)")
    ap.add_argument("--iukl", action="store_true",
                    help="in-graph per-sweep kernel-list refresh")
    ap.add_argument("--blocks", type=int, default=None,
                    help="spatial block count (-b)")
    ap.add_argument("--pmt", type=float, default=None,
                    help="probe maha threshold (default: reference's 800)")
    ap.add_argument("--pg", type=int, default=None,
                    help="probe grid points per dim (-pg)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--lsinit", action="store_true",
                    help="closed-form LS expert init + post-reseed "
                         "refreshes (fit -lsinit kernel)")
    ap.add_argument("--lsri", type=int, default=0,
                    help="periodic LS expert refresh cadence (fit -lsri N)")
    ap.add_argument("--lsrip", type=str, default="all",
                    choices=["all", "initial"],
                    help="restrict the -lsri refresh to the initial fit "
                         "(fit -lsrip)")
    ap.add_argument("--ganchor", action="store_true",
                    help="code gamma in the steering-whitened basis "
                         "(fit -ganchor 1)")
    ap.add_argument("--lean", action="store_true",
                    help="code with A10/mu12/nu8/pi10/g8 (-lean 1)")
    ap.add_argument("--lslean", action="store_true",
                    help="code with A8/mu10/nu10/pi10/g8 (fit -lslean 1)")
    ap.add_argument("--ulean", action="store_true",
                    help="code with A8/mu10/nu8/pi10/g6 (-ulean 1)")
    ap.add_argument("--static", action="store_true",
                    help="pure-pan clip (no independently moving object)")
    ap.add_argument("--qm", type=int, default=1,
                    help="quantization mode for the fit (fit -qm)")
    ap.add_argument("--texture", type=str, default="synth",
                    choices=["synth", "hopper"],
                    help="clip texture: synthetic or the real photograph")
    ap.add_argument("--lsrs", type=int, default=0,
                    help="stop the -lsri refresh after N initial-fit iters "
                         "(fit -lsrs)")
    ap.add_argument("--auto", action="store_true",
                    help="after the fit, run the production composed "
                         "encode (reconstruct --auto-bd 0.05 --prune 0 on "
                         "params_best) and print a second JSON line")
    ap.add_argument("--rot", type=float, default=0.0,
                    help="rotate the moving patch by DEG/frame (bilinear, "
                         "reflected border)")
    add_device_arg(ap)
    return ap


def fit_argv(args, clip: str, res_dir: str) -> list:
    """cli.fit's arguments for the recipe (bench_video_quality.py:181-205).
    -np 0: at K ~ 2000 the normalized 1/K pis sit below the 10-bit pi
    quantization step (2/1023), so the quantized model would collapse."""
    return ([
        "-i", clip, "-r", res_dir,
        "-n", str(args.n), "-ri", str(args.ri),
        "-k", str(args.k), str(args.k), "4",
        "-v", str(args.val), "-lr", str(args.lr),
        "-np", "0",
        "-qm", str(args.qm),
    ] + (["-lean", "1"] if args.lean else [])
      + (["-ulean", "1"] if args.ulean else [])
      + (["-lslean", "1"] if args.lslean else [])
      + (["-ukl", str(args.ukl)] if args.ukl else [])
      + (["-iukl", "1"] if args.iukl else [])
      + (["-pmt", str(args.pmt)] if args.pmt is not None else [])
      + (["-b", str(args.blocks)] if args.blocks else [])
      + (["-pg", str(args.pg)] if args.pg else [])
      + (["-lsinit", "kernel"] if args.lsinit else [])
      # LS-fitted slopes need center-anchored nu coding whether the fit
      # came from -lsinit or -lsri (exp_lsri_quant: -4.4 dB without)
      + (["-nuanchor", "1"] if (args.lsinit or args.lsri) else [])
      + (["-lsri", str(args.lsri)] if args.lsri else [])
      + (["-lsrip", args.lsrip] if args.lsrip != "all" else [])
      + (["-lsrs", str(args.lsrs)] if args.lsrs else [])
      + (["-ganchor", "1"] if args.ganchor else [])
      + ["--device", args.device])


def recipe(args) -> str:
    return (f"fit {args.n} + 4 slabs x {args.ri} (5x last), "
            f"k={args.k},{args.k},4, qm={args.qm}, lr={args.lr}"
            + (", lean" if args.lean else "")
            + (", ulean" if args.ulean else "")
            + (", lslean" if args.lslean else "")
            + (f", ukl={args.ukl}" if args.ukl else "")
            + (", iukl" if args.iukl else "")
            + (f", pmt={args.pmt}" if args.pmt is not None else "")
            + (f", b={args.blocks}" if args.blocks else "")
            + (f", pg={args.pg}" if args.pg else "")
            + (", lsinit" if args.lsinit else "")
            + (f", lsri={args.lsri}" if args.lsri else "")
            + (f", lsrip={args.lsrip}" if args.lsrip != "all" else "")
            + (f", lsrs={args.lsrs}" if args.lsrs else "")
            + (", ganchor" if args.ganchor else "")
            + (", static-pan" if args.static else ", moving-obj")
            + (f", texture={args.texture}"
               if args.texture != "synth" else "")
            + (f", rot={args.rot}" if args.rot else ""))


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    device = device_of(args.device)
    from smoe_tpu_torch.cli.fit import main as fit_main
    from smoe_tpu_torch.codec.serve import decode_bitstream
    from smoe_tpu_torch.core.losses import psnr_from_mse
    from smoe_tpu_torch.io.images import read_image

    # CIF 288x352x8 RGB pan + a foreground square moving against the pan
    # (the content class the reseed recipe exists for)
    vid, affines = content.build_video(moving_obj=not args.static,
                                       texture=args.texture, rot=args.rot)
    tmp = tempfile.mkdtemp(prefix="smoe_vidq_")
    clip = os.path.join(tmp, "cif.npz")
    np.savez(clip, imgs=np.moveaxis((vid * 255).astype(np.uint8), 2, 0),
             affines=affines)
    res_dir = os.path.join(tmp, "out")

    t0 = common.clock(device)
    smoe = fit_main(fit_argv(args, clip, res_dir))
    fit_s = common.clock(device) - t0

    # receiver-side decode of the best-validation model: .smoe bitstream
    # -> volume, no trainer state
    smoe_file = os.path.join(res_dir, "model_best.smoe")
    bits = os.path.getsize(smoe_file) * 8
    t0 = common.clock(device)
    rec = np.asarray(decode_bitstream(smoe_file, device=device))
    dec_s = common.clock(device) - t0

    orig, precision, _ = read_image(clip, True)     # the YUV train target
    rec = rec.reshape(orig.shape)
    peak = (2 ** precision) ** 2
    mse = float(np.mean((rec - orig) ** 2)) * peak
    psnr = 10 * np.log10(peak / mse)
    wts = np.array([6, 1, 1]) / 8
    mse_yuv = float(np.average(
        np.mean((rec - orig) ** 2, axis=(0, 1, 2)), weights=wts)) * peak
    psnr_yuv = 10 * np.log10(peak / mse_yuv)
    n_pix = int(np.prod(orig.shape[:3]))

    # in-trainer best (the decoded PSNR sits within the quantization loss
    # of it)
    gm = smoe.global_best_mse if smoe.global_best_mse is not None \
        else smoe.get_best_mse()
    psnr_train = psnr_from_mse(gm, precision)
    card = common.card_fields(device)

    lines = [{
        "metric": "video_cif_e2e_decoded_psnr_db",
        "value": round(psnr, 2),
        "unit": "dB",
        "psnr_yuv_weighted_db": round(psnr_yuv, 2),
        "psnr_train_best_db": round(psnr_train, 2),
        "coded_bpp": round(bits / n_pix, 4),
        "coded_bits": bits,
        "live_kernels": int(smoe.get_num_pis()[-1][1]),
        "fit_wallclock_s": round(fit_s, 1),
        "decode_s": round(dec_s, 3),
        "frames": int(orig.shape[2]),
        "workdir": tmp,
        "recipe": recipe(args),
        **card}]
    print(json.dumps(lines[0]), flush=True)

    if args.auto:
        # the production composed encode: measured per-group bit
        # allocation and RD prune on the best-validation snapshot, then the
        # receiver's view of the resulting bitstream
        from smoe_tpu_torch.cli.reconstruct import main as rec_main
        auto_dir = os.path.join(tmp, "auto")
        t0 = common.clock(device)
        rec_main(["-i", clip,
                  "-p", os.path.join(res_dir, "params_best.pkl"),
                  "-r", auto_dir, "-q", "1",
                  "--auto-bd", "0.05", "--prune", "0", "--device", device])
        enc_s = common.clock(device) - t0
        smoe_auto = os.path.join(auto_dir, "model.smoe")
        bits_a = os.path.getsize(smoe_auto) * 8
        rec_a = np.asarray(decode_bitstream(
            smoe_auto, device=device)).reshape(orig.shape)
        mse_a = float(np.mean((rec_a - orig) ** 2)) * peak
        lines.append({
            "metric": "video_cif_composed_auto_encode_psnr_db",
            "value": round(10 * np.log10(peak / mse_a), 2),
            "unit": "dB",
            "coded_bpp": round(bits_a / n_pix, 4),
            "coded_bits": bits_a,
            "psnr_train_best_db": round(psnr_train, 2),
            "encode_wallclock_s": round(enc_s, 1),
            "workdir": tmp,
            "recipe": "reconstruct --auto-bd 0.05 --prune 0 on "
                      "params_best of the fit above",
            **card})
        print(json.dumps(lines[1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
