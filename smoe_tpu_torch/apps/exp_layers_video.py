"""The layered (SNR-scalable) bitstream ladder at production scale (from
scripts/exp_layers_video.py): re-code a converged CIF video fit (the
params_best.pkl of bench/video_quality.py's workdir) as an L-tier layered
.smoe and decode every tier prefix: the rate and PSNR of each prefix on a
dual-model motion-compensated video model.

    python -m smoe_tpu_torch.apps.exp_layers_video --params
        WORKDIR/out/params_best.pkl [--layers 4] [--static] [--nuanchor]
        [--bd A MU NU PI G] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from smoe_tpu_torch.apps import add_device_arg, content, device_of
from smoe_tpu_torch.bench import common


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--params", required=True,
                    help="params_best.pkl of a converged video fit")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--static", action="store_true",
                    help="the fit used the pure-pan clip")
    ap.add_argument("--nuanchor", action="store_true",
                    help="center-anchored nu coding (use for LS fits)")
    ap.add_argument("--bd", type=int, nargs=5, default=None,
                    help="bit depths A/mu/nu/pi/gamma (default reference)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args.device)
    from smoe_tpu_torch.cli.reconstruct import main as rec_main
    from smoe_tpu_torch.codec.bitstream import read_header
    from smoe_tpu_torch.codec.serve import decode_bitstream
    from smoe_tpu_torch.io.images import read_image

    # the bench clip is deterministic: rebuild it as the PSNR target
    vid, affines = content.build_video(moving_obj=not args.static)
    tmp = tempfile.mkdtemp(prefix="smoe_layvid_")
    clip = os.path.join(tmp, "cif.npz")
    np.savez(clip, imgs=np.moveaxis((vid * 255).astype(np.uint8), 2, 0),
             affines=affines)

    # re-code through the encode CLI (it rebuilds the motion, diff-center
    # and dual-model state as the fit left it)
    rec_dir = os.path.join(tmp, "rec")
    rec_main(["-i", clip, "-p", args.params, "-r", rec_dir,
              "--layers", str(args.layers)]
             + (["-nuanchor", "1"] if args.nuanchor else [])
             + (["-bd"] + [str(b) for b in args.bd] if args.bd else [])
             + ["--device", device])
    lay = os.path.join(rec_dir, "model.smoe")

    orig, precision, _ = read_image(clip, True)        # YUV train target
    n_pix = float(np.prod(orig.shape[:3]))
    peak = (2.0 ** precision) ** 2

    def psnr(rec):
        mse = float(np.mean((np.asarray(rec).reshape(orig.shape)
                             - orig) ** 2)) * peak
        return 10 * np.log10(peak / mse)

    header = read_header(lay)
    per = [int(lh["bytes"]) for lh in header["layers"]]
    fixed = os.path.getsize(lay) - sum(per)
    rows, cum = [], fixed * 8
    for m in range(1, args.layers + 1):
        cum += per[m - 1] * 8
        t0 = common.clock(device)
        rec = decode_bitstream(lay, layers=m, device=device)
        dt = common.clock(device) - t0
        rows.append({"tiers": m,
                     "kernels": sum(int(lh["num_kernels"])
                                    for lh in header["layers"][:m]),
                     "cum_bits": int(cum), "cum_bpp": round(cum / n_pix, 4),
                     "psnr_db": round(psnr(rec), 2),
                     "decode_s": round(dt, 1)})
    out = {
        "metric": "layered_video_ladder",
        "layers": args.layers,
        "clip": "static-pan" if args.static else "moving-obj",
        "file_bits": os.path.getsize(lay) * 8,
        "file_bpp": round(os.path.getsize(lay) * 8 / n_pix, 4),
        "ladder": rows, **common.card_fields(device)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
