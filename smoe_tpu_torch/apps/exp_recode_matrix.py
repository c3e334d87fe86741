"""Post-hoc coding matrix on a saved fit (from scripts/exp_recode_matrix.py):
re-quantize, entropy-code and decode one params_best.pkl under several
bit allocations and anchors, without refitting (under qm = 1 the fit's
trajectory does not depend on the coding depths: the best snapshot is
picked on the float loss).

    python -m smoe_tpu_torch.apps.exp_recode_matrix WORKDIR [--video|--lf]
        [--device cuda|cpu]

WORKDIR: a bench/video_quality.py or bench/lf.py workdir (cif.npz or
lf.mat, and out/params_best.pkl); --video / --lf name which (the input's
extension tells it too).  Prints one JSON row per coding configuration:
decoded PSNR (and the trained views' PSNR of a light field) and coded bpp.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from smoe_tpu_torch.apps import add_device_arg, device_of
from smoe_tpu_torch.bench import common

REF = (20, 18, 6, 10, 10)
LEAN = (10, 12, 8, 10, 8)
ULEAN = (8, 10, 8, 10, 6)
ULEAN_G8 = (8, 10, 8, 10, 8)

CONFIGS = [
    ("ref", REF, []),
    ("ref+nuanchor", REF, ["-nuanchor", "1"]),
    ("ref+nuanchor+ganchor", REF, ["-nuanchor", "1", "-ganchor", "1"]),
    ("ulean+nuanchor", ULEAN, ["-nuanchor", "1"]),
    ("ulean+nuanchor+ganchor", ULEAN,
     ["-nuanchor", "1", "-ganchor", "1"]),
    ("ulean-g8+nuanchor", ULEAN_G8, ["-nuanchor", "1"]),
    # LS fits carry more information in the expert offsets: nu10 variants
    # locate the corrected knee
    ("ulean-nu10+nuanchor", (8, 10, 10, 10, 6), ["-nuanchor", "1"]),
    ("ulean-nu10-g8+nuanchor", (8, 10, 10, 10, 8),
     ["-nuanchor", "1"]),
    ("lean+nuanchor", LEAN, ["-nuanchor", "1"]),
    ("lean+nuanchor+ganchor", LEAN,
     ["-nuanchor", "1", "-ganchor", "1"]),
]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workdir")
    kind = ap.add_mutually_exclusive_group()
    kind.add_argument("--video", action="store_true")
    kind.add_argument("--lf", action="store_true")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args.device)
    from smoe_tpu_torch.cli.reconstruct import main as rec_main
    from smoe_tpu_torch.codec.serve import decode_bitstream
    from smoe_tpu_torch.fit.blocks import _lf_train_mask
    from smoe_tpu_torch.io.images import read_image

    wd = args.workdir
    want = (".npz",) if args.video else (".mat",) if args.lf else (
        ".npz", ".mat", ".png")
    inputs = sorted(f for f in os.listdir(wd) if f.endswith(want))
    assert inputs, f"no input media in {wd}"
    img_path = os.path.join(wd, inputs[0])
    pkl = os.path.join(wd, "out", "params_best.pkl")

    is_lf = img_path.endswith(".mat")
    orig, precision, _ = read_image(img_path, not is_lf)
    scale = float(2 ** precision) ** 2
    n_pix = int(np.prod(orig.shape[:-1]))
    tm = _lf_train_mask(orig.shape[:2]) if is_lf else None
    card = common.card_fields(device)

    rows = []
    for label, bd, flags in CONFIGS:
        out = tempfile.mkdtemp(prefix="smoe_recode_")
        rec_main(["-i", img_path, "-p", pkl, "-r", out,
                  "-bd"] + [str(b) for b in bd] + flags
                 + ["--device", device])
        f = [os.path.join(out, x) for x in sorted(os.listdir(out))
             if x.endswith(".smoe")][0]
        rec = np.asarray(decode_bitstream(f, device=device)).reshape(
            orig.shape)
        err2 = (rec - orig) ** 2
        mse = float(err2.mean()) * scale
        bits = os.path.getsize(f) * 8
        row = {"config": label, "bit_depths": list(bd),
               "decoded_db": round(10 * np.log10(scale / mse), 2),
               "bpp": round(bits / n_pix, 4)}
        if tm is not None:
            mse_tr = float(err2[tm].mean()) * scale
            row["decoded_trained_views_db"] = round(
                10 * np.log10(scale / mse_tr), 2)
        row.update(card)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
