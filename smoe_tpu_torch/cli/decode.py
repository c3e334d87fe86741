"""Decode a `.smoe` bitstream to an image with the PyTorch port
(from smoe_tpu/cli/decode.py:18-68, the `.smoe` branch).

Usage:
    python -m smoe_tpu_torch.cli.decode -p model.smoe -r out/ \\
        [-s scale] [--roi y0:y1,x0:x1] [--layers m | --max-bytes n] \\
        [--device cuda]

On a CUDA device the decode runs the Hopper gate+expert kernel.  With
`--device cuda` (the default) and no GPU present it fails rather than
carry on on the CPU.  The quantized-params pickle input rebuilds the
trainer, which is not ported yet.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(args=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-r", "--results_path", type=str, default="/tmp")
    p.add_argument("-p", "--params_file", type=str, required=True)
    p.add_argument("-s", "--scale", type=float, default=None,
                   help="decode the continuous model at scale x the coded "
                        "spatial resolution")
    p.add_argument("--roi", type=str, default=None,
                   help="decode only this spatial window, 'y0:y1,x0:x1' in "
                        "native pixels (composes with -s for zoom)")
    p.add_argument("--layers", type=int, default=None,
                   help="decode only the first N tiers of a layered "
                        "(SNR-scalable) .smoe bitstream")
    p.add_argument("--max-bytes", type=int, default=None, dest="max_bytes",
                   help="decode the largest tier prefix of a layered "
                        ".smoe that fits this byte budget")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to decode on (default cuda)")
    a = p.parse_args(args)
    roi = None
    if a.roi:
        roi = tuple(tuple(int(v) for v in r.split(":"))
                    for r in a.roi.split(","))

    import torch

    if torch.device(a.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit(f"--device {a.device}: no CUDA device is available "
                         "(pass --device cpu to decode on the CPU)")
    with open(a.params_file, "rb") as fd:
        head = fd.read(4)
    if head != b"SMOE":
        raise SystemExit(
            "smoe_tpu_torch decodes .smoe bitstreams only; the quantized-"
            "params pickle rebuilds the trainer, which is not ported yet "
            "(ROADMAP.md, Queue 1) — use python -m smoe_tpu.cli.decode")

    from smoe_tpu_torch.codec.serve import decode_bitstream
    from smoe_tpu_torch.io.images import write_image

    rec, header = decode_bitstream(a.params_file, return_header=True,
                                   scale=a.scale, roi=roi, layers=a.layers,
                                   max_bytes=a.max_bytes, device=a.device)
    os.makedirs(a.results_path, exist_ok=True)
    c = int(np.ravel(header.get("dim_of_output", [3]))[0])
    out = write_image(
        rec, os.path.join(a.results_path, "output"),
        len(header["shape_of_img"]),
        yuv=bool(header.get("use_yuv", True)) and c == 3,
        precision=int(header.get("precision", 8)))
    print(f"wrote {out}")
    return rec


if __name__ == "__main__":
    main()
