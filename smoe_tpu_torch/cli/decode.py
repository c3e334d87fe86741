"""Decode with the PyTorch port (from smoe_tpu/cli/decode.py): a `.smoe`
bitstream through the serving decoder, or a quantized-params pickle
(qparams.pkl of cli/reconstruct) by rebuilding the trainer (reference
smoe_reconstruction_decoded.py:16-62).

Usage:
    python -m smoe_tpu_torch.cli.decode -p model.smoe -r out/ \\
        [-s scale] [--roi y0:y1,x0:x1] [--layers m | --max-bytes n] \\
        [--device cuda]
    python -m smoe_tpu_torch.cli.decode -p qparams.pkl -r out/ [-i img.png]

On a CUDA device the `.smoe` decode runs the Hopper gate+expert kernel;
the pickle decode runs the trainer's exact quantized eval (plain torch
ops, as the JAX package keeps it outside its Pallas kernel).  With
`--device cuda` (the default) and no GPU present it fails rather than
carry on on the CPU.  A video file (d = 3, with its motion rows and
dual-model mask in the header) decodes to a raw I420 `output.yuv`; a
pickle carries no motion, so video models decode from their `.smoe`.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def main(args=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--image_path", type=str, default=None)
    p.add_argument("-r", "--results_path", type=str, default="/tmp")
    p.add_argument("-p", "--params_file", type=str, required=True)
    p.add_argument("-b", "--batches", type=int, default=1)
    p.add_argument("-s", "--scale", type=float, default=None,
                   help="decode the continuous model at scale x the coded "
                        "spatial resolution (.smoe inputs only)")
    p.add_argument("--roi", type=str, default=None,
                   help="decode only this spatial window, 'y0:y1,x0:x1' in "
                        "native pixels (composes with -s for zoom; .smoe "
                        "inputs only)")
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
    from smoe_tpu_torch.io.images import read_image, write_image

    with open(a.params_file, "rb") as fd:
        head = fd.read(4)
    if head == b"SMOE":
        # entropy-coded bitstream: the lean serving decoder handles this
        # end to end (chunked so memory is bounded — no OOM retry loop
        # needed)
        from smoe_tpu_torch.codec.serve import decode_bitstream
        rec, header = decode_bitstream(a.params_file, return_header=True,
                                       scale=a.scale, roi=roi,
                                       layers=a.layers,
                                       max_bytes=a.max_bytes,
                                       device=a.device)
        os.makedirs(a.results_path, exist_ok=True)
        c = int(np.ravel(header.get("dim_of_output", [3]))[0])
        out = write_image(
            rec, os.path.join(a.results_path, "output"),
            len(header["shape_of_img"]),
            yuv=bool(header.get("use_yuv", True)) and c == 3,
            precision=int(header.get("precision", 8)))
        print(f"wrote {out}")
        return rec
    if (a.scale is not None or roi is not None or a.layers is not None
            or a.max_bytes is not None):
        raise SystemExit("--scale/--roi/--layers/--max-bytes need a .smoe "
                         "bitstream input (the pickle path rebuilds the "
                         "trainer grid)")

    from smoe_tpu_torch.cli.reconstruct import estimate_batches
    from smoe_tpu_torch.codec.alloc import grid_numpy
    from smoe_tpu_torch.codec.quantize import rescaler
    from smoe_tpu_torch.fit.trainer import Smoe

    with open(a.params_file, "rb") as fd:
        cp = pickle.load(fd)

    img_shape = tuple(int(v) for v in np.ravel(cp["shape_of_img"]))
    c = int(np.ravel(cp.get("dim_of_output", [3]))[0])
    dim = len(img_shape)

    if a.image_path is not None:
        orig, precision, _ = read_image(a.image_path)
    else:
        orig = np.zeros(img_shape + (c,), np.float32)
        precision = 8

    # decoder rebuilds the model from the stored grid (reference :22,29)
    k = [max(int(s // 4), 1) for s in img_shape]
    cfg_kw = dict(
        use_determinant=bool(np.ravel(cp.get("used_determinants",
                                             cp.get("use_determinant",
                                                    True)))[0]),
        use_yuv=bool(np.ravel(cp.get("use_yuv", True))[0]) and c == 3,
        use_diff_center=bool(np.ravel(cp.get("use_diff_center", False))[0]),
        radial_as=bool(np.ravel(cp.get("radial_as", False))[0]),
        precision=precision)

    # Size the first attempt from the dominant allocation — the per-block
    # (Nb, K) gating map and its handful of same-shaped temporaries — so
    # decode usually skips the reference's fail-and-double loop
    # (smoe_reconstruction_decoded.py:41-50), which stays as the fallback.
    n_pix = int(np.prod(img_shape))
    k_cap = int(np.prod(k))
    batches = estimate_batches(n_pix, k_cap, a.batches)
    if batches > a.batches:
        print(f"memory estimate: starting with {batches} blocks "
              f"({n_pix}px x {k_cap} kernel slots)")
    rec = None
    while rec is None:
        smoe = Smoe(orig, kernels_per_dim=k, start_batches=batches,
                    device=a.device, **cfg_kw)
        cfg = smoe.cfg

        used = np.asarray(cp["used_kernels"]).astype(bool).reshape(-1)
        grid = grid_numpy(smoe)
        rp = rescaler(cp, cfg,
                      musX_grid=(grid[used[:len(grid)]]
                                 if cfg.use_diff_center and grid is not None
                                 else None))
        smoe.qparams = dict(cp)
        smoe.qparams["used_kernels"] = used
        smoe.rparams = rp
        # every block evaluates every slot, as the serving decoder does:
        # the rebuilt trainer's lists describe its own init grid, not the
        # decoded kernels, and with more than one block they would drop
        # decoded kernels (the JAX CLI keeps them; with one block, as in
        # its tests, they are all-true and the two agree)
        smoe.kernel_lists = torch.ones_like(smoe.kernel_lists)
        try:
            smoe.run_batched(train=False, update_reconstruction=True,
                             with_quantized_params=True)
            rec = smoe.get_qreconstruction()
        except torch.OutOfMemoryError as e:
            # only out-of-memory retries with more blocks; every other
            # fault propagates (the JAX CLI retries on any exception, :128)
            print(f"decode failed ({e}); retrying with {2 * batches} blocks")
            del smoe
            torch.cuda.empty_cache()
            batches *= 2
            if batches > 4096:
                raise

    os.makedirs(a.results_path, exist_ok=True)
    out = write_image(rec, os.path.join(a.results_path, "output"),
                      dim, yuv=cfg_kw["use_yuv"], precision=precision)
    print(f"wrote {out}")
    return rec


if __name__ == "__main__":
    main()
