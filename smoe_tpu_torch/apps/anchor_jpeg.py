"""Classical-codec anchor for the RD story (from scripts/anchor_jpeg.py):
a JPEG quality sweep on the same image the SMoE RD curve uses, so the
rate points have a familiar yardstick.

Prints one JSON row per JPEG quality (bpp, RGB PSNR, SSIM) and, with
--fit N, one SMoE row (an LS-init fit of N iterations, its best snapshot
quantized and entropy-coded, the decoded PSNR) for the same image.  The
JPEG is io/jpeg.py's, which writes and reads OpenCV's bytes and pixels bit
for bit; WebP, which the script adds when its OpenCV has it, is not ported
(ROADMAP.md, "Blocked, not queued"), and each run says so on stderr.

    python -m smoe_tpu_torch.apps.anchor_jpeg [image] [--fit 1000]
        [--size 256] [--k 12] [--lsri N] [--auto] [--ssim]
        [--family bench|pink|mosaic|text|hopper|mri|dem]
        [--device cuda|cpu]

The image argument is read as cv2.imread(IMREAD_COLOR) reads it (a JPEG's
EXIF orientation applied); PNG, JPEG, PGM and PPM are read.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

from smoe_tpu_torch.apps import device_of
from smoe_tpu_torch.io import jpeg

QUALITIES = (2, 5, 10, 20, 35, 50, 75, 90)
BLOCKED = ("not emitted: the WebP rows (cv2's libwebp); ROADMAP.md, "
           "\"Blocked, not queued\"")


def psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10 * np.log10(255.0 ** 2 / mse)


def ssim_rgb(a_u8, b_u8):
    """Mean per-channel SSIM in the coding (RGB / gray) domain on [0, 1]
    with the trainer's symmetric 5-px pad (core/ssim.py), computed on the
    host as the script computes it."""
    import torch
    from smoe_tpu_torch.core.ssim import ssim_loss
    a = torch.as_tensor((a_u8 / 255.0).astype(np.float32))
    b = torch.as_tensor((b_u8 / 255.0).astype(np.float32))
    return float(1.0 - ssim_loss(a, b, use_yuv=False))


def anchor_rows(img_u8, n_pix):
    """One row per JPEG quality: the file's bpp, its decode's PSNR and
    SSIM against img_u8 ((H, W, 3) RGB or (H, W, 1) gray uint8)."""
    rows = []
    gray = img_u8.shape[-1] == 1
    enc_in = img_u8[..., 0] if gray else img_u8[..., ::-1]
    for q in QUALITIES:
        buf = jpeg.encode(enc_in, q)
        dec = (jpeg.decode(buf, "gray")[..., None] if gray
               else jpeg.decode(buf, "color")[..., ::-1])
        rows.append({"codec": "jpeg", "q": q,
                     "bpp": round(8 * len(buf) / n_pix, 4),
                     "psnr_db": round(psnr(img_u8, dec), 2),
                     "ssim": round(ssim_rgb(img_u8, dec), 4)})
    return rows


def fitted(img, iters, k, lsri, ssim_fit, device):
    """The script's fit: LS-init, center-anchored nu, in-graph kernel
    lists, `iters` sweeps validated every iters / 10, LS refresh every
    `lsri`; returns a trainer rebuilt on the best-validation snapshot."""
    from smoe_tpu_torch.fit.trainer import Smoe
    bd = (8, 10, 10, 10, 8)
    s = Smoe(img, kernels_per_dim=[k], bit_depths=bd, nu_anchor=True,
             in_graph_ukl=True, ssim_opt=ssim_fit, device=device)
    s.set_optimizer()
    s.ls_init_experts()
    s.train(iters, val_iter=max(iters // 10, 1), ukl_iter=100,
            ls_refresh_iter=lsri or None)
    return Smoe(img, init_params_dict=s.get_best_params(), bit_depths=bd,
                nu_anchor=True, device=device)


def smoe_row(img_u8, iters, k=12, lsri=0, auto=False, ssim_fit=False,
             device="cuda"):
    """One SMoE RD point (scripts/anchor_jpeg.py:smoe_row): the fit's best
    snapshot quantized at A8/mu10/nu10/pi10/g8, or with auto the composed
    encode (the measured per-group bit allocation and the RD prune), coded
    to a real bitstream; the quantized reconstruction's PSNR and SSIM."""
    from smoe_tpu_torch.codec.bitstream import write_bitstream
    from smoe_tpu_torch.codec.quantize import quantize_params, rescaler
    from smoe_tpu_torch.core.losses import psnr_from_mse

    img = (img_u8 / 255.0).astype(np.float32)
    n_pix = int(np.prod(img.shape[:-1]))
    s = fitted(img, iters, k, lsri, ssim_fit, device)
    grid = None if s.musX_grid is None else s.musX_grid.cpu().numpy()
    if auto:
        from smoe_tpu_torch.codec.alloc import (START, choose_anchors,
                                                search_bit_depths)
        from smoe_tpu_torch.codec.prune import prune_search
        s.cfg = s.cfg.replace(bit_depths=START)
        choose_anchors(s)
        bd, _, _ = search_bit_depths(s, tol_db=0.05)
        s.cfg = s.cfg.replace(bit_depths=bd)
        s.qparams = quantize_params(s.get_params(), s.cfg, musX_grid=grid)
        s.qparams = prune_search(s, 0.0)
    else:
        s.qparams = quantize_params(s.get_params(), s.cfg, musX_grid=grid)
    s.rparams = rescaler(s.qparams, s.cfg, None if grid is None else
                         grid[np.asarray(s.qparams["used_kernels"])])
    _, mse_q, npi, _ = s.run_batched(train=False, update_reconstruction=True,
                                     with_quantized_params=True)
    rec_u8 = np.uint8(np.clip(np.asarray(s.get_qreconstruction()), 0, 1)
                      * 255 + 0.5)
    with tempfile.TemporaryDirectory() as tmp:
        bits = write_bitstream(os.path.join(tmp, "row.smoe"), s.qparams,
                               s.cfg)
    return {"codec": "smoe-ssim" if ssim_fit else "smoe", "q": None,
            "bpp": round(bits / n_pix, 4),
            "psnr_db": round(float(psnr_from_mse(mse_q, 8)), 2),
            "ssim": round(ssim_rgb(img_u8, rec_u8), 4),
            "iters": iters, "kernels": int(npi),
            "k": k, "lsri": lsri, "auto": bool(auto)}


def main(argv=None) -> list:
    argv = list(sys.argv[1:] if argv is None else argv)

    def opt(flag, default, kind=int):
        if flag in argv:
            i = argv.index(flag)
            v = kind(argv[i + 1])
            del argv[i:i + 2]
            return v
        return default

    def flag(name):
        if name in argv:
            argv.remove(name)
            return True
        return False

    fit_iters = opt("--fit", 0)
    size = opt("--size", 256)
    k = opt("--k", 12)
    lsri = opt("--lsri", 0)
    family = opt("--family", "bench", str)
    device = opt("--device", "cuda", str)
    auto, ssim_fit = flag("--auto"), flag("--ssim")
    if fit_iters:
        device = device_of(device)
    print(f"anchor_jpeg: {BLOCKED}", file=sys.stderr, flush=True)

    if argv:
        from smoe_tpu_torch.io.images import read_color
        img_u8 = read_color(argv[0])[..., ::-1]
    else:
        from smoe_tpu_torch.apps.content import build_family
        img_u8 = np.uint8(build_family(family, size) * 255)

    n_pix = int(np.prod(img_u8.shape[:-1]))
    rows = []
    for row in anchor_rows(img_u8, n_pix):
        rows.append({"family": family, **row})
        print(json.dumps(rows[-1]), flush=True)
    if fit_iters:
        rows.append({"family": family,
                     **smoe_row(img_u8, fit_iters, k=k, lsri=lsri, auto=auto,
                                ssim_fit=ssim_fit, device=device)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
