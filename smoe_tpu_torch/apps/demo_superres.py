"""Super-resolution decode demo (from scripts/demo_superres.py): one
bitstream, any raster.

`build_image(n)` samples the same continuous function at any n, so fitting
SMoE at 256 and decoding the bitstream at the 512 raster
(`decode_bitstream(out_shape=...)`) has a real ground truth.  Compares the
continuous 2x decode against bicubic upsampling of (a) the decoded 256
image and (b) the raw 256 input.

    python -m smoe_tpu_torch.apps.demo_superres [--iters 600] [--k 16]
        [--cpu | --device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from smoe_tpu_torch.apps import add_device_arg, device_of


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 10 * np.log10(1.0 / mse)


def bicubic(img: np.ndarray, shape) -> np.ndarray:
    """(H, W, C) float -> `shape` (h, w) as the script's
    cv2.resize(..., interpolation=INTER_CUBIC) (apps/cv.py:resize_cubic,
    OpenCV's own arithmetic on float32)."""
    from smoe_tpu_torch.apps.cv import resize_cubic
    return resize_cubic(np.asarray(img, np.float32), (shape[1], shape[0]))


def trainer(lo, k: int, device, **cfg):
    """The 256 fit's trainer after its LS expert init, ready for its first
    sweep.  Unnormalised pis (-np 0): normalised pis (~1/K) fall below the
    10-bit pi quantization step and collapse the decode."""
    from smoe_tpu_torch.fit.trainer import Smoe
    s = Smoe(lo, kernels_per_dim=[k], use_yuv=True, use_determinant=True,
             normalize_pis=False, device=device, **cfg)
    s.set_optimizer()
    s.ls_init_experts()
    return s


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--k", type=int, default=16)
    add_device_arg(ap, cpu_flag=True)
    args = ap.parse_args(argv)
    device = device_of(args.device, args.cpu)

    from smoe_tpu_torch.apps.content import build_image
    from smoe_tpu_torch.codec.bitstream import write_bitstream
    from smoe_tpu_torch.codec.quantize import quantize_params
    from smoe_tpu_torch.codec.serve import decode_bitstream

    lo = build_image(256)
    gt = build_image(512)        # the same continuous function, finer

    s = trainer(lo, args.k, device)
    s.train(args.iters, val_iter=max(args.iters // 5, 1), ukl_iter=100)
    s.qparams = quantize_params(s.get_params(), s.cfg)
    with tempfile.TemporaryDirectory(prefix="smoe_sr_") as tmp:
        path = os.path.join(tmp, "m.smoe")
        write_bitstream(path, s.qparams, s.cfg, extra={
            "shape_of_img": [256, 256], "dim_of_output": [3],
            "use_yuv": True,
            "use_determinant": bool(s.cfg.use_determinant)})
        rec256 = decode_bitstream(path, device=device)
        rec512 = decode_bitstream(path, out_shape=(512, 512), device=device)
    cubic_rec = bicubic(rec256, (512, 512))
    cubic_raw = bicubic(lo, (512, 512))

    out = {
        "metric": "superres_demo",
        "psnr_256_db": round(psnr(rec256, lo), 2),
        "psnr_sr512_db": round(psnr(rec512, gt), 2),
        "psnr_bicubic_of_decode_db": round(psnr(cubic_rec, gt), 2),
        "psnr_bicubic_of_input_db": round(psnr(cubic_raw, gt), 2),
        "iters": args.iters, "kernels": int(s.cfg.capacity),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
