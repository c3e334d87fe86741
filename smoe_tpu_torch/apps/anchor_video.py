"""Classical-codec anchors for the video modality (from
scripts/anchor_video.py): one JSON row per anchor point on the same clip
and the same metric as bench/video_quality.py, so the SMoE video rows
compare like with like.

  * per-frame JPEG quality sweeps (intra-only, the image-codec floor the
    SMoE literature positions against), through io/jpeg.py, which writes
    and reads OpenCV's bytes and pixels bit for bit;
  * with --smoe FILE.smoe, the SMoE bitstream of this clip decoded by the
    serving decoder, on the same metric.

The script's other rows (per-frame WebP; MJPG, mp4v, XVID and VP9 through
cv2.VideoWriter) need OpenCV's codecs and containers and are not emitted
(ROADMAP.md, "Blocked, not queued"); each run says so on stderr.

Metric: the clip's uint8 RGB frames (as bench/video_quality.py writes them
to its .npz) in YUV (cv2's COLOR_RGB2YUV, io/images.py:bgr_to_yuv) / 255,
PSNR = 10 log10(1 / mean((rec - orig)^2)) over the whole volume, and the
6/1/1-weighted variant.

    python -m smoe_tpu_torch.apps.anchor_video [--texture synth|hopper]
        [--static] [--rot DEG] [--smoe model.smoe] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from smoe_tpu_torch.apps import add_device_arg, device_of
from smoe_tpu_torch.apps.anchor_jpeg import QUALITIES
from smoe_tpu_torch.io import jpeg

BLOCKED = ("not emitted: the per-frame WebP rows and the cv2.VideoWriter "
           "rows (MJPG, mp4v, XVID, VP90); ROADMAP.md, \"Blocked, not "
           "queued\"")


def to_yuv_float(frames_u8_rgb):
    """(T, H, W, 3) uint8 RGB -> float YUV in [0, 1], the read_image path
    (cv2's RGB2YUV on uint8, then / 255)."""
    from smoe_tpu_torch.io.images import bgr_to_yuv
    out = bgr_to_yuv(np.ascontiguousarray(frames_u8_rgb[..., ::-1]))
    return out.astype(np.float32) / 255.0


def psnr_rows(orig_yuv, rec_yuv):
    mse = float(np.mean((rec_yuv - orig_yuv) ** 2))
    wts = np.array([6, 1, 1]) / 8
    mse_yuv = float(np.average(
        np.mean((rec_yuv - orig_yuv) ** 2, axis=(0, 1, 2)), weights=wts))
    return (round(10 * np.log10(1.0 / mse), 2),
            round(10 * np.log10(1.0 / mse_yuv), 2))


def per_frame_rows(frames_rgb, orig_yuv, n_pix):
    """JPEG applied frame by frame (an intra-only image codec)."""
    rows = []
    for q in QUALITIES:
        bits = 0
        dec = []
        for f in frames_rgb:
            buf = jpeg.encode(f[..., ::-1], q)
            bits += 8 * len(buf)
            dec.append(jpeg.decode(buf, "color")[..., ::-1])
        p, p_w = psnr_rows(orig_yuv, to_yuv_float(np.stack(dec)))
        rows.append({"codec": "jpeg-per-frame", "q": q, "inter": False,
                     "bpp": round(bits / n_pix, 4), "psnr_db": p,
                     "psnr_yuv_weighted_db": p_w})
    return rows


def smoe_row(smoe_file, orig_yuv, n_pix, device):
    from smoe_tpu_torch.codec.serve import decode_bitstream
    bits = os.path.getsize(smoe_file) * 8
    rec = np.asarray(decode_bitstream(smoe_file, device=device))
    # the serving decode returns (H, W, T, C); orig_yuv is (T, H, W, C)
    rec = np.moveaxis(rec.reshape(orig_yuv.shape[1], orig_yuv.shape[2],
                                  orig_yuv.shape[0], orig_yuv.shape[3]),
                      2, 0)
    p, p_w = psnr_rows(orig_yuv, rec)
    return {"codec": "smoe", "q": None, "inter": True,
            "bpp": round(bits / n_pix, 4), "psnr_db": p,
            "psnr_yuv_weighted_db": p_w, "file": smoe_file}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--texture", type=str, default="synth",
                    choices=["synth", "hopper"])
    ap.add_argument("--static", action="store_true")
    ap.add_argument("--smoe", type=str, default=None,
                    help="optional .smoe bitstream of this clip to score "
                         "on the same metric")
    ap.add_argument("--rot", type=float, default=0.0,
                    help="rotating-foreground clip variant (must match the "
                         "bench.video_quality --rot being anchored)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args.device) if args.smoe else args.device
    print(f"anchor_video: {BLOCKED}", file=sys.stderr, flush=True)

    from smoe_tpu_torch.apps.content import build_video
    vid, _ = build_video(moving_obj=not args.static, texture=args.texture,
                         rot=args.rot)
    # the exact uint8 RGB frames bench/video_quality.py writes to the .npz
    frames_rgb = np.moveaxis((vid * 255).astype(np.uint8), 2, 0)
    orig_yuv = to_yuv_float(frames_rgb)
    n_pix = int(np.prod(frames_rgb.shape[:3]))

    clip = {"texture": args.texture,
            "motion": "static-pan" if args.static
            else (f"moving-obj-rot{args.rot:g}" if args.rot
                  else "moving-obj")}
    rows = []
    for row in per_frame_rows(frames_rgb, orig_yuv, n_pix):
        rows.append({**clip, **row})
        print(json.dumps(rows[-1]), flush=True)
    if args.smoe:
        rows.append({**clip, **smoe_row(args.smoe, orig_yuv, n_pix, device)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
