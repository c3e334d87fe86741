"""Classical-codec anchors for the 4D light-field modality (from
scripts/anchor_lf.py): per-view JPEG quality sweeps on the same light
field and the same metric as bench/lf.py.

The content is bench/lf.py's: grayscale (views, views, s, s, 1) in
[0, 1]; PSNR over all views and over the reference-trained views (the
corner mask, fit/blocks.py:_lf_train_mask); bpp over all views' pixels.
The anchors are scored against the uint8 rounding of the float light
field, which is what they encode (its floor, ~52 dB, is above every point
here).  JPEG is io/jpeg.py's, which writes and reads OpenCV's bytes and
pixels bit for bit.  The script's other rows (per-view WebP; the
boustrophedon pseudo-video through cv2.VideoWriter's MJPG, mp4v, XVID and
VP9) need OpenCV's codecs and are not emitted (ROADMAP.md, "Blocked, not
queued"); each run says so on stderr.

    python -m smoe_tpu_torch.apps.anchor_lf [--s 24] [--texture synth|hopper]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from smoe_tpu_torch.apps.anchor_jpeg import QUALITIES
from smoe_tpu_torch.io import jpeg

BLOCKED = ("not emitted: the per-view WebP rows and the pseudo-video rows "
           "through cv2.VideoWriter (MJPG, mp4v, XVID, VP90); ROADMAP.md, "
           "\"Blocked, not queued\"")


def psnr_pair(orig, rec, train_mask):
    err2 = (rec.astype(np.float64) - orig.astype(np.float64)) ** 2
    return (round(10 * np.log10(1.0 / max(err2[train_mask].mean(), 1e-12)),
                  2),
            round(10 * np.log10(1.0 / max(err2.mean(), 1e-12)), 2))


def per_view_rows(views_u8, orig, tm, n_pix):
    """JPEG (native grayscale) applied view by view."""
    u, v = views_u8.shape[:2]
    rows = []
    for q in QUALITIES:
        bits = 0
        rec = np.empty_like(views_u8)
        for i in range(u):
            for j in range(v):
                buf = jpeg.encode(views_u8[i, j], q)
                bits += 8 * len(buf)
                rec[i, j] = jpeg.decode(buf, "gray")
        p_tr, p_all = psnr_pair(orig, rec / 255.0, tm)
        rows.append({"codec": "jpeg-per-view", "q": q, "inter": False,
                     "bpp": round(bits / n_pix, 4),
                     "psnr_trained_db": p_tr, "psnr_all_db": p_all})
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--s", type=int, default=24, help="spatial size")
    ap.add_argument("--texture", type=str, default="synth",
                    choices=["synth", "hopper"])
    args = ap.parse_args(argv)
    print(f"anchor_lf: {BLOCKED}", file=sys.stderr, flush=True)

    from smoe_tpu_torch.apps.content import build_lf
    from smoe_tpu_torch.fit.blocks import _lf_train_mask

    lf = build_lf(s=args.s, texture=args.texture)[..., 0]   # (15,15,s,s)
    views_u8 = np.round(lf * 255.0).astype(np.uint8)
    orig = views_u8 / 255.0
    tm = _lf_train_mask(lf.shape[:2])
    n_pix = int(np.prod(lf.shape))

    meta = {"s": args.s, "texture": args.texture}
    rows = []
    for row in per_view_rows(views_u8, orig, tm, n_pix):
        rows.append({**meta, **row})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
