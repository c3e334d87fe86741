"""Record the JAX package's classical-anchor scripts (cv2's JPEG) and its
SMoE anchor rows, for the PyTorch port's anchors (smoe_tpu_torch/apps/
anchor_jpeg.py, anchor_video.py, anchor_lf.py) and its JPEG codec and
cubic resize to be held against on a machine without cv2.

    JAX_PLATFORMS=cpu python scripts/make_torch_anchor_fixture.py   # ~10 min

Needs cv2, matplotlib and JAX.  Writes tests/data/anchor_ref.json:
    jpeg_rows     scripts/anchor_jpeg.py's JPEG rows for the bench,
                  hopper, mri and dem families at 256 (its --family runs)
    video_rows    scripts/anchor_video.py's per-frame JPEG rows of the
                  synth and hopper clips (moving object, no rotation)
    lf_rows       scripts/anchor_lf.py's per-view JPEG rows at s = 24,
                  synth and hopper
    smoe_rows     scripts/anchor_jpeg.py's SMoE rows on this CPU at
                  BASELINE.md:15-16's flags: dem --fit 5000 --k 12 --lsri
                  100 --auto, mri --fit 5000 --k 12 --auto
    upsized_sha256      the scripts' upsized content (hopper 1024, mri
                        512, dem 512, build_lf(s=520, texture="hopper"))
                        through OpenCV's own resize code
                        (cv2.ipp.setUseIPP(False))
    upsized_sha256_ipp  the same with cv2's default, Intel IPP's resize
    hopper_decode_sha256    cv2.imread of grace_hopper.jpg, IMREAD_COLOR
                            and IMREAD_GRAYSCALE
    hopper256_q90_jpeg      sha256 and length of cv2.imencode('.jpg') of
                            build_hopper(256) (BGR uint8) at quality 90
Only JPEG rows are kept: the WebP and cv2.VideoWriter rows are not ported
(ROADMAP.md, "Blocked, not queued").
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("bench", "hopper", "mri", "dem")
SMOE_FLAGS = {"dem": {"k": 12, "lsri": 100, "auto": True},
              "mri": {"k": 12, "lsri": 0, "auto": True}}


def script(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sha256(a) -> str:
    if isinstance(a, (bytes, bytearray)):
        return hashlib.sha256(a).hexdigest()
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def family_u8(content, family, size=256):
    return np.uint8(content.build_family(family, size) * 255)


def upsized(content, lf):
    return {"hopper_1024": content.build_hopper(1024),
            "mri_512": content.build_mri(512),
            "dem_512": content.build_dem(512),
            "lf_hopper_520": lf.build_lf(s=520, texture="hopper")}


def video_frames(video, texture):
    vid, _ = video.build_video(moving_obj=True, texture=texture)
    return np.moveaxis((vid * 255).astype(np.uint8), 2, 0)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--smoe-iters", type=int, default=5000)
    p.add_argument("-o", "--out", default=os.path.join(
        ROOT, "tests", "data", "anchor_ref.json"))
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import cv2
    import jax
    jax.config.update("jax_platforms", "cpu")

    content, video, lf = (script(n) for n in
                          ("content", "bench_video", "bench_lf"))
    aj, av, al = (script(n) for n in
                  ("anchor_jpeg", "anchor_video", "anchor_lf"))
    from smoe_tpu.fit.blocks import _lf_train_mask

    rec = {"cv2": cv2.__version__, "jax": jax.__version__}
    rec["jpeg_rows"] = {}
    for fam in FAMILIES:
        img = family_u8(content, fam)
        rows = aj.anchor_rows(img, int(np.prod(img.shape[:-1])))
        rec["jpeg_rows"][fam] = [{"family": fam, **r} for r in rows
                                 if r["codec"] == "jpeg"]
    rec["video_rows"] = {}
    for tex in ("synth", "hopper"):
        frames = video_frames(video, tex)
        rows = av.per_frame_rows(frames, av.to_yuv_float(frames),
                                 int(np.prod(frames.shape[:3])))
        rec["video_rows"][tex] = [
            {"texture": tex, "motion": "moving-obj", **r} for r in rows
            if r["codec"] == "jpeg-per-frame"]
    rec["lf_rows"] = {}
    for tex in ("synth", "hopper"):
        x = lf.build_lf(s=24, texture=tex)[..., 0]
        views = np.round(x * 255.0).astype(np.uint8)
        rows = al.per_view_rows(views, views / 255.0,
                                _lf_train_mask(x.shape[:2]),
                                int(np.prod(x.shape)))
        rec["lf_rows"][tex] = [{"s": 24, "texture": tex, **r} for r in rows
                               if r["codec"] == "jpeg-per-view"]
    cv2.ipp.setUseIPP(False)
    rec["upsized_sha256"] = {k: sha256(v)
                             for k, v in upsized(content, lf).items()}
    cv2.ipp.setUseIPP(True)
    rec["upsized_sha256_ipp"] = {k: sha256(v)
                                 for k, v in upsized(content, lf).items()}
    path = content._sample_data("grace_hopper.jpg")
    rec["hopper_decode_sha256"] = {
        "bgr": sha256(cv2.imread(path, cv2.IMREAD_COLOR)),
        "gray": sha256(cv2.imread(path, cv2.IMREAD_GRAYSCALE))}
    bgr = family_u8(content, "hopper")[..., ::-1]
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(bgr),
                           [cv2.IMWRITE_JPEG_QUALITY, 90])
    rec["hopper256_q90_jpeg"] = {"sha256": sha256(buf.tobytes()),
                                 "bytes": int(buf.size)}
    rec["smoe_rows"] = {}
    for fam, kw in SMOE_FLAGS.items():
        t0 = time.time()
        row = aj.smoe_row(family_u8(content, fam), a.smoe_iters, **kw)
        rec["smoe_rows"][fam] = {"family": fam, **row,
                                 "cpu_s": round(time.time() - t0, 1)}
        print(fam, json.dumps(rec["smoe_rows"][fam]), flush=True)
    with open(a.out, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print("wrote", a.out)


if __name__ == "__main__":
    main()
