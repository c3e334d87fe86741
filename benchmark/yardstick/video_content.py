"""The video cell's input: a frozen copy of the port's
`apps/content.py:build_video` (scripts/bench_video.py:18-94) with its noise
drawn from the run's seed, and the read `cli.fit` makes of the recipe's
.npz bundle (`bench/video_quality.py` saves the clip as uint8 RGB frames;
`io/images.py:read_image` turns them into YUV with OpenCV's integer
coefficients and scales by 1 / 255).  Seed 0 gives `build_video`'s clip
bit for bit."""

from __future__ import annotations

import numpy as np

# OpenCV's RGB -> YUV coefficients, scaled by 2^14 (cv2.COLOR_BGR2YUV)
_SHIFT = 14
_C_BY, _C_GY, _C_RY, _C_RV, _C_BU = 1868, 9617, 4899, 14369, 8061


def cif_clip(h: int, w: int, t: int, shift: float, moving_obj: bool,
             seed: int):
    """The panning sinusoid canvas, `shift` pixels a frame, with a textured
    square moving against the pan where `moving_obj`.  Returns (vid (h, w,
    t, 3) float32 RGB in [0, 1], affines (t, 2, 3))."""
    rng = np.random.default_rng(seed)
    wide_w = w + int(shift * t) + 4
    y, x = np.mgrid[0:h, 0:wide_w]
    y = y / (h - 1)
    x = x / (w - 1)
    wide = np.stack([
        0.5 + 0.3 * np.sin(6 * x + 2 * y),
        0.5 + 0.25 * np.cos(4 * x * y + 1.0),
        0.4 + 0.3 * np.sin(3 * (x + y)),
    ], axis=-1).astype(np.float32)
    wide += rng.normal(0, 0.005, wide.shape).astype(np.float32)
    frames = [wide[:, int(shift * i):int(shift * i) + w].copy()
              for i in range(t)]
    if moving_obj:
        oy, ox, s = 60, 40, 56
        yy, xx = np.mgrid[0:s, 0:s] / (s - 1)
        patch = np.stack([0.2 + 0.6 * yy, 0.7 - 0.5 * xx,
                          0.5 + 0.4 * yy * xx], -1).astype(np.float32)
        for i in range(t):
            py, px = oy + 6 * i, ox + 9 * i
            frames[i][py:py + s, px:px + s] = patch
    vid = np.clip(np.stack(frames, axis=2), 0, 1)
    affines = np.zeros((t, 2, 3), np.float32)
    affines[:, 0, 0] = 1.0
    affines[:, 1, 1] = 1.0
    affines[:, 0, 2] = -shift * np.arange(t)
    return vid, affines


def as_fit_reads_it(vid: np.ndarray) -> np.ndarray:
    """What `cli.fit` trains on from the clip: the uint8 frames the recipe
    writes (truncated, `(vid * 255).astype(np.uint8)`), in YUV through
    OpenCV's integer path (rounded, chroma offset 128, saturating), over
    255 as float32."""
    rgb = (vid * 255).astype(np.uint8)
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half = 1 << (_SHIFT - 1)
    delta = 128 << _SHIFT
    y = (b * _C_BY + g * _C_GY + r * _C_RY + half) >> _SHIFT
    u = ((b - y) * _C_BU + delta + half) >> _SHIFT
    v = ((r - y) * _C_RV + delta + half) >> _SHIFT
    yuv = np.clip(np.stack([y, u, v], -1), 0, 255).astype(np.uint8)
    return yuv.astype(np.float32) / 255.0


def build(content: dict, seed: int):
    """(the volume the fit reads (H, W, T, 3) YUV, affines (T, 2, 3)) of a
    configuration's `content`: {"family": "cif_video", "height", "width",
    "frames", "shift", "moving_obj"}."""
    if content["family"] != "cif_video":
        raise ValueError(f"unknown video family {content['family']!r}")
    vid, affines = cif_clip(int(content["height"]), int(content["width"]),
                            int(content["frames"]), float(content["shift"]),
                            bool(content["moving_obj"]), seed)
    return as_fit_reads_it(vid), affines
