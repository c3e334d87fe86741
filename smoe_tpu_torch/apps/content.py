"""Content: the families of the RD curve and the demos (from
scripts/content.py, and bench.py:29-44's build_image), and the bench
inputs: images, clips and light fields (scripts/bench_1080p.py,
bench_4k.py, bench_video.py, bench_lf.py).

  bench   - the sinusoid + blocks + noise headline image
  pink    - 1/f spectral field (natural-image second-order statistics)
  mosaic  - piecewise-constant Voronoi cells (cartoon / graphics class)
  text    - high-contrast thin strokes on a smooth gradient (screen
            content / document class)
  hopper  - a real photograph (matplotlib's grace_hopper.jpg), centre
            crop, area-resized (cubic above its 512 x 512 crop)
  mri     - a real MRI head slice (s1045.ima.gz), one channel
  dem     - real terrain elevation (jacksboro_fault_dem.npz), one channel

Each is deterministic, float32 in [0, 1], and the same array bit for bit
as the JAX package's script gives.  The photographs are read from
sample_data/ beside this module (byte copies of matplotlib's sample data,
carried by scripts/make_torch_photo_data.py) with numpy alone: the JPEG
through io/jpeg.py, OpenCV's resize and warpAffine through apps/cv.py's
copies; neither matplotlib nor cv2 is imported.  Where a script upsizes
(cv2's INTER_CUBIC), resize_cubic follows OpenCV's own resize code, which
an OpenCV built with Intel IPP replaces by IPP's except for a uint8
resize by a whole factor (apps/cv.py).
"""

from __future__ import annotations

import gzip
import os

import numpy as np

from smoe_tpu_torch.apps.cv import (resize_area, resize_cubic,
                                    rotation_matrix,
                                    warp_affine_linear_reflect)
from smoe_tpu_torch.io.jpeg import read_jpeg

SAMPLE_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "sample_data")
FAMILIES = ("bench", "pink", "mosaic", "text", "hopper", "mri", "dem")


def build_image(size=512):
    """Deterministic structured test image (edges + smooth texture +
    gradients) representable at 32+ dB by the benchmark kernel budget."""
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:size, 0:size] / (size - 1)
    img = np.stack([
        0.5 + 0.3 * np.sin(4 * x + 1.5 * y),
        0.5 + 0.25 * np.cos(3 * (x - 0.3) * (y + 0.4) * 4),
        0.4 + 0.3 * np.sin(5 * x * y),
    ], axis=-1)
    # blocky structure (codec-relevant edges)
    img[size // 4:size // 2, size // 3:size // 2, 0] += 0.2
    img[size // 2:, : size // 4, 1] -= 0.15
    img += rng.normal(0, 0.005, img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


def build_pink(size=256, seed=7, beta=1.8):
    """1/f^beta spectral field per channel: the classic natural-image
    power-law statistics (beta ~ 1.8-2.0)."""
    rng = np.random.default_rng(seed)
    fy = np.fft.fftfreq(size)[:, None]
    fx = np.fft.fftfreq(size)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0 / size
    amp = f ** (-beta / 2.0)
    chans = []
    for _ in range(3):
        phase = rng.uniform(0, 2 * np.pi, (size, size))
        spec = amp * np.exp(1j * phase)
        x = np.real(np.fft.ifft2(spec))
        x = (x - x.min()) / (x.max() - x.min() + 1e-12)
        chans.append(x)
    img = np.stack(chans, axis=-1).astype(np.float32)
    # correlate the channels like natural content (shared luminance)
    lum = img.mean(-1, keepdims=True)
    return np.clip(0.7 * lum + 0.3 * img, 0, 1).astype(np.float32)


def build_mosaic(size=256, seed=11, cells=40):
    """Piecewise-constant Voronoi mosaic (cartoon class: flat regions,
    sharp irregular boundaries)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, size, (cells, 2))
    cols = rng.uniform(0.1, 0.9, (cells, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    d2 = ((yy[..., None] - pts[:, 0]) ** 2
          + (xx[..., None] - pts[:, 1]) ** 2)
    img = cols[np.argmin(d2, axis=-1)]
    img += rng.normal(0, 0.003, img.shape).astype(np.float32)
    return np.clip(img, 0, 1).astype(np.float32)


def build_text(size=256, seed=13):
    """Glyph-like thin strokes on a smooth two-tone gradient (screen /
    document content): high-contrast 1-3 px structures at many
    orientations, no font dependency."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size] / (size - 1)
    img = np.stack([0.75 + 0.15 * x - 0.1 * y,
                    0.78 + 0.1 * (x + y) / 2,
                    0.8 - 0.12 * x], axis=-1).astype(np.float32)
    ink = np.zeros((size, size), bool)
    n_glyphs = max(6, size // 18) ** 2

    def stamp_line(r0, c0, r1, c1, w):
        n = int(max(abs(r1 - r0), abs(c1 - c0))) + 1
        rr = np.clip(np.linspace(r0, r1, n).astype(int), 0, size - 1)
        cc = np.clip(np.linspace(c0, c1, n).astype(int), 0, size - 1)
        for dy in range(w):
            for dx in range(w):
                ink[np.clip(rr + dy, 0, size - 1),
                    np.clip(cc + dx, 0, size - 1)] = True

    grid = int(np.sqrt(n_glyphs))
    cell = size // grid
    for gi in range(grid):
        for gj in range(grid):
            if rng.uniform() < 0.25:          # word spacing
                continue
            r, c = gi * cell + 2, gj * cell + 2
            h, w = int(cell * 0.6), int(cell * 0.5)
            for _ in range(rng.integers(2, 5)):   # strokes per glyph
                p = rng.integers(0, [h, w], 2)
                q = rng.integers(0, [h, w], 2)
                stamp_line(r + p[0], c + p[1], r + q[0], c + q[1],
                           max(1, size // 256))
    img[ink] = np.float32([0.08, 0.08, 0.12])
    return np.clip(img, 0, 1).astype(np.float32)


def _sample(name: str) -> str:
    return os.path.join(SAMPLE_DATA, name)


def hopper_photo(gray: bool = False):
    """grace_hopper.jpg as cv2.imread decodes it: (600, 512, 3) uint8 BGR
    (IMREAD_COLOR), or libjpeg's own (600, 512) grayscale decode
    (IMREAD_GRAYSCALE), which is not the colour decode's cvtColor."""
    return read_jpeg(_sample("grace_hopper.jpg"),
                     "gray" if gray else "color")


def _resize(img, size: int, s: int):
    """scripts/content.py's resize of an s x s crop to size x size:
    INTER_AREA below s, INTER_CUBIC above."""
    fn = resize_area if size < s else resize_cubic
    return fn(img, (size, size))


def build_hopper(size=256):
    """scripts/content.py:36-54: the photograph (portrait: skin, fabric,
    flag stripes, sharp insignia), centre-cropped square and resized."""
    bgr = hopper_photo()
    h, w = bgr.shape[:2]
    s = min(h, w)
    r0, c0 = (h - s) // 2, (w - s) // 2
    crop = _resize(bgr[r0:r0 + s, c0:c0 + s], size, s)
    rgb = crop[..., ::-1].astype(np.float32) / 255.0
    return np.clip(rgb, 0, 1)


def build_mri(size=256):
    """scripts/content.py:64-75: the MRI head slice, 256 x 256 big-endian
    uint16 (values 0..215), divided by its maximum; one channel."""
    with gzip.open(_sample("s1045.ima.gz")) as f:
        a = np.frombuffer(f.read(), np.uint16).reshape(256, 256).byteswap()
    img = (a / float(a.max())).astype(np.float32)
    if size != 256:
        img = _resize(img, size, 256)
    return np.clip(img, 0, 1)[..., None]


def build_dem(size=256):
    """scripts/content.py:78-90: the terrain elevation (344 x 403 int16),
    centre-cropped square, min-max normalised; one channel."""
    with np.load(_sample("jacksboro_fault_dem.npz")) as z:
        a = z["elevation"].astype(np.float32)
    h, w = a.shape
    s = min(h, w)
    r0, c0 = (h - s) // 2, (w - s) // 2
    a = a[r0:r0 + s, c0:c0 + s]
    if size != s:
        a = _resize(a, size, s)
    a = (a - a.min()) / (a.max() - a.min() + 1e-12)
    return np.clip(a, 0, 1).astype(np.float32)[..., None]


def build_family(name: str, size=256):
    builders = {"bench": build_image, "pink": build_pink,
                "mosaic": build_mosaic, "text": build_text,
                "hopper": build_hopper, "mri": build_mri, "dem": build_dem}
    if name not in builders:
        raise ValueError(f"unknown content family {name!r}; "
                         f"choose from {FAMILIES}")
    return builders[name](size)


def build_1080p():
    """scripts/bench_1080p.py:17-31: the 1920x1080 RGB block-fit image."""
    rng = np.random.default_rng(0)
    h, w = 1080, 1920
    y, x = np.mgrid[0:h, 0:w]
    y = y / (h - 1)
    x = x / (w - 1)
    img = np.stack([
        0.5 + 0.3 * np.sin(4 * x + 1.5 * y),
        0.5 + 0.25 * np.cos(5 * x * y + 1.0),
        0.4 + 0.3 * np.sin(3 * (x + y)),
    ], axis=-1)
    img[200:500, 400:900, 0] += 0.2
    img[600:, 1200:, 1] -= 0.15
    img += rng.normal(0, 0.005, img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


def build_4k():
    """scripts/bench_4k.py:23-36: the 3840x2160 RGB scaling image."""
    rng = np.random.default_rng(0)
    h, w = 2160, 3840
    y, x = np.mgrid[0:h, 0:w]
    y = y / (h - 1)
    x = x / (w - 1)
    img = np.stack([
        0.5 + 0.3 * np.sin(6 * x + 2 * y),
        0.5 + 0.25 * np.cos(7 * x * y + 1.0),
        0.4 + 0.3 * np.sin(4 * (x + y)),
    ], axis=-1)
    img[400:1000, 800:1800, 0] += 0.2
    img[1200:, 2400:, 1] -= 0.15
    img += rng.normal(0, 0.005, img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


def build_video(h=288, w=352, t=8, shift=2.0, moving_obj=False,
                texture="synth", rot=0.0):
    """scripts/bench_video.py:18-94: the CIF panning scene, a canvas panned
    by `shift` pixels a frame with its known per-frame affines: the
    sinusoid canvas, or with texture="hopper" the photograph's centre.
    moving_obj adds a textured square moving against the pan, which global
    motion cannot explain (on the photograph a patch of its far corner);
    rot turns that square by rot * i degrees in frame i (bilinear,
    reflected border), motion neither the global model nor a rigidly
    tracking kernel cloud explains.  Returns (vid (h, w, t, 3) float32 RGB
    in [0, 1], affines (t, 2, 3))."""
    rng = np.random.default_rng(0)
    wide_w = w + int(shift * t) + 4
    if texture == "hopper":
        bgr = hopper_photo()
        ph, pw = bgr.shape[:2]                     # 600 x 512
        if ph < h or pw < wide_w:
            sc = max(h / ph, wide_w / pw)
            bgr = resize_cubic(bgr, (int(np.ceil(pw * sc)),
                                     int(np.ceil(ph * sc))))
            ph, pw = bgr.shape[:2]
        r0, c0 = (ph - h) // 2, (pw - wide_w) // 2
        wide = (bgr[r0:r0 + h, c0:c0 + wide_w, ::-1].astype(np.float32)
                / 255.0)
    else:
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
        if texture == "hopper":
            patch = wide[-s:, :s].copy()
        else:
            yy, xx = np.mgrid[0:s, 0:s] / (s - 1)
            patch = np.stack([0.2 + 0.6 * yy, 0.7 - 0.5 * xx,
                              0.5 + 0.4 * yy * xx], -1).astype(np.float32)
        for i in range(t):
            py, px = oy + 6 * i, ox + 9 * i       # against the pan
            p_i = patch
            if rot:
                m = rotation_matrix(((s - 1) / 2, (s - 1) / 2), rot * i, 1.0)
                p_i = warp_affine_linear_reflect(patch, m, (s, s))
            frames[i][py:py + s, px:px + s] = p_i
    vid = np.clip(np.stack(frames, axis=2), 0, 1)
    affines = np.zeros((t, 2, 3), np.float32)
    affines[:, 0, 0] = 1.0
    affines[:, 1, 1] = 1.0
    affines[:, 0, 2] = -shift * np.arange(t)
    return vid, affines


def build_lf(views: int = 15, s: int = 48, seed: int = 3,
             texture: str = "synth"):
    """scripts/bench_lf.py:28-79: a (views, views, s, s, 1) grayscale light
    field in [0, 1] with two disparity planes, a textured background at
    +1.5 px a view and a foreground square at -2.5 px a view, each view an
    exact shift; texture="hopper" takes both planes from the photograph's
    grayscale decode (the background from its centre, the foreground from
    its top-left corner)."""
    rng = np.random.default_rng(seed)
    pad = int(3.0 * views) + 8
    side = s + 2 * pad
    if texture == "hopper":
        g = hopper_photo(gray=True).astype(np.float32) / 255.
        if min(g.shape) < side:
            sc = side / min(g.shape)
            g = resize_cubic(g, (int(np.ceil(g.shape[1] * sc)),
                                 int(np.ceil(g.shape[0] * sc))))
        gh, gw = g.shape
        tex = g[(gh - side) // 2:(gh - side) // 2 + side,
                (gw - side) // 2:(gw - side) // 2 + side].copy()
        ftex = g[:side, :side].copy()
    else:
        yy, xx = np.mgrid[0:side, 0:side] / s
        tex = (0.55 + 0.25 * np.sin(5.1 * yy + 1.0) * np.cos(4.3 * xx)
               + 0.12 * np.sin(11.0 * (yy + xx)))
        ftex = 0.35 + 0.3 * np.cos(7.0 * yy) * np.sin(6.2 * xx + 0.5)
    lf = np.empty((views, views, s, s), np.float32)
    uc = (views - 1) / 2
    d_bg, d_fg = 1.5, -2.5
    fy0, fx0, fs = int(0.30 * s), int(0.36 * s), int(0.30 * s)
    for u in range(views):
        for v in range(views):
            oy_b = pad + int(round(d_bg * (u - uc)))
            ox_b = pad + int(round(d_bg * (v - uc)))
            view = tex[oy_b:oy_b + s, ox_b:ox_b + s].copy()
            oy_f = pad + int(round(d_fg * (u - uc)))
            ox_f = pad + int(round(d_fg * (v - uc)))
            fg = ftex[oy_f:oy_f + s, ox_f:ox_f + s]
            view[fy0:fy0 + fs, fx0:fx0 + fs] = fg[fy0:fy0 + fs,
                                                  fx0:fx0 + fs]
            lf[u, v] = view
    lf += rng.normal(0, 0.004, lf.shape).astype(np.float32)
    return np.clip(lf, 0.0, 1.0)[..., None]
