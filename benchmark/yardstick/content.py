"""The benchmark's input images: frozen copies of the port's
`apps/content.py:build_image` (bench.py:29-44) and `build_4k`
(scripts/bench_4k.py:23-36), with the noise drawn from the run's seed.
Seed 0 gives the scripts' images bit for bit."""

from __future__ import annotations

import numpy as np


def bench_image(size: int, seed: int) -> np.ndarray:
    """The sinusoid + blocks + noise headline image, size x size RGB."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size] / (size - 1)
    img = np.stack([
        0.5 + 0.3 * np.sin(4 * x + 1.5 * y),
        0.5 + 0.25 * np.cos(3 * (x - 0.3) * (y + 0.4) * 4),
        0.4 + 0.3 * np.sin(5 * x * y),
    ], axis=-1)
    img[size // 4:size // 2, size // 3:size // 2, 0] += 0.2
    img[size // 2:, : size // 4, 1] -= 0.15
    img += rng.normal(0, 0.005, img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


def uhd_image(h: int, w: int, seed: int) -> np.ndarray:
    """The 4K scaling image at h x w (2160 x 3840 in the script); the
    blocks scale with the raster."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    y = y / (h - 1)
    x = x / (w - 1)
    img = np.stack([
        0.5 + 0.3 * np.sin(6 * x + 2 * y),
        0.5 + 0.25 * np.cos(7 * x * y + 1.0),
        0.4 + 0.3 * np.sin(4 * (x + y)),
    ], axis=-1)
    img[h * 400 // 2160:h * 1000 // 2160, w * 800 // 3840:w * 1800 // 3840,
        0] += 0.2
    img[h * 1200 // 2160:, w * 2400 // 3840:, 1] -= 0.15
    img += rng.normal(0, 0.005, img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


def build(content: dict, seed: int) -> np.ndarray:
    """The image a configuration's `content` names: {"family": "bench",
    "size": n} or {"family": "uhd", "height": h, "width": w}."""
    fam = content["family"]
    if fam == "bench":
        return bench_image(int(content["size"]), seed)
    if fam == "uhd":
        return uhd_image(int(content["height"]), int(content["width"]), seed)
    raise ValueError(f"unknown content family {fam!r}")
