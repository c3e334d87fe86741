"""Write the still fixtures that the PyTorch port's readers are held to
on a machine without OpenCV, and record what OpenCV and the JAX reader
make of each.  Needs cv2 and PIL, so it runs where they are installed;
the card's machine reads the files and the record.

    JAX_PLATFORMS=cpu python scripts/make_torch_still_fixtures.py  # ~5 s
    JAX_PLATFORMS=cpu python scripts/make_torch_still_fixtures.py --cli
                               # + the JAX CLI on the DEM, ~20 min

Writes tests/data/stills/ (one small file a kind, 37 x 53 and odd sizes,
8- and 16-bit, gray and colour, plus):
    dem16.tif        round(build_dem(256) * 65535) as uint16, LZW with
                     predictor 2 (cv2.imwrite)
    hopper_prog.jpg  build_hopper(256) as a progressive q 90 JPEG
and tests/data/stills_ref.json:
    files[name]      sha256 of the file; cv2.imread's IMREAD_UNCHANGED
                     and IMREAD_COLOR arrays (sha256, dtype, shape);
                     smoe_tpu.io.images.read_image(path)'s array (sha256,
                     shape) and precision
    cli[name]        with --cli: the JAX CLI's recipe on dem16.tif and on
                     dem8.png (build_dem(256) as an 8-bit PNG, not kept):
                     `cli.fit -k 12 -n N -lsinit auto -lsri 100 -iukl 1`,
                     the automatic encode, the decode
                     (scripts/make_torch_photo_cli_record.py:cli_record)
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import io
import json
import os
import platform
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "stills")
REF = os.path.join(ROOT, "tests", "data", "stills_ref.json")
H, W = 37, 53


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sha256(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _picture(h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([0.5 + 0.4 * np.sin(5 * x + 2 * y),
                     0.5 + 0.3 * np.cos(7 * x * y), 0.4 + 0.3 * y], -1)
    return np.clip(base * 255 + rng.normal(0, 20, base.shape), 0,
                   255).astype(np.uint8)


def write_files(content) -> list:
    """Every fixture file; returns their names."""
    import cv2
    from PIL import Image
    from tests.torch_still_writers import first_scans, write_png, write_tiff
    rng = np.random.default_rng(16)
    os.makedirs(OUT, exist_ok=True)
    files = {}

    def u(shape, hi):
        return rng.integers(0, hi, shape)
    pic = _picture()

    def png(name, s, color, depth, **kw):
        write_png(os.path.join(OUT, name), s, color, depth,
                  filters=(0, 1, 2, 3, 4), **kw)
        files[name] = None
    png("png_gray1.png", u((H, W, 1), 2), 0, 1)
    png("png_gray4_adam7.png", u((H, W, 1), 16), 0, 4, interlace=1)
    png("png_palette4_trns.png", u((H, W, 1), 16), 3, 4,
        plte=u((16, 3), 256), trns=bytes(range(0, 256, 32)))
    png("png_palette8_adam7.png", u((H, W, 1), 256), 3, 8, interlace=1,
        plte=u((256, 3), 256))
    h, w = 19, 27              # the 16-bit colour kinds, kept small
    key = u((3,), 65536)
    rgb16 = u((h, w, 3), 65536)
    rgb16[5, 7] = key
    png("png_rgb16_trns.png", rgb16, 2, 16,
        trns=b"".join(int(v).to_bytes(2, "big") for v in key))
    png("png_gray_alpha8_adam7.png", u((H, W, 2), 256), 4, 8, interlace=1)
    png("png_rgba16.png", u((h, w, 4), 65536), 6, 16)
    g8, c16, bits = u((H, W), 256), u((H, W, 3), 65536), u((H, W), 2)
    pnm = {
        "pnm_p1.pgm": f"P1\n# bitmap\n{W} {H}\n".encode() + "\n".join(
            "".join(str(int(v)) for v in row) for row in bits).encode(),
        "pnm_p2_100.pgm": f"P2\n# ascii\n{W} {H}\n100\n".encode() + " ".join(
            str(int(v)) for v in (g8 % 120).reshape(-1)).encode() + b"\n",
        "pnm_p3_65535.ppm": f"P3 {w} {h}\n# comment\n65535\n".encode()
        + "\n".join(" ".join(str(int(v)) for v in row)
                    for row in c16[:h, :w].reshape(h, -1)).encode()
        + b"\n",
        "pnm_p4.ppm": f"P4 {W} {H}\n".encode() + np.packbits(
            bits.astype(np.uint8), axis=1).tobytes()}
    for name, data in pnm.items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        files[name] = None
    dem = content.build_family("dem", 256)[..., 0]
    dem16 = np.uint16(np.round(dem * 65535))
    cv2.imwrite(os.path.join(OUT, "dem16.tif"), dem16,
                [cv2.IMWRITE_TIFF_COMPRESSION, 5,
                 cv2.IMWRITE_TIFF_PREDICTOR, 2])
    files["dem16.tif"] = None

    def tif(name, img, **kw):
        write_tiff(os.path.join(OUT, name), img, **kw)
        files[name] = None
    tif("tiff_rgb8_deflate_tiles_mm.tif", pic, order=">", compression=8,
        tile=(16, 32))
    tif("tiff_rgba8_unassoc_packbits.tif",
        np.concatenate([pic, u((H, W, 1), 256).astype(np.uint8)], -1),
        compression=32773, extra=[2], rows_per_strip=8)
    tif("tiff_float32_pred3.tif",
        rng.normal(0.5, 0.3, (H, W)).astype(np.float32), compression=8,
        predictor=3)
    tif("tiff_palette8.tif", g8.astype(np.uint8), photometric=3,
        colormap=u((256, 3), 65536), compression=5)
    tif("tiff_bilevel_white.tif", bits.astype(np.uint8), bps=1,
        photometric=0)
    tif("tiff_rgb8_planar.tif", pic, planar=2, compression=5,
        rows_per_strip=10)
    tif("tiff_graya8_tiles.tif", u((H, W, 2), 256).astype(np.uint8),
        extra=[2], tile=(16, 32))
    tif("tiff_gray16_tiles_lzw.tif", c16[..., 0].astype(np.uint16),
        compression=5, predictor=2, tile=(16, 16))
    hop = np.uint8(np.round(content.build_family("hopper", 256) * 255))
    ok, prog = cv2.imencode(".jpg", hop[..., ::-1], [
        cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    jpegs = {"hopper_prog.jpg": prog.tobytes()}
    ok, small = cv2.imencode(".jpg", pic, [cv2.IMWRITE_JPEG_QUALITY, 85,
                                           cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    jpegs["jpeg_prog_cut4.jpg"] = first_scans(small.tobytes(), 4)
    jpegs["jpeg_prog_dc.jpg"] = first_scans(small.tobytes(), 1)
    for s in ("411", "440"):
        ok, b = cv2.imencode(".jpg", pic, [
            cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{s}")])
        jpegs[f"jpeg_{s}.jpg"] = b.tobytes()
    buf = io.BytesIO()
    Image.fromarray(pic[..., ::-1]).convert("CMYK").save(buf, "JPEG",
                                                         quality=90)
    cmyk = buf.getvalue()
    i = cmyk.index(b"\xff\xee")
    jpegs["jpeg_cmyk.jpg"] = cmyk
    jpegs["jpeg_ycck.jpg"] = cmyk[:i + 15] + b"\x02" + cmyk[i + 16:]
    jpegs["jpeg_named.png"] = small.tobytes()
    ok, p = cv2.imencode(".png", pic)
    jpegs["png_named.tif"] = p.tobytes()
    for name, data in jpegs.items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        files[name] = None
    return sorted(files)


def record(names) -> dict:
    """Each file's sha256, cv2's decodes and the JAX reader's result."""
    import cv2
    from smoe_tpu.io.images import read_image
    out = {}
    for name in names:
        path = os.path.join(OUT, name)
        with open(path, "rb") as f:
            row = {"file_sha256": hashlib.sha256(f.read()).hexdigest()}
        for key, flag in (("unchanged", cv2.IMREAD_UNCHANGED),
                          ("color", cv2.IMREAD_COLOR)):
            a = cv2.imread(path, flag)       # None: cv2 reads no such
            row[key] = None if a is None else {
                "sha256": sha256(a), "dtype": str(a.dtype),
                "shape": list(a.shape)}
        img, prec, _ = read_image(path)
        row["read_image"] = {"sha256": sha256(img), "shape": list(img.shape),
                             "precision": prec}
        out[name] = row
    return out


def cli_records(content, sweeps: int) -> dict:
    """The JAX CLI's recipe on dem16.tif and on the 8-bit PNG of the same
    build_dem(256)."""
    import cv2
    rec = _script("make_torch_photo_cli_record")
    flags = ["-k", "12", "-n", str(sweeps), "-lsinit", "auto", "-lsri",
             "100", "-iukl", "1"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "dem8.png")
        dem = content.build_family("dem", 256)[..., 0]
        cv2.imwrite(png, np.uint8(np.round(dem * 255)))
        for name, path in (("dem16.tif", os.path.join(OUT, "dem16.tif")),
                           ("dem8.png", png)):
            out[name] = rec.cli_record(path, flags)
            out[name]["flags"] = flags
            print(name, json.dumps(out[name]), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cli", action="store_true",
                   help="also run the JAX CLI on the DEM at both depths")
    p.add_argument("--n", type=int, default=5000, help="the CLI's sweeps")
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    content = _script("content")
    names = write_files(content)
    ref = {}
    if os.path.exists(REF):
        with open(REF) as f:
            ref = json.load(f)
    ref.update({"files": record(names), "jax": jax.__version__,
                "host": platform.processor() or platform.machine()})
    if a.cli:
        ref["cli"] = cli_records(content, a.n)
    with open(REF, "w") as f:
        json.dump(ref, f, indent=1, sort_keys=True)
        f.write("\n")
    size = sum(os.path.getsize(os.path.join(OUT, n)) for n in names)
    print(f"wrote {len(names)} files ({size} bytes) and {REF}")


if __name__ == "__main__":
    main()
