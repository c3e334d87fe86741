"""Record the JAX CLI's 2D real-photograph recipe (BASELINE.md:14) on
build_hopper(256) for a few 1-ulp members of its init, for the PyTorch
port's members on the card to be set beside.

The recipe: `cli.fit -k 12 -n 5000 -lsinit auto -lsri 100 -iukl 1`, then
`cli.reconstruct` of params_best.pkl (the default automatic encode,
`--auto-bd 0.05 --prune 0`), then the serving decode of its model.smoe.
Member 0 is the plain init.  Member m > 0 moves a seeded half
(`default_rng(m)`) of nu_e up by 1 ulp right after the first LS init, as
chip_smoke.py's photo members move theirs (`photo_smoe`); the CLI is
run unedited, the move made through `Smoe.ls_init_experts`.

    JAX_PLATFORMS=cpu python scripts/make_torch_photo_cli_record.py  # ~1 h

Output (committed): tests/data/photo_cli_ref.json, one row a member:
    best_db        the fit's best validation PSNR (metrics.jsonl)
    decoded_db     10 log10(1 / mse) of the decode against the image the
                   fit sees (YUV, [0, 1])
    decoded_rgb_db the decode in RGB against the PNG's pixels
    bpp            model.smoe's bits per pixel
    bit_depths, nu_anchor, gamma_anchor, auto_bd_db   what auto-bd chose
    fit_s          the fit's wall seconds on this CPU
`cli_record` runs the recipe on any still; scripts/make_torch_still_
fixtures.py takes it for the 16-bit DEM.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import platform
import re
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["-k", "12", "-n", "5000", "-lsinit", "auto", "-lsri", "100",
         "-iukl", "1"]
MEMBERS = 4
_AUTO_BD = re.compile(r"auto-bd: \[([0-9, ]+)\] nu_anchor=(\d+) "
                      r"gamma_anchor=(\d+) \(([-0-9.]+) dB vs generous "
                      r"([-0-9.]+) dB\)")


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def member_init(member: int):
    """Within: a Smoe's first ls_init_experts is followed by the member's
    1-ulp move of a seeded half of nu_e (none for member 0)."""
    from smoe_tpu.fit.trainer import Smoe
    import jax.numpy as jnp
    real = Smoe.ls_init_experts
    moved = set()

    def ls_init_experts(self, *a, **kw):
        out = real(self, *a, **kw)
        if member and id(self) not in moved:
            moved.add(id(self))
            nu = np.asarray(self.params.nu_e).copy()
            up = np.random.default_rng(member).random(nu.shape) < 0.5
            nu[up] = np.nextafter(nu[up], np.float32(np.inf))
            self.params = self.params.replace(nu_e=jnp.asarray(nu))
        return out
    Smoe.ls_init_experts = ls_init_experts
    try:
        yield
    finally:
        Smoe.ls_init_experts = real


def cli_record(image: str, flags, member: int = 0, rgb=None) -> dict:
    """The recipe on `image` for one member: cli.fit with `flags`, the
    automatic encode of params_best.pkl, the decode of its model.smoe.
    `rgb`: the (H, W, 3) uint8 RGB pixels, for the RGB PSNR."""
    from smoe_tpu.cli import fit, reconstruct
    from smoe_tpu.codec.serve import decode_bitstream
    from smoe_tpu.io.images import read_image
    with tempfile.TemporaryDirectory() as tmp:
        d, e = os.path.join(tmp, "fit"), os.path.join(tmp, "enc")
        t0 = time.time()
        with member_init(member), contextlib.redirect_stdout(io.StringIO()):
            smoe = fit.main(["-i", image, "-r", d] + list(flags))
        fit_s = time.time() - t0
        with open(os.path.join(d, "metrics.jsonl")) as fd:
            best = max(json.loads(line)["psnr_db"] for line in fd)
        use_yuv = smoe.cfg.use_yuv
        del smoe
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            reconstruct.main(["-i", image, "-p",
                              os.path.join(d, "params_best.pkl"), "-r", e])
        path = os.path.join(e, "model.smoe")
        dec, head = decode_bitstream(path, return_header=True)
        nbytes = os.path.getsize(path)
    orig, precision, _ = read_image(image, use_yuv)
    dec = np.asarray(dec, np.float64).reshape(orig.shape)
    m = _AUTO_BD.search(log.getvalue())
    row = {"member": member, "best_db": float(best),
           "decoded_db": float(10 * np.log10(
               1 / np.mean((dec - orig) ** 2))),
           "bpp": nbytes * 8 / (orig.shape[0] * orig.shape[1]),
           "file_bytes": nbytes, "precision": int(precision),
           "header_precision": int(head.get("precision", -1))
           if isinstance(head, dict) else None,
           "bit_depths": [int(v) for v in m.group(1).split(",")],
           "nu_anchor": int(m.group(2)), "gamma_anchor": int(m.group(3)),
           "auto_bd_db": [float(m.group(4)), float(m.group(5))],
           "fit_s": round(fit_s, 1)}
    if rgb is not None:
        import cv2
        bgr = cv2.cvtColor(np.uint8(np.round(dec * 255)),
                           cv2.COLOR_YUV2BGR).astype(np.float64)
        ref = rgb[..., ::-1].astype(np.float64)
        row["decoded_rgb_db"] = float(10 * np.log10(
            255 ** 2 / np.mean((bgr - ref) ** 2)))
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--members", type=int, nargs="+",
                   default=list(range(MEMBERS)))
    p.add_argument("-o", "--out", default=os.path.join(
        ROOT, "tests", "data", "photo_cli_ref.json"))
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import cv2
    import jax
    jax.config.update("jax_platforms", "cpu")
    img = _script("content").build_family("hopper", 256)
    rgb = np.uint8(np.round(img * 255))
    rec = {"recipe": "cli.fit " + " ".join(FLAGS) + "; cli.reconstruct "
           "(automatic: --auto-bd 0.05 --prune 0); decode_bitstream",
           "image": "build_hopper(256) as an 8-bit RGB PNG",
           "host": platform.processor() or platform.machine(),
           "jax": jax.__version__, "members": []}
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "hopper256.png")
        cv2.imwrite(png, rgb[..., ::-1])
        for m in a.members:
            row = cli_record(png, FLAGS, m, rgb)
            rec["members"].append(row)
            print(json.dumps(row), flush=True)
            with open(a.out, "w") as f:
                json.dump(rec, f, indent=1)
                f.write("\n")
    print("wrote", a.out)


if __name__ == "__main__":
    main()
