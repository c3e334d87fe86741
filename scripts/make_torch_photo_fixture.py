"""Record the JAX package's fit of the real photograph at the configuration
of BASELINE.md's fused-vs-XLA bisect on hopper (256^2 RGB, 12 x 12 = 144
kernels, YUV loss, determinant gating, the flagship optimizer), for the
PyTorch port's kernel and plain paths to be held against on the card, and
the sha256 of every photo input the JAX scripts build.

    JAX_PLATFORMS=cpu python scripts/make_torch_photo_fixture.py   # ~2 min

The fit: Smoe(build_hopper(256), kernels_per_dim=[12], use_yuv=True,
use_determinant=True), set_optimizer(), 1000 sweeps as run_batched_chunk(10)
a chunk, a light eval (run_batched(train=False)) after every 100.

Output (committed, under 20 KB):
    tests/data/hopper256_k144_ref.npz
        sweeps, chunk, eval_every    1000, 10, 100
        mse, loss, num_pi            per sweep, from the chunks (each
                                     describes the params before its
                                     sweep's update)
        eval_sweep, eval_mse         the light evals after sweeps 100..1000
        best_psnr_db                 the best of those evals' PSNR
        a_diag_max, a_corr_max       max |A_diagonal|, max |A_corr| of
                                     get_params() at those sweeps
        input_names, input_sha256,   each photo input of the JAX scripts
        input_shapes                 (scripts/content.py, bench_video.py,
                                     bench_lf.py): sha256 of its C-order
                                     bytes, and its shape
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEPS, CHUNK, EVAL_EVERY = 1000, 10, 100


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def photo_inputs():
    """name -> array: the photo inputs as the JAX scripts build them."""
    content, video, lf = (_script(n) for n in
                          ("content", "bench_video", "bench_lf"))
    out = {}
    for fam in ("hopper", "mri", "dem"):
        for size in (256, 48):
            out[f"{fam}_{size}"] = content.build_family(fam, size)
    vid, aff = video.build_video(moving_obj=True, texture="hopper", rot=5.0)
    out["video_hopper_rot5"] = vid
    out["video_hopper_rot5_affines"] = aff
    for s in (24, 48):
        out[f"lf_hopper_{s}"] = lf.build_lf(s=s, texture="hopper")
    return out


def sha256(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-o", "--out", default=os.path.join(
        ROOT, "tests", "data", "hopper256_k144_ref.npz"))
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)

    import jax
    jax.config.update("jax_platforms", "cpu")

    from smoe_tpu import Smoe
    from smoe_tpu.core.losses import psnr_from_mse

    inputs = photo_inputs()
    s = Smoe(inputs["hopper_256"], kernels_per_dim=[12], use_yuv=True,
             use_determinant=True)
    s.set_optimizer()
    t0 = time.time()
    mse, loss, npi, evals, a_diag, a_corr = [], [], [], [], [], []
    for done in range(CHUNK, SWEEPS + 1, CHUNK):
        lo, ms, n, _ = s.run_batched_chunk(CHUNK)
        loss += list(lo)
        mse += list(ms)
        npi += list(n)
        if done % EVAL_EVERY == 0:
            evals.append(s.run_batched(train=False)[1])
            prm = s.get_params()
            a_diag.append(float(np.abs(prm["A_diagonal"]).max()))
            a_corr.append(float(np.abs(prm["A_corr"]).max()))
            print(f"sweep {done}: {psnr_from_mse(evals[-1], 8):.2f} dB, "
                  f"max |A_diagonal| {a_diag[-1]:.1f}, max |A_corr| "
                  f"{a_corr[-1]:.1f} ({time.time() - t0:.1f} s)", flush=True)
    best = max(psnr_from_mse(m, 8) for m in evals)
    names = sorted(inputs)
    np.savez(a.out, sweeps=SWEEPS, chunk=CHUNK, eval_every=EVAL_EVERY,
             mse=np.asarray(mse, np.float32),
             loss=np.asarray(loss, np.float32),
             num_pi=np.asarray(npi, np.int32),
             eval_sweep=np.arange(EVAL_EVERY, SWEEPS + 1, EVAL_EVERY),
             eval_mse=np.asarray(evals, np.float64), best_psnr_db=best,
             a_diag_max=np.asarray(a_diag), a_corr_max=np.asarray(a_corr),
             input_names=np.asarray(names),
             input_sha256=np.asarray([sha256(inputs[n]) for n in names]),
             input_shapes=np.asarray([str(inputs[n].shape) for n in names]))
    print(f"best {best:.4f} dB; wrote {a.out}")


if __name__ == "__main__":
    main()
