"""Record the JAX package's bf16 fit of the real photograph: the fit of
scripts/make_torch_photo_fixture.py (256^2 RGB hopper, 12 x 12 = 144
kernels, YUV loss, determinant gating, the flagship optimizer, 1000 sweeps
as run_batched_chunk(10) a chunk, a light eval after every 100) with
compute_dtype="bfloat16", through the XLA path, for the PyTorch port's
bf16 fit on the card to be held against.

    JAX_PLATFORMS=cpu python scripts/make_torch_bf16_photo_record.py  # ~2 min

Output (committed, under 20 KB): tests/data/hopper256_k144_bf16_ref.npz
    sweeps, chunk, eval_every    1000, 10, 100
    mse, loss, num_pi            per sweep, from the chunks
    eval_sweep, eval_mse         the light evals after sweeps 100..1000
    best_psnr_db                 the best of those evals' PSNR
    a_diag_max, a_corr_max       max |A_diagonal|, max |A_corr| at those
                                 sweeps
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEPS, CHUNK, EVAL_EVERY = 1000, 10, 100


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-o", "--out", default=os.path.join(
        ROOT, "tests", "data", "hopper256_k144_bf16_ref.npz"))
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)

    import jax
    jax.config.update("jax_platforms", "cpu")

    from smoe_tpu import Smoe
    from smoe_tpu.core.losses import psnr_from_mse

    spec = importlib.util.spec_from_file_location(
        "_content", os.path.join(ROOT, "scripts", "content.py"))
    content = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(content)
    s = Smoe(content.build_family("hopper", 256), kernels_per_dim=[12],
             use_yuv=True, use_determinant=True, compute_dtype="bfloat16",
             use_pallas="off")
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
    np.savez(a.out, sweeps=SWEEPS, chunk=CHUNK, eval_every=EVAL_EVERY,
             mse=np.asarray(mse, np.float32),
             loss=np.asarray(loss, np.float32),
             num_pi=np.asarray(npi, np.int32),
             eval_sweep=np.arange(EVAL_EVERY, SWEEPS + 1, EVAL_EVERY),
             eval_mse=np.asarray(evals, np.float64), best_psnr_db=best,
             a_diag_max=np.asarray(a_diag), a_corr_max=np.asarray(a_corr))
    print(f"best {best:.4f} dB; wrote {a.out}")


if __name__ == "__main__":
    main()
